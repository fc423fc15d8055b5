"""Startup system diagnostics (twin of ``glim_tpu/utils/debug.py``;
reference: src/glim/util/debug.cpp:59-91, build flags and CUDA device
names): the PyTorch and CUDA versions, the devices, and each card's name and
power limit as ``nvidia-smi`` reports them."""

from __future__ import annotations

import subprocess
import sys

import torch

from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("glim")


def system_info() -> dict:
    info = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())],
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
    }
    if torch.cuda.is_available():
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        info["nvidia_smi"] = (smi.stdout.strip().splitlines() if smi.returncode == 0
                              else f"nvidia-smi failed ({smi.returncode})")
    return info


def print_system_info() -> None:
    for k, v in system_info().items():
        logger.info("%s: %s", k, v)
