"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``glim_tpu_torch/csrc/`` exposes a plain C
interface and is compiled by ``nvcc`` into its own shared library for
Hopper (``sm_90a``), then bound with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries are cached in ``build/glim_tpu_torch/`` at
the repository root (``GLIM_TPU_TORCH_BUILD_DIR`` overrides it), named by a
hash of the source and the flags, so an edited source is rebuilt on first
use. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}     # kernel name -> nvcc output (-Xptxas -v)


def build_dir() -> str:
    return os.environ.get("GLIM_TPU_TORCH_BUILD_DIR",
                          os.path.join(os.path.dirname(_PKG), "build", "glim_tpu_torch"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "glim_tpu_torch are built from source at first use")


def load_kernel_library(name: str, src: Optional[str] = None) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, or the source ``src``
    under ``name``; raises on failure."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = src or os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = build_dir()
        lib_path = os.path.join(out_dir, f"lib{name}-{digest}.so")
        log_path = lib_path + ".log"
        if not os.path.exists(lib_path):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{log}")
            with open(log_path, "w") as f:
                f.write(log)
            os.replace(tmp, lib_path)
        if os.path.exists(log_path):
            with open(log_path) as f:
                build_logs[name] = f.read()
        lib = ctypes.CDLL(lib_path)
        _libs[name] = lib
        return lib
