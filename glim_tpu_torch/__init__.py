"""glim_tpu_torch — the PyTorch / CUDA port of glim_tpu.

Same module layout and public surface as ``glim_tpu`` (each module sits at the
same relative path as its counterpart), with the device math written in
PyTorch and the hot nearest-neighbour search as a hand-written CUDA kernel
(``csrc/nn_search.cu``). This package never imports JAX or ``glim_tpu``:
host-only helpers are carried as their own numpy copies.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry code cannot tolerate TF32 matmul inputs: kNN distance expansions
# and SE(3) chains lose ~3 decimal digits. Full f32 everywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from glim_tpu_torch.utils.callbacks import CallbackSlot  # noqa: E402,F401
from glim_tpu_torch.utils.config import Config, GlobalConfig  # noqa: E402,F401
