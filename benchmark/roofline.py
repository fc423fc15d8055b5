"""The card's published peaks and the least time of the hand-written kernel.

Frozen copy of the bound arithmetic of ``chip_smoke.py`` phase 3 (PEAK_FP32,
PEAK_BYTES, ``nn_bound_ms``), taken from each call's sizes instead of its
tensors. Peaks: NVIDIA H100 SXM data sheet, 700 W, dense float32 outside the
tensor cores and HBM3 bandwidth.
"""

from __future__ import annotations

PEAK_FP32 = 67e12          # FLOP/s
PEAK_BYTES = 3.35e12       # B/s
NN_FLOPS_PER_PAIR = 8      # a (valid query, valid target) distance and compare
NN_KERNELS = ("pack_targets_kernel", "search_split_kernel", "merge_splits_kernel")


def nn_bound_s(Q: int, N: int, q_valid: int, t_valid: int) -> float:
    """Least seconds of one nn_search call: each input (xyz f32 and a mask
    byte a point) read once and each output (index and d2 a query) written
    once over the memory rate, against the valid pairs' flops over the
    float32 rate."""
    by_bytes = (Q * (12 + 1) + N * (12 + 1) + Q * 8) / PEAK_BYTES
    by_ops = NN_FLOPS_PER_PAIR * q_valid * t_valid / PEAK_FP32
    return max(by_bytes, by_ops)
