"""int16 scan quantisation for the host->device upload.

numpy port of ``glim_tpu/native/pack.cpp::pack_scan_i16``, with its exact
semantics: values are scaled by the reciprocal of the step, NaN and
anything at or below -32767 clamp to -32767, and rounding is ``llround``'s
half away from zero (not numpy's half to even).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _llround(v: np.ndarray) -> np.ndarray:
    return np.sign(v) * np.floor(np.abs(v) + 0.5)


def pack_scan_i16(points: np.ndarray, times: Optional[np.ndarray], cap: int,
                  pt_scale: float, t_scale: float) -> Tuple[np.ndarray, int]:
    """Quantise a raw scan into the zero-padded (cap, 4) int16 buffer
    [x, y, z, t] at pt_scale / t_scale per LSB. Returns (buffer, n used)."""
    n = min(len(points), cap)
    out = np.zeros((cap, 4), np.int16)
    v = np.asarray(points[:n, :3], np.float64) * (1.0 / pt_scale)
    v = np.where(v > -32767.0, v, -32767.0)          # also catches NaN
    v = np.minimum(v, 32767.0)
    out[:n, :3] = _llround(v)
    if times is not None and len(times) == len(points):
        inv_t = 1.0 / t_scale if t_scale > 0 else 0.0
        t = np.asarray(times[:n], np.float64) * inv_t
        t = np.where(t > 0.0, t, 0.0)
        t = np.minimum(t, 32767.0)
        out[:n, 3] = _llround(t)
    return out, n
