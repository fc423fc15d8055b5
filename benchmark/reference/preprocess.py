"""Plain reference for scan preprocessing: what a random-grid downsampled
scan has to be, worked out again from the raw scan.

numpy only. The deployment's ``config_preprocess`` (random-grid sampling at
``downsample_resolution`` to ``random_downsample_target`` points, a
``distance_near_thresh`` / ``distance_far_thresh`` range filter) and the
port's documented upload quantization (``quantize_resolution``, int16 with
rounding half away from zero) fix, for a raw scan, the set of points a
preprocessed scan may hold, how many it holds, and how many of them any one
voxel may give. The random choice inside a voxel is the program's own and is
not re-drawn here; everything else is checked exactly.
"""

from __future__ import annotations

import numpy as np


def quantized(raw: np.ndarray, step: float) -> np.ndarray:
    """(n, 3) int64 upload codes: round half away from zero, clamped to int16."""
    v = np.asarray(raw, np.float64)[:, :3] * (1.0 / step)
    v = np.clip(np.where(v > -32767.0, v, -32767.0), None, 32767.0)
    return (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.int64)


def _rows(a: np.ndarray) -> np.ndarray:
    """int64 (n, 3) -> one structured key per row."""
    return np.ascontiguousarray(a).view([("x", a.dtype), ("y", a.dtype), ("z", a.dtype)]).ravel()


def violations(raw: np.ndarray, out_pts, out_mask, out_times, params: dict) -> int:
    """Count of ways the preprocessed scan (``out_*``: the program's padded
    points, mask and times) departs from what ``raw`` allows: a point count
    other than min(target, sum over voxels of min(n_v, ceil(target / voxels))),
    points that are not raw points after quantization and the range filter
    (counted with multiplicity), voxels giving more than their budget, and
    times out of order."""
    step = np.float32(params["quantize_resolution"])          # the device's dequantize
    codes = quantized(raw, float(params["quantize_resolution"]))
    deq = codes.astype(np.float32) * step
    d = np.sqrt(np.sum(deq.astype(np.float32) ** 2, axis=1, dtype=np.float32))
    keep = np.isfinite(deq).all(1) & (d >= np.float32(params["distance_near_thresh"])) \
        & (d <= np.float32(params["distance_far_thresh"]))
    codes, deq = codes[keep], deq[keep]
    inv_res = np.float32(1.0 / params["downsample_resolution"])
    vox = np.floor(deq * inv_res).astype(np.int64)
    vkeys, vcount = np.unique(_rows(vox), return_counts=True)
    target = int(params["random_downsample_target"])
    budget = int(np.ceil(np.float32(target) / np.float32(max(len(vkeys), 1))))
    expected = min(target, int(np.minimum(vcount, budget).sum()))

    mask = np.asarray(out_mask, bool)
    pts = np.asarray(out_pts, np.float32)[mask]
    bad = abs(len(pts) - expected)
    # Membership with multiplicity: each output code at most as often as raw.
    out_codes = np.rint(pts.astype(np.float64) / float(step)).astype(np.int64)
    raw_keys, raw_n = np.unique(_rows(codes), return_counts=True)
    out_keys, out_n = np.unique(_rows(out_codes), return_counts=True)
    pos = np.searchsorted(raw_keys, out_keys)
    pos_c = np.minimum(pos, len(raw_keys) - 1)
    found = (pos < len(raw_keys)) & (raw_keys[pos_c] == out_keys) if len(raw_keys) else \
        np.zeros(len(out_keys), bool)
    bad += int(out_n[~found].sum()) + int(np.maximum(out_n[found] - raw_n[pos_c[found]], 0).sum())
    # Per-voxel budget.
    out_vox = np.floor(pts * inv_res).astype(np.int64)
    _, ov_n = np.unique(_rows(out_vox), return_counts=True)
    bad += int(np.maximum(ov_n - budget, 0).sum())
    # Time order of the valid points.
    t = np.asarray(out_times, np.float32)[mask]
    bad += int(np.sum(np.diff(t) < 0))
    return bad
