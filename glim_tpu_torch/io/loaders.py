"""Point-cloud file loaders for offline datasets (twin of
``glim_tpu/io/loaders.py``): ``.npy``, KITTI ``.bin`` and ``.ply``.

PLY goes through ``native/loader.ply_read``, the twin of the JAX package's
C++ reader: binary little-endian, one vertex element leading with float x,
y, z, further per-vertex properties (intensity, ring, ...) skipped by their
stride. Another layout raises ``ValueError``.
"""

from __future__ import annotations

import os

import numpy as np

from glim_tpu_torch.native.loader import ply_read


def load_kitti_bin(path: str) -> np.ndarray:
    """KITTI velodyne .bin: packed float32 [x, y, z, reflectance] rows.
    Returns (N, 4)."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


def load_ply(path: str) -> np.ndarray:
    """Binary little-endian PLY whose vertices lead with float x, y, z ->
    (N, 3) f32."""
    return ply_read(path)


def load_scan_file(path: str) -> np.ndarray:
    """Dispatch by extension: .npy | .bin (KITTI) | .ply. Returns (N, 3|4)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path)
    if ext == ".bin":
        return load_kitti_bin(path)
    if ext == ".ply":
        return load_ply(path)
    raise ValueError(f"unsupported scan format: {path}")
