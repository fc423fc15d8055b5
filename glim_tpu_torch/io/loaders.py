"""Point-cloud file loaders for offline datasets (twin of
``glim_tpu/io/loaders.py``): ``.npy``, KITTI ``.bin`` and ``.ply``.

PLY goes through a numpy reader of the layout ``io/dump.export_ply`` writes
(binary little-endian, one vertex element of float x, y, z), the twin of the
numpy path in ``glim_tpu/native/loader.py::ply_read``; the JAX package's
native C++ reader is not ported. Another layout raises ``ValueError``.
"""

from __future__ import annotations

import os

import numpy as np


def load_kitti_bin(path: str) -> np.ndarray:
    """KITTI velodyne .bin: packed float32 [x, y, z, reflectance] rows.
    Returns (N, 4)."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


def load_ply(path: str) -> np.ndarray:
    """Binary little-endian PLY of float x, y, z vertices -> (N, 3) f32."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY header has no end_header")
            line = line.strip()
            if line == b"end_header":
                break
            header.append(line.split())
        if header[:1] != [[b"ply"]] or [b"format", b"binary_little_endian", b"1.0"] not in header:
            raise ValueError(f"{path}: only binary little-endian PLY is read")
        elements = [h for h in header if h[0] == b"element"]
        props = [h[1:] for h in header if h[0] == b"property"]
        if (len(elements) != 1 or elements[0][1] != b"vertex"
                or props != [[b"float", b"x"], [b"float", b"y"], [b"float", b"z"]]):
            raise ValueError(f"{path}: only one vertex element of float x, y, z is read")
        n = int(elements[0][2])
        data = np.frombuffer(f.read(n * 12), dtype="<f4")
    if data.size != n * 3:
        raise ValueError(f"{path}: {data.size // 3} vertices for {n} declared")
    return data.reshape(n, 3).copy()


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
