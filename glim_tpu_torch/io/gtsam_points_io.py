"""gtsam_points binary point-cloud I/O — reference-dump interoperability.

Numpy-only copy of ``glim_tpu/io/gtsam_points_io.py``.

The reference saves each submap's cloud with
``gtsam_points::PointCloudCPU::save_compact`` (called from
mapping/sub_map.cpp:61) and reads it back with
``gtsam_points::PointCloudCPU::load`` (sub_map.cpp:142). Those live in the
external gtsam_points library; the on-disk layout is a raw little-endian
array per attribute:

  compact variant (written by save_compact):
    points_compact.bin      — N x Vector3f        (3 float32)
    covs_compact.bin        — N x 6 float32       upper triangular of the
                              3x3 block: (xx, xy, xz, yy, yz, zz)
    normals_compact.bin     — N x Vector3f
    times_compact.bin       — N x float32
    intensities_compact.bin — N x float32

  full variant (written by save):
    points.bin              — N x Vector4d        (4 float64, w = 1)
    covs.bin                — N x Matrix4d        (16 float64, symmetric,
                              last row/col zero)
    normals.bin             — N x Vector4d
    times.bin               — N x float64
    intensities.bin         — N x float64

``load`` prefers the compact files when present. This module implements
both directions so the offline tools can open a real GLIM dump and
so round-trip fixtures can be generated for tests.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _read_raw(path: str, dtype, cols: int) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    raw = np.fromfile(path, dtype=dtype)
    if cols > 1:
        if raw.size % cols:
            raise ValueError(f"{path}: size {raw.size} not divisible by {cols}")
        raw = raw.reshape(-1, cols)
    return raw


def _expand_cov6(c6: np.ndarray) -> np.ndarray:
    """(N, 6) upper-triangular (xx,xy,xz,yy,yz,zz) -> (N, 3, 3)."""
    out = np.empty((len(c6), 3, 3), np.float32)
    out[:, 0, 0] = c6[:, 0]
    out[:, 0, 1] = out[:, 1, 0] = c6[:, 1]
    out[:, 0, 2] = out[:, 2, 0] = c6[:, 2]
    out[:, 1, 1] = c6[:, 3]
    out[:, 1, 2] = out[:, 2, 1] = c6[:, 4]
    out[:, 2, 2] = c6[:, 5]
    return out


def _compact_cov6(covs: np.ndarray) -> np.ndarray:
    """(N, 3, 3) -> (N, 6) upper triangular, reference ordering."""
    covs = np.asarray(covs, np.float32)
    return np.stack([covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2],
                     covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]], axis=1)


def has_point_cloud(path: str) -> bool:
    return (os.path.exists(os.path.join(path, "points_compact.bin"))
            or os.path.exists(os.path.join(path, "points.bin")))


def load_point_cloud(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Read a gtsam_points cloud directory -> dict with 'points' (N, 3) and
    optional 'covs' (N, 3, 3), 'normals' (N, 3), 'times' (N,),
    'intensities' (N,). Compact files take precedence (matching
    PointCloudCPU::load). Returns None if no point payload exists."""
    j = lambda n: os.path.join(path, n)  # noqa: E731

    pts = _read_raw(j("points_compact.bin"), "<f4", 3)
    compact = pts is not None
    if pts is None:
        p4 = _read_raw(j("points.bin"), "<f8", 4)
        pts = p4[:, :3].astype(np.float32) if p4 is not None else None
    if pts is None:
        return None
    out: Dict[str, np.ndarray] = {"points": pts}

    if compact:
        c6 = _read_raw(j("covs_compact.bin"), "<f4", 6)
        if c6 is not None:
            out["covs"] = _expand_cov6(c6)
    else:
        c16 = _read_raw(j("covs.bin"), "<f8", 16)
        if c16 is not None:
            out["covs"] = c16.reshape(-1, 4, 4)[:, :3, :3].astype(np.float32)
    # Compact dumps of full saves can mix variants; fall back per attribute.
    if "covs" not in out:
        c6 = _read_raw(j("covs_compact.bin"), "<f4", 6)
        if c6 is not None:
            out["covs"] = _expand_cov6(c6)

    n3 = _read_raw(j("normals_compact.bin"), "<f4", 3)
    if n3 is None:
        n4 = _read_raw(j("normals.bin"), "<f8", 4)
        n3 = n4[:, :3].astype(np.float32) if n4 is not None else None
    if n3 is not None:
        out["normals"] = n3

    t = _read_raw(j("times_compact.bin"), "<f4", 1)
    if t is None:
        t64 = _read_raw(j("times.bin"), "<f8", 1)
        t = t64.astype(np.float32) if t64 is not None else None
    if t is not None:
        out["times"] = t

    inten = _read_raw(j("intensities_compact.bin"), "<f4", 1)
    if inten is None:
        i64 = _read_raw(j("intensities.bin"), "<f8", 1)
        inten = i64.astype(np.float32) if i64 is not None else None
    if inten is not None:
        out["intensities"] = inten

    n = len(pts)
    for k, v in list(out.items()):
        if len(v) != n:
            raise ValueError(f"{path}: attribute {k} has {len(v)} entries "
                             f"for {n} points")
    return out


def save_point_cloud_compact(path: str, points: np.ndarray,
                             covs: Optional[np.ndarray] = None,
                             normals: Optional[np.ndarray] = None,
                             times: Optional[np.ndarray] = None,
                             intensities: Optional[np.ndarray] = None) -> None:
    """Emit the reference's compact byte format (PointCloudCPU::save_compact
    equivalent) so real GLIM can open these dumps and tests can
    round-trip the format."""
    os.makedirs(path, exist_ok=True)
    j = lambda n: os.path.join(path, n)  # noqa: E731
    np.ascontiguousarray(np.asarray(points, np.float32)[:, :3]) \
        .astype("<f4").tofile(j("points_compact.bin"))
    if covs is not None:
        _compact_cov6(covs).astype("<f4").tofile(j("covs_compact.bin"))
    if normals is not None:
        np.asarray(normals, np.float32)[:, :3].astype("<f4") \
            .tofile(j("normals_compact.bin"))
    if times is not None:
        np.asarray(times, np.float32).astype("<f4") \
            .tofile(j("times_compact.bin"))
    if intensities is not None:
        np.asarray(intensities, np.float32).astype("<f4") \
            .tofile(j("intensities_compact.bin"))


def save_point_cloud_full(path: str, points: np.ndarray,
                          covs: Optional[np.ndarray] = None,
                          normals: Optional[np.ndarray] = None,
                          times: Optional[np.ndarray] = None,
                          intensities: Optional[np.ndarray] = None) -> None:
    """Emit the full double-precision variant (PointCloudCPU::save
    equivalent) — used by round-trip tests for the non-compact reader."""
    os.makedirs(path, exist_ok=True)
    j = lambda n: os.path.join(path, n)  # noqa: E731
    pts = np.asarray(points, np.float64)
    p4 = np.concatenate([pts[:, :3], np.ones((len(pts), 1))], axis=1)
    p4.astype("<f8").tofile(j("points.bin"))
    if covs is not None:
        c = np.asarray(covs, np.float64)
        c16 = np.zeros((len(c), 4, 4))
        c16[:, :3, :3] = c
        c16.astype("<f8").tofile(j("covs.bin"))
    if normals is not None:
        nr = np.asarray(normals, np.float64)
        n4 = np.concatenate([nr[:, :3], np.zeros((len(nr), 1))], axis=1)
        n4.astype("<f8").tofile(j("normals.bin"))
    if times is not None:
        np.asarray(times, np.float64).astype("<f8").tofile(j("times.bin"))
    if intensities is not None:
        np.asarray(intensities, np.float64).astype("<f8") \
            .tofile(j("intensities.bin"))
