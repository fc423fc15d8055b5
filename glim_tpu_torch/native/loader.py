"""PLY point-cloud IO of the host runtime.

Twin of ``glim_tpu/native/loader.py``'s ``ply_read`` / ``ply_write`` (and,
by name, its ``pack_scan_i16`` and ``available``), whose
reader is C++ (``glim_tpu/native/pack.cpp:65-97``): a binary little-endian
PLY whose vertex element leads with float x, y, z; any further per-vertex
scalar properties (intensity, a uchar ring, a double timestamp, ...) are
skipped by their byte stride. Here the same read is one numpy structured
dtype over the vertex block, with no build and no second path. Anything
else (ASCII, big-endian, x / y / z not the leading floats, a list property,
an element besides the vertices, fewer vertices than declared) raises
``ValueError`` rather than being misread. (The JAX package's numpy fallback
assumes a 12-byte stride and misreads a PLY with extra properties.)
"""

from __future__ import annotations

import numpy as np

from glim_tpu_torch.native.pack import pack_scan_i16  # noqa: F401  (the JAX module's name)

# PLY scalar types and their sizes (both naming schemes of the format).
_PLY_TYPES = {"char": "i1", "uchar": "u1", "short": "<i2", "ushort": "<u2",
              "int": "<i4", "uint": "<u4", "float": "<f4", "double": "<f8",
              "int8": "i1", "uint8": "u1", "int16": "<i2", "uint16": "<u2",
              "int32": "<i4", "uint32": "<u4", "float32": "<f4", "float64": "<f8"}


def _read_header(f, path: str):
    """(vertex count, per-vertex dtype) of a PLY header; the file is left at
    the first byte of the vertex data."""
    lines = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError(f"{path}: PLY header has no end_header")
        tok = line.strip().split()
        if tok == [b"end_header"]:
            break
        if tok and tok[0] not in (b"comment", b"obj_info"):
            lines.append([t.decode("ascii", "replace") for t in tok])
    if lines[:1] != [["ply"]] or ["format", "binary_little_endian", "1.0"] not in lines:
        raise ValueError(f"{path}: only binary little-endian PLY is read")
    elements = [t for t in lines if t[0] == "element"]
    if len(elements) != 1 or elements[0][1] != "vertex" or len(elements[0]) != 3:
        raise ValueError(f"{path}: only one vertex element is read")
    fields = []
    for t in lines:
        if t[0] != "property":
            continue
        if len(t) != 3 or t[1] not in _PLY_TYPES:
            raise ValueError(f"{path}: unsupported vertex property {' '.join(t)!r}")
        fields.append((t[2], _PLY_TYPES[t[1]]))
    if fields[:3] != [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]:
        raise ValueError(f"{path}: the vertex element must lead with float x, y, z")
    stride = sum(np.dtype(d).itemsize for _, d in fields)
    dtype = np.dtype({"names": ["xyz"], "formats": [("<f4", 3)], "offsets": [0],
                      "itemsize": stride})
    return int(elements[0][2]), dtype


def ply_read(path: str, max_points: int = 50_000_000) -> np.ndarray:
    """The x, y, z of up to ``max_points`` vertices -> (N, 3) float32."""
    with open(path, "rb") as f:
        n, dtype = _read_header(f, path)
        n = min(n, max_points)
        data = f.read(n * dtype.itemsize)
    if len(data) < n * dtype.itemsize:
        raise ValueError(f"{path}: {len(data) // dtype.itemsize} vertices for {n} declared")
    return np.frombuffer(data, dtype, count=n)["xyz"].copy()


def ply_write(path: str, points: np.ndarray) -> None:
    """A binary little-endian PLY of float x, y, z vertices (the bytes of
    ``pack.cpp::ply_write_xyz`` and ``io/dump.export_ply``)."""
    pts = np.ascontiguousarray(points, "<f4").reshape(-1, 3)
    with open(path, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(pts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "end_header\n").encode())
        f.write(pts.tobytes())


def available() -> bool:
    """Whether the host packer can be used. The JAX package's twin reports
    whether its C++ library built and loaded; the port's packer is numpy
    (``native/pack.py``, imported by this module), so it always can."""
    return True
