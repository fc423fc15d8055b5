"""sensor_msgs/PointCloud2 -> RawPoints conversion (host copy of
``glim_tpu/ros/cloud_converter.py``).

Equivalent capability to the reference's ``extract_raw_points``
(reference: include/glim/util/ros_cloud_converter.hpp:64+): automatic field
discovery (x/y/z, t/time/timestamp/time_stamp, intensity/reflectivity, ring/
channel), FLOAT32/FLOAT64 point layouts, and ROS1/ROS2 stamp handling.

Duck-typed: accepts any object with the PointCloud2 surface (``fields`` with
name/offset/datatype, ``point_step``, ``width``/``height``, ``data``,
optionally ``header.stamp``), so it works with rospy and rclpy messages —
and with plain namespaces in tests — without importing ROS. Each field is
one strided numpy view over the payload (a 65,536-point cloud decodes in a
few numpy copies, never point by point in Python).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from glim_tpu_torch.types import RawPoints
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("ros")

# sensor_msgs/PointField datatype codes.
_DTYPES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
           5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}

TIME_FIELDS = ("t", "time", "timestamp", "time_stamp", "stamp")
INTENSITY_FIELDS = ("intensity", "reflectivity", "intensities")
RING_FIELDS = ("ring", "channel", "laser_id")


def to_sec(stamp) -> float:
    """ROS1 (secs/nsecs) and ROS2 (sec/nanosec) stamp shims
    (reference: ros_cloud_converter.hpp:13-55)."""
    if stamp is None:
        return 0.0
    if hasattr(stamp, "sec"):
        return float(stamp.sec) + float(getattr(stamp, "nanosec", 0)) * 1e-9
    if hasattr(stamp, "secs"):
        return float(stamp.secs) + float(getattr(stamp, "nsecs", 0)) * 1e-9
    return float(stamp)


def _field_array(data: np.ndarray, point_step: int, n: int, offset: int,
                 dtype) -> np.ndarray:
    itemsize = np.dtype(dtype).itemsize
    view = np.lib.stride_tricks.as_strided(
        data[offset:offset + (n - 1) * point_step + itemsize].view(np.uint8),
        shape=(n, itemsize), strides=(point_step, 1))
    return view.copy().view(dtype).reshape(n)


def extract_raw_points(msg, intensity_field: str = "intensity",
                       ring_field: str = "") -> Optional[RawPoints]:
    """Convert a PointCloud2-like message into RawPoints."""
    fields = {f.name: f for f in msg.fields}
    if not all(k in fields for k in ("x", "y", "z")):
        logger.error("point cloud lacks x/y/z fields: %s", sorted(fields))
        return None

    n = int(msg.width) * int(getattr(msg, "height", 1) or 1)
    data = np.frombuffer(bytes(msg.data), np.uint8)
    step = int(msg.point_step)

    fx = fields["x"]
    xyz_dtype = _DTYPES.get(fx.datatype, np.float32)
    # Contiguous x, y, z is the common layout; gather per-field otherwise.
    pts = np.stack([
        _field_array(data, step, n, fields[a].offset,
                     _DTYPES.get(fields[a].datatype, np.float32))
        for a in ("x", "y", "z")], axis=1).astype(np.float64)

    times = None
    for name in TIME_FIELDS:
        if name in fields:
            f = fields[name]
            times = _field_array(data, step, n, f.offset,
                                 _DTYPES.get(f.datatype, np.float32)).astype(np.float64)
            break

    intensities = None
    for name in ((intensity_field,) if intensity_field else ()) + INTENSITY_FIELDS:
        if name in fields:
            f = fields[name]
            intensities = _field_array(data, step, n, f.offset,
                                       _DTYPES.get(f.datatype, np.float32)).astype(np.float64)
            break

    rings = None
    for name in ((ring_field,) if ring_field else ()) + RING_FIELDS:
        if name in fields:
            f = fields[name]
            rings = _field_array(data, step, n, f.offset,
                                 _DTYPES.get(f.datatype, np.uint16)).astype(np.int32)
            break

    colors = None
    for name in ("rgba", "rgb"):
        if name in fields:
            f = fields[name]
            packed = _field_array(data, step, n, f.offset,
                                  _DTYPES.get(f.datatype, np.uint32))
            if packed.dtype.kind == "f":  # PCL packs RGB bits into a float32
                packed = packed.view(np.uint32)
            packed = packed.astype(np.uint32)
            colors = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                               packed & 0xFF, (packed >> 24) & 0xFF],
                              axis=-1).astype(np.float32) / 255.0
            break

    stamp = to_sec(getattr(getattr(msg, "header", None), "stamp", None))
    return RawPoints(stamp=stamp, points=pts, times=times,
                     intensities=intensities, colors=colors, rings=rings)
