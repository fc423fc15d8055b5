"""ROS message construction with optional rclpy (host copy of
``glim_tpu/ros/messages.py``).

The live node publishes sensor_msgs/nav_msgs/tf2_msgs messages. On hosts
with ROS 2 installed the real message classes are used (so rclpy publishers
accept them); on hosts without ROS structurally identical SimpleNamespace
objects are produced, which keeps the full publish path testable and lets
bag-writer tools serialize them with their own CDR encoder.

Equivalent capability to the reference's glim_ros publishing helpers
(reference: config/config_ros.json TF/topic contract; the glim_ros package's
cloud/odometry publishers). The PointCloud2 builder is the exact inverse of
``cloud_converter.extract_raw_points`` and round-trips through it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np

_msg_cache: dict = {}


def _ros_class(module: str, name: str):
    """Import a ROS message class, or None without ROS."""
    key = (module, name)
    if key not in _msg_cache:
        try:
            mod = __import__(module, fromlist=[name])
            _msg_cache[key] = getattr(mod, name)
        except (ImportError, AttributeError):     # no ROS here, or no such class
            _msg_cache[key] = None
    return _msg_cache[key]


def stamp_msg(t: float):
    """builtin_interfaces/Time (ROS2 layout)."""
    sec = int(t)
    nanosec = int(round((t - sec) * 1e9))
    if nanosec >= 1_000_000_000:
        sec, nanosec = sec + 1, nanosec - 1_000_000_000
    cls = _ros_class("builtin_interfaces.msg", "Time")
    if cls is not None:
        m = cls()
        m.sec, m.nanosec = sec, nanosec
        return m
    return SimpleNamespace(sec=sec, nanosec=nanosec)


def header_msg(t: float, frame_id: str):
    cls = _ros_class("std_msgs.msg", "Header")
    if cls is not None:
        m = cls()
        m.stamp = stamp_msg(t)
        m.frame_id = frame_id
        return m
    return SimpleNamespace(stamp=stamp_msg(t), frame_id=frame_id)


# sensor_msgs/PointField datatype codes (FLOAT32).
_F32 = 7


def make_pointcloud2(t: float, frame_id: str, points: np.ndarray,
                     intensities: Optional[np.ndarray] = None,
                     times: Optional[np.ndarray] = None):
    """Dense FLOAT32 x/y/z(/intensity/t) PointCloud2; inverse of
    ``extract_raw_points`` (``times`` are per-point offsets, Ouster-style)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    n = pts.shape[0]
    names = ["x", "y", "z"]
    cols = [pts[:, 0], pts[:, 1], pts[:, 2]]
    if intensities is not None:
        names.append("intensity")
        cols.append(np.asarray(intensities, np.float32).reshape(-1))
    if times is not None:
        names.append("t")
        cols.append(np.asarray(times, np.float32).reshape(-1))
    step = 4 * len(names)
    buf = np.empty((n, len(names)), np.float32)
    for i, c in enumerate(cols):
        buf[:, i] = c
    data = buf.tobytes()

    fcls = _ros_class("sensor_msgs.msg", "PointField")

    def field(name, offset):
        if fcls is not None:
            f = fcls()
            f.name, f.offset, f.datatype, f.count = name, offset, _F32, 1
            return f
        return SimpleNamespace(name=name, offset=offset, datatype=_F32, count=1)

    fields = [field(nm, 4 * i) for i, nm in enumerate(names)]
    cls = _ros_class("sensor_msgs.msg", "PointCloud2")
    if cls is not None:
        m = cls()
        m.header = header_msg(t, frame_id)
        m.height, m.width = 1, n
        m.fields = fields
        m.is_bigendian = False
        m.point_step, m.row_step = step, step * n
        m.data = data
        m.is_dense = True
        return m
    return SimpleNamespace(header=header_msg(t, frame_id), height=1, width=n,
                           fields=fields, is_bigendian=False, point_step=step,
                           row_step=step * n, data=data, is_dense=True)


def _pose_fields(T: np.ndarray):
    from glim_tpu_torch.ops import lie_np
    T = np.asarray(T, np.float64)
    q = lie_np.rot_to_quat(T[:3, :3])  # (x, y, z, w)
    pos = SimpleNamespace(x=float(T[0, 3]), y=float(T[1, 3]), z=float(T[2, 3]))
    ori = SimpleNamespace(x=float(q[0]), y=float(q[1]), z=float(q[2]), w=float(q[3]))
    return pos, ori


def make_pose_stamped(t: float, frame_id: str, T: np.ndarray):
    pos, ori = _pose_fields(T)
    cls = _ros_class("geometry_msgs.msg", "PoseStamped")
    if cls is not None:
        m = cls()
        m.header = header_msg(t, frame_id)
        m.pose.position.x, m.pose.position.y, m.pose.position.z = pos.x, pos.y, pos.z
        (m.pose.orientation.x, m.pose.orientation.y,
         m.pose.orientation.z, m.pose.orientation.w) = ori.x, ori.y, ori.z, ori.w
        return m
    return SimpleNamespace(header=header_msg(t, frame_id),
                           pose=SimpleNamespace(position=pos, orientation=ori))


def make_odometry(t: float, frame_id: str, child_frame_id: str, T: np.ndarray,
                  cov: Optional[np.ndarray] = None):
    """nav_msgs/Odometry; ``cov`` is the 6x6 pose covariance if known."""
    ps = make_pose_stamped(t, frame_id, T)
    cov36 = (np.asarray(cov, np.float64).reshape(36).tolist()
             if cov is not None else [0.0] * 36)
    cls = _ros_class("nav_msgs.msg", "Odometry")
    if cls is not None:
        m = cls()
        m.header = ps.header
        m.child_frame_id = child_frame_id
        m.pose.pose = ps.pose
        m.pose.covariance = cov36
        return m
    return SimpleNamespace(header=ps.header, child_frame_id=child_frame_id,
                           pose=SimpleNamespace(pose=ps.pose, covariance=cov36),
                           twist=SimpleNamespace())


def make_transform_stamped(t: float, frame_id: str, child_frame_id: str,
                           T: np.ndarray):
    pos, ori = _pose_fields(T)
    trans = SimpleNamespace(x=pos.x, y=pos.y, z=pos.z)
    cls = _ros_class("geometry_msgs.msg", "TransformStamped")
    if cls is not None:
        m = cls()
        m.header = header_msg(t, frame_id)
        m.child_frame_id = child_frame_id
        m.transform.translation.x, m.transform.translation.y, m.transform.translation.z = \
            pos.x, pos.y, pos.z
        (m.transform.rotation.x, m.transform.rotation.y,
         m.transform.rotation.z, m.transform.rotation.w) = ori.x, ori.y, ori.z, ori.w
        return m
    return SimpleNamespace(header=header_msg(t, frame_id),
                           child_frame_id=child_frame_id,
                           transform=SimpleNamespace(translation=trans, rotation=ori))


def make_tf_message(transforms):
    cls = _ros_class("tf2_msgs.msg", "TFMessage")
    if cls is not None:
        m = cls()
        m.transforms = list(transforms)
        return m
    return SimpleNamespace(transforms=list(transforms))


def imu_to_arrays(msg):
    """sensor_msgs/Imu -> (stamp, linear_acc (3,), angular_vel (3,))."""
    from glim_tpu_torch.ros.cloud_converter import to_sec
    a, w = msg.linear_acceleration, msg.angular_velocity
    return (to_sec(getattr(getattr(msg, "header", None), "stamp", None)),
            np.array([a.x, a.y, a.z], np.float64),
            np.array([w.x, w.y, w.z], np.float64))
