"""Live ROS node, the ``glim_rosnode`` equivalent of the port.

Twin of ``glim_tpu/ros/node.py``: subscribes to the configured IMU / points
/ image topics, converts messages, feeds ``GlimTorch`` (on the card unless
``device="cpu"``), binds extension-module topic subscriptions, and
publishes odometry and the reference's TF contract ("map -> odom ->
base_frame" and "imu -> lidar", reference: config/config_ros.json TF
block).

Duck-typed against the node surface (``create_subscription`` /
``create_publisher`` / optional ``create_timer``), so it runs under rclpy
(``python -m glim_tpu_torch.ros.node``) or against a fake node in tests;
rclpy is imported only in ``main()``.

Device state is never read on an estimation worker: when the odometry
announces a frame, the callback starts the copy of its state (and of its
pose covariance) to the host, and ``spin_once`` on the node's thread takes
the frame in once that copy has landed, at the first spin that finds it
ready, so the node thread does not wait on the card either; each frame is
published once. A points
message is decoded through numpy views and uploaded once, by the
pipeline's preprocessor, as a dataset scan is.

Config keys honored (config_ros.json / "glim_ros" section, the reference's
schema): enable_local_mapping, enable_global_mapping, imu_time_offset,
points_time_offset, acc_scale (0 = auto-detect g-units vs m/s^2),
imu/lidar/base/odom/map frame ids, publish_imu2lidar, tf_time_offset,
extension_modules, imu/points/image topics, *_qos depth.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from glim_tpu_torch.ros import messages as rosmsg
from glim_tpu_torch.ros.cloud_converter import extract_raw_points, to_sec
from glim_tpu_torch.ros.conditioning import GRAVITY, ImuConditioner  # noqa: F401
from glim_tpu_torch.ros.extension_module_ros import ExtensionModuleROS
from glim_tpu_torch.types import HostCopy
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("ros")


class RosNodeParams:
    def __init__(self, cfg):
        g = lambda k, d: cfg.param("glim_ros", k, d)  # noqa: E731
        self.enable_local_mapping = bool(g("enable_local_mapping", True))
        self.enable_global_mapping = bool(g("enable_global_mapping", True))
        self.keep_raw_points = bool(g("keep_raw_points", False))
        self.imu_time_offset = float(g("imu_time_offset", 0.0))
        self.points_time_offset = float(g("points_time_offset", 0.0))
        self.acc_scale = float(g("acc_scale", 0.0))
        self.imu_frame_id = str(g("imu_frame_id", ""))
        self.lidar_frame_id = str(g("lidar_frame_id", ""))
        self.base_frame_id = str(g("base_frame_id", ""))
        self.odom_frame_id = str(g("odom_frame_id", "odom"))
        self.map_frame_id = str(g("map_frame_id", "map"))
        self.publish_imu2lidar = bool(g("publish_imu2lidar", True))
        self.tf_time_offset = float(g("tf_time_offset", 1e-6))
        self.extension_modules = list(g("extension_modules", []))
        self.imu_topic = str(g("imu_topic", "/imu"))
        self.points_topic = str(g("points_topic", "/points"))
        self.image_topic = str(g("image_topic", "/image"))
        imu_qos = cfg.param("glim_ros", "imu_qos", {})
        points_qos = cfg.param("glim_ros", "points_qos", {})
        self.imu_qos_depth = int(imu_qos.get("depth", 1000) if isinstance(imu_qos, dict)
                                 else 1000)
        self.points_qos_depth = int(points_qos.get("depth", 10)
                                    if isinstance(points_qos, dict) else 10)


class _Announced:
    """A frame the odometry announced, with the host copy of its pose
    covariance (its state copy is the frame's own)."""

    def __init__(self, frame):
        frame.fetch_state_async()
        self.frame = frame
        cov = getattr(frame, "cov_pose", None)
        self.cov = HostCopy(cov) if isinstance(cov, torch.Tensor) else cov

    def ready(self) -> bool:
        return self.frame.state_ready() and (not isinstance(self.cov, HostCopy)
                                             or self.cov.ready())

    def take(self):
        """(stamp, T_odom_sensor, pose covariance or None) on the host."""
        self.frame.fetch_state()
        cov = self.cov.numpy() if isinstance(self.cov, HostCopy) else self.cov
        return (self.frame.stamp, np.asarray(self.frame.T_world_sensor()),
                None if cov is None else np.asarray(cov, np.float64))


class GlimROSNode:
    """Binds a (duck-typed) ROS node to the ``GlimTorch`` pipeline."""

    def __init__(self, node: Any, config_path: Optional[str] = None,
                 async_mode: bool = True, device="cuda"):
        from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks
        from glim_tpu_torch.pipeline import GlimTorch
        from glim_tpu_torch.utils.config import GlobalConfig, create_default_config_dir

        self.node = node
        if config_path is None:
            config_path = create_default_config_dir(
                tempfile.mkdtemp(prefix="glim_tpu_torch_ros_config_"))
        # Peek at the ROS section first to apply the back-end enable flags as
        # module-selection overrides before the pipeline builds its modules.
        GlobalConfig.reset()
        ros_cfg = GlobalConfig.instance(config_path).get_config("config_ros")
        self.params = RosNodeParams(ros_cfg)
        overrides: List[tuple] = []
        if not self.params.enable_local_mapping:
            overrides.append(("config_sub_mapping", "sub_mapping", "so_name",
                              "libsub_mapping_passthrough.so"))
        if not self.params.enable_global_mapping:
            overrides.append(("config_global_mapping", "global_mapping",
                              "enable_optimization", False))

        self.glim = GlimTorch(config_path=config_path, async_mode=async_mode,
                              extension_modules=self.params.extension_modules,
                              overrides=overrides, device=device)

        # acc_scale=0 -> auto-detect (shared with glim_runner bag playback).
        self._imu_cond = ImuConditioner(self.params.acc_scale, self.params.imu_time_offset)
        self._lock = threading.Lock()
        self._announced: List[_Announced] = []   # frames whose copies are in flight

        # Publishers (topic names follow the reference's glim_ros layout).
        pub = node.create_publisher
        self.pub_odom = pub(type(rosmsg.make_odometry(0.0, "map", "base", np.eye(4))),
                            "/glim_ros/odom", 10)
        self.pub_pose = pub(type(rosmsg.make_pose_stamped(0.0, "map", np.eye(4))),
                            "/glim_ros/pose", 10)
        self.pub_tf = pub(type(rosmsg.make_tf_message([])), "/tf", 10)

        # Subscriptions (real message classes under rclpy, else duck-typed).
        sub = node.create_subscription
        imu_cls = rosmsg._ros_class("sensor_msgs.msg", "Imu") or object
        pc2_cls = rosmsg._ros_class("sensor_msgs.msg", "PointCloud2") or object
        img_cls = rosmsg._ros_class("sensor_msgs.msg", "Image") or object
        self._subs = [
            sub(imu_cls, self.params.imu_topic, self.imu_callback, self.params.imu_qos_depth),
            sub(pc2_cls, self.params.points_topic, self.points_callback,
                self.params.points_qos_depth),
            sub(img_cls, self.params.image_topic, self.image_callback, 10),
        ]
        # Extension-module topic subscriptions (reference:
        # extension_module_ros2.hpp GenericTopicSubscription binding).
        for ext in self.glim.extensions:
            if isinstance(ext, ExtensionModuleROS):
                for s in ext.create_subscriptions():
                    s.create_subscriber(node)
            if hasattr(ext, "bind_node"):
                ext.bind_node(node, self)

        self._cb_handle = OdometryEstimationCallbacks.on_new_frame.add(self._on_new_frame)

        # Publish on a timer when the node offers one (a failure to create it
        # raises); otherwise the caller drives spin_once().
        self._timer = node.create_timer(0.05, self.spin_once) \
            if hasattr(node, "create_timer") else None

    # -- sensor callbacks --

    def imu_callback(self, msg) -> None:
        stamp, acc, gyro = rosmsg.imu_to_arrays(msg)
        if not self.params.imu_frame_id:
            fid = getattr(getattr(msg, "header", None), "frame_id", "")
            if fid:
                self.params.imu_frame_id = fid
        for sample in self._imu_cond.condition(stamp, acc, gyro):
            self.glim.insert_imu(*sample)

    def points_callback(self, msg) -> None:
        raw = extract_raw_points(msg)
        if raw is None:
            return
        if not self.params.lidar_frame_id:
            fid = getattr(getattr(msg, "header", None), "frame_id", "")
            if fid:
                self.params.lidar_frame_id = fid
        if self.params.points_time_offset != 0.0:
            raw.stamp = raw.stamp + self.params.points_time_offset
        self.glim.insert_frame(raw)

    def image_callback(self, msg) -> None:
        from glim_tpu_torch.io.rosbag import image_msg_to_array

        stamp = to_sec(getattr(getattr(msg, "header", None), "stamp", None))
        # Decode the ROS Image to a numpy array before fan-out so extension
        # consumers (e.g. the image loop detector) see pixel data. Only the
        # decoder's own input errors (an unknown encoding, a short buffer)
        # fall back to the raw message.
        try:
            image = image_msg_to_array(msg)
        except (ValueError, KeyError) as e:
            logger.warning("image decode failed (%s); forwarding raw msg", e)
            image = msg
        self.glim.insert_image(stamp, image)

    # -- publishing --

    def _on_new_frame(self, frame) -> None:
        """On the odometry worker: start the host copies, read nothing."""
        announced = _Announced(frame)
        with self._lock:
            self._announced.append(announced)

    def _take_landed(self) -> List[tuple]:
        """Take in, oldest first, every announced frame whose copies have
        landed: [(stamp, T_odom_sensor, cov)]."""
        with self._lock:
            n = 0
            while n < len(self._announced) and self._announced[n].ready():
                n += 1
            landed, self._announced = self._announced[:n], self._announced[n:]
        return [a.take() for a in landed]

    def spin_once(self) -> None:
        """Pump pipeline results, then publish odom / pose / TF once for
        each frame whose state has reached the host since the last spin
        (the JAX node republishes its newest frame at every spin)."""
        if self.glim.async_mode:
            self.glim._guarded(self.glim._pump)
        for stamp, T_odom_base, cov in self._take_landed():
            self._publish(stamp, T_odom_base, cov)

    def _publish(self, stamp: float, T_odom_base: np.ndarray, cov) -> None:
        T_world_odom = self.glim.trajectory.get_T_world_odom()
        p = self.params
        base = p.base_frame_id or p.imu_frame_id or "imu"
        self.pub_odom.publish(rosmsg.make_odometry(stamp, p.odom_frame_id, base, T_odom_base,
                                                   cov))
        self.pub_pose.publish(rosmsg.make_pose_stamped(stamp, p.map_frame_id,
                                                       T_world_odom @ T_odom_base))

        tf_stamp = stamp + p.tf_time_offset
        tfs = [rosmsg.make_transform_stamped(tf_stamp, p.map_frame_id, p.odom_frame_id,
                                             T_world_odom),
               rosmsg.make_transform_stamped(tf_stamp, p.odom_frame_id, base, T_odom_base)]
        if p.publish_imu2lidar:
            T_imu_lidar = np.linalg.inv(self.glim.T_lidar_imu)
            tfs.append(rosmsg.make_transform_stamped(tf_stamp, p.imu_frame_id or "imu",
                                                     p.lidar_frame_id or "lidar", T_imu_lidar))
        self.pub_tf.publish(rosmsg.make_tf_message(tfs))

    # -- control --

    def save(self, path: str) -> None:
        self.glim.wait()
        self.glim.save(path)

    def stop(self) -> None:
        from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks
        OdometryEstimationCallbacks.on_new_frame.remove(self._cb_handle)


def main(argv=None):  # pragma: no cover - requires a live ROS 2 install
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None)
    ap.add_argument("--dump", default=os.path.join(tempfile.gettempdir(),
                                                   "glim_tpu_torch_dump"))
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)

    try:
        import rclpy
        from rclpy.node import Node
    except ImportError as e:
        raise SystemExit(
            "rclpy is required for the live node; use "
            "glim_tpu_torch.tools.glim_runner (datasets and recorded bags) or "
            "glim_tpu_torch.tools.bag_converter on hosts without ROS") from e

    rclpy.init()
    node = Node("glim_ros")
    glim_node = GlimROSNode(node, config_path=args.config, device=args.device)
    try:
        rclpy.spin(node)
    except KeyboardInterrupt:
        pass
    finally:
        glim_node.save(args.dump)
        glim_node.stop()
        node.destroy_node()
        rclpy.shutdown()


if __name__ == "__main__":
    main()
