"""Rviz viewer extension: publishes clouds for live visualization.

Twin of ``glim_tpu/ros/rviz_viewer.py`` (the reference's
``librviz_viewer.so``, config/config_ros.json extension_modules): publishes
the current aligned scan and a periodically refreshed global map so rviz
(or any PointCloud2 consumer) can render the session live. TF and odometry
are published by ``ros/node.GlimROSNode``; this module adds

  /glim_ros/aligned_points   the newest scan in the map frame
  /glim_ros/map              the global map (refreshed on submap update)

The estimation callbacks read nothing from the device: an announced frame
starts the host copies of its points, its mask and its state, and
``spin_once`` on the node's thread publishes the newest frame whose copies
have landed. The map comes from ``GlimTorch.export_points``, which reads
the submaps under the async global-mapping wrapper's mutex.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List

import numpy as np

from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks
from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks
from glim_tpu_torch.ros import messages as rosmsg
from glim_tpu_torch.ros.extension_module_ros import ExtensionModuleROS
from glim_tpu_torch.types import HostCopy
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("rviz")


class _Scan:
    """An announced frame with the host copies of its cloud and state."""

    def __init__(self, frame):
        frame.fetch_state_async()
        self.frame = frame
        self.points = HostCopy(frame.frame.points)
        self.mask = HostCopy(frame.frame.mask)

    def ready(self) -> bool:
        return self.frame.state_ready() and self.points.ready() and self.mask.ready()


class RvizViewer(ExtensionModuleROS):
    def __init__(self, map_publish_interval: float = 5.0,
                 max_map_points: int = 500_000):
        self.map_publish_interval = map_publish_interval
        self.max_map_points = max_map_points
        self._lock = threading.Lock()
        self._scans: List[_Scan] = []        # announced, copies in flight
        self._map_dirty = False
        self._last_map_publish = 0.0
        self._node = None
        self._glim_node = None
        self._pub_aligned = None
        self._pub_map = None
        self._handles = [
            (OdometryEstimationCallbacks.on_new_frame,
             OdometryEstimationCallbacks.on_new_frame.add(self._on_new_frame)),
            (GlobalMappingCallbacks.on_update_submaps,
             GlobalMappingCallbacks.on_update_submaps.add(self._on_update_submaps)),
        ]

    # -- node binding (called by GlimROSNode) --

    def bind_node(self, node: Any, glim_node: Any) -> None:
        self._node = node
        self._glim_node = glim_node
        cloud_cls = type(rosmsg.make_pointcloud2(0.0, "map", np.zeros((0, 3))))
        self._pub_aligned = node.create_publisher(cloud_cls, "/glim_ros/aligned_points", 10)
        self._pub_map = node.create_publisher(cloud_cls, "/glim_ros/map", 1)
        if hasattr(node, "create_timer"):      # a failure to create it raises
            node.create_timer(0.1, self.spin_once)

    # -- estimation callbacks (worker threads: start copies, read nothing) --

    def _on_new_frame(self, frame) -> None:
        if frame.frame is None or frame.frame.points is None:
            return
        scan = _Scan(frame)
        with self._lock:
            self._scans.append(scan)

    def _on_update_submaps(self, submaps) -> None:
        with self._lock:
            self._map_dirty = True

    # -- publishing (node thread) --

    def spin_once(self) -> None:
        if self._glim_node is None:
            return
        p = self._glim_node.params
        with self._lock:
            n = 0
            while n < len(self._scans) and self._scans[n].ready():
                n += 1
            landed, self._scans = self._scans[:n], self._scans[n:]
            map_due = self._map_dirty and (
                time.time() - self._last_map_publish > self.map_publish_interval)

        if landed and self._pub_aligned is not None:
            scan = landed[-1]
            scan.frame.fetch_state()
            traj = self._glim_node.glim.trajectory
            T_map_sensor = traj.odom2world(np.asarray(scan.frame.T_world_sensor()))
            # The batch's points live in the sensor (lidar) frame.
            pts = scan.points.numpy()[scan.mask.numpy().astype(bool)].astype(np.float64)
            aligned = pts[:, :3] @ T_map_sensor[:3, :3].T + T_map_sensor[:3, 3]
            self._pub_aligned.publish(rosmsg.make_pointcloud2(scan.frame.stamp,
                                                              p.map_frame_id, aligned))

        if map_due and self._pub_map is not None:
            pts = self._glim_node.glim.export_points()
            if pts is not None and len(pts):
                if len(pts) > self.max_map_points:
                    sel = np.random.default_rng(0).choice(len(pts), self.max_map_points,
                                                          replace=False)
                    pts = pts[sel]
                self._pub_map.publish(rosmsg.make_pointcloud2(
                    time.time(), p.map_frame_id, np.asarray(pts)[:, :3]))
            with self._lock:
                self._map_dirty = False
                self._last_map_publish = time.time()

    def detach(self) -> None:
        for slot, h in self._handles:
            slot.remove(h)
        self._handles = []

    def at_exit(self, dump_path: str) -> None:
        self.detach()


@register_module("extension", "rviz_viewer")
def create_extension_module(*args, **kwargs):
    return RvizViewer()
