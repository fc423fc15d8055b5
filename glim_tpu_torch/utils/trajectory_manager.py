"""Odometry->world frame anchoring.

Equivalent behavior to the reference's ``TrajectoryManager``
(reference: src/glim/util/trajectory_manager.cpp:15-72): maintains the
``T_world_odom`` anchor by interpolating the odometry pose stream at each
globally-corrected pose's stamp; lets consumers render low-latency odometry
poses in the globally-consistent map frame.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np

from glim_tpu_torch.ops import lie_np


class TrajectoryManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._odom_stamps: List[float] = [0.0]
        self._T_odom_sensor: List[np.ndarray] = [np.eye(4)]
        self.T_world_odom = np.eye(4)

    def add_odom(self, stamp: float, T_odom_sensor: np.ndarray, priority: int = 1) -> None:
        with self._lock:
            self._odom_stamps.append(float(stamp))
            self._T_odom_sensor.append(np.asarray(T_odom_sensor, dtype=np.float64))
            # Bound memory: keep the most recent window.
            if len(self._odom_stamps) > 100000:
                self._odom_stamps = self._odom_stamps[-50000:]
                self._T_odom_sensor = self._T_odom_sensor[-50000:]

    def update_anchor(self, stamp: float, T_world_sensor: np.ndarray) -> None:
        with self._lock:
            T_odom_sensor = self._interp(float(stamp))
            self.T_world_odom = np.asarray(T_world_sensor, np.float64) @ np.linalg.inv(T_odom_sensor)

    def current_pose(self) -> np.ndarray:
        with self._lock:
            return self.T_world_odom @ self._T_odom_sensor[-1]

    def odom2world(self, T_odom_sensor: np.ndarray) -> np.ndarray:
        with self._lock:
            return self.T_world_odom @ np.asarray(T_odom_sensor, np.float64)

    def get_T_world_odom(self) -> np.ndarray:
        with self._lock:
            return self.T_world_odom.copy()

    def _interp(self, stamp: float) -> np.ndarray:
        stamps = self._odom_stamps
        if stamp <= stamps[0]:
            return self._T_odom_sensor[0]
        if stamp >= stamps[-1]:
            return self._T_odom_sensor[-1]
        idx = int(np.searchsorted(stamps, stamp))
        t0, t1 = stamps[idx - 1], stamps[idx]
        a = 0.0 if t1 <= t0 else (stamp - t0) / (t1 - t0)
        return lie_np.se3_interpolate(self._T_odom_sensor[idx - 1], self._T_odom_sensor[idx], a)
