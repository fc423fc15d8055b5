"""Standalone input-diagnostics module.

Equivalent behavior to the reference's ``DataValidator``
(reference: src/glim/util/data_validator.cpp:13-110): tracks LiDAR/IMU rates,
stamp gaps and rewinds, non-finite points, per-point time sanity, and the
IMU<->LiDAR time offset; reports periodically through a duplicate-suppressed
logger so a misconfigured sensor setup is diagnosed before SLAM quietly
diverges.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque

import numpy as np

from glim_tpu_torch.types import RawPoints
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("validator")


class _DupFilter:
    """Suppress repeats of the same message within `window` seconds."""

    def __init__(self, window: float = 5.0):
        self.window = window
        self._last: dict = {}

    def __call__(self, level, msg, *args):
        now = time.time()
        if now - self._last.get(msg, 0.0) > self.window:
            self._last[msg] = now
            getattr(logger, level)(msg, *args)


class DataValidator:
    def __init__(self, report_interval: float = 10.0):
        self.report_interval = report_interval
        self._log = _DupFilter()
        self.imu_stamps: Deque[float] = deque(maxlen=1024)
        self.points_stamps: Deque[float] = deque(maxlen=256)
        self.num_imu = 0
        self.num_points = 0
        self.num_nonfinite = 0
        self.last_report = time.time()

    def imu_callback(self, stamp: float, linear_acc, angular_vel) -> None:
        self.num_imu += 1
        if self.imu_stamps and stamp < self.imu_stamps[-1]:
            self._log("warning", "IMU stamp rewind: %.6f -> %.6f",
                      self.imu_stamps[-1], stamp)
        if self.imu_stamps and stamp - self.imu_stamps[-1] > 0.1:
            self._log("warning", "IMU gap: %.3fs", stamp - self.imu_stamps[-1])
        acc = np.linalg.norm(linear_acc)
        if acc < 5.0 or acc > 50.0:
            self._log("warning", "implausible |acc|=%.2f (gravity-scaled? acc_scale?)", acc)
        self.imu_stamps.append(stamp)
        self._maybe_report()

    def points_callback(self, raw: RawPoints) -> None:
        self.num_points += 1
        if self.points_stamps and raw.stamp < self.points_stamps[-1]:
            self._log("warning", "points stamp rewind: %.6f -> %.6f",
                      self.points_stamps[-1], raw.stamp)
        pts = np.asarray(raw.points)
        nf = int((~np.isfinite(pts).all(axis=-1)).sum())
        if nf:
            self.num_nonfinite += nf
            self._log("warning", "%d non-finite points in scan", nf)
        if raw.times is not None and len(raw.times):
            t = np.asarray(raw.times)
            if t.max() - t.min() > 1.0:
                self._log("warning", "per-point time span %.3fs > 1s (wrong scale?)",
                          t.max() - t.min())
        if self.imu_stamps:
            off = raw.stamp - self.imu_stamps[-1]
            if abs(off) > 1.0:
                self._log("warning", "LiDAR-IMU time offset %.3fs (sync?)", off)
        self.points_stamps.append(raw.stamp)
        self._maybe_report()

    def timer_callback(self) -> None:
        self._report()

    def _maybe_report(self) -> None:
        if time.time() - self.last_report > self.report_interval:
            self._report()

    def _report(self) -> None:
        self.last_report = time.time()
        imu_hz = 0.0
        if len(self.imu_stamps) > 1:
            span = self.imu_stamps[-1] - self.imu_stamps[0]
            imu_hz = (len(self.imu_stamps) - 1) / span if span > 0 else 0.0
        pts_hz = 0.0
        if len(self.points_stamps) > 1:
            span = self.points_stamps[-1] - self.points_stamps[0]
            pts_hz = (len(self.points_stamps) - 1) / span if span > 0 else 0.0
        logger.info("input rates: points %.1f Hz, imu %.1f Hz (%d scans, %d imu, %d bad pts)",
                    pts_hz, imu_hz, self.num_points, self.num_imu, self.num_nonfinite)
