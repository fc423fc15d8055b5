"""Timestamp sanitization for LiDAR scans and IMU samples.

Equivalent behavior to the reference's ``TimeKeeper`` /
``PerPointTimeSettings`` (reference: src/glim/util/time_keeper.cpp:36-228):

- Autoconfigures per-point time semantics on the first scan: relative vs
  absolute, second vs nanosecond scale (incl. the Livox float64-nanosecond
  heuristic for stamps > 1e16).
- Synthesizes pseudo per-point times from an estimated scan duration (median
  over up to 1000 inter-frame gaps) when the sensor provides none.
- Detects timestamp rewinds (scan dropped) and large gaps (warned).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from glim_tpu_torch.types import RawPoints
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("time")


@dataclass
class PerPointTimeSettings:
    autoconf: bool = True
    prefer_frame_time: bool = False
    relative_time: bool = True
    point_time_scale: float = 1.0

    @staticmethod
    def from_config(config) -> "PerPointTimeSettings":
        s = PerPointTimeSettings()
        s.autoconf = config.param("sensors", "autoconf_perpoint_times", True)
        s.prefer_frame_time = config.param("sensors", "autoconf_prefer_frame_time", False)
        if not s.autoconf:
            s.relative_time = config.param("sensors", "perpoint_relative_time", True)
            s.point_time_scale = config.param("sensors", "perpoint_time_scale", 1.0)
        return s


class TimeKeeper:
    def __init__(self, settings: Optional[PerPointTimeSettings] = None):
        self.settings = settings or PerPointTimeSettings()
        self.last_points_stamp = -1.0
        self.last_imu_stamp = -1.0
        self.estimated_scan_duration = -1.0
        self.point_time_offset = 0.0
        self._scan_duration_history: List[float] = []
        self._warned_no_times = False

    # --- IMU ---
    def validate_imu_stamp(self, imu_stamp: float) -> bool:
        diff = imu_stamp - self.last_imu_stamp
        if self.last_imu_stamp < 0.0:
            pass  # first sample
        elif imu_stamp < self.last_imu_stamp:
            logger.warning("IMU timestamp rewind detected: current=%.6f last=%.6f diff=%.6f",
                           imu_stamp, self.last_imu_stamp, diff)
            return False
        elif diff > 0.1:
            logger.warning("large time gap between consecutive IMU data: diff=%.6f", diff)
        self.last_imu_stamp = imu_stamp

        pts_diff = imu_stamp - self.last_points_stamp
        if self.last_points_stamp > 0.0 and abs(pts_diff) > 1.0:
            logger.warning("large time difference between points and imu: diff=%.6f", pts_diff)
        return True

    # --- LiDAR ---
    def process(self, points: RawPoints) -> bool:
        """Sanitize a scan in place; returns False if it must be dropped."""
        self._replace_points_stamp(points)

        t = points.times
        if t is not None and len(t):
            if t[0] < 0.0 or t[-1] < 0.0:
                logger.error("negative per-point timestamp after conversion: front=%.6f back=%.6f", t[0], t[-1])
            if t[0] > 1.0 or t[-1] > 1.0:
                logger.error("large per-point timestamp after conversion: front=%.6f back=%.6f", t[0], t[-1])
        if points.stamp < 0.0:
            logger.warning("frame timestamp is negative: %.6f", points.stamp)

        time_diff = points.stamp - self.last_points_stamp
        ok = True
        if self.last_points_stamp < 0.0:
            pass  # first frame
        elif time_diff < 0.0:
            logger.warning("point timestamp rewind detected: current=%.6f last=%.6f", points.stamp, self.last_points_stamp)
            ok = False
        elif time_diff > 0.5:
            logger.warning("large time gap between consecutive LiDAR frames: diff=%.6f", time_diff)
        if ok:
            self.last_points_stamp = points.stamp
        return ok

    def _replace_points_stamp(self, points: RawPoints) -> None:
        s = self.settings
        n = points.size

        # No per-point timestamps -> synthesize from estimated scan duration.
        if points.times is None or len(points.times) == 0:
            if not self._warned_no_times:
                logger.warning("per-point timestamps not given; synthesizing pseudo times from scan order")
                self._warned_no_times = True
            duration = self._estimate_scan_duration(points.stamp)
            if duration > 0.0:
                points.times = duration * np.arange(n, dtype=np.float64) / n
            else:
                points.times = np.zeros(n, dtype=np.float64)
            return

        times = np.asarray(points.times, dtype=np.float64)
        if times.shape[0] != n:
            logger.warning("#timestamps (%d) != #points (%d); zeroing per-point times", times.shape[0], n)
            points.times = np.zeros(n, dtype=np.float64)
            return

        min_time = float(times.min())
        max_time = float(times.max())

        if s.autoconf:
            s.autoconf = False
            if min_time < 0.0:
                logger.warning("negative per-point timestamps found: min=%.6f max=%.6f", min_time, max_time)
            if max_time < 1.0:
                s.relative_time = True
            else:
                s.relative_time = False
                logger.warning("large point timestamps (max=%.6f > 1.0): assuming absolute times", max_time)
                if min_time > 1e16:
                    logger.warning("very large point timestamps (>1e16): assuming float64-nanosecond times (Livox)")
                    s.point_time_scale = 1e-9

        if s.relative_time:
            if min_time < 0.0:
                if not s.prefer_frame_time:
                    points.stamp += min_time * s.point_time_scale
                times = times - min_time
            if abs(s.point_time_scale - 1.0) > 1e-6:
                times = times * s.point_time_scale
            points.times = times
            return

        # Absolute per-point timestamps.
        if not s.prefer_frame_time:
            points.stamp = min_time * s.point_time_scale
        points.times = (times - min_time) * s.point_time_scale

    def _estimate_scan_duration(self, stamp: float) -> float:
        if self.estimated_scan_duration > 0.0:
            return self.estimated_scan_duration
        if self.last_points_stamp < 0:
            return -1.0
        self._scan_duration_history.append(stamp - self.last_points_stamp)
        duration = float(np.median(self._scan_duration_history))
        if len(self._scan_duration_history) == 1000:
            logger.info("estimated scan duration: %f", duration)
            self.estimated_scan_duration = duration
            self._scan_duration_history = []
        if duration < 0.01 or duration > 1.0:
            logger.warning("invalid scan duration estimate: %f", duration)
            duration = -1.0
        return duration
