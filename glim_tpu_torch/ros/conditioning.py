"""Shared sensor conditioning for live ROS and bag playback (host copy of
``glim_tpu/ros/conditioning.py``).

The reference routes both the live node and ``glim_rosbag`` through the same
GlimROS wrapper, so IMU scaling (acc_scale with g-unit auto-detection, as in
config_ros.json "Set to 9.80665 for Livox sensors") and the imu/points time
offsets are applied identically on either path. This module factors that
conditioning out of ``ros/node.py`` so ``tools/glim_runner.py``'s direct bag
playback applies the exact same rules.
"""

from __future__ import annotations

import collections
from typing import List, Tuple

import numpy as np

from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("ros")

GRAVITY = 9.80665


class ImuConditioner:
    """Applies ``acc_scale`` (0 = auto-detect g vs m/s^2 from the median
    acceleration norm) and ``imu_time_offset`` to raw IMU samples.

    ``condition(stamp, acc, gyro)`` returns a list of adjusted
    ``(stamp, acc, gyro)`` tuples: empty while auto-detection is still
    gathering evidence, then the buffered samples flush out (correctly
    scaled) together with the current one — no IMU data is lost during
    the detection window.
    """

    def __init__(self, acc_scale: float = 0.0, imu_time_offset: float = 0.0,
                 window: int = 100, min_samples: int = 10):
        self._acc_scale = float(acc_scale)
        self.imu_time_offset = float(imu_time_offset)
        self.min_samples = int(min_samples)
        self._acc_norms: collections.deque = collections.deque(maxlen=window)
        self._pending: List[Tuple[float, np.ndarray, np.ndarray]] = []

    @property
    def acc_scale(self) -> float:
        return self._acc_scale

    def condition(self, stamp: float, acc: np.ndarray,
                  gyro: np.ndarray) -> List[Tuple[float, np.ndarray,
                                                  np.ndarray]]:
        acc = np.asarray(acc, np.float64)
        gyro = np.asarray(gyro, np.float64)
        if self._acc_scale == 0.0:
            self._acc_norms.append(float(np.linalg.norm(acc)))
            self._pending.append((stamp, acc, gyro))
            if len(self._acc_norms) < self.min_samples:
                return []  # not enough evidence yet; buffer, don't mis-scale
            med = float(np.median(self._acc_norms))
            # Livox publishes acceleration in g; everything else in m/s^2.
            self._acc_scale = GRAVITY if 0.5 < med < 2.0 else 1.0
            logger.info("auto-detected acc_scale=%.5f (median |acc|=%.3f)",
                        self._acc_scale, med)
            pending, self._pending = self._pending, []
            return [(t + self.imu_time_offset, self._acc_scale * a, g)
                    for t, a, g in pending]
        return [(stamp + self.imu_time_offset, self._acc_scale * acc, gyro)]
