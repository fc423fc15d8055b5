"""Online IMU health validation.

Equivalent behavior to the reference's ``IMUValidation``
(reference: src/glim/common/imu_validation.cpp:13-175): for every frame,
compare the IMU-predicted state against a constant-velocity prediction and
the optimized state; keep running win-ratio statistics and warn every 64
frames when the IMU stops outperforming the naive predictor (thresholds
rot > 0.7, trans > 0.4, vel > 0.5 as in the reference heuristics) — the
symptom of wrong extrinsics, bad time sync, or miscalibrated noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from glim_tpu_torch.ops import lie_np
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("odom")


@dataclass
class RunningStatistics:
    """Streaming mean/var/min/max (gtsam_points::RunningStatistics role)."""

    n: int = 0
    mean: float = 0.0
    m2: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")

    def add(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    @property
    def var(self) -> float:
        return self.m2 / max(self.n - 1, 1)


class IMUValidation:
    def __init__(self, report_interval: int = 64):
        self.report_interval = report_interval
        self.frame_count = 0
        self.rot_wins = RunningStatistics()
        self.trans_wins = RunningStatistics()
        self.vel_wins = RunningStatistics()
        self._last: Optional[dict] = None

    def validate(self, T_imu_pred: np.ndarray, v_imu_pred: np.ndarray,
                 T_optimized: np.ndarray, v_optimized: np.ndarray,
                 dt: float) -> None:
        """Compare the IMU prediction of this frame's state with (a) the
        optimized result and (b) a constant-velocity prediction from the
        previous optimized state."""
        if self._last is not None and dt > 1e-6:
            T_prev, v_prev = self._last["T"], self._last["v"]
            # Constant-velocity prediction.
            T_cv = T_prev.copy()
            T_cv[:3, 3] = T_prev[:3, 3] + v_prev * dt
            e_imu = lie_np.se3_log(np.linalg.inv(T_imu_pred) @ T_optimized)
            e_cv = lie_np.se3_log(np.linalg.inv(T_cv) @ T_optimized)
            self.rot_wins.add(1.0 if np.linalg.norm(e_imu[:3]) <= np.linalg.norm(e_cv[:3]) else 0.0)
            self.trans_wins.add(1.0 if np.linalg.norm(e_imu[3:]) <= np.linalg.norm(e_cv[3:]) else 0.0)
            ev_imu = np.linalg.norm(v_imu_pred - v_optimized)
            ev_cv = np.linalg.norm(v_prev - v_optimized)
            self.vel_wins.add(1.0 if ev_imu <= ev_cv else 0.0)

        self._last = {"T": np.asarray(T_optimized, np.float64).copy(),
                      "v": np.asarray(v_optimized, np.float64).copy()}
        self.frame_count += 1
        if self.frame_count % self.report_interval == 0:
            self.report()

    def report(self) -> None:
        r, t, v = self.rot_wins.mean, self.trans_wins.mean, self.vel_wins.mean
        if self.rot_wins.n == 0:
            return
        logger.info("IMU validation: win ratios rot=%.2f trans=%.2f vel=%.2f (n=%d)",
                    r, t, v, self.rot_wins.n)
        # Reference heuristics (imu_validation.cpp:90-175).
        if r < 0.7:
            logger.warning("IMU rotation prediction underperforms (%.2f < 0.7): "
                           "check gyro noise/extrinsics/time sync", r)
        if t < 0.4:
            logger.warning("IMU translation prediction underperforms (%.2f < 0.4)", t)
        if v < 0.5:
            logger.warning("IMU velocity prediction underperforms (%.2f < 0.5)", v)
