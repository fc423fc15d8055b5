"""Online IMU health validation.

Equivalent behavior to the reference's ``IMUValidation``
(reference: src/glim/common/imu_validation.cpp:13-175): for every frame,
compare the IMU-predicted state against a constant-velocity prediction and
the optimized state; keep running win-ratio statistics and warn every 64
frames when the IMU stops outperforming the naive predictor (thresholds
rot > 0.7, trans > 0.4, vel > 0.5 as in the reference heuristics) — the
symptom of wrong extrinsics, bad time sync, or miscalibrated noise.

``IMUValidatorExtension`` (registered as ``imu_validator``) feeds it from
the odometry callbacks alone. A frame is validated one frame after it is
estimated: its state copy (``EstimationFrame.fetch_state_async``) and the
copy of its dead-reckoned prediction (``IMUIntegration`` on the pipeline's
device, read through a ``HostCopy``) start when it is announced and are
read at the next frame, when they have landed, so the odometry worker never
waits on the card for them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from glim_tpu_torch.ops import lie_np
from glim_tpu_torch.types import HostCopy
from glim_tpu_torch.utils.extension_module import ExtensionModule
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.registry import register_module

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


class IMUValidatorExtension(ExtensionModule):
    """``libimu_validator.so``: checks the IMU calibration's health from the
    odometry callback stream (reference: config/config_ros.json
    extension_modules). Dead-reckons from each optimized frame state to the
    next frame's stamp and feeds :class:`IMUValidation` the prediction
    against the optimized result."""

    def __init__(self, device="cuda"):
        from glim_tpu_torch.common.imu_integration import IMUIntegration
        from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks as O

        self.validation = IMUValidation()
        self.integration = IMUIntegration(device)
        self.frames_validated = 0
        self._last = None      # (stamp, T_world_imu, v_world_imu, bias)
        self._pending = None   # the announced frame whose state copy is in flight
        self._pred = None      # (dt, last sample interval, HostCopy of R, p, p_prev)
        self._handles = [(O.on_insert_imu, O.on_insert_imu.add(self._on_imu)),
                         (O.on_new_frame, O.on_new_frame.add(self._on_frame))]

    def detach(self) -> None:
        for slot, h in self._handles:
            slot.remove(h)
        self._handles = []

    def at_exit(self, dump_path: str) -> None:
        self.validation.report()
        self.detach()

    def _on_imu(self, stamp, acc, gyro) -> None:
        self.integration.insert_imu(stamp, acc, gyro)

    def _on_frame(self, frame) -> None:
        frame.fetch_state_async()
        prev, self._pending = self._pending, frame
        if prev is not None:
            self._validate(prev)
        self._predict(frame)

    def _predict(self, frame) -> None:
        """Start the dead reckoning from the last validated state to
        ``frame``'s stamp, and the copy of its last pose and position."""
        self._pred = None
        if self._last is None:
            return
        t0, T0, v0, bias = self._last
        dt = frame.stamp - t0
        pred = self.integration.integrate_imu_rate_poses(T0, v0, bias, t0, frame.stamp)
        if pred is not None and dt > 1e-6:
            stamps, Rs, ps = pred
            tail = torch.cat([Rs[-1].reshape(-1), ps[-1], ps[-2]])
            self._pred = (dt, float(stamps[-1] - stamps[-2]), HostCopy(tail))
        self.integration.erase_imu_data(t0 - 1.0)

    def _validate(self, frame) -> None:
        frame.fetch_state()
        T = np.asarray(frame.T_world_imu, np.float64)
        v = np.asarray(frame.v_world_imu, np.float64)
        if self._pred is not None:
            dt, dts, copy = self._pred
            tail = copy.numpy().astype(np.float64)
            T_pred = np.eye(4)
            T_pred[:3, :3] = tail[:9].reshape(3, 3)
            T_pred[:3, 3] = tail[9:12]
            v_pred = (tail[9:12] - tail[12:15]) / max(dts, 1e-6)
            self.validation.validate(T_pred, v_pred, T, v, dt)
            self.frames_validated += 1
        self._last = (frame.stamp, T, v, np.asarray(frame.imu_bias, np.float64))


@register_module("extension", "imu_validator")
def create_extension_module(*args, device="cuda", **kwargs):
    return IMUValidatorExtension(device=device)
