"""Scan deskewing front-end.

Twin of ``glim_tpu/common/cloud_deskewing.py`` (reference:
src/glim/common/cloud_deskewing.cpp:11-133): constant-twist and
IMU-pose-interpolation modes over ``ops/deskew.py``, on the points' device.
"""

from __future__ import annotations

import numpy as np
import torch

from glim_tpu_torch.ops import deskew as deskew_ops
from glim_tpu_torch.ops.lie import rot_to_quat


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a,
                           dtype=torch.float32, device=device)


class CloudDeskewing:
    def deskew_twist(self, points, times, mask, twist) -> torch.Tensor:
        """Constant-twist motion compensation (twist = [omega, v] per sec)."""
        return deskew_ops.deskew_twist(points, times, mask, _f32(twist, points.device))

    def deskew_imu(self, points, times, mask, imu_stamps, imu_Rs, imu_ps,
                   T_lidar_imu) -> torch.Tensor:
        """IMU-rate pose-stream motion compensation."""
        dev = points.device
        quats = rot_to_quat(_f32(imu_Rs, dev))
        return deskew_ops.deskew_imu(points, times, mask, _f32(imu_stamps, dev), quats,
                                     _f32(imu_ps, dev), _f32(T_lidar_imu, dev))
