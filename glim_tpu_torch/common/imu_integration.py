"""IMU sample queue + preintegration front-end.

Twin of ``glim_tpu/common/imu_integration.py``'s queue and
``integrate_imu``: a time-ordered queue of 7-vector samples [t, ax..az,
wx..wz] and the preintegration over [t0, t1] with a given bias, on
``device`` through ``ops/imu.preintegrate``. The samples go up in one
pinned copy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from glim_tpu_torch.ops import imu as imu_ops
from glim_tpu_torch.types import upload


class IMUIntegration:
    def __init__(self, device, acc_noise: float = 0.05, gyro_noise: float = 0.02,
                 int_noise: float = 0.001, capacity: int = 256):
        self.device = torch.device(device)
        self.acc_noise = acc_noise
        self.gyro_noise = gyro_noise
        self.int_noise = int_noise
        self.capacity = capacity
        self._data: List[np.ndarray] = []

    def insert_imu(self, stamp: float, linear_acc, angular_vel) -> None:
        self._data.append(np.concatenate([[stamp], np.asarray(linear_acc),
                                          np.asarray(angular_vel)]))

    @property
    def imu_data(self) -> List[np.ndarray]:
        return self._data

    def find_imu_data(self, t0: float, t1: float) -> np.ndarray:
        rows = [r for r in self._data if t0 - 1e-9 <= r[0] <= t1 + 1e-9]
        return np.stack(rows) if rows else np.zeros((0, 7))

    def erase_imu_data(self, before: float) -> None:
        self._data = [r for r in self._data if r[0] >= before]

    def integrate_imu(self, t0: float, t1: float, bias: np.ndarray
                      ) -> Tuple[imu_ops.PreintegratedImu, int]:
        """Preintegrate [t0, t1]; returns (preint, num_samples_used)."""
        rows = self.find_imu_data(t0, t1)
        cap = self.capacity
        n = min(len(rows), cap)
        # One (cap, 8) block [acc (3), gyro (3), dt, mask] and the bias.
        block = np.zeros((cap, 8), np.float32)
        prev = t0
        for i in range(n):
            block[i, :6] = rows[i, 1:7]
            block[i, 6] = max(rows[i, 0] - prev, 0.0)
            block[i, 7] = 1.0
            prev = rows[i, 0]
        dev = upload(np.concatenate([block.reshape(-1), np.asarray(bias, np.float32)]),
                     self.device)
        block_d, bias_d = dev[:cap * 8].reshape(cap, 8), dev[cap * 8:]
        pre = imu_ops.preintegrate(block_d[:, :3], block_d[:, 3:6], block_d[:, 6],
                                   block_d[:, 7] > 0, bias_d, self.acc_noise,
                                   self.gyro_noise, self.int_noise)
        return pre, n

    def integrate_imu_rate_poses(self, T0: np.ndarray, v0: np.ndarray, bias: np.ndarray,
                                 t0: float, t1: float,
                                 gravity=np.array([0.0, 0.0, -9.80665])):
        """World poses after each sample in [t0, t1] (dead reckoning from
        the state (T0, v0) with ``bias``), on ``device`` -> (stamps (K,),
        Rs (K, 3, 3), ps (K, 3)), or None with fewer than 2 samples."""
        rows = self.find_imu_data(t0, t1)
        if len(rows) < 2:
            return None
        dts = np.diff(rows[:, 0], prepend=rows[0, 0])
        T0 = np.asarray(T0)
        state = np.concatenate([T0[:3, :3].reshape(-1), T0[:3, 3], np.asarray(v0),
                                np.asarray(bias), np.asarray(gravity)])
        dev_state = upload(state.astype(np.float32), self.device)
        dev_rows = upload(np.concatenate([rows[:, 1:7], dts[:, None]], 1).astype(np.float32),
                          self.device)
        Rs, ps, _ = imu_ops.integrate_poses(
            dev_state[:9].reshape(3, 3), dev_state[9:12], dev_state[12:15],
            dev_state[15:21], dev_state[21:24], dev_rows[:, :3], dev_rows[:, 3:6],
            dev_rows[:, 6], torch.ones(len(rows), dtype=torch.bool, device=self.device))
        return rows[:, 0], Rs, ps
