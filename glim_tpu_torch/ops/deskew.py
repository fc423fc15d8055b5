"""Scan deskewing (motion compensation).

Twin of ``glim_tpu/ops/deskew.py``: constant-twist deskew and IMU-rate
deskew by slerp/lerp of the IMU pose stream. Output points live in the
LiDAR frame at scan start.
"""

from __future__ import annotations

import torch

from glim_tpu_torch.ops.lie import (quat_slerp, quat_to_rot, rot_to_quat,
                                    se3_exp, se3_inv)


def deskew_twist(points: torch.Tensor, times: torch.Tensor, mask: torch.Tensor,
                 twist: torch.Tensor) -> torch.Tensor:
    """Constant-twist deskew: point i is moved by Exp(times[i] * twist)."""
    T = se3_exp(times[:, None] * twist[None, :])            # (C, 4, 4)
    p = (T[:, :3, :3] @ points[:, :, None])[..., 0] + T[:, :3, 3]
    return torch.where(mask[:, None], p, points)


def deskew_imu(points, times, mask, imu_stamps, imu_quats, imu_trans,
               T_lidar_imu) -> torch.Tensor:
    """Deskew against an IMU-rate pose stream (stamps ascending, padding at
    +inf): points (C, 3) captured at ``times`` -> LiDAR frame at the
    earliest valid point time."""
    K = imu_stamps.shape[0]
    t = times
    idx = torch.clamp(torch.searchsorted(imu_stamps, t, right=False), 1, K - 1)
    t0 = imu_stamps[idx - 1]
    t1 = imu_stamps[idx]
    a = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)

    q = quat_slerp(imu_quats[idx - 1], imu_quats[idx], a)
    trans = imu_trans[idx - 1] * (1.0 - a[:, None]) + imu_trans[idx] * a[:, None]
    R_wi = quat_to_rot(q)                                   # (C, 3, 3)

    # The reference sample stays a (1,) index tensor: indexing with a 0-dim
    # tensor would read it back to the host.
    t_ref = torch.min(torch.where(mask, t, float("inf")))[None]
    i_ref = torch.clamp(torch.searchsorted(imu_stamps, t_ref, right=False), 1, K - 1)
    a_ref = torch.clamp((t_ref - imu_stamps[i_ref - 1])
                        / torch.clamp(imu_stamps[i_ref] - imu_stamps[i_ref - 1], min=1e-9),
                        0.0, 1.0)
    q_ref = quat_slerp(imu_quats[i_ref - 1], imu_quats[i_ref], a_ref)[0]
    p_ref = (imu_trans[i_ref - 1] * (1.0 - a_ref) + imu_trans[i_ref] * a_ref)[0]
    R_ref = quat_to_rot(q_ref)

    # p_out = (T_w_L(ref))^-1 * T_w_L(t) * p, with T_w_L = T_w_imu * T_imu_lidar.
    T_imu_lidar = se3_inv(T_lidar_imu)
    R_il = T_imu_lidar[:3, :3]
    p_il = T_imu_lidar[:3, 3]
    p_imu = points @ R_il.T + p_il
    p_w = (R_wi @ p_imu[:, :, None])[..., 0] + trans
    p_imu_ref = (p_w - p_ref) @ R_ref
    p_lidar = (p_imu_ref - p_il) @ R_il
    return torch.where(mask[:, None], p_lidar, points)


def imu_pose_table(stamps, Rs, ps):
    """Pack an IMU-rate pose stream into (stamps, quats, trans)."""
    return stamps, rot_to_quat(Rs), ps
