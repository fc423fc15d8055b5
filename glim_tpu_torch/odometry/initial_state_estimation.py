"""Initial state estimation: NAIVE and LOOSE modes.

Equivalent capability to the reference's ``NaiveInitialStateEstimation``
(reference: src/glim/odometry/initial_state_estimation.cpp:12-88 — gravity
align from averaged accelerometer) and ``LooseInitialStateEstimation``
(reference: src/glim/odometry/loose_initial_state_estimation.cpp:27-197 —
LiDAR-only odometry over the init window, then a batch solve for initial
attitude/velocity/bias).

The LOOSE solve here is the classic linear visual/LiDAR-inertial alignment:
(1) gyro bias from the rotation mismatch between IMU preintegration and
LiDAR relative rotations (least squares through the preintegration bias
Jacobian), (2) a linear system in {per-frame velocities, gravity vector}
from the preintegrated position/velocity deltas, (3) the world attitude from
rotating the estimated gravity onto -z. Small dense f64 host math — this
runs once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from glim_tpu_torch.ops import lie_np
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("odom")

GRAVITY_W = np.array([0.0, 0.0, -9.80665])


@dataclass
class InitialState:
    """Hand-off from initialization to the odometry window."""

    stamp: float
    T_world_imu: np.ndarray       # (4, 4)
    v_world: np.ndarray           # (3,)
    bias: np.ndarray              # (6,) [ba, bg]


def naive_initial_state(imu_rows: np.ndarray, stamp: float,
                        fix_bias: bool = False) -> InitialState:
    """Gravity-align from the averaged accelerometer; gyro bias from the
    averaged rates (valid only when starting at rest)."""
    acc_mean = imu_rows[:, 1:4].mean(axis=0)
    gyro_mean = imu_rows[:, 4:7].mean(axis=0)
    a = acc_mean / max(np.linalg.norm(acc_mean), 1e-9)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(a, z)
    s = np.linalg.norm(v)
    c = float(a @ z)
    if s < 1e-8:
        R0 = np.eye(3) if c > 0 else lie_np.so3_exp(np.array([np.pi, 0, 0]))
    else:
        R0 = lie_np.so3_exp(v / s * np.arctan2(s, c))
    T0 = np.eye(4)
    T0[:3, :3] = R0
    bias = np.zeros(6)
    if not fix_bias:
        bias[3:] = gyro_mean
    return InitialState(stamp=stamp, T_world_imu=T0, v_world=np.zeros(3), bias=bias)


def _preintegrate_np(rows: np.ndarray, bg: np.ndarray):
    """f64 preintegration of one interval (rotation/velocity/position deltas
    + dR/dbg Jacobian), Euler discretization matching ops.imu."""
    R = np.eye(3)
    dv = np.zeros(3)
    dp = np.zeros(3)
    H_Rg = np.zeros((3, 3))
    dt_sum = 0.0
    prev_t = rows[0, 0]
    for r in rows[1:]:
        dt = r[0] - prev_t
        prev_t = r[0]
        if dt <= 0:
            continue
        a = r[1:4]
        w = r[4:7] - bg
        wdt = w * dt
        R_inc = lie_np.so3_exp(wdt)
        Jr = lie_np._left_jacobian(-wdt)
        dp = dp + dv * dt + 0.5 * (R @ a) * dt * dt
        dv = dv + (R @ a) * dt
        H_Rg = R_inc.T @ H_Rg - Jr * dt
        R = R @ R_inc
        dt_sum += dt
    return R, dv, dp, H_Rg, dt_sum


def loose_initial_state(lidar_poses: List[Tuple[float, np.ndarray]],
                        imu_rows: np.ndarray, T_lidar_imu: np.ndarray
                        ) -> Optional[InitialState]:
    """Solve initial attitude/velocity/gyro-bias from LiDAR odometry + IMU.

    lidar_poses: [(stamp, T_odom_lidar)] over the init window (odom frame =
    the first LiDAR pose's frame, gravity direction unknown).
    """
    if len(lidar_poses) < 3:
        return None
    # IMU poses in the odom frame (reference convention: T_world_imu =
    # T_world_lidar * T_lidar_imu).
    stamps = np.array([s for s, _ in lidar_poses])
    T_oi = [np.asarray(T, np.float64) @ T_lidar_imu for _, T in lidar_poses]
    Rs = [T[:3, :3] for T in T_oi]
    ps = [T[:3, 3] for T in T_oi]
    N = len(T_oi)

    def interval_rows(i):
        t0, t1 = stamps[i], stamps[i + 1]
        sel = (imu_rows[:, 0] >= t0 - 1e-6) & (imu_rows[:, 0] <= t1 + 1e-6)
        rows = imu_rows[sel]
        return rows if len(rows) >= 2 else None

    # (1) Gyro bias: r_i(bg) ~ r_i(0) + H_Rg dbg = 0.
    A = []
    b = []
    pre0 = []
    for i in range(N - 1):
        rows = interval_rows(i)
        if rows is None:
            pre0.append(None)
            continue
        dR, dv, dp, H_Rg, dt = _preintegrate_np(rows, np.zeros(3))
        pre0.append((rows, dt))
        r = lie_np.so3_log(dR.T @ (Rs[i].T @ Rs[i + 1]))
        A.append(H_Rg)
        b.append(-r)
    if len(A) < 2:
        return None
    A = np.concatenate(A)
    b = np.concatenate(b)
    bg, *_ = np.linalg.lstsq(A, b, rcond=None)

    # (2) Linear system in {v_0..v_{N-1}, g}: for each interval i,
    #   p_{i+1} - p_i = v_i dt + 0.5 g dt^2 + R_i dp_i
    #   v_{i+1}      = v_i + g dt + R_i dv_i
    n_unk = 3 * N + 3
    rows_M = []
    rhs = []
    pre_b = []
    for i in range(N - 1):
        if pre0[i] is None:
            pre_b.append(None)
            continue
        rows, _ = pre0[i]
        dR, dv, dp, H_Rg, dt = _preintegrate_np(rows, bg)
        pre_b.append((dR, dv, dp, dt))
        Mp = np.zeros((3, n_unk))
        Mp[:, 3 * i:3 * i + 3] = np.eye(3) * dt
        Mp[:, 3 * N:] = 0.5 * np.eye(3) * dt * dt
        rows_M.append(Mp)
        rhs.append(ps[i + 1] - ps[i] - Rs[i] @ dp)
        # v_{i+1} - v_i - g dt = R_i dv
        Mv = np.zeros((3, n_unk))
        Mv[:, 3 * i:3 * i + 3] = -np.eye(3)
        Mv[:, 3 * (i + 1):3 * (i + 1) + 3] = np.eye(3)
        Mv[:, 3 * N:] = -np.eye(3) * dt
        rows_M.append(Mv)
        rhs.append(Rs[i] @ dv)
    M = np.concatenate(rows_M)
    y = np.concatenate(rhs)
    x, *_ = np.linalg.lstsq(M, y, rcond=None)
    g_odom = x[3 * N:]
    g_norm = np.linalg.norm(g_odom)
    if g_norm < 5.0 or g_norm > 15.0:
        logger.warning("loose init: implausible gravity norm %.2f; falling back", g_norm)
        return None
    # Refine with the gravity magnitude constrained.
    g_odom = g_odom / g_norm * 9.80665

    # (3) World attitude: R_wo rotates g_odom onto (0, 0, -9.80665).
    a = g_odom / 9.80665
    t = GRAVITY_W / 9.80665
    v = np.cross(a, t)
    s = np.linalg.norm(v)
    c = float(a @ t)
    if s < 1e-8:
        R_wo = np.eye(3) if c > 0 else lie_np.so3_exp(np.array([np.pi, 0, 0]))
    else:
        R_wo = lie_np.so3_exp(v / s * np.arctan2(s, c))

    # Hand off the LAST init-window state, expressed in the world frame with
    # the first IMU position at the origin.
    k = N - 1
    T_w = np.eye(4)
    T_w[:3, :3] = R_wo @ Rs[k]
    T_w[:3, 3] = R_wo @ (ps[k] - ps[0])
    v_w = R_wo @ x[3 * k:3 * k + 3]
    bias = np.concatenate([np.zeros(3), bg])
    logger.info("loose init: |g_err|=%.3f deg, bg=%s, |v|=%.2f",
                np.degrees(np.arccos(np.clip(-a[2], -1, 1))), bg.round(4),
                np.linalg.norm(v_w))
    return InitialState(stamp=float(stamps[k]), T_world_imu=T_w, v_world=v_w,
                        bias=bias)
