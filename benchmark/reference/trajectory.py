"""Plain reference for the pipeline cells: the true trajectory and the
errors of estimated poses against it.

numpy only; it imports nothing of the program and takes nothing the program
made. The true pose at a stamp is worked out here again from the traffic
file's analytic path (the generator's own copy is not used), and an
estimated trajectory is put into the true frame by one least-squares rigid
fit (Umeyama, as ``evo`` and the port's ``ate_rmse`` align), since the
odometry's world frame is its own.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def circle_pose(t: np.ndarray, radius: float, omega: float, z_amp: float,
                z_omega: float) -> np.ndarray:
    """(len(t), 4, 4) T_world_sensor on the circle: yaw tangent to the path,
    z = 1.5 + z_amp sin(z_omega t)."""
    t = np.asarray(t, np.float64)
    a = omega * t
    yaw = a + np.pi / 2
    T = np.zeros((len(t), 4, 4))
    T[:, 0, 0], T[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    T[:, 1, 0], T[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    T[:, 2, 2] = T[:, 3, 3] = 1.0
    T[:, 0, 3] = radius * np.cos(a)
    T[:, 1, 3] = radius * np.sin(a)
    T[:, 2, 3] = 1.5 + z_amp * np.sin(z_omega * t)
    return T


def true_poses(traffic: dict, stamps) -> np.ndarray:
    p = traffic["path"]
    if p["kind"] == "circle":
        return circle_pose(stamps, p["radius"], p["speed"] / p["radius"], p["z_amp"],
                           p["z_omega"])
    raise ValueError(f"reference: unknown path kind {p['kind']!r}")


def rigid_fit(est: np.ndarray, gt: np.ndarray):
    """(R, t) minimising sum |R est_i + t - gt_i|^2 over (n, 3) positions."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((est - mu_e).T @ (gt - mu_g))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    return R, mu_g - R @ mu_e


def orientation_error_deg(R_est: np.ndarray, R_gt: np.ndarray) -> np.ndarray:
    """The angle between (n, 3, 3) orientations by their chordal distance,
    2 asin(|R_est - R_gt|_F / sqrt 8), in degrees: the rotation angle between
    them where R_est is a rotation, and an error that a scaled or sheared
    R_est cannot hide (the angle from the trace of R_gt^T R_est reads 0 for a
    rotation scaled by a little over 1)."""
    d = np.linalg.norm(R_est - R_gt, axis=(1, 2)) / np.sqrt(8.0)
    return np.degrees(2.0 * np.arcsin(np.minimum(d, 1.0)))


def pose_errors(est: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """Errors of (n, 4, 4) estimated poses against the true ones at the same
    stamps, in time order. After one rigid fit of the positions: the RMS and
    the largest position error [m] and the largest orientation error [deg].
    Of the motion between consecutive poses (the relative pose error at one
    step, which no choice of world frame changes): the RMS and the median
    error of its translation [m] and of its rotation [deg]. And how far the
    estimated orientations are from orthonormal (the largest |R^T R - I|_F)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if len(est) < 3 or not np.all(np.isfinite(est)):
        return {k: float("inf") for k in ("ate", "max_err", "max_rot_deg", "rpe", "rpe_med",
                                           "rpe_rot_deg", "rpe_rot_med_deg", "max_orth")}
    R, t = rigid_fit(est[:, :3, 3], gt[:, :3, 3])
    p = est[:, :3, 3] @ R.T + t
    err = np.linalg.norm(p - gt[:, :3, 3], axis=1)
    rot = orientation_error_deg(R[None] @ est[:, :3, :3], gt[:, :3, :3])
    d_est = np.linalg.inv(est[:-1]) @ est[1:]
    d_gt = np.linalg.inv(gt[:-1]) @ gt[1:]
    rpe = np.linalg.norm(d_est[:, :3, 3] - d_gt[:, :3, 3], axis=1)
    rpe_rot = orientation_error_deg(d_est[:, :3, :3], d_gt[:, :3, :3])
    Rt = est[:, :3, :3]
    orth = np.linalg.norm(np.transpose(Rt, (0, 2, 1)) @ Rt - np.eye(3), axis=(1, 2))
    return dict(ate=float(np.sqrt(np.mean(err ** 2))), max_err=float(err.max()),
                max_rot_deg=float(rot.max()), rpe=float(np.sqrt(np.mean(rpe ** 2))),
                rpe_med=float(np.median(rpe)), rpe_rot_deg=float(np.sqrt(np.mean(rpe_rot ** 2))),
                rpe_rot_med_deg=float(np.median(rpe_rot)), max_orth=float(orth.max()))


def nearest_rotation(R: np.ndarray) -> np.ndarray:
    """(n, 3, 3) the rotations nearest to (n, 3, 3) matrices (polar factor)."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    return U @ Vt


def turned(T_after: np.ndarray, T_before: np.ndarray) -> np.ndarray:
    """(n,) the angle [rad] by which a solve turned each of (n, 4, 4) poses,
    between the rotations nearest to their orientations (so that making an
    orientation orthonormal again turns nothing to first order)."""
    a = nearest_rotation(np.asarray(T_after)[:, :3, :3])
    b = nearest_rotation(np.asarray(T_before)[:, :3, :3])
    return np.radians(orientation_error_deg(a, b))
