"""SO(3)/SE(3) manifold ops — f64 numpy host variants.

Plays the role of gtsam::Rot3/Pose3 Expmap/Logmap/retract for host-side
bookkeeping (pose chaining, interpolation). Twist convention follows
GTSAM: xi = [omega (3), v (3)] (rotation first). Device (torch) twins live in
glim_tpu_torch.ops.lie.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-10


def skew(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w, dtype=np.float64)
    return np.array([
        [0.0, -w[2], w[1]],
        [w[2], 0.0, -w[0]],
        [-w[1], w[0], 0.0],
    ])


def so3_exp(w: np.ndarray) -> np.ndarray:
    w = np.asarray(w, dtype=np.float64)
    theta2 = float(w @ w)
    W = skew(w)
    if theta2 < _EPS:
        return np.eye(3) + W + 0.5 * (W @ W)
    theta = np.sqrt(theta2)
    return np.eye(3) + (np.sin(theta) / theta) * W + ((1 - np.cos(theta)) / theta2) * (W @ W)


def so3_log(R: np.ndarray) -> np.ndarray:
    R = np.asarray(R, dtype=np.float64)
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-7:
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if np.pi - theta < 1e-4:
        # Near pi: route through the (Shepperd) quaternion, robust everywhere.
        q = rot_to_quat(R)
        if q[3] < 0:
            q = -q
        vec_norm = np.linalg.norm(q[:3])
        ang = 2.0 * np.arctan2(vec_norm, q[3])
        if vec_norm < _EPS:
            return np.zeros(3)
        return ang * q[:3] / vec_norm
    return theta / (2.0 * np.sin(theta)) * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def _left_jacobian(w: np.ndarray) -> np.ndarray:
    theta2 = float(w @ w)
    W = skew(w)
    if theta2 < _EPS:
        return np.eye(3) + 0.5 * W + (W @ W) / 6.0
    theta = np.sqrt(theta2)
    return (np.eye(3)
            + ((1 - np.cos(theta)) / theta2) * W
            + ((theta - np.sin(theta)) / (theta2 * theta)) * (W @ W))


def _left_jacobian_inv(w: np.ndarray) -> np.ndarray:
    theta2 = float(w @ w)
    W = skew(w)
    if theta2 < _EPS:
        return np.eye(3) - 0.5 * W + (W @ W) / 12.0
    theta = np.sqrt(theta2)
    half = 0.5 * theta
    cot = 1.0 / np.tan(half)
    coef = (1.0 - half * cot) / theta2
    return np.eye(3) - 0.5 * W + coef * (W @ W)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """xi = [omega, v] -> 4x4 SE3."""
    xi = np.asarray(xi, dtype=np.float64)
    w, v = xi[:3], xi[3:]
    T = np.eye(4)
    T[:3, :3] = so3_exp(w)
    T[:3, 3] = _left_jacobian(w) @ v
    return T


def se3_log(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T, dtype=np.float64)
    w = so3_log(T[:3, :3])
    v = _left_jacobian_inv(w) @ T[:3, 3]
    return np.concatenate([w, v])


def se3_inverse(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T, dtype=np.float64)
    Ti = np.eye(4)
    R = T[:3, :3]
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -R.T @ T[:3, 3]
    return Ti


def se3_interpolate(T0: np.ndarray, T1: np.ndarray, a: float) -> np.ndarray:
    """Geodesic interpolation: T0 * exp(a * log(T0^-1 T1))."""
    d = se3_log(se3_inverse(T0) @ np.asarray(T1, np.float64))
    return np.asarray(T0, np.float64) @ se3_exp(a * d)


def quat_to_rot(q_xyzw: np.ndarray) -> np.ndarray:
    x, y, z, w = np.asarray(q_xyzw, dtype=np.float64)
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 -> quaternion [x y z w]."""
    from glim_tpu_torch.utils.config import se3_to_tum

    T = np.eye(4)
    T[:3, :3] = R
    return np.array(se3_to_tum(T)[3:])


def se3_adjoint(T: np.ndarray) -> np.ndarray:
    """6x6 adjoint for twist convention [omega, v]."""
    T = np.asarray(T, dtype=np.float64)
    R = T[:3, :3]
    t = T[:3, 3]
    Ad = np.zeros((6, 6))
    Ad[:3, :3] = R
    Ad[3:, 3:] = R
    Ad[3:, :3] = skew(t) @ R
    return Ad
