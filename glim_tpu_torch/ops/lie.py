"""SO(3)/SE(3) manifold ops — torch device variants (f32, batch-friendly).

Twin of ``glim_tpu/ops/lie.py``. Twist convention follows GTSAM:
xi = [omega (3), v (3)]. Every function is branch-free (Taylor blends via
``torch.where`` on sanitised inputs) and builds its outputs with
``stack``/``cat`` rather than in-place writes, so it composes with
``torch.func.vmap`` and forward-mode ``torch.func.jacfwd``.

``forward_ad_lock``: torch's forward-mode AD keeps one dual level for the
whole process, so two threads evaluating ``jacfwd`` at once tear down each
other's level ("no level exists"). Every ``jacfwd`` evaluation of the port
holds this lock (the async pipeline's odometry and global workers both
linearize with it).
"""

from __future__ import annotations

import threading

import torch

_EPS = 1e-8
forward_ad_lock = threading.Lock()


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def _eye3(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


def _sin_over_theta(theta, theta2):
    small = theta2 < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)


def _one_minus_cos_over_theta2(theta, theta2):
    small = theta2 < _EPS
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    return torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)


def _theta_minus_sin_over_theta3(theta, theta2):
    small = theta2 < _EPS
    safe3 = torch.where(small, torch.ones_like(theta2), theta2 * theta)
    return torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                       (theta - torch.sin(theta)) / safe3)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    W = skew(w)
    W2 = W @ W
    a = _sin_over_theta(theta, theta2)[..., None, None]
    b = _one_minus_cos_over_theta2(theta, theta2)[..., None, None]
    return _eye3(w) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3). Accurate on [0, pi); near pi via the
    quaternion route. Every branch's inputs are sanitised, so forward-mode
    derivatives stay finite at the identity and near pi."""
    cos_t = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5,
                        -1.0, 1.0)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)

    small = cos_t > 1.0 - 1e-6        # theta < ~1.4e-3
    near_pi = cos_t < -1.0 + 1e-5     # theta > ~pi - 4.5e-3
    generic_m = ~small & ~near_pi

    cos_g = torch.where(generic_m, cos_t, torch.zeros_like(cos_t))
    theta_g = torch.arccos(cos_g)
    sin_g = torch.sqrt(torch.clamp(1.0 - cos_g * cos_g, min=1e-12))
    generic = (theta_g / (2.0 * sin_g))[..., None] * vee

    one_m = torch.clamp(1.0 - cos_t, min=0.0)
    taylor = 0.5 * vee * (1.0 + one_m / 3.0)[..., None]

    q = rot_to_quat(R)
    sign = torch.where(q[..., 3:4] < 0, -torch.ones_like(q[..., 3:4]),
                       torch.ones_like(q[..., 3:4]))
    qv = q[..., :3] * sign
    qw = q[..., 3:4] * sign
    unit_x = torch.eye(3, dtype=R.dtype, device=R.device)[0]
    qv_safe = torch.where(near_pi[..., None], qv, unit_x.expand_as(qv))
    vn = torch.linalg.norm(qv_safe, dim=-1, keepdim=True)
    ang = 2.0 * torch.atan2(vn, qw)
    pi_branch = ang * qv_safe / torch.clamp(vn, min=1e-12)

    return torch.where(near_pi[..., None], pi_branch,
                       torch.where(small[..., None], taylor, generic))


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    W = skew(w)
    W2 = W @ W
    b = _one_minus_cos_over_theta2(theta, theta2)[..., None, None]
    c = _theta_minus_sin_over_theta3(theta, theta2)[..., None, None]
    return _eye3(w) + b * W + c * W2


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    W = skew(w)
    W2 = W @ W
    small = theta2 < _EPS
    half = 0.5 * theta
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    sin_h = torch.sin(half)
    safe_sin = torch.where(torch.abs(sin_h) < _EPS, torch.ones_like(sin_h), sin_h)
    cot_term = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                           (1.0 - half * torch.cos(half) / safe_sin) / safe2
                           )[..., None, None]
    return _eye3(w) - 0.5 * W + cot_term * W2


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)                 # (..., 3, 4)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [omega, v] -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    t = (so3_left_jacobian(w) @ v[..., :, None])[..., 0]
    return make_se3(so3_exp(w), t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    w = so3_log(T[..., :3, :3])
    v = (so3_left_jacobian_inv(w) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([w, v], dim=-1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_se3(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply SE3 (4, 4) to points (N, 3)."""
    return pts @ T[:3, :3].T + T[:3, 3]


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion [x y z w]; branch-free Shepperd,
    selecting the numerically largest pivot."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    sw = safe_sqrt(1.0 + tr) * 2.0
    q_w = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, 0.25 * sw], dim=-1)
    sx = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q_x = torch.stack([0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], dim=-1)
    sy = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q_y = torch.stack([(m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy, (m02 - m20) / sy], dim=-1)
    sz = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q_z = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz, (m10 - m01) / sz], dim=-1)

    cond_w = tr > 0.0
    cond_x = (m00 > m11) & (m00 > m22)
    cond_y = m11 > m22
    q = torch.where(cond_w[..., None], q_w,
                    torch.where(cond_x[..., None], q_x,
                                torch.where(cond_y[..., None], q_y, q_z)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x y z w] -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation of quaternions [x y z w]; a in [0, 1] with
    one fewer dimension than q0."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_t = torch.sin(theta)
    small = sin_t < 1e-6
    a = a[..., None]
    safe_sin = torch.where(small, torch.ones_like(sin_t), sin_t)
    w0 = torch.where(small, 1.0 - a, torch.sin((1.0 - a) * theta) / safe_sin)
    w1 = torch.where(small, a, torch.sin(a * theta) / safe_sin)
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6, 6) adjoint for twist [omega, v]."""
    R = T[..., :3, :3]
    zero = torch.zeros_like(R)
    top = torch.cat([R, zero], dim=-1)
    bottom = torch.cat([skew(T[..., :3, 3]) @ R, R], dim=-1)
    return torch.cat([top, bottom], dim=-2)

