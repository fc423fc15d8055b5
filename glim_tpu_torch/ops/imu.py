"""IMU preintegration, NavState prediction, and IMU-rate pose integration.

Twin of ``glim_tpu/ops/imu.py`` (Forster et al. on-manifold preintegration,
GTSAM's model; bias layout [ba (3), bg (3)], covariance state order
(theta, v, p)). The JAX version runs its prefix recurrences with
``lax.associative_scan``; torch has none, so ``_prefix_scan`` is the
log-depth Hillis-Steele doubling form (8 batched rounds for 256 samples).
That choice is plain torch and its cost on the card is still to be measured.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable, Tuple

import torch

from glim_tpu_torch.ops.lie import (make_se3, se3_exp, se3_inv, se3_log, skew,
                                    so3_exp, so3_left_jacobian, so3_log)


def _right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian: Jr(w) = Jl(-w)."""
    return so3_left_jacobian(-w)


@dataclass
class PreintegratedImu:
    """Preintegrated IMU measurements between two stamps (fields may carry
    a leading batch dimension)."""

    dR: torch.Tensor     # (3, 3) rotation delta in the i-frame
    dv: torch.Tensor     # (3,) velocity delta
    dp: torch.Tensor     # (3,) position delta
    dt: torch.Tensor     # () total integration time
    H_Rg: torch.Tensor   # (3, 3) d(dR)/d(bg)
    H_va: torch.Tensor   # (3, 3) d(dv)/d(ba)
    H_vg: torch.Tensor   # (3, 3) d(dv)/d(bg)
    H_pa: torch.Tensor   # (3, 3) d(dp)/d(ba)
    H_pg: torch.Tensor   # (3, 3) d(dp)/d(bg)
    cov: torch.Tensor    # (9, 9) preintegration covariance, order (theta, v, p)
    bias: torch.Tensor   # (6,) [ba, bg] used during integration

    def astuple(self) -> tuple:
        return tuple(getattr(self, f.name) for f in fields(self))

    def map(self, fn: Callable) -> "PreintegratedImu":
        return PreintegratedImu(*(fn(x) for x in self.astuple()))


def _prefix_scan(fn: Callable, elems):
    """Inclusive prefix scan with an associative ``fn(earlier, later)`` over
    the leading axis of a tuple of tensors (Hillis-Steele doubling)."""
    x = tuple(elems)
    n = x[0].shape[0]
    d = 1
    while d < n:
        comb = fn(tuple(e[:-d] for e in x), tuple(e[d:] for e in x))
        x = tuple(torch.cat([e[:d], c]) for e, c in zip(x, comb))
        d *= 2
    return x


def _zeros_before(x: torch.Tensor) -> torch.Tensor:
    """Exclusive form of an inclusive prefix: [0, x[0], ..., x[-2]]."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def preintegrate_sequential(acc: torch.Tensor, gyro: torch.Tensor, dts: torch.Tensor,
                            mask: torch.Tensor, bias: torch.Tensor, acc_noise, gyro_noise,
                            int_noise) -> PreintegratedImu:
    """Step-by-step preintegration, one sample at a time: the ground truth
    for the log-depth ``preintegrate``. A plain loop of small ops per
    sample (no host read: a masked sample leaves the state as it was by
    ``torch.where``), so it is slow on the card and kept as a reference."""
    ba, bg = bias[:3], bias[3:]
    sig_a2 = acc_noise * acc_noise
    sig_g2 = gyro_noise * gyro_noise
    sig_i2 = int_noise * int_noise
    eye = torch.eye(3, dtype=acc.dtype, device=acc.device)
    Z = torch.zeros_like(eye)
    state = (eye, torch.zeros_like(acc[0]), torch.zeros_like(acc[0]), torch.zeros_like(dts[0]),
             Z, Z, Z, Z, Z, torch.zeros((9, 9), dtype=acc.dtype, device=acc.device))
    for k in range(acc.shape[0]):
        R, dv, dp, dt_sum, H_Rg, H_va, H_vg, H_pa, H_pg, cov = state
        valid = mask[k]
        dt = torch.where(valid, dts[k], 0.0)
        a = acc[k] - ba
        wdt = (gyro[k] - bg) * dt
        R_inc = so3_exp(wdt)
        Jr = _right_jacobian(wdt)
        Ra = R @ a
        A_sk = R @ skew(a)
        A = torch.cat([
            torch.cat([R_inc.T, Z, Z], dim=1),
            torch.cat([-A_sk * dt, eye, Z], dim=1),
            torch.cat([-0.5 * A_sk * dt * dt, eye * dt, eye], dim=1)])
        JrT = Jr * dt
        Q = torch.block_diag(JrT @ JrT.T * sig_g2 / torch.clamp(dt, min=1e-12),
                             eye * (sig_a2 * dt), eye * (sig_i2 * dt))
        new = (R @ R_inc, dv + Ra * dt, dp + dv * dt + 0.5 * Ra * dt * dt, dt_sum + dt,
               R_inc.T @ H_Rg - Jr * dt, H_va - R * dt, H_vg - A_sk @ H_Rg * dt,
               H_pa + H_va * dt - 0.5 * R * dt * dt,
               H_pg + H_vg * dt - 0.5 * A_sk @ H_Rg * dt * dt, A @ cov @ A.T + Q)
        state = tuple(torch.where(valid, n, o) for n, o in zip(new, state))
    R, dv, dp, dt_sum, H_Rg, H_va, H_vg, H_pa, H_pg, cov = state
    return PreintegratedImu(dR=R, dv=dv, dp=dp, dt=dt_sum, H_Rg=H_Rg, H_va=H_va,
                            H_vg=H_vg, H_pa=H_pa, H_pg=H_pg, cov=cov, bias=bias)


def preintegrate(acc: torch.Tensor, gyro: torch.Tensor, dts: torch.Tensor,
                 mask: torch.Tensor, bias: torch.Tensor, acc_noise, gyro_noise,
                 int_noise) -> PreintegratedImu:
    """Log-depth preintegration of a padded (N,) sample window (padding lanes
    carry mask=False and contribute nothing)."""
    ba, bg = bias[:3], bias[3:]
    sig_a2 = acc_noise * acc_noise
    sig_g2 = gyro_noise * gyro_noise
    sig_i2 = int_noise * int_noise
    N = acc.shape[0]
    eye = torch.eye(3, dtype=acc.dtype, device=acc.device)

    dt = torch.where(mask, dts, 0.0)
    dt3 = dt[:, None, None]
    a = acc - ba
    wdt = (gyro - bg) * dt[:, None]
    R_inc = so3_exp(wdt)                                  # I when dt=0
    Jr = _right_jacobian(wdt)

    (P,) = _prefix_scan(lambda x, y: (x[0] @ y[0],), (R_inc,))
    R_before = torch.cat([eye[None], P[:-1]])

    Ra = (R_before @ a[:, :, None])[..., 0]
    dv_inc = Ra * dt[:, None]
    dv_before = _zeros_before(torch.cumsum(dv_inc, 0))
    dp_inc = dv_before * dt[:, None] + 0.5 * Ra * (dt * dt)[:, None]

    dR = P[-1]
    dv = dv_inc.sum(0)
    dp = dp_inc.sum(0)
    dt_sum = dt.sum()

    # H_Rg: H' = R_inc^T H - Jr dt -> affine (A, B) composition.
    def aff_combine(x, y):
        A1, B1 = x
        A2, B2 = y
        return A2 @ A1, A2 @ B1 + B2

    _, B_pre = _prefix_scan(aff_combine, (R_inc.transpose(-1, -2), -Jr * dt3))
    H_Rg = B_pre[-1]
    H_Rg_before = _zeros_before(B_pre)

    A_sk = R_before @ skew(a)
    Hva_inc = -R_before * dt3
    Hvg_inc = -(A_sk @ H_Rg_before) * dt3
    H_va = Hva_inc.sum(0)
    H_vg = Hvg_inc.sum(0)
    Hva_before = _zeros_before(torch.cumsum(Hva_inc, 0))
    Hvg_before = _zeros_before(torch.cumsum(Hvg_inc, 0))
    dt2 = (dt * dt)[:, None, None]
    H_pa = torch.sum(Hva_before * dt3 - 0.5 * R_before * dt2, 0)
    H_pg = torch.sum(Hvg_before * dt3 - 0.5 * (A_sk @ H_Rg_before) * dt2, 0)

    # Covariance: cov' = A cov A^T + Q, composed pairwise (final value only).
    Z = torch.zeros_like(R_inc)
    eyeN = eye.expand(N, 3, 3)
    A_cov = torch.cat([
        torch.cat([R_inc.transpose(-1, -2), Z, Z], dim=2),
        torch.cat([-A_sk * dt3, eyeN, Z], dim=2),
        torch.cat([-0.5 * A_sk * dt2, eyeN * dt3, eyeN], dim=2)], dim=1)
    JrT = Jr * dt3
    Qg = (JrT @ JrT.transpose(-1, -2)) * (sig_g2 / torch.clamp(dt, min=1e-12))[:, None, None]
    Q = torch.cat([
        torch.cat([Qg, Z, Z], dim=2),
        torch.cat([Z, eyeN * (sig_a2 * dt)[:, None, None], Z], dim=2),
        torch.cat([Z, Z, eyeN * (sig_i2 * dt)[:, None, None]], dim=2)], dim=1)

    As, Qs = A_cov, Q
    while As.shape[0] > 1:
        n2 = As.shape[0] // 2
        A1, Q1 = As[0:2 * n2:2], Qs[0:2 * n2:2]
        A2, Q2 = As[1:2 * n2:2], Qs[1:2 * n2:2]
        pA = A2 @ A1
        pQ = A2 @ Q1 @ A2.transpose(-1, -2) + Q2
        if As.shape[0] % 2:
            As, Qs = torch.cat([pA, As[-1:]]), torch.cat([pQ, Qs[-1:]])
        else:
            As, Qs = pA, pQ

    return PreintegratedImu(dR=dR, dv=dv, dp=dp, dt=dt_sum, H_Rg=H_Rg,
                            H_va=H_va, H_vg=H_vg, H_pa=H_pa, H_pg=H_pg,
                            cov=Qs[0], bias=bias)


def bias_corrected(pre: PreintegratedImu, bias: torch.Tensor):
    """First-order bias correction of the deltas to a new bias estimate."""
    db = bias - pre.bias
    dba, dbg = db[:3], db[3:]
    dR = pre.dR @ so3_exp(pre.H_Rg @ dbg)
    dv = pre.dv + pre.H_va @ dba + pre.H_vg @ dbg
    dp = pre.dp + pre.H_pa @ dba + pre.H_pg @ dbg
    return dR, dv, dp


def predict(R_i, p_i, v_i, pre: PreintegratedImu, bias, gravity
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NavState prediction: world pose/velocity at the window's end."""
    dR, dv, dp = bias_corrected(pre, bias)
    dt = pre.dt
    R_j = R_i @ dR
    v_j = v_i + gravity * dt + R_i @ dv
    p_j = p_i + v_i * dt + 0.5 * gravity * dt * dt + R_i @ dp
    return R_j, p_j, v_j


def imu_residual(R_i, p_i, v_i, R_j, p_j, v_j, bias, pre: PreintegratedImu,
                 gravity) -> torch.Tensor:
    """9-dim IMU factor residual, order (theta, v, p)."""
    dR, dv, dp = bias_corrected(pre, bias)
    dt = pre.dt
    r_R = so3_log(dR.T @ (R_i.T @ R_j))
    r_v = R_i.T @ (v_j - v_i - gravity * dt) - dv
    r_p = R_i.T @ (p_j - p_i - v_i * dt - 0.5 * gravity * dt * dt) - dp
    return torch.cat([r_R, r_v, r_p])


def integrate_poses(R0, p0, v0, bias, gravity, acc, gyro, dts, mask):
    """IMU-rate dead reckoning: world-frame (R (N, 3, 3), p (N, 3),
    v (N, 3)) AFTER each sample. Rotations are prefix products; velocity and
    position then fall out as cumulative sums."""
    ba, bg = bias[:3], bias[3:]
    dt = torch.where(mask, dts, 0.0)
    R_inc = so3_exp((gyro - bg) * dt[:, None])
    (P,) = _prefix_scan(lambda x, y: (x[0] @ y[0],), (R_inc,))
    Rs = R0 @ P
    R_before = torch.cat([R0[None], Rs[:-1]])

    a_w = (R_before @ (acc - ba)[:, :, None])[..., 0] + gravity
    dv_inc = a_w * dt[:, None]
    vs = v0 + torch.cumsum(dv_inc, 0)
    v_before = torch.cat([v0[None], vs[:-1]])
    dp_inc = v_before * dt[:, None] + 0.5 * a_w * (dt * dt)[:, None]
    ps = p0 + torch.cumsum(dp_inc, 0)
    return Rs, ps, vs


def smooth_pose_chain(Rs, ps, mask, sigmas, T_end):
    """Doubly-anchored IMU pose-chain smoothing (closed form).

    The chain of IMU-integrated poses (Rs (N, 3, 3), ps (N, 3)) starts at
    the scan pose by construction; the end mismatch xi = log(P_n^-1 T_end)
    is spread along the chain in proportion to the accumulated Between
    variance: S_i = P_i * exp(alpha_i * xi), alpha_i = sum_{j<=i} sigma_j^2
    / sum_j sigma_j^2 (entry 0 ignored). The last valid index stays a (1,)
    device tensor. Returns (Rs', ps'); invalid lanes pass through."""
    n = torch.clamp(mask.sum(), min=1)
    var = torch.where(mask, sigmas * sigmas, 0.0)
    var = torch.cat([torch.zeros_like(var[:1]), var[1:]])
    cum = torch.cumsum(var, 0)
    idx_end = (n - 1).reshape(1)
    total = torch.clamp(cum.index_select(0, idx_end)[0], min=1e-12)
    alpha = torch.clamp(cum / total, 0.0, 1.0)

    P_end = make_se3(Rs.index_select(0, idx_end)[0], ps.index_select(0, idx_end)[0])
    xi = se3_log(se3_inv(P_end) @ T_end)
    T2 = make_se3(Rs, ps) @ se3_exp(alpha[:, None] * xi)
    return (torch.where(mask[:, None, None], T2[:, :3, :3], Rs),
            torch.where(mask[:, None], T2[:, :3, 3], ps))
