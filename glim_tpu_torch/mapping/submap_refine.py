"""Submap batch refinement: one LM over every frame state of a submap.

Twin of ``glim_tpu/mapping/submap_refine.py`` (reference:
src/glim/mapping/sub_mapping.cpp:183-243 factor creation, :421-452 batch
LM). Per-frame 15-dof states [pose, velocity, bias] joined by

  * a pose prior on the first frame (precision 1e8),
  * odometry between factors of consecutive frames with a GICP-Hessian
    information matrix,
  * the IMU chain: preintegrated factors between consecutive frames,
    velocity and bias priors at the odometry values, bias random-walk
    betweens, and a velocity-between fallback where IMU data was short,
  * VGICP matching factors of every keyframe pair i < j (target: keyframe
    i's voxel maps of every level; source: keyframe j's subsampled points).

The system is the dense (N*15)^2 Hessian of the submap's N frames (the JAX
package pads N to a frame bucket; padded states are decoupled and never
move, so the port solves the N real ones). Factor systems are batched and
added into it with ``index_put_(accumulate=True)``, which is not
deterministic on CUDA (compare with a tolerance). The pose prior and
between Jacobians are forward-mode ``jacfwd`` through
``ops/factors.batched_jacobian``, which holds ``lie.forward_ad_lock``.

Keyframe-pair correspondences are searched once per outer iteration and
kept over the inner GN steps; the JAX package looks up all K x K (target,
source) pairs and keeps the i < j ones, the port looks up only those, with
one ``vgicp_lookup_stacked`` per voxel-map level along the pair axis (each
pair's lookup is independent, so the values are the same). Nothing here
reads from the device: the caller reads the result once.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.func import vmap

from glim_tpu_torch.odometry.window_estimator import STATE_DIM, _imu_factor_systems
from glim_tpu_torch.ops import gicp, lie, solver
from glim_tpu_torch.ops.factors import batched_jacobian
from glim_tpu_torch.ops.imu import PreintegratedImu

POSE_PRIOR_INFO = 1e8      # first-frame gauge prior (reference :190)
VEL_PRIOR_INFO = 1e3       # per-frame velocity prior  (reference :227)
BIAS_PRIOR_INFO = 1e6      # per-frame bias prior      (reference :228)
BIAS_WALK_INFO = 1e6       # bias between              (reference :237)
VEL_WALK_INFO = 1.0        # velocity-between fallback (reference :242)


def _quadratic(J: torch.Tensor, r: torch.Tensor, info: torch.Tensor):
    """(J^T I J, J^T I r, r^T I r) with a full information matrix I,
    batched over the leading axis."""
    Jt = J.transpose(-1, -2)
    Ir = (info @ r[..., None])[..., 0]
    return Jt @ info @ J, (Jt @ Ir[..., None])[..., 0], torch.sum(r * Ir, dim=-1)


def _prior_system6(T: torch.Tensor, anchor: torch.Tensor, info: torch.Tensor):
    """SE3 pose prior r = log(anchor^-1 T Exp(xi)) -> (H (6, 6), g (6,), err)."""
    J, r = batched_jacobian(lambda x, Ti, Ai: lie.se3_log(Ai @ (Ti @ lie.se3_exp(x))), 6,
                            T[None], lie.se3_inv(anchor)[None])
    H, g, e = _quadratic(J, r, info[None])
    return H[0], g[0], e[0]


def _between_systems(T_i: torch.Tensor, T_j: torch.Tensor, Z: torch.Tensor,
                     info: torch.Tensor):
    """Full-information SE3 between factors r = log(Z^-1 (T_i Exp(xi_i))^-1
    T_j Exp(xi_j)), batched -> (H (B, 12, 12), g (B, 12), err (B,))."""
    def res(x, Ti, Tj, Zi):
        return lie.se3_log(Zi @ lie.se3_inv(Ti @ lie.se3_exp(x[:6])) @ (Tj @ lie.se3_exp(x[6:])))
    J, r = batched_jacobian(res, 12, T_i, T_j, lie.se3_inv(Z))
    return _quadratic(J, r, info)


def _add(H: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, blocks: torch.Tensor) -> None:
    """H[rows[b, i], cols[b, j]] += blocks[b, i, j] (accumulating)."""
    B, m = rows.shape
    n = cols.shape[1]
    H.index_put_((rows[:, :, None].expand(B, m, n), cols[:, None, :].expand(B, m, n)),
                 blocks.expand(B, m, n), accumulate=True)


def _add_vec(g: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> None:
    g.index_put_((rows,), vals, accumulate=True)


def pair_lookups(T_kf: torch.Tensor, pi: torch.Tensor, pj: torch.Tensor,
                 kf_pts: torch.Tensor, kf_mask: torch.Tensor, tables) -> List[tuple]:
    """Correspondences of every keyframe pair (target pi[p], source pj[p]) at
    the keyframe poses T_kf (K, 4, 4), for every level's stacked (keys,
    stats, resolutions) in ``tables`` -> per level (mu (P, Cs, 3), C_t (P,
    Cs, 3, 3), hit (P, Cs))."""
    return [gicp.vgicp_lookup_stacked(T_kf, pi, pj, kf_pts, kf_mask, keys, stats, res)
            for keys, stats, res in tables]


def _pair_systems(T_t, T_s, pts, covs, mu, C_t, hit):
    return vmap(gicp.vgicp_linearize_cached)(T_t, T_s, pts, covs, mu, C_t, hit)


def linearize(T, v, b, T0, v0, b0, bt_delta, bt_info, bt_valid, pre: PreintegratedImu,
              pre_valid, gravity, kf_fidx, pi, pj, kf_pts, kf_covs, corr
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense GN system (H (D, D), g (D,), err) of all factors at (T, v,
    b), with the keyframe pairs' cached correspondences ``corr``."""
    N = T.shape[0]
    dev = T.device
    D = N * STATE_DIM
    H = torch.zeros(D, D, device=dev)
    g = torch.zeros(D, device=dev)
    base = torch.arange(N, device=dev)[:, None] * STATE_DIM
    pose_rows = base + torch.arange(6, device=dev)
    vel_rows = base + 6 + torch.arange(3, device=dev)
    bias_rows = base + 9 + torch.arange(6, device=dev)
    eye3, eye6 = torch.eye(3, device=dev), torch.eye(6, device=dev)

    # Gauge prior on frame 0, velocity and bias priors on every frame.
    Hp, gp, ep = _prior_system6(T[0], T0[0], eye6 * POSE_PRIOR_INFO)
    H[:6, :6] += Hp
    g[:6] += gp
    r_v, r_b = v - v0, b - b0
    _add(H, vel_rows, vel_rows, VEL_PRIOR_INFO * eye3)
    _add_vec(g, vel_rows, VEL_PRIOR_INFO * r_v)
    _add(H, bias_rows, bias_rows, BIAS_PRIOR_INFO * eye6)
    _add_vec(g, bias_rows, BIAS_PRIOR_INFO * r_b)
    err = ep + VEL_PRIOR_INFO * torch.sum(r_v * r_v) + BIAS_PRIOR_INFO * torch.sum(r_b * r_b)

    # Odometry between factors (i-1, i) with GICP-Hessian information.
    bt_ok = bt_valid[1:].to(torch.float32)
    Hb, gb, eb = _between_systems(T[:-1], T[1:], bt_delta[1:], bt_info[1:])
    rows12 = torch.cat([pose_rows[:-1], pose_rows[1:]], dim=1)
    _add(H, rows12, rows12, bt_ok[:, None, None] * Hb)
    _add_vec(g, rows12, bt_ok[:, None] * gb)
    err = err + torch.sum(bt_ok * eb)

    # IMU factor chain, and the velocity-between fallback where it is absent.
    has_imu = pre_valid & (pre.dt > 1e-6)
    imu_ok = has_imu.to(torch.float32)
    vel_fb_ok = 1.0 - imu_ok
    Hi, gi, ei = _imu_factor_systems(T[:-1], v[:-1], T[1:], v[1:], b[:-1], pre, gravity)
    rows30 = base[:-1] + torch.arange(2 * STATE_DIM, device=dev)
    _add(H, rows30, rows30, imu_ok[:, None, None] * Hi)
    _add_vec(g, rows30, imu_ok[:, None] * gi)
    err = err + torch.sum(imu_ok * ei)

    # Bias random walk and velocity fallback: [I -I; -I I] blocks.
    for rows, info, w, x, I in ((bias_rows, BIAS_WALK_INFO, torch.ones_like(imu_ok), b, eye6),
                                (vel_rows, VEL_WALK_INFO, vel_fb_ok, v, eye3)):
        r_w = x[1:] - x[:-1]
        blk = info * w[:, None, None] * I
        a, c = rows[:-1], rows[1:]
        _add(H, a, a, blk)
        _add(H, c, c, blk)
        _add(H, a, c, -blk)
        _add(H, c, a, -blk)
        _add_vec(g, a, -info * w[:, None] * r_w)
        _add_vec(g, c, info * w[:, None] * r_w)
        err = err + info * torch.sum(w[:, None] * r_w * r_w)

    # VGICP keyframe pairs (cached correspondences).
    fi, fj = kf_fidx[pi], kf_fidx[pj]
    rows_t, rows_s = pose_rows[fi], pose_rows[fj]
    for mu, C_t, hit in corr:
        s = _pair_systems(T[fi], T[fj], kf_pts[pj], kf_covs[pj], mu, C_t, hit)
        _add(H, rows_t, rows_t, s.H_tt)
        _add(H, rows_t, rows_s, s.H_ts)
        _add(H, rows_s, rows_t, s.H_ts.transpose(1, 2))
        _add(H, rows_s, rows_s, s.H_ss)
        _add_vec(g, rows_t, s.b_t)
        _add_vec(g, rows_s, s.b_s)
        err = err + torch.sum(s.error)
    return H, g, err


def submap_refine(T0, v0, b0, bt_delta, bt_info, bt_valid, pre: PreintegratedImu,
                  pre_valid, kf_pts, kf_covs, kf_mask, kf_fidx, tables, gravity,
                  outer: int = 3, inner: int = 3):
    """Refine the N frame states of one submap.

    T0 (N, 4, 4), v0 (N, 3), b0 (N, 6): the initial states; bt_delta (N, 4,
    4), bt_info (N, 6, 6), bt_valid (N,): between edge (i-1, i) in entry i
    (entry 0 unused); pre / pre_valid: the preintegrations of edges (i, i+1),
    stacked (N-1, ...); kf_pts / kf_covs / kf_mask (K, Cs, ...) the K >= 2
    keyframes' refinement clouds and kf_fidx (K,) their frame indices;
    ``tables``: per voxel-map level the keyframes' stacked (keys (K, V, 2),
    stats (K, V, 12), resolutions (K,)). Returns (T, v, b, final error), all
    on the device; non-finite results give back the initial states."""
    K = kf_fidx.shape[0]
    dev = T0.device
    pi, pj = torch.triu_indices(K, K, offset=1, device=dev)     # pairs i < j, row-major
    kf_fidx = kf_fidx.to(torch.int64)

    T, v, b = T0, v0, b0
    err = torch.zeros((), device=dev)
    for _ in range(outer):
        corr = pair_lookups(T[kf_fidx], pi, pj, kf_pts, kf_mask, tables)
        for _ in range(inner):
            H, g, err = linearize(T, v, b, T0, v0, b0, bt_delta, bt_info, bt_valid, pre,
                                  pre_valid, gravity, kf_fidx, pi, pj, kf_pts, kf_covs,
                                  corr)
            d = solver.solve_damped(H, g, 1e-4).reshape(-1, STATE_DIM)
            T = T @ lie.se3_exp(d[:, :6])
            v = v + d[:, 6:9]
            b = b + d[:, 9:15]

    finite = torch.all(torch.isfinite(T)) & torch.all(torch.isfinite(v))
    return (torch.where(finite, T, T0), torch.where(finite, v, v0),
            torch.where(finite, b, b0), err)
