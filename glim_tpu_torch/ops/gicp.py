"""GICP / VGICP matching-cost linearization.

Twin of ``glim_tpu/ops/gicp.py``. A factor is a pure function returning
the summed Gauss-Newton system

    H = sum_i J_i^T Omega_i J_i,   b = sum_i J_i^T Omega_i r_i,
    err = sum_i r_i^T Omega_i r_i

with the plane-to-plane weight Omega_i = (C_tgt + R C_src R^T)^-1 and the
target-frame residual r_i = mu_tgt - T_t^-1 T_s p_src. The SoA layout (point
axis last, symmetric 3x3 packed as 6 planes [xx, xy, xz, yy, yz, zz]) is
kept; the per-point Jacobian columns are stacked and contracted with one
einsum per block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from glim_tpu_torch.ops.lie import se3_inv
from glim_tpu_torch.ops.nn_search import nn_search
from glim_tpu_torch.ops.voxelmap import (GaussianVoxelMap, lookup_keys,
                                         lookup_keys_stacked, lookup_table)


class FactorSystem(NamedTuple):
    """Accumulated GN system for one binary factor (target, source)."""

    H_tt: torch.Tensor   # (6, 6)
    H_ts: torch.Tensor   # (6, 6)
    H_ss: torch.Tensor   # (6, 6)
    b_t: torch.Tensor    # (6,)
    b_s: torch.Tensor    # (6,)
    error: torch.Tensor  # ()
    num_inliers: torch.Tensor  # ()


def sym_pack_soa(A: torch.Tensor) -> torch.Tensor:
    """(..., M, 3, 3) symmetric -> packed SoA (..., 6, M)."""
    return torch.stack([A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
                        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]], dim=-2)


def _soa_unpack(s: torch.Tensor) -> torch.Tensor:
    """Packed (6, C) -> full (3, 3, C)."""
    xx, xy, xz, yy, yz, zz = s
    return torch.stack([torch.stack([xx, xy, xz]), torch.stack([xy, yy, yz]),
                        torch.stack([xz, yz, zz])])


def _soa_sym_mul_vec(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Packed symmetric (6, C) times vectors (..., 3, C) -> (..., 3, C)."""
    return torch.einsum("abc,...bc->...ac", _soa_unpack(s), v)


def _soa_rot_sym(R: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """R S R^T for packed symmetric S (6, C) -> (6, C)."""
    full = torch.einsum("ia,abc,jb->ijc", R, _soa_unpack(s), R)
    return torch.stack([full[0, 0], full[0, 1], full[0, 2],
                        full[1, 1], full[1, 2], full[2, 2]])


def _soa_inv_sym(s: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of packed symmetric 3x3 (6, C) -> (6, C)."""
    xx, xy, xz, yy, yz, zz = s
    c00 = yy * zz - yz * yz
    c01 = xz * yz - xy * zz
    c02 = xy * yz - xz * yy
    c11 = xx * zz - xz * xz
    c12 = xy * xz - xx * yz
    c22 = xx * yy - xy * xy
    det = xx * c00 + xy * c01 + xz * c02
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, torch.ones_like(det))
    return torch.stack([c00, c01, c02, c11, c12, c22]) * inv_det


def inv_sym3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched symmetric 3x3 (..., 3, 3): the
    adjugate over the determinant (a determinant under 1e-20 counts as 1)."""
    packed = torch.stack([A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
                          A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]])
    return _soa_unpack(_soa_inv_sym(packed)).movedim((0, 1), (-2, -1))


def _skew_cols(v: torch.Tensor) -> torch.Tensor:
    """Columns of skew(v) for v (3, C) -> (3 cols, 3, C)."""
    zero = torch.zeros_like(v[0])
    return torch.stack([torch.stack([zero, v[2], -v[1]]),
                        torch.stack([-v[2], zero, v[0]]),
                        torch.stack([v[1], -v[0], zero])])


@record_function("linearize_core_soa")
def linearize_core_soa(R_rel, t_rel, pts, covs, mu, ct, hit, source_only=False):
    """pts/mu: (3, C); covs/ct: packed symmetric (6, C); hit: (C,) bool.
    Returns (H_tt, H_ts, H_ss, b_t, b_s, error), or only (H_ss, b_s, error)
    with ``source_only`` (the blocks the odometry window reads).

    Jacobians (right perturbation, twist order [omega, v]):
      dr/dxi_t = [ -[q]x     |  I      ]
      dr/dxi_s = [ R_rel [p]x | -R_rel ]"""
    q = R_rel @ pts + t_rel[:, None]
    r = mu - q
    omega = _soa_inv_sym(ct + _soa_rot_sym(R_rel, covs))
    w = hit.to(pts.dtype)
    C = pts.shape[1]

    Js = torch.cat([torch.einsum("ij,kjc->kic", R_rel, _skew_cols(pts)),
                    (-R_rel.T)[:, :, None].expand(3, 3, C)])        # (6, 3, C)
    WJs = _soa_sym_mul_vec(omega, Js) * w
    Wr = _soa_sym_mul_vec(omega, r) * w
    H_ss = torch.einsum("kac,lac->kl", Js, WJs)
    b_s = torch.einsum("kac,ac->k", Js, Wr)
    err = torch.sum(r * Wr)
    if source_only:
        return H_ss, b_s, err

    eye_cols = torch.eye(3, dtype=pts.dtype, device=pts.device)[:, :, None].expand(3, 3, C)
    Jt = torch.cat([-_skew_cols(q), eye_cols])                     # (6, 3, C)
    WJt = _soa_sym_mul_vec(omega, Jt) * w
    H_tt = torch.einsum("kac,lac->kl", Jt, WJt)
    H_ts = torch.einsum("kac,lac->kl", Jt, WJs)
    b_t = torch.einsum("kac,ac->k", Jt, Wr)
    return H_tt, H_ts, H_ss, b_t, b_s, err


def _soa_system(R_rel, t_rel, src_pts, src_covs, mu, C_t, hit) -> FactorSystem:
    """AoS-interface wrapper over the SoA core."""
    out = linearize_core_soa(R_rel, t_rel, src_pts.T, sym_pack_soa(src_covs),
                             mu.T, sym_pack_soa(C_t), hit)
    return FactorSystem(*out, torch.sum(hit > 0))


@record_function("vgicp_lookup")
def vgicp_lookup(T_target, T_source, src_pts, src_mask, vm: GaussianVoxelMap,
                 keys=None):
    """Correspondence phase of VGICP: voxel lookup + stats gather. ``keys``
    is the map's ``lookup_table``, for callers that look up one map many
    times. Returns (mu (C, 3), C_t (C, 3, 3), hit (C,))."""
    T_rel = se3_inv(T_target) @ T_source
    q = src_pts @ T_rel[:3, :3].T + T_rel[:3, 3]
    if keys is None:
        keys = lookup_table(vm)
    vidx = lookup_keys(keys, vm.resolution, q)
    hit = (vidx >= 0) & src_mask
    safe = torch.clamp(vidx, min=0)
    return vm.mean[safe], vm.cov[safe], hit


def vgicp_linearize_cached(T_target, T_source, src_pts, src_covs, mu, C_t,
                           hit) -> FactorSystem:
    """Linearize with pre-fetched correspondences (see vgicp_lookup)."""
    T_rel = se3_inv(T_target) @ T_source
    return _soa_system(T_rel[:3, :3], T_rel[:3, 3], src_pts, src_covs,
                       mu, C_t, hit)


@record_function("vgicp_lookup_stacked")
def vgicp_lookup_stacked(T_all, tgt, src, sm_pts, sm_mask, keys, stats, res):
    """Correspondence search for R factor rows against stacked per-submap
    voxel-map tables (``voxelmap.gaussian_lookup_table``): row r looks up
    submap src[r]'s cloud, at the relative pose T_all[tgt]^-1 T_all[src],
    in submap tgt[r]'s table.

    T_all (S, 4, 4); tgt/src (R,); sm_pts (S, M, 3); sm_mask (S, M); keys
    (S, V, 2); stats (S, V, 12); res (S,) -> mu (R, M, 3), C_t (R, M, 3, 3),
    hit (R, M)."""
    tgt, src = tgt.to(torch.int64), src.to(torch.int64)
    T_rel = se3_inv(T_all[tgt]) @ T_all[src]
    q = sm_pts[src] @ T_rel[:, :3, :3].transpose(-1, -2) + T_rel[:, None, :3, 3]
    found = lookup_keys_stacked(keys, res, q, tgt)
    hit = (found >= 0) & sm_mask[src]
    V = keys.shape[1]
    row = stats.reshape(-1, 12)[tgt[:, None] * V + torch.clamp(found, min=0)]
    return row[..., :3], row[..., 3:].reshape(row.shape[:2] + (3, 3)), hit


@record_function("gicp_linearize")
def gicp_linearize(T_target, T_source, src_pts, src_covs, src_mask,
                   tgt_pts, tgt_covs, tgt_mask, max_dist) -> FactorSystem:
    """GICP factor against an explicit target cloud, with nearest-neighbour
    correspondences from ``nn_search`` (the CUDA kernel on CUDA tensors)."""
    T_rel = se3_inv(T_target) @ T_source
    R_rel, t_rel = T_rel[:3, :3], T_rel[:3, 3]
    q = src_pts @ R_rel.T + t_rel
    idx, d2 = nn_search(q, src_mask, tgt_pts, tgt_mask)
    idx = idx.to(torch.int64)
    inlier = src_mask & (d2 < max_dist * max_dist) & torch.isfinite(d2)
    return _soa_system(R_rel, t_rel, src_pts, src_covs, tgt_pts[idx], tgt_covs[idx],
                       inlier.to(q.dtype))


@record_function("vgicp_linearize")
def vgicp_linearize(T_target, T_source, src_pts, src_covs, src_mask,
                    vm: GaussianVoxelMap, keys=None) -> FactorSystem:
    """VGICP factor against a target Gaussian voxel map: ``vgicp_lookup``
    and the linearization in one call. ``keys`` is the map's
    ``lookup_table``, for callers that register against one map many
    times."""
    mu, C_t, hit = vgicp_lookup(T_target, T_source, src_pts, src_mask, vm, keys)
    return vgicp_linearize_cached(T_target, T_source, src_pts, src_covs, mu, C_t,
                                  hit.to(src_pts.dtype))


def icp_linearize(T_target, T_source, src_pts, src_mask, tgt_pts, tgt_mask,
                  max_dist) -> FactorSystem:
    """Point-to-point ICP factor: GICP with a zero source and an identity
    target covariance, i.e. isotropic Mahalanobis weights; correspondences
    from ``nn_search``."""
    T_rel = se3_inv(T_target) @ T_source
    R_rel, t_rel = T_rel[:3, :3], T_rel[:3, 3]
    q = src_pts @ R_rel.T + t_rel
    idx, d2 = nn_search(q, src_mask, tgt_pts, tgt_mask)
    inlier = src_mask & (d2 < max_dist * max_dist) & torch.isfinite(d2)
    zeros = torch.zeros(q.shape + (3,), dtype=q.dtype, device=q.device)
    eyes = torch.eye(3, dtype=q.dtype, device=q.device).expand(q.shape + (3,))
    return _soa_system(R_rel, t_rel, src_pts, zeros, tgt_pts[idx.to(torch.int64)], eyes,
                       inlier.to(q.dtype))


def gicp_error(T_target, T_source, src_pts, src_covs, src_mask,
               tgt_pts, tgt_covs, tgt_mask, max_dist) -> torch.Tensor:
    return gicp_linearize(T_target, T_source, src_pts, src_covs, src_mask,
                          tgt_pts, tgt_covs, tgt_mask, max_dist).error


def vgicp_error(T_target, T_source, src_pts, src_covs, src_mask, vm) -> torch.Tensor:
    return vgicp_linearize(T_target, T_source, src_pts, src_covs, src_mask, vm).error


@record_function("inlier_fraction")
def inlier_fraction(T_target, T_source, src_pts, src_mask, tgt_pts, tgt_mask,
                    max_dist) -> torch.Tensor:
    """Fraction of valid source points with a valid target within
    ``max_dist`` (0-dim f32 on the device; the pose graph's loop
    validation), by ``nn_search``."""
    T_rel = se3_inv(T_target) @ T_source
    q = src_pts @ T_rel[:3, :3].T + T_rel[:3, 3]
    _, d2 = nn_search(q, src_mask, tgt_pts, tgt_mask)
    ok = src_mask & (d2 < max_dist * max_dist)
    return ok.sum() / torch.clamp(src_mask.sum(), min=1)
