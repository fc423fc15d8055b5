"""GICP / VGICP matching-cost linearization.

Twin of the parts of ``glim_tpu/ops/gicp.py`` the odometry uses. A factor is
a pure function returning the summed Gauss-Newton system

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
from glim_tpu_torch.ops.voxelmap import GaussianVoxelMap, lookup_keys, lookup_table


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
