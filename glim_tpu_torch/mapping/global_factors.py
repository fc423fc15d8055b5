"""Batched damped Gauss-Newton over all submap poses (the matching-cost
global back-end's solver).

Twin of ``glim_tpu/mapping/global_factors.py``. All factors live in stacked
padded tensors and one call runs the whole damped-GN optimization:

  * matching-cost factors: ``linearize_core_soa`` vmapped over the factor
    rows, in chunks of 256, with CACHED correspondences (the voxel lookups
    are refreshed outside, only for factors whose relative pose moved),
    optionally with the rows sharded over a device mesh;
  * between factors with a full 6x6 information, the prior on the first
    pose, gravity anchors and translation priors;
  * IMU endpoint-chain factors, whose junction velocity/bias states are
    appended to the state vector;
  * per-pose recovery damping (a traced vector) and 1e-3 on padded slots.

Every block is summed into the dense (D, D) system by one
``index_put_(accumulate=True)``: the index rows repeat (a pose sits in many
factors), and on CUDA the summation order is not fixed.

The convergence gate (``lax.cond`` under ``lax.scan`` in the JAX package)
reads the update's max |delta| on the host after each iteration and stops
once it is below 1e-4: one host sync an iteration, and a converged graph
pays for one or two linearizations instead of ``iters`` (the host's
dispatch of a linearization costs far more than the sync, the card idles
in between). err and min_diag come from the last linearization, as in the
JAX package, so the returned values are the same.

Padding buckets (``bucket``) are kept although nothing here compiles per
shape: the padded pose slots and their damping are part of the system,
and fixed shapes keep a later CUDA-graph capture of an iteration possible.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.func import vmap
from torch.profiler import record_function

from glim_tpu_torch.ops import factors as fct
from glim_tpu_torch.ops import gicp, lie, solver
from glim_tpu_torch.ops import imu as imu_ops
from glim_tpu_torch.ops.imu import PreintegratedImu
from glim_tpu_torch.types import upload

BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
MATCH_CHUNK = 256      # factor rows linearized together (bounds temporaries)


def bucket(n: int) -> int:
    for b in BUCKETS:
        if b >= n:
            return b
    return ((n + 1023) // 1024) * 1024


def _between_res(x, T_i, T_j, Z_inv):
    Ti = T_i @ lie.se3_exp(x[:6])
    Tj = T_j @ lie.se3_exp(x[6:])
    return lie.se3_log(Z_inv @ lie.se3_inv(Ti) @ Tj)


def _between_system_full(T_i, T_j, Z, info):
    """Batched SE3 between factors with a full 6x6 information matrix ->
    (H_ii, H_ij, H_jj, g_i, g_j, err)."""
    J, r = fct.batched_jacobian(_between_res, 12, T_i, T_j, lie.se3_inv(Z))
    Jt = J.transpose(-1, -2)
    H = Jt @ info @ J
    g = (Jt @ (info @ r[..., None]))[..., 0]
    err = (r[..., None, :] @ info @ r[..., None])[..., 0, 0]
    return H[:, :6, :6], H[:, :6, 6:], H[:, 6:, 6:], g[:, :6], g[:, 6:], err


def _endpoint_imu_res(x, T_i, T_j, junc, A_R, A_L, pre_t, gravity):
    pre = PreintegratedImu(*pre_t)
    T_R = (T_i @ lie.se3_exp(x[:6])) @ A_R
    T_L = (T_j @ lie.se3_exp(x[6:12])) @ A_L
    return imu_ops.imu_residual(T_R[:3, :3], T_R[:3, 3], junc[:3] + x[12:15],
                                T_L[:3, :3], T_L[:3, 3], junc[3:6] + x[15:18],
                                junc[6:12] + x[18:24], pre, gravity)


def _endpoint_imu_system(T_i, T_j, junc, A_R, A_L, pre: PreintegratedImu, gravity):
    """Batched endpoint-chain factors, dof [xi_i (6), xi_j (6), d_junc (12)]
    -> (H (J, 24, 24), g (J, 24), err (J,))."""
    J, r = fct.batched_jacobian(_endpoint_imu_res, 24, T_i, T_j, junc, A_R, A_L,
                                pre.astuple(), shared=(gravity,))
    cov = pre.cov + torch.eye(9, device=pre.cov.device) * 1e-6
    info = torch.linalg.solve_ex(cov, torch.cat([r[..., None], J], dim=-1))[0]
    Jt = J.transpose(-1, -2)
    return Jt @ info[..., 1:], (Jt @ info[..., :1])[..., 0], torch.sum(r * info[..., 0], -1)


def _rows6(idx: torch.Tensor) -> torch.Tensor:
    """(n,) pose indices -> (n, 6) rows of the state vector."""
    return idx.to(torch.int64)[:, None] * 6 + torch.arange(6, device=idx.device)


class _System:
    """Index/value lists of one linearization, summed into (H, g) at once."""

    def __init__(self):
        self.h: List[tuple] = []
        self.g: List[tuple] = []

    def block(self, rows_a, rows_b, vals):
        """vals (n, a, b) at rows_a (n, a) x rows_b (n, b)."""
        n, a, b = vals.shape
        self.h.append((rows_a[:, :, None].expand(n, a, b).reshape(-1),
                       rows_b[:, None, :].expand(n, a, b).reshape(-1), vals.reshape(-1)))

    def pair(self, rows_i, rows_j, H_ii, H_ij, H_jj, w):
        w = w[:, None, None]
        self.block(rows_i, rows_i, w * H_ii)
        self.block(rows_i, rows_j, w * H_ij)
        self.block(rows_j, rows_i, w * H_ij.transpose(1, 2))
        self.block(rows_j, rows_j, w * H_jj)

    def vec(self, rows, vals):
        self.g.append((rows.reshape(-1), vals.reshape(-1)))

    def assemble(self, D: int, device):
        H = torch.zeros(D, D, device=device)
        g = torch.zeros(D, device=device)
        H.index_put_((torch.cat([r for r, _, _ in self.h]), torch.cat([c for _, c, _ in self.h])),
                     torch.cat([v for _, _, v in self.h]), accumulate=True)
        g.index_put_((torch.cat([r for r, _ in self.g]),), torch.cat([v for _, v in self.g]),
                     accumulate=True)
        return H, g


_match_core = vmap(gicp.linearize_core_soa)


@record_function("global_gn")
def global_gn(poses0, junc0,
              # matching factors (cached correspondences)
              f_tgt, f_src, f_w, f_mu, f_ct, f_hit,
              sm_pts, sm_covs,
              # between factors (full 6x6 information)
              b_i, b_j, b_Z, b_info, b_valid,
              # IMU endpoint factors (m_pre: a PreintegratedImu stack)
              m_i, m_j, m_AR, m_AL, m_pre, m_valid,
              # priors / anchors / recovery
              prior_T, prior_sqrt, grav_idx, grav_valid, grav_sqrt,
              damping, gravity, matching_weight,
              # translation priors (GNSS / external position constraints)
              t_idx=None, t_pos=None, t_sqrt=None, t_valid=None,
              *, Sp: int, Fp: int, Bp: int, Jp: int, Ap: int, Tp: int = 0,
              iters: int = 5, shard_mesh=None):
    """Damped GN over the submap poses (+ junction states). Returns
    (poses' (Sp, 4, 4), junc' (Jp, 12), err, min_diag (Sp,)): err and the
    per-pose Hessian-diagonal minima come from the last linearization, one
    update before the returned poses, as in the JAX package.

    ``shard_mesh`` (``parallel.sharded.Mesh``) splits the Fp matching rows
    into ``shard_mesh.size`` contiguous slices, each linearized on its
    device; the blocks come back concatenated on ``poses0.device`` in row
    order. Fp must be a multiple of the mesh size."""
    dev = poses0.device
    D = Sp * 6 + Jp * 12
    rows_all = _rows6(torch.arange(Sp, device=dev))
    f_rows_t, f_rows_s = _rows6(f_tgt), _rows6(f_src)
    b_rows_i, b_rows_j = _rows6(b_i), _rows6(b_j)
    m_rows = torch.cat([_rows6(m_i), _rows6(m_j),
                        Sp * 6 + torch.arange(Jp * 12, device=dev).reshape(Jp, 12)], dim=1)
    f_src64 = f_src.to(torch.int64)
    f_tgt64 = f_tgt.to(torch.int64)

    # One SoA relayout per call: point axis last, symmetric 3x3 packed.
    f_mu_s = f_mu.transpose(-1, -2)
    f_ct_s = gicp.sym_pack_soa(f_ct)
    sm_pts_s = sm_pts.transpose(-1, -2)
    sm_covs_s = gicp.sym_pack_soa(sm_covs)
    f_use = f_hit & (f_w > 0)[:, None]
    mw = matching_weight * f_w
    if shard_mesh is not None:
        # The factor rows' slices go to their devices once a call, the
        # submap clouds (any row may read any submap) to each distinct one.
        from glim_tpu_torch.parallel.sharded import replicas, shard_slices
        clouds = replicas(shard_mesh, lambda d: (sm_pts_s.to(d), sm_covs_s.to(d)))
        rows = zip(*(shard_slices(shard_mesh, x, "global_gn")
                     for x in (f_tgt64, f_src64, f_mu_s, f_ct_s, f_use)))
        shards = list(zip(shard_mesh.devices, rows))

    def match_rows(T, tgt, src, mu_s, ct_s, use, pts_s, covs_s):
        T_rel = lie.se3_inv(T[tgt]) @ T[src]
        outs = []
        for s in range(0, int(tgt.shape[0]), MATCH_CHUNK):
            e = s + MATCH_CHUNK
            outs.append(_match_core(T_rel[s:e, :3, :3], T_rel[s:e, :3, 3], pts_s[src[s:e]],
                                    covs_s[src[s:e]], mu_s[s:e], ct_s[s:e], use[s:e]))
        return [torch.cat(parts) for parts in zip(*outs)]

    def match_blocks(T):
        if shard_mesh is None:
            return match_rows(T, f_tgt64, f_src64, f_mu_s, f_ct_s, f_use, sm_pts_s, sm_covs_s)
        outs = [match_rows(T.to(d), *rows, *clouds[d]) for d, rows in shards]
        return [torch.cat([x.to(dev) for x in parts]) for parts in zip(*outs)]

    def linearize(T, junc):
        sys = _System()
        Htt, Hts, Hss, bt, bs, ev = match_blocks(T)
        sys.pair(f_rows_t, f_rows_s, Htt, Hts, Hss, mw)
        sys.vec(f_rows_t, mw[:, None] * bt)
        sys.vec(f_rows_s, mw[:, None] * bs)
        err = torch.sum(mw * ev)

        Hii, Hij, Hjj, gi, gj, be = _between_system_full(T[b_i.to(torch.int64)],
                                                         T[b_j.to(torch.int64)], b_Z, b_info)
        bw = b_valid.to(torch.float32)
        sys.pair(b_rows_i, b_rows_j, Hii, Hij, Hjj, bw)
        sys.vec(b_rows_i, bw[:, None] * gi)
        sys.vec(b_rows_j, bw[:, None] * gj)
        err = err + torch.sum(bw * be)

        if Jp > 0:
            Hm, gm, em = _endpoint_imu_system(T[m_i.to(torch.int64)], T[m_j.to(torch.int64)],
                                              junc, m_AR, m_AL, m_pre, gravity)
            w = m_valid.to(torch.float32)
            sys.block(m_rows, m_rows, w[:, None, None] * Hm)
            sys.vec(m_rows, w[:, None] * gm)
            err = err + torch.sum(w * em)
            # Weak junction regularization keeps padded/unobserved states sane.
            jrows = Sp * 6 + torch.arange(Jp * 12, device=dev)
            sys.block(jrows[:, None], jrows[:, None],
                      torch.full((Jp * 12, 1, 1), 1e-4, device=dev))

        pH, pb, perr = fct.prior_linearize(T[:1], prior_T[None], prior_sqrt[None])
        sys.block(rows_all[:1], rows_all[:1], pH)
        sys.vec(rows_all[:1], pb)
        err = err + perr[0]

        if Ap > 0:
            ez = torch.cat([torch.zeros(Ap, 2, device=dev), torch.ones(Ap, 1, device=dev)], 1)
            gH, gb, gerr = fct.rotate_vector3_linearize(
                T[grav_idx.to(torch.int64)], ez, ez, grav_sqrt.expand(Ap, 3))
            w = grav_valid.to(torch.float32)
            rows = _rows6(grav_idx)
            sys.block(rows, rows, w[:, None, None] * gH)
            sys.vec(rows, w[:, None] * gb)
            err = err + torch.sum(w * gerr)

        if Tp > 0:
            tH, tb, terr = fct.translation_prior_linearize(T[t_idx.to(torch.int64)], t_pos,
                                                           t_sqrt)
            w = t_valid.to(torch.float32)
            rows = _rows6(t_idx)
            sys.block(rows, rows, w[:, None, None] * tH)
            sys.vec(rows, w[:, None] * tb)
            err = err + torch.sum(w * terr)

        # Per-pose recovery damping + base regularization on padded slots.
        sys.block(rows_all, rows_all,
                  damping[:, None, None] * torch.eye(6, device=dev).expand(Sp, 6, 6))
        H, g = sys.assemble(D, dev)
        return H + torch.eye(D, device=dev) * 1e-6, g, err

    T, junc = poses0, junc0
    err = torch.zeros((), device=dev)
    min_diag = torch.full((Sp,), float("inf"), device=dev)
    for _ in range(iters):
        H, g, err = linearize(T, junc)
        delta = solver.solve_damped(H, g, 1e-4)
        T = T @ lie.se3_exp(delta[:Sp * 6].reshape(Sp, 6))
        if Jp:
            junc = junc + delta[Sp * 6:].reshape(Jp, 12)
        min_diag = torch.diagonal(H)[:Sp * 6].reshape(Sp, 6).min(dim=1).values
        # The convergence gate: the one host read of an iteration.
        if bool(torch.max(torch.abs(delta)) < 1e-4):
            break
    return T, junc, err, min_diag


def pad_stack(items, pad_to: int, template, device) -> torch.Tensor:
    """Stack identically shaped items and pad the leading axis to ``pad_to``
    with ``template`` entries. With a tensor template the items are device
    tensors, stacked on the device; otherwise they are host values (numpy
    arrays / Python scalars), which become one padded numpy array and go up
    in one pinned copy."""
    if isinstance(template, torch.Tensor):
        pad = template[None].expand((pad_to - len(items),) + tuple(template.shape))
        return torch.cat([torch.stack(items), pad]) if items else pad.clone()
    t = np.asarray(template)
    if pad_to == 0:
        return torch.empty((0,) + t.shape, dtype=torch.from_numpy(t).dtype, device=device)
    out = np.empty((pad_to,) + t.shape, t.dtype)
    out[:] = t
    if items:
        out[:len(items)] = np.stack([np.asarray(x, t.dtype) for x in items])
    return upload(out, device)


def pad_stack_tree(trees, pad_to: int, zero: PreintegratedImu) -> PreintegratedImu:
    """Stack PreintegratedImu items field by field, padded with ``zero``."""
    fields = list(zip(*(t.astuple() for t in trees))) if trees else \
        [()] * len(zero.astuple())
    return PreintegratedImu(*(
        torch.cat([torch.stack(f), z[None].expand((pad_to - len(f),) + tuple(z.shape))])
        if f else z[None].expand((pad_to,) + tuple(z.shape)).clone()
        for f, z in zip(fields, zero.astuple())))
