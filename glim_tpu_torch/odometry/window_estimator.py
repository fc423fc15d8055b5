"""Device-side sliding-window LiDAR-IMU estimator core.

Twin of ``glim_tpu/odometry/window_estimator.py``. One call of
``window_scan_step`` is the whole per-scan step over a ring-buffer state:

  preintegrate IMU -> predict -> IMU-rate deskew -> covariances ->
  marginalize the oldest state (Schur prior) -> insert the new state ->
  batch GN over W states (15 dof each) -> freeze the newest matching
  linearization -> marginalization system for the next eviction

The newest state matches the map live at full resolution; every older state
carries a frozen 6x6 matching system, one of which is re-linearized
round-robin per scan from its stored 1/OLD_SUBSAMPLE points. States are
right-aligned in the ring (newest at slot W-1).

Port notes: the step is functional — every window field is rebuilt with
``cat``/``where``/``index_select`` and nothing is updated in place, so the
returned frame fields and the marginalised state never alias the next
window. Data-dependent choices stay on the device (``torch.where`` and index
tensors); the step adds no host synchronisation. Factor Jacobians use
forward-mode ``torch.func.jacfwd`` (reverse mode would turn the sanitised
``where`` branches of ``ops/lie.py`` into 0 * NaN gradients), evaluated in
float64: forward-mode AD gives the tangent of a 0-dim float32 tensor combined
with a Python float the dtype float64, which breaks the residual's matmuls;
in float64 primal and tangent agree. J and r are cast back to float32, and
everything downstream of them stays float32 as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch
from torch.func import jacfwd, vmap

from glim_tpu_torch.ops import covariance as cov_ops
from glim_tpu_torch.ops import deskew as deskew_ops
from glim_tpu_torch.ops import gicp, lie, solver
from glim_tpu_torch.ops import imu as imu_ops
from glim_tpu_torch.ops.imu import PreintegratedImu
from glim_tpu_torch.ops.nn_search import nn_search
from glim_tpu_torch.ops.voxelmap import GaussianVoxelMap, lookup_table

STATE_DIM = 15      # [pose (6), velocity (3), bias (6)]
OLD_SUBSAMPLE = 4   # older frames keep every 4th point for relinearization

# Status vector layout (host side decodes by these offsets).
STATUS_FINITE = 0
STATUS_ERR = 1
STATUS_OVERLAP = 2
STATUS_MARGINALIZED = 3
STATUS_LOGDET = 4      # log|H| of the newest live matching block (ENTROPY)
STATUS_DTRANS = 5      # displacement vs the given last-keyframe pose
STATUS_DROT = 6
STATUS_POSES = 7       # then: T_pred (16), v_pred (3), T_opt (16), v_opt (3)
STATUS_LEN = STATUS_POSES + 38


@dataclass
class WindowState:
    """Ring buffer of the W most recent states + frames + marginalization
    prior + frozen per-state matching linearizations."""

    T: torch.Tensor        # (W, 4, 4) T_world_imu
    v: torch.Tensor        # (W, 3)
    b: torch.Tensor        # (W, 6) [ba, bg]
    stamp: torch.Tensor    # (W,)
    valid: torch.Tensor    # (W,) bool
    pts: torch.Tensor      # (W, Cs, 3) lidar-frame deskewed points
    covs: torch.Tensor     # (W, Cs, 3, 3)
    mask: torch.Tensor     # (W, Cs)
    preints: PreintegratedImu   # stacked (W-1, ...); entry k connects k -> k+1
    m_H: torch.Tensor      # (W, 6, 6) frozen matching systems
    m_g: torch.Tensor      # (W, 6)
    m_e: torch.Tensor      # (W,)
    m_Tlin: torch.Tensor   # (W, 4, 4)
    m_valid: torch.Tensor  # (W,) bool
    H_prior: torch.Tensor      # (15, 15) dense prior on the oldest valid state
    b_prior: torch.Tensor      # (15,)
    T_anchor: torch.Tensor     # (4, 4)
    v_anchor: torch.Tensor     # (3,)
    b_anchor: torch.Tensor     # (6,)
    H_marg: torch.Tensor       # (30, 30) system over [oldest | oldest+1]
    b_marg: torch.Tensor       # (30,)
    step: torch.Tensor         # () int32 monotone scan counter

    def replace(self, **kw) -> "WindowState":
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d.update(kw)
        return WindowState(**d)


def _zero_preints(W: int, device) -> PreintegratedImu:
    n = W - 1
    z = lambda *s: torch.zeros((n,) + s, device=device)
    eye = torch.eye(3, device=device).expand(n, 3, 3).clone()
    return PreintegratedImu(dR=eye, dv=z(3), dp=z(3), dt=z(), H_Rg=z(3, 3),
                            H_va=z(3, 3), H_vg=z(3, 3), H_pa=z(3, 3),
                            H_pg=z(3, 3), cov=z(9, 9), bias=z(6))


def empty_window(W: int, C_sub: int, device) -> WindowState:
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
    eye4 = lambda n: torch.eye(4, device=device).expand(n, 4, 4).clone()
    return WindowState(
        T=eye4(W), v=z(W, 3), b=z(W, 6), stamp=z(W), valid=z(W, dt=torch.bool),
        pts=z(W, C_sub, 3), covs=z(W, C_sub, 3, 3), mask=z(W, C_sub, dt=torch.bool),
        preints=_zero_preints(W, device),
        m_H=z(W, 6, 6), m_g=z(W, 6), m_e=z(W), m_Tlin=eye4(W),
        m_valid=z(W, dt=torch.bool),
        H_prior=z(STATE_DIM, STATE_DIM), b_prior=z(STATE_DIM),
        T_anchor=torch.eye(4, device=device), v_anchor=z(3), b_anchor=z(6),
        H_marg=z(2 * STATE_DIM, 2 * STATE_DIM), b_marg=z(2 * STATE_DIM),
        step=torch.zeros((), dtype=torch.int32, device=device))


def _take(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """a[j] along axis 0 for a device index (a gather, no host sync)."""
    return a.index_select(0, j.reshape(1).to(torch.int64))[0]


def _set_last(a: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:-1], new[None]])


def _roll_set(a: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """jnp.roll(a, -1, 0).at[-1].set(new)."""
    return torch.cat([a[1:], new[None]])


def _state_residual(T, v, b, T_anchor, v_anchor, b_anchor):
    r_T = lie.se3_log(lie.se3_inv(T_anchor) @ T)
    return torch.cat([r_T, v - v_anchor, b - b_anchor])


def _prior_res(xi, T0, v0, b0, T_anchor, v_anchor, b_anchor):
    r = _state_residual(T0 @ lie.se3_exp(xi[:6]), v0 + xi[6:9], b0 + xi[9:15],
                        T_anchor, v_anchor, b_anchor)
    return r, r


def _f64(*ts):
    return tuple(t.to(torch.float64) for t in ts)


def _prior_system(T0, v0, b0, T_anchor, v_anchor, b_anchor, H_prior, b_prior):
    zero = torch.zeros(STATE_DIM, dtype=torch.float64, device=T0.device)
    with lie.forward_ad_lock:
        J, r = jacfwd(_prior_res, has_aux=True)(
            zero, *_f64(T0, v0, b0, T_anchor, v_anchor, b_anchor))
    J, r = J.float(), r.float()
    H = J.T @ H_prior @ J
    b = J.T @ (H_prior @ r + b_prior)
    err = r @ H_prior @ r + 2.0 * b_prior @ r
    return H, b, err


def _imu_res(xi, T_i, v_i, T_j, v_j, b_i, pre_t, gravity):
    pre = PreintegratedImu(*pre_t)
    xi_i, xi_j = xi[:STATE_DIM], xi[STATE_DIM:]
    Ti = T_i @ lie.se3_exp(xi_i[:6])
    Tj = T_j @ lie.se3_exp(xi_j[:6])
    r = imu_ops.imu_residual(Ti[:3, :3], Ti[:3, 3], v_i + xi_i[6:9],
                             Tj[:3, :3], Tj[:3, 3], v_j + xi_j[6:9],
                             b_i + xi_i[9:15], pre, gravity)
    return r, r


_imu_jac = jacfwd(_imu_res, has_aux=True)


def _imu_systems(J: torch.Tensor, r: torch.Tensor, cov: torch.Tensor):
    """Whitened GN blocks from residual Jacobians: batched (..., 9, 30)."""
    cov = cov + torch.eye(9, device=cov.device) * 1e-8
    info = torch.linalg.solve_ex(cov, torch.cat([r[..., None], J], dim=-1))[0]
    info_r, info_J = info[..., 0], info[..., 1:]
    Jt = J.transpose(-1, -2)
    return Jt @ info_J, (Jt @ info_r[..., None])[..., 0], torch.sum(r * info_r, -1)


def _imu_factor_system(T_i, v_i, T_j, v_j, b_i, pre: PreintegratedImu, gravity):
    zero = torch.zeros(2 * STATE_DIM, dtype=torch.float64, device=T_i.device)
    with lie.forward_ad_lock:
        J, r = _imu_jac(zero, *_f64(T_i, v_i, T_j, v_j, b_i), _f64(*pre.astuple()),
                        gravity.double())
    return _imu_systems(J.float(), r.float(), pre.cov)


def _imu_factor_systems(T_i, v_i, T_j, v_j, b_i, pre: PreintegratedImu, gravity):
    """_imu_factor_system over a leading batch of state pairs."""
    zero = torch.zeros(2 * STATE_DIM, dtype=torch.float64, device=T_i.device)
    with lie.forward_ad_lock:
        J, r = vmap(_imu_jac, in_dims=(None, 0, 0, 0, 0, 0, 0, None))(
            zero, *_f64(T_i, v_i, T_j, v_j, b_i), _f64(*pre.astuple()),
            gravity.double())
    return _imu_systems(J.float(), r.float(), pre.cov)


def _frozen_matching_system(T, m_H, m_g, m_e, m_Tlin, w):
    """Evaluate frozen matching linearizations at poses T (batched over a
    leading axis): at xi = log(Tlin^-1 T) the stored quadratic model gives
    gradient g + H xi and error e + 2 g.xi + xi.H.xi."""
    xi = lie.se3_log(lie.se3_inv(m_Tlin) @ T)
    Hxi = (m_H @ xi[..., None])[..., 0]
    g = m_g + Hxi
    e = m_e + 2.0 * torch.sum(m_g * xi, -1) + torch.sum(xi * Hxi, -1)
    return w[..., None, None] * m_H, w[..., None] * g, w * e


def _build_pair_system(T_c, v_c, b_c, valid, pre_ring, j,
                       T_anchor, v_anchor, b_anchor, H_prior, b_prior,
                       m_H, m_g, m_e, m_Tlin, m_valid, bias_rw_info, gravity):
    """GN system over [state_j | state_{j+1}] from ONLY the factors incident
    to state j (prior, IMU j->j+1, bias walk, frozen matching(j)), at the
    given estimate — the next eviction Schur-complements this."""
    W = T_c.shape[0]
    j1 = torch.clamp(j + 1, max=W - 1)
    take = lambda a: _take(a, j)
    take1 = lambda a: _take(a, j1)
    Tj, vj, bj = take(T_c), take(v_c), take(b_c)
    Tj1, vj1 = take1(T_c), take1(v_c)
    bj1 = take1(b_c)
    jp = torch.clamp(j, max=pre_ring.dt.shape[0] - 1)
    pre_j = pre_ring.map(lambda x: _take(x, jp))

    w_pair = (take(valid) & take1(valid)).to(torch.float32)
    Hp, bp, _ = _prior_system(Tj, vj, bj, T_anchor, v_anchor, b_anchor,
                              H_prior, b_prior)
    ok = w_pair * (pre_j.dt > 1e-6).to(torch.float32)
    Hi, bi, _ = _imu_factor_system(Tj, vj, Tj1, vj1, bj, pre_j, gravity)
    info = bias_rw_info / torch.clamp(pre_j.dt, min=1e-3)
    Hb = ok * torch.diag(info)
    r_b = bj1 - bj
    w_m = w_pair * take(m_valid).to(torch.float32)
    Hf, gf, _ = _frozen_matching_system(Tj, take(m_H), take(m_g), take(m_e),
                                        take(m_Tlin), w_m)

    Hm = ok * Hi
    Hm[:15, :15] += w_pair * Hp
    Hm[9:15, 9:15] += Hb
    Hm[24:30, 24:30] += Hb
    Hm[9:15, 24:30] -= Hb
    Hm[24:30, 9:15] -= Hb
    Hm[:6, :6] += Hf
    bm = ok * bi
    bm[:15] += w_pair * bp
    bm[9:15] -= ok * info * r_b
    bm[24:30] += ok * info * r_b
    bm[:6] += gf
    return Hm, bm


def _index_add(H: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor) -> None:
    H.index_put_((rows, cols), vals, accumulate=True)


def window_scan_step(win: WindowState, vms,
                     scan_pts, scan_times, scan_mask, scan_neighbors,
                     imu_packed, T_lidar_imu, gravity,
                     acc_noise, gyro_noise, int_noise, bias_rw_info,
                     matching_weight, T_last_keyframe, max_corr_dist,
                     vel_reg=None, *, W: int, outer_iters: int = 2,
                     inner_iters: int = 2, compute_covs: bool = False,
                     matching: str = "vgicp", full_connection: int = 2,
                     search=None):
    """One odometry step. Returns (win', outputs dict).

    ``imu_packed`` is the (cap+1, 8) per-scan upload: rows 0..cap-1 are IMU
    samples [acc(3), gyro(3), stamp_rel, dt] relative to the scan start; the
    last row is [n_imu, scan_stamp, force_evict, 0...]. ``vms`` is read-only:
    ``matching="vgicp"`` takes the multi-resolution GaussianVoxelMaps (a
    tuple, or one map) and matches against every level;
    ``matching="gicp"`` takes one PointVoxelMap and searches the nearest
    map point (capped at max_corr_dist) with ``nn_search``, or with
    ``search`` where given (a graph capture breaks there:
    ``window_graph.py``)."""
    if matching not in ("gicp", "vgicp"):
        raise ValueError(f"window_scan_step: unknown matching {matching!r}")
    dev = scan_pts.device
    f32 = torch.float32

    imu_cap = imu_packed.shape[0] - 1
    imu_acc = imu_packed[:imu_cap, 0:3]
    imu_gyro = imu_packed[:imu_cap, 3:6]
    imu_stamps_rel = imu_packed[:imu_cap, 6]
    imu_dts = imu_packed[:imu_cap, 7]
    meta = imu_packed[imu_cap]
    imu_mask = torch.arange(imu_cap, device=dev) < meta[0].to(torch.int32)
    scan_stamp = meta[1]
    force_evict = meta[2] > 0.5

    # lookup_soa gives one correspondence set (mu (3, C), packed C_t (6, C),
    # hit (C,)) per map level: one for the GICP point map, one per
    # resolution level for VGICP. The first set's hit mask is the overlap.
    if matching == "gicp":
        pm = vms
        max_d2 = max_corr_dist * max_corr_dist

        def lookup_soa(T_wl, pts, mask):
            """Nearest map point per scan point, relaid out to SoA."""
            q = pts @ T_wl[:3, :3].T + T_wl[:3, 3]
            idx, d2 = (nn_search if search is None else search)(
                q, mask, pm.points, pm.mask)
            idx = idx.to(torch.int64)
            hit = mask & (d2 < max_d2) & torch.isfinite(d2)
            return [(pm.points[idx].T, gicp.sym_pack_soa(pm.covs[idx]), hit)]
    else:
        levels = (vms,) if isinstance(vms, GaussianVoxelMap) else tuple(vms)
        # The maps are read-only here: build each level's key table once.
        tables = [(vm, lookup_table(vm)) for vm in levels]
        eye4 = torch.eye(4, device=dev)

        def lookup_soa(T_wl, pts, mask):
            out = []
            for vm, keys in tables:
                mu, Ct, hit = gicp.vgicp_lookup(eye4, T_wl, pts, mask, vm, keys)
                out.append((mu.T, gicp.sym_pack_soa(Ct), hit))
            return out

    def match_one(T_wl, pts_s, covs_s, corr):
        mu_s, ct_s, hit = corr
        return gicp.linearize_core_soa(T_wl[:3, :3], T_wl[:3, 3], pts_s, covs_s,
                                       mu_s, ct_s, hit, source_only=True)

    def match_soa(T_wl, pts_s, covs_s, corrs):
        """(H_ss, b_s, error) summed over the correspondence sets."""
        H, g, e = match_one(T_wl, pts_s, covs_s, corrs[0])
        for corr in corrs[1:]:
            Hs, bs, es = match_one(T_wl, pts_s, covs_s, corr)
            H, g, e = H + Hs, g + bs, e + es
        return H, g, e

    D = W * STATE_DIM
    T_imu_lidar = lie.se3_inv(T_lidar_imu)
    Ad = lie.se3_adjoint(lie.se3_inv(T_imu_lidar))
    arangeW = torch.arange(W, device=dev)

    T_prev, v_prev, b_prev = win.T[W - 1], win.v[W - 1], win.b[W - 1]

    # --- 1. preintegrate (t_prev, t_scan] and predict ---
    pre_dts = torch.clamp(imu_dts - torch.clamp(imu_stamps_rel, min=0.0), min=0.0)
    pre_mask = imu_mask & (imu_stamps_rel - imu_dts < -1e-9)
    pre_new = imu_ops.preintegrate(imu_acc, imu_gyro, pre_dts, pre_mask,
                                   b_prev, acc_noise, gyro_noise, int_noise)
    R_j, p_j, v_pred = imu_ops.predict(T_prev[:3, :3], T_prev[:3, 3], v_prev,
                                       pre_new, b_prev, gravity)
    T_pred = lie.make_se3(R_j, p_j)

    # --- 2. IMU-rate deskew of the new scan ---
    Rs, ps, _ = imu_ops.integrate_poses(T_prev[:3, :3], T_prev[:3, 3], v_prev,
                                        b_prev, gravity, imu_acc, imu_gyro,
                                        imu_dts, imu_mask)
    # Padding lanes sort after the real stamps for the binary search.
    stamps_sorted = torch.where(imu_mask, imu_stamps_rel, float("inf"))
    stamps_t, quats_t, trans_t = deskew_ops.imu_pose_table(stamps_sorted, Rs, ps)
    enough_imu = imu_mask.sum() >= 2
    deskewed = torch.where(enough_imu,
                           deskew_ops.deskew_imu(scan_pts, scan_times, scan_mask,
                                                 stamps_t, quats_t, trans_t,
                                                 T_lidar_imu),
                           scan_pts)
    covs_new, normals_new = cov_ops.estimate_covariances(
        deskewed, scan_mask, scan_neighbors, "plane")
    deskewed_s = deskewed.T                                  # (3, C)
    covs_new_s = gicp.sym_pack_soa(covs_new)                 # (6, C)

    # --- 3. evict the oldest state (decided on the host, passed in) ---
    j_old = win.valid.to(torch.int32).argmax()               # oldest valid slot
    evict = (win.valid.sum() >= 2) & force_evict
    marg_T_wi = _take(win.T, j_old)
    marg_T_wl = marg_T_wi @ T_imu_lidar
    marg_v, marg_b = _take(win.v, j_old), _take(win.b, j_old)
    marg_stamp = _take(win.stamp, j_old)

    # Schur prior from the stored oldest-pair system: reorder
    # [state_{j+1} | state_j], marginalize the trailing 15 dof.
    H2 = torch.roll(win.H_marg, (-STATE_DIM, -STATE_DIM), (0, 1))
    b2 = torch.roll(win.b_marg, -STATE_DIM, 0)
    H_schur, b_schur = solver.schur_marginalize(H2, b2, STATE_DIM)
    j_old1 = torch.clamp(j_old + 1, max=W - 1)
    H_prior_n = torch.where(evict, H_schur, win.H_prior)
    b_prior_n = torch.where(evict, b_schur, win.b_prior)
    T_anchor_n = torch.where(evict, _take(win.T, j_old1), win.T_anchor)
    v_anchor_n = torch.where(evict, _take(win.v, j_old1), win.v_anchor)
    b_anchor_n = torch.where(evict, _take(win.b, j_old1), win.b_anchor)
    valid_pre = win.valid & ~(evict & (arangeW == j_old))

    sub_pts = deskewed[::OLD_SUBSAMPLE].contiguous()
    sub_covs = covs_new[::OLD_SUBSAMPLE]
    sub_mask = scan_mask[::OLD_SUBSAMPLE].contiguous()

    T_r = _roll_set(win.T, T_pred)
    v_r = _roll_set(win.v, v_pred)
    b_r = _roll_set(win.b, b_prev)
    stamp_r = _roll_set(win.stamp, scan_stamp)
    valid_r = _roll_set(valid_pre, torch.ones((), dtype=torch.bool, device=dev))
    pts_r = _roll_set(win.pts, sub_pts)
    covs_r = _roll_set(win.covs, sub_covs)
    mask_r = _roll_set(win.mask, sub_mask)
    pre_r = PreintegratedImu(*(_roll_set(rb, new) for rb, new in
                               zip(win.preints.astuple(), pre_new.astuple())))
    mH_r = torch.roll(win.m_H, -1, 0)
    mg_r = torch.roll(win.m_g, -1, 0)
    me_r = torch.roll(win.m_e, -1, 0)
    mT_r = _roll_set(win.m_Tlin, T_pred)
    mv_r = _roll_set(win.m_valid, torch.zeros((), dtype=torch.bool, device=dev))

    prior_idx = valid_r.to(torch.int32).argmax()             # oldest valid (post-roll)

    # --- 3b. per-scan relinearization of older states against the current
    # map: the newest `full_connection - 1` older states every scan, plus
    # one of the rest round-robin. ---
    def _refresh_slot(k, bufs):
        mH, mg, me, mT, mv = bufs
        kk = torch.clamp(k, 0, W - 1)
        T_wl_k = _take(T_r, kk) @ T_imu_lidar
        pts_k = _take(pts_r, kk)
        mask_k = _take(mask_r, kk) & _take(valid_r, kk)
        Hk, gk, ek = match_soa(T_wl_k, pts_k.T, gicp.sym_pack_soa(_take(covs_r, kk)),
                               lookup_soa(T_wl_k, pts_k, mask_k))
        w_k = OLD_SUBSAMPLE * matching_weight
        do = _take(valid_r, kk) & (k < W - 1) & (k >= 0)
        sel = (arangeW == k) & do
        mH = torch.where(sel[:, None, None], w_k * (Ad.T @ Hk @ Ad), mH)
        mg = torch.where(sel[:, None], w_k * (Ad.T @ gk), mg)
        me = torch.where(sel, w_k * ek, me)
        mT = torch.where(sel[:, None, None], _take(T_r, kk), mT)
        mv = mv | sel
        return mH, mg, me, mT, mv

    bufs = (mH_r, mg_r, me_r, mT_r, mv_r)
    fc_extra = min(max(full_connection - 1, 0), W - 2)
    for j in range(fc_extra):
        bufs = _refresh_slot(torch.full((), W - 2 - j, device=dev), bufs)
    n_rest = torch.clamp(valid_r.sum() - 1 - fc_extra, min=1)
    k_rr = W - 2 - fc_extra - (win.step.to(torch.int64) % n_rest)
    mH_r, mg_r, me_r, mT_r, mv_r = _refresh_slot(k_rr, bufs)

    # --- 4. batch GN over the window ---
    rows30 = (torch.arange(W - 1, device=dev)[:, None] * STATE_DIM
              + torch.arange(2 * STATE_DIM, device=dev)[None, :])   # (W-1, 30)
    rows6 = (arangeW[:, None] * STATE_DIM
             + torch.arange(6, device=dev)[None, :])                # (W, 6)
    pair_ok = (valid_r[:-1] & valid_r[1:] & (pre_r.dt > 1e-6)).to(f32)
    walk_info = bias_rw_info[None, :] / torch.clamp(pre_r.dt, min=1e-3)[:, None]
    bias_rows_i = rows30[:, 9:15]
    bias_rows_j = rows30[:, 24:30]
    prior_rows = prior_idx.to(torch.int64) * STATE_DIM + torch.arange(STATE_DIM, device=dev)

    # Prior and IMU factors are linearized ONCE per scan at the entry
    # estimates; the GN iterations evaluate their quadratic models with a
    # first-order-corrected gradient (g0 + H * delta).
    Hp0, bp0, ep0 = _prior_system(_take(T_r, prior_idx), _take(v_r, prior_idx),
                                  _take(b_r, prior_idx), T_anchor_n, v_anchor_n,
                                  b_anchor_n, H_prior_n, b_prior_n)
    Hk0, bk0, ek0 = _imu_factor_systems(T_r[:-1], v_r[:-1], T_r[1:], v_r[1:],
                                        b_r[:-1], pre_r, gravity)
    w_frozen = (mv_r & valid_r).to(f32) * (arangeW < W - 1).to(f32)

    def linearize(T, v, b, corr_new):
        H = torch.zeros((D, D), device=dev)
        g = torch.zeros(D, device=dev)
        delta = torch.cat([lie.se3_log(lie.se3_inv(T_r) @ T), v - v_r, b - b_r], dim=1)

        # Prior on the oldest valid state (frozen quadratic model).
        d0 = _take(delta, prior_idx)
        _index_add(H, prior_rows[:, None], prior_rows[None, :], Hp0)
        g.index_put_((prior_rows,), bp0 + Hp0 @ d0, accumulate=True)
        err = ep0 + 2.0 * (bp0 @ d0) + d0 @ Hp0 @ d0

        # IMU factors k -> k+1 (frozen quadratic models), scatter-added.
        dpair = torch.cat([delta[:-1], delta[1:]], dim=1)           # (W-1, 30)
        Hd = (Hk0 @ dpair[..., None])[..., 0]
        bk = bk0 + Hd
        ek = ek0 + 2.0 * torch.sum(bk0 * dpair, -1) + torch.sum(dpair * Hd, -1)
        _index_add(H, rows30[:, :, None], rows30[:, None, :], pair_ok[:, None, None] * Hk0)
        g.index_put_((rows30,), pair_ok[:, None] * bk, accumulate=True)
        err = err + torch.sum(pair_ok * ek)

        # Bias random walk between consecutive states.
        r_b = b[1:] - b[:-1]
        wi = pair_ok[:, None] * walk_info
        Hb = wi[:, :, None] * torch.eye(6, device=dev)[None]
        _index_add(H, bias_rows_i[:, :, None], bias_rows_i[:, None, :], Hb)
        _index_add(H, bias_rows_j[:, :, None], bias_rows_j[:, None, :], Hb)
        _index_add(H, bias_rows_i[:, :, None], bias_rows_j[:, None, :], -Hb)
        _index_add(H, bias_rows_j[:, :, None], bias_rows_i[:, None, :], -Hb)
        g.index_put_((bias_rows_i,), -wi * r_b, accumulate=True)
        g.index_put_((bias_rows_j,), wi * r_b, accumulate=True)
        err = err + torch.sum(wi * r_b * r_b)

        # Frozen matching factors on all older states.
        Hf, gf, ef = _frozen_matching_system(T, mH_r, mg_r, me_r, mT_r, w_frozen)
        _index_add(H, rows6[:, :, None], rows6[:, None, :], Hf)
        g.index_put_((rows6,), gf, accumulate=True)
        err = err + torch.sum(ef)

        # Live matching for the newest state (full resolution, all levels).
        T_wl_n = T[W - 1] @ T_imu_lidar
        s = (W - 1) * STATE_DIM
        Hs, bs, es = match_soa(T_wl_n, deskewed_s, covs_new_s, corr_new)
        H_live = matching_weight * (Ad.T @ Hs @ Ad)
        H[s:s + 6, s:s + 6] += H_live
        g[s:s + 6] += matching_weight * (Ad.T @ bs)
        err = err + matching_weight * es

        if vel_reg is not None:
            # GN of r = v - proj_{|v|<=v_max}(v) on the newest velocity.
            sv = s + 6
            v_new = v[W - 1]
            speed = torch.linalg.norm(v_new)
            r_v = v_new * torch.clamp(1.0 - vel_reg[1] / torch.clamp(speed, min=1e-6), min=0.0)
            H[sv:sv + 3, sv:sv + 3] += vel_reg[0] * torch.eye(3, device=dev)
            g[sv:sv + 3] += vel_reg[0] * r_v
            err = err + vel_reg[0] * torch.sum(r_v * r_v)
        return H, g, err, H_live

    T_c, v_c, b_c = T_r, v_r, b_r
    err_fin = torch.zeros((), device=dev)
    H_gn = torch.eye(D, device=dev)
    H_live_fin = torch.eye(6, device=dev)
    lam = torch.full((), 1e-4, device=dev)
    for _ in range(outer_iters):
        corr_new = lookup_soa(T_c[W - 1] @ T_imu_lidar, deskewed, scan_mask)
        for _ in range(inner_iters):
            H_gn, g, err_fin, H_live_fin = linearize(T_c, v_c, b_c, corr_new)
            d = solver.solve_damped(H_gn, g, lam).reshape(W, STATE_DIM) * valid_r[:, None]
            T_c = T_c @ lie.se3_exp(d[:, :6])
            v_c = v_c + d[:, 6:9]
            b_c = b_c + d[:, 9:15]

    # --- 5. corruption guard: fall back to the IMU prediction ---
    finite = torch.all(torch.isfinite(T_c)) & torch.all(torch.isfinite(v_c))
    T_c = torch.where(finite, T_c, T_r)
    v_c = torch.where(finite, v_c, v_r)
    b_c = torch.where(finite, b_c, b_r)

    # --- 5b. freeze the newest matching linearization at the final pose ---
    T_wl_fin = T_c[W - 1] @ T_imu_lidar
    corr_fin = lookup_soa(T_wl_fin, sub_pts, sub_mask)
    Hn, gn, en = match_soa(T_wl_fin, deskewed_s[:, ::OLD_SUBSAMPLE],
                           covs_new_s[:, ::OLD_SUBSAMPLE], corr_fin)
    hit0 = corr_fin[0][2]            # overlap: the first level's hits
    w_n = OLD_SUBSAMPLE * matching_weight
    mH_r = _set_last(mH_r, w_n * (Ad.T @ Hn @ Ad))
    mg_r = _set_last(mg_r, w_n * (Ad.T @ gn))
    me_r = _set_last(me_r, w_n * en)
    mT_r = _set_last(mT_r, T_c[W - 1])
    mv_r = _set_last(mv_r, torch.ones((), dtype=torch.bool, device=dev))

    # --- 5c. marginalization system for the NEXT eviction ---
    Hm, bm = _build_pair_system(T_c, v_c, b_c, valid_r, pre_r, prior_idx,
                                T_anchor_n, v_anchor_n, b_anchor_n,
                                H_prior_n, b_prior_n,
                                mH_r, mg_r, me_r, mT_r, mv_r,
                                bias_rw_info, gravity)
    Hm = torch.where(finite, Hm, torch.eye(2 * STATE_DIM, device=dev))
    bm = torch.where(finite, bm, torch.zeros(2 * STATE_DIM, device=dev))

    # --- 6. keyframe-strategy inputs (decided on the host, lagged) ---
    ov = hit0.sum() / torch.clamp(sub_mask.sum(), min=1)
    sign, logdet = torch.linalg.slogdet(H_live_fin + torch.eye(6, device=dev) * 1e-6)
    d_kf = lie.se3_log(lie.se3_inv(T_last_keyframe) @ T_c[W - 1])

    win_new = WindowState(
        T=T_c, v=v_c, b=b_c, stamp=stamp_r, valid=valid_r,
        pts=pts_r, covs=covs_r, mask=mask_r, preints=pre_r,
        m_H=mH_r, m_g=mg_r, m_e=me_r, m_Tlin=mT_r, m_valid=mv_r,
        H_prior=H_prior_n, b_prior=b_prior_n, T_anchor=T_anchor_n,
        v_anchor=v_anchor_n, b_anchor=b_anchor_n, H_marg=Hm, b_marg=bm,
        step=win.step + 1)

    status = torch.cat([
        torch.stack([finite.to(f32), err_fin, ov.to(f32), evict.to(f32),
                     sign * logdet, torch.linalg.norm(d_kf[3:]),
                     torch.linalg.norm(d_kf[:3])]),
        T_pred.reshape(-1), v_pred, T_c[W - 1].reshape(-1), v_c[W - 1]])

    outputs = dict(
        T_wl=T_wl_fin,
        T_wi=T_c[W - 1].clone(), v=v_c[W - 1].clone(), b=b_c[W - 1].clone(),
        deskewed=deskewed, covs=covs_new, normals=normals_new,
        marg=dict(T_wl=marg_T_wl, T_wi=marg_T_wi, v=marg_v, b=marg_b,
                  stamp=marg_stamp, was_full=evict),
        pose_table=(stamps_t, quats_t, trans_t),
        status=status,
    )
    if compute_covs:
        # Marginal covariances of every in-window state from the final
        # window Hessian.
        damp = 1e-4 * torch.diagonal(H_gn) + 1e-6
        Sigma = torch.linalg.inv_ex(H_gn + torch.diag(damp))[0]
        blocks = Sigma.reshape(W, STATE_DIM, W, STATE_DIM)
        outputs["state_covs"] = torch.diagonal(blocks, dim1=0, dim2=2).permute(2, 0, 1)
    return win_new, outputs
