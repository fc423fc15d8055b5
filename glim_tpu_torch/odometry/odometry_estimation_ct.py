"""Continuous-time ICP odometry (LiDAR-only, CT-GICP).

Twin of ``glim_tpu/odometry/odometry_estimation_ct.py`` (reference:
src/glim/odometry/odometry_estimation_ct.cpp:127-318): each scan jointly
estimates its begin and end poses; the matching factor interpolates every
point's pose along the scan (in-factor deskewing), with location-consistency
(begin == previous end) and constant-velocity priors, and damped twist
extrapolation as the initial guess.

A step is one 12-dof Gauss-Newton over [xi_begin, xi_end]: the per-point
Jacobian splits across begin and end with weights (1 - s, s). The
correspondences come from a multi-resolution Gaussian voxel lookup
(``model_type`` "vgicp", the default; the finest level that hits wins) or
from the nearest point of a bounded point model (``model_type`` "ivox",
through ``nn_search``, the CUDA kernel on the card), re-searched every two
iterations. The priors' Jacobians are taken by forward-mode AD under
``ops/lie.forward_ad_lock``. The first scan's solve, against an empty model
where only the tiny location-consistency prior constrains the begin pose, is
discarded on the host (``step`` is a host int), so nothing of it reaches the
pose, the twist or the model. Random draws come from the module's own
``torch.Generator``.

On the card, the ivox model's steps past the bootstrap are replayed from a
CUDA graph (``ct_graph.py``): ``_ct_scan_step`` hands them to the
odometry's ``CTGraphRunner``, and the lookups' ``nn_search`` calls run
eagerly between its segments.

Spans (``utils/profiling.py``, host time, no device sync): ``ct_scan_step``
a step, inside it ``ct/lookup`` a model lookup (4 a step at
``lm_max_iterations`` 8) and ``ct/model_insert``, replayed or not;
``ct/bootstrap_replay`` once, when the bootstrap scans are replayed. An
estimate carries the ``host_stamps`` of its frame and ``estimate``; a frame
that leaves the smoother lag gets ``marginalized`` (``record_map_lag``'s
stages).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks as CB
from glim_tpu_torch.odometry.estimation_base import OdometryEstimationBase
from glim_tpu_torch.ops import covariance as cov_ops
from glim_tpu_torch.ops import lie, solver
from glim_tpu_torch.ops import voxelmap as vmx
from glim_tpu_torch.ops.factors import batched_jacobian
from glim_tpu_torch.ops.gicp import inv_sym3x3
from glim_tpu_torch.ops.nn_search import nn_search
from glim_tpu_torch.types import EstimationFrame, FrameID, PointBatch, PreprocessedFrame
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.profiling import profile_scope
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("odom")

_INNER = 2   # GN iterations per correspondence search


@dataclass
class OdometryEstimationCTParams:
    ivox_resolution: float = 1.0
    ivox_min_points_dist: float = 0.1
    ivox_lru_thresh: int = 200
    # "vgicp": multi-resolution Gaussian voxel maps; "ivox": the reference's
    # bounded point model with nearest-neighbour correspondences.
    model_type: str = "vgicp"
    vgicp_resolution: float = 0.3
    vgicp_levels: int = 2
    vgicp_scaling: float = 2.0
    max_correspondence_distance: float = 2.0
    # Final 6-dof alignment of the deskewed cloud at a fixed intra-scan
    # twist, with LM-style step acceptance (see _ct_scan_step).
    rigid_refine: bool = False
    # Pin the begin pose to the previous scan's end and solve the end pose
    # only.
    anchor_begin: bool = False
    location_consistency_inf_scale: float = 1e4
    constant_velocity_inf_scale: float = 1e3
    lm_max_iterations: int = 8
    smoother_lag: float = 1.0
    model_capacity: int = 65536
    extrapolation_damping: float = 0.85
    update_budget: int = 2048
    bootstrap_frames: int = 5
    # "replay" rebuilds the model from the stored bootstrap scans once the
    # twist has converged; "off" disables it.
    bootstrap_refine: str = "replay"

    @staticmethod
    def from_config(config) -> "OdometryEstimationCTParams":
        p = OdometryEstimationCTParams()
        g = lambda k, d: config.param("odometry_estimation", k, d)
        p.ivox_resolution = g("ivox_resolution", 1.0)
        p.ivox_min_points_dist = g("ivox_min_points_dist", 0.1)
        p.ivox_lru_thresh = int(g("ivox_lru_thresh", 200))
        p.model_type = g("model_type", "vgicp")
        p.vgicp_resolution = g("vgicp_resolution", 0.3)
        p.vgicp_levels = int(g("vgicp_levels", 2))
        # The JAX package's from_config drops this key; the port reads it.
        p.vgicp_scaling = g("vgicp_scaling", 2.0)
        p.rigid_refine = bool(g("rigid_refine", False))
        p.anchor_begin = bool(g("anchor_begin", False))
        p.max_correspondence_distance = g("max_correspondence_distance", 2.0)
        p.location_consistency_inf_scale = g("location_consistency_inf_scale", 1e4)
        p.constant_velocity_inf_scale = g("constant_velocity_inf_scale", 1e3)
        p.lm_max_iterations = int(g("lm_max_iterations", 8))
        p.smoother_lag = g("smoother_lag", 1.0)
        return p


def _interp_poses(T_b, T_e, s):
    """Per-point pose interpolation T(s) = T_b Exp(s log(T_b^-1 T_e)).

    Returns (R (C, 3, 3), t (C, 3))."""
    d = lie.se3_log(lie.se3_inv(T_b) @ T_e)
    T = T_b @ lie.se3_exp(s[:, None] * d[None, :])
    return T[:, :3, :3], T[:, :3, 3]


def _transform(R, t, pts):
    """Per-point rigid transform: (C, 3, 3), (C, 3), (C, 3) -> (C, 3)."""
    return (R @ pts[:, :, None])[:, :, 0] + t


def _ct_linearize(T_b, T_e, pts, covs, s, mu, C_t, hit):
    """CT-GICP system over [xi_begin, xi_end] with cached correspondences.

    Per point: q = T(s) p, r = mu - q; the Jacobian wrt the interpolated
    pose's right perturbation is [R(s)[p]x | -R(s)], split (1 - s) / s
    across begin and end. Returns (H (12, 12), b (12,), err)."""
    R_s, t_s = _interp_poses(T_b, T_e, s)
    r = mu - _transform(R_s, t_s, pts)
    omega = inv_sym3x3(C_t + R_s @ covs @ R_s.transpose(1, 2))
    w = hit.to(pts.dtype)

    J_pose = torch.cat([R_s @ lie.skew(pts), -R_s], dim=-1)        # (C, 3, 6)
    Wr = (omega @ r[:, :, None])[:, :, 0] * w[:, None]
    WJ = (omega @ J_pose) * w[:, None, None]
    H_pp = J_pose.transpose(1, 2) @ WJ                              # (C, 6, 6)
    b_p = (J_pose.transpose(1, 2) @ Wr[:, :, None])[:, :, 0]        # (C, 6)

    wb, we = 1.0 - s, s
    H_be = torch.einsum("c,cij->ij", wb * we, H_pp)
    H = torch.cat([torch.cat([torch.einsum("c,cij->ij", wb * wb, H_pp), H_be], dim=1),
                   torch.cat([H_be, torch.einsum("c,cij->ij", we * we, H_pp)], dim=1)])
    b = torch.cat([wb @ b_p, we @ b_p])
    err = torch.sum(r * Wr)
    return H, b, err


def _prior_residual(xi, T, anchor):
    return lie.se3_log(lie.se3_inv(anchor) @ (T @ lie.se3_exp(xi)))


def _prior_blocks(Ts, anchors, weights):
    """6-dof priors r = log(anchor^-1 T) for a batch of poses: (H6 (B, 6,
    6), b6 (B, 6), err (B,)), each scaled by its weight."""
    J, r = batched_jacobian(_prior_residual, 6, Ts, anchors)
    w = weights[:, None]
    Jt = J.transpose(1, 2)
    return (w[:, :, None] * (Jt @ J), w * (Jt @ r[:, :, None])[:, :, 0],
            weights * torch.sum(r * r, dim=1))


def _pose_prior_12(T, anchor, weight, offset):
    """6-dof prior on one of the two poses: r = log(anchor^-1 T), placed at
    ``offset`` (0: begin, 6: end) of the 12-dof system."""
    w = torch.full((1,), float(weight), device=T.device)
    H6, b6, err = _prior_blocks(T[None], anchor[None], w)
    H = torch.zeros(12, 12, device=T.device)
    H[offset:offset + 6, offset:offset + 6] = H6[0]
    b = torch.zeros(12, device=T.device)
    b[offset:offset + 6] = b6[0]
    return H, b, err[0]


def _priors(T_b, T_e, T_prev_e, cv_target, weights):
    """Location consistency (T_b ~ the previous scan's end) on the begin
    block and constant velocity (T_e ~ T_b Exp(cv_target)) on the end block,
    in one batched Jacobian; ``weights`` (2,) are their scales."""
    H6, b6, err = _prior_blocks(
        torch.stack([T_b, T_e]), torch.stack([T_prev_e, T_b @ lie.se3_exp(cv_target)]),
        weights)
    z = torch.zeros(6, 6, device=T_b.device)
    H = torch.cat([torch.cat([H6[0], z], dim=1), torch.cat([z, H6[1]], dim=1)])
    return H, b6.reshape(12), err.sum()


def _model_lookup(model, model_kind: str, mask, max_dist: float, search=None):
    """World-frame query points (C, 3) -> (mu, C_t, hit) against the
    read-only model. ``search`` stands in for ``nn_search`` (the ivox
    model's), as a graph capture hands one in."""
    max_d2 = max_dist * max_dist
    if model_kind == "vgicp":
        tables = [(vm, vmx.lookup_table(vm)) for vm in model]

        def lookup(q):
            # Coarse to fine, so the finest level that hits wins.
            with profile_scope("ct/lookup"):
                C = q.shape[0]
                mu = torch.zeros(C, 3, device=q.device)
                C_t = torch.zeros(C, 3, 3, device=q.device)
                hit = torch.zeros(C, dtype=torch.bool, device=q.device)
                for vm, keys in reversed(tables):
                    vidx = vmx.lookup_keys(keys, vm.resolution, q)
                    h = vidx >= 0
                    safe = torch.clamp(vidx, min=0)
                    mu = torch.where(h[:, None], vm.mean[safe], mu)
                    C_t = torch.where(h[:, None, None], vm.cov[safe], C_t)
                    hit = hit | h
                d2 = torch.sum((mu - q) ** 2, dim=1)
                return mu, C_t, hit & mask & (d2 < max_d2)
        return lookup

    def lookup(q):
        with profile_scope("ct/lookup"):
            find = nn_search if search is None else search
            idx, d2 = find(q.contiguous(), mask, model.points, model.mask)
            idx = idx.to(torch.int64)
            hit = mask & (d2 < max_d2) & torch.isfinite(d2)
            return model.points[idx], model.covs[idx], hit
    return lookup


def _ct_scan_step(T_prev_e, twist_prev, step: int, model, pts, times, mask, neighbors,
                  dt, uniforms, max_dist: float, loc_weight: float, cv_weight: float,
                  damping: float, *, iters: int, bootstrap_frames: int,
                  update_budget: int, model_kind: str = "ivox",
                  rigid_refine: bool = True, anchor_begin: bool = False, graph=None):
    """One CT scan step. ``uniforms`` (C,) are the model update's random
    draws. Returns (T_b, T_e, twist, model', deskewed, covs, normals, errs).
    ``graph`` (a ``ct_graph.CTGraphRunner``) replays the step from a CUDA
    graph on the card; without it the step's ops are dispatched one by one."""
    args = (T_prev_e, twist_prev, step, model, pts, times, mask, neighbors, dt, uniforms,
            max_dist, loc_weight, cv_weight, damping)
    static = dict(iters=iters, bootstrap_frames=bootstrap_frames,
                  update_budget=update_budget, model_kind=model_kind,
                  rigid_refine=rigid_refine, anchor_begin=anchor_begin)
    if graph is not None:
        return graph(*args, **static)
    return _ct_ops(*args, **static)


def _ct_ops(T_prev_e, twist_prev, step: int, model, *args, **static):
    """``_ct_scan_step``'s ops, dispatched one by one: the solve, then the
    model update."""
    (T_b, T_e, twist, deskewed, covs, normals, errs, w_pts, keep,
     covs_w) = _ct_solve(T_prev_e, twist_prev, step, model, *args, **static)
    model = _ct_model_insert(model, static["model_kind"], w_pts, keep, covs_w, step)
    return T_b, T_e, twist, model, deskewed, covs, normals, errs


def _ct_solve(T_prev_e, twist_prev, step: int, model, pts, times, mask, neighbors,
              dt, uniforms, max_dist: float, loc_weight: float, cv_weight: float,
              damping: float, *, iters: int, bootstrap_frames: int,
              update_budget: int, model_kind: str, rigid_refine: bool,
              anchor_begin: bool, search=None):
    """The step up to the model update: (T_b, T_e, twist, deskewed, covs,
    normals, errs) and the update's inputs (world points, the points kept,
    world covariances). The host int ``step`` picks the two host branches
    (the first step's discard, the bootstrap's rate) and nothing else."""
    dev = pts.device
    # Normalized per-point time s in [0, 1].
    t_max = torch.max(torch.where(mask, times, 0.0))
    s = torch.clamp(times / torch.clamp(t_max, min=1e-6), 0.0, 1.0)

    covs, normals = cov_ops.estimate_covariances(pts, mask, neighbors, "plane")

    # Initial guess: damped twist extrapolation.
    cv_target = damping * twist_prev * dt
    T_b0 = T_prev_e
    T_e0 = T_b0 @ lie.se3_exp(cv_target)
    model_lookup = _model_lookup(model, model_kind, mask, max_dist, search)
    lam = torch.full((), 1e-6, device=dev)
    # Filled on the device: a tensor made from a Python list would be a
    # host-to-device copy that waits for the stream.
    weights = torch.cat([torch.full((1,), float(loc_weight), device=dev),
                         torch.full((1,), float(cv_weight), device=dev)])

    T_b, T_e = T_b0, T_e0
    errs = []
    for _ in range(max(1, iters // _INNER)):
        R_s, t_s = _interp_poses(T_b, T_e, s)
        mu, C_t, hit = model_lookup(_transform(R_s, t_s, pts))
        for _ in range(_INNER):
            H, b, err = _ct_linearize(T_b, T_e, pts, covs, s, mu, C_t, hit)
            Hp, bp, _ = _priors(T_b, T_e, T_prev_e, cv_target, weights)
            H, b = H + Hp, b + bp
            if anchor_begin:
                # Begin pinned at the previous end: solve the end block only.
                T_e = T_e @ lie.se3_exp(solver.solve_damped(H[6:, 6:], b[6:], lam))
            else:
                delta = solver.solve_damped(H, b, lam)
                T_b, T_e = T_b @ lie.se3_exp(delta[:6]), T_e @ lie.se3_exp(delta[6:])
        errs.append(err)
    errs = torch.stack(errs)

    # The first scan registers against an empty model, where only the tiny
    # location-consistency prior constrains the begin pose: discard that
    # solve (keeping the extrapolated end pose, so a replay deskews frame 0
    # with the converged twist).
    first = step == 0
    if first:
        T_b, T_e = T_b0, T_e0

    rel = lie.se3_inv(T_b) @ T_e
    R_s, t_s = _interp_poses(torch.eye(4, device=dev), rel, s)
    deskewed = _transform(R_s, t_s, pts)
    s0 = torch.zeros_like(s)

    if rigid_refine:
        # Two 6-dof rounds with fresh correspondences place the deskewed,
        # now rigid cloud (_ct_linearize with s = 0 is that system), then
        # the refined pose is accepted only if it fits the model better
        # without losing matches and stays within a tight trust region.
        def place(T):
            return deskewed @ T[:3, :3].T + T[:3, 3]

        T_b_joint = T_b
        T_r = T_b
        for _ in range(2):
            mu, C_t, hit = model_lookup(place(T_r))
            H, b, _ = _ct_linearize(T_r, T_r @ rel, deskewed, covs, s0, mu, C_t, hit)
            H6 = H[:6, :6]
            lam_r = 1e-3 * torch.trace(H6) / 6.0 + 1e-2
            T_r = T_r @ lie.se3_exp(solver.solve_damped(H6, b[:6], lam_r))

        def match_quality(T):
            mu, C_t, hit = model_lookup(place(T))
            _, _, err = _ct_linearize(T, T @ rel, deskewed, covs, s0, mu, C_t, hit)
            n = torch.sum(hit)
            return err / torch.clamp(n, min=1), n

        e_j, n_j = match_quality(T_b_joint)
        e_r, n_r = match_quality(T_r)
        d = lie.se3_log(lie.se3_inv(T_b_joint) @ T_r)
        ok = ((e_r < e_j) & (n_r >= 0.95 * n_j)
              & (torch.linalg.norm(d[:3]) < 0.01) & (torch.linalg.norm(d[3:]) < 0.03)
              & torch.all(torch.isfinite(d)))
        d = torch.where(torch.isfinite(d), d, 0.0)
        T_b = T_b_joint @ lie.se3_exp(torch.where(ok, d, torch.zeros_like(d)))
        T_e = T_b @ rel

    if first:
        twist_new = twist_prev
    else:
        twist_new = lie.se3_log(lie.se3_inv(T_b) @ T_e) / torch.clamp(dt, min=1e-4)

    # Model update in the world frame.
    R = T_b[:3, :3]
    w_pts = deskewed @ R.T + T_b[:3, 3]
    covs_w = R @ covs @ R.T
    C = w_pts.shape[0]
    rate = 1.0 if step < bootstrap_frames else update_budget / C
    keep = mask & (uniforms < rate)
    return T_b, T_e, twist_new, deskewed, covs, normals, errs, w_pts, keep, covs_w


def _ct_model_insert(model, model_kind: str, w_pts, keep, covs_w, step):
    """The model update of a step; ``step`` is its int or, for the ivox
    model, a 0-dim device tensor."""
    with profile_scope("ct/model_insert"):
        if model_kind == "vgicp":
            return tuple(vmx.voxelmap_insert(vm, w_pts, keep, covs_w, step) for vm in model)
        return vmx.pointmap_insert(model, w_pts, keep, covs_w, step)


class OdometryEstimationCT(OdometryEstimationBase):
    def __init__(self, params: Optional[OdometryEstimationCTParams] = None, device="cuda"):
        self.params = params or OdometryEstimationCTParams()
        self.device = torch.device(device)
        p = self.params
        self.model_kind = str(p.model_type).lower()
        if self.model_kind not in ("vgicp", "ivox"):
            raise ValueError(f"odometry_estimation_ct: unknown model_type {p.model_type!r}")
        self.model = self._empty_model()
        self.T_prev_end = torch.eye(4, device=self.device)
        self.twist = torch.zeros(6, device=self.device)
        self.frame_count = 0
        self.last_stamp: Optional[float] = None
        self.frames: List[EstimationFrame] = []
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(5)
        # _ct_scan_step, replayed from a CUDA graph on the card (ct_graph
        # imports this module).
        from glim_tpu_torch.odometry.ct_graph import CTGraphRunner
        self._graph = CTGraphRunner()
        # Bootstrap replay buffer: the first scans register against a model
        # seeded from insertions deskewed with an immature twist.
        self._boot: List[tuple] = []
        self._boot_done = p.bootstrap_frames < 2 or p.bootstrap_refine == "off"

    def _empty_model(self):
        p = self.params
        if self.model_kind == "vgicp":
            return tuple(vmx.empty_gaussian_voxelmap(
                max(p.model_capacity >> lvl, 8192),
                p.vgicp_resolution * (p.vgicp_scaling ** lvl), device=self.device)
                for lvl in range(max(p.vgicp_levels, 1)))
        return vmx.empty_point_voxelmap(p.model_capacity, p.ivox_min_points_dist,
                                        lru_horizon=p.ivox_lru_thresh, device=self.device)

    def requires_imu(self) -> bool:
        return False

    def _step(self, T_prev, twist, step, model, pts, times, mask, neighbors, dt, gen):
        p = self.params
        uniforms = torch.rand(pts.shape[0], generator=gen, device=self.device)
        with profile_scope("ct_scan_step"):
            return _ct_scan_step(
                T_prev, twist, step, model, pts, times, mask, neighbors, dt, uniforms,
                p.max_correspondence_distance, p.location_consistency_inf_scale,
                p.constant_velocity_inf_scale, p.extrapolation_damping,
                iters=p.lm_max_iterations, bootstrap_frames=p.bootstrap_frames,
                update_budget=p.update_budget, model_kind=self.model_kind,
                rigid_refine=bool(p.rigid_refine), anchor_begin=bool(p.anchor_begin),
                graph=self._graph)

    def insert_frame(self, frame: PreprocessedFrame,
                     marginalized: Optional[List[EstimationFrame]] = None
                     ) -> Optional[EstimationFrame]:
        CB.on_insert_frame(frame)
        p = self.params
        dt = 0.1 if self.last_stamp is None else max(frame.stamp - self.last_stamp, 1e-3)
        dt_d = torch.full((), dt, dtype=torch.float32, device=self.device)

        if not self._boot_done and self.frame_count < p.bootstrap_frames:
            self._boot.append((frame.device_points, frame.device_times,
                               frame.device_mask, frame.device_neighbors, dt_d))
        elif not self._boot_done:
            # The twist has converged: rebuild the model by replaying the
            # stored bootstrap scans with it.
            self._boot_done = True
            with profile_scope("ct/bootstrap_replay"):
                self._replay_bootstrap()

        (T_b, T_e, self.twist, self.model, deskewed, covs, normals, _) = self._step(
            self.T_prev_end, self.twist, self.frame_count, self.model,
            frame.device_points, frame.device_times, frame.device_mask,
            frame.device_neighbors, dt_d, self._gen)
        self.T_prev_end = T_e

        est = EstimationFrame(
            id=self.frame_count, stamp=frame.stamp, device_T_world_lidar=T_b,
            frame_id=FrameID.LIDAR,
            frame=PointBatch(points=deskewed, mask=frame.device_mask,
                             times=frame.device_times, covs=covs, normals=normals),
            raw_frame=frame)
        est.host_stamps = dict(frame.host_stamps, estimate=time.perf_counter())
        est.custom_data["T_world_lidar_end"] = T_e
        self.frames.append(est)
        self.frame_count += 1
        self.last_stamp = frame.stamp
        CB.on_new_frame(est)

        margs = []
        while self.frames and self.frames[0].stamp < frame.stamp - p.smoother_lag:
            margs.append(self.frames.pop(0))
        now = time.perf_counter()
        for m in margs:
            m.host_stamps["marginalized"] = now
        if margs:
            CB.on_marginalized_frames(margs)
            if marginalized is not None:
                marginalized.extend(margs)
        return est

    def _replay_bootstrap(self) -> None:
        """Re-run the stored bootstrap scans against a fresh model, seeded
        with the converged twist, and adopt the replayed state. The replayed
        begin / end poses and deskewed clouds are written back into the
        bootstrap frames still inside the smoother-lag window."""
        if len(self._boot) < 2:
            self._boot = []
            return
        model = self._empty_model()
        twist = self.twist.clone()
        T_prev = torch.eye(4, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(6)
        for k, (pts, times, mask, neighbors, dt) in enumerate(self._boot):
            (T_b, T_prev, twist, model, deskewed, covs, normals, _) = self._step(
                T_prev, twist, k, model, pts, times, mask, neighbors, dt, gen)
            if k < len(self.frames) and self.frames[k].id == k:
                est = self.frames[k]
                est.device_T_world_lidar = T_b
                # Drop the host mirrors and any state copy still in flight.
                est._T_world_lidar = None
                est._T_world_imu = None
                est._state_pending = None
                est.custom_data["T_world_lidar_end"] = T_prev
                est.frame = PointBatch(points=deskewed, mask=est.frame.mask,
                                       times=est.frame.times, covs=covs, normals=normals)
        self.model = model
        self.T_prev_end = T_prev
        self.twist = twist
        self._boot = []

    def get_remaining_frames(self) -> List[EstimationFrame]:
        now = time.perf_counter()
        for e in self.frames:
            e.host_stamps["marginalized"] = now
        out = self.frames
        self.frames = []
        return out


@register_module("odometry", "odometry_estimation_ct")
def create_odometry_estimation_ct_module(config=None, sensors_config=None, device="cuda"):
    """libodometry_estimation_ct.so."""
    params = (OdometryEstimationCTParams.from_config(config)
              if config is not None else OdometryEstimationCTParams())
    return OdometryEstimationCT(params, device=device)
