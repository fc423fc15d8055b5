"""Frame-to-model LiDAR odometry (GICP / VGICP matching).

Twin of ``glim_tpu/odometry/odometry_estimation_cpu.py``: per-frame
registration of the twist-deskewed scan against an incremental model (an
iVox-style bounded point map in GICP mode, a Gaussian voxel map in VGICP
mode), followed by a model update with random sampling and an LRU horizon.
It is the LiDAR-only odometry (``enable_imu: false`` of
``config_odometry_cpu.json``, registered as ``odometry_estimation_lidar_only``)
and, in VGICP mode, the LiDAR-IMU odometry's LOOSE initialisation.

A step is one Python function over a device-resident state: deskew,
covariances, ``max_iterations`` Gauss-Newton iterations with the
correspondences re-searched every ``_INNER`` iterations (in GICP mode one
``nn_search`` call, the CUDA kernel on the card, per search), the EMA twist
update and the model insert. Random draws come from the module's own
``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks as CB
from glim_tpu_torch.odometry.estimation_base import OdometryEstimationBase
from glim_tpu_torch.ops import covariance as cov_ops
from glim_tpu_torch.ops import deskew as deskew_ops
from glim_tpu_torch.ops import gicp, lie, solver
from glim_tpu_torch.ops import voxelmap as vmx
from glim_tpu_torch.ops.nn_search import nn_search
from glim_tpu_torch.types import EstimationFrame, FrameID, PointBatch, PreprocessedFrame
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("odom")

_INNER = 2   # GN iterations per correspondence search


@dataclass
class OdometryEstimationCPUParams:
    registration_type: str = "GICP"          # GICP | VGICP
    max_iterations: int = 8
    smoother_lag: float = 5.0
    target_downsampling_rate: float = 0.1
    lru_thresh: int = 100
    ivox_resolution: float = 1.0
    ivox_min_dist: float = 0.1
    vgicp_resolution: float = 0.5
    vgicp_voxelmap_levels: int = 1
    max_correspondence_distance: float = 2.0
    model_capacity: int = 131072             # GICP model points
    voxel_capacity: int = 65536              # VGICP voxels
    enable_deskew: bool = True
    twist_smoothing: float = 0.25            # EMA gain on the twist estimate
    bootstrap_frames: int = 8                # full-density model updates early
    update_budget: int = 2048                # model-update points per scan
    # Startup refinement (see insert_frame): "replay" rebuilds the model from
    # the stored bootstrap scans once the twist converges; "two_pass"
    # additionally re-deskews and re-registers during bootstrap; "off"
    # disables both.
    bootstrap_refine: str = "replay"

    @staticmethod
    def from_config(config) -> "OdometryEstimationCPUParams":
        p = OdometryEstimationCPUParams()
        g = lambda k, d: config.param("odometry_estimation", k, d)
        p.registration_type = g("registration_type", "GICP")
        p.max_iterations = int(g("max_iterations", 8))
        p.smoother_lag = g("smoother_lag", 5.0)
        p.target_downsampling_rate = g("target_downsampling_rate", 0.1)
        p.lru_thresh = int(g("lru_thresh", 100))
        p.ivox_resolution = g("ivox_resolution", 1.0)
        p.ivox_min_dist = g("ivox_min_dist", 0.1)
        p.vgicp_resolution = g("vgicp_resolution", 0.5)
        p.vgicp_voxelmap_levels = int(g("vgicp_voxelmap_levels", 1))
        return p


@dataclass
class OdomDeviceState:
    """Device-resident odometry state threaded through the step."""

    T: torch.Tensor        # (4, 4) T_world_lidar (scan-start frame)
    twist: torch.Tensor    # (6,) body twist per second [omega, v]
    step: int              # frame counter
    model: object          # GaussianVoxelMap (VGICP) or PointVoxelMap (GICP)


def _orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Two Newton-Schulz polar iterations keep R in SO(3) despite f32 chains."""
    R = T[:3, :3]
    for _ in range(2):
        R = 1.5 * R - 0.5 * R @ (R.T @ R)
    return lie.make_se3(R, T[:3, 3])


def _register(T, dsk, cv, lookup, iters: int):
    """Correspondence-cached GN: ``lookup(T, dsk)`` -> (mu, C_t, hit) every
    ``_INNER`` iterations. Returns (T, the last error of each search)."""
    eye4 = torch.eye(4, device=T.device)
    lam = torch.full((), 1e-6, device=T.device)
    errs = []
    for _ in range(max(1, iters // _INNER)):
        mu, C_t, hit = lookup(T, dsk)
        for _ in range(_INNER):
            s = gicp.vgicp_linearize_cached(eye4, T, dsk, cv, mu, C_t, hit)
            T = T @ lie.se3_exp(solver.solve_damped(s.H_ss, s.b_s, lam))
        errs.append(s.error)
    return T, torch.stack(errs)


def _scan_step(state: OdomDeviceState, pts, times, mask, neighbors, dt, gen,
               lookup, insert_fn, *, iters: int, ema: float, bootstrap_frames: int,
               update_budget: int, enable_deskew: bool, two_pass: bool = False):
    """One registration + model update. ``lookup(model, mask)`` gives the
    correspondence search against the (read-only) model. Returns
    (state', (T, v_world, deskewed, covs, normals, errs))."""
    search = lookup(state.model, mask)
    twist = state.twist if enable_deskew else torch.zeros_like(state.twist)
    deskewed = deskew_ops.deskew_twist(pts, times, mask, twist)
    covs, normals = cov_ops.estimate_covariances(deskewed, mask, neighbors, "plane")
    T_pred = state.T @ lie.se3_exp(state.twist * dt)
    T_new, errs = _register(T_pred, deskewed, covs, search, iters)
    if two_pass and enable_deskew:
        # Bootstrap refinement: the twist used for deskewing came from the
        # previous step (zero at startup), so early scans register smeared.
        # Re-deskew with the twist implied by this registration and
        # register again.
        twist2 = lie.se3_log(lie.se3_inv(state.T) @ T_new) / torch.clamp(dt, min=1e-4)
        deskewed = deskew_ops.deskew_twist(pts, times, mask, twist2)
        covs, normals = cov_ops.estimate_covariances(deskewed, mask, neighbors, "plane")
        T_new, errs = _register(T_new, deskewed, covs, search, iters)

    # Twist update with EMA smoothing (unfiltered twists close a positive
    # feedback loop through deskewing).
    twist_raw = lie.se3_log(lie.se3_inv(state.T) @ T_new) / torch.clamp(dt, min=1e-4)
    twist_n = state.twist if state.step == 0 else ema * twist_raw + (1.0 - ema) * state.twist
    T_new = _orthonormalize(T_new)

    # Model update: early frames at full density, later a random subset.
    R = T_new[:3, :3]
    w_pts = deskewed @ R.T + T_new[:3, 3]
    covs_w = R @ covs @ R.T
    C = w_pts.shape[0]
    rate = 1.0 if state.step < bootstrap_frames else update_budget / C
    keep = mask & (torch.rand(C, generator=gen, device=pts.device) < rate)
    new_model = insert_fn(state.model, w_pts, keep, covs_w, state.step)

    new_state = OdomDeviceState(T=T_new, twist=twist_n, step=state.step + 1,
                                model=new_model)
    v_world = T_new[:3, :3] @ twist_n[3:]
    return new_state, (T_new, v_world, deskewed, covs, normals, errs)


def _vgicp_lookup(model: vmx.GaussianVoxelMap, mask):
    """Voxel lookup + stats gather against the Gaussian voxel map."""
    keys = vmx.lookup_table(model)
    eye4 = torch.eye(4, device=mask.device)
    return lambda T, dsk: gicp.vgicp_lookup(eye4, T, dsk, mask, model, keys)


def _vgicp_scan_step(state, pts, times, mask, neighbors, dt, gen, **kw):
    """The JAX package's ``_vgicp_scan_step``."""
    return _scan_step(state, pts, times, mask, neighbors, dt, gen, _vgicp_lookup,
                      vmx.voxelmap_insert, **kw)


def _gicp_scan_step(state, pts, times, mask, neighbors, dt, max_dist: float, gen, **kw):
    """The JAX package's ``_gicp_scan_step``: nearest model point per scan
    point through ``nn_search``, capped at ``max_dist``."""
    max_d2 = max_dist * max_dist

    def lookup(model: vmx.PointVoxelMap, mask):
        def search(T, dsk):
            q = dsk @ T[:3, :3].T + T[:3, 3]
            idx, d2 = nn_search(q, mask, model.points, model.mask)
            idx = idx.to(torch.int64)
            hit = mask & (d2 < max_d2) & torch.isfinite(d2)
            return model.points[idx], model.covs[idx], hit
        return search

    return _scan_step(state, pts, times, mask, neighbors, dt, gen, lookup,
                      vmx.pointmap_insert, **kw)


class OdometryEstimationCPU(OdometryEstimationBase):
    def __init__(self, params: Optional[OdometryEstimationCPUParams] = None,
                 device="cuda"):
        self.params = params or OdometryEstimationCPUParams()
        self.device = torch.device(device)
        p = self.params
        self.use_vgicp = p.registration_type.upper().startswith("VGICP")
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(1)
        self.state = OdomDeviceState(T=torch.eye(4, device=self.device),
                                     twist=torch.zeros(6, device=self.device),
                                     step=0, model=self._empty_model())
        self.frame_count = 0
        self.last_stamp: Optional[float] = None
        self.frames: List[EstimationFrame] = []
        # Bootstrap replay buffer: the first scans register against a model
        # built from undeskewed data (the twist estimate starts at zero);
        # once the twist has converged the model is rebuilt by replaying
        # these scans (see insert_frame).
        self._boot: List[tuple] = []
        self._boot_done = (p.bootstrap_frames < 2 or not p.enable_deskew
                           or p.bootstrap_refine == "off")

    def _empty_model(self):
        p = self.params
        if self.use_vgicp:
            return vmx.empty_gaussian_voxelmap(p.voxel_capacity, p.vgicp_resolution,
                                               device=self.device)
        return vmx.empty_point_voxelmap(p.model_capacity, p.ivox_min_dist,
                                        lru_horizon=p.lru_thresh, device=self.device)

    def requires_imu(self) -> bool:
        return False

    def insert_imu(self, stamp, linear_acc, angular_vel) -> None:
        CB.on_insert_imu(stamp, linear_acc, angular_vel)

    def _step(self, state, pts, times, mask, neighbors, dt, gen, two_pass=False):
        p = self.params
        kw = dict(iters=p.max_iterations, ema=p.twist_smoothing,
                  bootstrap_frames=p.bootstrap_frames, update_budget=p.update_budget,
                  enable_deskew=p.enable_deskew, two_pass=two_pass)
        if self.use_vgicp:
            return _vgicp_scan_step(state, pts, times, mask, neighbors, dt, gen, **kw)
        return _gicp_scan_step(state, pts, times, mask, neighbors, dt,
                               p.max_correspondence_distance, gen, **kw)

    def insert_frame(self, frame: PreprocessedFrame,
                     marginalized: Optional[List[EstimationFrame]] = None
                     ) -> Optional[EstimationFrame]:
        CB.on_insert_frame(frame)
        p = self.params
        dt = 0.1 if self.last_stamp is None else max(frame.stamp - self.last_stamp, 1e-3)
        dt_d = torch.full((), dt, dtype=torch.float32, device=self.device)

        two_pass = False
        if not self._boot_done and self.frame_count < p.bootstrap_frames:
            # Two-pass registration while the twist estimate converges.
            two_pass = p.bootstrap_refine == "two_pass"
            self._boot.append((frame.device_points, frame.device_times,
                               frame.device_mask, frame.device_neighbors, dt_d))
        elif not self._boot_done:
            # The twist has converged: rebuild the model by replaying the
            # bootstrap scans, whose first insertions were deskewed with an
            # immature twist.
            self._boot_done = True
            replay = self._replay_bootstrap()
            if replay is not None:
                self.state = replay
        self.state, out = self._step(self.state, frame.device_points,
                                     frame.device_times, frame.device_mask,
                                     frame.device_neighbors, dt_d, self._gen, two_pass)
        T_dev, v_dev, deskewed, covs, normals, _ = out

        est = EstimationFrame(
            id=self.frame_count, stamp=frame.stamp,
            device_T_world_lidar=T_dev, device_v_world_imu=v_dev,
            frame_id=FrameID.LIDAR,
            frame=PointBatch(points=deskewed, mask=frame.device_mask,
                             times=frame.device_times, covs=covs, normals=normals),
            raw_frame=frame)
        self.frames.append(est)
        self.frame_count += 1
        self.last_stamp = frame.stamp
        CB.on_new_frame(est)
        CB.on_update_frames(self.frames)

        # Time-based marginalization (the fixed-lag window boundary).
        margs = []
        while self.frames and self.frames[0].stamp < frame.stamp - p.smoother_lag:
            margs.append(self.frames.pop(0))
        if margs:
            CB.on_marginalized_frames(margs)
            if marginalized is not None:
                marginalized.extend(margs)
        return est

    def _replay_bootstrap(self) -> Optional[OdomDeviceState]:
        """Re-run the stored bootstrap scans against a fresh model, seeded
        with the converged twist."""
        if len(self._boot) < 2:
            self._boot = []
            return None
        twist = self.state.twist.clone()
        dt0 = self._boot[0][4]
        # T starts at exp(-twist*dt0): the step's constant-velocity predictor
        # advances by exp(twist*dt) before registering against the still
        # empty model, so replayed frame 0 lands on the identity anchor.
        st = OdomDeviceState(T=lie.se3_exp(-twist * dt0), twist=twist, step=0,
                             model=self._empty_model())
        gen = torch.Generator(device=self.device)
        gen.manual_seed(2)
        two_pass = self.params.bootstrap_refine == "two_pass"
        for (pts, times, mask, neighbors, dt) in self._boot:
            st, _ = self._step(st, pts, times, mask, neighbors, dt, gen, two_pass)
        self._boot = []
        return st

    def get_remaining_frames(self) -> List[EstimationFrame]:
        out = self.frames
        self.frames = []
        return out


# The "odometry_estimation_cpu" registry name is the IMU-coupled module
# (odometry_estimation_cpu_imu.py), whose enable_imu=false branch returns
# this one; it is also registered under a name of its own.
@register_module("odometry", "odometry_estimation_lidar_only")
def create_odometry_estimation_module(config=None, sensors_config=None, device="cuda"):
    params = (OdometryEstimationCPUParams.from_config(config)
              if config is not None else OdometryEstimationCPUParams())
    return OdometryEstimationCPU(params, device=device)
