"""Frame-to-model LiDAR odometry, VGICP matching.

Twin of ``glim_tpu/odometry/odometry_estimation_cpu.py`` as the LiDAR-IMU
odometry's LOOSE initialisation runs it (``registration_type="VGICP"``,
``bootstrap_refine="replay"``): per-frame registration of the
twist-deskewed scan against a Gaussian voxel map, followed by a model update
with random sampling. The module's GICP mode and its use as a LiDAR-only
odometry (``enable_imu: false``) are not ported yet. Random draws come from
the module's own ``torch.Generator``.
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
from glim_tpu_torch.types import EstimationFrame, FrameID, PointBatch, PreprocessedFrame
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("odom")

_INNER = 2   # GN iterations per correspondence search


@dataclass
class OdometryEstimationCPUParams:
    max_iterations: int = 8
    smoother_lag: float = 5.0
    vgicp_resolution: float = 0.5
    voxel_capacity: int = 65536              # VGICP voxels
    enable_deskew: bool = True
    twist_smoothing: float = 0.25            # EMA gain on the twist estimate
    bootstrap_frames: int = 8                # full-density model updates early
    update_budget: int = 2048                # model-update points per scan


@dataclass
class OdomDeviceState:
    """Device-resident odometry state threaded through the step."""

    T: torch.Tensor        # (4, 4) T_world_lidar (scan-start frame)
    twist: torch.Tensor    # (6,) body twist per second [omega, v]
    step: int              # frame counter
    model: vmx.GaussianVoxelMap


def _orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Two Newton-Schulz polar iterations keep R in SO(3) despite f32 chains."""
    R = T[:3, :3]
    for _ in range(2):
        R = 1.5 * R - 0.5 * R @ (R.T @ R)
    return lie.make_se3(R, T[:3, 3])


def _scan_step(state: OdomDeviceState, pts, times, mask, neighbors, dt, gen,
               *, iters: int, ema: float, bootstrap_frames: int,
               update_budget: int, enable_deskew: bool):
    """One registration + model update (the JAX package's
    _vgicp_scan_step). Returns (state', (T, v_world, deskewed, covs,
    normals, errs))."""
    model = state.model
    eye4 = torch.eye(4, device=pts.device)

    def register(T, dsk, cv):
        errs = []
        lam = torch.full((), 1e-6, device=T.device)
        for _ in range(max(1, iters // _INNER)):
            mu, C_t, hit = gicp.vgicp_lookup(eye4, T, dsk, mask, model)
            for _ in range(_INNER):
                s = gicp.vgicp_linearize_cached(eye4, T, dsk, cv, mu, C_t, hit)
                T = T @ lie.se3_exp(solver.solve_damped(s.H_ss, s.b_s, lam))
            errs.append(s.error)
        return T, torch.stack(errs)

    twist = state.twist if enable_deskew else torch.zeros_like(state.twist)
    deskewed = deskew_ops.deskew_twist(pts, times, mask, twist)
    covs, normals = cov_ops.estimate_covariances(deskewed, mask, neighbors, "plane")
    T_pred = state.T @ lie.se3_exp(state.twist * dt)
    T_new, errs = register(T_pred, deskewed, covs)

    # Twist update with EMA smoothing.
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
    new_model = vmx.voxelmap_insert(model, w_pts, keep, covs_w, state.step)

    new_state = OdomDeviceState(T=T_new, twist=twist_n, step=state.step + 1,
                                model=new_model)
    v_world = T_new[:3, :3] @ twist_n[3:]
    return new_state, (T_new, v_world, deskewed, covs, normals, errs)


class OdometryEstimationCPU(OdometryEstimationBase):
    def __init__(self, params: Optional[OdometryEstimationCPUParams] = None,
                 device="cuda"):
        self.params = params or OdometryEstimationCPUParams()
        self.device = torch.device(device)
        p = self.params
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(1)
        self.state = OdomDeviceState(T=torch.eye(4, device=self.device),
                                     twist=torch.zeros(6, device=self.device),
                                     step=0, model=self._empty_model())
        self.frame_count = 0
        self.last_stamp: Optional[float] = None
        self.frames: List[EstimationFrame] = []
        # Bootstrap replay buffer (see insert_frame).
        self._boot: List[tuple] = []
        self._boot_done = p.bootstrap_frames < 2 or not p.enable_deskew

    def _empty_model(self):
        p = self.params
        return vmx.empty_gaussian_voxelmap(p.voxel_capacity, p.vgicp_resolution,
                                           device=self.device)

    def requires_imu(self) -> bool:
        return False

    def insert_imu(self, stamp, linear_acc, angular_vel) -> None:
        CB.on_insert_imu(stamp, linear_acc, angular_vel)

    def _step(self, state, pts, times, mask, neighbors, dt, gen):
        p = self.params
        return _scan_step(state, pts, times, mask, neighbors, dt, gen,
                          iters=p.max_iterations, ema=p.twist_smoothing,
                          bootstrap_frames=p.bootstrap_frames,
                          update_budget=p.update_budget,
                          enable_deskew=p.enable_deskew)

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
            # bootstrap scans, whose first insertions were deskewed with an
            # immature twist.
            self._boot_done = True
            replay = self._replay_bootstrap()
            if replay is not None:
                self.state = replay
        self.state, out = self._step(self.state, frame.device_points,
                                     frame.device_times, frame.device_mask,
                                     frame.device_neighbors, dt_d, self._gen)
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
        for (pts, times, mask, neighbors, dt) in self._boot:
            st, _ = self._step(st, pts, times, mask, neighbors, dt, gen)
        self._boot = []
        return st

    def get_remaining_frames(self) -> List[EstimationFrame]:
        out = self.frames
        self.frames = []
        return out

