"""Tightly-coupled LiDAR-IMU odometry: the shared estimator machinery.

Twin of ``glim_tpu/odometry/odometry_estimation_imu.py``: per-scan IMU
preintegration and prediction, IMU-rate deskewing, matching against a map
model, and joint optimisation of pose/velocity/bias over a
``smoother_lag``-sized window with marginalisation priors — all in one
``window_scan_step`` call per scan. The host packs the IMU window, calls the
step, and decodes the small status vector ``_status_lag`` scans late.

The map model is a set of hooks. Here they are the flagship's: multi-
resolution Gaussian voxel maps matched by VGICP, whose contents the
``KeyframeManager`` decides (registered as ``odometry_estimation_gpu``, the
default configuration). The GICP subclass in ``odometry_estimation_cpu_imu.py``
overrides them with its point map.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks as CB
from glim_tpu_torch.odometry.estimation_base import OdometryEstimationBase
from glim_tpu_torch.odometry.keyframe_manager import KeyframeManager
from glim_tpu_torch.odometry.window_estimator import (
    OLD_SUBSAMPLE, STATUS_DROT, STATUS_DTRANS, STATUS_FINITE, STATUS_LOGDET,
    STATUS_OVERLAP, STATUS_POSES, WindowState, _set_last, empty_window,
    window_scan_step)
from glim_tpu_torch.ops import covariance as cov_ops
from glim_tpu_torch.ops import voxelmap as vmx
from glim_tpu_torch.ops.pointops import median_distance
from glim_tpu_torch.types import (EstimationFrame, FrameID, HostCopy, PointBatch,
                                  PreprocessedFrame, to_numpy, upload)
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.profiling import profile_scope
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("odom")

GRAVITY = np.array([0.0, 0.0, -9.80665])


def _adaptive_base_resolution(points, mask, res_min: float, res_max: float,
                              dmin: float, dmax: float) -> torch.Tensor:
    """Adaptive base resolution from a frame's median point distance: a
    linear ramp res_min -> res_max over median distance dmin -> dmax. A 0-dim
    device tensor, computed per keyframe insert and never read on the host."""
    med = median_distance(points, mask)
    t = torch.clamp((med - dmin) / max(dmax - dmin, 1e-6), 0.0, 1.0)
    return res_min + t * (res_max - res_min)


# Window capacity buckets: smoother_lag at the nominal 10 Hz scan rate picks
# the smallest bucket >= lag * 10 (the default 5 s lag runs a 48-state
# window); eviction inside the bucket is time-based.
WINDOW_BUCKETS = (8, 12, 16, 24, 32, 48)
NOMINAL_SCAN_HZ = 10.0


def _window_bucket(smoother_lag: float) -> int:
    want = int(np.ceil(smoother_lag * NOMINAL_SCAN_HZ))
    for b in WINDOW_BUCKETS:
        if b >= want:
            return b
    return WINDOW_BUCKETS[-1]


@dataclass
class OdometryEstimationIMUParams:
    # Initialization (reference config_odometry_gpu.json keys)
    initialization_mode: str = "LOOSE"      # LOOSE | NAIVE
    initialization_window_size: float = 1.0
    init_pose_damping_scale: float = 1e10
    # Optimization
    smoother_lag: float = 5.0
    fix_imu_bias: bool = False
    compute_covs: bool = False
    window_size: Optional[int] = None       # None -> bucket from smoother_lag
    outer_iterations: int = 2
    inner_iterations: int = 2
    # Voxel params
    voxel_resolution: float = 0.25
    voxel_resolution_max: float = 0.5
    voxel_resolution_dmin: float = 5.0
    voxel_resolution_dmax: float = 20.0
    voxelmap_levels: int = 2
    voxelmap_scaling_factor: float = 2.0
    full_connection_window_size: int = 2
    voxel_capacity: int = 131072
    # Keyframes
    keyframe_update_strategy: str = "OVERLAP"
    max_num_keyframes: int = 15
    keyframe_min_overlap: float = 0.01
    keyframe_max_overlap: float = 0.7
    keyframe_delta_trans: float = 2.0
    keyframe_delta_rot: float = 0.5
    keyframe_entropy_thresh: float = 0.99
    # Sensors
    imu_acc_noise: float = 0.05
    imu_gyro_noise: float = 0.02
    imu_int_noise: float = 0.001
    imu_bias_noise: float = 1e-5
    T_lidar_imu: np.ndarray = None
    # Misc
    validate_imu: bool = True
    save_imu_rate_trajectory: bool = False
    imu_window_capacity: int = 256
    matching_weight: float = 1.0
    bootstrap_frames: int = 5

    @staticmethod
    def from_config(config, sensors_config=None) -> "OdometryEstimationIMUParams":
        p = OdometryEstimationIMUParams()
        g = lambda k, d: config.param("odometry_estimation", k, d)
        p.initialization_mode = g("initialization_mode", "LOOSE")
        p.initialization_window_size = g("initialization_window_size", 1.0)
        p.init_pose_damping_scale = g("init_pose_damping_scale", 1e10)
        p.smoother_lag = g("smoother_lag", 5.0)
        p.fix_imu_bias = g("fix_imu_bias", False)
        p.compute_covs = g("compute_covs", False)
        ws = g("window_size", 0)
        p.window_size = int(ws) if ws else None
        p.outer_iterations = int(g("outer_iterations", 2))
        p.inner_iterations = int(g("inner_iterations", 2))
        p.voxel_resolution = g("voxel_resolution", 0.25)
        p.voxel_resolution_max = g("voxel_resolution_max", p.voxel_resolution)
        p.voxel_resolution_dmin = g("voxel_resolution_dmin", 5.0)
        p.voxel_resolution_dmax = g("voxel_resolution_dmax", 20.0)
        p.voxelmap_levels = int(g("voxelmap_levels", 2))
        p.voxelmap_scaling_factor = g("voxelmap_scaling_factor", 2.0)
        p.full_connection_window_size = int(g("full_connection_window_size", 2))
        p.keyframe_update_strategy = g("keyframe_update_strategy", "OVERLAP")
        p.max_num_keyframes = int(g("max_num_keyframes", 15))
        p.keyframe_min_overlap = g("keyframe_min_overlap", 0.01)
        p.keyframe_max_overlap = g("keyframe_max_overlap", 0.7)
        p.keyframe_delta_trans = g("keyframe_delta_trans", 2.0)
        p.keyframe_delta_rot = g("keyframe_delta_rot", 0.5)
        p.keyframe_entropy_thresh = g("keyframe_entropy_thresh", 0.99)
        p.validate_imu = g("validate_imu", True)
        p.save_imu_rate_trajectory = g("save_imu_rate_trajectory", False)
        p.imu_window_capacity = int(g("imu_window_capacity", 256))
        p.matching_weight = g("matching_weight", 1.0)
        p.bootstrap_frames = int(g("bootstrap_frames", 5))
        if sensors_config is not None:
            s = lambda k, d: sensors_config.param("sensors", k, d)
            p.imu_acc_noise = s("imu_acc_noise", 0.05)
            p.imu_gyro_noise = s("imu_gyro_noise", 0.02)
            p.imu_int_noise = s("imu_int_noise", 0.001)
            p.imu_bias_noise = s("imu_bias_noise", 1e-5)
            p.T_lidar_imu = sensors_config.param_se3("sensors", "T_lidar_imu")
        return p


class OdometryEstimationIMU(OdometryEstimationBase):
    """The LiDAR-IMU window odometry on ``device`` with the VGICP keyframe
    maps; subclasses may replace the map model through ``_make_model``,
    ``_init_model``, ``_maybe_update_model`` and ``_last_kf_pose_dev``."""

    def __init__(self, params: Optional[OdometryEstimationIMUParams] = None,
                 device="cuda"):
        self.params = params or OdometryEstimationIMUParams()
        self.device = torch.device(device)
        p = self.params
        self.T_lidar_imu = np.eye(4) if p.T_lidar_imu is None else np.asarray(p.T_lidar_imu)
        self.W = p.window_size or _window_bucket(p.smoother_lag)
        # Multi-resolution keyframe maps: level l has half the capacity (at
        # least 8192) and scaling_factor^l the resolution of level 0.
        self._model_caps = [max(p.voxel_capacity >> lvl, 8192)
                            for lvl in range(max(p.voxelmap_levels, 1))]
        self._model_res = self._level_resolutions(p.voxel_resolution)
        self.model = self._make_model()
        self._matching = "vgicp"
        self._max_corr_dist = 2.0           # used by the "gicp" mode only
        self.keyframes: Optional[KeyframeManager] = None   # lazy (needs C)
        self.window: Optional[WindowState] = None          # lazy (needs C)
        self._est_frames: List[EstimationFrame] = []

        # Constant step arguments, uploaded once as f32 (a float64 numpy
        # constant would otherwise stay float64 in torch).
        self._d_T_lidar_imu = self._f32(self.T_lidar_imu)
        self._d_gravity = self._f32(GRAVITY)
        self._d_acc_noise = self._f32(p.imu_acc_noise)
        self._d_gyro_noise = self._f32(p.imu_gyro_noise)
        self._d_int_noise = self._f32(p.imu_int_noise)
        # Bias random-walk stiffness: 1/sqrt(sigma), as in the JAX package.
        self._d_bias_rw_info = self._f32(
            np.full(6, 1.0 / max(np.sqrt(p.imu_bias_noise), 1e-6)))
        self._d_matching_weight = self._f32(p.matching_weight)
        self._d_max_corr_dist = self._f32(self._max_corr_dist)
        self._d_vel_reg = None

        self.imu_buffer: List[np.ndarray] = []   # rows [t, ax..az, wx..wz]
        self._init_odom = None
        self._init_poses: List = []
        # Status entries (status, stamp, dt, frame) decoded `_status_lag`
        # scans late, when the device has long finished them.
        self._pending: List[tuple] = []
        self._status_lag = 2
        self._last_state_covs = None
        self._covs_requested = bool(p.compute_covs)
        self.initialized = False
        self.frame_count = 0
        self.last_frame_stamp: Optional[float] = None
        if p.validate_imu:
            from glim_tpu_torch.common.imu_validation import IMUValidation
            self.imu_validation = IMUValidation()
        else:
            self.imu_validation = None
        CB.request_to_compute_covariances.add(self._on_request_covs)

    def _f32(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

    # -- model hooks (overridden by the GICP frame-to-model subclass) --

    def _make_model(self):
        return tuple(vmx.empty_gaussian_voxelmap(c, r, device=self.device)
                     for c, r in zip(self._model_caps, self._model_res))

    def _last_kf_pose_dev(self):
        return self.keyframes.last_kf_T_wi

    def _level_resolutions(self, base):
        p = self.params
        return [base * (p.voxelmap_scaling_factor ** lvl)
                for lvl in range(max(p.voxelmap_levels, 1))]

    def _init_model(self, frame, covs, T_wl_dev, T_wi_dev, T0_host) -> None:
        """First-frame model seeding: the first keyframe is the first frame.
        The initial adaptive resolution comes from the first frame's median
        distance, read once on the host before the per-scan loop."""
        p = self.params
        if p.voxel_resolution_max > p.voxel_resolution:
            med = float(median_distance(frame.device_points, frame.device_mask))
            t = float(np.clip((med - p.voxel_resolution_dmin)
                              / max(p.voxel_resolution_dmax - p.voxel_resolution_dmin, 1e-6),
                              0.0, 1.0))
            base = p.voxel_resolution + t * (p.voxel_resolution_max - p.voxel_resolution)
            if abs(base - self._model_res[0]) > 1e-6:
                self._model_res = self._level_resolutions(base)
                self.model = self._make_model()
                logger.info("adaptive voxel resolution: median dist %.2f m "
                            "-> base resolution %.3f m", med, base)
        self.keyframes = KeyframeManager(
            strategy=p.keyframe_update_strategy,
            max_num_keyframes=p.max_num_keyframes,
            min_overlap=p.keyframe_min_overlap,
            max_overlap=p.keyframe_max_overlap,
            delta_trans=p.keyframe_delta_trans,
            delta_rot=p.keyframe_delta_rot,
            entropy_thresh=p.keyframe_entropy_thresh,
            C=int(frame.device_points.shape[0]),
            model_capacities=self._model_caps,
            model_resolutions=self._model_res, device=self.device)
        self.keyframes.marginalized_callback = CB.on_marginalized_keyframes
        self.model = self.keyframes.insert(
            frame.device_points, covs, frame.device_mask, T_wl_dev, T_wi_dev,
            T0_host, self.model, 0)

    def _maybe_update_model(self, prev: EstimationFrame, s: np.ndarray) -> None:
        """Keyframe decision for the previous frame (its status has landed),
        then the map insert/evict through the manager. A new keyframe also
        re-derives the rebuild resolutions from its own median distance, as
        device scalars (no host read)."""
        kfm = self.keyframes
        p = self.params
        force = prev.id < p.bootstrap_frames
        if force or kfm.should_insert(float(s[STATUS_OVERLAP]), float(s[STATUS_DTRANS]),
                                      float(s[STATUS_DROT]), float(s[STATUS_LOGDET])):
            if p.voxel_resolution_max > p.voxel_resolution:
                base = _adaptive_base_resolution(
                    prev.frame.points, prev.frame.mask, p.voxel_resolution,
                    p.voxel_resolution_max, p.voxel_resolution_dmin,
                    p.voxel_resolution_dmax)
                kfm.set_model_resolutions(self._level_resolutions(base))
            T_opt = s[STATUS_POSES + 19:STATUS_POSES + 35].reshape(4, 4)
            with record_function("odom/kf_insert"):
                self.model = kfm.insert(
                    prev.frame.points, prev.frame.covs, prev.frame.mask,
                    prev.device_T_world_lidar, prev.custom_data["device_T_world_imu"],
                    T_opt, self.model, prev.id)
            CB.on_update_keyframes(list(np.where(kfm.h_order >= 0)[0]))

    def _on_request_covs(self, *args) -> None:
        self._covs_requested = True

    def requires_imu(self) -> bool:
        return True

    def insert_imu(self, stamp, linear_acc, angular_vel) -> None:
        CB.on_insert_imu(stamp, linear_acc, angular_vel)
        self.imu_buffer.append(np.concatenate([[stamp], linear_acc, angular_vel]))

    def set_velocity_regulation(self, weight: float, max_velocity: float) -> None:
        """Enable (weight > 0) or disable the velocity-regulation term."""
        self._d_vel_reg = None if weight <= 0 else self._f32([weight, max_velocity])

    # -- main entry --

    def insert_frame(self, frame: PreprocessedFrame,
                     marginalized: Optional[List[EstimationFrame]] = None
                     ) -> Optional[EstimationFrame]:
        CB.on_insert_frame(frame)
        p = self.params

        if not self.initialized:
            if not self._try_initialize(frame):
                return None
            self.last_frame_stamp = frame.stamp
            return self._est_frames[-1]

        # Model updates for frames whose status has landed (lag scans back)
        # run before this scan's step so the map includes them.
        self._process_status()

        # Host-side eviction decision (mirrors the device ring exactly).
        evict = len(self._est_frames) >= 2 and (
            len(self._est_frames) == self.W
            or self._est_frames[0].stamp < frame.stamp - p.smoother_lag)

        imu_packed = self._imu_packed(self.last_frame_stamp, frame.stamp,
                                      frame.scan_end_time,
                                      frame.stamp - self._t0, evict)

        with profile_scope("window_scan_step"):
            self.window, out = window_scan_step(
                self.window, self.model,
                frame.device_points, frame.device_times, frame.device_mask,
                frame.device_neighbors, imu_packed,
                self._d_T_lidar_imu, self._d_gravity,
                self._d_acc_noise, self._d_gyro_noise, self._d_int_noise,
                self._d_bias_rw_info, self._d_matching_weight,
                self._last_kf_pose_dev(), self._d_max_corr_dist,
                vel_reg=self._d_vel_reg,
                W=self.W, outer_iters=p.outer_iterations,
                inner_iters=p.inner_iterations,
                compute_covs=self._covs_requested, matching=self._matching,
                full_connection=p.full_connection_window_size)
        CB.on_smoother_update(self)

        # Marginalization bookkeeping: mirrors the device-side eviction.
        if evict:
            marg_est = self._est_frames.pop(0)
            marg_est.device_T_world_lidar = out["marg"]["T_wl"]
            marg_est._T_world_lidar = None
            marg_est._T_world_imu = None
            marg_est.device_v_world_imu = out["marg"]["v"]
            marg_est._v_world_imu = None
            marg_est.device_imu_bias = out["marg"]["b"]
            marg_est._imu_bias = None
            if self._last_state_covs is not None:
                # The evicted frame sat at slot W - n_prev (pre-roll).
                slot = self.W - (len(self._est_frames) + 1)
                self._attach_covs(marg_est, self._last_state_covs[slot])
            marg_est.host_stamps["marginalized"] = time.perf_counter()
            CB.on_marginalized_frames([marg_est])
            if marginalized is not None:
                marginalized.append(marg_est)

        est = EstimationFrame(
            id=self.frame_count, stamp=frame.stamp,
            T_lidar_imu=self.T_lidar_imu.copy(),
            device_T_world_lidar=out["T_wl"],
            device_v_world_imu=out["v"],
            device_imu_bias=out["b"],
            frame_id=FrameID.LIDAR,
            frame=PointBatch(points=out["deskewed"], mask=frame.device_mask,
                             times=frame.device_times, covs=out["covs"],
                             normals=out["normals"]),
            raw_frame=frame)
        est.host_stamps = dict(frame.host_stamps, estimate=time.perf_counter())
        est.custom_data["device_T_world_imu"] = out["T_wi"]
        if "state_covs" in out:
            self._last_state_covs = out["state_covs"]
            self._attach_covs(est, out["state_covs"][self.W - 1])
        if p.save_imu_rate_trajectory:
            stamps_t, quats_t, trans_t = out["pose_table"]
            packed = torch.cat([stamps_t[None, :], trans_t.T, quats_t.T], dim=0)
            est.device_imu_rate_trajectory = (packed, int(stamps_t.shape[0]), frame.stamp)
        self._est_frames.append(est)
        CB.on_new_frame(est)
        CB.on_update_frames(self._est_frames)
        CB.on_smoother_update_finish(self)

        # The status copy starts now and is read `_status_lag` scans later,
        # when it has long landed.
        self._pending.append((HostCopy(out["status"]), frame.stamp,
                              frame.stamp - self.last_frame_stamp, est))
        self.frame_count += 1
        self.last_frame_stamp = frame.stamp
        return est

    def get_remaining_frames(self) -> List[EstimationFrame]:
        self._process_status(drain=True)
        if self.window is not None and self._est_frames:
            # Final pose refresh from the optimized window.
            n = len(self._est_frames)
            T_wl_all = to_numpy(self.window.T, np.float64) @ np.linalg.inv(self.T_lidar_imu)
            v_all = to_numpy(self.window.v, np.float64)
            b_all = to_numpy(self.window.b, np.float64)
            for i, e in enumerate(self._est_frames):
                k = self.W - n + i
                e.T_world_lidar = T_wl_all[k]
                e.v_world_imu = v_all[k]
                e.imu_bias = b_all[k]
        now = time.perf_counter()
        for e in self._est_frames:
            e.host_stamps["marginalized"] = now
        out = self._est_frames
        self._est_frames = []
        return out

    # -- internals --

    @staticmethod
    def _attach_covs(est: EstimationFrame, cov15) -> None:
        est.cov_pose = cov15[:6, :6]        # device-backed
        est.cov_velocity = cov15[6:9, 6:9]
        est.cov_bias = cov15[9:15, 9:15]

    def _process_status(self, drain: bool = False) -> None:
        """Decode landed statuses (``_status_lag`` scans back)."""
        while self._pending and (drain or len(self._pending) >= self._status_lag):
            self._decode_status(*self._pending.pop(0))

    def _decode_status(self, status, stamp, dt,
                       prev: Optional[EstimationFrame]) -> None:
        s = to_numpy(status)
        finite = s[STATUS_FINITE] > 0.5
        if not finite:
            logger.error("window optimization corrupted at %.3f; IMU-prediction "
                         "fallback engaged", stamp)
            CB.on_smoother_corruption(stamp)
        if finite and prev is not None:
            # The optimized pose/velocity ride along in the status vector.
            T_opt = np.asarray(s[STATUS_POSES + 19:STATUS_POSES + 35], np.float64).reshape(4, 4)
            v_opt = np.asarray(s[STATUS_POSES + 35:STATUS_POSES + 38], np.float64)
            if prev._T_world_imu is None:
                prev._T_world_imu = T_opt
            if prev._T_world_lidar is None:
                prev._T_world_lidar = T_opt @ np.linalg.inv(prev.T_lidar_imu)
            if prev._v_world_imu is None:
                prev._v_world_imu = v_opt
        if self.imu_validation is not None and finite:
            self.imu_validation.validate(
                s[STATUS_POSES:STATUS_POSES + 16].reshape(4, 4),
                s[STATUS_POSES + 16:STATUS_POSES + 19],
                s[STATUS_POSES + 19:STATUS_POSES + 35].reshape(4, 4),
                s[STATUS_POSES + 35:STATUS_POSES + 38], dt)
        if prev is None or not finite:
            return
        self._maybe_update_model(prev, s)

    def _imu_packed(self, t_prev: float, t_scan: float, t_end: float,
                    scan_stamp_rel: float, evict: bool) -> torch.Tensor:
        """ONE packed per-scan upload (cap+1, 8): IMU rows [acc, gyro,
        stamp_rel, dt] covering (t_prev, t_end] relative to t_scan, plus a
        metadata row [n, scan_stamp, evict, 0...]."""
        cap = self.params.imu_window_capacity
        rows = [r for r in self.imu_buffer if t_prev < r[0] <= t_end + 0.02]
        self.imu_buffer = [r for r in self.imu_buffer if r[0] > t_prev - 0.2]
        if len(rows) > cap and not getattr(self, "_warned_imu_trunc", False):
            self._warned_imu_trunc = True
            logger.warning("IMU window truncated: %d samples > capacity %d "
                           "(raise imu_window_capacity for high-rate IMUs; "
                           "warning shown once)", len(rows), cap)
        n = min(len(rows), cap)
        packed = np.zeros((cap + 1, 8), np.float32)
        if n:
            arr = np.stack(rows[:n])                     # (n, 7) [t, acc, gyro]
            packed[:n, 0:3] = arr[:, 1:4]
            packed[:n, 3:6] = arr[:, 4:7]
            packed[:n, 6] = arr[:, 0] - t_scan
            packed[:n, 7] = np.maximum(np.diff(arr[:, 0], prepend=t_prev), 0.0)
        packed[cap, 0] = n
        packed[cap, 1] = scan_stamp_rel
        packed[cap, 2] = 1.0 if evict else 0.0
        return upload(packed, self.device)

    def _try_initialize(self, frame: PreprocessedFrame) -> bool:
        """Initialization hand-off (LOOSE: LiDAR-only odometry over the
        initialization window, then a loose IMU fit; NAIVE: IMU statics)."""
        from glim_tpu_torch.odometry.initial_state_estimation import (
            loose_initial_state, naive_initial_state)

        if not self.imu_buffer:
            return False
        p = self.params
        imu = np.stack(self.imu_buffer)
        span = imu[-1, 0] - imu[0, 0]

        init = None
        if p.initialization_mode.upper() == "LOOSE":
            if self._init_odom is None:
                from glim_tpu_torch.odometry.odometry_estimation_cpu import (
                    OdometryEstimationCPU, OdometryEstimationCPUParams)
                self._init_odom = OdometryEstimationCPU(OdometryEstimationCPUParams(
                    registration_type="VGICP",
                    vgicp_resolution=max(p.voxel_resolution * 2, 0.5),
                    voxel_capacity=min(p.voxel_capacity, 65536)), device=self.device)
                self._init_poses = []
            est0 = self._init_odom.insert_frame(frame)
            self._init_poses.append((frame.stamp, est0.T_world_lidar))
            if (self._init_poses[-1][0] - self._init_poses[0][0]
                    < p.initialization_window_size):
                return False
            init = loose_initial_state(self._init_poses, imu, self.T_lidar_imu)
            if init is None:
                logger.warning("LOOSE initialization failed; falling back to NAIVE")

        if init is None:
            if span < min(p.initialization_window_size, 0.3):
                return False
            init = naive_initial_state(imu, frame.stamp, p.fix_imu_bias)

        T0 = init.T_world_imu
        v0 = init.v_world
        b0 = np.zeros(6) if p.fix_imu_bias else init.bias

        C = int(frame.device_points.shape[0])
        self._t0 = frame.stamp
        win = empty_window(self.W, C // OLD_SUBSAMPLE, device=self.device)

        # First frame: no motion reference yet — covariances on the raw scan.
        covs, normals = cov_ops.estimate_covariances(
            frame.device_points, frame.device_mask, frame.device_neighbors, "plane")

        T0_d = self._f32(T0)
        self.window = win.replace(
            T=_set_last(win.T, T0_d),
            v=_set_last(win.v, self._f32(v0)),
            b=_set_last(win.b, self._f32(b0)),
            valid=_set_last(win.valid, torch.ones((), dtype=torch.bool, device=self.device)),
            pts=_set_last(win.pts, frame.device_points[::OLD_SUBSAMPLE]),
            covs=_set_last(win.covs, covs[::OLD_SUBSAMPLE]),
            mask=_set_last(win.mask, frame.device_mask[::OLD_SUBSAMPLE]),
            m_Tlin=_set_last(win.m_Tlin, T0_d),
            H_prior=torch.eye(15, device=self.device) * p.init_pose_damping_scale,
            T_anchor=T0_d.clone(), v_anchor=self._f32(v0), b_anchor=self._f32(b0))

        T_wl = T0_d @ self._f32(np.linalg.inv(self.T_lidar_imu))
        self._init_model(frame, covs, T_wl, T0_d, np.asarray(T0, np.float64))

        est = EstimationFrame(
            id=0, stamp=frame.stamp, T_lidar_imu=self.T_lidar_imu.copy(),
            device_T_world_lidar=T_wl, frame_id=FrameID.LIDAR,
            frame=PointBatch(points=frame.device_points, mask=frame.device_mask,
                             times=frame.device_times, covs=covs, normals=normals),
            raw_frame=frame)
        est.host_stamps = dict(frame.host_stamps, estimate=time.perf_counter())
        est.v_world_imu = v0
        est.imu_bias = b0
        est.custom_data["device_T_world_imu"] = T0_d
        self._est_frames.append(est)
        self.initialized = True
        self._init_odom = None
        self.frame_count = 1
        logger.info("initialized (%s): |v|=%.2f bias=%s W=%d",
                    p.initialization_mode, np.linalg.norm(v0), b0.round(4), self.W)
        return True


@register_module("odometry", "odometry_estimation_gpu")
def create_odometry_estimation_gpu_module(config=None, sensors_config=None, device="cuda"):
    """libodometry_estimation_gpu.so: the VGICP keyframe-map odometry."""
    params = (OdometryEstimationIMUParams.from_config(config, sensors_config)
              if config is not None else OdometryEstimationIMUParams())
    return OdometryEstimationIMU(params, device=device)
