"""Sub-mapping: bundle marginalized odometry frames into submaps.

Twin of ``glim_tpu/mapping/sub_mapping.py`` (reference:
src/glim/mapping/sub_mapping.cpp:104-500):

  * a 1-frame delayed input queue, so the IMU-rate trajectory between two
    consecutive frame poses can be smoothed (``ops/imu.py::smooth_pose_chain``);
  * keyframe selection by OVERLAP against the last keyframe's coarsest
    voxel map, or by DISPLACEMENT; a keyframe is re-deskewed with the
    smoothed IMU-rate poses, its covariances re-estimated, its points
    stride-sampled, and it gets one voxel map per level;
  * per-frame factor bookkeeping for the batch refinement: odometry
    between factors with, under ``create_between_factors``, a GICP-Hessian
    information (``_between_info_gicp``: one ``nn_search`` a frame after
    the submap's first), and the IMU preintegration of every edge;
  * a submap at ``max_num_keyframes``: under ``enable_optimization`` one LM
    over every frame state (``mapping/submap_refine.py``), then the
    keyframes merged and voxel-grid downsampled (points and covariances)
    at the refined poses in the frame of the central FRAME, with both
    endpoint offsets for global mapping's IMU chain.

The overlap gate of a frame is computed on the device from the frame's
device pose as soon as the frame arrives, and copied to pinned host memory
behind an event; the keyframe decision reads it once it has landed (or
when more than ``gate_keep`` decisions are waiting). Per-frame host data
goes up in one packed upload. A frame's between information stays on the
device with its host copy started (``HostCopy``); the refinement reads them
all when it starts, and reads its result once.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks as CB
from glim_tpu_torch.mapping.sub_mapping_base import SubMappingBase
from glim_tpu_torch.mapping.submap_refine import submap_refine
from glim_tpu_torch.odometry.window_estimator import _zero_preints
from glim_tpu_torch.ops import covariance as cov_ops
from glim_tpu_torch.ops import deskew as deskew_ops
from glim_tpu_torch.ops import gicp, lie, lie_np, pointops
from glim_tpu_torch.ops import imu as imu_ops
from glim_tpu_torch.ops import voxelmap as vmx
from glim_tpu_torch.ops.imu import PreintegratedImu
from glim_tpu_torch.types import (EstimationFrame, HostCopy, PointBatch, SubMap,
                                  to_numpy, upload)
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("sub")

GRAVITY = np.array([0.0, 0.0, -9.80665])
IMU_CHAIN_CAP = 64          # padded IMU samples per inter-frame interval
MAX_REFINED_FRAMES = 256    # the JAX package's largest frame bucket; past it, no refinement
BETWEEN_MIN_INLIERS = 500   # fewer GICP inliers: a fixed 1e3 information instead


@dataclass
class SubMappingParams:
    enable_imu: bool = True
    enable_optimization: bool = False
    max_num_keyframes: int = 15
    keyframe_update_strategy: str = "OVERLAP"     # OVERLAP | DISPLACEMENT
    keyframe_update_min_points: int = 500
    keyframe_update_interval_rot: float = 3.14
    keyframe_update_interval_trans: float = 1.0
    max_keyframe_overlap: float = 0.6
    create_between_factors: bool = False
    between_registration_type: str = "GICP"       # GICP | NONE
    keyframe_randomsampling_rate: float = 1.0
    keyframe_voxel_resolution: float = 0.25
    keyframe_voxelmap_levels: int = 2
    keyframe_voxelmap_scaling_factor: float = 2.0
    submap_downsample_resolution: float = 0.25
    submap_voxel_resolution: float = 0.5
    submap_target_num_points: int = 50000
    submap_point_capacity: int = 65536
    keyframe_voxel_capacity: int = 16384
    refine_subsample: int = 4          # refinement-cloud stride (Cs = C / this)
    optimization_outer: int = 3
    optimization_inner: int = 3

    @staticmethod
    def from_config(config) -> "SubMappingParams":
        p = SubMappingParams()
        g = lambda k, d: config.param("sub_mapping", k, d)
        p.enable_imu = g("enable_imu", True)
        p.enable_optimization = g("enable_optimization", False)
        p.max_num_keyframes = int(g("max_num_keyframes", 15))
        p.keyframe_update_strategy = g("keyframe_update_strategy", "OVERLAP")
        p.keyframe_update_min_points = int(g("keyframe_update_min_points", 500))
        p.keyframe_update_interval_rot = g("keyframe_update_interval_rot", 3.14)
        p.keyframe_update_interval_trans = g("keyframe_update_interval_trans", 1.0)
        p.max_keyframe_overlap = g("max_keyframe_overlap", 0.6)
        p.create_between_factors = g("create_between_factors", False)
        p.between_registration_type = g("between_registration_type", "GICP")
        p.keyframe_randomsampling_rate = g("keyframe_randomsampling_rate", 1.0)
        p.keyframe_voxel_resolution = g("keyframe_voxel_resolution", 0.25)
        p.keyframe_voxelmap_levels = int(g("keyframe_voxelmap_levels", 2))
        p.keyframe_voxelmap_scaling_factor = g("keyframe_voxelmap_scaling_factor", 2.0)
        p.submap_downsample_resolution = g("submap_downsample_resolution", 0.25)
        p.submap_voxel_resolution = g("submap_voxel_resolution", 0.5)
        p.submap_target_num_points = int(g("submap_target_num_points", 50000))
        return p


def _merge_keyframes(kf_points, kf_covs, kf_masks, kf_T_origin_kf, kf_valid,
                     resolution, *, out_cap: int):
    """Transform the keyframe clouds (points and covariances) into the
    origin frame and voxel-grid downsample them into one padded submap
    cloud. The covariances ride through the merge: the merged cloud is
    global mapping's matching source, and a VGICP factor without them
    weighs nothing."""
    R = kf_T_origin_kf[:, :3, :3]
    t = kf_T_origin_kf[:, :3, 3]
    pts = kf_points @ R.transpose(-1, -2) + t[:, None, :]
    covs = R[:, None] @ kf_covs @ R[:, None].transpose(-1, -2)
    mask = kf_masks & kf_valid[:, None]
    return pointops.voxelgrid_sampling_covs(
        pts.reshape(-1, 3), covs.reshape(-1, 3, 3), mask.reshape(-1),
        resolution, out_capacity=out_cap)


def _between_info_gicp(T_last, T_cur, last_pts, last_covs, last_mask,
                       cur_pts, cur_covs, cur_mask, max_dist):
    """6x6 information of the odometry delta from a GICP linearization of
    the current frame against the last frame's points (reference
    sub_mapping.cpp:193-210), and the inlier count -> (H, n_inliers)."""
    s = gicp.gicp_linearize(T_last, T_cur, cur_pts, cur_covs, cur_mask,
                            last_pts, last_covs, last_mask, max_dist)
    return s.H_ss, s.num_inliers


def _keyframe_gate(vm, points, mask, T_rel):
    """[n_valid_points, overlap vs the last keyframe] as one (2,) tensor."""
    ov = vmx.voxelmap_overlap(vm, points, mask, T_rel)
    return torch.stack([mask.sum().to(torch.float32), ov])


def _keyframe_gate_dev(vm, points, mask, T_frame, inv_last_T):
    """``_keyframe_gate`` from the frame's device pose, so it can be
    dispatched before any host state of the frame is read."""
    return _keyframe_gate(vm, points, mask, inv_last_T @ T_frame)


def _sub_frame_program(packed, T_lidar_imu, acc_noise, gyro_noise, int_noise, gravity):
    """The per-frame IMU work on one packed upload.

    ``packed`` (2*CAP+7, 8) f32:
      rows [0, CAP):      window A (prev->cur)  [acc(3), gyro(3), dt, rel]
      rows [CAP, 2*CAP):  window B (cur->next)  same layout
      row 2*CAP:          [spanB, 0, biasA(6)]
      rows 2*CAP+1..+2:   T_cur  (16 floats)
      rows 2*CAP+3..+4:   T_next (16 floats)
      row 2*CAP+5:        [v_cur(3), ...]
      row 2*CAP+6:        [bias_cur(6), ...]
    Padding rows carry rel = 1e9 (the mask sentinel; it also keeps the
    trajectory stamps ascending for deskew's binary search).

    Returns (traj (8, CAP): window B's smoothed IMU-rate trajectory
    [stamps_rel; trans(3); quat(4)], window A's preintegration)."""
    CAP = IMU_CHAIN_CAP
    A, B = packed[:CAP], packed[CAP:2 * CAP]
    maskA, maskB = A[:, 7] < 1e8, B[:, 7] < 1e8
    biasA = packed[2 * CAP, 2:8]
    T_cur = packed[2 * CAP + 1:2 * CAP + 3].reshape(4, 4)
    T_next = packed[2 * CAP + 3:2 * CAP + 5].reshape(4, 4)
    v_cur = packed[2 * CAP + 5, :3]
    b_cur = packed[2 * CAP + 6, :6]
    span = packed[2 * CAP, 0]

    pre = imu_ops.preintegrate(A[:, :3], A[:, 3:6], A[:, 6], maskA, biasA,
                               acc_noise, gyro_noise, int_noise)

    T_wi0 = T_cur @ T_lidar_imu
    T_wi1 = T_next @ T_lidar_imu
    Rs, ps, _ = imu_ops.integrate_poses(T_wi0[:3, :3], T_wi0[:3, 3], v_cur, b_cur,
                                        gravity, B[:, :3], B[:, 3:6], B[:, 6], maskB)
    sigmas = B[:, 6] / torch.clamp(span, min=1e-3) + 1e-2
    Rs2, ps2 = imu_ops.smooth_pose_chain(Rs, ps, maskB, sigmas, T_wi1)
    quats = lie.rot_to_quat(Rs2)
    stamps_safe = torch.where(maskB, B[:, 7], 1e9)
    traj = torch.cat([stamps_safe[None, :], ps2.T, quats.T], dim=0)
    return traj, pre


def _kf_voxelmaps(s_pts, s_covs, s_mask, levels: int, cap: int, res0: float,
                  scale: float) -> List[vmx.GaussianVoxelMap]:
    return [vmx.voxelmap_insert(
        vmx.empty_gaussian_voxelmap(cap, res0 * (scale ** lvl), device=s_pts.device),
        s_pts, s_mask, s_covs, 0) for lvl in range(levels)]


def _kf_build_deskew(raw_pts, raw_times, raw_mask, neighbors, traj_packed, T_li, *,
                     stride: int, levels: int, cap: int, res0: float, scale: float):
    """Keyframe build: IMU-rate re-deskew, covariance re-estimation, stride
    sampling and the per-keyframe voxel map of every level."""
    stamps_rel = traj_packed[0].contiguous()
    trans = traj_packed[1:4].T
    quats = traj_packed[4:8].T
    pts = deskew_ops.deskew_imu(raw_pts, raw_times, raw_mask, stamps_rel, quats,
                                trans, T_li)
    covs, _ = cov_ops.estimate_covariances(pts, raw_mask, neighbors, "plane")
    s_pts, s_covs, s_mask = pts[::stride], covs[::stride], raw_mask[::stride]
    vms = _kf_voxelmaps(s_pts, s_covs, s_mask, levels, cap, res0, scale)
    return pts, covs, s_pts, s_covs, s_mask, vms


def _kf_build_plain(pts, covs, mask, *, stride: int, levels: int, cap: int,
                    res0: float, scale: float):
    """Keyframe build without re-deskew (no IMU-rate trajectory): stride
    sampling and the voxel map of every level."""
    s_pts, s_covs, s_mask = pts[::stride], covs[::stride], mask[::stride]
    return s_pts, s_covs, s_mask, _kf_voxelmaps(s_pts, s_covs, s_mask, levels,
                                                cap, res0, scale)


class SubMapping(SubMappingBase):
    def __init__(self, params: Optional[SubMappingParams] = None, device="cuda"):
        self.params = params or SubMappingParams()
        p = self.params
        self.device = torch.device(device)
        self.submap_count = 0
        self._delayed: List[EstimationFrame] = []
        self.odom_frames: List[EstimationFrame] = []
        self.frames: List[EstimationFrame] = []     # every frame in the submap
        self.keyframes: List[dict] = []             # device keyframe records
        self.submap_queue: List[SubMap] = []
        self.imu_buffer: List[np.ndarray] = []
        # Per-edge factor data of the batch refinement, entry i connects
        # frames (i-1, i): the odometry delta, the between information (a
        # HostCopy of [H (36), n_inliers], None, or unused), its validity,
        # and the preintegration.
        self._bt_delta: List[np.ndarray] = []
        self._bt_info: List = []
        self._bt_valid: List[bool] = []
        self._preints: List = []
        self._pre_valid: List[bool] = []
        self._last_frame_full = dict(T=np.eye(4), pts=None, covs=None, mask=None)
        self.refinements = 0             # submaps refined (_refine ran its LM)
        self.between_infos = 0           # _between_info_gicp calls (nn_search launches)
        # Deferred keyframe decisions (gate HostCopy, frame, frame index),
        # read once the gate has landed; at most `gate_keep` wait.
        self._kf_pending: List[tuple] = []
        self.gate_keep = 3
        dev = self.device
        full = lambda v: torch.full((), v, device=dev)
        self._d_acc_noise = full(0.05)
        self._d_gyro_noise = full(0.02)
        self._d_int_noise = full(0.001)
        self._d_gravity = upload(GRAVITY.astype(np.float32), dev)
        self._d_max_dist = full(1.0)     # between-information correspondence distance
        self._d_downsample_res = full(float(p.submap_downsample_resolution))
        self._d_T_li = None          # inverse of T_lidar_imu, for the IMU program
        self._d_T_li_fwd = None      # T_lidar_imu, for the keyframe re-deskew

    def insert_imu(self, stamp, linear_acc, angular_vel) -> None:
        CB.on_insert_imu(stamp, linear_acc, angular_vel)
        if self.params.enable_imu:
            self.imu_buffer.append(np.concatenate([[stamp], linear_acc, angular_vel]))

    def insert_frame(self, frame: EstimationFrame) -> None:
        CB.on_insert_frame(frame)
        # Frame k is processed when k+1 arrives, so the IMU-rate trajectory
        # between them can be smoothed.
        self._delayed.append(frame)
        if len(self._delayed) < 2:
            return
        cur = self._delayed.pop(0)
        self._process_frame(cur, self._delayed[0])

    def _process_frame(self, frame: EstimationFrame,
                       next_frame: Optional[EstimationFrame]) -> None:
        with record_function("sub/process_frame"):
            self._process_frame_impl(frame, next_frame)

    def _process_frame_impl(self, frame: EstimationFrame,
                            next_frame: Optional[EstimationFrame]) -> None:
        p = self.params
        # Decide the earlier frames' keyframe questions first: their gates
        # had a frame interval to land, and the decision may change which
        # keyframe this frame's gate compares against.
        self._resolve_pending_keyframes()
        gate_pending = self._dispatch_keyframe_gate(frame)
        frame.fetch_state()
        if next_frame is not None:
            next_frame.fetch_state()

        pre_dev = None
        nA = 0
        if p.enable_imu:
            traj_dev, pre_dev, nA, nB = self._dispatch_imu_program(frame, next_frame)
            if traj_dev is not None:
                frame.imu_rate_trajectory = None
                frame.device_imu_rate_trajectory = (traj_dev, nB, frame.stamp)

        current = len(self.frames)
        self.odom_frames.append(frame.clone_wo_points())
        # Every scan of the submap (its optimized per-scan trajectory).
        self.frames.append(frame.clone_wo_points())

        # Factor bookkeeping for the batch refinement.
        T_frame = frame.T_world_sensor()
        last = self._last_frame_full
        if current == 0:
            self._bt_delta.append(np.eye(4))
            self._bt_info.append(None)
            self._bt_valid.append(False)
        else:
            info = None
            if (p.create_between_factors and p.between_registration_type.upper() == "GICP"
                    and last["pts"] is not None and frame.frame is not None):
                info = self._between_info(last, T_frame, frame.frame)
            self._bt_delta.append(np.linalg.inv(last["T"]) @ T_frame)
            self._bt_info.append(info)
            self._bt_valid.append(p.create_between_factors)
        if p.enable_imu and current > 0 and nA < 2:
            logger.warning("insufficient IMU data between LiDAR frames!! (sub_mapping)")
        ok = p.enable_imu and current > 0 and nA >= 2
        self._preints.append(pre_dev if ok else None)
        self._pre_valid.append(ok)
        # Only the last frame's full cloud is kept (for the next between).
        cloud = frame.frame
        self._last_frame_full = dict(
            T=T_frame, pts=cloud.points if cloud is not None else None,
            covs=cloud.covs if cloud is not None else None,
            mask=cloud.mask if cloud is not None else None)

        self._kf_pending.append((gate_pending, frame, current))

    def _between_info(self, last: dict, T_cur: np.ndarray, cloud: PointBatch) -> HostCopy:
        """The GICP between information of this frame against the last one,
        packed [H (36), n_inliers] on the device with its host copy started;
        the refinement reads it."""
        zeros = lambda pts: torch.zeros(pts.shape[:1] + (3, 3), device=pts.device)
        last_covs = last["covs"] if last["covs"] is not None else zeros(last["pts"])
        cur_covs = cloud.covs if cloud.covs is not None else zeros(cloud.points)
        T = upload(np.stack([last["T"], T_cur]).astype(np.float32), self.device)
        H, n_in = _between_info_gicp(T[0], T[1], last["pts"], last_covs, last["mask"],
                                     cloud.points, cur_covs, cloud.mask, self._d_max_dist)
        self.between_infos += 1
        return HostCopy(torch.cat([H.reshape(-1), n_in.to(torch.float32).reshape(1)]))

    def _resolve_pending_keyframes(self, force_all: bool = False,
                                   keep: int = None) -> None:
        """Decide deferred keyframe questions whose gates have landed;
        pendings deeper than ``keep`` (default ``gate_keep``) are decided
        even if that waits. Before a submap is closed, every pending one is
        decided, so each frame's candidacy lands in the submap it belongs
        to."""
        if keep is None:
            keep = self.gate_keep
        while self._kf_pending:
            gate = self._kf_pending[0][0]
            if (not force_all and len(self._kf_pending) <= keep
                    and gate is not None and not gate.ready()):
                return
            gate, frame, current = self._kf_pending.pop(0)
            if not self._should_insert_keyframe(frame, gate):
                continue
            with record_function("sub/kf_insert"):
                self._insert_keyframe(current, frame)
            CB.on_new_keyframe(current, frame)
            if len(self.keyframes) >= self.params.max_num_keyframes and not force_all:
                # Frames after `current` are already in self.frames and go
                # into this submap: decide them first.
                self._resolve_pending_keyframes(force_all=True)
                self._create_submap()
                return

    def get_submaps(self) -> List[SubMap]:
        out = self.submap_queue
        self.submap_queue = []
        now = time.perf_counter()
        for sm in out:
            sm.host_stamps["sub_mapping"] = now
        return out

    def submit_end_of_sequence(self) -> List[SubMap]:
        if self._delayed:
            self._process_frame(self._delayed.pop(0), None)
        self._resolve_pending_keyframes(force_all=True)
        if self.keyframes:
            self._create_submap()
        return self.get_submaps()

    # -- internals --

    def _imu_window_block(self, t0: float, t1: float):
        """(CAP, 8) [acc(3), gyro(3), dt, rel] block covering (t0, t1];
        padding rows carry rel = 1e9. Returns (block, n)."""
        rows = [r for r in self.imu_buffer if t0 < r[0] <= t1 + 1e-6]
        self.imu_buffer = [r for r in self.imu_buffer if r[0] > t0 - 0.5]
        n = min(len(rows), IMU_CHAIN_CAP)
        block = np.zeros((IMU_CHAIN_CAP, 8), np.float32)
        block[:, 7] = 1e9
        prev = t0
        for i in range(n):
            block[i, :3] = rows[i][1:4]
            block[i, 3:6] = rows[i][4:7]
            block[i, 6] = max(rows[i][0] - prev, 0.0)
            block[i, 7] = rows[i][0] - t0
            prev = rows[i][0]
        return block, n

    def _dispatch_imu_program(self, frame: EstimationFrame,
                              next_frame: Optional[EstimationFrame]):
        """Build the packed per-frame upload and run the IMU program.
        Returns (traj or None, preintegration or None, nA, nB): the cur->next
        smoothed trajectory and the prev->cur preintegration, both left on
        the device."""
        CAP = IMU_CHAIN_CAP
        prev = self.frames[-1] if self.frames else None
        packed = np.zeros((2 * CAP + 7, 8), np.float32)
        packed[:CAP, 7] = 1e9
        packed[CAP:2 * CAP, 7] = 1e9
        nA = nB = 0
        if prev is not None:
            packed[:CAP], nA = self._imu_window_block(prev.stamp, frame.stamp)
            packed[2 * CAP, 2:8] = prev.imu_bias
        if next_frame is not None:
            packed[CAP:2 * CAP], nB = self._imu_window_block(frame.stamp, next_frame.stamp)
            packed[2 * CAP, 0] = next_frame.stamp - frame.stamp
            packed[2 * CAP + 3:2 * CAP + 5] = np.asarray(
                next_frame.T_world_sensor(), np.float32).reshape(2, 8)
        if nA < 2 and nB < 2:
            return None, None, nA, nB
        packed[2 * CAP + 1:2 * CAP + 3] = np.asarray(
            frame.T_world_sensor(), np.float32).reshape(2, 8)
        packed[2 * CAP + 5, :3] = frame.v_world_imu
        packed[2 * CAP + 6, :6] = frame.imu_bias
        if self._d_T_li is None:
            self._d_T_li = upload(np.linalg.inv(frame.T_lidar_imu).astype(np.float32),
                                  self.device)
        traj, pre = _sub_frame_program(upload(packed, self.device), self._d_T_li,
                                       self._d_acc_noise, self._d_gyro_noise,
                                       self._d_int_noise, self._d_gravity)
        return (traj if (nB >= 2 and next_frame is not None) else None,
                pre if nA >= 2 else None, nA, nB)

    def _dispatch_keyframe_gate(self, frame: EstimationFrame) -> Optional[HostCopy]:
        """The OVERLAP gate from the frame's device pose, its host copy
        started; None when the gate does not apply to this frame."""
        p = self.params
        if (p.keyframe_update_strategy.upper() == "DISPLACEMENT"
                or not self.keyframes
                or frame.frame is None or frame.frame.points is None
                or frame.device_T_world_lidar is None):
            return None
        last = self.keyframes[-1]
        return HostCopy(_keyframe_gate_dev(last["vms"][-1], frame.frame.points,
                                           frame.frame.mask, frame.device_T_world_lidar,
                                           last["T_inv"]))

    def _should_insert_keyframe(self, frame: EstimationFrame,
                                gate_pending: Optional[HostCopy] = None) -> bool:
        p = self.params
        if not self.keyframes:
            return True
        if frame.frame is None or frame.frame.points is None:
            return False
        last = self.keyframes[-1]
        if p.keyframe_update_strategy.upper() == "DISPLACEMENT":
            if int(frame.frame.mask.sum()) <= p.keyframe_update_min_points:
                return False
            delta = lie_np.se3_log(np.linalg.inv(last["T"]) @ frame.T_world_sensor())
            return (np.linalg.norm(delta[3:]) > p.keyframe_update_interval_trans
                    or np.linalg.norm(delta[:3]) > p.keyframe_update_interval_rot)
        # OVERLAP vs the last keyframe's coarsest voxel map.
        if gate_pending is not None:
            gate = gate_pending.numpy()
        else:
            T_rel = last["T_inv"] @ upload(
                np.asarray(frame.T_world_sensor(), np.float32), self.device)
            gate = HostCopy(_keyframe_gate(last["vms"][-1], frame.frame.points,
                                           frame.frame.mask, T_rel)).numpy()
        if int(gate[0]) <= p.keyframe_update_min_points:
            return False
        return float(gate[1]) < p.max_keyframe_overlap

    def _insert_keyframe(self, current: int, frame: EstimationFrame) -> None:
        """Re-deskew with the smoothed IMU-rate poses, re-estimate
        covariances, stride-sample, and build the per-keyframe voxel maps."""
        p = self.params
        pts, covs, mask = frame.frame.points, frame.frame.covs, frame.frame.mask
        raw = frame.raw_frame
        dev_irt = frame.device_imu_rate_trajectory
        host_irt = frame._imu_rate_trajectory
        has_irt = ((dev_irt is not None and dev_irt[1] >= 2)
                   or (host_irt is not None and host_irt.shape[1] >= 2))
        static = dict(stride=max(1, int(round(1.0 / max(p.keyframe_randomsampling_rate, 1e-3)))),
                      levels=max(p.keyframe_voxelmap_levels, 1),
                      cap=p.keyframe_voxel_capacity,
                      res0=p.keyframe_voxel_resolution,
                      scale=p.keyframe_voxelmap_scaling_factor)
        if (p.enable_imu and raw is not None and has_irt
                and getattr(raw, "device_points", None) is not None):
            if dev_irt is not None:
                traj_packed = dev_irt[0]
            else:
                traj_packed = upload(np.concatenate(
                    [host_irt[0:1] - frame.stamp, host_irt[1:8]]).astype(np.float32),
                    self.device)
            if self._d_T_li_fwd is None:
                self._d_T_li_fwd = upload(np.asarray(frame.T_lidar_imu, np.float32),
                                          self.device)
            pts, covs, s_pts, s_covs, s_mask, vms = _kf_build_deskew(
                raw.device_points, raw.device_times, raw.device_mask,
                raw.device_neighbors, traj_packed, self._d_T_li_fwd, **static)
            mask = raw.device_mask
        else:
            if covs is None:
                covs = torch.zeros(pts.shape[:1] + (3, 3), device=pts.device)
            s_pts, s_covs, s_mask, vms = _kf_build_plain(pts, covs, mask, **static)

        T = frame.T_world_sensor()
        self.keyframes.append(dict(
            fidx=current, T=T, id=frame.id,
            T_inv=upload(np.linalg.inv(T).astype(np.float32), self.device),
            pts=s_pts, covs=s_covs, mask=s_mask,
            full_pts=pts, full_covs=covs, full_mask=mask, vms=vms))

    def _refine(self) -> Optional[tuple]:
        """Batch LM over all frame states (``submap_refine``) -> (T (N, 4, 4),
        v, b) as numpy, or None when disabled or degenerate. The between
        informations' host copies are read here (one wait each, long
        landed), and the result in one read."""
        p = self.params
        N = len(self.frames)
        if not p.enable_optimization or N < 2 or len(self.keyframes) < 2:
            return None
        if N > MAX_REFINED_FRAMES:
            logger.warning("submap has %d frames > %d; skipping batch refinement", N,
                           MAX_REFINED_FRAMES)
            return None
        dev = self.device
        bt_info = np.tile(np.eye(6, dtype=np.float32), (N, 1, 1))
        for i, info in enumerate(self._bt_info):
            if not self._bt_valid[i]:
                continue
            packed = info.numpy() if info is not None else None
            if packed is not None and int(packed[36]) >= BETWEEN_MIN_INLIERS:
                bt_info[i] = packed[:36].reshape(6, 6)
            else:
                bt_info[i] = np.eye(6) * 1e3
        kfs = self.keyframes[:p.max_num_keyframes]
        K = len(kfs)
        kf_fidx = np.zeros(N, np.float32)           # keyframe k's frame in row k < K
        kf_fidx[:K] = [kf["fidx"] for kf in kfs]
        # One upload of every per-frame input.
        host = upload(np.concatenate([
            np.stack([fr.T_world_sensor() for fr in self.frames]).reshape(N, -1),
            np.stack([fr.v_world_imu for fr in self.frames]),
            np.stack([fr.imu_bias for fr in self.frames]),
            np.stack(self._bt_delta).reshape(N, -1), bt_info.reshape(N, -1),
            np.asarray(self._bt_valid, np.float32)[:, None],
            np.asarray(self._pre_valid, np.float32)[:, None], kf_fidx[:, None]],
            axis=1).astype(np.float32), dev)
        T0_d, v0_d, b0_d = host[:, :16].reshape(N, 4, 4), host[:, 16:19], host[:, 19:25]
        btd_d = host[:, 25:41].reshape(N, 4, 4)
        bti_d = host[:, 41:77].reshape(N, 6, 6)
        btv_d, prv_d = host[:, 77] > 0.5, host[1:, 78] > 0.5
        kf_fidx_d = host[:K, 79].to(torch.int64)

        # Edge (i, i+1)'s preintegration is entry i + 1 (zeros where invalid).
        zero = _zero_preints(2, dev).map(lambda x: x[0])
        pre = PreintegratedImu(*(torch.stack(xs) for xs in zip(*(
            (self._preints[i] or zero).astuple() for i in range(1, N)))))

        rs = max(1, p.refine_subsample)
        stack = lambda key: torch.stack([kf[key][::rs] for kf in kfs])
        tables = []
        for lvl in range(max(p.keyframe_voxelmap_levels, 1)):
            keys, stats = zip(*(vmx.gaussian_lookup_table(kf["vms"][lvl]) for kf in kfs))
            tables.append((torch.stack(keys), torch.stack(stats),
                           torch.stack([kf["vms"][lvl].resolution for kf in kfs])))
        with record_function("sub/refine"):
            T, v, b, err = submap_refine(
                T0_d, v0_d, b0_d, btd_d, bti_d, btv_d, pre, prv_d, stack("pts"),
                stack("covs"), stack("mask"), kf_fidx_d, tables, self._d_gravity,
                outer=p.optimization_outer, inner=p.optimization_inner)
            out = to_numpy(torch.cat([T.reshape(N, -1), v, b, err.expand(N, 1)], dim=1),
                           np.float64)
        self.refinements += 1
        CB.on_optimization_status(dict(error=float(out[0, 25])), None)
        return out[:, :16].reshape(N, 4, 4), out[:, 16:19], out[:, 19:25]

    def _create_submap(self) -> None:
        with record_function("sub/create_submap"):
            self._create_submap_impl()

    def _create_submap_impl(self) -> None:
        p = self.params
        K = len(self.keyframes)
        N = len(self.frames)
        if K == 0 or N == 0:
            return
        refined = self._refine()
        if refined is not None:
            for fr, T, v, b in zip(self.frames, *refined):
                fr.set_T_world_sensor(T)
                fr.v_world_imu = v
                fr.imu_bias = b
        # Origin at the central FRAME.
        T_world_origin = self.frames[N // 2].T_world_sensor()
        T_origin_world = np.linalg.inv(T_world_origin)

        k_max = p.max_num_keyframes
        kfs = self.keyframes[:k_max]
        pad = k_max - len(kfs)
        stack = lambda key: torch.stack([kf[key] for kf in kfs]
                                        + [torch.zeros_like(kfs[0][key])] * pad)
        kf_T = np.tile(np.eye(4, dtype=np.float32), (k_max, 1, 1))
        kf_valid = np.zeros(k_max, bool)
        for i, kf in enumerate(kfs):
            kf_T[i] = T_origin_world @ self.frames[kf["fidx"]].T_world_sensor()
            kf_valid[i] = True

        out_cap = min(p.submap_point_capacity,
                      int(2 ** np.ceil(np.log2(max(p.submap_target_num_points, 1024)))))
        m_pts, m_covs, m_mask = _merge_keyframes(
            stack("full_pts"), stack("full_covs"), stack("full_mask"),
            upload(kf_T, self.device), upload(kf_valid, self.device),
            self._d_downsample_res, out_cap=out_cap)

        submap = SubMap(
            id=self.submap_count,
            T_world_origin=T_world_origin,
            T_origin_endpoint_L=T_origin_world @ self.frames[0].T_world_sensor(),
            T_origin_endpoint_R=T_origin_world @ self.frames[-1].T_world_sensor(),
            frame=PointBatch(points=m_pts, mask=m_mask, covs=m_covs),
            frames=self.frames,
            odom_frames=self.odom_frames)
        # Creation-time origin (global mapping overwrites T_world_origin).
        submap.custom_data["T_world_origin_pre"] = T_world_origin.copy()

        self.submap_count += 1
        self.keyframes = []
        self.frames = []
        self.odom_frames = []
        self._bt_delta = []
        self._bt_info = []
        self._bt_valid = []
        self._preints = []
        self._pre_valid = []
        self.submap_queue.append(submap)
        CB.on_new_submap(submap)
        logger.info("submap %d created (%d keyframes, %d frames%s)", submap.id, K, N,
                    ", refined" if refined is not None else "")


@register_module("sub_mapping", "sub_mapping")
def create_sub_mapping_module(config=None, device="cuda"):
    """libsub_mapping.so."""
    params = SubMappingParams.from_config(config) if config is not None else SubMappingParams()
    return SubMapping(params, device=device)
