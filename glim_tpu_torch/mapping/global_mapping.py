"""Matching-cost global mapping: registration-error minimization over submaps.

Twin of ``glim_tpu/mapping/global_mapping.py`` on ``device`` (the card by
default). Submaps enter with odometry-chained initial poses; every submap
within ``max_implicit_loop_distance`` (the nearest
``max_implicit_loop_candidates`` of them, <= 0 = all) whose overlap exceeds
``min_implicit_loop_overlap`` gets a VGICP matching-cost factor per voxel-map
level (implicit loop closure), plus optional GICP-refined odometry between
factors, an isolation-prevention factor for unconnected submaps, and IMU
factors over submap endpoints. ``mapping/global_factors.py::global_gn``
solves all submap poses jointly.

Matching factors keep CACHED correspondences in stacked padded tensors:
the voxel lookups are refreshed only for factors whose relative pose moved
since their last search (iSAM2's relinearization threshold, per factor),
one stacked search per voxel-map level and refresh round. Indeterminate-
system recovery damps exactly the offending poses, found from the final
Hessian's diagonal.

Host reads, each the twin of one in the JAX package: the overlap fractions
of an insert's candidates (one read), the between refinement's converged
Hessian, inlier count and pose (one read), and per GN call the solved poses,
junction states, error and Hessian-diagonal minima (one read), besides the
GN's per-iteration convergence flag (``global_factors.py``). The adaptive
voxel resolution stays a device scalar.

``loop_search_enabled`` (the viewer's "set_enabled loop_detection") keeps
only the odometry-neighbour candidate while off, as in the JAX package.

With more than one card attached (and ``use_device_mesh``), ``global_gn``
shards its matching-factor rows over a mesh of up to 8 of them, a power of
two (``parallel/sharded.py``), as the JAX package does over its devices.

Not ported: the background precompile worker (it exists only because XLA
compiles one program per shape).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as CB
from glim_tpu_torch.mapping.global_factors import (bucket, global_gn, pad_stack,
                                                   pad_stack_tree)
from glim_tpu_torch.mapping.global_mapping_base import GlobalMappingBase, record_map_lag
from glim_tpu_torch.ops import gicp, lie, lie_np, solver
from glim_tpu_torch.ops import voxelmap as vmx
from glim_tpu_torch.ops.pointops import INVALID_HASH
from glim_tpu_torch.types import SubMap, to_numpy, upload
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.profiling import profile_scope
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("global")

GRAVITY = np.array([0.0, 0.0, -9.80665], np.float32)
PENDING_BATCHES = 8     # searched-row batches held before a forced drain


@dataclass
class GlobalMappingParams:
    enable_imu: bool = True
    enable_optimization: bool = True
    init_pose_damping_scale: float = 1e10
    create_between_factors: bool = False
    between_registration_type: str = "GICP"      # GICP | NONE
    registration_error_factor_type: str = "VGICP"
    randomsampling_rate: float = 1.0
    submap_voxel_resolution: float = 0.5
    submap_voxel_resolution_max: float = 1.0
    submap_voxel_resolution_dmin: float = 5.0
    submap_voxel_resolution_dmax: float = 20.0
    submap_voxelmap_levels: int = 2
    submap_voxelmap_scaling_factor: float = 2.0
    max_implicit_loop_distance: float = 100.0
    min_implicit_loop_overlap: float = 0.2
    voxel_capacity: int = 32768
    lm_iterations: int = 5
    matching_weight: float = 1e-3
    matching_points: int = 4096        # per-factor source-cloud budget
    optimization_interval_submaps: int = 1
    # Correspondence-refresh thresholds: a factor whose relative pose moved
    # further than this since its last voxel search gets re-searched (the
    # convergence floor of loop closure; well under the voxel resolution).
    relinearize_trans: float = 0.04
    relinearize_rot: float = 0.01
    # Shard the matching-factor rows of global_gn over a device mesh when
    # the back-end runs on a card and more than one card is attached.
    use_device_mesh: bool = True
    # Subsampling stride of the candidate-overlap gate (the overlap only
    # feeds a threshold); 1 = exact.
    overlap_gate_stride: int = 4
    # Per-insert budget on implicit-loop candidates (nearest-K by center
    # distance; the odometry neighbor always survives); <= 0 = unbounded.
    max_implicit_loop_candidates: int = 64

    @staticmethod
    def from_config(config) -> "GlobalMappingParams":
        p = GlobalMappingParams()
        g = lambda k, d: config.param("global_mapping", k, d)
        p.enable_imu = g("enable_imu", True)
        p.enable_optimization = g("enable_optimization", True)
        p.init_pose_damping_scale = g("init_pose_damping_scale", 1e10)
        p.create_between_factors = g("create_between_factors", False)
        p.between_registration_type = g("between_registration_type", "GICP")
        p.registration_error_factor_type = g("registration_error_factor_type", "VGICP")
        p.randomsampling_rate = g("randomsampling_rate", 1.0)
        p.submap_voxel_resolution = g("submap_voxel_resolution", 0.5)
        p.submap_voxel_resolution_max = g("submap_voxel_resolution_max",
                                          p.submap_voxel_resolution)
        p.submap_voxelmap_levels = int(g("submap_voxelmap_levels", 2))
        p.submap_voxelmap_scaling_factor = g("submap_voxelmap_scaling_factor", 2.0)
        p.max_implicit_loop_distance = g("max_implicit_loop_distance", 100.0)
        p.min_implicit_loop_overlap = g("min_implicit_loop_overlap", 0.2)
        p.optimization_interval_submaps = int(g("optimization_interval_submaps", 1))
        p.use_device_mesh = bool(g("use_device_mesh", True))
        p.overlap_gate_stride = int(g("overlap_gate_stride", 4))
        p.max_implicit_loop_candidates = int(g("max_implicit_loop_candidates", 64))
        return p


class GlobalMapping(GlobalMappingBase):
    def __init__(self, params: Optional[GlobalMappingParams] = None, device="cuda"):
        self.params = params or GlobalMappingParams()
        self.device = torch.device(device)
        # VGICP and VGICP_GPU run the same stacked VGICP factors here.
        ft = self.params.registration_error_factor_type.upper()
        if ft not in ("VGICP", "VGICP_GPU"):
            logger.warning("unknown registration_error_factor_type (%s); using VGICP", ft)
            self.params.registration_error_factor_type = "VGICP"
        self.submaps: List[SubMap] = []
        self.poses: List[np.ndarray] = []
        self.odom_poses: List[np.ndarray] = []
        # Per-submap multi-resolution maps: voxelmaps[i][lvl], [0] finest.
        self.voxelmaps: List[list] = []
        # Per-submap matching clouds (budgeted stride sample, on the device).
        self._m_pts: List[torch.Tensor] = []
        self._m_covs: List[torch.Tensor] = []
        self._m_mask: List[torch.Tensor] = []
        # Matching-cost factors (target, source); their searched rows live in
        # the match stack (or briefly in _pending_rows); _f_cache keeps per
        # pair the relative pose of the last search (the staleness anchor).
        self.matching_factors: List[Tuple[int, int]] = []
        self._f_cache: dict = {}
        # Searched rows the live match stack could not take yet (no stack,
        # or a capacity / key change pending); drained by _match_stacks.
        self._pending_rows: List[tuple] = []
        # Between factors: (i, j, Z (4,4), info (6,6)).
        self.between_factors: List[Tuple[int, int, np.ndarray, np.ndarray]] = []
        self.between_refinements = 0     # inserts whose GICP refinement ran
        # IMU endpoint-chain factors and their junction states [v_R, v_L, bias].
        self.imu_factors: List[dict] = []
        self.junction_states: List[np.ndarray] = []
        self._imu_buffer: List[np.ndarray] = []
        # Indeterminate-system recovery: submap index -> damping scale.
        self.recovery_damping: dict = {}
        # Gravity-alignment anchors: first submap of each appended session.
        self.gravity_anchors: List[int] = []
        # External translation priors [(submap_idx, pos_world (3,), sqrt_info (3,))].
        self.translation_priors: List[tuple] = []
        self._new_loop_since_opt = False
        self._last_opt_count = 0
        # When True, insert_submap skips its in-line optimize (the
        # end-of-sequence drain sets it around a burst of submaps).
        self.defer_optimization = False
        # Runtime toggle of the implicit loop search (the command channel's
        # "set_enabled loop_detection"): off, a new submap gets only its
        # odometry-neighbour factor.
        self.loop_search_enabled = True
        # Stacked device tensors, maintained incrementally: submap clouds,
        # per-level lookup tables and the correspondence rows.
        self._sm_stack = None
        self._lk_stack = None
        self._match_stack = None
        self._match_dirty: set = set()
        self._mesh = None
        if self.params.use_device_mesh and self.device.type == "cuda":
            n = torch.cuda.device_count()
            if n > 1:
                from glim_tpu_torch.parallel.sharded import make_mesh
                self._mesh = make_mesh(min(1 << (n.bit_length() - 1), 8), axis="factors")
                logger.info("global_gn matching factors sharded over %d devices",
                            self._mesh.size)

    # -- insertion --

    def insert_imu(self, stamp, linear_acc, angular_vel) -> None:
        CB.on_insert_imu(stamp, linear_acc, angular_vel)
        if self.params.enable_imu:
            self._imu_buffer.append(np.concatenate([[stamp], linear_acc, angular_vel]))

    def insert_submap(self, submap: SubMap) -> None:
        with profile_scope("global/insert_submap"):
            self._insert_submap_impl(submap)

    def _ensure_covs(self, submap: SubMap) -> None:
        """Guarantee per-point covariances on the submap frame (the
        matching-cost factors are Mahalanobis-weighted): covariance-less
        submaps get them estimated from a 10-neighbour kNN."""
        if submap.frame.covs is not None:
            return
        from glim_tpu_torch.ops import covariance as cov_ops
        from glim_tpu_torch.ops import knn
        nbr, _ = knn.knn_banded(submap.frame.points, submap.frame.mask, 10)
        covs, _ = cov_ops.estimate_covariances(submap.frame.points, submap.frame.mask,
                                               nbr, "plane")
        submap.frame.covs = covs

    def _insert_submap_impl(self, submap: SubMap) -> None:
        CB.on_insert_submap(submap)
        with record_function("global/ins.covs"):
            self._ensure_covs(submap)
        p = self.params
        i = len(self.submaps)
        T_odom = np.asarray(submap.T_world_origin, np.float64)
        if i == 0:
            T_est = T_odom
        else:
            T_est = self.poses[-1] @ (np.linalg.inv(self.odom_poses[-1]) @ T_odom)

        self.submaps.append(submap)
        self.odom_poses.append(T_odom)
        self.poses.append(T_est)
        with record_function("global/ins.voxelmap"):
            self.voxelmaps.append(self._build_voxelmap(submap))
        self._append_match_slice(submap)

        # Optional odometry between factor, GICP-refined.
        if i > 0 and p.create_between_factors:
            dZ = np.linalg.inv(self.odom_poses[i - 1]) @ self.odom_poses[i]
            if p.between_registration_type.upper() == "GICP":
                with record_function("global/ins.between_gicp"):
                    dZ, info = self._gicp_refine_between(i - 1, i, dZ)
                self.between_refinements += 1
            else:
                info = np.eye(6) * 1e2
            self.between_factors.append((i - 1, i, dZ, info))

        with record_function("global/ins.matching_factors"):
            self._create_matching_cost_factors(i)
        if p.enable_imu and i > 0:
            with record_function("global/ins.imu_factor"):
                self._create_imu_factor(i - 1, i)
        # The insert's own work ends here, before an optimize it runs.
        submap.host_stamps["inserted"] = time.perf_counter()
        due = (i + 1 - self._last_opt_count) >= p.optimization_interval_submaps
        if p.enable_optimization and not self.defer_optimization \
                and (self._new_loop_since_opt or due):
            self.optimize()

    def _append_match_slice(self, submap: SubMap) -> None:
        """Budgeted source-cloud slice for matching factors: a stride sample
        within ``matching_points``, composed with ``randomsampling_rate``."""
        C = int(submap.frame.points.shape[0])
        p = self.params
        budget = p.matching_points
        if p.randomsampling_rate <= 0.99:
            budget = min(budget, max(64, int(C * p.randomsampling_rate)))
        stride = max(1, -(-C // budget))   # ceil: stay within the budget
        self._m_pts.append(submap.frame.points[::stride].contiguous())
        self._m_covs.append(submap.frame.covs[::stride].contiguous())
        self._m_mask.append(submap.frame.mask[::stride].contiguous())

    def _gicp_refine_between(self, i: int, j: int, dZ: np.ndarray):
        """Refine the odometry delta by GICP between the two submap clouds
        (five damped GN steps, ``nn_search`` correspondences) and take the
        information from the converged Hessian."""
        T_i = torch.eye(4, device=self.device)
        T_j = upload(np.asarray(dZ, np.float32), self.device)
        clouds = (self._m_pts[j], self._m_covs[j], self._m_mask[j],
                  self._m_pts[i], self._m_covs[i], self._m_mask[i], 2.0)
        for _ in range(5):
            s = gicp.gicp_linearize(T_i, T_j, *clouds)
            T_j = T_j @ lie.se3_exp(solver.solve_damped(s.H_ss, s.b_s, 1e-4))
        s = gicp.gicp_linearize(T_i, T_j, *clouds)
        # One host read: H, the inlier count and the refined pose.
        host = to_numpy(torch.cat([s.H_ss.reshape(-1), s.num_inliers.reshape(1).float(),
                                   T_j.reshape(-1)]), np.float64)
        H, n_in, dZ_ref = host[:36].reshape(6, 6), int(host[36]), host[37:].reshape(4, 4)
        if n_in < 100 or not np.all(np.isfinite(H)):
            return dZ, np.eye(6) * 1e2
        # Guard: keep the refinement within sanity of the odometry delta.
        d = lie_np.se3_log(np.linalg.inv(dZ) @ dZ_ref)
        if np.linalg.norm(d[3:]) > 1.0 or np.linalg.norm(d[:3]) > 0.3:
            return dZ, np.eye(6) * 1e2
        return _orthonormalize(dZ_ref), H + np.eye(6) * 1e-3

    def _create_imu_factor(self, i: int, j: int) -> None:
        """Preintegrate the IMU between submap i's right and submap j's left
        endpoint and add the endpoint-chain factor."""
        sm_i, sm_j = self.submaps[i], self.submaps[j]
        if not (sm_i.frames and sm_j.frames):
            return
        fr_R = sm_i.frames[-1]
        fr_L = sm_j.frames[0]
        t0, t1 = fr_R.stamp, fr_L.stamp
        rows = np.stack([r for r in self._imu_buffer if t0 < r[0] <= t1 + 1e-9]) \
            if self._imu_buffer else np.zeros((0, 7))
        self._imu_buffer = [r for r in self._imu_buffer if r[0] > t0 - 1.0]
        if len(rows) < 2 or (t1 - t0) > 5.0:
            return
        from glim_tpu_torch.common.imu_integration import IMUIntegration
        integ = IMUIntegration(self.device)
        for r in rows:
            integ.insert_imu(r[0], r[1:4], r[4:7])
        bias0 = np.asarray(fr_R.imu_bias, np.float64)
        pre, n = integ.integrate_imu(t0, t1, bias0)
        if n < 2:
            return
        A_R = np.linalg.inv(np.asarray(sm_i.T_world_origin)) @ fr_R.T_world_imu
        A_L = np.linalg.inv(np.asarray(sm_j.T_world_origin)) @ fr_L.T_world_imu
        self.imu_factors.append(dict(i=i, j=j, pre=pre,
                                     A_R=A_R.astype(np.float32),
                                     A_L=A_L.astype(np.float32),
                                     junction=len(self.junction_states)))
        v0 = np.asarray(fr_R.v_world_imu, np.float64)
        v1 = np.asarray(fr_L.v_world_imu, np.float64)
        self.junction_states.append(np.concatenate([v0, v1, bias0]))
        logger.info("IMU endpoint factor %d -> %d (%d samples, dt %.2fs)",
                    i, j, n, t1 - t0)

    def _build_voxelmap(self, submap: SubMap) -> list:
        """Multi-resolution Gaussian voxel maps of one submap: level L at
        resolution * scaling_factor^L, [0] (finest) being the overlap map.
        The adaptive resolution from the median point distance stays a
        device scalar (no host read)."""
        p = self.params
        from glim_tpu_torch.ops.pointops import median_distance
        med = median_distance(submap.frame.points, submap.frame.mask)
        t = torch.clamp((med - p.submap_voxel_resolution_dmin) /
                        max(p.submap_voxel_resolution_dmax
                            - p.submap_voxel_resolution_dmin, 1e-6), 0.0, 1.0)
        res = p.submap_voxel_resolution + t * (p.submap_voxel_resolution_max
                                               - p.submap_voxel_resolution)
        maps = []
        for lvl in range(max(p.submap_voxelmap_levels, 1)):
            cap = max(p.voxel_capacity >> lvl, 4096)
            vm = vmx.empty_gaussian_voxelmap(
                cap, res * (p.submap_voxelmap_scaling_factor ** lvl), self.device)
            maps.append(vmx.voxelmap_insert(vm, submap.frame.points, submap.frame.mask,
                                            submap.frame.covs, 0))
        return maps

    def add_translation_prior(self, submap_idx: int, position, sqrt_info) -> None:
        """External position constraint on a submap pose (GNSS-style);
        ``sqrt_info`` is a scalar or (3,) square-root information [1/m]."""
        si = np.asarray(sqrt_info, np.float32)
        if si.ndim == 0:
            si = np.full(3, float(si), np.float32)
        self.translation_priors.append((int(submap_idx), np.asarray(position, np.float32), si))
        self._new_loop_since_opt = True

    def add_matching_factor(self, tgt: int, src: int) -> None:
        """External loop-closure pair: a matching-cost factor between two
        existing submaps, with a fresh correspondence search."""
        if not (0 <= tgt < len(self.submaps) and 0 <= src < len(self.submaps)):
            raise IndexError("submap index out of range")
        if tgt == src or (tgt, src) in self.matching_factors \
                or (src, tgt) in self.matching_factors:
            return
        self._register_matching_factors_batch([(tgt, src)])

    def add_between_factor(self, tgt: int, src: int, T_tgt_src: np.ndarray,
                           info=None) -> None:
        """Between factor with an explicit relative-pose measurement."""
        if not (0 <= tgt < len(self.submaps) and 0 <= src < len(self.submaps)):
            raise IndexError("submap index out of range")
        if info is None:
            info = np.eye(6) * 1e4
        info = np.asarray(info, np.float64)
        if info.ndim == 0:
            info = np.eye(6) * float(info)
        self.between_factors.append((int(tgt), int(src), np.asarray(T_tgt_src, np.float64),
                                     info))
        self._new_loop_since_opt = True

    # -- matching factors (cached correspondences) --

    def _register_matching_factors_batch(self, pairs: list) -> None:
        """Register matching-cost factors with one stacked correspondence
        search per voxel-map level."""
        if not pairs:
            return
        fis = list(range(len(self.matching_factors),
                         len(self.matching_factors) + len(pairs)))
        self.matching_factors.extend(pairs)
        self._batch_lookup_factors(pairs, fis)
        for tgt, src in pairs:
            if tgt != src - 1:
                self._new_loop_since_opt = True

    def _poses_dev(self, Sp: int) -> torch.Tensor:
        return pad_stack([np.asarray(T, np.float32) for T in self.poses], Sp,
                         np.eye(4, dtype=np.float32), self.device)

    def _pair_indices(self, pairs: list) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tgt, src) index tensors of the pairs, in one upload."""
        idx = upload(np.asarray(pairs, np.int32).reshape(-1, 2).T.copy(), self.device)
        return idx[0], idx[1]

    def _lookup_rows(self, pairs: list, L: int) -> list:
        """Stacked correspondence search for (tgt, src) pairs: one search
        per voxel-map level, each giving (mu, C_t, hit) stacked over the
        pairs. Unlike the JAX package, the pair axis is not padded to a
        bucket (nothing compiles per shape here)."""
        Sp = bucket(len(self.submaps))
        M = int(self._m_pts[0].shape[0])
        self._sm_stacks(Sp, M)
        lk = self._lk_stacks(Sp)
        poses = self._poses_dev(Sp)
        tgt, src = self._pair_indices(pairs)
        st = self._sm_stack
        return [gicp.vgicp_lookup_stacked(poses, tgt, src, st["pts"], st["mask"],
                                          lk[lvl]["keys"], lk[lvl]["stats"], lk[lvl]["res"])
                for lvl in range(L)]

    def _refresh_stale_factors(self) -> int:
        """Re-search correspondences of the factors whose relative pose moved
        beyond the relinearization threshold (checked on the host, f64),
        as one stacked search per level."""
        p = self.params
        stale = []
        for fi, (tgt, src) in enumerate(self.matching_factors):
            cache = self._f_cache.get((tgt, src))
            if cache is None:
                stale.append(fi)
                continue
            T_rel = np.linalg.inv(self.poses[tgt]) @ self.poses[src]
            d = lie_np.se3_log(np.linalg.inv(cache["T_rel"]) @ T_rel)
            if (np.linalg.norm(d[3:]) > p.relinearize_trans
                    or np.linalg.norm(d[:3]) > p.relinearize_rot):
                stale.append(fi)
        if stale:
            self._batch_lookup_factors([self.matching_factors[fi] for fi in stale], stale)
        return len(stale)

    def _batch_lookup_factors(self, pairs: list, fis: list) -> None:
        """Correspondence search for every (tgt, src) pair (one stacked
        search per level), then one scatter per match-stack leaf; when the
        live stack cannot take the rows (none yet, a key change, or rows
        past its capacity) they wait in _pending_rows for _match_stacks.

        The JAX package lets that buffer grow by one batch per insert while
        optimization is off (only an optimize drains it); here it is
        drained into the stack once it holds more than PENDING_BATCHES
        batches, more than one optimize cycle leaves in normal operation."""
        if not pairs:
            return
        L = max(self.params.submap_voxelmap_levels, 1)
        outs = self._lookup_rows(pairs, L)
        for pair in pairs:
            self._f_cache[pair] = dict(T_rel=np.linalg.inv(self.poses[pair[0]])
                                       @ self.poses[pair[1]])
        self._match_dirty.update(fis)

        st = self._match_stack
        key = tuple(self.matching_factors)
        if (st is None or st["L"] != L
                or st["key"] != key[:len(st["key"])]
                or len(key) * L > st["Fp"]
                or max(fis) * L + L > st["Fp"]):
            self._pending_rows.append((list(fis), outs))
            if len(self._pending_rows) > PENDING_BATCHES:
                self._match_stacks(bucket(max(len(key) * L, 1)), L,
                                   int(self._m_pts[0].shape[0]))
            return
        self._scatter_rows(st, outs, fis)
        st["key"] = key
        self._match_dirty.difference_update(fis)

    def _scatter_rows(self, st: dict, outs: list, fis: list) -> None:
        """Write searched factor rows into the live match stack, one
        ``index_copy_`` per leaf: factor fi's level-l row lands at fi * L + l.
        A negative fi (a row no longer wanted) or a row past the stack's
        capacity is filtered out on the host first (the JAX package writes
        with mode="drop", which torch has no form of)."""
        L, Fp = st["L"], st["Fp"]
        fis_np = np.asarray(fis, np.int64)
        keep = np.nonzero((fis_np >= 0) & (fis_np * L + L <= Fp))[0]
        if len(keep) == 0:
            return
        # Row lvl: the level's destination rows; last row: the kept rows.
        idx = upload(np.concatenate([fis_np[keep][None, :] * L + np.arange(L)[:, None],
                                     keep[None, :]]), self.device)
        every = len(keep) == len(fis)
        for lvl, out in enumerate(outs):
            for leaf, rows in zip(("f_mu", "f_ct", "f_hit"), out):
                st[leaf].index_copy_(0, idx[lvl], rows if every
                                     else rows.index_select(0, idx[L]))

    def _batch_overlaps(self, pairs: list) -> np.ndarray:
        """Overlap fraction of submap src against submap tgt's finest voxel
        map for every (tgt, src) pair: one stacked search, one host read."""
        Sp = bucket(len(self.submaps))
        M = int(self._m_pts[0].shape[0])
        self._sm_stacks(Sp, M)
        lk0 = self._lk_stacks(Sp)[0]
        T_rel = np.stack([np.linalg.inv(self.poses[t]) @ self.poses[s]
                          for t, s in pairs]).astype(np.float32)
        tgt, src = self._pair_indices(pairs)
        st = self._sm_stack
        ovs = vmx.voxelmap_overlap_stacked(upload(T_rel, self.device), tgt, src,
                                           st["pts"], st["mask"], lk0["keys"], lk0["res"],
                                           stride=self.params.overlap_gate_stride)
        return to_numpy(ovs)

    def _create_matching_cost_factors(self, i: int) -> None:
        """Implicit loop closure: factors to all overlapping nearby submaps,
        every candidate's overlap scored in one stacked search."""
        p = self.params
        pi = self.poses[i][:3, 3]
        connected = False
        cands = []
        if i:
            centers = np.stack([T[:3, 3] for T in self.poses[:i]])
            d = np.linalg.norm(centers - pi, axis=1)
            cands = [int(j) for j in np.where(d <= p.max_implicit_loop_distance)[0]]
            if len(cands) > p.max_implicit_loop_candidates > 0:
                # Candidate budget: the nearest K by center distance, plus the
                # odometry neighbor unconditionally.
                order = sorted(cands, key=lambda j: d[j])
                cands = sorted(set(order[:p.max_implicit_loop_candidates]) | {i - 1})
            if not self.loop_search_enabled:
                cands = [j for j in cands if j == i - 1]
        if cands:
            ovs = self._batch_overlaps([(j, i) for j in cands])
            keep = [(j, ov) for j, ov in zip(cands, ovs) if ov >= p.min_implicit_loop_overlap]
            self._register_matching_factors_batch([(j, i) for j, _ in keep])
            for j, ov in keep:
                connected = True
                if j != i - 1:
                    logger.info("implicit loop factor %d <-> %d (overlap %.2f)", j, i, ov)
        if not connected and i > 0:
            # Isolation prevention.
            dZ = np.linalg.inv(self.odom_poses[i - 1]) @ self.odom_poses[i]
            self.between_factors.append((i - 1, i, dZ, np.eye(6) * 100.0))
            logger.warning("submap %d isolated; added between factor", i)

    # -- stacked device tensors --

    def _sm_stacks(self, Sp: int, M: int):
        """Padded (Sp, M, 3) / (Sp, M, 3, 3) / (Sp, M) submap-cloud stacks;
        submap slices are append-only, so only new rows are written."""
        S = len(self._m_pts)
        st = self._sm_stack
        dev = self.device
        if st is None or st["Sp"] != Sp:
            st = dict(Sp=Sp, n=S,
                      pts=pad_stack(self._m_pts, Sp, torch.zeros(M, 3, device=dev), dev),
                      covs=pad_stack(self._m_covs, Sp, torch.zeros(M, 3, 3, device=dev), dev),
                      mask=pad_stack(self._m_mask, Sp,
                                     torch.zeros(M, dtype=torch.bool, device=dev), dev))
        else:
            for i in range(st["n"], S):
                st["pts"][i] = self._m_pts[i]
                st["covs"][i] = self._m_covs[i]
                st["mask"][i] = self._m_mask[i]
            st["n"] = S
        self._sm_stack = st
        return st["pts"], st["covs"]

    def _lk_stacks(self, Sp: int) -> list:
        """Per-level stacked voxel-map lookup tables: keys (Sp, V, 2), stats
        (Sp, V, 12) and the adaptive resolutions (Sp,), maintained
        incrementally like _sm_stacks."""
        L = max(self.params.submap_voxelmap_levels, 1)
        S = len(self.voxelmaps)
        st = self._lk_stack
        dev = self.device
        if st is None or st["Sp"] != Sp or len(st["levels"]) != L:
            levels = []
            for lvl in range(L):
                tabs = [vmx.gaussian_lookup_table(vms[lvl]) for vms in self.voxelmaps]
                V = self.voxelmaps[0][lvl].capacity
                levels.append(dict(
                    keys=pad_stack([k for k, _ in tabs], Sp,
                                   torch.full((V, 2), INVALID_HASH, dtype=torch.int32,
                                              device=dev), dev),
                    stats=pad_stack([s for _, s in tabs], Sp,
                                    torch.zeros(V, 12, device=dev), dev),
                    res=pad_stack([vms[lvl].resolution for vms in self.voxelmaps], Sp,
                                  torch.ones((), device=dev), dev)))
            st = dict(Sp=Sp, n=S, levels=levels)
        else:
            for i in range(st["n"], S):
                for lvl in range(L):
                    k, s = vmx.gaussian_lookup_table(self.voxelmaps[i][lvl])
                    d = st["levels"][lvl]
                    d["keys"][i] = k
                    d["stats"][i] = s
                    d["res"][i] = self.voxelmaps[i][lvl].resolution
            st["n"] = S
        self._lk_stack = st
        return st["levels"]

    def _match_stacks(self, Fp: int, L: int, M: int):
        """Padded correspondence stacks (f_mu / f_ct / f_hit), maintained
        incrementally: appends and refreshes write only their rows, a bucket
        crossing copies the live rows into a larger stack, and only a break
        of the append-only key prefix forces a rebuild. Rows come from the
        pending buffer (newest first) when already searched, else from one
        batched search over all missing pairs."""
        key = tuple(self.matching_factors)
        dev = self.device
        zeros = dict(f_mu=torch.zeros(M, 3, device=dev),
                     f_ct=torch.zeros(M, 3, 3, device=dev),
                     f_hit=torch.zeros(M, dtype=torch.bool, device=dev))

        st = self._match_stack
        if st is not None and (st["L"] != L or st["key"] != key[:len(st["key"])]):
            st = None
        if st is not None and st["Fp"] != Fp:
            n_old = len(st["key"]) * L
            if n_old > Fp:
                st = None
            else:
                # Bucket crossing: copy the live rows into fresh padding.
                grown = dict(Fp=Fp, L=L, key=st["key"])
                for leaf, z in zeros.items():
                    out = pad_stack([], Fp, z, dev)
                    out[:n_old] = st[leaf][:n_old]
                    grown[leaf] = out
                st = grown
        if st is None:
            st = dict(Fp=Fp, L=L, key=(),
                      **{leaf: pad_stack([], Fp, z, dev) for leaf, z in zeros.items()})
            self._match_dirty = set(range(len(key)))
        todo = ((set(self._match_dirty) | set(range(len(st["key"]), len(key))))
                & set(range(len(key))))
        # Newest first, so a pair appended and then refreshed within one
        # cycle lands its fresh rows (older duplicates are dropped, fi = -1).
        for fis, outs in reversed(self._pending_rows):
            use = [fi if (fi in todo and fi * L + L <= Fp) else -1 for fi in fis]
            if any(fi >= 0 for fi in use):
                self._scatter_rows(st, outs, use)
                todo -= {fi for fi in use if fi >= 0}
        self._pending_rows = []
        rest = sorted(todo)
        if rest:
            pairs = [key[i] for i in rest]
            outs = self._lookup_rows(pairs, L)
            for pair in pairs:
                self._f_cache[pair] = dict(
                    T_rel=np.linalg.inv(self.poses[pair[0]]) @ self.poses[pair[1]])
            self._scatter_rows(st, outs, rest)
        st["key"] = key
        self._match_dirty.clear()
        self._match_stack = st
        return st["f_mu"], st["f_ct"], st["f_hit"]

    def _padded_args(self):
        """The padded stacked arguments of global_gn and their bucket sizes.
        Host-built stacks go up in one pinned copy each."""
        from glim_tpu_torch.odometry.window_estimator import _zero_preints
        p = self.params
        dev = self.device
        S = len(self.submaps)
        F = len(self.matching_factors)
        B = len(self.between_factors)
        J = len(self.junction_states)
        A = len(self.gravity_anchors)
        TR = len(self.translation_priors)
        L = max(p.submap_voxelmap_levels, 1)
        Sp, Fp, Bp = bucket(S), bucket(max(F * L, 1)), bucket(max(B, 1))
        Jp, Ap, Tp = (bucket(J) if J else 0), (bucket(A) if A else 0), \
            (bucket(TR) if TR else 0)
        M = int(self._m_pts[0].shape[0])
        f_mu, f_ct, f_hit = self._match_stacks(Fp, L, M)
        sm_pts, sm_covs = self._sm_stacks(Sp, M)
        # One factor row per (pair, voxel-map level).
        f_pairs = np.asarray(self.matching_factors, np.int32).reshape(-1, 2).repeat(L, axis=0)
        f_idx = pad_stack(list(f_pairs), Fp, np.zeros(2, np.int32), dev)
        pre0 = _zero_preints(2, dev).map(lambda x: x[0])
        if Jp:
            m_pre = pad_stack_tree([f["pre"] for f in self.imu_factors], Jp, pre0)
        else:
            m_pre = pre0.map(lambda x: x[None][:0])
        m_ij = pad_stack([np.array([f["i"], f["j"]], np.int32) for f in self.imu_factors],
                         Jp, np.zeros(2, np.int32), dev)
        b_ij = pad_stack([np.array(f[:2], np.int32) for f in self.between_factors], Bp,
                         np.zeros(2, np.int32), dev)
        damping = np.full(Sp, 1e-3, np.float32)
        damping[:S] = 0.0
        for k, scale in self.recovery_damping.items():
            if k < Sp:
                damping[k] = scale
        sqrt_scale = np.sqrt(p.init_pose_damping_scale)
        args = dict(
            poses0=self._poses_dev(Sp),
            junc0=pad_stack(list(self.junction_states), Jp, np.zeros(12, np.float32), dev),
            f_tgt=f_idx[:, 0], f_src=f_idx[:, 1],
            f_w=pad_stack([np.float32(1.0)] * (F * L), Fp, np.float32(0.0), dev),
            f_mu=f_mu, f_ct=f_ct, f_hit=f_hit, sm_pts=sm_pts, sm_covs=sm_covs,
            b_i=b_ij[:, 0], b_j=b_ij[:, 1],
            b_Z=pad_stack([f[2] for f in self.between_factors], Bp,
                          np.eye(4, dtype=np.float32), dev),
            b_info=pad_stack([f[3] for f in self.between_factors], Bp,
                             np.eye(6, dtype=np.float32), dev),
            b_valid=pad_stack([True] * B, Bp, False, dev),
            m_i=m_ij[:, 0], m_j=m_ij[:, 1],
            m_AR=pad_stack([f["A_R"] for f in self.imu_factors], Jp,
                           np.eye(4, dtype=np.float32), dev),
            m_AL=pad_stack([f["A_L"] for f in self.imu_factors], Jp,
                           np.eye(4, dtype=np.float32), dev),
            m_pre=m_pre,
            m_valid=pad_stack([True] * J, Jp, False, dev),
            prior_T=upload(np.asarray(self.poses[0], np.float32), dev),
            prior_sqrt=torch.full((6,), sqrt_scale, device=dev),
            grav_idx=pad_stack([np.int32(a) for a in self.gravity_anchors], Ap,
                               np.int32(0), dev),
            grav_valid=pad_stack([True] * A, Ap, False, dev),
            grav_sqrt=torch.full((), sqrt_scale * 0.1, device=dev),
            damping=upload(damping, dev),
            gravity=upload(GRAVITY, dev),
            matching_weight=p.matching_weight,
            t_idx=(pad_stack([np.int32(i) for i, _, _ in self.translation_priors], Tp,
                             np.int32(0), dev) if Tp else None),
            t_pos=(pad_stack([pos for _, pos, _ in self.translation_priors], Tp,
                             np.zeros(3, np.float32), dev) if Tp else None),
            t_sqrt=(pad_stack([si for _, _, si in self.translation_priors], Tp,
                              np.zeros(3, np.float32), dev) if Tp else None),
            t_valid=(pad_stack([True] * TR, Tp, False, dev) if Tp else None),
        )
        return args, dict(Sp=Sp, Fp=Fp, Bp=Bp, Jp=Jp, Ap=Ap, Tp=Tp)

    # -- optimization --

    def needs_optimize(self) -> bool:
        """Anything new since the last optimize?"""
        return self._new_loop_since_opt or len(self.submaps) > self._last_opt_count

    def optimize(self, mesh=None) -> None:
        """Solve every submap pose; ``mesh`` (default: the back-end's own,
        if it built one) shards the matching-factor rows."""
        with profile_scope("global/optimize"):
            self._optimize_impl(mesh if mesh is not None else self._mesh)

    def _solve(self, args: dict, dims: dict, N: int, J: int, mesh=None):
        """global_gn on ``_padded_args``' arguments, then one host read of
        its solution: (poses (N, 4, 4), junctions (J, 12), err, min_diag (N,))."""
        T_fin, junc_fin, err, min_diag = global_gn(**args, **dims,
                                                   iters=self.params.lm_iterations,
                                                   shard_mesh=mesh)
        host = to_numpy(torch.cat([T_fin[:N].reshape(-1), junc_fin[:J].reshape(-1),
                                   err.reshape(1), min_diag[:N]]), np.float64)
        return (host[:16 * N].reshape(N, 4, 4), host[16 * N:16 * N + 12 * J].reshape(J, 12),
                float(host[16 * N + 12 * J]), host[16 * N + 12 * J + 1:])

    def _optimize_impl(self, mesh=None) -> None:
        N = len(self.submaps)
        if N < 2:
            return
        CB.on_smoother_update(self, None, None)
        self._new_loop_since_opt = False
        self._last_opt_count = N
        J = len(self.junction_states)
        # Damped-GN solve + correspondence refresh, repeated until the cache
        # is quiescent (large loop-closure corrections move poses several
        # voxels; one refresh round cannot track them).
        max_rounds = 10
        err = 0.0
        for round_ in range(max_rounds):
            with record_function("global/opt.args"):
                args, dims = self._padded_args()
            with record_function("global/opt.gn"):
                new_poses, juncs, err, md = self._solve(args, dims, N, J, mesh)
            if not np.all(np.isfinite(new_poses)):
                # Selective indeterminate-system recovery: damp exactly the
                # rank-deficient poses, found from the Hessian diagonal.
                bad = np.where(~np.isfinite(md) | (md < 1e-4))[0]
                if len(bad) == 0:
                    bad = np.where(~np.isfinite(new_poses).reshape(N, -1).all(axis=1))[0]
                for k in bad:
                    self.recovery_damping[int(k)] = 1e6
                logger.warning("indeterminant linear system: damping poses %s and "
                               "re-optimizing", list(map(int, bad)))
                new_poses, juncs, err, md = self._solve(*self._padded_args(), N, J, mesh)
                self.recovery_damping.clear()
                if not np.all(np.isfinite(new_poses)):
                    logger.error("recovery failed; keeping previous poses")
                    return
            for k in range(N):
                self.poses[k] = _orthonormalize(new_poses[k])
                self.submaps[k].T_world_origin = self.poses[k].copy()
            if J:
                self.junction_states = [juncs[k] for k in range(J)]
            with record_function("global/opt.refresh"):
                n_stale = self._refresh_stale_factors() if round_ < max_rounds - 1 else 0
            if n_stale == 0:
                break
        CB.on_smoother_update_result(self, dict(error=err))
        record_map_lag(self.submaps)
        CB.on_update_submaps(self.submaps)

    def find_overlapping_submaps(self, min_overlap: float) -> None:
        """On-demand loop factor search, distance-gated before any point
        data is touched."""
        p = self.params
        existing = set(self.matching_factors)
        centers = np.stack([T[:3, 3] for T in self.poses]) if self.poses else np.zeros((0, 3))
        pairs = []
        for i in range(len(self.submaps)):
            d = np.linalg.norm(centers[:i] - centers[i], axis=1) if i else np.zeros(0)
            pairs.extend((int(j), i) for j in np.where(d <= p.max_implicit_loop_distance)[0]
                         if (int(j), i) not in existing)
        if not pairs:
            return
        ovs = self._batch_overlaps(pairs)
        keep = [(pair, ov) for pair, ov in zip(pairs, ovs) if ov >= max(min_overlap, 0.01)]
        self._register_matching_factors_batch([pair for pair, _ in keep])
        for (j, i), ov in keep:
            logger.info("found overlapping pair %d <-> %d (%.2f)", j, i, ov)

    def recover_graph(self) -> None:
        """Graph reconstruction after corruption: re-chain non-finite poses
        from odometry, drop factors on broken data, re-create matching
        factors of factor-less submaps from fresh overlaps, and re-chain the
        submaps still isolated with odometry between factors."""
        p = self.params
        N = len(self.submaps)
        if N == 0:
            return
        for k in range(N):
            if not np.all(np.isfinite(self.poses[k])):
                if k == 0:
                    self.poses[0] = self.odom_poses[0].copy()
                else:
                    dZ = np.linalg.inv(self.odom_poses[k - 1]) @ self.odom_poses[k]
                    self.poses[k] = self.poses[k - 1] @ dZ
                self.submaps[k].T_world_origin = self.poses[k].copy()
                logger.warning("recover_graph: repaired pose of submap %d", k)

        self.matching_factors = [(t, s) for (t, s) in self.matching_factors
                                 if 0 <= t < N and 0 <= s < N and t != s]
        self.between_factors = [
            f for f in self.between_factors
            if 0 <= f[0] < N and 0 <= f[1] < N
            and np.all(np.isfinite(f[2])) and np.all(np.isfinite(f[3]))]

        degree = np.zeros(N, np.int32)
        for (i, j) in self.matching_factors:
            degree[i] += 1
            degree[j] += 1
        for (i, j, _, _) in self.between_factors:
            degree[i] += 1
            degree[j] += 1
        orphans = [k for k in range(N) if degree[k] == 0]
        existing = set(self.matching_factors)
        pairs = []
        for k in orphans:
            pk = self.poses[k][:3, 3]
            for j in range(N):
                if j == k:
                    continue
                a, b = (j, k) if j < k else (k, j)
                if (a, b) in existing or (b, a) in existing:
                    continue
                if np.linalg.norm(self.poses[j][:3, 3] - pk) <= p.max_implicit_loop_distance:
                    pairs.append((a, b))
        pairs = sorted(set(pairs))
        if pairs:
            ovs = self._batch_overlaps(pairs)
            keep = [(pair, ov) for pair, ov in zip(pairs, ovs)
                    if ov >= p.min_implicit_loop_overlap]
            self._register_matching_factors_batch([pair for pair, _ in keep])
            for (t, s), ov in keep:
                degree[t] += 1
                degree[s] += 1
                logger.info("recover_graph: matching factor %d <-> %d re-created "
                            "(overlap %.2f)", t, s, ov)

        for k in range(1, N):
            if degree[k] == 0:
                dZ = np.linalg.inv(self.odom_poses[k - 1]) @ self.odom_poses[k]
                self.between_factors.append((k - 1, k, dZ, np.eye(6) * 100.0))
                logger.warning("recover_graph: re-chained submap %d", k)
        self._new_loop_since_opt = True

    # -- output --

    def export_points(self) -> np.ndarray:
        out = []
        for sm, T in zip(self.submaps, self.poses):
            pts = to_numpy(sm.frame.points)[to_numpy(sm.frame.mask)]
            out.append((T[:3, :3] @ pts.T).T + T[:3, 3])
        return np.concatenate(out, axis=0) if out else np.zeros((0, 3))

    def save(self, path: str) -> None:
        """Write the map dump (``io/dump.py``): submaps, optimized and
        odometry poses, between and matching factors, translation priors."""
        from glim_tpu_torch.io.dump import save_dump
        save_dump(path, self.submaps, self.poses, odom_poses=self.odom_poses,
                  factors=dict(i=[f[0] for f in self.between_factors],
                               j=[f[1] for f in self.between_factors],
                               Z=[f[2] for f in self.between_factors],
                               info=[f[3] for f in self.between_factors],
                               huber=[-1.0] * len(self.between_factors),
                               matching=list(self.matching_factors),
                               translation_priors=[
                                   (i, pos.tolist(), si.tolist())
                                   for i, pos, si in self.translation_priors]))

    def load(self, path: str, session_offset: int = 0) -> None:
        """Load a dump onto this back-end's device, each cloud padded to
        the capacity of the submaps already here (their matching slices
        are stacked together). Loaded submaps are appended after the
        existing ones and their factors re-keyed; the first submap of an
        appended session becomes a gravity anchor (multi-session merge,
        reference :690-910)."""
        from glim_tpu_torch.io.dump import load_dump
        capacity = int(self.submaps[0].frame.points.shape[0]) if self.submaps else None
        submaps, poses, factors = load_dump(path, self.device, capacity)
        base = len(self.submaps)
        if base > 0 and submaps:
            self.gravity_anchors.append(base)
        for sm, T in zip(submaps, poses):
            sm.id = base + sm.id
            sm.session_id = session_offset
            self._ensure_covs(sm)
            self.submaps.append(sm)
            self.poses.append(np.asarray(T, np.float64))
            self.odom_poses.append(np.asarray(T, np.float64))
            self.voxelmaps.append(self._build_voxelmap(sm))
            self._append_match_slice(sm)
        if factors:
            for i, j, Z, info in zip(factors["i"], factors["j"], factors["Z"],
                                     factors["info"]):
                info = np.asarray(info, np.float64)
                if info.ndim == 1:       # legacy diagonal sqrt-info dumps
                    info = np.diag(info) ** 2
                self.between_factors.append((base + int(i), base + int(j),
                                             np.asarray(Z), info))
            # One batched search registers every matching factor.
            self._register_matching_factors_batch(
                [(base + int(a), base + int(b)) for a, b in factors.get("matching", [])])
            for tp in factors.get("translation_priors", []):
                self.translation_priors.append(
                    (base + int(tp[0]), np.asarray(tp[1], np.float32),
                     np.asarray(tp[2], np.float32)))
        logger.info("loaded %d submaps from %s (session offset %d)",
                    len(submaps), path, session_offset)


def _orthonormalize(T: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(T[:3, :3])
    out = np.eye(4)
    out[:3, :3] = U @ np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    out[:3, 3] = T[:3, 3]
    return out


@register_module("global_mapping", "global_mapping")
def create_global_mapping_module(config=None, device="cuda"):
    params = (GlobalMappingParams.from_config(config)
              if config is not None else GlobalMappingParams())
    return GlobalMapping(params, device=device)
