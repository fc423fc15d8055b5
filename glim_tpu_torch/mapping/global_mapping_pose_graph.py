"""Pose-graph global mapping back-end with loop closure.

Twin of ``glim_tpu/mapping/global_mapping_pose_graph.py`` (reference:
src/glim/mapping/global_mapping_pose_graph.cpp:251-473, params from
config/config_global_mapping_pose_graph.json) on ``device`` (the card by
default). SE3 between factors chain the submap odometry; loop candidates
are gated by travel distance and proximity with fast-forward skipping
(:305-336), evaluated on a loop-detection thread that drains a shuffled,
bounded candidate buffer (:346-473), validated by a GICP or VGICP
registration and the point inlier fraction at
``gicp_max_correspondence_dist`` (:404,417), and added as Huber-robust
between factors. The whole graph is solved by a float64 LM on the host
(``_host_linearize_graph``): its Hessian mixes a 1e6 gauge prior and
1e4-stiff odometry links with lever-arm modes of O(1) true stiffness, which
float32 assembly corrupts; the device does what it is good at, the
registrations and inlier fractions that validate the loops.

A registration is ``registration_iterations`` damped GN steps in a Python
loop; each attempt reads its pose and inlier fraction from the device once.
Every registration slice is made contiguous once, at insert
(``nn_search`` takes contiguous tensors only).

No swallowed failures: an exception in the detection thread ends it and is
re-raised from the next ``insert_submap``, ``optimize``,
``wait_for_detection`` or ``stop``; the global-registration fallback catches
only ``torch.linalg.LinAlgError`` (a degenerate solve), never a failed
kernel build or launch.
"""

from __future__ import annotations

import atexit
import random
import threading
import time
import weakref
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as CB
from glim_tpu_torch.mapping.global_mapping_base import GlobalMappingBase
from glim_tpu_torch.ops import covariance as cov_ops
from glim_tpu_torch.ops import gicp, knn, lie, lie_np, solver
from glim_tpu_torch.ops import registration as reg
from glim_tpu_torch.ops import voxelmap as vmx
from glim_tpu_torch.types import SubMap, to_numpy, upload
from glim_tpu_torch.utils import lifecycle
from glim_tpu_torch.utils.concurrent import ConcurrentVector
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.profiling import profile_scope
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("global")


@dataclass
class GlobalMappingPoseGraphParams:
    enable_optimization: bool = True
    init_pose_damping_scale: float = 1e6
    registration_type: str = "VGICP"
    min_travel_dist: float = 50.0
    max_neighbor_dist: float = 5.0
    min_inliear_fraction: float = 0.5       # (sic: the reference key's spelling)
    subsample_target: int = 10000
    gicp_max_correspondence_dist: float = 2.0
    vgicp_voxel_resolution: float = 2.0
    odom_factor_stddev: float = 1e-3
    loop_factor_stddev: float = 0.1
    loop_factor_robust_width: float = 1.0
    loop_candidate_buffer_size: int = 100
    loop_candidate_eval_per_insert: int = 2
    registration_iterations: int = 10
    voxel_capacity: int = 32768
    enable_detection_thread: bool = True
    # Below this inlier fraction, the odometry-initialized registration is
    # retried from a global registration (FPFH + RANSAC) and the better of
    # the two kept; 0 disables the retry (the reference's behaviour).
    global_registration_min_inliers: float = 0.8

    @staticmethod
    def from_config(config) -> "GlobalMappingPoseGraphParams":
        p = GlobalMappingPoseGraphParams()
        g = lambda k, d: config.param("global_mapping", k, d)
        p.enable_optimization = g("enable_optimization", True)
        p.init_pose_damping_scale = g("init_pose_damping_scale", 1e6)
        p.registration_type = g("registration_type", "VGICP")
        p.min_travel_dist = g("min_travel_dist", 50.0)
        p.max_neighbor_dist = g("max_neighbor_dist", 5.0)
        p.min_inliear_fraction = g("min_inliear_fraction", 0.5)
        p.subsample_target = int(g("subsample_target", 10000))
        p.gicp_max_correspondence_dist = g("gicp_max_correspondence_dist", 2.0)
        p.vgicp_voxel_resolution = g("vgicp_voxel_resolution", 2.0)
        p.odom_factor_stddev = g("odom_factor_stddev", 1e-3)
        p.loop_factor_stddev = g("loop_factor_stddev", 0.1)
        p.loop_factor_robust_width = g("loop_factor_robust_width", 1.0)
        p.loop_candidate_buffer_size = int(g("loop_candidate_buffer_size", 100))
        p.loop_candidate_eval_per_insert = int(g("loop_candidate_eval_per_thread", 2))
        p.enable_detection_thread = g("enable_detection_thread", True)
        p.global_registration_min_inliers = g("global_registration_min_inliers", 0.8)
        return p


def _skew_np(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _se3_adjoint(T):
    """Ad(T) for [rot, trans] tangents: exp(Ad(T) xi) = T exp(xi) T^-1."""
    R, t = T[:3, :3], T[:3, 3]
    A = np.zeros((6, 6))
    A[:3, :3] = R
    A[3:, :3] = _skew_np(t) @ R
    A[3:, 3:] = R
    return A


def _se3_ad(xi):
    """Little adjoint ad(xi) for [rot, trans] ordering."""
    w, v = xi[:3], xi[3:]
    A = np.zeros((6, 6))
    A[:3, :3] = _skew_np(w)
    A[3:, :3] = _skew_np(v)
    A[3:, 3:] = _skew_np(w)
    return A


def _se3_jr_inv(r):
    """Inverse right Jacobian of se3_log, series to second order."""
    a = _se3_ad(r)
    return np.eye(6) + 0.5 * a + (a @ a) / 12.0


def _host_linearize_graph(poses, f_i, f_j, f_Z, f_si, f_huber, prior_info: float):
    """Float64 Gauss-Newton system over all poses -> (H, b, err).

    Right-perturbation Jacobians of r = log(Z^-1 Ti^-1 Tj): dr/dxi_j =
    Jr^-1(r), dr/dxi_i = -Jr^-1(r) Ad(Tj^-1 Ti), with the series Jr^-1(r) ~
    I + ad(r)/2 + ad(r)^2/12; past 1 rad of residual rotation, central
    differences. Huber-weighted; a gauge prior on pose 0 at its current
    value and 1e-6 damping everywhere."""
    N = len(poses)
    D = N * 6
    H = np.zeros((D, D))
    b = np.zeros(D)
    err = 0.0
    for i, j, Z, si, hub in zip(f_i, f_j, f_Z, f_si, f_huber):
        Ti, Tj = poses[i], poses[j]
        rel = np.linalg.inv(Ti) @ Tj
        Z_inv = np.linalg.inv(Z)
        r0 = si * lie_np.se3_log(Z_inv @ rel)
        if np.linalg.norm(r0[:3] / si) < 1.0:
            Jr_inv = _se3_jr_inv(r0 / si)
            J_j = si * Jr_inv
            J_i = -si * (Jr_inv @ _se3_adjoint(np.linalg.inv(rel)))
            J = np.concatenate([J_i, J_j], axis=1)
        else:
            eps = 1e-6
            J = np.zeros((6, 12))

            def res(xi_i, xi_j):
                A = Ti @ lie_np.se3_exp(xi_i)
                Bp = Tj @ lie_np.se3_exp(xi_j)
                return si * lie_np.se3_log(Z_inv @ np.linalg.inv(A) @ Bp)

            for k in range(6):
                dk = np.zeros(6)
                dk[k] = eps
                J[:, k] = (res(dk, np.zeros(6)) - res(-dk, np.zeros(6))) / (2 * eps)
                J[:, 6 + k] = (res(np.zeros(6), dk) - res(np.zeros(6), -dk)) / (2 * eps)
        u = np.linalg.norm(r0)
        if hub > 0 and u > hub:
            w = hub / u
            err += hub * u - 0.5 * hub * hub
        else:
            w = 1.0
            err += 0.5 * u * u
        Hf = w * (J.T @ J)
        bf = w * (J.T @ r0)
        sl_i, sl_j = slice(i * 6, i * 6 + 6), slice(j * 6, j * 6 + 6)
        H[sl_i, sl_i] += Hf[:6, :6]
        H[sl_i, sl_j] += Hf[:6, 6:]
        H[sl_j, sl_i] += Hf[6:, :6]
        H[sl_j, sl_j] += Hf[6:, 6:]
        b[sl_i] += bf[:6]
        b[sl_j] += bf[6:]
    H[:6, :6] += np.eye(6) * prior_info
    H += np.eye(D) * 1e-6
    return H, b, err


def _register_vgicp_pair(T_init_rel, pts, covs, mask, vm, keys, iters: int):
    """Relative registration of a source slice against a target submap's
    voxel map (both in their submap-origin frames): ``iters`` damped GN
    steps on the device."""
    eye = torch.eye(4, device=T_init_rel.device)
    T = T_init_rel
    for _ in range(iters):
        s = gicp.vgicp_linearize(eye, T, pts, covs, mask, vm, keys)
        T = T @ lie.se3_exp(solver.solve_damped(s.H_ss, s.b_s, 1e-6))
    return T


def _register_gicp_pair(T_init_rel, pts, covs, mask, tgt_pts, tgt_covs, tgt_mask,
                        max_dist, iters: int):
    """GICP registration mode: nearest-neighbour correspondences against the
    target submap's slice, one ``nn_search`` a step."""
    eye = torch.eye(4, device=T_init_rel.device)
    T = T_init_rel
    for _ in range(iters):
        s = gicp.gicp_linearize(eye, T, pts, covs, mask, tgt_pts, tgt_covs, tgt_mask,
                                max_dist)
        T = T @ lie.se3_exp(solver.solve_damped(s.H_ss, s.b_s, 1e-6))
    return T


def _stop_at_exit(ref) -> None:
    det = ref()
    if det is not None:
        det.stop()


class LoopDetector:
    """The loop-detection thread (reference :94,346-473): drains a bounded,
    shuffled candidate buffer, evaluates the registrations off the insertion
    path in the device's scope, and queues accepted loops for the next
    optimize. A failed evaluation ends the thread; ``raise_failure()``
    re-raises it."""

    def __init__(self, owner: "GlobalMappingPoseGraph"):
        self.owner = owner
        self.candidates = ConcurrentVector()
        self.results = ConcurrentVector()
        self._kill = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._ended = threading.Event()
        self._buffer: list = []
        self._rng = random.Random(0)
        self.worker = lifecycle.Worker("loop_detection", self._run, owner.device)
        lifecycle.register(self)
        # A daemon thread blocked in device work at interpreter exit can
        # abort the process: stop it first.
        atexit.register(_stop_at_exit, weakref.ref(self))

    def push(self, cands) -> None:
        if cands:
            self._idle.clear()
            self.candidates.insert(cands)

    def drain(self):
        return self.results.get_all_and_clear()

    def raise_failure(self) -> None:
        """Re-raise the exception that ended the thread, if one did."""
        if self._ended.is_set():
            self.worker.join(5.0)

    def wait_idle(self, timeout: float = 600.0) -> bool:
        """Block until the queue and the buffer are drained and the last
        batch's results pushed (False after ``timeout`` s: pending candidates
        are dropped); re-raises the thread's failure."""
        deadline = time.monotonic() + timeout
        while not self._idle.wait(timeout=1.0):
            if time.monotonic() > deadline:
                logger.warning("loop detection still busy after %.0f s; pending "
                               "candidates will be dropped", timeout)
                return False
        self.raise_failure()
        return True

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the thread (the shutdown path: a failure is not raised here)."""
        self._kill.set()
        self.worker.thread.join(timeout)

    def _run(self) -> None:
        try:
            self._loop()
        finally:
            self._ended.set()
            self._idle.set()

    def _loop(self) -> None:
        p = self.owner.params
        while not self._kill.is_set():
            self._buffer.extend(self.candidates.get_all_and_clear_wait(timeout=0.1))
            if not self._buffer:
                self._idle.set()
                continue
            # Regulate the buffer: shuffle and trim (reference :407-411).
            if len(self._buffer) > p.loop_candidate_buffer_size:
                self._rng.shuffle(self._buffer)
                del self._buffer[p.loop_candidate_buffer_size:]
            batch = self._buffer[:max(p.loop_candidate_eval_per_insert, 1)]
            del self._buffer[:len(batch)]
            for tgt, src, T_init in batch:
                if self._kill.is_set():
                    break
                res = self.owner._evaluate_candidate(tgt, src, T_init)
                if res is not None:
                    self.results.push_back(res)


class GlobalMappingPoseGraph(GlobalMappingBase):
    def __init__(self, params: Optional[GlobalMappingPoseGraphParams] = None,
                 device="cuda"):
        self.params = params or GlobalMappingPoseGraphParams()
        self.device = torch.device(device)
        self.submaps: List[SubMap] = []
        self.poses: List[np.ndarray] = []          # current world estimates
        self.odom_poses: List[np.ndarray] = []     # raw odometry submap poses
        self.travel_dist: List[float] = []
        self.voxelmaps: List[vmx.GaussianVoxelMap] = []
        self._vm_keys: List[torch.Tensor] = []     # each voxel map's lookup table
        # Per-submap registration slices, about subsample_target points each
        # (reference :262-268), contiguous.
        self._sub_pts: List[torch.Tensor] = []
        self._sub_covs: List[torch.Tensor] = []
        self._sub_mask: List[torch.Tensor] = []
        self.f_i: List[int] = []
        self.f_j: List[int] = []
        self.f_Z: List[np.ndarray] = []
        self.f_info: List[np.ndarray] = []
        self.f_huber: List[float] = []
        self.candidates: List[Tuple[int, int, np.ndarray]] = []
        self.num_loops = 0
        self._looped_pairs = set()
        self._last_opt_n = 0          # poses at the last optimize
        self._last_opt_factors = 0    # factors at the last optimize
        self.defer_optimization = False
        self.loop_search_enabled = True
        # Counters (written by the thread that evaluates candidates): the
        # registration attempts (each one inlier_fraction, and under GICP
        # registration_iterations gicp_linearize, all nn_search calls) and
        # the global-registration retries among them.
        self.registrations = 0
        self.global_registrations = 0
        self.detector = LoopDetector(self) if self.params.enable_detection_thread else None

    def stop(self) -> None:
        """Stop the detection thread; re-raises its failure, if any."""
        det, self.detector = self.detector, None
        if det is not None:
            det.stop()
            det.raise_failure()

    def wait_for_detection(self, timeout: float = 600.0) -> None:
        """Block until the detection thread has drained its queue."""
        if self.detector is not None:
            self.detector.wait_idle(timeout)

    def _check_detector(self) -> None:
        if self.detector is not None:
            self.detector.raise_failure()

    def nn_search_calls(self) -> int:
        """The nn_search calls of the candidate evaluations so far."""
        p = self.params
        per = 1 + (p.registration_iterations if p.registration_type.upper() == "GICP" else 0)
        return per * self.registrations

    # -- insertion --

    def insert_submap(self, submap: SubMap) -> None:
        self._check_detector()
        with profile_scope("global/insert_submap"):
            self._insert_submap_impl(submap)

    def _insert_submap_impl(self, submap: SubMap) -> None:
        CB.on_insert_submap(submap)
        p = self.params
        i = len(self.submaps)
        T_odom = np.asarray(submap.T_world_origin, np.float64)
        if i == 0:
            T_est = T_odom
            self.travel_dist.append(0.0)
        else:
            dZ = np.linalg.inv(self.odom_poses[-1]) @ T_odom
            T_est = self.poses[-1] @ dZ
            self.travel_dist.append(self.travel_dist[-1] + float(np.linalg.norm(dZ[:3, 3])))
            self._add_factor(i - 1, i, dZ, 1.0 / p.odom_factor_stddev, -1.0)
        self.submaps.append(submap)
        self.odom_poses.append(T_odom)
        self.poses.append(T_est)

        frame = submap.frame
        if frame.covs is None:
            # Registration is Mahalanobis-weighted: without covariances every
            # candidate evaluation would be a no-op, so estimate them.
            nbr, _ = knn.knn_banded(frame.points, frame.mask, 10)
            frame.covs, _ = cov_ops.estimate_covariances(frame.points, frame.mask, nbr,
                                                          "plane")
        C = int(frame.points.shape[0])
        stride = max(1, C // max(p.subsample_target, 64))
        self._sub_pts.append(frame.points[::stride].contiguous())
        self._sub_covs.append(frame.covs[::stride].contiguous())
        self._sub_mask.append(frame.mask[::stride].contiguous())

        vm = vmx.voxelmap_insert(
            vmx.empty_gaussian_voxelmap(p.voxel_capacity, p.vgicp_voxel_resolution,
                                        self.device),
            frame.points, frame.mask, frame.covs, 0)
        self.voxelmaps.append(vm)
        self._vm_keys.append(vmx.lookup_table(vm))

        if self.loop_search_enabled:
            self._find_loop_candidates(i)
        if self.detector is not None:
            self.detector.push(self.candidates)
            self.candidates = []
            self._collect_detected_loops()
        else:
            self._eval_candidates(p.loop_candidate_eval_per_insert)
        if p.enable_optimization and not self.defer_optimization:
            self.optimize()

    # -- loop closure --

    def add_loop_candidate(self, tgt: int, src: int, T_init=None) -> None:
        """An external loop candidate, validated like the proximity ones."""
        if not (0 <= tgt < len(self.submaps) and 0 <= src < len(self.submaps)) or tgt == src:
            return
        if (tgt, src) in self._looped_pairs:
            return
        if T_init is None:
            T_init = np.linalg.inv(self.poses[tgt]) @ self.poses[src]
        cand = (tgt, src, np.asarray(T_init, np.float64))
        if self.detector is not None:
            self.detector.push([cand])
        else:
            self.candidates.append(cand)

    def add_between_factor(self, tgt: int, src: int, T_tgt_src: np.ndarray,
                           info=None) -> None:
        """A between factor with an explicit relative-pose measurement; a
        6x6 information is reduced to the sqrt of its mean diagonal."""
        if not (0 <= tgt < len(self.submaps) and 0 <= src < len(self.submaps)) or tgt == src:
            return
        if info is None:
            si = 1.0 / self.params.loop_factor_stddev
        else:
            info = np.asarray(info, np.float64)
            si = float(np.sqrt(np.mean(np.diag(info)))) if info.ndim == 2 \
                else float(np.sqrt(info))
        self._looped_pairs.add((int(tgt), int(src)))
        self._add_factor(int(tgt), int(src), np.asarray(T_tgt_src, np.float64), si,
                         self.params.loop_factor_robust_width)
        self.num_loops += 1

    def _find_loop_candidates(self, i: int) -> None:
        """Gated candidate generation with fast-forward skipping (reference
        :305-336)."""
        p = self.params
        pi = self.poses[i][:3, 3]
        j = 0
        while j < i:
            direct = np.linalg.norm(self.poses[j][:3, 3] - pi)
            if direct > p.max_neighbor_dist:
                if j != 0 and direct > p.max_neighbor_dist * 2:
                    # Skip ahead by how far away we are, at the recent
                    # average travel step.
                    left = max(0, j - 3)
                    step_avg = (self.travel_dist[j] - self.travel_dist[left]) / max(j - left, 1)
                    step = int(0.8 * direct / max(min(step_avg, 100.0), 1e-3))
                    j += 1 + min(10, step)
                else:
                    j += 1
                continue
            if self.travel_dist[i] - self.travel_dist[j] < p.min_travel_dist:
                break
            if (j, i) not in self._looped_pairs:
                self.candidates.append((j, i, np.linalg.inv(self.poses[j]) @ self.poses[i]))
            j += 1
        if len(self.candidates) > p.loop_candidate_buffer_size:
            self.candidates = self.candidates[-p.loop_candidate_buffer_size:]

    def _eval_candidates(self, budget: int) -> None:
        """Synchronous candidate evaluation (no detection thread)."""
        for _ in range(min(budget, len(self.candidates))):
            tgt, src, T_init = self.candidates.pop(0)
            res = self._evaluate_candidate(tgt, src, T_init)
            if res is not None:
                self._accept_loop(res)

    def _evaluate_candidate(self, tgt: int, src: int, T_init: np.ndarray):
        """Registration and inlier-fraction validation (reference :404-417)
        -> (tgt, src, Z, inlier fraction) or None."""
        with profile_scope("global/eval_candidate"):
            return self._evaluate_candidate_impl(tgt, src, T_init)

    def _register_from(self, tgt: int, src: int, T_init: np.ndarray) -> Tuple[np.ndarray, float]:
        """One registration attempt from T_init -> (T_rel, inlier fraction),
        read from the device at once."""
        p = self.params
        pts, covs, mask = self._sub_pts[src], self._sub_covs[src], self._sub_mask[src]
        T0 = upload(np.asarray(T_init, np.float32), self.device)
        if p.registration_type.upper() == "GICP":
            T_rel = _register_gicp_pair(T0, pts, covs, mask, self._sub_pts[tgt],
                                        self._sub_covs[tgt], self._sub_mask[tgt],
                                        p.gicp_max_correspondence_dist,
                                        p.registration_iterations)
        else:
            T_rel = _register_vgicp_pair(T0, pts, covs, mask, self.voxelmaps[tgt],
                                         self._vm_keys[tgt], p.registration_iterations)
        frac = gicp.inlier_fraction(torch.eye(4, device=self.device), T_rel, pts, mask,
                                    self._sub_pts[tgt], self._sub_mask[tgt],
                                    p.gicp_max_correspondence_dist)
        self.registrations += 1
        host = to_numpy(torch.cat([T_rel.reshape(-1), frac.reshape(1)]), np.float64)
        return host[:16].reshape(4, 4), float(host[16])

    def _global_reg_init(self, tgt: int, src: int) -> np.ndarray:
        """FPFH + RANSAC global registration between the two slices (a
        drift-independent initial guess for the retry)."""
        def feats(k):
            pts, mask = self._sub_pts[k], self._sub_mask[k]
            nbr, _ = knn.knn_self(pts, mask, 10)
            _, normals = cov_ops.estimate_covariances(pts, mask, nbr, "plane")
            return pts, mask, reg.estimate_fpfh(pts, normals, mask, k=20)
        sp, sm_, sf = feats(src)
        tp, tm, tf = feats(tgt)
        res, _ = reg.estimate_pose_ransac(sp, sf, sm_, tp, tf, tm)
        return to_numpy(res.T_target_source, np.float64)

    def _evaluate_candidate_impl(self, tgt: int, src: int, T_init: np.ndarray):
        p = self.params
        T_rel, frac = self._register_from(tgt, src, T_init)
        if 0 < p.global_registration_min_inliers and frac < p.global_registration_min_inliers:
            # After meters of drift the odometry guess may lie outside the
            # true basin: retry from a drift-independent global guess and
            # keep the better-matching alignment.
            try:
                T0 = self._global_reg_init(tgt, src)
            except torch.linalg.LinAlgError as e:
                logger.warning("global registration of %d->%d: degenerate solve (%s)",
                               tgt, src, e)
                T0 = None
            if T0 is not None and np.all(np.isfinite(T0)):
                self.global_registrations += 1
                T_g, frac_g = self._register_from(tgt, src, T0)
                if frac_g > frac:
                    logger.info("loop %d->%d re-based on global registration (inliers "
                                "%.2f -> %.2f)", tgt, src, frac, frac_g)
                    T_rel, frac = T_g, frac_g
        if frac < p.min_inliear_fraction or not np.all(np.isfinite(T_rel)):
            logger.debug("loop %d->%d rejected (inliers %.2f)", tgt, src, frac)
            return None
        return (tgt, src, T_rel, frac)

    def _accept_loop(self, res) -> None:
        tgt, src, Z, frac = res
        if (tgt, src) in self._looped_pairs:
            return
        self._looped_pairs.add((tgt, src))
        p = self.params
        self._add_factor(tgt, src, Z, 1.0 / p.loop_factor_stddev, p.loop_factor_robust_width)
        self.num_loops += 1
        logger.info("loop factor %d->%d accepted (inliers %.2f)", tgt, src, frac)

    def _collect_detected_loops(self) -> None:
        if self.detector is not None:
            for res in self.detector.drain():
                self._accept_loop(res)

    def _add_factor(self, i: int, j: int, Z: np.ndarray, info: float, huber: float):
        self.f_i.append(i)
        self.f_j.append(j)
        self.f_Z.append(np.asarray(Z, np.float64))
        self.f_info.append(np.full(6, info))
        self.f_huber.append(huber)

    # -- optimization --

    def needs_optimize(self) -> bool:
        """Anything new since the last optimize (submaps, factors, loops
        waiting to be collected)? Never, with optimization disabled."""
        if not self.params.enable_optimization:
            return False
        if len(self.poses) > self._last_opt_n or len(self.f_i) > self._last_opt_factors:
            return True
        return self.detector is not None and self.detector.results.size() > 0

    def optimize(self) -> None:
        self._check_detector()
        with profile_scope("global/optimize"):
            self._optimize_impl()

    def _optimize_impl(self) -> None:
        self._collect_detected_loops()
        p = self.params
        N = len(self.poses)
        self._last_opt_n = N
        self._last_opt_factors = len(self.f_i)
        if N < 2 or not self.f_i:
            return
        poses = [np.asarray(T, np.float64).copy() for T in self.poses]
        f_i, f_j = list(self.f_i), list(self.f_j)
        f_Z = [np.asarray(Z, np.float64) for Z in self.f_Z]
        f_si = [float(info[0]) for info in self.f_info]
        f_hub = list(self.f_huber)

        def linearize(x):
            return _host_linearize_graph(x, f_i, f_j, f_Z, f_si, f_hub,
                                         p.init_pose_damping_scale)

        CB.on_smoother_update(self, None, None)
        # Float64 LM on the host: at steady state it ends after 1-3
        # iterations; a fresh loop on a drifted chain takes ~10-20.
        H, b, err = linearize(poses)
        lam = 1e-6
        for it in range(50):
            A = H + np.diag(lam * np.diag(H) + 1e-9)
            try:
                delta = np.linalg.solve(A, -b)
            except np.linalg.LinAlgError:
                delta = np.linalg.lstsq(A, -b, rcond=None)[0]
            d6 = delta.reshape(N, 6)
            trial = [T @ lie_np.se3_exp(d) for T, d in zip(poses, d6)]
            H_new, b_new, err_new = linearize(trial)
            if err_new < err:
                rel = (err - err_new) / max(err, 1e-12)
                poses, H, b, err = trial, H_new, b_new, err_new
                lam = max(lam / 10.0, 1e-10)
                rot_n = float(np.max(np.linalg.norm(d6[:, :3], axis=1)))
                tr_n = float(np.max(np.linalg.norm(d6[:, 3:], axis=1)))
                if (rot_n < 1e-5 and tr_n < 1e-5) or rel < 1e-8:
                    break
            else:
                lam = min(lam * 10.0, 1e6)
                if lam >= 1e6:
                    break
        CB.on_smoother_update_result(self, dict(error=float(err), iterations=it + 1))

        new_poses = np.stack(poses)
        if not np.all(np.isfinite(new_poses)):
            logger.error("pose-graph optimize produced non-finite poses; keeping the "
                         "previous estimates")
            return
        for k in range(N):
            self.poses[k] = _orthonormalize(new_poses[k])
            self.submaps[k].T_world_origin = self.poses[k].copy()
        CB.on_update_submaps(self.submaps)

    # -- output --

    def export_points(self) -> np.ndarray:
        out = []
        for sm, T in zip(self.submaps, self.poses):
            pts = to_numpy(sm.frame.points)[to_numpy(sm.frame.mask)]
            out.append((T[:3, :3] @ pts.T).T + T[:3, 3])
        return np.concatenate(out, axis=0) if out else np.zeros((0, 3))

    def save(self, path: str) -> None:
        """Write the map dump (``io/dump.py``): submaps, optimized and
        odometry poses, and the between factors with their (6,) sqrt
        information rows and Huber widths."""
        from glim_tpu_torch.io.dump import save_dump
        save_dump(path, self.submaps, self.poses, odom_poses=self.odom_poses,
                  factors=dict(i=self.f_i, j=self.f_j, Z=self.f_Z, info=self.f_info,
                               huber=self.f_huber))


def _orthonormalize(T: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(T[:3, :3])
    out = np.eye(4)
    out[:3, :3] = U @ np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    out[:3, 3] = T[:3, 3]
    return out


@register_module("global_mapping", "global_mapping_pose_graph")
def create_global_mapping_pose_graph_module(config=None, device="cuda"):
    """libglobal_mapping_pose_graph.so."""
    params = (GlobalMappingPoseGraphParams.from_config(config) if config is not None
              else GlobalMappingPoseGraphParams())
    return GlobalMappingPoseGraph(params, device=device)
