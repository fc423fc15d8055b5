"""Interactive map-correction tools (headless API).

Twin of ``glim_tpu/viewer/interactive_tools.py`` (reference:
src/glim/viewer/interactive/manual_loop_close_modal.cpp:9-64, FPFH +
RANSAC / GNC global registration + GICP refinement producing a between
factor; bundle_adjustment_modal.cpp:6-60, plane / point
eigenvalue-minimization bundle adjustment over selected regions). The
math runs on the submaps' device.

``ManualLoopClose.align`` calls ``nn_search`` (the CUDA kernel on CUDA
tensors) through ``gicp_linearize`` once at the start of each of its three
coarse-to-fine LM passes and once a trial step, then once for the inlier
fraction and once for the final information:
sum over the passes of (1 + trial steps) + 2. The FPFH descriptors are
computed only when a global registration needs them (no ``T_init``).
The evm factors' Jacobians are ``torch.func.jacfwd`` in float64 under
``ops/lie.forward_ad_lock``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.func import jacfwd

from glim_tpu_torch.ops import covariance as cov_ops
from glim_tpu_torch.ops import gicp, knn, lie, solver
from glim_tpu_torch.ops import registration as reg
from glim_tpu_torch.types import SubMap, to_numpy, upload
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("interactive")


@dataclass
class ManualLoopCloseResult:
    T_target_source: np.ndarray
    inlier_fraction: float
    method: str
    # 6x6 information of the aligned pair: the GICP Hessian at the refined
    # pose (the reference's BetweenFactor noise model,
    # manual_loop_close_modal.cpp:562-574).
    information: Optional[np.ndarray] = None
    # Trial steps of each coarse-to-fine LM pass.
    lm_trial_steps: tuple = ()


class ManualLoopClose:
    """Align two submaps: global registration (RANSAC or GNC over FPFH
    correspondences) unless an initial guess is given, then a
    coarse-to-fine GICP refinement -> a between factor candidate."""

    def __init__(self, fpfh_k: int = 20, refine_iterations: int = 15,
                 max_correspondence_distance: float = 1.0):
        self.fpfh_k = fpfh_k
        self.refine_iterations = refine_iterations
        self.max_corr = max_correspondence_distance

    def _features(self, sm: SubMap, fpfh: bool):
        pts, mask = sm.frame.points, sm.frame.mask
        nbr, _ = knn.knn_self(pts, mask, 10)
        covs, normals = cov_ops.estimate_covariances(pts, mask, nbr, "plane")
        feat = reg.estimate_fpfh(pts, normals, mask, k=self.fpfh_k) if fpfh else None
        return pts, mask, covs, feat

    def align(self, target: SubMap, source: SubMap, method: str = "RANSAC",
              T_init: Optional[np.ndarray] = None) -> ManualLoopCloseResult:
        glob = T_init is None
        tp, tm, tc, tf = self._features(target, glob)
        sp, sm_, sc, sf = self._features(source, glob)
        dev = sp.device

        if glob:
            if method.upper() == "GNC":
                res, _ = reg.estimate_pose_gnc(sp, sf, sm_, tp, tf, tm)
            else:
                res, _ = reg.estimate_pose_ransac(sp, sf, sm_, tp, tf, tm)
            T_cur = res.T_target_source.to(torch.float32)
        else:
            T_cur = upload(np.asarray(T_init, np.float32), dev)

        # Coarse-to-fine GICP refinement (the modal's final ICP stage; the
        # coarse passes recover the meters-scale in-plane error descriptor
        # matching leaves on feature-poor planar scenes).
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        steps = []
        for corr_dist in (4.0 * self.max_corr, 2.0 * self.max_corr, self.max_corr):
            def linearize(T, _d=corr_dist):
                s = gicp.gicp_linearize(eye, T, sp, sc, sm_, tp, tc, tm, _d)
                return s.H_ss, s.b_s, s.error

            lm = solver.lm_optimize(linearize, lambda T, d: T @ lie.se3_exp(d), T_cur,
                                    solver.TerminationCriteria(
                                        max_iterations=self.refine_iterations))
            T_cur = lm.x
            steps.append(len(lm.statuses))
        frac = gicp.inlier_fraction(eye, T_cur, sp, sm_, tp, tm, self.max_corr)
        # Information = the GICP Hessian at the refined pose.
        s_fin = gicp.gicp_linearize(eye, T_cur, sp, sc, sm_, tp, tc, tm, self.max_corr)
        host = to_numpy(torch.cat([T_cur.reshape(-1), frac.reshape(1),
                                   s_fin.H_ss.reshape(-1)]), np.float64)
        frac = float(host[16])
        logger.info("manual loop close (%s): inliers %.2f", method, frac)
        return ManualLoopCloseResult(T_target_source=host[:16].reshape(4, 4),
                                     inlier_fraction=frac, method=method,
                                     information=host[17:].reshape(6, 6),
                                     lm_trial_steps=tuple(steps))


@dataclass
class PlaneSelection:
    """Points selected from one submap for bundle adjustment."""

    submap_index: int
    points: np.ndarray   # (M, 3) in the submap origin frame


def _world_all(xi: torch.Tensor, poses: torch.Tensor, pts: List[torch.Tensor],
               idx: List[int]) -> torch.Tensor:
    N = poses.shape[0]
    Ts = poses @ lie.se3_exp(xi.reshape(N, 6))
    return torch.cat([p @ Ts[i][:3, :3].T + Ts[i][:3, 3] for p, i in zip(pts, idx)], dim=0)


def _evm_system(resid, poses: torch.Tensor):
    """(error, H (N*6, N*6), b) of the residual function at xi = 0, its
    Jacobian by forward-mode AD in float64, returned in float32."""
    zero = torch.zeros(poses.shape[0] * 6, dtype=torch.float64, device=poses.device)
    with lie.forward_ad_lock:
        J = jacfwd(resid)(zero)
    r = resid(zero)
    J, r = J.float(), r.float()
    return torch.sum(r * r), J.T @ J, J.T @ r


def plane_evm_factor(selections: Sequence[PlaneSelection], poses: torch.Tensor):
    """Eigenvalue-minimization plane factor over selected regions
    (gtsam_points::PlaneEVMFactor role): error = smallest eigenvalue of the
    scatter of the world-frame selected points. Linearized as the per-point
    point-to-plane residual r_k = n.(p_k - mean) / sqrt(P) with the normal n
    frozen at the current iterate (sum r_k^2 = lambda_min exactly). Returns
    (error, H (N*6, N*6), b)."""
    P64 = poses.double()
    pts = [upload(np.asarray(s.points, np.float64), poses.device) for s in selections]
    idx = [s.submap_index for s in selections]
    zero = torch.zeros(poses.shape[0] * 6, dtype=torch.float64, device=poses.device)
    allp = _world_all(zero, P64, pts, idx)
    d0 = allp - allp.mean(dim=0)
    S = d0.T @ d0 / allp.shape[0]
    n = torch.linalg.eigh(S)[1][:, 0]
    scale = 1.0 / math.sqrt(allp.shape[0])

    def resid(xi):
        ap = _world_all(xi, P64, pts, idx)
        return (ap - ap.mean(dim=0)) @ n * scale

    return _evm_system(resid, poses)


def point_evm_factor(selections: Sequence[PlaneSelection], poses: torch.Tensor):
    """Point eigenvalue-minimization factor: error = the trace of the
    world-frame scatter (zero when every selection collapses onto one
    point), linearized per point as its 3-vector deviation from the mean."""
    P64 = poses.double()
    pts = [upload(np.asarray(s.points, np.float64), poses.device) for s in selections]
    idx = [s.submap_index for s in selections]
    count = sum(len(s.points) for s in selections)
    scale = 1.0 / math.sqrt(count)

    def resid(xi):
        ap = _world_all(xi, P64, pts, idx)
        return ((ap - ap.mean(dim=0)) * scale).reshape(-1)

    return _evm_system(resid, poses)


class BundleAdjustment:
    """Plane / point-constraint bundle adjustment over selected regions
    (reference BundleAdjustmentModal role)."""

    def __init__(self, iterations: int = 10, weight: float = 1e4):
        self.iterations = iterations
        self.weight = weight

    def optimize(self, submaps: List[SubMap], poses: List[np.ndarray],
                 plane_selections: Sequence[Sequence[PlaneSelection]],
                 mode: str = "plane", device="cuda") -> List[np.ndarray]:
        """Refine submap poses so each selection group becomes coplanar
        (mode="plane") or coincident (mode="point"). Gauge: pose 0 fixed."""
        N = len(poses)
        D = N * 6
        dev = torch.device(device)
        x = upload(np.stack(poses).astype(np.float32), dev)
        factor = plane_evm_factor if mode == "plane" else point_evm_factor
        gauge = torch.zeros(D, D, dtype=torch.float32, device=dev)
        gauge[:6, :6] = torch.eye(6, device=dev) * 1e8

        def linearize(x):
            H = torch.eye(D, dtype=torch.float32, device=dev) * 1e-6
            b = torch.zeros(D, dtype=torch.float32, device=dev)
            err = torch.zeros((), dtype=torch.float32, device=dev)
            for group in plane_selections:
                r, Hg, bg = factor(group, x)
                H = H + self.weight * Hg
                b = b + self.weight * bg
                err = err + self.weight * r
            return H + gauge, b, err

        res = solver.lm_optimize(linearize, lambda x, d: x @ lie.se3_exp(d.reshape(N, 6)), x,
                                 solver.TerminationCriteria(max_iterations=self.iterations))
        return list(to_numpy(res.x, np.float64))
