"""Trajectory evaluation: ATE / RPE with SE(3) alignment (evo equivalent).

numpy copy of ``glim_tpu/io/evaluation.py``: timestamp association,
Umeyama SE(3) alignment, ATE RMSE and RPE over configurable deltas, plus TUM
file I/O, so trajectories are evaluated offline against ground truth without
any outside tool.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from glim_tpu_torch.ops import lie_np


# ---------------------------------------------------------------- TUM I/O

def load_tum(path: str) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Read a TUM trajectory file -> (stamps (N,), poses [T_4x4]).

    Format per line: ``t x y z qx qy qz qw`` (the dump format written by
    io/dump.py, matching reference mapping/global_mapping.cpp:600-628)."""
    data = np.loadtxt(path, ndmin=2)
    stamps = data[:, 0]
    poses = []
    for row in data:
        T = np.eye(4)
        T[:3, :3] = lie_np.quat_to_rot(row[4:8])
        T[:3, 3] = row[1:4]
        poses.append(T)
    return stamps, poses


def save_tum(path: str, stamps: Sequence[float], poses: Sequence[np.ndarray]) -> None:
    with open(path, "w") as f:
        for t, T in zip(stamps, poses):
            q = lie_np.rot_to_quat(T[:3, :3])
            p = T[:3, 3]
            f.write(f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


# ------------------------------------------------------------ association

def associate(stamps_a: np.ndarray, stamps_b: np.ndarray,
              max_diff: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-stamp association (evo's default). Returns index pairs
    (i_a, i_b) with |t_a - t_b| <= max_diff, each index used at most once."""
    pairs = []
    j = 0
    used_b = set()
    for i, ta in enumerate(stamps_a):
        while j + 1 < len(stamps_b) and abs(stamps_b[j + 1] - ta) <= abs(stamps_b[j] - ta):
            j += 1
        if abs(stamps_b[j] - ta) <= max_diff and j not in used_b:
            pairs.append((i, j))
            used_b.add(j)
    return pairs


# -------------------------------------------------------------- alignment

def umeyama_alignment(est_xyz: np.ndarray, gt_xyz: np.ndarray,
                      with_scale: bool = False) -> Tuple[np.ndarray, float]:
    """SE(3) (or Sim(3)) alignment est -> gt. Returns (T_gt_est 4x4, scale)."""
    mu_e = est_xyz.mean(axis=0)
    mu_g = gt_xyz.mean(axis=0)
    E = est_xyz - mu_e
    G = gt_xyz - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E / len(E))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var_e = (E ** 2).sum() / len(E)
        s = float(np.trace(np.diag(D) @ S) / var_e) if var_e > 0 else 1.0
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = mu_g - s * R @ mu_e
    return T, s


# ---------------------------------------------------------------- metrics

@dataclass
class TrajectoryMetrics:
    ate_rmse: float
    ate_mean: float
    ate_median: float
    ate_max: float
    rot_rmse_deg: float            # rotation error after alignment
    rpe_trans: dict                # delta -> RMSE of relative translation error
    rpe_rot_deg: dict              # delta -> RMSE of relative rotation error (deg)
    n_poses: int
    length_m: float                # ground-truth path length over the overlap

    def summary(self) -> str:
        rpe = ", ".join(f"RPE@{d}m {v:.4f} m" for d, v in self.rpe_trans.items())
        return (f"ATE RMSE {self.ate_rmse:.4f} m (mean {self.ate_mean:.4f}, "
                f"max {self.ate_max:.4f}) rot {self.rot_rmse_deg:.3f} deg | "
                f"{rpe} | {self.n_poses} poses, {self.length_m:.1f} m path")


def _rot_angle_deg(R: np.ndarray) -> float:
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def evaluate_trajectory(est_poses: Sequence[np.ndarray], gt_poses: Sequence[np.ndarray],
                        align: bool = True,
                        rpe_deltas_m: Sequence[float] = (1.0, 10.0)) -> TrajectoryMetrics:
    """Full ATE + RPE evaluation on associated pose lists of equal length."""
    est = list(est_poses)
    gt = list(gt_poses)
    assert len(est) == len(gt) and len(est) >= 2
    est_xyz = np.array([T[:3, 3] for T in est])
    gt_xyz = np.array([T[:3, 3] for T in gt])

    if align and len(est) >= 3:
        T_align, _ = umeyama_alignment(est_xyz, gt_xyz)
        est = [T_align @ T for T in est]
        est_xyz = np.array([T[:3, 3] for T in est])

    err = np.linalg.norm(est_xyz - gt_xyz, axis=1)
    rot_err = np.array([_rot_angle_deg(gt[i][:3, :3].T @ est[i][:3, :3])
                        for i in range(len(est))])

    # Cumulative ground-truth path length for distance-indexed RPE.
    seg = np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])

    rpe_trans, rpe_rot = {}, {}
    for delta in rpe_deltas_m:
        dt_errs, dr_errs = [], []
        j = 0
        for i in range(len(est)):
            while j < len(est) and cum[j] - cum[i] < delta:
                j += 1
            if j >= len(est):
                break
            d_gt = np.linalg.inv(gt[i]) @ gt[j]
            d_est = np.linalg.inv(est[i]) @ est[j]
            E = np.linalg.inv(d_gt) @ d_est
            dt_errs.append(np.linalg.norm(E[:3, 3]))
            dr_errs.append(_rot_angle_deg(E[:3, :3]))
        if dt_errs:
            rpe_trans[delta] = float(np.sqrt(np.mean(np.square(dt_errs))))
            rpe_rot[delta] = float(np.sqrt(np.mean(np.square(dr_errs))))

    return TrajectoryMetrics(
        ate_rmse=float(np.sqrt(np.mean(err ** 2))),
        ate_mean=float(err.mean()),
        ate_median=float(np.median(err)),
        ate_max=float(err.max()),
        rot_rmse_deg=float(np.sqrt(np.mean(rot_err ** 2))),
        rpe_trans=rpe_trans, rpe_rot_deg=rpe_rot,
        n_poses=len(est), length_m=float(cum[-1]))


def evaluate_tum_files(est_path: str, gt_path: str, max_diff: float = 0.02,
                       align: bool = True) -> TrajectoryMetrics:
    s_e, p_e = load_tum(est_path)
    s_g, p_g = load_tum(gt_path)
    pairs = associate(s_e, s_g, max_diff)
    if len(pairs) < 2:
        raise ValueError(f"only {len(pairs)} associated poses between "
                         f"{est_path} and {gt_path} (max_diff={max_diff})")
    est = [p_e[i] for i, _ in pairs]
    gt = [p_g[j] for _, j in pairs]
    return evaluate_trajectory(est, gt, align=align)
