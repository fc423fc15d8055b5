"""Global-mapping back-end on a drifting ring: scaling and loop closure.

Twin of ``glim_tpu/tools/backend_stress.py``: the same numpy ring (same
seed, same generator calls, so the same submaps and the same drifted
odometry) through the port's ``GlobalMapping`` (``run``) or
``GlobalMappingPoseGraph`` (``run_pose_graph``) on a ``device``. Each
submap observes the structured blocks within sensor range; neighbouring
submaps share structure, and the lap's end closes on its start.

Usage:
    python -m glim_tpu_torch.tools.backend_stress --n 128 [--interval 4] [--device cuda]
        [--backend matching|pose_graph]

Prints one JSON row per checkpoint (16, 32, 64, 128, ... submaps): submaps,
factors, mean insert and optimize wall (host clock up to a device sync)
and the ATE so far (the matching back-end also its steady optimize, the
pose graph its loops); then the pre- and post-closure ATE (the pose graph
also the detection thread's drain).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from glim_tpu_torch.mapping.global_mapping import GlobalMapping, GlobalMappingParams
from glim_tpu_torch.mapping.global_mapping_pose_graph import (GlobalMappingPoseGraph,
                                                              GlobalMappingPoseGraphParams)
from glim_tpu_torch.ops import lie_np
from glim_tpu_torch.types import PointBatch, SubMap, upload


def ring_world(rng: np.random.Generator, radius: float, n_blocks: int):
    """Structured blocks (two walls + pillars each) around a ring."""
    pts = []
    for k in range(n_blocks):
        ang = 2 * np.pi * k / n_blocks + rng.uniform(-0.1, 0.1)
        cx, cy = radius * np.cos(ang), radius * np.sin(ang)
        yaw = rng.uniform(0, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        for _ in range(2):  # two walls per block
            off = rng.uniform(-6, 6, 2)
            u = rng.uniform(-4, 4, 120)
            z = rng.uniform(0, 4, 120)
            wall = np.stack([u * c - off[0] * s, u * s + off[0] * c, z], 1)
            wall[:, 0] += cx + off[1] * s
            wall[:, 1] += cy + off[1] * c
            pts.append(wall)
            yaw += np.pi / 2  # perpendicular second wall
            c, s = np.cos(yaw), np.sin(yaw)
        for _ in range(3):  # pillars
            p0 = np.array([cx, cy]) + rng.uniform(-8, 8, 2)
            z = rng.uniform(0, 4, 40)
            pts.append(np.stack([np.full(40, p0[0]) + rng.normal(0, 0.05, 40),
                                 np.full(40, p0[1]) + rng.normal(0, 0.05, 40),
                                 z], 1))
    return np.concatenate(pts)


def make_submap(rng, sid, world, T_true, device, sensor_range=20.0, cap=2048):
    """The submap that sees ``world`` from ``T_true``, its cloud on
    ``device``; without covariances (GlobalMapping estimates them from kNN
    neighbourhoods, as for any covariance-less submap)."""
    d = np.linalg.norm(world[:, :2] - T_true[:2, 3], axis=1)
    vis = world[d < sensor_range]
    if len(vis) > cap:
        vis = vis[rng.choice(len(vis), cap, replace=False)]
    Ti = np.linalg.inv(T_true)
    local = (Ti[:3, :3] @ vis.T).T + Ti[:3, 3]
    pts = np.zeros((cap, 3), np.float32)
    pts[:len(local)] = local + rng.normal(0, 0.005, local.shape)
    mask = np.zeros(cap, bool)
    mask[:len(local)] = True
    return SubMap(id=sid, T_world_origin=np.eye(4),
                  frame=PointBatch(points=upload(pts, device), mask=upload(mask, device),
                                   covs=None))


def _ring_pose(k, n, radius):
    ang = 2 * np.pi * k / n
    T = np.eye(4)
    T[:2, 3] = radius * np.cos(ang), radius * np.sin(ang)
    yaw = ang + np.pi / 2
    T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    return T


def _true_xy(i, n, radius):
    ang = 2 * np.pi * i / n
    return np.array([radius * np.cos(ang), radius * np.sin(ang)])


def _ate(poses, n, radius):
    errs = [float(np.linalg.norm(np.asarray(poses[i])[:2, 3] - _true_xy(i, n, radius)))
            for i in range(len(poses))]
    return float(np.sqrt(np.mean(np.square(errs))))


def run(n_submaps: int, interval: int, seed: int = 5, step: float = 6.0,
        drift_rot: float = 2e-4, drift_trans: float = 3e-3, device="cuda",
        on_insert=None, quiet: bool = False):
    """The ring of ``n_submaps`` through GlobalMapping on ``device`` with the
    JAX stress tool's settings; returns the checkpoint rows, the last with
    the pre- and post-closure ATE. ``on_insert(k, gm)`` runs before insert
    k."""
    import logging
    logging.getLogger("glim_tpu_torch.global").setLevel(logging.WARNING)
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(seed)
    radius = n_submaps * step / (2 * np.pi)
    world = ring_world(rng, radius, max(n_submaps // 2, 8))

    gm = GlobalMapping(GlobalMappingParams(
        submap_voxel_resolution=0.5, voxel_capacity=16384,
        min_implicit_loop_overlap=0.15, max_implicit_loop_distance=40.0,
        optimization_interval_submaps=interval), device=dev)
    opt_s = []
    optimize = gm.optimize

    def timed_optimize():
        sync()
        t = time.perf_counter()
        optimize()
        sync()
        opt_s.append(time.perf_counter() - t)
    gm.optimize = timed_optimize

    drift = lie_np.se3_exp(np.array([0, 0, drift_rot, drift_trans, 0, 0.2 * drift_trans]))
    T_true_prev = None
    T_odom = np.eye(4)
    odom_inputs: list = []
    checkpoints = {16, 32, 64, 128, 256, 512}
    ins_times, opt_times = [], []
    rows = []
    for k in range(n_submaps):
        T_true = _ring_pose(k, n_submaps, radius)
        T_odom = T_true if T_true_prev is None else \
            T_odom @ np.linalg.inv(T_true_prev) @ T_true @ drift
        T_true_prev = T_true

        odom_inputs.append(T_odom.copy())
        sm = make_submap(rng, k, world, T_true, dev)
        sm.T_world_origin = T_odom
        if on_insert is not None:
            on_insert(k, gm)
        n_opt = len(opt_s)
        sync()
        t0 = time.perf_counter()
        gm.insert_submap(sm)
        sync()
        # Insert wall without the optimize it triggered.
        ins_times.append(time.perf_counter() - t0 - sum(opt_s[n_opt:]))
        opt_times.extend(opt_s[n_opt:])
        if (k + 1) in checkpoints or k == n_submaps - 1:
            row = dict(submaps=k + 1, factors=len(gm.matching_factors),
                       insert_mean_ms=1e3 * float(np.mean(ins_times)),
                       optimize_mean_ms=(1e3 * float(np.mean(opt_times))
                                         if opt_times else None),
                       optimize_last_ms=1e3 * opt_times[-1] if opt_times else None,
                       ate_rmse_m=_ate(gm.poses, n_submaps, radius))
            # Steady-state optimize at this map size: the median of three
            # forced optimizes (as the JAX tool does; they converge the
            # graph a little further).
            n_opt = len(opt_s)
            for _ in range(3):
                gm.optimize()
            row["optimize_steady_ms"] = 1e3 * sorted(opt_s[n_opt:])[1]
            rows.append(row)
            if not quiet:
                print(json.dumps(row))
            ins_times, opt_times = [], []

    # Final checkpoint: pre-closure drift against post-closure quality.
    gm.find_overlapping_submaps(0.15)
    n_opt = len(opt_s)
    gm.optimize()
    rows[-1]["final_optimize_ms"] = 1e3 * opt_s[n_opt]
    rows[-1]["ate_pre_closure_m"] = _ate(odom_inputs, n_submaps, radius)
    rows[-1]["ate_post_closure_m"] = _ate(gm.poses, n_submaps, radius)
    if not quiet:
        print(json.dumps({k: rows[-1][k] for k in ("submaps", "factors", "ate_pre_closure_m",
                                                   "ate_post_closure_m",
                                                   "final_optimize_ms")}))
    gm.optimize = optimize
    return rows, gm


def run_pose_graph(n_submaps: int, interval: int = 4, seed: int = 5, step: float = 6.0,
                   drift_rot: float = 2e-4, drift_trans: float = 3e-3, device="cuda",
                   quiet: bool = False):
    """The ring of ``n_submaps`` through GlobalMappingPoseGraph on ``device``
    with the JAX tool's settings: the detection thread evaluates proximity
    candidates (4 an insert) while submaps stream in, an optimize every
    ``interval`` inserts. Returns the checkpoint rows, the last with the
    loops, the detection drain and the pre- and post-closure ATE, and the
    back-end (stopped)."""
    import logging
    logging.getLogger("glim_tpu_torch.global").setLevel(logging.WARNING)
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(seed)
    radius = n_submaps * step / (2 * np.pi)
    world = ring_world(rng, radius, max(n_submaps // 2, 8))

    gm = GlobalMappingPoseGraph(GlobalMappingPoseGraphParams(
        vgicp_voxel_resolution=1.0, voxel_capacity=16384, subsample_target=2048,
        # The drifted lap comes back ~2 m off course: candidates within 12 m,
        # validated by the registration's inliers.
        max_neighbor_dist=12.0, min_travel_dist=40.0, loop_candidate_eval_per_insert=4),
        device=dev)
    drift = lie_np.se3_exp(np.array([0, 0, drift_rot, drift_trans, 0, 0.2 * drift_trans]))
    T_true_prev = None
    T_odom = np.eye(4)
    odom_inputs: list = []
    checkpoints = {16, 32, 64, 128, 256, 512}
    ins_times, opt_times = [], []
    rows = []
    gm.defer_optimization = True
    for k in range(n_submaps):
        T_true = _ring_pose(k, n_submaps, radius)
        T_odom = T_true if T_true_prev is None else \
            T_odom @ np.linalg.inv(T_true_prev) @ T_true @ drift
        T_true_prev = T_true
        odom_inputs.append(T_odom.copy())
        sm = make_submap(rng, k, world, T_true, dev)
        sm.T_world_origin = T_odom
        sync()
        t0 = time.perf_counter()
        gm.insert_submap(sm)
        sync()
        ins_times.append(time.perf_counter() - t0)
        if (k + 1) % interval == 0 or k == n_submaps - 1:
            t1 = time.perf_counter()
            gm.optimize()
            opt_times.append(time.perf_counter() - t1)
        if (k + 1) in checkpoints or k == n_submaps - 1:
            rows.append(dict(
                submaps=k + 1, factors=len(gm.f_i), loops=gm.num_loops,
                insert_mean_ms=1e3 * float(np.mean(ins_times)),
                optimize_mean_ms=1e3 * float(np.mean(opt_times)) if opt_times else None,
                optimize_last_ms=1e3 * opt_times[-1] if opt_times else None,
                ate_rmse_m=_ate(gm.poses, n_submaps, radius)))
            if not quiet:
                print(json.dumps(rows[-1]))
            ins_times, opt_times = [], []

    # End of sequence: let the detection thread drain, then the final solve.
    t0 = time.perf_counter()
    gm.wait_for_detection(timeout=600.0)
    drain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gm.optimize()
    rows[-1].update(final_optimize_ms=1e3 * (time.perf_counter() - t0), detect_drain_s=drain_s,
                    loops=gm.num_loops,
                    ate_pre_closure_m=_ate(odom_inputs, n_submaps, radius),
                    ate_post_closure_m=_ate(gm.poses, n_submaps, radius))
    gm.stop()
    if not quiet:
        print(json.dumps({k: rows[-1][k] for k in (
            "submaps", "loops", "ate_pre_closure_m", "ate_post_closure_m",
            "final_optimize_ms", "detect_drain_s")}))
    return rows, gm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--interval", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="matching", choices=("matching", "pose_graph"))
    ap.add_argument("--json", default=None, help="write the checkpoint rows to this file")
    args = ap.parse_args()
    fn = run if args.backend == "matching" else run_pose_graph
    rows, _ = fn(args.n, args.interval, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f)


if __name__ == "__main__":
    main()
