"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                   # the smoke run below
    python3 chip_smoke.py --nn-v1 SRC       # ... with phase 3's A/B against SRC
    python3 chip_smoke.py --profile [DIR]   # profiles of three configurations
    python3 chip_smoke.py --eval [OUT]      # the port's full run_eval to OUT
    python3 chip_smoke.py --debug-backend   # debug_backend over city_loop's 47 s lap
    python3 chip_smoke.py --loop-submaps OUT.npz   # ... saving phase 11b's submap clouds

Phases (any failure exits non-zero):
  1. print the card (name and power limit as nvidia-smi reports them) and
     the software versions;
  2. build the nn_search CUDA kernel from glim_tpu_torch/csrc and hold it
     against its plain PyTorch version at every caller's shape (NN_CHECKS:
     16384 and 4096 queries against 131072 targets, ~30% masked; the
     global back-end's between refinement, 4096 queries against 4096
     targets of merged submap clouds, ~5% masked; CT's iVox model, 16384
     queries against its 65536-point model, ~30% masked; sub-mapping's
     between information, Q = N = 16384 with ~39% of each side masked; the
     pose graph's inlier fraction, Q = N = 10923 with ~24% masked, and its
     ring, Q = N = 2048; the manual loop closure's align, Q = N = 65536,
     the default submaps' capacity, all valid; phase 13a's sharded GICP,
     Q = 2048 a shard against 131072, ~30% masked), a ragged case, the duplicate-target cases (the
     lowest index must win: across the split boundary that the launch
     geometry picks at each caller's shape, and inside one thread's
     register-tiled query rows) and a Q=4096 set with one valid target;
  3. time kernel and plain version at the callers' nine shapes with CUDA
     events, in turns (plain, kernel, kernel, plain), each beside its bound
     (valid pairs x 8 flops over the FP32 peak; bytes over the memory rate)
     and its share of it, then the host time to enqueue a call (and, at
     Q=16384, the SM clock nvidia-smi reads during 4000 calls). ``--nn-v1
     SRC`` also builds the one-thread-per-query kernel of the first port
     from SRC (its C interface) and times it in the same turns (plain, v1,
     kernel, kernel, v1, plain);
  4. drive the GICP LiDAR-IMU slice through GlimTorch on the card:
     config_odometry_cpu.json at its defaults, then sub-mapping, then the
     reference's CPU back-end config_global_mapping_cpu.json (matching
     factors and GICP-refined between factors, 6 nn_search calls a submap
     after the first), 150 synthetic scans of 65,536 points with 200 Hz
     IMU; check the kernel launches of the odometry and of the between
     refinement, one between factor a submap after the first, finite poses
     and the ATE bound;
  5. drive the default configuration through GlimTorch on the card, with no
     config edits (odometry_estimation_gpu: VGICP keyframe maps, then
     sub_mapping, then global_mapping: implicit-loop VGICP factors over two
     voxel-map levels, solved by global_gn): 150 synthetic scans of 65,536
     points at 10 Hz with 200 Hz IMU; check finite poses, the ATE bound,
     submaps that hold every frame that reached sub-mapping, at least one
     optimize, matching factors >= submaps - 1 and the submap-origin ATE
     (each optimized T_world_origin against the ground truth at its anchor
     frame, frames[N // 2]) under 0.08 m. This path runs no hand-written
     kernel;
  5b. the same configuration and sequence (first 80 scans) with one edit,
     keyframe_max_overlap 1.0, so that every frame becomes an odometry
     keyframe and, past the 15 kept, every insert evicts one: the keyframe
     manager's full-size eviction (the K x K x C overlap lookup, the model
     rebuild, the host read of the scores); phase 5's odometry and
     sub-mapping checks, and at least one eviction;
  5c. the JAX stress tool's drifting ring, 128 submaps of 2048 points (seed
     5, voxel_capacity 16384, two levels, optimize every 4 submaps), through
     the port's GlobalMapping on the card (glim_tpu_torch/tools/
     backend_stress.py): loop closure at a scale a 150-scan sequence never
     reaches; check the pre-closure ATE (1.9974 m +- 1e-3: the same numpy
     ring as the JAX tool's) and a post-closure ATE under 0.03 m, and print
     insert and optimize ms at the 16/32/64/128 checkpoints;
  5d. the same ring through the port's GlobalMappingPoseGraph
     (backend_stress.run_pose_graph: the loop-detection thread evaluating 4
     candidates an insert, an optimize every 4): the pre-closure ATE as in
     5c, a post-closure ATE no worse than 1.1 x the JAX record's 0.6493 m,
     a loop, and nn_search launches equal to the registrations counted;
  6. the asynchronous pipeline through the port's offline runner: phase
     5's sequence written as a dataset directory (scans/, times/, imu.csv,
     stamps.csv) in a temporary directory, played by
     glim_tpu_torch.tools.glim_runner.main (GlimTorch's default async
     pipeline with workload backpressure, wait(), save(dump)) on the card;
     check that every scan from the first estimate on has one, phase 5's
     estimate and submap counts, every frame that reached sub-mapping in a
     submap, the ATE bounds, at least one optimize and the dump's layout;
     load the dump into a fresh GlobalMapping on the card (same submaps,
     poses to 1e-9, factors, export_points count) and again as a second
     session (twice the submaps, one gravity anchor, one optimize); print
     async against sync scans/s, each worker's busy host ms a scan, the
     largest queue depths, the drain, dump write / load seconds and MiB;
     then the GICP slice asynchronously for 60 scans, whose nn_search
     launches (from the odometry and the global worker threads) must equal
     5 x window steps + 6 x between refinements;
  7. the shipped configurations the port gained, each through GlimTorch on
     phase 5's sequence (its first 100 scans of 65,536 points, 200 Hz IMU)
     with the default sub-mapping and global mapping unless named: (a)
     config_odometry_ct.json unedited (the vgicp model, no hand kernel),
     (b) the same with model_type ivox, (c) config_odometry_cpu.json with
     registration_type VGICP, (d) config_odometry_cpu.json with enable_imu
     false (LiDAR-only GICP), (e) the default configuration with
     config_sub_mapping_passthrough.json; each checks finite poses, its
     module's JAX ATE bound (CT 0.2 m, VGICP LiDAR-IMU 0.12 m, LiDAR-only
     0.15 m, the default odometry 0.08 m), submaps that hold every frame
     that reached sub-mapping (pass-through: its keyframes past the
     displacement gate), an optimize, the submap-origin ATE under 0.08 m
     and the exact nn_search launch count (expected_launches: 4 a step and
     a replayed bootstrap step for (b) and (d), none for the others, plus 6
     a between refinement), and prints scans/s, ATE, launches and peak
     memory;
  8. the port's run_eval (glim_tpu_torch/tools/run_eval.py) on
     figure8_room at its full 20 s (200 raycast scans, the flagship row):
     the odometry ATE within 10% (or 2 mm) of EVAL.md's 0.0138 m;
  9. the pose-graph configuration through GlimTorch (sync): the default
     configuration with config_global_mapping_pose_graph.json and
     sub-mapping's enable_optimization and create_between_factors, 120
     scans of 65,536 points on a 10 m circle at 0.6 rad/s (1.15 laps, 72 m
     of travel); checks finite poses, the odometry and submap-origin ATE
     bounds (0.08 m), every frame that reached sub-mapping in a submap, a
     refinement of every submap with two keyframes, a loop, an optimize
     and the exact nn_search count (one a between information, one a
     registration), and prints scans/s, refinement ms and host syncs a
     submap, loops and peak memory;
  11. the extension surface, async, at full width: (a) phase 5's run with
     gnss_global (1 Hz fixes of the ground truth in an ENU frame at a yaw
     of 0.7 rad and an offset of (100, -50, 2) m, N(0, 0.05^2) noise),
     velocity_suppressor, imu_validator, memory_monitor and
     standard_viewer (streaming to a file named in config_viewer): the
     alignment, one translation prior in the graph a prior sent, velocity
     regulation set once, the card's memory read, every stream line under
     the JAX schema, ok() throughout, phase 5's bounds; (b) phase 9's
     configuration and circle with the ScanContext and image loop
     detectors (one image a scan from a bank keyed by the heading): every
     loop request serviced, phase 9's bounds and the exact nn_search count
     (the detectors' candidates are registrations), each detector's device
     ms a submap; (c) the runner over phase 5's first LIVE_SCANS scans with
     --viewer-stream and --commands, a helper thread appending pause,
     loop_close, bundle_adjust, factors, status, set_enabled, step and
     resume once the stream's factor layer shows three submaps in the
     graph: each result, the between
     factors in the graph, align's exact nn_search count (sum over its
     three LM passes of 1 + trial steps, + 2), the dump loaded back;
  12. the ROS front end and the offline tools: (a) phase 6's 150 scans
     written as a rosbag2 .db3 (PointCloud2 of float32 x/y/z/t, Imu in
     g-units) and played by ``glim_runner BAG``: every scan fed, acc_scale
     detected as 9.80665, the ATE bound and within 10% or 2 mm of phase
     6's ATE, every frame in a submap, read + decode ms a scan; (b) the
     first 100 scans as messages through GlimROSNode on a fake node, async,
     with librviz_viewer.so and libimu_validator.so, spin_once after each
     scan: an odometry message for every scan from the first estimate on,
     the last at the last estimate's pose to 1e-6 m, the TF pairs, the
     aligned cloud as wide as its frame's valid points, a map message, the
     published poses' ATE bound; (c) on (a)'s dump: ``offline_viewer open
     --optimize --ply --save`` (the PLY holds export_points' count),
     ``merge DUMP DUMP`` (twice the submaps, sessions 0 / 1, cross-session
     matching factors, no kernel launch), ``interactive_viewer --exec
     "loop_close 0 2" --exec optimize`` (align at Q = N = 65,536 with
     exactly sum (1 + trial steps) + 2 nn_search launches), the map
     editor's outlier selection over the whole map against a cKDTree
     reference (Jaccard >= 0.999, its ms and peak memory), min-cut and
     region-growing selections within 3 m of a floor point (at most 16,384
     candidates) that grow beyond it, against the CPU editor (Jaccard >=
     0.99), the CLI's min-cut selection (10 m, the first 16,384
     candidates) against the CPU editor's (Jaccard >= 0.99), and
     ``map_editor --select-object --save`` loaded back with exactly the
     deleted points gone;
  13. the device mesh and the last two tools: (a) on a mesh of 8 entries
     of cuda:0 (JAX's tests' 8 virtual devices), sharded_vgicp_linearize
     and sharded_gicp_linearize at the GICP odometry's shape (16,384
     source points a call, 2,048 a shard, against 131,072 targets) and
     sharded_factor_linearize over 8 factors (4,096 points, 65,536-voxel
     maps) against the unsharded calls (rtol 1e-4, atol 1e-2, equal
     inliers; tests/test_parallel.py's tolerance), exactly 8 nn_search
     launches a sharded GICP call, sharded_odometry_step converged (< 0.1
     m), then tools/multichip_check's backend_parity_check (the 64-submap
     ring, >= 300 factors, max pose delta < 5e-4) on that mesh and on
     every visible card's; (b) tools/debug_backend's capture of city_loop
     (6 s: 60 raycast scans at 32 x 512) and its sweep of no_opt,
     default and between: finite poses, the global ATE under 0.08 m, and
     6 nn_search launches a between refinement, one a submap after the
     first; (c) tools/profile_e2e at its defaults (two passes of 100
     scans of 20,000 points, async): finite scans/s with and without the
     drain, the three workers' spans, the drain table;
  14. print the kernel summary JSON and, last, the device JSON.

``--profile`` runs phase 5's configuration for 100 scans: host-clock time
over scans 60-79 (the 48-state window is full and sub-mapping busy from
about scan 58), one ``torch.profiler`` window over scans 80-89 and one
``torch.cuda.set_sync_debug_mode("warn")`` count over scans 90-94; it
writes the tables to DIR/profile_default.txt (DIR defaults to build/).
It then does the same for phase 5b's eviction run (DIR/profile_evict.txt)
and for phase 4's GICP slice (DIR/profile_gicp.txt), profiles the ring
of phase 5c (DIR/profile_ring.txt: host and device ms, launches and host
syncs per insert and per optimize) and phase 6's async pipeline
(DIR/profile_async.txt: the spans the profiler records from the worker
threads, and the device's busy share).

``--ab-async PARENT_DIR`` runs phases 6 and 11a (``run_async_default``,
``run_extensions`` and their checks) of the tree in PARENT_DIR (a ``git
archive`` of another commit, with its own chip_smoke.py) and of this one,
each in a process of its own, parent / change / change / parent, and
prints a line of scans/s and ATEs for each run.

``--debug-backend`` runs phase 13b over city_loop's whole 47 s lap and
sweeps all seven back-end configurations; it is not part of the default
smoke.

``--eval [OUT]`` runs the port's full run_eval (the five sequences,
city_loop at 47 s, the registry matrix with its pose-graph rows and the
window study) on the card and writes it to OUT (default
build/EVAL_TORCH.md); it is not part of the default smoke.

``run_slice``, ``run_default``, ``run_ring``, ``run_pose_graph_ring``,
``run_async_default``, ``run_shipped``, ``run_pose_graph_config``,
``run_extensions``, ``run_loop_detectors``, ``run_live_corrections``,
``run_bag``, ``run_ros_node``, ``run_offline_tools``, ``run_mesh``,
``run_debug_backend`` and ``run_profile_e2e`` are importable and
run on any device (the CPU tests rehearse them at a tiny
size); ``main`` requires a CUDA device.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter

import numpy as np
import torch

ATE_BOUND = 0.12          # m; the JAX package's bound for the GICP module
DEFAULT_ATE_BOUND = 0.08  # m; the JAX package's bound for the VGICP module
SUBMAP_ATE_BOUND = 0.08   # m; optimized submap origins against ground truth
# Phase 5c: the JAX stress tool's 128-submap ring (bench.py, BENCH_r05.json).
RING_SUBMAPS = 128
RING_PRE_ATE = 1.9974     # m, the drifted odometry fed to the back-end
RING_PRE_TOL = 1e-3
RING_POST_BOUND = 0.03    # m; the JAX back-end reached 0.0219 m
RING_JAX_FACTORS = 627
# Phase 5b: every frame a keyframe, so every insert past the 15 kept evicts.
EVICT_OVERRIDES = [("config_odometry", "odometry_estimation", "keyframe_max_overlap", 1.0)]
EVICT_SCANS = 80
REL_TOL = 1e-4            # nn_search d2 tolerance: REL_TOL * max(1, d2)
MAX_WORKLOAD = 10         # async feed: queued frames before the feeder waits
# Phase 6: the async runner at full size, then the GICP slice asynchronously.
ASYNC_GICP_SCANS = 60
POSE_LOAD_TOL = 1e-9      # loaded poses against the dumped ones
DUMP_FILES = ("graph.txt", "graph.npz", "graph.bin", "values.bin", "odom_lidar.txt",
              "odom_imu.txt", "traj_lidar.txt", "traj_imu.txt", "config/config.json",
              "000000/data.txt", "000000/imu_rate.txt", "000000/points_compact.bin",
              "000000/covs_compact.bin")


_SEQUENCES = {}    # generator arguments but the length -> (scans, the sequence)


def _sequence(n_scans, n_scan_points, scene_points, seed, **kw):
    """A synthetic sequence at 10 Hz scans / 200 Hz IMU with no IMU noise
    (``kw``: generate_sequence's trajectory arguments). The generator draws
    scan by scan, and the IMU rows are the analytic kinematics, so a shorter
    sequence is a prefix of a longer one with the same arguments: each is
    made once a process, at the longest length asked, and a copy of its
    first ``n_scans`` scans returned (the smoke generated ~1,700 scans of
    65,536 points before, ~1.5 min of host time)."""
    import copy

    from glim_tpu_torch.io.synthetic import SyntheticSequence, generate_sequence
    key = (n_scan_points, scene_points, seed, tuple(sorted(kw.items())))
    if n_scans > _SEQUENCES.get(key, (0, None))[0]:
        _SEQUENCES[key] = n_scans, generate_sequence(
            duration=n_scans / 10.0, scan_hz=10.0, imu_hz=200.0, n_scan_points=n_scan_points,
            scene_points=scene_points, noise=0.01, seed=seed, **kw)
    seq = _SEQUENCES[key][1]
    n = int(n_scans / 10.0 * 10.0)                # generate_sequence's own counts
    n_imu = int(n_scans / 10.0 * 200.0) + 1
    return copy.deepcopy(SyntheticSequence(
        scans=seq.scans[:n], imu=seq.imu[:n_imu], gt_poses=seq.gt_poses[:n],
        stamps=seq.stamps[:n], T_lidar_imu=seq.T_lidar_imu, landmarks=seq.landmarks))


def submap_origin_ate(submaps, seq):
    """ATE of the submaps' (optimized) T_world_origin against the ground
    truth at each submap's anchor frame, frames[N // 2] (sub_mapping.py
    anchors the origin there), aligned as ``ate_rmse`` aligns; None for
    fewer than 3 submaps, which fix no alignment."""
    from glim_tpu_torch.io.synthetic import ate_rmse
    if len(submaps) < 3:
        return None
    gt = [seq.gt_poses[int(round(s.frames[len(s.frames) // 2].stamp * 10.0))]
          for s in submaps]
    return ate_rmse([s.T_world_origin for s in submaps], gt, align=True)


def _release_pipelines() -> None:
    """Drop the callback observers of earlier runs in this process (they
    hold those runs' pipelines, whose device memory would otherwise count
    in the next run's peak) and collect the pipelines."""
    import gc

    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()
    gc.collect()


def _timed_run(glim, seq, dev, on_scan=None) -> dict:
    """Feed ``seq`` through ``glim`` and flush it, timed on the host clock up
    to a device sync; the nn_search launch count is zeroed just before and
    read just after (the launches inside the global back-end's between
    refinement are also counted on their own). Returns the metrics every
    configuration reports."""
    from glim_tpu_torch.io.synthetic import ate_rmse
    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks
    from glim_tpu_torch.ops.nn_search import nn_search

    gm = glim.global_backend
    counts = dict(optimizes=0, between_launches=0)
    refine = getattr(gm, "_gicp_refine_between", None)     # the matching back-end's

    def counted_refine(*args):
        n0 = nn_search.kernel_launches
        out = refine(*args)
        counts["between_launches"] += nn_search.kernel_launches - n0
        return out

    def on_result(*_):
        counts["optimizes"] += 1

    # The async pipeline launches from two threads at once: a difference of
    # the shared count would mix them, so only the total is kept there.
    count_between = refine is not None and not glim.async_mode
    if count_between:
        gm._gicp_refine_between = counted_refine
    handle = GlobalMappingCallbacks.on_smoother_update_result.add(on_result)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    nn_search.kernel_launches = 0
    t0 = time.perf_counter()
    _feed(glim, seq, on_scan)
    glim.wait()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = nn_search.kernel_launches
    GlobalMappingCallbacks.on_smoother_update_result.remove(handle)
    if count_between:
        del gm._gicp_refine_between

    ests = glim.odometry_estimates
    window = getattr(_odometry(glim), "window", None)
    poses = [e.T_world_lidar for e in ests]
    gt = [seq.gt_poses[int(round(e.stamp * 10.0))] for e in ests]
    subs = glim.submaps
    return dict(
        scans=len(seq.scans), estimates=len(ests),
        window_steps=int(window.step) if window is not None else 0,
        seconds=seconds, scans_per_s=len(seq.scans) / seconds,
        max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        kernel_launches=launches,
        poses_finite=bool(all(np.all(np.isfinite(T)) for T in poses)),
        ate=ate_rmse(poses, gt, align=True),
        submaps=len(subs), optimizes=counts["optimizes"],
        matching_factors=len(getattr(gm, "matching_factors", ())),
        between_factors=len(getattr(gm, "between_factors", ())),
        between_refinements=getattr(gm, "between_refinements", 0),
        between_launches=counts["between_launches"] if count_between else None,
        submap_origins_finite=bool(all(np.all(np.isfinite(s.T_world_origin)) for s in subs)),
        submap_ate=submap_origin_ate(subs, seq))


def run_slice(device, n_scans: int = 150, n_scan_points: int = 65536,
              scene_points: int = 400000, seed: int = 0,
              odometry_overrides=None, preprocess_overrides=None,
              sub_mapping_overrides=None, on_scan=None, async_mode=False) -> dict:
    """Run GlimTorch (sync, or async with ``async_mode``;
    config_odometry_cpu.json with the reference's CPU back-end,
    config_global_mapping_cpu.json) over a synthetic sequence at 10 Hz
    scans / 200 Hz IMU; returns the run's metrics. ``on_scan(i)`` runs
    before scan i."""
    from glim_tpu_torch.pipeline import GlimTorch

    _release_pipelines()
    dev = torch.device(device)
    cfg_dir = config_dir(
        [("config", "global", "config_odometry", "config_odometry_cpu.json"),
         ("config", "global", "config_global_mapping", "config_global_mapping_cpu.json")]
        + [(logical, module, k, v) for logical, module, values in (
            ("config_odometry", "odometry_estimation", odometry_overrides),
            ("config_preprocess", "preprocess", preprocess_overrides),
            ("config_sub_mapping", "sub_mapping", sub_mapping_overrides))
           for k, v in (values or {}).items()])
    seq = _sequence(n_scans, n_scan_points, scene_points, seed)
    glim = GlimTorch(cfg_dir, async_mode=async_mode, device=dev)
    return _timed_run(glim, seq, dev, on_scan)


def check_slice(res: dict, name: str = "GICP slice", min_window_steps: int = 100) -> None:
    """Phase 4's failure conditions: nn_search launched for every window
    lookup and 6 times in every between refinement (the counts are 0 on the
    CPU, where the plain version runs), one GICP-refined between factor a
    submap after the first, finite poses and the ATE bound."""
    on_card = res["max_memory_allocated"] is not None
    want = 5 * res["window_steps"] + 6 * res["between_refinements"]
    if res["between_launches"] is None:      # async: the total, exactly
        if on_card and res["kernel_launches"] != want:
            raise AssertionError(f"{name}: {res['kernel_launches']} nn_search launches, "
                                 f"want {want} (5 x {res['window_steps']} window steps + 6 x "
                                 f"{res['between_refinements']} between refinements)")
    elif on_card and (res["kernel_launches"] < want
                      or res["between_launches"] != 6 * res["between_refinements"]):
        raise AssertionError(
            f"{name}: {res['kernel_launches']} nn_search launches ({res['between_launches']} "
            f"in the between refinement), want >= {want} (6 x {res['between_refinements']})")
    if res["window_steps"] < min_window_steps:
        raise AssertionError(f"{name}: {res['window_steps']} window steps")
    if res["submaps"] < 2 or res["between_refinements"] != res["submaps"] - 1 \
            or res["between_factors"] < res["submaps"] - 1:
        raise AssertionError(
            f"{name}: {res['submaps']} submaps, {res['between_refinements']} between "
            f"refinements, {res['between_factors']} between factors")
    if not (res["poses_finite"] and res["submap_origins_finite"]):
        raise AssertionError(f"{name}: non-finite poses")
    if not res["ate"] < ATE_BOUND:
        raise AssertionError(f"{name}: ATE {res['ate']:.4f} m >= {ATE_BOUND} m")


def _feed(glim, seq, on_scan=None):
    """All scans with their IMU (up to 0.12 s past each scan stamp),
    waiting while an async pipeline's workload exceeds MAX_WORKLOAD (the
    runner's default); ``on_scan(i)`` runs before scan i is inserted."""
    imu_i = 0
    for i, raw in enumerate(seq.scans):
        if on_scan is not None:
            on_scan(i)
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.12:
            glim.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
            imu_i += 1
        glim.insert_frame(raw)
        while glim.workload() > MAX_WORKLOAD:
            time.sleep(0.01)


def _odometry(glim):
    """The odometry module itself (inside its async wrapper)."""
    return glim.odometry.odometry if glim.async_mode else glim.odometry


def run_default(device, n_scans: int = 150, n_scan_points: int = 65536,
                scene_points: int = 400000, seed: int = 0, overrides=None,
                on_scan=None, async_mode=False) -> dict:
    """Run GlimTorch (sync, or async with ``async_mode``) on the default
    config directory, unedited but for ``overrides`` ((config, module,
    name, value) tuples: the CPU rehearsal's sizes, phase 5b's keyframe
    edit), over a synthetic sequence at 10 Hz scans / 200 Hz IMU; returns
    the run's metrics. ``on_scan(i)`` runs before scan i."""
    from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir

    _release_pipelines()
    dev = torch.device(device)
    cfg_dir = create_default_config_dir(tempfile.mkdtemp(prefix="glim_smoke_default_"))
    seq = _sequence(n_scans, n_scan_points, scene_points, seed)
    glim = GlimTorch(cfg_dir, async_mode=async_mode, device=dev, overrides=overrides)
    to_sub = []
    SubMappingCallbacks.on_insert_frame.add(lambda f: to_sub.append(f.id))
    res = _timed_run(glim, seq, dev, on_scan)

    kfm = _odometry(glim).keyframes
    subs = glim.submaps
    res.update(
        kf_inserts=kfm.next_order, kf_evictions=kfm.next_order - kfm.count,
        submaps=len(subs), frames_per_submap=[len(s.frames) for s in subs],
        submap_frames_total=sum(len(s.frames) for s in subs),
        frames_to_sub_mapping=len(to_sub),
        submap_points=[int(s.frame.mask.sum()) for s in subs],
        submap_device=subs[0].frame.points.device.type if subs else None)
    return res


def check_default(res: dict, name: str = "default configuration",
                  min_evictions: int = 0, global_mapping: bool = True) -> None:
    """The default phase's failure conditions (phase 5b also needs
    ``min_evictions`` odometry keyframe evictions, and leaves out the
    global-mapping checks with ``global_mapping=False``)."""
    if not res["poses_finite"]:
        raise AssertionError(f"{name}: non-finite poses")
    if not res["ate"] < DEFAULT_ATE_BOUND:
        raise AssertionError(f"{name}: ATE {res['ate']:.4f} m >= {DEFAULT_ATE_BOUND} m")
    if res["submaps"] < 1:
        raise AssertionError(f"{name}: no submap was created")
    if res["submap_frames_total"] != res["frames_to_sub_mapping"]:
        raise AssertionError(
            f"{name}: the submaps hold {res['submap_frames_total']} "
            f"frames, {res['frames_to_sub_mapping']} reached sub-mapping")
    if res["kf_evictions"] < min_evictions:
        raise AssertionError(f"{name}: {res['kf_evictions']} odometry keyframe "
                             f"evictions, {min_evictions} needed")
    if not global_mapping:
        return
    if res["submaps"] >= 2 and res["optimizes"] < 1:
        raise AssertionError(f"{name}: global mapping never optimized")
    if res["matching_factors"] < res["submaps"] - 1:
        raise AssertionError(f"{name}: {res['matching_factors']} matching factors for "
                             f"{res['submaps']} submaps")
    if not res["submap_origins_finite"]:
        raise AssertionError(f"{name}: non-finite submap origins")
    if res["submap_ate"] is None or not res["submap_ate"] < SUBMAP_ATE_BOUND:
        raise AssertionError(f"{name}: submap-origin ATE {res['submap_ate']} m for "
                             f"{res['submaps']} submaps, want under {SUBMAP_ATE_BOUND} m")


def run_ring(device, n_submaps: int = RING_SUBMAPS, interval: int = 4,
             on_insert=None) -> dict:
    """Phase 5c: the JAX stress tool's drifting ring through the port's
    GlobalMapping on ``device`` (glim_tpu_torch/tools/backend_stress.py);
    returns its checkpoint rows and the final factor count and ATEs."""
    from glim_tpu_torch.tools import backend_stress

    dev = torch.device(device)
    t0 = time.perf_counter()
    rows, gm = backend_stress.run(n_submaps, interval, device=dev, on_insert=on_insert,
                                  quiet=True)
    last = rows[-1]
    return dict(submaps=n_submaps, factors=last["factors"],
                factors_after_sweep=len(gm.matching_factors), rows=rows,
                seconds=time.perf_counter() - t0,
                ate_pre_closure_m=last["ate_pre_closure_m"],
                ate_post_closure_m=last["ate_post_closure_m"],
                poses_finite=bool(all(np.all(np.isfinite(T)) for T in gm.poses)))


def check_ring(res: dict, pre_ate: float = RING_PRE_ATE) -> None:
    """Phase 5c's failure conditions: the pre-closure ATE of the JAX ring
    (so the generator's copy made the same ring) and loop closure."""
    if abs(res["ate_pre_closure_m"] - pre_ate) > RING_PRE_TOL:
        raise AssertionError(f"ring: pre-closure ATE {res['ate_pre_closure_m']:.6f} m, "
                             f"the JAX ring's is {pre_ate} m")
    if not (res["poses_finite"] and res["ate_post_closure_m"] < RING_POST_BOUND):
        raise AssertionError(f"ring: post-closure ATE {res['ate_post_closure_m']:.6f} m "
                             f">= {RING_POST_BOUND} m or non-finite poses")


def config_dir(overrides=None, prefix: str = "glim_smoke_") -> str:
    """A default config directory with ``overrides`` ((config, module,
    name, value) tuples, applied in order; "config" is config.json) written
    into its files."""
    from glim_tpu_torch.utils.config import create_default_config_dir

    cfg_dir = create_default_config_dir(tempfile.mkdtemp(prefix=prefix))
    for logical, module, name, value in overrides or []:
        # config.json maps the logical names to files (an override may remap).
        with open(os.path.join(cfg_dir, "config.json")) as f:
            files = json.load(f)["global"]
        path = os.path.join(cfg_dir, files.get(logical, logical + ".json"))
        with open(path) as f:
            cfg = json.load(f)
        cfg.setdefault(module, {})[name] = value
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2)
    return cfg_dir


def _dir_mib(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs) / 2**20


def run_async_default(device, n_scans: int = 150, n_scan_points: int = 65536,
                      scene_points: int = 400000, seed: int = 0, overrides=None,
                      work_dir=None) -> dict:
    """Phase 6: phase 5's sequence written as a dataset directory, played by
    the port's runner (``tools/glim_runner.main``: GlimTorch's default
    async pipeline, workload backpressure, ``wait()``, ``save(dump)``) on
    ``device``; then the dump loaded into a fresh GlobalMapping on
    ``device``, and again as a second session, optimized once. The dataset
    and the dump live in a temporary directory under ``work_dir``, removed
    at the end. Returns the run's metrics."""
    import shutil

    from glim_tpu_torch.io.synthetic import ate_rmse
    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks, SubMappingCallbacks
    from glim_tpu_torch.mapping.global_mapping import GlobalMapping
    from glim_tpu_torch.tools import glim_runner
    from glim_tpu_torch.utils import profiling

    _release_pipelines()
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    seq = _sequence(n_scans, n_scan_points, scene_points, seed)
    tmp = tempfile.mkdtemp(prefix="glim_smoke_async_", dir=work_dir)
    try:
        data, dump = os.path.join(tmp, "dataset"), os.path.join(tmp, "dump")
        glim_runner.save_dataset(data, seq.imu, [(s.stamp, s.points, s.times)
                                                 for s in seq.scans])
        data_mib = _dir_mib(data)
        to_sub, optimizes = [], []
        SubMappingCallbacks.on_insert_frame.add(lambda f: to_sub.append(f.id))
        handle = GlobalMappingCallbacks.on_smoother_update_result.add(
            lambda *_: optimizes.append(1))
        profiling.report(reset=True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        run = glim_runner.main([data, "--dump", dump, "--device", str(dev),
                                "--config", config_dir(overrides, "glim_smoke_async_cfg_")])
        sync()
        stats = profiling.report()
        GlobalMappingCallbacks.on_smoother_update_result.remove(handle)
        glim = run["glim"]
        gm = glim.global_backend
        ests = glim.odometry_estimates
        poses = [e.T_world_lidar for e in ests]
        gt = [seq.gt_poses[int(round(e.stamp * 10.0))] for e in ests]
        subs = gm.submaps
        busy = {k: stats[k]["total_s"] * 1e3 / n_scans if k in stats else 0.0
                for k in ("preprocess", "odometry", "sub_mapping", "global_mapping")}
        res = dict(
            scans=n_scans, estimates=len(ests), estimate_ids=[e.id for e in ests],
            estimate_stamps_are_the_last_scans=[e.stamp for e in ests]
            == [s.stamp for s in seq.scans[len(seq.scans) - len(ests):]],
            seconds=run["seconds"], scans_per_s=n_scans / run["seconds"],
            wait_seconds=run["wait_seconds"], dump_write_seconds=run["save_seconds"],
            dataset_mib=data_mib, dump_mib=_dir_mib(dump),
            busy_host_ms_per_scan=busy,
            max_queue_depth=dict(
                odometry=glim.odometry.input_frame_queue.high_water,
                sub_mapping=glim.sub_mapping.input_frame_queue.high_water,
                global_mapping=glim.global_mapping.input_submap_queue.high_water),
            max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            poses_finite=bool(all(np.all(np.isfinite(T)) for T in poses)),
            ate=ate_rmse(poses, gt, align=True), submaps=len(subs),
            frames_per_submap=[len(s.frames) for s in subs],
            submap_frames_total=sum(len(s.frames) for s in subs),
            frames_to_sub_mapping=len(to_sub), optimizes=len(optimizes),
            matching_factors=len(gm.matching_factors),
            submap_origins_finite=bool(all(np.all(np.isfinite(s.T_world_origin))
                                           for s in subs)),
            submap_ate=submap_origin_ate(subs, seq),
            submap_device=subs[0].frame.points.device.type if subs else None,
            dump_missing=[f for f in DUMP_FILES if not os.path.exists(os.path.join(dump, f))])

        # The dump into a fresh back-end on the device, then a second session.
        fresh = GlobalMapping(gm.params, device=dev)
        sync()
        t0 = time.perf_counter()
        fresh.load(dump)
        sync()
        res["dump_load_seconds"] = time.perf_counter() - t0
        saved = np.load(os.path.join(dump, "graph.npz"))["poses"]
        res.update(
            loaded_submaps=len(fresh.submaps), loaded_ids_equal=[s.id for s in fresh.submaps]
            == [s.id for s in subs],
            loaded_pose_err=float(max(np.abs(a - b).max() for a, b in zip(fresh.poses, saved)))
            if fresh.poses else None,
            loaded_factors_equal=fresh.matching_factors == gm.matching_factors,
            export_points=len(gm.export_points()),
            loaded_export_points=len(fresh.export_points()))
        fresh.load(dump, session_offset=1)
        merged_opts = []
        handle = GlobalMappingCallbacks.on_smoother_update_result.add(
            lambda *_: merged_opts.append(1))
        fresh.optimize()
        sync()
        GlobalMappingCallbacks.on_smoother_update_result.remove(handle)
        res.update(merged_submaps=len(fresh.submaps), gravity_anchors=list(fresh.gravity_anchors),
                   merged_optimizes=len(merged_opts),
                   merged_poses_finite=bool(all(np.all(np.isfinite(T)) for T in fresh.poses)))
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_async(res: dict, sync: dict = None, name: str = "async runner") -> None:
    """Phase 6's failure conditions: every scan from the first estimate on
    has one (the sync run's estimate ids and submap count, when given),
    every frame that reached sub-mapping lies in a submap, the ATE bounds,
    at least one optimize, the dump's reference layout, and the dump loaded
    back (same submaps, poses to POSE_LOAD_TOL, the same factors and
    export_points count; a second session: twice the submaps, one gravity
    anchor, one optimize)."""
    if not (res["poses_finite"] and res["estimate_stamps_are_the_last_scans"]):
        raise AssertionError(f"{name}: non-finite poses or scans without an estimate")
    if res["estimate_ids"] != list(range(res["estimates"])) or (
            sync is not None and res["estimates"] != sync["estimates"]):
        raise AssertionError(f"{name}: {res['estimates']} estimates, ids not consecutive "
                             f"or the sync run's {sync and sync['estimates']}")
    if sync is not None and res["submaps"] != sync["submaps"]:
        raise AssertionError(f"{name}: {res['submaps']} submaps, the sync run {sync['submaps']}")
    if res["submaps"] < 2 or res["submap_frames_total"] != res["frames_to_sub_mapping"]:
        raise AssertionError(f"{name}: {res['submaps']} submaps holding "
                             f"{res['submap_frames_total']} frames, "
                             f"{res['frames_to_sub_mapping']} reached sub-mapping")
    if not res["ate"] < DEFAULT_ATE_BOUND:
        raise AssertionError(f"{name}: ATE {res['ate']:.4f} m >= {DEFAULT_ATE_BOUND} m")
    if not (res["submap_origins_finite"] and res["submap_ate"] is not None
            and res["submap_ate"] < SUBMAP_ATE_BOUND):
        raise AssertionError(f"{name}: submap-origin ATE {res['submap_ate']} m")
    if res["optimizes"] < 1:
        raise AssertionError(f"{name}: global mapping never optimized")
    if res["dump_missing"]:
        raise AssertionError(f"{name}: the dump lacks {res['dump_missing']}")
    n = res["submaps"]
    if not (res["loaded_submaps"] == n and res["loaded_ids_equal"]
            and res["loaded_pose_err"] <= POSE_LOAD_TOL and res["loaded_factors_equal"]
            and res["loaded_export_points"] == res["export_points"]):
        raise AssertionError(f"{name}: the dump loaded back differs: " + json.dumps(
            {k: res[k] for k in ("loaded_submaps", "loaded_ids_equal", "loaded_pose_err",
                                 "loaded_factors_equal", "export_points",
                                 "loaded_export_points")}))
    if not (res["merged_submaps"] == 2 * n and res["gravity_anchors"] == [n]
            and res["merged_optimizes"] == 1 and res["merged_poses_finite"]):
        raise AssertionError(f"{name}: second session: {res['merged_submaps']} submaps, "
                             f"anchors {res['gravity_anchors']}, "
                             f"{res['merged_optimizes']} optimizes")


def _print_async(res: dict, sync: dict, card: str) -> None:
    print("async: " + json.dumps({k: v for k, v in res.items() if k != "estimate_ids"}))
    busy = res["busy_host_ms_per_scan"]
    print(f"async [{card}]: {res['scans']} scans in {res['seconds']:.3f} s = "
          f"{res['scans_per_s']:.4f} scans/s through the runner (sync phase 5 in this call: "
          f"{sync['scans_per_s']:.4f}), wait() drained for {res['wait_seconds']:.3f} s")
    print(f"async [{card}]: busy host ms a scan: preprocess (feeder) {busy['preprocess']:.2f}, "
          f"odometry worker {busy['odometry']:.2f}, sub-mapping worker "
          f"{busy['sub_mapping']:.2f}, global worker {busy['global_mapping']:.2f}; largest "
          f"queue depths {res['max_queue_depth']}")
    print(f"async [{card}]: {res['optimizes']} optimizes, {res['submaps']} submaps "
          f"(sync {sync['submaps']}), {res['estimates']} estimates (sync {sync['estimates']}), "
          f"ATE {res['ate']:.4f} m, submap-origin ATE {res['submap_ate']} m, max memory "
          f"{res['max_memory_allocated'] / 2**20:.1f} MiB")
    print(f"async [{card}]: dump {res['dump_mib']:.2f} MiB written in "
          f"{res['dump_write_seconds']:.3f} s, loaded in {res['dump_load_seconds']:.3f} s "
          f"(pose error {res['loaded_pose_err']}, {res['loaded_export_points']} points); "
          f"second session {res['merged_submaps']} submaps, anchors {res['gravity_anchors']}, "
          f"{res['merged_optimizes']} optimize; dataset {res['dataset_mib']:.1f} MiB")


# Phase 7: the shipped configurations besides the default, through GlimTorch
# on phase 5's sequence: name -> (config edits, odometry ATE bound in m, the
# JAX test that sets the bound).
CT_ATE_BOUND = 0.2            # tests/test_odometry_ct.py
LIDAR_ONLY_ATE_BOUND = 0.15   # tests/test_odometry_e2e.py
SHIPPED_SCANS = 100          # not 150: the host sets the pace, and 1.3-2.1x spreads (PERF.md) must fit 1200 s
_CT = [("config", "global", "config_odometry", "config_odometry_ct.json")]
_CPU = [("config", "global", "config_odometry", "config_odometry_cpu.json")]
SHIPPED = {
    "ct": (_CT, CT_ATE_BOUND),
    "ct_ivox": (_CT + [("config_odometry", "odometry_estimation", "model_type", "ivox")],
                CT_ATE_BOUND),
    "cpu_vgicp": (_CPU + [("config_odometry", "odometry_estimation", "registration_type",
                           "VGICP")], ATE_BOUND),
    "lidar_only": (_CPU + [("config_odometry", "odometry_estimation", "enable_imu", False)],
                   LIDAR_ONLY_ATE_BOUND),
    "passthrough": ([("config", "global", "config_sub_mapping",
                      "config_sub_mapping_passthrough.json")], DEFAULT_ATE_BOUND),
}
# Phase 8: the port's run_eval on figure8_room against EVAL.md's flagship row.
EVAL_FIGURE8_ATE = 0.0138     # m
EVAL_REL, EVAL_ABS = 0.10, 0.002


def expected_launches(odom, between_refinements: int) -> int:
    """nn_search launches of a run: n_outer a step for CT with the ivox
    model and for the LiDAR-only GICP odometry (their steps and the
    bootstrap replay's), none for the VGICP paths, and 6 a between
    refinement of the global back-end."""
    from glim_tpu_torch.odometry.odometry_estimation_cpu import OdometryEstimationCPU
    from glim_tpu_torch.odometry.odometry_estimation_ct import OdometryEstimationCT

    p = odom.params
    per_step = 0
    if isinstance(odom, OdometryEstimationCT) and odom.model_kind == "ivox":
        per_step = max(1, p.lm_max_iterations // 2) + (4 if p.rigid_refine else 0)
    elif isinstance(odom, OdometryEstimationCPU) and not odom.use_vgicp:
        per_step = max(1, p.max_iterations // 2)
    steps = 0
    if per_step:
        if p.bootstrap_refine not in ("replay", "off"):
            raise ValueError(f"no launch count for bootstrap_refine {p.bootstrap_refine!r}")
        replayed = (p.bootstrap_frames if p.bootstrap_refine == "replay"
                    and p.bootstrap_frames >= 2 and odom.frame_count > p.bootstrap_frames
                    else 0)
        steps = odom.frame_count + replayed
    return per_step * steps + 6 * between_refinements


def run_shipped(device, name, n_scans: int = SHIPPED_SCANS, n_scan_points: int = 65536,
                scene_points: int = 400000, seed: int = 0, overrides=None) -> dict:
    """Phase 7: GlimTorch (sync) on the default config directory with the
    edits of SHIPPED[name] written into its files (and ``overrides``, the
    CPU rehearsal's sizes), over phase 5's sequence; returns the run's
    metrics, with the nn_search launches the run should make."""
    from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks
    from glim_tpu_torch.pipeline import GlimTorch

    edits, bound = SHIPPED[name]
    _release_pipelines()
    dev = torch.device(device)
    seq = _sequence(n_scans, n_scan_points, scene_points, seed)
    glim = GlimTorch(config_dir(edits, f"glim_smoke_{name}_"), async_mode=False,
                     device=dev, overrides=overrides)
    to_sub = []
    SubMappingCallbacks.on_insert_frame.add(lambda f: to_sub.append(f.id))
    res = _timed_run(glim, seq, dev)
    odom, sub = glim.odometry, glim.sub_mapping
    subs = glim.submaps
    passthrough = type(sub).__name__ == "SubMappingPassthrough"
    keyframe_gaps = []
    if passthrough:
        p = sub.params
        from glim_tpu_torch.ops.lie_np import se3_log
        for s in subs:
            for a, b in zip(s.frames, s.frames[1:]):
                d = se3_log(np.linalg.inv(a.T_world_sensor()) @ b.T_world_sensor())
                keyframe_gaps.append(bool(np.linalg.norm(d[3:]) >= p.keyframe_update_interval_trans
                                          or np.linalg.norm(d[:3])
                                          >= p.keyframe_update_interval_rot))
    res.update(
        name=name, ate_bound=bound, odometry=type(odom).__name__,
        sub_mapping=type(sub).__name__, steps=getattr(odom, "frame_count", None),
        expected_launches=expected_launches(odom, res["between_refinements"]),
        frames_per_submap=[len(s.frames) for s in subs],
        # Every frame that reached sub-mapping lies in a submap: the default
        # sub-mapping keeps them all in frames, pass-through in odom_frames
        # (frames are its keyframes, each past the displacement gate).
        submap_frames_total=sum(len(s.odom_frames if passthrough else s.frames) for s in subs),
        frames_to_sub_mapping=len(to_sub), keyframes_past_the_gate=all(keyframe_gaps))
    return res


def check_shipped(res: dict) -> None:
    """Phase 7's failure conditions: finite poses, the module's ATE bound,
    submaps holding every frame that reached sub-mapping (pass-through: its
    keyframes past the displacement gate), an optimize, the submap-origin
    ATE bound and, on the card, the exact nn_search launch count."""
    name = res["name"]
    if not (res["poses_finite"] and res["submap_origins_finite"]):
        raise AssertionError(f"{name}: non-finite poses")
    if not res["ate"] < res["ate_bound"]:
        raise AssertionError(f"{name}: ATE {res['ate']:.4f} m >= {res['ate_bound']} m")
    if res["submaps"] < 2 or res["submap_frames_total"] != res["frames_to_sub_mapping"] \
            or not res["keyframes_past_the_gate"]:
        raise AssertionError(f"{name}: {res['submaps']} submaps holding "
                             f"{res['submap_frames_total']} frames, "
                             f"{res['frames_to_sub_mapping']} reached sub-mapping "
                             f"(keyframe gate kept: {res['keyframes_past_the_gate']})")
    if res["optimizes"] < 1:
        raise AssertionError(f"{name}: global mapping never optimized")
    if res["submap_ate"] is None or not res["submap_ate"] < SUBMAP_ATE_BOUND:
        raise AssertionError(f"{name}: submap-origin ATE {res['submap_ate']} m for "
                             f"{res['submaps']} submaps, want under {SUBMAP_ATE_BOUND} m")
    on_card = res["max_memory_allocated"] is not None
    if on_card and res["kernel_launches"] != res["expected_launches"]:
        raise AssertionError(f"{name}: {res['kernel_launches']} nn_search launches, want "
                             f"{res['expected_launches']} ({res['steps']} steps)")


def _print_shipped(res: dict, card: str) -> None:
    print(f"shipped {res['name']}: " + json.dumps(res))
    mem = res["max_memory_allocated"]
    print(f"shipped {res['name']} [{card}]: {res['odometry']} + {res['sub_mapping']}, "
          f"{res['scans']} scans in {res['seconds']:.2f} s = {res['scans_per_s']:.4f} scans/s, "
          f"ATE {res['ate']:.4f} m (bound {res['ate_bound']}), {res['kernel_launches']} "
          f"nn_search launches (want {res['expected_launches']}), {res['submaps']} submaps, "
          f"submap-origin ATE {res['submap_ate']} m, {res['optimizes']} optimizes, max memory "
          + (f"{mem / 2**20:.1f} MiB" if mem is not None else "not measured"))


def run_eval_figure8(device, duration: float = 20.0) -> dict:
    """Phase 8: the port's run_eval flagship row on figure8_room (EVAL.md's
    sequence, 20 s = 200 raycast scans)."""
    from glim_tpu_torch.tools import run_eval

    _release_pipelines()
    t0 = time.perf_counter()
    seq, _ = run_eval.make_sequence("figure8_room", duration)
    gen_s = time.perf_counter() - t0
    m, g, sps, extra = run_eval.run_sequence(seq, device=device)
    return dict(scans=extra["n_scans"], ate=m.ate_rmse, rot_deg=m.rot_rmse_deg,
                global_ate=g.ate_rmse if g else None, scans_per_s=sps,
                submaps=extra["n_submaps"], generate_seconds=gen_s,
                seconds=time.perf_counter() - t0)


def check_eval_figure8(res: dict) -> None:
    tol = max(EVAL_REL * EVAL_FIGURE8_ATE, EVAL_ABS)
    if not abs(res["ate"] - EVAL_FIGURE8_ATE) <= tol:
        raise AssertionError(f"run_eval figure8_room: ATE {res['ate']:.4f} m, EVAL.md "
                             f"{EVAL_FIGURE8_ATE} m +- {tol} m")


# Phase 5d: the JAX stress tool's ring through the pose-graph back-end
# (EVAL.md "Pose-graph backend at scale": 0.6493 m after the closure).
POSE_RING_POST_BOUND = 1.1 * 0.6493     # m
# Phase 9: the pose-graph configuration: the default configuration with the
# pose-graph back-end and both sub-mapping options, on a circle that closes
# its loop (1.15 laps, 72 m of travel past the shipped 50 m min_travel_dist).
POSE_GRAPH_EDITS = [
    ("config", "global", "config_global_mapping", "config_global_mapping_pose_graph.json"),
    ("config_sub_mapping", "sub_mapping", "enable_optimization", True),
    ("config_sub_mapping", "sub_mapping", "create_between_factors", True)]
POSE_GRAPH_SCANS = 120
POSE_GRAPH_RADIUS, POSE_GRAPH_OMEGA = 10.0, 0.6


def run_pose_graph_ring(device, n_submaps: int = RING_SUBMAPS, interval: int = 4) -> dict:
    """Phase 5d: the drifting ring through the port's GlobalMappingPoseGraph
    (``backend_stress.run_pose_graph``: the detection thread on, 4
    evaluations an insert, an optimize every ``interval``); the nn_search
    count is zeroed just before and read just after."""
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.tools import backend_stress

    _release_pipelines()
    t0 = time.perf_counter()
    nn_search.kernel_launches = 0
    rows, gm = backend_stress.run_pose_graph(n_submaps, interval, device=device, quiet=True)
    launches = nn_search.kernel_launches
    last = rows[-1]
    return dict(submaps=n_submaps, rows=rows, seconds=time.perf_counter() - t0,
                loops=last["loops"], factors=len(gm.f_i), registrations=gm.registrations,
                global_registrations=gm.global_registrations, kernel_launches=launches,
                expected_launches=gm.nn_search_calls(), detect_drain_s=last["detect_drain_s"],
                final_optimize_ms=last["final_optimize_ms"],
                ate_pre_closure_m=last["ate_pre_closure_m"],
                ate_post_closure_m=last["ate_post_closure_m"],
                poses_finite=bool(all(np.all(np.isfinite(T)) for T in gm.poses)),
                on_card=torch.device(device).type == "cuda")


def check_pose_graph_ring(res: dict) -> None:
    if abs(res["ate_pre_closure_m"] - RING_PRE_ATE) > RING_PRE_TOL:
        raise AssertionError(f"pose-graph ring: pre-closure ATE {res['ate_pre_closure_m']:.6f} "
                             f"m, the JAX ring's is {RING_PRE_ATE} m")
    if not (res["poses_finite"] and res["ate_post_closure_m"] <= POSE_RING_POST_BOUND):
        raise AssertionError(f"pose-graph ring: post-closure ATE {res['ate_post_closure_m']:.6f}"
                             f" m > {POSE_RING_POST_BOUND:.4f} m or non-finite poses")
    if res["loops"] < 1:
        raise AssertionError("pose-graph ring: no loop accepted")
    if res["on_card"] and res["kernel_launches"] != res["expected_launches"]:
        raise AssertionError(f"pose-graph ring: {res['kernel_launches']} nn_search launches, "
                             f"want {res['expected_launches']} ({res['registrations']} "
                             "registrations)")


def _print_pose_graph_ring(res: dict, card: str) -> None:
    for row in res["rows"]:
        print("pose-graph ring: " + json.dumps(row))
    for row in res["rows"]:
        print(f"pose-graph ring [{card}]: {row['submaps']} submaps, {row['factors']} factors, "
              f"{row['loops']} loops, insert {row['insert_mean_ms']:.2f} ms, optimize "
              f"{row['optimize_mean_ms']:.2f} ms (last {row['optimize_last_ms']:.2f} ms), ATE "
              f"{row['ate_rmse_m']:.4f} m")
    print(f"pose-graph ring [{card}]: {res['submaps']} submaps in {res['seconds']:.2f} s, "
          f"{res['loops']} loops, {res['registrations']} registrations "
          f"({res['global_registrations']} from a global registration), "
          f"{res['kernel_launches']} nn_search launches (want {res['expected_launches']}), "
          f"detection drain {res['detect_drain_s']:.3f} s, final optimize "
          f"{res['final_optimize_ms']:.2f} ms, ATE pre-closure {res['ate_pre_closure_m']:.6f} m, "
          f"post-closure {res['ate_post_closure_m']:.6f} m (bound {POSE_RING_POST_BOUND:.4f})")


class _SyncCounter:
    """Host syncs (``torch.cuda.set_sync_debug_mode("warn")`` warnings)
    raised on this thread while the wrapped calls run; nothing on the CPU."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.count = 0

    def wrap(self, fn):
        import threading

        def counted(*args, **kw):
            if not self.on_card:
                return fn(*args, **kw)
            me = threading.current_thread()
            show = warnings.showwarning

            def record(message, *a, **k):
                if threading.current_thread() is me and "synchroniz" in str(message):
                    self.count += 1
                else:
                    show(message, *a, **k)
            prev = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
        return counted


def _sync_untracked(dev) -> None:
    """A device sync for a timing, outside any sync count."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode(prev)


def run_pose_graph_config(device, n_scans: int = POSE_GRAPH_SCANS, n_scan_points: int = 65536,
                          scene_points: int = 400000, seed: int = 0,
                          radius: float = POSE_GRAPH_RADIUS, omega: float = POSE_GRAPH_OMEGA,
                          overrides=None) -> dict:
    """Phase 9: GlimTorch (sync) on the pose-graph configuration over
    phase 5's generator on a circle of ``radius`` at ``omega`` (``overrides``:
    the CPU rehearsal's sizes); returns the run's metrics with the
    sub-mapping refinements (their ms and host syncs a submap), the loops
    and the nn_search launches the run should make (the odometry's, one a
    between information, and the pose graph's registrations)."""
    from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks
    from glim_tpu_torch.pipeline import GlimTorch

    _release_pipelines()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: _sync_untracked(dev)) if on_card else (lambda: None)
    seq = _sequence(n_scans, n_scan_points, scene_points, seed, radius=radius, omega=omega)
    glim = GlimTorch(config_dir(POSE_GRAPH_EDITS, "glim_smoke_pose_graph_"), async_mode=False,
                     device=dev, overrides=overrides)
    sub, gm = glim.sub_mapping, glim.global_backend
    to_sub, refine_ms, keyframes = [], [], []
    SubMappingCallbacks.on_insert_frame.add(lambda f: to_sub.append(f.id))
    refine, create = sub._refine, sub._create_submap
    syncs_refine, syncs_submap = _SyncCounter(on_card), _SyncCounter(on_card)

    def timed_refine():
        keyframes.append(len(sub.keyframes))
        sync()
        t0 = time.perf_counter()
        out = syncs_refine.wrap(refine)()
        sync()
        refine_ms.append(1e3 * (time.perf_counter() - t0))
        return out
    sub._refine = timed_refine
    sub._create_submap = syncs_submap.wrap(create)
    res = _timed_run(glim, seq, dev)
    subs = glim.submaps
    n_refined = sum(1 for k in keyframes if k >= 2)
    res.update(
        name="pose_graph", odometry=type(glim.odometry).__name__,
        global_mapping=type(gm).__name__, loops=gm.num_loops, factors=len(gm.f_i),
        registrations=gm.registrations, global_registrations=gm.global_registrations,
        between_infos=sub.between_infos, refinements=sub.refinements,
        refinements_wanted=n_refined,
        refine_ms=refine_ms, refine_ms_mean=float(np.mean(refine_ms)) if refine_ms else None,
        host_syncs_refine=syncs_refine.count if on_card else None,
        host_syncs_submap=syncs_submap.count if on_card else None,
        expected_launches=(expected_launches(glim.odometry, 0) + sub.between_infos
                           + gm.nn_search_calls()),
        frames_per_submap=[len(s.frames) for s in subs],
        submap_frames_total=sum(len(s.frames) for s in subs), frames_to_sub_mapping=len(to_sub))
    return res


def check_pose_graph_config(res: dict) -> None:
    """Phase 9's failure conditions: finite poses, the odometry and
    submap-origin ATE bounds, every frame that reached sub-mapping in a
    submap, a refinement of every submap with two keyframes or more, a
    loop, an optimize and, on the card, the exact nn_search launch count."""
    name = "pose-graph configuration"
    if not (res["poses_finite"] and res["submap_origins_finite"]):
        raise AssertionError(f"{name}: non-finite poses")
    if not res["ate"] < DEFAULT_ATE_BOUND:
        raise AssertionError(f"{name}: ATE {res['ate']:.4f} m >= {DEFAULT_ATE_BOUND} m")
    if res["submaps"] < 2 or res["submap_frames_total"] != res["frames_to_sub_mapping"]:
        raise AssertionError(f"{name}: {res['submaps']} submaps holding "
                             f"{res['submap_frames_total']} frames, "
                             f"{res['frames_to_sub_mapping']} reached sub-mapping")
    if res["refinements"] != res["refinements_wanted"] or res["refinements"] < 1:
        raise AssertionError(f"{name}: {res['refinements']} refinements, want "
                             f"{res['refinements_wanted']}")
    if res["loops"] < 1 or res["optimizes"] < 1:
        raise AssertionError(f"{name}: {res['loops']} loops, {res['optimizes']} optimizes")
    if res["submap_ate"] is None or not res["submap_ate"] < SUBMAP_ATE_BOUND:
        raise AssertionError(f"{name}: submap-origin ATE {res['submap_ate']} m for "
                             f"{res['submaps']} submaps, want under {SUBMAP_ATE_BOUND} m")
    on_card = res["max_memory_allocated"] is not None
    if on_card and res["kernel_launches"] != res["expected_launches"]:
        raise AssertionError(
            f"{name}: {res['kernel_launches']} nn_search launches, want "
            f"{res['expected_launches']} ({res['between_infos']} between informations, "
            f"{res['registrations']} registrations)")


def _print_pose_graph_config(res: dict, card: str) -> None:
    print("pose_graph: " + json.dumps(res))
    mem = res["max_memory_allocated"]
    print(f"pose_graph [{card}]: {res['odometry']} + SubMapping (refined, GICP betweens) + "
          f"{res['global_mapping']}, {res['scans']} scans in {res['seconds']:.2f} s = "
          f"{res['scans_per_s']:.4f} scans/s, ATE {res['ate']:.4f} m, {res['submaps']} submaps "
          f"(frames {res['frames_per_submap']}), {res['refinements']} refinements at "
          f"{res['refine_ms_mean']} ms mean, host syncs {res['host_syncs_refine']} in the "
          f"refinements / {res['host_syncs_submap']} in the submap closes, {res['loops']} loops "
          f"({res['registrations']} registrations, {res['global_registrations']} from a global "
          f"registration), {res['optimizes']} optimizes, submap-origin ATE {res['submap_ate']} m, "
          f"{res['kernel_launches']} nn_search launches (want {res['expected_launches']} = "
          f"{res['between_infos']} between informations + pose-graph registrations), max memory "
          + (f"{mem / 2**20:.1f} MiB" if mem is not None else "not measured"))


# Phase 11: the extension modules, the headless viewer and live corrections.
EXT_DEFAULT = ["libgnss_global.so", "libvelocity_suppressor.so", "libimu_validator.so",
               "libmemory_monitor.so", "libstandard_viewer.so"]
EXT_LOOPS = ["libscan_context_loop_detector.so", "libdbow_loop_detector.so"]
GNSS_YAW = 0.7                        # rad, the ENU frame against the map frame
GNSS_OFFSET = (100.0, -50.0, 2.0)     # m
GNSS_STD = 0.05                       # m, the fixes' noise and their stated std
IMAGE_BINS = 12                       # the image bank's heading bins on the circle
IMAGES_KEPT = 4096                    # image_loop's buffer: every image of the run
# 11b's gate: the JAX package's detectors, run on the CPU over the submap
# clouds and middle stamps of the first card run of 11b (and every image),
# fired the image detector on one pair and ScanContext on none; the port
# must fire on the same pairs whenever its submaps have those stamps.
LOOP_JAX_STAMPS = (1.7, 3.2, 4.7, 6.2, 7.7, 9.2, 10.7, 11.7)
LOOP_JAX_IMAGE_PAIRS = [(0, 7)]
LOOP_JAX_SC_PAIRS = []
EXT_SCANS = 100                       # 11a: phase 5's sequence cut from 150 scans
# 11c: the default configuration frames reach sub-mapping ~50 scans late
# (smoother_lag 5 s), so the third submap reaches the global back-end only
# after ~105 scans; 80 would end the feed before the stream reports three.
LIVE_SCANS = 120
LIVE_TRIGGER_SUBMAPS = 3
STREAM_STATS = ("frames", "keyframes", "submaps", "mb")


def stream_schema_errors(path: str) -> list:
    """Each line of a viewer stream against the JAX package's line schema
    (glim_tpu/viewer/stream_writer.py): the errors found, [] if none."""
    errors = []

    def pose_rows(v):
        return isinstance(v, list) and all(
            isinstance(r, list) and len(r) == 7 and all(isinstance(x, (int, float)) for x in r)
            for r in v)

    def point_rows(v):
        return isinstance(v, list) and all(
            isinstance(r, list) and len(r) == 3 and all(isinstance(x, (int, float)) for x in r)
            for r in v)

    with open(path) as f:
        lines = f.read().splitlines()
    for n, line in enumerate(lines):
        try:
            d = json.loads(line)
        except ValueError as e:
            errors.append(f"line {n}: {e}")
            continue
        keys = set(d)
        if not {"t", "seq", "odom", "submaps", "stats"} <= keys \
                or not keys <= {"t", "seq", "odom", "submaps", "stats", "scan", "clouds",
                                "factors"}:
            errors.append(f"line {n}: keys {sorted(keys)}")
        elif not (isinstance(d["t"], (int, float)) and d["seq"] == n and pose_rows(d["odom"])
                  and pose_rows(d["submaps"]) and isinstance(d["stats"], dict)
                  and set(d["stats"]) == set(STREAM_STATS)
                  and point_rows(d.get("scan", []))
                  and all(isinstance(k, str) and point_rows(v)
                          for k, v in d.get("clouds", {}).items())
                  and all(isinstance(r, list) and len(r) == 3 and isinstance(r[0], int)
                          and isinstance(r[1], int) and r[2] in ("m", "b")
                          for r in d.get("factors", []))):
            errors.append(f"line {n}: a value off the schema")
    return errors


def gnss_fixes(seq, seed: int = 0) -> list:
    """1 Hz ENU fixes of the ground truth: ENU = Rz(GNSS_YAW) p + GNSS_OFFSET
    + N(0, GNSS_STD^2) per axis, from a generator seeded with ``seed``. The
    last scan has one, so that every submap's stamp lies between two fixes
    (past the last one, gnss_global would reuse it for up to a second)."""
    rng = np.random.default_rng(seed)
    c, s = np.cos(GNSS_YAW), np.sin(GNSS_YAW)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    n = len(seq.scans)
    return [(seq.scans[k].stamp, R @ seq.gt_poses[k][:3, 3] + np.asarray(GNSS_OFFSET)
             + rng.normal(0.0, GNSS_STD, 3)) for k in range((n - 1) % 10, n, 10)]


def run_extensions(device, n_scans: int = EXT_SCANS, n_scan_points: int = 65536,
                   scene_points: int = 400000, seed: int = 0, overrides=None,
                   config_edits=(), work_dir=None) -> dict:
    """Phase 11a: phase 5's sequence through GlimTorch (async) with the five
    extensions of EXT_DEFAULT, the standard viewer streaming to a file named
    in config_viewer and 1 Hz GNSS fixes (gnss_fixes) handed to the loaded
    gnss_global; returns phase 5's metrics with the extensions' counts.
    ``config_edits`` are config_dir edits (the CPU rehearsal's shorter GNSS
    baseline)."""
    from glim_tpu_torch.pipeline import GlimTorch

    _release_pipelines()
    dev = torch.device(device)
    seq = _sequence(n_scans, n_scan_points, scene_points, seed)
    tmp = tempfile.mkdtemp(prefix="glim_smoke_ext_", dir=work_dir)
    try:
        stream = os.path.join(tmp, "stream.jsonl")
        cfg = config_dir([("config_viewer", "standard_viewer", "stream_path", stream)]
                         + list(config_edits), "glim_smoke_ext_cfg_")
        glim = GlimTorch(cfg, extension_modules=EXT_DEFAULT, device=dev, overrides=overrides)
        ext = {type(e).__name__: e for e in glim.extensions}
        gnss, viewer, monitor = ext["GNSSGlobal"], ext["StandardViewer"], ext["MemoryMonitor"]
        odom = _odometry(glim)
        vel_calls = []
        setter = odom.set_velocity_regulation
        odom.set_velocity_regulation = lambda *a: (vel_calls.append(a), setter(*a))
        fixes = gnss_fixes(seq, seed)
        state = dict(fix=0, ok=True)

        def on_scan(i):
            state["ok"] &= glim.ok()
            while state["fix"] < len(fixes) and fixes[state["fix"]][0] <= seq.scans[i].stamp:
                gnss.insert_gnss(*fixes[state["fix"]], GNSS_STD)
                state["fix"] += 1

        res = _timed_run(glim, seq, dev, on_scan)
        state["ok"] &= glim.ok()
        dump = os.path.join(tmp, "dump")
        glim.save(dump)                 # the extensions' at_exit: the stream closes
        gm = glim.global_backend
        with open(os.path.join(dump, "viewer_odom.txt")) as f:
            viewer_rows = len(f.read().splitlines())
        with open(stream) as f:
            stream_lines = len(f.read().splitlines())
        res.update(
            extensions=sorted(ext), gnss_fixes=state["fix"], gnss_pairs=len(gnss.pairs),
            gnss_aligned=gnss.T_map_enu is not None, priors_sent=gnss.priors_sent,
            translation_priors=len(gm.translation_priors),
            velocity_regulation_calls=vel_calls, velocity_applied=ext["VelocitySuppressor"].applied,
            imu_frames_validated=ext["IMUValidatorExtension"].frames_validated,
            imu_validator_device=str(ext["IMUValidatorExtension"].integration.device),
            monitor_device_reads=monitor.device_reads,
            monitor_last=monitor.last_device_stats, ok_throughout=state["ok"],
            stream_lines=stream_lines, stream_errors=stream_schema_errors(stream),
            viewer_frames=len(viewer.odom_poses), viewer_odom_rows=viewer_rows,
            skipped_requests=glim.global_mapping.skipped_requests,
            on_card=dev.type == "cuda")
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_extensions(res: dict) -> None:
    """Phase 11a's failure conditions: the GNSS alignment and one
    translation prior in the graph for each one sent, velocity regulation
    set once, IMU validation running on the pipeline's device, the card's
    memory read (on the card), a stream whose every line parses under the
    JAX schema, every estimate in the viewer (and in its TUM export), ok()
    throughout, and phase 5's bounds."""
    name = "extensions"
    if not (res["gnss_aligned"] and res["priors_sent"] >= 1
            and res["translation_priors"] == res["priors_sent"]):
        raise AssertionError(f"{name}: GNSS aligned {res['gnss_aligned']}, "
                             f"{res['priors_sent']} priors sent, "
                             f"{res['translation_priors']} in the graph")
    if len(res["velocity_regulation_calls"]) != 1 or not res["velocity_applied"]:
        raise AssertionError(f"{name}: velocity regulation set "
                             f"{len(res['velocity_regulation_calls'])} times")
    if res["imu_frames_validated"] < 1:
        raise AssertionError(f"{name}: the IMU validator validated no frame")
    if res["on_card"] != res["imu_validator_device"].startswith("cuda"):
        raise AssertionError(f"{name}: the IMU validator dead-reckons on "
                             f"{res['imu_validator_device']}, not the pipeline's device")
    if res["on_card"] and res["monitor_device_reads"] < 1:
        raise AssertionError(f"{name}: the memory monitor never read the card")
    if res["stream_lines"] < 1 or res["stream_errors"]:
        raise AssertionError(f"{name}: {res['stream_lines']} stream lines, off the schema: "
                             f"{res['stream_errors'][:5]}")
    if res["viewer_frames"] < res["estimates"] or res["viewer_odom_rows"] != res["viewer_frames"]:
        raise AssertionError(f"{name}: the viewer holds {res['viewer_frames']} frames "
                             f"({res['viewer_odom_rows']} rows), {res['estimates']} estimates")
    if not res["ok_throughout"]:
        raise AssertionError(f"{name}: ok() went false")
    if not res["poses_finite"] or not res["ate"] < DEFAULT_ATE_BOUND:
        raise AssertionError(f"{name}: ATE {res['ate']:.4f} m >= {DEFAULT_ATE_BOUND} m "
                             "or non-finite poses")
    if res["submap_ate"] is None or not res["submap_ate"] < SUBMAP_ATE_BOUND:
        raise AssertionError(f"{name}: submap-origin ATE {res['submap_ate']} m, want under "
                             f"{SUBMAP_ATE_BOUND} m")


def _print_extensions(res: dict, phase5: dict, card: str) -> None:
    print("extensions: " + json.dumps(res))
    mem = res["max_memory_allocated"]
    print(f"extensions [{card}]: {res['scans']} scans in {res['seconds']:.2f} s = "
          f"{res['scans_per_s']:.4f} scans/s async with {len(EXT_DEFAULT)} extensions "
          f"(phase 5 sync in this call: {phase5['scans_per_s']:.4f}), ATE {res['ate']:.4f} m, "
          f"submap-origin ATE {res['submap_ate']} m, {res['submaps']} submaps, GNSS "
          f"{res['gnss_fixes']} fixes / {res['gnss_pairs']} pairs / {res['priors_sent']} "
          f"priors sent = {res['translation_priors']} in the graph, velocity regulation set "
          f"{len(res['velocity_regulation_calls'])}x, {res['imu_frames_validated']} frames "
          f"IMU-validated, {res['monitor_device_reads']} card memory reads (last "
          f"{res['monitor_last']}), {res['stream_lines']} stream lines, max memory "
          + (f"{mem / 2**20:.1f} MiB" if mem is not None else "not measured"))


def _same_stamps(a, b) -> bool:
    return len(a) == len(b) and bool(np.allclose(a, b, atol=1e-6))


def scene_image(rng) -> np.ndarray:
    """A textured 'place' image, 120 x 160: gradients and random blobs (the
    recipe of the JAX package's image-loop tests)."""
    y, x = np.mgrid[0:120, 0:160].astype(np.float32)
    img = 40 + 20 * np.sin(x / rng.uniform(8, 30)) + 20 * np.cos(y / rng.uniform(8, 30))
    for _ in range(8):
        cy, cx = rng.uniform(10, 110), rng.uniform(10, 150)
        r = rng.uniform(5, 25)
        img += rng.uniform(40, 120) * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * r * r))
    return np.clip(img, 0, 255)


def heading_images(seq, seed: int = 0, noise: float = 4.0) -> list:
    """One camera image a scan: the bank image of the scan's ground-truth
    heading bin (IMAGE_BINS bins), with N(0, noise^2) pixel noise; a
    revisit of a heading sees the same place."""
    rng = np.random.default_rng(seed)
    bank = [scene_image(rng) for _ in range(IMAGE_BINS)]
    out = []
    for k in range(len(seq.scans)):
        R = seq.gt_poses[k][:3, :3]
        yaw = np.arctan2(R[1, 0], R[0, 0]) % (2 * np.pi)
        b = int(yaw / (2 * np.pi) * IMAGE_BINS) % IMAGE_BINS
        out.append(np.clip(bank[b] + rng.normal(0.0, noise, bank[b].shape), 0, 255))
    return out


def _device_ms(calls) -> float:
    """Summed device time (ms) of the CUDA kernels and copies that the
    thunks in ``calls`` launch, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in SPANS) / 1e3


def run_loop_detectors(device, n_scans: int = POSE_GRAPH_SCANS, n_scan_points: int = 65536,
                       scene_points: int = 400000, seed: int = 0,
                       radius: float = POSE_GRAPH_RADIUS, omega: float = POSE_GRAPH_OMEGA,
                       overrides=None) -> dict:
    """Phase 11b: phase 9's configuration and circle through GlimTorch
    (async) with the ScanContext and image loop detectors, one image a scan
    (heading_images); returns phase 9's metrics with the detectors'
    matches, the loop requests fired and serviced, each detector's device
    ms a submap (its work replayed over the run's submaps under the
    profiler, on the card) and the submaps' clouds for an offline check."""
    from glim_tpu_torch.ext.image_loop import ImageLoopDetector
    from glim_tpu_torch.ext.scan_context import ScanContextLoopDetector
    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks, SubMappingCallbacks
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.types import to_numpy

    _release_pipelines()
    dev = torch.device(device)
    seq = _sequence(n_scans, n_scan_points, scene_points, seed, radius=radius, omega=omega)
    images = heading_images(seq, seed)
    glim = GlimTorch(config_dir(POSE_GRAPH_EDITS + [("config", "image_loop", "image_buffer",
                                                     IMAGES_KEPT)], "glim_smoke_loops_"),
                     device=dev, extension_modules=EXT_LOOPS, overrides=overrides)
    sc, il = glim.extensions
    sub, gm = glim.sub_mapping.sub_mapping, glim.global_backend
    to_sub, fired, serviced = [], [], []
    SubMappingCallbacks.on_insert_frame.add(lambda f: to_sub.append(f.id))
    GlobalMappingCallbacks.request_to_add_loop.add(lambda t, s: fired.append((t, s)))
    add_candidate = gm.add_loop_candidate

    def counted_candidate(tgt, src, *a):
        serviced.append((tgt, src))
        return add_candidate(tgt, src, *a)
    gm.add_loop_candidate = counted_candidate
    res = _timed_run(glim, seq, dev,
                     lambda i: glim.insert_image(seq.scans[i].stamp, images[i]))
    subs = glim.submaps
    res.update(
        name="loop_detectors", loops=gm.num_loops, registrations=gm.registrations,
        global_registrations=gm.global_registrations, between_infos=sub.between_infos,
        refinements=sub.refinements,
        expected_launches=(expected_launches(_odometry(glim), 0) + sub.between_infos
                           + gm.nn_search_calls()),
        sc_matches=[(sc.submap_ids[t], sc.submap_ids[s], d) for t, s, d in sc.matches],
        image_matches=[(il.submap_ids[t], il.submap_ids[s], v) for t, s, v in il.matches],
        loop_requests=fired, loop_requests_serviced=serviced,
        submap_frames_total=sum(len(s.frames) for s in subs),
        frames_to_sub_mapping=len(to_sub),
        submap_stamps=[float(s.frames[len(s.frames) // 2].stamp) for s in subs])
    res["jax_gate"] = _same_stamps(res["submap_stamps"], LOOP_JAX_STAMPS)
    res["submap_clouds"] = [(to_numpy(s.frame.points), to_numpy(s.frame.mask)) for s in subs]
    res["sc_ms_per_submap"] = res["image_ms_per_submap"] = None
    if dev.type == "cuda":
        # Each detector's work replayed over the run's submaps, the card
        # otherwise idle: detached copies (their loop requests go nowhere).
        _release_pipelines()
        sc2 = ScanContextLoopDetector()
        il2 = ImageLoopDetector(image_buffer=len(images), device=dev)
        sc2.detach()
        il2.detach()
        for i, img in enumerate(images):
            il2._on_image(seq.scans[i].stamp, img)
        res["sc_ms_per_submap"] = _device_ms([lambda s=s: sc2._on_new_submap(s)
                                              for s in subs]) / len(subs)
        res["image_ms_per_submap"] = _device_ms([lambda s=s: il2._on_new_submap(s)
                                                 for s in subs]) / len(subs)
    return res


def check_loop_detectors(res: dict) -> None:
    """Phase 11b's failure conditions: phase 9's bounds (finite poses, the
    ATE bounds, every frame in a submap, an optimize), every loop request
    serviced, the JAX detectors' pairs when the submaps have the stamps
    they were run on, and on the card the exact nn_search count (the
    extensions' candidates are registrations too)."""
    name = "loop detectors"
    if not (res["poses_finite"] and res["submap_origins_finite"]):
        raise AssertionError(f"{name}: non-finite poses")
    if not res["ate"] < DEFAULT_ATE_BOUND:
        raise AssertionError(f"{name}: ATE {res['ate']:.4f} m >= {DEFAULT_ATE_BOUND} m")
    if res["submaps"] < 2 or res["submap_frames_total"] != res["frames_to_sub_mapping"]:
        raise AssertionError(f"{name}: {res['submaps']} submaps holding "
                             f"{res['submap_frames_total']} frames, "
                             f"{res['frames_to_sub_mapping']} reached sub-mapping")
    if res["optimizes"] < 1:
        raise AssertionError(f"{name}: no optimize")
    if res["submap_ate"] is None or not res["submap_ate"] < SUBMAP_ATE_BOUND:
        raise AssertionError(f"{name}: submap-origin ATE {res['submap_ate']} m")
    if res["loop_requests_serviced"] != res["loop_requests"]:
        raise AssertionError(f"{name}: loop requests {res['loop_requests']}, serviced "
                             f"{res['loop_requests_serviced']}")
    if res["jax_gate"] and (
            [m[:2] for m in res["image_matches"]] != LOOP_JAX_IMAGE_PAIRS
            or [m[:2] for m in res["sc_matches"]] != LOOP_JAX_SC_PAIRS):
        raise AssertionError(f"{name}: matches {res['image_matches']} (image), "
                             f"{res['sc_matches']} (ScanContext); the JAX detectors fired on "
                             f"{LOOP_JAX_IMAGE_PAIRS} and {LOOP_JAX_SC_PAIRS}")
    on_card = res["max_memory_allocated"] is not None
    if on_card and res["kernel_launches"] != res["expected_launches"]:
        raise AssertionError(
            f"{name}: {res['kernel_launches']} nn_search launches, want "
            f"{res['expected_launches']} ({res['between_infos']} between informations, "
            f"{res['registrations']} registrations)")


def _print_loop_detectors(res: dict, card: str) -> None:
    print("loop_detectors: " + json.dumps({k: v for k, v in res.items()
                                           if k != "submap_clouds"}))
    print(f"loop_detectors [{card}]: {res['scans']} scans in {res['seconds']:.2f} s = "
          f"{res['scans_per_s']:.4f} scans/s async, ATE {res['ate']:.4f} m, {res['submaps']} "
          f"submaps, ScanContext matches {res['sc_matches']}, image matches "
          f"{res['image_matches']}, {len(res['loop_requests'])} loop requests "
          f"({len(res['loop_requests_serviced'])} serviced), {res['loops']} loops, "
          f"{res['registrations']} registrations, {res['kernel_launches']} nn_search launches "
          f"(want {res['expected_launches']} = {res['between_infos']} between informations + "
          f"registrations), device ms a submap: ScanContext {res['sc_ms_per_submap']}, image "
          f"{res['image_ms_per_submap']}, submap-origin ATE {res['submap_ate']} m")


def _live_commands(stream: str, commands: str, done, written, timeout: float = 600.0) -> list:
    """The helper thread of phase 11c: tail the viewer stream until its
    factor layer shows the global back-end holding LIVE_TRIGGER_SUBMAPS
    submaps (its submap list grows when sub-mapping closes one, before the
    back-end inserts it), then append to the command file: pause,
    loop_close of submaps 1 and 2, a bundle adjustment around a floor point
    both see, factors, status, set_enabled loop_detection false, step,
    resume, and set ``written``. Returns the commands written."""
    clouds, pos, line, in_graph = {}, 0, None, 0
    t_end = time.time() + timeout
    while time.time() < t_end and not done.is_set():
        with open(stream) as f:
            f.seek(pos)
            chunk = f.read()
        complete = chunk[:chunk.rfind("\n") + 1]
        pos += len(complete)
        for text in complete.splitlines():
            line = json.loads(text)
            clouds.update(line.get("clouds", {}))
            if line.get("factors"):
                in_graph = 1 + max(max(i, j) for i, j, _ in line["factors"])
        if in_graph >= LIVE_TRIGGER_SUBMAPS and len(line["submaps"]) >= LIVE_TRIGGER_SUBMAPS \
                and {"1", "2"} <= set(clouds):
            break
        time.sleep(0.05)
    else:
        return []

    def world(k):
        from glim_tpu_torch.utils.config import tum_to_se3
        T = tum_to_se3(line["submaps"][k])
        return np.asarray(clouds[str(k)]) @ T[:3, :3].T + T[:3, 3]

    w1, w2 = world(1), world(2)
    both = np.concatenate([w1, w2])
    floor = both[:, 2] < np.percentile(both[:, 2], 5) + 0.3
    # The pick: a floor point and the smallest radius in which each streamed
    # cloud (a subset of the submap's) has 30 points, none of them off the
    # floor if possible (a wall or pillar inside makes the region no plane).
    center, radius, fallback = None, None, None
    for r in (2.0, 3.0, 4.0, 6.0, 8.0):
        for c in both[floor]:
            n = min(np.sum(np.linalg.norm(w - c, axis=1) < r) for w in (w1, w2))
            if n < 30:
                continue
            if not np.any((np.linalg.norm(both - c, axis=1) < r + 0.5) & ~floor):
                center, radius = c, r
                break
            fallback = fallback or (c, r)
        if center is not None:
            break
    if center is None:
        center, radius = fallback if fallback else (both[floor][0], 8.0)
    cmds = [{"cmd": "pause"}, {"cmd": "loop_close", "target": 1, "source": 2},
            {"cmd": "bundle_adjust", "center": [float(v) for v in center], "radius": radius,
             "mode": "plane", "submaps": [1, 2]},
            {"cmd": "factors"}, {"cmd": "status"},
            {"cmd": "set_enabled", "target": "loop_detection", "value": False},
            {"cmd": "step"}, {"cmd": "resume"}]
    for cmd in cmds:
        with open(commands, "a") as f:
            f.write(json.dumps(cmd) + "\n")
        # Let the poller take each line on its own (the feed is paused).
        time.sleep(0.5 if cmd["cmd"] in ("pause", "step") else 0.05)
    written.set()
    return cmds


def run_live_corrections(device, n_scans: int = LIVE_SCANS, n_scan_points: int = 65536,
                         scene_points: int = 400000, seed: int = 0, overrides=None,
                         work_dir=None) -> dict:
    """Phase 11c: phase 5's sequence (first ``n_scans``) written as a dataset
    directory and played by the port's runner with --viewer-stream and
    --commands; a helper thread appends the live corrections
    (_live_commands). Returns the commands' results, each align's LM trial
    steps and nn_search launches, the graph's between factors and the dump
    loaded back."""
    import threading

    from glim_tpu_torch.mapping.global_mapping import GlobalMapping
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.tools import glim_runner
    from glim_tpu_torch.viewer import interactive_tools

    _release_pipelines()
    dev = torch.device(device)
    seq = _sequence(n_scans, n_scan_points, scene_points, seed)
    tmp = tempfile.mkdtemp(prefix="glim_smoke_live_", dir=work_dir)
    MLC = interactive_tools.ManualLoopClose
    align = MLC.align
    aligns = []

    def counted_align(self, *a, **k):
        n0 = nn_search.kernel_launches
        t0 = time.perf_counter()
        out = align(self, *a, **k)          # ends in a host read of its result
        aligns.append(dict(trial_steps=list(out.lm_trial_steps),
                           launches=nn_search.kernel_launches - n0,
                           ms=1e3 * (time.perf_counter() - t0),
                           inlier_fraction=out.inlier_fraction))
        return out
    try:
        data, dump = os.path.join(tmp, "dataset"), os.path.join(tmp, "dump")
        stream, commands = os.path.join(tmp, "stream.jsonl"), os.path.join(tmp, "commands.jsonl")
        glim_runner.save_dataset(data, seq.imu, [(s.stamp, s.points, s.times)
                                                 for s in seq.scans])
        open(stream, "w").close()
        done, ready = threading.Event(), threading.Event()
        written = []
        helper = threading.Thread(target=lambda: written.extend(
            _live_commands(stream, commands, done, ready)), daemon=True)
        helper.start()

        def on_scan(i):
            # The last scan waits for the commands (the workers go on
            # draining meanwhile), so they are polled before the feed ends.
            if i == n_scans - 1:
                ready.wait(300.0)
        MLC.align = counted_align
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        nn_search.kernel_launches = 0
        t0 = time.perf_counter()
        try:
            run = glim_runner.main([data, "--dump", dump, "--device", str(dev),
                                    "--config", config_dir(overrides, "glim_smoke_live_cfg_"),
                                    "--viewer-stream", stream, "--commands", commands],
                                   on_scan=on_scan)
        finally:
            MLC.align = align
            done.set()
        seconds = time.perf_counter() - t0
        launches = nn_search.kernel_launches
        helper.join(10.0)
        gm = run["glim"].global_backend
        fresh = GlobalMapping(gm.params, device=dev)
        fresh.load(dump)
        results = [(c.get("cmd"), out) for c, out in run["command_results"]]
        return dict(
            scans=run["scans"], seconds=seconds, scans_per_s=run["scans"] / seconds,
            commands_written=[c["cmd"] for c in written], results=results, aligns=aligns,
            kernel_launches=launches,
            between_pairs=[(int(i), int(j)) for i, j, _, _ in gm.between_factors],
            submap_capacity=int(gm.submaps[0].frame.points.shape[0]),
            submap_valid=[int(s.frame.mask.sum()) for s in gm.submaps[:4]],
            loop_search_enabled=gm.loop_search_enabled, submaps=len(gm.submaps),
            loaded_submaps=len(fresh.submaps), loaded_between=len(fresh.between_factors),
            stream_errors=stream_schema_errors(stream),
            max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            on_card=dev.type == "cuda")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_live_corrections(res: dict) -> None:
    """Phase 11c's failure conditions: every command written came back with
    the expected result, the loop closure's and the bundle adjustment's
    between factors are in the graph, each align made exactly sum over its
    passes of (1 + trial steps) + 2 nn_search launches and the run no other
    (on the card), and the dump loads."""
    name = "live corrections"
    want = ["pause", "loop_close", "bundle_adjust", "factors", "status", "set_enabled",
            "step", "resume"]
    got = dict(res["results"])
    if res["commands_written"] != want or [c for c, _ in res["results"]] != want:
        raise AssertionError(f"{name}: commands written {res['commands_written']}, "
                             f"answered {[c for c, _ in res['results']]}")
    if not (got["loop_close"]["ok"] and got["bundle_adjust"]["ok"]
            and got["bundle_adjust"]["thickness_after_m"]
            <= got["bundle_adjust"]["thickness_before_m"]
            and got["factors"]["ok"] and got["status"]["ok"] and got["status"]["live"]
            and got["set_enabled"]["ok"] and not res["loop_search_enabled"]):
        raise AssertionError(f"{name}: results {res['results']}")
    controls = [out for c, out in res["results"] if c in ("pause", "step", "resume")]
    if controls != [dict(paused=True, step=0), dict(paused=True, step=1),
                    dict(paused=False, step=0)]:
        raise AssertionError(f"{name}: playback controls {controls}")
    ba_pairs = list(zip(got["bundle_adjust"]["submaps"], got["bundle_adjust"]["submaps"][1:]))
    if (1, 2) not in res["between_pairs"] or not set(ba_pairs) <= set(res["between_pairs"]):
        raise AssertionError(f"{name}: between factors {res['between_pairs']}")
    if len(res["aligns"]) != 1:
        raise AssertionError(f"{name}: {len(res['aligns'])} alignments")
    for a in res["aligns"]:
        expect = sum(1 + s for s in a["trial_steps"]) + 2
        if res["on_card"] and a["launches"] != expect:
            raise AssertionError(f"{name}: align made {a['launches']} nn_search launches, "
                                 f"want {expect} (trial steps {a['trial_steps']})")
    if res["on_card"] and res["kernel_launches"] != sum(a["launches"] for a in res["aligns"]):
        raise AssertionError(f"{name}: {res['kernel_launches']} nn_search launches in the run")
    if res["loaded_submaps"] != res["submaps"] or \
            res["loaded_between"] != len(res["between_pairs"]) or res["stream_errors"]:
        raise AssertionError(f"{name}: dump loaded {res['loaded_submaps']} submaps / "
                             f"{res['loaded_between']} between factors; stream "
                             f"{res['stream_errors'][:3]}")


def _print_live_corrections(res: dict, card: str) -> None:
    print("live: " + json.dumps(res))
    a = res["aligns"][0] if res["aligns"] else {}
    mem = res["max_memory_allocated"]
    print(f"live [{card}]: {res['scans']} scans through the runner in {res['seconds']:.2f} s "
          f"= {res['scans_per_s']:.4f} scans/s with --viewer-stream and --commands; align "
          f"at Q = N = {res['submap_capacity']} ({res['submap_valid']} valid): "
          f"{a.get('ms')} ms, LM trial steps {a.get('trial_steps')}, {a.get('launches')} "
          f"nn_search launches, inlier fraction {a.get('inlier_fraction')}; between factors "
          f"{res['between_pairs']}; {res['submaps']} submaps, dump loaded with "
          f"{res['loaded_submaps']}; max memory "
          + (f"{mem / 2**20:.1f} MiB" if mem is not None else "not measured"))


# Phase 12 (cells 14-16): ROS bag playback, the ROS node with its rviz
# publisher, and the offline map tools on the bag run's dump.
BAG_SCANS = 150                 # 12a: phase 6's sequence
ROS_SCANS = 100                 # 12b: its first 100 scans
GRAVITY = 9.80665               # m/s^2; the bag's IMU is in g-units
BAG_ATE_REL = 0.10              # 12a's ATE within 10% (or BAG_ATE_ABS) of phase 6's
BAG_ATE_ABS = 0.002             # m
BAG_POINTS_TOPIC = "/os_cloud_node/points"
BAG_IMU_TOPIC = "/os_cloud_node/imu"
ROS_EXTENSIONS = ["librviz_viewer.so", "libimu_validator.so"]
ROS_POSE_TOL = 1e-6             # m, the last published pose against its estimate
REPL_TARGET, REPL_SOURCE = 0, 2  # 12c: the REPL's loop_close pair
OUTLIER_K = 10
OUTLIER_JACCARD = 0.999         # the editor's outliers against a cKDTree reference
SEGMENT_JACCARD = 0.99          # segmentations on the card against the CPU editor
SEGMENT_CAP = 16384
SEGMENT_RADIUS = 3.0            # m; the cells around a floor patch, not the whole map
OBJECT_RADIUS, OBJECT_CAP = 10.0, 16384  # select_segmentation's defaults, as the CLI runs it


class _CdrWriter:
    """Little-endian XCDR1 encoder, alignment counted from the payload's
    start (after the 4-byte encapsulation header): the writer of the two
    message types ``io/rosbag.py`` decodes."""

    def __init__(self):
        self.buf = bytearray(b"\x00\x01\x00\x00")

    def prim(self, fmt: str, v) -> None:
        import struct
        size = struct.calcsize(fmt)
        self.buf += b"\x00" * (-(len(self.buf) - 4) % size)
        self.buf += struct.pack("<" + fmt, v)

    def string(self, s: str) -> None:
        b = s.encode() + b"\x00"
        self.prim("I", len(b))
        self.buf += b

    def header(self, stamp: float, frame_id: str) -> None:
        ns = int(round(stamp * 1e9))
        self.prim("i", ns // 1_000_000_000)
        self.prim("I", ns % 1_000_000_000)
        self.string(frame_id)

    def f64s(self, values) -> None:
        for v in values:
            self.prim("d", float(v))


def cdr_pointcloud2(stamp: float, points: np.ndarray, times: np.ndarray) -> bytes:
    """A dense PointCloud2 of float32 x, y, z, t (Ouster-style per-point
    times), frame os_lidar."""
    w = _CdrWriter()
    w.header(stamp, "os_lidar")
    n = len(points)
    w.prim("I", 1)
    w.prim("I", n)
    w.prim("I", 4)
    for k, name in enumerate(("x", "y", "z", "t")):
        w.string(name)
        w.prim("I", 4 * k)
        w.prim("B", 7)                       # FLOAT32
        w.prim("I", 1)
    w.prim("B", 0)                           # is_bigendian
    w.prim("I", 16)
    w.prim("I", 16 * n)
    data = np.empty((n, 4), "<f4")
    data[:, :3] = points[:, :3]
    data[:, 3] = times
    w.prim("I", 16 * n)
    w.buf += data.tobytes()
    w.prim("B", 1)                           # is_dense
    return bytes(w.buf)


def cdr_imu(stamp: float, acc, gyro) -> bytes:
    w = _CdrWriter()
    w.header(stamp, "imu_link")
    w.f64s([0.0, 0.0, 0.0, 1.0])
    w.f64s([0.0] * 9)
    w.f64s(gyro)
    w.f64s([0.0] * 9)
    w.f64s(acc)
    w.f64s([0.0] * 9)
    return bytes(w.buf)


def write_rosbag2(path: str, seq) -> float:
    """``seq`` as a rosbag2 sqlite3 bag (a .db3 file with rosbag2's tables
    and stamp index): PointCloud2 scans on BAG_POINTS_TOPIC, logged at the
    scan's end as a sensor's ROS node publishes them, and Imu samples in g-units (as
    Livox sensors publish them) on BAG_IMU_TOPIC. Returns the bag's MiB."""
    import sqlite3

    rows = [(2, int(round(r[0] * 1e9)), cdr_imu(r[0], r[1:4] / GRAVITY, r[4:7]))
            for r in seq.imu]
    rows += [(1, int(round((s.stamp + 0.1) * 1e9)), cdr_pointcloud2(s.stamp, s.points, s.times))
             for s in seq.scans]
    rows.sort(key=lambda r: r[1])
    conn = sqlite3.connect(path)
    try:
        conn.execute("CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT NOT NULL, "
                     "type TEXT NOT NULL, serialization_format TEXT NOT NULL, "
                     "offered_qos_profiles TEXT NOT NULL)")
        conn.execute("CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id INTEGER NOT NULL, "
                     "timestamp INTEGER NOT NULL, data BLOB NOT NULL)")
        # rosbag2's sqlite3 storage indexes the stamps its reader orders by.
        conn.execute("CREATE INDEX timestamp_idx ON messages (timestamp ASC)")
        conn.executemany("INSERT INTO topics VALUES (?,?,?,?,?)",
                         [(1, BAG_POINTS_TOPIC, "sensor_msgs/msg/PointCloud2", "cdr", ""),
                          (2, BAG_IMU_TOPIC, "sensor_msgs/msg/Imu", "cdr", "")])
        conn.executemany("INSERT INTO messages(topic_id, timestamp, data) VALUES (?,?,?)", rows)
        conn.commit()
    finally:
        conn.close()
    return os.path.getsize(path) / 2**20


def run_bag(device, n_scans: int = BAG_SCANS, n_scan_points: int = 65536,
            scene_points: int = 400000, seed: int = 0, overrides=None,
            work_dir=None) -> dict:
    """Phase 12a: phase 6's sequence written as a rosbag2 .db3
    (write_rosbag2) and played by the port's runner (``glim_runner BAG``:
    bag decoding, the IMU's g-unit detection, the async pipeline, the dump)
    on ``device``. The bag and the dump stay in ``res["work_dir"]`` (under
    ``work_dir``) for phase 12c; the caller removes it."""
    from glim_tpu_torch.io.synthetic import ate_rmse
    from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.tools import glim_runner

    _release_pipelines()
    dev = torch.device(device)
    seq = _sequence(n_scans, n_scan_points, scene_points, seed)
    tmp = tempfile.mkdtemp(prefix="glim_smoke_bag_", dir=work_dir)
    done = False
    try:
        bag, dump = os.path.join(tmp, "run.db3"), os.path.join(tmp, "dump")
        t0 = time.perf_counter()
        bag_mib = write_rosbag2(bag, seq)
        write_s = time.perf_counter() - t0
        to_sub = []
        SubMappingCallbacks.on_insert_frame.add(lambda f: to_sub.append(f.id))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        nn_search.kernel_launches = 0
        run = glim_runner.main([bag, "--dump", dump, "--device", str(dev),
                                "--config", config_dir(overrides, "glim_smoke_bag_cfg_")])
        launches = nn_search.kernel_launches
        glim = run["glim"]
        ests = glim.odometry_estimates
        poses = [e.T_world_lidar for e in ests]
        gt = [seq.gt_poses[int(round(e.stamp * 10.0))] for e in ests]
        subs = glim.submaps
        res = dict(
            work_dir=tmp, dump=dump, bag_mib=bag_mib, bag_write_seconds=write_s,
            scans=run["scans"], estimates=len(ests), seconds=run["seconds"],
            scans_per_s=run["scans"] / run["seconds"], kernel_launches=launches,
            decode_ms_per_scan=1e3 * run["decode_seconds"] / max(run["scans"], 1),
            acc_scale=run["acc_scale"],
            poses_finite=bool(all(np.all(np.isfinite(T)) for T in poses)),
            ate=ate_rmse(poses, gt, align=True), submaps=len(subs),
            submap_frames_total=sum(len(s.frames) for s in subs),
            frames_to_sub_mapping=len(to_sub), submap_ate=submap_origin_ate(subs, seq),
            max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None))
        done = True
        return res
    finally:
        if not done:
            shutil.rmtree(tmp, ignore_errors=True)


def check_bag(res: dict, runner: dict = None, n_scans: int = BAG_SCANS) -> None:
    """Phase 12a's failure conditions: every scan of the bag fed, the IMU's
    scale detected as GRAVITY, finite poses, the ATE bound and (given
    phase 6's run) within BAG_ATE_REL or BAG_ATE_ABS of its ATE, and every
    frame that reached sub-mapping in a submap."""
    name = "bag playback"
    if res["scans"] != n_scans:
        raise AssertionError(f"{name}: {res['scans']} scans fed, the bag holds {n_scans}")
    if abs(res["acc_scale"] - GRAVITY) > 1e-12:
        raise AssertionError(f"{name}: acc_scale {res['acc_scale']}, want {GRAVITY}")
    if not res["poses_finite"] or not res["ate"] < DEFAULT_ATE_BOUND:
        raise AssertionError(f"{name}: ATE {res['ate']} m (bound {DEFAULT_ATE_BOUND} m)")
    if runner is not None and abs(res["ate"] - runner["ate"]) > max(
            BAG_ATE_REL * runner["ate"], BAG_ATE_ABS):
        raise AssertionError(f"{name}: ATE {res['ate']:.5f} m, the dataset run's "
                             f"{runner['ate']:.5f} m")
    if res["submaps"] < 2 or res["submap_frames_total"] != res["frames_to_sub_mapping"]:
        raise AssertionError(f"{name}: {res['submaps']} submaps holding "
                             f"{res['submap_frames_total']} frames, "
                             f"{res['frames_to_sub_mapping']} reached sub-mapping")


def _print_bag(res: dict, runner: dict, card: str) -> None:
    print("bag: " + json.dumps(res))
    mem = res["max_memory_allocated"]
    print(f"bag [{card}]: {res['scans']} scans from a {res['bag_mib']:.1f} MiB rosbag2 bag in "
          f"{res['seconds']:.3f} s = {res['scans_per_s']:.4f} scans/s (phase 6's dataset run in "
          f"this call: {runner['scans_per_s']:.4f}), read + decode "
          f"{res['decode_ms_per_scan']:.3f} ms a scan, acc_scale {res['acc_scale']}, ATE "
          f"{res['ate']:.4f} m (phase 6: {runner['ate']:.4f} m), {res['submaps']} submaps, "
          f"{res['kernel_launches']} nn_search launches (the default path runs none), "
          f"submap-origin ATE {res['submap_ate']} m, max memory "
          + (f"{mem / 2**20:.1f} MiB" if mem is not None else "not measured"))


class _FakePublisher:
    def __init__(self, topic):
        self.topic = topic
        self.messages = []

    def publish(self, msg):
        self.messages.append(msg)


class FakeNode:
    """The rclpy node surface GlimROSNode uses, without a timer (the
    caller drives spin_once)."""

    def __init__(self):
        self.subscriptions = {}
        self.publishers = {}

    def create_subscription(self, msg_type, topic, callback, qos):
        self.subscriptions[topic] = callback
        return (msg_type, topic)

    def create_publisher(self, msg_type, topic, qos):
        self.publishers[topic] = _FakePublisher(topic)
        return self.publishers[topic]


def imu_msg(t: float, acc, gyro):
    """A duck-typed sensor_msgs/Imu."""
    from types import SimpleNamespace

    from glim_tpu_torch.ros import messages as rosmsg
    return SimpleNamespace(
        header=SimpleNamespace(stamp=rosmsg.stamp_msg(t), frame_id="imu_link"),
        linear_acceleration=SimpleNamespace(x=acc[0], y=acc[1], z=acc[2]),
        angular_velocity=SimpleNamespace(x=gyro[0], y=gyro[1], z=gyro[2]))


def _msg_pose(msg) -> np.ndarray:
    from glim_tpu_torch.ops import lie_np
    p, q = msg.pose.pose.position, msg.pose.pose.orientation
    T = np.eye(4)
    T[:3, :3] = lie_np.quat_to_rot(np.array([q.x, q.y, q.z, q.w]))
    T[:3, 3] = p.x, p.y, p.z
    return T


def run_ros_node(device, n_scans: int = ROS_SCANS, n_scan_points: int = 65536,
                 scene_points: int = 400000, seed: int = 0, overrides=None,
                 async_mode: bool = True) -> dict:
    """Phase 12b: phase 5's sequence (first ``n_scans``) as ROS messages
    through GlimROSNode on a FakeNode, with librviz_viewer.so and
    libimu_validator.so: IMU in g-units up to each scan's end, the scan as
    a PointCloud2, then the node's and the rviz viewer's spin_once (and
    while the workload exceeds MAX_WORKLOAD); after wait(), spins until
    every announced frame is taken in. Returns the messages' metrics."""
    from glim_tpu_torch.io.synthetic import ate_rmse
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.ros import messages as rosmsg
    from glim_tpu_torch.ros.cloud_converter import to_sec
    from glim_tpu_torch.ros.node import GlimROSNode

    _release_pipelines()
    dev = torch.device(device)
    seq = _sequence(n_scans, n_scan_points, scene_points, seed)
    cfg = config_dir(list(overrides or []) + [
        ("config_ros", "glim_ros", "extension_modules", ROS_EXTENSIONS),
        ("config_ros", "glim_ros", "imu_topic", BAG_IMU_TOPIC),
        ("config_ros", "glim_ros", "points_topic", BAG_POINTS_TOPIC)], "glim_smoke_ros_cfg_")
    node = FakeNode()
    gn = GlimROSNode(node, config_path=cfg, async_mode=async_mode, device=dev)
    rviz = next(e for e in gn.glim.extensions if type(e).__name__ == "RvizViewer")
    validator = next(e for e in gn.glim.extensions
                     if type(e).__name__ == "IMUValidatorExtension")
    imu_cb, points_cb = node.subscriptions[BAG_IMU_TOPIC], node.subscriptions[BAG_POINTS_TOPIC]

    def spin():
        gn.spin_once()
        rviz.spin_once()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    nn_search.kernel_launches = 0
    t0 = time.perf_counter()
    imu_i = 0
    for raw in seq.scans:
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.1:
            r = seq.imu[imu_i]
            imu_cb(imu_msg(r[0], r[1:4] / GRAVITY, r[4:7]))
            imu_i += 1
        points_cb(rosmsg.make_pointcloud2(raw.stamp, "os_lidar", raw.points, times=raw.times))
        spin()
        while gn.glim.workload() > MAX_WORKLOAD:
            time.sleep(0.01)
            spin()
    gn.glim.wait()
    for _ in range(1000):
        spin()
        if not gn._announced and not rviz._scans:
            break
        time.sleep(0.01)
    seconds = time.perf_counter() - t0
    launches = nn_search.kernel_launches
    gn.stop()

    ests = gn.glim.odometry_estimates
    odom = node.publishers["/glim_ros/odom"].messages
    # Messages carry ns stamps; the odometry also announces (and the node
    # publishes) the frames of its initialization window.
    scan_of = {round(s.stamp, 6): i for i, s in enumerate(seq.scans)}
    scan_index = lambda m: scan_of.get(round(to_sec(m.header.stamp), 6))  # noqa: E731
    published = [(scan_index(m), _msg_pose(m)) for m in odom]
    matched = [(i, T) for i, T in published if i is not None]
    by_stamp = {round(e.stamp, 6): e for e in ests}
    last = odom[-1] if odom else None
    last_est = by_stamp.get(round(to_sec(last.header.stamp), 6)) if last is not None else None
    aligned = node.publishers["/glim_ros/aligned_points"].messages
    aligned_est = by_stamp.get(round(to_sec(aligned[-1].header.stamp), 6)) if aligned else None
    tfs = node.publishers["/tf"].messages
    p = gn.params
    res = dict(
        scans=n_scans, estimates=len(ests), seconds=seconds, scans_per_s=n_scans / seconds,
        kernel_launches=launches, first_estimate_scan=scan_of[round(ests[0].stamp, 6)] if ests else None,
        odom_messages=len(odom), distinct_stamps=len({i for i, _ in matched}),
        unmatched_stamps=len(odom) - len(matched),
        last_is_last_estimate=bool(ests) and last_est is ests[-1],
        last_pose_err=(float(np.abs(_msg_pose(last)[:3, 3]
                                    - last_est.T_world_sensor()[:3, 3]).max())
                       if last_est is not None else None),
        published_ate=(ate_rmse([T for _, T in matched], [seq.gt_poses[i] for i, _ in matched],
                                align=True) if len(matched) >= 3 else None),
        tf_pairs=sorted({(t.header.frame_id, t.child_frame_id)
                         for t in tfs[-1].transforms}) if tfs else [],
        base_frame=p.base_frame_id or p.imu_frame_id, imu_frame=p.imu_frame_id,
        lidar_frame=p.lidar_frame_id, acc_scale=gn._imu_cond.acc_scale,
        aligned_messages=len(aligned),
        aligned_width=int(aligned[-1].width) if aligned else None,
        aligned_valid=int(aligned_est.frame.mask.sum()) if aligned_est is not None else None,
        map_messages=len(node.publishers["/glim_ros/map"].messages),
        frames_validated=validator.frames_validated,
        max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None))
    for e in gn.glim.extensions:
        e.detach()
    return res


def check_ros_node(res: dict) -> None:
    """Phase 12b's failure conditions: one odometry message for every scan
    from the first estimate on (the window's lag), each at a scan's stamp
    and none twice, the last one at the last estimate's pose to
    ROS_POSE_TOL, the TF contract, the aligned cloud as wide as its frame's
    valid points, a map message, the g-unit detection and the published
    poses' ATE bound."""
    name = "ROS node"
    lag = res["first_estimate_scan"]
    if lag is None or res["odom_messages"] < res["scans"] - lag or res["unmatched_stamps"] \
            or res["distinct_stamps"] != res["odom_messages"]:
        raise AssertionError(f"{name}: {res['odom_messages']} odometry messages "
                             f"({res['distinct_stamps']} stamps) for {res['scans']} scans "
                             f"(the first estimate at scan {lag}), "
                             f"{res['unmatched_stamps']} stamps of no scan")
    if not res["last_is_last_estimate"] or not res["last_pose_err"] <= ROS_POSE_TOL:
        raise AssertionError(f"{name}: the last odometry message is not the last estimate "
                             f"to {ROS_POSE_TOL} m ({res['last_pose_err']})")
    want = {("map", "odom"), ("odom", res["base_frame"]), ("imu_link", "os_lidar")}
    if res["imu_frame"] != "imu_link" or res["lidar_frame"] != "os_lidar" or \
            not want <= {tuple(t) for t in res["tf_pairs"]}:
        raise AssertionError(f"{name}: TF pairs {res['tf_pairs']}, want {sorted(want)}")
    if not res["aligned_messages"] or res["aligned_width"] != res["aligned_valid"]:
        raise AssertionError(f"{name}: aligned cloud of {res['aligned_width']} points, its "
                             f"frame holds {res['aligned_valid']}")
    if res["map_messages"] < 1:
        raise AssertionError(f"{name}: no /glim_ros/map message")
    if abs(res["acc_scale"] - GRAVITY) > 1e-12:
        raise AssertionError(f"{name}: acc_scale {res['acc_scale']}")
    if res["published_ate"] is None or not res["published_ate"] < DEFAULT_ATE_BOUND:
        raise AssertionError(f"{name}: ATE of the published poses {res['published_ate']} m")


def _print_ros_node(res: dict, card: str) -> None:
    print("ros: " + json.dumps(res))
    mem = res["max_memory_allocated"]
    print(f"ros [{card}]: {res['scans']} PointCloud2 scans through GlimROSNode (async, rviz + "
          f"imu_validator) in {res['seconds']:.3f} s = {res['scans_per_s']:.4f} scans/s, "
          f"{res['odom_messages']} odometry messages (first estimate at scan "
          f"{res['first_estimate_scan']}, ATE "
          f"{res['published_ate']} m), last pose error {res['last_pose_err']} m, "
          f"{res['aligned_messages']} aligned clouds (last {res['aligned_width']} points), "
          f"{res['map_messages']} map messages, {res['frames_validated']} frames validated, "
          f"{res['kernel_launches']} nn_search launches, "
          "max memory " + (f"{mem / 2**20:.1f} MiB" if mem is not None else "not measured"))


def _jaccard(a, b) -> float:
    a, b = set(a), set(b)
    return len(a & b) / len(a | b) if a | b else 1.0


def outlier_reference(points: np.ndarray, k: int = OUTLIER_K, std_mul: float = 1.0) -> set:
    """Statistical outliers by scipy's cKDTree (independent of the port):
    a point whose mean distance to its k nearest (itself included) is not
    below the mean + std_mul x std over all points."""
    from scipy.spatial import cKDTree
    d, _ = cKDTree(points).query(points, k=k)
    mean_k = d.mean(axis=1)
    thresh = mean_k.mean() + mean_k.std() * std_mul
    return set(np.where(~(mean_k < thresh))[0].tolist())


def run_offline_tools(device, dump: str, work_dir: str, segment_cap: int = SEGMENT_CAP
                      ) -> dict:
    """Phase 12c on a dump: ``offline_viewer open --optimize --ply --save``,
    ``offline_viewer merge DUMP DUMP``, ``interactive_viewer --exec
    "loop_close A B" --exec optimize`` (align's LM trial steps and the
    nn_search launches of each command), then the map editor: the outlier
    selection over the whole map (ms, peak memory, the cKDTree reference),
    min-cut and region-growing selections (within SEGMENT_RADIUS, at most
    ``segment_cap`` candidates) around a floor point at the map's centre
    against the same editor on the CPU, the CLI's min-cut selection (the
    editor's defaults) against the CPU's, and ``map_editor
    --select-object --save`` whose dump is loaded back. Files go under
    ``work_dir``."""
    from glim_tpu_torch.native import ply_read
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.tools import interactive_viewer, map_editor, offline_viewer
    from glim_tpu_torch.viewer import interactive_tools
    from glim_tpu_torch.ops import knn
    from glim_tpu_torch.viewer.map_editor import MapEditor

    _release_pipelines()
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    out = os.path.join(work_dir, "offline")
    os.makedirs(out, exist_ok=True)
    res = dict(on_card=dev.type == "cuda")

    t0 = time.perf_counter()
    ov = offline_viewer.main(["open", dump, "--optimize", "--ply", os.path.join(out, "map.ply"),
                              "--save", os.path.join(out, "opened"), "--device", str(dev)])
    n = len(ov.global_mapping.submaps)
    res.update(open_seconds=time.perf_counter() - t0, submaps=n,
               ply_points=len(ply_read(os.path.join(out, "map.ply"))),
               export_points=len(ov.global_mapping.export_points()),
               opened_saved=os.path.exists(os.path.join(out, "opened", "graph.txt")),
               opened_poses_finite=bool(all(np.all(np.isfinite(T))
                                            for T in ov.global_mapping.poses)))
    del ov

    nn_search.kernel_launches = 0
    t0 = time.perf_counter()
    mv = offline_viewer.main(["merge", dump, dump, "--save", os.path.join(out, "merged"),
                              "--device", str(dev)])
    gm = mv.global_mapping
    res.update(merge_seconds=time.perf_counter() - t0, merge_launches=nn_search.kernel_launches,
               merged_submaps=len(gm.submaps),
               merged_sessions=[s.session_id for s in gm.submaps],
               cross_matching=sum((i < n) != (j < n) for i, j in gm.matching_factors),
               merged_poses_finite=bool(all(np.all(np.isfinite(T)) for T in gm.poses)))
    del mv, gm

    MLC = interactive_tools.ManualLoopClose
    align = MLC.align
    aligns = []

    def counted_align(self, *a, **k):
        n0 = nn_search.kernel_launches
        t1 = time.perf_counter()
        r = align(self, *a, **k)
        aligns.append(dict(trial_steps=list(r.lm_trial_steps),
                           launches=nn_search.kernel_launches - n0,
                           ms=1e3 * (time.perf_counter() - t1),
                           inlier_fraction=r.inlier_fraction))
        return r
    MLC.align = counted_align
    nn_search.kernel_launches = 0
    try:
        repl = interactive_viewer.main([dump, "--exec", f"loop_close {REPL_TARGET} {REPL_SOURCE}",
                                        "--exec", "optimize", "--device", str(dev)])
    finally:
        MLC.align = align
    res.update(repl_results=[(c["cmd"], o) for c, o in repl["results"]], aligns=aligns,
               repl_launches=nn_search.kernel_launches,
               repl_between=len(repl["viewer"].gm.between_factors),
               align_capacity=int(repl["viewer"].gm.submaps[0].frame.points.shape[0]),
               align_valid=[int(repl["viewer"].gm.submaps[i].frame.mask.sum())
                            for i in (REPL_TARGET, REPL_SOURCE)])
    del repl

    ed = MapEditor(device=dev)
    ed.open(dump)
    npts = len(ed.points)
    if dev.type == "cuda":
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    ed.select_outliers(k=OUTLIER_K)
    sync()
    res.update(map_points=npts, outlier_ms=1e3 * (time.perf_counter() - t0),
               outlier_tile=knn._boxed_tile(npts),
               outlier_peak_mib=((torch.cuda.max_memory_allocated(dev) - base) / 2**20
                                 if dev.type == "cuda" else None))
    outliers = set(ed.selected)
    ref = outlier_reference(ed.points.astype(np.float32))
    res.update(outliers=len(outliers), outliers_reference=len(ref),
               outlier_jaccard=_jaccard(outliers, ref))

    # The seed: the lowest point within 1.5 m (in x, y) of the map's centre,
    # on the floor, where both segmentations grow a region.
    near = np.where(np.linalg.norm(ed.points[:, :2] - ed.points[:, :2].mean(axis=0),
                                   axis=1) < 1.5)[0]
    seed = ed.points[near[np.argmin(ed.points[near, 2])]]
    cpu = MapEditor(device="cpu")
    cpu.open(dump)
    segments = {}
    for method in ("min_cut", "region_growing"):
        sel = {}
        for name, editor in (("card", ed), ("cpu", cpu)):
            editor.clear_selection()
            t0 = time.perf_counter()
            editor.select_segmentation(seed, method=method, radius=SEGMENT_RADIUS,
                                       cap=segment_cap)
            sel[name] = (set(editor.selected), 1e3 * (time.perf_counter() - t0))
        segments[method] = dict(selected=len(sel["card"][0]), cpu_selected=len(sel["cpu"][0]),
                                candidates=len(ed.cells_near(seed, SEGMENT_RADIUS)),
                                ms=sel["card"][1], cpu_ms=sel["cpu"][1],
                                jaccard=_jaccard(sel["card"][0], sel["cpu"][0]))
    res["segments"] = segments
    # The CLI's selection: min-cut at the editor's default radius and cap,
    # on the card and on the CPU.
    sel = {}
    for name, editor in (("card", ed), ("cpu", cpu)):
        editor.clear_selection()
        editor.select_segmentation(seed, method="min_cut")
        sel[name] = set(editor.selected)
    del cpu
    object_sel = sel["card"]
    res.update(object_selected=len(object_sel), object_cpu_selected=len(sel["cpu"]),
               object_candidates=min(len(ed.cells_near(seed, OBJECT_RADIUS)), OBJECT_CAP),
               object_jaccard=_jaccard(object_sel, sel["cpu"]))

    edited = os.path.join(out, "edited")
    map_editor.main([dump, "--select-object", *(str(float(v)) for v in seed),
                     "--method", "min_cut", "--save", edited, "--device", str(dev)])
    back = MapEditor(device=dev)
    back.open(edited)
    keep = np.ones(npts, bool)
    keep[sorted(object_sel)] = False
    res.update(edited_points=len(back.points), deleted=len(object_sel),
               edited_exact=bool(len(back.points) == int(keep.sum())
                                 and np.array_equal(back.points, ed.points[keep])))
    return res


def check_offline_tools(res: dict) -> None:
    """Phase 12c's failure conditions: the PLY holds export_points' count;
    the merge doubles the submaps with session ids 0 then 1, links the
    sessions by matching factors and launches no kernel; the REPL's
    loop_close and optimize succeed, align made exactly sum over its LM
    passes of (1 + trial steps) + 2 nn_search launches and the REPL no
    other (on the card); the outliers agree with the cKDTree reference to
    OUTLIER_JACCARD, both segmentations grow beyond their seed and agree
    with the CPU editor's to SEGMENT_JACCARD; the edited dump loads with
    exactly the deleted points gone; the CLI's min-cut selection (the
    editor's default radius and cap) agrees with the CPU editor's to
    SEGMENT_JACCARD."""
    name = "offline tools"
    n = res["submaps"]
    if not (res["ply_points"] == res["export_points"] > 0 and res["opened_saved"]
            and res["opened_poses_finite"]):
        raise AssertionError(f"{name}: open: PLY {res['ply_points']} points, export_points "
                             f"{res['export_points']}, saved {res['opened_saved']}")
    if not (res["merged_submaps"] == 2 * n and res["merged_sessions"] == [0] * n + [1] * n
            and res["cross_matching"] > 0 and res["merged_poses_finite"]
            and res["merge_launches"] == 0):
        raise AssertionError(f"{name}: merge: {res['merged_submaps']} submaps, sessions "
                             f"{res['merged_sessions']}, {res['cross_matching']} cross-session "
                             f"factors, {res['merge_launches']} launches")
    got = dict(res["repl_results"])
    if [c for c, _ in res["repl_results"]] != ["loop_close", "optimize"] or not (
            got["loop_close"]["ok"] and got["optimize"]["ok"]) or res["repl_between"] < 1:
        raise AssertionError(f"{name}: REPL results {res['repl_results']}")
    if len(res["aligns"]) != 1:
        raise AssertionError(f"{name}: {len(res['aligns'])} alignments")
    a = res["aligns"][0]
    expect = sum(1 + s for s in a["trial_steps"]) + 2
    if res["on_card"] and not (a["launches"] == expect == res["repl_launches"]):
        raise AssertionError(f"{name}: align made {a['launches']} nn_search launches and the "
                             f"REPL {res['repl_launches']}, want {expect} "
                             f"(trial steps {a['trial_steps']})")
    if not res["outlier_jaccard"] >= OUTLIER_JACCARD or not res["outliers"]:
        raise AssertionError(f"{name}: {res['outliers']} outliers, the reference "
                             f"{res['outliers_reference']}, Jaccard {res['outlier_jaccard']}")
    for method, s in res["segments"].items():
        if not s["selected"] > 1 or not s["jaccard"] >= SEGMENT_JACCARD:
            raise AssertionError(f"{name}: {method} selected {s['selected']} points, the CPU "
                                 f"{s['cpu_selected']}, Jaccard {s['jaccard']}")
    if not res["object_jaccard"] >= SEGMENT_JACCARD:
        raise AssertionError(f"{name}: the CLI's min_cut selected {res['object_selected']} "
                             f"points, the CPU {res['object_cpu_selected']}, Jaccard "
                             f"{res['object_jaccard']}")
    if not res["edited_exact"]:
        raise AssertionError(f"{name}: the edited dump holds {res['edited_points']} points, "
                             f"{res['map_points']} less {res['deleted']} deleted expected")


def _print_offline_tools(res: dict, card: str) -> None:
    print("offline: " + json.dumps(res))
    a = res["aligns"][0] if res["aligns"] else {}
    seg = res["segments"]
    peak = res["outlier_peak_mib"]
    print(f"offline [{card}]: open + optimize + ply + save {res['open_seconds']:.3f} s "
          f"({res['submaps']} submaps, {res['ply_points']} points); merge "
          f"{res['merge_seconds']:.3f} s ({res['merged_submaps']} submaps, "
          f"{res['cross_matching']} cross-session factors, {res['merge_launches']} launches); "
          f"REPL align at Q = N = {res['align_capacity']} ({res['align_valid']} valid) "
          f"{a.get('ms')} ms, trial steps {a.get('trial_steps')}, {a.get('launches')} launches "
          f"({res['repl_launches']} in the REPL), inlier fraction {a.get('inlier_fraction')}")
    print(f"offline [{card}]: outliers over {res['map_points']} map points in "
          f"{res['outlier_ms']:.1f} ms (tile {res['outlier_tile']}, peak "
          + (f"{peak:.1f} MiB" if peak is not None else "not measured")
          + f"): {res['outliers']} (cKDTree {res['outliers_reference']}, Jaccard "
          f"{res['outlier_jaccard']:.5f}); within {SEGMENT_RADIUS} m "
          f"({seg['min_cut']['candidates']} candidates) min_cut {seg['min_cut']['selected']} in "
          f"{seg['min_cut']['ms']:.1f} ms (CPU {seg['min_cut']['cpu_ms']:.1f}, Jaccard "
          f"{seg['min_cut']['jaccard']:.4f}), region_growing "
          f"{seg['region_growing']['selected']} in {seg['region_growing']['ms']:.1f} ms (CPU "
          f"{seg['region_growing']['cpu_ms']:.1f}, Jaccard {seg['region_growing']['jaccard']:.4f}); "
          f"the CLI's min_cut within {OBJECT_RADIUS} m ({res['object_candidates']} candidates) "
          f"{res['object_selected']} (CPU {res['object_cpu_selected']}, Jaccard "
          f"{res['object_jaccard']:.4f}); edited dump {res['edited_points']} points = {res['map_points']} - {res['deleted']}")


# Phase 13 (cells 17-19): the device mesh, debug_backend and profile_e2e.
MESH_ENTRIES = 8                # 13a: one card as JAX's tests' 8 virtual devices
MESH_CAP, MESH_TARGETS = 16384, 131072     # the GICP odometry's shape
MESH_VOXELS = 131072            # the odometry's voxel capacity
MESH_FACTORS, MESH_FACTOR_POINTS, MESH_FACTOR_VOXELS = 8, 4096, 65536
MESH_RTOL, MESH_ATOL = 1e-4, 1e-2          # tests/test_parallel.py's tolerance
MESH_CONVERGE = 0.1             # m; sharded_odometry_step's translation error bound
PARITY_SUBMAPS, PARITY_ATOL = 64, 5e-4     # glim_tpu/tools/multichip_check.py's
# 13b: 60 raycast scans. On an H100 80GB HBM3 (700 W), at 20 s (200 scans)
# phase 13 took 162.2 s of a 933.6 s smoke, at 10 s 160.2 s of a 1217.0 s
# one on a slower host (PERF.md).
DEBUG_SEQ, DEBUG_DURATION = "city_loop", 6.0
DEBUG_WHICH = "no_opt,default,between"
# --debug-backend: debug_backend.sweep's seven configurations.
DEBUG_ALL = "no_opt,default,no_imu,fine_voxel,more_iters,weight_1e-2,between"
WORKER_SPANS = ("odometry", "sub_mapping", "global_mapping")


def mesh_inputs(cap: int = MESH_CAP, n_targets: int = MESH_TARGETS,
                n_factors: int = MESH_FACTORS, factor_points: int = MESH_FACTOR_POINTS,
                seed: int = 3) -> dict:
    """Phase 13a's inputs as numpy arrays: a room of ``n_targets`` points
    (30% masked) on planes and pillars (a floor, four walls, eight pillars:
    VGICP needs structure to constrain all six directions), a source cloud
    of ``cap`` points (5% masked) drawn from it, moved by ``T_true^-1``,
    with 5 mm noise, each point with the plane covariance of its surface
    (eigenvalues 1, 1 and 1e-3 along the normal, as the pipeline's
    "plane" regularization gives), and for each of ``n_factors`` factors a
    source cloud of ``factor_points`` points with its own small pose and a
    random half of the room as its target."""
    from glim_tpu_torch.ops import lie_np

    rng = np.random.default_rng(seed)
    n_floor, n_walls = int(0.4 * n_targets), int(0.4 * n_targets)
    n_pillars = n_targets - n_floor - n_walls
    floor = np.stack([rng.uniform(-8, 8, n_floor), rng.uniform(-8, 8, n_floor),
                      np.zeros(n_floor)], 1)
    side = rng.integers(0, 4, n_walls)
    u, z = rng.uniform(-8, 8, n_walls), rng.uniform(0, 3, n_walls)
    sign = np.where(side % 2 == 0, 8.0, -8.0)
    walls = np.where((side < 2)[:, None], np.stack([sign, u, z], 1), np.stack([u, sign, z], 1))
    centers = rng.uniform(-6, 6, (8, 2))
    which, ang = rng.integers(0, 8, n_pillars), rng.uniform(0, 2 * np.pi, n_pillars)
    radial = np.stack([np.cos(ang), np.sin(ang), np.zeros(n_pillars)], 1)
    pillars = np.stack([centers[which, 0], centers[which, 1], rng.uniform(0, 3, n_pillars)],
                       1) + 0.3 * radial
    normals = np.concatenate([np.tile([0.0, 0.0, 1.0], (n_floor, 1)),
                              np.where((side < 2)[:, None], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
                              radial])
    order = rng.permutation(n_targets)
    # Off the voxel grid: a plane on a voxel boundary is lost whole by a
    # one-centimetre step.
    tgt = (np.concatenate([floor, walls, pillars])[order] + [0.13, -0.21, 0.37]).astype(np.float32)
    nn = normals[order][:, :, None] * normals[order][:, None, :]
    tgt_covs = (np.eye(3) - nn + 1e-3 * nn).astype(np.float32)
    tgt_mask = rng.uniform(size=n_targets) >= 0.3
    T_true = lie_np.se3_exp(np.array([0.02, -0.01, 0.03, 0.2, -0.1, 0.05]))
    Ti = np.linalg.inv(T_true)
    pick = rng.choice(np.flatnonzero(tgt_mask), cap, replace=False)
    src_world = tgt[pick] + rng.normal(0, 0.005, (cap, 3)).astype(np.float32)
    src = (src_world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
    src_covs = (Ti[:3, :3] @ tgt_covs[pick] @ Ti[:3, :3].T).astype(np.float32)
    src_mask = rng.uniform(size=cap) >= 0.05
    T_src = lie_np.se3_exp(np.array([0.01, 0.02, -0.01, 0.1, 0.05, 0.0]))
    f_T = np.stack([lie_np.se3_exp(rng.normal(size=6) * 0.02) for _ in range(n_factors)])
    f_pick = np.stack([rng.choice(n_targets, factor_points, replace=False)
                       for _ in range(n_factors)])
    f_mask = rng.uniform(size=(n_factors, factor_points)) >= 0.05
    f_half = rng.uniform(size=(n_factors, n_targets)) < 0.5
    return dict(tgt=tgt, tgt_covs=tgt_covs, tgt_mask=tgt_mask, src=src,
                src_covs=src_covs, src_mask=src_mask, T_true=T_true,
                T_src=T_src.astype(np.float32), f_T=f_T.astype(np.float32),
                f_pts=tgt[f_pick], f_covs=tgt_covs[f_pick], f_mask=f_mask, f_half=f_half)


def _system_err(a, b) -> float:
    """Largest |a - b| over H_tt, H_ts, H_ss, b_t, b_s and error, beyond
    MESH_ATOL + MESH_RTOL |b|: <= 0 when the two systems agree."""
    worst = -float("inf")
    for x, y in zip(a[:6], b[:6]):
        x, y = x.double().cpu(), y.double().cpu()
        worst = max(worst, float(((x - y).abs() - (MESH_ATOL + MESH_RTOL * y.abs())).max()))
    return worst


def run_mesh(device, mesh=None, voxels: int = MESH_VOXELS,
             factor_voxels: int = MESH_FACTOR_VOXELS, inputs=None,
             parity_submaps: int = PARITY_SUBMAPS) -> dict:
    """Phase 13a on ``device``: the four sharded functions on ``mesh``
    (default: MESH_ENTRIES entries of ``device``) against the unsharded
    calls on ``mesh_inputs()``, sharded_gicp_linearize's nn_search
    launches counted alone, then backend_parity_check on that mesh and on
    every visible card's (``make_mesh(axis="factors")``; on the CPU, the
    one-entry CPU mesh)."""
    from glim_tpu_torch.ops import gicp, lie_np
    from glim_tpu_torch.ops import voxelmap as vmx
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.parallel import sharded as sh
    from glim_tpu_torch.tools.multichip_check import backend_parity_check

    _release_pipelines()
    dev = torch.device(device)
    mesh = mesh or sh.make_mesh(devices=[dev] * MESH_ENTRIES)
    d = inputs or mesh_inputs()
    t = {k: torch.as_tensor(v, device=dev) for k, v in d.items() if k != "T_true"}
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)

    def timed(fn):
        fn()                                    # warm-up
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    eye = torch.eye(4, device=dev)
    vm = vmx.voxelmap_insert(vmx.empty_gaussian_voxelmap(voxels, 0.5, dev), t["tgt"],
                             t["tgt_mask"], t["tgt_covs"], 0)
    src = (t["src"], t["src_covs"], t["src_mask"])
    tgt = (t["tgt"], t["tgt_covs"], t["tgt_mask"])
    res = dict(device=str(dev), mesh=[str(x) for x in mesh.devices], cap=int(d["src"].shape[0]),
               targets=int(d["tgt"].shape[0]), rows={})

    def compare(name, sharded, single):
        (a, ms_a), (b, ms_b) = timed(sharded), timed(single)
        row = dict(excess=_system_err(a, b), inliers=int(a.num_inliers),
                   inliers_single=int(b.num_inliers), ms=ms_a, ms_single=ms_b)
        res["rows"][name] = row
        return a

    compare("vgicp", lambda: sh.sharded_vgicp_linearize(mesh, eye, t["T_src"], *src, vm),
            lambda: gicp.vgicp_linearize(eye, t["T_src"], *src, vm))
    compare("gicp", lambda: sh.sharded_gicp_linearize(mesh, eye, t["T_src"], *src, *tgt, 1.0),
            lambda: gicp.gicp_linearize(eye, t["T_src"], *src, *tgt, 1.0))
    nn_search.kernel_launches = 0
    sh.sharded_gicp_linearize(mesh, eye, t["T_src"], *src, *tgt, 1.0)
    res["gicp_launches"] = nn_search.kernel_launches

    F = int(d["f_pts"].shape[0])
    vms = [vmx.voxelmap_insert(vmx.empty_gaussian_voxelmap(factor_voxels, 0.5, dev),
                               t["tgt"], t["tgt_mask"] & t["f_half"][f], t["tgt_covs"], 0)
           for f in range(F)]
    f_args = (eye.expand(F, 4, 4), t["f_T"], t["f_pts"], t["f_covs"], t["f_mask"])
    stacked = vmx.stack_voxelmaps(vms)
    out, ms_f = timed(lambda: sh.sharded_factor_linearize(mesh, *f_args, stacked))
    ref, ms_loop = timed(lambda: [gicp.vgicp_linearize(eye, t["f_T"][f], t["f_pts"][f],
                                                       t["f_covs"][f], t["f_mask"][f], vms[f])
                                  for f in range(F)])
    res["rows"]["factors"] = dict(
        excess=max(_system_err([x[f] for x in out], ref[f]) for f in range(F)),
        inliers=[int(x) for x in out.num_inliers], inliers_single=[int(r.num_inliers) for r in ref],
        ms=ms_f, ms_single=ms_loop, factors=F)

    T_est, errs = sh.sharded_odometry_step(mesh, eye, *src, vm, iters=10)
    e = lie_np.se3_log(np.linalg.inv(d["T_true"]) @ T_est.double().cpu().numpy())
    res["odometry"] = dict(trans_err=float(np.linalg.norm(e[3:])),
                           rot_err=float(np.linalg.norm(e[:3])),
                           errs=[float(x) for x in errs.cpu()])

    res["parity"] = backend_parity_check(
        sh.Mesh(mesh.devices, "factors"), n_submaps=parity_submaps)
    real = (sh.make_mesh(axis="factors") if dev.type == "cuda"
            else sh.make_mesh(axis="factors", devices=[dev]))
    res["parity_real"] = dict(backend_parity_check(real, n_submaps=parity_submaps),
                              mesh=[str(x) for x in real.devices])
    return res


def check_mesh(res: dict, launches_per_shard: int = 1) -> None:
    """Phase 13a's failure conditions: every sharded system within
    tests/test_parallel.py's tolerance of the unsharded one with equal
    inlier counts, ``launches_per_shard`` nn_search launches a shard (none
    on the CPU), the sharded solve converged, and both parity checks (>=
    300 factors, pose delta < 5e-4)."""
    for name, row in res["rows"].items():
        if not row["excess"] <= 0.0:
            raise AssertionError(f"mesh {name}: sharded and unsharded systems differ beyond "
                                 f"rtol {MESH_RTOL} / atol {MESH_ATOL} (excess {row['excess']})")
        if row["inliers"] != row["inliers_single"]:
            raise AssertionError(f"mesh {name}: inliers {row['inliers']} sharded, "
                                 f"{row['inliers_single']} unsharded")
    if res["gicp_launches"] != launches_per_shard * len(res["mesh"]):
        raise AssertionError(f"sharded_gicp_linearize launched nn_search {res['gicp_launches']} "
                             f"times, want {launches_per_shard} a shard ({len(res['mesh'])} "
                             "shards)")
    if not res["odometry"]["trans_err"] < MESH_CONVERGE:
        raise AssertionError(f"sharded_odometry_step did not converge: {res['odometry']}")
    for key in ("parity", "parity_real"):
        p = res[key]
        if not (p["factors"] >= 300 and p["max_pose_delta"] < PARITY_ATOL):
            raise AssertionError(f"backend parity ({key}): {p}")


def _print_mesh(res: dict, card: str) -> None:
    print("mesh: " + json.dumps(res))
    for name, row in res["rows"].items():
        print(f"mesh [{card}]: {name} over {len(res['mesh'])} entries of {res['mesh'][0]}: "
              f"{row['ms']:.3f} ms sharded, {row['ms_single']:.3f} ms unsharded, inliers "
              f"{row['inliers'] if name != 'factors' else sum(row['inliers'])} (equal), "
              f"excess over the tolerance {row['excess']:.3e}")
    o = res["odometry"]
    print(f"mesh [{card}]: sharded_gicp_linearize {res['gicp_launches']} nn_search launches at "
          f"Q = {res['cap'] // len(res['mesh'])} a shard, N = {res['targets']}; "
          f"sharded_odometry_step translation error {o['trans_err']:.2e} m, rotation "
          f"{o['rot_err']:.2e} rad")
    for key in ("parity", "parity_real"):
        p = res[key]
        mesh = p.get("mesh", res["mesh"])
        print(f"mesh [{card}]: backend parity on {len(mesh)} x {mesh[0]}: {p['submaps']} "
              f"submaps, {p['factors']} factors, {p['factor_rows']} factor rows, max pose "
              f"delta {p['max_pose_delta']:.3e}, global_gn {p['gn_ms_sharded']:.2f} ms sharded, "
              f"{p['gn_ms_single']:.2f} ms unsharded")


def run_debug_backend(device, seq: str = DEBUG_SEQ, duration=DEBUG_DURATION,
                      which: str = DEBUG_WHICH) -> dict:
    """Phase 13b: ``debug_backend capture`` over ``seq`` (``duration`` None:
    the sequence's own length) into a temporary directory, then ``sweep``
    over ``which`` (configuration labels, comma-separated); the between
    configuration's nn_search launches are counted alone. Returns each configuration's ATE, seconds, submaps and
    between refinements."""
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.tools import debug_backend

    _release_pipelines()
    work = tempfile.mkdtemp(prefix="glim_smoke_debug_")
    try:
        path = os.path.join(work, "state.pkl")
        t0 = time.perf_counter()
        state = debug_backend.capture(seq, path, duration, device)
        res = dict(seq=seq, scans=len(state["gt_stamps"]), submaps=len(state["submaps"]),
                   capture_seconds=time.perf_counter() - t0,
                   odom_ate=debug_backend._odom_ate(state).ate_rmse,
                   state_mib=os.path.getsize(path) / 2**20, configs={})
        labels = which.split(",")
        for between in (False, True):
            group = [n for n in labels if (n == "between") == between]
            if not group:
                continue
            nn_search.kernel_launches = 0
            out = debug_backend.sweep(path, ",".join(group), device)
            launches = nn_search.kernel_launches
            for label, (gm, m, seconds) in out.items():
                res["configs"][label] = dict(
                    ate=m.ate_rmse, rot_deg=m.rot_rmse_deg, seconds=seconds,
                    submaps=len(gm.submaps), between_refinements=gm.between_refinements,
                    finite=bool(all(np.all(np.isfinite(T)) for T in gm.poses)),
                    launches=launches if between else None)
            if not between:
                res["launches_others"] = launches
        return res
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check_debug_backend(res: dict, launches_per_refinement: int = 6) -> None:
    """Phase 13b's failure conditions: finite poses and a global ATE under
    DEFAULT_ATE_BOUND in every configuration, every submap in the back-end,
    no nn_search launch outside the between configuration and, in it, one
    refinement a submap after the first at ``launches_per_refinement``
    launches each (6, as expected_launches counts them; none on the
    CPU)."""
    for label, c in res["configs"].items():
        if not (c["finite"] and c["ate"] < DEFAULT_ATE_BOUND and c["submaps"] == res["submaps"]):
            raise AssertionError(f"debug_backend {label}: {c} ({res['submaps']} submaps)")
    if res.get("launches_others", 0) != 0:
        raise AssertionError(f"debug_backend: {res['launches_others']} nn_search launches "
                             "outside the between configuration")
    b = res["configs"].get("between")
    if b is not None and not (b["between_refinements"] == res["submaps"] - 1
                              and b["launches"] == launches_per_refinement
                              * b["between_refinements"]):
        raise AssertionError(f"debug_backend between: {b['launches']} launches, "
                             f"{b['between_refinements']} refinements, {res['submaps']} submaps")


def _print_debug_backend(res: dict, card: str) -> None:
    print("debug_backend: " + json.dumps(res))
    print(f"debug_backend [{card}]: capture of {res['seq']} ({res['scans']} raycast scans) in "
          f"{res['capture_seconds']:.2f} s, {res['submaps']} submaps, odometry ATE "
          f"{res['odom_ate']:.4f} m, state {res['state_mib']:.2f} MiB")
    for label, c in res["configs"].items():
        print(f"debug_backend [{card}]: {label}: global ATE {c['ate']:.4f} m, rot "
              f"{c['rot_deg']:.3f} deg, {c['seconds']:.3f} s"
              + (f", {c['launches']} nn_search launches = 6 x {c['between_refinements']} "
                 "refinements" if c["launches"] is not None else ""))


def run_profile_e2e(device, duration: float = 10.0, scan_hz: float = 10.0) -> dict:
    """Phase 13c: tools/profile_e2e at its defaults (two passes of
    duration x scan_hz scans of 20,000 points)."""
    from glim_tpu_torch.tools import profile_e2e

    _release_pipelines()
    return profile_e2e.run(duration, scan_hz, device)


def check_profile_e2e(res: dict) -> None:
    """Phase 13c's failure conditions: finite scans/s with and without the
    drain, the three workers' spans in the sustained table, a drain table."""
    if not (np.isfinite(res["scans_per_s"]) and np.isfinite(res["with_drain_scans_per_s"])
            and res["scans_per_s"] > 0):
        raise AssertionError(f"profile_e2e: scans/s {res['scans_per_s']}, with the drain "
                             f"{res['with_drain_scans_per_s']}")
    missing = [k for k in WORKER_SPANS if k not in res["scopes"]]
    if missing or not res["drain_scopes"]:
        raise AssertionError(f"profile_e2e: spans missing {missing}, drain table "
                             f"{sorted(res['drain_scopes'])}")


def _print_profile_e2e(res: dict, card: str) -> None:
    print("profile_e2e: " + json.dumps(res))
    print(f"profile_e2e [{card}]: sustained {res['scans_per_s']:.4f} scans/s "
          f"({res['sustained_s']:.3f} s for {res['scans']} scans), drain {res['drain_s']:.3f} s, "
          f"with-drain {res['with_drain_scans_per_s']:.4f} scans/s; "
          + ", ".join(f"{k} {res['scopes'][k]['mean_ms']:.2f} ms x {res['scopes'][k]['n']}"
                      for k in WORKER_SPANS if k in res["scopes"]))


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


# Phase 2's shapes: (name, Q, N, masked share of the targets, of the
# queries), the callers' and a ragged one (last).
NN_CHECKS = (("main Q=16384 N=131072", 16384, 131072, 0.3, 0.05),
             ("main Q=4096 N=131072", 4096, 131072, 0.3, 0.05),
             ("between refinement Q=N=4096", 4096, 4096, 0.05, 0.05),
             ("CT iVox Q=16384 N=65536", 16384, 65536, 0.3, 0.05),
             ("sub-mapping between information Q=N=16384", 16384, 16384, 0.39, 0.39),
             ("pose-graph inlier fraction Q=N=10923", 10923, 10923, 0.24, 0.24),
             ("pose-graph ring Q=N=2048", 2048, 2048, 0.05, 0.05),
             ("manual loop close Q=N=65536", 65536, 65536, 0.0, 0.0),
             ("sharded GICP linearize Q=2048 N=131072", 2048, 131072, 0.3, 0.05),
             ("ragged Q=1000 N=3001", 1000, 3001, 0.3, 0.05))


def _nn_case(gen, Q, N, masked=0.3, scale=20.0, q_masked=0.05):
    dev = torch.device("cuda")
    q = (torch.rand(Q, 3, generator=gen, device=dev) - 0.5) * scale
    t = (torch.rand(N, 3, generator=gen, device=dev) - 0.5) * scale
    qm = torch.rand(Q, generator=gen, device=dev) >= q_masked
    tm = torch.rand(N, generator=gen, device=dev) >= masked
    return q, qm, t, tm


def _runner_up_gap(q, qm, t, tm):
    """Gap between the two smallest d2 per query (plain torch, tiled)."""
    t_sq = torch.where(tm, (t * t).sum(-1), float("inf"))
    gaps = []
    for s in range(0, q.shape[0], 512):
        qq = q[s:s + 512]
        d2 = torch.addmm((qq * qq).sum(-1, keepdim=True) + t_sq[None], qq, t.T, alpha=-2.0)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        gaps.append(two[:, 1] - two[:, 0])
    return torch.cat(gaps)


def _compare(name, q, qm, t, tm, nn_search, nn_search_plain):
    idx_k, d2_k = nn_search(q, qm, t, tm)
    torch.cuda.synchronize()
    idx_p, d2_p = nn_search_plain(q, qm, t, tm)
    bound = REL_TOL * torch.clamp(d2_p, min=1.0)
    valid = qm
    err = torch.where(valid, (d2_k - d2_p).abs(), 0.0)
    decisive = valid & (_runner_up_gap(q, qm, t, tm) > bound)
    same = idx_k == idx_p
    if not bool((err <= bound).all()):
        w = int(torch.argmax(err - bound))
        raise AssertionError(
            f"{name}: d2 disagrees, max err {float(err.max())}; worst query {w}: d2 "
            f"{float(d2_k[w])} (kernel) / {float(d2_p[w])} (plain), idx {int(idx_k[w])} / "
            f"{int(idx_p[w])}, |q|^2 {float((q[w] * q[w]).sum())}")
    if not bool(same[decisive].all()):
        raise AssertionError(f"{name}: {int((~same & decisive).sum())} decisive index mismatches")
    if not bool((idx_k[~qm] == 0).all() and torch.isinf(d2_k[~qm]).all()):
        raise AssertionError(f"{name}: invalid queries must return (0, inf)")
    rate = float(same[valid].float().mean())
    print(f"nn_search {name}: index match {rate:.6f} over {int(valid.sum())} valid "
          f"queries ({int(decisive.sum())} decisive, all equal), max |d2 err| "
          f"{float(err.max()):.3e}")
    return float(err.max())


def _time(fn, n):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _host_us(fn, n):
    """Host time to enqueue one call (us), the card's queue left to drain."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _sm_clock_under(fn, n):
    """The SM clocks (MHz) that nvidia-smi samples while ``fn`` runs n times."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.3)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
    return [int(v) for v in smi.communicate()[0].split()]


def check_nn_search() -> float:
    """Phase 2: build the kernel, then hold it against the plain version at
    the main path's shapes, a ragged case, the duplicate cases (ties must go
    to the lowest index: inside one chunk, across chunks, across the split
    boundaries that the launch geometry picks, and inside one thread's query
    rows) and a query set with one valid target. Returns the max |d2 error|."""
    from glim_tpu_torch.ops import nn_search as nn
    from glim_tpu_torch.utils import cuda_build

    search, plain = nn.nn_search, nn.nn_search_plain
    t0 = time.perf_counter()
    search(*_nn_case(torch.Generator(device="cuda").manual_seed(9), 256, 2048))
    torch.cuda.synchronize()
    print(f"nn_search kernel built and launched in {time.perf_counter() - t0:.2f} s")
    for line in cuda_build.build_logs.get("nn_search", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for name, Q, N, masked, q_masked in NN_CHECKS:
        max_err = max(max_err, _compare(name, *_nn_case(gen, Q, N, masked, q_masked=q_masked),
                                        search, plain))

    def lowest_wins(name, case, rows, want):
        max_err = _compare(name, *case, search, plain)
        idx_k, _ = search(*case)
        if not bool((idx_k[rows] == want).all()):
            raise AssertionError(f"{name}: the lowest index must win")
        print(f"nn_search {name}: lowest index returned for all {len(rows)} duplicated targets")
        return max_err

    dev = torch.device("cuda")
    q, qm, t, tm = _nn_case(gen, 512, 4096, masked=0.0)
    t[2000:2100] = t[100:200]
    q[:100] = t[100:200]
    qm[:] = True
    max_err = max(max_err, lowest_wins("duplicates Q=512 N=4096", (q, qm, t, tm),
                                       torch.arange(100, device=dev),
                                       torch.arange(100, 200, device=dev)))
    # The duplicated targets below lie within 2.5 m of the origin: a query
    # on a target must find it (d2 = 0), and the expansion that picks it
    # rounds at a few ulp of 2|t|^2, far under the next target's d2.
    # Both copies of 64 targets on either side of the middle split boundary,
    # at every caller's shape (but the ragged one).
    def across_split(Q, N, masked, q_masked):
        _, splits, split_len = nn.launch_geometry(Q, N, nn._sm_count(0))
        b = split_len * (splits // 2)
        q, qm, t, tm = _nn_case(gen, Q, N, masked, q_masked=q_masked)
        t[b - 64:b] *= 0.25
        t[b:b + 64] = t[b - 64:b]
        tm[b - 64:b + 64] = True
        q[:64] = t[b - 64:b]
        qm[:64] = True
        return lowest_wins(
            f"duplicates across split boundary {b} (Q={Q} N={N}, S={splits})", (q, qm, t, tm),
            torch.arange(64, device=dev), torch.arange(b - 64, b, device=dev))

    for _, Q, N, masked, q_masked in NN_CHECKS[:-1]:
        max_err = max(max_err, across_split(Q, N, masked, q_masked))
    # One thread's query rows (block 3, thread 5): row r's target a_r has
    # copies at a_r + 1 and a_r + 3 (its chunk) and a_r + 11 (the next);
    # the last row asks for row 0's target.
    rows = (3 * nn.QUERIES_PER_BLOCK + 5
            + nn.QUERY_THREADS * torch.arange(nn.QUERY_ROWS, device=dev))
    a = 70000 + 16 * torch.arange(nn.QUERY_ROWS, device=dev)
    q, qm, t, tm = _nn_case(gen, 16384, 131072)
    t[a] *= 0.25
    for off in (1, 3, 11):
        t[a + off] = t[a]
        tm[a + off] = True
    tm[a] = True
    want = a.clone()
    want[-1] = a[0]
    q[rows] = t[want]
    qm[rows] = True
    max_err = max(max_err, lowest_wins("duplicates in one thread's query rows",
                                       (q, qm, t, tm), rows, want))
    # Every target masked but one.
    q, qm, t, tm = _nn_case(gen, 4096, 131072)
    tm[:] = False
    tm[77777] = True
    max_err = max(max_err, lowest_wins("one valid target Q=4096 N=131072", (q, qm, t, tm),
                                       torch.nonzero(qm).flatten(), 77777))
    return max_err


def _nn_search_v1(src):
    """The one-thread-per-query kernel of the first port (its C interface
    and its wrapper's packing), built from ``src`` for an A/B in one call."""
    import ctypes

    from glim_tpu_torch.utils import cuda_build

    lib = cuda_build.load_kernel_library("nn_search_v1", src)
    lib.glim_nn_search.restype = ctypes.c_int
    lib.glim_nn_search.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                   + [ctypes.c_void_p] * 3)

    def run(q, qm, t, tm):
        t_sq = torch.where(tm, torch.sum(t * t, dim=-1), float("inf"))
        xyzw = torch.cat([t, t_sq[:, None]], dim=1).contiguous()
        idx = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
        d2 = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
        rc = lib.glim_nn_search(q.data_ptr(), qm.data_ptr(), xyzw.data_ptr(), q.shape[0],
                                t.shape[0], idx.data_ptr(), d2.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nn_search v1 launch failed ({rc})")
        return idx, d2
    return run


# The H100's published peaks (SXM, 700 W): FP32 outside the tensor cores and
# HBM3. nn_search costs 8 flops a (valid query, valid target) pair.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
NN_FLOPS_PER_PAIR = 8


def nn_bound_ms(q, qm, t, tm):
    """Least time for the search on these inputs: each input read and each
    output written once, over the memory rate, against the valid pairs'
    flops over the FP32 rate."""
    Q, N = q.shape[0], t.shape[0]
    by_bytes = (Q * (12 + 1) + N * (12 + 1) + Q * 8) / PEAK_BYTES
    by_ops = NN_FLOPS_PER_PAIR * int(qm.sum()) * int(tm.sum()) / PEAK_FP32
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes > by_ops else "operations"


# Phase 3's shapes: (Q, N, masked share of the targets, of the queries, key
# suffix).
NN_SHAPES = ((16384, 131072, 0.3, 0.05, ""), (4096, 131072, 0.3, 0.05, "_q4096"),
             (4096, 4096, 0.05, 0.05, "_q4096_n4096"), (16384, 65536, 0.3, 0.05, "_n65536"),
             (16384, 16384, 0.39, 0.39, "_q16384_n16384"),
             (10923, 10923, 0.24, 0.24, "_n10923"), (2048, 2048, 0.05, 0.05, "_n2048"),
             (65536, 65536, 0.0, 0.0, "_q65536_n65536"), (2048, 131072, 0.3, 0.05, "_q2048"))


def time_nn_search(card: str, v1_src=None) -> dict:
    """Phase 3: CUDA-event times at the callers' shapes, in turns
    (plain, [v1,] kernel, kernel, [v1,] plain), each with its bound and
    share, then the host time to enqueue a call; ``v1_src`` adds the first
    port's kernel built from that source."""
    from glim_tpu_torch.ops.nn_search import nn_search, nn_search_plain

    v1 = _nn_search_v1(v1_src) if v1_src else None
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for Q, N, masked, q_masked, sfx in NN_SHAPES:
        case = _nn_case(gen, Q, N, masked, q_masked=q_masked)
        kern, plain = (lambda: nn_search(*case)), (lambda: nn_search_plain(*case))
        _time(kern, 3), _time(plain, 1)                       # warm-up
        p1 = _time(plain, 5)
        if v1:
            v1_fn = lambda: v1(*case)
            _time(v1_fn, 3)
            a1 = _time(v1_fn, 20)
        k1, k2 = _time(kern, 50), _time(kern, 50)
        if v1:
            a2 = _time(v1_fn, 20)
        p2 = _time(plain, 5)
        h1 = _host_us(kern, 50)
        if v1:
            hv = _host_us(v1_fn, 50)
        h2 = _host_us(kern, 50)
        bound, by = nn_bound_ms(*case)
        ms = (k1 + k2) / 2
        out.update({f"ms{sfx}": ms, f"plain_ms{sfx}": (p1 + p2) / 2, f"bound_ms{sfx}": bound,
                    f"bound_share{sfx}": bound / ms, f"bound_by{sfx}": by,
                    f"host_us{sfx}": (h1 + h2) / 2})
        line = (f"nn_search Q={Q} N={N} [{card}]: kernel {k1:.4f} / {k2:.4f} ms, plain "
                f"{p1:.3f} / {p2:.3f} ms, bound {bound:.4f} ms ({by}), share "
                f"{bound / ms:.3f}, host enqueue {h1:.1f} / {h2:.1f} us a call")
        if v1:
            out.update({f"v1_ms{sfx}": (a1 + a2) / 2, f"v1_host_us{sfx}": hv})
            line += (f"; v1 {a1:.4f} / {a2:.4f} ms, share {bound / ((a1 + a2) / 2):.3f}, "
                     f"host enqueue {hv:.1f} us a call")
        print(line)
        if not sfx:
            clocks = _sm_clock_under(kern, 4000)
            seen = f"{min(clocks)}-{max(clocks)} MHz" if clocks else "not read"
            print(f"nn_search Q=16384: SM clock {seen} over {len(clocks)} samples "
                  "during 4000 calls")
    # No single PyTorch call computes a masked k=1 search with this tie rule
    # (torch.cdist then min is two calls and a 16384 x 131072 matrix).
    out.update(library_ms=None)
    return out


def _print_default(res: dict, card: str, tag: str = "default") -> None:
    print(f"{tag}: " + json.dumps(res))
    print(f"{tag} [{card}]: {res['scans']} scans in {res['seconds']:.2f} s = "
          f"{res['scans_per_s']:.3f} scans/s, ATE {res['ate']:.4f} m, max memory "
          f"{res['max_memory_allocated'] / 2**20:.1f} MiB, {res['kf_inserts']} odometry "
          f"keyframe inserts / {res['kf_evictions']} evictions, {res['submaps']} submaps, "
          f"frames per submap {res['frames_per_submap']}, {res['optimizes']} optimizes, "
          f"{res['matching_factors']} matching factors, submap-origin ATE "
          f"{res['submap_ate']} m")


def _print_ring(res: dict, card: str) -> None:
    for row in res["rows"]:
        print("ring: " + json.dumps(row))
    for row in res["rows"]:
        print(f"ring [{card}]: {row['submaps']} submaps, {row['factors']} factors, insert "
              f"{row['insert_mean_ms']:.2f} ms, optimize {row['optimize_mean_ms']:.2f} ms "
              f"(steady {row['optimize_steady_ms']:.2f} ms), ATE {row['ate_rmse_m']:.4f} m")
    print(f"ring [{card}]: {res['submaps']} submaps in {res['seconds']:.2f} s, "
          f"{res['factors']} matching factors (the JAX back-end: {RING_JAX_FACTORS}), "
          f"{res['factors_after_sweep']} after the final overlap sweep, ATE "
          f"pre-closure {res['ate_pre_closure_m']:.6f} m, post-closure "
          f"{res['ate_post_closure_m']:.6f} m")


GLOBAL_SPANS = ("global/insert_submap", "global/ins.covs", "global/ins.voxelmap",
                "global/ins.matching_factors", "global/ins.between_gicp",
                "global/ins.imu_factor", "global/optimize", "global/opt.args", "global/opt.gn",
                "global/opt.refresh", "global_gn", "vgicp_lookup_stacked", "gicp_linearize")
SPANS = ("preprocess", "odometry", "window_scan_step", "odom/kf_insert", "odom/kf_evict",
         "rebuild_level", "sub_mapping", "sub/process_frame", "sub/kf_insert",
         "sub/create_submap", "vgicp_lookup", "linearize_core_soa", "voxelmap_insert",
         "global_mapping") + GLOBAL_SPANS


def _sync_site() -> str:
    """The two innermost frames of this repository's code on the stack."""
    import traceback
    ours = [f"{os.path.relpath(fr.filename)}:{fr.lineno} ({fr.name})"
            for fr in traceback.extract_stack()
            if ("glim_tpu_torch" in fr.filename or "chip_smoke" in fr.filename)
            and fr.name not in ("_sync_site", "on_sync_warning", "counted_read")]
    return " <- ".join(reversed(ours[-2:])) or "?"


class _GlobalStageMeter:
    """Host-clock ms (up to a device sync) of every global-mapping insert,
    without the optimize it triggers, and of every optimize, over a whole
    run: GlobalMapping's two entry points are wrapped while it is open."""

    NAMES = ("insert_submap", "optimize")

    def __enter__(self):
        from glim_tpu_torch.mapping.global_mapping import GlobalMapping
        self.cls = GlobalMapping
        self.orig = {n: getattr(GlobalMapping, n) for n in self.NAMES}
        self.ms = {n: [] for n in self.NAMES}
        self.nested = []
        for n in self.NAMES:
            setattr(GlobalMapping, n, self._timed(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.cls, n, fn)

    def _timed(self, name):
        fn = self.orig[name]

        def timed(gm, *args, **kwargs):
            torch.cuda.synchronize()
            self.nested.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(gm, *args, **kwargs)
            finally:
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                inner = self.nested.pop()
                self.ms[name].append(ms - inner)
                if self.nested:
                    self.nested[-1] += ms
        return timed

    def summary(self) -> str:
        parts = []
        for n, label in (("insert_submap", "inserts (without their optimize)"),
                         ("optimize", "optimizes")):
            v = self.ms[n]
            parts.append(f"{len(v)} {label}: host ms mean {np.mean(v):.1f}, max {np.max(v):.1f}"
                         if v else f"0 {label}")
        return "global mapping over the whole run (host clock to a device sync): " + \
            "; ".join(parts)


def profile_default(card: str, out_dir: str = "build", n_scans: int = 100,
                    steady=(60, 80), prof=(80, 90), sync=(90, 95),
                    name: str = "default", overrides=None, min_evictions: int = 0) -> None:
    """The default configuration (or, with name "gicp", phase 4's GICP
    slice): host-clock ms/scan over scans [steady), a torch.profiler window
    over scans [prof) and a set_sync_debug_mode ("warn") count over scans
    [sync), which also counts the pinned-copy reads that had to wait for
    their copy. The tables go to out_dir/profile_<name>.txt. ``overrides``
    and ``min_evictions`` as for run_default and check_default (phase 5b's
    run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from glim_tpu_torch import types as t_types

    state = dict(sites=Counter(), waits=Counter())
    read = t_types.HostCopy.numpy

    def counted_read(self):
        if state.get("counting") and not self.ready():
            state["waits"][_sync_site()] += 1
        return read(self)

    def on_sync_warning(message, *args, **kwargs):
        if state.get("counting") and "synchroniz" in str(message):
            state["sites"][_sync_site()] += 1

    def mark(i):
        torch.cuda.synchronize()
        state[i] = time.perf_counter()

    def on_scan(i):
        if i in (steady[0], steady[1], prof[0], prof[1]):
            mark(i)
        if i == prof[0]:
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].__enter__()
        if i == prof[1]:
            state["prof"].__exit__(None, None, None)
        if i == sync[0]:
            state["warn"] = warnings.catch_warnings()
            state["warn"].__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = on_sync_warning
            torch.cuda.set_sync_debug_mode("warn")
            state["counting"] = True
        if i == sync[1]:
            state["counting"] = False
            torch.cuda.set_sync_debug_mode(0)
            state["warn"].__exit__(None, None, None)

    t_types.HostCopy.numpy = counted_read
    try:
        with _GlobalStageMeter() as meter:
            if name == "gicp":
                res = run_slice("cuda", n_scans=n_scans, on_scan=on_scan)
            else:
                res = run_default("cuda", n_scans=n_scans, overrides=overrides,
                                  on_scan=on_scan)
    finally:
        t_types.HostCopy.numpy = read
    if name == "gicp":
        check_slice(res, name, min_window_steps=n_scans // 2)
        print("gicp: " + json.dumps(res))
    else:
        check_default(res, name, min_evictions, global_mapping=not min_evictions)
        _print_default(res, card, name)
    n_prof, n_sync = prof[1] - prof[0], sync[1] - sync[0]
    steady_ms = (state[steady[1]] - state[steady[0]]) * 1e3 / (steady[1] - steady[0])
    prof_ms = (state[prof[1]] - state[prof[0]]) * 1e3 / n_prof

    evs = state["prof"].events()

    def dev_self(e):
        v = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if v is None else v

    kernels = [e for e in evs if e.device_type == DeviceType.CUDA and e.name not in SPANS]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_prof
    by_kernel = {}
    for e in kernels:
        t, c = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    launches = sum(1 for e in evs if e.device_type == DeviceType.CPU
                   and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))

    def subtree_dev_us(e):
        return dev_self(e) + sum(subtree_dev_us(c) for c in e.cpu_children)

    span_rows = {}
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name in SPANS:
            h, d, c = span_rows.get(e.name, (0.0, 0.0, 0))
            span_rows[e.name] = (h + e.time_range.elapsed_us(), d + subtree_dev_us(e), c + 1)

    lines = [f"card: {card}", f"run: {name}, overrides {overrides or []}",
             f"steady scans {steady[0]}-{steady[1] - 1}, no profiler: {steady_ms:.1f} ms/scan",
             f"profile window: scans {prof[0]}-{prof[1] - 1} ({n_prof} scans), wall "
             f"{prof_ms:.1f} ms/scan under the profiler, device kernel time {dev_ms:.2f} ms/scan, "
             f"busy share {dev_ms / prof_ms:.4f} of the profiled wall, "
             f"{dev_ms / steady_ms:.4f} of the unprofiled ms/scan; kernel launches "
             f"{launches / n_prof:.1f}/scan",
             "span: host ms/scan, device kernel ms/scan, calls/scan"]
    for k in SPANS:
        if k in span_rows:
            h, d, c = span_rows[k]
            lines.append(f"  {k}: {h / 1e3 / n_prof:.2f}, {d / 1e3 / n_prof:.2f}, {c / n_prof:.1f}")
    lines.append("top device kernels: ms/scan, calls/scan, name")
    for kname, (t, c) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]:
        lines.append(f"  {t / 1e3 / n_prof:.3f}  {c / n_prof:.1f}  {kname[:110]}")
    n_s, n_w = sum(state["sites"].values()), sum(state["waits"].values())
    lines.append(f"host syncs (set_sync_debug_mode warn) over scans {sync[0]}-{sync[1] - 1}: "
                 f"{n_s / n_sync:.1f}/scan")
    for site, c in state["sites"].most_common():
        lines.append(f"  {c / n_sync:.1f}/scan  {site}")
    lines.append(f"pinned-copy reads that waited for their copy: {n_w / n_sync:.1f}/scan")
    for site, c in state["waits"].most_common():
        lines.append(f"  {c / n_sync:.1f}/scan  {site}")
    lines.append(meter.summary())
    lines.append("top host ops (self CPU ms/scan, calls/scan):")
    for e in sorted(state["prof"].key_averages(), key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:20]:
        lines.append(f"  {e.self_cpu_time_total / 1e3 / n_prof:.2f}  {e.count / n_prof:.1f}  "
                     f"{e.key[:90]}")
    text = "\n".join(lines)
    print(text)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(text + "\n")


LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def profile_ring(card: str, out_dir: str = "build", n_submaps: int = RING_SUBMAPS,
                 prof=(96, 112), sync=(112, 120)) -> None:
    """Phase 5c's ring with a torch.profiler window over inserts [prof) and
    a set_sync_debug_mode ("warn") count over inserts [sync): host and
    device ms, kernel launches and host syncs per insert (without its
    optimize) and per optimize, and per global span. The table goes to
    out_dir/profile_ring.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks

    state = dict(sites=Counter(), opt=0, ins=0, optimizes=0)

    def in_optimize():
        import traceback
        return any(fr.name == "_optimize_impl" for fr in traceback.extract_stack())

    def on_sync_warning(message, *args, **kwargs):
        if state.get("counting") and "synchroniz" in str(message):
            state["opt" if in_optimize() else "ins"] += 1
            state["sites"][_sync_site()] += 1

    def on_result(*_):
        if state.get("counting"):
            state["optimizes"] += 1

    def on_insert(k, gm):
        torch.cuda.synchronize()
        if k == prof[0]:
            state["t0"] = time.perf_counter()
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].__enter__()
        if k == prof[1]:
            state["prof"].__exit__(None, None, None)
            state["wall_ms"] = (time.perf_counter() - state["t0"]) * 1e3
        if k == sync[0]:
            state["warn"] = warnings.catch_warnings()
            state["warn"].__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = on_sync_warning
            torch.cuda.set_sync_debug_mode("warn")
            state["counting"] = True
        if k == sync[1]:
            state["counting"] = False
            torch.cuda.set_sync_debug_mode(0)
            state["warn"].__exit__(None, None, None)

    handle = GlobalMappingCallbacks.on_smoother_update_result.add(on_result)
    try:
        res = run_ring("cuda", n_submaps, on_insert=on_insert)
    finally:
        GlobalMappingCallbacks.on_smoother_update_result.remove(handle)
    check_ring(res)
    _print_ring(res, card)

    evs = state["prof"].events()

    def dev_self(e):
        v = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if v is None else v

    def subtree(e):
        """(device us, kernel launches) of an op and everything under it."""
        d, n = dev_self(e), int(e.name in LAUNCH_NAMES)
        for c in e.cpu_children:
            cd, cn = subtree(c)
            d, n = d + cd, n + cn
        return d, n

    rows = {}
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name in GLOBAL_SPANS:
            h, d, n, c = rows.get(e.name, (0.0, 0.0, 0, 0))
            sd, sn = subtree(e)
            rows[e.name] = (h + e.time_range.elapsed_us(), d + sd, n + sn, c + 1)
    n_ins = prof[1] - prof[0]
    ins = rows.get("global/insert_submap", (0.0, 0.0, 0, 0))
    opt = rows.get("global/optimize", (0.0, 0.0, 0, 1))
    n_opt = max(opt[3], 1)
    n_sync_ins = sync[1] - sync[0]
    lines = [f"card: {card}",
             f"run: the drifting ring, {n_submaps} submaps, optimize every 4 inserts; profile "
             f"window inserts {prof[0]}-{prof[1] - 1} ({n_ins} inserts, {opt[3]} optimizes), "
             f"wall {state['wall_ms'] / n_ins:.1f} ms an insert under the profiler",
             f"insert without its optimize: host {(ins[0] - opt[0]) / 1e3 / n_ins:.2f} ms, "
             f"device {(ins[1] - opt[1]) / 1e3 / n_ins:.3f} ms, "
             f"{(ins[2] - opt[2]) / n_ins:.1f} launches",
             f"optimize: host {opt[0] / 1e3 / n_opt:.2f} ms, device {opt[1] / 1e3 / n_opt:.3f} ms, "
             f"{opt[2] / n_opt:.1f} launches",
             "span: calls, host ms/call, device ms/call, launches/call"]
    for k in GLOBAL_SPANS:
        if k in rows:
            h, d, n, c = rows[k]
            lines.append(f"  {k}: {c}, {h / 1e3 / c:.2f}, {d / 1e3 / c:.3f}, {n / c:.1f}")
    lines.append(f"host syncs (set_sync_debug_mode warn) over inserts {sync[0]}-{sync[1] - 1}: "
                 f"{state['ins'] / n_sync_ins:.2f} an insert outside optimize, "
                 f"{state['opt'] / max(state['optimizes'], 1):.2f} an optimize "
                 f"({state['optimizes']} optimizes)")
    for site, c in state["sites"].most_common():
        lines.append(f"  {c}  {site}")
    lines.append("top device kernels: ms an insert, calls an insert, name")
    by_kernel = {}
    for e in evs:
        if e.device_type == DeviceType.CUDA and e.name not in SPANS:
            t, c = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for kname, (t, c) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]:
        lines.append(f"  {t / 1e3 / n_ins:.3f}  {c / n_ins:.1f}  {kname[:110]}")
    text = "\n".join(lines)
    print(text)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_ring.txt"), "w") as f:
        f.write(text + "\n")


def profile_async(card: str, out_dir: str = "build", n_scans: int = 100,
                  prof=(60, 80)) -> None:
    """Phase 6's pipeline (the default configuration, GlimTorch's async
    workers, fed in memory with workload backpressure) with a
    torch.profiler window over scans [prof), opened and closed on the
    feeding thread: which spans the profiler recorded and on how many
    threads, host ms per span, and the device's kernel ms and busy share
    of the window. The table goes to out_dir/profile_async.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = {}

    def on_scan(i):
        if i == prof[0]:
            torch.cuda.synchronize()
            state["t0"] = time.perf_counter()
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].__enter__()
        if i == prof[1]:
            torch.cuda.synchronize()
            state["prof"].__exit__(None, None, None)
            state["wall_ms"] = (time.perf_counter() - state["t0"]) * 1e3

    res = run_default("cuda", n_scans=n_scans, on_scan=on_scan, async_mode=True)
    check_default(res, "async profile")
    evs = state["prof"].events()
    n = prof[1] - prof[0]
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA and e.name not in SPANS]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    launches = sum(1 for e in evs if e.device_type == DeviceType.CPU and e.name in LAUNCH_NAMES)
    rows = {}
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name in SPANS:
            h, c, threads = rows.get(e.name, (0.0, 0, set()))
            rows[e.name] = (h + e.time_range.elapsed_us(), c + 1, threads | {e.thread})
    threads = {e.thread for e in evs if e.device_type == DeviceType.CPU}
    lines = [f"card: {card}",
             f"run: the default configuration, async, {n_scans} scans ({res['scans_per_s']:.4f} "
             f"scans/s, {res['optimizes']} optimizes); profile window scans {prof[0]}-"
             f"{prof[1] - 1} on the feeding thread: wall {state['wall_ms'] / n:.1f} ms a scan, "
             f"device kernel time {dev_ms / n:.2f} ms a scan, busy share "
             f"{dev_ms / state['wall_ms']:.4f}, {launches / n:.1f} kernel launches a scan, CPU "
             f"events on {len(threads)} threads",
             "span: host ms a scan, calls a scan, threads"]
    for k in SPANS:
        if k in rows:
            h, c, th = rows[k]
            lines.append(f"  {k}: {h / 1e3 / n:.2f}, {c / n:.2f}, {len(th)}")
    missing = [k for k in ("preprocess", "odometry", "window_scan_step", "sub_mapping",
                           "global_mapping") if k not in rows]
    lines.append(f"spans not recorded in the window: {missing or 'none'}")
    text = "\n".join(lines)
    print(text)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_async.txt"), "w") as f:
        f.write(text + "\n")


def ab_async(card: str, order=(False, True, True, False)) -> list:
    """Phase 5's run (150 full-size scans of the default configuration)
    through GlimTorch sync and async in turns (sync, async, async, sync by
    default) in one call: whole-run scans/s of each, to set the async
    pipeline's ratio against the host's own spread."""
    rows = []
    for async_mode in order:
        res = run_default("cuda", async_mode=async_mode)
        check_default(res, "async" if async_mode else "sync")
        rows.append(dict(async_mode=async_mode, scans_per_s=res["scans_per_s"],
                         seconds=res["seconds"], submaps=res["submaps"],
                         optimizes=res["optimizes"], ate=res["ate"],
                         max_memory_mib=res["max_memory_allocated"] / 2**20))
        print(f"ab [{card}]: " + json.dumps(rows[-1]))
    return rows


_ASYNC_PHASES = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as c
a = c.run_async_default("cuda")
c.check_async(a)
e = c.run_extensions("cuda")
c.check_extensions(e)
print("AB " + json.dumps(dict(phase6_scans_per_s=a["scans_per_s"], phase6_ate=a["ate"],
                              phase11a_scans_per_s=e["scans_per_s"], phase11a_ate=e["ate"])))
"""


def ab_async_phases(card: str, parent_dir: str) -> list:
    """Phases 6 and 11a of the tree in ``parent_dir`` and of this one, each
    run in a fresh process from its tree's root, parent / change / change /
    parent: their scans/s and ATEs, to compare the two commits' async
    pipelines on one card in one call."""
    here = os.path.dirname(os.path.abspath(__file__))
    rows = []
    for tree, d in (("parent", parent_dir), ("change", here), ("change", here),
                    ("parent", parent_dir)):
        out = subprocess.run([sys.executable, "-c", _ASYNC_PHASES], cwd=d, check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        line = [ln for ln in out.splitlines() if ln.startswith("AB ")][-1]
        rows.append(dict(tree=tree, **json.loads(line[3:])))
        print(f"ab-async [{card}]: " + json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--eval"]:
        from glim_tpu_torch.tools import run_eval
        card = _card()
        print(card)
        out = args[1] if len(args) > 1 else os.path.join("build", "EVAL_TORCH.md")
        run_eval.main(["--matrix", "--window-study", "--device", "cuda", "--out", out])
        with open(out) as f:
            print(f.read())
        return 0
    if args[:1] == ["--debug-backend"]:
        card = _card()
        print(card)
        res = run_debug_backend("cuda", duration=None, which=DEBUG_ALL)
        _print_debug_backend(res, card)
        check_debug_backend(res)
        return 0
    if args[:1] == ["--ab-async"]:
        card = _card()
        print(card)
        ab_async_phases(card, args[1])
        return 0
    if args[:1] == ["--profile"]:
        card = _card()
        print(card)
        profile_default(card, *args[1:2])
        profile_default(card, *args[1:2], name="evict", overrides=EVICT_OVERRIDES,
                        min_evictions=1)
        profile_default(card, *args[1:2], name="gicp")
        profile_ring(card, *args[1:2])
        profile_async(card, *args[1:2])
        return 0
    phase_s, clock = {}, [time.perf_counter()]

    def done(name):
        """Phase ``name`` ended: its seconds since the previous one ended."""
        now = time.perf_counter()
        phase_s[name] = round(now - clock[0], 1)
        clock[0] = now

    # --- 1. the card ---
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind} x{torch.cuda.device_count()}; python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    done("1")

    # --- 2. build + correctness at the main path's shapes ---
    max_err = check_nn_search()
    done("2")

    # --- 3. timing at the main path's shapes ---
    v1_src = args[args.index("--nn-v1") + 1] if "--nn-v1" in args else None
    timing = time_nn_search(card, v1_src)
    done("3")

    # --- 4. the GICP slice (odometry + the CPU back-end) on the card ---
    res = run_slice("cuda")
    print("slice: " + json.dumps(res))
    print(f"slice [{card}]: {res['scans']} scans in {res['seconds']:.2f} s = "
          f"{res['scans_per_s']:.2f} scans/s, {res['window_steps']} window steps, "
          f"{res['kernel_launches']} nn_search launches ({res['between_launches']} in "
          f"{res['between_refinements']} between refinements), ATE {res['ate']:.4f} m, "
          f"{res['submaps']} submaps, submap-origin ATE {res['submap_ate']} m, "
          f"max memory {res['max_memory_allocated'] / 2**20:.1f} MiB")
    check_slice(res)
    done("4")

    # --- 5. the default configuration on the card ---
    dres = run_default("cuda")
    _print_default(dres, card)
    print(f"default [{card}]: nn_search launches {dres['kernel_launches']} "
          "(the VGICP path runs no hand-written kernel)")
    check_default(dres)
    done("5")

    # --- 5b. odometry keyframe eviction at full size ---
    eres = run_default("cuda", n_scans=EVICT_SCANS, overrides=EVICT_OVERRIDES)
    _print_default(eres, card, "evict")
    check_default(eres, "eviction run", min_evictions=1, global_mapping=False)
    done("5b")

    # --- 5c. loop closure on the 128-submap drifting ring ---
    from glim_tpu_torch.ops.nn_search import nn_search
    nn_search.kernel_launches = 0
    rres = run_ring("cuda")
    ring_launches = nn_search.kernel_launches
    _print_ring(rres, card)
    check_ring(rres)
    done("5c")

    # --- 5d. the same ring through the pose-graph back-end ---
    pres = run_pose_graph_ring("cuda")
    _print_pose_graph_ring(pres, card)
    check_pose_graph_ring(pres)
    done("5d")

    # --- 6. the async runner at full size, its dump, and the GICP slice async ---
    ares = run_async_default("cuda")
    _print_async(ares, dres, card)
    check_async(ares, dres)
    gres = run_slice("cuda", n_scans=ASYNC_GICP_SCANS, async_mode=True)
    print("async gicp: " + json.dumps(gres))
    print(f"async gicp [{card}]: {gres['scans']} scans in {gres['seconds']:.3f} s = "
          f"{gres['scans_per_s']:.4f} scans/s, {gres['kernel_launches']} nn_search launches "
          f"= 5 x {gres['window_steps']} window steps + 6 x {gres['between_refinements']} "
          f"between refinements, ATE {gres['ate']:.4f} m")
    check_slice(gres, "async GICP slice", min_window_steps=ASYNC_GICP_SCANS // 3)
    done("6")

    # --- 7. the shipped CT, frame-to-model and pass-through configurations ---
    shipped = {}
    for name in SHIPPED:
        shipped[name] = run_shipped("cuda", name)
        _print_shipped(shipped[name], card)
        check_shipped(shipped[name])
    done("7")

    # --- 8. the port's run_eval on figure8_room (EVAL.md's sequence) ---
    fres = run_eval_figure8("cuda")
    print("eval figure8_room: " + json.dumps(fres))
    print(f"eval figure8_room [{card}]: {fres['scans']} raycast scans, ATE {fres['ate']:.4f} m "
          f"(EVAL.md {EVAL_FIGURE8_ATE} m), global ATE {fres['global_ate']} m, "
          f"{fres['scans_per_s']:.3f} scans/s after the warm-up, {fres['submaps']} submaps")
    check_eval_figure8(fres)
    done("8")

    # --- 9. the pose-graph configuration (refined submaps, GICP betweens, loops) ---
    gres9 = run_pose_graph_config("cuda")
    _print_pose_graph_config(gres9, card)
    check_pose_graph_config(gres9)
    done("9")

    # --- 11. extensions, the headless viewer and live corrections (async) ---
    xres = run_extensions("cuda")
    _print_extensions(xres, dres, card)
    check_extensions(xres)
    lres = run_loop_detectors("cuda")
    _print_loop_detectors(lres, card)
    if "--loop-submaps" in args:
        out = args[args.index("--loop-submaps") + 1]
        np.savez_compressed(out, stamps=np.asarray(lres["submap_stamps"]),
                            **{f"points_{i}": p for i, (p, _) in enumerate(lres["submap_clouds"])},
                            **{f"mask_{i}": m for i, (_, m) in enumerate(lres["submap_clouds"])})
    check_loop_detectors(lres)
    cres = run_live_corrections("cuda")
    _print_live_corrections(cres, card)
    check_live_corrections(cres)
    done("11")

    # --- 12. ROS bag playback, the ROS node and the offline map tools ---
    bres = run_bag("cuda")
    try:
        _print_bag(bres, ares, card)
        check_bag(bres, ares)
        nres = run_ros_node("cuda")
        _print_ros_node(nres, card)
        check_ros_node(nres)
        ores = run_offline_tools("cuda", bres["dump"], bres["work_dir"])
        _print_offline_tools(ores, card)
        check_offline_tools(ores)
    finally:
        shutil.rmtree(bres["work_dir"], ignore_errors=True)
    done("12")

    # --- 13. the device mesh, debug_backend and profile_e2e ---
    mres = run_mesh("cuda")
    _print_mesh(mres, card)
    check_mesh(mres)
    dbres = run_debug_backend("cuda")
    _print_debug_backend(dbres, card)
    check_debug_backend(dbres)
    pres13 = run_profile_e2e("cuda")
    _print_profile_e2e(pres13, card)
    check_profile_e2e(pres13)
    done("13")

    # --- 14. summary ---
    print(f"phase seconds [{card}]: " + json.dumps(phase_s))
    print(json.dumps({"kernels": [{
        "name": "nn_search", "route": "cuda",
        "source": "glim_tpu_torch/csrc/nn_search.cu",
        "replaces": "glim_tpu/ops/pallas_knn.py:29",
        "launches": res["kernel_launches"],
        "launches_between_refinement": res["between_launches"],
        "launches_default": dres["kernel_launches"], "launches_ring": ring_launches,
        "launches_async_gicp": gres["kernel_launches"],
        "launches_ct_ivox": shipped["ct_ivox"]["kernel_launches"],
        "launches_lidar_only": shipped["lidar_only"]["kernel_launches"],
        "launches_pose_graph_ring": pres["kernel_launches"],
        "launches_pose_graph": gres9["kernel_launches"],
        "launches_sub_mapping_between": gres9["between_infos"],
        "launches_pose_graph_registrations": gres9["kernel_launches"] - gres9["between_infos"],
        "launches_manual_loop_close": cres["kernel_launches"],
        "launches_extension_loops": lres["kernel_launches"],
        "launches_offline_loop_close": ores["repl_launches"],
        "launches_sharded_gicp": mres["gicp_launches"],
        "launches_debug_backend_between": dbres["configs"]["between"]["launches"],
        "max_abs_err": max_err, **timing}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
