"""Accuracy evaluation suite: the full pipeline over raycast sequences.

    python -m glim_tpu_torch.tools.run_eval [--out build/EVAL_TORCH.md] [--quick]
        [--sequences circle_room,figure8_room,corridor,aggressive,city_loop]
        [--window-study] [--matrix] [--duration 20] [--device cuda|cpu]

Twin of ``glim_tpu/tools/run_eval.py``: runs preprocess -> odometry ->
sub-mapping -> global mapping synchronously over simulated spinning-LiDAR
sequences (``io/synthetic.generate_raycast_sequence``: elevation rings,
azimuth timing, occlusion, exact ground truth), evaluates ATE / RPE with
``io/evaluation``, measures scans/s after a warm-up, and writes a markdown
report to its own file (``--out``), headed by the device it ran on (for the
card: name and power limit as nvidia-smi reports them). The JAX package's
accuracy (``EVAL.md``) stands beside each row.

``--matrix`` sweeps the registry matrix (odometry x sub-mapping x global
back-end) on a 12 s figure-8, each row beside EVAL.md's.
``--window-study`` runs the flagship odometry at four window sizes on an
aggressive figure-8. The pipeline runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import os
import platform
import subprocess
import sys
import time

import numpy as np

SEQUENCES = {
    # name: generator kwargs
    "circle_room": dict(path="circle", scene="room", speed=2.0, radius=10.0),
    "figure8_room": dict(path="figure8", scene="room", speed=2.5, extent=14.0),
    "corridor": dict(path="corridor", scene="corridor", speed=2.0,
                     length=30.0, turn_radius=3.0),
    "aggressive": dict(path="figure8", scene="room", speed=4.0,
                       aggressive=1.0, extent=12.0),
    # Large open loop: only local structure is visible, so odometry drifts
    # over the lap and global mapping's implicit loop closure must pull the
    # ring back together.
    "city_loop": dict(path="circle", scene="blocks", speed=4.0, radius=27.0,
                      extent=27.0, max_range=35.0, duration=47.0),
}

# The JAX package's flagship rows of EVAL.md (odometry ATE, global ATE, m).
EVAL_MD = {"circle_room": (0.0062, 0.0078), "figure8_room": (0.0138, 0.0144),
           "corridor": (0.0215, 0.0215), "aggressive": (0.0220, 0.0267),
           "city_loop": (0.0108, 0.0081)}
# EVAL.md's registry matrix (odometry ATE, global ATE, m).
EVAL_MD_MATRIX = {
    "flagship / full / matching": (0.0179, 0.0174),
    "flagship / full / pose_graph": (0.0179, 0.0179),
    "flagship / passthrough / matching": (0.0179, 0.0172),
    "flagship / passthrough / pose_graph": (0.0179, 0.0179),
    "cpu_gicp / full / matching": (0.0194, 0.0191),
    "cpu_gicp / full / pose_graph": (0.0194, 0.0194),
    "cpu_gicp / passthrough / matching": (0.0194, 0.0187),
    "cpu_gicp / passthrough / pose_graph": (0.0194, 0.0194),
    "cpu_vgicp / full / matching": (0.0171, 0.0166),
    "cpu_vgicp / full / pose_graph": (0.0171, 0.0171),
    "cpu_vgicp / passthrough / matching": (0.0171, 0.0167),
    "cpu_vgicp / passthrough / pose_graph": (0.0171, 0.0171),
    "ct / full / matching": (0.0110, 0.0115),
    "ct / full / pose_graph": (0.0110, 0.0110),
    "ct / passthrough / matching": (0.0110, 0.0117),
    "ct / passthrough / pose_graph": (0.0110, 0.0110),
}
IMU_BIAS = np.array([0.03, -0.02, 0.01, 0.002, -0.001, 0.001])


def _make_odometry(kind, odom_params, device):
    """Registry-matrix odometry factory."""
    if kind == "flagship":
        from glim_tpu_torch.odometry.odometry_estimation_imu import (
            OdometryEstimationIMU, OdometryEstimationIMUParams)
        return OdometryEstimationIMU(
            odom_params or OdometryEstimationIMUParams(
                voxel_resolution=0.5, voxel_capacity=131072,
                initialization_window_size=0.5), device=device)
    if kind in ("cpu_gicp", "cpu_vgicp"):
        from glim_tpu_torch.odometry.odometry_estimation_cpu_imu import (
            OdometryEstimationCPUIMU, OdometryEstimationCPUIMUParams)
        return OdometryEstimationCPUIMU(OdometryEstimationCPUIMUParams(
            registration_type="GICP" if kind == "cpu_gicp" else "VGICP",
            voxel_capacity=131072, initialization_window_size=0.5), device=device)
    if kind == "ct":
        from glim_tpu_torch.odometry.odometry_estimation_ct import (
            OdometryEstimationCT, OdometryEstimationCTParams)
        return OdometryEstimationCT(odom_params or OdometryEstimationCTParams(),
                                    device=device)
    raise ValueError(kind)


def run_sequence(seq, odom_params=None, downsample=10000, pose_graph=False,
                 odometry="flagship", sub_mapping="full", device="cuda"):
    """Full pipeline on one sequence. Returns (metrics, global metrics or
    None, scans_per_sec, extras)."""
    import torch

    from glim_tpu_torch.io.evaluation import evaluate_trajectory
    from glim_tpu_torch.mapping.global_mapping import GlobalMapping, GlobalMappingParams
    from glim_tpu_torch.mapping.global_mapping_pose_graph import (
        GlobalMappingPoseGraph, GlobalMappingPoseGraphParams)
    from glim_tpu_torch.mapping.sub_mapping import SubMapping, SubMappingParams
    from glim_tpu_torch.preprocess.cloud_preprocessor import (CloudPreprocessor,
                                                              CloudPreprocessorParams)

    device = torch.device(device)
    pp = CloudPreprocessor(CloudPreprocessorParams(
        random_downsample_target=downsample, downsample_resolution=0.25), device=device)
    odom = _make_odometry(odometry, odom_params, device)
    if sub_mapping == "passthrough":
        from glim_tpu_torch.mapping.sub_mapping_passthrough import (
            SubMappingPassthrough, SubMappingPassthroughParams)
        sub = SubMappingPassthrough(SubMappingPassthroughParams(
            max_num_keyframes=20, submap_target_num_points=20000), device=device)
    else:
        sub = SubMapping(SubMappingParams(max_num_keyframes=8, keyframe_update_min_points=256),
                         device=device)
    if pose_graph:
        gm = GlobalMappingPoseGraph(GlobalMappingPoseGraphParams(
            min_travel_dist=20.0, max_neighbor_dist=6.0), device=device)
    else:
        gm = GlobalMapping(GlobalMappingParams(voxel_capacity=65536), device=device)

    imu_idx = 0
    ests = []
    margs = []
    n_warm = 14
    t0 = None
    for si, raw in enumerate(seq.scans):
        while imu_idx < len(seq.imu) and seq.imu[imu_idx, 0] <= raw.stamp + 0.12:
            r = seq.imu[imu_idx]
            odom.insert_imu(r[0], r[1:4], r[4:7])
            sub.insert_imu(r[0], r[1:4], r[4:7])
            gm.insert_imu(r[0], r[1:4], r[4:7])
            imu_idx += 1
        new_margs = []
        e = odom.insert_frame(pp.preprocess(raw), new_margs)
        if e is not None:
            ests.append((raw.stamp, e))
        for m in new_margs:
            sub.insert_frame(m)
            margs.append(m)
        for sm in sub.get_submaps():
            gm.insert_submap(sm)
        if si == n_warm:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
    for m in odom.get_remaining_frames():
        if m.stamp > (margs[-1].stamp if margs else -1):
            sub.insert_frame(m)
    for sm in sub.submit_end_of_sequence():
        gm.insert_submap(sm)
    if pose_graph:
        gm.wait_for_detection()
    gm.optimize()
    if pose_graph:
        gm.stop()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - (t0 or time.perf_counter())
    n_timed = max(len(seq.scans) - n_warm - 1, 1)
    sps = n_timed / max(elapsed, 1e-9)

    # Odometry-frame trajectory against the ground truth (aligned: the
    # odometry frame is local).
    stamp_to_gt = {round(s, 4): T for s, T in zip(seq.stamps, seq.gt_poses)}
    est_T = [e.T_world_lidar for _, e in ests]
    gt_T = [stamp_to_gt[round(s, 4)] for s, _ in ests]
    m = evaluate_trajectory(est_T, gt_T, align=True)

    # Globally optimized trajectory: each submap's frames through its
    # optimized origin.
    g_est, g_gt = [], []
    for sm_obj, pose in zip(gm.submaps, gm.poses):
        To = np.linalg.inv(np.asarray(sm_obj.custom_data.get(
            "T_world_origin_pre", sm_obj.T_world_origin)))
        for fr in sm_obj.frames:
            key = round(fr.stamp, 4)
            if key in stamp_to_gt:
                g_est.append(pose @ To @ fr.T_world_sensor())
                g_gt.append(stamp_to_gt[key])
    gmetrics = evaluate_trajectory(g_est, g_gt, align=True) if len(g_est) >= 3 else None
    return m, gmetrics, sps, dict(n_submaps=len(gm.submaps), n_scans=len(seq.scans))


def make_sequence(name, duration, channels=32, azimuth=512, imu_noise=0.02):
    """One of SEQUENCES (city_loop keeps its own duration), seeded by its
    name as the JAX tool seeds it."""
    from glim_tpu_torch.io.synthetic import generate_raycast_sequence

    kw = dict(SEQUENCES[name])
    seq_duration = kw.pop("duration", duration)
    return generate_raycast_sequence(
        duration=seq_duration, n_channels=channels, n_azimuth=azimuth, imu_noise=imu_noise,
        imu_bias=IMU_BIAS, seed=sum(ord(c) for c in name) % 1000, **kw), seq_duration


def device_line(device) -> str:
    """The device a report was made on: the card's name and power limit as
    nvidia-smi reports them, or the host's CPU."""
    import torch

    if torch.device(device).type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        return f"card: {card}"
    return f"host CPU ({platform.processor() or platform.machine()}), no card"


def _rpe(m):
    return m.rpe_trans.get(10.0, m.rpe_trans.get(1.0, float("nan")))


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join("build", "EVAL_TORCH.md"))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--sequences", default=",".join(SEQUENCES))
    ap.add_argument("--window-study", action="store_true")
    ap.add_argument("--matrix", action="store_true",
                    help="sweep the registry matrix (odometry x sub_mapping x global "
                         "back-end) and write an ATE table per combination")
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--azimuth", type=int, default=512)
    ap.add_argument("--imu-noise", type=float, default=0.02)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_eval: no CUDA device; pass --device cpu to run on the host")

    from glim_tpu_torch.io.synthetic import generate_raycast_sequence
    from glim_tpu_torch.odometry.odometry_estimation_imu import OdometryEstimationIMUParams

    duration = 6.0 if args.quick else args.duration
    gen = dict(n_channels=args.channels, n_azimuth=args.azimuth, imu_noise=args.imu_noise,
               imu_bias=IMU_BIAS)
    rows = []
    for name in args.sequences.split(","):
        print(f"[eval] generating {name}...", flush=True)
        seq, seq_duration = make_sequence(name, duration, args.channels, args.azimuth,
                                          args.imu_noise)
        print(f"[eval] running {name} ({seq_duration:.0f} s)...", flush=True)
        m, gmet, sps, extra = run_sequence(seq, device=args.device)
        rows.append((name, seq_duration, m, gmet, sps, extra))
        print(f"[eval] {name}: {m.summary()} | {sps:.2f} scans/s", flush=True)

    matrix_rows = []
    if args.matrix:
        seq = generate_raycast_sequence(duration=min(duration, 12.0), path="figure8",
                                        scene="room", speed=2.5, seed=42, extent=14.0, **gen)
        for od in ("flagship", "cpu_gicp", "cpu_vgicp", "ct"):
            for sm in ("full", "passthrough"):
                for gb in ("matching", "pose_graph"):
                    label = f"{od} / {sm} / {gb}"
                    res = run_sequence(seq, odometry=od, sub_mapping=sm,
                                       pose_graph=(gb == "pose_graph"), device=args.device)
                    matrix_rows.append((label,) + res)
                    m, gmet = res[0], res[1]
                    print(f"[matrix] {label}: ATE {m.ate_rmse:.4f}"
                          + (f" (global {gmet.ate_rmse:.4f})" if gmet else ""), flush=True)

    study_rows = []
    if args.window_study:
        seq = generate_raycast_sequence(duration=duration, path="figure8", scene="room",
                                        speed=3.5, aggressive=0.7, seed=77, extent=12.0, **gen)
        for lag, W in [(0.4, None), (1.2, None), (3.0, None), (5.0, 4)]:
            p = OdometryEstimationIMUParams(voxel_resolution=0.5, voxel_capacity=131072,
                                            initialization_window_size=0.5, smoother_lag=lag,
                                            window_size=W)
            m, _, sps, _ = run_sequence(seq, odom_params=p, device=args.device)
            label = f"W={W}" if W else f"lag={lag}s"
            study_rows.append((label, m, sps))
            print(f"[study] {label}: ATE {m.ate_rmse:.4f} m, {sps:.2f} scans/s", flush=True)

    write_report(args.out, args, duration, rows, matrix_rows, study_rows)
    print(f"[eval] wrote {args.out}")
    return dict(rows=rows, matrix=matrix_rows, study=study_rows)


def write_report(path, args, duration, rows, matrix_rows, study_rows) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# EVAL_TORCH: accuracy and throughput of glim_tpu_torch on raycast "
                "sequences\n\n")
        f.write(f"Device: {device_line(args.device)}. Written by "
                "`python -m glim_tpu_torch.tools.run_eval` "
                f"(`--device {args.device}`, {args.channels} channels x {args.azimuth} "
                f"azimuth steps, IMU noise {args.imu_noise} + bias, {duration:.0f} s a "
                "sequence). The pipeline runs synchronously on one thread; scans/s is "
                "taken after a 15-scan warm-up. The EVAL.md columns are the JAX "
                "package's flagship rows.\n\n")
        f.write("| sequence | s | ATE RMSE [m] | EVAL.md ATE [m] | rot RMSE [deg] | "
                "RPE@10m [m] | global ATE [m] | EVAL.md global [m] | scans/s | "
                "submaps |\n|---|---|---|---|---|---|---|---|---|---|\n")
        for name, dur, m, gmet, sps, extra in rows:
            ref = EVAL_MD.get(name, (float("nan"),) * 2)
            gate = f"{gmet.ate_rmse:.4f}" if gmet else "-"
            f.write(f"| {name} | {dur:.0f} | {m.ate_rmse:.4f} | {ref[0]:.4f} | "
                    f"{m.rot_rmse_deg:.3f} | {_rpe(m):.4f} | {gate} | {ref[1]:.4f} | "
                    f"{sps:.2f} | {extra['n_submaps']} |\n")
        if matrix_rows:
            f.write("\n## Registry matrix (figure8_room, 12 s)\n\n")
            f.write("| odometry / sub_mapping / global | ATE RMSE [m] | EVAL.md ATE [m] | "
                    "global ATE [m] | EVAL.md global [m] | scans/s | submaps |\n"
                    "|---|---|---|---|---|---|---|\n")
            for label, m, gmet, sps, extra in matrix_rows:
                ref = EVAL_MD_MATRIX.get(label, (float("nan"),) * 2)
                gate = f"{gmet.ate_rmse:.4f}" if gmet else "-"
                f.write(f"| {label} | {m.ate_rmse:.4f} | {ref[0]:.4f} | {gate} | "
                        f"{ref[1]:.4f} | {sps:.2f} | {extra['n_submaps']} |\n")
        if study_rows:
            f.write("\n## Drift against window size (aggressive figure-8)\n\n")
            f.write("| window | ATE RMSE [m] | scans/s |\n|---|---|---|\n")
            for label, m, sps in study_rows:
                f.write(f"| {label} | {m.ate_rmse:.4f} | {sps:.2f} |\n")


if __name__ == "__main__":
    main()
    sys.exit(0)
