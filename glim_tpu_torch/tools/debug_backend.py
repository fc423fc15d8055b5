"""Back-end diagnosis harness: run odometry + sub-mapping ONCE on a sequence,
pickle the submap stream, then sweep GlobalMapping configurations offline.

Twin of ``glim_tpu/tools/debug_backend.py``:

    python -m glim_tpu_torch.tools.debug_backend capture --seq city_loop --out /tmp/cl.pkl
    python -m glim_tpu_torch.tools.debug_backend sweep --state /tmp/cl.pkl

Separating the (expensive, configuration-independent) front end from the
back end lets each back-end experiment run in seconds instead of minutes.
The state file holds numpy arrays, Python numbers and strings only (no
tensor, no class of the port), so a state captured on the card can be
swept with ``--device cpu`` and the other way round.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time

import numpy as np


def _frame_to_numpy(fr) -> dict:
    """What the back-end reads of an estimation frame: stamp, poses,
    velocity and bias."""
    fr.fetch_state()
    return dict(id=int(fr.id), stamp=float(fr.stamp), frame_id=fr.frame_id.name,
                T_lidar_imu=np.asarray(fr.T_lidar_imu, np.float64),
                T_world_lidar=np.asarray(fr.T_world_lidar, np.float64),
                T_world_imu=np.asarray(fr.T_world_imu, np.float64),
                v_world_imu=np.asarray(fr.v_world_imu, np.float64),
                imu_bias=np.asarray(fr.imu_bias, np.float64))


def _frame_from_numpy(d: dict):
    from glim_tpu_torch.types import EstimationFrame, FrameID
    return EstimationFrame(id=d["id"], stamp=d["stamp"], T_lidar_imu=d["T_lidar_imu"].copy(),
                           T_world_lidar=d["T_world_lidar"].copy(),
                           T_world_imu=d["T_world_imu"].copy(),
                           v_world_imu=d["v_world_imu"].copy(), imu_bias=d["imu_bias"].copy(),
                           frame_id=FrameID[d["frame_id"]])


def submap_to_numpy(sm) -> dict:
    """A submap as numpy arrays: poses, the merged cloud (points, mask,
    covariances), its frames and odometry frames, and custom data."""
    from glim_tpu_torch.types import to_numpy
    f = sm.frame
    return dict(id=int(sm.id), session_id=int(sm.session_id),
                T_world_origin=np.asarray(sm.T_world_origin, np.float64),
                T_origin_endpoint_L=np.asarray(sm.T_origin_endpoint_L, np.float64),
                T_origin_endpoint_R=np.asarray(sm.T_origin_endpoint_R, np.float64),
                points=to_numpy(f.points), mask=to_numpy(f.mask),
                covs=None if f.covs is None else to_numpy(f.covs),
                frames=[_frame_to_numpy(fr) for fr in sm.frames],
                odom_frames=[_frame_to_numpy(fr) for fr in sm.odom_frames],
                custom_data={k: to_numpy(v) for k, v in sm.custom_data.items()})


def submap_from_numpy(d: dict, device):
    """``submap_to_numpy``'s dict -> a SubMap with its cloud on ``device``."""
    from glim_tpu_torch.types import PointBatch, SubMap, upload
    frame = PointBatch(points=upload(d["points"], device), mask=upload(d["mask"], device),
                       covs=None if d["covs"] is None else upload(d["covs"], device))
    return SubMap(id=d["id"], session_id=d["session_id"],
                  T_world_origin=d["T_world_origin"].copy(),
                  T_origin_endpoint_L=d["T_origin_endpoint_L"].copy(),
                  T_origin_endpoint_R=d["T_origin_endpoint_R"].copy(), frame=frame,
                  frames=[_frame_from_numpy(fr) for fr in d["frames"]],
                  odom_frames=[_frame_from_numpy(fr) for fr in d["odom_frames"]],
                  custom_data={k: np.array(v) for k, v in d["custom_data"].items()})


def capture(seq_name: str, out: str, duration=None, device="cuda") -> dict:
    """Preprocessing, OdometryEstimationIMU and SubMapping over
    ``run_eval.SEQUENCES[seq_name]`` (32 x 512 rays; city_loop keeps its
    47 s unless ``duration`` is given), pickled to ``out``; returns the
    state."""
    import torch

    from glim_tpu_torch.io.synthetic import generate_raycast_sequence
    from glim_tpu_torch.mapping.sub_mapping import SubMapping, SubMappingParams
    from glim_tpu_torch.odometry.odometry_estimation_imu import (
        OdometryEstimationIMU, OdometryEstimationIMUParams)
    from glim_tpu_torch.preprocess.cloud_preprocessor import (CloudPreprocessor,
                                                              CloudPreprocessorParams)
    from glim_tpu_torch.tools.run_eval import SEQUENCES

    device = torch.device(device)
    kw = dict(SEQUENCES[seq_name])
    seq_duration = kw.pop("duration", duration or 20.0)
    if duration:
        seq_duration = duration
    seq = generate_raycast_sequence(
        duration=seq_duration, n_channels=32, n_azimuth=512, imu_noise=0.02,
        imu_bias=np.array([0.03, -0.02, 0.01, 0.002, -0.001, 0.001]),
        seed=sum(ord(c) for c in seq_name) % 1000, **kw)

    pp = CloudPreprocessor(CloudPreprocessorParams(
        random_downsample_target=10000, downsample_resolution=0.25), device=device)
    odom = OdometryEstimationIMU(OdometryEstimationIMUParams(
        voxel_resolution=0.5, voxel_capacity=131072,
        initialization_window_size=0.5), device=device)
    sub = SubMapping(SubMappingParams(max_num_keyframes=8,
                                      keyframe_update_min_points=256), device=device)

    imu_idx = 0
    ests = []
    margs = []
    submaps = []
    imu_rows = []
    t0 = time.perf_counter()
    for si, raw in enumerate(seq.scans):
        while imu_idx < len(seq.imu) and seq.imu[imu_idx, 0] <= raw.stamp + 0.12:
            r = seq.imu[imu_idx]
            odom.insert_imu(r[0], r[1:4], r[4:7])
            sub.insert_imu(r[0], r[1:4], r[4:7])
            imu_rows.append(np.asarray(r))
            imu_idx += 1
        new_margs = []
        e = odom.insert_frame(pp.preprocess(raw), new_margs)
        if e is not None:
            ests.append((raw.stamp, np.asarray(e.T_world_lidar)))
        for m in new_margs:
            sub.insert_frame(m)
            margs.append(m)
        submaps.extend(sub.get_submaps())
        if si % 50 == 0:
            print(f"[capture] scan {si}/{len(seq.scans)} "
                  f"({time.perf_counter()-t0:.0f}s)", flush=True)
    for m in odom.get_remaining_frames():
        if m.stamp > (margs[-1].stamp if margs else -1):
            sub.insert_frame(m)
    submaps.extend(sub.submit_end_of_sequence())

    state = dict(
        submaps=[submap_to_numpy(sm) for sm in submaps],
        imu=np.stack(imu_rows) if imu_rows else np.zeros((0, 7)),
        ests=ests,
        gt_stamps=np.asarray(seq.stamps),
        gt_poses=np.stack(seq.gt_poses),
    )
    with open(out, "wb") as f:
        pickle.dump(state, f)
    print(f"[capture] {len(submaps)} submaps, {len(ests)} odom poses -> {out}")
    return state


def _global_ate(gm, state):
    from glim_tpu_torch.io.evaluation import evaluate_trajectory
    stamp_to_gt = {round(s, 4): T for s, T in
                   zip(state["gt_stamps"], state["gt_poses"])}
    g_est, g_gt = [], []
    for sm_obj, pose in zip(gm.submaps, gm.poses):
        To = np.linalg.inv(np.asarray(sm_obj.custom_data.get(
            "T_world_origin_pre", sm_obj.T_world_origin)))
        for fr in sm_obj.frames:
            key = round(fr.stamp, 4)
            if key in stamp_to_gt:
                g_est.append(pose @ To @ fr.T_world_sensor())
                g_gt.append(stamp_to_gt[key])
    return evaluate_trajectory(g_est, g_gt, align=True)


def _odom_ate(state):
    from glim_tpu_torch.io.evaluation import evaluate_trajectory
    stamp_to_gt = {round(s, 4): T for s, T in
                   zip(state["gt_stamps"], state["gt_poses"])}
    est = [T for s, T in state["ests"] if round(s, 4) in stamp_to_gt]
    gt = [stamp_to_gt[round(s, 4)] for s, T in state["ests"]
          if round(s, 4) in stamp_to_gt]
    return evaluate_trajectory(est, gt, align=True)


def run_backend(state, params=None, label="", optimize_each=True,
                final_optimize=True, device="cuda"):
    """The captured submaps (and IMU) through a fresh GlobalMapping on
    ``device``. Returns (the back-end, its global metrics, seconds)."""
    import torch

    from glim_tpu_torch.mapping.global_mapping import (GlobalMapping,
                                                       GlobalMappingParams)
    device = torch.device(device)
    gm = GlobalMapping(params or GlobalMappingParams(voxel_capacity=65536), device=device)
    if not optimize_each:
        gm.params.enable_optimization = False
    imu = state["imu"]
    idx = 0
    submaps = [submap_from_numpy(d, device) for d in state["submaps"]]
    t0 = time.perf_counter()
    for sm in submaps:
        while idx < len(imu) and imu[idx, 0] <= sm.frames[-1].stamp + 0.3:
            gm.insert_imu(imu[idx, 0], imu[idx, 1:4], imu[idx, 4:7])
            idx += 1
        gm.insert_submap(sm)
    if final_optimize:
        gm.params.enable_optimization = True
        gm.optimize()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    el = time.perf_counter() - t0
    m = _global_ate(gm, state)
    print(f"[sweep] {label}: global ATE {m.ate_rmse:.4f} m  rot "
          f"{m.rot_rmse_deg:.3f} deg  ({el:.1f}s)", flush=True)
    return gm, m, el


def sweep(state_path: str, which="all", device="cuda") -> dict:
    """Run the seven back-end configurations (or those named in ``which``,
    comma-separated) on a captured state; returns label -> (the back-end,
    its global metrics, seconds)."""
    with open(state_path, "rb") as f:
        state = pickle.load(f)
    mo = _odom_ate(state)
    print(f"[sweep] odometry ATE {mo.ate_rmse:.4f} m rot {mo.rot_rmse_deg:.3f}")

    from glim_tpu_torch.mapping.global_mapping import GlobalMappingParams

    configs = {
        "no_opt": None,     # odometry-chained poses, no optimization
        "default": GlobalMappingParams(voxel_capacity=65536),
        "no_imu": GlobalMappingParams(voxel_capacity=65536, enable_imu=False),
        "fine_voxel": GlobalMappingParams(voxel_capacity=65536,
                                          submap_voxel_resolution=0.25,
                                          submap_voxel_resolution_max=0.5),
        "more_iters": GlobalMappingParams(voxel_capacity=65536,
                                          lm_iterations=15),
        "weight_1e-2": GlobalMappingParams(voxel_capacity=65536,
                                           matching_weight=1e-2),
        "between": GlobalMappingParams(voxel_capacity=65536,
                                       create_between_factors=True),
    }
    if which != "all":
        configs = {k: v for k, v in configs.items() if k in which.split(",")}
    out = {}
    for label, p in configs.items():
        if label == "no_opt":
            out[label] = run_backend(state, None, label, optimize_each=False,
                                     final_optimize=False, device=device)
        else:
            out[label] = run_backend(state, p, label, device=device)
    return out


def main(argv=None):
    default_state = os.path.join(tempfile.gettempdir(), "backend_state.pkl")
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["capture", "sweep"])
    ap.add_argument("--seq", default="city_loop")
    ap.add_argument("--out", default=default_state)
    ap.add_argument("--state", default=default_state)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--which", default="all")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "capture":
        capture(args.seq, args.out, args.duration, args.device)
    else:
        sweep(args.state, args.which, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
