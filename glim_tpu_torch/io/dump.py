"""Map dump save/load — the framework's checkpoint format.

Twin of ``glim_tpu/io/dump.py``; the two packages write the same bytes for
the same submaps and read each other's dumps. Layout (reference:
src/glim/mapping/global_mapping.cpp:546-635, mapping/sub_map.cpp:24-204):

  dump/
    graph.txt            — manifest in the reference token layout
                           (num_submaps / num_all_frames /
                           num_matching_cost_factors + "matching_cost
                           <type> <i> <j>" rows)
    graph.npz            — the factor graph as a numpy archive
    graph.bin values.bin — the between factors and poses as the reference's
                           boost binary archives (io/boost_archive.py)
    odom_lidar.txt       — TUM trajectories of raw odometry
    odom_imu.txt
    traj_lidar.txt       — globally optimized trajectories
    traj_imu.txt
    000000/ ...          — per-submap dirs: data.txt (text metadata in the
                           reference's key layout), imu_rate.txt, and the
                           cloud in gtsam_points' compact binary format
                           (points_compact.bin / covs_compact.bin ...)
    config/              — snapshot of every live config file

A submap's clouds live on the pipeline's device: ``save_submap`` reads the
valid points and every frame's IMU-rate trajectory not yet on the host in
one device-to-host copy. ``load_submap`` / ``load_dump`` build the clouds on
the ``device`` they are given, all at one capacity. The loader also reads
reference dumps
(full-precision ``points.bin`` clouds, manifests without ``graph.npz``,
``graph.bin`` / ``values.bin``) and legacy ``points.npy`` payloads.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from glim_tpu_torch.io import boost_archive as ba
from glim_tpu_torch.io import gtsam_points_io as gpio
from glim_tpu_torch.types import (EstimationFrame, FrameID, PointBatch, SubMap, capacity_for,
                                  to_numpy, upload)
from glim_tpu_torch.utils.config import GlobalConfig, se3_to_tum
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("dump")

# Cloud attributes of a submap frame and their widths per point.
_CLOUD_ATTRS = (("points", 3), ("covs", 9), ("normals", 3), ("times", 1), ("intensities", 1))


def _write_tum(f, stamp: float, T: np.ndarray) -> None:
    v = se3_to_tum(T)
    f.write(f"{stamp:.9f} " + " ".join(f"{x:.6f}" for x in v) + "\n")


def _write_matrix(f, name: str, T: np.ndarray) -> None:
    f.write(f"{name}: \n")
    for row in np.asarray(T):
        f.write(" ".join(f"{x:.12g}" for x in row) + "\n")


def _fetch_submap(submap: SubMap) -> Dict[str, np.ndarray]:
    """The submap cloud's valid points and attributes on the host, with one
    device-to-host copy that also carries each frame's IMU-rate trajectory
    still on the device (those land in the frames' host caches)."""
    pieces, layout = [], []
    cloud = submap.frame
    if cloud is not None and cloud.points is not None:
        C = int(cloud.points.shape[0])
        for name, width in (("mask", 1),) + _CLOUD_ATTRS:
            v = getattr(cloud, name)
            if v is not None:
                pieces.append(v.reshape(-1).to(torch.float32))
                layout.append((name, (C, width) if width > 1 else (C,)))
    trajs = [fr for fr in submap.frames
             if fr._imu_rate_trajectory is None and fr.device_imu_rate_trajectory is not None]
    for fr in trajs:
        packed, n, _ = fr.device_imu_rate_trajectory
        pieces.append(packed[:, :n].reshape(-1).to(torch.float32))
        layout.append((fr, (packed.shape[0], n)))
    if not pieces:
        return {}
    flat = to_numpy(torch.cat(pieces))
    host, off = {}, 0
    for key, shape in layout:
        size = int(np.prod(shape))
        part = flat[off:off + size].reshape(shape)
        off += size
        if isinstance(key, str):
            host[key] = part
        else:
            arr = part.astype(np.float64)
            arr[0] += key.device_imu_rate_trajectory[2]
            key.imu_rate_trajectory = arr
    if "mask" in host:
        mask = host.pop("mask") > 0.5
        host = {k: (v.reshape(-1, 3, 3) if k == "covs" else v)[mask] for k, v in host.items()}
    return host


def save_submap(path: str, submap: SubMap) -> None:
    """Per-submap directory (reference: sub_map.cpp:24-62 layout)."""
    os.makedirs(path, exist_ok=True)
    cloud = _fetch_submap(submap)
    with open(os.path.join(path, "data.txt"), "w") as f:
        f.write(f"id: {submap.id}\n")
        _write_matrix(f, "T_world_origin", submap.T_world_origin)
        _write_matrix(f, "T_origin_endpoint_L", submap.T_origin_endpoint_L)
        _write_matrix(f, "T_origin_endpoint_R", submap.T_origin_endpoint_R)
        if submap.frames:
            last = submap.frames[-1]
            _write_matrix(f, "T_lidar_imu", last.T_lidar_imu)
            f.write("imu_bias: " + " ".join(str(x) for x in last.imu_bias) + "\n")
            f.write(f"frame_id: {last.frame_id.value}\n")
        f.write(f"num_frames: {len(submap.frames)}\n")
        for i, fr in enumerate(submap.frames):
            f.write(f"frame_{i}\n")
            f.write(f"id: {fr.id}\n")
            f.write(f"stamp: {fr.stamp:.9f}\n")
            odom = submap.odom_frames[i] if i < len(submap.odom_frames) else fr
            _write_matrix(f, "T_odom_lidar", odom.T_world_lidar)
            _write_matrix(f, "T_world_lidar", fr.T_world_lidar)
            f.write("v_world_imu: " + " ".join(str(x) for x in fr.v_world_imu) + "\n")

    if "points" in cloud:
        gpio.save_point_cloud_compact(path, cloud["points"], covs=cloud.get("covs"),
                                      normals=cloud.get("normals"), times=cloud.get("times"),
                                      intensities=cloud.get("intensities"))
    with open(os.path.join(path, "imu_rate.txt"), "w") as f:
        for fr in submap.frames:
            if fr.imu_rate_trajectory is None:
                continue
            for col in np.asarray(fr.imu_rate_trajectory).T:
                f.write(" ".join(f"{x:.9f}" for x in col) + "\n")


def load_submap(path: str, device, capacity: Optional[int] = None) -> SubMap:
    """Inverse of save_submap (metadata + points on ``device``, padded to
    ``capacity``, by default the next power of two; frames restored as
    pose-only clones). Reads the port's and the JAX package's dumps and
    reference dumps: the data.txt token layout is sub_map.cpp's, and the
    point payload may be gtsam_points compact (points_compact.bin) or
    full-precision (points.bin) binary clouds, or a legacy points.npy."""
    sm, cloud = _load_submap_host(path)
    _attach_cloud(sm, cloud, path, device, capacity)
    return sm


def _load_submap_host(path: str):
    """(SubMap with its metadata and frames, cloud dict or None) of a
    submap directory, all on the host."""
    sm = SubMap()
    mats: Dict[str, np.ndarray] = {}
    frames: List[EstimationFrame] = []
    odom_frames: List[EstimationFrame] = []
    cur: Optional[EstimationFrame] = None
    cur_odom: Optional[EstimationFrame] = None
    imu_bias: Optional[np.ndarray] = None
    frame_id: Optional[FrameID] = None

    with open(os.path.join(path, "data.txt")) as f:
        lines = [line.rstrip("\n") for line in f]
    i = 0

    def read_matrix(idx):
        rows = [[float(x) for x in lines[idx + r].split()] for r in range(4)]
        return np.array(rows), idx + 4

    while i < len(lines):
        line = lines[i]
        stripped = line.strip()
        if stripped.startswith("frame_") and ":" not in stripped:
            if cur is not None:
                frames.append(cur)
                odom_frames.append(cur_odom)
            cur = EstimationFrame()
            cur_odom = EstimationFrame()
            i += 1
            continue
        if stripped.endswith(":"):       # matrix marker ("name: " + endl)
            name = stripped[:-1].strip()
            M, i = read_matrix(i + 1)
            if cur is None:
                mats[name] = M
            elif name == "T_odom_lidar":
                cur_odom.T_world_lidar = M
            elif name == "T_world_lidar":
                cur.T_world_lidar = M
            continue
        if ":" in line:
            key, _, val = line.partition(":")
            key = key.strip()
            val = val.strip()
            if key == "id" and cur is None:
                sm.id = int(val)
            elif key == "id":
                cur.id = int(val)
            elif key == "stamp":
                cur.stamp = float(val)
            elif key == "imu_bias" and cur is None:
                imu_bias = np.array([float(x) for x in val.split()])
            elif key == "frame_id" and cur is None:
                # The reference writes the FrameID enum as an int
                # (sub_map.cpp:36); the JAX package and the port the name.
                by_int = {0: FrameID.WORLD, 1: FrameID.LIDAR, 2: FrameID.IMU}
                frame_id = (by_int[int(val)] if val.lstrip("-").isdigit() else FrameID(val))
            elif key == "v_world_imu":
                cur.v_world_imu = np.array([float(x) for x in val.split()])
        i += 1
    if cur is not None:
        frames.append(cur)
        odom_frames.append(cur_odom)

    sm.T_world_origin = mats.get("T_world_origin", np.eye(4))
    sm.T_origin_endpoint_L = mats.get("T_origin_endpoint_L", np.eye(4))
    sm.T_origin_endpoint_R = mats.get("T_origin_endpoint_R", np.eye(4))
    T_lidar_imu = mats.get("T_lidar_imu")
    for fr, odom in zip(frames, odom_frames):
        if T_lidar_imu is not None:
            fr.T_lidar_imu = T_lidar_imu
            odom.T_lidar_imu = T_lidar_imu
            fr.T_world_imu = fr.T_world_lidar @ T_lidar_imu
            odom.T_world_imu = odom.T_world_lidar @ T_lidar_imu
        if imu_bias is not None:
            fr.imu_bias = imu_bias.copy()
            odom.imu_bias = imu_bias.copy()
        if frame_id is not None:
            fr.frame_id = frame_id
            odom.frame_id = frame_id
        odom.id = fr.id
        odom.stamp = fr.stamp
        odom.v_world_imu = fr.v_world_imu
    sm.frames = frames
    sm.odom_frames = odom_frames

    cloud = None
    if gpio.has_point_cloud(path):
        cloud = gpio.load_point_cloud(path)
    elif os.path.exists(os.path.join(path, "points.npy")):
        cloud = {"points": np.load(os.path.join(path, "points.npy"))}
    return sm, cloud


def _attach_cloud(sm: SubMap, cloud, path: str, device, capacity: Optional[int]) -> None:
    if cloud is None:
        return
    sm.frame = PointBatch.from_numpy(
        cloud["points"], covs=cloud.get("covs"), normals=cloud.get("normals"),
        times=cloud.get("times"), intensities=cloud.get("intensities"),
        capacity=capacity, device=device)
    repair_submap(sm, path)


def repair_submap(sm: SubMap, path: str = "?") -> None:
    """Load-time corruption repair (reference mapping/sub_map.cpp:149-199):
    drop non-finite points, validate stored covariances (finite, bounded),
    and re-estimate covariances and normals from a 10-neighbour kNN
    (``ops/knn.knn_search``, ``ops/covariance.estimate_covariances``) when
    they are missing or broken, so every loaded submap can be a VGICP
    target."""
    from glim_tpu_torch.ops import covariance as cov_ops
    from glim_tpu_torch.ops.knn import knn_search

    if sm.frame is None:
        return
    dev = sm.frame.points.device
    pts = to_numpy(sm.frame.points)
    mask = to_numpy(sm.frame.mask).copy()
    bad = ~np.isfinite(pts).all(axis=1) & mask
    if bad.any():
        logger.warning("submap %s: %d non-finite points dropped (%s)",
                       sm.id, int(bad.sum()), path)
        mask &= ~bad
        pts = np.where(mask[:, None], pts, 0.0).astype(np.float32)
        sm.frame.points = upload(pts, dev)
        sm.frame.mask = upload(mask, dev)

    covs_ok = False
    if sm.frame.covs is not None:
        c = to_numpy(sm.frame.covs)[mask]
        covs_ok = bool(len(c) == 0 or (np.isfinite(c).all() and np.abs(c).max() < 1e4))
        if not covs_ok:
            logger.warning("submap %s: stored covariances invalid; re-estimating (%s)",
                           sm.id, path)
    if not covs_ok and mask.sum() >= 16:
        idx, _ = knn_search(sm.frame.points, sm.frame.mask, sm.frame.points,
                            sm.frame.mask, k=10)
        sm.frame.covs, sm.frame.normals = cov_ops.estimate_covariances(
            sm.frame.points, sm.frame.mask, idx, "plane")


def save_dump(path: str, submaps: List[SubMap], poses: List[np.ndarray],
              odom_poses: Optional[List[np.ndarray]] = None,
              factors: Optional[dict] = None) -> None:
    """Full dump directory (reference: global_mapping.cpp:546-635)."""
    os.makedirs(path, exist_ok=True)

    # graph.txt manifest in the reference token layout
    # (global_mapping.cpp:576-598): matching-cost factors are the
    # non-serializable ones, listed by type and endpoint submap indices.
    with open(os.path.join(path, "graph.txt"), "w") as f:
        f.write(f"num_submaps: {len(submaps)}\n")
        n_frames = sum(len(s.frames) for s in submaps)
        f.write(f"num_all_frames: {n_frames}\n")
        matching_pairs = factors.get("matching", []) if factors else []
        f.write(f"num_matching_cost_factors: {len(matching_pairs)}\n")
        for i, j in matching_pairs:
            f.write(f"matching_cost vgicp {i} {j}\n")

    if factors:
        matching = np.asarray(factors.get("matching", []), np.int32).reshape(-1, 2)
        tp = factors.get("translation_priors", [])
        np.savez(os.path.join(path, "graph.npz"),
                 i=np.asarray(factors["i"], np.int32),
                 j=np.asarray(factors["j"], np.int32),
                 Z=np.stack(factors["Z"]) if factors["Z"] else np.zeros((0, 4, 4)),
                 info=np.stack(factors["info"]) if factors["info"] else np.zeros((0, 6, 6)),
                 huber=np.asarray(factors["huber"]),
                 matching=matching,
                 tp_idx=np.asarray([t[0] for t in tp], np.int32),
                 tp_pos=np.asarray([t[1] for t in tp], np.float32).reshape(-1, 3),
                 tp_sqrt=np.asarray([t[2] for t in tp], np.float32).reshape(-1, 3),
                 poses=np.stack(poses) if poses else np.zeros((0, 4, 4)))

    # The reference's factor graph + values as boost binary archives
    # (global_mapping.cpp:572-574), so its offline tools can open the dump.
    _write_boost_graph(path, poses, factors)

    with open(os.path.join(path, "odom_lidar.txt"), "w") as f_ol, \
            open(os.path.join(path, "odom_imu.txt"), "w") as f_oi, \
            open(os.path.join(path, "traj_lidar.txt"), "w") as f_tl, \
            open(os.path.join(path, "traj_imu.txt"), "w") as f_ti:
        for sm, T_world_origin in zip(submaps, poses):
            for fr in sm.odom_frames:
                _write_tum(f_ol, fr.stamp, fr.T_world_lidar)
                _write_tum(f_oi, fr.stamp, fr.T_world_imu)
            if not sm.frames:
                continue
            T_world_endpoint_L = T_world_origin @ sm.T_origin_endpoint_L
            T_odom_lidar0 = sm.frames[0].T_world_lidar
            for fr in sm.frames:
                T_world_lidar = T_world_endpoint_L @ np.linalg.inv(T_odom_lidar0) @ fr.T_world_lidar
                T_world_imu = T_world_lidar @ fr.T_lidar_imu
                _write_tum(f_tl, fr.stamp, T_world_lidar)
                _write_tum(f_ti, fr.stamp, T_world_imu)

    for i, sm in enumerate(submaps):
        save_submap(os.path.join(path, f"{i:06d}"), sm)

    # Config snapshot (if a GlobalConfig is live).
    if GlobalConfig._instance is not None:
        GlobalConfig.instance().dump(os.path.join(path, "config"))
    logger.info("dump saved to %s (%d submaps)", path, len(submaps))


def _write_boost_graph(path: str, poses, factors: Optional[dict]) -> None:
    """graph.bin + values.bin in the reference's boost-binary layout
    (X-key pose values, between factors with Gaussian information noise,
    identity prior on X(0) — global_mapping.cpp:389-426,572-574)."""
    bin_factors = [ba.make_prior_pose3(
        ba.symbol("x", 0), np.eye(4), ba.make_isotropic_precision(6, 1e6))]
    if factors:
        for i, j, Z, info in zip(factors["i"], factors["j"], factors["Z"], factors["info"]):
            info = np.asarray(info, np.float64)
            if info.ndim == 1:
                info = np.diag(info) ** 2
            # make the noise model PSD-robust: equilibrated jitter
            info = info + np.eye(6) * (1e-9 * max(float(np.trace(info)), 1.0))
            bin_factors.append(ba.make_between_pose3(
                ba.symbol("x", int(i)), ba.symbol("x", int(j)),
                np.asarray(Z, np.float64), ba.make_gaussian_information(info)))
    with open(os.path.join(path, "graph.bin"), "wb") as f:
        f.write(ba.write_graph(bin_factors))
    values = {ba.symbol("x", k): ba.make_generic_pose3(T) for k, T in enumerate(poses)}
    with open(os.path.join(path, "values.bin"), "wb") as f:
        f.write(ba.write_values(values))


# What a malformed or foreign boost archive raises in the codec.
_ARCHIVE_ERRORS = (ValueError, KeyError, IndexError, struct.error, UnicodeDecodeError)


def _read_boost_graph(path: str):
    """Parse graph.bin/values.bin into (between-factor fields, poses by
    index) — the exact saved graph. Returns (None, None) when graph.bin is
    absent or unreadable: the caller then uses the manifest, and
    ``GlobalMapping.recover_graph`` rebuilds the rest, as the reference does
    when deserialization throws (global_mapping.cpp:770-787)."""
    gp = os.path.join(path, "graph.bin")
    if not os.path.exists(gp):
        return None, None
    try:
        parsed = ba.read_graph(gp)
    except _ARCHIVE_ERRORS as exc:
        logger.warning("graph.bin unreadable (%s); falling back to recover_graph", exc)
        return None, None
    betweens = dict(i=[], j=[], Z=[], info=[], huber=[])
    for f in parsed:
        if f is None or f.get("_type") != "BetweenFactor<Pose3>":
            continue
        keys = [ba.symbol_split(int(k)) for k in f["base"]["base"]["base"]["keys"]]
        if len(keys) != 2 or any(c != "x" for c, _ in keys):
            continue
        info, robust = ba.noise_information(f["base"]["noiseModel"])
        betweens["i"].append(keys[0][1])
        betweens["j"].append(keys[1][1])
        betweens["Z"].append(ba.pose3_to_matrix(f["measured"]))
        betweens["info"].append(info)
        betweens["huber"].append(robust)
    poses = None
    vp = os.path.join(path, "values.bin")
    if os.path.exists(vp):
        try:
            vals = ba.read_values(vp)
        except _ARCHIVE_ERRORS as exc:
            logger.warning("values.bin unreadable (%s); keeping data.txt poses", exc)
        else:
            poses = {idx: ba.pose3_to_matrix(v["value"])
                     for key, v in vals.items()
                     if v and v["_type"] == "GenericValue<Pose3>"
                     for c, idx in [ba.symbol_split(int(key))] if c == "x"}
    logger.info("graph.bin: %d between factors restored exactly%s", len(betweens["i"]),
                "" if poses is None else f", {len(poses)} pose values")
    return betweens, poses


def load_dump(path: str, device, capacity: Optional[int] = None):
    """Load a dump directory onto ``device``: (submaps, poses, factors dict
    or None). Every submap cloud is padded to one ``capacity``, by default
    the power of two that holds the largest: the global back-end stacks the
    clouds, so they must share a shape (the JAX package gives each cloud
    its own capacity)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"dump directory not found: {path}")
    if not os.path.isdir(os.path.join(path, "000000")) and \
            not os.path.exists(os.path.join(path, "graph.txt")):
        raise FileNotFoundError(f"not a map dump (no graph.txt / submaps): {path}")
    loaded = []
    while os.path.isdir(os.path.join(path, f"{len(loaded):06d}")):
        sub_path = os.path.join(path, f"{len(loaded):06d}")
        loaded.append((sub_path,) + _load_submap_host(sub_path))
    if capacity is None:
        capacity = capacity_for(max([len(c["points"]) for _, _, c in loaded if c is not None],
                                    default=0))
    for sub_path, sm, cloud in loaded:
        _attach_cloud(sm, cloud, sub_path, device, capacity)
    submaps = [sm for _, sm, _ in loaded]
    factors = None
    poses = [sm.T_world_origin for sm in submaps]
    gp = os.path.join(path, "graph.npz")
    if not os.path.exists(gp):
        # Reference dump: the matching-cost factors live in the graph.txt
        # manifest, the between factors and optimized values in graph.bin /
        # values.bin.
        manifest = os.path.join(path, "graph.txt")
        matching = []
        if os.path.exists(manifest):
            with open(manifest) as f:
                for line in f:
                    tok = line.split()
                    if len(tok) == 4 and tok[0] == "matching_cost":
                        matching.append((int(tok[2]), int(tok[3])))
        betweens, bin_poses = _read_boost_graph(path)
        if betweens is not None:
            factors = dict(**betweens, matching=matching, translation_priors=[])
            if bin_poses:
                poses = [bin_poses.get(k, poses[k]) for k in range(len(poses))]
        elif matching:
            factors = dict(i=[], j=[], Z=[], info=[], huber=[], matching=matching,
                           translation_priors=[])
    else:
        z = np.load(gp)
        factors = dict(i=list(z["i"]), j=list(z["j"]), Z=list(z["Z"]),
                       info=list(z["info"]), huber=list(z["huber"]),
                       matching=[tuple(m) for m in z["matching"]] if "matching" in z else [],
                       translation_priors=[(int(a), z["tp_pos"][k], z["tp_sqrt"][k])
                                           for k, a in enumerate(z["tp_idx"])]
                       if "tp_idx" in z else [])
        if len(z["poses"]):
            poses = list(z["poses"])
    return submaps, poses, factors


def export_ply(path: str, points: np.ndarray) -> None:
    """Write an ASCII-header binary PLY (map export for external tools)."""
    points = np.asarray(points, np.float32)
    with open(path, "wb") as f:
        header = (f"ply\nformat binary_little_endian 1.0\n"
                  f"element vertex {len(points)}\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  "end_header\n")
        f.write(header.encode())
        f.write(points.astype("<f4").tobytes())
