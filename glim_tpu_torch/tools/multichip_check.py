"""Multi-device parity check of the global back-end at production scale.

Twin of ``glim_tpu/tools/multichip_check.py``: builds the drifting ring
(>= 64 submaps, >= 300 matching factors, the JAX tool's numpy world from
``default_rng(7)``) through the port's ``GlobalMapping`` insert path, then
runs the identical padded argument set through ``global_gn`` with the
factor rows sharded over the mesh and unsharded, and asserts that the
resulting poses match. Shard-boundary faults (padded rows crossing a shard
edge, a block summed from the wrong shard) cannot hide at this scale.
"""

from __future__ import annotations

import time

import numpy as np


def backend_parity_check(mesh, n_submaps: int = 64, step: float = 2.5,
                         atol: float = 5e-4) -> dict:
    """Build the ring through GlobalMapping on ``mesh.devices[0]``, then
    compare sharded and unsharded global_gn on the identical padded args.
    Returns the JAX tool's stats dict (submaps, factors, factor rows, max
    pose delta, both errors) with the host ms of each solve, after one
    unsharded warm-up solve, to its poses on the host; raises on a
    mismatch."""
    from glim_tpu_torch.mapping.global_factors import global_gn
    from glim_tpu_torch.mapping.global_mapping import GlobalMapping, GlobalMappingParams
    from glim_tpu_torch.ops import lie_np
    from glim_tpu_torch.types import PointBatch, SubMap, upload

    dev = mesh.devices[0]
    rng = np.random.default_rng(7)
    radius = n_submaps * step / (2 * np.pi)
    # Structured world: wall segments + pillars around the ring (planar
    # geometry gives VGICP full-rank constraints; random blobs do not).
    pts_w = []
    for k in range(max(n_submaps // 2, 8)):
        ang = 2 * np.pi * k / max(n_submaps // 2, 8)
        cx, cy = radius * np.cos(ang), radius * np.sin(ang)
        u = rng.uniform(-3, 3, 80)
        z = rng.uniform(0, 3, 80)
        c, s = np.cos(ang), np.sin(ang)
        pts_w.append(np.stack([cx + u * c, cy + u * s, z], 1))
        pts_w.append(np.stack([cx - u * s + 1.0, cy + u * c, z], 1))
        p0 = np.array([cx, cy]) + rng.uniform(-4, 4, 2)
        pts_w.append(np.stack([np.full(30, p0[0]) + rng.normal(0, 0.04, 30),
                               np.full(30, p0[1]) + rng.normal(0, 0.04, 30),
                               rng.uniform(0, 3, 30)], 1))
    world = np.concatenate(pts_w)

    drift = lie_np.se3_exp(np.array([0, 0, 2e-4, 2e-3, 0, 0]))
    gm = GlobalMapping(GlobalMappingParams(
        enable_imu=False, voxel_capacity=4096, matching_points=256,
        submap_voxelmap_levels=1, lm_iterations=3,
        min_implicit_loop_overlap=0.03, max_implicit_loop_distance=radius,
        enable_optimization=False, use_device_mesh=False), device=dev)
    gm.defer_optimization = True
    T_true_prev, T_odom = None, np.eye(4)
    cap = 512
    for k in range(n_submaps):
        ang = 2 * np.pi * k / n_submaps
        T_true = np.eye(4)
        T_true[:2, 3] = radius * np.cos(ang), radius * np.sin(ang)
        yaw = ang + np.pi / 2
        T_true[:2, :2] = [[np.cos(yaw), -np.sin(yaw)],
                          [np.sin(yaw), np.cos(yaw)]]
        if T_true_prev is None:
            T_odom = T_true
        else:
            T_odom = T_odom @ np.linalg.inv(T_true_prev) @ T_true @ drift
        T_true_prev = T_true
        d = np.linalg.norm(world[:, :2] - T_true[:2, 3], axis=1)
        vis = world[d < 8.0]
        if len(vis) > cap:
            vis = vis[rng.choice(len(vis), cap, replace=False)]
        Ti = np.linalg.inv(T_true)
        local = (Ti[:3, :3] @ vis.T).T + Ti[:3, 3]
        pts = np.zeros((cap, 3), np.float32)
        pts[:len(local)] = local + rng.normal(0, 0.004, local.shape)
        mask = np.zeros(cap, bool)
        mask[:len(local)] = True
        gm.insert_submap(SubMap(id=k, T_world_origin=T_odom.copy(),
                                frame=PointBatch(points=upload(pts, dev),
                                                 mask=upload(mask, dev))))
    F = len(gm.matching_factors)
    if F < 300:
        raise AssertionError(f"only {F} factors; the parity check needs >= 300")

    args, dims = gm._padded_args()
    iters = gm.params.lm_iterations

    def solve(shard_mesh):
        t0 = time.perf_counter()
        T, _, err, _ = global_gn(**args, **dims, iters=iters, shard_mesh=shard_mesh)
        T = T[:n_submaps].cpu().numpy()
        return T, float(err), (time.perf_counter() - t0) * 1e3

    solve(None)                     # warm-up: first calls of the solve's ops
    T_sh, err_sh, ms_sh = solve(mesh)
    T_1d, err_1d, ms_1d = solve(None)
    if not (np.all(np.isfinite(T_sh)) and np.all(np.isfinite(T_1d))):
        raise AssertionError("global_gn gave non-finite poses")
    delta = float(np.max(np.abs(T_sh - T_1d)))
    np.testing.assert_allclose(T_sh, T_1d, atol=atol)
    return dict(submaps=n_submaps, factors=F, factor_rows=dims["Fp"],
                max_pose_delta=delta, err_sharded=err_sh, err_single=err_1d,
                gn_ms_sharded=ms_sh, gn_ms_single=ms_1d)
