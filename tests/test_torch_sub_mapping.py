"""The port's SubMapping against the JAX package's, on one frame sequence.

Both get the same estimation frames, built from numpy: host poses (with the
device pose the overlap gate reads), velocities, biases, the frame cloud
with covariances, the preprocessed frame the keyframes are re-deskewed
from (with its kNN graph), and 100 Hz IMU between the frames. The
parameters are config_sub_mapping_gpu.json's, with max_num_keyframes cut
to 3 so that the sequence closes several submaps, and with every keyframe
decision taken as soon as the next frame arrives (``gate_keep = 0``), so
that neither package's timing decides which keyframe a gate compares
against.

Points lie on a ground plane and a wall, within 0.012 m of a lattice 0.02 m
inside the voxels of every resolution in play (0.1, 0.25, 0.5 m); poses are
integer translations, and all points of a scan share one time, so rounding cannot move a point across a voxel
face: the keyframe choices, the submap frames and origins, and the merged
mask must agree exactly; merged points and covariances at 1e-5 relative
(covariances relative to their largest entry).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.mapping.callbacks import SubMappingCallbacks as JCB
from glim_tpu.mapping.sub_mapping import SubMapping as JSubMapping
from glim_tpu.mapping.sub_mapping import SubMappingParams as JParams
from glim_tpu import types as jt
from glim_tpu_torch import types as tt
from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks as TCB
from glim_tpu_torch.mapping.sub_mapping import SubMapping as TSubMapping
from glim_tpu_torch.mapping.sub_mapping import SubMappingParams as TParams
from glim_tpu_torch.utils.config import Config, create_default_config_dir

C = 1024
K_NN = 10
X = [0, 0, 1, 2, 2, 3, 4, 4, 5, 6, 6, 7, 8, 8, 9, 10, 11, 12, 12, 13]   # pose x (m)
GRAVITY = np.array([0.0, 0.0, -9.80665])


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def _frame_data(seed=0):
    rng = np.random.default_rng(seed)
    out, prev = [], None
    for i, x in enumerate(X):
        T = np.eye(4)
        T[0, 3] = x
        if prev is not None and X[i - 1] == x:
            pts_w, mask = prev                                  # same view again
        else:
            n = int(rng.integers(700, 900))
            k = np.stack([rng.integers(10 * (x - 4), 10 * (x + 4), n),
                          rng.integers(-30, 30, n), rng.integers(-10, 10, n)], axis=1)
            # A ground plane and a wall, as a LiDAR sees surfaces: PLANE
            # covariances of points in a 3D blob would hang on the rounding
            # of a near-zero eigengap.
            k[: n // 2, 2] = -10
            k[n // 2:, 1] = 29
            pts_w = np.zeros((C, 3))
            pts_w[:n] = 0.02 + 0.1 * k + rng.uniform(-0.008, 0.008, size=(n, 3))
            pts_w[: n // 2, 2] = 0.02 - 1.0 + rng.uniform(-1e-3, 1e-3, n // 2)
            pts_w[n // 2:n, 1] = 0.02 + 2.9 + rng.uniform(-1e-3, 1e-3, n - n // 2)
            mask = np.arange(C) < n
        prev = (pts_w, mask)
        pts = np.where(mask[:, None], pts_w - T[:3, 3], 0.0).astype(np.float32)
        d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
        d2[:, ~mask] = np.inf
        nbrs = np.argsort(d2, axis=1)[:, :K_NN].astype(np.int32)
        A = rng.normal(size=(C, 3, 3)) * 0.05
        covs = (A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(3)).astype(np.float32)
        v = np.array([(X[min(i + 1, len(X) - 1)] - x) / 0.1, 0.0, 0.0])
        out.append(dict(id=i, stamp=0.1 * i, T=T, v=v, pts=pts, mask=mask, covs=covs,
                        nbrs=nbrs))
    return out


def _frame(pkg, d, device="cpu"):
    """An EstimationFrame of package ``pkg`` (glim_tpu.types or
    glim_tpu_torch.types) from one frame's numpy data."""
    if pkg is jt:
        dev = jnp.asarray
    else:
        dev = lambda a: torch.from_numpy(np.array(a)).to(device)
    times = np.zeros(C, np.float32)
    raw = pkg.PreprocessedFrame(stamp=d["stamp"], scan_end_time=d["stamp"], k_neighbors=K_NN,
                                device_points=dev(d["pts"]), device_times=dev(times),
                                device_mask=dev(d["mask"]), device_neighbors=dev(d["nbrs"]))
    f = pkg.EstimationFrame(
        id=d["id"], stamp=d["stamp"], T_world_lidar=d["T"].copy(),
        device_T_world_lidar=dev(d["T"].astype(np.float32)), frame_id=pkg.FrameID.LIDAR,
        frame=pkg.PointBatch(points=dev(d["pts"]), mask=dev(d["mask"]), covs=dev(d["covs"])),
        raw_frame=raw)
    f.v_world_imu = d["v"]
    f.imu_bias = np.zeros(6)
    return f


def _run(pkg, sm, cb, frames, device="cpu"):
    kfs = []
    cb.on_new_keyframe.add(lambda current, frame: kfs.append((current, frame.id)))
    sm.gate_keep = 0
    submaps, t_prev = [], -0.1
    for d in frames:
        t = t_prev
        while t < d["stamp"] - 1e-9:
            t += 0.01
            sm.insert_imu(t, -GRAVITY, np.zeros(3))
        t_prev = t
        sm.insert_frame(_frame(pkg, d, device))
        submaps += sm.get_submaps()
    submaps += sm.submit_end_of_sequence()
    return submaps, kfs


def _params(cls, tmp_path):
    cfg = Config(create_default_config_dir(str(tmp_path)) + "/config_sub_mapping_gpu.json")
    p = cls.from_config(cfg)
    p.max_num_keyframes = 3
    return p


def _check(tmp_path, device):
    frames = _frame_data()
    tp = _params(TParams, tmp_path)
    jp = JParams(**vars(tp))
    assert (tp.submap_downsample_resolution, tp.keyframe_voxel_resolution) == (0.1, 0.25)
    subs_j, kfs_j = _run(jt, JSubMapping(jp), JCB, frames)
    subs_t, kfs_t = _run(tt, TSubMapping(tp, device=device), TCB, frames, device)

    assert len(subs_t) == len(subs_j) >= 2
    assert kfs_t == kfs_j
    assert len(kfs_j) < len(frames) - 2            # the repeated views are not keyframes
    assert sum(len(s.frames) for s in subs_t) == len(frames)
    for st, sj in zip(subs_t, subs_j):
        assert st.id == sj.id
        assert [f.id for f in st.frames] == [f.id for f in sj.frames]
        for k in ("T_world_origin", "T_origin_endpoint_L", "T_origin_endpoint_R"):
            np.testing.assert_array_equal(getattr(st, k), getattr(sj, k), err_msg=k)
        mt, mj = st.frame.mask.cpu().numpy(), np.asarray(sj.frame.mask)
        np.testing.assert_array_equal(mt, mj)
        assert mt.sum() > 500
        np.testing.assert_allclose(st.frame.points.cpu().numpy()[mt], np.asarray(sj.frame.points)[mj],
                                   rtol=1e-5, atol=1e-6)
        cj = np.asarray(sj.frame.covs)[mj]
        np.testing.assert_allclose(st.frame.covs.cpu().numpy()[mt], cj, rtol=1e-5,
                                   atol=1e-5 * np.abs(cj).max())
    # The smoothed IMU-rate trajectory rode on the frames.
    traj_t, traj_j = subs_t[0].frames[1].imu_rate_trajectory, subs_j[0].frames[1].imu_rate_trajectory
    assert traj_j is not None and traj_j.shape == traj_t.shape and traj_j.shape[1] >= 5
    np.testing.assert_allclose(traj_t, traj_j, atol=1e-5)
    assert subs_t[0].frame.points.device.type == torch.device(device).type


def test_sub_mapping_matches_jax(tmp_path):
    _check(tmp_path, "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_sub_mapping_on_cuda(tmp_path, cuda):
    """Sub-mapping with its tensors on the card (pinned copies behind
    events for the gates and states) against JAX on the CPU."""
    _check(tmp_path, cuda)


@pytest.mark.parametrize("option", ["enable_optimization", "create_between_factors"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match=option):
        TSubMapping(TParams(**{option: True}), device="cpu")
