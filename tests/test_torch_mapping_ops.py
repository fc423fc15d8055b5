"""The ops that the VGICP odometry and sub-mapping add to the port, against
the JAX package's: the voxel-map overlap (one map and K stacked keyframe
maps), the voxel-grid downsampling that carries covariances, the IMU pose
chain smoothing, sub-mapping's per-frame IMU program and keyframe merge, and
the numpy converters of the new carried state.

Inputs are made with numpy from a seed and handed to both packages. Integer
and ordering results (hits, masks, overlap fractions computed from the same
map) must match exactly; points and covariances at 1e-6 relative; poses
from the smoothing at 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import np_state

from glim_tpu.mapping import sub_mapping as j_sub
from glim_tpu.odometry import keyframe_manager as j_kfm
from glim_tpu.ops import imu as j_imu
from glim_tpu.ops import lie_np
from glim_tpu.ops import pointops as j_pointops
from glim_tpu.ops import voxelmap as j_vmx
from glim_tpu_torch import state as t_state
from glim_tpu_torch.mapping import sub_mapping as t_sub
from glim_tpu_torch.odometry import keyframe_manager as t_kfm
from glim_tpu_torch.ops import imu as t_imu
from glim_tpu_torch.ops import pointops as t_pointops
from glim_tpu_torch.ops import voxelmap as t_vmx


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def T(a):
    return torch.from_numpy(np.array(a, order="C"))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)



def _cloud(rng, n, cap, scale=8.0):
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = rng.uniform(-scale, scale, size=(n, 3))
    mask = np.zeros(cap, bool)
    mask[:n] = True
    A = rng.normal(size=(cap, 3, 3)).astype(np.float32) * 0.1
    covs = (A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3, dtype=np.float32)).astype(np.float32)
    return pts, covs, mask


def _pose(rng, rot=0.3, trans=1.0):
    return lie_np.se3_exp(np.concatenate([rng.normal(size=3) * rot,
                                          rng.normal(size=3) * trans])).astype(np.float32)


def _jax_store(rng, K=5, C=600, filled=(0, 1, 3), res=0.8):
    """A JAX KeyframeStore with keyframes in the given slots (overlapping
    clouds under small pose offsets)."""
    base, covs, _ = _cloud(rng, C, C)
    store = j_kfm.empty_keyframe_store(K, C, 4096, res)
    for order, slot in enumerate(filled):
        n = int(rng.integers(C // 2, C))
        mask = np.arange(C) < n
        pts = base + rng.normal(size=base.shape).astype(np.float32) * 0.3
        T_wl = _pose(rng, 0.05, 0.5)
        store = j_kfm.kf_write(store, jnp.int32(slot), jnp.asarray(pts), jnp.asarray(covs),
                               jnp.asarray(mask), jnp.asarray(T_wl), jnp.asarray(T_wl), order)
    return store


def test_voxelmap_overlap_matches_jax():
    rng = np.random.default_rng(1)
    pts, covs, mask = _cloud(rng, 700, 1024)
    vm_j = j_vmx.voxelmap_insert(j_vmx.empty_gaussian_voxelmap(2048, 0.7), jnp.asarray(pts),
                                 jnp.asarray(mask), jnp.asarray(covs), jnp.int32(0))
    vm_t = t_state.gaussian_voxelmap_from_numpy(np_state(vm_j), "cpu")
    q, _, qm = _cloud(rng, 800, 1024, scale=10.0)
    q[:400] = pts[:400] + rng.normal(size=(400, 3)) * 0.1     # half land in the map
    for Tq in (np.eye(4, dtype=np.float32), _pose(rng, 0.01, 0.05)):
        ov_j = np.asarray(j_vmx.voxelmap_overlap(vm_j, jnp.asarray(q), jnp.asarray(qm),
                                                 jnp.asarray(Tq)))
        ov_t = N(t_vmx.voxelmap_overlap(vm_t, T(q), T(qm), T(Tq)))
        assert 0.05 < ov_j < 0.95
        assert ov_t.dtype == np.float32 and ov_t == ov_j


def test_stacked_lookup_equals_per_map_lookup():
    """voxelmap_lookup on a stacked store (K maps, K query rows) equals the
    port's and the JAX package's lookup of each map alone."""
    rng = np.random.default_rng(2)
    store_j = _jax_store(rng)
    d = np_state(store_j)
    store = t_state.keyframe_store_from_numpy(d, "cpu")
    # Map k is asked for points near its own keyframe's.
    q = (d["pts"][:, :300] + rng.normal(size=(5, 300, 3)) * 0.2).astype(np.float32)
    stacked = N(t_vmx.voxelmap_lookup(store.vm, T(q)))
    assert stacked.shape == (5, 300)
    for k in range(5):
        one = t_vmx.GaussianVoxelMap(*(getattr(store.vm, f.name)[k]
                                       for f in dataclasses.fields(t_vmx.GaussianVoxelMap)))
        np.testing.assert_array_equal(stacked[k], N(t_vmx.voxelmap_lookup(one, T(q[k]))))
        one_j = j_vmx.GaussianVoxelMap(*(getattr(store_j.vm, f.name)[k]
                                         for f in dataclasses.fields(j_vmx.GaussianVoxelMap)))
        np.testing.assert_array_equal(stacked[k], j_vmx.voxelmap_lookup(one_j, jnp.asarray(q[k])))
    assert (stacked >= 0).mean() > 0.1


def test_keyframe_overlaps_match_jax():
    """kf_overlaps_with_points and kf_overlap_vs_others (the K x K x C
    batched lookup) on one store: exact."""
    rng = np.random.default_rng(3)
    store_j = _jax_store(rng)
    store_t = t_state.keyframe_store_from_numpy(np_state(store_j), "cpu")
    pts, _, mask = _cloud(rng, 500, 600)
    ov_j = np.asarray(j_kfm.kf_overlaps_with_points(store_j, jnp.asarray(pts), jnp.asarray(mask)))
    ov_t = N(t_kfm.kf_overlaps_with_points(store_t, T(pts), T(mask)))
    np.testing.assert_array_equal(ov_t, ov_j)
    for excl in ([False] * 5, [False, False, False, True, False]):
        e = np.array(excl)
        oo_j = np.asarray(j_kfm.kf_overlap_vs_others(store_j, jnp.asarray(e)))
        oo_t = N(t_kfm.kf_overlap_vs_others(store_t, T(e)))
        np.testing.assert_array_equal(oo_t, oo_j)
        assert oo_j[[0, 1]].min() > 0.05


def test_kf_write_and_rebuild_match_jax():
    """kf_write (world transform + mini map) and rebuild_level, with poses
    whose transform is exact in both packages (identity rotation, integer
    translation), so the voxel keys must agree exactly."""
    rng = np.random.default_rng(4)
    K, C = 4, 512
    store_j = j_kfm.empty_keyframe_store(K, C, 2048, 0.6)
    store_t = t_kfm.empty_keyframe_store(K, C, 2048, 0.6, "cpu")
    for order, slot in enumerate((2, 0, 1)):
        pts, covs, mask = _cloud(rng, 400, C)
        Tw = np.eye(4, dtype=np.float32)
        Tw[:3, 3] = rng.integers(-3, 4, size=3)
        store_j = j_kfm.kf_write(store_j, jnp.int32(slot), jnp.asarray(pts), jnp.asarray(covs),
                                 jnp.asarray(mask), jnp.asarray(Tw), jnp.asarray(Tw), order)
        t_kfm.kf_write(store_t, slot, T(pts), T(covs), T(mask), T(Tw), T(Tw), order)
    a, b = t_state.keyframe_store_to_numpy(store_t), np_state(store_j)
    for k in ("mask", "T", "order"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["pts"], b["pts"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a["covs"], b["covs"], rtol=1e-6, atol=1e-7)
    for k in ("hash", "coords", "count", "age", "resolution"):
        np.testing.assert_array_equal(a["vm"][k], b["vm"][k], err_msg=k)
    np.testing.assert_allclose(a["vm"]["mean"], b["vm"]["mean"], rtol=1e-6, atol=1e-6)
    res = 0.9
    vm_j = j_kfm.rebuild_level(store_j, 4096, jnp.float32(res), jnp.int32(7))
    vm_t = t_kfm.rebuild_level(store_t, 4096, torch.full((), res), 7)
    a, b = t_state.gaussian_voxelmap_to_numpy(vm_t), np_state(vm_j)
    for k in ("hash", "coords", "count", "age", "resolution"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["mean"], b["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(a["cov"], b["cov"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("out_capacity", [None, 300])
def test_voxelgrid_sampling_covs_matches_jax(out_capacity):
    """Same order and mask; points and covariances at 1e-6 relative. With
    out_capacity below the voxel count the voxels past it are dropped in
    both packages."""
    rng = np.random.default_rng(5)
    pts, covs, mask = _cloud(rng, 1500, 2048, scale=5.0)
    pts[1500:1600] = pts[:100] + 0.01                # shared voxels
    mask[1500:1600] = True
    res = np.float32(0.5)
    pj, cj, mj = (np.asarray(x) for x in j_pointops.voxelgrid_sampling_covs(
        jnp.asarray(pts), jnp.asarray(covs), jnp.asarray(mask), jnp.float32(res),
        out_capacity=out_capacity))
    pt, ct, mt = (N(x) for x in t_pointops.voxelgrid_sampling_covs(
        T(pts), T(covs), T(mask), torch.full((), float(res)), out_capacity=out_capacity))
    if out_capacity:
        assert pt.shape == (out_capacity, 3) and mt.all()
    else:
        assert 300 < mt.sum() < 1600
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(pt[mt], pj[mj], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ct[mt], cj[mj], rtol=1e-6, atol=1e-8)


def test_smooth_pose_chain_matches_jax():
    rng = np.random.default_rng(6)
    n, cap = 21, 32
    Rs = np.stack([lie_np.so3_exp(rng.normal(size=3) * 0.3) for _ in range(cap)]).astype(np.float32)
    ps = np.cumsum(rng.normal(size=(cap, 3)) * 0.05, axis=0).astype(np.float32)
    mask = np.arange(cap) < n
    sigmas = (rng.uniform(0.004, 0.006, size=cap) / 0.1 + 1e-2).astype(np.float32)
    T_end = _pose(rng, 0.02, 0.05) @ np.block([[Rs[n - 1], ps[n - 1][:, None]],
                                               [np.zeros((1, 3)), np.ones((1, 1))]]).astype(np.float32)
    T_end = T_end.astype(np.float32)
    Rj, pj = (np.asarray(x) for x in j_imu.smooth_pose_chain(
        jnp.asarray(Rs), jnp.asarray(ps), jnp.asarray(mask), jnp.asarray(sigmas),
        jnp.asarray(T_end)))
    Rt, pt = (N(x) for x in t_imu.smooth_pose_chain(T(Rs), T(ps), T(mask), T(sigmas), T(T_end)))
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    np.testing.assert_allclose(pt[n - 1], T_end[:3, 3], atol=1e-4)     # end anchored
    np.testing.assert_array_equal(pt[n:], ps[n:])                      # padding untouched


def _imu_packed(rng, nA=18, nB=20):
    CAP = j_sub.IMU_CHAIN_CAP
    packed = np.zeros((2 * CAP + 7, 8), np.float32)
    packed[:CAP, 7] = 1e9
    packed[CAP:2 * CAP, 7] = 1e9
    for off, n in ((0, nA), (CAP, nB)):
        packed[off:off + n, 0:3] = [0.0, 0.0, 9.80665] + rng.normal(size=(n, 3)) * 0.2
        packed[off:off + n, 3:6] = rng.normal(size=(n, 3)) * 0.1
        packed[off:off + n, 6] = 0.005
        packed[off:off + n, 7] = np.arange(1, n + 1) * 0.005
    packed[2 * CAP, 0] = nB * 0.005
    packed[2 * CAP, 2:8] = rng.normal(size=6) * 1e-3
    T_cur = _pose(rng, 0.2, 2.0)
    packed[2 * CAP + 1:2 * CAP + 3] = T_cur.reshape(2, 8)
    packed[2 * CAP + 3:2 * CAP + 5] = (T_cur @ _pose(rng, 0.01, 0.1)).reshape(2, 8)
    packed[2 * CAP + 5, :3] = [1.0, 0.2, 0.0]
    packed[2 * CAP + 6, :6] = rng.normal(size=6) * 1e-3
    return packed


def test_sub_frame_program_matches_jax():
    rng = np.random.default_rng(7)
    packed = _imu_packed(rng)
    T_li = _pose(rng, 0.1, 0.2)
    noise = (0.05, 0.02, 0.001)
    traj_j, pre_j = j_sub._sub_frame_program(jnp.asarray(packed), jnp.asarray(T_li),
                                             *(jnp.float32(v) for v in noise))
    traj_t, pre_t = t_sub._sub_frame_program(
        T(packed), T(T_li), *(torch.full((), v) for v in noise),
        T(np.array([0.0, 0.0, -9.80665], np.float32)))
    traj_j = np.asarray(traj_j)
    np.testing.assert_array_equal(N(traj_t)[0], traj_j[0])       # stamps, 1e9 padding
    np.testing.assert_allclose(N(traj_t)[1:4], traj_j[1:4], atol=1e-5)
    q_t, q_j = N(traj_t)[4:], traj_j[4:]
    q_t = q_t * np.sign(np.sum(q_t * q_j, axis=0))                # q and -q are one rotation
    np.testing.assert_allclose(q_t, q_j, atol=1e-5)
    for f in dataclasses.fields(pre_t):
        a, b = N(getattr(pre_t, f.name)), np.asarray(getattr(pre_j, f.name))
        np.testing.assert_allclose(a, b, atol=1e-5 * max(1.0, float(np.abs(b).max())),
                                   err_msg=f.name)


def test_merge_keyframes_matches_jax():
    """The submap merge over more voxels than out_cap: the dropped voxels
    are the same in both packages."""
    rng = np.random.default_rng(8)
    K, C, out_cap = 4, 512, 256
    clouds = [_cloud(rng, 450, C, scale=4.0) for _ in range(K)]
    pts, covs, masks = (np.stack([c[i] for c in clouds]) for i in range(3))
    kf_T = np.stack([np.eye(4, dtype=np.float32)] * K)
    kf_T[:, :3, 3] = rng.integers(-2, 3, size=(K, 3))            # exact transforms
    valid = np.array([True, True, True, False])
    res = 0.3
    mj = [np.asarray(x) for x in j_sub._merge_keyframes(
        jnp.asarray(pts), jnp.asarray(covs), jnp.asarray(masks), jnp.asarray(kf_T),
        jnp.asarray(valid), jnp.float32(res), k_max=K, out_cap=out_cap)]
    mt = [N(x) for x in t_sub._merge_keyframes(
        T(pts), T(covs), T(masks), T(kf_T), T(valid), torch.full((), res), out_cap=out_cap)]
    np.testing.assert_array_equal(mt[2], mj[2])
    assert mt[2].all()                                           # overflowed
    np.testing.assert_allclose(mt[0], mj[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mt[1], mj[1], rtol=1e-5, atol=1e-7)


def test_state_converters_roundtrip():
    rng = np.random.default_rng(9)
    d = np_state(_jax_store(rng))
    back = t_state.keyframe_store_to_numpy(t_state.keyframe_store_from_numpy(d, "cpu"))
    for k, v in d.items():
        items = v.items() if k == "vm" else [(k, v)]
        for kk, vv in items:
            got = back["vm"][kk] if k == "vm" else back[kk]
            np.testing.assert_array_equal(got, vv)
            assert got.dtype == vv.dtype, kk
    levels = (d["vm"], d["vm"])
    lv = t_state.voxelmap_levels_to_numpy(t_state.voxelmap_levels_from_numpy(
        [{k: v[0] for k, v in m.items()} for m in levels], "cpu"))
    assert len(lv) == 2 and lv[0]["hash"].shape == (4096,)
