"""The ops that the matching-cost global back-end adds to the port, against
the JAX package's: the small analytic factors, the stacked voxel-map lookup
table, the stacked overlap and correspondence searches, the GICP factor of
the between refinement (through ``nn_search``) and the IMU integration
queue.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: factor blocks at 1e-5 of the block's largest entry; the stacked
lookups exact (hit masks equal, mu and C_t bitwise on hits, the overlap
fractions to 1e-6); GICP blocks at 1e-4 of their scale with the inlier
count exact; the preintegration at 1e-5 of each field's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_global_batched_lookup import _make_world, _stacks

from glim_tpu.common.imu_integration import IMUIntegration as JIMUIntegration
from glim_tpu.ops import factors as j_fct
from glim_tpu.ops import gicp as j_gicp
from glim_tpu.ops import lie_np
from glim_tpu.ops import voxelmap as j_vmx
from glim_tpu_torch.common.imu_integration import IMUIntegration as TIMUIntegration
from glim_tpu_torch.mapping.global_factors import pad_stack
from glim_tpu_torch.ops import factors as t_fct
from glim_tpu_torch.ops import gicp as t_gicp
from glim_tpu_torch.ops import voxelmap as t_vmx
from glim_tpu_torch.ops.nn_search import nn_search


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def T(a):
    return torch.from_numpy(np.array(a, order="C"))


def scaled(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rel * max(1.0, float(np.abs(b).max())))


def _poses(rng, n, rot=0.3, trans=5.0):
    return np.stack([lie_np.se3_exp(np.concatenate([rng.normal(0, rot, 3),
                                                     rng.normal(0, trans, 3)]))
                     for _ in range(n)]).astype(np.float32)


def _near(rng, Ts, sigma=0.05):
    return np.stack([T0 @ lie_np.se3_exp(rng.normal(0, sigma, 6)) for T0 in Ts]).astype(np.float32)


def _check_factor(out_t, out_j):
    for t, j in zip(out_t, out_j):
        assert tuple(t.shape) == tuple(np.shape(j))
        scaled(t.numpy(), j, 1e-5)


def test_prior_linearize_matches_jax():
    rng = np.random.default_rng(0)
    Ts = _poses(rng, 6)
    Z = _near(rng, Ts)
    si = rng.uniform(0.5, 3.0, (6, 6)).astype(np.float32)
    _check_factor(t_fct.prior_linearize(T(Ts), T(Z), T(si)),
                  j_fct.prior_linearize(jnp.asarray(Ts), jnp.asarray(Z), jnp.asarray(si)))


def test_translation_prior_linearize_matches_jax():
    rng = np.random.default_rng(1)
    Ts = _poses(rng, 6)
    t_meas = (Ts[:, :3, 3] + rng.normal(0, 0.2, (6, 3))).astype(np.float32)
    si = rng.uniform(0.5, 3.0, (6, 3)).astype(np.float32)
    _check_factor(t_fct.translation_prior_linearize(T(Ts), T(t_meas), T(si)),
                  j_fct.translation_prior_linearize(jnp.asarray(Ts), jnp.asarray(t_meas),
                                                    jnp.asarray(si)))


def test_rotate_vector3_linearize_matches_jax():
    rng = np.random.default_rng(2)
    Ts = _poses(rng, 6, rot=0.1)
    v = rng.normal(size=(6, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    si = np.full((6, 3), 1e4, np.float32)
    ez = np.tile(np.array([0, 0, 1], np.float32), (6, 1))
    _check_factor(t_fct.rotate_vector3_linearize(T(Ts), T(v), T(ez), T(si)),
                  j_fct.rotate_vector3_linearize(jnp.asarray(Ts), jnp.asarray(v),
                                                 jnp.asarray(ez), jnp.asarray(si)))


def test_linear_damping_matches_jax():
    np.testing.assert_array_equal(t_fct.linear_damping(6, 1e6, "cpu").numpy(),
                                  np.asarray(j_fct.linear_damping(6, 1e6)))


def _port_world(pts, masks, vms_j):
    """The port's voxel maps of the same clouds, at the JAX maps' resolutions."""
    vms = []
    for p, m, vm_j in zip(pts, masks, vms_j):
        vm = t_vmx.empty_gaussian_voxelmap(vm_j.capacity, float(vm_j.resolution), "cpu")
        covs = torch.eye(3).expand(p.shape[0], 3, 3) * 0.01
        vms.append(t_vmx.voxelmap_insert(vm, T(p), T(m), covs, 0))
    return vms


def _port_stacks(poses, pts, masks, vms, Sp=8):
    tabs = [t_vmx.gaussian_lookup_table(vm) for vm in vms]
    V = vms[0].capacity
    keys = pad_stack([k for k, _ in tabs], Sp,
                     torch.full((V, 2), t_vmx.INVALID_HASH, dtype=torch.int32), "cpu")
    stats = pad_stack([s for _, s in tabs], Sp, torch.zeros(V, 12), "cpu")
    res = pad_stack([vm.resolution for vm in vms], Sp, torch.ones(()), "cpu")
    sm_pts = pad_stack([T(p) for p in pts], Sp, torch.zeros(pts[0].shape), "cpu")
    sm_mask = pad_stack([T(m) for m in masks], Sp,
                        torch.zeros(masks[0].shape, dtype=torch.bool), "cpu")
    T_all = pad_stack([np.asarray(P, np.float32) for P in poses], Sp,
                      np.eye(4, dtype=np.float32), "cpu")
    return T_all, sm_pts, sm_mask, keys, stats, res


def test_gaussian_lookup_table_matches_jax():
    rng = np.random.default_rng(3)
    poses, pts, masks, vms_j = _make_world(rng)
    for vm_t, vm_j in zip(_port_world(pts, masks, vms_j), vms_j):
        keys_t, stats_t = t_vmx.gaussian_lookup_table(vm_t)
        keys_j, stats_j = j_vmx.gaussian_lookup_table(vm_j)
        np.testing.assert_array_equal(keys_t.numpy(), np.asarray(keys_j))
        valid = np.asarray(keys_j)[:, 0] != j_vmx.INVALID_HASH
        np.testing.assert_allclose(stats_t.numpy()[valid], np.asarray(stats_j)[valid],
                                   rtol=1e-6, atol=1e-7)


def test_vgicp_lookup_stacked_matches_jax():
    rng = np.random.default_rng(3)
    poses, pts, masks, vms_j = _make_world(rng)
    j_args = _stacks(poses, pts, masks, vms_j)
    t_args = _port_stacks(poses, pts, masks, _port_world(pts, masks, vms_j))
    pairs = [(0, 1), (1, 2), (2, 3), (0, 3), (3, 0), (1, 1)]
    tgt = np.array([t for t, _ in pairs], np.int32)
    src = np.array([s for _, s in pairs], np.int32)
    T_all, sm_pts, sm_mask, keys, stats, res = j_args
    mu_j, ct_j, hit_j = j_gicp.vgicp_lookup_stacked(T_all, jnp.asarray(tgt), jnp.asarray(src),
                                                    sm_pts, sm_mask, keys, stats, res)
    T_all, sm_pts, sm_mask, keys, stats, res = t_args
    mu_t, ct_t, hit_t = t_gicp.vgicp_lookup_stacked(T_all, T(tgt), T(src), sm_pts, sm_mask,
                                                    keys, stats, res)
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    h = np.asarray(hit_j)
    assert h.sum(1).min() > 50          # the test world really overlaps
    # mu and C_t come from the same stats rows: equal to the JAX package's
    # rows up to the voxel maps' own f32 accumulation.
    np.testing.assert_allclose(mu_t.numpy()[h], np.asarray(mu_j)[h], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ct_t.numpy()[h], np.asarray(ct_j)[h], rtol=1e-6, atol=1e-7)
    # Per row, the stacked search equals the single-map lookup of the port.
    vms_t = _port_world(pts, masks, vms_j)
    for k, (t, s) in enumerate(pairs):
        mu1, ct1, hit1 = t_gicp.vgicp_lookup(T(poses[t].astype(np.float32)),
                                             T(poses[s].astype(np.float32)),
                                             T(pts[s]), T(masks[s]), vms_t[t])
        np.testing.assert_array_equal(hit_t[k].numpy(), hit1.numpy())
        hk = hit1.numpy()
        np.testing.assert_array_equal(mu_t[k].numpy()[hk], mu1.numpy()[hk])
        np.testing.assert_array_equal(ct_t[k].numpy()[hk], ct1.numpy()[hk])


def test_voxelmap_overlap_stacked_matches_jax():
    rng = np.random.default_rng(4)
    poses, pts, masks, vms_j = _make_world(rng)
    j_args = _stacks(poses, pts, masks, vms_j)
    t_args = _port_stacks(poses, pts, masks, _port_world(pts, masks, vms_j))
    pairs = [(0, 1), (2, 1), (3, 0), (1, 3)]
    T_rel = np.stack([np.linalg.inv(poses[t]) @ poses[s] for t, s in pairs]).astype(np.float32)
    tgt = np.array([t for t, _ in pairs], np.int32)
    src = np.array([s for _, s in pairs], np.int32)
    for stride in (1, 4):
        _, sm_pts, sm_mask, keys, _, res = j_args
        ov_j = np.asarray(j_vmx.voxelmap_overlap_stacked(
            jnp.asarray(T_rel), jnp.asarray(tgt), jnp.asarray(src), sm_pts, sm_mask, keys,
            res, stride=stride))
        _, sm_pts, sm_mask, keys, _, res = t_args
        ov_t = t_vmx.voxelmap_overlap_stacked(T(T_rel), T(tgt), T(src), sm_pts, sm_mask,
                                              keys, res, stride=stride)
        assert ov_t.dtype == torch.float32
        np.testing.assert_allclose(ov_t.numpy(), ov_j, atol=1e-6)
        assert ov_j.min() > 0.2


def test_lookup_keys_stacked_equals_per_row_search():
    """One searchsorted over the (table, hash)-keyed stacked tables gives
    each row what a search of its own table gives (empty tables, hashes at
    both ends of int32 and the INVALID_HASH padding included)."""
    rng = np.random.default_rng(5)
    S, V, R, Q = 5, 64, 7, 200
    keys = np.full((S, V, 2), t_vmx.INVALID_HASH, np.int32)
    for s in range(1, S):
        n = rng.integers(1, V)
        h = np.sort(rng.choice(np.arange(-2**31, 2**31 - 1, 997, dtype=np.int64), n,
                               replace=False)).astype(np.int32)
        h[0] = -2**31 if s == 2 else h[0]
        keys[s, :n, 0] = h
        keys[s, :n, 1] = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
    res = rng.uniform(0.3, 1.0, S).astype(np.float32)
    pts = rng.uniform(-40, 40, (R, Q, 3)).astype(np.float32)
    rows = rng.integers(0, S, R).astype(np.int64)
    got = t_vmx.lookup_keys_stacked(T(keys), T(res), T(pts), T(rows)).numpy()
    for r in range(R):
        want = t_vmx.lookup_keys(T(keys[rows[r]]), T(res[rows[r]]), T(pts[r])).numpy()
        np.testing.assert_array_equal(got[r], want)
    # Queries that do hit: every valid voxel of row 0's table, from its centre.
    s = 3
    from glim_tpu_torch.ops.pointops import hash_coords, hash_coords2
    coords = torch.from_numpy(rng.integers(-50, 50, (V, 3)).astype(np.int32))
    h = hash_coords(coords).numpy()
    order = np.argsort(h, kind="stable")
    keys[s, :, 0] = h[order]
    keys[s, :, 1] = hash_coords2(coords).numpy()[order]
    centres = ((coords.numpy()[order] + 0.5) * res[s]).astype(np.float32)
    got = t_vmx.lookup_keys_stacked(T(keys), T(res), T(centres[None]),
                                    torch.tensor([s])).numpy()[0]
    want = t_vmx.lookup_keys(T(keys[s]), T(res[s]), T(centres)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).mean() > 0.9


def test_gicp_linearize_matches_jax():
    """The between refinement's GICP factor: nn_search correspondences (the
    plain version on CPU tensors, the XLA k=1 search in JAX), blocks at
    1e-4 of their scale, the inlier count exact."""
    rng = np.random.default_rng(6)
    base = rng.normal(0, 3.0, (3000, 3))
    clouds = []
    T_w = [np.eye(4), lie_np.se3_exp(np.array([0.02, -0.01, 0.05, 0.8, 0.3, 0.1]))]
    for Tk in T_w:
        local = (np.linalg.inv(Tk)[:3, :3] @ base.T).T + np.linalg.inv(Tk)[:3, 3]
        pts = np.zeros((1024, 3), np.float32)
        sel = rng.permutation(len(local))[:1000]
        pts[:1000] = local[sel] + rng.normal(0, 0.01, (1000, 3))
        mask = np.zeros(1024, bool)
        mask[:1000] = True
        A = rng.normal(size=(1024, 3, 3)).astype(np.float32) * 0.1
        covs = (A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3)).astype(np.float32)
        clouds.append((pts, covs, mask))
    T_t = np.eye(4, dtype=np.float32)
    T_s = (T_w[1] @ lie_np.se3_exp(np.array([0.01, 0, 0, 0.05, -0.03, 0]))).astype(np.float32)
    (pt, ct, mt), (ps, cs, ms) = clouds
    launches = nn_search.kernel_launches
    s_t = t_gicp.gicp_linearize(T(T_t), T(T_s), T(ps), T(cs), T(ms), T(pt), T(ct), T(mt), 2.0)
    assert nn_search.kernel_launches == launches        # CPU tensors: plain version
    s_j = j_gicp.gicp_linearize(*(jnp.asarray(a) for a in (T_t, T_s, ps, cs, ms, pt, ct, mt)),
                                jnp.float32(2.0))
    assert int(s_t.num_inliers) == int(s_j.num_inliers) > 900
    for name in ("H_tt", "H_ts", "H_ss", "b_t", "b_s"):
        scaled(getattr(s_t, name).numpy(), getattr(s_j, name), 1e-4)
    np.testing.assert_allclose(float(s_t.error), float(s_j.error), rtol=1e-4)


def test_imu_integration_matches_jax():
    rng = np.random.default_rng(7)
    stamps = np.sort(rng.uniform(0.0, 1.0, 150))
    acc = rng.normal([0, 0, 9.8], 0.3, (150, 3))
    gyro = rng.normal(0, 0.2, (150, 3))
    bias = rng.normal(0, 0.01, 6)
    jq, tq = JIMUIntegration(), TIMUIntegration("cpu")
    for t, a, w in zip(stamps, acc, gyro):
        jq.insert_imu(t, a, w)
        tq.insert_imu(t, a, w)
    np.testing.assert_array_equal(tq.find_imu_data(0.2, 0.7), jq.find_imu_data(0.2, 0.7))
    pre_t, n_t = tq.integrate_imu(0.2, 0.7, bias)
    pre_j, n_j = jq.integrate_imu(0.2, 0.7, bias)
    assert n_t == n_j > 50
    for name in ("dR", "dv", "dp", "dt", "H_Rg", "H_va", "H_vg", "H_pa", "H_pg", "cov", "bias"):
        scaled(getattr(pre_t, name).numpy(), getattr(pre_j, name), 1e-5)
    tq.erase_imu_data(0.5)
    jq.erase_imu_data(0.5)
    assert len(tq.imu_data) == len(jq.imu_data)
