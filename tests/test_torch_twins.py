"""The last public names of glim_tpu/ to get their twins in the port, each
against the JAX function on the same numpy inputs from a seed.

Tolerances: float32 results at ``torch_parity.POSE_ATOL`` (1e-4) unless a
case states another, Hessian-like blocks at 1e-4 of the block's largest
entry (``torch_parity.scaled``); integer and boolean results, gathers and
counts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu import native as j_native
from glim_tpu import types as j_types
from glim_tpu.ops import covariance as j_cov
from glim_tpu.ops import factors as j_fct
from glim_tpu.ops import gicp as j_gicp
from glim_tpu.ops import imu as j_imu
from glim_tpu.ops import knn as j_knn
from glim_tpu.ops import lie as j_lie
from glim_tpu.ops import pointops as j_pointops
from glim_tpu.ops import solver as j_solver
from glim_tpu.ops import voxelmap as j_vmx
from glim_tpu.ops import lie_np
from glim_tpu_torch import types as t_types
from glim_tpu_torch.native import loader as t_loader
from glim_tpu_torch.ops import covariance as t_cov
from glim_tpu_torch.ops import factors as t_fct
from glim_tpu_torch.ops import gicp as t_gicp
from glim_tpu_torch.ops import imu as t_imu
from glim_tpu_torch.ops import lie as t_lie
from glim_tpu_torch.ops import pointops as t_pointops
from glim_tpu_torch.ops import solver as t_solver
from glim_tpu_torch.ops import voxelmap as t_vmx
from torch_parity import POSE_ATOL, scaled


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a, order="C"))


def J(a):
    return jnp.asarray(np.asarray(a))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _poses(rng, n, scale=1.0):
    xi = np.concatenate([rng.normal(size=(n, 3)) * 0.5, rng.normal(size=(n, 3)) * scale], 1)
    return np.asarray(j_lie.se3_exp(J(xi.astype(np.float32))))


# ------------------------------------------------------------------ lie


def test_se3_mul_retract_interpolate():
    rng = np.random.default_rng(101)
    A, B = _poses(rng, 16), _poses(rng, 16, 3.0)
    xi = (rng.normal(size=(16, 6)) * 0.3).astype(np.float32)
    a = rng.uniform(0, 1, 16).astype(np.float32)
    np.testing.assert_allclose(N(t_lie.se3_mul(T(A), T(B))), j_lie.se3_mul(J(A), J(B)),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(N(t_lie.se3_retract(T(A), T(xi))),
                               j_lie.se3_retract(J(A), J(xi)), atol=POSE_ATOL)
    np.testing.assert_allclose(N(t_lie.se3_interpolate(T(A), T(B), T(a))),
                               j_lie.se3_interpolate(J(A), J(B), J(a)), atol=POSE_ATOL)
    np.testing.assert_allclose(N(t_lie.se3_interpolate(T(A[0]), T(B[0]), 0.3)),
                               j_lie.se3_interpolate(J(A[0]), J(B[0]), 0.3), atol=POSE_ATOL)


# ------------------------------------------------------------- pointops


def test_fast_floor_and_voxel_coords():
    """Exact, at the JAX test's cases (negative, zero, integer inputs) and
    on random coordinates, some on a voxel boundary."""
    x = np.array([-1.5, -0.1, 0.0, 0.9, 2.0, -2.0, -0.0, 1e-7, -1e-7], np.float32)
    np.testing.assert_array_equal(N(t_pointops.fast_floor(T(x))), [-2, -1, 0, 0, 2, -2, 0, 0, -1])
    np.testing.assert_array_equal(N(t_pointops.fast_floor(T(x))), j_pointops.fast_floor(J(x)))
    rng = np.random.default_rng(102)
    p = rng.uniform(-20, 20, (2000, 3)).astype(np.float32)
    p[:100] = np.round(p[:100] * 4) / 4
    np.testing.assert_array_equal(N(t_pointops.voxel_coords(T(p), 4.0)),
                                  j_pointops.voxel_coords(J(p), 4.0))
    assert N(t_pointops.fast_floor(T(x))).dtype == np.int32


def test_sample_compact_merge():
    """Gathers and the stable re-pack exactly, extras permuted alike."""
    rng = np.random.default_rng(103)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    m = rng.uniform(size=64) > 0.4
    e1 = rng.normal(size=64).astype(np.float32)
    e2 = rng.normal(size=(64, 3, 3)).astype(np.float32)
    idx = rng.integers(-5, 64, 40).astype(np.int32)
    for a, b in zip(t_pointops.sample(T(p), T(m), T(idx)),
                    j_pointops.sample(J(p), J(m), J(idx))):
        np.testing.assert_array_equal(N(a), b)
    got = t_pointops.compact(T(p), T(m), T(e1), T(e2))
    want = j_pointops.compact(J(p), J(m), J(e1), J(e2))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(N(a), b)
    parts = [(rng.normal(size=(n, 3)).astype(np.float32), rng.uniform(size=n) > 0.5)
             for n in (16, 32, 8)]
    for cap in (20, 56):
        got = t_pointops.merge_point_batches([T(q) for q, _ in parts], [T(k) for _, k in parts],
                                             cap)
        want = j_pointops.merge_point_batches([J(q) for q, _ in parts],
                                              [J(k) for _, k in parts], cap)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(N(a), b)
    Tp = _poses(rng, 1)[0]
    np.testing.assert_allclose(N(t_pointops.transform_points(T(Tp), T(p))),
                               j_pointops.transform_points(J(Tp), J(p)), atol=POSE_ATOL)


# ------------------------------------------------- batches and voxel maps


def test_point_batch_capacity_and_num_valid():
    rng = np.random.default_rng(104)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    bj = j_types.PointBatch.from_numpy(pts)
    bt = t_types.PointBatch.from_numpy(pts, device="cpu")
    assert bt.capacity == bj.capacity == 1024
    assert bt.num_valid() == bj.num_valid() == 700
    bt.mask[::3] = False
    assert bt.num_valid() == 700 - len(range(0, 700, 3))
    assert isinstance(bt.num_valid(), int) and isinstance(bt.capacity, int)


def test_voxel_map_counts_after_inserts():
    """num_voxels / num_points exactly, after the same inserts (over a
    map's capacity too), as 0-dim tensors."""
    rng = np.random.default_rng(105)
    vj, vt = j_vmx.empty_gaussian_voxelmap(256, 0.5), t_vmx.empty_gaussian_voxelmap(256, 0.5,
                                                                                   "cpu")
    pj, pt = j_vmx.empty_point_voxelmap(512, 0.5), t_vmx.empty_point_voxelmap(512, 0.5,
                                                                             device="cpu")
    assert int(vt.num_voxels()) == int(vj.num_voxels()) == 0
    for step in range(3):
        pts = rng.uniform(-6, 6, (300, 3)).astype(np.float32)
        A = rng.normal(size=(300, 3, 3))
        covs = ((A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(3)) * 0.01).astype(np.float32)
        m = rng.uniform(size=300) > 0.1
        vj = j_vmx.voxelmap_insert(vj, J(pts), J(m), J(covs), jnp.int32(step))
        vt = t_vmx.voxelmap_insert(vt, T(pts), T(m), T(covs), step)
        pj = j_vmx.pointmap_insert(pj, J(pts), J(m), J(covs), jnp.int32(step))
        pt = t_vmx.pointmap_insert(pt, T(pts), T(m), T(covs), step)
        assert vt.num_voxels().dim() == pt.num_points().dim() == 0
        assert int(vt.num_voxels()) == int(vj.num_voxels()), step
        assert int(pt.num_points()) == int(pj.num_points()), step
    assert int(vt.num_voxels()) == 256 and int(pt.num_points()) == 512


# ----------------------------------------------------------- covariance


def test_estimate_normals_on_clear_planes():
    """Three planes apart (a floor 1.5 m below the sensor, two walls 5 m
    away, 2 m past the floor's edge) with 5 mm noise: every eigengap is
    wide, so the normals agree at POSE_ATOL, orientation included."""
    rng = np.random.default_rng(106)
    n, C = 1500, 2048
    p = np.zeros((C, 3), np.float32)
    k = n // 3
    p[:k] = np.c_[rng.uniform(-3, 3, (k, 2)), np.full(k, -1.5)]
    p[k:2 * k] = np.c_[rng.uniform(-5, 5, k), np.full(k, 5.0), rng.uniform(-1.5, 2.5, k)]
    p[2 * k:n] = np.c_[np.full(n - 2 * k, 5.0), rng.uniform(-5, 5, n - 2 * k),
                       rng.uniform(-1.5, 2.5, n - 2 * k)]
    p[:n] += rng.normal(size=(n, 3)).astype(np.float32) * 0.005
    m = np.arange(C) < n
    nbr, _ = j_knn.knn_search(J(p), J(m), J(p), J(m), 10)
    nbr = np.asarray(nbr)
    nj = j_cov.estimate_normals(J(p), J(m), J(nbr))
    nt = t_cov.estimate_normals(T(p), T(m), T(nbr))
    np.testing.assert_allclose(N(nt), nj, atol=POSE_ATOL)
    np.testing.assert_allclose(N(nt), N(t_cov.estimate_covariances(T(p), T(m), T(nbr),
                                                                   t_cov.NONE)[1]), atol=0)
    assert np.all(np.abs(N(nt)[:k, 2]) > 0.99)     # the floor's normals are vertical


# ------------------------------------------------------------------ imu


@pytest.mark.parametrize("n_valid", [0, 1, 21, 256])
def test_preintegrate_sequential(n_valid):
    """The port's step-by-step loop against JAX's lax.scan ground truth and
    against the port's own log-depth preintegrate, at test_torch_ops.py's
    preintegration tolerances (atol 1e-5 + rtol 1e-4 on the deltas and
    bias Jacobians, which reach ~10 after 256 samples; the covariance at
    rtol 1e-4 + 1e-5 of its largest entry, its entries spanning seven
    orders of magnitude)."""
    rng = np.random.default_rng(107)
    cap = 256
    acc = np.zeros((cap, 3), np.float32)
    gyro = np.zeros((cap, 3), np.float32)
    acc[:n_valid] = [0.3, -0.2, 9.81] + rng.normal(size=(n_valid, 3)) * 0.5
    gyro[:n_valid] = [0.05, -0.02, 0.3] + rng.normal(size=(n_valid, 3)) * 0.1
    dts = np.where(np.arange(cap) < n_valid, 0.005, 0.0).astype(np.float32)
    m = np.arange(cap) < n_valid
    if n_valid > 2:
        m[n_valid // 2] = False        # a masked sample inside the window
    bias = np.array([0.01, -0.02, 0.03, 0.001, -0.002, 0.003], np.float32)
    noise = (np.float32(0.05), np.float32(0.02), np.float32(0.001))
    seq = t_imu.preintegrate_sequential(T(acc), T(gyro), T(dts), T(m), T(bias), *map(T, noise))
    refs = (j_imu.preintegrate_sequential(J(acc), J(gyro), J(dts), J(m), J(bias), *map(J, noise)),
            t_imu.preintegrate(T(acc), T(gyro), T(dts), T(m), T(bias), *map(T, noise)))
    for ref in refs:
        for name in ("dR", "dv", "dp", "dt", "H_Rg", "H_va", "H_vg", "H_pa", "H_pg"):
            np.testing.assert_allclose(N(getattr(seq, name)), N(getattr(ref, name)),
                                       atol=1e-5, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(N(seq.cov), N(ref.cov), rtol=1e-4,
                                   atol=1e-5 * max(1e-30, float(np.abs(N(ref.cov)).max())))
    assert float(seq.dt) == pytest.approx(0.005 * int(m.sum()), rel=1e-5)


# --------------------------------------------------------------- factors


def test_between_linearize_and_scatter():
    """Six between factors over four poses, one pair used twice and one
    reversed; Huber off (k <= 0) on two, active on others. The blocks and
    the dense (24, 24) system at 1e-4 of their largest entries (f32 GN
    products of information up to 100), errors and weights at rtol 1e-4;
    the repeated pair's blocks add up."""
    rng = np.random.default_rng(108)
    poses = _poses(rng, 4, 2.0)
    pairs = np.array([[0, 1], [1, 2], [2, 3], [0, 1], [2, 0], [1, 3]], np.int32)
    Ti, Tj = poses[pairs[:, 0]], poses[pairs[:, 1]]
    noise = _poses(np.random.default_rng(109), 6, 0.05)
    Z = np.linalg.inv(Ti.astype(np.float64)) @ Tj @ noise
    Z = Z.astype(np.float32)
    sqrt_info = rng.uniform(1.0, 10.0, (6, 6)).astype(np.float32)
    huber = np.array([0.0, -1.0, 0.5, 100.0, 0.05, 2.0], np.float32)
    bj = j_fct.between_linearize(J(Ti), J(Tj), J(Z), J(sqrt_info), J(huber))
    bt = t_fct.between_linearize(T(Ti), T(Tj), T(Z), T(sqrt_info), T(huber))
    assert isinstance(bt, t_fct.BetweenBatch) and bt._fields == bj._fields
    for name in ("H_ii", "H_ij", "H_jj", "b_i", "b_j"):
        scaled(N(getattr(bt, name)), np.asarray(getattr(bj, name)))
    np.testing.assert_allclose(N(bt.error), bj.error, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(N(bt.weight), bj.weight, rtol=1e-4)
    w = N(bt.weight)
    assert np.all(w[:2] == 1.0) and np.any(w[2:] < 1.0)

    H0, b0 = np.zeros((24, 24), np.float32), np.zeros(24, np.float32)
    Hj, bj_ = j_fct.scatter_between(J(H0), J(b0), bj, J(pairs[:, 0]), J(pairs[:, 1]))
    Ht, bt_ = t_fct.scatter_between(T(H0), T(b0), bt, T(pairs[:, 0]), T(pairs[:, 1]))
    scaled(N(Ht), np.asarray(Hj))
    scaled(N(bt_), np.asarray(bj_))
    np.testing.assert_array_equal(H0, 0.0)                  # inputs are not written
    # Pair (0, 1) twice: its off-diagonal block is the sum of both factors'.
    np.testing.assert_allclose(N(Ht)[0:6, 6:12], N(bt.H_ij[0] + bt.H_ij[3]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(N(Ht)[12:18, 0:6], N(bt.H_ij[4]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(Ht), N(Ht).T, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------- solver


def test_scatter_block():
    rng = np.random.default_rng(110)
    H = rng.normal(size=(18, 18)).astype(np.float32)
    b = rng.normal(size=18).astype(np.float32)
    blk = rng.normal(size=(6, 6)).astype(np.float32)
    bb = rng.normal(size=6).astype(np.float32)
    for args in ((T(blk), T(bb), 1, 2), (T(blk), None, 2, 0), (T(blk[:3]), T(bb[:3]), 1, 0, 3, 6)):
        jargs = tuple(J(a) if isinstance(a, torch.Tensor) else a for a in args)
        Ht, bt = t_solver.scatter_block(T(H), T(b), *args)
        Hj, bj = j_solver.scatter_block(J(H), J(b), *jargs)
        np.testing.assert_array_equal(N(Ht), Hj)
        np.testing.assert_array_equal(N(bt), bj)
    H_in, b_in = T(H), T(b)
    t_solver.scatter_block(H_in, b_in, T(blk), T(bb), 0, 0)
    assert np.array_equal(N(H_in), H) and np.array_equal(N(b_in), b)   # inputs not written


def _gicp_scene(rng, n=800, cap=1024):
    """tests/test_gicp.py's scene: three walls, so the registration is
    well-conditioned."""
    pts = np.zeros((cap, 3), np.float32)
    n3 = n // 3
    pts[:n3, 0] = rng.uniform(-5, 5, n3)
    pts[:n3, 1] = rng.uniform(-5, 5, n3)
    pts[n3:2 * n3, 0] = rng.uniform(-5, 5, n3)
    pts[n3:2 * n3, 2] = rng.uniform(0, 4, n3)
    pts[n3:2 * n3, 1] = 5.0
    pts[2 * n3:n, 1] = rng.uniform(-5, 5, n - 2 * n3)
    pts[2 * n3:n, 2] = rng.uniform(0, 4, n - 2 * n3)
    pts[2 * n3:n, 0] = 5.0
    pts[:n] += rng.normal(size=(n, 3)) * 0.005
    mask = np.arange(cap) < n
    covs = np.broadcast_to(np.eye(3, dtype=np.float32) * 0.01, (cap, 3, 3)).copy()
    return pts, mask, covs


def test_gn_optimize_scan_recovers_the_gicp_scene():
    """The twin of tests/test_gicp.py's test_gn_scan_variant: the same
    scene, voxel map and perturbation through 10 fixed GN iterations; the
    pose against the truth at that test's bound (0.1 m) and the error
    decreasing; the port's pose against JAX's at POSE_ATOL and its errors
    against JAX's, iteration by iteration, at rtol 1e-4 (a wrong damping,
    a skipped iteration or a shifted ``errs`` shows there)."""
    rng = np.random.default_rng(42)                # tests/conftest.py's rng fixture
    pts, mask, covs = _gicp_scene(rng)
    vj = j_vmx.voxelmap_insert(j_vmx.empty_gaussian_voxelmap(2048, 0.5), J(pts), J(mask),
                               J(covs), jnp.int32(0))
    vt = t_vmx.voxelmap_insert(t_vmx.empty_gaussian_voxelmap(2048, 0.5, "cpu"), T(pts),
                               T(mask), T(covs), 0)
    T_true = lie_np.se3_exp(np.array([0.02, 0.0, 0.03, 0.15, -0.1, 0.05]))
    Ti = np.linalg.inv(T_true).astype(np.float32)
    src = (pts @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)

    def lin_t(X):
        s = t_gicp.vgicp_linearize(torch.eye(4), X, T(src), T(covs), T(mask), vt)
        return s.H_ss, s.b_s, s.error

    def lin_j(X):
        s = j_gicp.vgicp_linearize(jnp.eye(4), X, J(src), J(covs), J(mask), vj)
        return s.H_ss, s.b_s, s.error

    Xt, errs_t = t_solver.gn_optimize_scan(lin_t, lambda X, d: X @ t_lie.se3_exp(d),
                                           torch.eye(4), num_iters=10)
    Xj, errs_j = j_solver.gn_optimize_scan(lin_j, lambda X, d: X @ j_lie.se3_exp(d),
                                           jnp.eye(4), num_iters=10)
    assert errs_t.shape == errs_j.shape == (10,)
    err = lie_np.se3_log(np.linalg.inv(T_true) @ N(Xt).astype(np.float64))
    assert np.linalg.norm(err[3:]) < 0.1, err
    assert float(errs_t[-1]) < float(errs_t[0])
    np.testing.assert_allclose(N(errs_t), np.asarray(errs_j), rtol=1e-4)
    np.testing.assert_allclose(N(Xt), np.asarray(Xj), atol=POSE_ATOL)


# ---------------------------------------------------------------- native


def test_native_available():
    """Both packers can be used: JAX's C++ library builds here (g++), the
    port's is numpy."""
    assert t_loader.available() is True
    assert j_native.available()
    assert t_loader.pack_scan_i16 is __import__("glim_tpu_torch.native.pack",
                                                fromlist=["pack_scan_i16"]).pack_scan_i16
