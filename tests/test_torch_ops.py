"""The port's device ops (glim_tpu_torch/ops/*) against the JAX package's.

Every case makes its inputs with numpy from a seed and hands the same arrays
to both packages; random draws are made once (by JAX where the op draws) and
fed to the port. Tolerances are float32 atol 1e-5 unless a test states why
it needs more; integer and ordering results (hashes, sorts, neighbour
indices, map contents) must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.ops import covariance as j_cov
from glim_tpu.ops import deskew as j_deskew
from glim_tpu.ops import eigh3 as j_eigh3
from glim_tpu.ops import gicp as j_gicp
from glim_tpu.ops import imu as j_imu
from glim_tpu.ops import knn as j_knn
from glim_tpu.ops import lie as j_lie
from glim_tpu.ops import pointops as j_pointops
from glim_tpu.ops import solver as j_solver
from glim_tpu.ops import voxelmap as j_vmx
from glim_tpu_torch.ops import covariance as t_cov
from glim_tpu_torch.ops import deskew as t_deskew
from glim_tpu_torch.ops import eigh3 as t_eigh3
from glim_tpu_torch.ops import gicp as t_gicp
from glim_tpu_torch.ops import imu as t_imu
from glim_tpu_torch.ops import knn as t_knn
from glim_tpu_torch.ops import lie as t_lie
from glim_tpu_torch.ops import pointops as t_pointops
from glim_tpu_torch.ops import solver as t_solver
from glim_tpu_torch.ops import voxelmap as t_vmx

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def T(a):
    return torch.from_numpy(np.asarray(a, order="C"))


def J(a):
    return jnp.asarray(np.asarray(a))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rotvecs(rng, n, regime):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = {"tiny": rng.uniform(1e-6, 1e-4, n), "moderate": rng.uniform(0.1, 2.5, n),
             "near_pi": np.pi - rng.uniform(1e-4, 2e-3, n)}[regime]
    return (axis * angle[:, None]).astype(np.float32)


def _spd(rng, n, size):
    A = rng.normal(size=(n, size, size))
    return (A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(size)).astype(np.float32)


# ------------------------------------------------------------------ lie


@pytest.mark.parametrize("regime", ["tiny", "moderate", "near_pi"])
def test_lie_so3_se3(regime):
    """exp/log/adjoint/quaternions vs JAX. Near pi the log goes through the
    quaternion route, where f32 rounding of R is amplified ~1/sin(theta):
    atol 2e-3 there, 1e-5 elsewhere."""
    rng = np.random.default_rng(0)
    w = _rotvecs(rng, 64, regime)
    xi = np.concatenate([w, rng.normal(size=(64, 3)).astype(np.float32)], axis=1)
    R_t, R_j = t_lie.so3_exp(T(w)), j_lie.so3_exp(J(w))
    np.testing.assert_allclose(N(R_t), R_j, atol=ATOL)
    log_tol = 2e-3 if regime == "near_pi" else ATOL
    np.testing.assert_allclose(N(t_lie.so3_log(R_t)), j_lie.so3_log(R_j), atol=log_tol)
    T_t, T_j = t_lie.se3_exp(T(xi)), j_lie.se3_exp(J(xi))
    np.testing.assert_allclose(N(T_t), T_j, atol=ATOL)
    np.testing.assert_allclose(N(t_lie.se3_log(T_t)), j_lie.se3_log(T_j), atol=log_tol)
    np.testing.assert_allclose(N(t_lie.se3_inv(T_t)), j_lie.se3_inv(T_j), atol=ATOL)
    np.testing.assert_allclose(N(t_lie.se3_adjoint(T_t)), j_lie.se3_adjoint(T_j), atol=ATOL)
    q_t, q_j = t_lie.rot_to_quat(R_t), j_lie.rot_to_quat(R_j)
    np.testing.assert_allclose(N(q_t), q_j, atol=ATOL)
    np.testing.assert_allclose(N(t_lie.quat_to_rot(q_t)), j_lie.quat_to_rot(q_j), atol=ATOL)
    a = rng.uniform(0, 1, 64).astype(np.float32)
    np.testing.assert_allclose(N(t_lie.quat_slerp(q_t, q_t.flip(0), T(a))),
                               j_lie.quat_slerp(q_j, q_j[::-1], J(a)), atol=1e-4)
    np.testing.assert_allclose(N(t_lie.so3_left_jacobian_inv(T(w))),
                               j_lie.so3_left_jacobian_inv(J(w)), atol=1e-4)


@pytest.mark.parametrize("angle", [0.0, 1e-7, 1.0, np.pi - 1e-6])
def test_lie_jacfwd_finite(angle):
    """Forward-mode Jacobians through exp/log stay finite at the branch
    points (theta ~ 0 and theta ~ pi), in the float64 the window uses, and
    agree with JAX's float32 jacfwd away from pi (atol 1e-4: f32 vs f64)."""
    xi0 = np.array([angle, 0.0, 0.0, 0.1, -0.2, 0.3])
    f_t = lambda x: t_lie.se3_log(t_lie.se3_exp(torch.from_numpy(xi0)) @ t_lie.se3_exp(x))
    Jt = torch.func.jacfwd(f_t)(torch.zeros(6, dtype=torch.float64))
    assert torch.isfinite(Jt).all()
    if angle < 3.0:
        xj = J(xi0.astype(np.float32))
        Jj = jax.jacfwd(lambda x: j_lie.se3_log(j_lie.se3_exp(xj) @ j_lie.se3_exp(x)))(
            jnp.zeros(6, jnp.float32))
        np.testing.assert_allclose(N(Jt), Jj, atol=1e-4)


# ------------------------------------------------------------- pointops


@pytest.mark.parametrize("lo,hi", [(-50, 50), (-(1 << 20), 1 << 20),
                                   (-(1 << 31), (1 << 31) - 1)])
def test_hashes_bit_exact(lo, hi):
    """uint32 wraparound emulated in int64: every bit must match, negative
    coordinates included (they decide sort order)."""
    rng = np.random.default_rng(1)
    c = rng.integers(lo, hi, size=(4096, 3), endpoint=True).astype(np.int32)
    c[:4] = [[lo, lo, lo], [hi, hi, hi], [-1, -1, -1], [0, 0, 0]]
    np.testing.assert_array_equal(N(t_pointops.hash_coords(T(c))),
                                  j_pointops.hash_coords(J(c)))
    np.testing.assert_array_equal(N(t_pointops.hash_coords2(T(c))),
                                  j_pointops.hash_coords2(J(c)))
    np.testing.assert_array_equal(N(t_knn.morton_code(T(c))), j_knn.morton_code(J(c)))


def test_voxel_coords_and_filters():
    rng = np.random.default_rng(2)
    p = rng.uniform(-60, 60, (1024, 3)).astype(np.float32)
    p[:3] = [[np.nan, 0, 0], [0.0, 0.1, 0.0], [-0.25, 0.5, -1e-7]]
    m = rng.uniform(size=1024) > 0.1
    res = np.float32(0.4)
    np.testing.assert_array_equal(N(t_pointops.voxel_coords(T(p[3:]), 1.0 / T(res))),
                                  j_pointops.voxel_coords(J(p[3:]), 1.0 / J(res)))
    np.testing.assert_array_equal(
        N(t_pointops.distance_filter(T(p), T(m), 0.5, 50.0)),
        j_pointops.distance_filter(J(p), J(m), 0.5, 50.0))
    Tb = np.eye(4, dtype=np.float32)
    Tb[:3, 3] = [1, 2, 3]
    lo, hi = np.array([-5, -5, -5], np.float32), np.array([5, 5, 5], np.float32)
    np.testing.assert_array_equal(
        N(t_pointops.cropbox_filter(T(p), T(m), T(Tb), T(lo), T(hi))),
        j_pointops.cropbox_filter(J(p), J(m), J(Tb), J(lo), J(hi)))
    q = np.nan_to_num(p)
    np.testing.assert_allclose(N(t_pointops.median_distance(T(q), T(m))),
                               j_pointops.median_distance(J(q), J(m)), rtol=1e-6)


@pytest.mark.parametrize("target", [100, 700, 5000])
def test_randomgrid_sampling_with_jax_draws(target):
    """JAX's own priorities (uniform(rng) and uniform(fold_in(rng, 1)))
    injected: output points, mask and source indices must match exactly."""
    rng = np.random.default_rng(3)
    C = 2048
    p = rng.uniform(-15, 15, (C, 3)).astype(np.float32)
    m = np.arange(C) < 1900
    res = np.float32(1.0)
    key = jax.random.PRNGKey(target)
    prio = np.asarray(jax.random.uniform(key, (C,)))
    prio2 = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (C,)))
    pj, mj, ij = j_pointops.randomgrid_sampling(J(p), J(m), J(res), jnp.int32(target), key)
    pt, mt, it = t_pointops.randomgrid_sampling(T(p), T(m), T(res), target, T(prio), T(prio2))
    np.testing.assert_array_equal(N(mt), mj)
    np.testing.assert_array_equal(N(it), ij)
    np.testing.assert_array_equal(N(pt), pj)


def test_voxelgrid_sampling():
    """Centroids: f32 segment sums in another order, atol 1e-5."""
    rng = np.random.default_rng(4)
    p = rng.uniform(-10, 10, (1024, 3)).astype(np.float32)
    m = rng.uniform(size=1024) > 0.2
    pj, mj = j_pointops.voxelgrid_sampling(J(p), J(m), 1.5)
    pt, mt = t_pointops.voxelgrid_sampling(T(p), T(m), 1.5)
    np.testing.assert_array_equal(N(mt), mj)
    np.testing.assert_allclose(N(pt)[N(mt)], np.asarray(pj)[np.asarray(mj)], atol=ATOL)


# ------------------------------------------------------------------ knn


def _scan_like(rng, C, n_valid):
    """Points on a few planes plus noise (what covariance estimation sees)."""
    u = rng.uniform(-10, 10, (C, 2))
    plane = rng.integers(0, 3, C)
    p = np.zeros((C, 3))
    for k in range(3):
        s = plane == k
        p[s] = np.insert(u[s], k, 3.0 * k - 3.0, axis=1)
    p += rng.normal(size=p.shape) * 0.02
    return p.astype(np.float32), np.arange(C) < n_valid


@pytest.mark.parametrize("k,window", [(10, 64), (5, 16)])
def test_knn_banded_exact_match(k, window):
    rng = np.random.default_rng(5)
    p, m = _scan_like(rng, 1024, 1000)
    nj, dj = j_knn.knn_banded(J(p), J(m), k, window=window, cell=0.8)
    nt, dt = t_knn.knn_banded(T(p), T(m), k, window=window, cell=0.8)
    np.testing.assert_array_equal(N(nt), nj)
    np.testing.assert_allclose(N(dt)[m], np.asarray(dj)[m], atol=ATOL)


def test_knn_search_k3():
    """Indices exact where the k-th and (k+1)-th distances are apart."""
    rng = np.random.default_rng(6)
    q, t = rng.uniform(-5, 5, (200, 3)).astype(np.float32), rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    qm, tm = rng.uniform(size=200) > 0.1, rng.uniform(size=300) > 0.2
    ij, dj = j_knn.knn_search(J(q), J(qm), J(t), J(tm), k=3)
    it, dt = t_knn.knn_search(T(q), T(qm), T(t), T(tm), k=3)
    np.testing.assert_array_equal(N(it), ij)
    np.testing.assert_allclose(N(dt)[qm], np.asarray(dj)[qm], atol=1e-4)


# ---------------------------------------------------------- covariances


def test_eigh_sym3x3():
    """Closed-form spectra; eigenvectors compared up to sign."""
    rng = np.random.default_rng(7)
    A = _spd(rng, 512, 3)
    A[:4] = np.diag([1.0, 1.0, 1.0]), np.diag([2.0, 1.0, 1.0]), np.zeros((3, 3)), np.diag([1e-3, 1.0, 1.0])
    wj, Vj = j_eigh3.eigh_sym3x3(J(A))
    wt, Vt = t_eigh3.eigh_sym3x3(T(A))
    np.testing.assert_allclose(N(wt), wj, atol=1e-5 * np.abs(A).max())
    dots = np.abs(np.sum(N(Vt) * np.asarray(Vj), axis=-2))
    distinct = np.min(np.diff(np.asarray(wj), axis=-1), axis=-1) > 1e-2
    np.testing.assert_allclose(dots[distinct], 1.0, atol=1e-4)


def test_estimate_covariances_and_outliers():
    """PLANE covariances: eigenvectors from the trigonometric solution carry
    f32 rounding amplified by 1/eigengap, so atol 1e-4 on the regularised
    covariance; normals compared at atol 1e-3."""
    rng = np.random.default_rng(8)
    p, m = _scan_like(rng, 1024, 1000)
    nbr, d2 = j_knn.knn_banded(J(p), J(m), 10, window=64, cell=0.8)
    nbr = np.asarray(nbr)
    cj, nj = j_cov.estimate_covariances(J(p), J(m), J(nbr), "plane")
    ct, nt = t_cov.estimate_covariances(T(p), T(m), T(nbr), "plane")
    np.testing.assert_allclose(N(ct), cj, atol=1e-4)
    np.testing.assert_allclose(N(nt), nj, atol=1e-3)
    d2 = np.asarray(d2)
    np.testing.assert_array_equal(N(t_cov.outlier_mask(T(d2), T(m), 1.0)),
                                  j_cov.outlier_mask(J(d2), J(m), 1.0))


# ------------------------------------------------------------------ imu


def _imu_window(rng, n_valid, cap=256):
    acc = np.zeros((cap, 3), np.float32)
    gyro = np.zeros((cap, 3), np.float32)
    acc[:n_valid] = [0.3, -0.2, 9.81] + rng.normal(size=(n_valid, 3)) * 0.5
    gyro[:n_valid] = [0.05, -0.02, 0.3] + rng.normal(size=(n_valid, 3)) * 0.1
    dts = np.zeros(cap, np.float32)
    dts[:n_valid] = 0.005
    return acc, gyro, dts, np.arange(cap) < n_valid


@pytest.mark.parametrize("n_valid", [0, 1, 21, 256])
def test_preintegrate(n_valid):
    """Log-depth doubling scan vs JAX's associative scan and its sequential
    ground truth. The deltas at atol 1e-5 plus rtol 1e-4: after 256 samples
    dv, dp and the bias Jacobians reach ~10, and H_vg / H_pg sum the H_Rg
    prefix (whose scan order differs, ~2e-6) times |a| ~ 10 m/s^2 over the
    window, so their f32 rounding grows to ~2e-5 (JAX's own two versions
    differ by 6e-6). The covariance at rtol 1e-4 + atol 1e-5 of its largest
    entry: its entries span seven orders of magnitude and the near-zero
    off-diagonal ones are the rounding residue of cancelling products."""
    rng = np.random.default_rng(9)
    acc, gyro, dts, m = _imu_window(rng, n_valid)
    bias = np.array([0.01, -0.02, 0.03, 0.001, -0.002, 0.003], np.float32)
    noise = (np.float32(0.05), np.float32(0.02), np.float32(0.001))
    pt = t_imu.preintegrate(T(acc), T(gyro), T(dts), T(m), T(bias), *map(T, noise))
    for fn in (j_imu.preintegrate, j_imu.preintegrate_sequential):
        pj = fn(J(acc), J(gyro), J(dts), J(m), J(bias), *map(J, noise))
        for name in ("dR", "dv", "dp", "dt", "H_Rg", "H_va", "H_vg", "H_pa", "H_pg"):
            np.testing.assert_allclose(N(getattr(pt, name)), getattr(pj, name),
                                       atol=ATOL, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(N(pt.cov), pj.cov, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(pj.cov).max()))


def test_predict_residual_integrate_poses():
    """Positions over 1.3 s of motion reach ~4 m: atol 1e-4 there."""
    rng = np.random.default_rng(10)
    acc, gyro, dts, m = _imu_window(rng, 256)
    bias = np.array([0.01, -0.02, 0.03, 0.001, -0.002, 0.003], np.float32)
    R0 = np.asarray(j_lie.so3_exp(J(np.array([0.1, -0.2, 0.3], np.float32))))
    p0, v0 = np.array([1, 2, 3], np.float32), np.array([3, 0, 0.1], np.float32)
    g = np.array([0, 0, -9.80665], np.float32)
    out_j = j_imu.integrate_poses(J(R0), J(p0), J(v0), J(bias), J(g), J(acc), J(gyro), J(dts), J(m))
    out_t = t_imu.integrate_poses(T(R0), T(p0), T(v0), T(bias), T(g), T(acc), T(gyro), T(dts), T(m))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(N(a), b, atol=1e-4)
    noise = (np.float32(0.05), np.float32(0.02), np.float32(0.001))
    pj = j_imu.preintegrate(J(acc), J(gyro), J(dts), J(m), J(bias), *map(J, noise))
    pt = t_imu.preintegrate(T(acc), T(gyro), T(dts), T(m), T(bias), *map(T, noise))
    b2 = bias + 0.01
    for a, b in zip(t_imu.predict(T(R0), T(p0), T(v0), pt, T(b2), T(g)),
                    j_imu.predict(J(R0), J(p0), J(v0), pj, J(b2), J(g))):
        np.testing.assert_allclose(N(a), b, atol=1e-4)
    R1 = np.asarray(j_lie.so3_exp(J(np.array([0.2, -0.1, 0.5], np.float32))))
    p1, v1 = p0 + 4.0, v0 + 0.5
    np.testing.assert_allclose(
        N(t_imu.imu_residual(T(R0), T(p0), T(v0), T(R1), T(p1), T(v1), T(b2), pt, T(g))),
        j_imu.imu_residual(J(R0), J(p0), J(v0), J(R1), J(p1), J(v1), J(b2), pj, J(g)),
        atol=1e-4)


def test_deskew_imu():
    """Stamps padded with +inf (as the window pads them); atol 1e-4 for
    points at up to 30 m."""
    rng = np.random.default_rng(11)
    acc, gyro, dts, m = _imu_window(rng, 24, cap=64)
    R0 = np.eye(3, dtype=np.float32)
    z3 = np.zeros(3, np.float32)
    g = np.array([0, 0, -9.80665], np.float32)
    Rs, ps, _ = j_imu.integrate_poses(J(R0), J(z3), J(np.array([2, 0, 0], np.float32)),
                                      J(np.zeros(6, np.float32)), J(g), J(acc), J(gyro), J(dts), J(m))
    stamps = np.where(m, np.cumsum(dts) - 0.02, np.inf).astype(np.float32)
    sj, qj, tj = j_deskew.imu_pose_table(J(stamps), Rs, ps)
    st, qt, tt = t_deskew.imu_pose_table(T(stamps), T(np.asarray(Rs)), T(np.asarray(ps)))
    np.testing.assert_allclose(N(qt), qj, atol=ATOL)
    pts = rng.uniform(-30, 30, (512, 3)).astype(np.float32)
    times = rng.uniform(0, 0.1, 512).astype(np.float32)
    pm = rng.uniform(size=512) > 0.1
    T_li = np.asarray(j_lie.se3_exp(J(np.array([0.01, 0.02, -0.03, 0.1, 0.0, -0.2], np.float32))))
    np.testing.assert_allclose(
        N(t_deskew.deskew_imu(T(pts), T(times), T(pm), st, qt, tt, T(T_li))),
        j_deskew.deskew_imu(J(pts), J(times), J(pm), sj, qj, tj, J(T_li)), atol=1e-4)


# ---------------------------------------------------------- gicp, solver


@pytest.mark.parametrize("hit_rate", [1.0, 0.6, 0.0])
def test_linearize_core_soa(hit_rate):
    """6x6 blocks summed over 512 points in another order: rtol 1e-4
    relative to each block's largest entry."""
    rng = np.random.default_rng(12)
    C = 512
    R = np.asarray(j_lie.so3_exp(J(np.array([0.1, 0.2, -0.1], np.float32))))
    t = np.array([0.5, -0.3, 0.2], np.float32)
    pts = rng.uniform(-10, 10, (3, C)).astype(np.float32)
    mu = (R @ pts + t[:, None] + rng.normal(size=(3, C)) * 0.05).astype(np.float32)
    covs = np.asarray(j_gicp.sym_pack_soa(J(_spd(rng, C, 3) * 0.1)))
    ct = np.asarray(j_gicp.sym_pack_soa(J(_spd(rng, C, 3) * 0.1)))
    hit = rng.uniform(size=C) < hit_rate
    out_j = j_gicp.linearize_core_soa(J(R), J(t), J(pts), J(covs), J(mu), J(ct), J(hit))
    out_t = t_gicp.linearize_core_soa(T(R), T(t), T(pts), T(covs), T(mu), T(ct), T(hit))
    for a, b in zip(out_t, out_j):
        b = np.asarray(b)
        np.testing.assert_allclose(N(a), b, atol=1e-4 * max(1.0, np.abs(b).max()))
    src = t_gicp.linearize_core_soa(T(R), T(t), T(pts), T(covs), T(mu), T(ct), T(hit),
                                    source_only=True)
    for a, b in zip(src, (out_t[2], out_t[4], out_t[5])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["spd", "indefinite"])
def test_solve_damped(kind):
    """SPD: the equilibrated Cholesky path; indefinite: Cholesky fails and
    the LU solve is selected on device. Relative atol 1e-4 (f32 solves of
    a 30x30 system with condition ~1e3)."""
    rng = np.random.default_rng(13)
    H = _spd(rng, 1, 30)[0]
    if kind == "indefinite":
        H = (H - 2.0 * np.abs(H).max() * np.eye(30)).astype(np.float32)
    b = rng.normal(size=30).astype(np.float32)
    xj = np.asarray(j_solver.solve_damped(J(H), J(b), jnp.float32(1e-4)))
    xt = N(t_solver.solve_damped(T(H), T(b), torch.tensor(1e-4)))
    assert np.isfinite(xt).all()
    np.testing.assert_allclose(xt, xj, atol=1e-4 * max(1.0, np.abs(xj).max()))


def test_schur_marginalize():
    rng = np.random.default_rng(14)
    H = _spd(rng, 1, 30)[0]
    b = rng.normal(size=30).astype(np.float32)
    for a, c in zip(t_solver.schur_marginalize(T(H), T(b), 15),
                    j_solver.schur_marginalize(J(H), J(b), 15)):
        c = np.asarray(c)
        np.testing.assert_allclose(N(a), c, atol=1e-4 * max(1.0, np.abs(c).max()))


# ------------------------------------------------------------- voxel maps


def _pm_numpy(pm):
    return {k: np.asarray(getattr(pm, k)) for k in ("points", "covs", "mask", "age")}


@pytest.mark.parametrize("capacity", [4096, 64])
def test_pointmap_insert(capacity):
    """Exact contents, including over capacity where many entries tie on
    age (lax.top_k keeps the lower index; the port must too)."""
    rng = np.random.default_rng(15)
    pj = j_vmx.empty_point_voxelmap(capacity, 0.5)
    pt = t_vmx.empty_point_voxelmap(capacity, 0.5, device="cpu")
    for step in range(3):
        n = 200
        pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        covs = _spd(rng, n, 3)
        m = rng.uniform(size=n) > 0.1
        pj = j_vmx.pointmap_insert(pj, J(pts), J(m), J(covs), jnp.int32(step))
        pt = t_vmx.pointmap_insert(pt, T(pts), T(m), T(covs), step)
        a, b = _pm_numpy(pt), _pm_numpy(pj)
        for k in a:
            np.testing.assert_array_equal(N(getattr(pt, k)), b[k], err_msg=f"{k} step {step}")


@pytest.mark.parametrize("capacity", [2048, 128])
def test_gaussian_voxelmap_insert_and_lookup(capacity):
    """Keys, counts and ages exact; means/covariances are f32 segment sums
    in another order (atol 1e-5); lookups exact."""
    rng = np.random.default_rng(16)
    vj = j_vmx.empty_gaussian_voxelmap(capacity, 0.5)
    vt = t_vmx.empty_gaussian_voxelmap(capacity, 0.5, "cpu")
    for step in range(3):
        pts = rng.uniform(-8, 8, (400, 3)).astype(np.float32)
        covs = _spd(rng, 400, 3) * 0.01
        m = rng.uniform(size=400) > 0.1
        vj = j_vmx.voxelmap_insert(vj, J(pts), J(m), J(covs), jnp.int32(step))
        vt = t_vmx.voxelmap_insert(vt, T(pts), T(m), T(covs), step)
        for k in ("hash", "coords", "count", "age"):
            np.testing.assert_array_equal(N(getattr(vt, k)), getattr(vj, k), err_msg=k)
        np.testing.assert_allclose(N(vt.mean), vj.mean, atol=ATOL)
        np.testing.assert_allclose(N(vt.cov), vj.cov, atol=ATOL)
    q = rng.uniform(-9, 9, (1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(N(t_vmx.voxelmap_lookup(vt, T(q))),
                                  j_vmx.voxelmap_lookup(vj, J(q)))


# ----------------------------------------------------------- scan packing


@pytest.mark.parametrize("with_times", [True, False])
def test_pack_scan_i16_matches_native(with_times):
    """Bit-exact with glim_tpu/native/pack.cpp (llround: half away from
    zero; NaN and <= -32767 clamp to -32767)."""
    from glim_tpu import native
    from glim_tpu_torch.native import pack_scan_i16

    assert native.available()            # the C++ library builds here (g++)
    rng = np.random.default_rng(17)
    pts = rng.uniform(-200, 200, (600, 3))
    pts[:8, 0] = [0.0025, -0.0025, 0.0075, -0.0125, np.nan, np.inf, -np.inf, 1e9]
    pts[8:12] = np.round(pts[8:12] / 0.005) * 0.005 + 0.0025   # exact halves
    times = rng.uniform(-0.01, 0.11, 600) if with_times else None
    if with_times:
        times[:3] = [np.nan, -1.0, 0.1 / 32000.0 * 2.5]
    a, na = pack_scan_i16(pts, times, 1024, 0.005, 0.1 / 32000.0)
    b, nb = native.pack_scan_i16(pts, times, 1024, 0.005, 0.1 / 32000.0)
    assert na == nb == 600
    np.testing.assert_array_equal(a, b)
