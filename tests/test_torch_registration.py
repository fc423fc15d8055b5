"""The port's global registration (``ops/registration.py``) and
``knn.knn_self`` against the JAX package's, and the JAX tests' recovery
cases (tests/test_registration.py) on the port.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances (f32): the kNN indices exact (no two targets at a tied
distance) and their squared distances at 1e-4 (the expansion's rounding),
FPFH at 1e-5 abs (both fed the same normals: the packages' eigenvectors
may differ in sign), matched correspondences exact on
well-separated descriptors, Kabsch at 1e-5, RANSAC with the JAX draws
injected at 1e-4 with the inlier count exact (inliers at 1 cm, outliers
metres off the 0.5 m threshold), GNC at 1e-4. The recovery cases draw
with the port's own generator and keep the JAX tests' bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.ops import covariance as j_cov
from glim_tpu.ops import knn as j_knn
from glim_tpu.ops import lie_np
from glim_tpu.ops import registration as j_reg
from glim_tpu_torch.ops import covariance as t_cov
from glim_tpu_torch.ops import knn as t_knn
from glim_tpu_torch.ops import registration as t_reg


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield


def T(a):
    return torch.from_numpy(np.array(a, order="C"))


def J(a):
    return jnp.asarray(np.asarray(a))


def structured_cloud(rng, n=600, cap=1024):
    """Corner of two walls and a floor (the JAX tests' cloud)."""
    pts = np.zeros((cap, 3), np.float32)
    k = n // 3
    pts[:k, :2] = rng.uniform(0, 8, (k, 2))
    pts[k:2 * k, 0] = rng.uniform(0, 8, k)
    pts[k:2 * k, 2] = rng.uniform(0, 4, k)
    pts[2 * k:n, 1] = rng.uniform(0, 8, n - 2 * k)
    pts[2 * k:n, 2] = rng.uniform(0, 4, n - 2 * k)
    pts[:n] += rng.normal(size=(n, 3)) * 0.01
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return pts, mask


def t_normals(pts, mask):
    nbr, _ = t_knn.knn_self(pts, mask, 10)
    return t_cov.estimate_covariances(pts, mask, nbr, "plane")[1]


def j_normals(pts, mask):
    nbr, _ = j_knn.knn_self(J(pts), J(mask), 10)
    return np.asarray(j_cov.estimate_covariances(J(pts), J(mask), nbr, "plane")[1])


def test_knn_self_matches_jax():
    rng = np.random.default_rng(1)
    pts, mask = structured_cloud(rng)
    mask[5] = False
    idx_t, d2_t = t_knn.knn_self(T(pts), T(mask), 10)
    idx_j, d2_j = j_knn.knn_self(J(pts), J(mask), 10)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    # d2 by the expansion |q|^2 + |t|^2 - 2 q.t at |q|^2 up to ~130 m^2.
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), atol=1e-4)
    assert (idx_t[mask, 0].numpy() == np.nonzero(mask)[0]).all()     # self first


def test_estimate_fpfh_matches_jax():
    rng = np.random.default_rng(2)
    pts, mask = structured_cloud(rng)
    normals = j_normals(pts, mask)
    for k in (10, 20):
        f_t = t_reg.estimate_fpfh(T(pts), T(normals), T(mask), k=k)
        f_j = j_reg.estimate_fpfh(J(pts), J(normals), J(mask), k=k)
        assert f_t.shape == (1024, t_reg.FPFH_DIM)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-5)


def test_match_features_matches_jax():
    """Descriptors apart by far more than the rounding of their distances."""
    rng = np.random.default_rng(3)
    tgt = rng.uniform(size=(300, 33)).astype(np.float32)
    perm = rng.permutation(300)[:200]
    src = (tgt[perm] + rng.normal(0, 0.02, (200, 33))).astype(np.float32)
    src[150:] = rng.uniform(size=(50, 33))                  # unmatched descriptors
    sm, tm = rng.uniform(size=200) > 0.1, rng.uniform(size=300) > 0.1
    c_t, m_t = t_reg.match_features(T(src), T(sm), T(tgt), T(tm))
    c_j, m_j = j_reg.match_features(J(src), J(sm), J(tgt), J(tm))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert 100 < m_t.sum() < 200


def _pair(rng, n=400, outliers=0.5):
    """Correspondences of a rigid motion: inliers at 1 cm, the rest moved
    metres away."""
    src = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    T_true = lie_np.se3_exp(np.array([0.1, -0.2, 0.7, 2.0, -1.0, 0.5]))
    tgt = (src @ T_true[:3, :3].T + T_true[:3, 3] + rng.normal(0, 0.01, (n, 3)))
    bad = rng.uniform(size=n) < outliers
    tgt[bad] += rng.uniform(2.0, 6.0, (bad.sum(), 3)) * rng.choice([-1, 1], (bad.sum(), 3))
    return src, tgt.astype(np.float32), T_true


def test_kabsch_matches_jax():
    rng = np.random.default_rng(4)
    src, tgt, _ = _pair(rng, outliers=0.2)
    w = rng.uniform(size=400).astype(np.float32)
    np.testing.assert_allclose(t_reg._kabsch(T(src), T(tgt), T(w)).numpy(),
                               np.asarray(j_reg._kabsch(J(src), J(tgt), J(w))), atol=1e-5)
    # A reflection-prone cross-covariance still gives a rotation.
    R = t_reg._kabsch(T(src), T(-tgt), T(w))[:3, :3].double()
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5


def test_ransac_core_with_jax_draws_matches_jax():
    rng = np.random.default_rng(5)
    src, tgt, _ = _pair(rng)
    corr = rng.permutation(400)
    tgt_perm = np.empty_like(tgt)
    tgt_perm[corr] = tgt                           # tgt_perm[corr[i]] == tgt[i]
    valid = rng.uniform(size=400) > 0.1
    n_h = 256
    key = jax.random.PRNGKey(3)
    res_j, inl_j = j_reg._ransac_core(J(src), J(tgt_perm), J(corr.astype(np.int32)), J(valid),
                                      jnp.float32(0.5), key, n_hypotheses=n_h)
    p = valid.astype(np.float32) / valid.sum()
    idx = np.asarray(jax.random.choice(key, 400, (n_h, 3), p=J(p)))
    res_t, inl_t = t_reg._ransac_core(T(src), T(tgt_perm), T(corr), T(valid), 0.5, n_h,
                                      idx=T(idx))
    np.testing.assert_allclose(res_t.T_target_source.numpy(),
                               np.asarray(res_j.T_target_source), atol=1e-4)
    assert int(res_t.num_inliers) == int(res_j.num_inliers) > 150
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert float(res_t.inlier_fraction) == pytest.approx(float(res_j.inlier_fraction), abs=1e-7)


def test_gnc_core_matches_jax():
    rng = np.random.default_rng(6)
    src, tgt, _ = _pair(rng, outliers=0.3)
    valid = rng.uniform(size=400) > 0.05
    res_t, inl_t = t_reg._gnc_core(T(src), T(tgt), T(valid), 0.5, 1e3, 1.4, 20)
    res_j, inl_j = j_reg._gnc_core(J(src), J(tgt), J(valid), jnp.float32(0.5),
                                   jnp.float32(1e3), jnp.float32(1.4), iters=20)
    np.testing.assert_allclose(res_t.T_target_source.numpy(),
                               np.asarray(res_j.T_target_source), atol=1e-4)
    assert int(res_t.num_inliers) == int(res_j.num_inliers)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))


def _make_pair(rng, xi):
    """The JAX tests' make_pair on the port."""
    pts, mask = structured_cloud(rng)
    pts, mask = T(pts), T(mask)
    feat = t_reg.estimate_fpfh(pts, t_normals(pts, mask), mask)
    T_true = lie_np.se3_exp(xi).astype(np.float32)
    Ti = np.linalg.inv(T_true).astype(np.float32)
    src = pts @ T(Ti[:3, :3].T) + T(Ti[:3, 3])
    feat_s = t_reg.estimate_fpfh(src, t_normals(src, mask), mask)
    return src, feat_s, mask, pts, feat, mask, T_true


def _err(T_true, T_est):
    return lie_np.se3_log(np.linalg.inv(T_true.astype(np.float64))
                          @ T_est.numpy().astype(np.float64))


def test_ransac_recovers_large_transform(rng):
    src, fs, ms, tgt, ft, mt, T_true = _make_pair(rng, np.array([0.0, 0.0, 0.8, 3.0, -2.0, 0.5]))
    res, inliers = t_reg.estimate_pose_ransac(
        src, fs, ms, tgt, ft, mt, t_reg.RANSACParams(max_iterations=2048, inlier_threshold=0.4))
    err = _err(T_true, res.T_target_source)
    assert float(res.inlier_fraction) > 0.05
    assert np.linalg.norm(err[3:]) < 0.3, err
    assert len(t_reg.find_inlier_points(src, inliers)) == int(res.num_inliers)


def test_gnc_recovers_transform(rng):
    src, fs, ms, tgt, ft, mt, T_true = _make_pair(rng, np.array([0.0, 0.0, 0.5, 2.0, 1.0, 0.0]))
    res, _ = t_reg.estimate_pose_gnc(src, fs, ms, tgt, ft, mt,
                                     t_reg.GNCParams(inlier_threshold=0.4))
    assert np.linalg.norm(_err(T_true, res.T_target_source)[3:]) < 0.3


def test_ransac_draws_follow_valid():
    """The port's own draws: seeded, and only among valid correspondences
    (uniform when none is valid)."""
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 17, 40]] = True
    a, b = t_reg.draw_triplets(valid, 100, 7), t_reg.draw_triplets(valid, 100, 7)
    assert torch.equal(a, b) and a.shape == (100, 3)
    assert set(a.flatten().tolist()) <= {3, 17, 40}
    assert t_reg.draw_triplets(torch.zeros(50, dtype=torch.bool), 10, 0).max() < 50
