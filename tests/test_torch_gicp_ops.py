"""The GICP-module ops the pose-graph back-end adds to the port, against the
JAX package's: ``vgicp_linearize`` (a voxel-map lookup and the SoA system),
``icp_linearize`` and ``inlier_fraction`` (through ``nn_search``: the plain
version on CPU tensors, the XLA k=1 search in JAX), ``gicp_error`` and
``vgicp_error``.

Two views of one random cloud, made with numpy from a seed, a few metres
and degrees apart. Tolerances (f32): blocks at 1e-4 of their largest entry,
errors at rtol 1e-4, inlier counts and fractions exact (the queries'
nearest targets are decisive at this density).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.ops import gicp as j_gicp
from glim_tpu.ops import lie_np
from glim_tpu.ops import voxelmap as j_vmx
from glim_tpu_torch.ops import gicp as t_gicp
from glim_tpu_torch.ops import voxelmap as t_vmx
from glim_tpu_torch.ops.nn_search import nn_search

BLOCKS = ("H_tt", "H_ts", "H_ss", "b_t", "b_s")


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield


def T(a):
    return torch.from_numpy(np.array(a, order="C"))


def J(a):
    return jnp.asarray(np.asarray(a))


def scaled(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rel * max(1.0, float(np.abs(b).max())))


@pytest.fixture(scope="module")
def clouds():
    """Target and source views (points, covariances, masks) and the poses."""
    rng = np.random.default_rng(11)
    base = rng.normal(0, 3.0, (3000, 3))
    T_w = [np.eye(4), lie_np.se3_exp(np.array([0.02, -0.01, 0.05, 0.8, 0.3, 0.1]))]
    out = []
    for Tk in T_w:
        Ti = np.linalg.inv(Tk)
        local = (Ti[:3, :3] @ base.T).T + Ti[:3, 3]
        pts = np.zeros((1024, 3), np.float32)
        sel = rng.permutation(len(local))[:1000]
        pts[:1000] = local[sel] + rng.normal(0, 0.01, (1000, 3))
        mask = np.zeros(1024, bool)
        mask[:1000] = True
        A = rng.normal(size=(1024, 3, 3)).astype(np.float32) * 0.1
        covs = (A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3)).astype(np.float32)
        out.append((pts, covs, mask))
    T_t = np.eye(4, dtype=np.float32)
    T_s = (T_w[1] @ lie_np.se3_exp(np.array([0.01, 0, 0, 0.05, -0.03, 0]))).astype(np.float32)
    return out, T_t, T_s


def _voxelmaps(pts, covs, mask, res=1.0):
    vj = j_vmx.voxelmap_insert(j_vmx.empty_gaussian_voxelmap(4096, res), J(pts), J(mask),
                               J(covs), jnp.int32(0))
    vt = t_vmx.voxelmap_insert(t_vmx.empty_gaussian_voxelmap(4096, res, "cpu"), T(pts),
                               T(mask), T(covs), 0)
    return vj, vt


def _check_system(s_t, s_j, min_inliers):
    assert int(s_t.num_inliers) == int(s_j.num_inliers) > min_inliers
    for name in BLOCKS:
        scaled(getattr(s_t, name).numpy(), getattr(s_j, name), 1e-4)
    np.testing.assert_allclose(float(s_t.error), float(s_j.error), rtol=1e-4)


def test_vgicp_linearize_and_error_match_jax(clouds):
    (pt, ct, mt), (ps, cs, ms), T_t, T_s = *clouds[0], clouds[1], clouds[2]
    vj, vt = _voxelmaps(pt, ct, mt)
    s_t = t_gicp.vgicp_linearize(T(T_t), T(T_s), T(ps), T(cs), T(ms), vt)
    s_j = j_gicp.vgicp_linearize(J(T_t), J(T_s), J(ps), J(cs), J(ms), vj)
    _check_system(s_t, s_j, 600)
    # The cached lookup table gives the same system.
    s_k = t_gicp.vgicp_linearize(T(T_t), T(T_s), T(ps), T(cs), T(ms), vt,
                                 t_vmx.lookup_table(vt))
    for name in BLOCKS:
        np.testing.assert_array_equal(getattr(s_k, name).numpy(), getattr(s_t, name).numpy())
    np.testing.assert_allclose(
        float(t_gicp.vgicp_error(T(T_t), T(T_s), T(ps), T(cs), T(ms), vt)),
        float(j_gicp.vgicp_error(J(T_t), J(T_s), J(ps), J(cs), J(ms), vj)), rtol=1e-4)


def test_icp_linearize_matches_jax(clouds):
    (pt, _, mt), (ps, _, ms), T_t, T_s = *clouds[0], clouds[1], clouds[2]
    launches = nn_search.kernel_launches
    s_t = t_gicp.icp_linearize(T(T_t), T(T_s), T(ps), T(ms), T(pt), T(mt), 1.0)
    assert nn_search.kernel_launches == launches        # CPU tensors: plain version
    s_j = j_gicp.icp_linearize(J(T_t), J(T_s), J(ps), J(ms), J(pt), J(mt), jnp.float32(1.0))
    _check_system(s_t, s_j, 700)


def test_gicp_error_matches_jax(clouds):
    (pt, ct, mt), (ps, cs, ms), T_t, T_s = *clouds[0], clouds[1], clouds[2]
    e_t = t_gicp.gicp_error(T(T_t), T(T_s), T(ps), T(cs), T(ms), T(pt), T(ct), T(mt), 2.0)
    e_j = j_gicp.gicp_error(*(J(a) for a in (T_t, T_s, ps, cs, ms, pt, ct, mt)),
                            jnp.float32(2.0))
    assert e_t.dim() == 0
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-4)


@pytest.mark.parametrize("max_dist", [0.05, 0.3, 2.0])
def test_inlier_fraction_matches_jax(clouds, max_dist):
    """Exact: the fraction is a count over the same decisive distances."""
    (pt, _, mt), (ps, _, ms), T_t, T_s = *clouds[0], clouds[1], clouds[2]
    f_t = t_gicp.inlier_fraction(T(T_t), T(T_s), T(ps), T(ms), T(pt), T(mt), max_dist)
    f_j = j_gicp.inlier_fraction(J(T_t), J(T_s), J(ps), J(ms), J(pt), J(mt),
                                 jnp.float32(max_dist))
    assert f_t.dim() == 0 and f_t.dtype == torch.float32
    assert float(f_t) == float(f_j)
    assert 0.0 < float(f_t) <= 1.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_new_ops_on_cuda(clouds, cuda):
    """On the card: ``icp_linearize`` and ``inlier_fraction`` launch the
    CUDA kernel once each, ``vgicp_linearize`` none; the same tolerances
    against JAX on its CPU."""
    (pt, ct, mt), (ps, cs, ms), T_t, T_s = *clouds[0], clouds[1], clouds[2]
    C = lambda a: T(a).to(cuda)
    vj, _ = _voxelmaps(pt, ct, mt)
    vt = t_vmx.voxelmap_insert(t_vmx.empty_gaussian_voxelmap(4096, 1.0, cuda), C(pt), C(mt),
                               C(ct), 0)
    n0 = nn_search.kernel_launches
    s_v = t_gicp.vgicp_linearize(C(T_t), C(T_s), C(ps), C(cs), C(ms), vt)
    assert nn_search.kernel_launches == n0
    s_i = t_gicp.icp_linearize(C(T_t), C(T_s), C(ps), C(ms), C(pt), C(mt), 1.0)
    f_t = t_gicp.inlier_fraction(C(T_t), C(T_s), C(ps), C(ms), C(pt), C(mt), 0.3)
    assert nn_search.kernel_launches == n0 + 2
    cpu = lambda s: type(s)(*(x.cpu() for x in s))
    _check_system(cpu(s_v), j_gicp.vgicp_linearize(J(T_t), J(T_s), J(ps), J(cs), J(ms), vj), 600)
    _check_system(cpu(s_i), j_gicp.icp_linearize(J(T_t), J(T_s), J(ps), J(ms), J(pt), J(mt),
                                                 jnp.float32(1.0)), 700)
    assert float(f_t) == float(j_gicp.inlier_fraction(J(T_t), J(T_s), J(ps), J(ms), J(pt),
                                                      J(mt), jnp.float32(0.3)))
