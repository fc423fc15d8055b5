"""The port's preprocessing (glim_tpu_torch/preprocess/cloud_preprocessor.py)
against the JAX package's, with JAX's own random draws injected.

``_preprocess_device`` splits its key and draws the grid sampler's
priorities from the first half (``uniform(key)`` and
``uniform(fold_in(key, 1))``); the same draws are handed to the port, so
masks, point order and neighbour graphs must match bit for bit. The scan
comes from the synthetic generator, packed to int16 by the native packer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.io.synthetic import generate_sequence
from glim_tpu.native import pack_scan_i16
from glim_tpu.preprocess import cloud_preprocessor as j_pre
from glim_tpu_torch.preprocess import cloud_preprocessor as t_pre
from glim_tpu_torch.types import RawPoints as TRawPoints


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


@pytest.fixture(scope="module")
def scan():
    seq = generate_sequence(duration=0.3, n_scan_points=3000, scene_points=20000, seed=21)
    raw = seq.scans[2]
    t_scale = float(np.max(raw.times)) / 32000.0
    packed, n = pack_scan_i16(raw.points, raw.times, 4096, 0.005, t_scale)
    return raw, packed, np.array([n, t_scale, 0], np.float32)


CASES = {
    "default": dict(use_random_grid=True, exact_knn=False, target=1000),
    "exact_knn": dict(use_random_grid=True, exact_knn=True, target=1000),
    "small_target": dict(use_random_grid=True, exact_knn=False, target=300),
    "cropbox_outliers": dict(use_random_grid=True, exact_knn=False, target=1000,
                             enable_cropbox=True, enable_outlier_removal=True),
    "voxelgrid": dict(use_random_grid=False, exact_knn=True, target=1000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_device_matches_jax(scan, case):
    raw, packed, meta = scan
    c = dict(CASES[case])
    target = c.pop("target")
    meta = meta.copy()
    meta[2] = target
    out_cap = 1024 if target > 512 else 512
    kw = dict(out_cap=out_cap, k=10, enable_cropbox=False, enable_outlier_removal=False,
              outlier_k=10, knn_window=64)
    kw.update(c)
    consts = dict(near=0.5, far=100.0, resolution=0.5,
                  bbox_T=np.eye(4, dtype=np.float32),
                  bbox_min=np.array([-3, -3, -2], np.float32),
                  bbox_max=np.array([3, 3, 2], np.float32), outlier_std_mul=1.0)
    consts = {k: np.asarray(v, np.float32) for k, v in consts.items()}
    pt_scale = np.float32(0.005)

    key = jax.random.PRNGKey(5)
    used = jax.random.split(key)[0]
    prio = np.asarray(jax.random.uniform(used, (packed.shape[0],)))
    prio2 = np.asarray(jax.random.uniform(jax.random.fold_in(used, 1), (packed.shape[0],)))

    out_j = j_pre._preprocess_device(jnp.asarray(packed), jnp.asarray(meta),
                                     jnp.asarray(pt_scale), key, **kw,
                                     **{k: jnp.asarray(v) for k, v in consts.items()})
    out_t = t_pre._preprocess_device(torch.from_numpy(packed), torch.from_numpy(meta),
                                     torch.from_numpy(np.asarray(pt_scale)),
                                     torch.from_numpy(prio), torch.from_numpy(prio2), **kw,
                                     **{k: torch.from_numpy(v) for k, v in consts.items()})
    pts_j, times_j, mask_j, nbr_j = (np.asarray(a) for a in out_j[:4])
    pts_t, times_t, mask_t, nbr_t = (a.numpy() for a in out_t)
    np.testing.assert_array_equal(mask_t, mask_j)
    if case == "voxelgrid":
        # Voxel centroids are f32 segment sums taken in another order; the
        # centroid time is its nearest raw point's, which may flip between
        # near-equidistant raw points and so reorder the time sort. Compare
        # order-free: every centroid has a twin within 1e-5 m whose
        # neighbour distances agree at atol 1e-4.
        P_t, P_j = pts_t[mask_t], pts_j[mask_j]
        D = np.linalg.norm(P_t[:, None] - P_j[None], axis=-1)
        twin = D.argmin(1)
        assert D.min(1).max() < 1e-5
        assert len(np.unique(twin)) == len(twin)
        dist = lambda p, n: np.linalg.norm(p[n] - p[:, None], axis=-1)
        np.testing.assert_allclose(dist(pts_t, nbr_t)[mask_t],
                                   dist(pts_j, nbr_j)[mask_j][twin], atol=1e-4)
    else:
        np.testing.assert_array_equal(nbr_t, nbr_j)
        np.testing.assert_array_equal(pts_t, pts_j)
        np.testing.assert_array_equal(times_t, times_j)
    assert mask_t.sum() > 0.5 * min(target, 1000) or case == "cropbox_outliers"


def test_cloud_preprocessor_frame():
    """The front-end on the CPU: shapes, capacity class, time order and kNN
    self-match; the per-scan draws come from its own torch.Generator, so
    two preprocessors with one seed agree exactly."""
    seq = generate_sequence(duration=0.2, n_scan_points=2500, scene_points=15000, seed=3)
    raw = TRawPoints(stamp=seq.scans[1].stamp, points=seq.scans[1].points,
                     times=seq.scans[1].times)
    params = t_pre.CloudPreprocessorParams(random_downsample_target=800,
                                           downsample_resolution=0.5)
    f1 = t_pre.CloudPreprocessor(params, seed=4, device="cpu").preprocess(raw)
    f2 = t_pre.CloudPreprocessor(params, seed=4, device="cpu").preprocess(raw)
    assert f1.device_points.shape == (1024, 3) and f1.device_neighbors.shape == (1024, 10)
    assert 500 < f1.size <= 800
    m = f1.device_mask.numpy()
    assert np.all(np.diff(f1.times[m]) >= 0)
    assert (f1.neighbors[m, 0] == np.arange(1024)[m]).mean() > 0.95
    assert torch.equal(f1.device_points, f2.device_points)
    assert f1.scan_end_time == pytest.approx(raw.stamp + float(np.max(raw.times)))
