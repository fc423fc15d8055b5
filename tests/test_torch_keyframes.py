"""The port's KeyframeManager against the JAX package's, for each keyframe
strategy (OVERLAP, DISPLACEMENT, ENTROPY).

Both managers get the same sequence: per frame the status scalars the
odometry step would report (overlap, displacement, matching entropy) and,
when the strategy inserts, the same keyframe (lidar-frame points and
covariances with the pose they were taken at). The clouds are views of one
scene from poses with an identity rotation and integer translations, so the
world transform is exact in both packages and the voxel keys must agree;
one pose lies far off the others, so the overlap eviction's first phase has
something to drop. Midway the rebuild resolutions change, as the adaptive
resolution changes them. Compared: every insertion decision, ``h_order``,
the evicted insertion orders, the store, and the model levels (keys and
counts exactly, means and covariances at 1e-5 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import np_state

from glim_tpu.odometry.keyframe_manager import KeyframeManager as JKeyframeManager
from glim_tpu.ops import voxelmap as j_vmx
from glim_tpu_torch import state as t_state
from glim_tpu_torch.odometry.keyframe_manager import KeyframeManager as TKeyframeManager
from glim_tpu_torch.ops import voxelmap as t_vmx

C = 640
CAPS = [4096, 2048]
RES = [0.5, 1.0]


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()



def _frames(n=14, seed=0):
    """(status scalars, pts_l, covs_l, mask, T) per frame."""
    rng = np.random.default_rng(seed)
    scene = rng.uniform(-6, 6, size=(1200, 3)).astype(np.float32)
    A = rng.normal(size=(C, 3, 3)).astype(np.float32) * 0.1
    covs = (A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3, dtype=np.float32)).astype(np.float32)
    out = []
    for i in range(n):
        t = np.array([i % 5, (i // 5) % 2, 0], np.float32)
        if i == 7:
            t = np.array([90.0, 0.0, 0.0], np.float32)          # far off the rest
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = t
        pick = rng.choice(len(scene), C, replace=False)
        pts_l = (scene[pick] - t + rng.normal(size=(C, 3)).astype(np.float32) * 0.02)
        mask = np.arange(C) < int(rng.integers(C // 2, C))
        status = (float(rng.uniform(0.3, 0.9)), float(rng.uniform(0.0, 3.0)),
                  float(rng.uniform(0.0, 0.8)), float(rng.uniform(-40.0, -20.0)))
        out.append((status, pts_l.astype(np.float32), covs, mask, T))
    return out


def _managers(strategy, device):
    kw = dict(strategy=strategy, max_num_keyframes=3, min_overlap=0.01, max_overlap=0.7,
              delta_trans=1.0, delta_rot=0.5, entropy_thresh=0.99, C=C,
              model_capacities=CAPS, model_resolutions=RES, mini_capacity=2048)
    jm, tm = JKeyframeManager(**kw), TKeyframeManager(**kw, device=device)
    ev_j, ev_t = [], []
    jm.marginalized_callback = ev_j.append
    tm.marginalized_callback = ev_t.append
    model_j = tuple(j_vmx.empty_gaussian_voxelmap(c, r) for c, r in zip(CAPS, RES))
    model_t = tuple(t_vmx.empty_gaussian_voxelmap(c, r, device=device)
                    for c, r in zip(CAPS, RES))
    return jm, tm, ev_j, ev_t, model_j, model_t


def _assert_maps_equal(vm_t, vm_j):
    a, b = t_state.gaussian_voxelmap_to_numpy(vm_t), np_state(vm_j)
    for k in ("hash", "coords", "count", "age", "resolution"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["mean"], b["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a["cov"], b["cov"], rtol=1e-5, atol=1e-7)


def _check(strategy, device):
    dev = lambda a: torch.from_numpy(a).to(device)
    jm, tm, ev_j, ev_t, model_j, model_t = _managers(strategy, device)
    inserts = 0
    for i, (status, pts, covs, mask, T) in enumerate(_frames()):
        if i == 6:      # adaptive resolution: new rebuild resolutions
            jm.set_model_resolutions([jnp.float32(0.6), jnp.float32(1.2)])
            tm.set_model_resolutions([torch.full((), 0.6, device=device),
                                      torch.full((), 1.2, device=device)])
        dj, dt = jm.should_insert(*status), tm.should_insert(*status)
        assert dj == dt, i
        if not dj:
            continue
        inserts += 1
        model_j = jm.insert(jnp.asarray(pts), jnp.asarray(covs), jnp.asarray(mask),
                            jnp.asarray(T), jnp.asarray(T), T.astype(np.float64), model_j, i)
        model_t = tm.insert(dev(pts), dev(covs), dev(mask), dev(T), dev(T),
                            T.astype(np.float64), model_t, i)
        np.testing.assert_array_equal(tm.h_order, jm.h_order, err_msg=f"frame {i}")
        assert ev_t == ev_j, i
        np.testing.assert_array_equal(tm.last_kf_T_wi.cpu().numpy(), np.asarray(jm.last_kf_T_wi))
    evicted = [o for e in ev_j for o in e]
    assert inserts >= 6 and len(evicted) >= 2, (inserts, ev_j)
    if strategy == "OVERLAP":
        assert 7 in evicted                     # the far keyframe, by the first phase
    assert tm.count == jm.count <= 3
    a, b = t_state.keyframe_store_to_numpy(tm.store), np_state(jm.store)
    for k in ("mask", "T", "order"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["pts"], b["pts"], rtol=1e-6, atol=1e-6)
    for vm_t, vm_j in zip(model_t, model_j):
        _assert_maps_equal(vm_t, vm_j)
    assert abs(float(model_t[0].resolution) - 0.6) < 1e-6      # rebuilt at the new scale


@pytest.mark.parametrize("strategy", ["OVERLAP", "DISPLACEMENT", "ENTROPY"])
def test_keyframe_manager_matches_jax(strategy):
    _check(strategy, "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_keyframe_manager_on_cuda(cuda):
    """The overlap strategy (batched stacked lookups, rebuilds) with the
    store and maps on the card, against JAX on the CPU."""
    _check("OVERLAP", cuda)
