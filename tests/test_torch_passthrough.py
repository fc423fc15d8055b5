"""The port's pass-through sub-mapping (``sub_mapping_passthrough``) and its
``pointops.random_sampling`` against the JAX package's.

Both packages get the same estimation frames, built from numpy with a seed:
host poses that translate by multiples of the 0.2 m sub-voxel (with a few
frames that do not move, which the keyframe gate skips) and points within
0.04 m of sub-voxel centres, so f32 rounding cannot move a point into
another sub-voxel; each frame carries covariances. The port's sampling
priorities are the JAX module's draws (its key 11, split per submap),
injected. The submaps must agree: count, keyframe and frame ids, origins
and end points at 1e-4, the same valid points, points at 1e-4 and
covariances at 1e-4 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import scaled

from glim_tpu import types as jt
from glim_tpu.mapping.sub_mapping_passthrough import SubMappingPassthrough as JPass
from glim_tpu.mapping.sub_mapping_passthrough import SubMappingPassthroughParams as JParams
from glim_tpu.ops import pointops as j_pointops
from glim_tpu_torch import types as tt
from glim_tpu_torch.mapping.sub_mapping_passthrough import SubMappingPassthrough as TPass
from glim_tpu_torch.mapping.sub_mapping_passthrough import \
    SubMappingPassthroughParams as TParams
from glim_tpu_torch.ops import pointops as t_pointops

C = 640
SUBVOXEL = 0.2
# Frame translations along x in sub-voxels: repeats are skipped keyframes.
STEPS = [0, 2, 2, 4, 6, 8, 8, 10, 12, 14, 16, 16, 18, 20, 22, 24, 26]


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def test_random_sampling_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    mask = rng.uniform(size=1000) > 0.3
    key = jax.random.PRNGKey(5)
    for target in (300, 5000):
        out_j = j_pointops.random_sampling(jnp.asarray(pts), jnp.asarray(mask), target, key)
        prio = torch.as_tensor(np.asarray(jax.random.uniform(key, (1000,))))
        out_t = t_pointops.random_sampling(torch.as_tensor(pts), torch.as_tensor(mask),
                                           target, prio)
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(out_t[1].sum()) == min(int(mask.sum()), target)


def _frame_data(seed=0):
    rng = np.random.default_rng(seed)
    frames = []
    for i, k in enumerate(STEPS):
        T = np.eye(4)
        T[0, 3] = k * SUBVOXEL
        cells = rng.integers(-12, 12, size=(C, 3))
        pts = ((cells + 0.5) * SUBVOXEL + rng.uniform(-0.04, 0.04, size=(C, 3)))
        A = rng.normal(size=(C, 3, 3)) * 0.05
        covs = A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(3)
        mask = rng.uniform(size=C) > 0.1
        frames.append(dict(id=i, stamp=0.1 * i, T=T, pts=pts.astype(np.float32),
                           covs=covs.astype(np.float32), mask=mask))
    return frames


def _frame(pkg, d):
    arr = (lambda a: jnp.asarray(a)) if pkg is jt else (lambda a: torch.as_tensor(a))
    return pkg.EstimationFrame(id=d["id"], stamp=d["stamp"], T_world_lidar=d["T"].copy(),
                               frame=pkg.PointBatch(points=arr(d["pts"]), mask=arr(d["mask"]),
                                                    covs=arr(d["covs"])))


def _params(cls):
    return cls(max_num_keyframes=4, submap_target_num_points=1500, point_capacity=8192)


def _jax_draws():
    """The JAX module's sampling priorities, in order: its key 11, split
    once per submap."""
    state = {"key": jax.random.PRNGKey(11)}

    def draw(n):
        state["key"], sub = jax.random.split(state["key"])
        return torch.as_tensor(np.asarray(jax.random.uniform(sub, (n,))))
    return draw


def _run(sub, pkg, frames):
    out = []
    for d in frames:
        sub.insert_frame(_frame(pkg, d))
        out += sub.get_submaps()
    return out + sub.submit_end_of_sequence()


def test_passthrough_matches_jax():
    frames = _frame_data()
    subs_j = _run(JPass(_params(JParams)), jt, frames)
    t_sub = TPass(_params(TParams), device="cpu")
    t_sub._priorities = _jax_draws()
    subs_t = _run(t_sub, tt, frames)
    assert len(subs_t) == len(subs_j) >= 3
    for a, b in zip(subs_t, subs_j):
        assert a.id == b.id
        assert [f.id for f in a.frames] == [f.id for f in b.frames]
        assert [f.id for f in a.odom_frames] == [f.id for f in b.odom_frames]
        for k in ("T_world_origin", "T_origin_endpoint_L", "T_origin_endpoint_R"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k), atol=1e-4, err_msg=k)
        np.testing.assert_allclose(a.custom_data["T_world_origin_pre"], b.T_world_origin,
                                   atol=1e-4)
        mask = np.asarray(b.frame.mask)
        np.testing.assert_array_equal(a.frame.mask.numpy(), mask)
        assert 0 < int(mask.sum()) <= 1500
        np.testing.assert_allclose(a.frame.points.numpy()[mask],
                                   np.asarray(b.frame.points)[mask], atol=1e-4)
        scaled(a.frame.covs.numpy()[mask], np.asarray(b.frame.covs)[mask])
    # Every frame is in a submap; the repeated poses are not keyframes.
    assert sum(len(s.odom_frames) for s in subs_t) == len(frames)
    assert sum(len(s.frames) for s in subs_t) == len(set(STEPS))


def test_covariance_less_frames_leave_covs_to_global_mapping():
    frames = _frame_data(1)[:3]
    t_sub = TPass(_params(TParams), device="cpu")
    for d in frames:
        f = _frame(tt, d)
        f.frame.covs = None
        t_sub.insert_frame(f)
    (sm,) = t_sub.submit_end_of_sequence()
    assert sm.frame.covs is None and int(sm.frame.mask.sum()) > 0


def test_registry_and_shipped_config():
    from glim_tpu_torch.utils.config import Config
    from glim_tpu_torch.utils.default_config import DEFAULT_CONFIGS
    from glim_tpu_torch.utils.registry import load_module

    cfg = Config(DEFAULT_CONFIGS["config_sub_mapping_passthrough.json"])
    sub = load_module("sub_mapping", "libsub_mapping_passthrough.so", cfg, device="cpu")
    assert isinstance(sub, TPass)
    assert vars(sub.params) == vars(JParams.from_config(cfg))
