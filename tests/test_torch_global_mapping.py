"""The port's matching-cost GlobalMapping against the JAX package's on
identical numpy submaps: the chain cases of tests/test_global_mapping.py
(implicit-loop factors, drift correction, recover_graph,
find_overlapping_submaps, the indeterminate-system recovery), the batched
correspondence refresh of tests/test_global_batched_lookup.py with and
without deferred optimization, and a 16-submap drifting ring.

Both back-ends must build the same ``matching_factors`` list and land on
poses within 1e-3 (m and rad). Every overlap the port scores must lie more
than 1e-3 from the threshold it is compared with, so that the two
packages' f32 roundings cannot decide a factor differently. The ring's
post-closure ATE must be within 1.1 x JAX's + 2 mm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.mapping import global_mapping as j_gm
from glim_tpu.ops import lie_np
from glim_tpu.types import PointBatch as JPointBatch
from glim_tpu.types import SubMap as JSubMap
from glim_tpu_torch.mapping import global_mapping as t_gm
from glim_tpu_torch.types import PointBatch as TPointBatch
from glim_tpu_torch.types import SubMap as TSubMap

POSE_TOL = 1e-3
OVERLAP_MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def structured_world(rng, n=1200):
    """Walls + floor (registration-friendly structure)."""
    pts = np.zeros((n, 3))
    k = n // 3
    pts[:k, 0] = rng.uniform(-15, 15, k)
    pts[:k, 1] = rng.uniform(-15, 15, k)
    pts[k:2 * k, 0] = rng.uniform(-15, 15, k)
    pts[k:2 * k, 2] = rng.uniform(0, 5, k)
    pts[k:2 * k, 1] = 15.0
    pts[2 * k:, 1] = rng.uniform(-15, 15, n - 2 * k)
    pts[2 * k:, 2] = rng.uniform(0, 5, n - 2 * k)
    pts[2 * k:, 0] = 15.0
    return pts


def _chain(seed=42, n_submaps=4, step=2.0, drift_xi=None, cap=2048):
    """(clouds [(pts, mask, covs)], true poses, odometry poses) of a chain of
    submaps observing one structured world."""
    rng = np.random.default_rng(seed)
    world = structured_world(rng)
    true = []
    for k in range(n_submaps):
        T = np.eye(4)
        T[0, 3] = step * k
        true.append(T)
    drift = lie_np.se3_exp(np.zeros(6) if drift_xi is None else drift_xi)
    odom = [true[0]]
    for k in range(1, n_submaps):
        odom.append(odom[-1] @ np.linalg.inv(true[k - 1]) @ true[k] @ drift)
    clouds = []
    for T in true:
        Ti = np.linalg.inv(T)
        local = (Ti[:3, :3] @ world.T).T + Ti[:3, 3]
        pts = np.zeros((cap, 3), np.float32)
        pts[:len(local)] = local + rng.normal(size=local.shape) * 0.005
        mask = np.zeros(cap, bool)
        mask[:len(local)] = True
        covs = np.broadcast_to(np.eye(3, dtype=np.float32) * 0.02, (cap, 3, 3)).copy()
        clouds.append((pts, mask, covs))
    return clouds, true, odom


class _Pair:
    """One JAX and one port GlobalMapping fed the same submaps; the port's
    overlap scores are recorded with the thresholds they meet."""

    def __init__(self, defer=False, **params):
        self.j = j_gm.GlobalMapping(j_gm.GlobalMappingParams(**params))
        self.t = t_gm.GlobalMapping(t_gm.GlobalMappingParams(**params), device="cpu")
        self.j.defer_optimization = self.t.defer_optimization = defer
        self.overlaps = []
        batch = self.t._batch_overlaps
        self.t._batch_overlaps = lambda pairs: self._record(batch(pairs))

    def _record(self, ovs):
        self.overlaps.extend(float(v) for v in ovs)
        return ovs

    def insert(self, k, pts, mask, covs, T_odom):
        self.j.insert_submap(JSubMap(id=k, T_world_origin=np.array(T_odom), frame=JPointBatch(
            points=jnp.asarray(pts), mask=jnp.asarray(mask),
            covs=None if covs is None else jnp.asarray(covs))))
        self.t.insert_submap(TSubMap(id=k, T_world_origin=np.array(T_odom), frame=TPointBatch(
            points=torch.from_numpy(pts), mask=torch.from_numpy(mask),
            covs=None if covs is None else torch.from_numpy(covs))))

    def both(self, fn):
        fn(self.j)
        fn(self.t)

    def check(self, thresholds):
        assert self.t.matching_factors == self.j.matching_factors
        assert [f[:2] for f in self.t.between_factors] == [f[:2] for f in self.j.between_factors]
        for a, b in zip(self.t.poses, self.j.poses):
            np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=POSE_TOL)
            assert np.abs(lie_np.so3_log(a[:3, :3].T @ b[:3, :3])).max() < POSE_TOL
        for ov in self.overlaps:
            for thr in thresholds:
                assert abs(ov - thr) > OVERLAP_MARGIN, (ov, thr)


CHAIN = dict(submap_voxel_resolution=0.5, voxel_capacity=16384, min_implicit_loop_overlap=0.2)


def _build(n_submaps=4, drift_xi=None, **kw):
    clouds, true, odom = _chain(n_submaps=n_submaps, drift_xi=drift_xi)
    pair = _Pair(**CHAIN, **kw)
    for k, (pts, mask, covs) in enumerate(clouds):
        pair.insert(k, pts, mask, covs, odom[k])
    return pair, true, odom


def test_implicit_loop_factors_match_jax():
    pair, _, _ = _build(n_submaps=3)
    assert len(pair.t.matching_factors) >= 3
    pair.check([0.2])


def test_drift_corrected_matches_jax():
    pair, true, odom = _build(drift_xi=np.array([0, 0, 0.005, 0.08, 0.05, 0.0]))
    pair.check([0.2])
    err_odom = np.linalg.norm(odom[-1][:3, 3] - true[-1][:3, 3])
    err_opt = np.linalg.norm(pair.t.poses[-1][:3, 3] - true[-1][:3, 3])
    assert err_opt < err_odom * 0.5, (err_odom, err_opt)
    # The corrected poses are the submaps' T_world_origin.
    np.testing.assert_array_equal(pair.t.submaps[-1].T_world_origin, pair.t.poses[-1])


def test_recover_graph_matches_jax():
    pair, _, _ = _build(n_submaps=3, enable_optimization=False)

    def orphan_and_recover(gm):
        gm.matching_factors = [f for f in gm.matching_factors if 2 not in f]
        gm.between_factors = [f for f in gm.between_factors if f[1] != 2]
        gm.recover_graph()
    pair.both(orphan_and_recover)
    assert any(2 in f for f in pair.t.matching_factors)
    pair.check([0.2])

    def break_and_recover(gm):
        gm.poses[1] = np.full((4, 4), np.nan)
        gm.recover_graph()
    pair.both(break_and_recover)
    np.testing.assert_allclose(pair.t.poses[1], pair.t.poses[0] @ np.linalg.inv(
        pair.t.odom_poses[0]) @ pair.t.odom_poses[1], atol=1e-9)
    pair.both(lambda gm: gm.optimize())
    pair.check([0.2])


def test_find_overlapping_submaps_matches_jax():
    pair, _, _ = _build(n_submaps=3, enable_optimization=False)
    before = len(pair.t.matching_factors)

    def find(gm):
        gm.matching_factors = []
        gm.find_overlapping_submaps(0.2)
    pair.both(find)
    assert len(pair.t.matching_factors) >= before
    pair.check([0.2])


def test_indeterminant_recovery_matches_jax(monkeypatch):
    """A first solve with a non-finite pose: both back-ends damp exactly the
    flagged pose, re-solve, and clear the damping."""
    clouds, _, odom = _chain(n_submaps=3, drift_xi=np.array([0, 0, 0.003, 0.05, 0, 0]))
    pair = _Pair(**CHAIN, enable_optimization=False)
    for k, (pts, mask, covs) in enumerate(clouds):
        pair.insert(k, pts, mask, covs, odom[k])
    damped = {"jax": [], "torch": []}
    for name, mod, nan in (("jax", j_gm, lambda a: a.at[1].set(jnp.nan)),
                           ("torch", t_gm, lambda a: a.index_fill(0, torch.tensor([1]),
                                                                  float("nan")))):
        real = mod.global_gn
        calls = {"n": 0}

        def flaky(*args, real=real, calls=calls, nan=nan, name=name, **kw):
            calls["n"] += 1
            T, junc, err, md = real(*args, **kw)
            if calls["n"] == 1:
                T, md = nan(T), nan(md)
            else:
                damped[name].append(np.asarray(kw["damping"]).copy())
            return T, junc, err, md
        monkeypatch.setattr(mod, "global_gn", flaky)
    pair.both(lambda gm: gm.optimize())
    assert len(damped["torch"]) >= 1 and len(damped["jax"]) >= 1
    np.testing.assert_array_equal(damped["torch"][0], damped["jax"][0])
    assert damped["torch"][0][1] == 1e6 and damped["torch"][0][0] == 0.0
    assert pair.t.recovery_damping == {} and pair.j.recovery_damping == {}
    assert all(np.all(np.isfinite(T)) for T in pair.t.poses)
    pair.check([0.2])


def test_external_constraints_match_jax():
    """A translation prior, an explicit between factor and an explicit
    matching pair added to a chain without in-line optimization: the same
    graph and, after one optimize, the same poses as the JAX back-end."""
    pair, true, _ = _build(n_submaps=3, drift_xi=np.array([0, 0, 0.004, 0.06, 0.03, 0.0]),
                           enable_optimization=False)
    assert pair.t.needs_optimize() and pair.j.needs_optimize()

    def constrain(gm):
        gm.matching_factors = [f for f in gm.matching_factors if f != (0, 2)]
        gm.add_matching_factor(2, 0)
        gm.add_matching_factor(0, 1)                  # already there: no-op
        gm.add_translation_prior(2, true[2][:3, 3] + [0.01, 0.0, 0.0], 50.0)
        gm.add_between_factor(0, 1, np.linalg.inv(true[0]) @ true[1], 1e4)
        with pytest.raises(IndexError):
            gm.add_between_factor(0, 7, np.eye(4))
        gm.optimize()
    pair.both(constrain)
    assert (2, 0) in pair.t.matching_factors and len(pair.t.translation_priors) == 1
    assert not pair.t.needs_optimize()
    pair.check([0.2])
    np.testing.assert_allclose(pair.t.poses[2][:3, 3], true[2][:3, 3] + [0.01, 0, 0], atol=0.02)


@pytest.mark.parametrize("defer", [False, True])
def test_batched_refresh_consistency_matches_jax(defer):
    """A drifting chain with the batched refresh: the same factors and poses
    as the JAX back-end, and the match stack written row by row equals a
    stack rebuilt from scratch at the same poses, bitwise."""
    from glim_tpu.ops.lie_np import se3_exp as se3_exp_np

    rng = np.random.default_rng(11)
    world = rng.normal(0, 4.0, (4096, 3)).astype(np.float32)
    pair = _Pair(defer=defer, enable_imu=False, submap_voxel_resolution=0.4,
                 voxel_capacity=8192, min_implicit_loop_overlap=0.1,
                 max_implicit_loop_distance=50.0, optimization_interval_submaps=3)
    T_true = []
    drift = se3_exp_np(np.array([0, 0, 1e-3, 6e-3, 0, 0]))
    cur = np.eye(4)
    for k in range(6):
        T = np.eye(4)
        T[:3, 3] = [k * 1.2, 0.3 * np.sin(k), 0]
        T_true.append(T)
        cur = cur @ (np.linalg.inv(T_true[k - 1]) @ T if k else T) @ (drift if k else np.eye(4))
        local = (np.linalg.inv(T)[:3, :3] @ world.T).T + np.linalg.inv(T)[:3, 3]
        keep = np.linalg.norm(local, axis=1) < 6.0
        pts = np.zeros((1024, 3), np.float32)
        sel = np.where(keep)[0][:1024]
        pts[:len(sel)] = local[sel] + rng.normal(0, 0.004, (len(sel), 3))
        mask = np.zeros(1024, bool)
        mask[:len(sel)] = True
        pair.insert(k, pts, mask, None, cur.copy())

    def finish(gm):
        gm.defer_optimization = False
        gm.optimize()
    pair.both(finish)
    pair.check([0.1])

    gm = pair.t
    shove = se3_exp_np(np.array([0, 0, 0, 1.0, 0, 0]))
    for p in list(gm._f_cache):
        gm._f_cache[p]["T_rel"] = gm._f_cache[p]["T_rel"] @ shove
    assert gm._refresh_stale_factors() == len(gm.matching_factors)
    gm._padded_args()
    st = gm._match_stack
    fast = [st[k].clone() for k in ("f_mu", "f_ct", "f_hit")]
    gm._match_stack = None
    rebuilt = gm._match_stacks(st["Fp"], st["L"], int(gm._m_pts[0].shape[0]))
    for a, b in zip(fast, rebuilt):
        assert torch.equal(a, b)
    errs = [np.linalg.norm(gm.poses[k][:3, 3] - T_true[k][:3, 3]) for k in range(6)]
    assert np.sqrt(np.mean(np.square(errs))) < 0.05


def test_pending_rows_stay_bounded_without_optimization():
    """With optimization off, the searched rows that wait for the match
    stack are drained into it once PENDING_BATCHES batches wait (the JAX
    back-end keeps one more batch per insert until an optimize); the stack
    then holds what a rebuild gives."""
    clouds, _, odom = _chain(n_submaps=12, step=1.0)
    gm = t_gm.GlobalMapping(t_gm.GlobalMappingParams(**CHAIN, enable_optimization=False),
                            device="cpu")
    for k, (pts, mask, covs) in enumerate(clouds):
        gm.insert_submap(TSubMap(id=k, T_world_origin=odom[k].copy(), frame=TPointBatch(
            points=torch.from_numpy(pts), mask=torch.from_numpy(mask),
            covs=torch.from_numpy(covs))))
        assert len(gm._pending_rows) <= t_gm.PENDING_BATCHES
    assert len(gm.matching_factors) >= 30 and gm._match_stack is not None
    gm._match_stacks(gm._match_stack["Fp"], gm._match_stack["L"], int(gm._m_pts[0].shape[0]))
    st = gm._match_stack
    n = len(gm.matching_factors) * st["L"]
    live = [st[k][:n].clone() for k in ("f_mu", "f_ct", "f_hit")]
    gm._match_stack, gm._pending_rows = None, []
    rebuilt = gm._match_stacks(st["Fp"], st["L"], int(gm._m_pts[0].shape[0]))
    for a, b in zip(live, rebuilt):
        assert torch.equal(a, b[:n])


def test_save_and_load_name_io_dump(tmp_path):
    """save / load go through io/dump.py: the chain's back-end saved by the
    port loads into a fresh back-end of either package with the saved
    poses and the same factor list."""
    pair, _, _ = _build()
    pair.t.save(str(tmp_path / "dump"))
    assert (tmp_path / "dump" / "graph.npz").exists() and (tmp_path / "dump" / "000003").is_dir()
    t_fresh = t_gm.GlobalMapping(t_gm.GlobalMappingParams(**CHAIN), device="cpu")
    j_fresh = j_gm.GlobalMapping(j_gm.GlobalMappingParams(**CHAIN))
    for gm in (t_fresh, j_fresh):
        gm.load(str(tmp_path / "dump"))
        assert gm.matching_factors == pair.t.matching_factors
        for a, b in zip(gm.poses, pair.t.poses):
            np.testing.assert_array_equal(a, b)


def test_ring_16_matches_jax(monkeypatch):
    """The JAX stress tool's drifting ring at 16 submaps (seed 5, 2048-point
    submaps without covariances, voxel_capacity 16384, two levels) through
    both back-ends: the same numpy ring, the same factor list, and a
    post-closure ATE within 1.1 x JAX's + 2 mm."""
    from glim_tpu.tools import backend_stress as j_stress
    from glim_tpu_torch.tools import backend_stress as t_stress

    made = []
    real_init = j_gm.GlobalMapping.__init__

    def keep(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(self)
    monkeypatch.setattr(j_gm.GlobalMapping, "__init__", keep)
    rows_j = j_stress.run(16, 4)
    rows_t, gm_t = t_stress.run(16, 4, device="cpu", quiet=True)
    gm_j = made[-1]
    assert rows_t[-1]["ate_pre_closure_m"] == rows_j[-1]["ate_pre_closure_m"]
    assert gm_t.matching_factors == gm_j.matching_factors
    assert rows_t[-1]["factors"] == rows_j[-1]["factors"]
    post_t, post_j = rows_t[-1]["ate_post_closure_m"], rows_j[-1]["ate_post_closure_m"]
    assert post_t <= 1.1 * post_j + 0.002, (post_t, post_j)
    assert post_t < 0.5 * rows_t[-1]["ate_pre_closure_m"]
    for a, b in zip(gm_t.poses, gm_j.poses):
        np.testing.assert_allclose(a[:3, 3], b[:3, 3], atol=POSE_TOL)


def test_chip_smoke_ring_rehearsal_on_cpu():
    """chip_smoke.py's phase 5c at 16 submaps on the CPU: the ring's
    pre-closure ATE is the JAX tool's at this size (0.026917 m, the numpy
    ring being the same), loop closure brings it under the phase's bound,
    and every checkpoint row carries its timings."""
    import chip_smoke

    res = chip_smoke.run_ring("cpu", 16)
    chip_smoke.check_ring(res, pre_ate=0.026917)
    assert res["factors"] >= 16 and res["ate_post_closure_m"] < 0.1 * res["ate_pre_closure_m"]
    row = res["rows"][-1]
    assert row["submaps"] == 16 and row["optimize_mean_ms"] > 0 and row["insert_mean_ms"] > 0
