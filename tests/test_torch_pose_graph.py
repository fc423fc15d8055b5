"""The port's pose-graph back-end (``mapping/global_mapping_pose_graph.py``)
against the JAX package's.

- The host float64 pieces are the same numpy code: the Gauss-Newton system
  (to 1e-9), the analytic Jacobians against central differences (the twin
  of tests/test_loop_detection.py), the 64-pose drifted ring with two loop
  factors (final poses to 1e-9) and the candidate lists (equal).
- The whole back-end, fed the same numpy-made ring of 24 submaps of 512
  points (the stress tool's generator; no detection thread, so candidates
  are evaluated in insertion order), accepts the same loop pairs with loop
  measurements Z within 1e-4 m / 1e-5 rad (f32 registrations on either
  side) and final poses within 1e-3 m; once with the global-registration
  retry off, once on with the JAX RANSAC draws injected. Both take the JAX
  package's covariances and normals (hazard C18: the pillars' covariances
  have a near-zero eigengap).
- No swallowed failures: an exception inside a candidate evaluation on the
  detection thread re-raises from ``wait_for_detection`` and ``stop``; in
  the retry only ``torch.linalg.LinAlgError`` is caught.
- ``save`` writes the JAX back-end's dump byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dump import _check_same_files, _jax_submap, _port_submap, _submap_data
from torch_parity import use_jax_covariances

import glim_tpu.mapping.global_mapping_pose_graph as jpg
from glim_tpu.ops import lie_np
from glim_tpu.types import PointBatch as JPointBatch
from glim_tpu.types import SubMap as JSubMap
from glim_tpu.utils.config import GlobalConfig as JConfig
import glim_tpu_torch.mapping.global_mapping_pose_graph as tpg
from glim_tpu_torch.ops import registration as t_reg
from glim_tpu_torch.tools import backend_stress
from glim_tpu_torch.types import PointBatch as TPointBatch
from glim_tpu_torch.types import SubMap as TSubMap
from glim_tpu_torch.utils.config import GlobalConfig as TConfig
from glim_tpu_torch.utils.lifecycle import WorkerFailed

RING_N, RING_CAP = 24, 512


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    JConfig.reset()
    TConfig.reset()
    yield
    from glim_tpu_torch.utils import lifecycle
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


def _random_graph(rng, n=10):
    poses = [lie_np.se3_exp(rng.normal(0, [0.3, 0.3, 0.3, 4, 4, 1])) for _ in range(n)]
    f = dict(i=[], j=[], Z=[], si=[], hub=[])
    for i, j, big in [(k, k + 1, False) for k in range(n - 1)] + [(0, n - 1, False),
                                                                   (2, 7, True), (1, 5, False)]:
        Z = np.linalg.inv(poses[i]) @ poses[j] @ lie_np.se3_exp(rng.normal(0, 0.05, 6))
        if big:       # past 1 rad of residual rotation: the central-difference rows
            Z = Z @ lie_np.se3_exp(np.array([0.0, 1.4, 0.3, 0.5, 0.0, 0.0]))
        f["i"].append(i)
        f["j"].append(j)
        f["Z"].append(Z)
        f["si"].append(float(rng.uniform(5, 50)))
        f["hub"].append(-1.0 if i + 1 == j else 1.0)
    return poses, f


def test_host_linearize_graph_matches_jax():
    poses, f = _random_graph(np.random.default_rng(0))
    args = (poses, f["i"], f["j"], f["Z"], f["si"], f["hub"], 1e6)
    H_t, b_t, e_t = tpg._host_linearize_graph(*args)
    H_j, b_j, e_j = jpg._host_linearize_graph(*args)
    np.testing.assert_allclose(H_t, H_j, rtol=0, atol=1e-9 * np.abs(H_j).max())
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=1e-9 * np.abs(b_j).max())
    assert abs(e_t - e_j) <= 1e-9 * abs(e_j)


def test_analytic_jacobians_match_central_differences():
    rng = np.random.default_rng(1)
    checked = 0
    for _ in range(6):
        Ti = lie_np.se3_exp(rng.normal(0, 0.4, 6))
        Tj = lie_np.se3_exp(rng.normal(0, 0.4, 6))
        Z = lie_np.se3_exp(rng.normal(0, 0.2, 6))
        si = 37.0
        rel = np.linalg.inv(Ti) @ Tj
        r0 = si * lie_np.se3_log(np.linalg.inv(Z) @ rel)
        if np.linalg.norm(r0[:3] / si) > 0.9:
            continue          # the analytic path defers to central differences there
        Jr_inv = tpg._se3_jr_inv(r0 / si)
        Ja = np.concatenate([-si * (Jr_inv @ tpg._se3_adjoint(np.linalg.inv(rel))),
                             si * Jr_inv], axis=1)
        eps = 1e-6
        Jn = np.zeros((6, 12))

        def res(xi_i, xi_j):
            A = Ti @ lie_np.se3_exp(xi_i)
            Bp = Tj @ lie_np.se3_exp(xi_j)
            return si * lie_np.se3_log(np.linalg.inv(Z) @ np.linalg.inv(A) @ Bp)

        for k in range(6):
            d = np.zeros(6)
            d[k] = eps
            Jn[:, k] = (res(d, np.zeros(6)) - res(-d, np.zeros(6))) / (2 * eps)
            Jn[:, 6 + k] = (res(np.zeros(6), d) - res(np.zeros(6), -d)) / (2 * eps)
        assert np.abs(Ja - Jn).max() / max(np.abs(Jn).max(), 1.0) < 5e-3
        checked += 1
    assert checked >= 3


def _drifted_ring(gm, submap_cls, n=64, radius=40.0):
    drift = lie_np.se3_exp(np.array([0, 0, 4e-4, 5e-3, 0, 0]))
    T_true, prev, cur = [], None, np.eye(4)
    for k in range(n):
        T = backend_stress._ring_pose(k, n, radius)
        T_true.append(T)
        cur = T if prev is None else cur @ np.linalg.inv(prev) @ T @ drift
        prev = T
        gm.poses.append(cur.copy())
        gm.odom_poses.append(cur.copy())
        gm.submaps.append(submap_cls(id=k, T_world_origin=cur.copy(), frame=None))
        if k:
            gm._add_factor(k - 1, k, np.linalg.inv(gm.odom_poses[k - 1]) @ gm.odom_poses[k],
                           1.0 / 0.01, -1.0)
    for a in (0, 1):
        gm._add_factor(a, n - 1, np.linalg.inv(T_true[a]) @ T_true[n - 1], 1.0 / 0.01, 1.0)
    return T_true


def test_drifted_ring_closes_to_the_jax_poses():
    kw = dict(enable_detection_thread=False, enable_optimization=False)
    gm_t = tpg.GlobalMappingPoseGraph(tpg.GlobalMappingPoseGraphParams(**kw), device="cpu")
    gm_j = jpg.GlobalMappingPoseGraph(jpg.GlobalMappingPoseGraphParams(**kw))
    T_true = _drifted_ring(gm_t, TSubMap)
    _drifted_ring(gm_j, JSubMap)
    ate = lambda gm: np.sqrt(np.mean([np.sum((gm.poses[k][:2, 3] - T_true[k][:2, 3]) ** 2)
                                      for k in range(len(T_true))]))
    pre = ate(gm_t)
    assert not gm_t.needs_optimize()          # enable_optimization is false
    gm_t.optimize()
    gm_j.optimize()
    assert pre > 0.5 and ate(gm_t) < 0.5 * pre, (pre, ate(gm_t))
    np.testing.assert_allclose(np.stack(gm_t.poses), np.stack(gm_j.poses), rtol=0, atol=1e-9)
    for sm, T in zip(gm_t.submaps, gm_t.poses):
        np.testing.assert_array_equal(sm.T_world_origin, T)


def test_candidate_lists_match_jax():
    """Both back-ends' candidate generation over one drifted ring, with a
    looped pair to skip and a short buffer to trim."""
    rng = np.random.default_rng(3)
    kw = dict(enable_detection_thread=False, max_neighbor_dist=8.0, min_travel_dist=30.0,
              loop_candidate_buffer_size=6)
    gm_t = tpg.GlobalMappingPoseGraph(tpg.GlobalMappingPoseGraphParams(**kw), device="cpu")
    gm_j = jpg.GlobalMappingPoseGraph(jpg.GlobalMappingPoseGraphParams(**kw))
    poses = [backend_stress._ring_pose(k, 40, 30.0) @ lie_np.se3_exp(rng.normal(0, 0.05, 6))
             for k in range(46)]
    travel = np.cumsum([0.0] + [np.linalg.norm(b[:3, 3] - a[:3, 3])
                                for a, b in zip(poses, poses[1:])]).tolist()
    total = 0
    for gm in (gm_t, gm_j):
        gm.poses, gm.travel_dist = poses, travel
        gm._looped_pairs = {(1, 41)}
    for i in range(len(poses)):
        gm_t._find_loop_candidates(i)
        gm_j._find_loop_candidates(i)
        assert [(a, b) for a, b, _ in gm_t.candidates] == [(a, b) for a, b, _ in gm_j.candidates]
        for (_, _, Ta), (_, _, Tb) in zip(gm_t.candidates, gm_j.candidates):
            np.testing.assert_array_equal(Ta, Tb)
        total += len(gm_t.candidates)
        gm_t.candidates, gm_j.candidates = gm_t.candidates[:2], gm_j.candidates[:2]
    assert total > 10


def _ring_data():
    """The stress tool's ring cut to RING_N submaps of RING_CAP points: per
    submap (points, mask, drifted odometry pose), and the true poses."""
    rng = np.random.default_rng(5)
    radius = RING_N * 6.0 / (2 * np.pi)
    world = backend_stress.ring_world(rng, radius, max(RING_N // 2, 8))
    drift = lie_np.se3_exp(np.array([0, 0, 2e-4, 3e-3, 0, 0.6e-3]))
    out, T_prev, T_odom = [], None, np.eye(4)
    for k in range(RING_N):
        T_true = backend_stress._ring_pose(k, RING_N, radius)
        T_odom = T_true if T_prev is None else T_odom @ np.linalg.inv(T_prev) @ T_true @ drift
        T_prev = T_true
        sm = backend_stress.make_submap(rng, k, world, T_true, "cpu", cap=RING_CAP)
        out.append((sm.frame.points.numpy(), sm.frame.mask.numpy(), T_odom.copy()))
    return out


def _ring_params(cls, retry):
    return cls(vgicp_voxel_resolution=1.0, voxel_capacity=4096, subsample_target=2048,
               max_neighbor_dist=12.0, min_travel_dist=40.0, loop_candidate_eval_per_insert=4,
               enable_detection_thread=False,
               global_registration_min_inliers=0.8 if retry else 0.0)


def _run_ring(retry):
    data = _ring_data()
    gm_t = tpg.GlobalMappingPoseGraph(_ring_params(tpg.GlobalMappingPoseGraphParams, retry),
                                      device="cpu")
    gm_j = jpg.GlobalMappingPoseGraph(_ring_params(jpg.GlobalMappingPoseGraphParams, retry))
    for k, (pts, mask, T_odom) in enumerate(data):
        gm_t.insert_submap(TSubMap(id=k, T_world_origin=T_odom.copy(), frame=TPointBatch(
            points=torch.from_numpy(pts.copy()), mask=torch.from_numpy(mask.copy()),
            covs=None)))
        gm_j.insert_submap(JSubMap(id=k, T_world_origin=T_odom.copy(),
                                   frame=JPointBatch(points=jnp.asarray(pts),
                                                     mask=jnp.asarray(mask), covs=None)))
    return gm_t, gm_j


def _check_same_loops(gm_t, gm_j):
    assert gm_t.num_loops == gm_j.num_loops >= 1
    assert (gm_t.f_i, gm_t.f_j) == (gm_j.f_i, gm_j.f_j)
    assert gm_t._looped_pairs == gm_j._looped_pairs
    for Zt, Zj, hub in zip(gm_t.f_Z, gm_j.f_Z, gm_t.f_huber):
        if hub > 0:                                  # a loop factor
            d = lie_np.se3_log(np.linalg.inv(Zj) @ Zt)
            assert np.linalg.norm(d[3:]) < 1e-4 and np.linalg.norm(d[:3]) < 1e-5, d
    np.testing.assert_allclose(np.stack(gm_t.poses)[:, :3, 3], np.stack(gm_j.poses)[:, :3, 3],
                               rtol=0, atol=1e-3)


def test_ring_accepts_the_jax_loops(monkeypatch):
    use_jax_covariances(monkeypatch)
    gm_t, gm_j = _run_ring(retry=False)
    _check_same_loops(gm_t, gm_j)
    assert gm_t.global_registrations == 0 and gm_t.registrations >= gm_t.num_loops


def test_ring_with_the_global_registration_retry(monkeypatch):
    """The retry's RANSAC takes the draws JAX makes for the same mutual
    correspondences (jax.random.choice with the same key)."""
    use_jax_covariances(monkeypatch)

    def jax_draws(valid, n_hypotheses, seed):
        v = valid.numpy()
        p = v.astype(np.float32) / max(v.sum(), 1)
        return torch.from_numpy(np.asarray(jax.random.choice(
            jax.random.PRNGKey(seed), len(v), (n_hypotheses, 3), p=jnp.asarray(p))))

    monkeypatch.setattr(t_reg, "draw_triplets", jax_draws)
    gm_t, gm_j = _run_ring(retry=True)
    _check_same_loops(gm_t, gm_j)
    assert gm_t.global_registrations >= 1


def _small_graph(**kw):
    rng = np.random.default_rng(9)
    gm = tpg.GlobalMappingPoseGraph(tpg.GlobalMappingPoseGraphParams(**kw), device="cpu")
    for k in range(3):
        gm.insert_submap(_port_submap(_submap_data(rng, k)))
    return gm


def test_detection_thread_failure_reraises(monkeypatch):
    gm = _small_graph(enable_detection_thread=True)

    def broken(*args):
        raise RuntimeError("nn_search kernel launch failed")
    monkeypatch.setattr(gm, "_evaluate_candidate", broken)
    gm.add_loop_candidate(0, 2)
    with pytest.raises(WorkerFailed) as err:
        gm.wait_for_detection(60.0)
    assert isinstance(err.value.__cause__, RuntimeError)
    with pytest.raises(WorkerFailed):
        gm.optimize()
    with pytest.raises(WorkerFailed):
        gm.stop()
    assert gm.detector is None
    gm.stop()                                        # stopped once; nothing left to raise


def test_global_registration_retry_catches_only_linalg_errors(monkeypatch):
    gm = _small_graph(enable_detection_thread=False, global_registration_min_inliers=1.0)

    def degenerate(*args):
        raise torch.linalg.LinAlgError("svd: the algorithm failed to converge")
    monkeypatch.setattr(gm, "_global_reg_init", degenerate)
    gm._evaluate_candidate(0, 1, np.eye(4))          # no retry, the evaluation goes on
    assert gm.global_registrations == 0 and gm.registrations == 1

    def launch_failed(*args):
        raise RuntimeError("nn_search kernel launch failed")
    monkeypatch.setattr(gm, "_global_reg_init", launch_failed)
    with pytest.raises(RuntimeError, match="launch failed"):
        gm._evaluate_candidate(0, 1, np.eye(4))


def test_save_matches_the_jax_dump(tmp_path):
    """The same submaps, odometry factors, one manual between factor and
    the optimize (the same float64 numpy code): the same dump bytes."""
    rng = np.random.default_rng(7)
    data = [_submap_data(rng, k) for k in range(3)]
    kw = dict(enable_detection_thread=False)
    gm_t = tpg.GlobalMappingPoseGraph(tpg.GlobalMappingPoseGraphParams(**kw), device="cpu")
    gm_j = jpg.GlobalMappingPoseGraph(jpg.GlobalMappingPoseGraphParams(**kw))
    Z = lie_np.se3_exp(np.array([0.01, 0.0, 0.1, 1.0, 0.5, 0.0]))
    for gm, make in ((gm_t, _port_submap), (gm_j, _jax_submap)):
        gm.loop_search_enabled = False
        for d in data:
            gm.insert_submap(make(d))
        gm.add_between_factor(0, 2, Z, np.eye(6) * 400.0)
        gm.optimize()
    np.testing.assert_array_equal(np.stack(gm_t.poses), np.stack(gm_j.poses))
    assert gm_t.num_loops == 1 and gm_t.f_info[-1].shape == (6,)
    gm_j.save(str(tmp_path / "jax"))
    gm_t.save(str(tmp_path / "torch"))
    _check_same_files(str(tmp_path / "jax"), str(tmp_path / "torch"))
    pts = gm_t.export_points()
    np.testing.assert_allclose(pts, gm_j.export_points(), atol=1e-4)
    assert len(pts) == sum(len(d["points"]) for d in data)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ring_on_cuda_accepts_the_jax_loops(monkeypatch, cuda):
    """The ring's back-end on the card (registrations and inlier fractions
    through the CUDA kernel, one launch an attempt) against JAX on its
    CPU, at the CPU test's tolerances."""
    from glim_tpu_torch.ops.nn_search import nn_search

    use_jax_covariances(monkeypatch)
    data = _ring_data()
    gm_t = tpg.GlobalMappingPoseGraph(_ring_params(tpg.GlobalMappingPoseGraphParams, False),
                                      device=cuda)
    gm_j = jpg.GlobalMappingPoseGraph(_ring_params(jpg.GlobalMappingPoseGraphParams, False))
    n0 = nn_search.kernel_launches
    for k, (pts, mask, T_odom) in enumerate(data):
        gm_t.insert_submap(TSubMap(id=k, T_world_origin=T_odom.copy(), frame=TPointBatch(
            points=torch.from_numpy(pts.copy()).to(cuda),
            mask=torch.from_numpy(mask.copy()).to(cuda), covs=None)))
        gm_j.insert_submap(JSubMap(id=k, T_world_origin=T_odom.copy(),
                                   frame=JPointBatch(points=jnp.asarray(pts),
                                                     mask=jnp.asarray(mask), covs=None)))
    assert nn_search.kernel_launches - n0 == gm_t.nn_search_calls() == gm_t.registrations
    _check_same_loops(gm_t, gm_j)
