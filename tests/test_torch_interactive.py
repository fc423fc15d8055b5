"""The port's interactive correction tools (glim_tpu_torch/viewer/
interactive_tools.py, interactive_viewer.py) and ``ops/solver.lm_optimize``
against the JAX package's on the same seeded numpy inputs.

Tolerances: ``lm_optimize`` on a small GICP problem takes the same accepted
/ rejected sequence and lands within 1e-4; ``ManualLoopClose.align`` from a
given initial pose (both searches the JAX k=1 search, both covariances the
JAX package's: near-tied neighbours and near-zero eigengaps are the
packages' rounding, not the tool) to 1e-4 rad / 1e-4 m, its inlier
fraction to 1e-4 and its information to 1e-3 of its largest entry;
``BundleAdjustment.optimize`` to 1e-4. The runtime loop-search toggle
(repair F2) gives the JAX back-end's factors."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from glim_tpu.ops import lie_np
from glim_tpu.types import PointBatch as JPB
from glim_tpu.types import SubMap as JSM
from glim_tpu_torch.types import PointBatch as TPB
from glim_tpu_torch.types import SubMap as TSM
from glim_tpu_torch.utils.callbacks import CallbackSlot

from torch_parity import use_jax_covariances, use_jax_nn_search


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils import lifecycle
    lifecycle.stop_all()
    CallbackSlot.clear_all()


def _scene(rng, n=900):
    """Floor, two walls and four pillars (well-conditioned for GICP)."""
    k = n // 4
    floor = np.c_[rng.uniform(-12, 12, (k, 2)), np.zeros(k)]
    w1 = np.c_[rng.uniform(-12, 12, k), np.full(k, 8.0), rng.uniform(0, 4, k)]
    w2 = np.c_[np.full(k, -9.0), rng.uniform(-12, 12, k), rng.uniform(0, 4, k)]
    m = n - 3 * k
    ang = rng.uniform(0, 2 * np.pi, m)
    ctr = rng.uniform(-6, 6, (4, 2))[rng.integers(0, 4, m)]
    pil = np.c_[ctr + 0.3 * np.c_[np.cos(ang), np.sin(ang)], rng.uniform(0, 3, m)]
    return np.concatenate([floor, w1, w2, pil])


def _view(rng, world, T, cap=1024):
    Ti = np.linalg.inv(T)
    local = world @ Ti[:3, :3].T + Ti[:3, 3] + rng.normal(0, 0.005, world.shape)
    pts = np.zeros((cap, 3), np.float32)
    pts[:len(local)] = local
    mask = np.zeros(cap, bool)
    mask[:len(local)] = True
    return pts, mask


def _pair(seed=2):
    rng = np.random.default_rng(seed)
    world = _scene(rng)
    T_t = lie_np.se3_exp(np.array([0.0, 0.0, 0.1, 0.5, -0.3, 0.0]))
    T_s = lie_np.se3_exp(np.array([0.01, -0.01, 0.35, 2.0, 1.0, 0.1]))
    return _view(rng, world, T_t), _view(rng, world, T_s), np.linalg.inv(T_t) @ T_s


def test_lm_optimize_matches_jax(monkeypatch):
    """One GICP pose problem through both packages' lm_optimize from 0.3 m
    / 0.05 rad off: the same accepted / rejected sequence, the same x."""
    from glim_tpu.ops import covariance as j_cov
    from glim_tpu.ops import gicp as j_gicp
    from glim_tpu.ops import knn as j_knn
    from glim_tpu.ops import lie as j_lie
    from glim_tpu.ops import solver as j_solver
    from glim_tpu_torch.ops import gicp as t_gicp
    from glim_tpu_torch.ops import lie as t_lie
    from glim_tpu_torch.ops import solver as t_solver

    use_jax_nn_search(monkeypatch, t_gicp)
    (tp, tm), (sp, sm), T_ts = _pair()
    covs = []
    for p, m in ((tp, tm), (sp, sm)):
        nbr, _ = j_knn.knn_self(jnp.asarray(p), jnp.asarray(m), 10)
        covs.append(np.asarray(j_cov.estimate_covariances(jnp.asarray(p), jnp.asarray(m), nbr,
                                                          "plane")[0]))
    T0 = T_ts @ lie_np.se3_exp(np.array([0.03, -0.02, 0.05, 0.3, -0.2, 0.1]))
    crit = dict(max_iterations=12)

    def j_lin(T):
        s = j_gicp.gicp_linearize(jnp.eye(4), T, jnp.asarray(sp), jnp.asarray(covs[1]),
                                  jnp.asarray(sm), jnp.asarray(tp), jnp.asarray(covs[0]),
                                  jnp.asarray(tm), jnp.float32(2.0))
        return s.H_ss, s.b_s, s.error

    def t_lin(T):
        s = t_gicp.gicp_linearize(torch.eye(4), T, torch.from_numpy(sp),
                                  torch.from_numpy(covs[1]), torch.from_numpy(sm),
                                  torch.from_numpy(tp), torch.from_numpy(covs[0]),
                                  torch.from_numpy(tm), 2.0)
        return s.H_ss, s.b_s, s.error

    rj = j_solver.lm_optimize(j_lin, lambda T, d: T @ j_lie.se3_exp(d),
                              jnp.asarray(T0, jnp.float32), j_solver.TerminationCriteria(**crit))
    seen = []
    rt = t_solver.lm_optimize(t_lin, lambda T, d: T @ t_lie.se3_exp(d),
                              torch.from_numpy(T0.astype(np.float32)),
                              t_solver.TerminationCriteria(**crit), callback=seen.append)
    assert [s.accepted for s in rt.statuses] == [s.accepted for s in rj.statuses]
    assert len(rt.statuses) >= 3 and seen == rt.statuses
    assert (rt.iterations, rt.converged) == (rj.iterations, rj.converged)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-4)
    assert abs(rt.error - rj.error) <= 1e-4 * max(rj.error, 1.0)
    assert np.abs(lie_np.se3_log(np.linalg.inv(T_ts) @ rt.x.numpy().astype(np.float64))
                  ).max() < 0.02


def test_lm_optimize_stiff_quadratic():
    """The device's equilibrated damped solve reaches the minimum of a
    quadratic whose curvatures differ by 1e8."""
    from glim_tpu_torch.ops import solver as t_solver

    A = torch.tensor([[1e6, 0.0], [0.0, 1e-2]])
    target = torch.tensor([0.3, -2.0])

    def lin(x):
        r = x - target
        return A, A @ r, r @ A @ r

    res = t_solver.lm_optimize(lin, lambda x, d: x + d, torch.zeros(2),
                               t_solver.TerminationCriteria(max_iterations=20))
    np.testing.assert_allclose(res.x.numpy(), target.numpy(), atol=1e-4)
    assert res.converged and res.statuses[0].accepted


def test_manual_loop_close_align_matches_jax(monkeypatch):
    from glim_tpu.viewer.interactive_tools import ManualLoopClose as JMLC
    from glim_tpu_torch.ops import gicp as t_gicp
    from glim_tpu_torch.viewer.interactive_tools import ManualLoopClose as TMLC

    use_jax_nn_search(monkeypatch, t_gicp)
    use_jax_covariances(monkeypatch)
    (tp, tm), (sp, sm), T_ts = _pair()
    T_init = T_ts @ lie_np.se3_exp(np.array([0.01, 0.02, -0.04, 0.4, 0.2, -0.1]))
    rj = JMLC().align(JSM(id=0, frame=JPB(points=jnp.asarray(tp), mask=jnp.asarray(tm))),
                      JSM(id=1, frame=JPB(points=jnp.asarray(sp), mask=jnp.asarray(sm))),
                      T_init=T_init)
    rt = TMLC().align(TSM(id=0, frame=TPB(points=torch.from_numpy(tp), mask=torch.from_numpy(tm))),
                      TSM(id=1, frame=TPB(points=torch.from_numpy(sp), mask=torch.from_numpy(sm))),
                      T_init=T_init)
    d = lie_np.se3_log(np.linalg.inv(rj.T_target_source) @ rt.T_target_source)
    assert np.abs(d[:3]).max() < 1e-4 and np.abs(d[3:]).max() < 1e-4
    assert abs(rt.inlier_fraction - rj.inlier_fraction) < 1e-4 and rt.inlier_fraction > 0.9
    scale = np.abs(rj.information).max()
    assert np.abs(rt.information - rj.information).max() < 1e-3 * scale
    assert len(rt.lm_trial_steps) == 3
    assert np.abs(lie_np.se3_log(np.linalg.inv(T_ts) @ rt.T_target_source)).max() < 0.02


def _warped_plane(seed=8, n_sub=4, z_step=0.08, cap=768):
    """The JAX test's warped plane: n_sub submaps along x seeing one ground
    plane (and pillars outside the pick), recorded with growing z error.
    Returns [(points, mask, T_bad)]."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_sub):
        T_true = np.eye(4)
        T_true[0, 3] = 2.0 * k
        gxy = rng.uniform(-3, 3, (500, 2)) + [2.0 * k, 0]
        ground = np.concatenate([gxy, np.zeros((500, 1))], axis=1)
        pillar = np.stack([np.full(100, 2.0 * k + 1.0) + rng.normal(0, 0.03, 100),
                           np.full(100, 4.5) + rng.normal(0, 0.03, 100),
                           rng.uniform(0, 2, 100)], axis=1)
        world = np.concatenate([ground, pillar])
        Ti = np.linalg.inv(T_true)
        local = world @ Ti[:3, :3].T + Ti[:3, 3]
        pts = np.zeros((cap, 3), np.float32)
        pts[:len(local)] = local + rng.normal(0, 0.004, local.shape)
        mask = np.zeros(cap, bool)
        mask[:len(local)] = True
        T_bad = T_true.copy()
        T_bad[2, 3] = z_step * k
        out.append((pts, mask, T_bad))
    return out


def _ba_groups(mode, seed=8, n_sub=4, n=25):
    """Selections that fix every submap's pose relative to the first:
    "plane": the floor and two walls of a corner, one group a plane;
    "point": three small blobs, one group a blob. Each of n_sub submaps
    (1.5 m apart) sees every group; the recorded poses carry errors in all
    six degrees of freedom. Returns (groups per package, recorded poses)."""
    from glim_tpu.viewer.interactive_tools import PlaneSelection as JSel
    from glim_tpu_torch.viewer.interactive_tools import PlaneSelection as TSel

    rng = np.random.default_rng(seed)
    if mode == "plane":
        shapes = [lambda: np.c_[rng.uniform(-2, 6, (n, 2)), np.zeros(n)],
                  lambda: np.c_[np.full(n, 7.0), rng.uniform(-3, 3, n), rng.uniform(0, 3, n)],
                  lambda: np.c_[rng.uniform(-2, 6, n), np.full(n, 3.5), rng.uniform(0, 3, n)]]
    else:
        shapes = [lambda c=c: np.asarray(c) + rng.normal(0, 0.02, (n, 3))
                  for c in ((1.0, 2.0, 0.5), (5.0, -2.0, 1.5), (3.0, 1.0, 2.5))]
    poses, groups_j, groups_t = [], [[] for _ in shapes], [[] for _ in shapes]
    for k in range(n_sub):
        T_true = np.eye(4)
        T_true[0, 3] = 1.5 * k
        err = np.zeros(6) if k == 0 else rng.normal(0, [0.01, 0.01, 0.02, 0.05, 0.05, 0.05])
        poses.append(T_true @ lie_np.se3_exp(err))
        Ti = np.linalg.inv(T_true)
        for g, shape in enumerate(shapes):
            p = (shape() @ Ti[:3, :3].T + Ti[:3, 3] + rng.normal(0, 0.003, (n, 3)))
            p = p.astype(np.float32)
            groups_j[g].append(JSel(submap_index=k, points=p))
            groups_t[g].append(TSel(submap_index=k, points=p))
    return groups_j, groups_t, poses


@pytest.mark.parametrize("mode", ["plane", "point"])
def test_bundle_adjustment_matches_jax(mode):
    from glim_tpu.viewer.interactive_tools import BundleAdjustment as JBA
    from glim_tpu_torch.viewer.interactive_tools import BundleAdjustment as TBA

    groups_j, groups_t, poses = _ba_groups(mode)
    out_j = JBA().optimize([None] * 4, poses, groups_j, mode=mode)
    out_t = TBA().optimize([None] * 4, poses, groups_t, mode=mode, device="cpu")
    for a, b in zip(out_t, out_j):
        d = lie_np.se3_log(np.linalg.inv(b) @ a)
        assert np.abs(d).max() < 1e-4, d
    moved = lie_np.se3_log(np.linalg.inv(poses[3]) @ out_t[3])
    assert np.abs(moved).max() > 1e-2                        # the errors were corrected


def _global_pair(**params):
    from glim_tpu.mapping.global_mapping import GlobalMapping as JGM
    from glim_tpu.mapping.global_mapping import GlobalMappingParams as JP
    from glim_tpu_torch.mapping.global_mapping import GlobalMapping as TGM
    from glim_tpu_torch.mapping.global_mapping import GlobalMappingParams as TP
    return JGM(JP(**params)), TGM(TP(**params), device="cpu")


def _insert_both(pair, sid, pts, mask, T):
    j, t = pair
    j.insert_submap(JSM(id=sid, T_world_origin=np.array(T),
                        frame=JPB(points=jnp.asarray(pts), mask=jnp.asarray(mask))))
    t.insert_submap(TSM(id=sid, T_world_origin=np.array(T),
                        frame=TPB(points=torch.from_numpy(pts), mask=torch.from_numpy(mask))))


def test_loop_search_disabled_only_chains_odometry():
    """Repair F2, the port's counterpart of the JAX test of the same name:
    with loop search off, a submap landing on an old one gets only its
    odometry-neighbour factor, in both back-ends; back on, the revisit is
    linked."""
    from glim_tpu.tools.backend_stress import make_submap, ring_world

    rng = np.random.default_rng(9)
    radius = 10 * 6.0 / (2 * np.pi)
    world = ring_world(rng, radius, 10)

    def pose(k):
        ang = 2 * np.pi * k / 10
        T = np.eye(4)
        T[:2, 3] = radius * np.cos(ang), radius * np.sin(ang)
        yaw = ang + np.pi / 2
        T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        return T

    pair = _global_pair(enable_optimization=False, submap_voxel_resolution=0.5,
                        voxel_capacity=16384, max_implicit_loop_distance=1e9,
                        min_implicit_loop_overlap=0.01, enable_imu=False)
    for gm in pair:
        gm.loop_search_enabled = False
    for k in (0, 1, 0, 0):
        if k == 0 and len(pair[0].submaps) == 3:
            for gm in pair:
                gm.loop_search_enabled = True
        sm = make_submap(rng, len(pair[0].submaps), world, pose(k))
        _insert_both(pair, sm.id, np.asarray(sm.frame.points), np.asarray(sm.frame.mask),
                     sm.T_world_origin)
        if len(pair[0].submaps) == 3:
            assert pair[1].matching_factors == pair[0].matching_factors == [(0, 1), (1, 2)]
    assert pair[1].matching_factors == pair[0].matching_factors
    assert any(abs(t - s) > 1 for t, s in pair[1].matching_factors)


def _ring_viewer(tmp_path=None, live=False, lock=None):
    """A drifted 6-submap chain around the JAX stress ring, loop search off
    (only a manual closure can fix it), in the port's back-end."""
    from glim_tpu_torch.mapping.global_mapping import GlobalMapping, GlobalMappingParams
    from glim_tpu_torch.tools.backend_stress import make_submap, ring_world
    from glim_tpu_torch.viewer.interactive_viewer import InteractiveViewer

    rng = np.random.default_rng(3)
    n, radius = 6, 6 * 6.0 / (2 * np.pi)
    world = ring_world(rng, radius, 8)
    gm = GlobalMapping(GlobalMappingParams(enable_optimization=False, submap_voxel_resolution=0.5,
                                           voxel_capacity=8192, max_implicit_loop_distance=0.0,
                                           enable_imu=False), device="cpu")
    drift = lie_np.se3_exp(np.array([0, 0, 4e-3, 0.09, 0, 0]))
    T_prev, T_odom = None, np.eye(4)
    for k in range(n):
        ang = 2 * np.pi * k / n
        T = np.eye(4)
        T[:2, 3] = radius * np.cos(ang), radius * np.sin(ang)
        yaw = ang + np.pi / 2
        T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        T_odom = T if T_prev is None else T_odom @ np.linalg.inv(T_prev) @ T @ drift
        T_prev = T
        sm = make_submap(rng, k, world, T, "cpu", cap=1024)
        sm.T_world_origin = T_odom
        gm.insert_submap(sm)
    return InteractiveViewer(gm, live=live, lock=lock)


def test_commands_offline_and_input_errors(tmp_path):
    """execute_command offline: list / factors / status / set_enabled, a
    loop closure applied and re-optimized, save and ply; a bad submap index
    and malformed commands come back as error dicts (C22)."""
    from glim_tpu_torch.viewer.interactive_viewer import InteractiveViewer, execute_command

    viewer = _ring_viewer()
    gm = viewer.gm
    out = execute_command(viewer, {"cmd": "list"})
    assert out["ok"] and len(out["submaps"]) == 6 and out["submaps"][0]["points"] > 100
    assert execute_command(viewer, {"cmd": "status"}) == dict(
        ok=True, live=False, submaps=6, global_optimization=False, loop_detection=True)
    out = execute_command(viewer, {"cmd": "set_enabled", "target": "loop_detection",
                                   "value": False})
    assert out["ok"] and out["previous"] is True and gm.loop_search_enabled is False
    out = execute_command(viewer, {"cmd": "set_enabled", "target": "global_optimization",
                                   "value": True})
    assert out["ok"] and gm.params.enable_optimization is True
    gap0 = np.linalg.norm((np.linalg.inv(gm.poses[0]) @ gm.poses[5])[:3, 3])
    out = execute_command(viewer, {"cmd": "loop_close", "target": 4, "source": 5})
    assert out["ok"] and out["inlier_fraction"] > 0.5
    assert (4, 5) in [f[:2] for f in gm.between_factors]
    assert execute_command(viewer, {"cmd": "factors"})["between"] == len(gm.between_factors)
    assert np.isfinite(gap0)
    for bad in ({"cmd": "loop_close", "target": 0, "source": 99},
                {"cmd": "loop_close", "target": "x", "source": 1},
                {"cmd": "bundle_adjust", "radius": 1.0},
                {"cmd": "set_enabled", "target": "nope"}, {"cmd": "nonsense"}):
        out = execute_command(viewer, bad)
        assert out["ok"] is False and out["error"], bad
    assert "IndexError" in execute_command(
        viewer, {"cmd": "loop_close", "target": 0, "source": 99})["error"]
    assert execute_command(viewer, {"cmd": "save", "path": str(tmp_path / "d")})["ok"]
    assert execute_command(viewer, {"cmd": "ply", "path": str(tmp_path / "m.ply")})["ok"]
    again = InteractiveViewer.open(str(tmp_path / "d"), device="cpu")
    assert len(again.gm.submaps) == 6 and len(again.gm.between_factors) == len(gm.between_factors)


def test_execute_command_reraises_non_input_errors(monkeypatch):
    """C22: a RuntimeError inside align (a failed kernel build or launch
    raises one) is not turned into an error dict."""
    from glim_tpu_torch.viewer import interactive_tools
    from glim_tpu_torch.viewer.interactive_viewer import execute_command

    viewer = _ring_viewer()

    def broken(self, *a, **k):
        raise RuntimeError("nn_search: CUDA launch failed")
    monkeypatch.setattr(interactive_tools.ManualLoopClose, "align", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        execute_command(viewer, {"cmd": "loop_close", "target": 0, "source": 1})


def test_bundle_adjust_command_flattens_a_warped_plane():
    from glim_tpu_torch.mapping.global_mapping import GlobalMapping, GlobalMappingParams
    from glim_tpu_torch.viewer.interactive_viewer import InteractiveViewer, execute_command

    gm = GlobalMapping(GlobalMappingParams(enable_optimization=False, enable_imu=False,
                                           submap_voxel_resolution=0.5, voxel_capacity=8192,
                                           max_implicit_loop_distance=0.0), device="cpu")
    for k, (pts, mask, T) in enumerate(_warped_plane()):
        gm.insert_submap(TSM(id=k, T_world_origin=T, frame=TPB(points=torch.from_numpy(pts),
                                                               mask=torch.from_numpy(mask))))
    viewer = InteractiveViewer(gm)
    out = execute_command(viewer, {"cmd": "bundle_adjust", "center": [3.0, 0.0, 0.1],
                                   "radius": 4.0, "mode": "plane"})
    assert out["ok"] and out["factors_added"] >= 2, out
    assert out["thickness_after_m"] < 0.5 * out["thickness_before_m"]
    out = execute_command(viewer, {"cmd": "bundle_adjust", "center": [100.0, 0.0, 0.0],
                                   "radius": 1.0})
    assert not out["ok"]


def test_live_loop_close_through_the_request_slot():
    """C23: live, the submaps and poses are read under the async wrapper's
    mutex and the factor reaches the graph only through
    request_to_add_between, on the global worker."""
    import time

    from glim_tpu_torch.mapping.async_global_mapping import AsyncGlobalMapping
    from glim_tpu_torch.viewer.interactive_viewer import execute_command

    viewer = _ring_viewer(live=True)
    gm = viewer.gm
    wrapper = AsyncGlobalMapping(gm, optimization_interval=1e9)
    viewer.lock = wrapper._mutex
    n0 = len(gm.between_factors)
    try:
        with wrapper._mutex:            # the worker holds the graph: nothing lands yet
            pass
        out = execute_command(viewer, {"cmd": "loop_close", "target": 4, "source": 5})
        assert out["ok"]
        t0 = time.time()
        while len(gm.between_factors) == n0 and time.time() - t0 < 30:
            time.sleep(0.02)
        assert [f[:2] for f in gm.between_factors[n0:]] == [(4, 5)]
        np.testing.assert_allclose(gm.between_factors[-1][2], out["T_target_source"])
    finally:
        wrapper.join()


@pytest.mark.gpu
def test_align_on_the_card_launch_count():
    """ManualLoopClose.align on the card at a small size: nn_search launched
    exactly sum over the LM passes of (1 + trial steps) + 2 times, and the
    result within 1e-4 of the same align on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.viewer.interactive_tools import ManualLoopClose

    (tp, tm), (sp, sm), T_ts = _pair()
    T_init = T_ts @ lie_np.se3_exp(np.array([0.01, 0.02, -0.04, 0.4, 0.2, -0.1]))

    def sub(p, m, dev):
        return TSM(id=0, frame=TPB(points=torch.from_numpy(p).to(dev),
                                   mask=torch.from_numpy(m).to(dev)))

    nn_search.kernel_launches = 0
    rc = ManualLoopClose().align(sub(tp, tm, "cuda"), sub(sp, sm, "cuda"), T_init=T_init)
    launches = nn_search.kernel_launches
    assert launches == sum(1 + s for s in rc.lm_trial_steps) + 2
    rh = ManualLoopClose().align(sub(tp, tm, "cpu"), sub(sp, sm, "cpu"), T_init=T_init)
    d = lie_np.se3_log(np.linalg.inv(rh.T_target_source) @ rc.T_target_source)
    assert np.abs(d).max() < 1e-4 and abs(rc.inlier_fraction - rh.inlier_fraction) < 1e-3
