"""The port's continuous-time odometry (``odometry_estimation_ct``) against the
benchmark's plain reference of its scan step (``benchmark/reference/ct_step.py``,
plain torch, the same file the ``ct.circle`` cell runs on the card), on the
CPU at a small size: a 2,048-point skewed scan of a seeded planar room against
an 8,192-point model of it, from random begin and end poses and twist.

Compared: ``_ct_linearize`` and the priors' blocks on the same
correspondences, and one whole ``_ct_scan_step`` with the ``ivox`` model and
the flags of the frozen ``benchmark/configs/ct.json``. Two faults planted in
the port (the constant-velocity prior dropped; one correspondence search
where there are four) each fail the step's tolerances. Also the map lag's
five stages under the CT preset (the port stamps ``estimate`` and
``marginalized`` on its frames).
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import glim_config  # noqa: E402
from benchmark.reference import ct_step as ref  # noqa: E402
from glim_tpu_torch.odometry import odometry_estimation_ct as tct  # noqa: E402
from glim_tpu_torch.utils.config import Config  # noqa: E402

N_SCAN, N_MODEL, K = 2048, 8192, 10
STEP = 57                   # past the bootstrap scans: the update budget applies
# Poses: the two implementations agree to 1e-7-1e-6 m on this scene (float32
# sums in another order, the covariances from another eigensolver); a
# correspondence that flips between them (a point at the edge of a nearest
# neighbour's cell, the kernel's distance expansion against exact
# differences) moves the solve by ~4e-5 m. The faults move the poses by
# 2.5e-3 m and more, the rotations by 0.015 deg and more.
POSE_ATOL_M = 2e-4
ROT_ATOL_DEG = 2e-3
TWIST_ATOL = 2 * POSE_ATOL_M / 0.1    # two poses' difference over dt


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def ct_params():
    """The frozen preset's odometry parameters (benchmark/configs/ct.json)."""
    with open(os.path.join(ROOT, "benchmark", "configs", "ct.json")) as f:
        tree = json.load(f)["glim"]
    fname = tree["config.json"]["global"]["config_odometry"]
    return tct.OdometryEstimationCTParams.from_config(Config(tree[fname]))


def _room(rng, n):
    """n points on the floor, ceiling and four walls of a 12 x 8 x 3 m room,
    with their plane covariances (eigenvalues 1e-3, 1, 1)."""
    faces = [(2, 0.0), (2, 3.0), (0, -6.0), (0, 6.0), (1, -4.0), (1, 4.0)]
    area = np.array([96, 96, 24, 24, 36, 36], np.float64)
    which = rng.choice(6, size=n, p=area / area.sum())
    lo, hi = np.array([-6.0, -4.0, 0.0]), np.array([6.0, 4.0, 3.0])
    pts = rng.uniform(lo, hi, size=(n, 3))
    normals = np.zeros((n, 3))
    for f, (axis, value) in enumerate(faces):
        sel = which == f
        pts[sel, axis] = value
        normals[sel, axis] = 1.0
    covs = np.eye(3)[None] - (1 - 1e-3) * normals[:, :, None] * normals[:, None, :]
    return pts.astype(np.float32), covs.astype(np.float32)


def _se3(xi):
    return ref.se3_exp(torch.as_tensor(xi, dtype=torch.float32))


def make_case(seed=11):
    """The step's inputs: a previous end pose and twist, a model of the room
    (7,800 of its 8,192 entries valid, ages over the last 40 steps), and a
    scan taken while the sensor moved from a true begin pose (near the
    previous end) to a true end pose (the twist, changed)."""
    rng = np.random.default_rng(seed)
    T_prev = _se3(np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.5, 3)])
    twist_prev = torch.as_tensor(np.r_[rng.normal(0, 0.3, 3), rng.normal(0, 2.0, 3)],
                                 dtype=torch.float32)
    dt = 0.1
    T_b = T_prev @ _se3(rng.normal(0, 0.005, 6))
    true_twist = twist_prev + torch.as_tensor(rng.normal(0, 0.15, 6), dtype=torch.float32)
    T_e = T_b @ _se3(true_twist * dt)

    mp, mc = _room(rng, N_MODEL)
    n_valid = 7800
    mask = np.zeros(N_MODEL, bool)
    mask[:n_valid] = True
    age = np.where(mask, rng.integers(STEP - 40, STEP, N_MODEL), 0)
    model = dict(points=torch.as_tensor(mp), covs=torch.as_tensor(mc),
                 mask=torch.as_tensor(mask), age=torch.as_tensor(age, dtype=torch.int32),
                 min_dist=torch.tensor(0.1, dtype=torch.float32),
                 lru_horizon=torch.tensor(200, dtype=torch.int32))

    world, _ = _room(rng, N_SCAN)
    times = np.sort(rng.uniform(0, dt, N_SCAN)).astype(np.float32)
    s = torch.as_tensor(times / times.max())
    T_s = ref.interpolate(T_b, T_e, s)
    w = torch.as_tensor(world)
    pts = (T_s[:, :3, :3].transpose(1, 2) @ (w - T_s[:, :3, 3])[:, :, None])[:, :, 0]
    pts = pts + torch.as_tensor(rng.normal(0, 0.003, (N_SCAN, 3)), dtype=torch.float32)
    scan_mask = torch.as_tensor(rng.uniform(size=N_SCAN) > 0.05)
    d = torch.cdist(pts, pts) + torch.where(scan_mask, 0.0, 1e6)[None, :]
    neighbors = torch.topk(d, K, largest=False).indices.to(torch.int32)
    uniforms = torch.as_tensor(rng.uniform(size=N_SCAN), dtype=torch.float32)
    return dict(T_prev=T_prev, twist_prev=twist_prev, model=model, pts=pts.contiguous(),
                times=torch.as_tensor(times), mask=scan_mask, neighbors=neighbors,
                dt=torch.tensor(dt), uniforms=uniforms, truth=(T_b, T_e))


def port_step(c, p):
    pm = tct.vmx.PointVoxelMap(**c["model"])
    return tct._ct_scan_step(
        c["T_prev"], c["twist_prev"], STEP, pm, c["pts"], c["times"], c["mask"],
        c["neighbors"], c["dt"], c["uniforms"], p.max_correspondence_distance,
        p.location_consistency_inf_scale, p.constant_velocity_inf_scale,
        p.extrapolation_damping, iters=p.lm_max_iterations,
        bootstrap_frames=p.bootstrap_frames, update_budget=p.update_budget,
        model_kind="ivox", rigid_refine=bool(p.rigid_refine),
        anchor_begin=bool(p.anchor_begin))


def ref_step(c, p):
    return ref.ct_step(
        c["T_prev"], c["twist_prev"], STEP, c["model"], c["pts"], c["times"], c["mask"],
        c["neighbors"], c["dt"], c["uniforms"], max_dist=p.max_correspondence_distance,
        loc_weight=p.location_consistency_inf_scale, cv_weight=p.constant_velocity_inf_scale,
        damping=p.extrapolation_damping, iters=p.lm_max_iterations,
        bootstrap_frames=p.bootstrap_frames, update_budget=p.update_budget)


def step_errors(out_t, out_r):
    """(largest translation difference of T_b and T_e [m], largest rotation
    difference [deg], largest twist difference)."""
    trans, rot = 0.0, 0.0
    for a, b in ((out_t[0], out_r["T_b"]), (out_t[1], out_r["T_e"])):
        a, b = a.double().numpy(), b.double().numpy()
        trans = max(trans, float(np.linalg.norm(a[:3, 3] - b[:3, 3])))
        D = a[:3, :3].T @ b[:3, :3]
        vee = 0.5 * np.array([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
        rot = max(rot, float(np.degrees(np.arctan2(np.linalg.norm(vee),
                                                   0.5 * (np.trace(D) - 1)))))
    twist = float(np.abs(out_t[2].double().numpy() - out_r["twist"].double().numpy()).max())
    return trans, rot, twist


def within(errs):
    return errs[0] <= POSE_ATOL_M and errs[1] <= ROT_ATOL_DEG and errs[2] <= TWIST_ATOL


@pytest.fixture(scope="module")
def case():
    return make_case()


@pytest.fixture(scope="module")
def params():
    p = ct_params()
    assert (p.model_type, p.rigid_refine, p.anchor_begin, p.lm_max_iterations) == \
        ("ivox", False, False, 8)
    return p


def _rand_pose(rng, scale):
    return _se3(rng.normal(0, scale, 6))


def test_linearize_and_priors_match_the_reference(case):
    """``_ct_linearize`` (H, b, error) on the same correspondences, and the
    two priors' blocks, within 1e-4 of the largest entry: float32 sums over
    2,048 points in another order."""
    rng = np.random.default_rng(5)
    c = case
    T_b, T_e = c["truth"]
    T_b = T_b @ _rand_pose(rng, 0.01)
    T_e = T_e @ _rand_pose(rng, 0.01)
    s = torch.as_tensor(rng.uniform(size=N_SCAN), dtype=torch.float32)
    covs = ref.scan_covariances(c["pts"], c["mask"], c["neighbors"])
    T = ref.interpolate(T_b, T_e, s)
    q = (T[:, :3, :3] @ c["pts"][:, :, None])[:, :, 0] + T[:, :3, 3]
    mu, C_t, hit = ref.lookup(c["model"], q, c["mask"], 2.0)
    assert 0.5 * N_SCAN < int(hit.sum()) < N_SCAN
    with ref.full_float32():
        got = tct._ct_linearize(T_b, T_e, c["pts"], covs, s, mu, C_t, hit)
        want = ref.linearize(T_b, T_e, c["pts"], covs, s, mu, C_t, hit)
    for a, b in zip(got, want):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4 * max(1.0, float(np.abs(b).max())))

    anchor = T_b @ _rand_pose(rng, 0.03)
    for offset, T_x in ((0, T_b), (6, T_e)):
        H, b, _ = tct._pose_prior_12(T_x, anchor, 1e3, offset)
        H6, b6 = ref.prior(T_x, anchor, 1e3)
        blk = slice(offset, offset + 6)
        np.testing.assert_allclose(H[blk, blk].numpy(), H6.numpy(),
                                   atol=1e-4 * float(H6.abs().max()))
        np.testing.assert_allclose(b[blk].numpy(), b6.numpy(),
                                   atol=1e-4 * float(b6.abs().max()))


def test_scan_covariances_match_the_port(case):
    """The plane-regularised scan covariances from the given neighbours, at
    1e-4: the same normals from another eigensolver."""
    from glim_tpu_torch.ops import covariance as cov_ops
    c = case
    got, _ = cov_ops.estimate_covariances(c["pts"], c["mask"], c["neighbors"], "plane")
    want = ref.scan_covariances(c["pts"], c["mask"], c["neighbors"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_scan_step_matches_the_reference(case, params):
    """One whole step: begin and end poses and twist within the tolerances
    (POSE_ATOL_M, ROT_ATOL_DEG, TWIST_ATOL), the deskewed scan within 1e-4 m,
    and the model update: the same number of valid points and the same ages."""
    out_t = port_step(case, params)
    out_r = ref_step(case, params)
    errs = step_errors(out_t, out_r)
    assert within(errs), errs
    # The step moved the end pose off the extrapolated guess, towards the truth.
    T_e_true = case["truth"][1]
    guess = case["T_prev"] @ ref.se3_exp(params.extrapolation_damping * case["twist_prev"]
                                         * case["dt"])
    off = lambda T: float(torch.linalg.norm(T[:3, 3] - T_e_true[:3, 3]))  # noqa: E731
    assert off(out_t[1]) < 0.5 * off(guess)
    np.testing.assert_allclose(out_t[4].numpy(), out_r["deskewed"].numpy(), atol=1e-4)
    m_t, m_r = out_t[3], out_r["model"]
    assert int(m_t.mask.sum()) == int(m_r["mask"].sum())
    assert int(m_r["mask"].sum()) == N_MODEL            # the update overflowed the model
    np.testing.assert_array_equal(np.sort(m_t.age[m_t.mask].numpy()),
                                  np.sort(m_r["age"][m_r["mask"]].numpy()))


def _drop_cv_prior(monkeypatch):
    priors = tct._priors

    def without_cv(T_b, T_e, T_prev_e, cv_target, weights):
        return priors(T_b, T_e, T_prev_e, cv_target, weights * torch.tensor([1.0, 0.0]))
    monkeypatch.setattr(tct, "_priors", without_cv)


def _one_search(monkeypatch):
    monkeypatch.setattr(tct, "_INNER", 8)


@pytest.mark.parametrize("fault", [_drop_cv_prior, _one_search])
def test_planted_faults_fail_the_tolerances(case, params, fault, monkeypatch):
    fault(monkeypatch)
    errs = step_errors(port_step(case, params), ref_step(case, params))
    assert not within(errs), errs


def test_first_scan_keeps_the_extrapolation(case, params):
    """Step 0: the solve is discarded in both; the poses are the previous end
    and its damped extrapolation, the twist the one it came with."""
    c = dict(case)
    c["model"] = dict(case["model"], mask=torch.zeros(N_MODEL, dtype=torch.bool))
    pm = tct.vmx.PointVoxelMap(**c["model"])
    p = params
    out_t = tct._ct_scan_step(
        c["T_prev"], c["twist_prev"], 0, pm, c["pts"], c["times"], c["mask"], c["neighbors"],
        c["dt"], c["uniforms"], p.max_correspondence_distance,
        p.location_consistency_inf_scale, p.constant_velocity_inf_scale,
        p.extrapolation_damping, iters=p.lm_max_iterations,
        bootstrap_frames=p.bootstrap_frames, update_budget=p.update_budget,
        model_kind="ivox", rigid_refine=False, anchor_begin=False)
    out_r = ref.ct_step(
        c["T_prev"], c["twist_prev"], 0, c["model"], c["pts"], c["times"], c["mask"],
        c["neighbors"], c["dt"], c["uniforms"], max_dist=p.max_correspondence_distance,
        loc_weight=p.location_consistency_inf_scale, cv_weight=p.constant_velocity_inf_scale,
        damping=p.extrapolation_damping, iters=p.lm_max_iterations,
        bootstrap_frames=p.bootstrap_frames, update_budget=p.update_budget)
    assert within(step_errors(out_t, out_r))
    np.testing.assert_array_equal(out_r["T_b"].numpy(), c["T_prev"].numpy())
    assert torch.equal(out_r["twist"], c["twist_prev"])
    # Every valid point of the first scan goes into the empty model.
    assert int(out_r["model"]["mask"].sum()) == int(out_t[3].mask.sum()) > 0.9 * N_SCAN


def test_ct_map_lag_stages_add_up_to_the_lag(tmp_path):
    """The frozen CT preset (benchmark/configs/ct.json) through a small sync
    GlimTorch run: every submap an optimize covered has the five stages of
    its map lag, each >= 0, adding up within 1 ms to its lag measured from
    outside (the newest frame's hand-over, taken before ``insert_frame``, to
    the end of the first optimize that covers it, ``on_update_submaps``). One
    thread, so nothing runs between a stamp and its callback."""
    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as G
    from glim_tpu_torch.mapping.global_mapping_base import MAP_LAG_STAGES
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils import profiling

    with open(os.path.join(ROOT, "benchmark", "configs", "ct.json")) as f:
        config = json.load(f)
    small = [("config_preprocess", "preprocess", "random_downsample_target", 1000),
             ("config_preprocess", "preprocess", "downsample_resolution", 0.4),
             ("config_sub_mapping", "sub_mapping", "max_num_keyframes", 4)]
    seq = generate_sequence(duration=3.0, n_scan_points=1500, scene_points=20000, seed=53)
    handover, newest, first_opt = {}, {}, {}
    G.on_insert_submap.add(lambda sm: newest.__setitem__(sm.id, max(f.stamp
                                                                    for f in sm.frames)))

    def on_update_submaps(submaps):
        t = time.perf_counter()
        for sm in submaps:
            first_opt.setdefault(sm.id, t)
    G.on_update_submaps.add(on_update_submaps)
    glim = GlimTorch(glim_config.config_dir(config, str(tmp_path)), async_mode=False,
                     device="cpu", overrides=small)
    assert type(glim.odometry).__name__ == "OdometryEstimationCT"
    profiling.report(reset=True)
    imu_i = 0
    for raw in seq.scans:
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.12:
            glim.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
            imu_i += 1
        handover[raw.stamp] = time.perf_counter()
        glim.insert_frame(raw)
    glim.wait()
    scopes = profiling.report()

    covered = [sm for sm in glim.submaps if sm.id in first_opt]
    assert len(covered) >= 2
    for sm in covered:
        stamps = dict(max(sm.frames, key=lambda f: f.stamp).host_stamps, **sm.host_stamps)
        stages = [stamps[b] - stamps[a] for _, a, b in MAP_LAG_STAGES]
        assert min(stages) >= 0.0, (sm.id, stages)
        outside = first_opt[sm.id] - handover[newest[sm.id]]
        assert sum(stages) == pytest.approx(outside, abs=1e-3), (sm.id, stages, outside)
    for name, _, _ in MAP_LAG_STAGES:
        assert scopes[name]["n"] == len(covered), name
    # The CT spans: a step a scan (and the bootstrap replay's), four model
    # lookups and one insert a step, one replay.
    n_step = scopes["ct_scan_step"]["n"]
    assert n_step == len(seq.scans) + glim.odometry.params.bootstrap_frames
    assert scopes["ct/lookup"]["n"] == 4 * n_step
    assert scopes["ct/model_insert"]["n"] == n_step
    assert scopes["ct/bootstrap_replay"]["n"] == 1
