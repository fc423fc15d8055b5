"""The port's fused odometry step (glim_tpu_torch/odometry/window_estimator.py)
against the JAX package's ``window_scan_step(matching="gicp")``.

A realistic state comes from running the JAX cpu-parity module for a few
scans (W=6, C=512 scan lanes, a 4096-point map) until its window is full.
That state, the map and the next two scans' inputs are taken as numpy, and
each package starts from the same numpy state through ``state.py``: one
step (which evicts the oldest state), then a second step chained on each
package's own output.

The VGICP mode is checked here on the problem of ``__graft_entry__.py``
(one flagship step on a synthetic map) and in tests/test_torch_vgicp_step.py
on a realistic state. Tolerances are those of tests/torch_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import POSE_ATOL, compare_step, jax_window, np_state, scaled

from glim_tpu.io.synthetic import generate_sequence
from glim_tpu.odometry import window_estimator as j_we
from glim_tpu.odometry.odometry_estimation_cpu_imu import (
    OdometryEstimationCPUIMU, OdometryEstimationCPUIMUParams)
from glim_tpu.ops.voxelmap import PointVoxelMap as JPointVoxelMap
from glim_tpu.preprocess.cloud_preprocessor import (CloudPreprocessor,
                                                    CloudPreprocessorParams)
from glim_tpu_torch import state as t_state
from glim_tpu_torch.odometry import window_estimator as t_we

W = 6


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


@pytest.fixture(scope="module")
def scenario():
    """JAX odometry run until the window is full; returns the numpy state,
    map, constants and the next two scans' step inputs."""
    seq = generate_sequence(duration=1.3, n_scan_points=900, scene_points=12000, seed=31)
    pp = CloudPreprocessor(CloudPreprocessorParams(random_downsample_target=500,
                                                   downsample_resolution=0.4))
    odom = OdometryEstimationCPUIMU(OdometryEstimationCPUIMUParams(
        window_size=W, initialization_mode="NAIVE", initialization_window_size=0.3,
        model_capacity=4096, ivox_resolution=0.8))
    imu_i = 0

    def feed_imu(stamp):
        nonlocal imu_i
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= stamp + 0.12:
            odom.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
            imu_i += 1

    scans = iter(seq.scans)
    while len(odom._est_frames) < W:
        raw = next(scans)
        feed_imu(raw.stamp)
        odom.insert_frame(pp.preprocess(raw))
    odom._process_status()                 # map updates the next step would see
    win = np_state(odom.window)
    model = np_state(odom.model)
    steps = []
    for evict in (True, True):
        raw = next(scans)
        feed_imu(raw.stamp)
        f = pp.preprocess(raw)
        packed = odom._imu_packed(odom.last_frame_stamp, f.stamp, f.scan_end_time,
                                  f.stamp - odom._t0, evict)
        odom.last_frame_stamp = f.stamp
        steps.append([np.asarray(a) for a in (f.device_points, f.device_times, f.device_mask,
                                              f.device_neighbors, packed)])
    consts = [np.asarray(a) for a in (
        odom._d_T_lidar_imu, odom._d_gravity, odom._d_acc_noise, odom._d_gyro_noise,
        odom._d_int_noise, odom._d_bias_rw_info, odom._d_matching_weight,
        odom._last_kf_pose_dev(), odom._d_max_corr_dist)]
    kw = dict(W=W, outer_iters=odom.params.outer_iterations,
              inner_iters=odom.params.inner_iterations, matching="gicp",
              full_connection=odom.params.full_connection_window_size)
    assert win["valid"].all()
    return win, model, consts, steps, kw


def _run_jax(win, model, consts, step, kw, compute_covs=False, vel_reg=None):
    vm = JPointVoxelMap(**{k: jnp.asarray(v) for k, v in model.items()})
    w, out = j_we.window_scan_step(jax_window(win), vm,
                                   *[jnp.asarray(a) for a in step + consts],
                                   vel_reg=None if vel_reg is None else jnp.asarray(vel_reg),
                                   compute_covs=compute_covs, **kw)
    return np_state(w), jax.tree_util.tree_map(np.asarray, out)


def _run_torch(win, model, consts, step, kw, compute_covs=False, device="cpu",
               vel_reg=None):
    w, out = t_we.window_scan_step(t_state.window_state_from_numpy(win, device),
                                   t_state.point_voxelmap_from_numpy(model, device),
                                   *[torch.from_numpy(np.asarray(a, order="C")).to(device)
                                     for a in step + consts],
                                   vel_reg=None if vel_reg is None else torch.from_numpy(vel_reg),
                                   compute_covs=compute_covs, **kw)
    return t_state.window_state_to_numpy(w), out


def test_state_roundtrip(scenario):
    win, model = scenario[:2]
    back = t_state.window_state_to_numpy(t_state.window_state_from_numpy(win, "cpu"))
    assert set(back) == set(win) and len(back) == 22
    for k, v in win.items():
        if k == "preints":
            for kk, vv in v.items():
                np.testing.assert_array_equal(back[k][kk], vv)
        else:
            np.testing.assert_array_equal(back[k], v)
            assert back[k].dtype == v.dtype, k
    pm = t_state.point_voxelmap_to_numpy(t_state.point_voxelmap_from_numpy(model, "cpu"))
    for k, v in model.items():
        np.testing.assert_array_equal(pm[k], v)


@pytest.mark.parametrize("compute_covs", [False, True])
def test_one_step_with_eviction(scenario, compute_covs):
    win, model, consts, steps, kw = scenario
    wj, out_j = _run_jax(win, model, consts, steps[0], kw, compute_covs)
    wt, out_t = _run_torch(win, model, consts, steps[0], kw, compute_covs)
    assert out_j["status"][j_we.STATUS_MARGINALIZED] == 1.0       # evicted
    compare_step(wt, out_t, wj, out_j)
    np.testing.assert_allclose(out_t["marg"]["T_wi"].numpy(), out_j["marg"]["T_wi"], atol=0)
    np.testing.assert_allclose(out_t["deskewed"].numpy(), out_j["deskewed"], atol=POSE_ATOL)
    if compute_covs:
        scaled(out_t["state_covs"].numpy(), out_j["state_covs"], rel=1e-3)


def test_one_step_with_velocity_regulation(scenario):
    """The velocity-regulation term (the velocity suppressor's hook), with a
    speed cap below the scenario's ~2.9 m/s so that it pulls."""
    win, model, consts, steps, kw = scenario
    vel_reg = np.array([100.0, 2.0], np.float32)
    wj, out_j = _run_jax(win, model, consts, steps[0], kw, vel_reg=vel_reg)
    wt, out_t = _run_torch(win, model, consts, steps[0], kw, vel_reg=vel_reg)
    compare_step(wt, out_t, wj, out_j)
    _, out_free = _run_jax(win, model, consts, steps[0], kw)
    assert np.linalg.norm(out_j["v"]) < np.linalg.norm(out_free["v"]) - 0.02


def test_two_steps_chained(scenario):
    win, model, consts, steps, kw = scenario
    wj, _ = _run_jax(win, model, consts, steps[0], kw)
    wt, _ = _run_torch(win, model, consts, steps[0], kw)
    wj2, out_j = _run_jax(wj, model, consts, steps[1], kw)
    wt2, out_t = _run_torch(wt, model, consts, steps[1], kw)
    compare_step(wt2, out_t, wj2, out_j)


def test_vgicp_graft_entry_matches_jax():
    """The VGICP mode on the problem of ``__graft_entry__.py::entry`` (one
    flagship step: W=8, 2048 scan lanes, an 8192-voxel map): the port's
    step matches the JAX one in T_wi and status."""
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    T_wi_j, status_j = (np.asarray(x) for x in fn(*args))
    win, vm, pts, times, mask, nbrs, packed = args
    f32 = lambda *v: torch.tensor(v, dtype=torch.float32)
    eye4 = torch.eye(4)
    _, out = t_we.window_scan_step(
        t_state.window_state_from_numpy(np_state(win), "cpu"),
        (t_state.gaussian_voxelmap_from_numpy(np_state(vm), "cpu"),),
        *[torch.from_numpy(np.array(a)) for a in (pts, times, mask, nbrs, packed)],
        eye4, f32(0.0, 0.0, -9.80665), f32(0.05)[0], f32(0.02)[0], f32(0.001)[0],
        torch.full((6,), 300.0), f32(1.0)[0], eye4, f32(2.0)[0],
        W=8, outer_iters=2, inner_iters=2, matching="vgicp")
    st = out["status"].numpy()
    np.testing.assert_allclose(out["T_wi"].numpy(), T_wi_j, atol=POSE_ATOL)
    assert st[j_we.STATUS_FINITE] == status_j[j_we.STATUS_FINITE] == 1.0
    assert 0.5 < status_j[j_we.STATUS_OVERLAP] <= 1.0
    np.testing.assert_allclose(st[j_we.STATUS_OVERLAP], status_j[j_we.STATUS_OVERLAP], atol=5e-3)
    np.testing.assert_allclose(st[j_we.STATUS_ERR], status_j[j_we.STATUS_ERR], rtol=1e-2)
    np.testing.assert_allclose(st[j_we.STATUS_LOGDET], status_j[j_we.STATUS_LOGDET], rtol=1e-3)
    np.testing.assert_allclose(st[j_we.STATUS_DTRANS:], status_j[j_we.STATUS_DTRANS:],
                               atol=POSE_ATOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the nn_search kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_one_step_on_cuda(scenario, cuda):
    """The step on the card, its lookups through the nn_search kernel,
    against JAX on the CPU at the same tolerances."""
    from glim_tpu_torch.ops.nn_search import nn_search

    win, model, consts, steps, kw = scenario
    wj, out_j = _run_jax(win, model, consts, steps[0], kw)
    before = nn_search.kernel_launches
    wt, out_t = _run_torch(win, model, consts, steps[0], kw, device=cuda)
    assert nn_search.kernel_launches - before == 5
    compare_step(wt, out_t, wj, out_j)
