"""The port's ``window_scan_step(matching="vgicp")`` against the JAX
package's, from a realistic state.

A JAX flagship ``OdometryEstimationIMU`` (VGICP, 2 voxel-map levels, W=6,
512 scan lanes) runs until its window is full. Its window, its model levels
and the next two scans' step inputs are taken as numpy, and each package
starts from the same numpy state through ``state.py``: one step (which
evicts the oldest state), with and without the marginal covariances, then a
second step chained on each package's own output. Tolerances are those of
tests/torch_parity.py; the overlap comes from the first level's hits, and
the matching log-determinant (the ENTROPY strategy's input) agrees to 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import POSE_ATOL, compare_step, jax_window, np_state, scaled

from glim_tpu.io.synthetic import generate_sequence
from glim_tpu.odometry import window_estimator as j_we
from glim_tpu.odometry.odometry_estimation_imu import (OdometryEstimationIMU,
                                                       OdometryEstimationIMUParams)
from glim_tpu.ops.voxelmap import GaussianVoxelMap as JGaussianVoxelMap
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
    """JAX flagship odometry run until the window is full; returns the numpy
    window, model levels, constants and the next two scans' step inputs."""
    seq = generate_sequence(duration=1.3, n_scan_points=900, scene_points=12000, seed=31)
    pp = CloudPreprocessor(CloudPreprocessorParams(random_downsample_target=500,
                                                   downsample_resolution=0.4))
    odom = OdometryEstimationIMU(OdometryEstimationIMUParams(
        window_size=W, initialization_mode="NAIVE", initialization_window_size=0.3,
        voxel_capacity=8192, voxel_resolution=0.5, voxel_resolution_max=0.5,
        bootstrap_frames=2))
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
    levels = tuple(np_state(vm) for vm in odom.model)
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
              inner_iters=odom.params.inner_iterations, matching="vgicp",
              full_connection=odom.params.full_connection_window_size)
    assert win["valid"].all() and len(levels) == 2
    assert odom.keyframes.count >= 3
    return win, levels, consts, steps, kw


def _run_jax(win, levels, consts, step, kw, compute_covs=False):
    # vel_reg is passed as the odometry passes it, so the jitted program the
    # scenario compiled is reused.
    vms = tuple(JGaussianVoxelMap(**{k: jnp.asarray(v) for k, v in lv.items()})
                for lv in levels)
    w, out = j_we.window_scan_step(jax_window(win), vms,
                                   *[jnp.asarray(a) for a in step + consts],
                                   vel_reg=None, compute_covs=compute_covs, **kw)
    return np_state(w), jax.tree_util.tree_map(np.asarray, out)


def _run_torch(win, levels, consts, step, kw, compute_covs=False, device="cpu"):
    w, out = t_we.window_scan_step(t_state.window_state_from_numpy(win, device),
                                   t_state.voxelmap_levels_from_numpy(levels, device),
                                   *[torch.from_numpy(np.array(a, order="C")).to(device)
                                     for a in step + consts],
                                   compute_covs=compute_covs, **kw)
    return t_state.window_state_to_numpy(w), out


def _compare_vgicp(wt, out_t, wj, out_j):
    compare_step(wt, out_t, wj, out_j)
    st, sj = out_t["status"].cpu().numpy(), out_j["status"]
    np.testing.assert_allclose(st[j_we.STATUS_LOGDET], sj[j_we.STATUS_LOGDET], rtol=1e-3)
    assert 0.1 < sj[j_we.STATUS_OVERLAP] <= 1.0


def test_model_levels_roundtrip(scenario):
    levels = scenario[1]
    back = t_state.voxelmap_levels_to_numpy(t_state.voxelmap_levels_from_numpy(levels, "cpu"))
    for lv, bk in zip(levels, back):
        for k, v in lv.items():
            np.testing.assert_array_equal(bk[k], v)
            assert bk[k].dtype == v.dtype, k
    assert levels[1]["resolution"] == 2 * levels[0]["resolution"]


@pytest.mark.parametrize("compute_covs", [False, True])
def test_vgicp_one_step_with_eviction(scenario, compute_covs):
    win, levels, consts, steps, kw = scenario
    wj, out_j = _run_jax(win, levels, consts, steps[0], kw, compute_covs)
    wt, out_t = _run_torch(win, levels, consts, steps[0], kw, compute_covs)
    assert out_j["status"][j_we.STATUS_MARGINALIZED] == 1.0       # evicted
    _compare_vgicp(wt, out_t, wj, out_j)
    np.testing.assert_allclose(out_t["marg"]["T_wi"].numpy(), out_j["marg"]["T_wi"], atol=0)
    np.testing.assert_allclose(out_t["deskewed"].numpy(), out_j["deskewed"], atol=POSE_ATOL)
    if compute_covs:
        scaled(out_t["state_covs"].numpy(), out_j["state_covs"], rel=1e-3)


def test_vgicp_two_steps_chained(scenario):
    win, levels, consts, steps, kw = scenario
    wj, _ = _run_jax(win, levels, consts, steps[0], kw)
    wt, _ = _run_torch(win, levels, consts, steps[0], kw)
    wj2, out_j = _run_jax(wj, levels, consts, steps[1], kw)
    wt2, out_t = _run_torch(wt, levels, consts, steps[1], kw)
    _compare_vgicp(wt2, out_t, wj2, out_j)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_vgicp_one_step_on_cuda(scenario, cuda):
    """The VGICP step with its tensors on the card against JAX on the CPU,
    at the same tolerances."""
    win, levels, consts, steps, kw = scenario
    wj, out_j = _run_jax(win, levels, consts, steps[0], kw)
    wt, out_t = _run_torch(win, levels, consts, steps[0], kw, device=cuda)
    assert out_t["T_wi"].device.type == "cuda"
    _compare_vgicp(wt, out_t, wj, out_j)
