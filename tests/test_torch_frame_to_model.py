"""The port's frame-to-model odometry against the JAX package's: the
LiDAR-only module (``odometry_estimation_cpu.py``, GICP and VGICP) and the
LiDAR-IMU module's VGICP mode (``odometry_estimation_cpu_imu.py``).

The same numpy inputs, made from a seed, go through both packages. One
LiDAR-only step from the same carried-in state (poses, twist and velocity
at POSE_ATOL; scans of ~1000 points against the default update budget of
2048, so every valid point enters the model and no random draw matters),
once with the two-pass bootstrap refinement; short sequences through both
modules compared on the aligned ATE within 10% or 2 mm; one window step of
the LiDAR-IMU VGICP mode from the JAX module's window and its own voxel-map
levels (``torch_parity.compare_step``); the factory's ``enable_imu: false``
branch; and the LiDAR-only configuration through GlimTorch in both modes,
fed the IMU stream it ignores. The steps use the JAX scan covariances
(``torch_parity.use_jax_covariances``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (POSE_ATOL, SMALL_DEFAULT_OVERRIDES, compare_step, jax_window,
                          np_state, port_frame, use_jax_covariances)

from glim_tpu.io.synthetic import ate_rmse, generate_sequence
from glim_tpu.odometry import odometry_estimation_cpu as jlo
from glim_tpu.odometry import odometry_estimation_cpu_imu as jci
from glim_tpu.odometry import window_estimator as j_we
from glim_tpu.ops import voxelmap as j_vmx
from glim_tpu.preprocess.cloud_preprocessor import (CloudPreprocessor,
                                                    CloudPreprocessorParams)
from glim_tpu_torch import state as t_state
from glim_tpu_torch.odometry import odometry_estimation_cpu as tlo
from glim_tpu_torch.odometry import odometry_estimation_cpu_imu as tci
from glim_tpu_torch.odometry import window_estimator as t_we

ATE_REL, ATE_ABS = 0.10, 0.002
SEQ = dict(duration=1.5, n_scan_points=1500, scene_points=20000, noise=0.01, seed=4)


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    from glim_tpu_torch.utils import lifecycle
    lifecycle.stop_all()
    CallbackSlot.clear_all()


@pytest.fixture(scope="module")
def frames():
    seq = generate_sequence(**SEQ)
    pp = CloudPreprocessor(CloudPreprocessorParams(random_downsample_target=1000,
                                                   downsample_resolution=0.4))
    return seq, [pp.preprocess(raw) for raw in seq.scans]


def _lo_params(pkg, reg, **kw):
    return pkg.OdometryEstimationCPUParams(registration_type=reg, model_capacity=16384,
                                           voxel_capacity=16384, ivox_min_dist=0.1, **kw)


def _gen_model(d):
    """A numpy model dict as the JAX package's map."""
    cls = j_vmx.GaussianVoxelMap if "hash" in d else j_vmx.PointVoxelMap
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _t_model(d):
    return (t_state.gaussian_voxelmap_from_numpy(d, "cpu") if "hash" in d
            else t_state.point_voxelmap_from_numpy(d, "cpu"))


@pytest.mark.parametrize("reg, two_pass", [("GICP", False), ("GICP", True),
                                           ("VGICP", False)])
def test_lidar_only_step(frames, reg, two_pass, monkeypatch):
    """One step of ``_gicp_scan_step`` / ``_vgicp_scan_step`` after the
    bootstrap replay, from the same state."""
    _, fs = frames
    use_jax_covariances(monkeypatch)
    odom = jlo.OdometryEstimationCPU(_lo_params(jlo, reg, bootstrap_frames=3))
    for f in fs[:5]:
        odom.insert_frame(f)
    st = odom.state
    T, twist, step = np.asarray(st.T), np.asarray(st.twist), int(st.step)
    model = np_state(st.model)
    p, f = odom.params, fs[5]
    kw = dict(iters=p.max_iterations, ema=p.twist_smoothing,
              bootstrap_frames=p.bootstrap_frames, update_budget=p.update_budget,
              enable_deskew=True, two_pass=two_pass)
    assert p.update_budget >= f.device_points.shape[0]

    j_state = jlo.OdomDeviceState(T=jnp.asarray(T), twist=jnp.asarray(twist),
                                  step=jnp.int32(step), rng=jax.random.PRNGKey(0),
                                  model=_gen_model(model))
    j_args = (f.device_points, f.device_times, f.device_mask, f.device_neighbors,
              jnp.float32(0.1))
    tf = port_frame(f)
    t_state_ = tlo.OdomDeviceState(T=torch.as_tensor(T), twist=torch.as_tensor(twist),
                                   step=step, model=_t_model(model))
    t_args = (tf.device_points, tf.device_times, tf.device_mask, tf.device_neighbors,
              torch.tensor(0.1))
    gen = torch.Generator().manual_seed(0)
    if reg == "GICP":
        sj, out_j = jlo._gicp_scan_step(j_state, *j_args, jnp.float32(2.0), **kw)
        st_t, out_t = tlo._gicp_scan_step(t_state_, *t_args, 2.0, gen, **kw)
    else:
        sj, out_j = jlo._vgicp_scan_step(j_state, *j_args, **kw)
        st_t, out_t = tlo._vgicp_scan_step(t_state_, *t_args, gen, **kw)
    for name, a, b in (("T", st_t.T, sj.T), ("twist", st_t.twist, sj.twist),
                       ("v_world", out_t[1], out_j[1]), ("deskewed", out_t[2], out_j[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=POSE_ATOL, err_msg=name)
    # The last search's matching error (an earlier search may count one
    # boundary point in or out).
    np.testing.assert_allclose(out_t[5][-1].numpy(), np.asarray(out_j[5])[-1], rtol=1e-2)
    assert st_t.step == int(sj.step) == step + 1
    n_valid = (lambda m: int(np.asarray(m.hash != 0x7FFFFFFF).sum())) if reg == "VGICP" \
        else (lambda m: int(np.asarray(m.mask).sum()))
    assert abs(n_valid(st_t.model) - n_valid(sj.model)) <= 0.01 * n_valid(sj.model)


def _ate(seq, ests):
    gt = [seq.gt_poses[int(round(e.stamp * 10))] for e in ests]
    poses = [e.T_world_lidar for e in ests]
    assert all(np.all(np.isfinite(T)) for T in poses)
    return ate_rmse(poses, gt, align=True)


@pytest.mark.parametrize("reg", ["GICP", "VGICP"])
def test_lidar_only_sequence_matches_jax(frames, reg):
    """Fifteen scans through both modules (the default eight bootstrap
    scans and their replay included)."""
    seq, fs = frames
    jo = jlo.OdometryEstimationCPU(_lo_params(jlo, reg))
    to = tlo.OdometryEstimationCPU(_lo_params(tlo, reg), device="cpu")
    ate_j = _ate(seq, [jo.insert_frame(f) for f in fs])
    ate_t = _ate(seq, [to.insert_frame(port_frame(f)) for f in fs])
    assert to._boot_done and not to._boot
    assert abs(ate_t - ate_j) <= max(ATE_REL * ate_j, ATE_ABS), (ate_t, ate_j)
    assert ate_t < 0.15


def _cpu_imu_params(pkg):
    return pkg.OdometryEstimationCPUIMUParams(
        registration_type="VGICP", window_size=6, outer_iterations=3, inner_iterations=2,
        initialization_window_size=0.3, model_capacity=16384, vgicp_resolution=0.5)


def _feed_imu(odom, seq, imu_i, stamp):
    while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= stamp + 0.12:
        odom.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
        imu_i += 1
    return imu_i


@pytest.fixture(scope="module")
def cpu_imu_jax(frames):
    """The JAX LiDAR-IMU VGICP module over the sequence (LOOSE
    initialisation, then the window): its estimates, and a snapshot taken
    when its window first fills (window, model levels, the next scan's step
    inputs and the step's constants), as numpy."""
    seq, fs = frames
    odom = jci.OdometryEstimationCPUIMU(_cpu_imu_params(jci))
    imu_i, ests, snap = 0, [], None
    for raw, f in zip(seq.scans, fs):
        imu_i = _feed_imu(odom, seq, imu_i, raw.stamp)
        if snap is None and odom.window is not None and len(odom._est_frames) == odom.W:
            odom._process_status()            # what insert_frame does first
            packed = odom._imu_packed(odom.last_frame_stamp, f.stamp, f.scan_end_time,
                                      f.stamp - odom._t0, True)
            snap = dict(
                win=np_state(odom.window), levels=tuple(np_state(vm) for vm in odom.model),
                step=[np.asarray(a) for a in (f.device_points, f.device_times, f.device_mask,
                                              f.device_neighbors, packed)],
                consts=[np.asarray(a) for a in (
                    odom._d_T_lidar_imu, odom._d_gravity, odom._d_acc_noise,
                    odom._d_gyro_noise, odom._d_int_noise, odom._d_bias_rw_info,
                    odom._d_matching_weight, odom._last_kf_pose_dev(),
                    odom._d_max_corr_dist)],
                kw=dict(W=odom.W, outer_iters=3, inner_iters=2, matching="vgicp",
                        full_connection=odom.params.full_connection_window_size))
        e = odom.insert_frame(f)
        if e is not None:
            ests.append(e)
    odom.get_remaining_frames()            # the window's final poses, in place
    assert snap is not None
    return snap, ests


def test_cpu_imu_vgicp_window_step(cpu_imu_jax, monkeypatch):
    """The LiDAR-IMU VGICP mode: its model is vgicp_voxelmap_levels Gaussian
    voxel maps at vgicp_resolution x scaling^level; one window step
    (evicting the oldest state) against that tuple of maps, from the JAX
    module's window, in both packages."""
    snap, _ = cpu_imu_jax
    use_jax_covariances(monkeypatch)
    win, levels, kw = snap["win"], snap["levels"], snap["kw"]
    assert [float(lv["resolution"]) for lv in levels] == pytest.approx([0.5, 1.0])
    inputs = snap["step"] + snap["consts"]
    wj, out_j = j_we.window_scan_step(
        jax_window(win), tuple(_gen_model(lv) for lv in levels),
        *[jnp.asarray(a) for a in inputs], vel_reg=None, **kw)
    wj, out_j = np_state(wj), jax.tree_util.tree_map(np.asarray, out_j)

    todom = tci.OdometryEstimationCPUIMU(_cpu_imu_params(tci), device="cpu")
    assert todom._matching == "vgicp" and len(todom.model) == 2
    assert [float(vm.resolution) for vm in todom.model] == pytest.approx([0.5, 1.0])
    wt, out_t = t_we.window_scan_step(
        t_state.window_state_from_numpy(win, "cpu"),
        t_state.voxelmap_levels_from_numpy(levels, "cpu"),
        *[torch.from_numpy(np.array(a, order="C")) for a in inputs], **kw)
    # b_marg, the gradient of the evicted pair's system, is held to first
    # order in the state difference (torch_parity.compare_step).
    compare_step(t_state.window_state_to_numpy(wt), out_t, wj, out_j, stiff=("b_marg",))


def test_cpu_imu_vgicp_sequence_matches_jax(frames, cpu_imu_jax):
    """The LiDAR-IMU VGICP mode over the sequence in both packages."""
    seq, fs = frames
    odom = tci.OdometryEstimationCPUIMU(_cpu_imu_params(tci), device="cpu")
    imu_i, ests = 0, []
    for raw, f in zip(seq.scans, fs):
        imu_i = _feed_imu(odom, seq, imu_i, raw.stamp)
        e = odom.insert_frame(port_frame(f))
        if e is not None:
            ests.append(e)
    odom.get_remaining_frames()
    j_ests = cpu_imu_jax[1]
    assert [e.id for e in ests] == [e.id for e in j_ests] and len(ests) >= 8
    ate_j, ate_t = _ate(seq, j_ests), _ate(seq, ests)
    assert abs(ate_t - ate_j) <= max(ATE_REL * ate_j, ATE_ABS), (ate_t, ate_j)
    assert ate_t < 0.12


def test_factory_enable_imu_false():
    """The port's twin of tests/test_odometry_cpu_imu.py's registry test:
    enable_imu false gives the LiDAR-only module (with the config's
    registration type), VGICP the IMU-coupled one."""
    from glim_tpu_torch.utils.config import Config
    from glim_tpu_torch.utils.registry import load_module

    cfg = Config({"odometry_estimation": {"enable_imu": False, "registration_type": "GICP"}})
    m = load_module("odometry", "libodometry_estimation_cpu.so", cfg, device="cpu")
    assert isinstance(m, tlo.OdometryEstimationCPU) and not m.use_vgicp
    assert not m.requires_imu() and m.params.model_capacity == 131072
    m2 = load_module("odometry", "libodometry_estimation_cpu.so",
                     Config({"odometry_estimation": {"registration_type": "VGICP"}}),
                     device="cpu")
    assert isinstance(m2, tci.OdometryEstimationCPUIMU) and m2.requires_imu()
    assert m2.use_vgicp and m2._matching == "vgicp"
    lo = load_module("odometry", "odometry_estimation_lidar_only", None, device="cpu")
    assert isinstance(lo, tlo.OdometryEstimationCPU) and lo.params.registration_type == "GICP"


@pytest.mark.parametrize("async_mode", [False, True])
def test_lidar_only_through_glim(async_mode):
    """config_odometry_cpu.json with enable_imu false through GlimTorch: the
    pipeline feeds it the IMU stream (which it ignores), and every frame
    reaches a submap."""
    import chip_smoke
    from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks
    from glim_tpu_torch.pipeline import GlimTorch

    cfg = chip_smoke.config_dir([
        ("config", "global", "config_odometry", "config_odometry_cpu.json"),
        ("config_odometry", "odometry_estimation", "enable_imu", False)])
    seq = generate_sequence(duration=2.0, n_scan_points=1500, scene_points=20000, seed=53)
    glim = GlimTorch(cfg, async_mode=async_mode, device="cpu", overrides=[
        ("config_odometry", "odometry_estimation", "smoother_lag", 0.5)]
        + [o for o in SMALL_DEFAULT_OVERRIDES if o[0] != "config_odometry"])
    inner = glim.odometry.odometry if async_mode else glim.odometry
    assert isinstance(inner, tlo.OdometryEstimationCPU)
    to_sub = []
    SubMappingCallbacks.on_insert_frame.add(lambda f: to_sub.append(f.id))
    imu_i = 0
    for raw in seq.scans:
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.12:
            glim.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
            imu_i += 1
        glim.insert_frame(raw)
    glim.wait()
    ests = glim.odometry_estimates
    assert [e.id for e in ests] == list(range(len(seq.scans)))
    assert _ate(seq, ests) < 0.15
    assert sorted(to_sub) == list(range(len(seq.scans)))
    assert sum(len(s.frames) for s in glim.submaps) == len(to_sub) and glim.submaps
