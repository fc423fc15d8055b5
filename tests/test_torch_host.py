"""The port's host-only numpy copies against the JAX package's originals.

These modules (config, synthetic data, trajectory evaluation, time keeping,
initialisation, numpy Lie helpers) are copied rather than imported, because
importing anything from ``glim_tpu`` loads JAX. A copy must not change
behaviour: the same numpy inputs give equal outputs (exactly, or at f64
rounding, atol 1e-12, where the math is floating point).
"""

import json
import os

import jax  # noqa: F401  (both packages in one process, as in the other files)
import numpy as np
import pytest
import torch

F64_ATOL = 1e-12


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def test_default_config_dirs_are_equal(tmp_path):
    from glim_tpu.utils.config import create_default_config_dir as j_create
    from glim_tpu_torch.utils.config import create_default_config_dir as t_create

    dj, dt = j_create(str(tmp_path / "jax")), t_create(str(tmp_path / "torch"))
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt)) and "config_odometry_cpu.json" in names
    for name in names:
        with open(os.path.join(dj, name)) as fj, open(os.path.join(dt, name)) as ft:
            assert json.load(fj) == json.load(ft), name


@pytest.mark.parametrize("kind", ["circle", "figure8"])
def test_synthetic_sequences_are_equal(kind):
    from glim_tpu.io import synthetic as j_syn
    from glim_tpu_torch.io import synthetic as t_syn

    kw = dict(duration=0.3, path=kind, n_channels=8, n_azimuth=128, seed=3)
    sj, st = j_syn.generate_raycast_sequence(**kw), t_syn.generate_raycast_sequence(**kw)
    np.testing.assert_array_equal(st.imu, sj.imu)
    np.testing.assert_array_equal(np.stack(st.gt_poses), np.stack(sj.gt_poses))
    assert len(st.scans) == len(sj.scans)
    for a, b in zip(st.scans, sj.scans):
        assert a.stamp == b.stamp
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.times, b.times)


def _noisy_trajectory(seed):
    from glim_tpu.io.synthetic import generate_sequence

    rng = np.random.default_rng(seed)
    seq = generate_sequence(duration=3.0, n_scan_points=16, scene_points=64, seed=seed)
    gt = [np.asarray(T, np.float64) for T in seq.gt_poses]
    est = []
    for T in gt:
        E = T.copy()
        E[:3, 3] += rng.normal(scale=0.05, size=3)
        est.append(E)
    return [0.1 * i for i in range(len(gt))], est, gt


@pytest.mark.parametrize("align", [True, False])
def test_trajectory_evaluation_is_equal(tmp_path, align):
    from glim_tpu.io import evaluation as j_ev
    from glim_tpu_torch.io import evaluation as t_ev

    stamps, est, gt = _noisy_trajectory(5)
    mj = j_ev.evaluate_trajectory(est, gt, align=align, rpe_deltas_m=(1.0, 3.0))
    mt = t_ev.evaluate_trajectory(est, gt, align=align, rpe_deltas_m=(1.0, 3.0))
    for field in ("ate_rmse", "ate_mean", "ate_median", "ate_max", "rot_rmse_deg",
                  "length_m"):
        np.testing.assert_allclose(getattr(mt, field), getattr(mj, field), atol=F64_ATOL)
    assert mt.n_poses == mj.n_poses and mt.rpe_trans.keys() == mj.rpe_trans.keys()
    # TUM files written by the port read back identically by both packages.
    path = str(tmp_path / "est.txt")
    t_ev.save_tum(path, stamps, est)
    (s_t, p_t), (s_j, p_j) = t_ev.load_tum(path), j_ev.load_tum(path)
    np.testing.assert_array_equal(s_t, s_j)
    np.testing.assert_array_equal(np.stack(p_t), np.stack(p_j))
    shifted = np.asarray(stamps) + 0.004
    assert t_ev.associate(s_t, shifted, 0.01) == j_ev.associate(s_j, shifted, 0.01)


def test_initial_state_estimation_is_equal():
    from glim_tpu.io.synthetic import generate_sequence
    from glim_tpu.odometry import initial_state_estimation as j_init
    from glim_tpu_torch.odometry import initial_state_estimation as t_init

    seq = generate_sequence(duration=1.0, n_scan_points=16, scene_points=64, seed=2)
    poses = [(0.1 * i, np.asarray(T, np.float64)) for i, T in enumerate(seq.gt_poses)]
    T_li = np.eye(4)
    T_li[:3, 3] = [0.1, -0.05, 0.2]
    for fn, args in ((t_init.loose_initial_state, (poses, seq.imu, T_li)),
                     (t_init.naive_initial_state, (seq.imu[:40], 0.2))):
        st = fn(*args)
        sj = getattr(j_init, fn.__name__)(*args)
        for field in ("stamp", "T_world_imu", "v_world", "bias"):
            np.testing.assert_allclose(getattr(st, field), getattr(sj, field),
                                       atol=F64_ATOL, err_msg=f"{fn.__name__}.{field}")


def test_time_keeper_is_equal():
    """Relative per-point times, a late scan and out-of-order IMU stamps."""
    from glim_tpu.types import RawPoints as JRaw
    from glim_tpu.utils.time_keeper import TimeKeeper as JTimeKeeper
    from glim_tpu_torch.types import RawPoints as TRaw
    from glim_tpu_torch.utils.time_keeper import TimeKeeper as TTimeKeeper

    rng = np.random.default_rng(4)
    tj, tt = JTimeKeeper(), TTimeKeeper()
    for stamp in (0.0, 0.1, 0.2, 0.15, 0.35, 0.4):
        pts = rng.normal(size=(50, 3))
        times = np.sort(rng.uniform(0.0, 0.09, 50))
        rj, rt = JRaw(stamp, pts.copy(), times.copy()), TRaw(stamp, pts.copy(), times.copy())
        assert tt.process(rt) == tj.process(rj)
        assert rt.stamp == rj.stamp
        np.testing.assert_array_equal(rt.times, rj.times)
    for s in (0.0, 0.005, 0.004, 0.01, 0.3):
        assert tt.validate_imu_stamp(s) == tj.validate_imu_stamp(s)


def test_lie_np_is_equal():
    from glim_tpu.ops import lie_np as j_lie
    from glim_tpu_torch.ops import lie_np as t_lie

    rng = np.random.default_rng(6)
    for xi in rng.normal(size=(16, 6)) * [1, 1, 1, 3, 3, 3]:
        T = t_lie.se3_exp(xi)
        np.testing.assert_array_equal(T, j_lie.se3_exp(xi))
        np.testing.assert_array_equal(t_lie.se3_log(T), j_lie.se3_log(T))
        np.testing.assert_array_equal(t_lie.se3_inverse(T), j_lie.se3_inverse(T))
        np.testing.assert_array_equal(t_lie.rot_to_quat(T[:3, :3]), j_lie.rot_to_quat(T[:3, :3]))
        np.testing.assert_array_equal(t_lie.se3_adjoint(T), j_lie.se3_adjoint(T))
        np.testing.assert_array_equal(t_lie.se3_interpolate(np.eye(4), T, 0.3),
                                      j_lie.se3_interpolate(np.eye(4), T, 0.3))


def test_interpolation_helper_is_equal():
    """The port's InterpolationHelper against the JAX package's on the same
    stamps: the same tri-state results and brackets, exactly."""
    from glim_tpu.utils.interpolation import InterpolationHelper as JHelper
    from glim_tpu_torch.utils.interpolation import InterpolationHelper as THelper

    rng = np.random.default_rng(7)
    stamps = np.cumsum(rng.uniform(0.01, 0.1, 40))
    hj, ht = JHelper(), THelper()
    for t in stamps:
        hj.add(t, t * 10.0)
        ht.add(t, t * 10.0)
    queries = np.concatenate([[stamps[0] - 0.5, stamps[-1] + 0.5], stamps[[0, 7, 39]],
                              rng.uniform(stamps[0], stamps[-1], 20)])
    for q in queries:
        sj, sr = hj.find(q), ht.find(q)
        assert sr[0].name == sj[0].name and sr[1:] == sj[1:]
    for cut, margin in ((stamps[10], 1), (stamps[20] + 1e-3, 2)):
        hj.erase_before(cut, margin)
        ht.erase_before(cut, margin)
        assert (len(ht), ht.leftmost_time(), ht.rightmost_time()) == \
            (len(hj), hj.leftmost_time(), hj.rightmost_time())


@pytest.mark.parametrize("model", ["plumb_bob", "fisheye", "none"])
def test_camera_model_is_equal(model, tmp_path):
    """The port's CameraModel against the JAX package's: projection,
    distortion and its inverse, LiDAR extrinsics and from_config, equal to
    f64 rounding (atol 1e-12: the same numpy expressions)."""
    from glim_tpu.utils.camera import CameraModel as JCam
    from glim_tpu.utils.config import GlobalConfig as JGC
    from glim_tpu.utils.config import create_default_config_dir as j_create
    from glim_tpu_torch.utils.camera import CameraModel as TCam
    from glim_tpu_torch.utils.config import GlobalConfig as TGC
    from glim_tpu_torch.utils.config import create_default_config_dir as t_create

    rng = np.random.default_rng(8)
    coeffs = {"plumb_bob": [-0.02, 0.005, 0.001, -0.002, 0.0001],
              "fisheye": [0.01, -0.002, 0.0005, 0.0001], "none": [0.0] * 5}[model]
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.05, 0.02]
    kw = dict(intrinsics=np.array([500.0, 510.0, 320.0, 240.0]), distortion_model=model,
              distortion_coeffs=np.array(coeffs), image_size=(640, 480), T_lidar_camera=T)
    mj, mt = JCam(**kw), TCam(**kw)
    pts = np.stack([rng.uniform(-3, 3, 300), rng.uniform(-2, 2, 300),
                    rng.uniform(-1, 10, 300)], 1)
    for a, b in zip(mt.project(pts), mj.project(pts)):
        np.testing.assert_allclose(a, b, atol=F64_ATOL)
    for a, b in zip(mt.project_lidar(pts), mj.project_lidar(pts)):
        np.testing.assert_allclose(a, b, atol=F64_ATOL)
    xn = rng.uniform(-0.5, 0.5, (100, 2))
    np.testing.assert_allclose(mt.distort(xn), mj.distort(xn), atol=F64_ATOL)
    np.testing.assert_allclose(mt.undistort(xn), mj.undistort(xn), atol=F64_ATOL)
    uv = rng.uniform(0, 480, (50, 2))
    np.testing.assert_allclose(mt.unproject(uv), mj.unproject(uv), atol=F64_ATOL)
    np.testing.assert_allclose(mt.unproject(uv, np.full(50, 2.0)),
                               mj.unproject(uv, np.full(50, 2.0)), atol=F64_ATOL)

    try:
        cj = JGC.instance(j_create(str(tmp_path / "j")), override=True).get_config("config_sensors")
        ct = TGC.instance(t_create(str(tmp_path / "t")), override=True).get_config("config_sensors")
        fj, ft = JCam.from_config(cj), TCam.from_config(ct)
        for name in ("intrinsics", "distortion_coeffs", "T_lidar_camera"):
            np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name))
        assert (ft.distortion_model, ft.image_size, ft.global_shutter) == \
            (fj.distortion_model, fj.image_size, fj.global_shutter)
    finally:
        JGC.reset()
        TGC.reset()
