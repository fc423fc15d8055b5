"""The port's continuous-time odometry (``odometry_estimation_ct``) against
the JAX package's.

The same numpy inputs, made from a seed, go through both packages:
``_ct_linearize`` and ``_pose_prior_12`` on random systems (at 1e-4 of the
largest entry), one ``_ct_scan_step`` from the JAX module's carried state
(``torch_parity.ct_state``) for both model kinds, with and without
``anchor_begin`` and once with ``rigid_refine``, with the model update's
uniforms drawn by JAX and injected into the port (poses and twist at
POSE_ATOL), and an 8-scan skewed sequence through both modules built from
the shipped config_odometry_ct.json (``location_consistency_inf_scale``
1e-3), compared on the aligned ATE within 10% or 2 mm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (POSE_ATOL, carry_ct_state, ct_state, port_frame, scaled,
                          use_jax_covariances)

from glim_tpu.io.synthetic import ate_rmse, generate_sequence
from glim_tpu.odometry import odometry_estimation_ct as jct
from glim_tpu.ops import gicp as j_gicp
from glim_tpu.ops import lie as j_lie
from glim_tpu.preprocess.cloud_preprocessor import (CloudPreprocessor,
                                                    CloudPreprocessorParams)
from glim_tpu.utils.config import Config as JConfig
from glim_tpu_torch.odometry import odometry_estimation_ct as tct
from glim_tpu_torch.ops import gicp as t_gicp
from glim_tpu_torch.utils.config import Config as TConfig
from glim_tpu_torch.utils.default_config import DEFAULT_CONFIGS

CAPACITY = 16384
WARM_SCANS = 6          # scans before the compared step (the replay is past)
ATE_REL, ATE_ABS = 0.10, 0.002


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


@pytest.fixture(scope="module")
def frames():
    """Eight skewed scans of ~1000 points (seed 29) and their JAX
    preprocessed frames."""
    seq = generate_sequence(duration=0.8, n_scan_points=1500, scene_points=20000, seed=29,
                            skew=True)
    pp = CloudPreprocessor(CloudPreprocessorParams(random_downsample_target=1000,
                                                   downsample_resolution=0.4))
    return seq, [pp.preprocess(raw) for raw in seq.scans]


def _params(pkg, kind):
    """The shipped config_odometry_ct.json through the package's
    from_config, with the model kind and a small model capacity."""
    cfg = dict(DEFAULT_CONFIGS["config_odometry_ct.json"])
    cfg["odometry_estimation"] = dict(cfg["odometry_estimation"], model_type=kind)
    Config = JConfig if pkg is jct else TConfig
    p = pkg.OdometryEstimationCTParams.from_config(Config(cfg))
    p.model_capacity = CAPACITY
    return p


_SCENARIOS = {}


def _scenario(kind, frames):
    """The JAX module after WARM_SCANS scans: its state as numpy and the
    next frame (cached per model kind)."""
    if kind not in _SCENARIOS:
        odom = jct.OdometryEstimationCT(_params(jct, kind))
        for f in frames[:WARM_SCANS]:
            odom.insert_frame(f)
        _SCENARIOS[kind] = (odom.params, ct_state(odom), frames[WARM_SCANS])
    return _SCENARIOS[kind]


def test_shipped_config_and_registry():
    """from_config reads what the JAX one reads, and vgicp_scaling too; the
    registry builds the module from the shipped config."""
    from glim_tpu_torch.utils.registry import load_module

    cfg = dict(DEFAULT_CONFIGS["config_odometry_ct.json"])
    pj = jct.OdometryEstimationCTParams.from_config(JConfig(cfg))
    pt = tct.OdometryEstimationCTParams.from_config(TConfig(cfg))
    assert vars(pt) == vars(pj)
    assert pt.location_consistency_inf_scale == 1e-3 and pt.model_type == "vgicp"
    cfg["odometry_estimation"] = dict(cfg["odometry_estimation"], vgicp_scaling=3.0)
    assert tct.OdometryEstimationCTParams.from_config(TConfig(cfg)).vgicp_scaling == 3.0
    odom = load_module("odometry", "libodometry_estimation_ct.so", TConfig(cfg), device="cpu")
    assert isinstance(odom, tct.OdometryEstimationCT) and not odom.requires_imu()
    assert [float(vm.resolution) for vm in odom.model] == pytest.approx([0.3, 0.9])


def _rand_se3(rng, scale):
    return np.asarray(j_lie.se3_exp(jnp.asarray(rng.normal(size=6) * scale, jnp.float32)))


def _spd(rng, n):
    A = rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.1
    return (A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3, dtype=np.float32)).astype(np.float32)


def test_ct_linearize_and_pose_prior():
    rng = np.random.default_rng(7)
    n = 300
    T_b, T_e = _rand_se3(rng, 0.3), _rand_se3(rng, 0.3)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 5
    s = rng.uniform(size=n).astype(np.float32)
    mu = pts + rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    covs, C_t = _spd(rng, n), _spd(rng, n)
    hit = rng.uniform(size=n) > 0.2
    args = (T_b, T_e, pts, covs, s, mu, C_t, hit)
    out_j = jct._ct_linearize(*map(jnp.asarray, args))
    out_t = tct._ct_linearize(*map(torch.as_tensor, args))
    for a, b in zip(out_t, out_j):
        scaled(a.numpy(), np.asarray(b))
    A = _rand_se3(rng, 0.05) @ T_b
    for offset in (0, 6):
        out_j = jct._pose_prior_12(jnp.asarray(T_b), jnp.asarray(A), jnp.float32(1e3), offset)
        out_t = tct._pose_prior_12(torch.as_tensor(T_b), torch.as_tensor(A), 1e3, offset)
        for a, b in zip(out_t, out_j):
            scaled(a.numpy(), np.asarray(b))
    A = np.asarray(j_gicp.inv_sym3x3(jnp.asarray(covs)))
    scaled(t_gicp.inv_sym3x3(torch.as_tensor(covs)).numpy(), A)


@pytest.mark.parametrize("kind, rigid_refine, anchor_begin", [
    ("vgicp", False, False), ("vgicp", False, True),
    ("ivox", False, False), ("ivox", True, False)])
def test_ct_scan_step(frames, kind, rigid_refine, anchor_begin, monkeypatch):
    """One step from the same carried-in state, with the JAX package's scan
    covariances (``torch_parity.use_jax_covariances``): one point of this
    scan has a near-zero eigengap, which alone moves the 12-dof solve by a
    few 1e-4 m."""
    p, st, f = _scenario(kind, frames[1])
    use_jax_covariances(monkeypatch)
    key = jax.random.PRNGKey(3)
    C = int(f.device_points.shape[0])
    uniforms = np.asarray(jax.random.uniform(key, (C,)))
    jm = (tuple(jct.vmx.GaussianVoxelMap(**{k: jnp.asarray(v) for k, v in lv.items()})
                for lv in st["model"]) if kind == "vgicp"
          else jct.vmx.PointVoxelMap(**{k: jnp.asarray(v) for k, v in st["model"].items()}))
    kw = dict(iters=p.lm_max_iterations, bootstrap_frames=p.bootstrap_frames,
              update_budget=p.update_budget, model_kind=kind, rigid_refine=rigid_refine,
              anchor_begin=anchor_begin)
    out_j = jct._ct_scan_step(
        jnp.asarray(st["T_prev_end"]), jnp.asarray(st["twist"]), jnp.int32(st["step"]), jm,
        f.device_points, f.device_times, f.device_mask, f.device_neighbors, jnp.float32(0.1),
        key, jnp.float32(p.max_correspondence_distance),
        jnp.float32(p.location_consistency_inf_scale),
        jnp.float32(p.constant_velocity_inf_scale), jnp.float32(p.extrapolation_damping), **kw)

    todom = carry_ct_state(st, tct.OdometryEstimationCT(_params(tct, kind), device="cpu"))
    tf = port_frame(f)
    out_t = tct._ct_scan_step(
        todom.T_prev_end, todom.twist, todom.frame_count, todom.model, tf.device_points,
        tf.device_times, tf.device_mask, tf.device_neighbors, torch.tensor(0.1),
        torch.as_tensor(uniforms), p.max_correspondence_distance,
        p.location_consistency_inf_scale, p.constant_velocity_inf_scale,
        p.extrapolation_damping, **kw)
    for name, i in (("T_b", 0), ("T_e", 1), ("twist", 2), ("deskewed", 4)):
        np.testing.assert_allclose(out_t[i].numpy(), np.asarray(out_j[i]), atol=POSE_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(out_t[7].numpy(), np.asarray(out_j[7]), rtol=1e-2)
    if anchor_begin:
        np.testing.assert_array_equal(out_t[0].numpy(), st["T_prev_end"])
    # The model took the same update: the same number of valid entries.
    valid = (lambda m: sum(int(np.asarray(vm.hash != 0x7FFFFFFF).sum()) for vm in m)) \
        if kind == "vgicp" else (lambda m: int(np.asarray(m.mask).sum()))
    assert abs(valid(out_t[3]) - valid(out_j[3])) <= 0.01 * valid(out_j[3])


@pytest.mark.parametrize("kind", ["vgicp", "ivox"])
def test_ct_sequence_matches_jax(frames, kind):
    """Eight scans through both modules (the bootstrap replay included):
    finite poses, the aligned ATE within 10% or 2 mm of the JAX module's,
    and the last scan's begin-to-end motion within 2 mm of the JAX one."""
    seq, fs = frames
    jo = jct.OdometryEstimationCT(_params(jct, kind))
    to = tct.OdometryEstimationCT(_params(tct, kind), device="cpu")
    j_est = [jo.insert_frame(f) for f in fs]
    t_est = [to.insert_frame(port_frame(f)) for f in fs]
    assert to._boot_done and not to._boot and to.frame_count == len(fs)
    gt = [seq.gt_poses[int(round(e.stamp * 10))] for e in t_est]
    ate_j = ate_rmse([e.T_world_lidar for e in j_est], gt, align=True)
    poses = [e.T_world_lidar for e in t_est]
    assert all(np.all(np.isfinite(T)) for T in poses)
    ate_t = ate_rmse(poses, gt, align=True)
    assert abs(ate_t - ate_j) <= max(ATE_REL * ate_j, ATE_ABS), (ate_t, ate_j)
    assert ate_t < 0.2
    motion = [np.linalg.norm(np.asarray(e.custom_data["T_world_lidar_end"])[:3, 3]
                             - e.T_world_lidar[:3, 3]) for e in (to.frames[-1], jo.frames[-1])]
    assert motion[0] == pytest.approx(motion[1], abs=ATE_ABS)
