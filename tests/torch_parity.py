"""Helpers shared by the port's parity tests (tests/test_torch_*.py): numpy
snapshots of either package's dataclass state, and the comparison of one
odometry step's outputs between the packages.

Step tolerances: poses, velocities and biases at atol 1e-4 (f32 GN solves
over a window of 15-dof states, whose correspondence sets and sums are
taken in another order); Hessian-like fields at 1e-4 of the field's largest
entry (matching blocks reach ~1e5); booleans and counters exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from glim_tpu.odometry import window_estimator as j_we
from glim_tpu.ops.imu import PreintegratedImu as JPreint

POSE_ATOL = 1e-4

# The default configuration cut to the CPU tests' size: a 6-state window,
# small voxel maps, 1000 points a scan, 4 keyframes a submap.
SMALL_DEFAULT_OVERRIDES = [
    ("config_odometry", "odometry_estimation", "window_size", 6),
    ("config_odometry", "odometry_estimation", "voxel_capacity", 16384),
    ("config_odometry", "odometry_estimation", "initialization_window_size", 0.3),
    ("config_preprocess", "preprocess", "random_downsample_target", 1000),
    ("config_preprocess", "preprocess", "downsample_resolution", 0.4),
    ("config_sub_mapping", "sub_mapping", "max_num_keyframes", 4),
]


def np_state(obj):
    """Dataclass (either package) -> nested dict of numpy arrays."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = np_state(v) if dataclasses.is_dataclass(v) else (
            None if v is None else np.asarray(v))
    return out


def jax_window(d):
    kw = {k: jnp.asarray(v) for k, v in d.items() if k != "preints"}
    return j_we.WindowState(preints=JPreint(**{k: jnp.asarray(v) for k, v in d["preints"].items()}),
                            **kw)


def scaled(a, b, rel=1e-4):
    np.testing.assert_allclose(a, b, atol=rel * max(1.0, float(np.abs(b).max())))


def compare_step(wt, out_t, wj, out_j, stiff=()):
    """One window step of the port (numpy window ``wt``, torch outputs
    ``out_t``) against the JAX package's (``wj``, ``out_j``).

    ``stiff`` names gradient fields ("b_marg", "b_prior") compared to first
    order instead: a gradient evaluated at states that differ by dx differs
    by up to |H| dx, with H the field's Hessian and dx the largest state
    difference (T, v, b) of the two windows; through a stiff IMU factor
    (|H| ~ 1e8) an f32-level dx of 1e-6 moves such a gradient by ~1."""
    np.testing.assert_allclose(out_t["T_wi"].cpu().numpy(), out_j["T_wi"], atol=POSE_ATOL)
    np.testing.assert_allclose(out_t["T_wl"].cpu().numpy(), out_j["T_wl"], atol=POSE_ATOL)
    st, sj = out_t["status"].cpu().numpy(), out_j["status"]
    assert st.shape == sj.shape == (j_we.STATUS_LEN,)
    assert st[j_we.STATUS_FINITE] == sj[j_we.STATUS_FINITE] == 1.0
    assert st[j_we.STATUS_MARGINALIZED] == sj[j_we.STATUS_MARGINALIZED]
    np.testing.assert_allclose(st[j_we.STATUS_POSES:], sj[j_we.STATUS_POSES:], atol=POSE_ATOL)
    np.testing.assert_allclose(st[j_we.STATUS_OVERLAP], sj[j_we.STATUS_OVERLAP], atol=5e-3)
    np.testing.assert_allclose(st[j_we.STATUS_ERR], sj[j_we.STATUS_ERR], rtol=1e-2)
    np.testing.assert_allclose(st[j_we.STATUS_DTRANS:j_we.STATUS_POSES],
                               sj[j_we.STATUS_DTRANS:j_we.STATUS_POSES], atol=POSE_ATOL)
    for k in ("valid", "mask", "m_valid", "step"):
        np.testing.assert_array_equal(wt[k], wj[k], err_msg=k)
    for k in ("T", "v", "b", "stamp", "m_Tlin", "T_anchor", "v_anchor", "b_anchor", "pts"):
        np.testing.assert_allclose(wt[k], wj[k], atol=POSE_ATOL, err_msg=k)
    for k in ("covs", "m_H", "m_g", "m_e", "H_prior", "b_prior", "H_marg", "b_marg"):
        if k not in stiff:
            scaled(wt[k], wj[k])
    dx = max(float(np.abs(wt[k] - wj[k]).max()) for k in ("T", "v", "b"))
    for k in stiff:
        H = wj["H" + k[1:]]
        bound = np.abs(H).sum(axis=1) * dx + 1e-4 * max(1.0, float(np.abs(wj[k]).max()))
        assert np.all(np.abs(wt[k] - wj[k]) <= bound), k
    for k, v in wj["preints"].items():
        scaled(wt["preints"][k], v)


def port_frame(jf, device="cpu"):
    """A JAX ``PreprocessedFrame`` as the port's, its device arrays copied
    through numpy onto ``device``."""
    import torch

    from glim_tpu_torch.types import PreprocessedFrame

    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    return PreprocessedFrame(stamp=jf.stamp, scan_end_time=jf.scan_end_time,
                             k_neighbors=jf.k_neighbors, device_points=t(jf.device_points),
                             device_times=t(jf.device_times), device_mask=t(jf.device_mask),
                             device_neighbors=t(jf.device_neighbors))


def ct_state(j_odom):
    """The JAX CT module's carried state as numpy: the previous scan's end
    pose, the twist, the frame counter and the model (a tuple of Gaussian
    voxel-map dicts for ``model_type`` vgicp, a point-map dict for ivox)."""
    model = (tuple(np_state(vm) for vm in j_odom.model)
             if j_odom.model_kind == "vgicp" else np_state(j_odom.model))
    return dict(T_prev_end=np.asarray(j_odom.T_prev_end), twist=np.asarray(j_odom.twist),
                step=j_odom.frame_count, model=model)


def carry_ct_state(d, t_odom):
    """Load ``ct_state``'s numpy state into the port's CT module."""
    import torch

    from glim_tpu_torch import state as t_state

    dev = t_odom.device
    t_odom.T_prev_end = torch.as_tensor(d["T_prev_end"], device=dev)
    t_odom.twist = torch.as_tensor(d["twist"], device=dev)
    t_odom.frame_count = d["step"]
    t_odom.model = (t_state.voxelmap_levels_from_numpy(d["model"], dev)
                    if t_odom.model_kind == "vgicp"
                    else t_state.point_voxelmap_from_numpy(d["model"], dev))
    return t_odom


def use_jax_covariances(monkeypatch):
    """Make the port's ``covariance.estimate_covariances`` return the JAX
    package's result for the same inputs, for the duration of a test. Where
    a point's covariance has a near-zero eigengap, the two packages'
    eigenvectors differ by f32 rounding over the gap (the op's own parity
    test, tests/test_torch_ops.py, compares at atol 1e-4 on scans without
    such points); a module's step test takes them out of the comparison
    this way."""
    import torch

    from glim_tpu.ops import covariance as j_cov
    from glim_tpu_torch.ops import covariance as t_cov

    def jax_covs(points, mask, neighbors, regularization="plane", *args, **kwargs):
        out = j_cov.estimate_covariances(*(jnp.asarray(a.cpu().numpy())
                                           for a in (points, mask, neighbors)),
                                         regularization, *args, **kwargs)
        return tuple(torch.as_tensor(np.asarray(o), device=points.device) for o in out)

    monkeypatch.setattr(t_cov, "estimate_covariances", jax_covs)


def use_jax_nn_search(monkeypatch, module):
    """Make ``module.nn_search`` (the port's k=1 search, as ``module``
    imported it) return the JAX package's ``nn_search`` for the same
    inputs, for the duration of a test. On point clouds near a lattice many
    queries have two targets whose squared distances differ by less than the
    two packages' rounding of |q|^2 + |t|^2 - 2 q.t (a few 1e-6 m^2), and a
    flipped correspondence moves a GICP Hessian by one point's share; a
    module test takes the search out of the comparison this way (the op's
    own parity tests compare it on decisive queries)."""
    import torch

    from glim_tpu.ops.pallas_knn import nn_search as j_nn_search

    def jax_nn(q, qm, t, tm):
        idx, d2 = j_nn_search(*(jnp.asarray(a.cpu().numpy()) for a in (q, qm, t, tm)))
        return (torch.as_tensor(np.asarray(idx), device=q.device),
                torch.as_tensor(np.asarray(d2), device=q.device))

    monkeypatch.setattr(module, "nn_search", jax_nn)
