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


def compare_step(wt, out_t, wj, out_j):
    """One window step of the port (numpy window ``wt``, torch outputs
    ``out_t``) against the JAX package's (``wj``, ``out_j``)."""
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
        scaled(wt[k], wj[k])
    for k, v in wj["preints"].items():
        scaled(wt["preints"][k], v)
