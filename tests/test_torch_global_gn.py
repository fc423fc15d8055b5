"""global_gn, the global back-end's damped Gauss-Newton, against the JAX
package's on one problem with every branch switched on: matching rows with
cached correspondences (and padded rows), between factors with full
information, IMU endpoint factors with junction states, the prior on the
first pose, a gravity anchor, a translation prior, per-pose recovery
damping and the damped padded pose slots.

The problem is built with numpy from a seed; both packages get the same
arrays (the port through ``state.global_gn_args_from_numpy``). Tolerances:
poses at 2e-4 (m and rad), junction states at 1e-3, err at rtol 1e-3,
min_diag at 1e-4 of its scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.mapping.global_factors import global_gn as j_global_gn
from glim_tpu.ops import imu as j_imu
from glim_tpu.ops import lie_np
from glim_tpu.ops.imu import PreintegratedImu as JPreint
from glim_tpu_torch import state as t_state
from glim_tpu_torch.mapping import global_factors as t_gf

DIMS = dict(Sp=8, Fp=16, Bp=8, Jp=8, Ap=8, Tp=8)
S, M = 5, 256


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def _spd(rng, n, scale):
    A = rng.normal(size=(n, 3, 3)) * scale
    return (A @ A.transpose(0, 2, 1) + 0.1 * scale ** 2 * np.eye(3)).astype(np.float32)


def _problem(seed=0):
    """Five submap poses on a yaw-only path, the last two perturbed;
    matching rows whose correspondences come from the true poses; between,
    IMU, gravity and translation factors consistent with the truth.

    The IMU factors join poses that start at the truth: a junction state
    (velocities at both ends and one bias) has three directions that no
    residual of its factor sees, held only by the 1e-4 regularization, so a
    large step there is set by f32 rounding in either package."""
    rng = np.random.default_rng(seed)
    Sp, Fp, Bp, Jp, Ap, Tp = (DIMS[k] for k in ("Sp", "Fp", "Bp", "Jp", "Ap", "Tp"))
    true = [lie_np.se3_exp(np.array([0, 0, 0.1 * k, 2.0 * k, 0.3 * k, 0.0])) for k in range(S)]
    init = true[:3] + [T @ lie_np.se3_exp(rng.normal(0, [0.01, 0.01, 0.02, 0.1, 0.1, 0.05]))
                       for T in true[3:]]
    poses0 = np.tile(np.eye(4, dtype=np.float32), (Sp, 1, 1))
    poses0[:S] = np.asarray(init, np.float32)

    sm_pts = np.zeros((Sp, M, 3), np.float32)
    sm_pts[:S] = rng.uniform(-10, 10, (S, M, 3))
    sm_covs = np.zeros((Sp, M, 3, 3), np.float32)
    sm_covs[:S] = _spd(rng, S * M, 0.05).reshape(S, M, 3, 3)
    pairs = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 2), (1, 3)]
    L = 2
    rows = [p for p in pairs for _ in range(L)]
    f_tgt = np.zeros(Fp, np.int32)
    f_src = np.zeros(Fp, np.int32)
    f_w = np.zeros(Fp, np.float32)
    f_mu = np.zeros((Fp, M, 3), np.float32)
    f_ct = np.zeros((Fp, M, 3, 3), np.float32)
    f_hit = np.zeros((Fp, M), bool)
    for r, (t, s) in enumerate(rows):
        f_tgt[r], f_src[r], f_w[r] = t, s, 1.0
        T_rel = np.linalg.inv(true[t]) @ true[s]
        f_mu[r] = sm_pts[s] @ T_rel[:3, :3].T + T_rel[:3, 3] + rng.normal(0, 0.01, (M, 3))
        f_ct[r] = _spd(rng, M, 0.05)
        f_hit[r] = rng.uniform(size=M) < 0.8
    f_hit[len(rows)] = True        # a padded row (f_w = 0) must contribute nothing

    b_ij = [(0, 1), (2, 3), (1, 4)]
    b_i = np.zeros(Bp, np.int32)
    b_j = np.zeros(Bp, np.int32)
    b_Z = np.tile(np.eye(4, dtype=np.float32), (Bp, 1, 1))
    b_info = np.tile(np.eye(6, dtype=np.float32), (Bp, 1, 1))
    b_valid = np.zeros(Bp, bool)
    for k, (i, j) in enumerate(b_ij):
        b_i[k], b_j[k], b_valid[k] = i, j, True
        b_Z[k] = np.linalg.inv(true[i]) @ true[j] @ lie_np.se3_exp(rng.normal(0, 1e-3, 6))
        A = rng.normal(size=(6, 6))
        b_info[k] = A @ A.T + 50.0 * np.eye(6)

    # IMU endpoint factors: 0.1 s of standstill-like samples between submap
    # i's right endpoint and submap j's left one, both at one world pose.
    m_ij = [(0, 1), (1, 2)]
    m_i = np.zeros(Jp, np.int32)
    m_j = np.zeros(Jp, np.int32)
    m_AR = np.tile(np.eye(4, dtype=np.float32), (Jp, 1, 1))
    m_AL = np.tile(np.eye(4, dtype=np.float32), (Jp, 1, 1))
    m_valid = np.zeros(Jp, bool)
    junc0 = np.zeros((Jp, 12), np.float32)
    pres = []
    n = 32
    for k, (i, j) in enumerate(m_ij):
        m_i[k], m_j[k], m_valid[k] = i, j, True
        T_end = true[j] @ lie_np.se3_exp(np.array([0, 0, 0.05, -0.4, 0.1, 0.0]))
        m_AR[k] = np.linalg.inv(true[i]) @ T_end
        m_AL[k] = np.linalg.inv(true[j]) @ T_end
        junc0[k] = rng.normal(0, 1e-3, 12)
        acc = (T_end[:3, :3].T @ np.array([0, 0, 9.80665]) + rng.normal(0, 0.01, (n, 3)))
        pres.append(j_imu.preintegrate(
            jnp.asarray(acc, jnp.float32), jnp.asarray(rng.normal(0, 0.01, (n, 3)), jnp.float32),
            jnp.full(n, 0.1 / n, jnp.float32), jnp.ones(n, bool),
            jnp.zeros(6, jnp.float32), jnp.float32(0.05), jnp.float32(0.02),
            jnp.float32(0.001)))
    zero = dict(dR=np.eye(3), dv=np.zeros(3), dp=np.zeros(3), dt=np.zeros(()),
                H_Rg=np.zeros((3, 3)), H_va=np.zeros((3, 3)), H_vg=np.zeros((3, 3)),
                H_pa=np.zeros((3, 3)), H_pg=np.zeros((3, 3)), cov=np.zeros((9, 9)),
                bias=np.zeros(6))
    m_pre = {k: np.stack([np.asarray(getattr(p, k)) for p in pres]
                         + [z] * (Jp - len(pres))).astype(np.float32) for k, z in zero.items()}

    grav_idx = np.zeros(Ap, np.int32)
    grav_idx[0] = 3
    grav_valid = np.zeros(Ap, bool)
    grav_valid[0] = True
    t_idx = np.zeros(Tp, np.int32)
    t_idx[0] = 4
    t_pos = np.zeros((Tp, 3), np.float32)
    t_pos[0] = true[4][:3, 3] + np.array([0.02, -0.01, 0.0])
    t_sqrt = np.zeros((Tp, 3), np.float32)
    t_sqrt[0] = 30.0
    t_valid = np.zeros(Tp, bool)
    t_valid[0] = True
    damping = np.full(Sp, 1e-3, np.float32)
    damping[:S] = 0.0
    damping[2] = 50.0              # recovery damping on one pose
    return dict(
        poses0=poses0, junc0=junc0, f_tgt=f_tgt, f_src=f_src, f_w=f_w, f_mu=f_mu, f_ct=f_ct,
        f_hit=f_hit, sm_pts=sm_pts, sm_covs=sm_covs, b_i=b_i, b_j=b_j, b_Z=b_Z,
        b_info=b_info, b_valid=b_valid, m_i=m_i, m_j=m_j, m_AR=m_AR, m_AL=m_AL,
        m_pre=m_pre, m_valid=m_valid, prior_T=np.asarray(true[0], np.float32),
        prior_sqrt=np.full(6, 1e5, np.float32), grav_idx=grav_idx, grav_valid=grav_valid,
        grav_sqrt=np.float32(1e4), damping=damping,
        gravity=np.array([0, 0, -9.80665], np.float32),
        matching_weight=np.float32(1e-3), t_idx=t_idx, t_pos=t_pos, t_sqrt=t_sqrt,
        t_valid=t_valid), true


def _jax_args(d):
    out = {k: (None if v is None else jnp.asarray(v)) for k, v in d.items() if k != "m_pre"}
    out["m_pre"] = JPreint(**{k: jnp.asarray(v) for k, v in d["m_pre"].items()})
    return out


@pytest.mark.parametrize("iters", [1, 5])
def test_global_gn_matches_jax(iters):
    d, true = _problem()
    T_j, junc_j, err_j, md_j = (np.asarray(x) for x in j_global_gn(**_jax_args(d), **DIMS,
                                                                   iters=iters))
    args = t_state.global_gn_args_from_numpy(d, "cpu")
    assert args["f_tgt"].dtype == torch.int32 and args["f_w"].dtype == torch.float32
    T_t, junc_t, err_t, md_t = (x.numpy() for x in t_gf.global_gn(**args, **DIMS,
                                                                  iters=iters))
    assert T_t.shape == (DIMS["Sp"], 4, 4) and junc_t.shape == (DIMS["Jp"], 12)
    for k in range(DIMS["Sp"]):
        d_rot = lie_np.so3_log(T_t[k, :3, :3].astype(np.float64).T @ T_j[k, :3, :3])
        assert np.abs(d_rot).max() < 2e-4, (k, d_rot)
        np.testing.assert_allclose(T_t[k, :3, 3], T_j[k, :3, 3], atol=2e-4)
    np.testing.assert_allclose(junc_t, junc_j, atol=1e-3)
    np.testing.assert_allclose(err_t, err_j, rtol=1e-3)
    finite = np.isfinite(md_j)
    np.testing.assert_array_equal(np.isfinite(md_t), finite)
    np.testing.assert_allclose(md_t[finite], md_j[finite],
                               atol=1e-4 * max(1.0, np.abs(md_j[finite]).max()))
    if iters == 5:
        # The solve really moved the perturbed poses toward the truth.
        err0 = np.linalg.norm(d["poses0"][3:5, :3, 3] - np.stack([T[:3, 3] for T in true[3:]]))
        err1 = np.linalg.norm(T_t[3:5, :3, 3] - np.stack([T[:3, 3] for T in true[3:]]))
        assert err1 < 0.5 * err0, (err0, err1)


def test_global_gn_stops_at_the_convergence_gate(monkeypatch):
    """Once max |delta| < 1e-4 the remaining iterations are skipped (one
    host read of the flag an iteration): a problem already at its optimum
    linearizes once or twice, not ``iters`` times."""
    d, _ = _problem()
    args = t_state.global_gn_args_from_numpy(d, "cpu")
    calls = []
    real = t_gf.solver.solve_damped
    monkeypatch.setattr(t_gf.solver, "solve_damped",
                        lambda *a: calls.append(1) or real(*a))
    T1, junc1, _, _ = t_gf.global_gn(**args, **DIMS, iters=20)
    n_first = len(calls)
    assert n_first < 20
    args.update(poses0=T1, junc0=junc1)
    calls.clear()
    t_gf.global_gn(**args, **DIMS, iters=20)
    assert len(calls) <= 2


def test_pad_stack_and_state_converter():
    d, _ = _problem()
    args = t_state.global_gn_args_from_numpy(d, "cpu")
    assert args["m_pre"].cov.shape == (DIMS["Jp"], 9, 9) and args["f_hit"].dtype == torch.bool
    out = t_gf.pad_stack([np.eye(4), np.eye(4) * 2], 8, np.eye(4, dtype=np.float32), "cpu")
    assert out.dtype == torch.float32 and out.shape == (8, 4, 4)
    np.testing.assert_array_equal(out[1].numpy(), np.eye(4) * 2)
    np.testing.assert_array_equal(out[5].numpy(), np.eye(4))
    dev = t_gf.pad_stack([torch.ones(3)], 4, torch.zeros(3), "cpu")
    np.testing.assert_array_equal(dev.numpy(), [[1, 1, 1], [0, 0, 0], [0, 0, 0], [0, 0, 0]])
    assert [t_gf.bucket(n) for n in (1, 8, 9, 4096, 4097)] == [8, 8, 16, 4096, 5120]
