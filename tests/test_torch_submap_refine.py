"""Sub-mapping's batch refinement and GICP between factors in the port
(``mapping/submap_refine.py``, ``SubMapping`` with ``enable_optimization``
and ``create_between_factors``) against the JAX package's.

The frames are tests/test_torch_sub_mapping.py's (three keyframes a
submap), with both options on and the refinement cut to one outer and two
inner iterations (the shipped 3 x 3 compiles for minutes in JAX on the
CPU). On that harness's lattice clouds many queries have two targets whose
squared distances differ by less than the packages' rounding, and one
flipped correspondence moves a between information by a point's share, so
the sub-mapping comparison runs the port with the JAX k=1 search
(``torch_parity.use_jax_nn_search``); ``_between_info_gicp`` itself is held
to JAX with the port's own search on decisive clouds (H at 1e-4 of its
scale, the inlier count exact).

- One linearization (H, g, err) of the JAX refinement's first inputs:
  the port's dense system against the JAX package's factor functions
  assembled here, at 1e-4 of each part's scale.
- ``submap_refine`` (T, v, b): the tolerance is ten times JAX's own spread
  when the keyframe points are permuted (their sums taken in another
  order). Measured: T 1.3e-6 / 9.5e-7, v 1.9e-6 / 1.3e-6, b 1.2e-10 /
  1.4e-10 on the two submaps; the port was 9.1e-7 / 3.8e-6 (T).
- The whole sub-mapping: keyframes, refined frame states and origins
  within that tolerance, equal merged valid counts, one read from the
  device a refinement.
- The twin of tests/test_submapping_imu.py's recovery of perturbed poses:
  the port recovers at least as well as JAX did on the same data (its mean
  position error 0.002085347 m from 0.102199 m, recorded from the JAX
  test's code path; f32 rounding allowed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_sub_mapping as harness
from torch_parity import use_jax_nn_search

import glim_tpu.mapping.sub_mapping as jsm
import glim_tpu.mapping.submap_refine as jsr
import glim_tpu.odometry.window_estimator as j_we
from glim_tpu import types as jt
from glim_tpu.mapping.callbacks import SubMappingCallbacks as JCB
from glim_tpu.ops import gicp as j_gicp
from glim_tpu.ops import lie_np
import glim_tpu_torch.mapping.sub_mapping as tsm
import glim_tpu_torch.mapping.submap_refine as tsr
from glim_tpu_torch import types as tt
from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks as TCB
from glim_tpu_torch.ops import gicp as t_gicp
from glim_tpu_torch.ops import voxelmap as t_vmx
from glim_tpu_torch.ops.imu import PreintegratedImu as TPreint

SPREAD_FACTOR = 10
_j_prior = jax.jit(jsr._prior_system6)
_j_between = jax.jit(jsr._between_system)
_j_imu = jax.jit(j_we._imu_factor_system)
JAX_RECOVERED_ERR, JAX_INPUT_ERR = 0.002085347197608926, 0.10219931572563458


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def T(a):
    return torch.from_numpy(np.array(a, order="C"))


def scaled(a, b, rel, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, atol=rel * max(1.0, float(np.abs(b).max())), err_msg=name)


def _params(tmp_path):
    p = harness._params(tsm.SubMappingParams, tmp_path)
    p.enable_optimization = p.create_between_factors = True
    p.optimization_outer, p.optimization_inner = 1, 2
    return p


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX sub-mapping over the harness frames, with every
    submap_refine call's inputs and result, and the result of the same
    call with the keyframe points permuted."""
    p = _params(tmp_path_factory.mktemp("cfg"))
    calls = []
    refine = jsm.submap_refine

    def recorded(*args, **kw):
        out = refine(*args, **kw)
        perm = np.random.default_rng(1).permutation(args[9].shape[1])
        permuted = list(args)
        for i in (9, 10, 11):                      # kf_pts, kf_covs, kf_mask
            permuted[i] = args[i][:, perm]
        calls.append((args, kw, out, refine(*permuted, **kw)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsm, "submap_refine", recorded)
        submaps, kfs = harness._run(jt, jsm.SubMapping(jsm.SubMappingParams(**vars(p))), JCB,
                                    harness._frame_data())
    return p, calls, submaps, kfs


def _spread(call, N):
    """(T, v, b) spread of JAX's refinement under the point permutation."""
    _, _, out, out_p = call
    return [float(np.abs(np.asarray(a)[:N] - np.asarray(b)[:N]).max())
            for a, b in zip(out[:3], out_p[:3])]


def _tolerance(jax_run):
    spreads = np.array([_spread(c, len(s.frames)) for c, s in zip(jax_run[1], jax_run[2])])
    return SPREAD_FACTOR * spreads.max(axis=0)


def _port_inputs(args, N):
    """The JAX refinement's padded inputs, cut to the N real frames and K
    real keyframes, as the port's submap_refine takes them."""
    (T0, v0, b0, valid, btd, bti, btv, pre, prv, kf_pts, kf_covs, kf_mask, kf_fidx, kf_valid,
     kf_vms, gravity) = args
    K = int(np.asarray(kf_valid).sum())
    tables = []
    for vms in kf_vms:
        maps = [t_vmx.GaussianVoxelMap(*(T(np.asarray(getattr(vms, f))[k]) for f in (
            "hash", "coords", "mean", "cov", "count", "age", "resolution"))) for k in range(K)]
        keys, stats = zip(*(t_vmx.gaussian_lookup_table(m) for m in maps))
        tables.append((torch.stack(keys), torch.stack(stats),
                       torch.stack([m.resolution for m in maps])))
    pre_t = TPreint(*(T(np.asarray(getattr(pre, f))[:N - 1]) for f in (
        "dR", "dv", "dp", "dt", "H_Rg", "H_va", "H_vg", "H_pa", "H_pg", "cov", "bias")))
    cut = lambda a, n: T(np.asarray(a)[:n])
    return dict(T0=cut(T0, N), v0=cut(v0, N), b0=cut(b0, N), bt_delta=cut(btd, N),
                bt_info=cut(bti, N), bt_valid=cut(btv, N), pre=pre_t,
                pre_valid=cut(prv, N - 1), kf_pts=cut(kf_pts, K), kf_covs=cut(kf_covs, K),
                kf_mask=cut(kf_mask, K), kf_fidx=cut(kf_fidx, K).to(torch.int64),
                tables=tables, gravity=T(np.asarray(gravity)))


def _jax_system(args, N):
    """The refinement's GN system at its initial states, assembled here
    from the JAX package's factor functions."""
    (T0, v0, b0, _, btd, bti, btv, pre, prv, kf_pts, kf_covs, kf_mask, kf_fidx, kf_valid,
     kf_vms, gravity) = args
    D = N * 15
    H, g = np.zeros((D, D)), np.zeros(D)

    def add(i, j, Hb, gb=None):
        H[i, j] += np.asarray(Hb)
        if gb is not None:
            g[i] += np.asarray(gb)

    pose = lambda k: slice(15 * k, 15 * k + 6)
    vel = lambda k: slice(15 * k + 6, 15 * k + 9)
    bias = lambda k: slice(15 * k + 9, 15 * k + 15)
    Hp, gp, err = _j_prior(T0[0], T0[0], jnp.eye(6) * jsr.POSE_PRIOR_INFO)
    add(pose(0), pose(0), Hp, gp)
    err = float(err)
    for k in range(N):
        add(vel(k), vel(k), jsr.VEL_PRIOR_INFO * np.eye(3))
        add(bias(k), bias(k), jsr.BIAS_PRIOR_INFO * np.eye(6))
    for k in range(1, N):
        if bool(btv[k]):
            Hb, gb, eb = _j_between(T0[k - 1], T0[k], btd[k], bti[k])
            Hb, gb = np.asarray(Hb), np.asarray(gb)
            for a, ra in ((0, pose(k - 1)), (1, pose(k))):
                g[ra] += gb[6 * a:6 * a + 6]
                for c, rc in ((0, pose(k - 1)), (1, pose(k))):
                    H[ra, rc] += Hb[6 * a:6 * a + 6, 6 * c:6 * c + 6]
            err += float(eb)
    for k in range(N - 1):
        pre_k = jax.tree_util.tree_map(lambda x: x[k], pre)
        if bool(prv[k]) and float(pre_k.dt) > 1e-6:
            Hi, gi, ei = _j_imu(T0[k], v0[k], T0[k + 1], v0[k + 1], b0[k], pre_k, gravity)
            rows = slice(15 * k, 15 * k + 30)
            H[rows, rows] += np.asarray(Hi)
            g[rows] += np.asarray(gi)
            err += float(ei)
        else:
            for a, c, s in ((k, k, 1), (k + 1, k + 1, 1), (k, k + 1, -1), (k + 1, k, -1)):
                add(vel(a), vel(c), s * jsr.VEL_WALK_INFO * np.eye(3))
        for a, c, s in ((k, k, 1), (k + 1, k + 1, 1), (k, k + 1, -1), (k + 1, k, -1)):
            add(bias(a), bias(c), s * jsr.BIAS_WALK_INFO * np.eye(6))
    K = int(np.asarray(kf_valid).sum())
    fidx = np.asarray(kf_fidx)
    for vms in kf_vms:
        for i in range(K):
            vm_i = jax.tree_util.tree_map(lambda x: x[i], vms)
            for j in range(i + 1, K):
                Tt, Ts = T0[fidx[i]], T0[fidx[j]]
                mu, ct, hit = j_gicp.vgicp_lookup(Tt, Ts, kf_pts[j], kf_mask[j], vm_i)
                s = j_gicp.vgicp_linearize_cached(Tt, Ts, kf_pts[j], kf_covs[j], mu, ct, hit)
                ri, rj = pose(fidx[i]), pose(fidx[j])
                add(ri, ri, s.H_tt, s.b_t)
                add(ri, rj, s.H_ts)
                add(rj, ri, np.asarray(s.H_ts).T)
                add(rj, rj, s.H_ss, s.b_s)
                err += float(s.error)
    return H, g, err


def test_between_info_gicp_matches_jax():
    """The port's own nn_search on decisive clouds (a random cloud seen from
    two poses)."""
    rng = np.random.default_rng(12)
    base = rng.normal(0, 4.0, (4000, 3))
    T_w = [np.eye(4), lie_np.se3_exp(np.array([0.01, 0.02, 0.03, 0.5, -0.2, 0.1]))]
    clouds = []
    for Tk in T_w:
        Ti = np.linalg.inv(Tk)
        pts = np.zeros((2048, 3), np.float32)
        pts[:1500] = ((Ti[:3, :3] @ base[rng.permutation(4000)[:1500]].T).T + Ti[:3, 3]
                      + rng.normal(0, 0.01, (1500, 3)))
        A = rng.normal(size=(2048, 3, 3)).astype(np.float32) * 0.1
        clouds += [pts, (A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3)).astype(np.float32),
                   np.arange(2048) < 1500]
    T_last = np.eye(4, dtype=np.float32)
    T_cur = (T_w[1] @ lie_np.se3_exp(rng.normal(0, 0.01, 6))).astype(np.float32)
    H_t, n_t = tsm._between_info_gicp(T(T_last), T(T_cur), *map(T, clouds), 1.0)
    H_j, n_j = jsm._between_info_gicp(*(jnp.asarray(a) for a in [T_last, T_cur] + clouds),
                                      jnp.float32(1.0))
    assert int(n_t) == int(n_j) > tsm.BETWEEN_MIN_INLIERS
    scaled(H_t.numpy(), H_j, 1e-4)


def test_linearization_matches_jax(jax_run):
    args, kw, _, _ = jax_run[1][0]
    N = len(jax_run[2][0].frames)
    inp = _port_inputs(args, N)
    K = inp["kf_fidx"].shape[0]
    pi, pj = torch.triu_indices(K, K, offset=1)
    corr = tsr.pair_lookups(inp["T0"][inp["kf_fidx"]], pi, pj, inp["kf_pts"], inp["kf_mask"],
                            inp["tables"])
    H_t, g_t, e_t = tsr.linearize(
        inp["T0"], inp["v0"], inp["b0"], inp["T0"], inp["v0"], inp["b0"], inp["bt_delta"],
        inp["bt_info"], inp["bt_valid"], inp["pre"], inp["pre_valid"], inp["gravity"],
        inp["kf_fidx"], pi, pj, inp["kf_pts"], inp["kf_covs"], corr)
    H_j, g_j, e_j = _jax_system(args, N)
    D = 15 * N
    assert H_t.shape == (D, D)
    # Each part at its own scale: the 1e8 gauge prior, the 1e6 bias blocks,
    # and the rest of the poses, velocities and gradients.
    gauge = np.zeros((D, D), bool)
    gauge[:6, :6] = True
    bias = np.zeros(D, bool)
    for k in range(N):
        bias[15 * k + 9:15 * k + 15] = True
    for name, sel in (("gauge", gauge), ("bias", np.outer(bias, bias)),
                      ("rest", ~gauge & ~np.outer(bias, bias))):
        scaled(H_t.numpy()[sel], H_j[sel], 1e-4, name)
    scaled(g_t.numpy(), g_j, 1e-4, "g")
    np.testing.assert_allclose(float(e_t), e_j, rtol=1e-4)


def test_submap_refine_matches_jax(jax_run):
    tol = _tolerance(jax_run)
    for (args, kw, out, _), sub in zip(jax_run[1], jax_run[2]):
        N = len(sub.frames)
        Tr, v, b, err = tsr.submap_refine(**_port_inputs(args, N), outer=kw["outer"],
                                          inner=kw["inner"])
        for got, want, t in zip((Tr, v, b), out[:3], tol):
            np.testing.assert_allclose(got.numpy(), np.asarray(want)[:N], rtol=0, atol=t)
        np.testing.assert_allclose(float(err), float(out[3]), rtol=1e-4)


def test_sub_mapping_with_refinement_matches_jax(jax_run, tmp_path, monkeypatch):
    p, _, subs_j, kfs_j = jax_run
    tol = _tolerance(jax_run)
    use_jax_nn_search(monkeypatch, t_gicp)
    reads = []
    monkeypatch.setattr(tsm, "to_numpy", lambda *a: (reads.append(1), tt.to_numpy(*a))[1])
    sm = tsm.SubMapping(p, device="cpu")
    subs_t, kfs_t = harness._run(tt, sm, TCB, harness._frame_data())
    assert kfs_t == kfs_j
    assert len(subs_t) == len(subs_j) >= 2
    assert sm.refinements == len(subs_t) and len(reads) == sm.refinements
    assert sm.between_infos == sum(len(s.frames) - 1 for s in subs_t)
    for st, sj in zip(subs_t, subs_j):
        assert [f.id for f in st.frames] == [f.id for f in sj.frames]
        moved = max(np.abs(a.T_world_sensor() - b.T_world_sensor()).max()
                    for a, b in zip(sj.frames, sj.odom_frames))
        assert moved > 10 * tol[0]                 # the refinement moved the frames
        for ft, fj in zip(st.frames, sj.frames):
            np.testing.assert_allclose(ft.T_world_sensor(), fj.T_world_sensor(), atol=tol[0])
            np.testing.assert_allclose(ft.v_world_imu, fj.v_world_imu, atol=tol[1])
            np.testing.assert_allclose(ft.imu_bias, fj.imu_bias, atol=tol[2])
        np.testing.assert_allclose(st.T_world_origin, sj.T_world_origin, atol=tol[0])
        assert int(st.frame.mask.sum()) == int(np.asarray(sj.frame.mask).sum())


def test_refinement_recovers_perturbed_poses():
    """The twin of tests/test_submapping_imu.py::test_batch_refinement_
    recovers_perturbed_poses on the port (the same numpy data, draw for
    draw)."""
    from test_submapping_imu import _feed_imu, _line_pose, _scene

    rng = np.random.default_rng(11)
    scene = _scene(rng)
    N = 8
    sm = tsm.SubMapping(tsm.SubMappingParams(
        max_num_keyframes=N, keyframe_update_min_points=100,
        keyframe_update_strategy="DISPLACEMENT", keyframe_update_interval_trans=0.01,
        enable_optimization=True, enable_imu=True, keyframe_voxel_resolution=0.5,
        keyframe_voxelmap_levels=2, refine_subsample=2, keyframe_voxel_capacity=8192),
        device="cpu")
    prev_t, errs0 = -0.1, []
    for i in range(N + 1):
        t = 0.1 * i
        T_true = _line_pose(t)
        T_obs = T_true.copy()
        if 2 <= i <= N - 2:
            T_obs[:3, 3] += rng.normal(size=3) * 0.12
        errs0.append(np.linalg.norm(T_obs[:3, 3] - T_true[:3, 3]))
        _feed_imu(sm, prev_t, t)
        prev_t = t
        Ti = np.linalg.inv(T_true)
        local = scene @ Ti[:3, :3].T + Ti[:3, 3]
        local = local[np.linalg.norm(local, axis=1) < 12.0][:768]
        pts = np.zeros((768, 3), np.float32)
        pts[:len(local)] = local + rng.normal(size=local.shape) * 0.005
        f = tt.EstimationFrame(
            id=i, stamp=t, T_world_lidar=T_obs, frame_id=tt.FrameID.LIDAR,
            frame=tt.PointBatch(points=T(pts), mask=T(np.arange(768) < len(local)),
                                covs=T(np.broadcast_to(np.eye(3, dtype=np.float32) * 0.01,
                                                       (768, 3, 3)))))
        f.v_world_imu = np.array([1.0, 0.0, 0.0])
        f.imu_bias = np.zeros(6)
        sm.insert_frame(f)
    s = sm.submit_end_of_sequence()[0]
    err = float(np.mean([np.linalg.norm(f.T_world_sensor()[:3, 3] - _line_pose(f.stamp)[:3, 3])
                         for f in s.frames]))
    err_in = float(np.mean(errs0[:len(s.frames)]))
    assert err_in == pytest.approx(JAX_INPUT_ERR, rel=1e-12)
    assert err < err_in * 0.7 and err < 0.06, (err, err_in)
    assert err <= JAX_RECOVERED_ERR + 1e-6, err


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_submap_refine_on_cuda(jax_run, cuda):
    """``submap_refine`` on the card (accumulating ``index_put_`` is not
    deterministic there) against JAX at the same spread-derived tolerance."""
    tol = _tolerance(jax_run)
    for (args, kw, out, _), sub in zip(jax_run[1], jax_run[2]):
        N = len(sub.frames)
        inp = _port_inputs(args, N)
        on_card = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else v) for k, v in inp.items()}
        on_card["pre"] = inp["pre"].map(lambda x: x.to(cuda))
        on_card["tables"] = [tuple(x.to(cuda) for x in t) for t in inp["tables"]]
        Tr, v, b, err = tsr.submap_refine(**on_card, outer=kw["outer"], inner=kw["inner"])
        for got, want, t in zip((Tr, v, b), out[:3], tol):
            np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want)[:N], rtol=0, atol=t)
        np.testing.assert_allclose(float(err), float(out[3]), rtol=1e-4)
