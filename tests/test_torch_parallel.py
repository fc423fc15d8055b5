"""The port's device mesh (``glim_tpu_torch/parallel``), the sharded
``global_gn`` and ``tools/multichip_check`` against the JAX package.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
(``make_mesh(8)``); the port's mesh has 8 entries that are all
``torch.device("cpu")``. Inputs are ``tests/test_parallel.py``'s scenes
(960 of 1024 points; 8 factors of 480 / 512) from a numpy seed.
Tolerances: rtol 1e-4, atol 1e-2 on the systems (``test_parallel.py``'s),
``num_inliers`` equal; ``global_gn`` poses at 2e-4 against JAX
(``test_torch_global_gn.py``'s) and to 1e-6 between the port's sharded and
unsharded solves.
"""

import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from glim_tpu import parallel as j_par
from glim_tpu.mapping.global_factors import global_gn as j_global_gn
from glim_tpu.ops import lie_np
from glim_tpu.ops import voxelmap as j_vmx
from glim_tpu_torch import parallel as t_par
from glim_tpu_torch import state as t_state
from glim_tpu_torch.mapping import global_factors as t_gf
from glim_tpu_torch.ops import gicp as t_gicp
from glim_tpu_torch.ops import voxelmap as t_vmx
from glim_tpu_torch.parallel import sharded as t_sh
from test_torch_global_gn import DIMS, _jax_args, _problem

RTOL, ATOL = 1e-4, 1e-2
FIELDS = ("H_tt", "H_ts", "H_ss", "b_t", "b_s", "error")


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


@pytest.fixture(scope="module")
def jmesh():
    return j_par.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return t_par.make_mesh(devices=[torch.device("cpu")] * 8)


def scene(rng, n=960, cap=1024):
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    pts[:n, 2] = np.abs(pts[:n, 2]) * 0.3
    mask = np.zeros(cap, bool)
    mask[:n] = True
    covs = np.broadcast_to(np.eye(3, dtype=np.float32) * 0.01, (cap, 3, 3)).copy()
    return pts, mask, covs


def _maps(pts, mask, covs, capacity, res):
    jvm = j_vmx.voxelmap_insert(j_vmx.empty_gaussian_voxelmap(capacity, res), jnp.asarray(pts),
                                jnp.asarray(mask), jnp.asarray(covs), jnp.int32(0))
    tvm = t_vmx.voxelmap_insert(t_vmx.empty_gaussian_voxelmap(capacity, res, "cpu"),
                                torch.from_numpy(pts), torch.from_numpy(mask),
                                torch.from_numpy(covs), 0)
    return jvm, tvm


def _same_system(t, j, rtol=RTOL, atol=ATOL, fields=FIELDS):
    for name in fields:
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_array_equal(t.num_inliers.numpy(), np.asarray(j.num_inliers))


def _host(sys):
    return type(sys)(*(x.cpu() for x in sys))


def _pose(rng, scale=0.02):
    return lie_np.se3_exp(rng.normal(size=6) * scale).astype(np.float32)


def test_sharded_vgicp_matches_jax_and_unsharded(jmesh, tmesh, rng):
    pts, mask, covs = scene(rng)
    jvm, tvm = _maps(pts, mask, covs, 2048, 0.7)
    T = lie_np.se3_exp(np.array([0.01, 0.02, -0.01, 0.1, 0.05, 0.0])).astype(np.float32)
    j = j_par.sharded_vgicp_linearize(jmesh, jnp.eye(4), jnp.asarray(T), jnp.asarray(pts),
                                      jnp.asarray(covs), jnp.asarray(mask), jvm)
    args = (torch.eye(4), torch.from_numpy(T), torch.from_numpy(pts), torch.from_numpy(covs),
            torch.from_numpy(mask), tvm)
    t = t_par.sharded_vgicp_linearize(tmesh, *args)
    _same_system(t, j)
    _same_system(t, t_gicp.vgicp_linearize(*args))
    assert t.H_ss.device == torch.device("cpu") and int(t.num_inliers) > 500


def test_sharded_gicp_matches_jax_one_search_a_shard(jmesh, tmesh, rng, monkeypatch):
    pts, mask, covs = scene(rng)
    tgt, tmask, tcovs = scene(rng, 900, 1024)
    T = _pose(rng)
    j = j_par.sharded_gicp_linearize(jmesh, jnp.eye(4), jnp.asarray(T), jnp.asarray(pts),
                                     jnp.asarray(covs), jnp.asarray(mask), jnp.asarray(tgt),
                                     jnp.asarray(tcovs), jnp.asarray(tmask), 2.0)
    calls = []
    real = t_gicp.nn_search
    monkeypatch.setattr(t_gicp, "nn_search", lambda q, *a: calls.append(q.shape[0]) or real(q, *a))
    args = (torch.eye(4), torch.from_numpy(T), torch.from_numpy(pts), torch.from_numpy(covs),
            torch.from_numpy(mask), torch.from_numpy(tgt), torch.from_numpy(tcovs),
            torch.from_numpy(tmask), 2.0)
    t = t_par.sharded_gicp_linearize(tmesh, *args)
    assert calls == [128] * 8        # one search a shard, at Q = cap / mesh size
    _same_system(t, j)
    _same_system(t, t_gicp.gicp_linearize(*args))


def test_sharded_factor_linearize_matches_jax(jmesh, tmesh, rng):
    F, C = 8, 512
    jvms, tvms, items = [], [], []
    for _ in range(F):
        pts, mask, covs = scene(rng, 480, C)
        jvm, tvm = _maps(pts, mask, covs, 1024, 0.7)
        jvms.append(jvm)
        tvms.append(tvm)
        items.append((np.eye(4, dtype=np.float32), _pose(rng), pts, covs, mask))
    stacked = [np.stack(x) for x in zip(*items)]
    j = j_par.sharded_factor_linearize(jmesh, *(jnp.asarray(x) for x in stacked),
                                       jtu.tree_map(lambda *xs: jnp.stack(xs), *jvms))
    t = t_par.sharded_factor_linearize(tmesh, *(torch.from_numpy(x) for x in stacked),
                                       t_vmx.stack_voxelmaps(tvms))
    assert t.H_ss.shape == (F, 6, 6) and t.num_inliers.shape == (F,)
    _same_system(t, j)
    for f in range(F):
        ref = t_gicp.vgicp_linearize(*(torch.from_numpy(x[f]) for x in stacked), tvms[f])
        _same_system(type(ref)(*(x[f] for x in t)), ref)


def test_sharded_odometry_step_converges_as_jax(jmesh, tmesh, rng):
    pts, mask, covs = scene(rng)
    jvm, tvm = _maps(pts, mask, covs, 2048, 0.7)
    T_true = lie_np.se3_exp(np.array([0.02, -0.01, 0.03, 0.2, -0.1, 0.05]))
    Ti = np.linalg.inv(T_true).astype(np.float32)
    src = (pts @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
    T_j, errs_j = j_par.sharded_odometry_step(jmesh, jnp.eye(4), jnp.asarray(src),
                                              jnp.asarray(covs), jnp.asarray(mask), jvm, iters=10)
    T_t, errs_t = t_par.sharded_odometry_step(tmesh, torch.eye(4), torch.from_numpy(src),
                                              torch.from_numpy(covs), torch.from_numpy(mask),
                                              tvm, iters=10)
    assert errs_t.shape == errs_j.shape == (10,)
    err = lie_np.se3_log(np.linalg.inv(T_true) @ T_t.numpy().astype(np.float64))
    assert np.linalg.norm(err[3:]) < 0.1, err
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-3)
    np.testing.assert_allclose(errs_t.numpy(), np.asarray(errs_j), rtol=1e-3)


def test_mesh_construction_and_indivisible_axes(tmesh, rng, monkeypatch):
    assert tmesh.size == 8 and tmesh.axis == "points"
    assert t_par.make_mesh(2, axis="factors", devices=["cpu"] * 8).devices == \
        (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        t_par.make_mesh(9, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        t_par.make_mesh()
    pts, mask, covs = (torch.from_numpy(x) for x in scene(rng, 900, 1004))
    vm = t_vmx.empty_gaussian_voxelmap(256, 0.7, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        t_par.sharded_vgicp_linearize(tmesh, torch.eye(4), torch.eye(4), pts, covs, mask, vm)
    with pytest.raises(ValueError, match="not divisible"):
        t_par.sharded_gicp_linearize(tmesh, torch.eye(4), torch.eye(4), pts, covs, mask,
                                     pts, covs, mask, 1.0)
    d, _ = _problem()
    args = t_state.global_gn_args_from_numpy(d, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        t_gf.global_gn(**args, **DIMS, iters=1,
                       shard_mesh=t_par.make_mesh(devices=["cpu"] * 3))


@pytest.mark.parametrize("n", [2, 8])
def test_global_gn_sharded_matches_unsharded_and_jax(n):
    """Fp = 16 rows, 12 of them factors: the last shard (rows 14-15 at n =
    8, rows 8-15 at n = 2) holds only padded rows, one with hits and zero
    weight."""
    d, _ = _problem()
    args = t_state.global_gn_args_from_numpy(d, "cpu")
    mesh = t_par.make_mesh(axis="factors", devices=["cpu"] * n)
    T_sh, junc_sh, err_sh, md_sh = (x.numpy() for x in t_gf.global_gn(
        **args, **DIMS, iters=5, shard_mesh=mesh))
    T_1d, junc_1d, err_1d, md_1d = (x.numpy() for x in t_gf.global_gn(**args, **DIMS, iters=5))
    np.testing.assert_allclose(T_sh, T_1d, atol=1e-6)
    np.testing.assert_allclose(junc_sh, junc_1d, atol=1e-6)
    np.testing.assert_allclose(err_sh, err_1d, rtol=1e-6)
    T_j = np.asarray(j_global_gn(**_jax_args(d), **DIMS, iters=5,
                                 shard_mesh=j_par.make_mesh(n, axis="factors"))[0])
    for k in range(DIMS["Sp"]):
        d_rot = lie_np.so3_log(T_sh[k, :3, :3].astype(np.float64).T @ T_j[k, :3, :3])
        assert np.abs(d_rot).max() < 2e-4, (k, d_rot)
        np.testing.assert_allclose(T_sh[k, :3, 3], T_j[k, :3, 3], atol=2e-4)


def test_backend_parity_check_on_the_cpu_mesh(tmesh):
    from glim_tpu_torch.tools.multichip_check import backend_parity_check

    stats = backend_parity_check(t_sh.Mesh(tmesh.devices, "factors"), n_submaps=64)
    assert stats["factors"] >= 300 and stats["factor_rows"] == 512
    assert stats["max_pose_delta"] < 5e-4
    assert np.isfinite(stats["err_sharded"]) and stats["err_sharded"] == \
        pytest.approx(stats["err_single"], rel=1e-4)


@pytest.mark.parametrize("n_cards, want", [(1, None), (2, 2), (3, 2), (4, 4), (12, 8)])
def test_global_mapping_mesh_from_the_card_count(monkeypatch, n_cards, want):
    """The back-end builds a mesh of min(2^floor(log2 n), 8) cards only on a
    CUDA device with more than one card attached, and only with
    use_device_mesh; the CPU back-end never does."""
    from glim_tpu_torch.mapping.global_mapping import GlobalMapping, GlobalMappingParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    gm = GlobalMapping(device="cuda")
    assert (gm._mesh.size if gm._mesh else None) == want
    if want:
        assert gm._mesh.axis == "factors"
        assert gm._mesh.devices == tuple(torch.device("cuda", i) for i in range(want))
    assert GlobalMapping(GlobalMappingParams(use_device_mesh=False), device="cuda")._mesh is None
    assert GlobalMapping(device="cpu")._mesh is None


def test_use_device_mesh_from_config(tmp_path):
    from glim_tpu_torch.mapping.global_mapping import GlobalMappingParams
    from glim_tpu_torch.utils.config import GlobalConfig, create_default_config_dir

    GlobalConfig.reset()
    cfg = GlobalConfig.instance(create_default_config_dir(str(tmp_path)))
    gcfg = cfg.get_config("config_global_mapping")
    assert GlobalMappingParams.from_config(gcfg).use_device_mesh is True
    gcfg.override_param("global_mapping", "use_device_mesh", False)
    assert GlobalMappingParams.from_config(gcfg).use_device_mesh is False
    GlobalConfig.reset()


def test_optimize_passes_the_mesh_to_global_gn(tmesh, monkeypatch):
    """optimize(mesh) shards the solve and gives the unsharded poses."""
    from glim_tpu_torch.mapping import global_mapping as t_gm
    from glim_tpu_torch.types import PointBatch, SubMap

    rng = np.random.default_rng(3)
    world = np.concatenate([np.stack([rng.uniform(-6, 6, 600), rng.uniform(-6, 6, 600),
                                      np.zeros(600)], 1),
                            np.stack([np.full(400, 4.0), rng.uniform(-6, 6, 400),
                                      rng.uniform(0, 3, 400)], 1),
                            np.stack([rng.uniform(-6, 6, 400), np.full(400, -3.0),
                                      rng.uniform(0, 3, 400)], 1)])
    noise = [lie_np.se3_exp(rng.normal(size=6) * [0, 0, 0.01, 0.05, 0.05, 0]) for _ in range(3)]
    seen = []
    real = t_gm.global_gn
    monkeypatch.setattr(t_gm, "global_gn",
                        lambda *a, **k: seen.append(k["shard_mesh"]) or real(*a, **k))

    def build():
        gm = t_gm.GlobalMapping(t_gm.GlobalMappingParams(
            enable_imu=False, voxel_capacity=2048, matching_points=256,
            submap_voxelmap_levels=1, enable_optimization=False), device="cpu")
        for k in range(3):
            T = lie_np.se3_exp(np.array([0, 0, 0.02 * k, 0.5 * k, 0.1 * k, 0]))
            Ti = np.linalg.inv(T)
            pts = (world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
            gm.insert_submap(SubMap(id=k, T_world_origin=T @ noise[k],
                                    frame=PointBatch.from_numpy(pts, capacity=2048,
                                                                device="cpu")))
        return gm

    a, b = build(), build()
    a.optimize(t_sh.Mesh(tmesh.devices, "factors"))
    b.optimize()
    assert seen[0] is not None and seen[-1] is None
    np.testing.assert_allclose(np.stack(a.poses), np.stack(b.poses), atol=1e-6)


def test_chip_smoke_phase13a_rehearsal_on_cpu(tmesh):
    """chip_smoke.py phase 13a at a tiny size on the 8-entry CPU mesh: the
    same comparisons, checks and parity runs (no launches on the CPU)."""
    import chip_smoke

    inputs = chip_smoke.mesh_inputs(cap=1024, n_targets=8192, factor_points=512)
    res = chip_smoke.run_mesh("cpu", voxels=8192, factor_voxels=4096, inputs=inputs)
    chip_smoke.check_mesh(res, launches_per_shard=0)
    assert set(res["rows"]) == {"vgicp", "gicp", "factors"}
    assert res["parity_real"]["mesh"] == ["cpu"] and res["odometry"]["trans_err"] < 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sharded GICP launches the nn_search kernel)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_phase13a_on_the_card_against_jax(cuda, jmesh):
    """13a's comparisons on 8 entries of cuda:0 against JAX's sharded
    functions on its CPU mesh, at the rehearsal's size."""
    import chip_smoke
    from glim_tpu_torch.ops.nn_search import nn_search

    d = chip_smoke.mesh_inputs(cap=1024, n_targets=8192, factor_points=512)
    mesh = t_par.make_mesh(devices=[cuda] * 8)
    t = {k: torch.as_tensor(v, device=cuda) for k, v in d.items() if k != "T_true"}
    j = {k: jnp.asarray(v) for k, v in d.items() if k != "T_true"}
    jvm, _ = _maps(d["tgt"], d["tgt_mask"], d["tgt_covs"], 8192, 0.5)
    tvm = t_vmx.voxelmap_insert(t_vmx.empty_gaussian_voxelmap(8192, 0.5, cuda), t["tgt"],
                                t["tgt_mask"], t["tgt_covs"], 0)
    src_t = (t["src"], t["src_covs"], t["src_mask"])
    src_j = (j["src"], j["src_covs"], j["src_mask"])
    eye_t = torch.eye(4, device=cuda)
    _same_system(_host(t_par.sharded_vgicp_linearize(mesh, eye_t, t["T_src"], *src_t, tvm)),
                 j_par.sharded_vgicp_linearize(jmesh, jnp.eye(4), j["T_src"], *src_j, jvm))
    nn_search.kernel_launches = 0
    sys_t = t_par.sharded_gicp_linearize(mesh, eye_t, t["T_src"], *src_t, t["tgt"],
                                         t["tgt_covs"], t["tgt_mask"], 1.0)
    assert nn_search.kernel_launches == 8
    _same_system(_host(sys_t),
                 j_par.sharded_gicp_linearize(jmesh, jnp.eye(4), j["T_src"], *src_j, j["tgt"],
                                              j["tgt_covs"], j["tgt_mask"], 1.0))
