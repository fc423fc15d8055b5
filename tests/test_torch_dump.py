"""Map dumps of the port (glim_tpu_torch/io/dump.py) against the JAX
package's (glim_tpu/io/dump.py) on the same numpy submaps.

``save_dump`` must write byte-identical text, cloud (.bin) and boost
archive (graph.bin / values.bin) files, and a graph.npz with equal arrays;
each package's ``load_dump`` reads the other's dump to equal submaps, poses
and factors; ``repair_submap`` re-estimates broken covariances to the JAX
package's values within f32 tolerance (1e-4 of the largest entry; the kNN
has no distance ties on these random points, hazard C4). Back-ends: the
16-submap ring (tools/backend_stress) saved by the port gives the same
factor list and poses in either back-end, and a second session appended
with ``session_offset=1`` the same gravity anchors and factor list.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.io import dump as j_dump
from glim_tpu.types import EstimationFrame as JFrame
from glim_tpu.types import PointBatch as JPointBatch
from glim_tpu.types import SubMap as JSubMap
from glim_tpu.utils.config import GlobalConfig as JConfig
from glim_tpu_torch.io import dump as t_dump
from glim_tpu_torch.types import EstimationFrame as TFrame
from glim_tpu_torch.types import PointBatch as TPointBatch
from glim_tpu_torch.types import SubMap as TSubMap
from glim_tpu_torch.utils.config import GlobalConfig as TConfig

COV_REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    JConfig.reset()
    TConfig.reset()
    yield
    from glim_tpu_torch.utils import lifecycle
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


def _pose(rng, scale=5.0):
    from glim_tpu.ops import lie_np
    return lie_np.se3_exp(np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, scale, 3)]))


def _submap_data(rng, k, n=700, n_frames=3):
    """Numpy fields of one submap: a cloud with every attribute, and frames
    with poses, velocities, biases and an IMU-rate trajectory."""
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    frames = []
    for f in range(n_frames):
        m = 5 + f
        packed = np.zeros((8, 16), np.float32)
        packed[0, :m] = np.linspace(0.0, 0.1, m)
        packed[1:4, :m] = rng.normal(size=(3, m))
        q = rng.normal(size=(4, m))
        packed[4:8, :m] = q / np.linalg.norm(q, axis=0)
        frames.append(dict(id=10 * k + f, stamp=1.0 * k + 0.1 * f, T=_pose(rng), T_odom=_pose(rng),
                           v=rng.normal(size=3), b=rng.normal(0, 0.01, 6), traj=(packed, m)))
    return dict(
        id=k, T_world_origin=_pose(rng), T_L=_pose(rng), T_R=_pose(rng),
        T_lidar_imu=_pose(rng, 0.1),
        points=rng.uniform(-20, 20, (n, 3)).astype(np.float32),
        covs=(A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3, dtype=np.float32)),
        normals=rng.normal(size=(n, 3)).astype(np.float32),
        times=rng.uniform(0, 0.1, n).astype(np.float32),
        intensities=rng.uniform(0, 1, n).astype(np.float32), frames=frames)


def _frames(d, cls, device_traj):
    out, odom = [], []
    for f in d["frames"]:
        for dst, T in ((out, f["T"]), (odom, f["T_odom"])):
            fr = cls(id=f["id"], stamp=f["stamp"], T_lidar_imu=d["T_lidar_imu"].copy(),
                     T_world_lidar=T.copy(), T_world_imu=T @ d["T_lidar_imu"],
                     v_world_imu=f["v"].copy(), imu_bias=f["b"].copy())
            if dst is out:
                packed, m = f["traj"]
                fr.device_imu_rate_trajectory = (device_traj(packed), m, f["stamp"])
            dst.append(fr)
    return out, odom


def _jax_submap(d):
    frames, odom = _frames(d, JFrame, jnp.asarray)
    return JSubMap(id=d["id"], T_world_origin=d["T_world_origin"].copy(),
                   T_origin_endpoint_L=d["T_L"].copy(), T_origin_endpoint_R=d["T_R"].copy(),
                   frame=JPointBatch.from_numpy(d["points"], times=d["times"],
                                                intensities=d["intensities"], covs=d["covs"],
                                                normals=d["normals"]),
                   frames=frames, odom_frames=odom)


def _port_submap(d, device="cpu"):
    frames, odom = _frames(d, TFrame, lambda a: torch.from_numpy(a).to(device))
    return TSubMap(id=d["id"], T_world_origin=d["T_world_origin"].copy(),
                   T_origin_endpoint_L=d["T_L"].copy(), T_origin_endpoint_R=d["T_R"].copy(),
                   frame=TPointBatch.from_numpy(d["points"], times=d["times"],
                                                intensities=d["intensities"], covs=d["covs"],
                                                normals=d["normals"], device=device),
                   frames=frames, odom_frames=odom)


def _factors(rng, n_submaps):
    def info():
        A = rng.normal(size=(6, 6))
        return A @ A.T + np.eye(6)
    pairs = [(k - 1, k) for k in range(1, n_submaps)]
    return dict(i=[p[0] for p in pairs], j=[p[1] for p in pairs],
                Z=[_pose(rng, 1.0) for _ in pairs], info=[info() for _ in pairs],
                huber=[-1.0] * len(pairs), matching=[(0, 1), (0, 2), (1, 2)],
                translation_priors=[(1, [1.0, 2.0, 3.0], [0.5, 0.5, 0.5])])


def _both_dumps(tmp_path, device="cpu", n_submaps=3):
    rng = np.random.default_rng(7)
    data = [_submap_data(rng, k) for k in range(n_submaps)]
    poses = [_pose(rng) for _ in range(n_submaps)]
    factors = _factors(rng, n_submaps)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_dump.save_dump(j_dir, [_jax_submap(d) for d in data], poses, factors=factors)
    t_dump.save_dump(t_dir, [_port_submap(d, device) for d in data], poses, factors=factors)
    return j_dir, t_dir, data, poses, factors


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _check_same_files(j_dir, t_dir):
    names = _files(j_dir)
    assert names == _files(t_dir)
    assert {"graph.txt", "graph.npz", "graph.bin", "values.bin", "traj_lidar.txt",
            "odom_imu.txt", "000000/data.txt", "000000/points_compact.bin",
            "000000/covs_compact.bin", "000002/imu_rate.txt"} <= set(names)
    for name in names:
        a, b = os.path.join(j_dir, name), os.path.join(t_dir, name)
        if name == "graph.npz":
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, k
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name


def test_save_dump_matches_jax_bytes(tmp_path):
    j_dir, t_dir, *_ = _both_dumps(tmp_path)
    _check_same_files(j_dir, t_dir)


def _check_loaded(submaps, poses, factors, data, want_poses, want_factors):
    np.testing.assert_array_equal(np.stack(poses), np.stack(want_poses))
    assert len(submaps) == len(data)
    for sm, d in zip(submaps, data):
        assert sm.id == d["id"]
        np.testing.assert_allclose(sm.T_world_origin, d["T_world_origin"], atol=1e-10)
        mask = np.asarray(sm.frame.mask)
        for name in ("points", "times", "intensities", "normals", "covs"):
            np.testing.assert_array_equal(np.asarray(getattr(sm.frame, name))[mask], d[name],
                                          err_msg=name)
        assert [f.id for f in sm.frames] == [f["id"] for f in d["frames"]]
        for fr, odom, f in zip(sm.frames, sm.odom_frames, d["frames"]):
            assert fr.stamp == pytest.approx(f["stamp"], abs=1e-9)
            np.testing.assert_allclose(fr.T_world_lidar, f["T"], atol=1e-10)
            np.testing.assert_allclose(odom.T_world_lidar, f["T_odom"], atol=1e-10)
            np.testing.assert_array_equal(fr.v_world_imu, f["v"])
            np.testing.assert_array_equal(fr.imu_bias, d["frames"][-1]["b"])
    assert [int(x) for x in factors["i"]] == want_factors["i"]
    assert [int(x) for x in factors["j"]] == want_factors["j"]
    np.testing.assert_array_equal(np.stack(factors["Z"]), np.stack(want_factors["Z"]))
    np.testing.assert_array_equal(np.stack(factors["info"]), np.stack(want_factors["info"]))
    assert [tuple(int(v) for v in m) for m in factors["matching"]] == want_factors["matching"]
    assert [(int(a), list(p), list(s)) for a, p, s in factors["translation_priors"]] == \
        [(a, p, s) for a, p, s in want_factors["translation_priors"]]


def test_each_package_loads_the_others_dump(tmp_path):
    j_dir, t_dir, data, poses, factors = _both_dumps(tmp_path)
    _check_loaded(*t_dump.load_dump(j_dir, "cpu"), data, poses, factors)
    _check_loaded(*j_dump.load_dump(t_dir), data, poses, factors)


def test_repair_submap_matches_jax():
    """Non-finite points are dropped and broken covariances re-estimated
    from a 10-neighbour kNN, as the JAX package does."""
    rng = np.random.default_rng(3)
    d = _submap_data(rng, 0, n=900)
    d["points"][[5, 77, 300]] = np.nan
    d["covs"][10] = np.inf
    jsm, tsm = _jax_submap(d), _port_submap(d)
    j_dump.repair_submap(jsm)
    t_dump.repair_submap(tsm)
    mask = np.asarray(jsm.frame.mask)
    np.testing.assert_array_equal(tsm.frame.mask.numpy(), mask)
    assert mask.sum() == 897
    np.testing.assert_array_equal(tsm.frame.points.numpy(), np.asarray(jsm.frame.points))
    for name in ("covs", "normals"):
        want = np.asarray(getattr(jsm.frame, name))[mask]
        got = getattr(tsm.frame, name).numpy()[mask]
        np.testing.assert_allclose(got, want, atol=COV_REL_TOL * np.abs(want).max())
    assert not np.allclose(tsm.frame.covs.numpy()[:900][mask[:900]], d["covs"][mask[:900]])


def test_export_ply_reads_back(tmp_path):
    from glim_tpu.io.loaders import load_scan_file as j_load
    from glim_tpu_torch.io.loaders import load_scan_file as t_load

    pts = np.random.default_rng(1).normal(size=(333, 3)).astype(np.float32)
    t_dump.export_ply(str(tmp_path / "t.ply"), pts)
    j_dump.export_ply(str(tmp_path / "j.ply"), pts)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(t_load(str(tmp_path / "t.ply")), pts)
    np.testing.assert_array_equal(j_load(str(tmp_path / "t.ply")), pts)


@pytest.mark.parametrize("layout", ["ascii", "double", "two_elements"])
def test_ply_reader_refuses_other_layouts(tmp_path, layout):
    from glim_tpu_torch.io.loaders import load_ply

    header = {"ascii": "ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n"
                       "property float y\nproperty float z\nend_header\n",
              "double": "ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
                        "property double x\nproperty double y\nproperty double z\nend_header\n",
              "two_elements": "ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
                              "property float x\nproperty float y\nproperty float z\n"
                              "element face 0\nend_header\n"}[layout]
    (tmp_path / "x.ply").write_bytes(header.encode() + b"\0" * 24)
    with pytest.raises(ValueError):
        load_ply(str(tmp_path / "x.ply"))


def test_load_pads_every_cloud_to_one_capacity(tmp_path):
    """Submaps of 700, 1500 and 3000 points load at one capacity, so the
    back-end can stack them and optimize (the JAX package gives each cloud
    its own capacity, and its load then fails to stack the matching
    slices), and a second session loads at the first one's capacity."""
    from glim_tpu_torch.mapping import global_mapping as t_gm
    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks

    rng = np.random.default_rng(11)
    data = [_submap_data(rng, k, n=n) for k, n in enumerate((700, 1500, 3000))]
    path = str(tmp_path / "dump")
    t_dump.save_dump(path, [_port_submap(d) for d in data], [d["T_world_origin"] for d in data],
                     factors=_factors(rng, 3))
    submaps, _, _ = t_dump.load_dump(path, "cpu")
    assert [int(s.frame.points.shape[0]) for s in submaps] == [4096] * 3
    assert [int(s.frame.mask.sum()) for s in submaps] == [700, 1500, 3000]
    gm = t_gm.GlobalMapping(t_gm.GlobalMappingParams(voxel_capacity=4096), device="cpu")
    gm.load(path)
    gm.load(path, session_offset=1)
    assert {int(s.frame.points.shape[0]) for s in gm.submaps} == {4096}
    optimizes = []
    GlobalMappingCallbacks.on_smoother_update_result.add(lambda *a: optimizes.append(1))
    gm.optimize()
    assert optimizes == [1] and gm.gravity_anchors == [3]


def _ring_dump(tmp_path):
    from glim_tpu_torch.tools import backend_stress as t_stress

    _, gm = t_stress.run(16, 4, device="cpu", quiet=True)
    path = str(tmp_path / "ring")
    gm.save(path)
    return gm, path


def test_ring_dump_loads_into_both_back_ends(tmp_path):
    """The port's 16-submap ring, saved and loaded into a fresh back-end of
    each package, then appended again as a second session: the same factor
    lists, poses and gravity anchors."""
    from glim_tpu.mapping import global_mapping as j_gm
    from glim_tpu_torch.mapping import global_mapping as t_gm

    gm, path = _ring_dump(tmp_path)
    params = dict(submap_voxel_resolution=0.5, voxel_capacity=16384,
                  min_implicit_loop_overlap=0.15, max_implicit_loop_distance=40.0)
    t_new = t_gm.GlobalMapping(t_gm.GlobalMappingParams(**params), device="cpu")
    j_new = j_gm.GlobalMapping(j_gm.GlobalMappingParams(**params))
    for fresh in (t_new, j_new):
        fresh.load(path)
        assert fresh.matching_factors == gm.matching_factors
        assert [f[:2] for f in fresh.between_factors] == [f[:2] for f in gm.between_factors]
        for a, b in zip(fresh.poses, gm.poses):
            np.testing.assert_array_equal(a, b)
        fresh.load(path, session_offset=1)
    n = len(gm.submaps)
    assert t_new.gravity_anchors == j_new.gravity_anchors == [n]
    assert t_new.matching_factors == j_new.matching_factors
    assert t_new.matching_factors[len(gm.matching_factors):] == \
        [(a + n, b + n) for a, b in gm.matching_factors]
    assert [s.id for s in t_new.submaps] == [s.id for s in j_new.submaps] == list(range(2 * n))
    assert [s.session_id for s in t_new.submaps] == [0] * n + [1] * n


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_dump_round_trip_from_cuda_tensors(tmp_path, cuda):
    """Submaps whose clouds and IMU-rate trajectories lie on the card save
    to the same bytes as the JAX package's, and load back onto the card."""
    j_dir, t_dir, data, poses, factors = _both_dumps(tmp_path, device=cuda)
    _check_same_files(j_dir, t_dir)
    submaps, got_poses, got_factors = t_dump.load_dump(t_dir, cuda)
    assert all(sm.frame.points.device.type == "cuda" for sm in submaps)
    for sm in submaps:
        sm.frame = TPointBatch(**{k: (None if v is None else v.cpu())
                                  for k, v in vars(sm.frame).items()})
    _check_loaded(submaps, got_poses, got_factors, data, poses, factors)
