"""The port's offline map tools (glim_tpu_torch/ops/segmentation.py,
viewer/map_editor.py, viewer/offline_viewer.py, the map editor, offline
viewer and interactive viewer CLIs, native/loader.py) against the JAX
package's on the same seeded inputs.

Tolerances: region growing and min-cut give identical masks when both are
given the JAX neighbours and normals (near-tied kNN neighbours and
near-zero eigengaps are the packages' f32 rounding, C4, not the tools);
the map editor's radius, box, outlier and segmentation selections the same
index sets, and its saved dumps the same points; the offline viewer the
same submaps, session ids and factors and poses within 1e-4 m / 1e-4 rad;
the REPL's --exec lines the same results (poses and inlier fractions to
1e-4); PLY files the same bytes and the PLY reader the C++ reader's
vertices exactly. The outlier selection examines points past the JAX
package's 131,072-point cap. chip_smoke phase 12c is rehearsed at a tiny
size; the gpu-marked cases compare the card with the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.ops import lie_np
from torch_parity import use_jax_covariances, use_jax_nn_search

POSE_ATOL = 1e-4      # m / rad


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils import lifecycle
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _room(rng, n=900, box_at=(2.0, 1.0)):
    """A floor, two walls, a box object on the floor and a pillar."""
    k = n // 5
    floor = np.c_[rng.uniform(-6, 6, (k, 2)), rng.normal(0, 0.005, k)]
    w1 = np.c_[rng.uniform(-6, 6, k), np.full(k, 6.0), rng.uniform(0, 3, k)]
    w2 = np.c_[np.full(k, -6.0), rng.uniform(-6, 6, k), rng.uniform(0, 3, k)]
    face = rng.integers(0, 3, k)
    u = rng.uniform(-0.4, 0.4, (k, 2))
    box = np.where(face[:, None] == 0, np.c_[u, np.full(k, 0.4)],
                   np.where(face[:, None] == 1, np.c_[np.full(k, 0.4), u],
                            np.c_[u[:, 0], np.full(k, 0.4), u[:, 1]]))
    box = box + [box_at[0], box_at[1], 0.4]
    m = n - 4 * k
    ang = rng.uniform(0, 2 * np.pi, m)
    pillar = np.c_[-3 + 0.3 * np.cos(ang), -2 + 0.3 * np.sin(ang), rng.uniform(0, 3, m)]
    return np.concatenate([floor, w1, w2, box, pillar]).astype(np.float32)


def _padded(pts, cap):
    out = np.zeros((cap, 3), np.float32)
    out[:len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[:len(pts)] = True
    return out, mask


def _save_dump(path, clouds, poses, between=True):
    """A dump of the given local clouds at the given poses, written by the
    port (the JAX package reads it byte for byte), with covariances from
    the JAX package (so neither side re-estimates them on load)."""
    from glim_tpu.ops import covariance as j_cov
    from glim_tpu.ops import knn as j_knn
    from glim_tpu_torch.io.dump import save_dump
    from glim_tpu_torch.types import EstimationFrame, PointBatch, SubMap

    submaps = []
    for k, (pts, T) in enumerate(zip(clouds, poses)):
        cap = 1 << int(np.ceil(np.log2(max(len(pts), 16))))
        p, m = _padded(pts, cap)
        nbr, _ = j_knn.knn_self(jnp.asarray(p), jnp.asarray(m), 10)
        covs = np.array(j_cov.estimate_covariances(jnp.asarray(p), jnp.asarray(m), nbr,
                                                     "plane")[0])
        sm = SubMap(id=k, T_world_origin=np.asarray(T, np.float64),
                    frame=PointBatch(points=torch.from_numpy(p), mask=torch.from_numpy(m),
                                     covs=torch.from_numpy(covs)))
        sm.frames = [EstimationFrame(id=k, stamp=float(k))]
        sm.odom_frames = [EstimationFrame(id=k, stamp=float(k))]
        submaps.append(sm)
    n = len(submaps)
    factors = dict(i=list(range(n - 1)), j=list(range(1, n)),
                   Z=[np.linalg.inv(poses[a]) @ poses[a + 1] for a in range(n - 1)],
                   info=[np.eye(6) * 1e2] * (n - 1), huber=[-1.0] * (n - 1)) \
        if between and n > 1 else None
    save_dump(path, submaps, [np.asarray(T, np.float64) for T in poses], factors=factors)
    return path


def _room_dump(tmp_path, name="dump", n_sub=3, offset=0.0, seed=5, n=900):
    """Submaps of one room seen from poses 1.5 m apart (and ``offset`` m
    along y), with an outlier blob far above the room in the last one."""
    rng = np.random.default_rng(seed)
    world = _room(rng, n=4 * n)
    clouds, poses = [], []
    for k in range(n_sub):
        T = lie_np.se3_exp(np.array([0.0, 0.0, 0.05 * k, 1.5 * k - 1.5, offset, 0.0]))
        sel = world[rng.choice(len(world), n, replace=False)]
        Ti = np.linalg.inv(T)
        local = sel @ Ti[:3, :3].T + Ti[:3, 3] + rng.normal(0, 0.003, sel.shape)
        if k == n_sub - 1:
            local[-8:] = np.array([0.0, 0.0, 25.0]) + rng.normal(0, 0.5, (8, 3))
        clouds.append(local.astype(np.float32))
        poses.append(T)
    return _save_dump(str(tmp_path / name), clouds, poses)


def _jax_knn(monkeypatch, *modules):
    """Make ``knn_self`` in the port's ``modules`` return the JAX package's
    neighbours and squared distances for the same inputs."""
    from glim_tpu.ops import knn as j_knn

    def knn_self(points, mask, k):
        nbr, d2 = j_knn.knn_self(jnp.asarray(points.cpu().numpy()),
                                 jnp.asarray(mask.cpu().numpy()), k)
        return (torch.as_tensor(np.array(nbr), device=points.device),
                torch.as_tensor(np.array(d2), device=points.device))

    for m in modules:
        monkeypatch.setattr(m, "knn_self", knn_self)


@pytest.mark.parametrize("method", ["region_growing", "min_cut"])
def test_segmentation_matches_jax(monkeypatch, method):
    from glim_tpu.ops import covariance as j_cov
    from glim_tpu.ops import knn as j_knn
    from glim_tpu.ops import segmentation as j_seg
    from glim_tpu_torch.ops import segmentation as t_seg

    _jax_knn(monkeypatch, t_seg)
    pts, mask = _padded(_room(np.random.default_rng(6), n=1500), 2048)
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    nbr, _ = j_knn.knn_self(jp, jm, 10)
    normals = np.array(j_cov.estimate_covariances(jp, jm, nbr, "plane")[1])
    seed = 1500 - 3 * (1500 // 5) + 5               # a point on the box object
    if method == "region_growing":
        want = j_seg.region_growing(jp, jnp.asarray(normals), jm, seed)
        got = t_seg.region_growing(torch.from_numpy(pts), torch.from_numpy(normals),
                                   torch.from_numpy(mask), seed)
        ctx = t_seg.region_growing_init(torch.from_numpy(pts), torch.from_numpy(normals),
                                        torch.from_numpy(mask), seed)
        jctx = j_seg.region_growing_init(jp, jnp.asarray(normals), jm, seed)
        np.testing.assert_array_equal(ctx.ok.numpy(), np.asarray(jctx.ok))
        one = t_seg.region_growing_update(ctx, rounds=1)
        np.testing.assert_array_equal(one.labels.numpy(),
                                      np.asarray(j_seg.region_growing_update(jctx, 1).labels))
    else:
        want = j_seg.min_cut(jp, jm, seed)
        got = t_seg.min_cut(torch.from_numpy(pts), torch.from_numpy(mask), seed)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 10 < got.sum() < mask.sum() and got[seed] and not got[~mask].any()


def test_map_editor_selections_match_jax(tmp_path, monkeypatch):
    from glim_tpu.io.dump import load_dump as j_load
    from glim_tpu.viewer.map_editor import MapEditor as JEditor
    from glim_tpu_torch.io.dump import load_dump as t_load
    from glim_tpu_torch.ops import knn as t_knn
    from glim_tpu_torch.ops import segmentation as t_seg
    from glim_tpu_torch.viewer.map_editor import MapEditor as TEditor

    dump = _room_dump(tmp_path)
    ej, et = JEditor(), TEditor(device="cpu")
    ej.open(dump)
    et.open(dump)
    np.testing.assert_array_equal(et.points, ej.points)
    np.testing.assert_array_equal(et.owner, ej.owner)
    np.testing.assert_array_equal(et.local_idx, ej.local_idx)
    assert sorted(et.cells) == sorted(ej.cells)
    for key, idx in ej.cells.items():
        np.testing.assert_array_equal(et.cells[key], idx)

    def same(fn):
        ej.clear_selection()
        et.clear_selection()
        nj, nt = fn(ej, "jax"), fn(et, "torch")
        assert nt == nj and et.selected == ej.selected
        return nt

    center = ej.points[-4]
    assert same(lambda e, _: e.select_radius(center, 2.0)) >= 8
    T_box = np.eye(4)
    T_box[:3, 3] = [0.5, 0.5, 1.0]
    assert same(lambda e, _: e.select_box(T_box, [2.0, 1.5, 1.0])) > 50
    n = len(ej.points)
    # JAX examines its first `cap` points; here every point is below the cap.
    n_out = same(lambda e, p: e.select_outliers(k=8, std_mul=1.5, cap=4096) if p == "jax"
                 else e.select_outliers(k=8, std_mul=1.5))
    assert n_out > 0 and {n - k for k in range(1, 9)} <= et.selected

    _jax_knn(monkeypatch, t_knn, t_seg)
    use_jax_covariances(monkeypatch)
    seed = ej.points[np.argmin(np.linalg.norm(ej.points - [2.0, 1.0, 0.8], axis=1))]
    for method in ("min_cut", "region_growing"):
        assert same(lambda e, _: e.select_segmentation(seed, method=method, cap=4096)) > 10

    for e, name in ((ej, "j_out"), (et, "t_out")):
        e.clear_selection()
        e.select_radius(center, 2.0)
        e.delete_selected()
        e.select_box(T_box, [2.0, 1.5, 1.0])       # selected on save: removed too
        e.save(str(tmp_path / name))
    for path in ("j_out", "t_out"):
        subs_j, _, _ = j_load(str(tmp_path / path))
        subs_t, _, _ = t_load(str(tmp_path / path), "cpu")
        for sj, st in zip(subs_j, subs_t):
            mj, mt = np.asarray(sj.frame.mask), st.frame.mask.numpy()
            np.testing.assert_array_equal(st.frame.points.numpy()[mt],
                                          np.asarray(sj.frame.points)[mj])
    back = TEditor(device="cpu")
    back.open(str(tmp_path / "t_out"))
    keep = np.ones(n, bool)
    keep[sorted(ej.deleted | ej.selected)] = False
    np.testing.assert_array_equal(back.points, ej.points[keep])


def test_outlier_past_the_cap_is_selected(tmp_path):
    """The JAX editor copies only the first 131,072 points into its outlier
    search; the port's examines the whole map and selects an isolated point
    at index 133,000."""
    from glim_tpu_torch.io.dump import save_dump
    from glim_tpu_torch.types import PointBatch, SubMap
    from glim_tpu_torch.viewer.map_editor import MapEditor

    g = np.arange(0.0, 18.5, 0.05)
    grid = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)[:133_100]
    pts = np.c_[grid, np.zeros(len(grid))].astype(np.float32)
    pts[133_000] = [9.0, 9.0, 6.0]                       # 6 m above the floor
    # Stored covariances: loading re-estimates none (a brute-force kNN).
    covs = np.broadcast_to(np.eye(3, dtype=np.float32) * 1e-3, (len(pts), 3, 3))
    submaps = [SubMap(id=k, frame=PointBatch.from_numpy(pts[a:b], covs=covs[a:b],
                                                        device="cpu"))
               for k, (a, b) in enumerate(((0, 65_536), (65_536, 131_072), (131_072, None)))]
    save_dump(str(tmp_path / "big"), submaps, [np.eye(4)] * 3)
    ed = MapEditor(device="cpu")
    ed.open(str(tmp_path / "big"))
    assert len(ed.points) == 133_100 > 131_072
    ed.select_outliers()
    # The isolated point, and a few points of sparser neighbourhoods (the
    # grid's edges, the hole it left), past the cap too.
    assert 133_000 in ed.selected and len(ed.selected) < 0.05 * len(ed.points)


def test_knn_self_boxed_matches_ckdtree(monkeypatch):
    """The outlier kNN (knn_self_boxed) against scipy's cKDTree on a
    ~41,000-point cloud in over 2,500 tiles of 16: blobs, a floor, isolated
    points (their tenth neighbour lies beyond the box radius: re-searched)
    and, last along the Z-order curve, a 3-point corner that is a whole tile
    whose box holds fewer than k points. The points lie on a 1/8 m lattice
    within 40 m, so every float32 distance of both searches is exact and
    equal-distance neighbours are exact ties, which go to the lower index
    (the reference orders cKDTree's 64 nearest by distance, then index).
    Indices and squared distances must be equal."""
    from scipy.spatial import cKDTree

    from glim_tpu_torch.ops import knn

    rng = np.random.default_rng(8)
    blobs = [c + rng.normal(0, 1.5, (3000, 3)) for c in rng.uniform(-30, 30, (12, 3))]
    floor = np.c_[rng.uniform(-30, 30, (6000, 2)), np.zeros(6000)]
    lone = rng.uniform(-35, 35, (40, 3))
    pts = np.unique(np.round(np.concatenate(blobs + [floor, lone]) * 8) / 8, axis=0)
    pts = pts[rng.permutation(len(pts))[:len(pts) // 16 * 16]]
    corner = np.array([[38.0, 38.0, 38.0], [38.5, 38.0, 38.0], [38.0, 38.5, 38.0]])
    pts = torch.from_numpy(np.concatenate([pts, corner]).astype(np.float32))
    n, k, radius = len(pts), 10, 1.0
    monkeypatch.setattr(knn, "_BOXED_KEY_BYTES", 8 * 16 * n)
    assert knn._boxed_tile(n) == 16 and n // 16 > 2500 and n % 16 == 3

    idx, d2 = knn.knn_self_boxed(pts, k, radius)
    cd, ci = cKDTree(pts.numpy().astype(np.float64)).query(pts.numpy().astype(np.float64), 64)
    cd = cd ** 2
    assert np.all(cd[:, -1] > cd[:, k - 1])          # no tie group cut at 64
    first = np.lexsort((ci, cd), axis=1)[:, :k]
    ref_idx = torch.from_numpy(np.take_along_axis(ci, first, 1).astype(np.int32))
    ref_d2 = torch.from_numpy(np.take_along_axis(cd, first, 1).astype(np.float32))
    assert torch.equal(idx, ref_idx)
    assert torch.equal(d2, ref_d2)
    # The paths the cloud was built to reach: re-searched points, the
    # corner among them, and exact ties among the k.
    far = (ref_d2[:, -1] > radius * radius).nonzero().reshape(-1).tolist()
    assert {n - 3, n - 2, n - 1} <= set(far) and len(far) > 3
    assert bool((ref_d2[:, 1:] == ref_d2[:, :-1]).any(dim=1).sum() > 1000)


def _corner_dumps(tmp_path, offset_b):
    """Two sessions of two submaps of one room; the second ``offset_b`` m
    along x."""
    rng = np.random.default_rng(21)
    world = _room(rng, n=4000)
    out = []
    for name, off in (("a", 0.0), ("b", offset_b)):
        clouds, poses = [], []
        for k in range(2):
            T_true = lie_np.se3_exp(np.array([0.0, 0.0, 0.1 * k, 2.0 * k - 1.0, 0.0, 0.0]))
            sel = world[rng.choice(len(world), 1000, replace=False)]
            Ti = np.linalg.inv(T_true)
            clouds.append((sel @ Ti[:3, :3].T + Ti[:3, 3]
                           + rng.normal(0, 0.003, sel.shape)).astype(np.float32))
            T = T_true.copy()
            T[0, 3] += off
            poses.append(T)
        out.append(_save_dump(str(tmp_path / name), clouds, poses))
    return out


def _compare_graphs(gt, gj):
    assert len(gt.submaps) == len(gj.submaps)
    assert [s.session_id for s in gt.submaps] == [s.session_id for s in gj.submaps]
    assert [tuple(int(v) for v in m) for m in gt.matching_factors] == \
        [tuple(int(v) for v in m) for m in gj.matching_factors]
    assert [f[:2] for f in gt.between_factors] == [tuple(f[:2]) for f in gj.between_factors]
    for Tt, Tj in zip(gt.poses, gj.poses):
        d = lie_np.se3_log(np.linalg.inv(np.asarray(Tj)) @ np.asarray(Tt))
        assert np.abs(d).max() < POSE_ATOL, d


@pytest.mark.parametrize("case", ["open", "merge_anchored", "merge_aligned"])
def test_offline_viewer_matches_jax(tmp_path, monkeypatch, case):
    """OfflineViewer in both packages on the same dumps: open + optimize +
    export, a merge that the automatic overlap anchors, and one whose second
    session lies 60 m off, so the closest cross pair is aligned
    (ManualLoopClose.align, FPFH + GNC; both given the JAX k=1 search and
    covariances, C4)."""
    from glim_tpu.viewer.offline_viewer import OfflineViewer as JViewer
    from glim_tpu_torch.ops import gicp as t_gicp
    from glim_tpu_torch.ops import knn as t_knn
    from glim_tpu_torch.ops import registration as t_reg
    from glim_tpu_torch.viewer import interactive_tools as t_tools
    from glim_tpu_torch.viewer.offline_viewer import OfflineViewer as TViewer

    use_jax_nn_search(monkeypatch, t_gicp)
    use_jax_covariances(monkeypatch)
    _jax_knn(monkeypatch, t_knn, *[m for m in (t_reg, t_tools) if hasattr(m, "knn_self")])
    a, b = _corner_dumps(tmp_path, 60.0 if case == "merge_aligned" else 0.0)
    vj, vt = JViewer(), TViewer(device="cpu")
    for v in (vj, vt):
        v.open_map(a)
    if case != "open":
        pair = vt.merge_map(b)
        vj.merge_map(b)
        if case == "merge_anchored":
            assert pair is None
            assert any((i < 2) != (j < 2) for i, j in vt.global_mapping.matching_factors)
        else:
            assert pair == (1, 2) and vt.global_mapping.between_factors[-1][:2] == (1, 2)
            Zt = vt.global_mapping.between_factors[-1][2]
            Zj = vj.global_mapping.between_factors[-1][2]
            d = lie_np.se3_log(np.linalg.inv(np.asarray(Zj)) @ Zt)
            assert np.abs(d).max() < POSE_ATOL, d
    _compare_graphs(vt.global_mapping, vj.global_mapping)
    vj.optimize()
    vt.optimize()
    _compare_graphs(vt.global_mapping, vj.global_mapping)
    n = vt.export_ply(str(tmp_path / "t.ply"))
    vj.export_ply(str(tmp_path / "j.ply"))
    from glim_tpu_torch.native import ply_read
    pt, pj = ply_read(str(tmp_path / "t.ply")), ply_read(str(tmp_path / "j.ply"))
    assert n == len(pt) == len(pj)
    np.testing.assert_allclose(pt, pj, atol=5 * POSE_ATOL * (1 + np.abs(pj).max()))
    assert (tmp_path / "render_hints.json").exists()
    vt.save(str(tmp_path / "saved"))
    assert (tmp_path / "saved" / "render_hints.json").exists()


def _ring_dump(tmp_path):
    """test_torch_interactive's drifted 6-submap ring, saved by the port."""
    from test_torch_interactive import _ring_viewer

    viewer = _ring_viewer()
    path = str(tmp_path / "ring")
    viewer.gm.save(path)
    return path


def test_repl_exec_matches_jax(tmp_path, monkeypatch, capsys):
    """interactive_viewer --exec in both packages on the port's drifted ring
    dump (both given the JAX k=1 search and covariances, C4): list,
    factors, a loop closure, optimize and save give the same results."""
    import json

    from glim_tpu.tools.interactive_viewer import main as j_main
    from glim_tpu_torch.io.dump import load_dump
    from glim_tpu_torch.ops import gicp as t_gicp
    from glim_tpu_torch.tools.interactive_viewer import main as t_main

    use_jax_nn_search(monkeypatch, t_gicp)
    use_jax_covariances(monkeypatch)
    dump = _ring_dump(tmp_path)
    lines = ["list", "factors", "loop_close 4 5", "optimize", "bogus", "loop_close 1",
             f"save {tmp_path / 'j'}"]
    capsys.readouterr()
    assert j_main([dump] + sum((["--exec", line] for line in lines), [])) == 0
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    t_lines = [line.replace(f"{tmp_path / 'j'}", f"{tmp_path / 't'}") for line in lines]
    run = t_main([dump, "--device", "cpu"] + sum((["--exec", line] for line in t_lines), []))
    got = [out for _, out in run["results"]]
    assert len(got) == len(printed) == 5              # two lines are input errors
    for out_t, out_j in zip(got, printed):
        assert out_t["ok"] == out_j["ok"] is True
    for st, sj in zip(got[0]["submaps"], printed[0]["submaps"]):
        assert st["id"] == sj["id"] and st["points"] == sj["points"]
        np.testing.assert_allclose([st["x"], st["y"], st["z"]], [sj["x"], sj["y"], sj["z"]],
                                   atol=1e-6)
    assert got[1] == {k: v for k, v in printed[1].items()}
    assert abs(got[2]["inlier_fraction"] - printed[2]["inlier_fraction"]) < POSE_ATOL
    d = lie_np.se3_log(np.linalg.inv(np.asarray(printed[2]["T_target_source"]))
                       @ np.asarray(got[2]["T_target_source"]))
    assert np.abs(d).max() < POSE_ATOL, d
    _, pj, _ = load_dump(str(tmp_path / "j"), "cpu")
    _, pt, _ = load_dump(str(tmp_path / "t"), "cpu")
    for Tt, Tj in zip(pt, pj):
        assert np.abs(lie_np.se3_log(np.linalg.inv(Tj) @ Tt)).max() < POSE_ATOL


def test_cli_outputs_match_jax(tmp_path):
    """The map editor and offline viewer CLIs write the JAX CLIs' PLY files
    byte for byte, and the edited dumps hold the same points."""
    from glim_tpu.tools.map_editor import main as j_editor
    from glim_tpu.tools.offline_viewer import main as j_viewer
    from glim_tpu_torch.tools.map_editor import main as t_editor
    from glim_tpu_torch.tools.offline_viewer import main as t_viewer
    from glim_tpu_torch.viewer.map_editor import MapEditor

    dump = _room_dump(tmp_path)
    args = [dump, "--select-radius", "0", "0", "25", "3", "--select-box", "0", "0", "0",
            "1", "1", "0.5", "--invert"]
    assert j_editor(args + ["--save", str(tmp_path / "je"), "--ply", str(tmp_path / "je.ply")]) \
        == 0
    assert t_editor(args + ["--save", str(tmp_path / "te"), "--ply", str(tmp_path / "te.ply"),
                            "--device", "cpu"]) == 0
    assert (tmp_path / "te.ply").read_bytes() == (tmp_path / "je.ply").read_bytes()
    assert t_editor([dump, "--select-outliers", "--dry-run", "--device", "cpu"]) == 0
    edited = [MapEditor(device="cpu") for _ in range(2)]
    for e, name in zip(edited, ("je", "te")):
        e.open(str(tmp_path / name))
    np.testing.assert_array_equal(edited[1].points, edited[0].points)
    j_viewer(["open", dump, "--ply", str(tmp_path / "jo.ply")])
    ov = t_viewer(["open", dump, "--ply", str(tmp_path / "to.ply"), "--device", "cpu"])
    assert len(ov.global_mapping.submaps) == 3
    assert (tmp_path / "to.ply").read_bytes() == (tmp_path / "jo.ply").read_bytes()
    j_viewer(["edit", dump, "--remove-radius", "0", "0", "25", "3", "--save", str(tmp_path / "jr")])
    t_viewer(["edit", dump, "--remove-radius", "0", "0", "25", "3", "--save", str(tmp_path / "tr"),
              "--device", "cpu"])
    for e, name in zip(edited, ("jr", "tr")):
        e.open(str(tmp_path / name))
    np.testing.assert_array_equal(edited[1].points, edited[0].points)


def _ply_with(path, pts, extra):
    """A binary little-endian PLY of float x, y, z followed by ``extra``
    [(type, name, numpy dtype)] per-vertex properties."""
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(pts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              + "".join(f"property {t} {n}\n" for t, n, _ in extra) + "end_header\n")
    dtype = np.dtype([("xyz", "<f4", 3)] + [(n, d) for _, n, d in extra])
    rows = np.zeros(len(pts), dtype)
    rows["xyz"] = pts
    for k, (_, n, _) in enumerate(extra):
        rows[n] = np.arange(len(pts)) % 200 + k
    with open(path, "wb") as f:
        f.write(header.encode() + rows.tobytes())


@pytest.mark.parametrize("extra", [
    [], [("float", "intensity", "<f4")], [("uchar", "ring", "u1")],
    [("double", "t", "<f8")],
    [("float", "intensity", "<f4"), ("uchar", "ring", "u1"), ("double", "t", "<f8")]])
def test_ply_read_matches_the_cpp_reader(tmp_path, extra):
    from glim_tpu import native
    from glim_tpu_torch.io.loaders import load_scan_file
    from glim_tpu_torch.native import ply_read, ply_write

    assert native.available()                   # the JAX package's C++ build (g++)
    pts = np.random.default_rng(22).normal(size=(501, 3)).astype(np.float32) * 10
    p = str(tmp_path / "scan.ply")
    _ply_with(p, pts, extra)
    got = ply_read(p)
    np.testing.assert_array_equal(got, native.ply_read(p))
    np.testing.assert_array_equal(got, pts)
    np.testing.assert_array_equal(load_scan_file(p), pts)
    np.testing.assert_array_equal(ply_read(p, max_points=100), pts[:100])
    ply_write(str(tmp_path / "t.ply"), pts)
    native.ply_write(str(tmp_path / "j.ply"), pts)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    with open(p, "r+b") as f:                   # cut the last vertex short
        f.truncate(os.path.getsize(p) - 1)
    with pytest.raises(ValueError, match="vertices"):
        ply_read(p)


def test_chip_smoke_offline_tools_rehearsal_on_cpu(tmp_path):
    """chip_smoke.py's phase 12c at a tiny size on the CPU: open / merge /
    REPL / editor with the phase's checks, on a room dump whose floor is as
    dense as a full-size map's (region growing's 0.5 m edges need ~13
    points a square metre; phase 12a's dump at the rehearsal's size has
    far fewer)."""
    import chip_smoke

    dump = _room_dump(tmp_path, n=6000)
    res = chip_smoke.run_offline_tools("cpu", dump, str(tmp_path), segment_cap=2048)
    chip_smoke.check_offline_tools(res)
    assert res["merge_launches"] == 0 and not res["on_card"]


@pytest.mark.gpu
def test_map_editor_on_the_card_matches_cpu(tmp_path, cuda):
    """The editor's selections on the card against the same editor on the
    CPU: the same radius, box and outlier sets, and min-cut and region
    growing within Jaccard 0.99."""
    from glim_tpu_torch.viewer.map_editor import MapEditor

    dump = _room_dump(tmp_path)
    eds = [MapEditor(device=d) for d in (cuda, "cpu")]
    for e in eds:
        e.open(dump)
    seed = eds[1].points[np.argmin(np.linalg.norm(eds[1].points - [2.0, 1.0, 0.8], axis=1))]
    T_box = np.eye(4)
    for fn, exact in ((lambda e: e.select_radius(eds[1].points[-4], 2.0), True),
                      (lambda e: e.select_box(T_box, [2.0, 1.5, 1.0]), True),
                      (lambda e: e.select_outliers(), True),
                      (lambda e: e.select_segmentation(seed, "min_cut"), False),
                      (lambda e: e.select_segmentation(seed, "region_growing"), False)):
        for e in eds:
            e.clear_selection()
            fn(e)
        a, b = eds[0].selected, eds[1].selected
        assert a and (a == b if exact else len(a & b) / len(a | b) >= 0.99)


@pytest.mark.gpu
def test_repl_loop_close_on_the_card(tmp_path, cuda):
    """The REPL's loop_close on the card against the CPU: the same
    correction within 1e-4, and exactly sum (1 + trial steps) + 2
    nn_search launches."""
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.tools.interactive_viewer import main
    from glim_tpu_torch.viewer import interactive_tools

    dump = _ring_dump(tmp_path)
    align = interactive_tools.ManualLoopClose.align
    steps = []
    try:
        interactive_tools.ManualLoopClose.align = \
            lambda self, *a, **k: steps.append(align(self, *a, **k)) or steps[-1]
        nn_search.kernel_launches = 0
        card = main([dump, "--device", "cuda", "--exec", "loop_close 4 5"])
        launches = nn_search.kernel_launches
        host = main([dump, "--device", "cpu", "--exec", "loop_close 4 5"])
    finally:
        interactive_tools.ManualLoopClose.align = align
    assert launches == sum(1 + s for s in steps[0].lm_trial_steps) + 2
    (_, oc), (_, oh) = card["results"][0], host["results"][0]
    assert oc["ok"] and oh["ok"]
    d = lie_np.se3_log(np.linalg.inv(np.asarray(oh["T_target_source"]))
                       @ np.asarray(oc["T_target_source"]))
    assert np.abs(d).max() < POSE_ATOL and abs(oc["inlier_fraction"] - oh["inlier_fraction"]) < 1e-3
