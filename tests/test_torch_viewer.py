"""The port's headless viewer surface (glim_tpu_torch/viewer: the run stream,
the standard viewer, the memory monitor; tools/watch.py; the
common/cloud_* front-ends) against the JAX package's on the same inputs.

A stream line for the same inputs must be equal after JSON parsing; the
standard viewer's poses, TUM export and stream content equal the JAX
viewer's for the same callback stream (the port takes a frame in one frame
late, so what a line carries besides the frame's own pose and scan is what
JAX's next line carries)."""

import json
import threading
import types as pytypes
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu_torch.utils.callbacks import CallbackSlot


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    before = [len(s) for s in CallbackSlot._ALL]
    yield
    from glim_tpu_torch.utils import lifecycle
    lifecycle.stop_all()
    # Each viewer built here detached itself.
    assert [len(s) for s in CallbackSlot._ALL[:len(before)]] == before
    CallbackSlot.clear_all()


def _pose(rng):
    from glim_tpu.ops import lie_np
    return lie_np.se3_exp(rng.normal(0, 0.5, 6))


def test_stream_line_matches_jax(tmp_path):
    from glim_tpu.viewer.stream_writer import ViewerStream as JStream
    from glim_tpu_torch.viewer.stream_writer import ViewerStream as TStream

    rng = np.random.default_rng(4)
    args = (12.345678, [_pose(rng) for _ in range(3)], [_pose(rng) for _ in range(2)],
            rng.normal(0, 10, (3000, 3)), dict(frames=3, keyframes=1, submaps=2, mb=0.4))
    kw = dict(clouds={0: rng.normal(0, 5, (40, 3)), 7: rng.normal(0, 5, (5, 3))},
              factors=[(0, 1, "m"), (1, 2, "b")])
    lines = []
    for cls, name in ((JStream, "j.jsonl"), (TStream, "t.jsonl")):
        s = cls(str(tmp_path / name), scan_budget=500)
        s.emit(*args, **kw)
        s.emit(*args[:3], None, args[4])
        s.close()
        lines.append([json.loads(x) for x in (tmp_path / name).read_text().splitlines()])
    assert lines[0] == lines[1] and len(lines[0]) == 2
    assert len(lines[1][0]["scan"]) == 500 and "scan" not in lines[1][1]


def _feed(viewers, rng, n_frames=12, submap_at=(4, 9)):
    """The same callback stream into a JAX viewer and a port viewer."""
    from glim_tpu.mapping.callbacks import GlobalMappingCallbacks as JG
    from glim_tpu.mapping.callbacks import SubMappingCallbacks as JS
    from glim_tpu.odometry.callbacks import OdometryEstimationCallbacks as JO
    from glim_tpu.types import PointBatch as JPB
    from glim_tpu.types import SubMap as JSM
    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as TG
    from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks as TS
    from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks as TO
    from glim_tpu_torch.types import EstimationFrame
    from glim_tpu_torch.types import PointBatch as TPB
    from glim_tpu_torch.types import SubMap as TSM

    submaps_j, submaps_t = [], []
    for k in range(n_frames):
        T = _pose(rng)
        pts = rng.normal(0, 8, (2048, 3)).astype(np.float32)
        mask = rng.uniform(size=2048) > 0.3
        JO.on_new_frame(pytypes.SimpleNamespace(
            stamp=0.1 * k, T_world_sensor=lambda T=T: T,
            frame=JPB(points=jnp.asarray(pts), mask=jnp.asarray(mask))))
        TO.on_new_frame(EstimationFrame(id=k, stamp=0.1 * k, T_world_lidar=T,
                                        frame=TPB(points=torch.from_numpy(pts),
                                                  mask=torch.from_numpy(mask))))
        JO.on_update_keyframes([0, 1])
        TO.on_update_keyframes([0, 1])
        if k in submap_at:
            sid = len(submaps_j)
            T_o = _pose(rng)
            cpts = rng.normal(0, 5, (3000, 3)).astype(np.float32)
            cmask = rng.uniform(size=3000) > 0.5
            # A submap holds frames estimated a while before (the window lag).
            fr = pytypes.SimpleNamespace(stamp=0.1 * (k - 2))
            submaps_j.append(JSM(id=sid, T_world_origin=T_o, frames=[fr], frame=JPB(
                points=jnp.asarray(cpts), mask=jnp.asarray(cmask))))
            submaps_t.append(TSM(id=sid, T_world_origin=T_o, frames=[fr], frame=TPB(
                points=torch.from_numpy(cpts), mask=torch.from_numpy(cmask))))
            JS.on_new_submap(submaps_j[-1])
            TS.on_new_submap(submaps_t[-1])
            graph = pytypes.SimpleNamespace(matching_factors=[(0, sid)],
                                            between_factors=[(0, sid, None, None)])
            JG.on_smoother_update(graph, None, None)
            TG.on_smoother_update(graph, None, None)
            JG.on_update_submaps(submaps_j)
            TG.on_update_submaps(submaps_t)


def test_standard_viewer_matches_jax(tmp_path):
    from glim_tpu.viewer.standard_viewer import StandardViewer as JV
    from glim_tpu_torch.viewer.standard_viewer import StandardViewer as TV

    jv = JV(stream_path=str(tmp_path / "j.jsonl"), stream_interval=0.0)
    tv = TV(stream_path=str(tmp_path / "t.jsonl"), stream_interval=0.0)
    try:
        _feed((jv, tv), np.random.default_rng(7))
        jv.at_exit(str(tmp_path / "jd"))
        tv.at_exit(str(tmp_path / "td"))
    finally:
        jv.detach()
        tv.detach()
    assert (tmp_path / "td" / "viewer_odom.txt").read_text() == \
        (tmp_path / "jd" / "viewer_odom.txt").read_text()
    sj, st = jv.snapshot(), tv.snapshot()
    for key in ("odom_stamps", "num_keyframes", "num_marginalized", "render_hints"):
        assert st[key] == sj[key], key
    for key in ("odom_poses", "submap_poses"):
        np.testing.assert_array_equal(np.stack(st[key]), np.stack(sj[key]))
    np.testing.assert_allclose(st["T_world_odom"], sj["T_world_odom"], atol=1e-12)
    assert tv.frame_bytes == jv.frame_bytes
    lines = [[json.loads(x) for x in (tmp_path / f).read_text().splitlines()]
             for f in ("j.jsonl", "t.jsonl")]
    assert len(lines[0]) == len(lines[1]) == 12
    for key in ("t", "seq", "odom", "scan"):
        assert [ln[key] for ln in lines[1]] == [ln[key] for ln in lines[0]], key
    # The port writes frame k's line when frame k + 1 is announced: the
    # submaps and counters it carries are those JAX's line k + 1 carries.
    j_next, t_prev = lines[0][1:], lines[1][:-1]
    assert [ln["submaps"] for ln in t_prev] == [ln["submaps"] for ln in j_next]
    for key in ("frames", "mb"):
        assert [ln["stats"][key] for ln in lines[1]] == [ln["stats"][key] for ln in lines[0]]
    for key in ("keyframes", "submaps"):
        assert [ln["stats"][key] for ln in t_prev] == [ln["stats"][key] for ln in j_next], key
    merged = [{k: v for ln in ls for k, v in ln.get("clouds", {}).items()} for ls in lines]
    assert merged[1] == merged[0] and len(merged[0]) == 2
    assert [ln["factors"] for ln in lines[1] if "factors" in ln] == \
        [ln["factors"] for ln in lines[0] if "factors" in ln]


def test_standard_viewer_reads_config_viewer(tmp_path):
    """The factory reads config_viewer as the JAX one does (stream path,
    rendering hints); without a GlobalConfig it takes the defaults."""
    from glim_tpu_torch.utils.config import GlobalConfig
    from glim_tpu_torch.utils.registry import load_module
    import chip_smoke

    GlobalConfig.reset()
    v = load_module("extension", "libstandard_viewer.so")
    assert v.stream is None and v.render_hints["point_size"] == 0.025
    v.detach()
    cfg = chip_smoke.config_dir([
        ("config_viewer", "standard_viewer", "stream_path", str(tmp_path / "s.jsonl")),
        ("config_viewer", "standard_viewer", "point_size", 0.5)])
    GlobalConfig.instance(cfg)
    try:
        v = load_module("extension", "libstandard_viewer.so")
        assert v.stream is not None and v.render_hints["point_size"] == 0.5
        v.at_exit(str(tmp_path / "d"))
        v.detach()
    finally:
        GlobalConfig.reset()


def test_memory_monitor_reads_and_fails_loudly(monkeypatch):
    """On the CPU there is no device memory to read; a failed read ends the
    monitor's thread and ok() re-raises it (the JAX monitor returns None)."""
    from glim_tpu_torch.utils.lifecycle import WorkerFailed
    from glim_tpu_torch.viewer import memory_monitor as mm

    assert mm.device_memory_stats("cpu") is None
    assert mm.read_meminfo().get("MemTotal", 0) > 0 and mm.read_self_rss() > 0
    mon = mm.MemoryMonitor(interval=0.01, device="cpu")
    mon.poll()
    assert mon.ok() and mon.device_reads == 0
    mon.stop()

    def broken(device):
        raise RuntimeError("device memory read failed")
    monkeypatch.setattr(mm, "device_memory_stats", broken)
    mon = mm.MemoryMonitor(interval=0.01, device="cpu")
    mon.worker.thread.join(5.0)
    with pytest.raises(WorkerFailed, match="device memory read failed"):
        mon.ok()
    with pytest.raises(WorkerFailed):
        mon.at_exit("")


@pytest.mark.gpu
def test_memory_monitor_reads_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from glim_tpu_torch.viewer import memory_monitor as mm

    mon = mm.MemoryMonitor(interval=3600.0, device="cuda")
    x = torch.zeros(1 << 20, device="cuda")
    mon.poll()
    st = mon.last_device_stats
    assert mon.device_reads == 1 and st["bytes_in_use"] >= x.numel() * 4
    assert 0 < st["bytes_free"] < st["bytes_limit"]
    mon.stop()


def test_watch_serves_page_stream_and_commands(tmp_path):
    """tools/watch.py on a localhost port: the port's page, the stream, and
    POST /command appended to the command file (bad JSON refused)."""
    from glim_tpu_torch.tools import watch

    (tmp_path / "s.jsonl").write_text('{"t": 0.0}\n')
    srv = watch.make_server(str(tmp_path / "s.jsonl"), str(tmp_path / "c.jsonl"),
                            "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        page = urllib.request.urlopen(base + "/").read().decode()
        assert "glim_tpu_torch run viewer" in page
        assert urllib.request.urlopen(base + "/stream").read() == b'{"t": 0.0}\n'
        req = urllib.request.Request(base + "/command", data=b'{"cmd": "status"}',
                                     method="POST")
        assert json.loads(urllib.request.urlopen(req).read()) == {"ok": True}
        bad = urllib.request.Request(base + "/command", data=b"{nope", method="POST")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(bad)
        assert (tmp_path / "c.jsonl").read_text() == '{"cmd": "status"}\n'
    finally:
        srv.shutdown()
        srv.server_close()


def test_cloud_front_ends_match_jax():
    from glim_tpu.common.cloud_covariance_estimation import CloudCovarianceEstimation as JC
    from glim_tpu.common.cloud_deskewing import CloudDeskewing as JD
    from glim_tpu.ops import knn as j_knn
    from glim_tpu.ops import lie_np
    from glim_tpu_torch.common.cloud_covariance_estimation import CloudCovarianceEstimation as TC
    from glim_tpu_torch.common.cloud_deskewing import CloudDeskewing as TD

    rng = np.random.default_rng(3)
    pts = rng.normal(0, 3, (256, 3)).astype(np.float32)
    pts[:, 2] *= 0.05                                    # planar-ish
    mask = rng.uniform(size=256) > 0.1
    nbr, _ = j_knn.knn_search(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pts),
                              jnp.asarray(mask), k=8)
    nbr = np.asarray(nbr)
    for mode in (TC.PLANE, TC.NORMALIZED_MIN_EIG, TC.FROBENIUS):
        cj, nj = JC(mode).estimate(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(nbr))
        ct, nt = TC(mode).estimate(torch.from_numpy(pts), torch.from_numpy(mask),
                                   torch.from_numpy(nbr))
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-4)
        np.testing.assert_allclose(np.abs(nt.numpy()), np.abs(np.asarray(nj)), atol=2e-3)
    times = rng.uniform(0, 0.1, 256).astype(np.float32)
    twist = np.array([0.1, -0.2, 0.3, 1.0, 0.5, -0.2])
    np.testing.assert_allclose(
        TD().deskew_twist(torch.from_numpy(pts), torch.from_numpy(times),
                          torch.from_numpy(mask), twist).numpy(),
        np.asarray(JD().deskew_twist(jnp.asarray(pts), jnp.asarray(times), jnp.asarray(mask),
                                     twist)), atol=1e-5)
    stamps = np.linspace(-0.01, 0.12, 8).astype(np.float32)
    Rs = np.stack([lie_np.so3_exp(np.array([0.0, 0.0, 0.3 * t])) for t in stamps])
    ps = np.stack([[t, 0.5 * t, 0.0] for t in stamps])
    T_li = lie_np.se3_exp(np.array([0.0, 0.0, 0.1, 0.05, 0.0, 0.02]))
    np.testing.assert_allclose(
        TD().deskew_imu(torch.from_numpy(pts), torch.from_numpy(times), torch.from_numpy(mask),
                        stamps, Rs, ps, T_li).numpy(),
        np.asarray(JD().deskew_imu(jnp.asarray(pts), jnp.asarray(times), jnp.asarray(mask),
                                   stamps, Rs, ps, T_li)), atol=1e-5)
