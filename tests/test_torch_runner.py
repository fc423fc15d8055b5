"""The port's offline runner (glim_tpu_torch/tools/glim_runner.py): a tiny
synthetic run on the CPU whose dump the JAX package's ``load_dump`` reads,
the dataset directory layout against the JAX runner's reader, the scan
loaders against the JAX package's, the runner options of the modules
ported since (the viewer stream, live commands, ROS bag playback), and the
extension names the port lacks."""

import os

import numpy as np
import pytest
import torch

from torch_parity import SMALL_DEFAULT_OVERRIDES


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils import lifecycle
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


def test_synthetic_run_writes_a_dump_jax_reads(tmp_path):
    import chip_smoke
    from glim_tpu.io.dump import load_dump as j_load_dump
    from glim_tpu_torch.tools import glim_runner

    dump = str(tmp_path / "dump")
    run = glim_runner.main(["--synthetic", "2.0", "--device", "cpu", "--dump", dump,
                            "--config", chip_smoke.config_dir(SMALL_DEFAULT_OVERRIDES)])
    glim = run["glim"]
    assert run["scans"] == 20 and run["seconds"] > run["wait_seconds"] > 0
    assert len(glim.odometry_estimates) >= 15
    gm = glim.global_backend
    assert len(gm.submaps) >= 2
    for name in ("graph.txt", "graph.npz", "graph.bin", "values.bin", "traj_lidar.txt",
                 "000000/data.txt", "000000/points_compact.bin", "config/config.json"):
        assert os.path.exists(os.path.join(dump, name)), name
    submaps, poses, factors = j_load_dump(dump)
    assert [s.id for s in submaps] == [s.id for s in gm.submaps]
    np.testing.assert_array_equal(np.stack(poses), np.stack(gm.poses))
    assert [tuple(int(v) for v in m) for m in factors["matching"]] == gm.matching_factors
    for s_j, s_t in zip(submaps, gm.submaps):
        assert [f.id for f in s_j.frames] == [f.id for f in s_t.frames]
        mask = s_t.frame.mask.numpy()
        np.testing.assert_array_equal(np.asarray(s_j.frame.points)[np.asarray(s_j.frame.mask)],
                                      s_t.frame.points.numpy()[mask])


def test_pose_graph_run_writes_a_dump_jax_reads(tmp_path):
    """The runner on the pose-graph configuration (the registry loads
    libglobal_mapping_pose_graph.so in the async pipeline): its dump's
    between factors, with their (6,) information rows and Huber widths,
    read back by the JAX package."""
    import chip_smoke
    from glim_tpu.io.dump import load_dump as j_load_dump
    from glim_tpu_torch.tools import glim_runner

    dump = str(tmp_path / "dump")
    run = glim_runner.main(["--synthetic", "2.0", "--device", "cpu", "--dump", dump, "--config",
                            chip_smoke.config_dir(chip_smoke.POSE_GRAPH_EDITS
                                                  + SMALL_DEFAULT_OVERRIDES)])
    gm = run["glim"].global_backend
    assert type(gm).__name__ == "GlobalMappingPoseGraph" and gm.detector is None
    assert len(gm.submaps) >= 2 and len(gm.f_i) >= len(gm.submaps) - 1
    submaps, poses, factors = j_load_dump(dump)
    assert [s.id for s in submaps] == [s.id for s in gm.submaps]
    np.testing.assert_array_equal(np.stack(poses), np.stack(gm.poses))
    assert list(factors["i"]) == gm.f_i and list(factors["j"]) == gm.f_j
    np.testing.assert_array_equal(factors["huber"], gm.f_huber)


def test_dataset_directory_round_trip(tmp_path):
    """save_dataset writes what both packages' load_dataset read back
    exactly."""
    from glim_tpu.tools.glim_runner import load_dataset as j_load
    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.tools.glim_runner import load_dataset, save_dataset

    seq = generate_sequence(duration=0.5, n_scan_points=300, scene_points=3000, seed=4)
    scans = [(s.stamp, s.points, s.times) for s in seq.scans]
    save_dataset(str(tmp_path / "ds"), seq.imu, scans)
    for imu, got in (load_dataset(str(tmp_path / "ds")), j_load(str(tmp_path / "ds"))):
        np.testing.assert_array_equal(imu, seq.imu)
        assert len(got) == len(scans)
        for (st, pts, times), (st0, pts0, times0) in zip(got, scans):
            assert st == st0
            np.testing.assert_array_equal(pts, pts0)
            np.testing.assert_array_equal(times, times0)


def test_scan_loaders_match_jax(tmp_path):
    from glim_tpu.io.loaders import load_scan_file as j_load
    from glim_tpu_torch.io.loaders import load_scan_file as t_load

    rng = np.random.default_rng(2)
    pts4 = rng.normal(size=(257, 4)).astype(np.float32)
    np.save(str(tmp_path / "a.npy"), pts4.astype(np.float64))
    pts4.tofile(str(tmp_path / "b.bin"))
    for name in ("a.npy", "b.bin"):
        np.testing.assert_array_equal(t_load(str(tmp_path / name)),
                                      j_load(str(tmp_path / name)))
    with pytest.raises(ValueError, match="unsupported"):
        t_load(str(tmp_path / "c.pcd"))


@pytest.mark.parametrize("argv, module", [
    (["--viewer-stream", "s.jsonl"], "viewer"),
    (["--commands", "c.jsonl"], "interactive_viewer"),
    (["--points-topic", "/points"], "rosbag"),
])
def test_unported_runner_options_raise(tmp_path, argv, module):
    """The runner options of the modules ported since: the viewer stream,
    the command file and (io/rosbag) a bag's points topic, each run on a
    three-scan sequence (a stream line a scan, a command answered after the
    first, the bag's three scans played into a dump)."""
    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.tools import glim_runner

    ds = tmp_path / "ds"
    seq = generate_sequence(duration=0.3, n_scan_points=300, scene_points=3000, seed=4)
    if module == "rosbag":
        from test_rosbag import make_db3
        ds.mkdir()
        make_db3(str(ds / "bag_0.db3"), _bag_messages(seq, ros1=False))
        _check_bag_run(glim_runner.main([str(ds), "--device", "cpu", "--dump",
                                         str(tmp_path / "d")] + argv), tmp_path / "d")
        return
    glim_runner.save_dataset(str(ds), seq.imu, [(s.stamp, s.points, s.times)
                                                for s in seq.scans])
    path = str(tmp_path / argv[1])
    if module == "interactive_viewer":
        (tmp_path / argv[1]).write_text('{"cmd": "status"}\nnot json\n')
    run = glim_runner.main([str(ds), "--device", "cpu", "--dump", str(tmp_path / "d"),
                            argv[0], path])
    assert run["scans"] == 3
    if module == "viewer":
        assert run["viewer"] is not None and (tmp_path / "d" / "viewer_odom.txt").exists()
        assert os.path.getsize(path) > 0
    else:
        assert [(c["cmd"], out["ok"]) for c, out in run["command_results"]] == [("status", True)]
    run["glim"].wait()


def _bag_messages(seq, ros1: bool):
    """``seq`` as bag records (topic, type, stamp_ns, payload) in time order,
    encoded by tests/test_rosbag.py's writers; each scan logged at its end."""
    import test_rosbag as tr

    pc2, imu = ((tr.encode_pointcloud2_ros1, tr.encode_imu_ros1) if ros1
                else (tr.encode_pointcloud2, tr.encode_imu))
    sep = "/" if ros1 else "/msg/"
    msgs = [("/imu", f"sensor_msgs{sep}Imu", int(round(r[0] * 1e9)), imu(r[0], r[1:4], r[4:7]))
            for r in seq.imu]
    msgs += [("/points", f"sensor_msgs{sep}PointCloud2", int(round((s.stamp + 0.1) * 1e9)),
              pc2(s.stamp, s.points.astype(np.float32), s.times)) for s in seq.scans]
    return sorted(msgs, key=lambda m: m[2])


def _check_bag_run(run, dump):
    """Every scan of the bag fed, the IMU's scale detected, and a dump the
    port loads back."""
    from glim_tpu_torch.io.dump import load_dump

    assert run["scans"] == 3 and run["acc_scale"] == 1.0 and run["decode_seconds"] > 0
    for name in ("graph.txt", "traj_lidar.txt", "odom_lidar.txt", "config/config.json"):
        assert os.path.exists(os.path.join(dump, name)), name
    submaps, poses, _ = load_dump(str(dump), "cpu")
    assert len(submaps) == len(run["glim"].submaps) and len(poses) == len(submaps)


def test_bag_playback_raises(tmp_path):
    """A ROS1 bag (run.bag) of a three-scan sequence plays through the
    runner into a dump (it raised before io/rosbag was ported)."""
    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.tools import glim_runner
    from test_rosbag import make_rosbag1

    seq = generate_sequence(duration=0.3, n_scan_points=300, scene_points=3000, seed=4)
    make_rosbag1(str(tmp_path / "run.bag"), _bag_messages(seq, ros1=True), compress="bz2")
    run = glim_runner.main([str(tmp_path / "run.bag"), "--device", "cpu",
                            "--dump", str(tmp_path / "d")])
    _check_bag_run(run, tmp_path / "d")


def test_extension_modules_raise(tmp_path):
    """A module the port lacks raises, naming it; the ported ones load
    (librviz_viewer.so too, since ros/rviz_viewer.py is ported)."""
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir

    cfg = create_default_config_dir(str(tmp_path / "cfg"))
    with pytest.raises(NotImplementedError, match="libno_such_viewer.so"):
        GlimTorch(cfg, extension_modules=["libno_such_viewer.so"], device="cpu")
    glim = GlimTorch(cfg, extension_modules=["librviz_viewer.so"], device="cpu")
    assert [type(e).__name__ for e in glim.extensions] == ["RvizViewer"]
    glim.wait()
    for e in glim.extensions:
        e.detach()
    glim = GlimTorch(cfg, extension_modules=["libscan_context_loop_detector.so"], device="cpu")
    assert [type(e).__name__ for e in glim.extensions] == ["ScanContextLoopDetector"]
    glim.wait()
    GlimTorch(cfg, extension_modules=[], device="cpu").wait()


def test_system_info_names_the_stack():
    from glim_tpu_torch.utils.debug import print_system_info, system_info

    info = system_info()
    assert info["torch"] == torch.__version__ and info["cuda_available"] == \
        torch.cuda.is_available()
    assert info["tf32_matmul"] is False
    print_system_info()


def test_chip_smoke_async_rehearsal_on_cpu(tmp_path):
    """chip_smoke.py's phase 6 at a tiny size on the CPU: the runner over a
    dataset directory against the sync run of the same sequence, the dump
    loaded back and merged as a second session, with the phase's checks;
    then the GICP slice asynchronously."""
    import chip_smoke

    size = dict(n_scans=25, n_scan_points=1500, scene_points=20000, seed=53)
    sync = chip_smoke.run_default("cpu", overrides=SMALL_DEFAULT_OVERRIDES, **size)
    res = chip_smoke.run_async_default("cpu", overrides=SMALL_DEFAULT_OVERRIDES,
                                       work_dir=str(tmp_path), **size)
    chip_smoke.check_async(res, sync)
    assert os.listdir(str(tmp_path)) == []           # dataset and dump removed
    assert res["max_queue_depth"]["odometry"] >= 1 and res["dump_mib"] > 0
    assert res["busy_host_ms_per_scan"]["odometry"] > 0
    assert res["busy_host_ms_per_scan"]["global_mapping"] > 0
    gicp = chip_smoke.run_slice(
        "cpu", n_scans=20, n_scan_points=1500, scene_points=20000, seed=53, async_mode=True,
        sub_mapping_overrides=dict(max_num_keyframes=4),
        odometry_overrides=dict(window_size=6, initialization_window_size=0.3,
                                model_capacity=8192),
        preprocess_overrides=dict(random_downsample_target=1000, downsample_resolution=0.4))
    assert gicp["between_launches"] is None and gicp["kernel_launches"] == 0
    chip_smoke.check_slice(gicp, min_window_steps=5)


def test_command_poller_playback_protocol(tmp_path):
    """The runner poller's playback controls, as in the JAX package: pause
    blocks the feed gate, step lets one scan through, resume unblocks."""
    import threading
    import time as _time
    import types as pytypes

    from glim_tpu_torch.tools.glim_runner import _make_command_poller, _playback_gate

    glim = pytypes.SimpleNamespace(global_backend=pytypes.SimpleNamespace(submaps=[]),
                                   global_mapping=None)
    path = tmp_path / "commands.jsonl"
    controls = {"paused": False, "step": 0}
    poll = _make_command_poller(glim, str(path), controls)
    with open(path, "a") as f:
        f.write('{"cmd": "pause"}\n')
    poll()
    assert controls["paused"]
    passed = []

    def feed():
        _playback_gate(controls, poll)
        passed.append(_time.monotonic())
    th = threading.Thread(target=feed)
    th.start()
    _time.sleep(0.25)
    assert not passed, "the gate let a scan through while paused"
    with open(path, "a") as f:
        f.write('{"cmd": "step", "n": 1}\n')
    th.join(timeout=10.0)
    assert passed and controls["paused"] and controls["step"] == 0
    with open(path, "a") as f:
        f.write('{"cmd": "resume"}\n')
    poll()
    assert not controls["paused"]
    t0 = _time.monotonic()
    _playback_gate(controls, poll)
    assert _time.monotonic() - t0 < 0.2
    assert [c["cmd"] for c, _ in poll.results] == ["pause", "step", "resume"]


def test_chip_smoke_live_corrections_rehearsal_on_cpu(tmp_path):
    """chip_smoke.py's phase 11c at a tiny size on the CPU: the runner with
    --viewer-stream and --commands, a helper thread appending the live
    corrections once the stream shows three submaps, with the phase's
    checks (no launches counted on the CPU)."""
    import chip_smoke

    res = chip_smoke.run_live_corrections(
        "cpu", n_scans=50, n_scan_points=1500, scene_points=20000, seed=53,
        overrides=SMALL_DEFAULT_OVERRIDES + [
            ("config_sub_mapping", "sub_mapping", "submap_target_num_points", 1000)],
        work_dir=str(tmp_path))
    chip_smoke.check_live_corrections(res)
    assert os.listdir(str(tmp_path)) == []
    assert res["kernel_launches"] == 0 and res["aligns"][0]["launches"] == 0
