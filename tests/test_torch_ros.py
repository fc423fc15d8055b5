"""The port's ROS front end (glim_tpu_torch/io/rosbag.py, ros/*,
tools/bag_converter.py) against the JAX package's on the same seeded
inputs.

Tolerances: the bag readers give the same (topic, type, stamp, payload)
records, byte for byte, and the converters the same arrays exactly (the
same numpy decoding); the message builders the same fields exactly; the
bag converter the same files, byte for byte. GlimROSNode against the JAX
node on a fake node (sync, the same sequence): odometry messages at the
same stamps (one a scan), both sets of published poses under the JAX
odometry's ATE bound (0.08 m,
tests/test_odometry_imu.py), the same TF contract and frame ids, and the
back-end flags select the same modules. The chip_smoke phases 12a and 12b
are rehearsed at a tiny size."""

import os
import struct
from types import SimpleNamespace

import jax  # noqa: F401  (both packages in one process, as in the other files)
import numpy as np
import pytest
import torch

from test_rosbag import (_sample_messages, _sample_messages_ros1, encode_imu,
                         encode_pointcloud2, make_db3, make_mcap, make_rosbag1)
from test_ros_tools import make_pc2
from torch_parity import SMALL_DEFAULT_OVERRIDES

ATE_BOUND = 0.08     # m, tests/test_odometry_imu.py


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils import lifecycle
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


def _bag(tmp_path, kind):
    """A bag of 3 scans and 10 IMU samples in the given format."""
    if kind.startswith("ros1"):
        p = str(tmp_path / "seq.bag")
        make_rosbag1(p, _sample_messages_ros1(), compress=kind.split("_")[1])
    elif kind.startswith("mcap"):
        p = str(tmp_path / "seq.mcap")
        make_mcap(p, _sample_messages(), compress=kind.split("_")[1])
    else:
        p = str(tmp_path / "bag_0.db3")
        make_db3(p, _sample_messages())
    return p


def _same(a, b):
    """Equal decoded values: arrays exactly, namespaces / dataclasses field
    by field."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif hasattr(a, "__dict__") and hasattr(b, "__dict__"):
        assert sorted(vars(a)) == sorted(vars(b))
        for k in vars(a):
            _same(getattr(a, k), getattr(b, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("kind", ["db3", "mcap_", "mcap_zlib", "ros1_none", "ros1_bz2"])
def test_bag_readers_match_jax(tmp_path, kind):
    from glim_tpu.io import rosbag as j_rb
    from glim_tpu_torch.io import rosbag as t_rb

    p = _bag(tmp_path, kind)
    for path in (p, str(tmp_path)):                  # the file, and its directory
        recs_j, recs_t = list(j_rb.read_bag(path)), list(t_rb.read_bag(path))
        assert len(recs_t) == 13 and recs_t == recs_j
        assert all(type(r[3]) is bytes for r in recs_t)
        assert t_rb.bag_topics(path) == j_rb.bag_topics(path)
    msgs_j, msgs_t = list(j_rb.iter_sensor_messages(p)), list(t_rb.iter_sensor_messages(p))
    assert [k for k, _ in msgs_t] == [k for k, _ in msgs_j]
    assert sum(k == "points" for k, _ in msgs_t) == 3
    for (_, mj), (_, mt) in zip(msgs_j, msgs_t):
        _same(mt, mj)


def _mcap_chunked(path, comp, records):
    """An MCAP file of one chunk holding ``records`` compressed as ``comp``
    (the layout of tests/test_rosbag.py's make_mcap)."""
    from test_rosbag import _mcap_record, _mcap_string

    chunk = struct.pack("<QQQ", 0, 0, 0) + struct.pack("<I", 0) + _mcap_string(comp) \
        + struct.pack("<Q", len(records)) + records
    with open(path, "wb") as f:
        f.write(b"\x89MCAP0\r\n" + _mcap_record(0x06, chunk)
                + _mcap_record(0x02, struct.pack("<QQI", 0, 0, 0)))


def _plain_mcap_records(tmp_path) -> bytes:
    """The records of make_mcap's single uncompressed chunk."""
    from glim_tpu_torch.io import rosbag as t_rb

    p = str(tmp_path / "plain.mcap")
    make_mcap(p, _sample_messages(), compress="")
    body = [b for op, b in t_rb._mcap_records(memoryview(open(p, "rb").read())[8:])
            if op == 0x06][0]
    _, pos = t_rb._mcap_str(body, 28)
    return bytes(body[pos + 8:])


def test_bag_codecs_match_jax(tmp_path, monkeypatch):
    """zstd (MCAP) and lz4 (MCAP, ROS1) chunks without their module raise
    the JAX package's RuntimeError, naming the codec; with zstandard
    present, a zstd MCAP reads as JAX reads it."""
    import sys

    from glim_tpu.io import rosbag as j_rb
    from glim_tpu_torch.io import rosbag as t_rb

    for mod in ("zstandard", "lz4", "lz4.frame"):
        monkeypatch.setitem(sys.modules, mod, None)        # import raises ImportError
    for comp in ("zstd", "lz4"):
        p = str(tmp_path / f"{comp}.mcap")
        _mcap_chunked(p, comp, b"\0" * 16)
        errors = []
        for rb in (j_rb, t_rb):
            with pytest.raises(RuntimeError) as e:
                list(rb.read_mcap(p))
            errors.append(str(e.value))
        assert errors[0] == errors[1] and comp in errors[1]
    errors = []
    for rb in (j_rb, t_rb):
        with pytest.raises(RuntimeError) as e:
            rb._ros1_decompress("lz4", memoryview(b"\0"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "lz4" in errors[1]
    monkeypatch.undo()
    zstandard = pytest.importorskip("zstandard")
    p = str(tmp_path / "z.mcap")
    _mcap_chunked(p, "zstd", zstandard.ZstdCompressor().compress(_plain_mcap_records(tmp_path)))
    recs = list(t_rb.read_mcap(p))
    assert len(recs) == 13 and recs == list(j_rb.read_mcap(p))


@pytest.mark.parametrize("dtype, with_time, with_intensity", [
    (np.float32, True, True), (np.float64, True, False), (np.float32, False, True)])
def test_cloud_converter_matches_jax(dtype, with_time, with_intensity):
    from glim_tpu.ros.cloud_converter import extract_raw_points as j_extract
    from glim_tpu.ros.cloud_converter import to_sec as j_to_sec
    from glim_tpu_torch.ros.cloud_converter import extract_raw_points as t_extract
    from glim_tpu_torch.ros.cloud_converter import to_sec as t_to_sec

    rng = np.random.default_rng(11)
    msg, pts, times, inten, rings = make_pc2(rng, n=300, with_time=with_time,
                                             with_intensity=with_intensity, dtype=dtype)
    rj, rt = j_extract(msg), t_extract(msg)
    for name in ("stamp", "points", "times", "intensities", "colors", "rings"):
        _same(getattr(rt, name), getattr(rj, name))
    np.testing.assert_array_equal(rt.points, pts.astype(np.float64))
    np.testing.assert_array_equal(rt.rings, rings.astype(np.int32))
    msg.fields = [f for f in msg.fields if f.name != "z"]
    assert t_extract(msg) is None and j_extract(msg) is None
    for stamp in (SimpleNamespace(sec=3, nanosec=5), SimpleNamespace(secs=3, nsecs=5), None, 2.5):
        assert t_to_sec(stamp) == j_to_sec(stamp)


@pytest.mark.parametrize("acc_scale, units", [(0.0, "g"), (0.0, "si"), (9.80665, "g"),
                                              (1.0, "si")])
def test_imu_conditioner_matches_jax(acc_scale, units):
    from glim_tpu.ros.conditioning import ImuConditioner as JCond
    from glim_tpu_torch.ros.conditioning import GRAVITY
    from glim_tpu_torch.ros.conditioning import ImuConditioner as TCond

    rng = np.random.default_rng(12)
    cj, ct = JCond(acc_scale, imu_time_offset=0.01), TCond(acc_scale, imu_time_offset=0.01)
    out_j, out_t = [], []
    for i in range(30):
        acc = np.array([0.1, -0.05, 9.80665]) + rng.normal(0, 0.02, 3)
        if units == "g":
            acc = acc / GRAVITY
        gyro = rng.normal(0, 0.01, 3)
        out_j += cj.condition(0.005 * i, acc, gyro)
        out_t += ct.condition(0.005 * i, acc, gyro)
    assert len(out_t) == len(out_j) == 30 and ct.acc_scale == cj.acc_scale
    assert ct.acc_scale == (GRAVITY if units == "g" else 1.0)
    _same(out_t, out_j)


def test_messages_match_jax():
    """The message builders give the JAX package's fields; a PointCloud2
    round-trips through the converter."""
    from glim_tpu.ops import lie_np
    from glim_tpu.ros import messages as j_msg
    from glim_tpu_torch.ros import messages as t_msg
    from glim_tpu_torch.ros.cloud_converter import extract_raw_points

    rng = np.random.default_rng(13)
    T = lie_np.se3_exp(np.array([0.1, -0.2, 0.3, 1.0, 2.0, 3.0]))
    pts, inten, times = rng.normal(size=(200, 3)), rng.uniform(size=200), np.linspace(0, 0.1, 200)
    _same(t_msg.make_pointcloud2(12.5, "lidar", pts, inten, times),
          j_msg.make_pointcloud2(12.5, "lidar", pts, inten, times))
    raw = extract_raw_points(t_msg.make_pointcloud2(12.5, "lidar", pts, inten, times))
    np.testing.assert_allclose(raw.points, pts, atol=1e-5)
    np.testing.assert_allclose(raw.times, times, atol=1e-6)
    for t in (4.9999999999, 1.25, 0.0):
        _same(t_msg.stamp_msg(t), j_msg.stamp_msg(t))
    cov = rng.normal(size=(6, 6))
    _same(t_msg.make_odometry(1.5, "odom", "base", T, cov),
          j_msg.make_odometry(1.5, "odom", "base", T, cov))
    _same(t_msg.make_pose_stamped(1.5, "map", T), j_msg.make_pose_stamped(1.5, "map", T))
    tfs = [t_msg.make_transform_stamped(2.0, "map", "odom", T)]
    _same(tfs[0], j_msg.make_transform_stamped(2.0, "map", "odom", T))
    _same(t_msg.make_tf_message(tfs), j_msg.make_tf_message(tfs))
    imu = SimpleNamespace(header=SimpleNamespace(stamp=t_msg.stamp_msg(3.25)),
                          linear_acceleration=SimpleNamespace(x=0.1, y=0.2, z=9.8),
                          angular_velocity=SimpleNamespace(x=0.0, y=0.01, z=-0.02))
    _same(t_msg.imu_to_arrays(imu), j_msg.imu_to_arrays(imu))
    assert t_msg._ros_class("no_such_ros_package.msg", "Nothing") is None


def test_topic_subscriptions():
    """ExtensionModuleROS's subscriptions bind to a node and take replayed
    messages of their type."""
    from glim_tpu_torch.ros.extension_module_ros import (ExtensionModuleROS,
                                                         GenericTopicSubscription,
                                                         TopicSubscription)

    got, made = [], []
    node = SimpleNamespace(create_subscription=lambda *a: made.append(a) or a)
    sub = TopicSubscription("/gnss", dict, got.append, qos_depth=5)
    sub.create_subscriber(node)
    assert made == [(dict, "/gnss", got.append, 5)]
    sub.insert_message_instance({"fix": 1})
    sub.insert_message_instance([1])                 # another type: dropped
    assert got == [{"fix": 1}]
    assert ExtensionModuleROS().create_subscriptions() == []
    with pytest.raises(NotImplementedError):
        GenericTopicSubscription("/x").create_subscriber(node)


@pytest.mark.parametrize("kind", ["mcap_", "ros1_bz2"])
def test_bag_converter_writes_the_jax_files(tmp_path, kind):
    from glim_tpu.tools.bag_converter import main as j_main
    from glim_tpu_torch.tools import glim_runner
    from glim_tpu_torch.tools.bag_converter import main as t_main

    p = _bag(tmp_path, kind)
    assert j_main([p, str(tmp_path / "j")]) == 0 and t_main([p, str(tmp_path / "t")]) == 0
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                   for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert len(files) == 8 and files == sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "t")
        for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    imu, scans = glim_runner.load_dataset(str(tmp_path / "t"))
    assert len(scans) == 3 and imu.shape == (10, 7) and scans[0][2] is not None
    assert t_main([p, "--list"]) == 0


def _image_msg(encoding="mono8"):
    return SimpleNamespace(header=SimpleNamespace(stamp=SimpleNamespace(sec=1, nanosec=0)),
                           encoding=encoding, height=2, width=3, step=3, is_bigendian=False,
                           data=bytes(range(6)))


def _node_config(tmp_path, extensions=("librviz_viewer.so", "libimu_validator.so"), **ros):
    import chip_smoke

    edits = [("config_ros", "glim_ros", "extension_modules", list(extensions)),
             ("config_ros", "glim_ros", "imu_topic", "/imu"),
             ("config_ros", "glim_ros", "points_topic", "/points")]
    edits += [("config_ros", "glim_ros", k, v) for k, v in ros.items()]
    return chip_smoke.config_dir(SMALL_DEFAULT_OVERRIDES + edits)


def _drive_node(node, gn, seq, gravity):
    import chip_smoke
    from glim_tpu_torch.ros import messages as t_msg

    imu_i = 0
    for raw in seq.scans:
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.1:
            r = seq.imu[imu_i]
            node.subscriptions["/imu"](chip_smoke.imu_msg(r[0], r[1:4] / gravity, r[4:7]))
            imu_i += 1
        node.subscriptions["/points"](t_msg.make_pointcloud2(raw.stamp, "os_lidar", raw.points,
                                                            times=raw.times))
        gn.spin_once()


def test_ros_node_matches_the_jax_node(tmp_path):
    """GlimROSNode against the JAX package's GlimROSNode on a fake node,
    both sync on the same config and sequence (IMU in g-units, so acc_scale
    0 detects 9.80665)."""
    import chip_smoke
    from glim_tpu.io.synthetic import ate_rmse
    from glim_tpu.ros.node import GlimROSNode as JNode
    from glim_tpu.utils.config import GlobalConfig as JGC
    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.ros.cloud_converter import to_sec
    from glim_tpu_torch.ros.node import GRAVITY
    from glim_tpu_torch.ros.node import GlimROSNode as TNode

    cfg = _node_config(tmp_path)
    seq = generate_sequence(duration=2.0, n_scan_points=1500, scene_points=20000, seed=3)
    runs = {}
    for name, cls, kw in (("jax", JNode, {}), ("torch", TNode, dict(device="cpu"))):
        node = chip_smoke.FakeNode()
        gn = cls(node, config_path=cfg, async_mode=False, **kw)
        _drive_node(node, gn, seq, GRAVITY)
        for e in gn.glim.extensions:
            if type(e).__name__ == "RvizViewer":
                e.spin_once()
        odom = node.publishers["/glim_ros/odom"].messages
        runs[name] = dict(
            gn=gn, node=node, stamps=[round(to_sec(m.header.stamp), 6) for m in odom],
            poses=[chip_smoke._msg_pose(m) for m in odom],
            tf=sorted({(t.header.frame_id, t.child_frame_id)
                       for t in node.publishers["/tf"].messages[-1].transforms}),
            ests=gn.glim.odometry_estimates)
        gn.stop()
        for e in gn.glim.extensions:
            e.at_exit(str(tmp_path / name))
        JGC.reset()
    j, t = runs["jax"], runs["torch"]
    assert t["stamps"] == j["stamps"] and len(j["stamps"]) >= 15
    assert len(set(t["stamps"])) == len(t["stamps"])          # each frame once
    scan_of = {round(s.stamp, 6): i for i, s in enumerate(seq.scans)}
    for r in (j, t):
        gt = [seq.gt_poses[scan_of[s]] for s in r["stamps"]]
        assert ate_rmse(r["poses"], gt, align=True) < ATE_BOUND
        assert r["gn"]._imu_cond.acc_scale == pytest.approx(GRAVITY)
        assert (r["gn"].params.imu_frame_id, r["gn"].params.lidar_frame_id) == \
            ("imu_link", "os_lidar")
    assert t["tf"] == j["tf"] == [("imu_link", "os_lidar"), ("map", "odom"),
                                  ("odom", "imu_link")]
    # The last message is the last estimate's pose.
    np.testing.assert_allclose(t["poses"][-1][:3, 3], t["ests"][-1].T_world_sensor()[:3, 3],
                               atol=1e-6)
    # rviz: the newest frame's cloud in the map frame, as wide as its valid points.
    for r in (j, t):
        aligned = r["node"].publishers["/glim_ros/aligned_points"].messages
        assert aligned and aligned[-1].width > 0
    aligned = t["node"].publishers["/glim_ros/aligned_points"].messages[-1]
    est = {round(e.stamp, 6): e for e in t["ests"]}[round(to_sec(aligned.header.stamp), 6)]
    assert aligned.width == int(est.frame.mask.sum())
    val = [e for e in t["gn"].glim.extensions if type(e).__name__ == "IMUValidatorExtension"]
    assert val and val[0].frames_validated >= 3


@pytest.mark.parametrize("flag", ["enable_local_mapping", "enable_global_mapping"])
def test_ros_node_backend_flags(tmp_path, flag):
    """enable_local_mapping false selects the pass-through sub-mapping and
    enable_global_mapping false turns the back-end's optimization off, as
    in the JAX node; an image message is decoded before it fans out, and
    only the decoder's input errors forward the raw message (C22)."""
    from glim_tpu_torch.mapping.sub_mapping_passthrough import SubMappingPassthrough
    from glim_tpu_torch.ros.node import GlimROSNode

    import chip_smoke
    node = chip_smoke.FakeNode()
    gn = GlimROSNode(node, config_path=_node_config(tmp_path, (), **{flag: False}),
                     async_mode=False, device="cpu")
    if flag == "enable_local_mapping":
        assert isinstance(gn.glim.sub_mapping, SubMappingPassthrough)
    else:
        assert gn.glim.global_mapping.params.enable_optimization is False
    seen = []
    gn.glim.insert_image = lambda stamp, image: seen.append((stamp, image))
    node.subscriptions["/image"](_image_msg())
    node.subscriptions["/image"](_image_msg("no_such_encoding"))
    assert seen[0][0] == 1.0 and seen[0][1].shape == (2, 3)
    assert isinstance(seen[1][1], SimpleNamespace)            # forwarded raw
    broken = _image_msg()
    broken.height = None                                      # a TypeError: not swallowed
    with pytest.raises(TypeError):
        node.subscriptions["/image"](broken)
    gn.stop()
    gn.glim.wait()


def test_ros_node_reads_frames_only_once_their_copies_land(tmp_path, monkeypatch):
    """C23: the odometry callback starts the host copies and reads nothing;
    spin_once takes a frame in only when its copy has landed, and never
    waits for one."""
    import chip_smoke
    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.ros.node import GRAVITY, GlimROSNode
    from glim_tpu_torch.types import EstimationFrame

    node = chip_smoke.FakeNode()
    gn = GlimROSNode(node, config_path=_node_config(tmp_path, ()), async_mode=False,
                     device="cpu")
    landed = {"ok": False}
    monkeypatch.setattr(EstimationFrame, "state_ready", lambda self: landed["ok"])
    seq = generate_sequence(duration=1.2, n_scan_points=1500, scene_points=20000, seed=3)
    _drive_node(node, gn, seq, GRAVITY)
    odom = node.publishers["/glim_ros/odom"].messages
    waiting = len(gn._announced)
    assert odom == [] and waiting >= len(gn.glim.odometry_estimates) > 0
    landed["ok"] = True
    gn.spin_once()
    assert len(odom) == waiting and not gn._announced
    gn.spin_once()                                   # nothing new: nothing published
    assert len(odom) == waiting
    gn.stop()


def test_rviz_viewer_registered_and_loads():
    from glim_tpu_torch.ros.rviz_viewer import RvizViewer
    from glim_tpu_torch.utils.extension_module import ExtensionModule

    mods = ExtensionModule.load_extensions(["librviz_viewer.so"], device="cpu")
    assert [type(m) for m in mods] == [RvizViewer]
    mods[0].spin_once()                      # unbound: nothing to publish
    mods[0].at_exit("unused")
    assert mods[0]._handles == []


def test_chip_smoke_bag_and_node_rehearsal_on_cpu(tmp_path):
    """chip_smoke.py's phases 12a and 12b at a tiny size on the CPU: a
    rosbag2 .db3 written by its CDR writer played by the runner (every
    scan, the g-unit detection, every frame in a submap), then the node
    with rviz and the IMU validator, with the phases' checks."""
    import shutil

    import chip_smoke
    from glim_tpu_torch.io import rosbag as t_rb

    size = dict(n_scan_points=1500, scene_points=20000, seed=53, overrides=SMALL_DEFAULT_OVERRIDES)
    bag = chip_smoke.run_bag("cpu", n_scans=20, work_dir=str(tmp_path), **size)
    try:
        chip_smoke.check_bag(bag, n_scans=20)
        assert bag["decode_ms_per_scan"] > 0 and os.path.exists(bag["dump"])
        recs = list(t_rb.read_bag(os.path.join(bag["work_dir"], "run.db3")))
        assert sum(r[1].endswith("PointCloud2") for r in recs) == 20
    finally:
        shutil.rmtree(bag["work_dir"])
    ros = chip_smoke.run_ros_node("cpu", n_scans=20, **size)
    chip_smoke.check_ros_node(ros)
    assert ros["aligned_messages"] >= 1 and ros["frames_validated"] >= 3


def test_cdr_writer_matches_the_test_encoder():
    """chip_smoke's CDR writer gives the bytes of tests/test_rosbag.py's
    encoder for the same PointCloud2 and Imu, and the port decodes them."""
    import chip_smoke
    from glim_tpu_torch.io import rosbag as t_rb

    rng = np.random.default_rng(14)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    times = np.linspace(0, 0.1, 50).astype(np.float32)
    mine = chip_smoke.cdr_pointcloud2(12.25, pts, times)
    ref = encode_pointcloud2(12.25, pts, times)
    # The test encoder names its frame "lidar"; the writer "os_lidar".
    assert t_rb.decode_pointcloud2(mine).data == t_rb.decode_pointcloud2(ref).data
    assert t_rb.decode_pointcloud2(mine).header.frame_id == "os_lidar"
    imu = t_rb.decode_imu(chip_smoke.cdr_imu(3.5, [0.1, -0.2, 1.0], [0.01, 0.02, -0.03]))
    ref_imu = t_rb.decode_imu(encode_imu(3.5, [0.1, -0.2, 1.0], [0.01, 0.02, -0.03]))
    for name in ("stamp", "linear_acceleration", "angular_velocity", "orientation"):
        np.testing.assert_array_equal(getattr(imu, name), getattr(ref_imu, name))
