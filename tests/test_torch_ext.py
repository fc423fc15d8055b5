"""The port's extension modules (glim_tpu_torch/ext, the IMU validator, the
extension surface of GlimTorch) against the JAX package's on the same
seeded numpy inputs.

Tolerances: the ScanContext descriptor to 1e-6 absolute, ``sc_distance``
to 1e-5 with the same best shift; the HOG descriptor and the database
similarities to 1e-5 with the same argmax; ``lla_to_enu`` /
``fit_yaw_translation`` to 1e-9 in float64, and the same priors for the
same submap stream. Every extension attaches to process-global callback
slots: the ``slots_unchanged`` fixture holds each test that builds one to
detaching it."""

import types as pytypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.mapping.callbacks import GlobalMappingCallbacks as JGCB
from glim_tpu.types import PointBatch as JPointBatch
from glim_tpu.types import SubMap as JSubMap
from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as TGCB
from glim_tpu_torch.types import PointBatch as TPointBatch
from glim_tpu_torch.types import SubMap as TSubMap
from glim_tpu_torch.utils.callbacks import CallbackSlot

from torch_parity import SMALL_DEFAULT_OVERRIDES


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils import lifecycle
    lifecycle.stop_all()
    CallbackSlot.clear_all()


@pytest.fixture
def slots_unchanged():
    """Every port callback slot holds as many handlers after the test as
    before it."""
    before = [len(s) for s in CallbackSlot._ALL]
    yield
    assert [len(s) for s in CallbackSlot._ALL[:len(before)]] == before


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _room_cloud(rng, cap=4096, rot=0.0):
    """L-shaped wall scene (rotation-asymmetric), the JAX test's."""
    pts = np.zeros((cap, 3), np.float32)
    k = cap // 2
    pts[:k, 0] = rng.uniform(0, 20, k)
    pts[:k, 1] = 10.0
    pts[:k, 2] = rng.uniform(0, 4, k)
    pts[k:, 0] = -5.0
    pts[k:, 1] = rng.uniform(-15, 10, cap - k)
    pts[k:, 2] = rng.uniform(-1, 4, cap - k)
    c, s = np.cos(rot), np.sin(rot)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    mask = rng.uniform(size=cap) > 0.1
    return (pts @ R.T).astype(np.float32), mask


def _structured_scene(rng, n=2048):
    """Random walls and pillar clusters (the JAX detector test's scenes)."""
    chunks = []
    for _ in range(3):
        ang, off = rng.uniform(0, np.pi), rng.uniform(5, 25)
        u = rng.uniform(-15, 15, 500)
        h = rng.uniform(0, rng.uniform(2, 8), 500)
        c_, s_ = np.cos(ang), np.sin(ang)
        chunks.append(np.stack([u * c_ - off * s_, u * s_ + off * c_, h], 1))
    for _ in range(4):
        ctr = rng.uniform(-25, 25, 2)
        h = rng.uniform(0, rng.uniform(3, 10), 137)
        chunks.append(np.stack([np.full(137, ctr[0]) + rng.normal(0, 0.1, 137),
                                np.full(137, ctr[1]) + rng.normal(0, 0.1, 137), h], 1))
    p = np.concatenate(chunks)[:n].astype(np.float32)
    return np.concatenate([p, np.zeros((n - len(p), 3), np.float32)])


def test_scan_context_descriptor_and_distance_match_jax(rng):
    from glim_tpu.ext import scan_context as j_sc
    from glim_tpu_torch.ext import scan_context as t_sc

    clouds = [_room_cloud(rng), _room_cloud(rng, rot=2 * np.pi * 7 / 60),
              (_structured_scene(rng), np.ones(2048, bool))]
    descs = []
    for pts, mask in clouds:
        dj = np.asarray(j_sc.scan_context_descriptor(jnp.asarray(pts), jnp.asarray(mask),
                                                     jnp.float32(40.0)))
        dt = t_sc.scan_context_descriptor(torch.from_numpy(pts), torch.from_numpy(mask), 40.0)
        np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-6)
        assert (dj > 0).sum() > 20
        descs.append((dj, dt))
    batch = torch.stack([dt for _, dt in descs])
    d_all, s_all = t_sc.sc_distance(descs[0][1], batch)
    for k, (dj, dt) in enumerate(descs):
        dist_j, shift_j = j_sc.sc_distance(jnp.asarray(descs[0][0]), jnp.asarray(dj))
        dist_t, shift_t = t_sc.sc_distance(descs[0][1], dt)
        assert abs(float(dist_t) - float(dist_j)) < 1e-5
        assert int(shift_t) == int(shift_j)
        # The batched form (the detector scores its candidates at once).
        assert abs(float(d_all[k]) - float(dist_j)) < 1e-5 and int(s_all[k]) == int(shift_j)
        np.testing.assert_allclose(t_sc.ring_key(dt.numpy()), j_sc.ring_key(dj), atol=1e-6)
    assert float(d_all[1]) < 0.12 < float(d_all[2])


def test_scan_context_detectors_fire_on_the_same_pairs(rng, slots_unchanged):
    """The JAX test's scenario (four distinct scenes, then a rotated noisy
    revisit of the first) through both detectors: the same requests."""
    from glim_tpu.ext.scan_context import ScanContextLoopDetector as JDet
    from glim_tpu_torch.ext.scan_context import ScanContextLoopDetector as TDet

    jd, td = JDet(distance_threshold=0.25, exclude_recent=2), \
        TDet(distance_threshold=0.25, exclude_recent=2)
    fired_j, fired_t = [], []
    hj = JGCB.request_to_add_loop.add(lambda t, s: fired_j.append((t, s)))
    ht = TGCB.request_to_add_loop.add(lambda t, s: fired_t.append((t, s)))
    try:
        scenes = [_structured_scene(rng) for _ in range(4)]
        c, s = np.cos(0.3), np.sin(0.3)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        scenes.append(scenes[0] @ R.T + rng.normal(0, 0.05, (2048, 3)).astype(np.float32))
        mask = np.ones(2048, bool)
        for sid, p in enumerate(scenes):
            jd._on_new_submap(JSubMap(id=sid, frame=JPointBatch(points=jnp.asarray(p),
                                                                 mask=jnp.asarray(mask))))
            td._on_new_submap(TSubMap(id=sid, frame=TPointBatch(points=torch.from_numpy(p),
                                                                 mask=torch.from_numpy(mask))))
        assert fired_t == fired_j == [(0, 4)]
        assert [m[:2] for m in td.matches] == [m[:2] for m in jd.matches]
        assert abs(td.matches[0][2] - jd.matches[0][2]) < 1e-5
    finally:
        JGCB.request_to_add_loop.remove(hj)
        TGCB.request_to_add_loop.remove(ht)
        jd.detach()
        td.detach()


def _scene_image(rng, seed_img=None, noise=0.0):
    import chip_smoke
    if seed_img is None:
        return chip_smoke.scene_image(rng)
    return np.clip(seed_img + rng.normal(0, noise, seed_img.shape), 0, 255)


def test_image_descriptor_and_query_match_jax(rng):
    from glim_tpu.ext import image_loop as j_il
    from glim_tpu_torch.ext import image_loop as t_il

    a = _scene_image(rng)
    imgs = [a, _scene_image(rng), _scene_image(rng, a, 4.0),
            rng.uniform(0, 255, (48, 50, 3)), rng.uniform(0, 255, (200, 301))]
    descs_j, descs_t = [], []
    for img in imgs:
        g_j, g_t = j_il._to_gray64(img), t_il._to_gray64(img)
        np.testing.assert_array_equal(g_t, g_j)
        dj = np.asarray(j_il.image_descriptor(jnp.asarray(g_j)))
        dt = t_il.image_descriptor(torch.from_numpy(g_t))
        np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-5)
        descs_j.append(dj)
        descs_t.append(dt)
    sims_j, best_j = j_il.database_query(jnp.asarray(np.stack(descs_j[1:])),
                                         jnp.asarray(descs_j[0]))
    sims_t, best_t = t_il.database_query(torch.stack(descs_t[1:]), descs_t[0])
    np.testing.assert_allclose(sims_t.numpy(), np.asarray(sims_j), rtol=0, atol=1e-5)
    assert int(best_t) == int(best_j) == 1            # the revisit of image a


def test_image_detectors_fire_on_the_same_pairs(rng, slots_unchanged):
    """The JAX test's scenario (four places, then a noisy revisit of the
    first) through both detectors; and a submap with no frames is skipped."""
    from glim_tpu.ext.image_loop import ImageLoopDetector as JDet
    from glim_tpu_torch.ext.image_loop import ImageLoopDetector as TDet

    jd, td = JDet(exclude_recent=2), TDet(exclude_recent=2, device="cpu")
    fired_j, fired_t = [], []
    hj = JGCB.request_to_add_loop.add(lambda t, s: fired_j.append((t, s)))
    ht = TGCB.request_to_add_loop.add(lambda t, s: fired_t.append((t, s)))
    try:
        imgs = [_scene_image(rng) for _ in range(4)]
        imgs.append(_scene_image(rng, imgs[0], 4.0))
        for sid, img in enumerate(imgs):
            fr = pytypes.SimpleNamespace(stamp=float(sid))
            jd._on_image(float(sid), img)
            jd._on_new_submap(JSubMap(id=sid, frames=[fr]))
            TGCB.on_insert_image(float(sid), img)        # the port's through its slot
            td._on_new_submap(TSubMap(id=sid, frames=[fr]))
        assert fired_t == fired_j == [(0, 4)]
        assert abs(td.matches[0][2] - jd.matches[0][2]) < 1e-5
        td._on_new_submap(TSubMap(id=9, frames=[]))
        assert len(td.descriptors) == 5
    finally:
        JGCB.request_to_add_loop.remove(hj)
        TGCB.request_to_add_loop.remove(ht)
        jd.detach()
        td.detach()


def test_gnss_geometry_matches_jax(rng):
    from glim_tpu.ext import gnss_global as j_g
    from glim_tpu_torch.ext import gnss_global as t_g

    ref = np.array([35.0, 139.0, 50.0])
    for lla in (np.array([35.001, 139.0, 50.0]), np.array([35.0, 139.0, 60.0]),
                ref + rng.normal(0, 0.01, 3) * [1, 1, 100]):
        np.testing.assert_allclose(t_g.lla_to_enu(lla, ref), j_g.lla_to_enu(lla, ref),
                                   rtol=0, atol=1e-9)
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    p_enu = rng.uniform(-50, 50, (20, 3))
    p_map = p_enu @ R.T + [3.0, -2.0, 1.0] + rng.normal(0, 0.05, (20, 3))
    for a, b in zip(t_g.fit_yaw_translation(p_map, p_enu), j_g.fit_yaw_translation(p_map, p_enu)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_gnss_sends_the_same_priors_as_jax(slots_unchanged):
    """The same fixes and submap stream (a map frame 0.5 rad from ENU) give
    the same translation-prior requests in both packages."""
    from glim_tpu.ext.gnss_global import GNSSGlobal as JG
    from glim_tpu_torch.ext.gnss_global import GNSSGlobal as TG

    ext_j = JG(min_baseline=5.0, min_pairs=3, default_std=1.0)
    ext_t = TG(min_baseline=5.0, min_pairs=3, default_std=1.0)
    fired_j, fired_t = [], []
    hj = JGCB.request_to_add_translation_prior.add(
        lambda i, p, s: fired_j.append((i, np.asarray(p), float(s))))
    ht = TGCB.request_to_add_translation_prior.add(
        lambda i, p, s: fired_t.append((i, np.asarray(p), float(s))))
    try:
        th = 0.5
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        for k in range(8):
            enu = np.array([4.0 * k, 1.0 * k, 0.0])
            ext_j.insert_gnss(float(k), enu, std=1.0 + 0.1 * k)
            ext_t.insert_gnss(float(k), enu, std=1.0 + 0.1 * k)
            T = np.eye(4)
            T[:3, 3] = R @ enu + [10.0, -5.0, 2.0]
            fr = pytypes.SimpleNamespace(stamp=float(k) + 0.3)
            ext_j._on_new_submap(JSubMap(id=k, T_world_origin=T, frames=[fr]))
            ext_t._on_new_submap(TSubMap(id=k, T_world_origin=T, frames=[fr]))
        assert ext_t.priors_sent == ext_j.priors_sent == len(fired_t) >= 4
        for (it, pt, st), (ij, pj, sj) in zip(fired_t, fired_j):
            assert it == ij
            np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
            assert pt.dtype == np.float32 and abs(st - sj) < 1e-7
        np.testing.assert_allclose(ext_t.T_map_enu[0], ext_j.T_map_enu[0], atol=1e-9)
    finally:
        JGCB.request_to_add_translation_prior.remove(hj)
        TGCB.request_to_add_translation_prior.remove(ht)
        ext_j.detach()
        ext_t.detach()


def test_velocity_suppressor_applies_once(slots_unchanged):
    from glim_tpu_torch.ext.velocity_suppressor import VelocitySuppressor
    from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks as OCB

    ext = VelocitySuppressor(max_velocity=3.0, weight=5.0)
    calls = []
    try:
        OCB.on_smoother_update(pytypes.SimpleNamespace(
            set_velocity_regulation=lambda w, v: calls.append((w, v))))
        OCB.on_smoother_update(pytypes.SimpleNamespace(
            set_velocity_regulation=lambda w, v: calls.append((w, v))))
        assert calls == [(5.0, 3.0)] and ext.applied
    finally:
        ext.detach()


def test_velocity_regulation_setter_on_the_real_module():
    from glim_tpu_torch.odometry.odometry_estimation_imu import OdometryEstimationIMU

    mod = OdometryEstimationIMU(device="cpu")
    mod.set_velocity_regulation(10.0, 4.0)
    np.testing.assert_allclose(mod._d_vel_reg.numpy(), [10.0, 4.0])
    mod.set_velocity_regulation(0.0, 4.0)
    assert mod._d_vel_reg is None


def test_imu_validator_matches_jax(slots_unchanged):
    """The same IMU stream and frame states through both validators: the
    same win statistics (the port takes a frame in one frame late)."""
    from glim_tpu.common.imu_validation import IMUValidatorExtension as JV
    from glim_tpu.odometry.callbacks import OdometryEstimationCallbacks as JOCB
    from glim_tpu_torch.common.imu_validation import IMUValidatorExtension as TV
    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks as TOCB
    from glim_tpu_torch.types import EstimationFrame

    seq = generate_sequence(duration=2.0, n_scan_points=100, scene_points=2000, seed=3)
    jv, tv = JV(), TV(device="cpu")
    try:
        rng = np.random.default_rng(5)
        imu_i = 0
        for k, raw in enumerate(seq.scans):
            while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp:
                row = seq.imu[imu_i]
                JOCB.on_insert_imu(row[0], row[1:4], row[4:7])
                TOCB.on_insert_imu(row[0], row[1:4], row[4:7])
                imu_i += 1
            T = seq.gt_poses[k] @ np.linalg.inv(np.eye(4))
            T = T.copy()
            T[:3, 3] += rng.normal(0, 0.02, 3)
            v = rng.normal(0, 0.5, 3)
            JOCB.on_new_frame(pytypes.SimpleNamespace(stamp=raw.stamp, T_world_imu=T,
                                                      v_world_imu=v, imu_bias=np.zeros(6)))
            TOCB.on_new_frame(EstimationFrame(id=k, stamp=raw.stamp, T_world_lidar=T,
                                              v_world_imu=v, imu_bias=np.zeros(6)))
        TOCB.on_new_frame(EstimationFrame(id=99, stamp=99.0))   # takes in the last frame
        assert tv.frames_validated == len(seq.scans) - 1 >= 15
        for name in ("rot_wins", "trans_wins", "vel_wins"):
            a, b = getattr(tv.validation, name), getattr(jv.validation, name)
            assert a.n == b.n and abs(a.mean - b.mean) < 1e-12, name
    finally:
        jv.at_exit("")
        tv.at_exit("")


def test_all_seven_extensions_load_and_detach(slots_unchanged):
    from glim_tpu_torch.utils.extension_module import ExtensionModule

    names = ["libstandard_viewer.so", "libmemory_monitor.so", "libimu_validator.so",
             "libscan_context_loop_detector.so", "libdbow_loop_detector.so",
             "libgnss_global.so", "libvelocity_suppressor.so"]
    mods = ExtensionModule.load_extensions(names, device="cpu")
    assert [type(m).__name__ for m in mods] == [
        "StandardViewer", "MemoryMonitor", "IMUValidatorExtension",
        "ScanContextLoopDetector", "ImageLoopDetector", "GNSSGlobal", "VelocitySuppressor"]
    assert all(m.ok() and not m.needs_wait() for m in mods)
    for m in mods:
        m.detach()


def test_unknown_extension_raises_naming_it(tmp_path):
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir

    cfg = create_default_config_dir(str(tmp_path / "cfg"))
    with pytest.raises(NotImplementedError, match="librviz_viewer.so"):
        GlimTorch(cfg, extension_modules=["libvelocity_suppressor.so", "librviz_viewer.so"],
                  device="cpu")


def test_translation_prior_request_skipped_by_the_pose_graph():
    """F1: a GNSS request under the pose-graph back-end (which has no
    add_translation_prior) is skipped with a warning and leaves the global
    worker alive; a loop request after it is still serviced."""
    import time

    from glim_tpu_torch.mapping.async_global_mapping import AsyncGlobalMapping
    from glim_tpu_torch.mapping.global_mapping_pose_graph import (
        GlobalMappingPoseGraph, GlobalMappingPoseGraphParams)

    gm = GlobalMappingPoseGraph(GlobalMappingPoseGraphParams(enable_detection_thread=False),
                                device="cpu")
    wrapper = AsyncGlobalMapping(gm, optimization_interval=1e9)
    seen = []
    gm.add_loop_candidate = lambda t, s, *a: seen.append((t, s))
    try:
        TGCB.request_to_add_translation_prior(0, np.zeros(3, np.float32), np.float32(1.0))
        TGCB.request_to_add_loop(0, 1)
        t0 = time.time()
        while not seen and time.time() - t0 < 30:
            time.sleep(0.02)
        assert seen == [(0, 1)] and wrapper.skipped_requests == 1
        assert wrapper.worker.is_alive()
        wrapper.workload()                          # no WorkerFailed
    finally:
        wrapper.join()


def test_sync_mode_services_no_extension_requests(tmp_path):
    """As in the JAX package only the async wrapper subscribes to the
    request slots: a synchronous GlimTorch leaves a request unserviced."""
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir

    cfg = create_default_config_dir(str(tmp_path / "cfg"))
    glim = GlimTorch(cfg, async_mode=False, device="cpu")
    try:
        assert len(TGCB.request_to_add_loop) == len(TGCB.request_to_add_translation_prior) == 0
        TGCB.request_to_add_translation_prior(0, np.zeros(3, np.float32), np.float32(1.0))
        assert glim.global_mapping.translation_priors == []
    finally:
        CallbackSlot.clear_all()


def test_glim_torch_runs_the_default_extensions_on_cpu(tmp_path):
    """chip_smoke.py phase 11a at a tiny size on the CPU: GlimTorch with
    gnss_global, velocity_suppressor, imu_validator, memory_monitor and
    standard_viewer, with the phase's checks (the card's memory is not
    read here)."""
    import chip_smoke

    res = chip_smoke.run_extensions(
        "cpu", n_scans=34, n_scan_points=1500, scene_points=20000, seed=53,
        overrides=SMALL_DEFAULT_OVERRIDES + [
            ("config_sub_mapping", "sub_mapping", "submap_target_num_points", 2048)],
        work_dir=str(tmp_path),
        config_edits=[("config", "gnss_global", "min_baseline", 3.0),
                      ("config", "gnss_global", "max_stamp_gap", 0.3)])
    chip_smoke.check_extensions(res)
    assert res["monitor_device_reads"] == 0 and res["stream_lines"] >= 3
    assert res["priors_sent"] >= 1 and res["skipped_requests"] == 0


def test_glim_torch_loop_detectors_on_cpu():
    """chip_smoke.py phase 11b at a tiny size on the CPU (the pose-graph
    configuration, async, with both detectors): every loop request is
    serviced, and the ScanContext requests are the JAX detector's on the
    run's own submap clouds."""
    import chip_smoke
    from glim_tpu.ext.scan_context import ScanContextLoopDetector as JDet

    res = chip_smoke.run_loop_detectors(
        "cpu", n_scans=36, n_scan_points=1500, scene_points=20000, seed=53,
        overrides=SMALL_DEFAULT_OVERRIDES + [
            ("config_sub_mapping", "sub_mapping", "submap_target_num_points", 2048)])
    chip_smoke.check_loop_detectors(res)
    assert res["sc_matches"] and res["loop_requests"]
    jd = JDet()
    fired = []
    h = JGCB.request_to_add_loop.add(lambda t, s: fired.append((t, s)))
    try:
        for sid, (pts, mask) in enumerate(res["submap_clouds"]):
            jd._on_new_submap(JSubMap(id=sid, frame=JPointBatch(points=jnp.asarray(pts),
                                                                 mask=jnp.asarray(mask))))
    finally:
        JGCB.request_to_add_loop.remove(h)
        jd.detach()
    assert [(t, s) for t, s, _ in res["sc_matches"]] == fired
