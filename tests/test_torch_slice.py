"""The port's slice end to end: GlimTorch against GlimTPU on one synthetic
sequence, the package's import isolation, and a CPU rehearsal of
chip_smoke.py's slice run.

Both pipelines run synchronously with config_odometry_cpu.json (GICP,
LiDAR-IMU) and the parameters of tests/test_odometry_cpu_imu.py, on the
same numpy-generated sequence. Random draws differ between the packages, so
the comparison is on trajectory accuracy: both ATEs under the module's
0.12 m bound and the port within 1.25 x the JAX ATE + 5 mm.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = dict(duration=2.0, n_scan_points=1500, scene_points=20000, seed=53)
ODOM = dict(window_size=6, outer_iterations=3, inner_iterations=2,
            initialization_window_size=0.3, model_capacity=32768,
            ivox_resolution=0.8, vgicp_resolution=0.5)
PRE = dict(random_downsample_target=1200, downsample_resolution=0.4)


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils import lifecycle
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


def _config_dir(create, path, odometry="config_odometry_cpu.json", odom=ODOM):
    create(str(path))

    def edit(fname, section, values):
        p = os.path.join(str(path), fname)
        with open(p) as f:
            cfg = json.load(f)
        cfg[section].update(values)
        with open(p, "w") as f:
            json.dump(cfg, f)

    edit("config.json", "global", {"config_odometry": odometry})
    edit("config_odometry_cpu.json", "odometry_estimation", odom)
    edit("config_preprocess.json", "preprocess", PRE)
    return str(path)


def _drive(glim, seq):
    imu_i = 0
    for raw in seq.scans:
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.12:
            glim.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
            imu_i += 1
        glim.insert_frame(raw)
    glim.wait()
    ests = glim.odometry_estimates
    gt = [seq.gt_poses[int(round(e.stamp * 10))] for e in ests]
    return ests, gt


class _NoMapping:
    """Stand-in for GlimTPU's sub-mapping and global-mapping stages:
    odometry estimates do not depend on them (sub-mapping is compared in
    tests/test_torch_sub_mapping.py and test_torch_default_slice.py)."""

    def insert_imu(self, *a):
        pass

    def insert_frame(self, *a):
        pass

    def insert_submap(self, *a):
        pass

    def get_submaps(self):
        return []

    def submit_end_of_sequence(self):
        return []

    def optimize(self):
        pass


def test_glim_torch_matches_glim_tpu(tmp_path):
    from glim_tpu.io.synthetic import ate_rmse as j_ate
    from glim_tpu.io.synthetic import generate_sequence as j_generate
    from glim_tpu.pipeline import GlimTPU
    from glim_tpu.utils.config import create_default_config_dir as j_create
    from glim_tpu_torch.io.synthetic import ate_rmse as t_ate
    from glim_tpu_torch.io.synthetic import generate_sequence as t_generate
    from glim_tpu_torch.ops.nn_search import nn_search
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir as t_create

    seq_j, seq_t = j_generate(**SEQ), t_generate(**SEQ)
    np.testing.assert_array_equal(seq_j.scans[-1].points, seq_t.scans[-1].points)

    glim_j = GlimTPU(_config_dir(j_create, tmp_path / "jax"), async_mode=False)
    glim_j.sub_mapping = glim_j.global_mapping = _NoMapping()
    ests_j, gt_j = _drive(glim_j, seq_j)
    ate_jax = j_ate([e.T_world_lidar for e in ests_j], gt_j, align=True)

    launches = nn_search.kernel_launches
    glim_t = GlimTorch(_config_dir(t_create, tmp_path / "torch"), async_mode=False,
                       device="cpu")
    ests_t, gt_t = _drive(glim_t, seq_t)
    ate_torch = t_ate([e.T_world_lidar for e in ests_t], gt_t, align=True)

    assert nn_search.kernel_launches == launches     # CPU tensors: plain version
    assert len(ests_t) == len(ests_j) >= 15
    assert all(np.isfinite(e.T_world_lidar).all() for e in ests_t)
    assert ate_jax < 0.12 and ate_torch < 0.12, (ate_jax, ate_torch)
    assert ate_torch <= 1.25 * ate_jax + 0.005, (ate_jax, ate_torch)


def test_import_isolation():
    """glim_tpu_torch and its pipeline, tools and ROS front end load neither
    JAX nor glim_tpu."""
    code = ("import sys, glim_tpu_torch, glim_tpu_torch.pipeline, glim_tpu_torch.state, "
            "glim_tpu_torch.odometry.keyframe_manager, glim_tpu_torch.mapping.sub_mapping, "
            "glim_tpu_torch.mapping.global_mapping, glim_tpu_torch.tools.backend_stress, "
            "glim_tpu_torch.common.imu_integration, glim_tpu_torch.utils.concurrent, "
            "glim_tpu_torch.utils.lifecycle, glim_tpu_torch.utils.profiling, "
            "glim_tpu_torch.utils.debug, glim_tpu_torch.odometry.async_odometry_estimation, "
            "glim_tpu_torch.mapping.async_sub_mapping, "
            "glim_tpu_torch.mapping.async_global_mapping, glim_tpu_torch.io.dump, "
            "glim_tpu_torch.io.boost_archive, glim_tpu_torch.io.gtsam_points_io, "
            "glim_tpu_torch.io.loaders, glim_tpu_torch.tools.glim_runner, "
            "glim_tpu_torch.odometry.odometry_estimation_ct, "
            "glim_tpu_torch.odometry.odometry_estimation_cpu, "
            "glim_tpu_torch.odometry.odometry_estimation_cpu_imu, "
            "glim_tpu_torch.mapping.sub_mapping_passthrough, glim_tpu_torch.tools.run_eval, "
            "glim_tpu_torch.tools.evaluate, glim_tpu_torch.mapping.submap_refine, "
            "glim_tpu_torch.mapping.global_mapping_pose_graph, glim_tpu_torch.ops.registration, "
            "glim_tpu_torch.utils.extension_module, glim_tpu_torch.ext.scan_context, "
            "glim_tpu_torch.ext.image_loop, glim_tpu_torch.ext.gnss_global, "
            "glim_tpu_torch.ext.velocity_suppressor, glim_tpu_torch.viewer.memory_monitor, "
            "glim_tpu_torch.viewer.stream_writer, glim_tpu_torch.viewer.standard_viewer, "
            "glim_tpu_torch.viewer.interactive_tools, glim_tpu_torch.viewer.interactive_viewer, "
            "glim_tpu_torch.tools.watch, glim_tpu_torch.common.cloud_covariance_estimation, "
            "glim_tpu_torch.common.cloud_deskewing, glim_tpu_torch.utils.interpolation, "
            "glim_tpu_torch.utils.camera, glim_tpu_torch.native, glim_tpu_torch.native.loader, "
            "glim_tpu_torch.ops.segmentation, glim_tpu_torch.viewer.map_editor, "
            "glim_tpu_torch.tools.map_editor, glim_tpu_torch.viewer.offline_viewer, "
            "glim_tpu_torch.tools.offline_viewer, glim_tpu_torch.tools.interactive_viewer, "
            "glim_tpu_torch.ros, glim_tpu_torch.ros.cloud_converter, "
            "glim_tpu_torch.ros.conditioning, glim_tpu_torch.io.rosbag, "
            "glim_tpu_torch.tools.bag_converter, glim_tpu_torch.ros.messages, "
            "glim_tpu_torch.ros.extension_module_ros, glim_tpu_torch.ros.node, "
            "glim_tpu_torch.ros.rviz_viewer, chip_smoke; "
            "from glim_tpu_torch.utils.registry import available_modules; "
            "assert {'odometry_estimation_gpu', 'odometry_estimation_cpu', "
            "'odometry_estimation_ct', 'odometry_estimation_lidar_only'} "
            "<= set(available_modules('odometry')); "
            "assert {'sub_mapping', 'sub_mapping_passthrough'} "
            "<= set(available_modules('sub_mapping')); "
            "assert {'global_mapping', 'global_mapping_pose_graph'} "
            "<= set(available_modules('global_mapping')); "
            "assert {'standard_viewer', 'memory_monitor', 'imu_validator', 'scan_context', "
            "'image_loop', 'gnss_global', 'velocity_suppressor', 'rviz_viewer'} "
            "== set(available_modules('extension')); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'glim_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_rehearsal_on_cpu():
    """chip_smoke.run_slice at a tiny size on the CPU: the path the card
    runs, with the plain nn_search (no launches counted)."""
    import chip_smoke

    res = chip_smoke.run_slice(
        "cpu", n_scans=12, n_scan_points=1500, scene_points=20000, seed=53,
        odometry_overrides=dict(window_size=6, initialization_window_size=0.3,
                                model_capacity=8192),
        preprocess_overrides=dict(random_downsample_target=1000, downsample_resolution=0.4))
    assert res["scans"] == 12 and res["window_steps"] >= 5
    assert res["kernel_launches"] == 0 and res["max_memory_allocated"] is None
    assert res["poses_finite"] and res["ate"] < chip_smoke.ATE_BOUND


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result, also
    when it stands alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    src = os.path.join(REPO, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(src).read())
    for cwd, script in ((REPO, src), (str(tmp_path), str(lone))):
        r = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_unported_configurations_raise(tmp_path):
    """No shipped configuration raises: the pose-graph back-end and
    sub-mapping's enable_optimization and create_between_factors each build
    and run 10 scans at a tiny size, the pose graph in both pipeline modes,
    the options asynchronously (tests/test_torch_pose_graph_slice.py runs
    all three synchronously); the CT, pass-through and frame-to-model
    configurations and the default one build."""
    import chip_smoke
    from torch_parity import SMALL_DEFAULT_OVERRIDES

    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir

    cfg = create_default_config_dir(str(tmp_path / "default"))
    seq = generate_sequence(duration=1.0, n_scan_points=1500, scene_points=20000, seed=53)
    for module, name, value in (
            ("global", "config_global_mapping", "config_global_mapping_pose_graph.json"),
            ("sub_mapping", "enable_optimization", True),
            ("sub_mapping", "create_between_factors", True)):
        logical = "config" if module == "global" else "config_sub_mapping"
        edited = chip_smoke.config_dir([(logical, module, name, value)])
        for async_mode in (True, False) if module == "global" else (True,):
            glim = GlimTorch(edited, async_mode=async_mode, device="cpu",
                             overrides=SMALL_DEFAULT_OVERRIDES)
            chip_smoke._feed(glim, seq)
            glim.wait()
            gm = type(glim.global_backend).__name__
            assert gm == ("GlobalMappingPoseGraph" if module == "global" else "GlobalMapping")
            sub = glim.sub_mapping.sub_mapping if async_mode else glim.sub_mapping
            if module == "sub_mapping":
                assert getattr(sub.params, name) is True
            assert len(glim.odometry_estimates) >= 6 and len(glim.submaps) >= 1
    for overrides, names in (
            ([("config", "global", "config_odometry", "config_odometry_ct.json")],
             ("OdometryEstimationCT", "SubMapping")),
            ([("config", "global", "config_sub_mapping", "config_sub_mapping_passthrough.json")],
             ("OdometryEstimationIMU", "SubMappingPassthrough")),
            ([("config", "global", "config_odometry", "config_odometry_cpu.json"),
              ("config_odometry", "odometry_estimation", "registration_type", "VGICP")],
             ("OdometryEstimationCPUIMU", "SubMapping")),
            ([("config", "global", "config_odometry", "config_odometry_cpu.json"),
              ("config_odometry", "odometry_estimation", "enable_imu", False)],
             ("OdometryEstimationCPU", "SubMapping"))):
        glim = GlimTorch(chip_smoke.config_dir(overrides), async_mode=False, device="cpu")
        assert (type(glim.odometry).__name__, type(glim.sub_mapping).__name__) == names
    glim = GlimTorch(cfg, device="cpu")        # the default configuration builds
    assert [type(s).__name__ for s in (glim.odometry, glim.sub_mapping, glim.global_mapping)] \
        == ["AsyncOdometryEstimation", "AsyncSubMapping", "AsyncGlobalMapping"]
    assert type(glim.global_backend).__name__ == "GlobalMapping"
    glim.wait()
    sync = GlimTorch(cfg, async_mode=False, device="cpu")
    assert type(sync.global_mapping).__name__ == "GlobalMapping"


def test_entry_points_default_to_cuda(tmp_path):
    """Every entry point runs on the card unless the caller asks for the
    CPU; without a card GlimTorch raises and names the remedy."""
    import inspect

    from glim_tpu_torch.mapping.global_mapping import (GlobalMapping,
                                                       create_global_mapping_module)
    from glim_tpu_torch.mapping.sub_mapping import SubMapping, create_sub_mapping_module
    from glim_tpu_torch.odometry.keyframe_manager import KeyframeManager
    from glim_tpu_torch.odometry.odometry_estimation_cpu import OdometryEstimationCPU
    from glim_tpu_torch.odometry.odometry_estimation_cpu_imu import (
        OdometryEstimationCPUIMU, create_odometry_estimation_cpu_module)
    from glim_tpu_torch.odometry.odometry_estimation_imu import (
        OdometryEstimationIMU, create_odometry_estimation_gpu_module)
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.preprocess.cloud_preprocessor import CloudPreprocessor
    from glim_tpu_torch.tools import backend_stress
    from glim_tpu_torch.utils.config import create_default_config_dir
    from glim_tpu_torch.utils.registry import available_modules

    entry_points = [GlimTorch, CloudPreprocessor, OdometryEstimationIMU,
                    OdometryEstimationCPU, OdometryEstimationCPUIMU, KeyframeManager,
                    SubMapping, GlobalMapping, create_odometry_estimation_gpu_module,
                    create_odometry_estimation_cpu_module, create_sub_mapping_module,
                    create_global_mapping_module, backend_stress.run]
    for kind in ("odometry", "sub_mapping", "global_mapping"):
        entry_points += available_modules(kind).values()
    for fn in entry_points:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            GlimTorch(create_default_config_dir(str(tmp_path / "cfg")))


def test_chip_smoke_gicp_backend_rehearsal_on_cpu():
    """chip_smoke.run_slice with sub-mapping closing a submap every 4
    keyframes, so that the CPU back-end (config_global_mapping_cpu.json)
    refines a between factor for every submap after the first: the plain
    nn_search on the CPU (no launches counted), and phase 4's checks."""
    import chip_smoke

    res = chip_smoke.run_slice(
        "cpu", n_scans=30, n_scan_points=1500, scene_points=20000, seed=53,
        odometry_overrides=dict(window_size=6, initialization_window_size=0.3,
                                model_capacity=8192),
        preprocess_overrides=dict(random_downsample_target=1000, downsample_resolution=0.4),
        sub_mapping_overrides=dict(max_num_keyframes=4))
    assert res["kernel_launches"] == res["between_launches"] == 0
    assert res["submaps"] >= 3 and res["optimizes"] >= 1
    chip_smoke.check_slice(res, min_window_steps=20)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the nn_search kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_slice_on_cuda_launches_the_kernel(cuda):
    import chip_smoke

    res = chip_smoke.run_slice(cuda, n_scans=40, n_scan_points=8000, scene_points=60000,
                               sub_mapping_overrides=dict(max_num_keyframes=4))
    # 40 scans less the 3 s initialization window leave about 9 window steps.
    assert res["kernel_launches"] >= 5 * res["window_steps"] + 6 * res["between_refinements"]
    assert res["between_refinements"] >= 1
    chip_smoke.check_slice(res, min_window_steps=5)
