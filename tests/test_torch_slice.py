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
    from glim_tpu_torch.utils.callbacks import CallbackSlot
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
    glim_t = GlimTorch(_config_dir(t_create, tmp_path / "torch"), device="cpu")
    ests_t, gt_t = _drive(glim_t, seq_t)
    ate_torch = t_ate([e.T_world_lidar for e in ests_t], gt_t, align=True)

    assert nn_search.kernel_launches == launches     # CPU tensors: plain version
    assert len(ests_t) == len(ests_j) >= 15
    assert all(np.isfinite(e.T_world_lidar).all() for e in ests_t)
    assert ate_jax < 0.12 and ate_torch < 0.12, (ate_jax, ate_torch)
    assert ate_torch <= 1.25 * ate_jax + 0.005, (ate_jax, ate_torch)


def test_import_isolation():
    """glim_tpu_torch and its pipeline load neither JAX nor glim_tpu."""
    code = ("import sys, glim_tpu_torch, glim_tpu_torch.pipeline, glim_tpu_torch.state, "
            "glim_tpu_torch.odometry.keyframe_manager, glim_tpu_torch.mapping.sub_mapping; "
            "from glim_tpu_torch.utils.registry import available_modules; "
            "assert 'odometry_estimation_gpu' in available_modules('odometry'); "
            "assert 'sub_mapping' in available_modules('sub_mapping'); "
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
    """Each configuration the port lacks raises, naming itself."""
    from glim_tpu_torch.odometry.odometry_estimation_cpu_imu import (
        OdometryEstimationCPUIMU, OdometryEstimationCPUIMUParams)
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir

    cfg = create_default_config_dir(str(tmp_path / "default"))
    for logical, module, name, value, match in (
            ("config", "global", "config_odometry", "config_odometry_ct.json",
             "libodometry_estimation_ct.so"),
            ("config", "global", "config_sub_mapping", "config_sub_mapping_passthrough.json",
             "libsub_mapping_passthrough.so"),
            ("config_sub_mapping", "sub_mapping", "enable_optimization", True,
             "enable_optimization"),
            ("config_sub_mapping", "sub_mapping", "create_between_factors", True,
             "create_between_factors")):
        path = os.path.join(cfg, f"{logical}.json")
        if logical == "config_sub_mapping":
            path = os.path.join(cfg, "config_sub_mapping_gpu.json")
        with open(path) as f:
            data = json.load(f)
        before = data[module][name]
        data[module][name] = value
        with open(path, "w") as f:
            json.dump(data, f)
        with pytest.raises(NotImplementedError, match=match):
            GlimTorch(cfg, device="cpu")
        data[module][name] = before
        with open(path, "w") as f:
            json.dump(data, f)
    with pytest.raises(NotImplementedError, match="VGICP"):
        OdometryEstimationCPUIMU(OdometryEstimationCPUIMUParams(registration_type="VGICP"),
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="async"):
        GlimTorch(cfg, async_mode=True, device="cpu")
    GlimTorch(cfg, device="cpu")        # the default configuration builds


def test_entry_points_default_to_cuda(tmp_path):
    """Every entry point runs on the card unless the caller asks for the
    CPU; without a card GlimTorch raises and names the remedy."""
    import inspect

    from glim_tpu_torch.mapping.sub_mapping import SubMapping, create_sub_mapping_module
    from glim_tpu_torch.odometry.keyframe_manager import KeyframeManager
    from glim_tpu_torch.odometry.odometry_estimation_cpu import OdometryEstimationCPU
    from glim_tpu_torch.odometry.odometry_estimation_cpu_imu import (
        OdometryEstimationCPUIMU, create_odometry_estimation_cpu_module)
    from glim_tpu_torch.odometry.odometry_estimation_imu import (
        OdometryEstimationIMU, create_odometry_estimation_gpu_module)
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.preprocess.cloud_preprocessor import CloudPreprocessor
    from glim_tpu_torch.utils.config import create_default_config_dir
    from glim_tpu_torch.utils.registry import available_modules

    entry_points = [GlimTorch, CloudPreprocessor, OdometryEstimationIMU,
                    OdometryEstimationCPU, OdometryEstimationCPUIMU, KeyframeManager,
                    SubMapping, create_odometry_estimation_gpu_module,
                    create_odometry_estimation_cpu_module, create_sub_mapping_module]
    for kind in ("odometry", "sub_mapping"):
        entry_points += available_modules(kind).values()
    for fn in entry_points:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            GlimTorch(create_default_config_dir(str(tmp_path / "cfg")))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the nn_search kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_slice_on_cuda_launches_the_kernel(cuda):
    import chip_smoke

    res = chip_smoke.run_slice(cuda, n_scans=40, n_scan_points=8000, scene_points=60000)
    assert res["window_steps"] >= 5
    assert res["kernel_launches"] >= 5 * res["window_steps"]
    assert res["poses_finite"] and res["ate"] < chip_smoke.ATE_BOUND
