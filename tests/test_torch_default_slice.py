"""The default configuration end to end: GlimTorch against GlimTPU on the
default config directory (odometry_estimation_gpu, VGICP keyframe maps,
then sub_mapping), and a CPU rehearsal of chip_smoke.py's default phase.

Both pipelines run synchronously on the same numpy-generated sequence with
the default config directory and no file edits; only sizes are overridden
(scan points, the preprocessing target, the window, the voxel capacity and
the sub-mapping keyframe count). GlimTPU's global mapping, which the port
does not have yet, is replaced by a stand-in; odometry and sub-mapping do
not depend on it. Random draws differ between the packages, so odometry is
compared on accuracy: both ATEs under the module's 0.08 m bound
(tests/test_odometry_imu.py) and the port within 1.25 x the JAX ATE + 5 mm;
both pipelines close at least two submaps, and the port's submaps hold
every frame that reached sub-mapping.
"""

import numpy as np
import pytest
import torch

ATE_BOUND = 0.08
SEQ = dict(duration=3.0, n_scan_points=1500, scene_points=20000, seed=53)
OVERRIDES = [
    ("config_odometry", "odometry_estimation", "window_size", 6),
    ("config_odometry", "odometry_estimation", "voxel_capacity", 16384),
    ("config_odometry", "odometry_estimation", "initialization_window_size", 0.3),
    ("config_preprocess", "preprocess", "random_downsample_target", 1000),
    ("config_preprocess", "preprocess", "downsample_resolution", 0.4),
    ("config_sub_mapping", "sub_mapping", "max_num_keyframes", 4),
]


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


class _NoGlobalMapping:
    """Stand-in for GlimTPU's global mapping, which the port does not have
    yet; it keeps the submaps it is given."""

    def __init__(self):
        self.submaps = []

    def insert_imu(self, *a):
        pass

    def insert_submap(self, submap):
        self.submaps.append(submap)

    def optimize(self):
        pass


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


def test_default_config_matches_glim_tpu(tmp_path):
    from glim_tpu.io.synthetic import ate_rmse as j_ate
    from glim_tpu.io.synthetic import generate_sequence as j_generate
    from glim_tpu.pipeline import GlimTPU
    from glim_tpu.utils.config import create_default_config_dir as j_create
    from glim_tpu_torch.io.synthetic import ate_rmse as t_ate
    from glim_tpu_torch.io.synthetic import generate_sequence as t_generate
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir as t_create

    seq_j, seq_t = j_generate(**SEQ), t_generate(**SEQ)
    glim_j = GlimTPU(j_create(str(tmp_path / "jax")), async_mode=False, overrides=OVERRIDES)
    glim_j.global_mapping = _NoGlobalMapping()
    ests_j, gt_j = _drive(glim_j, seq_j)
    ate_jax = j_ate([e.T_world_lidar for e in ests_j], gt_j, align=True)

    glim_t = GlimTorch(t_create(str(tmp_path / "torch")), device="cpu", overrides=OVERRIDES)
    assert type(glim_t.odometry).__name__ == "OdometryEstimationIMU"
    assert type(glim_t.sub_mapping).__name__ == "SubMapping"
    ests_t, gt_t = _drive(glim_t, seq_t)
    ate_torch = t_ate([e.T_world_lidar for e in ests_t], gt_t, align=True)

    assert len(ests_t) == len(ests_j) >= 25
    assert all(np.isfinite(e.T_world_lidar).all() for e in ests_t)
    assert ate_jax < ATE_BOUND and ate_torch < ATE_BOUND, (ate_jax, ate_torch)
    assert ate_torch <= 1.25 * ate_jax + 0.005, (ate_jax, ate_torch)
    subs_j, subs_t = glim_j.global_mapping.submaps, glim_t.submaps
    assert len(subs_j) >= 2 and len(subs_t) >= 2, (len(subs_j), len(subs_t))
    assert sum(len(s.frames) for s in subs_t) == len(ests_t)
    assert [s.id for s in subs_t] == list(range(len(subs_t)))
    for s in subs_t:
        assert s.frame.mask.sum() > 500 and torch.isfinite(s.frame.points).all()


def test_chip_smoke_default_rehearsal_on_cpu():
    """chip_smoke.run_default at a tiny size on the CPU: the default
    configuration's path that the card runs, with its checks."""
    import chip_smoke

    res = chip_smoke.run_default(
        "cpu", n_scans=25, n_scan_points=1500, scene_points=20000, seed=53,
        overrides=OVERRIDES)
    assert res["scans"] == 25 and res["poses_finite"]
    assert res["ate"] < chip_smoke.DEFAULT_ATE_BOUND
    assert res["submaps"] >= 2 and res["submap_frames_total"] == res["frames_to_sub_mapping"]
    assert res["kf_inserts"] >= res["kf_evictions"] + 1 and res["max_memory_allocated"] is None
    chip_smoke.check_default(res)


def test_chip_smoke_evict_rehearsal_on_cpu():
    """chip_smoke's eviction run (phase 5b: every frame a keyframe) at a
    tiny size on the CPU: past the 15 kept keyframes every insert evicts one,
    the manager never holds more, and the checks hold."""
    import chip_smoke

    res = chip_smoke.run_default(
        "cpu", n_scans=25, n_scan_points=1500, scene_points=20000, seed=53,
        overrides=OVERRIDES + chip_smoke.EVICT_OVERRIDES)
    assert res["kf_inserts"] - res["kf_evictions"] == 15 and res["kf_evictions"] >= 3
    chip_smoke.check_default(res, "eviction run", min_evictions=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_default_slice_on_cuda(cuda):
    """The default configuration on the card at a mid size: finite poses,
    the ATE bound, submaps holding every frame, and every tensor of the
    submaps on the card."""
    import chip_smoke

    res = chip_smoke.run_default(cuda, n_scans=40, n_scan_points=8000, scene_points=60000)
    chip_smoke.check_default(res)
    assert res["submap_device"] == "cuda"
