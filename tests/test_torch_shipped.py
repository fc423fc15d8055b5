"""chip_smoke.py phase 7 rehearsed on the CPU at a tiny size: each shipped
configuration the port gained (CT with either model, the LiDAR-IMU odometry
in VGICP mode, the LiDAR-only odometry, pass-through sub-mapping) through
GlimTorch from config files edited as the card's run edits them, with the
phase's checks (ATE bounds, every frame that reached sub-mapping in a
submap, an optimize, the submap-origin ATE). On the CPU the plain nn_search
runs, so no launch is counted; the launch count the card must match is
computed from the run all the same.
"""

import pytest
import torch
from torch_parity import SMALL_DEFAULT_OVERRIDES

# The CPU tests' sizes: SMALL_DEFAULT_OVERRIDES for preprocessing and
# sub-mapping (and the flagship odometry), a 6-state window and a small
# point map for the frame-to-model odometry.
_SMALL_CPU_ODOMETRY = [("config_odometry", "odometry_estimation", k, v) for k, v in (
    ("window_size", 6), ("initialization_window_size", 0.3), ("model_capacity", 16384))]


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils import lifecycle
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


@pytest.mark.parametrize("name", ["ct", "ct_ivox", "cpu_vgicp", "lidar_only", "passthrough"])
def test_phase7_rehearsal_on_cpu(name):
    import chip_smoke

    overrides = [o for o in SMALL_DEFAULT_OVERRIDES
                 if o[0] != "config_odometry" or name == "passthrough"]
    if name in ("cpu_vgicp", "lidar_only"):
        overrides += _SMALL_CPU_ODOMETRY
    res = chip_smoke.run_shipped("cpu", name, n_scans=24, n_scan_points=1500,
                                 scene_points=20000, seed=53, overrides=overrides)
    assert res["kernel_launches"] == 0 and res["max_memory_allocated"] is None
    want_odometry = {"ct": "OdometryEstimationCT", "ct_ivox": "OdometryEstimationCT",
                     "cpu_vgicp": "OdometryEstimationCPUIMU",
                     "lidar_only": "OdometryEstimationCPU",
                     "passthrough": "OdometryEstimationIMU"}[name]
    assert res["odometry"] == want_odometry
    assert res["sub_mapping"] == ("SubMappingPassthrough" if name == "passthrough"
                                  else "SubMapping")
    n_outer = 4    # lm_max_iterations / max_iterations 8, two iterations a search
    replayed = {"ct_ivox": 5, "lidar_only": 8}.get(name, 0)
    assert res["expected_launches"] == (n_outer * (res["steps"] + replayed)
                                        if replayed else 0)
    chip_smoke.check_shipped(res)
