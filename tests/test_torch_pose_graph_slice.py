"""chip_smoke.py phases 9 and 5d rehearsed on the CPU at a tiny size.

Phase 9: the pose-graph configuration (the default configuration with
config_global_mapping_pose_graph.json, and sub-mapping's
enable_optimization and create_between_factors) through GlimTorch
(synchronous) from config files edited as the card's run edits them, on a
loop that closes: tests/test_loop_closure_e2e.py's generator shrunk to a
4 m circle at 1 rad/s, 64 scans of 1500 points (one lap, 25 m), with the
CPU tests' cut of the default configuration, submap clouds of 2048 points
and min_travel_dist 15 m for the short lap. The phase's checks hold: ATE
bounds, every frame that reached sub-mapping in a submap, every submap with
two keyframes refined, a loop, an optimize. On the CPU the plain nn_search
runs, so no launch is counted; the count the card must match is computed
all the same.

Phase 5d: the stress tool's ring at 16 submaps through the pose-graph
back-end: the pre-closure ATE equals the JAX tool's (the same numpy ring),
and the detection thread closes the loop.
"""

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


def test_phase9_rehearsal_on_cpu():
    import chip_smoke

    overrides = SMALL_DEFAULT_OVERRIDES + [
        ("config_sub_mapping", "sub_mapping", "submap_target_num_points", 2048),
        ("config_global_mapping", "global_mapping", "min_travel_dist", 15.0)]
    res = chip_smoke.run_pose_graph_config("cpu", n_scans=64, n_scan_points=1500,
                                           scene_points=20000, seed=53, radius=4.0, omega=1.0,
                                           overrides=overrides)
    assert res["kernel_launches"] == 0 and res["max_memory_allocated"] is None
    assert (res["odometry"], res["global_mapping"]) == ("OdometryEstimationIMU",
                                                         "GlobalMappingPoseGraph")
    # One between information a frame but each submap's first, one
    # inlier_fraction a VGICP registration.
    assert res["between_infos"] == res["submap_frames_total"] - res["submaps"]
    assert res["expected_launches"] == res["between_infos"] + res["registrations"]
    assert res["registrations"] >= res["loops"] >= 1
    assert len(res["refine_ms"]) == res["submaps"]
    chip_smoke.check_pose_graph_config(res)


def test_phase5d_rehearsal_on_cpu():
    import chip_smoke
    from glim_tpu.tools import backend_stress as j_stress

    res = chip_smoke.run_pose_graph_ring("cpu", n_submaps=16)
    j_rows = j_stress.run_pose_graph(16, 4)
    assert res["ate_pre_closure_m"] == j_rows[-1]["ate_pre_closure_m"] > 0.02
    assert res["loops"] >= 1 and res["ate_post_closure_m"] < res["ate_pre_closure_m"]
    assert res["poses_finite"] and res["kernel_launches"] == 0
    assert res["expected_launches"] == res["registrations"] >= res["loops"]
    assert [r["submaps"] for r in res["rows"]] == [16]
