"""CPU tests of the CT cell (`ct.circle`): its entries and files, the readers
of the CT odometry's spans (`ct_step_host_ms`, `ct_lookup_host_ms`,
`ct_model_insert_host_ms`), a traced run of the cell through
`benchmark.run.main` at a tiny size, and a fault planted in the CT step (the
constant-velocity prior dropped) that the step checks against the plain
reference (`benchmark/reference/ct_step.py`) must catch.

    python -m pytest benchmark/tests/test_bench_ct.py -q    (~4 min on an idle CPU)
"""

import json
import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.tests.test_bench_harness import bench, canned_run  # noqa: E402

CELL = "ct.circle"
NEW = ("ct_step_host_ms", "ct_lookup_host_ms", "ct_model_insert_host_ms")
STEP_CHECKS = ("ct_step_trans_err_m", "ct_step_rot_err_deg", "ct_twist_err")
# The accepted readers that read the CT cell unchanged.
APPENDED = ("preprocess_host_ms", "odometry_host_ms", "odometry_offcpu_ms",
            "launches_per_scan", "device_idle_pct.pipeline", "nn_search_roofline")
EDITS = dict(scan_points=2048, scene={"points": 40000, "extent": 30.0}, check_frames=2,
             trace_scans=2)


def test_the_cell_and_its_files():
    """One configuration and one cell added, each file it names present;
    CT's end-to-end metrics are scans_per_s, the p90 and setup_s (the map
    lag's back half, the same code, is guarded by default_gpu.circle)."""
    b = bench()
    cfg = {c["name"]: c for c in b["configs"]}["ct"]
    assert cfg["file"] == "benchmark/configs/ct.json" and cfg["reduced"] == ["log_dir"]
    wl, _, config, traffic, limits = run.cell(b, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("ct", "circle_ct", 1)
    assert b["workloads"][-1]["name"] == CELL
    assert os.path.isfile(os.path.join(ROOT, "benchmark", "drivers", traffic["driver"] + ".py"))
    assert set(STEP_CHECKS) <= set(limits)
    e2e = [m["name"] for m in run.metrics_for(b, CELL, trace=False)]
    assert sorted(e2e) == ["odom_latency_p90_ms", "scans_per_s", "setup_s"]
    per_layer = [m["name"] for m in run.metrics_for(b, CELL, trace=True)]
    assert sorted(per_layer) == sorted(APPENDED + NEW)
    for name in per_layer:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", name + ".py"))
    # Every cell's driver exists (the circle cells' is `pipeline`).
    for w in b["workloads"]:
        t = run.cell(b, w["name"])[3]
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "drivers", t["driver"] + ".py"))


def test_the_frozen_tree_is_the_ct_preset():
    """config.json selects the CT odometry with the iVox model; sub-mapping
    and the back-end are the GPU files with the IMU off; the traffic is
    circle's numbers."""
    b = bench()
    _, _, config, traffic, _ = run.cell(b, CELL)
    tree = config["glim"]
    g = tree["config.json"]["global"]
    odo = tree[g["config_odometry"]]["odometry_estimation"]
    assert g["config_odometry"] == "config_odometry_ct.json"
    assert odo["so_name"] == "libodometry_estimation_ct.so" and odo["model_type"] == "ivox"
    assert tree[g["config_sub_mapping"]]["sub_mapping"]["enable_imu"] is False
    assert tree[g["config_global_mapping"]]["global_mapping"]["enable_imu"] is False
    circle = run.cell(b, "default_gpu.circle")[3]
    assert {k: v for k, v in traffic.items() if k not in ("driver", "why", "ct_check_steps")} \
        == {k: v for k, v in circle.items() if k not in ("driver", "why")}
    assert traffic["ct_check_steps"] == 4


def _scope(n, mean_ms):
    return dict(n=n, total_s=n * mean_ms / 1e3, mean_ms=mean_ms, max_ms=2 * mean_ms,
                cpu_ms=mean_ms, offcpu_ms=0.0)


def test_readers_on_canned_scopes():
    r = canned_run()
    r = dict(r, scopes=dict(r["scopes"], ct_scan_step=_scope(80, 450.0),
                            **{"ct/lookup": _scope(320, 20.0),
                               "ct/model_insert": _scope(80, 12.5)}))
    assert run.read_metric("ct_step_host_ms", r) == 450.0
    assert run.read_metric("ct_lookup_host_ms", r) == pytest.approx(80.0)   # 4 x 20 ms
    assert run.read_metric("ct_model_insert_host_ms", r) == 12.5
    # A program without the spans (the parent, or another odometry).
    for name in NEW:
        assert run.read_metric(name, canned_run()) is None, name
        assert run.read_metric(name, dict(canned_run(), scopes={})) is None, name


def test_a_traced_run_on_the_cpu_prints_the_ct_metrics(capsys):
    """The --trace 1 path of the cell at a tiny size (no card: the device
    readers find nothing): the three CT readings and the accepted host
    readers, finite; the window's sampled steps agree with the reference."""
    rc = run.main(["--workload", CELL, "--seed", "2147484021", "--seconds", "8", "--trace", "1"],
                  device="cpu", traffic_edits=EDITS)
    out = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    metrics = line["metrics"]
    assert set(NEW) | {"preprocess_host_ms", "odometry_host_ms", "odometry_offcpu_ms"} \
        <= set(metrics) <= set(NEW + APPENDED)
    for name in metrics:
        assert math.isfinite(metrics[name]["value"]) and metrics[name]["value"] >= 0, name
    assert metrics["ct_step_host_ms"]["value"] <= metrics["odometry_host_ms"]["value"]
    for name in STEP_CHECKS:
        c = line["checks"][name]
        assert c["value"] <= c["limit"], (name, c)


def test_cv_prior_dropped_is_not_correct(capsys, monkeypatch):
    """The CT step without its constant-velocity prior: the sampled steps
    leave the reference's by more than the step checks allow."""
    from glim_tpu_torch.odometry import odometry_estimation_ct as ct_mod

    priors = ct_mod._priors

    def without_cv(T_b, T_e, T_prev_e, cv_target, weights):
        return priors(T_b, T_e, T_prev_e, cv_target,
                      weights * torch.tensor([1.0, 0.0], device=weights.device))

    def fault(glim):
        monkeypatch.setattr(ct_mod, "_priors", without_cv)

    rc = run.main(["--workload", CELL, "--seed", "3000000077", "--seconds", "8", "--trace", "0"],
                  fault=fault, device="cpu", traffic_edits=EDITS)
    out = capsys.readouterr().out
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert not line["correct"]
    assert any(line["checks"][n]["value"] > line["checks"][n]["limit"] for n in STEP_CHECKS), \
        line["checks"]
