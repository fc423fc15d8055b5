"""CPU tests of the per-layer readers of the program's thread-CPU split and
of its five-stage map lag (`odometry_offcpu_ms`, `window_scan_step_host_ms`,
`map_lag_{odometry,window,sub_mapping,global,optimize}_s`): on canned scopes,
on a run of a program without those entries, and in a traced run on the CPU.

    python -m pytest benchmark/tests/test_bench_tracing_metrics.py -q
"""

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.tests.test_bench_harness import bench, canned_run  # noqa: E402

STAGES = ("odometry", "window", "sub_mapping", "global", "optimize")
NEW = ("odometry_offcpu_ms", "window_scan_step_host_ms") + \
    tuple(f"map_lag_{st}_s" for st in STAGES)
# What the accepted benchmark's host-span readers print in a short CPU run.
ACCEPTED = {"preprocess_host_ms", "odometry_host_ms", "sub_mapping_host_ms",
            "global_optimize_ms.pipeline"}


def tracing_run():
    """The harness's canned run, its scopes as the program reports them
    with thread CPU keys and the map lag entries."""
    r = canned_run()
    scopes = dict(r["scopes"])
    scopes["odometry"] = dict(scopes["odometry"], cpu_ms=210.0, offcpu_ms=90.0)
    scopes["window_scan_step"] = dict(n=4, total_s=0.96, mean_ms=240.0, max_ms=320.0,
                                      cpu_ms=200.0, offcpu_ms=40.0)
    for st, mean_ms in zip(STAGES, (5000.0, 22000.0, 1000.0, 500.0, 1500.0)):
        scopes[f"map_lag/{st}"] = dict(n=2, total_s=2 * mean_ms / 1e3, mean_ms=mean_ms,
                                       max_ms=1.1 * mean_ms)
    return dict(r, scopes=scopes)


def test_each_new_metric_is_declared_for_both_cells():
    b = bench()
    per_layer = {m["name"]: m for m in b["per_layer"]}
    cells = [w["name"] for w in b["workloads"]]
    for name in NEW:
        m = per_layer[name]
        assert m["workloads"] == cells and m["better"] == "lower", name
        assert m["moves"] == ("scans_per_s" if name in NEW[:2] else "map_lag_s"), name
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", name + ".py"))


def test_new_readers_on_canned_scopes():
    r = tracing_run()
    read = lambda name: run.read_metric(name, r)  # noqa: E731
    assert read("odometry_offcpu_ms") == 90.0
    assert read("window_scan_step_host_ms") == 240.0
    assert [read(f"map_lag_{st}_s") for st in STAGES] == [5.0, 22.0, 1.0, 0.5, 1.5]
    # The accepted readers read what they read before.
    assert read("odometry_host_ms") == 300.0


def test_new_readers_find_nothing_in_a_program_without_the_entries():
    """A program whose scopes lack the new entries and keys (the parent of
    the change that added them): nothing to read, and no error."""
    r = tracing_run()
    old = {k: {f: v[f] for f in ("n", "total_s", "mean_ms", "max_ms")}
           for k, v in r["scopes"].items()
           if k != "window_scan_step" and not k.startswith("map_lag/")}
    empty = dict(r, scopes={}, trace=None, nn_calls=[])
    for name in NEW:
        assert run.read_metric(name, dict(r, scopes=old)) is None, name
        assert run.read_metric(name, empty) is None, name
    zero = dict(r, scopes={k: dict(v, n=0) for k, v in r["scopes"].items()})
    for name in NEW:
        assert run.read_metric(name, zero) is None, name


def test_a_traced_run_on_the_cpu_prints_the_new_metrics(capsys):
    """The --trace 1 path at the harness's tiny CPU size: the two odometry
    readings are always there; a 3 s window may hold no optimize, so the
    map lag stages may be absent, but are finite where printed."""
    rc = run.main(["--workload", "default_gpu.circle", "--seed", "2147484011", "--seconds",
                   "3", "--trace", "1"], device="cpu",
                  traffic_edits=dict(scan_points=4096, scene={"points": 40000, "extent": 30.0},
                                     check_frames=2, trace_scans=2))
    out = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is True
    metrics = set(line["metrics"])
    assert {"odometry_offcpu_ms", "window_scan_step_host_ms"} <= metrics
    assert metrics <= ACCEPTED | set(NEW)
    for name in metrics & set(NEW):
        v = line["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, name
    assert line["metrics"]["window_scan_step_host_ms"]["value"] <= \
        line["metrics"]["odometry_host_ms"]["value"]
