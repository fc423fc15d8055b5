"""CPU tests of the per-layer reader of the CT odometry's CUDA-graph replays
(`ct_graph_replay_pct`): its declaration, and what it reads on canned
scopes, with the program's span and without it.

    python -m pytest benchmark/tests/test_bench_ct_graph_metric.py -q
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.tests.test_bench_harness import bench, canned_run  # noqa: E402

NAME = "ct_graph_replay_pct"


def _run_with(**scopes):
    r = canned_run()
    return dict(r, scopes=dict(r["scopes"], **scopes))


def _scope(n, mean_ms):
    return dict(n=n, total_s=n * mean_ms / 1e3, mean_ms=mean_ms, max_ms=2 * mean_ms,
                cpu_ms=mean_ms, offcpu_ms=0.0)


def test_the_metric_is_declared_for_the_ct_cell():
    b = bench()
    m = {m["name"]: m for m in b["per_layer"]}[NAME]
    assert m["workloads"] == ["ct.circle"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == \
        ("%", "higher", "program_span", "odometry", "scans_per_s")
    assert b["per_layer"][-1]["name"] == NAME      # appended, nothing moved
    assert NAME in [m["name"] for m in run.metrics_for(b, "ct.circle", trace=True)]
    assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", NAME + ".py"))


def test_null_without_the_span():
    """A program without the graph (the parent, or the CPU, where the
    runner calls the step's ops directly) has no replay span: nothing to
    read."""
    assert run.read_metric(NAME, _run_with(ct_scan_step=_scope(40, 590.0))) is None
    assert run.read_metric(NAME, canned_run()) is None
    assert run.read_metric(NAME, dict(canned_run(), scopes={})) is None
    assert run.read_metric(NAME, dict(canned_run(), scopes=None)) is None
    # The window step's replays are not the CT step's.
    r = _run_with(ct_scan_step=_scope(40, 590.0), **{"window_graph/replay": _scope(40, 6.0)})
    assert run.read_metric(NAME, r) is None


def test_100_with_every_step_replayed():
    r = _run_with(ct_scan_step=_scope(400, 16.0), **{"ct_graph/replay": _scope(400, 15.0)})
    assert run.read_metric(NAME, r) == 100.0
    # A window with eager steps in it (a key captured late, or a failed
    # capture) reads their share short of 100.
    r = _run_with(ct_scan_step=_scope(80, 40.0), **{"ct_graph/replay": _scope(60, 15.0)})
    assert run.read_metric(NAME, r) == 75.0
