"""CPU tests of the benchmark harness: BENCHMARK.json against its rules, the
result line, the metric readers, the trace reduction, a cell added from new
files only, and the rules on what a run may load and when it prints nothing.

    python -m pytest benchmark/tests -q
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import readers, roofline, run, trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    # A full check of 24 cells fits its 43,200 s.
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    b = bench()
    metrics = b["end_to_end"] + b["per_layer"]
    names = [x["name"] for x in b["configs"] + b["workloads"] + metrics]
    for n in names:
        assert NAME.match(n), n
    for group in (b["configs"], b["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].split("/")[0] in b["paths"]
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])
        reporting = [w["name"] for w in b["workloads"]
                     if w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])]
        assert set(m["workloads"]) <= set(reporting), m["name"]


def test_every_cell_reports_what_it_must():
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in run.metrics_for(b, w["name"], trace=False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert run.metrics_for(b, w["name"], trace=True), w["name"]


def test_every_file_a_name_points_at_exists():
    b = bench()
    for w in b["workloads"]:
        _, _, config, traffic, limits = run.cell(b, w["name"])
        assert traffic["driver"] == "pipeline"
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "drivers",
                                           traffic["driver"] + ".py"))
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))


def canned_run(trace_on=True):
    scopes = {"preprocess": dict(n=4, total_s=0.08, mean_ms=20.0, max_ms=30.0),
              "odometry": dict(n=4, total_s=1.2, mean_ms=300.0, max_ms=400.0),
              "sub_mapping": dict(n=4, total_s=0.4, mean_ms=100.0, max_ms=150.0),
              "global/insert_submap": dict(n=2, total_s=2.4, mean_ms=1200.0, max_ms=1300.0),
              "global/optimize": dict(n=2, total_s=2.0, mean_ms=1000.0, max_ms=1100.0)}
    tr = None
    if trace_on:
        tr = dict(busy_s=0.5, window_s=5.0, span_s=4.9, n_kernels=1000, scans=10,
                  kernels={"pack_targets_kernel": (5, 0.0001),
                           "search_split_kernel": (5, 0.0010),
                           "merge_splits_kernel": (5, 0.0002)},
                  device_ops=[["search_split_kernel", 0.001]], idle_gaps=[["odometry", 4.0]])
    return dict(attempted=12, failed=0, e2e={"scans_per_s": 2.5, "setup_s": 40.0,
                                            "odom_latency_p90_ms": 500.0, "map_lag_s": 15.0},
                window_s=40.0, scopes=scopes, trace=tr,
                nn_calls=[(16384, 131072, 16000, 90000)] * 5, checks={"odom_ate_m": 0.01},
                info={}, memory_peak=123)


def test_result_line_keys_on_a_canned_run():
    b = bench()
    wl = {w["name"]: w for w in b["workloads"]}["gicp_cpu.circle"]
    for trace_on in (False, True):
        r = canned_run(trace_on)
        judged = run.judge(r["checks"], {"odom_ate_m": 0.05, "odom_max_err_m": 0.2})
        line = run.result_line(r, judged, run.metrics_for(b, wl["name"], trace_on), wl,
                               trace_on, "NVIDIA H100 80GB HBM3")
        assert list(line)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
        assert line["correct"] is False          # odom_max_err_m is missing: fails
        assert line["checks"]["odom_ate_m"] == {"value": 0.01, "limit": 0.05}
        dev = line["device"]
        assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] == 123
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
        if trace_on:
            assert dev["busy_s"] == 0.5 and dev["window_s"] == 5.0
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
            assert "nn_search_roofline" in line["metrics"]
        else:
            assert set(line["metrics"]) == {"scans_per_s", "setup_s", "odom_latency_p90_ms",
                                            "map_lag_s"}
        json.loads(json.dumps(line))


def test_judge_fails_missing_and_non_finite():
    j = run.judge({"a": 0.1, "b": float("nan"), "c": 0.0}, {"a": 0.2, "b": 1.0, "c": 0, "d": 1})
    assert [j[k]["ok"] for k in "abcd"] == [True, False, True, False]


def test_metric_readers_on_canned_data():
    r = canned_run()
    read = lambda name: run.read_metric(name, r)  # noqa: E731
    assert read("preprocess_host_ms") == 20.0
    assert read("odometry_host_ms") == 300.0
    assert read("sub_mapping_host_ms") == 100.0
    assert read("global_optimize_ms.pipeline") == 1000.0
    assert read("launches_per_scan") == 100.0
    assert read("device_idle_pct.pipeline") == pytest.approx(90.0)
    bound = roofline.nn_bound_s(16384, 131072, 16000, 90000)
    assert bound == pytest.approx(8 * 16000 * 90000 / 67e12)
    assert read("nn_search_roofline") == pytest.approx(100 * 5 * bound / 0.0013)
    # Nothing to read: no number, never 0.
    empty = dict(r, scopes={}, trace=None, nn_calls=[])
    for name in ("preprocess_host_ms", "launches_per_scan", "device_idle_pct.pipeline",
                 "nn_search_roofline", "global_optimize_ms.pipeline"):
        assert run.read_metric(name, empty) is None, name
    assert readers.device_idle_pct(dict(r, trace=dict(r["trace"], busy_s=0.0))) is None


def test_trace_reduction_on_canned_events():
    ev = [dict(ph="X", cat="kernel", name="void (anonymous namespace)::search_split_kernel"
               "<4>(float const*, int)", ts=100.0, dur=10.0),
          dict(ph="X", cat="kernel", name="merge_splits_kernel", ts=105.0, dur=10.0),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=130.0, dur=5.0),
          dict(ph="X", cat="kernel", name="void at::native::vectorized_elementwise_kernel<4>()",
               ts=200.0, dur=20.0),
          dict(ph="X", cat="user_annotation", name="odometry", ts=0.0, dur=300.0),
          dict(ph="X", cat="user_annotation", name="window_scan_step", ts=140.0, dur=50.0),
          dict(ph="X", cat="cpu_op", name="aten::add", ts=10.0, dur=1.0),
          dict(ph="i", cat="kernel", name="instant", ts=0.0)]
    out = trace.reduce_events(ev)
    assert out["busy_s"] == pytest.approx(40e-6)
    assert out["span_s"] == pytest.approx(120e-6)
    assert out["n_kernels"] == 3
    assert out["kernels"]["search_split_kernel"][0] == 1
    assert out["kernels"]["vectorized_elementwise_kernel"][1] == pytest.approx(20e-6)
    gaps = dict(out["idle_gaps"])
    assert gaps["odometry"] == pytest.approx(15e-6)           # 115-130: only the outer span
    assert gaps["window_scan_step"] == pytest.approx(65e-6)   # 135-200: the inner one


def test_kernel_names():
    assert trace.kernel_name("void ns::f<int>(float*)") == "f"
    assert trace.kernel_name("(anonymous namespace)::g(int)") == "g"
    assert trace.kernel_name("plain") == "plain"


def copy_benchmark(dst):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_a_cell_added_from_new_files_only_is_listed(tmp_path):
    """A later PR's cell: a new traffic file and limits file and new entries in
    BENCHMARK.json, no file edited; the harness resolves it by name."""
    copy_benchmark(tmp_path)
    with open(tmp_path / "benchmark" / "traffic" / "circle.json") as f:
        traffic = json.load(f)
    traffic.update(path=dict(traffic["path"], speed=4.0))
    with open(tmp_path / "benchmark" / "traffic" / "circle_fast.json", "w") as f:
        json.dump(traffic, f)
    shutil.copy(tmp_path / "benchmark" / "limits" / "default_gpu.circle.json",
                tmp_path / "benchmark" / "limits" / "default_gpu.circle_fast.json")
    with open(tmp_path / "benchmark" / "metrics" / "new_counter.py", "w") as f:
        f.write("def read(run):\n    return 7.0\n")
    b = bench()
    b["workloads"].append(dict(name="default_gpu.circle_fast", config="default_gpu",
                               traffic="circle_fast", chips=1, why="a faster circle"))
    b["per_layer"].append(dict(name="new_counter", unit="1", better="lower",
                               source="program_counter", layer="odometry",
                               moves="scans_per_s", workloads=["default_gpu.circle_fast"]))
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    code = ("import json; from benchmark import run; b = run.load_json(run.ROOT, "
            "'BENCHMARK.json'); wl, _, c, t, l = run.cell(b, 'default_gpu.circle_fast'); "
            "ms = [m['name'] for m in run.metrics_for(b, wl['name'], True)]; "
            "print(json.dumps([wl['name'], c['name'], t['path']['speed'], sorted(l), ms, "
            "run.read_metric('new_counter', {})]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(tmp_path)), timeout=120)
    assert out.returncode == 0, out.stderr
    name, config, speed, limits, ms, value = json.loads(out.stdout.strip().splitlines()[-1])
    assert (name, config, speed, value) == ("default_gpu.circle_fast", "default_gpu", 4.0, 7.0)
    assert "odom_max_orth" in limits and ms == ["new_counter"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for n in ("glim_tpu_torch.fake", "jaxfoo", "glim_tpu_x", "flaxen"):
        monkeypatch.setitem(sys.modules, n, object())
    assert run.forbidden_modules() == []
    for n in ("glim_tpu.fake", "jax", "jaxlib.x", "flax"):
        monkeypatch.setitem(sys.modules, n, object())
        assert n in run.forbidden_modules()


def test_what_a_run_loads_holds_no_jax():
    """Every module of the benchmark and of the program a run drives, imported
    in a fresh process, loads neither JAX nor glim_tpu."""
    code = ("import benchmark.run as r, benchmark.control, benchmark.drivers.pipeline, "
            "benchmark.glim_config, benchmark.trace, benchmark.roofline; "
            "import glim_tpu_torch.pipeline, glim_tpu_torch.mapping.global_mapping; "
            "import glim_tpu_torch.mapping.async_global_mapping, "
            "glim_tpu_torch.mapping.async_sub_mapping; "
            "import glim_tpu_torch.odometry.odometry_estimation_imu; "
            "import glim_tpu_torch.odometry.odometry_estimation_cpu_imu; "
            "import os; [r.read_metric(f[:-3], {}) for f in "
            "sorted(os.listdir('benchmark/metrics')) if f.endswith('.py')]; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _no_result(cwd, env_extra):
    env = dict(os.environ, PYTHONPATH=str(cwd), **env_extra)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "default_gpu.circle", "--seed", "3000000019", "--seconds", "1",
                          "--trace", "0"], cwd=cwd, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert not any(ln.startswith("{") for ln in out.stdout.splitlines())
    return out


def test_no_card_no_result():
    out = _no_result(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert "no result" in out.stderr


def test_without_the_program_no_result(tmp_path):
    copy_benchmark(tmp_path)
    _no_result(tmp_path, {})


def test_a_traced_run_on_the_cpu_prints_the_per_layer_line(capsys):
    """The --trace 1 path end to end at a tiny size (no card, so the profiler
    sees the host only and the device readers find nothing)."""
    rc = run.main(["--workload", "default_gpu.circle", "--seed", "2147483999", "--seconds",
                   "3", "--trace", "1"], device="cpu",
                  traffic_edits=dict(scan_points=4096, scene={"points": 40000, "extent": 30.0},
                                     check_frames=2, trace_scans=2))
    out = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"] is True
    # Host spans only; a 3 s window may hold no global optimize.
    assert {"preprocess_host_ms", "odometry_host_ms", "sub_mapping_host_ms"} <= \
        set(line["metrics"]) <= {"preprocess_host_ms", "odometry_host_ms",
                                 "sub_mapping_host_ms", "global_optimize_ms.pipeline"}
    assert line["device"]["window_s"] > 0 and "breakdown" in line
    assert out.err.strip().splitlines()[-1].startswith("[check] ")


def test_config_tree_is_written_as_the_file_freezes_it(tmp_path):
    """Each configuration file holds config.json and every file it selects;
    a run writes them as they stand, ${TMPDIR} read as its own directory, and
    the program reads the deployment's files from there."""
    from benchmark import glim_config
    from glim_tpu_torch.utils.config import GlobalConfig
    b = bench()
    for c in b["configs"]:
        config = run.load_json(ROOT, c["file"])
        tree = config["glim"]
        selected = {v for k, v in tree["config.json"]["global"].items()
                    if k.startswith("config_") and k != "config_path" and v}
        assert selected | {"config.json"} == set(tree), c["name"]
        root = tmp_path / c["name"]
        path = glim_config.config_dir(config, str(root))
        assert sorted(os.listdir(path)) == sorted(tree)
        for fname, data in tree.items():
            with open(os.path.join(path, fname)) as f:
                assert json.loads(json.dumps(data).replace("${TMPDIR}", str(root))) == \
                    json.load(f)
        GlobalConfig.reset()
        g = GlobalConfig.instance(path)
        for logical in ("config_odometry", "config_sub_mapping", "config_global_mapping"):
            assert os.path.basename(g.get_config_path(logical)) == \
                tree["config.json"]["global"][logical]
        assert g.get_config("config_logging").param("logging", "log_dir", "") == str(root)
        GlobalConfig.reset()
        pre = glim_config.preprocess_params(config)
        assert pre["quantize_resolution"] == config["quantize_resolution"]
        assert pre["random_downsample_target"] == \
            tree["config_preprocess.json"]["preprocess"]["random_downsample_target"]
