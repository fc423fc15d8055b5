"""The benchmark of glim_tpu_torch: one run of one cell.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``benchmark/configs/<config>.json``) and traffic
(``benchmark/traffic/<traffic>.json``); the traffic names its driver
(``benchmark/drivers/<driver>.py``), and each per-layer metric is read by
``benchmark/metrics/<metric>.py``; the check's limits are
``benchmark/limits/<workload>.json``. A new cell or metric is new files.

The run makes its inputs from ``--seed`` on the card, warms up (set-up),
measures ``--seconds``, then drains, frees the program's state and compares
what the timed path produced with the plain reference
(``benchmark/reference``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also end standard error. Without a card, without
the program, or with JAX or ``glim_tpu`` loaded, it prints no result and
exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "glim_tpu")


class NoResult(Exception):
    """A run that must print no result line (no card, no program, JAX)."""


def cache_env() -> dict:
    """Fixed build and kernel-cache directories inside the checkout, so that
    only a cell's first run there builds or compiles."""
    build = os.path.join(ROOT, "build")
    return {"GLIM_TPU_TORCH_BUILD_DIR": os.path.join(build, "glim_tpu_torch"),
            "TRITON_CACHE_DIR": os.path.join(build, "triton_cache")}


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(bench: dict, workload: str):
    """(workload entry, configuration entry, configuration file, traffic file,
    limits) of a cell, found by name."""
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{', '.join(w['name'] for w in bench['workloads'])}")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = load_json(ROOT, cfg_entry["file"])
    traffic = load_json(BENCH, "traffic", f"{wl['traffic']}.json")
    limits = load_json(BENCH, "limits", f"{workload}.json")["checks"]
    return wl, cfg_entry, config, traffic, limits


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metric entries: end-to-end ones untraced, per-layer traced;
    an entry without ``workloads`` belongs to every cell that reports the
    end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def read_metric(name: str, run: dict):
    """``benchmark/metrics/<name>.py``'s ``read(run)``: a number, or None
    when the run holds nothing for it to read."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


def host_facts() -> dict:
    """The card's name and power limit (nvidia-smi) and the host CPU model:
    the same code runs at different speeds on different hosts."""
    facts = {}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        facts["nvidia_smi"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        facts["nvidia_smi"] = f"unavailable: {e}"
    try:
        with open("/proc/cpuinfo") as f:
            facts["cpu"] = next((ln.split(":", 1)[1].strip() for ln in f
                                 if ln.startswith("model name")), "unknown")
    except OSError:
        facts["cpu"] = "unknown"
    facts["cpus"] = os.cpu_count()
    return facts


class Context:
    """What a drivers/ module gets: the run's arguments, the cell's files, the device,
    a temporary directory, and ``apply_fault`` (a no-op outside the tests)."""

    def __init__(self, args, config, traffic, device, tmpdir, fault=None):
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.config, self.traffic, self.device, self.tmpdir = config, traffic, device, tmpdir
        self.t_start = T_START
        self._fault = fault

    def apply_fault(self, target) -> None:
        if self._fault is not None:
            self._fault(target)

    @staticmethod
    def log(msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)


def judge(checks: dict, limits: dict) -> dict:
    """Each limited number beside its limit; a number that is missing or not
    finite fails."""
    out = {}
    for name, limit in limits.items():
        v = checks.get(name, float("nan"))
        out[name] = {"value": v, "limit": limit,
                     "ok": bool(math.isfinite(v) and v <= limit)}
    return out


def result_line(run: dict, judged: dict, metrics: list, wl: dict, trace: bool,
                device_name: str) -> dict:
    values = {}
    for m in metrics:
        v = run["e2e"].get(m["name"]) if not trace else read_metric(m["name"], run)
        if v is None:
            Context.log(f"metric {m['name']}: nothing to read in this run")
            continue
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": int(wl["chips"]),
              "memory_peak_bytes": int(run["memory_peak"])}
    line = {"correct": all(c["ok"] for c in judged.values()),
            "attempted": int(run["attempted"]), "failed": int(run["failed"]),
            "metrics": values, "device": device}
    if trace and run.get("trace"):
        tr = run["trace"]
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in judged.items()}
    return line


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, fault=None, control=None, device="cuda", traffic_edits=None,
         bench=None) -> int:
    """One run; returns the exit code. ``fault`` (applied by the drivers/ module to
    the program it builds), ``control`` (called once the program is
    imported), ``device``, ``traffic_edits`` (a smaller traffic) and
    ``bench`` (BENCHMARK.json's content, with a cell not in it) are for the
    tests and the control runs."""
    args = parse(argv)
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    wl, _, config, traffic, limits = cell(bench, args.workload)
    traffic = dict(traffic, **(traffic_edits or {}))
    for k, v in cache_env().items():
        os.environ[k] = v
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    dev = torch.device(device)
    try:
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise NoResult("no CUDA device: the benchmark measures the card only")
            if torch.cuda.device_count() < int(wl["chips"]):
                raise NoResult(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                               f"{wl['chips']}")
        try:
            import glim_tpu_torch  # noqa: F401
        except ImportError as e:
            raise NoResult(f"the program (glim_tpu_torch) is not importable: {e}")
    except NoResult as e:
        print(f"[bench] no result: {e}", file=sys.stderr, flush=True)
        return 2
    if control is not None:
        control()

    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tmpdir = tempfile.mkdtemp(prefix="glim_bench_")
    ctx = Context(args, config, traffic, dev, tmpdir, fault)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    print("bench-host " + json.dumps(host_facts()), flush=True)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    try:
        run = driver.run(ctx)
    except Exception:
        traceback.print_exc()
        bad = forbidden_modules()
        if bad:
            print(f"[bench] no result: forbidden modules loaded: {bad}", file=sys.stderr)
            return 3
        print(json.dumps({"correct": False, "attempted": 0, "failed": 0, "metrics": {},
                          "device": {"platform": "gpu", "kind": device_name,
                                     "count": int(wl["chips"]), "memory_peak_bytes": 0},
                          "checks": {}}), flush=True)
        return 1
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    bad = forbidden_modules()
    if bad:
        print(f"[bench] no result: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    judged = judge(run["checks"], limits)
    info = dict(run["info"], window_s=run["window_s"],
                unlimited_checks={k: v for k, v in run["checks"].items() if k not in limits})
    if run.get("trace"):
        info["trace"] = {k: v for k, v in run["trace"].items()
                         if k not in ("kernels", "device_ops", "idle_gaps")}
        info["nn_calls"] = len(run.get("nn_calls", []))
    print("bench-info " + json.dumps(info), flush=True)
    if run.get("scopes"):
        print("bench-scopes " + json.dumps(run["scopes"]), flush=True)
    line = result_line(run, judged, metrics_for(bench, args.workload, bool(args.trace)), wl,
                       bool(args.trace), device_name)
    for name, c in judged.items():
        print(f"[check] {name} = {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
