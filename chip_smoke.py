"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile [DIR]   # profile of the default configuration

Phases (any failure exits non-zero):
  1. print the card (name and power limit as nvidia-smi reports them) and
     the software versions;
  2. build the nn_search CUDA kernel from glim_tpu_torch/csrc and hold it
     against its plain PyTorch version at the main path's shapes (16384 and
     4096 queries against 131072 targets, ~30% masked), a ragged case and a
     duplicate-target case;
  3. time kernel and plain version at 16384 x 131072 with CUDA events, in
     turns (plain, kernel, kernel, plain);
  4. drive the GICP LiDAR-IMU odometry slice through GlimTorch on the card:
     config_odometry_cpu.json at its defaults, then sub-mapping, 150
     synthetic scans of 65,536 points with 200 Hz IMU; check the kernel
     launches, finite poses and the ATE bound;
  5. drive the default configuration through GlimTorch on the card, with no
     config edits (odometry_estimation_gpu: VGICP keyframe maps, then
     sub_mapping): 150 synthetic scans of 65,536 points at 10 Hz with 200 Hz
     IMU; check finite poses, the ATE bound, and submaps that hold every
     frame that reached sub-mapping. This path runs no hand-written kernel;
  5b. the same configuration and sequence (first 80 scans) with one edit,
     keyframe_max_overlap 1.0, so that every frame becomes an odometry
     keyframe and, past the 15 kept, every insert evicts one: the keyframe
     manager's full-size eviction (the K x K x C overlap lookup, the model
     rebuild, the host read of the scores); the same checks, and at least
     one eviction;
  6. print the kernel summary JSON and, last, the device JSON.

``--profile`` runs phase 5's configuration for 100 scans: host-clock time
over scans 60-79 (the 48-state window is full and sub-mapping busy from
about scan 58), one ``torch.profiler`` window over scans 80-89 and one
``torch.cuda.set_sync_debug_mode("warn")`` count over scans 90-94; it
writes the tables to DIR/profile_default.txt (DIR defaults to build/).
It then does the same for phase 5b's eviction run (DIR/profile_evict.txt).

``run_slice`` and ``run_default`` are importable and run on any device (the
CPU tests rehearse them at a tiny size); ``main`` requires a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter

import numpy as np
import torch

ATE_BOUND = 0.12          # m; the JAX package's bound for the GICP module
DEFAULT_ATE_BOUND = 0.08  # m; the JAX package's bound for the VGICP module
# Phase 5b: every frame a keyframe, so every insert past the 15 kept evicts.
EVICT_OVERRIDES = [("config_odometry", "odometry_estimation", "keyframe_max_overlap", 1.0)]
EVICT_SCANS = 80
REL_TOL = 1e-4            # nn_search d2 tolerance: REL_TOL * max(1, d2)


def _sequence(n_scans, n_scan_points, scene_points, seed):
    """A synthetic sequence at 10 Hz scans / 200 Hz IMU."""
    from glim_tpu_torch.io.synthetic import generate_sequence
    return generate_sequence(duration=n_scans / 10.0, scan_hz=10.0, imu_hz=200.0,
                             n_scan_points=n_scan_points, scene_points=scene_points,
                             noise=0.01, seed=seed)


def _timed_run(glim, seq, dev, on_scan=None) -> dict:
    """Feed ``seq`` through ``glim`` and flush it, timed on the host clock up
    to a device sync; the nn_search launch count is zeroed just before and
    read just after. Returns the metrics every configuration reports."""
    from glim_tpu_torch.io.synthetic import ate_rmse
    from glim_tpu_torch.ops.nn_search import nn_search

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    nn_search.kernel_launches = 0
    t0 = time.perf_counter()
    _feed(glim, seq, on_scan)
    glim.wait()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = nn_search.kernel_launches

    ests = glim.odometry_estimates
    window = glim.odometry.window
    poses = [e.T_world_lidar for e in ests]
    gt = [seq.gt_poses[int(round(e.stamp * 10.0))] for e in ests]
    return dict(
        scans=len(seq.scans), estimates=len(ests),
        window_steps=int(window.step) if window is not None else 0,
        seconds=seconds, scans_per_s=len(seq.scans) / seconds,
        max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        kernel_launches=launches,
        poses_finite=bool(all(np.all(np.isfinite(T)) for T in poses)),
        ate=ate_rmse(poses, gt, align=True))


def run_slice(device, n_scans: int = 150, n_scan_points: int = 65536,
              scene_points: int = 400000, seed: int = 0,
              odometry_overrides=None, preprocess_overrides=None) -> dict:
    """Run GlimTorch (sync, config_odometry_cpu.json) over a synthetic
    sequence at 10 Hz scans / 200 Hz IMU; returns the run's metrics."""
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir

    dev = torch.device(device)
    cfg_dir = create_default_config_dir(tempfile.mkdtemp(prefix="glim_smoke_"))

    def edit(fname, section, values):
        path = os.path.join(cfg_dir, fname)
        with open(path) as f:
            cfg = json.load(f)
        cfg[section].update(values)
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2)

    edit("config.json", "global", {"config_odometry": "config_odometry_cpu.json"})
    if odometry_overrides:
        edit("config_odometry_cpu.json", "odometry_estimation", odometry_overrides)
    if preprocess_overrides:
        edit("config_preprocess.json", "preprocess", preprocess_overrides)

    seq = _sequence(n_scans, n_scan_points, scene_points, seed)
    glim = GlimTorch(cfg_dir, async_mode=False, device=dev)
    return _timed_run(glim, seq, dev)


def _feed(glim, seq, on_scan=None):
    """All scans with their IMU (up to 0.12 s past each scan stamp);
    ``on_scan(i)`` runs before scan i is inserted."""
    imu_i = 0
    for i, raw in enumerate(seq.scans):
        if on_scan is not None:
            on_scan(i)
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.12:
            glim.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
            imu_i += 1
        glim.insert_frame(raw)


def run_default(device, n_scans: int = 150, n_scan_points: int = 65536,
                scene_points: int = 400000, seed: int = 0, overrides=None,
                on_scan=None) -> dict:
    """Run GlimTorch on the default config directory, unedited but for
    ``overrides`` ((config, module, name, value) tuples: the CPU rehearsal's
    sizes, phase 5b's keyframe edit), over a synthetic sequence at 10 Hz
    scans / 200 Hz IMU; returns the run's metrics. ``on_scan(i)`` runs
    before scan i."""
    from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir

    dev = torch.device(device)
    cfg_dir = create_default_config_dir(tempfile.mkdtemp(prefix="glim_smoke_default_"))
    seq = _sequence(n_scans, n_scan_points, scene_points, seed)
    glim = GlimTorch(cfg_dir, async_mode=False, device=dev, overrides=overrides)
    to_sub = []
    SubMappingCallbacks.on_insert_frame.add(lambda f: to_sub.append(f.id))
    res = _timed_run(glim, seq, dev, on_scan)

    kfm = glim.odometry.keyframes
    subs = glim.submaps
    res.update(
        kf_inserts=kfm.next_order, kf_evictions=kfm.next_order - kfm.count,
        submaps=len(subs), frames_per_submap=[len(s.frames) for s in subs],
        submap_frames_total=sum(len(s.frames) for s in subs),
        frames_to_sub_mapping=len(to_sub),
        submap_points=[int(s.frame.mask.sum()) for s in subs],
        submap_device=subs[0].frame.points.device.type if subs else None)
    return res


def check_default(res: dict, name: str = "default configuration",
                  min_evictions: int = 0) -> None:
    """The default phase's failure conditions (phase 5b also needs
    ``min_evictions`` odometry keyframe evictions)."""
    if not res["poses_finite"]:
        raise AssertionError(f"{name}: non-finite poses")
    if not res["ate"] < DEFAULT_ATE_BOUND:
        raise AssertionError(f"{name}: ATE {res['ate']:.4f} m >= {DEFAULT_ATE_BOUND} m")
    if res["submaps"] < 1:
        raise AssertionError(f"{name}: no submap was created")
    if res["submap_frames_total"] != res["frames_to_sub_mapping"]:
        raise AssertionError(
            f"{name}: the submaps hold {res['submap_frames_total']} "
            f"frames, {res['frames_to_sub_mapping']} reached sub-mapping")
    if res["kf_evictions"] < min_evictions:
        raise AssertionError(f"{name}: {res['kf_evictions']} odometry keyframe "
                             f"evictions, {min_evictions} needed")


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def _nn_case(gen, Q, N, masked=0.3, scale=20.0):
    dev = torch.device("cuda")
    q = (torch.rand(Q, 3, generator=gen, device=dev) - 0.5) * scale
    t = (torch.rand(N, 3, generator=gen, device=dev) - 0.5) * scale
    qm = torch.rand(Q, generator=gen, device=dev) >= 0.05
    tm = torch.rand(N, generator=gen, device=dev) >= masked
    return q, qm, t, tm


def _runner_up_gap(q, qm, t, tm):
    """Gap between the two smallest d2 per query (plain torch, tiled)."""
    t_sq = torch.where(tm, (t * t).sum(-1), float("inf"))
    gaps = []
    for s in range(0, q.shape[0], 512):
        qq = q[s:s + 512]
        d2 = torch.addmm((qq * qq).sum(-1, keepdim=True) + t_sq[None], qq, t.T, alpha=-2.0)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        gaps.append(two[:, 1] - two[:, 0])
    return torch.cat(gaps)


def _compare(name, q, qm, t, tm, nn_search, nn_search_plain):
    idx_k, d2_k = nn_search(q, qm, t, tm)
    torch.cuda.synchronize()
    idx_p, d2_p = nn_search_plain(q, qm, t, tm)
    bound = REL_TOL * torch.clamp(d2_p, min=1.0)
    valid = qm
    err = torch.where(valid, (d2_k - d2_p).abs(), 0.0)
    decisive = valid & (_runner_up_gap(q, qm, t, tm) > bound)
    same = idx_k == idx_p
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name}: d2 disagrees, max err {float(err.max())}")
    if not bool(same[decisive].all()):
        raise AssertionError(f"{name}: {int((~same & decisive).sum())} decisive index mismatches")
    if not bool((idx_k[~qm] == 0).all() and torch.isinf(d2_k[~qm]).all()):
        raise AssertionError(f"{name}: invalid queries must return (0, inf)")
    rate = float(same[valid].float().mean())
    print(f"nn_search {name}: index match {rate:.6f} over {int(valid.sum())} valid "
          f"queries ({int(decisive.sum())} decisive, all equal), max |d2 err| "
          f"{float(err.max()):.3e}")
    return float(err.max())


def _time(fn, n):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _print_default(res: dict, card: str, tag: str = "default") -> None:
    print(f"{tag}: " + json.dumps(res))
    print(f"{tag} [{card}]: {res['scans']} scans in {res['seconds']:.2f} s = "
          f"{res['scans_per_s']:.3f} scans/s, ATE {res['ate']:.4f} m, max memory "
          f"{res['max_memory_allocated'] / 2**20:.1f} MiB, {res['kf_inserts']} odometry "
          f"keyframe inserts / {res['kf_evictions']} evictions, {res['submaps']} submaps, "
          f"frames per submap {res['frames_per_submap']}")


SPANS = ("preprocess", "odometry", "window_scan_step", "odom/kf_insert", "odom/kf_evict",
         "rebuild_level", "sub_mapping", "sub/process_frame", "sub/kf_insert",
         "sub/create_submap", "vgicp_lookup", "linearize_core_soa", "voxelmap_insert")


def _sync_site() -> str:
    """The two innermost frames of this repository's code on the stack."""
    import traceback
    ours = [f"{os.path.relpath(fr.filename)}:{fr.lineno} ({fr.name})"
            for fr in traceback.extract_stack()
            if ("glim_tpu_torch" in fr.filename or "chip_smoke" in fr.filename)
            and fr.name not in ("_sync_site", "on_sync_warning", "counted_read")]
    return " <- ".join(reversed(ours[-2:])) or "?"


def profile_default(card: str, out_dir: str = "build", n_scans: int = 100,
                    steady=(60, 80), prof=(80, 90), sync=(90, 95),
                    name: str = "default", overrides=None, min_evictions: int = 0) -> None:
    """The default configuration: host-clock ms/scan over scans [steady),
    a torch.profiler window over scans [prof) and a set_sync_debug_mode
    ("warn") count over scans [sync), which also counts the pinned-copy
    reads that had to wait for their copy. The tables go to
    out_dir/profile_<name>.txt. ``overrides`` and ``min_evictions`` as for
    run_default and check_default (phase 5b's run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from glim_tpu_torch import types as t_types

    state = dict(sites=Counter(), waits=Counter())
    read = t_types.HostCopy.numpy

    def counted_read(self):
        if state.get("counting") and not self.ready():
            state["waits"][_sync_site()] += 1
        return read(self)

    def on_sync_warning(message, *args, **kwargs):
        if state.get("counting") and "synchroniz" in str(message):
            state["sites"][_sync_site()] += 1

    def mark(i):
        torch.cuda.synchronize()
        state[i] = time.perf_counter()

    def on_scan(i):
        if i in (steady[0], steady[1], prof[0], prof[1]):
            mark(i)
        if i == prof[0]:
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].__enter__()
        if i == prof[1]:
            state["prof"].__exit__(None, None, None)
        if i == sync[0]:
            state["warn"] = warnings.catch_warnings()
            state["warn"].__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = on_sync_warning
            torch.cuda.set_sync_debug_mode("warn")
            state["counting"] = True
        if i == sync[1]:
            state["counting"] = False
            torch.cuda.set_sync_debug_mode(0)
            state["warn"].__exit__(None, None, None)

    t_types.HostCopy.numpy = counted_read
    try:
        res = run_default("cuda", n_scans=n_scans, overrides=overrides, on_scan=on_scan)
    finally:
        t_types.HostCopy.numpy = read
    check_default(res, name, min_evictions)
    _print_default(res, card, name)
    n_prof, n_sync = prof[1] - prof[0], sync[1] - sync[0]
    steady_ms = (state[steady[1]] - state[steady[0]]) * 1e3 / (steady[1] - steady[0])
    prof_ms = (state[prof[1]] - state[prof[0]]) * 1e3 / n_prof

    evs = state["prof"].events()

    def dev_self(e):
        v = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if v is None else v

    kernels = [e for e in evs if e.device_type == DeviceType.CUDA and e.name not in SPANS]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_prof
    by_kernel = {}
    for e in kernels:
        t, c = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    launches = sum(1 for e in evs if e.device_type == DeviceType.CPU
                   and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))

    def subtree_dev_us(e):
        return dev_self(e) + sum(subtree_dev_us(c) for c in e.cpu_children)

    span_rows = {}
    for e in evs:
        if e.device_type == DeviceType.CPU and e.name in SPANS:
            h, d, c = span_rows.get(e.name, (0.0, 0.0, 0))
            span_rows[e.name] = (h + e.time_range.elapsed_us(), d + subtree_dev_us(e), c + 1)

    lines = [f"card: {card}", f"run: {name}, overrides {overrides or []}",
             f"steady scans {steady[0]}-{steady[1] - 1}, no profiler: {steady_ms:.1f} ms/scan",
             f"profile window: scans {prof[0]}-{prof[1] - 1} ({n_prof} scans), wall "
             f"{prof_ms:.1f} ms/scan under the profiler, device kernel time {dev_ms:.2f} ms/scan, "
             f"busy share {dev_ms / prof_ms:.4f} of the profiled wall, "
             f"{dev_ms / steady_ms:.4f} of the unprofiled ms/scan; kernel launches "
             f"{launches / n_prof:.1f}/scan",
             "span: host ms/scan, device kernel ms/scan, calls/scan"]
    for k in SPANS:
        if k in span_rows:
            h, d, c = span_rows[k]
            lines.append(f"  {k}: {h / 1e3 / n_prof:.2f}, {d / 1e3 / n_prof:.2f}, {c / n_prof:.1f}")
    lines.append("top device kernels: ms/scan, calls/scan, name")
    for kname, (t, c) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]:
        lines.append(f"  {t / 1e3 / n_prof:.3f}  {c / n_prof:.1f}  {kname[:110]}")
    n_s, n_w = sum(state["sites"].values()), sum(state["waits"].values())
    lines.append(f"host syncs (set_sync_debug_mode warn) over scans {sync[0]}-{sync[1] - 1}: "
                 f"{n_s / n_sync:.1f}/scan")
    for site, c in state["sites"].most_common():
        lines.append(f"  {c / n_sync:.1f}/scan  {site}")
    lines.append(f"pinned-copy reads that waited for their copy: {n_w / n_sync:.1f}/scan")
    for site, c in state["waits"].most_common():
        lines.append(f"  {c / n_sync:.1f}/scan  {site}")
    lines.append("top host ops (self CPU ms/scan, calls/scan):")
    for e in sorted(state["prof"].key_averages(), key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:20]:
        lines.append(f"  {e.self_cpu_time_total / 1e3 / n_prof:.2f}  {e.count / n_prof:.1f}  "
                     f"{e.key[:90]}")
    text = "\n".join(lines)
    print(text)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(text + "\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--profile"]:
        card = _card()
        print(card)
        profile_default(card, *args[1:2])
        profile_default(card, *args[1:2], name="evict", overrides=EVICT_OVERRIDES,
                        min_evictions=1)
        return 0
    from glim_tpu_torch.ops.nn_search import nn_search, nn_search_plain
    from glim_tpu_torch.utils import cuda_build

    # --- 1. the card ---
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind} x{torch.cuda.device_count()}; python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # --- 2. build + correctness at the main path's shapes ---
    t0 = time.perf_counter()
    nn_search(*_nn_case(torch.Generator(device="cuda").manual_seed(9), 256, 2048))
    torch.cuda.synchronize()
    print(f"nn_search kernel built and launched in {time.perf_counter() - t0:.2f} s")
    for line in cuda_build.build_logs.get("nn_search", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("  ptxas:", line.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for name, Q, N in (("main Q=16384 N=131072", 16384, 131072),
                       ("main Q=4096 N=131072", 4096, 131072),
                       ("ragged Q=1000 N=3001", 1000, 3001)):
        max_err = max(max_err, _compare(name, *_nn_case(gen, Q, N),
                                        nn_search, nn_search_plain))
    q, qm, t, tm = _nn_case(gen, 512, 4096, masked=0.0)
    t[2000:2100] = t[100:200]                 # duplicate targets
    q[:100] = t[100:200]
    qm[:] = True
    _compare("duplicates Q=512 N=4096", q, qm, t, tm, nn_search, nn_search_plain)
    idx_k, _ = nn_search(q, qm, t, tm)
    if not bool((idx_k[:100] == torch.arange(100, 200, device="cuda")).all()):
        raise AssertionError("duplicate targets: the lowest index must win")
    print("nn_search duplicates: lowest index returned for all 100 duplicated targets")

    # --- 3. timing at the main path's shape ---
    q, qm, t, tm = _nn_case(gen, 16384, 131072)
    kern = lambda: nn_search(q, qm, t, tm)
    plain = lambda: nn_search_plain(q, qm, t, tm)
    _time(kern, 3), _time(plain, 1)                       # warm-up
    p1, k1, k2, p2 = _time(plain, 5), _time(kern, 20), _time(kern, 20), _time(plain, 5)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"nn_search Q=16384 N=131072 [{card}]: kernel {k1:.3f} / {k2:.3f} ms, "
          f"plain {p1:.3f} / {p2:.3f} ms")

    # --- 4. the slice on the card ---
    res = run_slice("cuda")
    print("slice: " + json.dumps(res))
    print(f"slice [{card}]: {res['scans']} scans in {res['seconds']:.2f} s = "
          f"{res['scans_per_s']:.2f} scans/s, {res['window_steps']} window steps, "
          f"{res['kernel_launches']} nn_search launches, ATE {res['ate']:.4f} m, "
          f"max memory {res['max_memory_allocated'] / 2**20:.1f} MiB")
    if res["kernel_launches"] < 5 * res["window_steps"] or res["window_steps"] < 100:
        raise AssertionError("the slice did not run nn_search on every window lookup")
    if not res["poses_finite"]:
        raise AssertionError("non-finite poses")
    if not res["ate"] < ATE_BOUND:
        raise AssertionError(f"ATE {res['ate']:.4f} m >= {ATE_BOUND} m")

    # --- 5. the default configuration on the card ---
    dres = run_default("cuda")
    _print_default(dres, card)
    print(f"default [{card}]: nn_search launches {dres['kernel_launches']} "
          "(the VGICP path runs no hand-written kernel)")
    check_default(dres)

    # --- 5b. odometry keyframe eviction at full size ---
    eres = run_default("cuda", n_scans=EVICT_SCANS, overrides=EVICT_OVERRIDES)
    _print_default(eres, card, "evict")
    check_default(eres, "eviction run", min_evictions=1)

    # --- 6. summary ---
    print(json.dumps({"kernels": [{
        "name": "nn_search", "route": "cuda",
        "source": "glim_tpu_torch/csrc/nn_search.cu",
        "replaces": "glim_tpu/ops/pallas_knn.py:29",
        "launches": res["kernel_launches"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
