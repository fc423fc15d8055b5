"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                   # the smoke run below
    python3 chip_smoke.py --nn-v1 SRC       # ... with phase 3's A/B against SRC
    python3 chip_smoke.py --profile [DIR]   # profiles of three configurations

Phases (any failure exits non-zero):
  1. print the card (name and power limit as nvidia-smi reports them) and
     the software versions;
  2. build the nn_search CUDA kernel from glim_tpu_torch/csrc and hold it
     against its plain PyTorch version at the main path's shapes (16384 and
     4096 queries against 131072 targets, ~30% masked), a ragged case, the
     duplicate-target cases (the lowest index must win: across the split
     boundary that the launch geometry picks at Q=16384, and inside one
     thread's register-tiled query rows) and a Q=4096 set with one valid
     target;
  3. time kernel and plain version at both main-path shapes with CUDA
     events, in turns (plain, kernel, kernel, plain), each beside its bound
     (valid pairs x 8 flops over the FP32 peak; bytes over the memory rate)
     and its share of it, then the host time to enqueue a call (and, at
     Q=16384, the SM clock nvidia-smi reads during 4000 calls). ``--nn-v1
     SRC`` also builds the one-thread-per-query kernel of the first port
     from SRC (its C interface) and times it in the same turns (plain, v1,
     kernel, kernel, v1, plain);
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
It then does the same for phase 5b's eviction run (DIR/profile_evict.txt)
and for phase 4's GICP slice (DIR/profile_gicp.txt).

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
              odometry_overrides=None, preprocess_overrides=None, on_scan=None) -> dict:
    """Run GlimTorch (sync, config_odometry_cpu.json) over a synthetic
    sequence at 10 Hz scans / 200 Hz IMU; returns the run's metrics.
    ``on_scan(i)`` runs before scan i."""
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
    return _timed_run(glim, seq, dev, on_scan)


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
        w = int(torch.argmax(err - bound))
        raise AssertionError(
            f"{name}: d2 disagrees, max err {float(err.max())}; worst query {w}: d2 "
            f"{float(d2_k[w])} (kernel) / {float(d2_p[w])} (plain), idx {int(idx_k[w])} / "
            f"{int(idx_p[w])}, |q|^2 {float((q[w] * q[w]).sum())}")
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


def _host_us(fn, n):
    """Host time to enqueue one call (us), the card's queue left to drain."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _sm_clock_under(fn, n):
    """The SM clocks (MHz) that nvidia-smi samples while ``fn`` runs n times."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.3)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
    return [int(v) for v in smi.communicate()[0].split()]


def check_nn_search() -> float:
    """Phase 2: build the kernel, then hold it against the plain version at
    the main path's shapes, a ragged case, the duplicate cases (ties must go
    to the lowest index: inside one chunk, across chunks, across the split
    boundary that the launch geometry picks, and inside one thread's query
    rows) and a query set with one valid target. Returns the max |d2 error|."""
    from glim_tpu_torch.ops import nn_search as nn
    from glim_tpu_torch.utils import cuda_build

    search, plain = nn.nn_search, nn.nn_search_plain
    t0 = time.perf_counter()
    search(*_nn_case(torch.Generator(device="cuda").manual_seed(9), 256, 2048))
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
        max_err = max(max_err, _compare(name, *_nn_case(gen, Q, N), search, plain))

    def lowest_wins(name, case, rows, want):
        max_err = _compare(name, *case, search, plain)
        idx_k, _ = search(*case)
        if not bool((idx_k[rows] == want).all()):
            raise AssertionError(f"{name}: the lowest index must win")
        print(f"nn_search {name}: lowest index returned for all {len(rows)} duplicated targets")
        return max_err

    dev = torch.device("cuda")
    q, qm, t, tm = _nn_case(gen, 512, 4096, masked=0.0)
    t[2000:2100] = t[100:200]
    q[:100] = t[100:200]
    qm[:] = True
    max_err = max(max_err, lowest_wins("duplicates Q=512 N=4096", (q, qm, t, tm),
                                       torch.arange(100, device=dev),
                                       torch.arange(100, 200, device=dev)))
    # The duplicated targets below lie within 2.5 m of the origin: a query
    # on a target has d2 = 0, where the plain version's cancellation error
    # (a few ulp of 2|t|^2) must stay under REL_TOL.
    # Both copies of 64 targets on either side of the middle split boundary.
    _, splits, split_len = nn.launch_geometry(16384, 131072, nn._sm_count(0))
    b = split_len * (splits // 2)
    q, qm, t, tm = _nn_case(gen, 16384, 131072)
    t[b - 64:b] *= 0.25
    t[b:b + 64] = t[b - 64:b]
    tm[b - 64:b + 64] = True
    q[:64] = t[b - 64:b]
    qm[:64] = True
    max_err = max(max_err, lowest_wins(
        f"duplicates across split boundary {b} (S={splits})", (q, qm, t, tm),
        torch.arange(64, device=dev), torch.arange(b - 64, b, device=dev)))
    # One thread's query rows (block 3, thread 5): row r's target a_r has
    # copies at a_r + 1 and a_r + 3 (its chunk) and a_r + 11 (the next);
    # the last row asks for row 0's target.
    rows = (3 * nn.QUERIES_PER_BLOCK + 5
            + nn.QUERY_THREADS * torch.arange(nn.QUERY_ROWS, device=dev))
    a = 70000 + 16 * torch.arange(nn.QUERY_ROWS, device=dev)
    q, qm, t, tm = _nn_case(gen, 16384, 131072)
    t[a] *= 0.25
    for off in (1, 3, 11):
        t[a + off] = t[a]
        tm[a + off] = True
    tm[a] = True
    want = a.clone()
    want[-1] = a[0]
    q[rows] = t[want]
    qm[rows] = True
    max_err = max(max_err, lowest_wins("duplicates in one thread's query rows",
                                       (q, qm, t, tm), rows, want))
    # Every target masked but one.
    q, qm, t, tm = _nn_case(gen, 4096, 131072)
    tm[:] = False
    tm[77777] = True
    max_err = max(max_err, lowest_wins("one valid target Q=4096 N=131072", (q, qm, t, tm),
                                       torch.nonzero(qm).flatten(), 77777))
    return max_err


def _nn_search_v1(src):
    """The one-thread-per-query kernel of the first port (its C interface
    and its wrapper's packing), built from ``src`` for an A/B in one call."""
    import ctypes

    from glim_tpu_torch.utils import cuda_build

    lib = cuda_build.load_kernel_library("nn_search_v1", src)
    lib.glim_nn_search.restype = ctypes.c_int
    lib.glim_nn_search.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                   + [ctypes.c_void_p] * 3)

    def run(q, qm, t, tm):
        t_sq = torch.where(tm, torch.sum(t * t, dim=-1), float("inf"))
        xyzw = torch.cat([t, t_sq[:, None]], dim=1).contiguous()
        idx = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
        d2 = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
        rc = lib.glim_nn_search(q.data_ptr(), qm.data_ptr(), xyzw.data_ptr(), q.shape[0],
                                t.shape[0], idx.data_ptr(), d2.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"nn_search v1 launch failed ({rc})")
        return idx, d2
    return run


# The H100's published peaks (SXM, 700 W): FP32 outside the tensor cores and
# HBM3. nn_search costs 8 flops a (valid query, valid target) pair.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
NN_FLOPS_PER_PAIR = 8


def nn_bound_ms(q, qm, t, tm):
    """Least time for the search on these inputs: each input read and each
    output written once, over the memory rate, against the valid pairs'
    flops over the FP32 rate."""
    Q, N = q.shape[0], t.shape[0]
    by_bytes = (Q * (12 + 1) + N * (12 + 1) + Q * 8) / PEAK_BYTES
    by_ops = NN_FLOPS_PER_PAIR * int(qm.sum()) * int(tm.sum()) / PEAK_FP32
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes > by_ops else "operations"


def time_nn_search(card: str, v1_src=None) -> dict:
    """Phase 3: CUDA-event times at both main-path shapes, in turns (plain,
    [v1,] kernel, kernel, [v1,] plain), each with its bound and share, then
    the host time to enqueue a call; ``v1_src`` adds the first port's
    kernel built from that source."""
    from glim_tpu_torch.ops.nn_search import nn_search, nn_search_plain

    v1 = _nn_search_v1(v1_src) if v1_src else None
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for Q in (16384, 4096):
        case = _nn_case(gen, Q, 131072)
        kern, plain = (lambda: nn_search(*case)), (lambda: nn_search_plain(*case))
        _time(kern, 3), _time(plain, 1)                       # warm-up
        p1 = _time(plain, 5)
        if v1:
            v1_fn = lambda: v1(*case)
            _time(v1_fn, 3)
            a1 = _time(v1_fn, 20)
        k1, k2 = _time(kern, 50), _time(kern, 50)
        if v1:
            a2 = _time(v1_fn, 20)
        p2 = _time(plain, 5)
        h1 = _host_us(kern, 50)
        if v1:
            hv = _host_us(v1_fn, 50)
        h2 = _host_us(kern, 50)
        bound, by = nn_bound_ms(*case)
        ms = (k1 + k2) / 2
        sfx = "" if Q == 16384 else f"_q{Q}"
        out.update({f"ms{sfx}": ms, f"plain_ms{sfx}": (p1 + p2) / 2, f"bound_ms{sfx}": bound,
                    f"bound_share{sfx}": bound / ms, f"host_us{sfx}": (h1 + h2) / 2})
        line = (f"nn_search Q={Q} N=131072 [{card}]: kernel {k1:.4f} / {k2:.4f} ms, plain "
                f"{p1:.3f} / {p2:.3f} ms, bound {bound:.4f} ms ({by}), share "
                f"{bound / ms:.3f}, host enqueue {h1:.1f} / {h2:.1f} us a call")
        if v1:
            out.update({f"v1_ms{sfx}": (a1 + a2) / 2, f"v1_host_us{sfx}": hv})
            line += (f"; v1 {a1:.4f} / {a2:.4f} ms, share {bound / ((a1 + a2) / 2):.3f}, "
                     f"host enqueue {hv:.1f} us a call")
        print(line)
        if Q == 16384:
            clocks = _sm_clock_under(kern, 4000)
            seen = f"{min(clocks)}-{max(clocks)} MHz" if clocks else "not read"
            print(f"nn_search Q=16384: SM clock {seen} over {len(clocks)} samples "
                  "during 4000 calls")
    # No single PyTorch call computes a masked k=1 search with this tie rule
    # (torch.cdist then min is two calls and a 16384 x 131072 matrix).
    out.update(bound_by=by, library_ms=None)
    return out


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
    """The default configuration (or, with name "gicp", phase 4's GICP
    slice): host-clock ms/scan over scans [steady), a torch.profiler window
    over scans [prof) and a set_sync_debug_mode ("warn") count over scans
    [sync), which also counts the pinned-copy reads that had to wait for
    their copy. The tables go to out_dir/profile_<name>.txt. ``overrides``
    and ``min_evictions`` as for run_default and check_default (phase 5b's
    run)."""
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
        if name == "gicp":
            res = run_slice("cuda", n_scans=n_scans, on_scan=on_scan)
        else:
            res = run_default("cuda", n_scans=n_scans, overrides=overrides, on_scan=on_scan)
    finally:
        t_types.HostCopy.numpy = read
    if name == "gicp":
        if not (res["poses_finite"] and res["ate"] < ATE_BOUND):
            raise AssertionError(f"gicp: ATE {res['ate']:.4f} m or non-finite poses")
        print("gicp: " + json.dumps(res))
    else:
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
        profile_default(card, *args[1:2], name="gicp")
        return 0
    # --- 1. the card ---
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"device: {kind} x{torch.cuda.device_count()}; python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # --- 2. build + correctness at the main path's shapes ---
    max_err = check_nn_search()

    # --- 3. timing at the main path's shapes ---
    v1_src = args[args.index("--nn-v1") + 1] if "--nn-v1" in args else None
    timing = time_nn_search(card, v1_src)

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
        "launches": res["kernel_launches"], "max_abs_err": max_err, **timing}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
