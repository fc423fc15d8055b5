"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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
     config_odometry_cpu.json at its defaults, 150 synthetic scans of 65,536
     points with 200 Hz IMU; check the kernel launches, finite poses and the
     ATE bound;
  5. print the kernel summary JSON and, last, the device JSON.

``run_slice`` is importable and runs on any device (the CPU tests rehearse
it at a tiny size); ``main`` requires a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ATE_BOUND = 0.12          # m; the JAX package's bound for this module
REL_TOL = 1e-4            # nn_search d2 tolerance: REL_TOL * max(1, d2)


def run_slice(device, n_scans: int = 150, n_scan_points: int = 65536,
              scene_points: int = 400000, seed: int = 0,
              odometry_overrides=None, preprocess_overrides=None) -> dict:
    """Run GlimTorch (sync, config_odometry_cpu.json) over a synthetic
    sequence at 10 Hz scans / 200 Hz IMU; returns the run's metrics."""
    from glim_tpu_torch.io.synthetic import ate_rmse, generate_sequence
    from glim_tpu_torch.ops.nn_search import nn_search
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

    seq = generate_sequence(duration=n_scans / 10.0, scan_hz=10.0, imu_hz=200.0,
                            n_scan_points=n_scan_points, scene_points=scene_points,
                            noise=0.01, seed=seed)
    glim = GlimTorch(cfg_dir, async_mode=False, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    nn_search.kernel_launches = 0
    t0 = time.perf_counter()
    imu_i = 0
    for raw in seq.scans:
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.12:
            glim.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
            imu_i += 1
        glim.insert_frame(raw)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
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
    nn_search.kernel_launches = 0
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

    # --- 5. summary ---
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
