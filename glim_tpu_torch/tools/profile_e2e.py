"""Profile the asynchronous end-to-end pipeline stage by stage.

Twin of ``glim_tpu/tools/profile_e2e.py``: the same sequence (20,000
points a scan, 120,000 scene points, seed 17), a warm pass and a timed pass
through ``GlimTorch(async_mode=True)`` with the same back-pressure, then
the ``glim_tpu_torch.utils.profiling`` scope table of the sustained phase
and, apart, of the drain, so that stage stalls show up with names.

Usage: python -m glim_tpu_torch.tools.profile_e2e [duration_s] [scan_hz] [--device DEV]
"""

from __future__ import annotations

import argparse
import time


def run(duration: float = 10.0, scan_hz: float = 10.0, device="cuda") -> dict:
    """Both passes on ``device``; returns the timed pass's sustained and
    drain seconds, its scans, scans/s with and without the drain, and the
    scope tables of the sustained phase (``scopes``) and of the drain
    (``drain_scopes``), as ``profiling.report`` gives them."""
    import torch

    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils import profiling

    device = torch.device(device)
    seq = generate_sequence(duration=duration, scan_hz=scan_hz,
                            n_scan_points=20000, noise=0.01, seed=17,
                            scene_points=120000)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run_pass(n_warm: int):
        glim = GlimTorch(async_mode=True, device=device)
        imu_idx = 0

        def feed(raw):
            nonlocal imu_idx
            while (imu_idx < len(seq.imu)
                   and seq.imu[imu_idx, 0] <= raw.stamp + 0.12):
                r = seq.imu[imu_idx]
                glim.insert_imu(r[0], r[1:4], r[4:7])
                imu_idx += 1
            while glim.workload() > 4:
                time.sleep(0.005)
                glim._pump()
            glim.insert_frame(raw)

        for k, raw in enumerate(seq.scans[:n_warm]):
            feed(raw)
            if k % 10 == 0:
                print(f"  warm scan {k}", flush=True)
        while glim.workload() > 0:
            time.sleep(0.02)
            glim._pump()
        sync()

        t0 = time.perf_counter()
        for k, raw in enumerate(seq.scans[n_warm:]):
            feed(raw)
            if k % 20 == 0:
                print(f"  scan {k}", flush=True)
        while glim.workload() > 0:
            time.sleep(0.005)
            glim._pump()
        sync()
        t1 = time.perf_counter()
        sustained = profiling.report(reset=True)     # split: sustained vs drain scopes
        glim.wait()
        sync()
        t2 = time.perf_counter()
        drain = profiling.report(reset=False)
        print("drain-phase scopes:", flush=True)
        for name, row in drain.items():
            print(f"  [drain] {name:28s} n={row['n']:<4d} "
                  f"total={row['total_s']:7.2f}s mean={row['mean_ms']:7.2f}ms",
                  flush=True)
        return t1 - t0, t2 - t1, len(seq.scans) - n_warm, sustained, drain

    print("warm pass ...", flush=True)
    run_pass(n_warm=16)
    profiling.report(reset=True)
    print("timed pass ...", flush=True)
    sustained_s, drain_s, n, sustained, drain = run_pass(n_warm=16)
    profiling.report(reset=True)
    return dict(device=str(device), scans=n, sustained_s=sustained_s, drain_s=drain_s,
                scans_per_s=n / sustained_s, with_drain_scans_per_s=n / (sustained_s + drain_s),
                scopes=sustained, drain_scopes=drain)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("duration", nargs="?", type=float, default=10.0)
    ap.add_argument("scan_hz", nargs="?", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.duration, args.scan_hz, args.device)
    n, sustained_s, drain_s = res["scans"], res["sustained_s"], res["drain_s"]
    print(f"\nsustained: {n / sustained_s:.2f} scans/s "
          f"({sustained_s:.2f}s for {n} scans), drain {drain_s:.2f}s, "
          f"with-drain {n / (sustained_s + drain_s):.2f} scans/s\n",
          flush=True)
    for name, row in res["scopes"].items():
        print(f"{name:32s} n={row['n']:<5d} total={row['total_s']:8.2f}s "
              f"mean={row['mean_ms']:8.2f}ms max={row['max_ms']:8.2f}ms")


if __name__ == "__main__":
    main()
