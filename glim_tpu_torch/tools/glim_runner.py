"""Offline dataset runner — the ``glim_rosbag`` equivalent of the port.

Twin of ``glim_tpu/tools/glim_runner.py``: plays a recorded dataset through
the asynchronous ``GlimTorch`` pipeline faster than real time, throttled by
the pipeline's ``workload()`` (reference: docs/quickstart.md:70-79),
drains it with ``wait()`` and saves the dump.

Dataset layout:
  dataset/
    imu.csv                   # rows: t, ax, ay, az, wx, wy, wz
    scans/NNNNNN.npy          # (N, 3|4) float points, or .ply / KITTI .bin
    stamps.csv                # per-scan stamps (row i -> scans/%06i)
    [times/NNNNNN.npy]        # optional per-point times

Usage: python -m glim_tpu_torch.tools.glim_runner <dataset_dir> [--config DIR]
       [--dump DIR] [--synthetic N_SECONDS] [--max-workload N] [--device cuda|cpu]

The pipeline runs on the card unless ``--device cpu`` is given. ROS bag
playback (``io/rosbag``, ``ros/conditioning``), ``--viewer-stream``
(``viewer/``) and ``--commands`` (``viewer/interactive_viewer``) are not
ported: each raises, naming the module it needs.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

BAG_SUFFIXES = (".bag", ".mcap", ".db3")


def load_dataset(path: str):
    """(imu (M, 7), [(stamp, points, times or None)]) of a dataset dir."""
    from glim_tpu_torch.io.loaders import load_scan_file

    imu = np.loadtxt(os.path.join(path, "imu.csv"), delimiter=",", ndmin=2) \
        if os.path.exists(os.path.join(path, "imu.csv")) else np.zeros((0, 7))
    stamps = np.loadtxt(os.path.join(path, "stamps.csv"), delimiter=",")
    scan_dir = os.path.join(path, "scans")
    scans = []
    for i, stamp in enumerate(np.atleast_1d(stamps)):
        for ext in (".npy", ".ply", ".bin"):
            fp = os.path.join(scan_dir, f"{i:06d}{ext}")
            if os.path.exists(fp):
                pts = load_scan_file(fp)
                break
        else:
            break
        tfile = os.path.join(path, "times", f"{i:06d}.npy")
        times = np.load(tfile) if os.path.exists(tfile) else None
        scans.append((float(stamp), pts, times))
    return imu, scans


def save_dataset(path: str, imu: np.ndarray, scans) -> None:
    """Write ``imu`` and ``scans`` ([(stamp, points, times or None)]) in the
    layout ``load_dataset`` reads; values round-trip exactly."""
    os.makedirs(os.path.join(path, "scans"), exist_ok=True)
    np.savetxt(os.path.join(path, "imu.csv"), np.asarray(imu, np.float64), delimiter=",")
    np.savetxt(os.path.join(path, "stamps.csv"), np.array([s[0] for s in scans], np.float64),
               delimiter=",")
    for i, (_, pts, times) in enumerate(scans):
        np.save(os.path.join(path, "scans", f"{i:06d}.npy"), pts)
        if times is not None:
            os.makedirs(os.path.join(path, "times"), exist_ok=True)
            np.save(os.path.join(path, "times", f"{i:06d}.npy"), times)


def _is_bag(path: str) -> bool:
    """A ROS bag rather than a converted dataset directory."""
    if os.path.isfile(path):
        return path.endswith(BAG_SUFFIXES)
    if os.path.isdir(path) and not os.path.exists(os.path.join(path, "stamps.csv")):
        return any(e.endswith(BAG_SUFFIXES) for e in os.listdir(path))
    return False


def play(glim, imu: np.ndarray, scans, max_workload: int) -> int:
    """Feed every scan with the IMU up to 0.2 s past its stamp, waiting
    while the pipeline's workload exceeds ``max_workload``; returns the
    number of scans fed."""
    from glim_tpu_torch.types import RawPoints

    imu_idx = 0
    for stamp, pts, times in scans:
        while imu_idx < len(imu) and imu[imu_idx, 0] <= stamp + 0.2:
            glim.insert_imu(imu[imu_idx, 0], imu[imu_idx, 1:4], imu[imu_idx, 4:7])
            imu_idx += 1
        glim.insert_frame(RawPoints(stamp=stamp, points=pts, times=times))
        while glim.workload() > max_workload:
            time.sleep(0.01)
    return len(scans)


def main(argv=None) -> dict:
    """Run the pipeline over a dataset and save its dump. Returns the run:
    the pipeline (``glim``), ``scans``, ``seconds`` (feed + drain),
    ``wait_seconds`` (the drain), ``save_seconds`` and ``dump``."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset", nargs="?", help="dataset directory")
    ap.add_argument("--config", default=None, help="config directory")
    ap.add_argument("--dump", default=os.path.join(tempfile.gettempdir(),
                                                   "glim_tpu_torch_dump"))
    ap.add_argument("--synthetic", type=float, default=0.0,
                    help="run N seconds of the synthetic sequence instead")
    ap.add_argument("--max-workload", type=int, default=10,
                    help="throttle input when pipeline workload exceeds this")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--points-topic", default=None, help="bag playback (not ported)")
    ap.add_argument("--imu-topic", default=None, help="bag playback (not ported)")
    ap.add_argument("--viewer-stream", default=None, metavar="FILE.jsonl",
                    help="run stream for the viewer (not ported)")
    ap.add_argument("--commands", default=None, metavar="FILE.jsonl",
                    help="live correction commands (not ported)")
    args = ap.parse_args(argv)

    if args.viewer_stream:
        raise NotImplementedError("--viewer-stream needs glim_tpu/viewer/, which is not "
                                  "ported to glim_tpu_torch yet")
    if args.commands:
        raise NotImplementedError("--commands needs glim_tpu/viewer/interactive_viewer.py, "
                                  "which is not ported to glim_tpu_torch yet")
    if args.synthetic <= 0 and not args.dataset:
        ap.error("dataset directory or --synthetic required")
    if args.synthetic <= 0 and (_is_bag(args.dataset) or args.points_topic
                                or args.imu_topic):
        raise NotImplementedError("bag playback needs glim_tpu/io/rosbag.py and "
                                  "glim_tpu/ros/conditioning.py, which are not ported to "
                                  "glim_tpu_torch yet")

    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.debug import print_system_info

    print_system_info()
    if args.synthetic > 0:
        from glim_tpu_torch.io.synthetic import generate_sequence
        seq = generate_sequence(duration=args.synthetic, n_scan_points=20000,
                                scene_points=120000)
        imu = seq.imu
        scans = [(s.stamp, s.points, s.times) for s in seq.scans]
    else:
        imu, scans = load_dataset(args.dataset)

    glim = GlimTorch(config_path=args.config, async_mode=True, device=args.device)
    t0 = time.perf_counter()
    n = play(glim, imu, scans, args.max_workload)
    t_wait = time.perf_counter()
    glim.wait()
    t_end = time.perf_counter()
    elapsed = t_end - t0
    print(f"processed {n} scans in {elapsed:.1f}s ({n / max(elapsed, 1e-9):.2f} scans/s), "
          f"drain {t_end - t_wait:.2f}s")
    glim.save(args.dump)
    save_s = time.perf_counter() - t_end
    print(f"dump saved to {args.dump}")
    return dict(glim=glim, scans=n, seconds=elapsed, wait_seconds=t_end - t_wait,
                save_seconds=save_s, dump=args.dump)


if __name__ == "__main__":
    main()
