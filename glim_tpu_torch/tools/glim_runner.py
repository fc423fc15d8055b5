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
       [--viewer-stream FILE.jsonl] [--commands FILE.jsonl]

The pipeline runs on the card unless ``--device cpu`` is given.
``--viewer-stream`` writes the run stream (``viewer/standard_viewer.py``;
replay it with ``viewer/watch.html`` or ``tools/watch.py``).
``--commands`` tails a JSONL file of live corrections applied to the
running graph (``viewer/interactive_viewer.execute_command``; ``pause`` /
``resume`` / ``step`` act on the feed loop). The pipeline's ``ok()`` going
false (an extension module's request) ends the feed. ROS bag playback
(``io/rosbag``, ``ros/conditioning``) is not ported: it raises, naming the
modules it needs.
"""

from __future__ import annotations

import argparse
import json
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


def _make_command_poller(glim, commands_path, controls=None):
    """Tail a JSONL command file and apply its new lines to the live run
    (the interactive-correction loop: watch.py's POST /command appends
    there). Returns ``poll()``; ``poll.results`` lists (command, result).

    The alignment runs on the calling (feed) thread on submaps read under
    the async global-mapping wrapper's mutex; the factor goes in through
    request_to_add_between, applied on the global-mapping worker. pause /
    resume / step are recorded in ``controls`` for the feed loop; every
    other command goes to ``execute_command``."""
    results = []
    if not commands_path:
        poll = lambda: None  # noqa: E731
        poll.results = results
        return poll
    from glim_tpu_torch.viewer.interactive_viewer import InteractiveViewer, execute_command

    viewer = InteractiveViewer(glim.global_backend, live=True,
                               lock=getattr(glim.global_mapping, "_mutex", None))
    state = {"pos": 0}
    open(commands_path, "a").close()          # exists for the tail

    def poll():
        try:
            with open(commands_path) as f:
                f.seek(state["pos"])
                lines = f.readlines()
                state["pos"] = f.tell()
        except OSError:
            return
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                cmd = json.loads(line)
            except ValueError:
                print(f"[commands] bad JSON line ignored: {line[:80]}")
                continue
            name = cmd.get("cmd")
            if controls is not None and name in ("pause", "resume", "step"):
                if name == "pause":
                    controls["paused"] = True
                elif name == "resume":
                    controls["paused"] = False
                    controls["step"] = 0
                else:
                    controls["paused"] = True
                    controls["step"] += max(int(cmd.get("n", 1)), 1)
                out = dict(controls)
            else:
                out = execute_command(viewer, cmd)
            results.append((cmd, out))
            print(f"[commands] {name}: {out}")

    poll.results = results
    return poll


def _playback_gate(controls, poll_commands) -> None:
    """Block the feed loop while paused (still polling, so resume / step /
    corrections are serviced); consume one step credit when stepping."""
    while controls["paused"] and controls["step"] == 0:
        time.sleep(0.05)
        poll_commands()
    if controls["step"] > 0:
        controls["step"] -= 1


def play(glim, imu: np.ndarray, scans, max_workload: int, poll_commands=None,
         controls=None, on_scan=None) -> int:
    """Feed every scan with the IMU up to 0.2 s past its stamp, waiting
    while the pipeline's workload exceeds ``max_workload``; after each scan
    poll the commands and pass the playback gate. Stops early when the
    pipeline's ``ok()`` goes false. ``on_scan(i)`` runs before scan i.
    Returns the number of scans fed."""
    from glim_tpu_torch.types import RawPoints

    poll_commands = poll_commands or (lambda: None)
    imu_idx = 0
    n = 0
    for stamp, pts, times in scans:
        if on_scan is not None:
            on_scan(n)
        while imu_idx < len(imu) and imu[imu_idx, 0] <= stamp + 0.2:
            glim.insert_imu(imu[imu_idx, 0], imu[imu_idx, 1:4], imu[imu_idx, 4:7])
            imu_idx += 1
        glim.insert_frame(RawPoints(stamp=stamp, points=pts, times=times))
        n += 1
        poll_commands()
        if controls is not None:
            _playback_gate(controls, poll_commands)
        while glim.workload() > max_workload:
            time.sleep(0.01)
        if not glim.ok():
            print("extension module requested shutdown")
            break
    return n


def main(argv=None, on_scan=None) -> dict:
    """Run the pipeline over a dataset and save its dump. Returns the run:
    the pipeline (``glim``), ``scans``, ``seconds`` (feed + drain),
    ``wait_seconds`` (the drain), ``save_seconds``, ``dump``, the
    ``viewer`` (with ``--viewer-stream``) and ``command_results`` (the
    (command, result) pairs of ``--commands``). ``on_scan(i)`` runs before
    scan i is fed."""
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
                    help="write a watchable run stream (replay with "
                         "glim_tpu_torch/viewer/watch.html or tools/watch.py)")
    ap.add_argument("--commands", default=None, metavar="FILE.jsonl",
                    help="poll this JSONL file for interactive correction commands "
                         "applied to the live run (viewer/interactive_viewer.py; "
                         "tools/watch.py POSTs here)")
    args = ap.parse_args(argv)

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
    viewer = None
    if args.viewer_stream:
        from glim_tpu_torch.viewer.standard_viewer import StandardViewer
        viewer = StandardViewer(stream_path=args.viewer_stream, stream_interval=0.5)
        print(f"viewer stream -> {args.viewer_stream} (open glim_tpu_torch/viewer/watch.html, "
              f"or python -m glim_tpu_torch.tools.watch --stream {args.viewer_stream})")
    controls = {"paused": False, "step": 0}
    poll_commands = _make_command_poller(glim, args.commands, controls)
    t0 = time.perf_counter()
    n = play(glim, imu, scans, args.max_workload, poll_commands, controls, on_scan)
    t_wait = time.perf_counter()
    glim.wait()
    t_end = time.perf_counter()
    elapsed = t_end - t0
    print(f"processed {n} scans in {elapsed:.1f}s ({n / max(elapsed, 1e-9):.2f} scans/s), "
          f"drain {t_end - t_wait:.2f}s")
    glim.save(args.dump)
    save_s = time.perf_counter() - t_end
    if viewer is not None:
        viewer.at_exit(args.dump)
        viewer.detach()
    print(f"dump saved to {args.dump}")
    return dict(glim=glim, scans=n, seconds=elapsed, wait_seconds=t_end - t_wait,
                save_seconds=save_s, dump=args.dump, viewer=viewer,
                command_results=poll_commands.results)


if __name__ == "__main__":
    main()
