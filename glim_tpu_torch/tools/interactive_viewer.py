"""Interactive map-correction REPL (the InteractiveViewer executable),
twin of ``glim_tpu/tools/interactive_viewer.py``.

Opens a dump on ``--device`` (the card by default) and drives the
correction workflow of the reference's InteractiveViewer
(src/glim/viewer/interactive_viewer.cpp: manual loop close, re-optimize,
save) from a command line:

    python -m glim_tpu_torch.tools.interactive_viewer DUMP_DIR [--device cuda|cpu]

Commands (also accepted as one-shot ``--exec`` arguments):
    list                         submap ids, positions, point counts
    factors                      factor counts
    loop_close A B [GNC|RANSAC]  align submaps A<-B, inject between factor,
                                 re-optimize (reference
                                 manual_loop_close_modal.cpp:38-64)
    find_loops [MIN_OVERLAP]     automatic overlap search + optimize
    optimize                     re-run global optimization
    save DIR                     save the corrected dump
    ply FILE                     export the merged cloud
    quit

``main`` returns the viewer and the (command, result) pairs it ran.

For corrections on a LIVE run use ``glim_runner --commands FILE.jsonl`` and
append the same commands as JSON lines (watch.py POSTs to it).
"""

from __future__ import annotations

import argparse
import json


def _parse_line(line: str):
    """Turn a REPL line into the JSON command dict execute_command takes."""
    parts = line.split()
    if not parts:
        return None
    name = parts[0]
    if name == "loop_close":
        if len(parts) < 3:
            raise ValueError("usage: loop_close A B [GNC|RANSAC]")
        cmd = dict(cmd="loop_close", target=int(parts[1]),
                   source=int(parts[2]))
        if len(parts) > 3:
            cmd["method"] = parts[3]
        return cmd
    if name == "find_loops":
        cmd = dict(cmd="find_loops")
        if len(parts) > 1:
            cmd["min_overlap"] = float(parts[1])
        return cmd
    if name in ("save", "ply"):
        if len(parts) < 2:
            raise ValueError(f"usage: {name} PATH")
        return dict(cmd=name, path=parts[1])
    if name in ("list", "factors", "optimize"):
        return dict(cmd=name)
    if name in ("quit", "exit", "q"):
        return dict(cmd="quit")
    raise ValueError(f"unknown command {name!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dump", help="dump directory to open")
    ap.add_argument("--exec", dest="exec_cmds", action="append", default=[],
                    metavar="CMD", help="run this command and exit "
                                        "(repeatable; skips the REPL)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)

    from glim_tpu_torch.viewer.interactive_viewer import InteractiveViewer, execute_command
    viewer = InteractiveViewer.open(args.dump, device=args.device)
    print(f"opened {args.dump}: {viewer.factor_summary()}")
    results = []

    def run_one(line: str) -> bool:
        try:
            cmd = _parse_line(line)
        except ValueError as e:
            print(e)
            return True
        if cmd is None:
            return True
        if cmd["cmd"] == "quit":
            return False
        out = execute_command(viewer, cmd)
        results.append((cmd, out))
        print(json.dumps(out, indent=None, default=str))
        return True

    if args.exec_cmds:
        for line in args.exec_cmds:
            run_one(line)
        return dict(viewer=viewer, results=results)

    while True:
        try:
            line = input("glim> ")
        except (EOFError, KeyboardInterrupt):
            break
        if not run_one(line):
            break
    return dict(viewer=viewer, results=results)


if __name__ == "__main__":
    main()
