"""Offline dump tools CLI (the offline_viewer / map_editor executables),
twin of ``glim_tpu/tools/offline_viewer.py``.

Usage:
  python -m glim_tpu_torch.tools.offline_viewer open DUMP [--optimize] [--ply OUT.ply] [--save OUT_DIR]
  python -m glim_tpu_torch.tools.offline_viewer merge DUMP_A DUMP_B --save OUT_DIR
  python -m glim_tpu_torch.tools.offline_viewer edit DUMP --remove-outliers --save OUT_DIR

Every subcommand takes ``--device`` (default ``cuda``; ``cpu`` runs on the
host). ``main`` returns the viewer (open / merge) or the editor (edit).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_open = sub.add_parser("open")
    p_open.add_argument("dump")
    p_open.add_argument("--optimize", action="store_true")
    p_open.add_argument("--find-loops", type=float, default=None,
                        metavar="MIN_OVERLAP")
    p_open.add_argument("--ply", default=None)
    p_open.add_argument("--save", default=None)
    p_open.add_argument("--config", default=None,
                        help="config_viewer.json for render hints "
                             "(defaults to the dump's config snapshot)")

    p_merge = sub.add_parser("merge")
    p_merge.add_argument("dumps", nargs="+")
    p_merge.add_argument("--save", required=True)
    p_merge.add_argument("--ply", default=None)

    p_edit = sub.add_parser("edit")
    p_edit.add_argument("dump")
    p_edit.add_argument("--remove-outliers", action="store_true")
    p_edit.add_argument("--remove-radius", nargs=4, type=float, default=None,
                        metavar=("X", "Y", "Z", "R"))
    p_edit.add_argument("--save", required=True)
    for p in (p_open, p_merge, p_edit):
        p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")

    args = ap.parse_args(argv)

    if args.cmd in ("open", "merge"):
        from glim_tpu_torch.viewer.offline_viewer import OfflineViewer
        config = None
        if getattr(args, "config", None):
            from glim_tpu_torch.utils.config import Config
            config = Config(args.config)
        ov = OfflineViewer(config=config, device=args.device)
        if args.cmd == "open":
            ov.open_map(args.dump)
            if args.find_loops is not None:
                ov.global_mapping.find_overlapping_submaps(args.find_loops)
            if args.optimize or args.find_loops is not None:
                ov.optimize()
        else:
            ov.open_map(args.dumps[0])
            for d in args.dumps[1:]:
                ov.merge_map(d)
            ov.optimize()
        print(f"{len(ov.global_mapping.submaps)} submaps, "
              f"{len(ov.global_mapping.matching_factors)} matching factors")
        if args.ply:
            ov.export_ply(args.ply)
        if args.save:
            ov.save(args.save)
        return ov

    import numpy as np

    from glim_tpu_torch.viewer.map_editor import MapEditor
    ed = MapEditor(device=args.device)
    ed.open(args.dump)
    if args.remove_outliers:
        n = ed.select_outliers()
        print(f"selected {n} outliers")
    if args.remove_radius:
        x, y, z, r = args.remove_radius
        n = ed.select_radius(np.array([x, y, z]), r)
        print(f"selected {n} points in radius")
    ed.delete_selected()
    ed.save(args.save)
    print(f"edited map saved to {args.save}")
    return ed


if __name__ == "__main__":
    main()
