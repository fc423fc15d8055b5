"""Map editor CLI, twin of ``glim_tpu/tools/map_editor.py`` (the
reference's ``map_editor`` executable, src/glim/viewer/map_editor.cpp:19-24,
editor/points_selector.cpp: radius / gizmo-box / outlier / min-cut /
region-growing selection) as a headless batch tool over dump directories.

Usage:
    python -m glim_tpu_torch.tools.map_editor <dump> --save <out>
        [--select-radius X Y Z R] [--select-box CX CY CZ EX EY EZ]
        [--select-outliers [STD_MUL]]
        [--select-object X Y Z [--method min_cut|region_growing]]
        [--invert] [--ply out.ply] [--dry-run] [--device cuda|cpu]

Selections accumulate (union), like the interactive selector; ``--invert``
flips the final selection; the selected points are deleted on save. The
map is opened on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dump", help="dump directory to edit")
    ap.add_argument("--save", default=None, help="output dump directory")
    ap.add_argument("--select-radius", nargs=4, type=float, default=None,
                    metavar=("X", "Y", "Z", "R"))
    ap.add_argument("--select-box", nargs=6, type=float, default=None,
                    metavar=("CX", "CY", "CZ", "EX", "EY", "EZ"),
                    help="axis-aligned box: center + half-extents")
    ap.add_argument("--select-outliers", nargs="?", type=float, const=1.0,
                    default=None, metavar="STD_MUL")
    ap.add_argument("--select-object", nargs=3, type=float, default=None,
                    metavar=("X", "Y", "Z"),
                    help="segmentation selection around a seed point")
    ap.add_argument("--method", default="min_cut",
                    choices=["min_cut", "region_growing"])
    ap.add_argument("--invert", action="store_true",
                    help="invert the selection before deleting")
    ap.add_argument("--ply", default=None, help="export the edited cloud")
    ap.add_argument("--dry-run", action="store_true",
                    help="report selection counts without saving")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    if not (args.save or args.ply or args.dry_run):
        ap.error("--save, --ply, or --dry-run required")

    from glim_tpu_torch.viewer.map_editor import MapEditor

    ed = MapEditor(device=args.device)
    ed.open(args.dump)
    print(f"opened {args.dump}: {len(ed.points)} points")

    if args.select_radius is not None:
        x, y, z, r = args.select_radius
        print(f"radius select: {ed.select_radius(np.array([x, y, z]), r)}")
    if args.select_box is not None:
        cx, cy, cz, ex, ey, ez = args.select_box
        T = np.eye(4)
        T[:3, 3] = [cx, cy, cz]
        print(f"box select: {ed.select_box(T, [ex, ey, ez])}")
    if args.select_outliers is not None:
        print(f"outlier select: "
              f"{ed.select_outliers(std_mul=float(args.select_outliers))}")
    if args.select_object is not None:
        seed = np.asarray(args.select_object)
        print(f"object select ({args.method}): "
              f"{ed.select_segmentation(seed, method=args.method)}")

    if args.invert:
        all_idx = set(range(len(ed.points))) - ed.deleted
        ed.selected = all_idx - ed.selected
    print(f"{ed.num_selected()} points selected")
    if args.dry_run:
        return 0
    n = ed.delete_selected()
    print(f"deleted {n} points")
    if args.save:
        ed.save(args.save)
        print(f"edited map saved to {args.save}")
    if args.ply:
        from glim_tpu_torch.native.loader import ply_write
        keep = np.ones(len(ed.points), bool)
        keep[list(ed.deleted)] = False
        ply_write(args.ply, ed.points[keep])
        print(f"exported {int(keep.sum())} points to {args.ply}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
