"""Offline trajectory evaluation CLI (evo equivalent).

    python -m glim_tpu_torch.tools.evaluate <est.tum | dump_dir> <gt.tum>
        [--max-diff 0.02] [--no-align] [--traj traj_lidar.txt] [--json]

Twin of ``glim_tpu/tools/evaluate.py``: evaluates a TUM trajectory, or the
one inside a dump directory (``io/dump.py`` layout), against a ground-truth
TUM file and prints ATE / RPE. Host only: it reads files and runs numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("est", help="estimated TUM file or dump directory")
    ap.add_argument("gt", help="ground-truth TUM file")
    ap.add_argument("--max-diff", type=float, default=0.02)
    ap.add_argument("--no-align", action="store_true")
    ap.add_argument("--traj", default="traj_lidar.txt",
                    help="trajectory file inside a dump dir")
    ap.add_argument("--json", action="store_true", help="print JSON only")
    args = ap.parse_args(argv)

    from glim_tpu_torch.io.evaluation import evaluate_tum_files

    est_path = args.est
    if os.path.isdir(est_path):
        est_path = os.path.join(est_path, args.traj)
    m = evaluate_tum_files(est_path, args.gt, max_diff=args.max_diff,
                           align=not args.no_align)
    if args.json:
        print(json.dumps({
            "ate_rmse_m": m.ate_rmse, "ate_mean_m": m.ate_mean,
            "ate_max_m": m.ate_max, "rot_rmse_deg": m.rot_rmse_deg,
            "rpe_trans_m": m.rpe_trans, "rpe_rot_deg": m.rpe_rot_deg,
            "n_poses": m.n_poses, "length_m": m.length_m}))
    else:
        print(m.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
