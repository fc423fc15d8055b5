"""The check's controls: runs of a cell judged by the same reference and
limits, which have to come out not correct. The benchmark's own runs never
run them; they give the upper readings the limits are set below.

- ``tf32``: the program's own path one precision below the configuration's
  (float32 with TF32 off): TF32 float32 matmuls switched on
  (``glim_tpu_torch/__init__.py`` turns them off).
- ``bf16_reference``: the reference put in the program's place, in bfloat16:
  each published estimate, each submap frame and each submap origin is the
  true pose at its stamp rounded to bfloat16. The program runs as in any run,
  and its own readings are printed first, on a ``control-program`` line, so
  that one run gives a sound reading and the control's on the same seed and
  structure (the same stamps, submaps and frames).

    python3 -m benchmark.control --control <tf32|bf16_reference> --workload <name> \\
        --seed <n> --seconds <s> --trace 0
"""

import argparse
import json
import sys

import numpy as np

from benchmark import run
from benchmark.reference import trajectory as ref_traj


def enable_tf32() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


def bfloat16(T: np.ndarray) -> np.ndarray:
    import torch
    return torch.as_tensor(T).to(torch.bfloat16).to(torch.float64).numpy()


def reference_in_bf16() -> None:
    """Judge, in place of the program's poses, the true poses in bfloat16; print
    the program's own readings first."""
    from benchmark.drivers import pipeline

    check = pipeline.check_outputs

    def replaced(traffic, config, seq, ests, subs, frames, win_keys):
        program = check(traffic, config, seq, ests, subs, frames, win_keys)
        print("control-program " + json.dumps(program), flush=True)
        stamp_of = {pipeline._key(float(s)): float(s) for s in seq.stamps}
        low = lambda k: bfloat16(ref_traj.true_poses(traffic, [stamp_of[k]])[0])  # noqa: E731
        ests = {k: low(k) for k in ests}
        subs = [pipeline.Submap(s.optimized, low(s.frames[len(s.frames) // 2][0]),
                                low(s.frames[len(s.frames) // 2][0]),
                                [(k, low(k)) for k, _ in s.frames]) if s.frames else s
                for s in subs]
        return check(traffic, config, seq, ests, subs, frames, win_keys)
    pipeline.check_outputs = replaced


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--control", choices=("tf32", "bf16_reference"), required=True)
    args, rest = ap.parse_known_args(argv)
    if args.control == "tf32":
        return run.main(rest, control=enable_tf32)
    reference_in_bf16()
    return run.main(rest)


if __name__ == "__main__":
    sys.exit(main())
