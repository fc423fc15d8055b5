"""On the card: each cell's controls (``benchmark/control.py``: the program's
TF32 matmuls switched on; the reference's true poses in bfloat16 in the
program's place) come out not correct under the cell's limits, with a short
window. Skips without a card.

    python -m pytest benchmark/tests/test_bench_control.py -m gpu -q    (~8 min)
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("control", ["tf32", "bf16_reference"])
@pytest.mark.parametrize("workload", bench_cells())
def test_control_is_not_correct(workload, control):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "benchmark.control", "--control", control,
                          "--workload", workload,
                          "--seed", "2147483999", "--seconds", "10", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
