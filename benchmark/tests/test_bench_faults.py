"""The check must see a broken timed path: whole runs of the harness on the CPU
at a tiny size (no card: ``device="cpu"``; the limits are the cells' own),
with faults planted in the program it drives, come out not correct; the same
run without a fault comes out correct.

Faults, as the pipeline can have them: a step that returns its state
unchanged (every estimate keeps the first pose; every optimize of the
back-end leaves the submap poses as they came), half of the batch left out
(every other scan never reaches the odometry; half of each scan's points
never reach preprocessing), an answer altered where it is produced (one
estimate's matrix written wrong; one estimate in twenty with its position
alone moved 0.5 m; every estimate's position scaled by 1.05). No cell spans
chips, so no exchange between chips can be left out.

    python -m pytest benchmark/tests/test_bench_faults.py -q    (~8 min)
"""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402

PIPE_EDITS = dict(scan_points=4096, scene={"points": 40000, "extent": 30.0}, check_frames=4)


def run_cell(capsys, workload, fault=None, seconds=8):
    """The run's result line; a run that fails prints one too (not correct)."""
    rc = run.main(["--workload", workload, "--seed", "3000000077", "--seconds", str(seconds),
                   "--trace", "0"], fault=fault, device="cpu", traffic_edits=PIPE_EDITS)
    out = capsys.readouterr().out
    assert rc == 0 or fault is not None
    return json.loads(out.strip().splitlines()[-1])


def state_unchanged(glim):
    add, first = glim._add_estimates, []

    def frozen(ests):
        for e in ests:
            if not first:
                first.append(np.array(e.T_world_lidar))
            e.T_world_lidar = first[0]
        add(ests)
    glim._add_estimates = frozen


def half_the_scans(glim):
    insert, n = glim.insert_frame, [0]

    def every_other(raw):
        n[0] += 1
        if n[0] % 2:
            insert(raw)
    glim.insert_frame = every_other


def half_the_points(glim):
    pre = glim.preprocessor.preprocess

    def halved(raw):
        raw.points, raw.times = raw.points[::2], raw.times[::2]
        return pre(raw)
    glim.preprocessor.preprocess = halved


def one_estimate_corrupted(glim):
    """The fifth published estimate written wrong: one entry of its rotation
    off by 0.05, its position by 0.5 m."""
    add, n = glim._add_estimates, [0]

    def corrupted(ests):
        for e in ests:
            n[0] += 1
            if n[0] == 5:
                T = np.array(e.T_world_lidar)
                T[0, 1] += 0.05
                T[0, 3] += 0.5
                e.T_world_lidar = T
        add(ests)
    glim._add_estimates = corrupted


def one_position_moved(glim):
    """One published estimate in twenty with its position off by 0.5 m, its
    rotation left as it is."""
    add, n = glim._add_estimates, [0]

    def moved(ests):
        for e in ests:
            n[0] += 1
            if n[0] % 20 == 0:
                T = np.array(e.T_world_lidar)
                T[0, 3] += 0.5
                e.T_world_lidar = T
        add(ests)
    glim._add_estimates = moved


def translations_scaled(glim):
    """Every published estimate's position scaled by 1.05: an odometry whose
    steps are all 5% too long."""
    add = glim._add_estimates

    def scaled(ests):
        for e in ests:
            T = np.array(e.T_world_lidar)
            T[:3, 3] *= 1.05
            e.T_world_lidar = T
        add(ests)
    glim._add_estimates = scaled


def optimize_unchanged(glim):
    """The back-end's solve returns the poses it was given: every optimize
    runs, and leaves the submap poses as they came."""
    gm = glim.global_backend

    def solve(args, dims, N, J, mesh=None):
        juncs = np.array(gm.junction_states, np.float64).reshape(J, 12)
        return np.stack(gm.poses[:N]), juncs, 0.0, np.ones(N)
    gm._solve = solve


@pytest.mark.parametrize("workload", ["default_gpu.circle", "gicp_cpu.circle"])
def test_pipeline_sound_run_is_correct(capsys, workload):
    line = run_cell(capsys, workload)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, half_the_scans, half_the_points,
                                   one_estimate_corrupted, one_position_moved,
                                   translations_scaled, optimize_unchanged])
def test_pipeline_faults_are_not_correct(capsys, fault):
    line = run_cell(capsys, "default_gpu.circle", fault)
    assert not line["correct"], line["checks"]
