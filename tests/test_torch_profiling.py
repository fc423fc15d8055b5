"""The port's stage profile (``glim_tpu_torch/utils/profiling.py``): thread CPU
time against wall time in ``profile_scope``, durations added by ``record``,
the five stages of the map lag that the program records
(``mapping/global_mapping_base.py::record_map_lag``) against the lag the
benchmark measures from the outside, the span of the odometry step, and the
global-mapping worker's scope on busy polls only.
"""

import os
import threading
import time

import pytest
import torch

from torch_parity import SMALL_DEFAULT_OVERRIDES

from glim_tpu_torch.utils import lifecycle, profiling

JOIN_S = 300.0
SEQ = dict(duration=3.0, n_scan_points=1500, scene_points=20000, seed=53)


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


def _spin(seconds):
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        pass


def _taken_s():
    """The seconds taken from the calling thread while it was ready to run,
    as the kernel counts them, apart from the thread clock that
    profile_scope reads: its wait on a run queue (/proc/thread-self/schedstat)
    and the time the hypervisor ran no virtual CPU of the machine
    (/proc/stat's steal, summed over them, counted in ticks of 1/CLK_TCK s)."""
    with open("/proc/thread-self/schedstat") as f:
        wait = int(f.read().split()[1]) * 1e-9
    with open("/proc/stat") as f:
        steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    return wait + steal


def test_offcpu_of_a_sleep_and_of_a_spin():
    """A sleep is time off the CPU, though another thread of the process
    spins meanwhile: the CPU time is the thread's own (a process clock would
    read the other thread's 50 ms). A spin of the same length is CPU time:
    it reads less than 10 ms off the CPU beyond what the machine took from
    the ready thread (other processes take half of a 50 ms spin when the
    test suite runs in parallel), give or take the one tick to which the
    kernel counts steal; the best of three spins is held to that."""
    stop = threading.Event()

    def spin_until_stopped():
        while not stop.is_set():
            _spin(0.005)
    with profiling.profile_scope("test/warm"):    # the profiler's first span
        pass
    spinner = threading.Thread(target=spin_until_stopped)
    spinner.start()
    try:
        with profiling.profile_scope("test/sleep"):
            time.sleep(0.05)
    finally:
        stop.set()
        spinner.join(10.0)
    assert not spinner.is_alive()
    got = profiling.report()["test/sleep"]
    assert got["offcpu_ms"] >= 45.0 and got["cpu_ms"] < 25.0
    assert got["cpu_ms"] + got["offcpu_ms"] == pytest.approx(got["mean_ms"])

    beyond = []
    for k in range(3):
        t0 = _taken_s()
        with profiling.profile_scope(f"test/spin{k}"):
            _spin(0.05)
        taken_ms = 1e3 * (_taken_s() - t0)
        got = profiling.report()[f"test/spin{k}"]
        assert got["mean_ms"] >= 50.0
        beyond.append(got["offcpu_ms"] - taken_ms)
    tick_ms = 1e3 / os.sysconf("SC_CLK_TCK")
    assert min(beyond) < 10.0 + tick_ms, beyond


def test_record_entries_come_back_and_reset():
    profiling.record("test/rec", 0.25)
    profiling.record("test/rec", 0.75)
    got = profiling.report()["test/rec"]
    assert got["n"] == 2 and got["total_s"] == pytest.approx(1.0)
    assert got["mean_ms"] == pytest.approx(500.0) and got["max_ms"] == pytest.approx(750.0)
    assert "cpu_ms" not in got and "offcpu_ms" not in got    # no span: no CPU time
    assert "test/rec" in profiling.report(reset=True)
    assert "test/rec" not in profiling.report()


def test_map_lag_stages_add_up_to_the_lag_measured_outside(tmp_path):
    """A small async GlimTorch run: every submap an optimize covered has five
    stages, each >= 0, that add up to its lag as the benchmark measures it
    (the newest frame's hand-over, taken before ``insert_frame``, to the end
    of the first optimize that covers the submap, ``on_update_submaps``)."""
    from glim_tpu_torch.io.synthetic import generate_sequence
    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as G
    from glim_tpu_torch.mapping.global_mapping_base import MAP_LAG_STAGES
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir

    seq = generate_sequence(**SEQ)
    handover, newest, first_opt = {}, {}, {}
    lock = threading.Lock()

    def on_insert_submap(sm):
        with lock:
            newest[sm.id] = max(f.stamp for f in sm.frames)

    def on_update_submaps(submaps):
        t = time.perf_counter()
        with lock:
            for sm in submaps:
                first_opt.setdefault(sm.id, t)

    G.on_insert_submap.add(on_insert_submap)
    G.on_update_submaps.add(on_update_submaps)
    glim = GlimTorch(create_default_config_dir(str(tmp_path / "cfg")), async_mode=True,
                     device="cpu", overrides=SMALL_DEFAULT_OVERRIDES)
    profiling.report(reset=True)
    imu_i = 0
    for raw in seq.scans:
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.12:
            glim.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
            imu_i += 1
        handover[raw.stamp] = time.perf_counter()
        glim.insert_frame(raw)
        deadline = time.perf_counter() + JOIN_S
        while glim.workload() > 10:
            assert time.perf_counter() < deadline, "the pipeline stopped draining"
            time.sleep(0.01)
    waiter = threading.Thread(target=glim.wait)
    waiter.start()
    waiter.join(JOIN_S)
    assert not waiter.is_alive(), "wait() did not return"
    scopes = profiling.report()

    covered = [sm for sm in glim.submaps if sm.id in first_opt]
    assert len(covered) >= 2
    sums = {name: 0.0 for name, _, _ in MAP_LAG_STAGES}
    for sm in covered:
        stamps = dict(max(sm.frames, key=lambda f: f.stamp).host_stamps, **sm.host_stamps)
        stages = [stamps[b] - stamps[a] for _, a, b in MAP_LAG_STAGES]
        assert min(stages) >= 0.0, (sm.id, stages)
        outside = first_opt[sm.id] - handover[newest[sm.id]]
        assert sum(stages) == pytest.approx(outside, abs=5e-3), (sm.id, stages, outside)
        for (name, _, _), v in zip(MAP_LAG_STAGES, stages):
            sums[name] += v
    for name, total in sums.items():
        assert scopes[name]["n"] == len(covered), name
        assert scopes[name]["total_s"] == pytest.approx(total), name
    for name in ("window_scan_step", "odometry"):
        assert scopes[name]["n"] > 0 and scopes[name]["offcpu_ms"] >= 0.0, name
    # Every estimate but the initialization's came from one window step.
    assert scopes["window_scan_step"]["n"] == len(glim.odometry_estimates) - 1


class _Backend:
    """A global-mapping back-end that only counts what it is asked to do, and
    needs an optimize after an insert."""

    def __init__(self):
        self.inserted = []
        self.optimized = 0
        self.changed = False

    def insert_imu(self, *args):
        pass

    def insert_submap(self, submap):
        self.inserted.append(submap)
        self.changed = True

    def needs_optimize(self):
        return self.changed

    def optimize(self):
        self.optimized += 1
        self.changed = False


def _wait_until(cond, timeout=30.0):
    deadline = time.perf_counter() + timeout
    while not cond():
        assert time.perf_counter() < deadline
        time.sleep(0.005)


def test_global_mapping_scope_counts_busy_polls_only():
    """The worker polls its queue every 50 ms; only the polls that had work
    (three submaps, one poll each, and the final optimize) open its scope."""
    from glim_tpu_torch.mapping.async_global_mapping import AsyncGlobalMapping
    from glim_tpu_torch.types import SubMap

    before = profiling.report().get("global_mapping", {"n": 0})["n"]
    gm = _Backend()
    agm = AsyncGlobalMapping(gm, optimization_interval=1e9)
    for k in range(3):
        agm.insert_submap(SubMap(id=k))
        _wait_until(lambda: len(gm.inserted) > k)
        time.sleep(0.3)            # several idle polls
    agm.join(timeout=30.0)
    assert not agm.worker.thread.is_alive()
    assert [sm.id for sm in gm.inserted] == [0, 1, 2] and gm.optimized == 1
    assert profiling.report()["global_mapping"]["n"] - before == 4


def test_global_mapping_scope_skips_a_due_optimize_with_nothing_to_solve():
    """With a 50 ms optimization interval, an optimize falls due on nearly
    every idle poll. Only the first after an insert has a changed graph to
    solve and opens the scope: each of three submaps makes two busy polls
    (its insert, its idle optimize), and the final poll one, however many
    polls found the optimize due with the graph unchanged."""
    from glim_tpu_torch.mapping.async_global_mapping import AsyncGlobalMapping
    from glim_tpu_torch.types import SubMap

    before = profiling.report().get("global_mapping", {"n": 0})["n"]
    gm = _Backend()
    agm = AsyncGlobalMapping(gm, optimization_interval=0.05)
    for k in range(3):
        agm.insert_submap(SubMap(id=k))
        _wait_until(lambda: gm.optimized > k)
        time.sleep(0.3)            # several polls with the optimize due
    agm.join(timeout=30.0)
    assert not agm.worker.thread.is_alive()
    assert [sm.id for sm in gm.inserted] == [0, 1, 2] and gm.optimized == 3
    assert profiling.report()["global_mapping"]["n"] - before == 7
