"""The odometry's window step replayed from a CUDA graph
(glim_tpu_torch/odometry/window_graph.py).

On the CPU the runner's capture is replaced by a stub that runs the captured
callable: "capture" runs the step once on the static inputs, and a replay
runs it again there, its searches going through the runner's ``Search``
objects and its results copied into the static outputs, as a graph writes
them in place. So the runner's keys, buffers, searches and clones run
without a card. Each test drives the port's odometry over a small circle
sequence whose step is a ``Twin``: the runner's call and a direct
``window_scan_step`` call on the same arguments, compared step by step, with
a keyframe insert (a new map) and a ``compute_covs`` flip among the steps.

The card tests (``gpu``) run the real capture in both matching modes, with a
second thread launching kernels throughout.
"""

import threading

import pytest
import torch

from glim_tpu_torch.io.synthetic import generate_sequence
from glim_tpu_torch.odometry import window_estimator, window_graph
from glim_tpu_torch.odometry.odometry_estimation_cpu_imu import (
    OdometryEstimationCPUIMU, OdometryEstimationCPUIMUParams)
from glim_tpu_torch.odometry.odometry_estimation_imu import (
    OdometryEstimationIMU, OdometryEstimationIMUParams)
from glim_tpu_torch.ops.nn_search import nn_search
from glim_tpu_torch.preprocess.cloud_preprocessor import (CloudPreprocessor,
                                                          CloudPreprocessorParams)
from glim_tpu_torch.utils import profiling

SEQ = dict(duration=3.2, n_scan_points=1500, scene_points=20000, seed=61)
COVS_FROM = 14          # the frame from which compute_covs is requested


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


class StubProgram:
    """``capture_cuda``'s stand-in: ``fn`` runs at capture with a search that
    hands out static buffers, and again at each replay on the static inputs;
    each search then copies the queries it is given over the captured ones
    (a graph writes them in place) and runs the runner's ``Search``, and the
    results are copied into the static outputs."""

    captures = 0

    def __init__(self, fn, device):
        StubProgram.captures += 1
        self.fn = fn
        self.searches = []
        self.outputs = fn(self._capture_search)

    def _capture_search(self, *args):
        out = window_graph.search_buffers(args[0])
        self.searches.append(window_graph.Search(args, out))
        return out

    def replay(self):
        pending = iter(self.searches)

        def search(*args):
            s = next(pending)
            for dst, src in zip(s.args, args):
                dst.copy_(src)
            return s()
        new, static = [], []
        window_graph.flatten(self.fn(search), new)
        window_graph.flatten(self.outputs, static)
        assert next(pending, None) is None
        for dst, src in zip(static, new):
            dst.copy_(src)


def _programs(runner):
    """The runner's captured programs by key."""
    return {k: e.program for k, e in runner._entries.items() if e.program is not None}


def _leaves(tree):
    out = []
    window_graph.flatten(tree, out)
    return out


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


class Twin:
    """The odometry's step: the runner's result, checked against a direct
    ``window_scan_step`` call on the same arguments. Records the shapes
    (Q, N) of the ``nn_search`` calls each path makes and, on the card, the
    launch counts."""

    def __init__(self, runner, compare):
        self.runner, self.compare = runner, compare
        self.calls = None
        self.kept = []          # (returned leaves, their values at return)
        self.steps = 0
        self.searches = []      # (eager, runner) (Q, N) lists a step
        self.launches = []      # (eager, runner) nn_search launches a step
        self.evicts = []        # whether each step evicted a state

    def record(self, queries, query_mask, targets, target_mask):
        self.calls.append((int(queries.shape[0]), int(targets.shape[0])))
        return nn_search(queries, query_mask, targets, target_mask)

    def __call__(self, *args, **kw):
        self.calls, n0 = [], nn_search.kernel_launches
        eager = window_estimator.window_scan_step(*args, **kw)
        eager_calls, n1 = self.calls, nn_search.kernel_launches
        self.calls = []
        got = self.runner(*args, **kw)
        self.searches.append((eager_calls, self.calls))
        self.launches.append((n1 - n0, nn_search.kernel_launches - n1))
        self.compare(eager, got)
        self.evicts.append(bool(eager[1]["marg"]["was_full"]))
        leaves = _leaves(got)
        self.kept.append((leaves, [t.clone() for t in leaves]))
        self.steps += 1
        return got


def _exact(eager, got):
    for a, b in zip(_leaves(eager), _leaves(got), strict=True):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)


def _run(odom, twin, frames, seq, covs_from=COVS_FROM):
    """The sequence through ``odom`` with ``twin`` as its step, compute_covs
    requested from frame ``covs_from``; the map objects each step saw."""
    odom._window_step = twin
    imu_i = 0
    models = []
    nn_search_mod = window_estimator.nn_search
    window_estimator.nn_search = twin.record
    try:
        for i, (raw, f) in enumerate(zip(seq.scans, frames)):
            while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.12:
                odom.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
                imu_i += 1
            if i == covs_from:
                odom._on_request_covs()
            n = twin.steps
            odom.insert_frame(f)
            if twin.steps > n:
                models.append(odom.model)
    finally:
        window_estimator.nn_search = nn_search_mod
    return models


def _odometry(matching, device, window_size):
    common = dict(window_size=window_size, initialization_mode="NAIVE",
                  initialization_window_size=0.3)
    if matching == "gicp":
        return OdometryEstimationCPUIMU(OdometryEstimationCPUIMUParams(
            model_capacity=8192, ivox_resolution=0.8, **common), device=device)
    return OdometryEstimationIMU(OdometryEstimationIMUParams(
        voxel_capacity=8192, voxel_resolution=0.5, voxel_resolution_max=0.5,
        bootstrap_frames=3, **common), device=device)


def _frames(seq, device, target):
    pp = CloudPreprocessor(CloudPreprocessorParams(random_downsample_target=target,
                                                   downsample_resolution=0.4),
                           device=device)
    return [pp.preprocess(raw) for raw in seq.scans]


@pytest.fixture(scope="module")
def cpu_seq():
    seq = generate_sequence(**SEQ)
    return seq, _frames(seq, "cpu", 500)


class StubRun:
    """One run of the sequence through the stub: the twin, the runner, the
    map objects the steps saw and the profile scopes."""

    def __init__(self, seq, frames, matching):
        StubProgram.captures = 0
        self.runner = window_graph.WindowGraphRunner(capture=StubProgram, strict=True)
        self.twin = Twin(self.runner, _exact)
        profiling.report(reset=True)
        self.models = _run(_odometry(matching, "cpu", 6), self.twin, frames, seq)
        self.captures = StubProgram.captures
        self.scopes = profiling.report(reset=True)


@pytest.fixture(scope="module")
def stub_runs(cpu_seq):
    runs = {}

    def get(matching):
        if matching not in runs:
            runs[matching] = StubRun(*cpu_seq, matching)
        return runs[matching]
    return get


@pytest.mark.parametrize("matching", ["vgicp", "gicp"])
def test_replays_are_bit_equal_to_direct_steps(stub_runs, matching):
    """20+ steps through the stub: every result bit-equal to the direct call
    (the twin compares each step), a map replaced between steps, one capture
    a key, a second key from the compute_covs flip, the warm-up calls
    eager."""
    r = stub_runs(matching)
    assert r.twin.steps >= 20
    assert len({id(m) for m in r.models}) > 1          # keyframe / model inserts
    assert r.captures == 2 == len(_programs(r.runner))
    assert [dict(k[2])["compute_covs"] for k in _programs(r.runner)] == [False, True]
    assert r.scopes["window_graph/capture"]["n"] == 2
    # Two eager warm-up calls a key, every other call a replay.
    assert r.scopes["window_graph/replay"]["n"] == r.twin.steps - 2 * window_graph.WARMUP_CALLS


@pytest.mark.parametrize("matching", ["vgicp", "gicp"])
def test_outputs_own_their_memory(stub_runs, matching):
    """No returned tensor shares storage with a static input or output, and
    none changes when later steps run."""
    r = stub_runs(matching)
    static = set()
    for key, program in _programs(r.runner).items():
        static |= _storages(r.runner._entries[key].inputs) | _storages(_leaves(program.outputs))
    assert static
    for leaves, values in r.twin.kept:
        assert not (_storages(leaves) & static)
        for t, v in zip(leaves, values, strict=True):
            torch.testing.assert_close(t, v, rtol=0, atol=0, equal_nan=True)


def test_gicp_searches_once_a_call_site(stub_runs, cpu_seq):
    """GICP through the stub: the replay makes the step's five searches,
    eagerly and in the same order and shapes as the direct call; VGICP
    makes none."""
    C = cpu_seq[1][0].device_points.shape[0]
    for matching, per_step in (("gicp", 5), ("vgicp", 0)):
        r = stub_runs(matching)
        for eager, replayed in r.twin.searches:
            assert len(eager) == per_step and replayed == eager
        if per_step:
            assert [q for q, _ in r.twin.searches[-1][0]] == [C // 4, C // 4, C, C, C // 4]
            assert all(len(p.searches) == per_step for p in _programs(r.runner).values())


def test_clone_all_is_a_bitwise_copy_in_new_memory():
    """The runner's one-call clone: each dtype the step returns, 0-dim and
    strided views among them, -0.0, NaN and a denormal kept bit for bit."""
    f = torch.tensor([-0.0, float("nan"), 1e-40, -3.5, float("inf")])
    ts = [f, torch.tensor([True, False]), torch.tensor([7, -2**31], dtype=torch.int32),
          torch.tensor(2.5), torch.arange(12.0).reshape(3, 4).T, torch.zeros((), dtype=torch.bool)]
    out = window_graph.clone_all(ts)
    for t, o in zip(ts, out, strict=True):
        assert (o.dtype, o.shape) == (t.dtype, t.shape)
        assert o.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
        torch.testing.assert_close(o, t, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(out[0].view(torch.int32), f.view(torch.int32))


def test_a_new_key_captures_anew(cpu_seq):
    """A key is what the call can observe: another W, or vel_reg given or
    not, captures a program of its own; the same key captures once."""
    seq, frames = cpu_seq
    keys = set()
    for window_size, vel in ((6, False), (6, True), (8, False)):
        StubProgram.captures = 0
        runner = window_graph.WindowGraphRunner(capture=StubProgram, strict=True)
        odom = _odometry("vgicp", "cpu", window_size)
        if vel:
            odom.set_velocity_regulation(1.0, 5.0)
        twin = Twin(runner, _exact)
        _run(odom, twin, frames[:12], seq, covs_from=len(frames))
        assert StubProgram.captures == 1 and twin.steps > window_graph.WARMUP_CALLS + 1
        keys |= set(_programs(runner))
    assert len(keys) == 3


def test_the_cpu_path_is_the_direct_call(cpu_seq):
    """Without a capture given, CPU tensors go straight to
    window_scan_step: nothing is captured or replayed."""
    seq, frames = cpu_seq
    odom = _odometry("vgicp", "cpu", 6)
    assert isinstance(odom._window_step, window_graph.WindowGraphRunner)
    runner = odom._window_step
    profiling.report(reset=True)
    twin = Twin(runner, _exact)
    _run(odom, twin, frames[:12], seq)
    assert _programs(runner) == {} and twin.steps > window_graph.WARMUP_CALLS + 1
    scopes = profiling.report()
    assert "window_graph/capture" not in scopes and "window_graph/replay" not in scopes


def test_a_failed_capture_raises_or_runs_eagerly(cpu_seq):
    """A capture that fails raises with strict; without it the step runs
    eagerly, and the key is tried again up to MAX_CAPTURE_ATTEMPTS times."""
    seq, frames = cpu_seq
    attempts = []

    def broken(fn, device):
        attempts.append(1)
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        _run(_odometry("vgicp", "cpu", 6),
             Twin(window_graph.WindowGraphRunner(capture=broken, strict=True), _exact),
             frames[:12], seq)
    attempts.clear()
    runner = window_graph.WindowGraphRunner(capture=broken)
    twin = Twin(runner, _exact)
    _run(_odometry("vgicp", "cpu", 6), twin, frames[:14], seq, covs_from=len(frames))
    assert len(attempts) == window_graph.MAX_CAPTURE_ATTEMPTS and _programs(runner) == {}
    assert twin.steps > window_graph.WARMUP_CALLS + window_graph.MAX_CAPTURE_ATTEMPTS


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graph capture has no CPU mode)")
    return torch.device("cuda")


def _close(eager, got):
    """Poses, velocities and biases within 1e-5; the status flags equal."""
    we, oe = eager
    wg, og = got
    for k in ("T_wl", "T_wi", "v", "b"):
        torch.testing.assert_close(og[k], oe[k], rtol=0, atol=1e-5)
    for f in ("T", "v", "b"):
        torch.testing.assert_close(getattr(wg, f), getattr(we, f), rtol=0, atol=1e-5)
    for i in (window_estimator.STATUS_FINITE, window_estimator.STATUS_MARGINALIZED):
        assert float(og["status"][i]) == float(oe["status"][i])
    assert bool(og["marg"]["was_full"]) == bool(oe["marg"]["was_full"])


@pytest.mark.gpu
@pytest.mark.parametrize("matching", ["vgicp", "gicp"])
def test_graph_on_the_card(cuda, matching):
    """40 window steps of a circle sequence with keyframe inserts and
    evictions: replayed steps match eager ones within 1e-5 with the same
    flags, nn_search launches as often on both paths (5 a GICP step), and
    the capture succeeds while a second thread launches kernels throughout."""
    seq = generate_sequence(duration=4.6, n_scan_points=20000, scene_points=120000, seed=67)
    frames = _frames(seq, cuda, 4096)
    stop = threading.Event()
    spins = [0]

    def busy():
        a = torch.randn(256, 256, device=cuda)
        while not stop.is_set():
            a = torch.tanh(a @ a.T / 256.0)
            b = torch.empty(int(1 + spins[0] % 7) << 16, device=cuda)
            b.fill_(1.0)
            spins[0] += 1

    other = threading.Thread(target=busy)
    other.start()
    try:
        runner = window_graph.WindowGraphRunner(strict=True)
        twin = Twin(runner, _close)
        profiling.report(reset=True)
        models = _run(_odometry(matching, cuda, 12), twin, frames, seq)
        torch.cuda.synchronize()
    finally:
        stop.set()
        other.join(60.0)
    assert not other.is_alive() and spins[0] > 100
    assert twin.steps >= 40
    assert len({id(m) for m in models}) > 1
    assert len(_programs(runner)) == 2
    assert any(twin.evicts)
    per_step = 5 if matching == "gicp" else 0
    assert all(e == g == per_step for e, g in twin.launches), twin.launches
    for eager, replayed in twin.searches:
        assert replayed == eager
    scopes = profiling.report()
    assert scopes["window_graph/replay"]["n"] == twin.steps - 2 * window_graph.WARMUP_CALLS
    program = next(iter(_programs(runner).values()))
    assert len(program.segments) == per_step + 1
