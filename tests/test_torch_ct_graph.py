"""The CT odometry's scan step replayed from a CUDA graph
(glim_tpu_torch/odometry/ct_graph.py).

On the CPU the runner's capture is replaced by a stub that runs the captured
callable: "capture" runs it once on the static inputs, and a replay runs it
again there, its lookups going through the runner's ``Lookup`` objects and
its results copied into the static outputs, as a graph writes them in place.
So the runner's keys, buffers, lookups and clones run without a card. Each
test drives the port's CT odometry (the ivox model) over a small circle
sequence with a ``Twin`` placed where the benchmark's driver puts its
sampler, on ``odometry_estimation_ct._ct_scan_step``: each step through the
runner and, on the same arguments, directly, compared step by step. The LRU
horizon is 3 steps, so a replay that reused the step of its capture would
stop the model's ages and its expiry, and differ from the direct steps.

The card test (``gpu``) runs the real capture over 260 scans of the shipped
CT preset with a second thread launching kernels throughout.
"""

import contextlib
import math
import threading

import pytest
import torch

from glim_tpu_torch.io.synthetic import generate_sequence
from glim_tpu_torch.odometry import ct_graph, window_graph
from glim_tpu_torch.odometry import odometry_estimation_ct as tct
from glim_tpu_torch.ops import voxelmap as vmx
from glim_tpu_torch.ops.nn_search import nn_search
from glim_tpu_torch.preprocess.cloud_preprocessor import (CloudPreprocessor,
                                                          CloudPreprocessorParams)
from glim_tpu_torch.utils import profiling
from glim_tpu_torch.utils.config import Config
from glim_tpu_torch.utils.default_config import DEFAULT_CONFIGS

SEQ = dict(duration=2.4, n_scan_points=1500, scene_points=20000, seed=71)
LRU = 3                 # ivox_lru_thresh: steps a model point lives untouched
BOOT = 5                # bootstrap_frames (the default), replayed once


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
    (a graph writes them in place) and runs the program's search object (the
    runner's ``Lookup``), and the results are copied into the static
    outputs."""

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


def _leaves(tree):
    out = []
    window_graph.flatten(tree, out)
    return out


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


def _captured(runner):
    """The runner's captured entries by key."""
    return {k: e for k, e in runner._entries.items() if e.solve is not None}


class Twin:
    """A wrapper on ``odometry_estimation_ct._ct_scan_step``: the runner's
    result (the step as the odometry calls it), checked against a direct call
    on the same arguments. Records each step's int, the model it took and
    returned (with ``keep``, and every returned tensor with its values), and
    the (Q, N) of the ``nn_search`` calls each path made."""

    def __init__(self, compare, keep=True):
        self.orig, self.compare, self.keep = tct._ct_scan_step, compare, keep
        self.calls = None
        self.steps = []         # (step, model in, model out)
        self.searches = []      # (direct, runner) (Q, N) lists a step
        self.launches = []      # (direct, runner) nn_search launches a step
        self.kept = []          # (returned leaves, their values at return)

    def record(self, queries, query_mask, targets, target_mask):
        self.calls.append((int(queries.shape[0]), int(targets.shape[0])))
        return nn_search(queries, query_mask, targets, target_mask)

    def __call__(self, *args, graph, **kw):
        self.calls, n0 = [], nn_search.kernel_launches
        direct = self.orig(*args, **kw)
        direct_calls, n1 = self.calls, nn_search.kernel_launches
        self.calls = []
        got = self.orig(*args, graph=graph, **kw)
        self.searches.append((direct_calls, self.calls))
        self.launches.append((n1 - n0, nn_search.kernel_launches - n1))
        self.compare(direct, got)
        if not self.keep:
            self.steps.append((args[2], None, None))
            return got
        self.steps.append((args[2], args[3], got[3]))
        leaves = _leaves(got)
        self.kept.append((leaves, [t.clone() for t in leaves]))
        return got


def _exact(direct, got):
    for a, b in zip(_leaves(direct), _leaves(got), strict=True):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)


def _run(odom, step, frames):
    """The frames through ``odom`` with ``step`` in the place of
    ``_ct_scan_step`` and, where it records searches, of ``nn_search``."""
    orig_step, orig_nn = tct._ct_scan_step, tct.nn_search
    tct._ct_scan_step = step
    if hasattr(step, "record"):
        tct.nn_search = step.record
    try:
        for f in frames:
            odom.insert_frame(f)
    finally:
        tct._ct_scan_step, tct.nn_search = orig_step, orig_nn


def _odometry(device, graph=None, **kw):
    kw = dict(dict(model_type="ivox", model_capacity=4096, ivox_lru_thresh=LRU,
                   update_budget=200, bootstrap_frames=BOOT), **kw)
    p = tct.OdometryEstimationCTParams(**kw)
    odom = tct.OdometryEstimationCT(p, device=device)
    if graph is not None:
        odom._graph = graph
    return odom


@pytest.fixture(scope="module")
def cpu_frames():
    seq = generate_sequence(**SEQ)
    pp = CloudPreprocessor(CloudPreprocessorParams(random_downsample_target=500,
                                                   downsample_resolution=0.4), device="cpu")
    return [pp.preprocess(raw) for raw in seq.scans]


class StubRun:
    """The sequence through the stub: the twin, the runner and the profile
    scopes."""

    def __init__(self, frames):
        StubProgram.captures = 0
        self.runner = ct_graph.CTGraphRunner(capture=StubProgram, strict=True)
        self.twin = Twin(_exact)
        profiling.report(reset=True)
        _run(_odometry("cpu", self.runner), self.twin, frames)
        self.captures = StubProgram.captures
        self.scopes = profiling.report(reset=True)


@pytest.fixture(scope="module")
def stub_run(cpu_frames):
    return StubRun(cpu_frames)


def _ages(model):
    return model.age[model.mask].to(torch.int64)


def test_replays_are_bit_equal_to_direct_steps(stub_run, cpu_frames):
    """Every step bit-equal to the direct call (the twin compares each),
    over the bootstrap, its replay and more than one LRU horizon of replays:
    one key, captured once as two programs, after two eager warm-up calls."""
    r = stub_run
    steps = [s for s, _, _ in r.twin.steps]
    assert steps == list(range(BOOT)) + list(range(len(cpu_frames)))
    steady = len(cpu_frames) - BOOT
    replays = steady - window_graph.WARMUP_CALLS
    assert replays > 2 * LRU + 2
    assert len(_captured(r.runner)) == len(r.runner._entries) == 1
    assert r.captures == 2 and r.scopes["ct_graph/capture"]["n"] == 1
    assert r.scopes["ct_graph/replay"]["n"] == replays


def test_replays_advance_the_model_ages(stub_run):
    """The step reaches the model update as an input: in every replayed step
    the newest age is that step, no point outlives the LRU horizon, and
    points expired in replayed steps."""
    replayed = [t for t in stub_run.twin.steps[-(stub_run.scopes["ct_graph/replay"]["n"]):]]
    expired = 0
    for step, model_in, model_out in replayed:
        ages = _ages(model_out)
        assert int(ages.max()) == step and int(ages.min()) >= step - LRU
        expired += int((_ages(model_in) < step - LRU).sum())
    assert expired > 0


def test_four_lookups_a_step(stub_run, cpu_frames):
    """The replay makes the step's four searches, eagerly, in the same order
    and shapes as the direct call, each through a ``Lookup``; the model
    update is a program of its own, with no search."""
    r = stub_run
    C = cpu_frames[0].device_points.shape[0]
    for direct, replayed in r.twin.searches:
        assert direct == replayed == [(C, 4096)] * 4
    entry = next(iter(_captured(r.runner).values()))
    assert len(entry.solve.searches) == 4 and entry.insert.searches == []
    assert all(isinstance(s, ct_graph.Lookup) for s in entry.solve.searches)
    assert r.scopes["ct_scan_step"]["n"] == len(r.twin.steps)


def test_replayed_work_keeps_its_spans(cpu_frames, monkeypatch):
    """Inside ``ct_graph/replay`` each of a step's four searches runs inside
    a ``ct/lookup`` span and the model update inside ``ct/model_insert``, so
    the benchmark's lookup and insert readers read the same work replayed."""
    stack, spans, searches = [], [], []
    real = ct_graph.profile_scope

    @contextlib.contextmanager
    def scope(name):
        stack.append(name)
        spans.append(tuple(stack))
        try:
            with real(name):
                yield
        finally:
            stack.pop()

    def search(*args):
        searches.append(tuple(stack))
        return nn_search(*args)

    monkeypatch.setattr(ct_graph, "profile_scope", scope)
    frames = cpu_frames[:12]
    runner = ct_graph.CTGraphRunner(capture=StubProgram, strict=True)
    monkeypatch.setattr(tct, "nn_search", search)
    odom = _odometry("cpu", runner)
    for f in frames:
        odom.insert_frame(f)
    replays = len(frames) - BOOT - window_graph.WARMUP_CALLS
    assert spans.count(("ct_graph/capture",)) == 1
    assert spans.count(("ct_graph/replay",)) == replays
    assert spans.count(("ct_graph/replay", "ct/model_insert")) == replays
    assert [s for s in searches if s] == [("ct_graph/replay", "ct/lookup")] * 4 * replays


def test_outputs_own_their_memory(stub_run):
    """No returned tensor shares storage with a static input or output, and
    none changes when later steps run."""
    r = stub_run
    static = set()
    for entry in _captured(r.runner).values():
        static |= _storages(entry.inputs) | _storages(entry.outputs)
        static |= _storages(_leaves(entry.solve.outputs))
    assert static
    for leaves, values in r.twin.kept:
        assert not (_storages(leaves) & static)
        for t, v in zip(leaves, values, strict=True):
            torch.testing.assert_close(t, v, rtol=0, atol=0, equal_nan=True)


def test_a_wrapper_on_the_step_sees_every_step(cpu_frames):
    """A wrapper put on ``odometry_estimation_ct._ct_scan_step``, as the
    benchmark's step sampler is, is called for every step, replays included,
    with the step's arguments, and returns what the runner returned."""
    frames = cpu_frames[:12]
    seen = []

    def wrapper(*args, **kw):
        out = orig(*args, **kw)
        seen.append((args[2], out))
        return out

    orig = tct._ct_scan_step
    profiling.report(reset=True)
    _run(_odometry("cpu", ct_graph.CTGraphRunner(capture=StubProgram, strict=True)),
         wrapper, frames)
    scopes = profiling.report(reset=True)
    assert [s for s, _ in seen] == list(range(BOOT)) + list(range(len(frames)))
    assert scopes["ct_graph/replay"]["n"] == len(frames) - BOOT - window_graph.WARMUP_CALLS
    assert all(len(out) == 8 for _, out in seen)


def test_the_cpu_path_is_the_direct_call(cpu_frames):
    """The odometry's own runner, without a capture given, sends CPU tensors
    straight to the step's ops: nothing is captured or replayed."""
    odom = _odometry("cpu")
    assert isinstance(odom._graph, ct_graph.CTGraphRunner)
    profiling.report(reset=True)
    twin = Twin(_exact)
    _run(odom, twin, cpu_frames[:10])
    assert odom._graph._entries == {} and len(twin.steps) == 10 + BOOT
    scopes = profiling.report(reset=True)
    assert "ct_graph/capture" not in scopes and "ct_graph/replay" not in scopes


def test_the_vgicp_model_runs_directly(cpu_frames):
    """The Gaussian voxel model's insert takes the step as a host int: its
    steps are never captured."""
    StubProgram.captures = 0
    runner = ct_graph.CTGraphRunner(capture=StubProgram, strict=True)
    p = tct.OdometryEstimationCTParams(model_type="vgicp", model_capacity=8192)
    odom = tct.OdometryEstimationCT(p, device="cpu")
    odom._graph = runner
    _run(odom, Twin(_exact), cpu_frames[:10])
    assert runner._entries == {} and StubProgram.captures == 0


def test_a_new_key_captures_anew(cpu_frames):
    """A key is what the call can observe: another float weight or static
    keyword captures a program of its own; the same key captures once."""
    frames = cpu_frames[:10]
    runner = ct_graph.CTGraphRunner(capture=StubProgram, strict=True)
    keys = []
    for kw in (dict(), dict(constant_velocity_inf_scale=500.0), dict(update_budget=150),
               dict()):
        StubProgram.captures = 0
        _run(_odometry("cpu", runner, **kw), Twin(_exact), frames)
        keys.append(StubProgram.captures)
    assert keys == [2, 2, 2, 0] and len(_captured(runner)) == 3


def test_a_failed_capture_raises_or_runs_eagerly(cpu_frames):
    """A capture that fails raises with strict; without it the step runs
    eagerly, and the key is tried again up to MAX_CAPTURE_ATTEMPTS times."""
    attempts = []

    def broken(fn, device):
        attempts.append(1)
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        _run(_odometry("cpu", ct_graph.CTGraphRunner(capture=broken, strict=True)),
             Twin(_exact), cpu_frames[:10])
    attempts.clear()
    runner = ct_graph.CTGraphRunner(capture=broken)
    twin = Twin(_exact)
    profiling.report(reset=True)
    _run(_odometry("cpu", runner), twin, cpu_frames[:14])
    assert len(attempts) == window_graph.MAX_CAPTURE_ATTEMPTS and _captured(runner) == {}
    assert len(twin.steps) == 14 + BOOT
    assert "ct_graph/replay" not in profiling.report(reset=True)


@pytest.mark.parametrize("step", [7, 300])
def test_pointmap_insert_takes_a_device_step(step):
    """``pointmap_insert`` with the step as a 0-dim int64 tensor gives what
    it gives with the step as an int, expiry included."""
    g = torch.Generator().manual_seed(step)
    pm = vmx.empty_point_voxelmap(256, 0.1, lru_horizon=3, device="cpu")
    pts = torch.rand(200, 3, generator=g) * 4.0
    covs = torch.eye(3).expand(200, 3, 3).contiguous()
    mask = torch.rand(200, generator=g) > 0.1
    pm = vmx.pointmap_insert(pm, pts, mask, covs, step - 4)
    new = (pts[:100] + 2.0, mask[:100], covs[:100])
    by_int = vmx.pointmap_insert(pm, *new, step)
    by_tensor = vmx.pointmap_insert(pm, *new, torch.tensor(step, dtype=torch.int64))
    for a, b in zip(_leaves(by_int), _leaves(by_tensor), strict=True):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    # The points of step - 4 left untouched expired; the touched took the step.
    assert int(pm.mask.sum()) > 0 and bool((_ages(by_int) == step).all())


# -- on the card ------------------------------------------------------------


CARD_SCANS = 260
# benchmark/limits/ct.circle.json's step limits.
TRANS_M, ROT_DEG, TWIST = 0.007, 0.0066, 0.1


def _rot_deg(Ra, Rb):
    """The angle between two rotations, from both the sine and the cosine
    (an arccosine alone loses small angles to rounding)."""
    D = Ra.T @ Rb
    vee = torch.stack([D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])
    return math.degrees(math.atan2(0.5 * float(torch.linalg.norm(vee)),
                                   0.5 * (float(torch.trace(D)) - 1.0)))


def _close(direct, got):
    """Poses and twist within the benchmark's step limits."""
    for i in (0, 1):
        a, b = direct[i].double(), got[i].double()
        assert float(torch.linalg.norm(a[:3, 3] - b[:3, 3])) <= TRANS_M
        assert _rot_deg(a[:3, :3], b[:3, :3]) <= ROT_DEG
    assert float((direct[2] - got[2]).abs().max()) <= TWIST


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graph capture has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_on_the_card(cuda):
    """260 steps of the shipped CT preset (ivox, 16,384 points a scan against
    a 65,536-point model): each replayed step within the benchmark's step
    limits of the direct step on the same arguments, nn_search launched 4
    times a step on both paths, a replay on every steady step after the
    warm-up, and the capture made while a second thread launches kernels."""
    seq = generate_sequence(duration=CARD_SCANS / 10.0, n_scan_points=40000,
                            scene_points=200000, seed=73)
    pp = CloudPreprocessor(CloudPreprocessorParams(random_downsample_target=16384,
                                                   downsample_resolution=0.1), device=cuda)
    frames = [pp.preprocess(raw) for raw in seq.scans]
    cfg = dict(DEFAULT_CONFIGS["config_odometry_ct.json"])
    cfg["odometry_estimation"] = dict(cfg["odometry_estimation"], model_type="ivox")
    p = tct.OdometryEstimationCTParams.from_config(Config(cfg))
    odom = tct.OdometryEstimationCT(p, device=cuda)
    odom._graph = ct_graph.CTGraphRunner(strict=True)

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
        twin = Twin(_close, keep=False)
        profiling.report(reset=True)
        _run(odom, twin, frames)
        torch.cuda.synchronize()
    finally:
        stop.set()
        other.join(60.0)
    assert not other.is_alive() and spins[0] > 100
    assert len(frames) >= 250 and len(twin.steps) == len(frames) + p.bootstrap_frames
    assert all(d == g == 4 for d, g in twin.launches), twin.launches
    for direct, replayed in twin.searches:
        assert replayed == direct
    scopes = profiling.report()
    steady = len(frames) - p.bootstrap_frames
    assert scopes["ct_graph/replay"]["n"] == steady - window_graph.WARMUP_CALLS
    entry = next(iter(_captured(odom._graph).values()))
    assert len(entry.solve.segments) == 5 and len(entry.insert.segments) == 1
    assert int(odom.model.mask.sum()) > 0
