"""The port's asynchronous pipeline: the queue against the JAX package's,
the worker threads, and GlimTorch(async_mode=True) against the port's
synchronous pipeline on one small default-configuration sequence.

Async and sync must give the same estimate ids, the same frames in the same
submaps and an ATE under the default slice's 0.08 m bound (on the CPU the
two runs take the same decisions: gate copies are always ready). A stage
that raises makes ``workload()`` / ``wait()`` raise and stops the other
workers; a back-end with ``enable_optimization`` false is never optimized
by the wrapper (the JAX wrapper's check ignores it, so that path is not
compared), in either pipeline mode. A back-end's wait_for_detection() runs
before the final solve and its stop() after it, in both modes. Every join
has a timeout and the test fails if a thread is still alive.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from torch_parity import SMALL_DEFAULT_OVERRIDES

from glim_tpu.utils import concurrent as j_conc
from glim_tpu_torch.utils import concurrent as t_conc
from glim_tpu_torch.utils import lifecycle

JOIN_S = 300.0
ATE_BOUND = 0.08
SEQ = dict(duration=3.0, n_scan_points=1500, scene_points=20000, seed=53)


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    lifecycle.stop_all()
    CallbackSlot.clear_all()


def _ops(vec, policy_max):
    """One fixed sequence of queue operations; returns what each observed."""
    out = []
    vec.push_back(1)
    vec.insert([2, 3, 4])
    out.append(vec.size())
    out.append(vec.pop_wait(timeout=0.01))
    out.append(vec.get_all_and_clear())
    out.append((vec.empty(), vec.pop_wait(timeout=0.01)))
    vec.insert(list(range(10)))
    out.append(vec.get_all_and_clear_wait(timeout=0.01))
    vec.push_back(7)
    vec.clear()
    out.append((vec.size(), vec.closed(), vec.end_of_data()))
    vec.push_back(8)
    vec.submit_end_of_data()
    out.append((vec.closed(), vec.end_of_data()))
    t0 = time.perf_counter()
    out.append(vec.get_all_and_clear_wait(timeout=5.0))
    out.append(vec.get_all_and_clear_wait(timeout=5.0))    # closed: no wait
    out.append((vec.pop_wait(timeout=5.0), vec.end_of_data()))
    assert time.perf_counter() - t0 < 2.0
    out.append(policy_max)
    return out


@pytest.mark.parametrize("max_size", [0, 3])
def test_concurrent_vector_matches_jax(max_size):
    j = j_conc.ConcurrentVector(j_conc.DataStorePolicy.UPTO(max_size))
    t = t_conc.ConcurrentVector(t_conc.DataStorePolicy.UPTO(max_size))
    assert _ops(t, max_size) == _ops(j, max_size)
    assert t.high_water == (10 if max_size == 0 else 3)


def test_concurrent_vector_loses_nothing_under_contention():
    """More producers than cores with a short switch interval: every item
    pushed is drained exactly once, and profile_scope counts every scope."""
    from glim_tpu_torch.utils import profiling

    vec = t_conc.ConcurrentVector()
    n_threads, n_items = 16, 400
    got, done = [], threading.Event()

    def produce(k):
        for i in range(n_items):
            with profiling.profile_scope("test/contention"):
                vec.push_back((k, i))

    def consume():
        while not (done.is_set() and vec.empty()):
            got.extend(vec.get_all_and_clear_wait(timeout=0.01))

    before = profiling.report().get("test/contention", {"n": 0})["n"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        consumer = threading.Thread(target=consume)
        consumer.start()
        producers = [threading.Thread(target=produce, args=(k,)) for k in range(n_threads)]
        for p in producers:
            p.start()
        for p in producers:
            p.join(60)
        done.set()
        consumer.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not consumer.is_alive() and not any(p.is_alive() for p in producers)
    assert sorted(got) == [(k, i) for k in range(n_threads) for i in range(n_items)]
    assert profiling.report()["test/contention"]["n"] - before == n_threads * n_items


def _seq():
    from glim_tpu_torch.io.synthetic import generate_sequence
    return generate_sequence(**SEQ)


def _glim(tmp_path, async_mode, overrides=()):
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.utils.config import create_default_config_dir

    cfg = create_default_config_dir(str(tmp_path / f"cfg_{async_mode}"))
    return GlimTorch(cfg, async_mode=async_mode, device="cpu",
                     overrides=SMALL_DEFAULT_OVERRIDES + list(overrides))


def _feed(glim, seq, n_scans=None, max_workload=10):
    imu_i = 0
    for raw in seq.scans[:n_scans]:
        while imu_i < len(seq.imu) and seq.imu[imu_i, 0] <= raw.stamp + 0.12:
            glim.insert_imu(seq.imu[imu_i, 0], seq.imu[imu_i, 1:4], seq.imu[imu_i, 4:7])
            imu_i += 1
        glim.insert_frame(raw)
        deadline = time.perf_counter() + JOIN_S
        while glim.workload() > max_workload:
            assert time.perf_counter() < deadline, "the pipeline stopped draining"
            time.sleep(0.01)


def _wait(glim):
    """glim.wait() on a helper thread joined with a timeout; re-raises what
    wait() raised, and fails if any thread is still alive."""
    err = []

    def run():
        try:
            glim.wait()
        except BaseException as exc:
            err.append(exc)
    t = threading.Thread(target=run)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "wait() did not return"
    if glim.async_mode:
        for stage in (glim.odometry, glim.sub_mapping, glim.global_mapping):
            assert not stage.worker.is_alive(), stage.worker.name
    if err:
        raise err[0]


def _run(glim, seq):
    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks
    from glim_tpu_torch.io.synthetic import ate_rmse

    optimizes = []
    GlobalMappingCallbacks.on_smoother_update_result.add(lambda *a: optimizes.append(1))
    _feed(glim, seq)
    _wait(glim)
    ests = glim.odometry_estimates
    gt = [seq.gt_poses[int(round(e.stamp * 10))] for e in ests]
    return dict(ids=[e.id for e in ests], ate=ate_rmse([e.T_world_lidar for e in ests], gt,
                                                       align=True),
                frames=[[f.id for f in s.frames] for s in glim.submaps],
                optimizes=len(optimizes))


def test_async_matches_sync(tmp_path):
    """GlimTorch's default (async) pipeline against its synchronous one on
    the same sequence; the async pipeline builds the three wrappers."""
    seq = _seq()
    sync = _run(_glim(tmp_path, False), seq)
    glim = _glim(tmp_path, True)
    assert [type(s).__name__ for s in (glim.odometry, glim.sub_mapping, glim.global_mapping)] == \
        ["AsyncOdometryEstimation", "AsyncSubMapping", "AsyncGlobalMapping"]
    res = _run(glim, seq)
    assert res["ids"] == sync["ids"] and len(res["ids"]) >= 25
    assert res["frames"] == sync["frames"] and len(res["frames"]) >= 3
    assert sum(len(f) for f in res["frames"]) == len(res["ids"])
    assert res["ate"] < ATE_BOUND and sync["ate"] < ATE_BOUND
    assert res["ate"] == pytest.approx(sync["ate"], abs=1e-6)
    assert res["optimizes"] >= 1
    # Every estimate was published with its state on the host.
    assert all(e._T_world_lidar is not None for e in glim.odometry_estimates)


@pytest.mark.parametrize("stage", ["odometry", "sub_mapping", "global_mapping"])
def test_failed_stage_raises(tmp_path, stage):
    """A worker that raises surfaces in the caller (workload() while
    feeding, or wait()), and every worker is stopped."""
    glim = _glim(tmp_path, True)
    inner = {"odometry": lambda g: g.odometry.odometry,
             "sub_mapping": lambda g: g.sub_mapping.sub_mapping,
             "global_mapping": lambda g: g.global_mapping.global_mapping}[stage](glim)
    method = "insert_submap" if stage == "global_mapping" else "insert_frame"

    def boom(*args, **kwargs):
        raise ValueError(f"{stage} failed on purpose")
    setattr(inner, method, boom)
    with pytest.raises(lifecycle.WorkerFailed, match=f"{stage} failed on purpose") as info:
        _feed(glim, _seq(), n_scans=12)
        _wait(glim)
    assert isinstance(info.value.__cause__, ValueError)
    for s in (glim.odometry, glim.sub_mapping, glim.global_mapping):
        s.worker.thread.join(JOIN_S)
        assert not s.worker.is_alive(), s.worker.name


class _Backend:
    """A global-mapping back-end that records optimize calls."""

    def __init__(self, enable_optimization):
        from glim_tpu_torch.mapping.global_mapping import GlobalMappingParams
        self.params = GlobalMappingParams(enable_optimization=enable_optimization)
        self.defer_optimization = False
        self.inserted, self.optimizes = [], 0

    def insert_imu(self, *a):
        pass

    def insert_submap(self, sm):
        self.inserted.append(sm)

    def needs_optimize(self):
        return True

    def optimize(self):
        self.optimizes += 1


@pytest.mark.parametrize("enable", [False, True])
def test_enable_optimization_false_never_optimizes(enable):
    """With enable_optimization false the wrapper optimizes neither after a
    burst, nor when idle, nor at the end, nor on request; with it true each
    of those paths optimizes."""
    from glim_tpu_torch.mapping.async_global_mapping import AsyncGlobalMapping
    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks

    backend = _Backend(enable)
    agm = AsyncGlobalMapping(backend, optimization_interval=0.05)
    agm.input_submap_queue.insert(["a", "b", "c"])        # a burst
    time.sleep(0.3)                                          # idle
    GlobalMappingCallbacks.request_to_optimize()
    time.sleep(0.2)
    agm.join(JOIN_S)
    assert not agm.worker.is_alive()
    assert backend.inserted == ["a", "b", "c"]
    assert (backend.optimizes == 0) if not enable else (backend.optimizes >= 3)


@pytest.mark.parametrize("async_mode", [True, False])
def test_enable_optimization_false_in_the_pipeline(tmp_path, async_mode):
    """The pipeline (async, and the sync wait()'s final solve) with
    enable_optimization false runs no optimize and keeps the odometry's
    submap origins."""
    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks

    glim = _glim(tmp_path, async_mode, [("config_global_mapping", "global_mapping",
                                         "enable_optimization", False)])
    optimizes = []
    GlobalMappingCallbacks.on_smoother_update_result.add(lambda *a: optimizes.append(1))
    _feed(glim, _seq(), n_scans=20)
    _wait(glim)
    gm = glim.global_backend
    assert len(gm.submaps) >= 2 and optimizes == []
    for T, T0 in zip(gm.poses, gm.odom_poses):
        np.testing.assert_allclose(T, T0, atol=1e-9)


class _HookedBackend(_Backend):
    """A back-end with the pose graph's end-of-sequence hooks, recording
    the order of its calls."""

    def __init__(self):
        super().__init__(True)
        self.calls = []

    def insert_submap(self, sm):
        super().insert_submap(sm)
        self.calls.append("insert")

    def optimize(self):
        super().optimize()
        self.calls.append("optimize")

    def wait_for_detection(self):
        self.calls.append("wait_for_detection")

    def stop(self):
        self.calls.append("stop")


@pytest.mark.parametrize("async_mode", [True, False])
def test_backend_hooks_at_the_end_of_a_sequence(tmp_path, async_mode):
    """wait() finishes the back-end's detection before the final solve and
    stops it after, in both pipeline modes."""
    glim = _glim(tmp_path, async_mode)
    backend = _HookedBackend()
    if async_mode:
        glim.global_mapping.global_mapping = backend
        glim.global_mapping.insert_submap("a")
    else:
        glim.global_mapping = backend
        backend.insert_submap("a")
    _wait(glim)
    assert backend.calls == ["insert", "wait_for_detection", "optimize", "stop"]


def test_async_stop_stops_the_backend():
    """The async wrapper's non-draining stop() stops the back-end too."""
    from glim_tpu_torch.mapping.async_global_mapping import AsyncGlobalMapping

    backend = _HookedBackend()
    agm = AsyncGlobalMapping(backend)
    agm.stop()
    assert not agm.worker.is_alive()
    assert backend.calls[-1] == "stop" and "optimize" not in backend.calls[
        backend.calls.index("stop") + 1:]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_async_default_pipeline_on_cuda(tmp_path, cuda):
    """The default configuration's async pipeline on the card at a mid size:
    the sync pipeline's estimate ids, every frame in a submap, the ATE
    bounds, submaps on the card and at least one optimize."""
    import chip_smoke

    res = chip_smoke.run_async_default(cuda, n_scans=40, n_scan_points=8000,
                                       scene_points=60000, work_dir=str(tmp_path),
                                       overrides=[("config_sub_mapping", "sub_mapping",
                                                   "max_num_keyframes", 6)])
    chip_smoke.check_async(res)
    assert res["submap_device"] == "cuda"


def test_forward_ad_from_many_threads():
    """Forward-mode AD from more threads than cores with a short switch
    interval (the odometry and global workers both linearize with jacfwd):
    every thread gets the single-threaded Jacobians, and none fails."""
    from glim_tpu_torch.ops import factors, lie

    rng = np.random.default_rng(5)
    Ts = [lie.se3_exp(torch.from_numpy(rng.normal(0, 0.5, (64, 6)).astype(np.float32)))
          for _ in range(8)]
    Zs = [lie.se3_exp(torch.from_numpy(rng.normal(0, 0.5, (64, 6)).astype(np.float32)))
          for _ in range(8)]

    def res(x, Ti, Zi):
        return lie.se3_log(Zi @ (Ti @ lie.se3_exp(x)))

    want = [factors.batched_jacobian(res, 6, T, Z) for T, Z in zip(Ts, Zs)]
    errors, got = [], {}

    def work(k):
        try:
            for _ in range(10):
                got[k] = factors.batched_jacobian(res, 6, Ts[k], Zs[k])
        except BaseException as exc:
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    for k in range(8):
        for a, b in zip(got[k], want[k]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
