"""Pipeline cells: scans and IMU through the user's entry point, ``GlimTorch``.

The load is an offline replay, a closed loop with the runner's own
backpressure (``glim_tpu_torch/tools/glim_runner.py::play``): each scan goes
in with the IMU up to ``imu_lead_s`` past its stamp, then the feed waits
while ``workload()`` exceeds ``max_workload``. Set-up feeds scans until the
first global optimize has ended; the window opens there, mid-stream, and
closes after ``--seconds`` on the host clock. A traced run then feeds
``trace_scans`` more scans under the profiler. ``wait()`` drains the
pipeline after that, outside every metric.

Timings come from the program's public callback slots, on the host clock:
odometry takes a scan up (``OdometryEstimationCallbacks.on_insert_frame``)
and emits its estimate (``on_new_frame``); global mapping takes a submap
(``GlobalMappingCallbacks.on_insert_submap``) and ends an optimize
(``on_update_submaps``). The preprocessed frames of a sample of the
window's scans are kept (``PreprocessCallbacks.on_filtering_finished``) for
the check.
"""

from __future__ import annotations

import gc
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import trace as trace_mod
from benchmark.generators import landmark_scans
from benchmark.glim_config import config_dir, preprocess_params
from benchmark.reference import preprocess as ref_pre
from benchmark.reference import trajectory as ref_traj


# An optimize turns each submap pose it covers (but the anchor) by far more
# than this [rad]; one that turns none by as much left its state unchanged.
UNMOVED_RAD = 1e-6


def _key(stamp: float) -> int:
    return int(round(stamp * 1e6))


class Recorder:
    """Host-clock times of the program's callbacks, keyed by scan stamp
    (microseconds) and submap id; thread-safe (they fire on the workers)."""

    def __init__(self, n_sample: int, seed: int):
        self.lock = threading.Lock()
        self.taken: Dict[int, float] = {}        # odometry took the scan up
        self.emitted: Dict[int, float] = {}      # its estimate left
        self.submap_newest: Dict[int, int] = {}  # submap id -> newest scan key
        self.first_opt_end: Dict[int, float] = {}
        self.optimizes = 0
        # A uniform sample (reservoir) of the window's preprocessed frames.
        self.window_on = False
        self.n_sample = n_sample
        self.seen = 0
        self.rng = np.random.default_rng(seed)
        self.frames: Dict[int, tuple] = {}

    def on_insert_frame(self, frame) -> None:
        t = time.perf_counter()
        with self.lock:
            self.taken.setdefault(_key(frame.stamp), t)

    def on_new_frame(self, est) -> None:
        t = time.perf_counter()
        with self.lock:
            self.emitted.setdefault(_key(est.stamp), t)

    def on_insert_submap(self, submap) -> None:
        with self.lock:
            self.submap_newest[submap.id] = max(_key(f.stamp) for f in submap.frames)

    def on_update_submaps(self, submaps) -> None:
        t = time.perf_counter()
        with self.lock:
            self.optimizes += 1
            for sm in submaps:
                self.first_opt_end.setdefault(sm.id, t)

    def on_filtering_finished(self, frame) -> None:
        """On the feeding thread: a reservoir sample of the window's frames,
        held by reference (no copy, no sync)."""
        if not self.window_on:
            return
        self.seen += 1
        item = (frame.device_points, frame.device_mask, frame.device_times)
        if len(self.frames) < self.n_sample:
            self.frames[_key(frame.stamp)] = item
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.n_sample:
            del self.frames[sorted(self.frames)[j]]
            self.frames[_key(frame.stamp)] = item


class Feeder:
    """The runner's replay loop, one scan at a time."""

    def __init__(self, glim, seq, traffic: dict, handover: Dict[int, float]):
        from glim_tpu_torch.types import RawPoints
        self.RawPoints = RawPoints
        self.glim, self.seq = glim, seq
        self.lead = float(traffic["imu_lead_s"])
        self.max_workload = int(traffic["max_workload"])
        self.handover = handover
        self.i = 0
        self.imu_i = 0

    def feed(self, deadline: float = float("inf")) -> None:
        seq = self.seq
        if self.i >= len(seq.stamps):
            raise RuntimeError(f"traffic used up after {self.i} scans: the sequence is too "
                               "short for this run (raise ceiling_scans_per_s)")
        stamp = float(seq.stamps[self.i])
        imu = seq.imu
        while self.imu_i < len(imu) and imu[self.imu_i, 0] <= stamp + self.lead:
            self.glim.insert_imu(imu[self.imu_i, 0], imu[self.imu_i, 1:4], imu[self.imu_i, 4:7])
            self.imu_i += 1
        self.handover[_key(stamp)] = time.perf_counter()
        self.glim.insert_frame(self.RawPoints(stamp=stamp, points=seq.points[self.i],
                                              times=seq.times[self.i]))
        self.i += 1
        while self.glim.workload() > self.max_workload and time.perf_counter() < deadline:
            time.sleep(0.01)


def record_published(glim) -> Dict[int, np.ndarray]:
    """The odometry estimates as ``GlimTorch`` hands them out (its trajectory
    takes them there, on the feeding thread, host copies already made): the
    pose each scan got when it was published. The frame objects are the
    odometry's own and their poses are smoothed later, so each is copied
    then."""
    out: Dict[int, np.ndarray] = {}
    inner = glim._add_estimates

    def add(ests):
        inner(ests)
        for e in ests:
            out.setdefault(_key(e.stamp), np.array(e.T_world_lidar, np.float64))
    glim._add_estimates = add
    return out


def _percentile(values: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def _nn_recording():
    """Replace the program's ``nn_search`` in the modules that call it by a
    wrapper that records each call's Q, N and valid counts (device scalars,
    read after the trace) while ``state["on"]``; returns (state, calls,
    restore)."""
    import sys

    from glim_tpu_torch.ops import nn_search as nn_mod

    orig = nn_mod.nn_search
    state = {"on": False}
    calls: list = []

    def wrapper(queries, query_mask, targets, target_mask):
        out = orig(queries, query_mask, targets, target_mask)
        if state["on"] and queries.device.type == "cuda":
            calls.append((int(queries.shape[0]), int(targets.shape[0]),
                          query_mask.sum(), target_mask.sum()))
        return out

    patched = [m for name, m in list(sys.modules.items())
               if name.split(".")[0] == "glim_tpu_torch" and m is not None
               and m is not nn_mod and getattr(m, "nn_search", None) is orig]
    for m in patched:
        m.nn_search = wrapper

    def restore():
        for m in patched:
            m.nn_search = orig
    return state, calls, restore


def run(ctx) -> dict:
    traffic, config = ctx.traffic, ctx.config
    dev = ctx.device
    n_scans = int(traffic["warmup_max_scans"]) + int(
        np.ceil(ctx.seconds * float(traffic["ceiling_scans_per_s"]))) + (
        int(traffic["trace_scans"]) + 2 if ctx.trace else 0)
    t_gen = time.perf_counter()
    seq = landmark_scans.generate(traffic, ctx.seed, n_scans, dev)
    ctx.log(f"generated {n_scans} scans in {time.perf_counter() - t_gen:.2f} s")

    from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as G
    from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks as O
    from glim_tpu_torch.pipeline import GlimTorch
    from glim_tpu_torch.preprocess.callbacks import PreprocessCallbacks as P
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    from glim_tpu_torch.utils.profiling import report

    rec = Recorder(int(traffic["check_frames"]), ctx.seed)
    handles = [(O.on_insert_frame, O.on_insert_frame.add(rec.on_insert_frame)),
               (O.on_new_frame, O.on_new_frame.add(rec.on_new_frame)),
               (G.on_insert_submap, G.on_insert_submap.add(rec.on_insert_submap)),
               (G.on_update_submaps, G.on_update_submaps.add(rec.on_update_submaps)),
               (P.on_filtering_finished, P.on_filtering_finished.add(rec.on_filtering_finished))]

    glim = GlimTorch(config_dir(config, ctx.tmpdir), async_mode=True, device=dev)
    ctx.apply_fault(glim)
    published = record_published(glim)
    try:
        handover: Dict[int, float] = {}
        feeder = Feeder(glim, seq, traffic, handover)
        while rec.optimizes == 0:
            if feeder.i >= int(traffic["warmup_max_scans"]):
                raise RuntimeError(f"no global optimize within {feeder.i} warm-up scans")
            feeder.feed()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        warmup_scans = feeder.i
        report(reset=True)

        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        deadline = t0 + ctx.seconds
        first_window_scan = feeder.i
        rec.window_on = True
        while time.perf_counter() < deadline:
            feeder.feed(deadline)
        t1 = time.perf_counter()
        rec.window_on = False
        scopes = report(reset=False)
        window_scans = feeder.i - first_window_scan
        ctx.log(f"warm-up {warmup_scans} scans, window {window_scans} scans fed in {t1 - t0:.3f} s")

        traced = None
        nn_calls: list = []
        if ctx.trace:
            state, calls, restore = _nn_recording()
            n_trace = int(traffic["trace_scans"])
            with rec.lock:
                before = len(rec.emitted)

            def slice_():
                state["on"] = True
                for _ in range(n_trace):
                    feeder.feed()
                state["on"] = False

            try:
                traced = trace_mod.traced(slice_, ctx.tmpdir, dev)
            finally:
                restore()
            with rec.lock:
                traced["scans"] = len(rec.emitted) - before
            nn_calls = [(q, n, int(a), int(b)) for q, n, a, b in calls]

        glim.wait()
    except BaseException:
        # Stop the workers before the error leaves the run.
        for stage in (glim.odometry, glim.sub_mapping, glim.global_mapping):
            stage.stop()
        raise
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for slot, h in handles:
        slot.remove(h)

    # ---- end-to-end metrics of the window
    in_win = lambda t: t0 <= t < t1  # noqa: E731
    with rec.lock:
        emitted = dict(rec.emitted)
        taken = dict(rec.taken)
        first_opt = dict(rec.first_opt_end)
        newest = dict(rec.submap_newest)
    out_keys = [k for k, t in emitted.items() if in_win(t)]
    lat_ms = [1e3 * (emitted[k] - taken[k]) for k in out_keys if k in taken]
    lags = [first_opt[i] - handover[newest[i]] for i in first_opt
            if in_win(first_opt[i]) and i in newest and newest[i] in handover]
    window_s = t1 - t0
    e2e = {"scans_per_s": len(out_keys) / window_s, "setup_s": setup_s}
    if lat_ms:
        e2e["odom_latency_p90_ms"] = _percentile(lat_ms, 90)
    if lags:
        e2e["map_lag_s"] = float(np.mean(lags))

    # ---- outputs of the timed path, for the check
    win_keys = [_key(float(s)) for s in seq.stamps[first_window_scan:first_window_scan
                                                    + window_scans]]
    ests = dict(published)
    subs = [Submap(s.id in first_opt, np.asarray(s.T_world_origin, np.float64),
                   np.asarray(s.custom_data["T_world_origin_pre"], np.float64),
                   [(_key(f.stamp), np.asarray(f.T_world_sensor(), np.float64))
                    for f in s.frames])
            for s in glim.submaps]
    sub_points = sorted(int(s.frame.mask.sum()) for s in glim.submaps)
    frames = {k: tuple(t.cpu() for t in v) for k, v in rec.frames.items()}
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del glim, feeder, rec
    CallbackSlot.clear_all()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference, after the program's state is freed
    failed = sum(1 for k in win_keys if k not in ests or not np.all(np.isfinite(ests[k])))
    checks = check_outputs(traffic, config, seq, ests, subs, frames, win_keys)
    info = dict(warmup_scans=warmup_scans, window_scans=window_scans,
                window_estimates=len(out_keys), latencies=len(lat_ms), map_lags=len(lags),
                submaps=len(subs), submap_points_median=(float(np.median(sub_points))
                                                         if sub_points else None),
                submap_points=sub_points)
    return dict(attempted=window_scans, failed=failed, e2e=e2e, window_s=window_s,
                scopes=scopes, trace=traced, nn_calls=nn_calls, checks=checks, info=info,
                memory_peak=memory_peak)


@dataclass
class Submap:
    """What the timed path made of one submap: whether an optimize covered it,
    its optimized origin, its origin as sub-mapping handed it over, and each
    frame's (scan key, T_world_sensor) as sub-mapping placed it."""
    optimized: bool
    T_opt: np.ndarray
    T_pre: np.ndarray
    frames: List[Tuple[int, np.ndarray]]


def check_outputs(traffic, config, seq, ests, subs, frames, win_keys) -> dict:
    """The numbers compared with the plain reference (``benchmark/reference``):
    the odometry's published estimates against the true trajectory, the
    submaps' frames carried by their optimized origins (the map), the
    optimized origins, and the sampled preprocessed frames; and exact counts
    of what the timed path has to produce."""
    stamp_of = {_key(float(s)): float(s) for s in seq.stamps}
    idx_of = {_key(float(s)): i for i, s in enumerate(seq.stamps)}
    truth = lambda ks: ref_traj.true_poses(traffic, [stamp_of[k] for k in ks])  # noqa: E731
    checks = {}

    def errors(prefix, keys, poses):
        e = ref_traj.pose_errors(np.stack(poses), truth(keys)) if len(keys) >= 3 else \
            ref_traj.pose_errors(np.zeros((0, 4, 4)), np.zeros((0, 4, 4)))
        names = dict(ate="ate_m", max_err="max_err_m", max_rot_deg="max_rot_deg", rpe="rpe_m",
                     rpe_med="rpe_med_m", rpe_rot_deg="rpe_rot_deg",
                     rpe_rot_med_deg="rpe_rot_med_deg")
        checks.update({f"{prefix}_{n}": e[k] for k, n in names.items()})
        return e

    keys = sorted(ests)
    checks["odom_max_orth"] = errors("odom", keys, [ests[k] for k in keys])["max_orth"]
    checks["estimates_missing"] = float(sum(1 for k in win_keys if k not in ests))
    # The sensor moves between any two scans: an estimate equal to the one
    # before is a step that left its state unchanged.
    checks["estimates_repeated"] = float(sum(
        np.array_equal(ests[a], ests[b]) for a, b in zip(keys, keys[1:])))
    held = {}
    for s in subs:
        for k, _ in s.frames:
            held[k] = held.get(k, 0) + 1
    checks["frames_unmapped"] = float(sum(1 for k in win_keys if held.get(k, 0) != 1))
    # The map: each frame of a submap, as sub-mapping placed it relative to
    # the submap's origin, carried by the optimized origin; in time order.
    placed = sorted(((k, s.T_opt @ np.linalg.inv(s.T_pre) @ T) for s in subs
                     for k, T in s.frames), key=lambda x: x[0])
    errors("map", [k for k, _ in placed], [T for _, T in placed])
    # The optimized origins against the truth at each submap's middle frame
    # (sub-mapping's origin frame), in submap order.
    anchored = [(s.frames[len(s.frames) // 2][0], s.T_opt) for s in subs if s.frames]
    errors("submap_origin", [k for k, _ in anchored], [T for _, T in anchored])
    # An optimize that leaves every pose as it came: origins it covered that
    # keep the orientation sub-mapping handed over (the first is the anchor).
    turn = ref_traj.turned(np.stack([s.T_opt for s in subs[1:]]),
                           np.stack([s.T_pre for s in subs[1:]])) if len(subs) > 1 else \
        np.zeros(0)
    opt = np.array([s.optimized for s in subs[1:]], bool)
    checks["submaps_unmoved"] = float(np.sum(opt & (turn < UNMOVED_RAD)))
    checks["submap_min_turn_rad"] = float(turn[opt].min()) if opt.any() else float("inf")
    viol = 0
    for k, (pts, mask, times) in frames.items():
        viol += ref_pre.violations(seq.points[idx_of[k]], pts, mask, times,
                                   preprocess_params(config))
    checks["preprocess_violations"] = float(viol)
    return checks
