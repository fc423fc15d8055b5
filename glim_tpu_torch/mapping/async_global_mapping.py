"""Asynchronous global-mapping wrapper.

Twin of ``glim_tpu/mapping/async_global_mapping.py`` (reference:
src/glim/mapping/async_global_mapping.cpp:24-143): a worker thread drains
the submap queue, defers optimization over a burst of submaps (catch-up or
the end-of-sequence drain) to one solve after it, services the request
slots (optimize, recover, find-overlapping, translation prior, loop,
between), optimizes periodically when idle, and guards ``save`` /
``export_points`` with a mutex.

A back-end's ``wait_for_detection()`` (the pose graph's loop detection)
runs before the final solve and its ``stop()`` after it and in ``stop()``.
A back-end with ``enable_optimization`` false is never optimized by the
wrapper (the JAX wrapper's check ignores that parameter). Otherwise every
optimize the wrapper decides on itself (after a burst, when idle, and the
final one) runs only when ``needs_optimize()`` says the graph changed; an
explicit ``request_to_optimize`` runs as asked. The worker runs in the pipeline device's scope on the default
stream; its failure is re-raised by ``join()`` and ``workload()``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as CB
from glim_tpu_torch.mapping.global_mapping_base import GlobalMappingBase
from glim_tpu_torch.types import SubMap
from glim_tpu_torch.utils import lifecycle
from glim_tpu_torch.utils.concurrent import ConcurrentVector
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.profiling import profile_scope

logger = create_module_logger("global")


class AsyncGlobalMapping:
    def __init__(self, global_mapping: GlobalMappingBase,
                 optimization_interval: float = 5.0):
        self.global_mapping = global_mapping
        self.optimization_interval = optimization_interval
        self.input_imu_queue: ConcurrentVector = ConcurrentVector()
        self.input_submap_queue: ConcurrentVector = ConcurrentVector()
        self._end_of_sequence = threading.Event()
        self._draining = threading.Event()
        self._request_optimize = threading.Event()
        self._request_recover = threading.Event()
        self._request_overlap: ConcurrentVector = ConcurrentVector()
        # Extension factor-injection requests, applied on the worker thread.
        self._request_factors: ConcurrentVector = ConcurrentVector()
        self._mutex = threading.RLock()
        self._last_optimization = time.time()
        self.skipped_requests = 0     # request kinds the back-end lacks

        CB.request_to_optimize.add(self._request_optimize.set)
        CB.request_to_recover.add(self._request_recover.set)
        CB.request_to_find_overlapping_submaps.add(self._request_overlap.push_back)
        CB.request_to_add_translation_prior.add(
            lambda idx, pos, si: self._request_factors.push_back(("tp", idx, pos, si)))
        CB.request_to_add_loop.add(
            lambda tgt, src: self._request_factors.push_back(("loop", tgt, src)))
        CB.request_to_add_between.add(
            lambda tgt, src, T, info=None: self._request_factors.push_back(
                ("between", tgt, src, T, info)))

        self.worker = lifecycle.Worker("global_mapping", self._run,
                                       getattr(global_mapping, "device", None))
        lifecycle.register(self)

    def insert_imu(self, stamp: float, linear_acc: np.ndarray, angular_vel: np.ndarray) -> None:
        self.input_imu_queue.push_back((stamp, np.asarray(linear_acc), np.asarray(angular_vel)))

    def insert_submap(self, submap: SubMap) -> None:
        self.input_submap_queue.push_back(submap)

    def insert_image(self, stamp: float, image) -> None:
        # Callback fan-out only; CallbackSlot is thread-safe.
        self.global_mapping.insert_image(stamp, image)

    def begin_drain(self) -> None:
        """The feed has ended and a join() is imminent: from now on every
        insert defers its optimization into the single final solve."""
        self._draining.set()

    def join(self, timeout=None) -> None:
        self._draining.set()
        self._end_of_sequence.set()
        self.input_submap_queue.submit_end_of_data()
        self.worker.join(timeout)

    def stop(self, timeout: float = 5.0) -> None:
        """Non-draining shutdown (lifecycle cleanup); stops the back-end
        too when it has a ``stop`` (the pose graph's detection thread)."""
        self._end_of_sequence.set()
        self.input_submap_queue.submit_end_of_data()
        self.worker.thread.join(timeout=timeout)
        stop_inner = getattr(self.global_mapping, "stop", None)
        if stop_inner is not None:
            stop_inner()

    def workload(self) -> int:
        self.worker.check()
        return self.input_submap_queue.size()

    def save(self, path: str) -> None:
        with self._mutex:
            self.global_mapping.save(path)

    def export_points(self) -> np.ndarray:
        with self._mutex:
            return self.global_mapping.export_points()

    def _optimization_enabled(self) -> bool:
        params = getattr(self.global_mapping, "params", None)
        return bool(getattr(params, "enable_optimization", True))

    def _needs_optimize(self) -> bool:
        needs = getattr(self.global_mapping, "needs_optimize", None)
        return self._optimization_enabled() and (needs is None or needs())

    def _apply_factor_request(self, req: tuple) -> bool:
        """Apply one extension request; a kind the back-end has no method
        for is skipped with a warning (the pose graph takes no translation
        prior), as in the JAX wrapper. True when the request asks for an
        optimize (a between factor)."""
        gm = self.global_mapping
        if req[0] == "tp" and hasattr(gm, "add_translation_prior"):
            gm.add_translation_prior(req[1], req[2], req[3])
        elif req[0] == "loop" and hasattr(gm, "add_matching_factor"):
            gm.add_matching_factor(req[1], req[2])
        elif req[0] == "loop" and hasattr(gm, "add_loop_candidate"):
            gm.add_loop_candidate(req[1], req[2])   # the pose graph validates it first
        elif req[0] == "between" and hasattr(gm, "add_between_factor"):
            gm.add_between_factor(req[1], req[2], req[3], req[4])
            return True
        else:
            self.skipped_requests += 1
            logger.warning("%s has no method for a %r request; skipped",
                           type(gm).__name__, req[0])
        return False

    def _run(self) -> None:
        while True:
            eos = self._end_of_sequence.is_set()
            for stamp, acc, gyro in self.input_imu_queue.get_all_and_clear():
                self.global_mapping.insert_imu(stamp, acc, gyro)
            submaps = self.input_submap_queue.get_all_and_clear_wait(timeout=0.05)
            with self._mutex:
                gm = self.global_mapping
                draining = eos or self._draining.is_set()
                # Each source is read once a poll; the stage's scope spans
                # the polls that have work, and no idle one.
                factors = self._request_factors.get_all_and_clear()
                overlaps = self._request_overlap.get_all_and_clear()
                optimize = _take(self._request_optimize)
                recover = _take(self._request_recover)
                # Periodic idle optimization (reference: :96-118), only when
                # the graph changed since the last solve.
                idle_optimize = False
                now = time.time()
                if not (draining or submaps or optimize) \
                        and now - self._last_optimization > self.optimization_interval:
                    self._last_optimization = now
                    idle_optimize = self._needs_optimize()
                if submaps or factors or overlaps or optimize or recover or idle_optimize:
                    with profile_scope("global_mapping"):
                        self._work(gm, draining, submaps, factors, optimize, recover,
                                   overlaps, idle_optimize)

            if eos and self.input_submap_queue.empty() and not submaps:
                with self._mutex, profile_scope("global_mapping"):
                    # Let a back-end's loop detection finish its queue first.
                    if hasattr(gm, "wait_for_detection"):
                        gm.wait_for_detection()
                    # Final solve, skipped when the graph is unchanged since
                    # the last optimize or optimization is disabled.
                    if self._needs_optimize():
                        gm.optimize()
                    if hasattr(gm, "stop"):
                        gm.stop()
                break

    def _work(self, gm, draining: bool, submaps, factors, optimize: bool,
              recover: bool, overlaps, idle_optimize: bool) -> None:
        """One busy poll of the worker, under the mutex, on what ``_run``
        read: the submaps, the requests, and the periodic optimize."""
        # A backlog costs one solve after the burst instead of one per
        # insert; once the drain is flagged, every insert defers and the
        # final solve covers them.
        defer = (len(submaps) > 1 or draining) and hasattr(gm, "defer_optimization")
        if defer:
            gm.defer_optimization = True
        for sm in submaps:
            gm.insert_submap(sm)
            self._last_optimization = time.time()
        if defer:
            gm.defer_optimization = False
            if not draining:
                if self._needs_optimize():
                    gm.optimize()
                self._last_optimization = time.time()

        for req in factors:
            try:
                optimize |= self._apply_factor_request(req)
            except (ValueError, IndexError, np.linalg.LinAlgError) as e:
                # Extension input: a malformed request is reported
                # and dropped, never fatal to the map.
                logger.warning("extension factor request %s failed: %s", req[0], e)

        if optimize:
            if self._optimization_enabled():
                gm.optimize()
            self._last_optimization = time.time()
        if recover:
            gm.recover_graph()
        for min_overlap in overlaps:
            gm.find_overlapping_submaps(min_overlap)
        if idle_optimize and not optimize:
            gm.optimize()
            self._last_optimization = time.time()


def _take(flag: threading.Event) -> bool:
    """Read and clear a request flag."""
    if flag.is_set():
        flag.clear()
        return True
    return False
