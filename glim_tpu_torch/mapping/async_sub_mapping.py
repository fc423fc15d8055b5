"""Asynchronous sub-mapping wrapper (reference:
src/glim/mapping/async_sub_mapping.cpp:8-91); twin of
``glim_tpu/mapping/async_sub_mapping.py``.

The producer starts each frame's packed-state copy at the hand-off, so the
copy lands while the frame waits in the queue. On an input burst (catch-up,
or the end-of-sequence drain) the worker deepens sub-mapping's pending-gate
queue (``gate_keep``) so back-to-back frames do not wait on gate copies
still behind the work just queued. The worker runs in the pipeline device's
scope on the default stream; its failure is re-raised by ``join()``,
``workload()`` and ``get_results()``.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np

from glim_tpu_torch.mapping.sub_mapping_base import SubMappingBase
from glim_tpu_torch.types import EstimationFrame, SubMap
from glim_tpu_torch.utils import lifecycle
from glim_tpu_torch.utils.concurrent import ConcurrentVector
from glim_tpu_torch.utils.profiling import profile_scope


class AsyncSubMapping:
    def __init__(self, sub_mapping: SubMappingBase):
        self.sub_mapping = sub_mapping
        self.input_imu_queue: ConcurrentVector = ConcurrentVector()
        self.input_frame_queue: ConcurrentVector = ConcurrentVector()
        self.output_submap_queue: ConcurrentVector = ConcurrentVector()
        self._end_of_sequence = threading.Event()
        self._draining = threading.Event()
        self.worker = lifecycle.Worker("sub_mapping", self._run,
                                       getattr(sub_mapping, "device", None))
        lifecycle.register(self)

    def insert_imu(self, stamp: float, linear_acc: np.ndarray, angular_vel: np.ndarray) -> None:
        self.input_imu_queue.push_back((stamp, np.asarray(linear_acc), np.asarray(angular_vel)))

    def insert_frame(self, frame: EstimationFrame) -> None:
        frame.fetch_state_async()
        self.input_frame_queue.push_back(frame)

    def insert_image(self, stamp: float, image) -> None:
        # Callback fan-out only; CallbackSlot is thread-safe.
        self.sub_mapping.insert_image(stamp, image)

    def begin_drain(self) -> None:
        """Feed ended, join() imminent: keep the pending-gate queue deep for
        the whole drain (decisions still resolve at submap rolls and at the
        end of the sequence)."""
        self._draining.set()

    def join(self, timeout=None) -> None:
        self._draining.set()
        self._end_of_sequence.set()
        self.input_frame_queue.submit_end_of_data()
        self.worker.join(timeout)

    def stop(self, timeout: float = 5.0) -> None:
        """Non-draining shutdown (lifecycle cleanup)."""
        self._end_of_sequence.set()
        self.input_frame_queue.submit_end_of_data()
        self.worker.thread.join(timeout=timeout)

    def workload(self) -> int:
        self.worker.check()
        return self.input_frame_queue.size()

    def get_results(self) -> List[SubMap]:
        self.worker.check()
        return self.output_submap_queue.get_all_and_clear()

    def _run(self) -> None:
        while True:
            eos = self._end_of_sequence.is_set()
            for stamp, acc, gyro in self.input_imu_queue.get_all_and_clear():
                self.sub_mapping.insert_imu(stamp, acc, gyro)
            frames = self.input_frame_queue.get_all_and_clear_wait(timeout=0.05)
            burst = len(frames) > 1 or self._draining.is_set()
            if burst and hasattr(self.sub_mapping, "gate_keep"):
                self.sub_mapping.gate_keep = max(len(frames) + 3, 64)
            for frame in frames:
                with profile_scope("sub_mapping"):
                    self.sub_mapping.insert_frame(frame)
            if not burst and hasattr(self.sub_mapping, "gate_keep"):
                self.sub_mapping.gate_keep = 3
            self.output_submap_queue.insert(self.sub_mapping.get_submaps())
            if eos and self.input_frame_queue.empty() and not frames:
                self.output_submap_queue.insert(self.sub_mapping.submit_end_of_sequence())
                self.output_submap_queue.submit_end_of_data()
                break
