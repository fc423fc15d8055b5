"""Asynchronous odometry wrapper: worker thread + queues.

Twin of ``glim_tpu/odometry/async_odometry_estimation.py`` (reference:
src/glim/odometry/async_odometry_estimation.cpp:15-139): input queues for
IMU and frames, a worker that holds scans back until IMU coverage reaches
``scan_end_time``, output queues of estimated and marginalized frames, and
``workload()`` for upstream backpressure.

Each estimate is published one frame late. Its packed state (pose, velocity,
bias) is copied to pinned host memory behind an event as soon as its window
step is queued, and the worker fills the frame's host caches from that copy
when it publishes the frame, a scan later, by which time the copy has
landed: consumers on other threads read host values and never wait on the
card. The worker runs in the pipeline device's scope on the default stream
(``utils/lifecycle.Worker``); a failure in it is re-raised by ``join()``,
``workload()`` and ``get_results()``.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np

from glim_tpu_torch.odometry.estimation_base import OdometryEstimationBase
from glim_tpu_torch.types import EstimationFrame, PreprocessedFrame
from glim_tpu_torch.utils import lifecycle
from glim_tpu_torch.utils.concurrent import ConcurrentVector
from glim_tpu_torch.utils.profiling import profile_scope


class AsyncOdometryEstimation:
    def __init__(self, odometry: OdometryEstimationBase, enable_imu: bool = True):
        self.odometry = odometry
        self.enable_imu = enable_imu and odometry.requires_imu()

        self.input_imu_queue: ConcurrentVector = ConcurrentVector()
        self.input_frame_queue: ConcurrentVector = ConcurrentVector()
        self.output_estimation_results: ConcurrentVector = ConcurrentVector()
        self.output_marginalized_frames: ConcurrentVector = ConcurrentVector()

        self._end_of_sequence = threading.Event()
        self._internal_frames: List[PreprocessedFrame] = []
        self._pending_out: List[EstimationFrame] = []
        self._last_imu_stamp = -1.0
        self.worker = lifecycle.Worker("odometry", self._run, getattr(odometry, "device", None))
        lifecycle.register(self)

    def insert_imu(self, stamp: float, linear_acc: np.ndarray, angular_vel: np.ndarray) -> None:
        self.input_imu_queue.push_back((stamp, np.asarray(linear_acc), np.asarray(angular_vel)))

    def insert_frame(self, frame: PreprocessedFrame) -> None:
        self.input_frame_queue.push_back(frame)

    def insert_image(self, stamp: float, image) -> None:
        # Callback fan-out only; CallbackSlot is thread-safe.
        self.odometry.insert_image(stamp, image)

    def join(self, timeout=None) -> None:
        self._end_of_sequence.set()
        self.input_frame_queue.submit_end_of_data()
        self.worker.join(timeout)

    def stop(self, timeout: float = 5.0) -> None:
        """Non-draining shutdown (lifecycle cleanup): signal end-of-sequence
        and wait briefly; queued frames may be dropped."""
        self._end_of_sequence.set()
        self.input_frame_queue.submit_end_of_data()
        self.worker.thread.join(timeout=timeout)

    def workload(self) -> int:
        self.worker.check()
        return self.input_frame_queue.size() + len(self._internal_frames)

    def get_results(self) -> Tuple[List[EstimationFrame], List[EstimationFrame]]:
        self.worker.check()
        return (self.output_estimation_results.get_all_and_clear(),
                self.output_marginalized_frames.get_all_and_clear())

    def _publish(self, est: EstimationFrame) -> None:
        est.fetch_state()
        self.output_estimation_results.push_back(est)

    def _run(self) -> None:
        while True:
            eos = self._end_of_sequence.is_set()
            for stamp, acc, gyro in self.input_imu_queue.get_all_and_clear():
                self.odometry.insert_imu(stamp, acc, gyro)
                self._last_imu_stamp = stamp

            self._internal_frames.extend(
                self.input_frame_queue.get_all_and_clear_wait(timeout=0.05))

            # Hold frames back until IMU coverage reaches scan end (reference:
            # async_odometry_estimation.cpp:114-124).
            while self._internal_frames:
                frame = self._internal_frames[0]
                if self.enable_imu and not eos and frame.scan_end_time > self._last_imu_stamp:
                    break
                self._internal_frames.pop(0)
                marginalized: List[EstimationFrame] = []
                with profile_scope("odometry"):
                    est = self.odometry.insert_frame(frame, marginalized)
                if est is not None:
                    est.fetch_state_async()
                    # Publish one frame late: the previous estimate's state
                    # copy was queued behind its own window step, a scan ago.
                    if self._pending_out:
                        self._publish(self._pending_out.pop(0))
                    self._pending_out.append(est)
                if marginalized:
                    self.output_marginalized_frames.insert(marginalized)

            if eos and not self._internal_frames and self.input_frame_queue.empty():
                for e in self._pending_out:
                    self._publish(e)
                self._pending_out = []
                remaining = self.odometry.get_remaining_frames()
                if remaining:
                    self.output_marginalized_frames.insert(remaining)
                self.output_estimation_results.submit_end_of_data()
                self.output_marginalized_frames.submit_end_of_data()
                break
