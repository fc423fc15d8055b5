"""Headless standard viewer: real-time state aggregation + export.

Twin of ``glim_tpu/viewer/standard_viewer.py`` (reference:
src/glim/viewer/standard_viewer.cpp:42-198, the callbacks in
standard_viewer_callbacks.cpp, memory accounting in
standard_viewer_mem.cpp:15-59): it attaches to the callback slots, keeps
the odometry trajectory, keyframe / submap poses and a byte count of the
frame data, and exposes them as ``snapshot()``, a periodic log line, the
run stream (``viewer/stream_writer.py``, replayed by ``viewer/watch.html``)
and a TUM export at ``at_exit``.

Device reads go through ``HostCopy``: an odometry frame is taken in one
frame after it is announced (its state copy, and its scan for a stream
line, start when it is announced and have landed by then), and a new
submap's cloud is copied when it is created and read at the next stream
line. The odometry worker never waits on the card for the viewer;
``at_exit`` takes in the last frame.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks, SubMappingCallbacks
from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks
from glim_tpu_torch.types import HostCopy
from glim_tpu_torch.utils.config import se3_to_tum
from glim_tpu_torch.utils.extension_module import ExtensionModule, global_config
from glim_tpu_torch.utils.logging import create_module_logger, get_ringbuffer_lines
from glim_tpu_torch.utils.registry import register_module
from glim_tpu_torch.utils.trajectory_manager import TrajectoryManager
from glim_tpu_torch.viewer.stream_writer import ViewerStream

logger = create_module_logger("viewer")


def _batch_bytes(batch) -> int:
    """Byte count of a PointBatch's arrays (reference:
    standard_viewer_mem.cpp:34-59 attribute layout)."""
    if batch is None:
        return 0
    total = 0
    for name in ("points", "mask", "times", "intensities", "covs", "normals"):
        a = getattr(batch, name, None)
        if a is not None:
            total += a.numel() * a.element_size()
    return total


def _masked_copy(batch) -> Optional[tuple]:
    """(HostCopy of the points, HostCopy of the mask) of a batch, or None."""
    if batch is None or batch.points is None:
        return None
    return HostCopy(batch.points), HostCopy(batch.mask)


def _thinned(copies: tuple, budget: int) -> np.ndarray:
    """The valid points of a ``_masked_copy``, every k-th past ``budget``."""
    pts = copies[0].numpy()[copies[1].numpy()]
    if len(pts) > budget:
        pts = pts[:: max(1, len(pts) // budget)]
    return pts


class StandardViewer(ExtensionModule):
    def __init__(self, report_interval: float = 10.0, config=None, stream_path=None,
                 stream_interval=None):
        self.report_interval = report_interval
        # Rendering hints (reference standard_viewer.cpp:70-100 GUI knobs),
        # carried in snapshot() for external renderers.
        g = (lambda k, d: config.param("standard_viewer", k, d)) if config \
            else (lambda k, d: d)
        self.render_hints = dict(
            default_z_range=list(g("default_z_range", [-2.0, 4.0])),
            point_size=float(g("point_size", 0.025)),
            point_size_metric=bool(g("point_size_metric", True)),
            point_shape_circle=bool(g("point_shape_circle", True)),
            points_alpha=float(g("points_alpha", 1.0)),
            factors_alpha=float(g("factors_alpha", 1.0)),
            enable_partial_rendering=bool(g("enable_partial_rendering", False)),
            partial_rendering_budget=int(g("partial_rendering_budget", 1024)),
            viewer_width=int(g("viewer_width", 2560)),
            viewer_height=int(g("viewer_height", 1440)),
        )
        self._lock = threading.Lock()
        self.trajectory = TrajectoryManager()
        self.odom_poses: List[np.ndarray] = []
        self.odom_stamps: List[float] = []
        self.submap_poses: List[np.ndarray] = []
        self.num_keyframes = 0
        self.num_marginalized = 0
        self.frame_bytes = 0
        self.last_report = time.time()
        self.stream = None
        sp = stream_path if stream_path is not None else g("stream_path", None)
        if sp:
            self.stream = ViewerStream(str(sp), scan_budget=int(g("stream_scan_budget", 1024)))
        self.stream_interval = float(stream_interval if stream_interval is not None
                                     else g("stream_interval", 1.0))
        self._last_stream = 0.0
        self._stream_odom_mark = 0
        # The announced frame not yet taken in: (frame, scan copies or None).
        self._pending_frame: Optional[tuple] = None
        # Submap clouds (origin frame) for the next stream line, as copies.
        self._pending_clouds: Dict[int, tuple] = {}
        self._factors: List[list] = []
        self._factors_dirty = False
        self.cloud_budget = int(g("stream_cloud_budget", 1200))
        self._handles = []
        self._wire()

    def _wire(self) -> None:
        O = OdometryEstimationCallbacks
        S = SubMappingCallbacks
        G = GlobalMappingCallbacks
        add = lambda slot, fn: self._handles.append((slot, slot.add(fn)))  # noqa: E731
        add(O.on_new_frame, self._on_new_frame)
        add(O.on_update_keyframes, self._on_update_keyframes)
        add(O.on_marginalized_frames, self._on_marginalized)
        add(S.on_new_submap, self._on_new_submap)
        add(G.on_update_submaps, self._on_update_submaps)
        add(G.on_smoother_update, self._on_smoother_update)

    def detach(self) -> None:
        for slot, h in self._handles:
            slot.remove(h)
        self._handles = []

    # -- callbacks --

    def _on_new_frame(self, frame) -> None:
        frame.fetch_state_async()
        scan = None
        if self.stream is not None and time.time() - self._last_stream >= self.stream_interval:
            self._last_stream = time.time()
            scan = _masked_copy(frame.frame)
        prev, self._pending_frame = self._pending_frame, (frame, scan)
        if prev is not None:
            self._take_frame(*prev)

    def _take_frame(self, frame, scan) -> None:
        """Record an announced frame (its state copy has landed), and write
        its stream line if one was due when it was announced."""
        frame.fetch_state()
        T = frame.T_world_sensor()
        with self._lock:
            self.odom_poses.append(T)
            self.odom_stamps.append(frame.stamp)
            self.trajectory.add_odom(frame.stamp, T)
            self.frame_bytes += _batch_bytes(frame.frame)
        if scan is not None:
            self._emit_stream(frame, T, scan)
        if time.time() - self.last_report > self.report_interval:
            self.last_report = time.time()
            logger.info("viewer: %d frames, %d keyframes, %d submaps, ~%.1f MB frame data",
                        len(self.odom_poses), self.num_keyframes, len(self.submap_poses),
                        self.frame_bytes / 1e6)

    def _on_update_keyframes(self, keyframes) -> None:
        with self._lock:
            self.num_keyframes += len(keyframes)

    def _on_marginalized(self, frames) -> None:
        with self._lock:
            self.num_marginalized += len(frames)

    def _on_new_submap(self, submap) -> None:
        # One-shot origin-frame cloud for the stream's persistent map layer.
        cloud = _masked_copy(submap.frame) if self.stream is not None else None
        with self._lock:
            self.submap_poses.append(np.asarray(submap.T_world_origin))
            if cloud is not None:
                self._pending_clouds[int(submap.id)] = cloud

    def _on_smoother_update(self, mapping, *_args) -> None:
        """Capture the global factor graph for the stream's pose-graph layer
        (reference interactive_viewer factor lines)."""
        pairs = [[int(t), int(s), "m"] for t, s in getattr(mapping, "matching_factors", [])]
        pairs += [[int(bf[0]), int(bf[1]), "b"] for bf in getattr(mapping, "between_factors", [])]
        # Pose-graph back-end: consecutive = odometry chain ("b"),
        # non-consecutive = accepted loop factors ("m").
        for i, j, _h in zip(getattr(mapping, "f_i", []), getattr(mapping, "f_j", []),
                            getattr(mapping, "f_huber", [])):
            pairs.append([int(i), int(j), "b" if abs(int(j) - int(i)) == 1 else "m"])
        with self._lock:
            if pairs != self._factors:
                self._factors = pairs
                self._factors_dirty = True

    def _on_update_submaps(self, submaps) -> None:
        with self._lock:
            self.submap_poses = [np.asarray(s.T_world_origin) for s in submaps]
            if submaps and self.odom_stamps:
                last = submaps[-1]
                if last.frames:
                    self.trajectory.update_anchor(last.frames[-1].stamp,
                                                  last.T_world_origin @ last.T_origin_endpoint_R)

    def _emit_stream(self, frame, T: np.ndarray, scan: tuple) -> None:
        """One stream line: the odometry poses since the last line, every
        (corrected) submap pose, the scan in the world frame."""
        pts = _thinned(scan, self.stream.scan_budget)
        scan_world = (T[:3, :3] @ pts.T).T + T[:3, 3]
        with self._lock:
            odom_new = self.odom_poses[self._stream_odom_mark:]
            self._stream_odom_mark = len(self.odom_poses)
            submaps = [S.copy() for S in self.submap_poses]
            stats = dict(frames=len(self.odom_poses), keyframes=self.num_keyframes,
                         submaps=len(self.submap_poses), mb=round(self.frame_bytes / 1e6, 1))
            pending, self._pending_clouds = self._pending_clouds, {}
            factors = list(self._factors) if self._factors_dirty else None
            self._factors_dirty = False
        clouds = {k: _thinned(c, self.cloud_budget) for k, c in pending.items()}
        self.stream.emit(frame.stamp, odom_new, submaps, scan_world, stats,
                         clouds=clouds or None, factors=factors)

    # -- outputs --

    def snapshot(self) -> Dict:
        with self._lock:
            return dict(
                odom_poses=[T.copy() for T in self.odom_poses],
                odom_stamps=list(self.odom_stamps),
                submap_poses=[T.copy() for T in self.submap_poses],
                num_keyframes=self.num_keyframes,
                num_marginalized=self.num_marginalized,
                T_world_odom=self.trajectory.get_T_world_odom(),
                log_tail=get_ringbuffer_lines(32),
                render_hints=dict(self.render_hints),
            )

    def flush(self) -> None:
        """Take in the last announced frame."""
        prev, self._pending_frame = self._pending_frame, None
        if prev is not None:
            self._take_frame(*prev)

    def at_exit(self, dump_path: str) -> None:
        self.flush()
        os.makedirs(dump_path, exist_ok=True)
        with self._lock:
            with open(os.path.join(dump_path, "viewer_odom.txt"), "w") as f:
                for t, T in zip(self.odom_stamps, self.odom_poses):
                    v = se3_to_tum(T)
                    f.write(f"{t:.9f} " + " ".join(f"{x:.6f}" for x in v) + "\n")
        if self.stream is not None:
            self.stream.close()


@register_module("extension", "standard_viewer")
def create_extension_module(*args, **kwargs):
    return StandardViewer(config=global_config("config_viewer"))
