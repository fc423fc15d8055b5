"""Newline-JSON viewer stream: the watchable run artifact.

Twin of ``glim_tpu/viewer/stream_writer.py``: the same line schema and the
same rounding, so one ``watch.html`` replays either package's stream.

The reference's StandardViewer renders the live run in an OpenGL window
(reference: src/glim/viewer/standard_viewer_callbacks.cpp:1-630 — odometry
trajectory, keyframes, submap poses, current scan drawables). A TPU host is
headless, so the equivalent surface here is a *streaming file*: one compact
JSON object per emission with the trajectory tail, corrected submap poses
and a downsampled world-frame slice of the current scan. The bundled
``watch.html`` (same directory) replays the stream in any browser — open the
page, drop the ``.jsonl`` on it, press play — and ``tools/watch.py`` serves
both with live polling for tail -f style viewing of an in-progress run.

Line schema (all floats rounded for compactness):
  {"t": stamp, "seq": n,
   "odom": [[x, y, z, qx, qy, qz, qw], ...]   # poses since the last line
   "submaps": [[x, y, z, qx, qy, qz, qw], ...]  # ALL current submap poses
   "scan": [[x, y, z], ...],                  # current scan, world frame
   "clouds": {"id": [[x, y, z], ...]},        # submap clouds, ORIGIN frame
                                              # (sent once, on creation)
   "factors": [[i, j, "m"|"b"], ...],         # global factor edges by
                                              # submap index (on change):
                                              # m=matching-cost, b=between
   "stats": {"frames": n, "keyframes": n, "submaps": n, "mb": float}}

The clouds + corrected submap poses give the replaying page a persistent
world map (the reference viewer's submap drawables); the factor list draws
the pose graph for inspection/picking (interactive_viewer.cpp's factor
lines).
"""

from __future__ import annotations

import json
import os
import threading
from typing import List, Optional

import numpy as np

from glim_tpu_torch.utils.config import se3_to_tum


class ViewerStream:
    """Append-only .jsonl writer; thread-safe, crash-tolerant (each line is
    self-contained — a truncated tail only loses the last emission)."""

    def __init__(self, path: str, scan_budget: int = 1024):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        self._f = open(path, "w", buffering=1)   # line-buffered
        self._lock = threading.Lock()
        self._seq = 0
        self.scan_budget = scan_budget
        self.path = path

    def emit(self, stamp: float, odom_poses: List[np.ndarray],
             submap_poses: List[np.ndarray],
             scan_world: Optional[np.ndarray], stats: dict,
             clouds: Optional[dict] = None,
             factors: Optional[list] = None) -> None:
        line = dict(
            t=round(float(stamp), 4),
            seq=self._seq,
            odom=[[round(float(v), 4) for v in se3_to_tum(T)]
                  for T in odom_poses],
            submaps=[[round(float(v), 4) for v in se3_to_tum(T)]
                     for T in submap_poses],
            stats=stats,
        )
        if scan_world is not None and len(scan_world):
            pts = np.asarray(scan_world, np.float64)
            if len(pts) > self.scan_budget:
                pts = pts[:: max(1, len(pts) // self.scan_budget)]
            line["scan"] = np.round(pts, 3).tolist()
        if clouds:
            line["clouds"] = {str(k): np.round(np.asarray(v, np.float64),
                                               3).tolist()
                              for k, v in clouds.items()}
        if factors is not None:
            line["factors"] = [[int(i), int(j), str(t)]
                               for i, j, t in factors]
        with self._lock:
            self._seq += 1
            self._f.write(json.dumps(line) + "\n")

    def close(self) -> None:
        with self._lock:
            self._f.close()
