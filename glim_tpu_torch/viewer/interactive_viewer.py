"""Interactive correction front end: the reference InteractiveViewer's
human-in-the-loop workflow (pick two submaps -> align -> inject a between
factor -> re-solve the graph) as a headless, scriptable surface.

Twin of ``glim_tpu/viewer/interactive_viewer.py`` (reference
src/glim/viewer/interactive_viewer.cpp:405-418, which inserts the modals'
factors into the graph, and interactive/manual_loop_close_modal.cpp:522-574,
a BetweenFactor with information = scale * GICP Hessian):

  * offline: ``InteractiveViewer.open(dump)`` -> ``loop_close(a, b)`` ->
    ``optimize()`` -> ``save()``;
  * live: ``InteractiveViewer(gm, live=True, lock=wrapper._mutex)`` sends
    the correction through the ``request_to_add_between`` slot, which the
    async global-mapping worker applies between inserts
    (``tools/glim_runner.py --commands``).

A live correction runs on the feed thread against a graph the global worker
mutates: the submaps and poses it reads are taken under ``lock`` (the async
wrapper's mutex), the alignment runs outside it, and the factor goes in
only through ``request_to_add_between``.

``execute_command`` turns input errors (``KeyError``, ``ValueError``,
``TypeError``, and ``IndexError`` from a bad submap index) into
``{"ok": false, ...}``; anything else (a failed kernel build or launch, a
CUDA error, a failed worker) propagates.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as CB
from glim_tpu_torch.types import HostCopy, PointBatch, SubMap, to_numpy
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.viewer.interactive_tools import (BundleAdjustment, ManualLoopClose,
                                                     ManualLoopCloseResult, PlaneSelection)

logger = create_module_logger("interactive")

INPUT_ERRORS = (KeyError, ValueError, TypeError, IndexError)


def _cloud(sm: SubMap) -> SubMap:
    """A submap holding the same cloud tensors (references, not copies)."""
    return SubMap(id=sm.id, frame=PointBatch(points=sm.frame.points, mask=sm.frame.mask))


class InteractiveViewer:
    """Correction workflow over a global map.

    ``live=False`` (offline): mutates ``global_mapping`` directly and
    re-optimizes inline (the dump-editing workflow). ``live=True``: reads
    submaps for alignment under ``lock`` and injects the factor through
    ``GlobalMappingCallbacks.request_to_add_between``."""

    def __init__(self, global_mapping=None, live: bool = False,
                 min_inlier_fraction: float = 0.3, lock=None):
        self.gm = global_mapping
        self.live = live
        self.min_inlier_fraction = min_inlier_fraction
        self.lock = lock if lock is not None else threading.RLock()
        self.mlc = ManualLoopClose()

    @classmethod
    def open(cls, dump_path: str, device="cuda", **kwargs) -> "InteractiveViewer":
        from glim_tpu_torch.mapping.global_mapping import GlobalMapping, GlobalMappingParams
        gm = GlobalMapping(GlobalMappingParams(enable_optimization=False), device=device)
        gm.load(dump_path)
        return cls(gm, live=False, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.gm.device

    # -- inspection --

    def submap_summaries(self) -> List[dict]:
        with self.lock:
            subs, poses = list(self.gm.submaps), [np.array(T, np.float64) for T in self.gm.poses]
        counts = to_numpy(torch.stack([sm.frame.mask.sum() for sm in subs])).tolist() \
            if subs else []
        return [dict(id=i, x=float(T[0, 3]), y=float(T[1, 3]), z=float(T[2, 3]), points=int(n))
                for i, (T, n) in enumerate(zip(poses, counts))]

    def factor_summary(self) -> dict:
        gm = self.gm
        with self.lock:
            return dict(submaps=len(gm.submaps),
                        matching=len(getattr(gm, "matching_factors", [])),
                        between=len(getattr(gm, "between_factors", getattr(gm, "f_i", []))))

    # -- correction --

    def _snapshot(self, indices: List[int]):
        """The named submaps' clouds and poses, taken under the lock."""
        with self.lock:
            n = len(self.gm.submaps)
            if not all(0 <= i < n for i in indices):
                raise IndexError(f"submap index out of range: {indices} of {n} submaps")
            return ([_cloud(self.gm.submaps[i]) for i in indices],
                    [np.array(self.gm.poses[i], np.float64) for i in indices])

    def loop_close(self, target: int, source: int, method: str = "GNC",
                   information_scale: float = 1.0, from_current_estimate: bool = True
                   ) -> Optional[ManualLoopCloseResult]:
        """Align two submaps and inject the between factor. Returns the
        alignment, or None when it was rejected (inlier fraction below
        ``min_inlier_fraction``: the stand-in for the modal's accept
        button)."""
        (sm_t, sm_s), (T_t, T_s) = self._snapshot([target, source])
        T_init = np.linalg.inv(T_t) @ T_s if from_current_estimate else None
        res = self.mlc.align(sm_t, sm_s, method=method, T_init=T_init)
        if res.inlier_fraction < self.min_inlier_fraction or \
                not np.all(np.isfinite(res.T_target_source)):
            logger.warning("loop_close %d->%d rejected (inliers %.2f < %.2f)", target, source,
                           res.inlier_fraction, self.min_inlier_fraction)
            return None
        info = information_scale * res.information
        if self.live:
            CB.request_to_add_between(target, source, res.T_target_source, info)
            logger.info("loop_close %d->%d requested on the live graph (inliers %.2f)",
                        target, source, res.inlier_fraction)
        else:
            self.gm.add_between_factor(target, source, res.T_target_source, info)
            self.gm.optimize()
            logger.info("loop_close %d->%d applied + re-optimized (inliers %.2f)",
                        target, source, res.inlier_fraction)
        return res

    def bundle_adjust(self, center, radius: float, mode: str = "plane",
                      submaps: Optional[List[int]] = None, information_scale: float = 1e3,
                      max_points: int = 512) -> dict:
        """Region-pick bundle adjustment (reference BundleAdjustmentModal):
        every submap's points inside the picked sphere, the involved poses
        refined with the plane / point evm factor, and the refined relative
        poses injected as strong between factors (live through
        request_to_add_between, offline applied + re-optimized). Returns the
        region's plane thickness before and after."""
        center = np.asarray(center, np.float64).reshape(3)
        with self.lock:
            n = len(self.gm.submaps)
            picked = [i for i in range(n) if (submaps is None or i in submaps)
                      and self.gm.submaps[i].frame is not None]
        clouds, poses_all = self._snapshot(picked)
        copies = [(HostCopy(c.frame.points), HostCopy(c.frame.mask)) for c in clouds]
        sel: List[PlaneSelection] = []
        involved: List[int] = []
        poses: List[np.ndarray] = []
        for i, T, (pts_c, mask_c) in zip(picked, poses_all, copies):
            pts = pts_c.numpy()[mask_c.numpy()]
            world = pts @ T[:3, :3].T + T[:3, 3]
            keep = np.linalg.norm(world - center, axis=1) < radius
            if keep.sum() >= 30:
                p = pts[keep]
                if len(p) > max_points:
                    p = p[:: len(p) // max_points + 1][:max_points]
                sel.append(PlaneSelection(submap_index=len(involved),
                                          points=p.astype(np.float32)))
                involved.append(i)
                poses.append(T)
        if len(involved) < 2:
            return dict(ok=False, error=f"region intersects {len(involved)} submap(s); "
                                        "bundle adjustment needs at least 2")

        def thickness(Ts):
            world = np.concatenate([s.points @ np.asarray(T)[:3, :3].T + np.asarray(T)[:3, 3]
                                    for s, T in zip(sel, Ts)])
            d = world - world.mean(axis=0)
            ev = np.linalg.eigvalsh(d.T @ d / len(world))
            return float(np.sqrt(max(ev[0], 0.0))) if mode == "plane" \
                else float(np.sqrt(max(ev.sum(), 0.0)))

        before = thickness(poses)
        refined = BundleAdjustment().optimize(clouds, poses, [sel], mode=mode,
                                              device=self.device)
        after = thickness(refined)
        if not all(np.all(np.isfinite(T)) for T in refined) or after > before:
            return dict(ok=False, error="refinement did not improve "
                                        f"flatness ({before:.4f} -> {after:.4f} m)")
        info = np.eye(6) * information_scale
        for a in range(len(involved) - 1):
            Z = np.linalg.inv(refined[a]) @ refined[a + 1]
            if self.live:
                CB.request_to_add_between(involved[a], involved[a + 1], Z, info)
            else:
                self.gm.add_between_factor(involved[a], involved[a + 1], Z, info)
        if not self.live:
            self.gm.optimize()
        logger.info("bundle_adjust (%s) over submaps %s: thickness %.4f -> %.4f m "
                    "(%d between factors %s)", mode, involved, before, after,
                    len(involved) - 1,
                    "requested on the live graph" if self.live else "applied + re-optimized")
        return dict(ok=True, submaps=involved, mode=mode, thickness_before_m=before,
                    thickness_after_m=after, factors_added=len(involved) - 1)

    def optimize(self) -> None:
        if self.live:
            CB.request_to_optimize()
        else:
            self.gm.optimize()

    def find_loops(self, min_overlap: float = 0.2) -> None:
        if self.live:
            CB.request_to_find_overlapping_submaps(min_overlap)
        else:
            self.gm.find_overlapping_submaps(min_overlap)
            self.gm.optimize()

    # -- persistence --

    def save(self, path: str) -> None:
        with self.lock:
            self.gm.save(path)

    def export_ply(self, path: str) -> None:
        from glim_tpu_torch.io.dump import export_ply
        with self.lock:
            points = self.gm.export_points()
        export_ply(path, points)


def backend_flags(gm) -> dict:
    """The back-end's two live toggles, as ``status`` and ``set_enabled``
    read and write them (the runner's viewer stream carries them)."""
    return dict(global_optimization=bool(gm.params.enable_optimization),
                loop_detection=bool(getattr(gm, "loop_search_enabled", True)))


def execute_command(viewer: InteractiveViewer, cmd: dict) -> dict:
    """Execute one JSON command against a viewer (the dispatcher shared by
    glim_runner's --commands poller and watch.py's POST /command).

    Commands: {"cmd": "loop_close", "target": A, "source": B,
               "method"?: "GNC"|"RANSAC", "information_scale"?: s,
               "global_registration"?: bool}
              {"cmd": "bundle_adjust", "center": [x, y, z], "radius": r,
               "mode"?: "plane"|"point", "submaps"?: [ids],
               "information_scale"?: s}
              {"cmd": "optimize"} | {"cmd": "find_loops", "min_overlap"?: f}
              {"cmd": "list"} | {"cmd": "factors"}
              {"cmd": "save", "path": P} | {"cmd": "ply", "path": P}
              {"cmd": "set_enabled", "target": "global_optimization"|
               "loop_detection", "value": bool} | {"cmd": "status"}

    "global_optimization" gates the back-end's per-insert optimize,
    "loop_detection" its implicit-loop / candidate search (reference
    standard_viewer_ui.cpp's enable checkboxes). Playback (pause / resume /
    step) is the runner's poller's, not a command here. Input errors come
    back as {"ok": false, "error": ...}; any other exception propagates."""
    name = cmd.get("cmd")
    try:
        if name == "loop_close":
            res = viewer.loop_close(
                int(cmd["target"]), int(cmd["source"]), method=cmd.get("method", "GNC"),
                information_scale=float(cmd.get("information_scale", 1.0)),
                from_current_estimate=not cmd.get("global_registration", False))
            if res is None:
                return dict(ok=False, error="alignment rejected")
            return dict(ok=True, inlier_fraction=res.inlier_fraction,
                        T_target_source=np.asarray(res.T_target_source).tolist())
        if name == "bundle_adjust":
            return viewer.bundle_adjust(
                cmd["center"], float(cmd["radius"]), mode=cmd.get("mode", "plane"),
                submaps=cmd.get("submaps"),
                information_scale=float(cmd.get("information_scale", 1e3)))
        if name == "optimize":
            viewer.optimize()
            return dict(ok=True)
        if name == "find_loops":
            viewer.find_loops(float(cmd.get("min_overlap", 0.2)))
            return dict(ok=True)
        if name == "list":
            return dict(ok=True, submaps=viewer.submap_summaries())
        if name == "factors":
            return dict(ok=True, **viewer.factor_summary())
        if name == "save":
            viewer.save(cmd["path"])
            return dict(ok=True)
        if name == "ply":
            viewer.export_ply(cmd["path"])
            return dict(ok=True)
        if name == "set_enabled":
            target = cmd.get("target")
            value = bool(cmd.get("value", True))
            gm = viewer.gm
            if target == "global_optimization":
                prev = gm.params.enable_optimization
                gm.params.enable_optimization = value
            elif target == "loop_detection":
                prev = getattr(gm, "loop_search_enabled", True)
                gm.loop_search_enabled = value
            else:
                return dict(ok=False, error=f"unknown target {target!r}")
            logger.info("set_enabled %s -> %s (was %s)", target, value, prev)
            return dict(ok=True, target=target, value=value, previous=prev)
        if name == "status":
            gm = viewer.gm
            with viewer.lock:
                n = len(gm.submaps)
            return dict(ok=True, live=viewer.live, submaps=n, **backend_flags(gm))
        return dict(ok=False, error=f"unknown command {name!r}")
    except INPUT_ERRORS as e:        # interactive input: reported, not fatal
        logger.warning("command %s failed: %s", name, e)
        return dict(ok=False, error=f"{type(e).__name__}: {e}")
