"""Offline map editing: open / merge / re-optimize / export dumps.

Twin of ``glim_tpu/viewer/offline_viewer.py`` (the reference's
``OfflineViewer``, src/glim/viewer/offline_viewer.cpp:22-120: open a map,
merge sessions, re-run GlobalMapping offline, save, export PLY) as a
headless, scriptable API over the port's ``GlobalMapping`` on ``device``
(the card by default). A merge that finds no automatic overlap between the
sessions aligns the closest cross-session pair with
``ManualLoopClose.align`` (FPFH + GNC, then GICP: ``nn_search`` on the
card).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from glim_tpu_torch.io.dump import export_ply
from glim_tpu_torch.mapping.global_mapping import GlobalMapping, GlobalMappingParams
from glim_tpu_torch.utils.config import Config
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.viewer.interactive_tools import ManualLoopClose

logger = create_module_logger("offline")


class OfflineViewer:
    def __init__(self, params: Optional[GlobalMappingParams] = None,
                 config=None, device="cuda"):
        self.params = params or GlobalMappingParams(enable_optimization=False)
        self.global_mapping = GlobalMapping(self.params, device=device)
        self._sessions = 0
        # Rendering hints (reference config_viewer.json:23-39
        # "interactive_viewer" section); exported alongside PLY / dump saves
        # for external renderers, like StandardViewer.render_hints.
        self._hints_from_config = config is not None
        self._load_hints(config)

    def _load_hints(self, config) -> None:
        g = (lambda k, d: config.param("interactive_viewer", k, d)) if config \
            else (lambda k, d: d)
        self.render_hints = dict(
            default_z_range=list(g("default_z_range", [-2.0, 4.0])),
            point_size=float(g("point_size", 0.025)),
            point_size_metric=bool(g("point_size_metric", True)),
            point_shape_circle=bool(g("point_shape_circle", True)),
            points_alpha=float(g("points_alpha", 0.5)),
            factors_alpha=float(g("factors_alpha", 0.5)),
            enable_partial_rendering=bool(g("enable_partial_rendering", False)),
            partial_rendering_budget=int(g("partial_rendering_budget", 1024)),
            viewer_width=int(g("viewer_width", 2560)),
            viewer_height=int(g("viewer_height", 1440)),
        )

    def _write_hints(self, dir_path: str) -> None:
        os.makedirs(dir_path, exist_ok=True)
        with open(os.path.join(dir_path, "render_hints.json"), "w") as f:
            json.dump(self.render_hints, f, indent=2)

    def open_map(self, dump_path: str) -> None:
        # Adopt the dump's config snapshot's viewer hints if this viewer was
        # constructed without a config (reference: OfflineViewer re-reads
        # GlobalConfig from dump/config, offline_viewer.cpp:82-120).
        if not self._hints_from_config:
            snap = os.path.join(dump_path, "config", "config_viewer.json")
            if os.path.exists(snap):
                self._load_hints(Config(snap))
        self.global_mapping.load(dump_path, session_offset=self._sessions)
        self._sessions += 1

    def merge_map(self, dump_path: str) -> Optional[tuple]:
        """Load an additional session and connect it: the automatic overlap
        search first; without a cross-session factor, the manual alignment
        of the closest cross pair (a between factor when its inlier
        fraction exceeds 0.3; reference merge workflow, docs/merge.md).
        Returns the aligned pair, or None when no alignment ran."""
        base = len(self.global_mapping.submaps)
        self.open_map(dump_path)
        if base == 0:
            return None
        self.global_mapping.find_overlapping_submaps(self.params.min_implicit_loop_overlap)
        anchored = any((i < base) != (j < base)
                       for i, j in self.global_mapping.matching_factors)
        if anchored:
            return None
        logger.info("no automatic overlap between sessions; trying manual "
                    "loop close between closest submaps")
        i, j = self._closest_cross_pair(base)
        res = ManualLoopClose().align(self.global_mapping.submaps[i],
                                      self.global_mapping.submaps[j], method="GNC")
        if res.inlier_fraction > 0.3:
            self.global_mapping.between_factors.append(
                (i, j, res.T_target_source, np.eye(6) * 100.0))
        return i, j

    def _closest_cross_pair(self, base: int):
        gm = self.global_mapping
        best = (0, base)
        best_d = np.inf
        for i in range(base):
            for j in range(base, len(gm.submaps)):
                d = np.linalg.norm(gm.poses[i][:3, 3] - gm.poses[j][:3, 3])
                if d < best_d:
                    best_d = d
                    best = (i, j)
        return best

    def optimize(self, iterations: int = 1) -> None:
        """Re-run global optimization offline (reference :82-120)."""
        for _ in range(iterations):
            self.global_mapping.optimize()

    def save(self, path: str) -> None:
        self.global_mapping.save(path)
        self._write_hints(path)

    def export_ply(self, path: str) -> int:
        """Write the map's points as a PLY; returns their count."""
        pts = self.global_mapping.export_points()
        export_ply(path, pts)
        self._write_hints(os.path.dirname(os.path.abspath(path)))
        logger.info("exported %d points to %s", len(pts), path)
        return len(pts)
