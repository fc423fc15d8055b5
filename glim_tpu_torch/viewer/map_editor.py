"""Point-level map editor (headless API).

Twin of ``glim_tpu/viewer/map_editor.py`` (reference ``MapEditor`` +
``PointsSelector``: src/glim/viewer/map_editor.cpp:19-24,
viewer/editor/points_selector.cpp:8-56, editor/map_cell.cpp's 2 m cells):
cell-partitioned map points, radius / box selection, statistical outlier
removal, min-cut and region-growing object segmentation, deletion, and the
edited submaps written back to a dump. Selections are index sets over the
flattened map, so front ends (CLI, notebook, rviz) can drive them.

The map is opened onto ``device`` (the card by default); the flattened
world-frame points live on the host for the cell index and the box and
radius tests, and the kNN, covariances and segmentation run on the device.

The outlier selection examines every point of the map, with an exact kNN
(``ops/knn.knn_self_boxed``: each query tile against the points near it,
isolated points against the whole map, tiles sized to a memory budget).
(The JAX package copies only the first ``cap = 131072`` points, so a
default dump's later submaps are never examined.)
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from glim_tpu_torch.io.dump import load_dump, save_dump
from glim_tpu_torch.ops import covariance as cov_ops
from glim_tpu_torch.ops import knn
from glim_tpu_torch.ops import segmentation as seg
from glim_tpu_torch.types import PointBatch, SubMap, to_numpy, upload
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("editor")

CELL_SIZE = 2.0  # reference map_cell.cpp cell size
# The outlier kNN searches each query tile against the points within this
# of its bounding box (m); a point with fewer than k neighbours that near
# is searched against the whole map.
OUTLIER_RADIUS = 1.0


class MapEditor:
    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.submaps: List[SubMap] = []
        self.poses: List[np.ndarray] = []
        self._factors = None
        # Flattened world-frame view: (N, 3) + (N,) submap index + local index.
        self.points = np.zeros((0, 3))
        self.owner = np.zeros(0, np.int32)
        self.local_idx = np.zeros(0, np.int32)
        self.selected: Set[int] = set()
        self.deleted: Set[int] = set()
        self.cells: Dict[Tuple[int, int, int], np.ndarray] = {}

    # -- IO --

    def open(self, dump_path: str) -> None:
        self.submaps, self.poses, self._factors = load_dump(dump_path, self.device)
        pts, owner, lidx = [], [], []
        for k, (sm, T) in enumerate(zip(self.submaps, self.poses)):
            m = to_numpy(sm.frame.mask)
            local = to_numpy(sm.frame.points)[m]
            world = (np.asarray(T)[:3, :3] @ local.T).T + np.asarray(T)[:3, 3]
            pts.append(world)
            owner.append(np.full(len(world), k, np.int32))
            lidx.append(np.where(m)[0].astype(np.int32))
        self.points = np.concatenate(pts) if pts else np.zeros((0, 3))
        self.owner = np.concatenate(owner) if owner else np.zeros(0, np.int32)
        self.local_idx = np.concatenate(lidx) if lidx else np.zeros(0, np.int32)
        self._rebuild_cells()
        logger.info("map editor: %d points from %d submaps", len(self.points),
                    len(self.submaps))

    def save(self, dump_path: str) -> None:
        """Write the edited submaps back (deleted and selected points
        removed; an edited cloud keeps points and mask, as in JAX)."""
        deleted_by_sm: Dict[int, Set[int]] = {}
        for g in self.deleted | self.selected:
            deleted_by_sm.setdefault(int(self.owner[g]), set()).add(int(self.local_idx[g]))
        for k, sm in enumerate(self.submaps):
            dels = deleted_by_sm.get(k)
            if not dels:
                continue
            mask = to_numpy(sm.frame.mask).copy()
            mask[sorted(dels)] = False
            sm.frame = PointBatch(points=sm.frame.points,
                                  mask=upload(mask, sm.frame.points.device))
        save_dump(dump_path, self.submaps, self.poses, factors=self._factors)

    # -- cells (reference map_cell partitioning) --

    def _rebuild_cells(self) -> None:
        """Point indices by 2 m cell, ascending within a cell."""
        keys = np.floor(self.points / CELL_SIZE).astype(np.int64)
        if not len(keys):
            self.cells = {}
            return
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        order = np.argsort(inv, kind="stable")
        bounds = np.cumsum(np.bincount(inv, minlength=len(uniq)))[:-1]
        self.cells = {tuple(int(v) for v in key): idx
                      for key, idx in zip(uniq, np.split(order, bounds))}

    def cells_near(self, center: np.ndarray, radius: float) -> np.ndarray:
        """Candidate point indices from cells within radius of center."""
        c0 = np.floor((np.asarray(center) - radius) / CELL_SIZE).astype(int)
        c1 = np.floor((np.asarray(center) + radius) / CELL_SIZE).astype(int)
        out = []
        for x in range(c0[0], c1[0] + 1):
            for y in range(c0[1], c1[1] + 1):
                for z in range(c0[2], c1[2] + 1):
                    idx = self.cells.get((x, y, z))
                    if idx is not None:
                        out.append(idx)
        return np.concatenate(out) if out else np.zeros(0, np.int64)

    # -- selection --

    def select_radius(self, center, radius: float) -> int:
        cand = self.cells_near(center, radius)
        if not len(cand):
            return 0
        d = np.linalg.norm(self.points[cand] - np.asarray(center), axis=1)
        sel = cand[d < radius]
        self.selected.update(int(i) for i in sel)
        return len(sel)

    def select_box(self, T_box: np.ndarray, extents) -> int:
        """Gizmo-box selection: T_box places a box of half-extents `extents`."""
        Ti = np.linalg.inv(np.asarray(T_box))
        local = (Ti[:3, :3] @ self.points.T).T + Ti[:3, 3]
        inside = np.all(np.abs(local) <= np.asarray(extents), axis=1)
        sel = np.where(inside)[0]
        self.selected.update(int(i) for i in sel)
        return len(sel)

    def select_outliers(self, k: int = 10, std_mul: float = 1.0) -> int:
        """Statistical outlier selection over every point of the map: a
        point is selected when its mean distance to its k nearest (itself
        included) is not below the map's mean + std_mul x std. The kNN is
        exact (``knn_self_boxed``)."""
        n = len(self.points)
        if n == 0:
            return 0
        pts = upload(self.points.astype(np.float32), self.device)
        mask = torch.ones(n, dtype=torch.bool, device=self.device)
        _, d2 = knn.knn_self_boxed(pts, k, OUTLIER_RADIUS)
        keep = cov_ops.outlier_mask(d2, mask, std_mul)
        bad = np.where(~to_numpy(keep))[0]
        self.selected.update(int(i) for i in bad)
        return len(bad)

    def select_segmentation(self, seed_point, method: str = "min_cut",
                            radius: float = 10.0, cap: int = 16384) -> int:
        """Object selection by segmentation around a clicked point (the
        first ``cap`` candidates of the cells within ``radius``)."""
        cand = self.cells_near(seed_point, radius)
        if not len(cand):
            return 0
        cand = cand[:cap]
        n = len(cand)
        pts = np.zeros((cap, 3), np.float32)
        pts[:n] = self.points[cand]
        mask = np.zeros(cap, bool)
        mask[:n] = True
        d = np.linalg.norm(pts[:n] - np.asarray(seed_point), axis=1)
        seed_local = int(np.argmin(d))
        pts_d, mask_d = upload(pts, self.device), upload(mask, self.device)
        if method == "region_growing":
            nbr, _ = knn.knn_self(pts_d, mask_d, 10)
            _, normals = cov_ops.estimate_covariances(pts_d, mask_d, nbr, "plane")
            lab = seg.region_growing(pts_d, normals, mask_d, seed_local)
        else:
            lab = seg.min_cut(pts_d, mask_d, seed_local)
        sel = cand[np.where(lab[:n])[0]]
        self.selected.update(int(i) for i in sel)
        return len(sel)

    def clear_selection(self) -> None:
        self.selected.clear()

    def num_selected(self) -> int:
        return len(self.selected)

    def delete_selected(self) -> int:
        """Mark selected points deleted (persisted on save; indices refer to
        the original flattened layout so owner/local maps stay aligned)."""
        n = len(self.selected)
        self.deleted |= self.selected
        self.selected = set()
        return n
