"""Point-cloud segmentation: min-cut and region growing.

Twin of ``glim_tpu/ops/segmentation.py`` (the gtsam_points segmentation
the reference's map editor uses for object removal: ``min_cut``,
``region_growing_init`` / ``_update`` with MinCutParams /
RegionGrowingParams, src/glim/viewer/editor/points_selector.cpp).

- Region growing runs on the cloud's device as label propagation over the
  kNN graph: each round relabels the whole frontier with one masked gather,
  and asks the host once (``torch.equal``) whether the region grew.
- Min-cut builds its capacities from the device kNN and solves max-flow on
  the host with scipy (editor tooling, not a hot path), as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from glim_tpu_torch.ops.knn import knn_self
from glim_tpu_torch.types import to_numpy


@dataclass
class RegionGrowingParams:
    k_neighbors: int = 10
    angle_threshold: float = 0.35        # rad between normals
    distance_threshold: float = 0.5      # m
    max_iterations: int = 100


@dataclass
class MinCutParams:
    k_neighbors: int = 10
    distance_sigma: float = 0.25
    foreground_radius: float = 3.0       # points beyond this lean background
    background_weight: float = 0.2


@dataclass
class RegionGrowingContext:
    """Incremental region-growing state (region_growing_init/update API)."""

    labels: torch.Tensor       # (C,) bool: the grown region
    neighbors: torch.Tensor    # (C, k)
    ok: torch.Tensor           # (C, k): edge admissibility
    converged: bool = False


def region_growing_init(points: torch.Tensor, normals: torch.Tensor,
                        mask: torch.Tensor, seed_index: int,
                        params: Optional[RegionGrowingParams] = None
                        ) -> RegionGrowingContext:
    p = params or RegionGrowingParams()
    nbr, d2 = knn_self(points, mask, p.k_neighbors)
    nbr = nbr.long()
    cos_thresh = float(np.cos(p.angle_threshold))
    n_dot = torch.abs(torch.einsum("ci,cki->ck", normals, normals[nbr]))
    ok = (mask[:, None] & mask[nbr] & (d2 < p.distance_threshold ** 2)
          & (n_dot > cos_thresh))
    labels = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    labels[seed_index] = True
    return RegionGrowingContext(labels=labels, neighbors=nbr, ok=ok)


def _propagate(labels: torch.Tensor, neighbors: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return labels | torch.any(labels[neighbors] & ok, dim=-1)


def region_growing_update(ctx: RegionGrowingContext,
                          rounds: int = 8) -> RegionGrowingContext:
    """Run up to ``rounds`` propagation rounds; sets ``converged`` when the
    region stops growing (one host read a round)."""
    labels = ctx.labels
    for _ in range(rounds):
        new = _propagate(labels, ctx.neighbors, ctx.ok)
        if torch.equal(new, labels):
            return RegionGrowingContext(labels=new, neighbors=ctx.neighbors,
                                        ok=ctx.ok, converged=True)
        labels = new
    return RegionGrowingContext(labels=labels, neighbors=ctx.neighbors,
                                ok=ctx.ok, converged=False)


def region_growing(points, normals, mask, seed_index,
                   params: Optional[RegionGrowingParams] = None) -> np.ndarray:
    """Run region growing to convergence; returns the host bool mask."""
    p = params or RegionGrowingParams()
    ctx = region_growing_init(points, normals, mask, seed_index, p)
    for _ in range(p.max_iterations):
        ctx = region_growing_update(ctx)
        if ctx.converged:
            break
    return to_numpy(ctx.labels)


def min_cut(points: torch.Tensor, mask: torch.Tensor, seed_index: int,
            params: Optional[MinCutParams] = None) -> np.ndarray:
    """Foreground / background min-cut segmentation around a seed point.

    Returns a host bool foreground mask over the padded cloud."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow

    p = params or MinCutParams()
    nbr, d2 = knn_self(points, mask, p.k_neighbors)
    pts = to_numpy(points)
    msk = to_numpy(mask)
    nbrn = to_numpy(nbr)
    d2n = to_numpy(d2)
    C = len(pts)
    seed_pt = pts[seed_index]

    # Edge capacities: Gaussian in distance (the smoothness term), scaled to
    # integers for scipy's integer max-flow.
    SCALE = 1000.0
    rows, cols, caps = [], [], []
    w_edge = np.exp(-d2n / (2 * p.distance_sigma ** 2))
    for k in range(nbrn.shape[1]):
        j = nbrn[:, k]
        valid = msk & msk[j] & (j != np.arange(C)) & np.isfinite(d2n[:, k])
        rows.append(np.arange(C)[valid])
        cols.append(j[valid])
        caps.append((w_edge[valid, k] * SCALE).astype(np.int32) + 1)
    # Terminal edges (PCL-style min-cut priors): the source feeds the
    # seed's neighbourhood with a capacity decaying with distance (the
    # foreground prior), and every point drains to the sink with a capacity
    # growing with distance (the background prior).
    dist_seed = np.linalg.norm(pts - seed_pt, axis=1)
    sigma_f = max(p.foreground_radius, 1e-6) / 2.0
    fg_w = np.exp(-(dist_seed / sigma_f) ** 2)
    bg = p.background_weight * (dist_seed / max(p.foreground_radius, 1e-6))
    vr = np.where(msk)[0]
    rows.append(np.full(len(vr), C))
    cols.append(vr)
    caps.append((fg_w[vr] * SCALE).astype(np.int32) + 1)
    rows.append(np.asarray([C]))
    cols.append(np.asarray([seed_index]))
    caps.append(np.asarray([np.int32(1e7)]))
    rows.append(vr)
    cols.append(np.full(len(vr), C + 1))
    caps.append((bg[vr] * SCALE).astype(np.int32) + 1)

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    caps = np.concatenate(caps)
    graph = coo_matrix((caps, (rows, cols)), shape=(C + 2, C + 2)).tocsr()
    res = maximum_flow(graph, C, C + 1)
    # Foreground: reachable from the source in the residual graph.
    residual = graph - res.flow
    reach, _ = breadth_first_order(residual > 0, C, directed=True,
                                   return_predecessors=True)
    fg = np.zeros(C + 2, bool)
    fg[reach] = True
    return fg[:C] & msk
