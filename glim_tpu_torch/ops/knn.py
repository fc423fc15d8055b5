"""Brute-force and Morton-banded k-nearest-neighbor search.

Twin of ``glim_tpu/ops/knn.py``: distances by the expansion
``|q|^2 + |t|^2 - 2 q.t`` tile by tile over query rows, and an approximate
self-kNN that searches a band of the Z-order-sorted cloud. ``lax.top_k``
breaks ties toward the lower index and ``torch.topk`` promises no order, so
the k smallest are taken from a stable ascending sort.
"""

from __future__ import annotations

from typing import Tuple

import torch

_TILE = 1024
_INT32_MAX = 2**31 - 1


def _k_smallest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise k smallest values, ties to the lower index (lax.top_k order)."""
    if k == 1:
        v, i = torch.min(d2, dim=1, keepdim=True)    # first minimum
        return v, i
    s = torch.sort(d2, dim=1, stable=True)
    return s.values[:, :k], s.indices[:, :k]


def knn_search(queries: torch.Tensor, query_mask: torch.Tensor,
               targets: torch.Tensor, target_mask: torch.Tensor,
               k: int, exclude_self: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest targets per query -> (indices (Q, k) int32, sq_dists (Q, k)).
    Invalid queries get index 0 / +inf."""
    Q = queries.shape[0]
    N = targets.shape[0]
    t_sq = torch.sum(targets * targets, dim=-1)
    t_invalid = torch.where(target_mask, 0.0, float("inf"))
    idx_out, d2_out = [], []
    for base in range(0, Q, _TILE):
        qt = queries[base:base + _TILE]
        q_sq = torch.sum(qt * qt, dim=-1, keepdim=True)
        d2 = q_sq + t_sq[None, :] - 2.0 * (qt @ targets.T)
        d2 = torch.clamp(d2, min=0.0) + t_invalid[None, :]
        if exclude_self:
            rows = torch.arange(qt.shape[0], device=qt.device)[:, None] + base
            cols = torch.arange(N, device=qt.device)[None, :]
            d2 = torch.where(cols == rows, float("inf"), d2)
        v, i = _k_smallest(d2, k)
        idx_out.append(i)
        d2_out.append(v)
    idx = torch.cat(idx_out).to(torch.int32)
    d2 = torch.cat(d2_out)
    d2 = torch.where(query_mask[:, None], d2, float("inf"))
    idx = torch.where(query_mask[:, None], idx, 0)
    return idx, d2


def _morton_expand10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_code(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 voxel coords -> (...,) int32 Morton (Z-order) code,
    each axis offset-shifted into [0, 1024) (the offset wraps in int32, as
    the JAX version's does)."""
    c = (coords.to(torch.int64) + 512 + 2**31) % 2**32 - 2**31
    c = torch.clamp(c, 0, 1023)
    return (_morton_expand10(c[..., 0])
            | (_morton_expand10(c[..., 1]) << 1)
            | (_morton_expand10(c[..., 2]) << 2)).to(torch.int32)


def knn_banded(points: torch.Tensor, mask: torch.Tensor, k: int,
               window: int = 64, cell=0.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate self-kNN: sort along a Z-order curve, then search only a
    +-window/2 band of the sorted order (self-match included)."""
    C = points.shape[0]
    dev = points.device
    coords = torch.floor(points / cell).to(torch.int32)
    key = torch.where(mask, morton_code(coords), _INT32_MAX)
    order = torch.sort(key, stable=True).indices
    pts_s = points[order]

    offs = torch.arange(window, device=dev) - window // 2          # includes 0
    idx = torch.arange(C, device=dev)[:, None] + offs[None, :]      # (C, W)
    idx_c = torch.clamp(idx, 0, C - 1)
    cand = pts_s[idx_c]                                             # (C, W, 3)
    # Valid points are an exact prefix of the sorted order.
    n_valid = mask.sum()
    cand_ok = (idx >= 0) & (idx < torch.clamp(n_valid, max=C))
    diff = cand - pts_s[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(cand_ok, d2, float("inf"))

    d2k, jsel = _k_smallest(d2, k)                                  # within band
    nbr = order[torch.gather(idx_c, 1, jsel)]                       # original indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(C, device=dev)
    nbr = nbr[inv]
    d2k = d2k[inv]
    d2k = torch.where(mask[:, None], d2k, float("inf"))
    nbr = torch.where(mask[:, None], nbr, 0)
    return nbr.to(torch.int32), d2k


def knn_self(points: torch.Tensor, mask: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN graph of a cloud against itself, the self-match included
    as neighbour 0."""
    return knn_search(points, mask, points, mask, k=k, exclude_self=False)
