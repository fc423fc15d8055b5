"""Brute-force and Morton-banded k-nearest-neighbor search.

Twin of ``glim_tpu/ops/knn.py``: distances by the expansion
``|q|^2 + |t|^2 - 2 q.t`` tile by tile over query rows, and an approximate
self-kNN that searches a band of the Z-order-sorted cloud. ``lax.top_k``
breaks ties toward the lower index and ``torch.topk`` promises no order, so
the k smallest are taken by a ``topk`` of unique (value, column) keys.
``knn_self_boxed`` is the port's own exact self-kNN of a large cloud (the
map editor's outlier selection over a whole map): each tile of queries is
searched only against the points in its bounding box grown by a radius.
"""

from __future__ import annotations

from typing import Tuple

import torch

_TILE = 1024
_INT32_MAX = 2**31 - 1
# Device bytes of one query tile's int64 (distance, column) keys in
# ``knn_self_boxed``, were the tile searched against the whole cloud (a box
# holding all of it, or the re-search); the tile's other temporaries add
# about 1.5x more.
_BOXED_KEY_BYTES = 1 << 30


def _boxed_tile(n: int) -> int:
    """Query rows a tile of ``knn_self_boxed`` over ``n`` points: the largest
    power of two, 16 to 1024, whose 8 B x tile x n keys fit _BOXED_KEY_BYTES."""
    rows = max(1, _BOXED_KEY_BYTES // (8 * max(n, 1)))
    return int(min(_TILE, max(16, 1 << (rows.bit_length() - 1))))


def _k_smallest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise k smallest values of non-negative (or +inf) ``d2``, ties to
    the lower index (lax.top_k order): a ``topk`` of one int64 key a column,
    (the value's IEEE bits << 32) | column, which orders non-negative floats
    and is unique. (A stable sort gives the same order but took ~50 GB on
    the card at 1024 x 65536.)"""
    if k == 1:
        v, i = torch.min(d2, dim=1, keepdim=True)    # first minimum
        return v, i
    bits = (d2 + 0.0).view(torch.int32).to(torch.int64)    # + 0.0: -0.0 -> +0.0
    cols = torch.arange(d2.shape[1], device=d2.device, dtype=torch.int64)
    keys = torch.topk((bits << 32) | cols, k, dim=1, largest=False, sorted=True).values
    i = keys & 0xFFFFFFFF
    return torch.gather(d2, 1, i), i


def knn_search(queries: torch.Tensor, query_mask: torch.Tensor,
               targets: torch.Tensor, target_mask: torch.Tensor,
               k: int, exclude_self: bool = False, tile: int = _TILE
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest targets per query -> (indices (Q, k) int32, sq_dists (Q, k)).
    Invalid queries get index 0 / +inf. ``tile`` query rows are searched at
    a time: their (tile, N) distances and int64 keys bound the memory."""
    Q = queries.shape[0]
    N = targets.shape[0]
    t_sq = torch.sum(targets * targets, dim=-1)
    t_invalid = torch.where(target_mask, 0.0, float("inf"))
    idx_out, d2_out = [], []
    for base in range(0, Q, tile):
        qt = queries[base:base + tile]
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


def knn_self_boxed(points: torch.Tensor, k: int, radius: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN graph of an all-valid cloud against itself (the self-match
    included), without an N x N search: the points are ordered along a
    Z-order curve of ``radius`` cells, and each tile of ``_boxed_tile(N)``
    queries is searched (``knn_search``) against the points inside its bounding box
    grown by ``radius``. A point outside that box lies more than ``radius``
    from every query of the tile, so a query whose k-th neighbour in the box
    is within ``radius`` has its exact k nearest; the others (isolated
    points, or a box with fewer than k points) are searched against the
    whole cloud. Each search runs on coordinates centred on its tile's box
    (the re-search on the cloud's) (the expansion |q|^2 + |t|^2 - 2 q.t loses ~1e-4 m^2 to cancellation at 30 m
    from the origin), and the squared distances returned are those of the
    neighbours found, by difference. Returns (indices (N, k) int32,
    squared distances (N, k)), ties to the lower index as ``knn_self``. One
    host read a tile (the box's size) and one for the re-searched queries."""
    N = points.shape[0]
    dev = points.device
    tile = _boxed_tile(N)
    order = torch.sort(morton_code(torch.floor(points / radius).to(torch.int32)),
                       stable=True).indices
    ps = points[order]
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    idx = torch.empty((N, k), dtype=torch.int32, device=dev)   # original indices
    far = torch.ones(N, dtype=torch.bool, device=dev)           # to search everywhere
    for base in range(0, N, tile):
        q = ps[base:base + tile]
        lo = q.min(dim=0).values - radius
        hi = q.max(dim=0).values + radius
        box = torch.nonzero(torch.all((ps >= lo) & (ps <= hi), dim=1)).reshape(-1)
        if box.shape[0] < k:
            continue
        box = box[torch.argsort(order[box])]      # ties to the lower original index
        c = (lo + hi) / 2
        i_t, d_t = knn_search(q - c, ones[:q.shape[0]], ps[box] - c, ones[:box.shape[0]], k)
        idx[base:base + q.shape[0]] = order[box[i_t.long()]].to(torch.int32)
        far[base:base + q.shape[0]] = d_t[:, -1] > radius * radius
    again = torch.nonzero(far).reshape(-1)
    if again.shape[0]:
        c = (points.min(dim=0).values + points.max(dim=0).values) / 2
        idx[again] = knn_search(ps[again] - c, ones[:again.shape[0]], points - c, ones, k,
                                tile=tile)[0]
    out_idx = torch.empty_like(idx)
    out_idx[order] = idx
    diff = points[:, None, :] - points[out_idx.long()]
    return out_idx, torch.sum(diff * diff, dim=-1)
