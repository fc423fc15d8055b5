"""Masked padded point-batch primitives: voxel keys, downsampling, filters.

Twin of ``glim_tpu/ops/pointops.py``. Everything operates on fixed-capacity
(C, ...) tensors with a validity mask; grouping by voxel is a stable sort +
segment reduction. The two 32-bit mixing hashes are computed bit-exactly in
int64 with explicit ``& 0xFFFFFFFF`` wraparound (torch has no uint32
arithmetic), because they decide sort order and so which points survive.
Random priorities are inputs, drawn by the caller from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Large sentinel so invalid lanes sort to the end of any key ordering.
INVALID_HASH = 2**31 - 1
_M32 = 0xFFFFFFFF


def voxel_coords(points: torch.Tensor, inv_resolution) -> torch.Tensor:
    """(..., 3) f32 -> (..., 3) int32 quantized voxel coordinates."""
    return torch.floor(points * inv_resolution).to(torch.int32)


def _u32(coords: torch.Tensor) -> torch.Tensor:
    """int32 -> its uint32 bit pattern, held in int64."""
    return coords.to(torch.int64) & _M32


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for a in [0, 2^32), without int64 overflow."""
    hi = ((a >> 16) * k) & 0xFFFF
    return ((hi << 16) + (a & 0xFFFF) * k) & _M32


def _finish(h: torch.Tensor) -> torch.Tensor:
    # Clamp to 0x7FFFFFFE: 0x7FFFFFFF is the INVALID_HASH sentinel.
    return torch.clamp(h & 0x7FFFFFFF, max=0x7FFFFFFE).to(torch.int32)


def hash_coords(coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 -> (...,) int32 large-prime XOR mixing hash."""
    c = _u32(coords)
    h = (_mul32(c[..., 0], 73856093) ^ _mul32(c[..., 1], 19349669)
         ^ _mul32(c[..., 2], 83492791))
    return _finish(h)


def hash_coords2(coords: torch.Tensor) -> torch.Tensor:
    """Second independent hash (additive combination + murmur3 finalizer),
    the sort tiebreak of the (hash_coords, hash_coords2) pair."""
    c = _u32(coords)
    h = (_mul32(c[..., 0], 2654435761) + _mul32(c[..., 1], 805459861)
         + _mul32(c[..., 2], 3674653429)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return _finish(h)


def lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort`` semantics: the LAST key is the primary one; one
    stable sort pass per key from the least significant."""
    perm = None
    for k in keys:
        if perm is None:
            perm = torch.sort(k, stable=True).indices
        else:
            perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _order_by(hash_keys: torch.Tensor, coords: torch.Tensor,
              *tiebreak: torch.Tensor) -> torch.Tensor:
    """Sort order: (hash, cx, cy, cz, *tiebreak) lexicographic."""
    keys = list(tiebreak)[::-1] + [coords[..., 2], coords[..., 1],
                                   coords[..., 0], hash_keys]
    return lexsort(keys)


def _segment_starts(hash_keys: torch.Tensor, coords: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Boundary flags for sorted-by-voxel arrays: True where a voxel begins."""
    same = (hash_keys[1:] == hash_keys[:-1]) & torch.all(coords[1:] == coords[:-1], dim=-1)
    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=same.device), ~same])
    return starts & valid


def segment_sum(data: torch.Tensor, seg_id: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ids outside [0, n) are dropped."""
    ok = (seg_id >= 0) & (seg_id < n)
    idx = torch.where(ok, seg_id, torch.full_like(seg_id, n)).to(torch.int64)
    out = torch.zeros((n + 1,) + data.shape[1:], dtype=data.dtype, device=data.device)
    return out.index_add_(0, idx, data)[:n]


def segment_max(data: torch.Tensor, seg_id: torch.Tensor, n: int,
                init: int) -> torch.Tensor:
    """``jax.ops.segment_max`` for integer data (empty segments -> init)."""
    ok = (seg_id >= 0) & (seg_id < n)
    idx = torch.where(ok, seg_id, torch.full_like(seg_id, n)).to(torch.int64)
    out = torch.full((n + 1,) + data.shape[1:], init, dtype=data.dtype,
                     device=data.device)
    if data.dim() > 1:
        idx = idx[:, None].expand_as(data)
    return out.scatter_reduce_(0, idx, data, "amax")[:n]


def voxelgrid_sampling(points: torch.Tensor, mask: torch.Tensor, resolution,
                       out_capacity: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel-grid downsampling: one centroid per occupied voxel."""
    C = points.shape[0]
    out_c = out_capacity or C
    coords = voxel_coords(points, 1.0 / resolution)
    h = torch.where(mask, hash_coords(coords), INVALID_HASH)
    order = _order_by(h, coords)
    pts_s, coords_s, h_s, valid_s = points[order], coords[order], h[order], mask[order]

    starts = _segment_starts(h_s, coords_s, valid_s)
    seg_id = torch.cumsum(starts.to(torch.int64), 0) - 1
    num_segs = starts.sum()
    seg_sum = segment_sum(torch.where(valid_s[:, None], pts_s, 0.0), seg_id, out_c)
    seg_cnt = segment_sum(valid_s.to(points.dtype), seg_id, out_c)
    out_pts = seg_sum / torch.clamp(seg_cnt[:, None], min=1.0)
    out_mask = (torch.arange(out_c, device=points.device) < num_segs) & (seg_cnt > 0)
    return out_pts, out_mask


def voxelgrid_sampling_covs(points: torch.Tensor, covs: torch.Tensor,
                            mask: torch.Tensor, resolution,
                            out_capacity: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxel-grid downsampling that carries per-point covariances: one
    centroid per occupied voxel with the voxel-mean covariance.

    Voxels past ``out_capacity`` (in sort order) are dropped, as
    ``jax.ops.segment_sum`` drops segment ids >= num_segments: ``segment_sum``
    sends them to a dump row that is sliced off.
    Returns (out_points (C', 3), out_covs (C', 3, 3), out_mask (C',))."""
    C = points.shape[0]
    out_c = out_capacity or C
    coords = voxel_coords(points, 1.0 / resolution)
    h = torch.where(mask, hash_coords(coords), INVALID_HASH)
    order = _order_by(h, coords)
    coords_s, h_s, valid_s = coords[order], h[order], mask[order]

    starts = _segment_starts(h_s, coords_s, valid_s)
    seg_id = torch.cumsum(starts.to(torch.int64), 0) - 1
    num_segs = starts.sum()

    # One 13-wide payload: [1, p(3), C(9)].
    pts_s = points[order]
    payload = torch.cat([torch.ones_like(pts_s[:, :1]), pts_s,
                         covs[order].reshape(-1, 9)], dim=1)
    seg = segment_sum(torch.where(valid_s[:, None], payload, 0.0), seg_id, out_c)
    cnt = torch.clamp(seg[:, 0], min=1.0)
    out_pts = seg[:, 1:4] / cnt[:, None]
    out_covs = seg[:, 4:13].reshape(-1, 3, 3) / cnt[:, None, None]
    out_mask = (torch.arange(out_c, device=points.device) < num_segs) & (seg[:, 0] > 0)
    return out_pts, out_covs, out_mask


def randomgrid_sampling(points: torch.Tensor, mask: torch.Tensor, resolution,
                        target, prio: torch.Tensor, prio2: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxel-bucketed random sampling to ~``target`` points.

    Each occupied voxel contributes up to ceil(target / #voxels) points in
    ``prio`` order, then a global trim in ``prio2`` order brings the count to
    <= target. ``prio``/``prio2`` are (C,) uniform draws (the JAX twin draws
    them from its key and ``fold_in(key, 1)``).

    Returns (points, mask, src_idx)."""
    C = points.shape[0]
    dev = points.device
    coords = voxel_coords(points, 1.0 / resolution)
    h = torch.where(mask, hash_coords(coords), INVALID_HASH)
    order = _order_by(h, coords, prio)
    pts_s, coords_s, h_s, valid_s = points[order], coords[order], h[order], mask[order]

    starts = _segment_starts(h_s, coords_s, valid_s)
    num_segs = torch.clamp(starts.sum(), min=1)
    idx = torch.arange(C, device=dev)
    seg_start = torch.cummax(torch.where(starts, idx, 0), 0).values
    rank = idx - seg_start

    target = torch.as_tensor(target, device=dev)
    budget = torch.ceil(target.to(torch.float32) / num_segs.to(torch.float32)).to(torch.int64)
    keep = valid_s & (rank < budget)

    trim_order = lexsort((prio2, ~keep))      # kept points first, random within
    kept_mask = keep[trim_order] & (idx < target)
    return pts_s[trim_order], kept_mask, order[trim_order]


def distance_filter(points: torch.Tensor, mask: torch.Tensor, near, far) -> torch.Tensor:
    """Mask update: keep finite points with near <= |p| <= far."""
    d = torch.linalg.norm(points, dim=-1)
    finite = torch.all(torch.isfinite(points), dim=-1)
    return mask & finite & (d >= near) & (d <= far)


def cropbox_filter(points: torch.Tensor, mask: torch.Tensor,
                   T_frame_lidar: torch.Tensor, bbox_min: torch.Tensor,
                   bbox_max: torch.Tensor) -> torch.Tensor:
    """Mask update: REMOVE points inside the box (in the box's frame)."""
    p = points @ T_frame_lidar[:3, :3].T + T_frame_lidar[:3, 3]
    inside = torch.all((p >= bbox_min) & (p <= bbox_max), dim=-1)
    return mask & ~inside


def median_distance(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Approximate median range of valid points: the (n_valid // 2)-th
    sorted distance, invalid lanes pushed to +inf. The index stays a (1,)
    device tensor, so the result is read without a host sync."""
    d = torch.where(mask, torch.linalg.norm(points, dim=-1), float("inf"))
    d_s = torch.sort(d).values
    return d_s.index_select(0, torch.clamp(mask.sum() // 2, min=0).reshape(1))[0]
