"""Fixed-capacity voxel maps: Gaussian-statistics (VGICP target) and
point-container (GICP / iVox-style target).

Twin of ``glim_tpu/ops/voxelmap.py``. A voxel map is a sorted table keyed
by the (hash_coords, hash_coords2) double hash: insertion is concat -> stable
multi-key sort -> segment reduction, lookup is a binary search plus a short
probe window, and LRU eviction keeps the highest ages. ``lax.sort`` is
stable and ``lax.top_k`` breaks ties toward the lower index; both orders are
reproduced with stable ``torch.sort`` passes (one per key, least
significant first), since the stored order decides later tie-breaks.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch
from torch.profiler import record_function

from glim_tpu_torch.ops.pointops import (INVALID_HASH, hash_coords,
                                         hash_coords2, segment_max,
                                         segment_sum, voxel_coords)

_PROBE = 4   # entries scanned past the binary-search hit (equal-h1 runs)
_I32_MIN = -2**31


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by keys[0], then keys[1], ... (stable)."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k[perm]
        p = torch.sort(kk, stable=True).indices
        perm = p if perm is None else perm[p]
    return perm


def _top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k`` indices: k largest, ties toward the lower index."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


@dataclass
class GaussianVoxelMap:
    """Sorted-table Gaussian voxel map (VGICP target): per voxel the mean
    of inserted points, the mean of their covariances, a count and an age."""

    hash: torch.Tensor    # (V,) int32, sorted; INVALID_HASH for empty slots
    coords: torch.Tensor  # (V, 3) int32
    mean: torch.Tensor    # (V, 3) f32
    cov: torch.Tensor     # (V, 3, 3) f32
    count: torch.Tensor   # (V,) f32
    age: torch.Tensor     # (V,) int32
    resolution: torch.Tensor  # () f32

    @property
    def capacity(self) -> int:
        return int(self.hash.shape[0])

    @property
    def valid(self) -> torch.Tensor:
        return self.hash != INVALID_HASH


def empty_gaussian_voxelmap(capacity: int, resolution, device) -> GaussianVoxelMap:
    """``resolution`` is a float or a 0-dim tensor; a tensor already on
    ``device`` is kept as it is, and a float is filled on the device, so
    neither reads from nor uploads through the host."""
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
    if isinstance(resolution, torch.Tensor):
        res = resolution.to(device=device, dtype=torch.float32)
    else:
        res = torch.full((), float(resolution), dtype=torch.float32, device=device)
    return GaussianVoxelMap(
        hash=torch.full((capacity,), INVALID_HASH, dtype=torch.int32, device=device),
        coords=z(capacity, 3, dt=torch.int32), mean=z(capacity, 3),
        cov=z(capacity, 3, 3), count=z(capacity), age=z(capacity, dt=torch.int32),
        resolution=res)


def stack_voxelmaps(vms) -> GaussianVoxelMap:
    """K maps of one capacity as one map whose fields carry a leading K axis
    (the JAX package vmaps over such a stack)."""
    return GaussianVoxelMap(*(torch.stack([getattr(vm, f.name) for vm in vms])
                              for f in fields(GaussianVoxelMap)))


def _sorted_reduce(hashes, hashes2, coords, weights, w_mean, w_cov, ages, capacity):
    """Sort entries by the (hash, hash2) pair and segment-reduce weighted
    Gaussian stats into at most ``capacity`` voxels (already hash-sorted,
    INVALID_HASH suffix)."""
    order = _stable_order(hashes, hashes2)
    h_s, h2_s = hashes[order], hashes2[order]
    c_s, w_s, wm_s, wc_s, a_s = (coords[order], weights[order], w_mean[order],
                                 w_cov[order], ages[order])

    valid = h_s != INVALID_HASH
    same = (h_s[1:] == h_s[:-1]) & (h2_s[1:] == h2_s[:-1])
    starts = torch.cat([valid[:1], ~same]) & valid
    seg_id = torch.cumsum(starts.to(torch.int64), 0) - 1
    num_segs = starts.sum()
    seg_id = torch.where(valid, seg_id, capacity)

    payload = torch.cat([w_s[:, None], wm_s, wc_s.reshape(-1, 9)], dim=1)
    seg_sum = segment_sum(payload, seg_id, capacity + 1)[:capacity]
    ipayload = torch.where(valid[:, None],
                           torch.cat([h_s[:, None], c_s, a_s[:, None]], dim=1).to(torch.int64),
                           _I32_MIN)
    seg_imax = segment_max(ipayload, seg_id, capacity + 1, _I32_MIN)[:capacity]

    slot_valid = torch.arange(capacity, device=hashes.device) < num_segs
    seg_hash = torch.where(slot_valid, seg_imax[:, 0], INVALID_HASH).to(torch.int32)
    seg_age = torch.where(slot_valid, seg_imax[:, 4], -1).to(torch.int32)
    return (seg_hash, seg_imax[:, 1:4].to(torch.int32), seg_sum[:, 0],
            seg_sum[:, 1:4], seg_sum[:, 4:13].reshape(-1, 3, 3), seg_age)


@record_function("voxelmap_insert")
def voxelmap_insert(vm: GaussianVoxelMap, points: torch.Tensor, mask: torch.Tensor,
                    covs: torch.Tensor, step) -> GaussianVoxelMap:
    """Merge a padded point batch (+covs) into the map; ``step`` is the LRU
    stamp of the touched voxels. Over capacity, the least recently updated
    voxels are dropped."""
    V = vm.capacity
    dev = points.device
    step = torch.full((), step, dtype=torch.int32, device=dev)
    p_coords = voxel_coords(points, 1.0 / vm.resolution)
    p_hash = torch.where(mask, hash_coords(p_coords), INVALID_HASH)
    p_hash2 = torch.where(mask, hash_coords2(p_coords), INVALID_HASH)
    e_valid = vm.valid
    e_hash2 = torch.where(e_valid, hash_coords2(vm.coords), INVALID_HASH)

    s_hash, s_coords, s_w, s_wm, s_wc, s_age = _sorted_reduce(
        torch.cat([vm.hash, p_hash]), torch.cat([e_hash2, p_hash2]),
        torch.cat([vm.coords, p_coords]),
        torch.cat([vm.count, mask.to(torch.float32)]),
        torch.cat([vm.mean * vm.count[:, None], torch.where(mask[:, None], points, 0.0)]),
        torch.cat([vm.cov * vm.count[:, None, None],
                   torch.where(mask[:, None, None], covs, 0.0)]),
        torch.cat([torch.where(e_valid, vm.age, -1),
                   torch.where(mask, step, -1)]),
        V + points.shape[0])

    # Keep the V most recently updated voxels (lax.top_k order), restored to
    # key order: s_* is key-sorted, so that is ascending index order. When
    # everything fits this is exactly the first V entries (the JAX version
    # takes that branch with lax.cond; here both cases share one path).
    score = torch.where(s_hash != INVALID_HASH, s_age, _I32_MIN)
    keep = torch.sort(_top_indices(score, V)).values
    k_w = s_w[keep]
    safe_w = torch.clamp(k_w, min=1.0)
    return GaussianVoxelMap(
        hash=s_hash[keep], coords=s_coords[keep],
        mean=s_wm[keep] / safe_w[:, None], cov=s_wc[keep] / safe_w[:, None, None],
        count=k_w, age=torch.clamp(s_age[keep], min=0), resolution=vm.resolution)


def lookup_table(vm: GaussianVoxelMap) -> torch.Tensor:
    """(..., V, 2) double-hash key table for lookup_keys; a stack of maps
    (leading K axis, ``stack_voxelmaps``) gives one table per map."""
    t_h2 = torch.where(vm.valid, hash_coords2(vm.coords), INVALID_HASH)
    return torch.stack([vm.hash, t_h2], dim=-1)


def lookup_keys(keys: torch.Tensor, resolution, points: torch.Tensor) -> torch.Tensor:
    """(..., Q, 3) query points against (..., V, 2) key tables, batch row b
    against table b, at the per-table ``resolution`` tensor (...) -> (..., Q)
    voxel index or -1. One batched binary search and one gather per probe."""
    q_coords = voxel_coords(points, (1.0 / resolution)[..., None, None])
    q_hash = hash_coords(q_coords)
    q_h2 = hash_coords2(q_coords)
    t_hash = keys[..., 0].contiguous()
    t_h2 = keys[..., 1]
    base = torch.searchsorted(t_hash, q_hash, right=False)
    found = torch.full(q_hash.shape, -1, dtype=torch.int64, device=points.device)
    V = keys.shape[-2]
    for w in range(_PROBE):
        idx = torch.clamp(base + w, max=V - 1)
        hit = (t_hash.gather(-1, idx) == q_hash) & (t_h2.gather(-1, idx) == q_h2)
        found = torch.where((found < 0) & hit, idx, found)
    return found


def gaussian_lookup_table(vm: GaussianVoxelMap):
    """The per-submap search payload of the stacked lookups (global mapping
    keeps one per submap and level): the (V, 2) key table and the (V, 12)
    mean|cov stats rows."""
    return lookup_table(vm), torch.cat([vm.mean, vm.cov.reshape(-1, 9)], dim=1)


def lookup_keys_stacked(keys: torch.Tensor, resolution: torch.Tensor,
                        points: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Query row r's points (R, Q, 3) against table ``rows[r]`` of the
    stacked (S, V, 2) key tables at its resolution (S,) -> (R, Q) voxel
    index or -1: per row, what ``lookup_keys`` gives on that table.

    No per-row table is gathered (an (R, V, 2) copy): the S sorted tables,
    keyed (table, hash) as int64, are one ascending sequence, so a single
    ``searchsorted(right=False)`` finds each query's insertion point in its
    own table, and the probes read the stacked table in place."""
    S, V = keys.shape[0], keys.shape[1]
    rows = rows.to(torch.int64)
    q_coords = voxel_coords(points, (1.0 / resolution[rows])[:, None, None])
    q_hash = hash_coords(q_coords)
    q_h2 = hash_coords2(q_coords)
    t_hash = keys[..., 0].reshape(-1)
    t_h2 = keys[..., 1].reshape(-1)
    table = torch.arange(S, device=keys.device)[:, None] << 32
    flat = (table + (keys[..., 0].to(torch.int64) - _I32_MIN)).reshape(-1)
    start = rows[:, None] * V
    base = torch.searchsorted(flat, (rows[:, None] << 32) + (q_hash.to(torch.int64) - _I32_MIN),
                              right=False) - start
    found = torch.full(q_hash.shape, -1, dtype=torch.int64, device=points.device)
    for w in range(_PROBE):
        idx = torch.clamp(base + w, max=V - 1)
        hit = (t_hash[start + idx] == q_hash) & (t_h2[start + idx] == q_h2)
        found = torch.where((found < 0) & hit, idx, found)
    return found


def voxelmap_overlap_stacked(T_rel: torch.Tensor, tgt: torch.Tensor, src: torch.Tensor,
                             sm_pts: torch.Tensor, sm_mask: torch.Tensor,
                             keys: torch.Tensor, res: torch.Tensor,
                             stride: int = 1) -> torch.Tensor:
    """``voxelmap_overlap`` over (tgt, src) pair rows against stacked
    per-submap tables: row r scores submap src[r]'s cloud, transformed by
    T_rel[r], against submap tgt[r]'s key table. ``stride`` subsamples the
    scored cloud (the overlap only feeds a threshold); 1 is exact.

    T_rel (R, 4, 4); tgt/src (R,); sm_pts (S, M, 3); sm_mask (S, M); keys
    (S, V, 2); res (S,) -> (R,) f32."""
    src = src.to(torch.int64)
    pts = sm_pts[src][:, ::stride]
    msk = sm_mask[src][:, ::stride]
    q = pts @ T_rel[:, :3, :3].transpose(-1, -2) + T_rel[:, None, :3, 3]
    hits = (lookup_keys_stacked(keys, res, q, tgt) >= 0) & msk
    return hits.sum(1) / torch.clamp(msk.sum(1), min=1)


def voxelmap_lookup(vm: GaussianVoxelMap, points: torch.Tensor) -> torch.Tensor:
    """(..., Q, 3) query points -> (..., Q) voxel index or -1; a stacked
    map (leading K axis) looks up query row k in map k."""
    return lookup_keys(lookup_table(vm), vm.resolution, points)


def voxelmap_overlap(vm: GaussianVoxelMap, points: torch.Tensor, mask: torch.Tensor,
                     T: torch.Tensor) -> torch.Tensor:
    """Fraction of valid points whose T-transformed position hits an
    occupied voxel (0-dim f32, stays on the device)."""
    p = points @ T[:3, :3].T + T[:3, 3]
    hits = (voxelmap_lookup(vm, p) >= 0) & mask
    return hits.sum() / torch.clamp(mask.sum(), min=1)


# ---------------------------------------------------------------------------
# Point-container voxel map (iVox equivalent): bounded model point cloud with
# per-subvoxel dedup and LRU age eviction; NN queries go through
# glim_tpu_torch.ops.nn_search.
# ---------------------------------------------------------------------------


@dataclass
class PointVoxelMap:
    points: torch.Tensor   # (M, 3) f32
    covs: torch.Tensor     # (M, 3, 3) f32
    mask: torch.Tensor     # (M,) bool
    age: torch.Tensor      # (M,) int32
    min_dist: torch.Tensor  # () f32 — sub-voxel size (one point kept per cell)
    # () int32 — entries untouched for this many steps expire on the next
    # insert (iVox lru_thresh horizon).
    lru_horizon: torch.Tensor = None

    @property
    def capacity(self) -> int:
        return int(self.points.shape[0])


def empty_point_voxelmap(capacity: int, min_dist, lru_horizon: int = 2**30, *,
                         device) -> PointVoxelMap:
    return PointVoxelMap(
        points=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        covs=torch.zeros((capacity, 3, 3), dtype=torch.float32, device=device),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        age=torch.zeros((capacity,), dtype=torch.int32, device=device),
        min_dist=torch.as_tensor(min_dist, dtype=torch.float32, device=device),
        lru_horizon=torch.as_tensor(lru_horizon, dtype=torch.int32, device=device))


def pointmap_insert(pm: PointVoxelMap, points: torch.Tensor, mask: torch.Tensor,
                    covs: torch.Tensor, step) -> PointVoxelMap:
    """Insert new points, keeping at most one point per min_dist sub-voxel
    (existing points win) and the most recently touched ``capacity`` points
    overall (LRU)."""
    M = pm.capacity
    C = points.shape[0]
    dev = points.device
    step = torch.full((), step, dtype=torch.int64, device=dev)

    all_pts = torch.cat([pm.points, points])
    all_cov = torch.cat([pm.covs, covs])
    all_mask = torch.cat([pm.mask, mask])
    all_age = torch.cat([torch.where(pm.mask, pm.age.to(torch.int64), -1),
                         torch.where(mask, step, -1)])
    # Existing points get priority 0, new ones 1: the first entry in each
    # sub-voxel after the sort is the survivor.
    prio = torch.cat([torch.zeros(M, dtype=torch.int32, device=dev),
                      torch.ones(C, dtype=torch.int32, device=dev)])

    coords = voxel_coords(all_pts, 1.0 / pm.min_dist)
    h = torch.where(all_mask, hash_coords(coords), INVALID_HASH)
    h2 = torch.where(all_mask, hash_coords2(coords), INVALID_HASH)
    order = _stable_order(h, h2, prio)
    h_s, h2_s, valid_s = h[order], h2[order], all_mask[order]
    same = (h_s[1:] == h_s[:-1]) & (h2_s[1:] == h2_s[:-1])
    first = torch.cat([valid_s[:1], ~same]) & valid_s

    # LRU refresh-on-touch: a surviving point adopts the newest age in its
    # sub-voxel.
    seg_id = torch.cumsum(first.to(torch.int64), 0) - 1
    n_seg = M + C + 1
    seg_max_age = segment_max(torch.where(valid_s, all_age[order], -1),
                              torch.where(valid_s, seg_id, n_seg - 1), n_seg, _I32_MIN)
    age_s = torch.where(valid_s, seg_max_age[seg_id], -1)
    first = first & (age_s >= step - pm.lru_horizon.to(torch.int64))
    score = torch.where(first, age_s, _I32_MIN)
    keep = _top_indices(score, M)
    new_mask = first[keep]
    src = order[keep]
    return PointVoxelMap(
        points=all_pts[src], covs=all_cov[src], mask=new_mask,
        age=torch.where(new_mask, age_s[keep], 0).to(torch.int32),
        min_dist=pm.min_dist, lru_horizon=pm.lru_horizon)
