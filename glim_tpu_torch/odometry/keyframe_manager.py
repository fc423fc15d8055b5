"""Odometry keyframe management (OVERLAP / DISPLACEMENT / ENTROPY).

Twin of ``glim_tpu/odometry/keyframe_manager.py``. The matching target is
the accumulated multi-resolution Gaussian voxel map; the keyframe set
decides what that map contains:

* an insertion strategy gates which frames contribute points;
* an eviction removes a keyframe's contribution by rebuilding every level
  from the surviving keyframes' stored world points (at most once per
  keyframe insertion, off the per-scan step).

Each keyframe also keeps a mini voxel map for the overlap scores the
eviction strategies need. The mini maps share one capacity and are stacked
along a leading K axis (``voxelmap.stack_voxelmaps``), so the K overlaps
of a point set, and the K x K "overlap with the others", each come from one
batched lookup rather than K or K x K small ones.

Strategies (same formulas as the JAX package):
  OVERLAP       insert when overlap(new, all keyframes) <= keyframe_max_overlap;
                evict keyframes with overlap(kf_i, new) < keyframe_min_overlap,
                then the min of score_i = overlap(kf_i, new) * (1 - overlap(kf_i, others))
  DISPLACEMENT  insert when delta_trans/rot from the last keyframe exceed
                thresholds; evict the first keyframe with overlap < 0.01,
                else the max of score_i = sqrt(dist(kf_i, new)) * sum_j 1/(dist_ij+eps)
                with the two oldest protected
  ENTROPY       insert when logdet(H_match) falls below the running average
                x keyframe_entropy_thresh; evict the oldest
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from glim_tpu_torch.ops import voxelmap as vmx
from glim_tpu_torch.types import to_numpy
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("odom")


@dataclass
class KeyframeStore:
    """Device-resident keyframe set (slot-addressed, unordered)."""

    pts: torch.Tensor     # (K, C, 3) world-frame deskewed points
    covs: torch.Tensor    # (K, C, 3, 3) world-frame covariances
    mask: torch.Tensor    # (K, C) bool
    T: torch.Tensor       # (K, 4, 4) T_world_imu at insertion
    order: torch.Tensor   # (K,) int32 insertion counter; -1 = empty slot
    vm: vmx.GaussianVoxelMap   # stacked (K, ...) per-keyframe mini maps


def empty_keyframe_store(K: int, C: int, mini_capacity: int, resolution,
                         device) -> KeyframeStore:
    mini = vmx.empty_gaussian_voxelmap(mini_capacity, resolution, device=device)
    return KeyframeStore(
        pts=torch.zeros((K, C, 3), device=device),
        covs=torch.zeros((K, C, 3, 3), device=device),
        mask=torch.zeros((K, C), dtype=torch.bool, device=device),
        T=torch.eye(4, device=device).expand(K, 4, 4).clone(),
        order=torch.full((K,), -1, dtype=torch.int32, device=device),
        vm=vmx.stack_voxelmaps([mini] * K))


def _to_world(pts_l, covs_l, T_wl):
    R, t = T_wl[:3, :3], T_wl[:3, 3]
    return pts_l @ R.T + t, R @ covs_l @ R.T


def kf_write(store: KeyframeStore, slot: int, pts_l, covs_l, mask, T_wl, T_wi,
             order_id: int) -> None:
    """Write one keyframe into ``slot`` in place: transform the lidar-frame
    scan to world, store it, and build its mini overlap map."""
    pts_w, covs_w = _to_world(pts_l, covs_l, T_wl)
    empty = vmx.empty_gaussian_voxelmap(store.vm.hash.shape[1],
                                        store.vm.resolution[slot], device=pts_w.device)
    mini = vmx.voxelmap_insert(empty, pts_w, mask, covs_w, 0)
    store.pts[slot] = pts_w
    store.covs[slot] = covs_w
    store.mask[slot] = mask
    store.T[slot] = T_wi
    # fill_ on the 0-dim view: assigning a Python int would copy it from
    # the host, a sync on the card.
    store.order[slot].fill_(order_id)
    for name in ("hash", "coords", "mean", "cov", "count", "age"):
        getattr(store.vm, name)[slot] = getattr(mini, name)


def kf_overlaps_with_points(store: KeyframeStore, pts_w: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """(K,) overlap of the given world points vs each keyframe's mini map."""
    K = store.order.shape[0]
    hits = (vmx.voxelmap_lookup(store.vm, pts_w.expand(K, -1, -1)) >= 0) & mask
    ovs = hits.sum(1) / torch.clamp(mask.sum(), min=1)
    return torch.where(store.order >= 0, ovs, 0.0)


def kf_overlap_vs_others(store: KeyframeStore, exclude: torch.Tensor) -> torch.Tensor:
    """(K,) fraction of each keyframe's points that land in ANY other
    keyframe's map (slots in ``exclude``, e.g. the newest, are ignored both
    as sources and as targets). Every target map looks up all K x C source
    points in one batched lookup."""
    K, C = store.mask.shape
    active = (store.order >= 0) & ~exclude
    q = store.pts.reshape(1, K * C, 3).expand(K, -1, -1)
    # hits[tgt, src, c]: does source point c of keyframe src land in tgt's map?
    hits = (vmx.voxelmap_lookup(store.vm, q) >= 0).reshape(K, K, C)
    hits = hits & active[:, None, None]
    not_self = ~torch.eye(K, dtype=torch.bool, device=q.device)
    any_other = torch.any(hits & not_self[:, :, None], dim=0) & store.mask
    frac = any_other.sum(1) / torch.clamp(store.mask.sum(1), min=1)
    return torch.where(active, frac, 0.0)


@record_function("rebuild_level")
def rebuild_level(store: KeyframeStore, capacity: int, resolution,
                  step: int) -> vmx.GaussianVoxelMap:
    """Rebuild one accumulated model level from all surviving keyframes.
    ``resolution`` may be a device scalar; it is never read on the host."""
    K, C = store.mask.shape
    mask = (store.mask & (store.order >= 0)[:, None]).reshape(K * C)
    empty = vmx.empty_gaussian_voxelmap(capacity, resolution, device=store.pts.device)
    return vmx.voxelmap_insert(empty, store.pts.reshape(K * C, 3),
                               mask, store.covs.reshape(K * C, 3, 3), step)


class KeyframeManager:
    """Host-side keyframe strategy over the device KeyframeStore.

    Decisions use the lagged status scalars of the odometry step (overlap,
    displacement and matching entropy of the frame being decided), so the
    per-scan loop stays sync-free; an eviction reads K small scores."""

    def __init__(self, strategy: str, max_num_keyframes: int,
                 min_overlap: float, max_overlap: float,
                 delta_trans: float, delta_rot: float,
                 entropy_thresh: float,
                 C: int, model_capacities: List[int],
                 model_resolutions: List[float],
                 mini_capacity: int = 16384, device="cuda"):
        self.strategy = strategy.upper()
        self.max_num = max_num_keyframes
        self.min_overlap = min_overlap
        self.max_overlap = max_overlap
        self.delta_trans = delta_trans
        self.delta_rot = delta_rot
        self.entropy_thresh = entropy_thresh
        self.model_capacities = model_capacities
        self.model_resolutions = model_resolutions
        self.device = torch.device(device)
        # Per-level rebuild resolutions as device scalars: the adaptive
        # resolution updates them per keyframe insert without a host read;
        # they take effect at the next eviction-triggered rebuild (between
        # rebuilds the merge keeps each map's own resolution).
        self.model_res_dev = [torch.full((), float(r), device=self.device)
                              for r in model_resolutions]
        K = max_num_keyframes + 1          # room for insert-then-evict
        self.store = empty_keyframe_store(K, C, mini_capacity, model_resolutions[-1],
                                          device=self.device)
        # Host mirrors (poses/order) for the pose-only score arithmetic.
        self.h_T: List[Optional[np.ndarray]] = [None] * K
        self.h_order = np.full(K, -1, np.int64)
        self.next_order = 0
        self.last_kf_T_wi = None           # device (4,4), passed to the step
        self._entropy_avg = 0.0
        self._entropy_n = 0
        self.marginalized_callback = None  # set by the odometry module

    def set_model_resolutions(self, res_dev: List[torch.Tensor]) -> None:
        """Update the per-level rebuild resolutions (device scalars).
        Takes effect at the next eviction-triggered rebuild."""
        self.model_res_dev = list(res_dev)

    # -- queries ---------------------------------------------------------

    @property
    def count(self) -> int:
        return int((self.h_order >= 0).sum())

    def _free_slot(self) -> int:
        return int(np.argmin(self.h_order >= 0))

    # -- decision --------------------------------------------------------

    def should_insert(self, overlap: float, d_trans: float, d_rot: float,
                      neg_entropy: float) -> bool:
        if self.count == 0:
            return True
        if self.strategy == "OVERLAP":
            return overlap <= self.max_overlap
        if self.strategy == "DISPLACEMENT":
            return (d_trans >= self.delta_trans) or (d_rot >= self.delta_rot)
        if self.strategy == "ENTROPY":
            self._entropy_n += 1
            self._entropy_avg += (neg_entropy - self._entropy_avg) / self._entropy_n
            if neg_entropy > self._entropy_avg * self.entropy_thresh:
                return False
            self._entropy_n = 0
            self._entropy_avg = 0.0
            return True
        raise ValueError(f"unknown keyframe strategy {self.strategy}")

    # -- mutation --------------------------------------------------------

    def insert(self, pts_l, covs_l, mask, T_wl_dev, T_wi_dev,
               T_wi_host: np.ndarray, model: Tuple[vmx.GaussianVoxelMap, ...],
               step_id: int) -> Tuple[vmx.GaussianVoxelMap, ...]:
        """Insert a keyframe; evict per strategy if over capacity. Returns
        the (possibly rebuilt) accumulated model maps."""
        slot = self._free_slot()
        kf_write(self.store, slot, pts_l, covs_l, mask, T_wl_dev, T_wi_dev,
                 self.next_order)
        self.h_T[slot] = np.asarray(T_wi_host, np.float64)
        self.h_order[slot] = self.next_order
        self.next_order += 1
        # The step reads this pose scans later: it must be a tensor that no
        # in-place update reaches (the odometry hands over fresh ones).
        self.last_kf_T_wi = T_wi_dev

        evicted = []
        if self.count > self.max_num:
            with record_function("odom/kf_evict"):
                evicted = self._evict(slot)

        if evicted:
            model = tuple(rebuild_level(self.store, cap, res, step_id)
                          for cap, res in zip(self.model_capacities, self.model_res_dev))
            if self.marginalized_callback is not None:
                self.marginalized_callback(evicted)
        else:
            # Merge the new keyframe into the accumulated maps.
            pts_w, covs_w = _to_world(pts_l, covs_l, T_wl_dev)
            model = tuple(vmx.voxelmap_insert(vm, pts_w, mask, covs_w, step_id)
                          for vm in model)
        return model

    def _clear(self, slot: int, evicted: List[int]) -> None:
        evicted.append(int(self.h_order[slot]))
        self.store.mask[slot] = False
        self.store.order[slot].fill_(-1)     # no host copy (see kf_write)
        self.h_order[slot] = -1
        self.h_T[slot] = None

    def _evict(self, new_slot: int) -> List[int]:
        """Strategy-specific eviction. Returns evicted insertion orders."""
        K = len(self.h_order)
        valid = self.h_order >= 0
        evicted: List[int] = []

        if self.strategy == "ENTROPY":
            olds = np.where(valid, self.h_order, np.iinfo(np.int64).max)
            olds[new_slot] = np.iinfo(np.int64).max
            self._clear(int(np.argmin(olds)), evicted)
            return evicted

        # Both OVERLAP and DISPLACEMENT need overlap(kf_i, new keyframe).
        ov_new = to_numpy(kf_overlaps_with_points(
            self.store, self.store.pts[new_slot], self.store.mask[new_slot])).copy()
        ov_new[new_slot] = np.inf            # never evict the newest

        if self.strategy == "OVERLAP":
            # Phase 1: drop keyframes with (almost) no overlap to the newest.
            for i in np.where(valid & (ov_new < self.min_overlap))[0]:
                if i != new_slot:
                    self._clear(int(i), evicted)
            if self.count <= self.max_num:
                return evicted
            # Phase 2: min score = overlap_latest * (1 - overlap_others).
            exclude = torch.arange(K, device=self.device) == new_slot
            ov_others = to_numpy(kf_overlap_vs_others(self.store, exclude))
            valid = self.h_order >= 0
            scores = np.where(valid, ov_new * (1.0 - ov_others), np.inf)
            scores[new_slot] = np.inf
            self._clear(int(np.argmin(scores)), evicted)
            return evicted

        # DISPLACEMENT
        low = np.where(valid & (ov_new < 0.01))[0]
        low = low[low != new_slot]
        if len(low):
            self._clear(int(low[0]), evicted)
            return evicted
        # Protect the two oldest; evict max sqrt(d0) * sum 1/(dist+eps).
        orders = np.where(valid, self.h_order, np.iinfo(np.int64).max)
        orders[new_slot] = np.iinfo(np.int64).max
        protected = set(np.argsort(orders)[:2].tolist())
        t_new = self.h_T[new_slot][:3, 3]
        scores = np.full(K, -np.inf)
        for i in range(K):
            if not valid[i] or i == new_slot or i in protected:
                continue
            t_i = self.h_T[i][:3, 3]
            s = 0.0
            for j in range(K):
                if j == i or not valid[j] or j == new_slot:
                    continue
                s += 1.0 / (np.linalg.norm(t_i - self.h_T[j][:3, 3]) + 1e-3)
            scores[i] = np.sqrt(np.linalg.norm(t_i - t_new)) * s
        if np.isfinite(scores).any() and scores.max() > -np.inf:
            self._clear(int(np.argmax(scores)), evicted)
        return evicted
