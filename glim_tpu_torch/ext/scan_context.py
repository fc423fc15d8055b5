"""ScanContext-style explicit loop detection extension.

Twin of ``glim_tpu/ext/scan_context.py`` (glim_ext's
scan_context_loop_detector; Kim & Kim, IROS 2018): a polar ring x sector
grid of the maximum point height, compared by a rotation-invariant
(sector-shifted) cosine distance and pre-filtered by a ring key.

The descriptor is one segment-max on the submap's device
(``scatter_reduce(..., "amax", include_self=False)`` into R*S + 1 cells,
the last one taking the invalid points; empty cells stay 0). The
candidates that pass the host ring-key filter are scored in one batched
``sc_distance`` (every sector shift at once, an (S, R, S) tensor a
candidate) and read back once. Each submap's descriptor is copied to the
host once, for its ring key.

Wiring: ``GlobalMappingCallbacks.on_insert_submap``; an accepted match
fires ``request_to_add_loop(tgt, src)``, which the async global-mapping
wrapper services (matching-cost back-end: a matching factor; pose graph: a
candidate validated by registration).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as GCB
from glim_tpu_torch.types import to_numpy
from glim_tpu_torch.utils.extension_module import ExtensionModule, config_getter
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("scan_ctx")


def scan_context_descriptor(points: torch.Tensor, mask: torch.Tensor, max_range: float,
                            n_rings: int = 20, n_sectors: int = 60) -> torch.Tensor:
    """(R, S) descriptor: max z per polar cell, 0 where empty. ``points``
    (N, 3) in the submap's local frame, ``mask`` (N,) validity."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = torch.sqrt(x * x + y * y)
    ring = torch.clamp((r / max_range * n_rings).to(torch.int64), 0, n_rings - 1)
    sector = torch.clamp(((torch.atan2(y, x) + math.pi) / (2 * math.pi) * n_sectors)
                         .to(torch.int64), 0, n_sectors - 1)
    valid = mask & (r < max_range)
    # Heights below the sensor clamp to 0 (the descriptor's ground floor).
    zc = torch.where(valid, torch.clamp(z, min=0.0), -1.0)
    cell = torch.where(valid, ring * n_sectors + sector, n_rings * n_sectors)
    desc = torch.zeros(n_rings * n_sectors + 1, dtype=points.dtype, device=points.device)
    desc = desc.scatter_reduce(0, cell, zc, "amax", include_self=False)[:-1]
    return torch.clamp(desc, min=0.0).reshape(n_rings, n_sectors)


def sc_distance(d1: torch.Tensor, d2: torch.Tensor):
    """Rotation-invariant ScanContext distance of ``d1`` (R, S) to ``d2``
    (..., R, S): the minimum over sector shifts of the mean column cosine
    distance, columns empty in either descriptor skipped. Returns
    (distance (...,), best shift (...,))."""
    S = d1.shape[-1]
    ar = torch.arange(S, device=d1.device)
    roll = (ar[None, :] - ar[:, None]) % S            # [shift, col]: torch.roll's source column
    cols2 = d2[..., roll].movedim(-2, -3)             # (..., S shifts, R, S cols)
    n1 = torch.linalg.norm(d1, dim=0)                 # (S,)
    n2 = torch.linalg.norm(cols2, dim=-2)             # (..., S, S)
    num = torch.sum(d1 * cols2, dim=-2)
    occ = (n1 > 1e-6) & (n2 > 1e-6)
    colsim = torch.where(occ, num / (n1 * n2 + 1e-9), 0.0)
    n_occ = torch.clamp(occ.sum(dim=-1), min=1)
    dist = 1.0 - colsim.sum(dim=-1) / n_occ          # (..., S)
    best = torch.argmin(dist, dim=-1)
    return torch.gather(dist, -1, best[..., None])[..., 0], best


def ring_key(desc: np.ndarray) -> np.ndarray:
    """(R,) occupancy ratio per ring: the nearest-neighbour pre-filter key."""
    return (np.asarray(desc) > 1e-6).mean(axis=1)


class ScanContextLoopDetector(ExtensionModule):
    """Explicit loop detector over submaps (glim_ext analogue)."""

    def __init__(self, n_rings: int = 20, n_sectors: int = 60, max_range: float = 80.0,
                 distance_threshold: float = 0.25, ring_key_candidates: int = 8,
                 exclude_recent: int = 3):
        self.n_rings = n_rings
        self.n_sectors = n_sectors
        self.max_range = max_range
        self.distance_threshold = distance_threshold
        self.ring_key_candidates = ring_key_candidates
        self.exclude_recent = exclude_recent
        self.descriptors: List[np.ndarray] = []          # host copies
        self._device_descriptors: List[torch.Tensor] = []
        self.ring_keys: List[np.ndarray] = []
        self.submap_ids: List[int] = []
        self.matches: List[tuple] = []       # (tgt, src, dist) accepted
        self._handle = GCB.on_insert_submap.add(self._on_new_submap)

    def detach(self) -> None:
        if self._handle is not None:
            GCB.on_insert_submap.remove(self._handle)
            self._handle = None

    def _on_new_submap(self, submap) -> None:
        if submap.frame is None or submap.frame.points is None:
            return
        desc_d = scan_context_descriptor(submap.frame.points, submap.frame.mask,
                                         self.max_range, self.n_rings, self.n_sectors)
        desc = to_numpy(desc_d)
        cur = len(self.descriptors)
        self.descriptors.append(desc)
        self._device_descriptors.append(desc_d)
        self.ring_keys.append(ring_key(desc))
        self.submap_ids.append(int(submap.id))

        n_hist = cur - self.exclude_recent
        if n_hist <= 0:
            return
        keys = np.stack(self.ring_keys[:n_hist])
        d_key = np.linalg.norm(keys - self.ring_keys[cur][None], axis=1)
        cands = np.argsort(d_key)[:self.ring_key_candidates]
        dists, _ = sc_distance(desc_d, torch.stack([self._device_descriptors[j]
                                                    for j in cands]))
        best: Optional[tuple] = None
        for j, dist in zip(cands, to_numpy(dists).tolist()):
            if dist < self.distance_threshold and (best is None or dist < best[1]):
                best = (int(j), dist)
        if best is not None:
            tgt, dist = best
            logger.info("ScanContext loop %d -> %d (dist %.3f)",
                        self.submap_ids[tgt], self.submap_ids[cur], dist)
            self.matches.append((tgt, cur, dist))
            GCB.request_to_add_loop(self.submap_ids[tgt], self.submap_ids[cur])


@register_module("extension", "scan_context")
def create_extension_module(*args, **kwargs):
    g = config_getter("scan_context")
    return ScanContextLoopDetector(
        n_rings=int(g("n_rings", 20)), n_sectors=int(g("n_sectors", 60)),
        max_range=float(g("max_range", 80.0)),
        distance_threshold=float(g("distance_threshold", 0.25)),
        ring_key_candidates=int(g("ring_key_candidates", 8)),
        exclude_recent=int(g("exclude_recent", 3)))
