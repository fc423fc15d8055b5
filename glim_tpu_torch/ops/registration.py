"""Global registration: FPFH features, feature matching, RANSAC and
graduated non-convexity.

Twin of ``glim_tpu/ops/registration.py`` (the gtsam_points helpers
``estimate_fpfh``, ``estimate_pose_ransac``, ``estimate_pose_gnc`` and
``find_inlier_points``):

- FPFH: the 33-bin histogram (3 Darboux angles x 11 bins) over the exact
  kNN graph, then the distance-weighted neighbourhood sum.
- Feature matching: the argmin of the (Ns, Nt) descriptor distances, one
  matrix product, with the mutual (reciprocal) check.
- RANSAC: all hypotheses at once. Triplets are drawn with probability
  proportional to ``valid`` by ``torch.multinomial`` from a generator seeded
  with ``RANSACParams.seed`` (``_ransac_core`` takes injected draws instead,
  for tests). A triplet whose side lengths disagree between source and
  target, or that is degenerate, fails the rigidity gate; its cross-
  covariance is replaced by the identity before the batched SVD, so the
  SVD only sees the gate's survivors, and it collects no inliers.
- GNC: Geman-McClure weights, iteratively reweighted Kabsch with a
  mu-continuation, one Python loop iteration a step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from glim_tpu_torch.ops.knn import knn_self
from glim_tpu_torch.types import to_numpy

FPFH_DIM = 33
_HYPOTHESIS_CHUNK = 512     # hypotheses scored at once (bounds the (H, C, 3) temporaries)


class RegistrationResult(NamedTuple):
    T_target_source: torch.Tensor   # (4, 4)
    inlier_fraction: torch.Tensor   # ()
    num_inliers: torch.Tensor       # ()


def estimate_fpfh(points: torch.Tensor, normals: torch.Tensor, mask: torch.Tensor,
                  k: int = 10) -> torch.Tensor:
    """(C, 3) points and normals -> (C, 33) FPFH descriptors (zero rows for
    invalid points)."""
    nbr, _ = knn_self(points, mask, k)
    nbr = nbr.to(torch.int64)
    p1, n1 = points[:, None, :], normals[:, None, :]
    p2, n2 = points[nbr], normals[nbr]                            # (C, k, 3)
    dvec = p2 - p1
    dist = torch.linalg.norm(dvec, dim=-1)
    d_unit = dvec / torch.clamp(dist[..., None], min=1e-9)

    u = n1.expand(p2.shape)
    v = torch.linalg.cross(d_unit, u)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)
    w = torch.linalg.cross(u, v)

    alpha = torch.sum(v * n2, dim=-1)                             # in [-1, 1]
    phi = torch.sum(u * d_unit, dim=-1)                           # in [-1, 1]
    theta = torch.atan2(torch.sum(w * n2, dim=-1), torch.sum(u * n2, dim=-1))

    valid = mask[:, None] & mask[nbr] & (dist > 1e-9)
    validf = valid.to(points.dtype)

    def hist11(x, lo, hi):
        b = torch.clamp(((x - lo) / (hi - lo) * 11).to(torch.int32), 0, 10)
        oh = torch.nn.functional.one_hot(b.to(torch.int64), 11).to(points.dtype)
        return torch.sum(oh * validf[..., None], dim=1)           # (C, 11)

    spfh = torch.cat([hist11(alpha, -1.0, 1.0), hist11(phi, -1.0, 1.0),
                      hist11(theta, -np.pi, np.pi)], dim=-1)      # (C, 33)
    nvalid = torch.clamp(valid.sum(dim=1), min=1)
    spfh = spfh / nvalid[:, None]

    wgt = torch.where(valid, 1.0 / torch.clamp(dist, min=1e-3), 0.0)  # (C, k)
    acc = torch.einsum("ck,ckf->cf", wgt, spfh[nbr])
    wsum = torch.clamp(torch.sum(wgt, dim=1), min=1e-9)
    fpfh = spfh + acc / wsum[:, None]
    fpfh = fpfh / torch.clamp(torch.sum(fpfh, dim=-1, keepdim=True), min=1e-9)
    return torch.where(mask[:, None], fpfh, 0.0)


def match_features(src_feat: torch.Tensor, src_mask: torch.Tensor,
                   tgt_feat: torch.Tensor, tgt_mask: torch.Tensor):
    """Mutual nearest-neighbour descriptor correspondences -> (corr (Cs,)
    int64, mutual (Cs,) bool); ties to the lowest index."""
    s2 = torch.sum(src_feat * src_feat, dim=-1, keepdim=True)
    t2 = torch.sum(tgt_feat * tgt_feat, dim=-1)
    d2 = s2 + t2[None, :] - 2.0 * (src_feat @ tgt_feat.T)
    d2 = torch.where(tgt_mask[None, :], d2, float("inf"))
    d2 = torch.where(src_mask[:, None], d2, float("inf"))
    corr = torch.argmin(d2, dim=-1)
    back = torch.argmin(d2, dim=0)
    mutual = src_mask & (back[corr] == torch.arange(corr.shape[0], device=corr.device))
    return corr, mutual


def _kabsch(src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor,
            S_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted rigid alignment src -> tgt, batched over leading axes:
    (..., C, 3), (..., C, 3), (..., C) -> (..., 4, 4). Where ``S_ok`` is
    false the cross-covariance is replaced by the identity before the SVD."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    mu_s = torch.sum(w[..., None] * src, dim=-2) / wsum
    mu_t = torch.sum(w[..., None] * tgt, dim=-2) / wsum
    S = torch.einsum("...c,...ci,...cj->...ij", w, src - mu_s[..., None, :],
                     tgt - mu_t[..., None, :])
    if S_ok is not None:
        eye = torch.eye(3, dtype=S.dtype, device=S.device)
        S = torch.where(S_ok[..., None, None], S, eye)
    U, _, Vh = torch.linalg.svd(S)
    d = torch.sign(torch.linalg.det(Vh.mT @ U.mT))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = Vh.mT @ D @ U.mT
    t = mu_t - (R @ mu_s[..., None])[..., 0]
    T = torch.eye(4, dtype=S.dtype, device=S.device).expand(R.shape[:-2] + (4, 4)).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


@dataclass
class RANSACParams:
    max_iterations: int = 4096
    inlier_threshold: float = 0.5
    early_stop_fraction: float = 0.9  # informational; fixed-size batch anyway
    seed: int = 0


def _transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[..., :3, :3].mT + T[..., None, :3, 3]


def draw_triplets(valid: torch.Tensor, n_hypotheses: int, seed: int) -> torch.Tensor:
    """(n_hypotheses, 3) indices drawn with probability proportional to
    ``valid`` (uniform when no entry is valid), from a generator on
    ``valid``'s device seeded with ``seed``."""
    g = torch.Generator(device=valid.device).manual_seed(seed)
    p = valid.to(torch.float32)
    p = torch.where(valid.any(), p, torch.ones_like(p))
    return torch.multinomial(p, n_hypotheses * 3, replacement=True,
                             generator=g).reshape(n_hypotheses, 3)


def _ransac_core(src, tgt, corr, valid, thresh: float, n_hypotheses: int, seed: int = 0,
                 idx: Optional[torch.Tensor] = None):
    """RANSAC over ``n_hypotheses`` triplets (``idx`` (H, 3) injects the
    draws), then Kabsch on the best hypothesis' inliers -> (result,
    per-source-point inlier mask)."""
    if idx is None:
        idx = draw_triplets(valid, n_hypotheses, seed)
    idx = idx.to(torch.int64)
    tgt_c = tgt[corr]
    s3, t3 = src[idx], tgt_c[idx]                                 # (H, 3, 3)
    w3 = valid[idx].to(src.dtype)
    pairs = ((0, 1), (1, 2), (0, 2))
    ls = torch.stack([torch.linalg.norm(s3[:, a] - s3[:, b], dim=-1) for a, b in pairs], -1)
    lt = torch.stack([torch.linalg.norm(t3[:, a] - t3[:, b], dim=-1) for a, b in pairs], -1)
    compatible = torch.all(torch.abs(ls - lt) < thresh, dim=-1) & (ls.min(dim=-1).values > thresh)
    Ts = _kabsch(s3, t3, w3 + 1e-6, S_ok=compatible)
    inls = []
    for h in range(0, Ts.shape[0], _HYPOTHESIS_CHUNK):
        d2 = torch.sum((_transform(Ts[h:h + _HYPOTHESIS_CHUNK], src) - tgt_c) ** 2, dim=-1)
        inls.append(torch.sum((d2 < thresh * thresh) & valid, dim=-1))
    inls = torch.where(compatible, torch.cat(inls), 0)
    T_best = Ts[torch.argmax(inls)]

    d2 = torch.sum((_transform(T_best, src) - tgt_c) ** 2, dim=-1)
    w = ((d2 < thresh * thresh) & valid).to(src.dtype)
    T_ref = _kabsch(src, tgt_c, w + 1e-9)
    d2 = torch.sum((_transform(T_ref, src) - tgt_c) ** 2, dim=-1)
    inliers = (d2 < thresh * thresh) & valid
    n_inl = torch.sum(inliers)
    frac = n_inl / torch.clamp(torch.sum(valid), min=1)
    return RegistrationResult(T_ref, frac, n_inl), inliers


def estimate_pose_ransac(src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
                         params: Optional[RANSACParams] = None):
    """Feature-based RANSAC global registration -> (RegistrationResult,
    per-source-point inlier mask)."""
    p = params or RANSACParams()
    corr, mutual = match_features(src_feat, src_mask, tgt_feat, tgt_mask)
    return _ransac_core(src_pts, tgt_pts, corr, mutual, p.inlier_threshold,
                        p.max_iterations, p.seed)


@dataclass
class GNCParams:
    max_iterations: int = 20
    inlier_threshold: float = 0.5
    mu_init: float = 1e3
    mu_factor: float = 1.4
    seed: int = 0


def _gnc_core(src, tgt_c, valid, thresh: float, mu0: float, mu_factor: float, iters: int):
    """Geman-McClure GNC from the identity -> (result, inlier mask)."""
    eps2 = thresh * thresh
    T = torch.eye(4, dtype=src.dtype, device=src.device)
    mu = mu0
    for _ in range(iters):
        r2 = torch.sum((_transform(T, src) - tgt_c) ** 2, dim=-1)
        w = (mu * eps2 / (r2 + mu * eps2)) ** 2
        w = torch.where(valid, w, 0.0)
        T = _kabsch(src, tgt_c, w + 1e-12)
        mu = max(mu / mu_factor, 1.0)
    d2 = torch.sum((_transform(T, src) - tgt_c) ** 2, dim=-1)
    inliers = (d2 < eps2) & valid
    n_inl = torch.sum(inliers)
    frac = n_inl / torch.clamp(torch.sum(valid), min=1)
    return RegistrationResult(T, frac, n_inl), inliers


def estimate_pose_gnc(src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
                      params: Optional[GNCParams] = None):
    """Graduated-non-convexity global registration -> (RegistrationResult,
    per-source-point inlier mask)."""
    p = params or GNCParams()
    corr, mutual = match_features(src_feat, src_mask, tgt_feat, tgt_mask)
    return _gnc_core(src_pts, tgt_pts[corr], mutual, p.inlier_threshold, p.mu_init,
                     p.mu_factor, p.max_iterations)


def find_inlier_points(points: torch.Tensor, inlier_mask: torch.Tensor) -> np.ndarray:
    """The inlier subset on the host."""
    return to_numpy(points)[to_numpy(inlier_mask)]
