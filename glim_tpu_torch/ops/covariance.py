"""Per-point covariance & normal estimation from kNN neighborhoods.

Twin of ``glim_tpu/ops/covariance.py``: gather each point's k neighbours,
form the 3x3 scatter, regularise (PLANE replaces the spectrum with
diag(eps, 1, 1) in the eigenbasis), normal = smallest-eigenvalue direction
oriented toward the sensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from glim_tpu_torch.ops.eigh3 import eigh_sym3x3

PLANE = "plane"
NORMALIZED_MIN_EIG = "normalized_min_eig"
FROBENIUS = "frobenius"
NONE = "none"


def estimate_covariances(points: torch.Tensor, mask: torch.Tensor,
                         neighbors: torch.Tensor, regularization: str = PLANE,
                         plane_eps: float = 1e-3
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (C, 3), mask (C,), neighbors (C, k) -> (covs (C, 3, 3),
    normals (C, 3)). Invalid lanes get identity covs and zero normals."""
    nb = neighbors.to(torch.int64)
    neigh = points[nb]                               # (C, k, 3)
    w = mask[nb].to(points.dtype)                    # (C, k)
    cnt = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(neigh * w[..., None], dim=-2) / cnt
    d = (neigh - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("cki,ckj->cij", d, d) / cnt[..., None]

    eigvals, eigvecs = eigh_sym3x3(cov)
    eye = torch.eye(3, dtype=points.dtype, device=points.device)

    if regularization == PLANE:
        # Built on the device (fills, no host-to-device copy).
        lam = torch.cat([torch.full((1,), plane_eps, dtype=points.dtype, device=points.device),
                         torch.ones(2, dtype=points.dtype, device=points.device)])
        cov_r = torch.einsum("cij,j,ckj->cik", eigvecs, lam, eigvecs)
    elif regularization == NORMALIZED_MIN_EIG:
        lam_max = torch.clamp(eigvals[..., 2:3], min=1e-12)
        lam = torch.clamp(eigvals / lam_max, min=plane_eps)
        cov_r = torch.einsum("cij,cj,ckj->cik", eigvecs, lam, eigvecs)
    elif regularization == FROBENIUS:
        cov_f = cov + 1e-3 * eye
        norm = torch.linalg.norm(cov_f.reshape(-1, 9), dim=-1).reshape(-1, 1, 1)
        cov_r = cov_f / torch.clamp(norm, min=1e-12)
    else:
        cov_r = cov

    normals = eigvecs[..., :, 0]
    flip = torch.sum(normals * points, dim=-1, keepdim=True) > 0.0
    normals = torch.where(flip, -normals, normals)

    cov_r = torch.where(mask[:, None, None], cov_r, eye.expand_as(cov_r))
    normals = torch.where(mask[:, None], normals, 0.0)
    return cov_r, normals


def estimate_normals(points: torch.Tensor, mask: torch.Tensor,
                     neighbors: torch.Tensor) -> torch.Tensor:
    """Per-point normals only: those of ``estimate_covariances(..., NONE)``."""
    return estimate_covariances(points, mask, neighbors, NONE)[1]


def outlier_mask(sq_dists: torch.Tensor, mask: torch.Tensor,
                 std_mul_factor=1.0) -> torch.Tensor:
    """Statistical outlier removal on kNN distances: keep a point if its mean
    neighbour distance is below mean + std * factor over the cloud."""
    d = torch.sqrt(torch.clamp(sq_dists, min=0.0))
    d = torch.where(torch.isfinite(d), d, 0.0)
    mean_k = torch.mean(d, dim=-1)
    valid = mask.to(d.dtype)
    n = torch.clamp(valid.sum(), min=1.0)
    mu = torch.sum(mean_k * valid) / n
    var = torch.sum((mean_k - mu) ** 2 * valid) / n
    thresh = mu + torch.sqrt(torch.clamp(var, min=0.0)) * std_mul_factor
    return mask & (mean_k < thresh)
