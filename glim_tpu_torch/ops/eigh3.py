"""Closed-form eigendecomposition of batched symmetric 3x3 matrices.

Twin of ``glim_tpu/ops/eigh3.py``: Smith's trigonometric eigenvalues and
cross-product eigenvectors with pivoting on the most independent row pair,
returned in ascending eigenvalue order like ``torch.linalg.eigh``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-12


def eigvals_sym3x3(A: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 3) eigenvalues ascending."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))

    safe_p = torch.where(p > _EPS, p, torch.ones_like(p))
    c00, c11, c22 = b00 / safe_p, b11 / safe_p, b22 / safe_p
    c01, c02, c12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detB = (c00 * (c11 * c22 - c12 * c12)
            - c01 * (c01 * c22 - c12 * c02)
            + c02 * (c01 * c12 - c11 * c02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e2 = q + 2.0 * p * torch.cos(phi)
    e0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e1 = 3.0 * q - e0 - e2
    deg = p <= _EPS
    e0 = torch.where(deg, q, e0)
    e1 = torch.where(deg, q, e1)
    e2 = torch.where(deg, q, e2)
    return torch.stack([e0, e1, e2], dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v / |v|, or the x axis where v vanishes."""
    nrm = torch.linalg.norm(v, dim=-1, keepdim=True)
    unit_x = torch.eye(3, dtype=v.dtype, device=v.device)[0].expand_as(v)
    return torch.where(nrm > 1e-20, v / torch.clamp(nrm, min=1e-20), unit_x)


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector for eigenvalue lam via the cross product of the two most
    independent rows of (A - lam I)."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n = torch.stack([torch.sum(c01 * c01, -1), torch.sum(c02 * c02, -1),
                     torch.sum(c12 * c12, -1)], dim=-1)
    best = n.argmax(dim=-1)      # first maximum, as jnp.argmax
    v = torch.where((best == 0)[..., None], c01,
                    torch.where((best == 1)[..., None], c02, c12))
    return _unit(v)


def eigh_sym3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 3, 3) symmetric -> (eigvals (..., 3) ascending, eigvecs
    (..., 3, 3) with eigvecs[..., :, i] the i-th eigenvector)."""
    w = eigvals_sym3x3(A)
    v0 = _eigvec_for(A, w[..., 0])
    v2 = _eigvec_for(A, w[..., 2])
    # Re-orthogonalise v0 against v2 (f32 drift in near-degenerate spectra),
    # then the middle vector is the orthogonal complement.
    v0 = _unit(v0 - torch.sum(v0 * v2, dim=-1, keepdim=True) * v2)
    v1 = torch.linalg.cross(v2, v0)
    return w, torch.stack([v0, v1, v2], dim=-1)
