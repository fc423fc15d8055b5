"""Dense damped Gauss-Newton solve and Schur marginalization.

Twin of the parts of ``glim_tpu/ops/solver.py`` the odometry window uses.
``jnp.linalg.cholesky`` returns NaN on a non-PD matrix where
``torch.linalg.cholesky`` raises, so the factorisations here are the
``*_ex`` variants, and the LU fallback is selected with ``torch.where`` on
device — no host branch, no per-iteration synchronisation.
"""

from __future__ import annotations

import torch


def solve_damped(H: torch.Tensor, b: torch.Tensor, lam) -> torch.Tensor:
    """Solve (H + lam * diag(H) + eps I) delta = -b.

    Cholesky on the Jacobi-equilibrated system (D^-1 A D^-1) plus one
    iterative-refinement step; where the factorisation fails or yields a
    non-finite step, the LU solve of the unscaled system is taken instead."""
    damping = lam * torch.diagonal(H) + 1e-9
    A = H + torch.diag(damping)
    d_inv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-12))
    As = A * d_inv[:, None] * d_inv[None, :]
    bs = (b * d_inv)[:, None]
    L, info = torch.linalg.cholesky_ex(As)
    y = torch.cholesky_solve(bs, L)
    y = y + torch.cholesky_solve(bs - As @ y, L)
    x = y[:, 0] * d_inv
    x_lu = torch.linalg.solve_ex(A, b)[0]
    ok = (info == 0) & torch.all(torch.isfinite(x))
    return -torch.where(ok, x, x_lu)


def schur_marginalize(H: torch.Tensor, b: torch.Tensor, n_keep: int):
    """Marginalize trailing variables by Schur complement.

    Layout x = [keep (n_keep dof) | marg (rest)]; returns the reduced
    (H', b') on the kept variables."""
    Hkk = H[:n_keep, :n_keep]
    Hkm = H[:n_keep, n_keep:]
    Hmm = H[n_keep:, n_keep:]
    bk = b[:n_keep]
    bm = b[n_keep:]
    Hmm_reg = Hmm + 1e-8 * torch.eye(Hmm.shape[0], dtype=H.dtype, device=H.device)
    sol = torch.linalg.solve_ex(Hmm_reg, torch.cat([Hkm.T, bm[:, None]], dim=1))[0]
    H_red = Hkk - Hkm @ sol[:, :n_keep]
    b_red = bk - Hkm @ sol[:, n_keep]
    return H_red, b_red
