"""Dense damped Gauss-Newton solve, the host-loop LM and Schur marginalization.

Twin of ``glim_tpu/ops/solver.py``'s ``solve_damped``, ``lm_optimize`` (with
``TerminationCriteria``, ``LMStatus``, ``LMResult``) and
``schur_marginalize``.
``jnp.linalg.cholesky`` returns NaN on a non-PD matrix where
``torch.linalg.cholesky`` raises, so the factorisations here are the
``*_ex`` variants, and the LU fallback is selected with ``torch.where`` on
device — no host branch, no per-iteration synchronisation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import torch

from glim_tpu_torch.types import to_numpy


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


@dataclass
class TerminationCriteria:
    """Convergence thresholds (the reference's custom LM termination,
    odometry_estimation_cpu.cpp:120-133: eps_trans / eps_rot on the update)."""

    max_iterations: int = 8
    eps_rot: float = 1e-4
    eps_trans: float = 1e-4
    relative_error_tol: float = 1e-6


@dataclass
class LMStatus:
    """Per-trial-step status handed to callbacks."""

    iteration: int = 0
    error: float = 0.0
    new_error: float = 0.0
    lambda_: float = 0.0
    accepted: bool = True
    delta_norm: float = 0.0


@dataclass
class LMResult:
    x: Any = None
    error: float = 0.0
    iterations: int = 0
    converged: bool = False
    statuses: List[LMStatus] = field(default_factory=list)


def lm_optimize(linearize_fn: Callable[[Any], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                retract_fn: Callable[[Any, torch.Tensor], Any], x0: Any,
                criteria: Optional[TerminationCriteria] = None, init_lambda: float = 1e-5,
                lambda_factor: float = 10.0,
                callback: Optional[Callable[[LMStatus], None]] = None) -> LMResult:
    """Host-loop Levenberg-Marquardt: ``linearize_fn(x)`` gives (H, b, error)
    on the device, ``retract_fn(x, delta)`` applies the stacked update, and
    the damping is decided on the host. Each trial step makes one host read
    (its error, the update's norm and, for 6-dof blocks, their largest
    rotation and translation norms), the start one more (the first error).
    ``callback`` fires after every trial step."""
    crit = criteria or TerminationCriteria()
    x = x0
    H, b, err_t = linearize_fn(x)
    err = float(to_numpy(err_t))
    lam = init_lambda
    result = LMResult(x=x, error=err)
    for it in range(crit.max_iterations):
        delta = solve_damped(H, b, lam)
        x_new = retract_fn(x, delta)
        H_new, b_new, err_new_t = linearize_fn(x_new)
        reads = [err_new_t.reshape(()).double(), torch.linalg.norm(delta).double()]
        blocks = delta.numel() % 6 == 0
        if blocks:
            d = delta.reshape(-1, 6)
            reads += [torch.linalg.norm(d[:, :3], dim=-1).max().double(),
                      torch.linalg.norm(d[:, 3:], dim=-1).max().double()]
        vals = to_numpy(torch.stack(reads)).tolist()
        err_new, delta_norm = vals[0], vals[1]

        accepted = err_new < err
        st = LMStatus(iteration=it, error=err, new_error=err_new, lambda_=lam,
                      accepted=accepted, delta_norm=delta_norm)
        if callback is not None:
            callback(st)
        result.statuses.append(st)

        if accepted:
            rel_decrease = (err - err_new) / max(err, 1e-12)
            x, H, b, err = x_new, H_new, b_new, err_new
            lam = max(lam / lambda_factor, 1e-10)
            if blocks:
                small = vals[2] < crit.eps_rot and vals[3] < crit.eps_trans
            else:
                small = delta_norm < min(crit.eps_rot, crit.eps_trans)
            if small or rel_decrease < crit.relative_error_tol:
                result.converged = True
                result.iterations = it + 1
                break
        else:
            lam = min(lam * lambda_factor, 1e6)
        result.iterations = it + 1

    result.x = x
    result.error = err
    return result
