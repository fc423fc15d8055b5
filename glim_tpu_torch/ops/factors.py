"""Small analytic factors: SE3 between factors with a Huber weight, SE3
prior, translation prior, rotated-vector constraint and linear damping,
batched.

Twin of ``glim_tpu/ops/factors.py``. Residuals follow the right-retraction
convention x (+) xi = x * Exp(xi). Jacobians are exact, by forward-mode
``torch.func.jacfwd`` on the retraction parameters, vmapped over the factor
batch and evaluated in float64 (see ``batched_jacobian``); J and r are cast
back to float32 and the GN blocks are formed in float32, as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch.func import jacfwd, vmap

from glim_tpu_torch.ops.lie import forward_ad_lock, se3_exp, se3_inv, se3_log


def _f64(a):
    if isinstance(a, tuple):
        return tuple(map(_f64, a))
    return a.to(torch.float64) if a.is_floating_point() else a


def batched_jacobian(res: Callable, n: int, *batched, shared=()
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(J (B, m, n), r (B, m)) of ``res(x, *batched, *shared)`` at x = 0 for
    every row of the ``batched`` tensors (or tuples of tensors), which share
    a leading axis B; ``shared`` tensors are the same for every row.

    Evaluated in float64: forward-mode AD gives the tangent of a 0-dim
    float32 tensor combined with a Python float the dtype float64, which
    breaks the residual's matmuls, while in float64 primal and tangent
    agree (the window estimator does the same)."""
    def aux(x, *a):
        r = res(x, *a)
        return r, r

    b = [_f64(a) for a in batched]
    s = [_f64(a) for a in shared]
    first = b[0][0] if isinstance(b[0], tuple) else b[0]
    zero = torch.zeros(n, dtype=torch.float64, device=first.device)
    in_dims = (None,) + (0,) * len(b) + (None,) * len(s)
    with forward_ad_lock:
        J, r = vmap(jacfwd(aux, has_aux=True), in_dims=in_dims)(zero, *b, *s)
    return J.float(), r.float()


def _whitened(J: torch.Tensor, r: torch.Tensor, sqrt_info: torch.Tensor):
    """Diagonal-information GN blocks: (J^T W J, J^T W r, r^T W r), W =
    diag(sqrt_info^2), batched."""
    W = sqrt_info * sqrt_info
    Jt = J.transpose(-1, -2)
    return (Jt @ (W[..., None] * J), (Jt @ (W * r)[..., None])[..., 0],
            torch.sum(W * r * r, -1))


class BetweenBatch(NamedTuple):
    """Batched linearized between factors: for factor k with endpoints
    (i_k, j_k), r_k = log(Z_k^-1 T_i^-1 T_j), whitened by sqrt_info and
    Huber-weighted. H blocks (B, 6, 6), b blocks (B, 6)."""

    H_ii: torch.Tensor
    H_ij: torch.Tensor
    H_jj: torch.Tensor
    b_i: torch.Tensor
    b_j: torch.Tensor
    error: torch.Tensor   # (B,)
    weight: torch.Tensor  # (B,) robust weights applied


def between_linearize(T_i: torch.Tensor, T_j: torch.Tensor, Z: torch.Tensor,
                      sqrt_info: torch.Tensor, huber_k: torch.Tensor) -> BetweenBatch:
    """Batched SE3 between factors. T_i, T_j (B, 4, 4) the endpoints' world
    poses, Z (B, 4, 4) the measured relative pose i -> j, sqrt_info (B, 6)
    the diagonal whitening, huber_k (B,) the Huber threshold on the
    whitened norm (<= 0 disables it). Both endpoints' Jacobians come from
    one 12-dof ``batched_jacobian``."""
    def res(x, Ti, Tj, Zi):
        return se3_log(Zi @ se3_inv(Ti @ se3_exp(x[:6])) @ (Tj @ se3_exp(x[6:])))

    J, r = batched_jacobian(res, 12, T_i, T_j, se3_inv(Z))
    J_i, J_j = J[..., :6], J[..., 6:]
    norm = torch.linalg.norm(sqrt_info * r, dim=-1)
    w = torch.where(huber_k > 0, torch.clamp(huber_k / torch.clamp(norm, min=1e-12), max=1.0),
                    torch.ones_like(norm))
    W = sqrt_info * sqrt_info * w[:, None]           # diag info x robust weight
    Jt_i, Jt_j = J_i.transpose(-1, -2), J_j.transpose(-1, -2)
    Wr = (W * r)[..., None]
    return BetweenBatch(H_ii=Jt_i @ (W[..., None] * J_i), H_ij=Jt_i @ (W[..., None] * J_j),
                        H_jj=Jt_j @ (W[..., None] * J_j), b_i=(Jt_i @ Wr)[..., 0],
                        b_j=(Jt_j @ Wr)[..., 0], error=torch.sum(W * r * r, -1), weight=w)


def scatter_between(H: torch.Tensor, b: torch.Tensor, batch: BetweenBatch,
                    idx_i: torch.Tensor, idx_j: torch.Tensor):
    """Add the batched between blocks into the dense (6N, 6N) system and its
    (6N,) vector -> (H, b), new tensors; blocks at a repeated endpoint or
    pair add up (``index_put`` with accumulate)."""
    ar = torch.arange(6, device=H.device)
    ri = (idx_i.to(torch.int64)[:, None] * 6 + ar)   # (B, 6) rows of i
    rj = (idx_j.to(torch.int64)[:, None] * 6 + ar)
    rows = torch.cat([ri, ri, rj, rj])[:, :, None].expand(-1, 6, 6)
    cols = torch.cat([ri, rj, ri, rj])[:, None, :].expand(-1, 6, 6)
    blocks = torch.cat([batch.H_ii, batch.H_ij, batch.H_ij.transpose(-1, -2), batch.H_jj])
    H = H.index_put((rows.reshape(-1), cols.reshape(-1)), blocks.reshape(-1), accumulate=True)
    b = b.index_put((torch.cat([ri, rj]).reshape(-1),),
                    torch.cat([batch.b_i, batch.b_j]).reshape(-1), accumulate=True)
    return H, b


def prior_linearize(T: torch.Tensor, Z: torch.Tensor, sqrt_info: torch.Tensor):
    """Batched SE3 prior factors: r = log(Z^-1 T). T, Z (B, 4, 4), sqrt_info
    (B, 6) -> (H (B, 6, 6), b (B, 6), err (B,))."""
    J, r = batched_jacobian(lambda x, Ti, Zi: se3_log(Zi @ (Ti @ se3_exp(x))), 6,
                            T, se3_inv(Z))
    return _whitened(J, r, sqrt_info)


def translation_prior_linearize(T: torch.Tensor, t_meas: torch.Tensor,
                                sqrt_info: torch.Tensor):
    """Batched translation-only priors: r = T.t - t_meas, whitened by
    diag(sqrt_info); rotation is left free. -> (H (B, 6, 6), b (B, 6),
    err (B,))."""
    J, r = batched_jacobian(lambda x, Ti, tm: (Ti @ se3_exp(x))[:3, 3] - tm, 6,
                            T, t_meas)
    return _whitened(J, r, sqrt_info)


def rotate_vector3_linearize(T: torch.Tensor, v_local: torch.Tensor,
                             v_world: torch.Tensor, sqrt_info: torch.Tensor):
    """Batched rotated-vector constraint: r = R(T) @ v_local - v_world
    (a session's gravity direction against the map's), whitened by
    diag(sqrt_info). -> (H (B, 6, 6), b (B, 6), err (B,)); the translation
    columns are zero."""
    J, r = batched_jacobian(lambda x, Ti, vl, vw: (Ti @ se3_exp(x))[:3, :3] @ vl - vw, 6,
                            T, v_local, v_world)
    return _whitened(J, r, sqrt_info)


def linear_damping(dim: int, scale, device) -> torch.Tensor:
    """An isotropic information block added at a key to fix gauge freedom or
    recover an indeterminate system."""
    return torch.eye(dim, device=device) * scale
