"""Small analytic factors: SE3 prior, translation prior, rotated-vector
constraint and linear damping, batched.

Twin of the parts of ``glim_tpu/ops/factors.py`` that the matching-cost
global back-end uses (the pose-graph back-end's ``between_linearize`` and
``scatter_between`` come with it). Residuals follow the right-retraction
convention x (+) xi = x * Exp(xi). Jacobians are exact, by forward-mode
``torch.func.jacfwd`` on the retraction parameters, vmapped over the factor
batch and evaluated in float64 (see ``batched_jacobian``); J and r are cast
back to float32 and the GN blocks are formed in float32, as in the JAX
package.
"""

from __future__ import annotations

from typing import Callable, Tuple

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
