"""Plain reference for the CT cells: one scan step of the LiDAR-only
continuous-time odometry (CT-GICP), worked out again in plain torch.

It imports nothing of the program and takes nothing the program made but the
step's inputs. It follows the published method (Dellenbach et al., "CT-ICP:
Real-time Elastic LiDAR Odometry with Loop Closure", ICRA 2022, as upstream
GLIM's ``odometry_estimation_ct.cpp`` runs it with gtsam_points'
``IntegratedCT_GICPFactor``):

- each scan has a begin pose T_b and an end pose T_e; a point at normalised
  time s in [0, 1] sits at T(s) = T_b Exp(s log(T_b^-1 T_e));
- its residual is the GICP Mahalanobis distance to the nearest model point,
  weighted by (C_model + R(s) C_scan R(s)^T)^-1, where C_scan is the point's
  plane-regularised covariance from the given neighbours (eigenvalues 1e-3,
  1, 1) and C_model the model point's; a point farther than
  ``max_dist`` from its nearest model point has no residual;
- a location-consistency prior holds T_b to the previous scan's end, and a
  constant-velocity prior holds T_e to T_b Exp(damping * twist * dt), each
  scaled by its weight (the preset's ``location_consistency_inf_scale`` and
  ``constant_velocity_inf_scale``);
- the nearest neighbour is found by brute force over the valid model points,
  in blocks of queries, exact differences (no matmul expansion).

The port departs from upstream in these ways, and the reference follows:

1. damped Gauss-Newton, (H + 1e-6 diag(H) + 1e-9 I) delta = -b, for a fixed
   ``iters`` (8) iterations, instead of Levenberg-Marquardt with its own stop;
2. the correspondences are searched again every 2 iterations (4 searches at
   8 iterations), not at every linearisation;
3. the per-point Jacobian of T(s) is split across the begin and end blocks
   with weights (1 - s, s) (the paper's approximation), and the
   constant-velocity prior's target T_b Exp(...) is held fixed while its
   Jacobian is taken with respect to T_e alone;
4. the first scan's solve (against an empty model) is discarded: its poses
   are the extrapolated guess and its twist the one it came with;
5. the model is a bounded point map: one point a ``min_dist`` sub-voxel
   (points already there win; the survivor takes the newest age of its
   sub-voxel), points untouched for ``lru_horizon`` steps expire, and a full
   map keeps the newest ``capacity`` points, instead of iVox's LRU grid of
   voxels;
6. the model update keeps each valid point whose uniform draw is under
   ``update_budget / C`` (every valid point during the first
   ``bootstrap_frames`` steps), instead of iVox's distance-based insertion.

Which points of one age leave a full model is the program's own choice (its
hash order) and is not drawn again here; the count kept and their ages are.

Rotations here are below pi / 2 (a scan's motion and the priors' residuals):
the logarithm is taken from the antisymmetric part and the trace. The prior
Jacobian is the right Jacobian's inverse of SE(3) by its Bernoulli series to
ad^6, exact in float32 for residuals below 0.5.

Everything is float32. ``full_float32`` switches TF32 off around the
reference's own work and restores the flags after, so that it neither hides
nor undoes a control that switches TF32 on for the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

PLANE_EPS = 1e-3
INNER = 2              # Gauss-Newton iterations per correspondence search
QUERY_BLOCK = 2048     # queries a brute-force block


@contextlib.contextmanager
def full_float32():
    """TF32 off for float32 matmuls and convolutions inside; the flags and
    the matmul precision as they were after."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


# ---------------------------------------------------------------- SO(3), SE(3)
# Twists are [omega, v]; a pose perturbation is on the right, T Exp(xi).

def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with hat(w) x = w cross x."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coefficients(theta2: torch.Tensor):
    """sin t / t, (1 - cos t) / t^2 and (t - sin t) / t^3 for t^2 = theta2:
    by their series below t = 0.1, in closed form (the second through the
    half angle) above."""
    small = theta2 < 1e-2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    a = torch.where(small, 1 - theta2 / 6 * (1 - theta2 / 20 * (1 - theta2 / 42)),
                    torch.sin(t) / t)
    b = torch.where(small, 0.5 - theta2 / 24 * (1 - theta2 / 30 * (1 - theta2 / 56)),
                    2 * torch.sin(t / 2) ** 2 / t2)
    c = torch.where(small, 1 / 6 - theta2 / 120 * (1 - theta2 / 42 * (1 - theta2 / 72)),
                    (t - torch.sin(t)) / (t2 * t))
    return a, b, c


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 4, 4): R by Rodrigues, t = J_l(omega) v."""
    w, v = xi[..., :3], xi[..., 3:]
    W = hat(w)
    W2 = W @ W
    a, b, c = (x[..., None, None] for x in _coefficients(torch.sum(w * w, -1)))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * W + b * W2
    t = ((eye + b * W + c * W2) @ v[..., None])[..., 0]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = torch.zeros_like(T)
    out[..., :3, :3] = R.transpose(-1, -2)
    out[..., :3, 3] = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6), for rotations below pi / 2."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1) * 0.5
    sin_t = torch.linalg.norm(vee, dim=-1)
    cos_t = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    theta = torch.atan2(sin_t, cos_t)
    theta2 = theta * theta
    small = theta2 < 1e-2
    safe_sin = torch.where(small, torch.ones_like(sin_t), sin_t)
    ratio = torch.where(small, 1 + theta2 / 6 + 7 * theta2 * theta2 / 360, theta / safe_sin)
    w = vee * ratio[..., None]
    # J_l(omega)^-1 = I - W / 2 + k W^2, k = 1 / t^2 - (1 + cos t) / (2 t sin t).
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    k = torch.where(small, 1 / 12 + theta2 / 720 + theta2 * theta2 / 30240,
                    1 / safe2 - (1 + cos_t) / (2 * torch.sqrt(safe2) * safe_sin))
    W = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    v = ((eye - 0.5 * W + k[..., None, None] * (W @ W)) @ t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 6, 6): d log(Exp(xi) Exp(d)) / d d at d = 0,
    I + ad / 2 + ad^2 / 12 - ad^4 / 720 + ad^6 / 30240."""
    W, V = hat(xi[..., :3]), hat(xi[..., 3:])
    ad = torch.zeros(xi.shape[:-1] + (6, 6), dtype=xi.dtype, device=xi.device)
    ad[..., :3, :3] = W
    ad[..., 3:, 3:] = W
    ad[..., 3:, :3] = V
    ad2 = ad @ ad
    ad4 = ad2 @ ad2
    eye = torch.eye(6, dtype=xi.dtype, device=xi.device)
    return eye + ad / 2 + ad2 / 12 - ad4 / 720 + ad4 @ ad2 / 30240


def interpolate(T_b: torch.Tensor, T_e: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(4, 4), (4, 4), (C,) -> (C, 4, 4): T_b Exp(s log(T_b^-1 T_e))."""
    d = se3_log(se3_inv(T_b) @ T_e)
    return T_b @ se3_exp(s[:, None] * d)


# ------------------------------------------------------------------ the cost

def scan_covariances(pts: torch.Tensor, mask: torch.Tensor,
                     neighbors: torch.Tensor) -> torch.Tensor:
    """(C, 3), (C,), (C, k) -> (C, 3, 3): each valid point's covariance of its
    valid neighbours, with its eigenvalues set to (1e-3, 1, 1); identity for
    an invalid point."""
    nb = neighbors.long()
    q = pts[nb]
    w = mask[nb].to(pts.dtype)[..., None]
    n = torch.clamp(w.sum(1), min=1.0)
    mean = (q * w).sum(1) / n
    d = (q - mean[:, None]) * w
    cov = d.transpose(1, 2) @ d / n[..., None]
    _, vecs = torch.linalg.eigh(cov)
    normal = vecs[..., 0]
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    reg = eye - (1.0 - PLANE_EPS) * normal[:, :, None] * normal[:, None, :]
    return torch.where(mask[:, None, None], reg, eye)


def nearest(queries: torch.Tensor, targets: torch.Tensor, target_mask: torch.Tensor):
    """Index of each query's nearest valid target and the squared distance
    (inf without any valid target), by brute force in blocks of queries."""
    C = queries.shape[0]
    valid = torch.nonzero(target_mask).flatten()
    if valid.numel() == 0:
        return (torch.zeros(C, dtype=torch.long, device=queries.device),
                torch.full((C,), float("inf"), device=queries.device))
    P = targets[valid]
    idx = torch.empty(C, dtype=torch.long, device=queries.device)
    for i in range(0, C, QUERY_BLOCK):
        D = torch.cdist(queries[i:i + QUERY_BLOCK], P,
                        compute_mode="donot_use_mm_for_euclid_dist")
        idx[i:i + QUERY_BLOCK] = valid[torch.argmin(D, dim=1)]
    d2 = torch.sum((queries - targets[idx]) ** 2, dim=1)
    return idx, d2


def lookup(model: Dict[str, torch.Tensor], q: torch.Tensor, mask: torch.Tensor,
           max_dist: float):
    """(mu, C_model, hit) of world-frame queries against the model."""
    idx, d2 = nearest(q, model["points"], model["mask"])
    hit = mask & (d2 < max_dist * max_dist)
    return model["points"][idx], model["covs"][idx], hit


def linearize(T_b, T_e, pts, covs, s, mu, C_t, hit):
    """The matching cost's Gauss-Newton system over [xi_b, xi_e] with the
    given correspondences: (H (12, 12), b (12,), error)."""
    T = interpolate(T_b, T_e, s)
    R, t = T[:, :3, :3], T[:, :3, 3]
    r = mu - ((R @ pts[:, :, None])[:, :, 0] + t)
    S = C_t + R @ covs @ R.transpose(1, 2)
    info = torch.linalg.inv(torch.where(hit[:, None, None], S,
                                        torch.eye(3, device=pts.device)))
    info = torch.where(hit[:, None, None], info, torch.zeros_like(info))
    r = torch.where(hit[:, None], r, torch.zeros_like(r))
    # d r / d xi of T(s) Exp(xi): [R hat(p), -R].
    J = torch.cat([R @ hat(pts), -R], dim=2)
    Jt = J.transpose(1, 2)
    H_p = Jt @ info @ J
    b_p = (Jt @ info @ r[:, :, None])[:, :, 0]
    wb, we = 1.0 - s, s
    H = torch.zeros(12, 12, device=pts.device)
    H[:6, :6] = ((wb * wb)[:, None, None] * H_p).sum(0)
    H[:6, 6:] = ((wb * we)[:, None, None] * H_p).sum(0)
    H[6:, :6] = H[:6, 6:]
    H[6:, 6:] = ((we * we)[:, None, None] * H_p).sum(0)
    b = torch.cat([(wb[:, None] * b_p).sum(0), (we[:, None] * b_p).sum(0)])
    err = torch.sum(r * (info @ r[:, :, None])[:, :, 0])
    return H, b, err


def prior(T: torch.Tensor, anchor: torch.Tensor, weight: float):
    """A 6-dof prior r = log(anchor^-1 T), scaled by ``weight``: (H6, b6)."""
    r = se3_log(se3_inv(anchor) @ T)
    J = right_jacobian_inv(r)
    return weight * J.T @ J, weight * J.T @ r


def solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The damped step -(H + 1e-6 diag(H) + 1e-9 I)^-1 b, on the
    Jacobi-scaled system."""
    A = H + torch.diag(1e-6 * torch.diagonal(H) + 1e-9)
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-12))
    y = torch.linalg.solve(A * d[:, None] * d[None, :], (b * d)[:, None])[:, 0]
    return -y * d


# ----------------------------------------------------------------- the model

def model_insert(model: Dict[str, torch.Tensor], points, keep, covs, step: int):
    """The bounded point model after inserting the kept points at ``step``."""
    M = model["points"].shape[0]
    dev = points.device
    pts = torch.cat([model["points"], points])
    cov = torch.cat([model["covs"], covs])
    valid = torch.cat([model["mask"], keep])
    age = torch.cat([torch.where(model["mask"], model["age"].long(), -1),
                     torch.where(keep, step, -1)])
    n = pts.shape[0]
    rows = torch.nonzero(valid).flatten()
    out = dict(points=torch.zeros_like(model["points"]), covs=torch.zeros_like(model["covs"]),
               mask=torch.zeros_like(model["mask"]),
               age=torch.zeros_like(model["age"]), min_dist=model["min_dist"],
               lru_horizon=model["lru_horizon"])
    if rows.numel() == 0:
        return out
    cell = torch.floor(pts[rows] / model["min_dist"]).long()
    _, group = torch.unique(cell, dim=0, return_inverse=True)
    G = int(group.max()) + 1
    # The survivor of a sub-voxel: a point already in the model first, then
    # the lowest row; it takes the newest age of its sub-voxel.
    order_key = torch.where(rows < M, rows, rows + n)
    first = torch.full((G,), 2 * n, dtype=torch.long, device=dev).scatter_reduce(
        0, group, order_key, "amin", include_self=False)
    newest = torch.full((G,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, group, age[rows], "amax", include_self=False)
    src = torch.where(first >= n, first - n, first)
    alive = newest >= step - int(model["lru_horizon"])
    src, newest = src[alive], newest[alive]
    top = torch.argsort(newest, descending=True, stable=True)[:M]
    src, newest = src[top], newest[top]
    k = src.numel()
    out["points"][:k] = pts[src]
    out["covs"][:k] = cov[src]
    out["mask"][:k] = True
    out["age"][:k] = newest.to(out["age"].dtype)
    return out


# ------------------------------------------------------------------ the step

def ct_step(T_prev_e, twist_prev, step: int, model: Dict[str, torch.Tensor], pts, times,
            mask, neighbors, dt, uniforms, *, max_dist: float, loc_weight: float,
            cv_weight: float, damping: float, iters: int, bootstrap_frames: int,
            update_budget: int) -> Dict[str, torch.Tensor]:
    """One scan step from the previous end pose, twist and model: the begin
    and end poses, the twist, the deskewed scan (in the begin frame), its
    covariances, the model after the update and the matching error at each
    correspondence search."""
    with full_float32():
        dev = pts.device
        dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
        t_max = torch.max(torch.where(mask, times, torch.zeros_like(times)))
        s = torch.clamp(times / torch.clamp(t_max, min=1e-6), 0.0, 1.0)
        covs = scan_covariances(pts, mask, neighbors)

        cv_target = damping * twist_prev * dt
        T_b0, T_e0 = T_prev_e, T_prev_e @ se3_exp(cv_target)
        T_b, T_e = T_b0, T_e0
        errs = []
        for _ in range(max(1, iters // INNER)):
            T = interpolate(T_b, T_e, s)
            q = (T[:, :3, :3] @ pts[:, :, None])[:, :, 0] + T[:, :3, 3]
            mu, C_t, hit = lookup(model, q, mask, max_dist)
            for _ in range(INNER):
                H, b, err = linearize(T_b, T_e, pts, covs, s, mu, C_t, hit)
                Hl, bl = prior(T_b, T_prev_e, loc_weight)
                Hc, bc = prior(T_e, T_b @ se3_exp(cv_target), cv_weight)
                H = H.clone()
                H[:6, :6] += Hl
                H[6:, 6:] += Hc
                b = b + torch.cat([bl, bc])
                delta = solve(H, b)
                T_b, T_e = T_b @ se3_exp(delta[:6]), T_e @ se3_exp(delta[6:])
            errs.append(err)
        if step == 0:
            T_b, T_e = T_b0, T_e0
            twist = twist_prev
        else:
            twist = se3_log(se3_inv(T_b) @ T_e) / torch.clamp(dt, min=1e-4)

        Ts = interpolate(torch.eye(4, device=dev), se3_inv(T_b) @ T_e, s)
        deskewed = (Ts[:, :3, :3] @ pts[:, :, None])[:, :, 0] + Ts[:, :3, 3]
        R = T_b[:3, :3]
        rate = 1.0 if step < bootstrap_frames else update_budget / pts.shape[0]
        keep = mask & (uniforms < rate)
        new_model = model_insert(model, deskewed @ R.T + T_b[:3, 3], keep,
                                 R @ covs @ R.T, step)
        return dict(T_b=T_b, T_e=T_e, twist=twist, deskewed=deskewed, covs=covs,
                    model=new_model, errs=torch.stack(errs))
