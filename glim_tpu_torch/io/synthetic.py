"""Synthetic LiDAR-IMU sequence generator for tests and benchmarks.

The reference repo ships no test data; its canonical validation is running a
real Ouster OS1-128 rosbag (reference docs/quickstart.md:6-10). For CI-able
numerical validation we instead simulate a spinning LiDAR + IMU moving through
an analytic scene (SURVEY.md §4 implication (2)): world landmarks on walls /
floor / pillars, scans taken along a smooth closed trajectory with motion skew
(each point sampled at the sensor pose of its capture time), IMU samples from
the analytic kinematics with optional bias and noise. Ground-truth poses come
with the data, so ATE is exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from glim_tpu_torch.ops import lie_np
from glim_tpu_torch.types import RawPoints

GRAVITY = np.array([0.0, 0.0, -9.81])


def make_scene(rng: np.random.Generator, extent: float = 30.0,
               n_points: int = 60000) -> np.ndarray:
    """World landmarks: 4 walls + floor + scattered pillars (N, 3)."""
    n_wall = n_points // 8
    pts = []
    for axis, sign in [(0, -1), (0, 1), (1, -1), (1, 1)]:
        w = np.zeros((n_wall, 3))
        w[:, axis] = sign * extent
        w[:, 1 - axis] = rng.uniform(-extent, extent, n_wall)
        w[:, 2] = rng.uniform(0.0, 6.0, n_wall)
        pts.append(w)
    floor = np.zeros((n_points // 4, 3))
    floor[:, 0] = rng.uniform(-extent, extent, len(floor))
    floor[:, 1] = rng.uniform(-extent, extent, len(floor))
    pts.append(floor)
    # Pillars: vertical cylinders at random xy.
    n_pil = n_points - 4 * n_wall - len(floor)
    centers = rng.uniform(-extent * 0.7, extent * 0.7, size=(12, 2))
    pp = np.zeros((n_pil, 3))
    ci = rng.integers(0, len(centers), n_pil)
    ang = rng.uniform(0, 2 * np.pi, n_pil)
    pp[:, 0] = centers[ci, 0] + 0.4 * np.cos(ang)
    pp[:, 1] = centers[ci, 1] + 0.4 * np.sin(ang)
    pp[:, 2] = rng.uniform(0, 5.0, n_pil)
    pts.append(pp)
    return np.concatenate(pts, axis=0)


def circle_pose(t: float, radius: float = 10.0, omega: float = 0.3,
                z_amp: float = 0.5, z_omega: float = 0.7) -> np.ndarray:
    """T_world_sensor on a circle with yaw tangent to the path and a gentle
    vertical bob. Sensor z-up, x-forward."""
    a = omega * t
    p = np.array([radius * np.cos(a), radius * np.sin(a),
                  1.5 + z_amp * np.sin(z_omega * t)])
    yaw = a + np.pi / 2.0
    R = lie_np.so3_exp(np.array([0.0, 0.0, yaw]))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = p
    return T


def circle_imu(t: float, radius: float = 10.0, omega: float = 0.3,
               z_amp: float = 0.5, z_omega: float = 0.7):
    """Analytic body-frame IMU measurements for circle_pose."""
    a = omega * t
    # World-frame acceleration of the position curve.
    acc_w = np.array([-radius * omega * omega * np.cos(a),
                      -radius * omega * omega * np.sin(a),
                      -z_amp * z_omega * z_omega * np.sin(z_omega * t)])
    R = circle_pose(t, radius, omega, z_amp, z_omega)[:3, :3]
    acc_body = R.T @ (acc_w - GRAVITY)
    gyro_body = np.array([0.0, 0.0, omega])
    return acc_body, gyro_body


@dataclass
class SyntheticSequence:
    scans: List[RawPoints]
    imu: np.ndarray                     # (M, 7): [t, ax, ay, az, wx, wy, wz]
    gt_poses: List[np.ndarray]          # T_world_lidar at each scan stamp
    stamps: List[float]
    T_lidar_imu: np.ndarray = field(default_factory=lambda: np.eye(4))
    landmarks: Optional[np.ndarray] = None


def generate_sequence(duration: float = 10.0, scan_hz: float = 10.0,
                      imu_hz: float = 200.0, n_scan_points: int = 6000,
                      max_range: float = 40.0, noise: float = 0.01,
                      imu_noise: float = 0.0, imu_bias: Optional[np.ndarray] = None,
                      radius: float = 10.0, omega: float = 0.3,
                      seed: int = 0, skew: bool = True,
                      scene_points: int = 60000) -> SyntheticSequence:
    """Simulate a full LiDAR-IMU sequence on the circle trajectory."""
    rng = np.random.default_rng(seed)
    scene = make_scene(rng, n_points=scene_points)
    imu_bias = np.zeros(6) if imu_bias is None else imu_bias

    scan_period = 1.0 / scan_hz
    n_scans = int(duration * scan_hz)
    scans: List[RawPoints] = []
    gt_poses: List[np.ndarray] = []
    stamps: List[float] = []

    for si in range(n_scans):
        stamp = si * scan_period
        T_ws = circle_pose(stamp, radius, omega)
        gt_poses.append(T_ws)
        stamps.append(stamp)

        # Visible landmarks: within range of the sensor at scan start.
        rel = scene - T_ws[:3, 3]
        dist = np.linalg.norm(rel, axis=1)
        vis = np.where(dist < max_range)[0]
        if len(vis) > n_scan_points:
            vis = rng.choice(vis, n_scan_points, replace=False)
        lm = scene[vis]

        # Spinning-lidar time ordering: azimuth in the sensor frame at stamp.
        in_s0 = (np.linalg.inv(T_ws)[:3, :3] @ lm.T).T + np.linalg.inv(T_ws)[:3, 3]
        az = np.arctan2(in_s0[:, 1], in_s0[:, 0])
        order = np.argsort(az)
        lm = lm[order]
        times = (az[order] + np.pi) / (2 * np.pi) * scan_period

        pts = np.zeros((len(lm), 3))
        if skew:
            # Each point observed from the pose at its capture time.
            # Batch by small time groups for speed.
            n_groups = 32
            gidx = np.minimum((times / scan_period * n_groups).astype(int), n_groups - 1)
            for g in range(n_groups):
                sel = gidx == g
                if not sel.any():
                    continue
                tg = stamp + (g + 0.5) / n_groups * scan_period
                T_g = circle_pose(tg, radius, omega)
                Ti = np.linalg.inv(T_g)
                pts[sel] = (Ti[:3, :3] @ lm[sel].T).T + Ti[:3, 3]
        else:
            Ti = np.linalg.inv(T_ws)
            pts = (Ti[:3, :3] @ lm.T).T + Ti[:3, 3]

        pts += rng.normal(size=pts.shape) * noise
        scans.append(RawPoints(stamp=stamp, points=pts, times=times))

    n_imu = int(duration * imu_hz) + 1
    imu = np.zeros((n_imu, 7))
    for i in range(n_imu):
        t = i / imu_hz
        acc, gyro = circle_imu(t, radius, omega)
        imu[i, 0] = t
        imu[i, 1:4] = acc + imu_bias[:3] + rng.normal(size=3) * imu_noise
        imu[i, 4:7] = gyro + imu_bias[3:] + rng.normal(size=3) * imu_noise * 0.1
    return SyntheticSequence(scans=scans, imu=imu, gt_poses=gt_poses,
                             stamps=stamps, landmarks=scene)


def ate_rmse(est_poses: List[np.ndarray], gt_poses: List[np.ndarray],
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE over translations), with optional
    SE(3) Umeyama alignment — the evo-style offline check implied by the
    reference docs (quickstart.md:119-127)."""
    est = np.array([T[:3, 3] for T in est_poses])
    gt = np.array([T[:3, 3] for T in gt_poses])
    assert est.shape == gt.shape
    if align and len(est) >= 3:
        mu_e = est.mean(axis=0)
        mu_g = gt.mean(axis=0)
        E = est - mu_e
        G = gt - mu_g
        U, _, Vt = np.linalg.svd(E.T @ G)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        est = (R @ E.T).T + mu_g
        gt = G + mu_g
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


# ======================================================================
# Raycast scan simulation (round 2): realistic spinning-LiDAR scans.
#
# The landmark-sampling generator above produces structureless point sets;
# real scans (the reference's canonical Ouster OS1-128 input,
# docs/quickstart.md:6-10) have elevation rings, azimuth-ordered timing,
# occlusion, and degenerate geometry (corridors). This generator raycasts a
# ring-pattern scanner through analytic scenes along several trajectory
# families, with IMU derived from the exact pose function by central finite
# differences — so ground truth is exact and hard cases (corridor
# rank-deficiency, aggressive motion) are reproducible.
# ======================================================================


def _path_imu(pose_fn, t: float, h: float = 1e-4):
    """Body-frame IMU (acc, gyro) from an arbitrary pose function by central
    finite differences (exact to O(h^2); pose functions are analytic)."""
    Tm, T0, Tp = pose_fn(t - h), pose_fn(t), pose_fn(t + h)
    acc_w = (Tp[:3, 3] - 2.0 * T0[:3, 3] + Tm[:3, 3]) / (h * h)
    dR = Tm[:3, :3].T @ Tp[:3, :3]
    gyro = lie_np.so3_log(dR) / (2.0 * h)
    acc_body = T0[:3, :3].T @ (acc_w - GRAVITY)
    return acc_body, gyro


def _heading_pose(p: np.ndarray, v: np.ndarray, roll: float = 0.0) -> np.ndarray:
    """Pose with x-forward along v, z-up, optional roll about the path."""
    yaw = np.arctan2(v[1], v[0])
    pitch = -np.arctan2(v[2], np.hypot(v[0], v[1]))
    R = (lie_np.so3_exp(np.array([0.0, 0.0, yaw]))
         @ lie_np.so3_exp(np.array([0.0, pitch, 0.0]))
         @ lie_np.so3_exp(np.array([roll, 0.0, 0.0])))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = p
    return T


def make_path(kind: str, speed: float = 2.0, aggressive: float = 0.0, **kw):
    """Returns pose_fn(t) -> T_world_sensor for a trajectory family.

    kinds: circle | figure8 | corridor (stadium out-and-back) | line."""
    h = 1e-4

    if kind == "circle":
        radius = kw.get("radius", 10.0)
        omega = speed / radius
        return lambda t: circle_pose(t, radius, omega)

    if kind == "figure8":
        A = kw.get("extent", 12.0)
        om = speed / A

        def p_of(t):
            return np.array([A * np.sin(om * t),
                             0.5 * A * np.sin(2 * om * t),
                             1.5 + 0.3 * np.sin(0.9 * om * t)])

        def pose(t):
            v = (p_of(t + h) - p_of(t - h)) / (2 * h)
            roll = aggressive * 0.4 * np.sin(2.3 * om * t)
            return _heading_pose(p_of(t), v, roll)
        return pose

    if kind == "corridor":
        # Stadium: two straights of length L joined by half-circles of
        # radius r — a long, geometrically degenerate corridor run with
        # 180-degree turns at the ends.
        L = kw.get("length", 30.0)
        r = kw.get("turn_radius", 3.0)
        peri = 2 * L + 2 * np.pi * r

        def p_of(t):
            s = (speed * t) % peri
            if s < L:                                  # +x straight at y=-r
                return np.array([s - L / 2, -r, 1.2])
            s -= L
            if s < np.pi * r:                          # right end half-circle
                a = s / r
                return np.array([L / 2 + r * np.sin(a), -r * np.cos(a), 1.2])
            s -= np.pi * r
            if s < L:                                  # -x straight at y=+r
                return np.array([L / 2 - s, r, 1.2])
            s -= L
            a = s / r                                  # left end half-circle
            return np.array([-L / 2 - r * np.sin(a), r * np.cos(a), 1.2])

        def pose(t):
            v = (p_of(t + h) - p_of(t - h)) / (2 * h)
            return _heading_pose(p_of(t), v)
        return pose

    if kind == "line":
        def pose(t):
            return _heading_pose(np.array([speed * t, 0.0, 1.2]),
                                 np.array([1.0, 0.0, 0.0]))
        return pose

    raise ValueError(f"unknown path kind: {kind}")


# -------------------------------------------------- analytic scene raycast

def make_raycast_scene(kind: str = "room", extent: float = 30.0,
                       seed: int = 0):
    """Primitive list for the vectorized raycaster.

    Primitives: ("plane", normal(3), d, bmin(3), bmax(3)) — bounded plane
    n.x = d clipped to the AABB [bmin, bmax]; ("cyl", cx, cy, r, z0, z1)."""
    rng = np.random.default_rng(seed)
    prims = []
    big = 1e6
    if kind == "room":
        E = extent
        for axis, sign in [(0, -1), (0, 1), (1, -1), (1, 1)]:
            n = np.zeros(3)
            n[axis] = float(sign)
            bmin = np.array([-E, -E, 0.0])
            bmax = np.array([E, E, 8.0])
            prims.append(("plane", n, sign * E, bmin, bmax))
        prims.append(("plane", np.array([0.0, 0.0, 1.0]), 0.0,
                      np.array([-E, -E, -1.0]), np.array([E, E, 1.0])))
        for _ in range(14):
            c = rng.uniform(-E * 0.7, E * 0.7, 2)
            if np.linalg.norm(c) < 4.0:
                c = c + np.array([6.0, 6.0])
            prims.append(("cyl", c[0], c[1], rng.uniform(0.3, 0.8), 0.0,
                          rng.uniform(3.0, 6.0)))
    elif kind == "corridor":
        # Long narrow corridor around the stadium path: walls at y=±w along
        # the straights, end caps, floor; a few boxes (as thin walls) break
        # the longitudinal degeneracy only slightly.
        L, w = extent, 6.0
        bmin = np.array([-L, -w, 0.0])
        bmax = np.array([L, w, 4.0])
        prims.append(("plane", np.array([0.0, 1.0, 0.0]), w, bmin, bmax))
        prims.append(("plane", np.array([0.0, -1.0, 0.0]), w, bmin, bmax))
        prims.append(("plane", np.array([1.0, 0.0, 0.0]), L, bmin, bmax))
        prims.append(("plane", np.array([-1.0, 0.0, 0.0]), L, bmin, bmax))
        prims.append(("plane", np.array([0.0, 0.0, 1.0]), 0.0,
                      np.array([-L, -w, -1.0]), np.array([L, w, 1.0])))
        for i in range(6):
            x = -L * 0.8 + i * (L * 1.6 / 5)
            side = 1.0 if i % 2 == 0 else -1.0
            prims.append(("cyl", x, side * (w - 1.0), 0.4, 0.0, 2.5))
    elif kind == "blocks":
        # Open city-block scene: an unbounded ground plane plus pillars and
        # wall segments scattered in two rings around the origin, leaving a
        # street annulus (radius ~ extent*0.65..1.15) free for a loop
        # trajectory. Unlike "room" there is NO enclosing wall: with a
        # finite sensor range the estimator only ever sees LOCAL structure,
        # so odometry drift accumulates over a lap and the loop closure in
        # the global backend has real work to do.
        E = extent
        prims.append(("plane", np.array([0.0, 0.0, 1.0]), 0.0,
                      np.array([-4 * E, -4 * E, -1.0]),
                      np.array([4 * E, 4 * E, 1.0])))
        for n_feat, r_lo, r_hi in [(18, 0.15 * E, 0.55 * E),
                                   (22, 1.25 * E, 1.9 * E)]:
            for _ in range(n_feat):
                ang = rng.uniform(0, 2 * np.pi)
                rad = rng.uniform(r_lo, r_hi)
                c = np.array([rad * np.cos(ang), rad * np.sin(ang)])
                if rng.uniform() < 0.55:
                    prims.append(("cyl", c[0], c[1], rng.uniform(0.8, 2.5),
                                  0.0, rng.uniform(3.0, 8.0)))
                else:
                    # Wall segment: zero-thickness bounded plane, axis-aligned
                    # normal, random along-length 4..10 m, height 3..6 m.
                    axis = int(rng.integers(0, 2))
                    half = rng.uniform(2.0, 5.0)
                    h = rng.uniform(3.0, 6.0)
                    n = np.zeros(3)
                    n[axis] = 1.0
                    bmin = np.array([c[0], c[1], 0.0])
                    bmax = np.array([c[0], c[1], h])
                    bmin[1 - axis] -= half
                    bmax[1 - axis] += half
                    prims.append(("plane", n, c[axis], bmin, bmax))
    else:
        raise ValueError(f"unknown scene kind: {kind}")
    return prims


def _raycast(origins: np.ndarray, dirs: np.ndarray, prims,
             max_range: float) -> np.ndarray:
    """Vectorized nearest-hit raycast. origins/dirs (N, 3) -> ranges (N,)
    (inf where no hit)."""
    N = len(dirs)
    best = np.full(N, np.inf)
    for prim in prims:
        if prim[0] == "plane":
            _, n, d, bmin, bmax = prim
            denom = dirs @ n
            t = (d - origins @ n) / np.where(np.abs(denom) > 1e-9, denom, 1e-9)
            pt = origins + t[:, None] * dirs
            ok = ((np.abs(denom) > 1e-9) & (t > 0.05) & (t < max_range)
                  & np.all(pt >= bmin - 1e-6, axis=1)
                  & np.all(pt <= bmax + 1e-6, axis=1))
            best = np.where(ok & (t < best), t, best)
        elif prim[0] == "cyl":
            _, cx, cy, r, z0, z1 = prim
            ox = origins[:, 0] - cx
            oy = origins[:, 1] - cy
            dx, dy = dirs[:, 0], dirs[:, 1]
            a = dx * dx + dy * dy
            b = 2 * (ox * dx + oy * dy)
            c = ox * ox + oy * oy - r * r
            disc = b * b - 4 * a * c
            sq = np.sqrt(np.maximum(disc, 0.0))
            t = (-b - sq) / np.where(a > 1e-12, 2 * a, 1e-12)
            z = origins[:, 2] + t * dirs[:, 2]
            ok = (disc > 0) & (a > 1e-12) & (t > 0.05) & (t < max_range) \
                & (z >= z0) & (z <= z1)
            best = np.where(ok & (t < best), t, best)
    return best


def generate_raycast_sequence(duration: float = 10.0, scan_hz: float = 10.0,
                              imu_hz: float = 200.0,
                              path: str = "circle", scene: str = "room",
                              speed: float = 2.0, aggressive: float = 0.0,
                              n_channels: int = 32, n_azimuth: int = 512,
                              fov_up: float = 22.5, fov_down: float = -22.5,
                              max_range: float = 80.0, noise: float = 0.01,
                              imu_noise: float = 0.0,
                              imu_bias: Optional[np.ndarray] = None,
                              seed: int = 0, n_time_groups: int = 32,
                              **path_kw) -> SyntheticSequence:
    """Simulate a spinning ring-pattern LiDAR + IMU along an analytic path."""
    rng = np.random.default_rng(seed)
    pose_fn = make_path(path, speed=speed, aggressive=aggressive, **path_kw)
    prims = make_raycast_scene(scene, seed=seed)
    imu_bias = np.zeros(6) if imu_bias is None else imu_bias

    scan_period = 1.0 / scan_hz
    elev = np.radians(np.linspace(fov_down, fov_up, n_channels))
    az = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False)
    # Column-major: all channels of one azimuth column share a capture time.
    AZ, EL = np.meshgrid(az, elev, indexing="ij")     # (n_az, n_ch)
    dirs_s = np.stack([np.cos(EL) * np.cos(AZ), np.cos(EL) * np.sin(AZ),
                       np.sin(EL)], axis=-1).reshape(-1, 3)
    times_flat = ((AZ[..., 0:1] + np.pi) / (2 * np.pi) * scan_period
                  * np.ones_like(EL)).reshape(-1)
    rings_flat = np.tile(np.arange(n_channels), n_azimuth)

    n_scans = int(round(duration * scan_hz))
    scans: List[RawPoints] = []
    gt_poses: List[np.ndarray] = []
    stamps: List[float] = []
    for si in range(n_scans):
        stamp = si * scan_period
        gt_poses.append(pose_fn(stamp))
        stamps.append(stamp)

        gidx = np.minimum((times_flat / scan_period * n_time_groups).astype(int),
                          n_time_groups - 1)
        pts_sensor = np.zeros_like(dirs_s)
        rng_all = np.full(len(dirs_s), np.inf)
        for g in range(n_time_groups):
            sel = gidx == g
            if not sel.any():
                continue
            tg = stamp + (g + 0.5) / n_time_groups * scan_period
            T_g = pose_fn(tg)
            d_w = dirs_s[sel] @ T_g[:3, :3].T
            o_w = np.broadcast_to(T_g[:3, 3], d_w.shape)
            r = _raycast(o_w, d_w, prims, max_range)
            rng_all[sel] = r
            # Hit points in world, re-expressed in the SCAN-STAMP sensor
            # frame via the capture-time pose (true motion skew).
            hit_w = o_w + np.where(np.isfinite(r), r, 0.0)[:, None] * d_w
            Ti = lie_np.se3_inverse(T_g)
            pts_sensor[sel] = hit_w @ Ti[:3, :3].T + Ti[:3, 3]

        ok = np.isfinite(rng_all)
        pts = pts_sensor[ok] + rng.normal(size=(int(ok.sum()), 3)) * noise
        scans.append(RawPoints(stamp=stamp, points=pts, times=times_flat[ok],
                               rings=rings_flat[ok]))

    n_imu = int(duration * imu_hz) + 1
    imu = np.zeros((n_imu, 7))
    for i in range(n_imu):
        t = i / imu_hz
        acc, gyro = _path_imu(pose_fn, t)
        imu[i, 0] = t
        imu[i, 1:4] = acc + imu_bias[:3] + rng.normal(size=3) * imu_noise
        imu[i, 4:7] = gyro + imu_bias[3:] + rng.normal(size=3) * imu_noise * 0.1
    return SyntheticSequence(scans=scans, imu=imu, gt_poses=gt_poses,
                             stamps=stamps)
