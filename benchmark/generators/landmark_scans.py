"""Spinning-LiDAR + IMU sequence over a landmark scene, made on the device.

A frozen copy of ``glim_tpu_torch/io/synthetic.py::generate_sequence`` (the
landmark-sampling generator every full-size smoke run of the port used),
rewritten in PyTorch so that a whole sequence is drawn on the card in a few
large calls instead of scan by scan on the host: world landmarks on four
walls, a floor and twelve pillars; scans along an analytic trajectory, each
point picked at random among the landmarks in range, ordered by azimuth,
stamped by its azimuth within the scan period and seen from the sensor pose
of its capture time (32 time groups: motion skew); Gaussian range noise; an
IMU at its own rate from the analytic kinematics, without noise or bias.

The same trajectory, scan stamps and point counts as the original for the
same arguments; the random draws come from a ``torch.Generator`` seeded with
the run's seed, so they differ from the original's numpy draws. Points and
times are returned as host float32 arrays, as a sensor driver hands them over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

GRAVITY = np.array([0.0, 0.0, -9.81])


@dataclass
class Sequence:
    stamps: np.ndarray            # (S,) scan stamps [s]
    points: List[np.ndarray]      # S x (n, 3) float32, sensor frame at the stamp
    times: List[np.ndarray]       # S x (n,) float32, seconds after the stamp
    imu: np.ndarray               # (M, 7) [t, ax, ay, az, wx, wy, wz]
    gt_poses: np.ndarray          # (S, 4, 4) T_world_sensor at each stamp


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    return g


def make_scene(gen: torch.Generator, n_points: int, extent: float, device) -> torch.Tensor:
    """World landmarks (n_points, 3) float64: 4 walls of n/8 each, a floor of
    n/4, the rest on 12 pillars of radius 0.4 m (``make_scene``'s layout)."""
    u = lambda *s: torch.rand(*s, generator=gen, device=device, dtype=torch.float64)
    n_wall = n_points // 8
    parts = []
    for axis, sign in [(0, -1), (0, 1), (1, -1), (1, 1)]:
        w = torch.zeros(n_wall, 3, dtype=torch.float64, device=device)
        w[:, axis] = sign * extent
        w[:, 1 - axis] = (u(n_wall) * 2 - 1) * extent
        w[:, 2] = u(n_wall) * 6.0
        parts.append(w)
    n_floor = n_points // 4
    floor = torch.zeros(n_floor, 3, dtype=torch.float64, device=device)
    floor[:, :2] = (u(n_floor, 2) * 2 - 1) * extent
    parts.append(floor)
    n_pil = n_points - 4 * n_wall - n_floor
    centers = (u(12, 2) * 2 - 1) * extent * 0.7
    ci = torch.randint(0, 12, (n_pil,), generator=gen, device=device)
    ang = u(n_pil) * 2 * math.pi
    pil = torch.stack([centers[ci, 0] + 0.4 * torch.cos(ang),
                       centers[ci, 1] + 0.4 * torch.sin(ang), u(n_pil) * 5.0], 1)
    parts.append(pil)
    return torch.cat(parts, 0)


def circle_poses(t: torch.Tensor, radius: float, omega: float, z_amp: float,
                 z_omega: float) -> torch.Tensor:
    """(..., 4, 4) T_world_sensor on the circle, yaw tangent to the path,
    with a vertical bob (``circle_pose``)."""
    a = omega * t
    yaw = a + math.pi / 2
    T = torch.zeros(t.shape + (4, 4), dtype=torch.float64, device=t.device)
    c, s = torch.cos(yaw), torch.sin(yaw)
    T[..., 0, 0], T[..., 0, 1], T[..., 1, 0], T[..., 1, 1] = c, -s, s, c
    T[..., 2, 2] = 1.0
    T[..., 3, 3] = 1.0
    T[..., 0, 3] = radius * torch.cos(a)
    T[..., 1, 3] = radius * torch.sin(a)
    T[..., 2, 3] = 1.5 + z_amp * torch.sin(z_omega * t)
    return T


def circle_imu(t: np.ndarray, radius: float, omega: float, z_amp: float,
               z_omega: float) -> np.ndarray:
    """(M, 6) body-frame [acc, gyro] of the circle (``circle_imu``)."""
    a = omega * t
    acc_w = np.stack([-radius * omega ** 2 * np.cos(a), -radius * omega ** 2 * np.sin(a),
                      -z_amp * z_omega ** 2 * np.sin(z_omega * t)], 1) - GRAVITY
    yaw = a + np.pi / 2
    c, s = np.cos(yaw), np.sin(yaw)
    # R^T @ acc with R = Rz(yaw).
    acc_b = np.stack([c * acc_w[:, 0] + s * acc_w[:, 1], -s * acc_w[:, 0] + c * acc_w[:, 1],
                      acc_w[:, 2]], 1)
    gyro = np.zeros_like(acc_b)
    gyro[:, 2] = omega
    return np.concatenate([acc_b, gyro], 1)


def _path(traffic: dict):
    p = traffic["path"]
    if p["kind"] == "circle":
        args = (p["radius"], p["speed"] / p["radius"], p["z_amp"], p["z_omega"])
        return (lambda t: circle_poses(t, *args)), (lambda t: circle_imu(t, *args))
    raise ValueError(f"landmark_scans: unknown path kind {p['kind']!r}")


def generate(traffic: dict, seed: int, n_scans: int, device, chunk: int = 16) -> Sequence:
    """``n_scans`` scans and their IMU rows from the traffic file's sensor,
    scene and path, drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = _generator(seed, dev)
    pose_fn, imu_fn = _path(traffic)
    hz = float(traffic["scan_hz"])
    period = 1.0 / hz
    n_pts = int(traffic["scan_points"])
    groups = int(traffic["time_groups"])
    max_range = float(traffic["max_range"])
    noise = float(traffic["range_noise"])
    scene = make_scene(gen, int(traffic["scene"]["points"]), float(traffic["scene"]["extent"]),
                       dev)
    stamps = np.arange(n_scans) * period
    points, times = [], []
    for s0 in range(0, n_scans, chunk):
        st = torch.as_tensor(stamps[s0:s0 + chunk], dtype=torch.float64, device=dev)
        B = st.shape[0]
        T_ws = pose_fn(st)                                         # (B, 4, 4)
        rel = scene[None] - T_ws[:, None, :3, 3]
        vis = torch.linalg.norm(rel, dim=-1) < max_range           # (B, P)
        # A uniform draw without replacement among the visible landmarks:
        # the n_pts smallest priorities, the invisible ones pushed past 1.
        prio = torch.rand(vis.shape, generator=gen, device=dev) + (~vis).float() * 2.0
        k = min(n_pts, scene.shape[0])
        sel_p, sel = torch.topk(prio, k, dim=1, largest=False)
        counts = torch.clamp(vis.sum(1), max=k)
        lm = scene[sel]                                            # (B, k, 3)
        R0 = T_ws[:, :3, :3]
        in_s0 = torch.einsum("bji,bnj->bni", R0, lm - T_ws[:, None, :3, 3])
        az = torch.atan2(in_s0[..., 1], in_s0[..., 0])
        az = torch.where(sel_p < 2.0, az, float("inf"))           # invisible last
        az, order = torch.sort(az, dim=1)
        lm = torch.gather(lm, 1, order[..., None].expand(-1, -1, 3))
        t_pt = (az + math.pi) / (2 * math.pi) * period
        t_pt = torch.where(torch.isfinite(t_pt), t_pt, 0.0)
        g = torch.clamp((t_pt / period * groups).to(torch.int64), max=groups - 1)
        tg = st[:, None] + (torch.arange(groups, device=dev, dtype=torch.float64) + 0.5) \
            / groups * period                                      # (B, G)
        T_g = pose_fn(tg)                                          # (B, G, 4, 4)
        T_pt = torch.gather(T_g, 1, g[..., None, None].expand(-1, -1, 4, 4))
        pts = torch.einsum("bnji,bnj->bni", T_pt[..., :3, :3], lm - T_pt[..., :3, 3])
        pts = pts + torch.randn(pts.shape, generator=gen, device=dev,
                                dtype=torch.float64) * noise
        pts_h = pts.to(torch.float32).cpu().numpy()
        t_h = t_pt.to(torch.float32).cpu().numpy()
        for b, n in enumerate(counts.tolist()):
            points.append(np.ascontiguousarray(pts_h[b, :n]))
            times.append(np.ascontiguousarray(t_h[b, :n]))
    imu_hz = float(traffic["imu_hz"])
    n_imu = int(n_scans * period * imu_hz) + 1
    t_imu = np.arange(n_imu) / imu_hz
    imu = np.concatenate([t_imu[:, None], imu_fn(t_imu)], 1)
    gt = pose_fn(torch.as_tensor(stamps, dtype=torch.float64)).numpy()
    return Sequence(stamps=stamps, points=points, times=times, imu=imu, gt_poses=gt)
