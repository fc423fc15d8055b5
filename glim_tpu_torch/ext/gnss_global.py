"""GNSS global position constraints extension.

Twin of ``glim_tpu/ext/gnss_global.py`` (glim_ext's gnss_global): GNSS
fixes are matched to submaps by stamp, the 4-dof (yaw + translation)
alignment between the map frame and the ENU frame is estimated once enough
horizontal baseline has accumulated, and each later submap receives a
translation prior through ``request_to_add_translation_prior`` (serviced
on the async global-mapping worker by back-ends that have
``add_translation_prior``). All host numpy, in float64.

Each alignment pass re-reads the paired submaps' ``T_world_origin``: the
host mirror the back-end writes after every optimize (a numpy array; no
device read).
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as GCB
from glim_tpu_torch.utils.extension_module import ExtensionModule, config_getter
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("gnss")

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_E2 = _WGS84_F * (2.0 - _WGS84_F)


def lla_to_ecef(lat_deg, lon_deg, alt):
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    sl, cl = np.sin(lat), np.cos(lat)
    N = _WGS84_A / np.sqrt(1.0 - _WGS84_E2 * sl * sl)
    return np.array([(N + alt) * cl * np.cos(lon),
                     (N + alt) * cl * np.sin(lon),
                     (N * (1.0 - _WGS84_E2) + alt) * sl])


def lla_to_enu(lla: np.ndarray, ref_lla: np.ndarray) -> np.ndarray:
    """WGS84 (lat deg, lon deg, alt m) -> local ENU meters at ref_lla."""
    lat0, lon0 = np.radians(ref_lla[0]), np.radians(ref_lla[1])
    d = lla_to_ecef(*lla) - lla_to_ecef(*ref_lla)
    sl, cl = np.sin(lat0), np.cos(lat0)
    so, co = np.sin(lon0), np.cos(lon0)
    R = np.array([[-so, co, 0.0],
                  [-sl * co, -sl * so, cl],
                  [cl * co, cl * so, sl]])
    return R @ d


def fit_yaw_translation(p_map: np.ndarray, p_enu: np.ndarray):
    """4-dof alignment map = R_yaw(theta) @ enu + t minimizing horizontal
    residuals (closed form; z by the mean offset) -> (R (3,3), t (3,), rms)."""
    cm, ce = p_map.mean(0), p_enu.mean(0)
    dm, de = p_map - cm, p_enu - ce
    C = float(np.sum(de[:, 0] * dm[:, 0] + de[:, 1] * dm[:, 1]))
    S = float(np.sum(de[:, 0] * dm[:, 1] - de[:, 1] * dm[:, 0]))
    th = np.arctan2(S, C)
    R = np.array([[np.cos(th), -np.sin(th), 0.0],
                  [np.sin(th), np.cos(th), 0.0],
                  [0.0, 0.0, 1.0]])
    t = cm - R @ ce
    res = p_map - (p_enu @ R.T + t)
    return R, t, float(np.sqrt(np.mean(np.sum(res ** 2, axis=1))))


class GNSSGlobal(ExtensionModule):
    """GNSS position priors on submap poses (glim_ext gnss_global role)."""

    def __init__(self, min_baseline: float = 10.0, min_pairs: int = 4,
                 default_std: float = 2.0, max_stamp_gap: float = 1.0,
                 prior_inf_scale: float = 1.0):
        self.min_baseline = min_baseline
        self.min_pairs = min_pairs
        self.default_std = default_std
        self.max_stamp_gap = max_stamp_gap
        self.prior_inf_scale = prior_inf_scale
        self._lock = threading.Lock()
        self.fixes: List[tuple] = []         # (stamp, enu (3,), std)
        self._ref_lla: Optional[np.ndarray] = None
        # (submap, stamp, enu (3,), std) of the submaps with GNSS coverage.
        self.pairs: List[tuple] = []
        self.T_map_enu: Optional[tuple] = None        # (R, t)
        self.priors_sent = 0
        self._handle = GCB.on_insert_submap.add(self._on_new_submap)

    def detach(self) -> None:
        if self._handle is not None:
            GCB.on_insert_submap.remove(self._handle)
            self._handle = None

    # -- input --

    def insert_gnss_lla(self, stamp: float, lla, std: float = 0.0) -> None:
        """A raw WGS84 fix (lat deg, lon deg, alt m), projected to the local
        ENU frame anchored at the first fix."""
        lla = np.asarray(lla, np.float64)
        if self._ref_lla is None:
            self._ref_lla = lla.copy()
        self.insert_gnss(stamp, lla_to_enu(lla, self._ref_lla), std)

    def insert_gnss(self, stamp: float, position, std: float = 0.0) -> None:
        """A pre-projected local ENU fix (x, y, z) in meters."""
        enu = np.asarray(position, np.float64)
        with self._lock:
            self.fixes.append((float(stamp), enu, float(std) if std > 0 else self.default_std))

    def _interp_fix(self, stamp: float):
        with self._lock:
            if not self.fixes:
                return None
            stamps = np.array([f[0] for f in self.fixes])
            k = int(np.searchsorted(stamps, stamp))
            if k == 0 or k == len(stamps):
                j = 0 if k == 0 else len(stamps) - 1
                if abs(stamps[j] - stamp) > self.max_stamp_gap:
                    return None
                return self.fixes[j][1], self.fixes[j][2]
            t0, p0, s0 = self.fixes[k - 1]
            t1, p1, s1 = self.fixes[k]
            if stamp - t0 > self.max_stamp_gap and t1 - stamp > self.max_stamp_gap:
                return None
            a = (stamp - t0) / max(t1 - t0, 1e-9)
            return p0 + a * (p1 - p0), s0 + a * (s1 - s0)

    # -- wiring --

    def _on_new_submap(self, submap) -> None:
        if not submap.frames:
            return
        stamp = submap.frames[len(submap.frames) // 2].stamp
        fix = self._interp_fix(stamp)
        if fix is None:
            return
        enu, std = fix
        self.pairs.append((submap, stamp, enu, std))
        self._update_alignment()
        if self.T_map_enu is None:
            return
        R, t = self.T_map_enu
        pos_map = R @ enu + t
        GCB.request_to_add_translation_prior(
            int(submap.id), pos_map.astype(np.float32),
            np.float32(self.prior_inf_scale / max(std, 1e-3)))
        self.priors_sent += 1

    def _update_alignment(self) -> None:
        if len(self.pairs) < self.min_pairs:
            return
        p_enu = np.stack([p[2] for p in self.pairs])
        span = p_enu[:, :2].max(0) - p_enu[:, :2].min(0)
        if np.linalg.norm(span) < self.min_baseline:
            return
        p_map = np.stack([np.asarray(p[0].T_world_origin, np.float64)[:3, 3]
                          for p in self.pairs])
        R, t, rms = fit_yaw_translation(p_map, p_enu)
        first = self.T_map_enu is None
        self.T_map_enu = (R, t)
        if first:
            logger.info("GNSS/map alignment established over %d pairs (rms %.2f m)",
                        len(self.pairs), rms)


@register_module("extension", "gnss_global")
def create_extension_module(*args, **kwargs):
    g = config_getter("gnss_global")
    return GNSSGlobal(min_baseline=float(g("min_baseline", 10.0)),
                      min_pairs=int(g("min_pairs", 4)),
                      default_std=float(g("default_std", 2.0)),
                      max_stamp_gap=float(g("max_stamp_gap", 1.0)),
                      prior_inf_scale=float(g("prior_inf_scale", 1.0)))
