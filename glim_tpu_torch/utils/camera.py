"""Camera sensor model from ``config_sensors.json``'s camera block (host
copy of ``glim_tpu/utils/camera.py``).

The reference parses camera parameters for extension modules only
(the reference's config/config_sensors.json "Camera config (required for
only extension modules)"); image-based extensions receive them through
GlobalConfig. This module gives those extensions a working projection
model: pinhole intrinsics + plumb_bob (radtan) or fisheye (equidistant)
distortion, LiDAR-camera extrinsics, and the global-shutter flag.

Vectorized numpy throughout — image-space work is host-side (extensions,
colorization, visualization exports), not part of the device hot path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class CameraModel:
    # pinhole intrinsics [fx, fy, cx, cy]
    intrinsics: np.ndarray = field(
        default_factory=lambda: np.array([500.0, 500.0, 320.0, 240.0]))
    distortion_model: str = "plumb_bob"       # plumb_bob | fisheye | none
    distortion_coeffs: np.ndarray = field(
        default_factory=lambda: np.zeros(5))
    image_size: tuple = (640, 480)            # (width, height)
    T_lidar_camera: np.ndarray = field(default_factory=lambda: np.eye(4))
    global_shutter: bool = True

    @staticmethod
    def from_config(sensors_config) -> "CameraModel":
        """Build from the ``sensors`` section (same key names as the
        reference's config_sensors.json camera block)."""
        g = lambda k, d: sensors_config.param("sensors", k, d)
        m = CameraModel()
        m.intrinsics = np.asarray(g("intrinsics",
                                    list(m.intrinsics)), np.float64)
        m.distortion_model = str(g("distortion_model", "plumb_bob"))
        m.distortion_coeffs = np.asarray(g("distortion_coeffs", [0.0] * 5),
                                         np.float64)
        size = g("image_size", list(m.image_size))
        m.image_size = (int(size[0]), int(size[1]))
        # A missing entry reads as the identity; a malformed one (not a TUM
        # 7-vector, a zero quaternion) does too, as in the JAX package, but
        # no other error is caught.
        try:
            m.T_lidar_camera = sensors_config.param_se3("sensors",
                                                        "T_lidar_camera")
        except (ValueError, TypeError):
            m.T_lidar_camera = np.eye(4)
        m.global_shutter = bool(g("global_shutter_camera", True))
        return m

    # -- projection --

    def distort(self, xn: np.ndarray) -> np.ndarray:
        """Apply lens distortion to normalized image coords (N, 2)."""
        xn = np.asarray(xn, np.float64)
        if self.distortion_model == "none" or not np.any(self.distortion_coeffs):
            return xn
        x, y = xn[..., 0], xn[..., 1]
        if self.distortion_model == "fisheye":
            k = np.zeros(4)
            k[:min(4, len(self.distortion_coeffs))] = \
                self.distortion_coeffs[:4]
            r = np.sqrt(x * x + y * y)
            th = np.arctan(r)
            th2 = th * th
            thd = th * (1 + k[0] * th2 + k[1] * th2 ** 2
                        + k[2] * th2 ** 3 + k[3] * th2 ** 4)
            scale = np.where(r > 1e-9, thd / np.maximum(r, 1e-9), 1.0)
            return np.stack([x * scale, y * scale], -1)
        # plumb_bob / radtan: k1 k2 p1 p2 [k3]
        c = np.zeros(5)
        c[:min(5, len(self.distortion_coeffs))] = self.distortion_coeffs[:5]
        k1, k2, p1, p2, k3 = c
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([xd, yd], -1)

    def undistort(self, xd: np.ndarray, iters: int = 8) -> np.ndarray:
        """Invert ``distort`` by fixed-point iteration (N, 2)."""
        xd = np.asarray(xd, np.float64)
        xn = xd.copy()
        for _ in range(iters):
            err = self.distort(xn) - xd
            xn = xn - err
        return xn

    def project(self, pts_cam: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
        """Project camera-frame points (N, 3) -> pixel coords (N, 2) and a
        validity mask (in front of the camera and inside the image)."""
        pts_cam = np.asarray(pts_cam, np.float64)
        z = pts_cam[..., 2]
        valid = z > 1e-6
        zs = np.where(valid, z, 1.0)
        xn = np.stack([pts_cam[..., 0] / zs, pts_cam[..., 1] / zs], -1)
        xd = self.distort(xn)
        fx, fy, cx, cy = self.intrinsics
        uv = np.stack([fx * xd[..., 0] + cx, fy * xd[..., 1] + cy], -1)
        w, h = self.image_size
        valid = valid & (uv[..., 0] >= 0) & (uv[..., 0] < w) \
            & (uv[..., 1] >= 0) & (uv[..., 1] < h)
        return uv, valid

    def project_lidar(self, pts_lidar: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Project LiDAR-frame points through T_lidar_camera."""
        T_cl = np.linalg.inv(self.T_lidar_camera)
        p = np.asarray(pts_lidar, np.float64)
        pc = p @ T_cl[:3, :3].T + T_cl[:3, 3]
        return self.project(pc)

    def unproject(self, uv: np.ndarray, depth: Optional[np.ndarray] = None
                  ) -> np.ndarray:
        """Pixel coords (N, 2) [+ depth (N,)] -> camera-frame rays/points."""
        fx, fy, cx, cy = self.intrinsics
        uv = np.asarray(uv, np.float64)
        xd = np.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
        xn = self.undistort(xd)
        rays = np.concatenate([xn, np.ones(xn.shape[:-1] + (1,))], -1)
        if depth is None:
            return rays / np.linalg.norm(rays, axis=-1, keepdims=True)
        return rays * np.asarray(depth)[..., None]
