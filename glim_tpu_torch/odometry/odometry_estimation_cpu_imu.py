"""IMU-coupled frame-to-model odometry (cpu-module parity).

Twin of ``glim_tpu/odometry/odometry_estimation_cpu_imu.py``: the shared
window estimator fuses a frame-to-model matching system for the newest
state with the IMU chain in one joint Gauss-Newton. The model is a bounded
iVox-style point map in GICP mode (nearest-neighbour correspondences through
the ``nn_search`` CUDA kernel, capped at 2 x ivox_resolution) or
``vgicp_voxelmap_levels`` Gaussian voxel maps in VGICP mode (resolution
``vgicp_resolution * scaling^level``, matched by ``window_scan_step`` with
``matching="vgicp"``). The model absorbs every scan: full density for the
first ``dense_frames`` frames, then a ``target_downsampling_rate`` random
sample drawn from the module's own ``torch.Generator``.

``enable_imu: false`` selects the LiDAR-only module of
``odometry_estimation_cpu.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from glim_tpu_torch.odometry.odometry_estimation_imu import (
    OdometryEstimationIMU, OdometryEstimationIMUParams)
from glim_tpu_torch.ops import voxelmap as vmx
from glim_tpu_torch.types import EstimationFrame
from glim_tpu_torch.utils.registry import register_module


@dataclass
class OdometryEstimationCPUIMUParams(OdometryEstimationIMUParams):
    registration_type: str = "GICP"        # GICP (iVox) | VGICP
    max_iterations: int = 8
    target_downsampling_rate: float = 0.1
    ivox_resolution: float = 0.5
    ivox_min_dist: float = 0.1
    vgicp_resolution: float = 0.3
    vgicp_voxelmap_levels: int = 2
    vgicp_voxelmap_scaling_factor: float = 2.0
    model_capacity: int = 131072
    dense_frames: int = 5                  # full-density model updates early

    @staticmethod
    def from_config(config, sensors_config=None) -> "OdometryEstimationCPUIMUParams":
        base = OdometryEstimationIMUParams.from_config(config, sensors_config)
        p = OdometryEstimationCPUIMUParams(**vars(base))
        g = lambda k, d: config.param("odometry_estimation", k, d)
        p.registration_type = g("registration_type", "GICP")
        p.max_iterations = int(g("max_iterations", 8))
        p.target_downsampling_rate = g("target_downsampling_rate", 0.1)
        p.ivox_resolution = g("ivox_resolution", 0.5)
        p.ivox_min_dist = g("ivox_min_dist", 0.1)
        p.vgicp_resolution = g("vgicp_resolution", 0.3)
        p.vgicp_voxelmap_levels = int(g("vgicp_voxelmap_levels", 2))
        p.vgicp_voxelmap_scaling_factor = g("vgicp_voxelmap_scaling_factor", 2.0)
        return p


class OdometryEstimationCPUIMU(OdometryEstimationIMU):
    def __init__(self, params: Optional[OdometryEstimationCPUIMUParams] = None,
                 device="cuda"):
        self._cpu_params = params or OdometryEstimationCPUIMUParams()
        p = self._cpu_params
        super().__init__(p, device=device)
        self.use_vgicp = p.registration_type.upper().startswith("VGICP")
        self._matching = "vgicp" if self.use_vgicp else "gicp"
        self._max_corr_dist = p.ivox_resolution * 2.0
        self._d_max_corr_dist = self._f32(self._max_corr_dist)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(7)
        # Displacement reference fed to the step (unused by this module's
        # model policy).
        self._last_kf_T = torch.eye(4, device=self.device)

    # -- model hooks ------------------------------------------------------

    def _make_model(self):
        p = self._cpu_params
        if p.registration_type.upper().startswith("VGICP"):
            return tuple(
                vmx.empty_gaussian_voxelmap(
                    max(p.model_capacity >> lvl, 8192),
                    p.vgicp_resolution * (p.vgicp_voxelmap_scaling_factor ** lvl),
                    device=self.device)
                for lvl in range(max(p.vgicp_voxelmap_levels, 1)))
        return vmx.empty_point_voxelmap(p.model_capacity, p.ivox_min_dist,
                                        device=self.device)

    def _last_kf_pose_dev(self):
        return self._last_kf_T

    def _init_model(self, frame, covs, T_wl_dev, T_wi_dev, T0_host) -> None:
        self._insert_scan(frame.device_points, covs, frame.device_mask, T_wl_dev, 0)
        self._last_kf_T = T_wi_dev

    def _maybe_update_model(self, prev: EstimationFrame, s: np.ndarray) -> None:
        """Every scan feeds the model: full density for the first
        ``dense_frames``, then a random ``target_downsampling_rate`` sample."""
        self._insert_scan(prev.frame.points, prev.frame.covs, prev.frame.mask,
                          prev.device_T_world_lidar, prev.id)

    def _insert_scan(self, pts_l, covs_l, mask, T_wl, frame_id: int) -> None:
        p = self._cpu_params
        R, t = T_wl[:3, :3], T_wl[:3, 3]
        pts_w = pts_l @ R.T + t
        covs_w = R @ covs_l @ R.T
        if frame_id >= p.dense_frames:
            keep = torch.rand(mask.shape, generator=self._gen,
                              device=self.device) < p.target_downsampling_rate
            mask = mask & keep
        if self.use_vgicp:
            self.model = tuple(vmx.voxelmap_insert(vm, pts_w, mask, covs_w, frame_id)
                               for vm in self.model)
        else:
            self.model = vmx.pointmap_insert(self.model, pts_w, mask, covs_w, frame_id)


@register_module("odometry", "odometry_estimation_cpu")
def create_odometry_estimation_cpu_module(config=None, sensors_config=None, device="cuda"):
    """libodometry_estimation_cpu.so: the IMU-coupled frame-to-model module;
    enable_imu=false selects the LiDAR-only module."""
    if config is not None and not config.param("odometry_estimation", "enable_imu", True):
        from glim_tpu_torch.odometry.odometry_estimation_cpu import (
            OdometryEstimationCPU, OdometryEstimationCPUParams)
        return OdometryEstimationCPU(OdometryEstimationCPUParams.from_config(config),
                                     device=device)
    params = (OdometryEstimationCPUIMUParams.from_config(config, sensors_config)
              if config is not None else OdometryEstimationCPUIMUParams())
    return OdometryEstimationCPUIMU(params, device=device)
