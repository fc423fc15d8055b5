"""Scan preprocessing: downsample -> filter -> sort -> kNN graph.

Twin of ``glim_tpu/preprocess/cloud_preprocessor.py``: one device pipeline
over a padded scan (distance/finite filter -> random-grid or voxel-grid
downsampling -> time sort -> optional crop-box -> banded or exact kNN graph
-> optional statistical outlier removal), fed by a single int16 upload of
the raw scan. The random priorities of the grid sampler are drawn from the
preprocessor's own ``torch.Generator`` and passed in as tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from glim_tpu_torch.native import pack_scan_i16
from glim_tpu_torch.ops import covariance, knn, pointops
from glim_tpu_torch.preprocess.callbacks import PreprocessCallbacks
from glim_tpu_torch.types import PreprocessedFrame, RawPoints, capacity_for, upload
from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("preprocess")


@dataclass
class CloudPreprocessorParams:
    """Mirrors config_preprocess.json keys (reference defaults)."""

    distance_near_thresh: float = 0.5
    distance_far_thresh: float = 100.0
    use_random_grid_downsampling: bool = True
    downsample_resolution: float = 1.0
    random_downsample_target: int = 10000
    random_downsample_rate: float = 0.1
    enable_outlier_removal: bool = False
    outlier_removal_k: int = 10
    outlier_std_mul_factor: float = 1.0
    enable_cropbox_filter: bool = False
    crop_bbox_frame: str = "lidar"
    crop_bbox_min: np.ndarray = None
    crop_bbox_max: np.ndarray = None
    k_correspondences: int = 10
    T_imu_lidar: np.ndarray = None
    exact_knn: bool = False                  # banded Morton kNN by default
    knn_window: int = 64
    quantize_resolution: float = 0.005       # upload quantization [m/LSB]

    @staticmethod
    def from_config(config, sensors_config=None) -> "CloudPreprocessorParams":
        p = CloudPreprocessorParams()
        g = lambda k, d: config.param("preprocess", k, d)
        p.distance_near_thresh = g("distance_near_thresh", p.distance_near_thresh)
        p.distance_far_thresh = g("distance_far_thresh", p.distance_far_thresh)
        p.use_random_grid_downsampling = g("use_random_grid_downsampling", True)
        p.downsample_resolution = g("downsample_resolution", 1.0)
        p.random_downsample_target = int(g("random_downsample_target", 10000))
        p.random_downsample_rate = g("random_downsample_rate", 0.1)
        p.enable_outlier_removal = g("enable_outlier_removal", False)
        p.outlier_removal_k = int(g("outlier_removal_k", 10))
        p.outlier_std_mul_factor = g("outlier_std_mul_factor", 1.0)
        p.enable_cropbox_filter = g("enable_cropbox_filter", False)
        p.crop_bbox_frame = g("crop_bbox_frame", "lidar")
        p.crop_bbox_min = np.asarray(g("crop_bbox_min", [-1.0, -1.0, -1.0]))
        p.crop_bbox_max = np.asarray(g("crop_bbox_max", [1.0, 1.0, 1.0]))
        p.k_correspondences = int(g("k_correspondences", 10))
        if sensors_config is not None:
            T_lidar_imu = sensors_config.param_se3("sensors", "T_lidar_imu")
            p.T_imu_lidar = np.linalg.inv(T_lidar_imu)
        return p


def _preprocess_device(packed, meta, pt_scale, prio, prio2, *,
                       out_cap: int, use_random_grid: bool, k: int,
                       enable_cropbox: bool, enable_outlier_removal: bool,
                       outlier_k: int, exact_knn: bool, knn_window: int,
                       near, far, resolution, bbox_T, bbox_min, bbox_max,
                       outlier_std_mul):
    """The device pipeline. Returns (points, times, mask, neighbors).

    ``packed`` is the (C, 4) int16 [x, y, z, t] upload at pt_scale m/LSB and
    t_scale s/LSB; ``meta`` is (3,) f32 [n_valid, t_scale, sample_target];
    ``prio``/``prio2`` are the (C,) uniform priorities of the grid sampler.
    """
    C = packed.shape[0]
    dev = packed.device
    n_valid = meta[0].to(torch.int32)
    t_scale = meta[1]
    target = meta[2].to(torch.int32)
    points = packed[:, :3].to(torch.float32) * pt_scale
    times = packed[:, 3].to(torch.float32) * t_scale
    mask = torch.arange(C, device=dev) < n_valid
    mask = pointops.distance_filter(points, mask, near, far)

    if use_random_grid:
        pts_d, mask_d, idx = pointops.randomgrid_sampling(
            points, mask, resolution, target, prio, prio2)
        times_d = times[idx]
    else:
        pts_d, mask_d = pointops.voxelgrid_sampling(points, mask, resolution)
        # Centroid times: the nearest original point's time.
        nn_idx, _ = knn.knn_search(pts_d, mask_d, points, mask, k=1)
        times_d = times[nn_idx[:, 0].to(torch.int64)]

    pts_d, mask_d, times_d = pts_d[:out_cap], mask_d[:out_cap], times_d[:out_cap]

    # Time sort (stable, as jnp.argsort).
    t_sort = torch.where(mask_d, times_d, float("inf"))
    order = torch.sort(t_sort, stable=True).indices
    pts_d = pts_d[order]
    times_d = torch.where(mask_d[order], times_d[order], 0.0)
    mask_d = mask_d[order]

    if enable_cropbox:
        mask_d = pointops.cropbox_filter(pts_d, mask_d, bbox_T, bbox_min, bbox_max)

    if exact_knn:
        neighbors, sq_dists = knn.knn_search(pts_d, mask_d, pts_d, mask_d, k=k)
    else:
        neighbors, sq_dists = knn.knn_banded(pts_d, mask_d, k, window=knn_window,
                                             cell=2.0 * resolution)
    if enable_outlier_removal:
        # kNN columns are distance-sorted: the first outlier_k are the
        # outlier-removal neighbourhood.
        mask_d = covariance.outlier_mask(sq_dists[:, :outlier_k], mask_d,
                                         outlier_std_mul)
    return pts_d, times_d, mask_d, neighbors


class CloudPreprocessor:
    """Sensor-agnostic scan preprocessing front-end on ``device``."""

    def __init__(self, params: Optional[CloudPreprocessorParams] = None,
                 seed: int = 0, device="cuda"):
        self.params = params or CloudPreprocessorParams()
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        tgt = self.params.random_downsample_target
        # target <= 0 selects rate mode; the output capacity is then chosen
        # per scan from the input size.
        self.out_capacity = capacity_for(max(tgt, 512)) if tgt > 0 else None
        p = self.params
        if p.enable_outlier_removal and p.outlier_removal_k > p.k_correspondences:
            logger.warning(
                "outlier_removal_k=%d exceeds k_correspondences=%d; the "
                "outlier test reuses the correspondence kNN graph and is "
                "clamped to %d neighbors", p.outlier_removal_k,
                p.k_correspondences, p.k_correspondences)
        bbox_T = np.eye(4, dtype=np.float32)
        if p.enable_cropbox_filter and p.crop_bbox_frame == "imu" \
                and p.T_imu_lidar is not None:
            bbox_T = p.T_imu_lidar.astype(np.float32)
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
        self._d_const = dict(
            pt_scale=f32(p.quantize_resolution),
            near=f32(p.distance_near_thresh),
            far=f32(p.distance_far_thresh),
            resolution=f32(p.downsample_resolution),
            bbox_T=f32(bbox_T),
            bbox_min=f32(p.crop_bbox_min if p.crop_bbox_min is not None else [-1.0] * 3),
            bbox_max=f32(p.crop_bbox_max if p.crop_bbox_max is not None else [1.0] * 3),
            outlier_std_mul=f32(p.outlier_std_mul_factor),
        )

    def preprocess(self, raw: RawPoints) -> PreprocessedFrame:
        PreprocessCallbacks.on_raw_points_received(raw)
        p = self.params
        n = raw.size
        cap = capacity_for(max(n, 1024))
        if raw.times is not None and len(raw.times) == n and n:
            scan_duration = float(np.max(raw.times))
        else:
            scan_duration = 0.0
        t_scale = max(scan_duration, 1e-3) / 32000.0
        packed, _ = pack_scan_i16(np.asarray(raw.points, np.float64),
                                  raw.times if scan_duration > 0.0 else None,
                                  cap, p.quantize_resolution, t_scale)

        if p.random_downsample_target > 0:
            target = p.random_downsample_target
            out_cap = self.out_capacity
        else:
            target = max(512, int(n * p.random_downsample_rate))
            out_cap = capacity_for(target)

        dev = upload(packed, self.device)
        meta = upload(np.array([n, t_scale, target], np.float32), self.device)
        prio = torch.rand(cap, generator=self._gen, device=self.device)
        prio2 = torch.rand(cap, generator=self._gen, device=self.device)
        c = self._d_const
        pts_d, times_d, mask_d, neighbors = _preprocess_device(
            dev, meta, c["pt_scale"], prio, prio2,
            out_cap=out_cap,
            use_random_grid=p.use_random_grid_downsampling,
            k=p.k_correspondences,
            enable_cropbox=p.enable_cropbox_filter,
            enable_outlier_removal=p.enable_outlier_removal,
            outlier_k=min(p.outlier_removal_k, p.k_correspondences),
            exact_knn=p.exact_knn, knn_window=p.knn_window,
            near=c["near"], far=c["far"], resolution=c["resolution"],
            bbox_T=c["bbox_T"], bbox_min=c["bbox_min"], bbox_max=c["bbox_max"],
            outlier_std_mul=c["outlier_std_mul"])

        frame = PreprocessedFrame(
            stamp=raw.stamp, scan_end_time=raw.stamp + scan_duration,
            k_neighbors=p.k_correspondences,
            device_points=pts_d, device_times=times_d, device_mask=mask_d,
            device_neighbors=neighbors, raw_points=raw)
        PreprocessCallbacks.on_filtering_finished(frame)
        return frame
