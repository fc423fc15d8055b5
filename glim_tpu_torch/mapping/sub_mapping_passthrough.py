"""Lightweight non-optimizing sub-mapping.

Twin of ``glim_tpu/mapping/sub_mapping_passthrough.py`` (reference:
src/glim/mapping/sub_mapping_passthrough.cpp:16-156): displacement-gated
keyframes accumulated into one incremental point voxel map on the device; a
submap is emitted when the keyframe count or the voxel-occupancy budget is
hit, and its points are the map's, randomly sampled down to the target with
priorities drawn from the module's own ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks as CB
from glim_tpu_torch.mapping.sub_mapping_base import SubMappingBase
from glim_tpu_torch.ops import lie_np, pointops
from glim_tpu_torch.ops import voxelmap as vmx
from glim_tpu_torch.types import EstimationFrame, PointBatch, SubMap, upload
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("sub")


@dataclass
class SubMappingPassthroughParams:
    keyframe_update_interval_rot: float = 0.01
    keyframe_update_interval_trans: float = 0.1
    max_num_keyframes: int = 50
    max_num_voxels: int = -1
    adaptive_max_num_voxels: float = 2.5
    submap_voxel_resolution: float = 0.5
    min_dist_in_voxel: float = 0.2
    max_num_points_in_voxel: int = 100
    submap_target_num_points: int = 50000
    point_capacity: int = 131072

    @staticmethod
    def from_config(config) -> "SubMappingPassthroughParams":
        p = SubMappingPassthroughParams()
        g = lambda k, d: config.param("sub_mapping", k, d)
        p.keyframe_update_interval_rot = g("keyframe_update_interval_rot", 0.01)
        p.keyframe_update_interval_trans = g("keyframe_update_interval_trans", 0.1)
        p.max_num_keyframes = int(g("max_num_keyframes", 50))
        p.max_num_voxels = int(g("max_num_voxels", -1))
        p.adaptive_max_num_voxels = g("adaptive_max_num_voxels", 2.5)
        p.submap_voxel_resolution = g("submap_voxel_resolution", 0.5)
        p.min_dist_in_voxel = g("min_dist_in_voxel", 0.2)
        p.max_num_points_in_voxel = int(g("max_num_points_in_voxel", 100))
        p.submap_target_num_points = int(g("submap_target_num_points", 50000))
        return p


class SubMappingPassthrough(SubMappingBase):
    def __init__(self, params: Optional[SubMappingPassthroughParams] = None,
                 device="cuda"):
        self.params = params or SubMappingPassthroughParams()
        self.device = torch.device(device)
        self.submap_count = 0
        self.keyframes: List[EstimationFrame] = []
        self.odom_frames: List[EstimationFrame] = []
        self.submap_queue: List[SubMap] = []
        self._map: Optional[vmx.PointVoxelMap] = None
        # Occupied-voxel count after each keyframe insert; entry [2] is the
        # reference's init_num_voxels for the adaptive emission check.
        self._num_voxels_history: List[int] = []
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(11)
        # Whether every keyframe batch so far carried covariances: if so the
        # submap carries them (rotated into its origin frame), else covs is
        # None and global mapping estimates them.
        self._covs_complete = True

    def insert_frame(self, frame: EstimationFrame) -> None:
        CB.on_insert_frame(frame)
        p = self.params
        self.odom_frames.append(frame.clone_wo_points())

        if self.keyframes:
            T_last = self.keyframes[-1].T_world_sensor()
            delta = lie_np.se3_log(np.linalg.inv(T_last) @ frame.T_world_sensor())
            if (np.linalg.norm(delta[3:]) < p.keyframe_update_interval_trans
                    and np.linalg.norm(delta[:3]) < p.keyframe_update_interval_rot):
                return

        self._insert_keyframe(frame)
        CB.on_new_keyframe(len(self.keyframes) - 1, frame)

        full = len(self.keyframes) >= p.max_num_keyframes
        if self._map is not None and (p.max_num_voxels > 0 or p.adaptive_max_num_voxels > 0):
            nv = int(self._map.mask.sum())      # one point per sub-voxel
            self._num_voxels_history.append(nv)
            if p.max_num_voxels > 0:
                full = full or nv >= p.max_num_voxels
            # Adaptive budget: emit when the map outgrew the voxel count it
            # had after its third keyframe by the configured factor.
            if p.adaptive_max_num_voxels > 0 and len(self._num_voxels_history) >= 3:
                full = full or nv >= self._num_voxels_history[2] * p.adaptive_max_num_voxels
        if full:
            self._create_submap()

    def get_submaps(self) -> List[SubMap]:
        out = self.submap_queue
        self.submap_queue = []
        return out

    def submit_end_of_sequence(self) -> List[SubMap]:
        if self.keyframes:
            self._create_submap()
        return self.get_submaps()

    # -- internals --

    def _priorities(self, n: int) -> torch.Tensor:
        """(n,) uniform sampling priorities for one submap."""
        return torch.rand(n, generator=self._gen, device=self.device)

    def _insert_keyframe(self, frame: EstimationFrame) -> None:
        p = self.params
        if self._map is None:
            # The per-cell point cap maps to a minimum point spacing: one
            # point per min_dist sub-voxel holds at most (resolution /
            # min_dist)^3 points in a resolution-sized cell.
            min_dist = max(p.min_dist_in_voxel,
                           p.submap_voxel_resolution
                           / max(float(p.max_num_points_in_voxel), 1.0) ** (1 / 3))
            self._map = vmx.empty_point_voxelmap(p.point_capacity, min_dist,
                                                 device=self.device)
        batch = frame.frame
        if batch is not None and batch.points is not None:
            T = upload(np.asarray(frame.T_world_sensor(), np.float32), self.device)
            R = T[:3, :3]
            w_pts = batch.points @ R.T + T[:3, 3]
            if batch.covs is not None:
                covs = R @ batch.covs @ R.T
            else:
                covs = torch.zeros(batch.points.shape[:1] + (3, 3), device=self.device)
                self._covs_complete = False
            self._map = vmx.pointmap_insert(self._map, w_pts, batch.mask, covs,
                                            len(self.keyframes))
        self.keyframes.append(frame.clone_wo_points())

    def _create_submap(self) -> None:
        p = self.params
        K = len(self.keyframes)
        T_world_origin = self.keyframes[K // 2].T_world_sensor()
        T_origin_world = np.linalg.inv(T_world_origin)

        # Submap cloud: the map's points (world) in the origin frame, cut to
        # the target. random_sampling puts the shuffled valid points first,
        # so the slice keeps exactly the sample.
        prio = self._priorities(self._map.capacity)
        pts, mask, order = pointops.random_sampling(
            self._map.points, self._map.mask, p.submap_target_num_points, prio)
        tgt = min(p.submap_target_num_points, self._map.capacity)
        pts, mask = pts[:tgt], mask[:tgt]
        To = upload(np.asarray(T_origin_world, np.float32), self.device)
        Ro = To[:3, :3]
        pts_o = pts @ Ro.T + To[:3, 3]
        covs_o = None
        if self._covs_complete:
            covs_o = Ro @ self._map.covs[order[:tgt]] @ Ro.T

        submap = SubMap(
            id=self.submap_count,
            T_world_origin=T_world_origin,
            T_origin_endpoint_L=T_origin_world @ self.keyframes[0].T_world_sensor(),
            T_origin_endpoint_R=T_origin_world @ self.keyframes[-1].T_world_sensor(),
            frame=PointBatch(points=pts_o, mask=mask, covs=covs_o),
            frames=self.keyframes,
            odom_frames=self.odom_frames)
        # Creation-time origin (global mapping overwrites T_world_origin).
        submap.custom_data["T_world_origin_pre"] = T_world_origin.copy()
        self.submap_count += 1
        self.keyframes = []
        self.odom_frames = []
        self._map = None
        self._num_voxels_history = []
        self._covs_complete = True
        self.submap_queue.append(submap)
        CB.on_new_submap(submap)
        logger.info("passthrough submap %d created (%d keyframes)", submap.id, K)


@register_module("sub_mapping", "sub_mapping_passthrough")
def create_sub_mapping_passthrough_module(config=None, device="cuda"):
    """libsub_mapping_passthrough.so."""
    params = (SubMappingPassthroughParams.from_config(config)
              if config is not None else SubMappingPassthroughParams())
    return SubMappingPassthrough(params, device=device)
