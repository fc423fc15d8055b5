"""Core data model: raw scans, preprocessed frames, estimation frames.

Twin of ``glim_tpu/types.py``: point clouds are padded fixed-capacity SoA
tensors with validity masks; capacity classes are powers of two. Device
fields are torch tensors on the pipeline's device; host mirrors are fetched
lazily with ``.detach().cpu().numpy()`` on first access.
"""

from __future__ import annotations

import copy
import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def capacity_for(n: int, minimum: int = 512) -> int:
    """Round n up to the next power-of-two capacity class."""
    c = minimum
    while c < n:
        c *= 2
    return c


def to_numpy(t, dtype=None) -> np.ndarray:
    """Host copy of a tensor (or pass-through for numpy input)."""
    if isinstance(t, HostCopy):
        t = t.numpy()
    elif isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype) if dtype is not None else np.asarray(t)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device``. To a CUDA device the copy goes
    through pinned memory and is queued on the stream, so the host does not
    wait for it (a copy from pageable memory would)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class HostCopy:
    """A device -> host copy that lands in the background.

    On a CUDA tensor the copy goes to pinned host memory behind a recorded
    event: ``ready()`` asks the event without waiting, ``numpy()`` waits for
    the event and then reads (reading pinned memory before the copy has
    landed would return stale numbers silently). A CPU tensor is always
    ready."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclass
class PointBatch:
    """Padded SoA point cloud resident on device; invalid lanes are masked."""

    points: torch.Tensor          # (C, 3) f32
    mask: torch.Tensor            # (C,) bool
    times: Optional[torch.Tensor] = None        # (C,) f32
    intensities: Optional[torch.Tensor] = None  # (C,) f32
    covs: Optional[torch.Tensor] = None         # (C, 3, 3) f32
    normals: Optional[torch.Tensor] = None      # (C, 3) f32


@dataclass
class RawPoints:
    """One raw sensor scan (reference: util/raw_points.hpp:12-27)."""

    stamp: float
    points: np.ndarray                       # (N, 3) or (N, 4) f64
    times: Optional[np.ndarray] = None       # (N,) per-point times
    intensities: Optional[np.ndarray] = None
    colors: Optional[np.ndarray] = None      # (N, 4)
    rings: Optional[np.ndarray] = None       # (N,) int

    @property
    def size(self) -> int:
        return int(self.points.shape[0])


class PreprocessedFrame:
    """Downsampled/filtered scan + kNN graph, padded to the preprocessor's
    output capacity; host mirrors are fetched lazily."""

    def __init__(self, stamp: float, scan_end_time: float, k_neighbors: int,
                 device_points=None, device_times=None, device_mask=None,
                 device_neighbors=None, raw_points: Optional[RawPoints] = None,
                 points: Optional[np.ndarray] = None,
                 times: Optional[np.ndarray] = None,
                 intensities: Optional[np.ndarray] = None,
                 neighbors: Optional[np.ndarray] = None):
        self.stamp = stamp
        self.scan_end_time = scan_end_time
        self.k_neighbors = k_neighbors
        self.device_points = device_points      # (C, 3)
        self.device_times = device_times        # (C,)
        self.device_mask = device_mask          # (C,)
        self.device_neighbors = device_neighbors  # (C, k)
        self.raw_points = raw_points
        self.intensities = intensities
        self._points = points
        self._times = times
        self._neighbors = neighbors

    @property
    def points(self) -> Optional[np.ndarray]:
        if self._points is None and self.device_points is not None:
            self._points = to_numpy(self.device_points)
        return self._points

    @property
    def times(self) -> Optional[np.ndarray]:
        if self._times is None and self.device_times is not None:
            self._times = to_numpy(self.device_times)
        return self._times

    @property
    def neighbors(self) -> Optional[np.ndarray]:
        if self._neighbors is None and self.device_neighbors is not None:
            self._neighbors = to_numpy(self.device_neighbors)
        return self._neighbors

    @property
    def size(self) -> int:
        if self.device_mask is not None:
            return int(to_numpy(self.device_mask).sum())
        return int(self._points.shape[0]) if self._points is not None else 0


class FrameID(enum.Enum):
    WORLD = "world"
    LIDAR = "lidar"
    IMU = "imu"


class EstimationFrame:
    """One odometry estimation frame; world poses may be backed by device
    tensors and are fetched lazily."""

    def __init__(self, id: int = -1, stamp: float = 0.0,
                 T_lidar_imu: Optional[np.ndarray] = None,
                 T_world_lidar: Optional[np.ndarray] = None,
                 T_world_imu: Optional[np.ndarray] = None,
                 device_T_world_lidar=None,
                 v_world_imu: Optional[np.ndarray] = None,
                 device_v_world_imu=None,
                 imu_bias: Optional[np.ndarray] = None,
                 device_imu_bias=None,
                 imu_rate_trajectory: Optional[np.ndarray] = None,
                 cov_pose=None, cov_velocity=None, cov_bias=None,
                 frame_id: FrameID = FrameID.LIDAR,
                 frame: Optional[PointBatch] = None,
                 raw_frame: Optional[PreprocessedFrame] = None,
                 voxelmaps: Optional[List[Any]] = None,
                 custom_data: Optional[Dict[str, Any]] = None):
        self.id = id
        self.stamp = stamp
        self.T_lidar_imu = np.eye(4) if T_lidar_imu is None else T_lidar_imu
        self._T_world_lidar = T_world_lidar
        self._T_world_imu = T_world_imu
        self.device_T_world_lidar = device_T_world_lidar
        self._v_world_imu = v_world_imu
        self.device_v_world_imu = device_v_world_imu
        self._imu_bias = imu_bias
        self.device_imu_bias = device_imu_bias
        self._imu_rate_trajectory = imu_rate_trajectory
        # (packed (8, CAP) [stamps_rel; trans(3); quats(4)], n, stamp0).
        self.device_imu_rate_trajectory = None
        self.cov_pose = cov_pose
        self.cov_velocity = cov_velocity
        self.cov_bias = cov_bias
        self.frame_id = frame_id
        self.frame = frame
        self.raw_frame = raw_frame
        self.voxelmaps = [] if voxelmaps is None else voxelmaps
        self.custom_data = {} if custom_data is None else custom_data
        # In-flight packed-state copy: (HostCopy, need_T, need_v, need_b).
        self._state_pending = None

    @property
    def T_world_lidar(self) -> np.ndarray:
        if self._T_world_lidar is None:
            if self.device_T_world_lidar is not None:
                self._T_world_lidar = to_numpy(self.device_T_world_lidar, np.float64)
            else:
                self._T_world_lidar = np.eye(4)
        return self._T_world_lidar

    @T_world_lidar.setter
    def T_world_lidar(self, T) -> None:
        self._T_world_lidar = np.asarray(T, np.float64)

    @property
    def T_world_imu(self) -> np.ndarray:
        # p_lidar = T_lidar_imu * p_imu, hence T_world_imu = T_world_lidar * T_lidar_imu.
        if self._T_world_imu is None:
            self._T_world_imu = self.T_world_lidar @ self.T_lidar_imu
        return self._T_world_imu

    @T_world_imu.setter
    def T_world_imu(self, T) -> None:
        self._T_world_imu = np.asarray(T, np.float64)

    @property
    def imu_rate_trajectory(self):
        """(8, n) [abs stamps; trans xyz; quat xyzw] or None."""
        if self._imu_rate_trajectory is None \
                and self.device_imu_rate_trajectory is not None:
            packed, n, stamp0 = self.device_imu_rate_trajectory
            arr = to_numpy(packed, np.float64)[:, :n].copy()
            arr[0] += stamp0
            self._imu_rate_trajectory = arr
        return self._imu_rate_trajectory

    @imu_rate_trajectory.setter
    def imu_rate_trajectory(self, traj) -> None:
        self._imu_rate_trajectory = traj

    @property
    def imu_bias(self) -> np.ndarray:
        if self._imu_bias is None:
            if self.device_imu_bias is not None:
                self._imu_bias = to_numpy(self.device_imu_bias, np.float64)
            else:
                self._imu_bias = np.zeros(6)
        return self._imu_bias

    @imu_bias.setter
    def imu_bias(self, b) -> None:
        self._imu_bias = np.asarray(b, np.float64)

    @property
    def v_world_imu(self) -> np.ndarray:
        if self._v_world_imu is None:
            if self.device_v_world_imu is not None:
                self._v_world_imu = to_numpy(self.device_v_world_imu, np.float64)
            else:
                self._v_world_imu = np.zeros(3)
        return self._v_world_imu

    @v_world_imu.setter
    def v_world_imu(self, v) -> None:
        self._v_world_imu = np.asarray(v, np.float64)

    def _pack_state(self):
        """The packed 25-float device state [T_world_lidar (16), v (3),
        bias (6)] and which parts are missing from the host caches, or None
        when nothing is missing."""
        need_T = self._T_world_lidar is None and self.device_T_world_lidar is not None
        need_v = self._v_world_imu is None and self.device_v_world_imu is not None
        need_b = self._imu_bias is None and self.device_imu_bias is not None
        if not (need_T or need_v or need_b):
            return None
        dev = next(t.device for t, need in ((self.device_T_world_lidar, need_T),
                                            (self.device_v_world_imu, need_v),
                                            (self.device_imu_bias, need_b)) if need)
        part = lambda t, need, n: (t.reshape(-1).to(torch.float32) if need
                                   else torch.zeros(n, device=dev))
        packed = torch.cat([part(self.device_T_world_lidar, need_T, 16),
                            part(self.device_v_world_imu, need_v, 3),
                            part(self.device_imu_bias, need_b, 6)])
        return packed, need_T, need_v, need_b

    def fetch_state_async(self) -> None:
        """Start the device -> host copy of the packed state; a later
        ``fetch_state()`` reads it when it has landed."""
        if self._state_pending is not None:
            return
        ps = self._pack_state()
        if ps is not None:
            self._state_pending = (HostCopy(ps[0]),) + ps[1:]

    def fetch_state(self) -> None:
        """Fill the pose/velocity/bias host caches from one packed copy
        (the one ``fetch_state_async`` started, if any); no-op for values
        already cached."""
        ps = self._state_pending
        if ps is None:
            ps = self._pack_state()
            if ps is None:
                return
            ps = (HostCopy(ps[0]),) + ps[1:]
        self._state_pending = None
        host, need_T, need_v, need_b = ps
        packed = np.asarray(host.numpy(), np.float64)
        if need_T and self._T_world_lidar is None:
            self._T_world_lidar = packed[:16].reshape(4, 4)
        if need_v and self._v_world_imu is None:
            self._v_world_imu = packed[16:19]
        if need_b and self._imu_bias is None:
            self._imu_bias = packed[19:25]

    def T_world_sensor(self) -> np.ndarray:
        if self.frame_id == FrameID.LIDAR:
            return self.T_world_lidar
        if self.frame_id == FrameID.IMU:
            return self.T_world_imu
        return np.eye(4)

    def set_T_world_sensor(self, T: np.ndarray) -> None:
        if self.frame_id == FrameID.LIDAR:
            self.T_world_lidar = T
            self.T_world_imu = T @ self.T_lidar_imu
        elif self.frame_id == FrameID.IMU:
            self.T_world_imu = T
            self.T_world_lidar = T @ np.linalg.inv(self.T_lidar_imu)
        else:
            raise ValueError("cannot set world pose for WORLD frame")

    def clone(self) -> "EstimationFrame":
        return copy.copy(self)

    def clone_wo_points(self) -> "EstimationFrame":
        c = self.clone()
        c.frame = None
        c.raw_frame = None
        c.voxelmaps = []
        return c


@dataclass
class SubMap:
    """A bundle of optimized frames merged into one map node."""

    id: int = -1
    session_id: int = 0

    T_world_origin: np.ndarray = field(default_factory=lambda: np.eye(4))
    T_origin_endpoint_L: np.ndarray = field(default_factory=lambda: np.eye(4))
    T_origin_endpoint_R: np.ndarray = field(default_factory=lambda: np.eye(4))

    frame: Optional[PointBatch] = None       # merged + downsampled points
    voxelmaps: List[Any] = field(default_factory=list)

    frames: List[EstimationFrame] = field(default_factory=list)       # optimized
    odom_frames: List[EstimationFrame] = field(default_factory=list)  # raw odometry
    custom_data: Dict[str, Any] = field(default_factory=dict)

    def drop_frame_points(self) -> None:
        self.frames = [f.clone_wo_points() for f in self.frames]
        self.odom_frames = [f.clone_wo_points() for f in self.odom_frames]
