"""GlimTorch: the config-driven front of the PyTorch port.

Twin of ``glim_tpu/pipeline.py::GlimTPU`` in synchronous mode: reads
config.json, builds the time keeper, the preprocessor, the configured
odometry module and the configured sub-mapping module on ``device`` (the
card by default; without one it raises unless ``device="cpu"``), and
exposes ``insert_imu`` / ``insert_frame`` / ``wait`` / ``odometry_estimates``
/ ``submaps``. Frames marginalized out of the odometry window go to
sub-mapping, as in ``GlimTPU``'s synchronous path.

Global mapping is not built yet: the submaps are kept in ``submaps``. The
async worker threads (``async_mode=True``) and extension modules are not
ported either. A module the port lacks (for example
``libsub_mapping_passthrough.so``) raises, naming the module; it is never
swapped for another.
"""

from __future__ import annotations

import tempfile
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from glim_tpu_torch.mapping.sub_mapping_base import SubMappingBase
from glim_tpu_torch.odometry.estimation_base import OdometryEstimationBase
from glim_tpu_torch.preprocess.cloud_preprocessor import (CloudPreprocessor,
                                                          CloudPreprocessorParams)
from glim_tpu_torch.types import EstimationFrame, RawPoints, SubMap
from glim_tpu_torch.utils.config import GlobalConfig, create_default_config_dir
from glim_tpu_torch.utils.data_validator import DataValidator
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.time_keeper import PerPointTimeSettings, TimeKeeper
from glim_tpu_torch.utils.trajectory_manager import TrajectoryManager

logger = create_module_logger("glim")


class GlimTorch:
    """LiDAR-IMU odometry and sub-mapping: scans + IMU in, odometry
    estimates and submaps out."""

    def __init__(self, config_path: Optional[str] = None,
                 async_mode: bool = False, device="cuda",
                 overrides: Optional[List[tuple]] = None):
        """``overrides`` is a list of (logical_config, module, name, value)
        applied after loading and before module construction."""
        if async_mode:
            raise NotImplementedError("glim_tpu_torch runs the synchronous "
                                      "pipeline only (async_mode=False)")
        self.device = torch.device(device)
        if self.device.type != "cpu" and not torch.cuda.is_available():
            raise RuntimeError(f"GlimTorch: device {self.device} requested but no CUDA device "
                               'is available; pass device="cpu" to run on the host')
        if config_path is None:
            config_path = create_default_config_dir(
                tempfile.mkdtemp(prefix="glim_tpu_torch_config_"))
        GlobalConfig.reset()
        self.config = GlobalConfig.instance(config_path)
        for logical, module, name, value in (overrides or []):
            self.config.get_config(logical).override_param(module, name, value)

        sensors = self.config.get_config("config_sensors")
        self.T_lidar_imu = sensors.param_se3("sensors", "T_lidar_imu")
        self.time_keeper = TimeKeeper(PerPointTimeSettings.from_config(sensors))
        self.trajectory = TrajectoryManager()
        self.data_validator = DataValidator()

        pre_cfg = self.config.get_config("config_preprocess")
        self.preprocessor = CloudPreprocessor(
            CloudPreprocessorParams.from_config(pre_cfg, sensors), device=self.device)
        ros_cfg = self.config.get_config("config_ros")
        self.keep_raw_points = bool(ros_cfg.param("glim_ros", "keep_raw_points", False))

        odo_cfg = self.config.get_config("config_odometry")
        self.odometry = OdometryEstimationBase.load_module(
            odo_cfg.param("odometry_estimation", "so_name", "libodometry_estimation_cpu.so"),
            odo_cfg, sensors_config=sensors, device=self.device)
        sub_cfg = self.config.get_config("config_sub_mapping")
        self.sub_mapping = SubMappingBase.load_module(
            sub_cfg.param("sub_mapping", "so_name", "libsub_mapping.so"), sub_cfg,
            device=self.device)
        glb_cfg = self.config.get_config("config_global_mapping")
        logger.info("glim_tpu_torch: global mapping (%s) is not built yet; submaps "
                    "are kept in GlimTorch.submaps",
                    glb_cfg.param("global_mapping", "so_name", "libglobal_mapping.so"))
        self._sync_estimates: List[EstimationFrame] = []
        self._submaps: List[SubMap] = []

    # -- input --

    def insert_imu(self, stamp: float, linear_acc, angular_vel) -> None:
        self.data_validator.imu_callback(stamp, linear_acc, angular_vel)
        if not self.time_keeper.validate_imu_stamp(stamp):
            return
        linear_acc, angular_vel = np.asarray(linear_acc), np.asarray(angular_vel)
        self.odometry.insert_imu(stamp, linear_acc, angular_vel)
        self.sub_mapping.insert_imu(stamp, linear_acc, angular_vel)

    def insert_frame(self, raw: RawPoints) -> None:
        self.data_validator.points_callback(raw)
        if not self.time_keeper.process(raw):
            logger.warning("dropping scan at %.6f", raw.stamp)
            return
        with record_function("preprocess"):
            frame = self.preprocessor.preprocess(raw)
        if not self.keep_raw_points:
            frame.raw_points = None
        marginalized: List[EstimationFrame] = []
        with record_function("odometry"):
            est = self.odometry.insert_frame(frame, marginalized)
        if est is not None:
            self._sync_estimates.append(est)
            self.trajectory.add_odom(est.stamp, est.T_world_sensor())
        with record_function("sub_mapping"):
            for m in marginalized:
                # The state copy lands while sub-mapping dispatches its work.
                m.fetch_state_async()
                self.sub_mapping.insert_frame(m)
            self._submaps.extend(self.sub_mapping.get_submaps())

    # -- control --

    def wait(self) -> None:
        """Flush the pipeline (end of sequence): the frames still in the
        odometry window, with their final poses, go to sub-mapping, which
        closes its last submap."""
        for m in self.odometry.get_remaining_frames():
            self.sub_mapping.insert_frame(m)
        self._submaps.extend(self.sub_mapping.submit_end_of_sequence())

    # -- output --

    @property
    def odometry_estimates(self) -> List[EstimationFrame]:
        return self._sync_estimates

    @property
    def submaps(self) -> List[SubMap]:
        return self._submaps
