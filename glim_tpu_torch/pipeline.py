"""GlimTorch: the config-driven front of the PyTorch port.

Twin of ``glim_tpu/pipeline.py::GlimTPU`` in synchronous mode: reads
config.json, builds the time keeper, the preprocessor and the configured
odometry module on ``device``, and exposes ``insert_imu`` / ``insert_frame``
/ ``wait`` / ``odometry_estimates``.

Sub-mapping and global mapping are not built yet: the odometry path (time
keeper -> CloudPreprocessor -> odometry_estimation_cpu with GICP) is the
whole of this pipeline, and marginalized frames are dropped. Neither are the
async worker threads (``async_mode=True``) or extension modules. An odometry
module the port lacks (for example ``libodometry_estimation_gpu.so``)
raises, naming the module; it is never swapped for another.
"""

from __future__ import annotations

import tempfile
from typing import List, Optional

import numpy as np
import torch

from glim_tpu_torch.odometry.estimation_base import OdometryEstimationBase
from glim_tpu_torch.preprocess.cloud_preprocessor import (CloudPreprocessor,
                                                          CloudPreprocessorParams)
from glim_tpu_torch.types import EstimationFrame, RawPoints
from glim_tpu_torch.utils.config import GlobalConfig, create_default_config_dir
from glim_tpu_torch.utils.data_validator import DataValidator
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.time_keeper import PerPointTimeSettings, TimeKeeper
from glim_tpu_torch.utils.trajectory_manager import TrajectoryManager

logger = create_module_logger("glim")


class GlimTorch:
    """LiDAR-IMU odometry pipeline: scans + IMU in, odometry estimates out."""

    def __init__(self, config_path: Optional[str] = None,
                 async_mode: bool = False, device="cpu",
                 overrides: Optional[List[tuple]] = None):
        """``overrides`` is a list of (logical_config, module, name, value)
        applied after loading and before module construction."""
        if async_mode:
            raise NotImplementedError("glim_tpu_torch runs the synchronous "
                                      "pipeline only (async_mode=False)")
        self.device = torch.device(device)
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
        so_name = odo_cfg.param("odometry_estimation", "so_name",
                                "libodometry_estimation_cpu.so")
        self.odometry = OdometryEstimationBase.load_module(
            so_name, odo_cfg, sensors_config=sensors, device=self.device)
        logger.info("glim_tpu_torch: odometry only — sub-mapping and global "
                    "mapping are not built yet")
        self._sync_estimates: List[EstimationFrame] = []

    # -- input --

    def insert_imu(self, stamp: float, linear_acc, angular_vel) -> None:
        self.data_validator.imu_callback(stamp, linear_acc, angular_vel)
        if not self.time_keeper.validate_imu_stamp(stamp):
            return
        self.odometry.insert_imu(stamp, np.asarray(linear_acc), np.asarray(angular_vel))

    def insert_frame(self, raw: RawPoints) -> None:
        self.data_validator.points_callback(raw)
        if not self.time_keeper.process(raw):
            logger.warning("dropping scan at %.6f", raw.stamp)
            return
        frame = self.preprocessor.preprocess(raw)
        if not self.keep_raw_points:
            frame.raw_points = None
        est = self.odometry.insert_frame(frame, [])
        if est is not None:
            self._sync_estimates.append(est)
            self.trajectory.add_odom(est.stamp, est.T_world_sensor())

    # -- control --

    def wait(self) -> None:
        """Flush the pipeline (end of sequence): final window poses are
        written back into the estimates still in the window."""
        self.odometry.get_remaining_frames()

    # -- output --

    @property
    def odometry_estimates(self) -> List[EstimationFrame]:
        return self._sync_estimates
