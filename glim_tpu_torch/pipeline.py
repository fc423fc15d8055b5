"""GlimTorch: the config-driven front of the PyTorch port.

Twin of ``glim_tpu/pipeline.py::GlimTPU``: reads config.json, builds the time
keeper, the preprocessor and the configured odometry, sub-mapping and
global-mapping modules on ``device`` (the card by default; without one it
raises unless ``device="cpu"``), and exposes ``insert_imu`` /
``insert_frame`` / ``insert_image`` / ``workload`` / ``wait`` / ``save`` /
``odometry_estimates`` / ``submaps`` / ``export_points``.

By default (``async_mode=True``) each stage runs on its own worker thread
behind a queue (``AsyncOdometryEstimation``, ``AsyncSubMapping``,
``AsyncGlobalMapping``), as in ``GlimTPU``; all three queue their device
work on the device's default stream, in the order the threads reach it.
``workload()`` is the deepest input queue, for the feeder's backpressure.
A stage whose worker raised makes ``workload()``, ``wait()`` and the next
``insert_frame`` raise, after the other workers are stopped. With
``async_mode=False`` everything runs inline: frames marginalized out of the
odometry window go to sub-mapping and each new submap to global mapping on
the caller's thread.

``submaps`` are the global mapping's, with their optimized
``T_world_origin``. ``extension_modules`` are loaded on ``device`` after the
stages (``utils/extension_module.py``; kept in ``extensions``): while any
of them ``needs_wait()``, ``workload()`` reports 1 << 20; ``ok()`` is
every extension's ``ok()``; ``save()`` calls each one's ``at_exit``. A
module the port lacks raises, naming the module; it is never swapped for
another.
"""

from __future__ import annotations

import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks
from glim_tpu_torch.mapping.global_mapping_base import GlobalMappingBase
from glim_tpu_torch.mapping.sub_mapping_base import SubMappingBase
from glim_tpu_torch.odometry.async_odometry_estimation import AsyncOdometryEstimation
from glim_tpu_torch.odometry.estimation_base import OdometryEstimationBase
from glim_tpu_torch.preprocess.cloud_preprocessor import (CloudPreprocessor,
                                                          CloudPreprocessorParams)
from glim_tpu_torch.types import EstimationFrame, RawPoints, SubMap
from glim_tpu_torch.utils.config import GlobalConfig, create_default_config_dir
from glim_tpu_torch.utils.extension_module import ExtensionModule
from glim_tpu_torch.utils.logging import configure_logging, create_module_logger
from glim_tpu_torch.utils.profiling import profile_scope, report
from glim_tpu_torch.utils.time_keeper import PerPointTimeSettings, TimeKeeper
from glim_tpu_torch.utils.trajectory_manager import TrajectoryManager

logger = create_module_logger("glim")


class GlimTorch:
    """End-to-end SLAM: scans + IMU in, odometry estimates and a globally
    consistent set of submaps out."""

    def __init__(self, config_path: Optional[str] = None,
                 async_mode: bool = True,
                 extension_modules: Optional[List[str]] = None,
                 overrides: Optional[List[tuple]] = None, device="cuda"):
        """``overrides`` is a list of (logical_config, module, name, value)
        applied after loading and before module construction."""
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

        # Before the first import of a module whose logger takes a file sink
        # (global, sub, validator): a logger is set up once, when made.
        log_cfg = self.config.get_config("config_logging")
        configure_logging(log_dir=log_cfg.param("logging", "log_dir", None),
                          save_logs=log_cfg.param("logging", "save_logs", False))
        from glim_tpu_torch.mapping.async_global_mapping import AsyncGlobalMapping
        from glim_tpu_torch.mapping.async_sub_mapping import AsyncSubMapping
        from glim_tpu_torch.utils.data_validator import DataValidator

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
        odometry = OdometryEstimationBase.load_module(
            odo_cfg.param("odometry_estimation", "so_name", "libodometry_estimation_cpu.so"),
            odo_cfg, sensors_config=sensors, device=self.device)
        sub_cfg = self.config.get_config("config_sub_mapping")
        sub = SubMappingBase.load_module(
            sub_cfg.param("sub_mapping", "so_name", "libsub_mapping.so"), sub_cfg,
            device=self.device)
        glb_cfg = self.config.get_config("config_global_mapping")
        glb = GlobalMappingBase.load_module(
            glb_cfg.param("global_mapping", "so_name", "libglobal_mapping_pose_graph.so"),
            glb_cfg, device=self.device)

        self.async_mode = async_mode
        if async_mode:
            self.odometry = AsyncOdometryEstimation(odometry)
            self.sub_mapping = AsyncSubMapping(sub)
            self.global_mapping = AsyncGlobalMapping(glb)
        else:
            self.odometry = odometry
            self.sub_mapping = sub
            self.global_mapping = glb
        self._sync_estimates: List[EstimationFrame] = []
        self.extensions = ExtensionModule.load_extensions(extension_modules or [], self.device)
        # The odom -> world anchor follows the globally corrected submaps
        # (fired on the global-mapping worker in async mode; the trajectory
        # manager locks).
        GlobalMappingCallbacks.on_update_submaps.add(self._on_update_submaps_anchor)

    def _on_update_submaps_anchor(self, submaps: List[SubMap]) -> None:
        if submaps and submaps[-1].frames:
            last = submaps[-1]
            self.trajectory.update_anchor(last.frames[-1].stamp,
                                          last.T_world_origin @ last.T_origin_endpoint_R)

    # -- input --

    def insert_imu(self, stamp: float, linear_acc, angular_vel) -> None:
        self.data_validator.imu_callback(stamp, linear_acc, angular_vel)
        if not self.time_keeper.validate_imu_stamp(stamp):
            return
        linear_acc, angular_vel = np.asarray(linear_acc), np.asarray(angular_vel)
        self.odometry.insert_imu(stamp, linear_acc, angular_vel)
        self.sub_mapping.insert_imu(stamp, linear_acc, angular_vel)
        self.global_mapping.insert_imu(stamp, linear_acc, angular_vel)

    def insert_frame(self, raw: RawPoints) -> None:
        handover = time.perf_counter()
        self.data_validator.points_callback(raw)
        if not self.time_keeper.process(raw):
            logger.warning("dropping scan at %.6f", raw.stamp)
            return
        with profile_scope("preprocess"):
            frame = self.preprocessor.preprocess(raw)
        frame.host_stamps["handover"] = handover
        if not self.keep_raw_points:
            frame.raw_points = None
        if self.async_mode:
            self.odometry.insert_frame(frame)
            self._guarded(self._pump)
            return
        marginalized: List[EstimationFrame] = []
        with profile_scope("odometry"):
            est = self.odometry.insert_frame(frame, marginalized)
        if est is not None:
            self._add_estimates([est])
        with profile_scope("sub_mapping"):
            for m in marginalized:
                # The state copy lands while sub-mapping dispatches its work.
                m.fetch_state_async()
                self.sub_mapping.insert_frame(m)
        with profile_scope("global_mapping"):
            for sm in self.sub_mapping.get_submaps():
                self.global_mapping.insert_submap(sm)

    def insert_image(self, stamp: float, image) -> None:
        """Forward a camera frame to every stage's image callbacks."""
        self.odometry.insert_image(stamp, image)
        self.sub_mapping.insert_image(stamp, image)
        self.global_mapping.insert_image(stamp, image)

    def _add_estimates(self, ests: List[EstimationFrame]) -> None:
        for e in ests:
            self._sync_estimates.append(e)
            self.trajectory.add_odom(e.stamp, e.T_world_sensor())

    def _pump(self) -> None:
        """Move results downstream: estimates to the trajectory, frames
        marginalized by the odometry to sub-mapping, submaps to global
        mapping."""
        est, margs = self.odometry.get_results()
        self._add_estimates(est)
        for m in margs:
            self.sub_mapping.insert_frame(m)
        for sm in self.sub_mapping.get_results():
            self.global_mapping.insert_submap(sm)

    def _guarded(self, fn) -> None:
        """Run ``fn``; if it raises (a stage's worker failed), stop every
        worker before the exception propagates."""
        try:
            fn()
        except BaseException:
            for stage in (self.odometry, self.sub_mapping, self.global_mapping):
                stage.stop()
            raise

    # -- control --

    def workload(self) -> int:
        if any(ext.needs_wait() for ext in self.extensions):
            return 1 << 20   # an extension asks for throttling
        if not self.async_mode:
            return 0
        loads = []
        self._guarded(lambda: loads.extend(
            stage.workload() for stage in (self.odometry, self.sub_mapping,
                                           self.global_mapping)))
        return max(loads)

    def ok(self) -> bool:
        """False when an extension module requests a shutdown."""
        return all(ext.ok() for ext in self.extensions)

    def wait(self) -> None:
        """Flush the pipeline (end of sequence): the frames still in the
        odometry window, with their final poses, go to sub-mapping, which
        closes its last submap; global mapping takes the remaining submaps
        without optimizing between them, then runs one final optimize
        (none when its ``enable_optimization`` is false). A back-end with
        ``wait_for_detection`` / ``stop`` has its detection finished before
        that solve and stopped after it, as in async mode."""
        if self.async_mode:
            self._guarded(self._drain)
            return
        for m in self.odometry.get_remaining_frames():
            self.sub_mapping.insert_frame(m)
        gm = self.global_mapping
        with profile_scope("global_mapping"):
            gm.defer_optimization = True
            for sm in self.sub_mapping.submit_end_of_sequence():
                gm.insert_submap(sm)
            gm.defer_optimization = False
            if hasattr(gm, "wait_for_detection"):
                gm.wait_for_detection()
            if getattr(getattr(gm, "params", None), "enable_optimization", True):
                gm.optimize()
            if hasattr(gm, "stop"):
                gm.stop()

    def _drain(self) -> None:
        # Flag the drain downstream before the odometry join: submaps
        # trickle into the global worker throughout the window flush, and
        # each would otherwise pay an intermediate optimize that the final
        # solve makes redundant.
        self.sub_mapping.begin_drain()
        self.global_mapping.begin_drain()
        self.odometry.join()
        self._pump()
        self.sub_mapping.join()
        for sm in self.sub_mapping.get_results():
            self.global_mapping.insert_submap(sm)
        self.global_mapping.join()

    # -- output --

    @property
    def odometry_estimates(self) -> List[EstimationFrame]:
        return self._sync_estimates

    @property
    def global_backend(self) -> GlobalMappingBase:
        """The global-mapping module itself (inside its async wrapper)."""
        return self.global_mapping.global_mapping if self.async_mode else self.global_mapping

    @property
    def submaps(self) -> List[SubMap]:
        return self.global_backend.submaps

    def save(self, path: str) -> None:
        """Log the stage profile, write the map dump to ``path``
        (``io/dump.py`` layout), then call each extension's ``at_exit``."""
        report()
        self.global_mapping.save(path)
        for ext in self.extensions:
            ext.at_exit(path)

    def export_points(self) -> np.ndarray:
        return self.global_mapping.export_points()
