"""Velocity suppressor extension.

Twin of ``glim_tpu/ext/velocity_suppressor.py`` (glim_ext's
velocity_suppressor: "constraints to regulate IMU velocity"). The
regulation term lives inside the window step (``window_scan_step``'s
``vel_reg``); this module switches it on for the active odometry module
through ``set_velocity_regulation`` the first time the smoother update
fires.
"""

from __future__ import annotations

from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks as OCB
from glim_tpu_torch.utils.extension_module import ExtensionModule, config_getter
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("vel_sup")


class VelocitySuppressor(ExtensionModule):
    def __init__(self, max_velocity: float = 5.0, weight: float = 10.0):
        self.max_velocity = max_velocity
        self.weight = weight
        self.applied = False
        self._handle = OCB.on_smoother_update.add(self._on_smoother_update)

    def detach(self) -> None:
        if self._handle is not None:
            OCB.on_smoother_update.remove(self._handle)
            self._handle = None

    def _on_smoother_update(self, odometry_module, *args) -> None:
        if self.applied:
            return
        setter = getattr(odometry_module, "set_velocity_regulation", None)
        if setter is None:
            logger.warning("odometry module %s has no velocity regulation hook; "
                           "velocity_suppressor inactive", type(odometry_module).__name__)
        else:
            setter(self.weight, self.max_velocity)
            logger.info("velocity regulation enabled: |v| <= %.1f m/s (weight %.1f)",
                        self.max_velocity, self.weight)
        self.applied = True


@register_module("extension", "velocity_suppressor")
def create_extension_module(*args, **kwargs):
    g = config_getter("velocity_suppressor")
    return VelocitySuppressor(max_velocity=float(g("max_velocity", 5.0)),
                              weight=float(g("weight", 10.0)))
