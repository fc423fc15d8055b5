"""Abstract odometry estimation interface + module factory.

Equivalent surface to the reference's ``OdometryEstimationBase``
(reference: include/glim/odometry/odometry_estimation_base.hpp:22-68,
src/glim/odometry/odometry_estimation_base.cpp:28-30 for the dlopen factory,
replaced here by the named registry).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from glim_tpu_torch.types import EstimationFrame, PreprocessedFrame
from glim_tpu_torch.utils.registry import load_module


class OdometryEstimationBase:
    def requires_imu(self) -> bool:
        return True

    def insert_image(self, stamp: float, image) -> None:
        # Fire the extension hook (reference:
        # odometry/odometry_estimation_base.cpp:14-16).
        from glim_tpu_torch.odometry.callbacks import OdometryEstimationCallbacks
        OdometryEstimationCallbacks.on_insert_image(stamp, image)

    def insert_imu(self, stamp: float, linear_acc: np.ndarray,
                   angular_vel: np.ndarray) -> None:
        pass

    def insert_frame(self, frame: PreprocessedFrame,
                     marginalized: Optional[List[EstimationFrame]] = None
                     ) -> Optional[EstimationFrame]:
        """Process one preprocessed scan; returns the new estimation frame.

        Frames marginalized out of the estimation window are appended to
        ``marginalized`` (they feed sub-mapping).
        """
        raise NotImplementedError

    def get_remaining_frames(self) -> List[EstimationFrame]:
        """Frames still in the window at end-of-sequence."""
        return []

    @staticmethod
    def load_module(so_name: str, *args, **kwargs) -> "OdometryEstimationBase":
        return load_module("odometry", so_name, *args, **kwargs)
