"""Abstract sub-mapping interface (reference: include/glim/mapping/sub_mapping_base.hpp:22-67)."""

from __future__ import annotations

from typing import List

import numpy as np

from glim_tpu_torch.types import EstimationFrame, SubMap
from glim_tpu_torch.utils.registry import load_module


class SubMappingBase:
    def insert_image(self, stamp: float, image) -> None:
        from glim_tpu_torch.mapping.callbacks import SubMappingCallbacks
        SubMappingCallbacks.on_insert_image(stamp, image)

    def insert_imu(self, stamp: float, linear_acc: np.ndarray,
                   angular_vel: np.ndarray) -> None:
        pass

    def insert_frame(self, frame: EstimationFrame) -> None:
        raise NotImplementedError

    def get_submaps(self) -> List[SubMap]:
        """Drain submaps completed since the last call."""
        raise NotImplementedError

    def submit_end_of_sequence(self) -> List[SubMap]:
        """Flush: build a submap from whatever is buffered."""
        return []

    @staticmethod
    def load_module(so_name: str, *args, **kwargs) -> "SubMappingBase":
        return load_module("sub_mapping", so_name, *args, **kwargs)
