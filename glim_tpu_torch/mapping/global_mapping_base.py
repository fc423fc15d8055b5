"""Abstract global-mapping interface (reference: include/glim/mapping/global_mapping_base.hpp:22-81)."""

from __future__ import annotations

import numpy as np

from glim_tpu_torch.types import SubMap
from glim_tpu_torch.utils.registry import load_module


class GlobalMappingBase:
    def insert_image(self, stamp: float, image) -> None:
        from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks
        GlobalMappingCallbacks.on_insert_image(stamp, image)

    def insert_imu(self, stamp: float, linear_acc: np.ndarray,
                   angular_vel: np.ndarray) -> None:
        pass

    def insert_submap(self, submap: SubMap) -> None:
        raise NotImplementedError

    def optimize(self) -> None:
        pass

    def find_overlapping_submaps(self, min_overlap: float) -> None:
        pass

    def recover_graph(self) -> None:
        pass

    def save(self, path: str) -> None:
        raise NotImplementedError

    def export_points(self) -> np.ndarray:
        """All submap points in the world frame, (N, 3)."""
        raise NotImplementedError

    @staticmethod
    def load_module(so_name: str, *args, **kwargs) -> "GlobalMappingBase":
        return load_module("global_mapping", so_name, *args, **kwargs)
