"""Abstract global-mapping interface (reference:
include/glim/mapping/global_mapping_base.hpp:22-81), and the split of a
submap's map lag that both back-ends record at the end of an optimize
(``record_map_lag``)."""

from __future__ import annotations

import time
from typing import Iterable

import numpy as np

from glim_tpu_torch.types import SubMap
from glim_tpu_torch.utils.profiling import record
from glim_tpu_torch.utils.registry import load_module

# The map lag of a submap, as the time from its newest frame's hand-over to
# ``GlimTorch.insert_frame`` until the end of the first optimize that covers
# the submap, cut at the host-clock stamps taken along the way
# (``host_stamps`` of the frame and of the submap): (entry, from, to).
MAP_LAG_STAGES = (("map_lag/odometry", "handover", "estimate"),
                  ("map_lag/window", "estimate", "marginalized"),
                  ("map_lag/sub_mapping", "marginalized", "sub_mapping"),
                  ("map_lag/global", "sub_mapping", "inserted"),
                  ("map_lag/optimize", "inserted", "optimized"))


def record_map_lag(submaps: Iterable[SubMap]) -> None:
    """At the end of an optimize: for each submap it covers for the first
    time, stamp ``optimized`` and record the five stages of its map lag
    (``utils/profiling.py::record``) from the stamps of the submap and of its
    newest frame. A submap whose newest frame did not come through every
    stamp (fed to a module directly, loaded from a dump) records nothing."""
    now = time.perf_counter()
    for sm in submaps:
        st = sm.host_stamps
        if "optimized" in st or not sm.frames:
            continue
        st["optimized"] = now
        t = dict(max(sm.frames, key=lambda f: f.stamp).host_stamps, **st)
        if all(k in t for _, k, _ in MAP_LAG_STAGES):
            for name, a, b in MAP_LAG_STAGES:
                record(name, t[b] - t[a])


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
