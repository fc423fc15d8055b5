"""Carried state between the JAX package and the port, as numpy dicts.

The odometry has no weights; its carried state is the sliding window, the
map (a point map, or a tuple of Gaussian voxel-map levels) and the keyframe
store; global mapping's is the padded factor graph that ``global_gn``
solves (``global_gn_args_from_numpy``). These functions turn a state given
as a dict of numpy arrays (one entry per dataclass field, the window's
``preints`` as a nested dict) into the port's tensors on ``device``, and
back. Floating arrays become float32,
integer arrays int32, booleans stay boolean, so a float64 numpy state is not
silently kept as float64 in torch.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Dict, Tuple

import numpy as np
import torch

from glim_tpu_torch.odometry.keyframe_manager import KeyframeStore
from glim_tpu_torch.odometry.window_estimator import WindowState
from glim_tpu_torch.ops.imu import PreintegratedImu
from glim_tpu_torch.ops.voxelmap import GaussianVoxelMap, PointVoxelMap
from glim_tpu_torch.types import to_numpy


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dt = np.bool_
    elif np.issubdtype(a.dtype, np.integer):
        dt = np.int32
    else:
        dt = np.float32
    return torch.as_tensor(np.array(a, dt, order="C"), device=device)


def _from_numpy(cls, d: Dict[str, np.ndarray], device, nested=()):
    kw = {}
    for f in fields(cls):
        if f.name in nested:
            kw[f.name] = nested[f.name](d[f.name], device)
        elif d.get(f.name) is not None:
            kw[f.name] = _tensor(d[f.name], device)
    return cls(**kw)


def _to_numpy(obj, nested=()) -> Dict[str, np.ndarray]:
    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = nested[f.name](v) if f.name in nested else (
            None if v is None else to_numpy(v))
    return out


def preintegrated_imu_from_numpy(d: Dict[str, np.ndarray], device) -> PreintegratedImu:
    return _from_numpy(PreintegratedImu, d, device)


def preintegrated_imu_to_numpy(pre: PreintegratedImu) -> Dict[str, np.ndarray]:
    return _to_numpy(pre)


def window_state_from_numpy(d: Dict, device) -> WindowState:
    """All 22 WindowState fields; ``d["preints"]`` is a nested dict."""
    return _from_numpy(WindowState, d, device,
                       nested={"preints": preintegrated_imu_from_numpy})


def window_state_to_numpy(win: WindowState) -> Dict:
    return _to_numpy(win, nested={"preints": preintegrated_imu_to_numpy})


def point_voxelmap_from_numpy(d: Dict[str, np.ndarray], device) -> PointVoxelMap:
    return _from_numpy(PointVoxelMap, d, device)


def point_voxelmap_to_numpy(pm: PointVoxelMap) -> Dict[str, np.ndarray]:
    return _to_numpy(pm)


def gaussian_voxelmap_from_numpy(d: Dict[str, np.ndarray], device) -> GaussianVoxelMap:
    """One map, or a stack of maps when every field has a leading axis."""
    return _from_numpy(GaussianVoxelMap, d, device)


def gaussian_voxelmap_to_numpy(vm: GaussianVoxelMap) -> Dict[str, np.ndarray]:
    return _to_numpy(vm)


def voxelmap_levels_from_numpy(levels, device) -> Tuple[GaussianVoxelMap, ...]:
    """The multi-resolution model: a sequence of per-level dicts."""
    return tuple(gaussian_voxelmap_from_numpy(d, device) for d in levels)


def voxelmap_levels_to_numpy(levels) -> Tuple[Dict[str, np.ndarray], ...]:
    return tuple(gaussian_voxelmap_to_numpy(vm) for vm in levels)


def keyframe_store_from_numpy(d: Dict, device) -> KeyframeStore:
    """All KeyframeStore fields; ``d["vm"]`` is the stacked mini maps' dict."""
    return _from_numpy(KeyframeStore, d, device,
                       nested={"vm": gaussian_voxelmap_from_numpy})


def keyframe_store_to_numpy(store: KeyframeStore) -> Dict:
    return _to_numpy(store, nested={"vm": gaussian_voxelmap_to_numpy})


def global_gn_args_from_numpy(d: Dict, device) -> Dict:
    """``global_gn``'s argument dict (the JAX package's keyword names,
    without the static bucket sizes) given as numpy arrays, ``d["m_pre"]``
    the PreintegratedImu stack as a nested dict -> the port's tensors on
    ``device``; absent translation priors stay None."""
    return {k: (preintegrated_imu_from_numpy(v, device) if k == "m_pre"
                else None if v is None else _tensor(v, device))
            for k, v in d.items()}
