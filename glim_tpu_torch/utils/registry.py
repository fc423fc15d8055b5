"""Named module registry replacing the reference's dlopen plugin loader.

The reference selects estimation-module implementations by the ``so_name``
config key and dlopens ``lib*.so`` exporting ``create_*_module`` C symbols
(reference: src/glim/util/load_module.cpp:8-31,
odometry/odometry_estimation_base.cpp:28-30, CMakeLists.txt:123-193). Here the
same config keys map to registered Python factories. A module the port does
not have raises, naming it; it is never replaced by another.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("registry")

# kind -> name -> factory
_REGISTRY: Dict[str, Dict[str, Callable[..., Any]]] = {}

# Map reference so_name strings to registry names so reference configs work as-is.
SO_NAME_ALIASES = {
    "libodometry_estimation_cpu.so": "odometry_estimation_cpu",
    "libodometry_estimation_gpu.so": "odometry_estimation_gpu",
    "libodometry_estimation_ct.so": "odometry_estimation_ct",
    "libsub_mapping.so": "sub_mapping",
    "libsub_mapping_passthrough.so": "sub_mapping_passthrough",
    "libglobal_mapping.so": "global_mapping",
    "libglobal_mapping_pose_graph.so": "global_mapping_pose_graph",
    "libstandard_viewer.so": "standard_viewer",
    "libinteractive_viewer.so": "interactive_viewer",
    "libmemory_monitor.so": "memory_monitor",
    "librviz_viewer.so": "rviz_viewer",
    "libimu_validator.so": "imu_validator",
    # glim_ext module names (the ecosystem extensions bundled in
    # glim_tpu/ext/).
    "libscan_context_loop_detector.so": "scan_context",
    "libdbow_loop_detector.so": "image_loop",
    "libgnss_global.so": "gnss_global",
    "libvelocity_suppressor.so": "velocity_suppressor",
}


def canonical_name(so_name: str) -> str:
    name = SO_NAME_ALIASES.get(so_name, so_name)
    if name.startswith("lib") and name.endswith(".so"):
        name = name[3:-3]
    return name


def register_module(kind: str, name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a factory under (kind, name)."""

    def deco(factory: Callable) -> Callable:
        _REGISTRY.setdefault(kind, {})[name] = factory
        return factory

    return deco


def _ensure_builtins_imported(kind: str) -> None:
    # Lazy import of the built-in implementations so registry lookups work
    # without the caller importing every pipeline module.
    mods = {"odometry": ["glim_tpu_torch.odometry.odometry_estimation_imu",
                         "glim_tpu_torch.odometry.odometry_estimation_cpu_imu"],
            "sub_mapping": ["glim_tpu_torch.mapping.sub_mapping"]}
    for m in mods.get(kind, []):
        importlib.import_module(m)


def load_module(kind: str, so_name: str, *args: Any, **kwargs: Any) -> Any:
    """Instantiate the module registered under (kind, canonical_name(so_name));
    raises NotImplementedError, naming the module, if the port lacks it."""
    factories = available_modules(kind)
    name = canonical_name(so_name)
    if name not in factories:
        raise NotImplementedError(
            f"{kind} module {so_name!r} is not ported to glim_tpu_torch; "
            f"ported: {sorted(factories)}")
    logger.info("loading module %s/%s", kind, name)
    return factories[name](*args, **kwargs)


def available_modules(kind: str) -> Dict[str, Callable]:
    _ensure_builtins_imported(kind)
    return dict(_REGISTRY.get(kind, {}))
