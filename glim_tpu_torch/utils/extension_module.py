"""Extension module base + loader.

Twin of ``glim_tpu/utils/extension_module.py`` (reference:
include/glim/util/extension_module.hpp:10-42,
src/glim/util/extension_module.cpp:8-14): plugins attach to the global
callback slots; the pipeline polls ``needs_wait()`` for backpressure and
``ok()`` for health (a failing module requests system shutdown);
``at_exit(dump_path)`` fires on save. Loading goes through the registry.

Unlike the JAX package, which logs "not available; skipped", a name the
port lacks raises ``NotImplementedError`` naming it (``registry.load_module``).
A module's factory reads its config section only when a ``GlobalConfig``
exists (``global_config``); any other error in it propagates.
"""

from __future__ import annotations

from typing import List, Optional

from glim_tpu_torch.utils.config import Config, GlobalConfig
from glim_tpu_torch.utils.registry import load_module


class ExtensionModule:
    def ok(self) -> bool:
        """False requests a system shutdown."""
        return True

    def needs_wait(self) -> bool:
        """True asks the pipeline to throttle input."""
        return False

    def at_exit(self, dump_path: str) -> None:
        pass

    @staticmethod
    def load_extensions(so_names: List[str], device="cuda") -> List["ExtensionModule"]:
        """Instantiate each named extension module on ``device``."""
        return [load_module("extension", name, device=device) for name in so_names]


def global_config(logical: Optional[str] = None) -> Optional[Config]:
    """The process's ``GlobalConfig`` (or its ``logical`` file), or None when
    no pipeline has initialized one: the one config error an extension
    factory answers with its defaults."""
    cfg = GlobalConfig.current()
    if cfg is None:
        return None
    return cfg.get_config(logical) if logical else cfg


def config_getter(section: str, logical: Optional[str] = None):
    """``g(name, default)`` reading ``section`` of the global config (or of
    its ``logical`` file); the defaults when there is none."""
    cfg = global_config(logical)
    if cfg is None:
        return lambda name, default: default
    return lambda name, default: cfg.param(section, name, default)
