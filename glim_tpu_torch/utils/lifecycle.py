"""Worker threads of the asynchronous pipeline and the registry of live ones.

Every object that owns a worker thread (the async pipeline wrappers)
registers itself here at construction. ``stop_all`` shuts down whatever is
still alive: the test suite calls it between tests, and embedders may call
it for a hard shutdown. Registration is a WeakSet, so normal operation never
keeps an object alive through this module (twin of
``glim_tpu/utils/lifecycle.py``).

``Worker`` runs a wrapper's loop on a daemon thread, inside the scope of the
pipeline's CUDA device (the current device is per thread), and keeps the
exception that ends the loop: ``check()`` and ``join()`` re-raise it, so a
failed stage stops the pipeline instead of leaving it short of frames or
submaps.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable, Optional

import torch

from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("glim")

_LIVE: "weakref.WeakSet" = weakref.WeakSet()


def register(obj) -> None:
    """Track a thread-owning object. ``obj`` must expose ``stop()`` or
    ``join()`` (checked in that order by stop_all)."""
    _LIVE.add(obj)


def stop_all(timeout: float = 5.0) -> int:
    """Stop every live registered object; returns how many were stopped.
    A stage's stored failure is not raised here: this is the shutdown
    path, and ``join()`` is where failures surface."""
    n = 0
    for obj in list(_LIVE):
        stop = getattr(obj, "stop", None) or getattr(obj, "join", None)
        stop(timeout=timeout)
        n += 1
        _LIVE.discard(obj)
    return n


class WorkerFailed(RuntimeError):
    """A pipeline stage's worker thread raised; the original exception is
    the ``__cause__``."""


class Worker:
    """A daemon thread that runs ``loop()`` once inside ``device``'s scope
    and keeps the exception that ends it."""

    def __init__(self, name: str, loop: Callable[[], None], device=None):
        self.name = name
        self.error: Optional[BaseException] = None
        self._loop = loop
        self._device = torch.device(device) if device is not None else None
        self.thread = threading.Thread(target=self._main, name=name, daemon=True)
        self.thread.start()

    def _main(self) -> None:
        scope = (torch.cuda.device(self._device)
                 if self._device is not None and self._device.type == "cuda"
                 else contextlib.nullcontext())
        try:
            with scope:
                self._loop()
        except BaseException as exc:   # kept for join()/check(), which re-raise
            self.error = exc
            logger.exception("%s worker failed", self.name)

    def check(self) -> None:
        """Raise ``WorkerFailed`` if the loop ended with an exception."""
        if self.error is not None:
            raise WorkerFailed(f"{self.name} worker failed: {self.error!r}") from self.error

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the loop to end, then re-raise its failure; raises
        ``TimeoutError`` if it is still running after ``timeout`` s."""
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise TimeoutError(f"{self.name} worker still running after {timeout} s")
        self.check()

    def is_alive(self) -> bool:
        return self.thread.is_alive()
