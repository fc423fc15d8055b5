"""Multicast callback slots — the framework's extension mechanism.

Equivalent surface to the reference's ``CallbackSlot<Func>``
(reference: include/glim/util/callback_slot.hpp:11-69): observers register
with ``add`` (returning a removable handle), pipeline stages fire events with
``call``/``__call__``. Slots are declared as class attributes on per-stage
callback structs (see glim_tpu_torch.preprocess.callbacks, odometry.callbacks,
mapping.callbacks), exactly mirroring the reference's static-slot layout so
extension modules port over.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict


class CallbackSlot:
    """Thread-safe multicast callback registry."""

    _ALL: list = []   # every slot ever declared (slots are static members)

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._next_id = 0
        self._callbacks: Dict[int, Callable] = {}
        CallbackSlot._ALL.append(self)

    @staticmethod
    def clear_all() -> None:
        """Deregister every observer from every slot. Slots are static class
        members shared process-wide, so long-lived processes that build many
        pipelines (and the test suite) use this to drop stale observers —
        otherwise each dead pipeline's callbacks keep firing and keep the
        dead objects alive."""
        for slot in CallbackSlot._ALL:
            slot.clear()

    def add(self, fn: Callable) -> int:
        with self._lock:
            handle = self._next_id
            self._next_id += 1
            self._callbacks[handle] = fn
        return handle

    def remove(self, handle: int) -> bool:
        with self._lock:
            return self._callbacks.pop(handle, None) is not None

    def clear(self) -> None:
        with self._lock:
            self._callbacks.clear()

    def empty(self) -> bool:
        with self._lock:
            return not self._callbacks

    def __len__(self) -> int:
        with self._lock:
            return len(self._callbacks)

    def call(self, *args: Any, **kwargs: Any) -> None:
        with self._lock:
            fns = list(self._callbacks.values())
        for fn in fns:
            fn(*args, **kwargs)

    __call__ = call
