"""Thread-safe queues connecting pipeline stages.

Numpy-side copy of ``glim_tpu/utils/concurrent.py`` (reference:
include/glim/util/concurrent_vector.hpp:15-209): push/insert from a producer
thread, drain (``get_all_and_clear[_wait]``) or pop from a consumer thread,
bounded drop-oldest policy, and end-of-data signalling used for clean
pipeline shutdown. ``high_water`` records the deepest the queue has been.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Generic, List, Optional, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class DataStorePolicy:
    """Bounded-queue policy: keep at most max_size items, dropping oldest."""

    max_size: int = 0  # 0 = unlimited

    @staticmethod
    def UPTO(n: int) -> "DataStorePolicy":
        return DataStorePolicy(max_size=n)

    UNLIMITED: "DataStorePolicy" = None  # type: ignore[assignment]


DataStorePolicy.UNLIMITED = DataStorePolicy(max_size=0)


class ConcurrentVector(Generic[T]):
    """SPSC-friendly thread-safe vector (safe for MPMC too)."""

    def __init__(self, policy: DataStorePolicy = DataStorePolicy.UNLIMITED):
        self._policy = policy
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._data: deque = deque()
        self._end_of_data = False
        self.high_water = 0

    def push_back(self, item: T) -> None:
        with self._cv:
            self._data.append(item)
            self._trim()
            self._cv.notify_all()

    def insert(self, items: List[T]) -> None:
        with self._cv:
            self._data.extend(items)
            self._trim()
            self._cv.notify_all()

    def _trim(self) -> None:
        if self._policy.max_size > 0:
            while len(self._data) > self._policy.max_size:
                self._data.popleft()
        self.high_water = max(self.high_water, len(self._data))

    def get_all_and_clear(self) -> List[T]:
        with self._cv:
            items = list(self._data)
            self._data.clear()
        return items

    def get_all_and_clear_wait(self, timeout: Optional[float] = 0.1) -> List[T]:
        with self._cv:
            if not self._data and not self._end_of_data:
                self._cv.wait(timeout)
            items = list(self._data)
            self._data.clear()
        return items

    def pop_wait(self, timeout: Optional[float] = 0.1) -> Optional[T]:
        with self._cv:
            if not self._data and not self._end_of_data:
                self._cv.wait(timeout)
            if self._data:
                return self._data.popleft()
            return None

    def size(self) -> int:
        with self._lock:
            return len(self._data)

    def empty(self) -> bool:
        return self.size() == 0

    def clear(self) -> None:
        with self._cv:
            self._data.clear()

    def submit_end_of_data(self) -> None:
        with self._cv:
            self._end_of_data = True
            self._cv.notify_all()

    def end_of_data(self) -> bool:
        with self._lock:
            return self._end_of_data and not self._data

    def closed(self) -> bool:
        with self._lock:
            return self._end_of_data
