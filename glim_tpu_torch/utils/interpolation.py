"""Stamped-value stream interpolation helper (host copy of
``glim_tpu/utils/interpolation.py``).

Equivalent surface to the reference's ``InterpolationHelper``
(reference: include/glim/util/interpolation_helper.hpp:23-122): append stamped
values, query an interpolation bracket for an arbitrary stamp with a tri-state
result, and drop consumed history.
"""

from __future__ import annotations

import bisect
import enum
from typing import Any, List, Optional, Tuple


class InterpolationResult(enum.Enum):
    SUCCESS = 0
    FAILURE = 1  # query before the oldest stored stamp
    WAITING = 2  # query after the newest stored stamp; more data needed


class InterpolationHelper:
    def __init__(self):
        self._stamps: List[float] = []
        self._values: List[Any] = []

    def add(self, stamp: float, value: Any) -> None:
        self._stamps.append(float(stamp))
        self._values.append(value)

    def __len__(self) -> int:
        return len(self._stamps)

    def leftmost_time(self) -> float:
        return self._stamps[0] if self._stamps else -1.0

    def rightmost_time(self) -> float:
        return self._stamps[-1] if self._stamps else -1.0

    def find(self, stamp: float) -> Tuple[InterpolationResult, Optional[Tuple[float, Any]], Optional[Tuple[float, Any]], int]:
        """Returns (status, (t0, v0), (t1, v1), index_of_right_bracket)."""
        if not self._stamps or stamp < self._stamps[0]:
            return InterpolationResult.FAILURE, None, None, -1
        if stamp > self._stamps[-1]:
            return InterpolationResult.WAITING, None, None, -1
        idx = bisect.bisect_left(self._stamps, stamp)
        if self._stamps[idx] == stamp:
            left = max(idx - 1, 0)
            return (InterpolationResult.SUCCESS,
                    (self._stamps[left], self._values[left]),
                    (self._stamps[idx], self._values[idx]), idx)
        return (InterpolationResult.SUCCESS,
                (self._stamps[idx - 1], self._values[idx - 1]),
                (self._stamps[idx], self._values[idx]), idx)

    def erase_before(self, stamp: float, margin: int = 1) -> None:
        """Drop entries strictly older than stamp, keeping `margin` extra."""
        idx = bisect.bisect_left(self._stamps, stamp)
        cut = max(0, idx - margin)
        if cut > 0:
            self._stamps = self._stamps[cut:]
            self._values = self._values[cut:]
