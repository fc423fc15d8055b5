"""Helpers of the per-layer metric readers (``benchmark/metrics/*.py``).

A reader takes the run (``drivers/*.run``'s dict: ``scopes``, the program's
``profile_scope`` totals over the window, host clock and no device sync;
``trace``, the reduced profiler slice; ``nn_calls``, the shapes of the
``nn_search`` calls in that slice) and returns a number, or None when the
run holds nothing for it to read.
"""

from __future__ import annotations

from typing import Optional


def scope_mean_ms(run: dict, name: str) -> Optional[float]:
    s = (run.get("scopes") or {}).get(name)
    return float(s["mean_ms"]) if s and s["n"] > 0 else None


def device_idle_pct(run: dict) -> Optional[float]:
    """100 x (1 - the union of the device's busy intervals over the traced
    slice's host-clock length)."""
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
