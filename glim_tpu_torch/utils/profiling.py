"""Lightweight stage profiling.

Twin of ``glim_tpu/utils/profiling.py``: named scopes accumulate host
wall-time statistics per stage, thread-safe, and ``report()`` logs a summary
table. A scope also takes its thread's CPU time, so that ``report()`` tells a
stage's own work from the time its thread waited (for the GIL, a lock or a
queue) inside it. Each scope also opens a ``torch.profiler.record_function``
span of the same name, so a profiler trace shows the stages under the names
the synchronous pipeline uses. ``record`` adds a duration measured elsewhere
to the same table, with no span (the map lag's stages,
``mapping/global_mapping_base.py::record_map_lag``). ``device_trace`` records
a profiler trace (host ops and spans, and the card's kernels) when
``GLIM_TPU_TORCH_TRACE_DIR`` is set.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("prof")

_lock = threading.Lock()
_stats: Dict[str, list] = {}   # name -> [n, total, max, cpu total or None]


def _add(name: str, dt: float, cpu: Optional[float]) -> None:
    with _lock:
        s = _stats.setdefault(name, [0, 0.0, 0.0, None if cpu is None else 0.0])
        s[0] += 1
        s[1] += dt
        s[2] = max(s[2], dt)
        if cpu is not None:
            s[3] += cpu


@contextlib.contextmanager
def profile_scope(name: str):
    """Accumulate wall time and the thread's CPU time under `name`
    (thread-safe) inside a profiler span of the same name."""
    t0 = time.perf_counter()
    c0 = time.thread_time()
    try:
        with record_function(name):
            yield
    finally:
        _add(name, time.perf_counter() - t0, time.thread_time() - c0)


def record(name: str, seconds: float) -> None:
    """Add a duration measured elsewhere under `name`, as one more sample of
    the table ``report()`` reads; no span is opened and no CPU time taken."""
    _add(name, seconds, None)


def report(reset: bool = False) -> Dict[str, dict]:
    """Log + return per-entry stats {name: {n, total_s, mean_ms, max_ms}};
    a scope's entry adds ``cpu_ms``, the mean CPU time of its thread, and
    ``offcpu_ms``, the mean wall time less that: what the thread spent
    waiting (for the GIL, a lock, the kernel's scheduler) inside the span.
    A CUDA sync spins by default, so it counts as CPU time. Entries of
    ``record`` have no CPU time and neither key."""
    with _lock:
        snap = {k: list(v) for k, v in _stats.items()}
        if reset:
            _stats.clear()
    out = {}
    for name, (n, total, mx, cpu) in sorted(snap.items(), key=lambda kv: -kv[1][1]):
        e = out[name] = dict(n=n, total_s=total, mean_ms=total / max(n, 1) * 1e3,
                             max_ms=mx * 1e3)
        if cpu is not None:
            e["cpu_ms"] = cpu / max(n, 1) * 1e3
            e["offcpu_ms"] = (total - cpu) / max(n, 1) * 1e3
        logger.info("profile %-28s n=%-6d total=%7.2fs mean=%7.2fms max=%7.2fms%s",
                    name, n, total, e["mean_ms"], e["max_ms"],
                    "" if cpu is None else f" cpu={e['cpu_ms']:7.2f}ms")
    return out


@contextlib.contextmanager
def device_trace(name: str = "glim", device="cuda"):
    """A ``torch.profiler`` trace of the enclosed work, active when
    ``GLIM_TPU_TORCH_TRACE_DIR`` is set, else a no-op: host activity (ops
    and ``profile_scope`` spans), plus the card's kernels and copies when
    ``device`` is a CUDA device, written as a Chrome trace to
    ``$GLIM_TPU_TORCH_TRACE_DIR/<name>/trace.json``. A CUDA ``device``
    without a card raises rather than tracing the host alone."""
    trace_dir = os.environ.get("GLIM_TPU_TORCH_TRACE_DIR")
    if not trace_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device_trace: device {device} requested but no CUDA "
                               "device is available")
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(trace_dir, name, "trace.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(out)
    logger.info("device trace written to %s", out)
