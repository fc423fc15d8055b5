"""Lightweight stage profiling.

Twin of ``glim_tpu/utils/profiling.py``: named scopes accumulate host
wall-time statistics per stage, thread-safe, and ``report()`` logs a summary
table. Each scope also opens a ``torch.profiler.record_function`` span of the
same name, so a profiler trace shows the stages under the names the
synchronous pipeline uses. ``device_trace`` records such a trace (host ops
and spans, and the card's kernels) when ``GLIM_TPU_TORCH_TRACE_DIR`` is set.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("prof")

_lock = threading.Lock()
_stats: Dict[str, list] = {}


@contextlib.contextmanager
def profile_scope(name: str):
    """Accumulate wall time under `name` (thread-safe) inside a profiler
    span of the same name."""
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            s = _stats.setdefault(name, [0, 0.0, 0.0])  # n, total, max
            s[0] += 1
            s[1] += dt
            s[2] = max(s[2], dt)


def report(reset: bool = False) -> Dict[str, dict]:
    """Log + return per-scope stats {name: {n, total_s, mean_ms, max_ms}}."""
    with _lock:
        snap = {k: list(v) for k, v in _stats.items()}
        if reset:
            _stats.clear()
    out = {}
    for name, (n, total, mx) in sorted(snap.items(), key=lambda kv: -kv[1][1]):
        out[name] = dict(n=n, total_s=total, mean_ms=total / max(n, 1) * 1e3,
                         max_ms=mx * 1e3)
        logger.info("profile %-28s n=%-6d total=%7.2fs mean=%7.2fms max=%7.2fms",
                    name, n, total, total / max(n, 1) * 1e3, mx * 1e3)
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
