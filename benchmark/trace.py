"""A ``torch.profiler`` slice and its reduction to what the per-layer
metrics read.

The slice records host activity (ops and the program's ``record_function``
spans) and the card's activity; its Chrome trace is written under the run's
temporary directory, read back once, reduced and deleted. The reduction
keeps: the slice's host-clock length, the union of the device's busy
intervals (kernels, copies, sets), kernel counts and device seconds by
name, and the idle gaps between busy intervals, each named by the innermost
host span (``record_function`` / ``profile_scope``) open at its midpoint.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_name(name: str) -> str:
    """The bare function name of a kernel event, whose name is a demangled
    signature ("void ns::f<...>(...)") or a plain name."""
    n = re.sub(r"\(anonymous namespace\)::", "", name).split("(")[0].split("<")[0].strip()
    return n.split(" ")[-1].split("::")[-1]


def traced(fn, tmpdir: str, device) -> dict:
    """Run ``fn()`` under the profiler (synchronised at both ends); return
    the reduced trace with ``window_s``, the slice's host-clock length. On
    a CPU ``device`` (the tests) only host activity is recorded."""
    on_card = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    path = os.path.join(tmpdir, "trace.json")
    with profile(activities=activities, experimental_config=_all_threads()) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    t_w = time.perf_counter()
    prof.export_chrome_trace(path)
    try:
        t_r = time.perf_counter()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        out = reduce_events(events)
        out["read_s"] = time.perf_counter() - t_r
        out["trace_mib"] = os.path.getsize(path) / 2 ** 20
    finally:
        os.remove(path)
    out["write_s"] = t_r - t_w
    out["window_s"] = window_s
    return out


def _all_threads():
    """Record the host ops of every thread (the pipeline's workers started
    before the profiler), where this PyTorch has the option."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def reduce_events(events: list) -> dict:
    """Reduce Chrome-trace events (microsecond ``ts`` / ``dur``)."""
    dev: List[Tuple[float, float]] = []
    kernels: Dict[str, List[float]] = {}
    ops: Dict[str, float] = {}
    spans: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            name = kernel_name(e.get("name", "")) if cat == "kernel" else cat
            ops[name] = ops.get(name, 0.0) + dur * 1e-6
            if cat == "kernel":
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += dur * 1e-6
        elif cat == "user_annotation":
            spans.append((ts, ts + dur, e.get("name", "")))
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # Each gap goes to the host span open at its midpoint that began last
    # (the innermost one on a thread): a sweep with a heap of open spans.
    spans.sort()
    gaps: Dict[str, float] = {}
    heap: list = []
    j = 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        while j < len(spans) and spans[j][0] <= mid:
            heapq.heappush(heap, (-spans[j][0], spans[j][1], spans[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no host span)"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) * 1e-6
    return dict(busy_s=busy_s,
                span_s=(busy[-1][1] - busy[0][0]) * 1e-6 if busy else 0.0,
                kernels={k: (n, s) for k, (n, s) in kernels.items()},
                n_kernels=sum(n for n, _ in kernels.values()),
                device_ops=sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:10],
                idle_gaps=sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:10])
