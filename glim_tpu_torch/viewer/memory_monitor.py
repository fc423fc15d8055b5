"""Background memory monitor.

Twin of ``glim_tpu/viewer/memory_monitor.py`` (reference:
src/glim/viewer/memory_monitor.cpp:13-125): a polling thread reading
/proc/meminfo and /proc/self/statm plus the pipeline device's memory,
warning above 80% use and requesting shutdown through ``ok()`` when
critically low.

On the card the device side reads ``torch.cuda.mem_get_info`` and
``torch.cuda.memory_stats``; a failed read raises (the JAX package returns
None on any exception). The thread is a ``utils/lifecycle.Worker``: its
failure is re-raised by ``ok()`` and ``at_exit()``.
"""

from __future__ import annotations

import resource
import threading
from typing import Dict, Optional

import torch

from glim_tpu_torch.utils import lifecycle
from glim_tpu_torch.utils.extension_module import ExtensionModule
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("mem")


def read_meminfo() -> Dict[str, int]:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                parts = line.split()
                out[parts[0].rstrip(":")] = int(parts[1]) * 1024  # kB -> B
    except OSError:
        pass
    return out


def read_self_rss() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * resource.getpagesize()
    except OSError:
        return 0


def device_memory_stats(device) -> Optional[Dict]:
    """{"bytes_in_use", "bytes_limit", "bytes_free", "peak_bytes_in_use"} of
    a CUDA ``device``; None for the CPU, which has no device memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    stats = torch.cuda.memory_stats(device)
    return dict(bytes_in_use=int(stats.get("allocated_bytes.all.current", 0)),
                peak_bytes_in_use=int(stats.get("allocated_bytes.all.peak", 0)),
                bytes_free=int(free), bytes_limit=int(total))


class MemoryMonitor(ExtensionModule):
    def __init__(self, interval: float = 5.0, warn_ratio: float = 0.8,
                 critical_ratio: float = 0.95, device="cuda"):
        self.interval = interval
        self.warn_ratio = warn_ratio
        self.critical_ratio = critical_ratio
        self.device = torch.device(device)
        self.device_reads = 0
        self.last_device_stats: Optional[Dict] = None
        self._critical = False
        self._stop = threading.Event()
        self.worker = lifecycle.Worker("memory_monitor", self._run, self.device)
        lifecycle.register(self)

    def ok(self) -> bool:
        self.worker.check()
        return not self._critical

    def stop(self, timeout: float = 5.0) -> None:
        """End the thread (the shutdown path: its failure is not raised)."""
        self._stop.set()
        self.worker.thread.join(timeout)

    def detach(self) -> None:
        self.stop()

    def at_exit(self, dump_path: str) -> None:
        self.stop()
        self.worker.check()

    def poll(self) -> None:
        """One reading of host and device memory."""
        info = read_meminfo()
        total = info.get("MemTotal", 0)
        avail = info.get("MemAvailable", 0)
        if total:
            used_ratio = 1.0 - avail / total
            if used_ratio > self.critical_ratio:
                logger.error("host memory critical: %.0f%% used", used_ratio * 100)
                self._critical = True
            elif used_ratio > self.warn_ratio:
                logger.warning("host memory high: %.0f%% used (rss %.1f GB)",
                               used_ratio * 100, read_self_rss() / 1e9)
        dstats = device_memory_stats(self.device)
        if dstats is not None:
            self.device_reads += 1
            self.last_device_stats = dstats
            used = dstats["bytes_limit"] - dstats["bytes_free"]
            if dstats["bytes_limit"] and used / dstats["bytes_limit"] > self.warn_ratio:
                logger.warning("device memory high: %.0f%% of %.1f GB",
                               100 * used / dstats["bytes_limit"], dstats["bytes_limit"] / 1e9)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.poll()


@register_module("extension", "memory_monitor")
def create_memory_monitor(*args, device="cuda", **kwargs):
    return MemoryMonitor(device=device)
