"""Per-module loggers with a shared ring-buffer sink.

Equivalent surface to the reference's ``create_module_logger`` /
``get_ringbuffer_sink`` (reference: src/glim/util/logging.cpp:23-66): named
loggers ("odom", "sub", "global", ...) that write to stdout, a bounded shared
ring buffer (consumed by viewer/metrics modules), and optional rotating file
sinks configured by config_logging.json.
"""

from __future__ import annotations

import collections
import logging
import logging.handlers
import os
import sys
import tempfile
import threading
from typing import Deque, List, Optional

_lock = threading.Lock()
_ring_lock = threading.Lock()
_ring: Deque[str] = collections.deque(maxlen=1024)
_file_handlers: dict = {}
_log_dir: Optional[str] = None
_save_logs = False
_rotate_logs = True
_max_file_size_kb = 8192
_max_files = 10

# The module loggers that never write a file: the pipeline front end's, which
# the JAX package makes before its pipeline applies config_logging. Every other
# logger made while save_logs is set writes log_dir/glim_<name>.log.
STDOUT_ONLY_LOGGERS = frozenset(
    {"config", "ext", "glim", "odom", "preprocess", "prof", "registry", "time"})


class _RingBufferHandler(logging.Handler):
    def emit(self, record: logging.LogRecord) -> None:
        with _ring_lock:
            _ring.append(self.format(record))


def get_ringbuffer_lines(n: int = 128) -> List[str]:
    """Last n formatted log lines across all module loggers."""
    with _ring_lock:
        items = list(_ring)
    return items[-n:]


def configure_logging(log_dir: Optional[str] = None, save_logs: bool = False,
                      rotate_logs: bool = True, max_file_size_kb: int = 8192,
                      max_files: int = 10, level: int = logging.INFO) -> None:
    """Apply config_logging.json settings (reference: config/config_logging.json)
    to the loggers made from now on. A ``log_dir`` of "/tmp", the default, is
    read as the directory ``tempfile.gettempdir()`` names (``TMPDIR`` where it
    is set), so that runs with temporary directories of their own keep their
    log files apart."""
    global _log_dir, _save_logs, _rotate_logs, _max_file_size_kb, _max_files
    with _lock:
        _log_dir = tempfile.gettempdir() if log_dir == "/tmp" else log_dir
        _save_logs = save_logs
        _rotate_logs = rotate_logs
        _max_file_size_kb = max_file_size_kb
        _max_files = max_files
    logging.getLogger("glim_tpu_torch").setLevel(level)


def create_module_logger(name: str) -> logging.Logger:
    """Named module logger: stdout + shared ring buffer, plus a file sink if
    save_logs is set when it is first made and ``name`` is not one of
    STDOUT_ONLY_LOGGERS."""
    logger = logging.getLogger(f"glim_tpu_torch.{name}")
    with _lock:
        if getattr(logger, "_glim_configured", False):
            return logger
        logger._glim_configured = True  # type: ignore[attr-defined]
        logger.setLevel(logging.INFO)
        fmt = logging.Formatter(f"[%(asctime)s] [{name}] [%(levelname)s] %(message)s", "%H:%M:%S")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        rb = _RingBufferHandler()
        rb.setFormatter(fmt)
        logger.addHandler(rb)
        if _save_logs and _log_dir and name not in STDOUT_ONLY_LOGGERS:
            os.makedirs(_log_dir, exist_ok=True)
            path = os.path.join(_log_dir, f"glim_{name}.log")
            if _rotate_logs:
                fh: logging.Handler = logging.handlers.RotatingFileHandler(
                    path, maxBytes=_max_file_size_kb * 1024, backupCount=_max_files)
            else:
                fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        logger.propagate = False
    return logger
