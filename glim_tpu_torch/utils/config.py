"""JSON config system with typed accessors.

Equivalent surface to the reference's ``glim::Config``/``glim::GlobalConfig``
(reference: include/glim/util/config.hpp:14,112 and src/glim/util/config.cpp):

- JSON-with-comments parsing (``//`` and ``/* */``).
- ``param(module, name, default)`` typed lookup with warn-on-default,
  ``param_required`` abort-on-missing, nested lookup via ``/``-separated paths.
- SE3 poses encoded as TUM 7-vectors ``[x y z qx qy qz qw]``
  (reference: util/config_impl.hpp:65-87); decoded to 4x4 numpy matrices.
- ``override_param`` for volatile in-memory overrides, ``save`` to write back.
- ``GlobalConfig``: process-wide singleton mapping logical config names
  (``config_odometry`` ...) to files, with ``dump()`` snapshotting every live
  config into a result directory (reference: util/config.cpp:65-103).
"""

from __future__ import annotations

import copy
import io
import json
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from glim_tpu_torch.utils.logging import create_module_logger

logger = create_module_logger("config")


def strip_json_comments(text: str) -> str:
    """Remove // and /* */ comments from JSON text (string-literal aware)."""
    out = io.StringIO()
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            out.write(c)
            if c == "\\" and i + 1 < n:
                out.write(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
            continue
        if c == '"':
            in_str = True
            out.write(c)
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            i += 2
            while i + 1 < n and not (text[i] == "*" and text[i + 1] == "/"):
                i += 1
            i += 2
            continue
        out.write(c)
        i += 1
    return out.getvalue()


def tum_to_se3(vec) -> np.ndarray:
    """TUM 7-vector [x y z qx qy qz qw] -> 4x4 SE3 matrix (f64)."""
    v = np.asarray(vec, dtype=np.float64)
    if v.shape != (7,):
        raise ValueError(f"expected 7-vector TUM pose, got shape {v.shape}")
    t = v[:3]
    qx, qy, qz, qw = v[3:]
    norm = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    if norm < 1e-12:
        raise ValueError("zero-norm quaternion in config")
    qx, qy, qz, qw = qx / norm, qy / norm, qz / norm, qw / norm
    R = np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def se3_to_tum(T: np.ndarray) -> List[float]:
    """4x4 SE3 matrix -> TUM 7-vector [x y z qx qy qz qw]."""
    T = np.asarray(T, dtype=np.float64)
    R = T[:3, :3]
    t = T[:3, 3]
    # Shepperd's method for robust matrix->quaternion.
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return [float(t[0]), float(t[1]), float(t[2]), float(qx), float(qy), float(qz), float(qw)]


_MISSING = object()


class Config:
    """One JSON config file: typed lookup by (module, param-name)."""

    def __init__(self, source: Any = None):
        self._path: Optional[str] = None
        if source is None:
            self._data: Dict[str, Any] = {}
        elif isinstance(source, dict):
            self._data = copy.deepcopy(source)
        else:
            self._path = str(source)
            if not os.path.exists(self._path):
                logger.warning("config file %s not found; using empty config", self._path)
                self._data = {}
            else:
                with open(self._path, "r") as f:
                    self._data = json.loads(strip_json_comments(f.read()))

    @property
    def path(self) -> Optional[str]:
        return self._path

    @property
    def data(self) -> Dict[str, Any]:
        return self._data

    def _lookup(self, module: str, name: str):
        # Nested lookup: module and name may contain '/'-separated path segments
        # (reference: Config::param_nested, util/config.hpp:63).
        node: Any = self._data
        for seg in [s for s in module.split("/") if s]:
            if not isinstance(node, dict) or seg not in node:
                return _MISSING
            node = node[seg]
        for seg in [s for s in name.split("/") if s]:
            if not isinstance(node, dict) or seg not in node:
                return _MISSING
            node = node[seg]
        return node

    def param(self, module: str, name: str, default: Any = None, quiet: bool = True) -> Any:
        val = self._lookup(module, name)
        if val is _MISSING:
            if not quiet:
                logger.warning("param %s/%s not found; using default %r", module, name, default)
            return copy.deepcopy(default)
        if default is not None and isinstance(default, bool) != isinstance(val, bool) and isinstance(default, bool):
            return bool(val)
        if default is not None and isinstance(default, float) and isinstance(val, int):
            return float(val)
        return val

    def param_required(self, module: str, name: str) -> Any:
        val = self._lookup(module, name)
        if val is _MISSING:
            raise KeyError(f"required param {module}/{name} not found in {self._path}")
        return val

    def param_se3(self, module: str, name: str, default: Optional[np.ndarray] = None) -> np.ndarray:
        """Read an SE3 pose stored as a TUM 7-vector; returns 4x4 f64 matrix."""
        val = self._lookup(module, name)
        if val is _MISSING:
            if default is None:
                return np.eye(4)
            return np.array(default, dtype=np.float64)
        return tum_to_se3(val)

    def override_param(self, module: str, name: str, value: Any) -> None:
        if isinstance(value, np.ndarray) and value.shape == (4, 4):
            value = se3_to_tum(value)
        node = self._data.setdefault(module, {}) if module else self._data
        segs = [s for s in name.split("/") if s]
        for seg in segs[:-1]:
            node = node.setdefault(seg, {})
        node[segs[-1]] = value

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self._data, f, indent=2, default=_json_default)

    def dumps(self) -> str:
        return json.dumps(self._data, indent=2, default=_json_default)


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


class GlobalConfig(Config):
    """Process-wide config root (reference: util/config.cpp:65-103).

    Reads ``<config_path>/config.json``, whose ``global`` section maps logical
    names (``config_odometry`` etc.) to per-module files. ``get_config_path``
    resolves a logical name to an absolute file path; ``dump`` snapshots every
    config that has been loaded into a result directory.
    """

    _instance: Optional["GlobalConfig"] = None
    _lock = threading.Lock()

    def __init__(self, config_path: str):
        super().__init__(os.path.join(config_path, "config.json"))
        self.config_root = config_path
        self._loaded: Dict[str, Config] = {}
        self.override_param("global", "config_path", config_path)

    @classmethod
    def instance(cls, config_path: Optional[str] = None, override: bool = False) -> "GlobalConfig":
        with cls._lock:
            if cls._instance is None or (override and config_path is not None):
                if config_path is None:
                    raise RuntimeError("GlobalConfig not initialized; pass config_path")
                cls._instance = cls(config_path)
            return cls._instance

    @classmethod
    def current(cls) -> Optional["GlobalConfig"]:
        """The instance, or None when none was initialized."""
        with cls._lock:
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    def get_config_path(self, logical_name: str) -> str:
        fname = self.param("global", logical_name, logical_name + ".json")
        if os.path.isabs(fname):
            return fname
        return os.path.join(self.config_root, fname)

    def get_config(self, logical_name: str) -> Config:
        path = self.get_config_path(logical_name)
        if path not in self._loaded:
            self._loaded[path] = Config(path)
        return self._loaded[path]

    def dump(self, dst_dir: str) -> None:
        os.makedirs(dst_dir, exist_ok=True)
        self.save(os.path.join(dst_dir, "config.json"))
        glb = self._data.get("global", {})
        for key, fname in glb.items():
            if key == "config_path" or not key.startswith("config_") or not isinstance(fname, str) or not fname:
                continue
            cfg = self.get_config(key)
            cfg.save(os.path.join(dst_dir, os.path.basename(self.get_config_path(key))))


def create_default_config_dir(path: str) -> str:
    """Write the default config tree (mirrors reference config/*.json keys)."""
    from glim_tpu_torch.utils.default_config import DEFAULT_CONFIGS

    os.makedirs(path, exist_ok=True)
    for fname, data in DEFAULT_CONFIGS.items():
        with open(os.path.join(path, fname), "w") as f:
            json.dump(data, f, indent=2)
    return path
