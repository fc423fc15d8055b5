"""Boost binary-archive codec for the reference's graph.bin / values.bin.

Numpy-only copy of ``glim_tpu/io/boost_archive.py``: the port writes and
reads the same bytes.

The reference serializes its factor graph and value estimates with
`gtsam::serializeToBinaryFile` (boost::archive::binary_oarchive) when a map
is saved (reference: src/glim/mapping/global_mapping.cpp:572-574), and
its "serializable subset" fallback drops any factor whose serialization
throws (reference: src/glim/util/serialization.cpp:10-36).  The factor
types that survive into graph.bin are exactly the ones GUID-exported in
reference src/glim/util/export_factors.cpp:17-60 MINUS gtsam::ImuFactor
(its PreintegrationParams member is polymorphic but never exported, so the
params pointer save throws `unregistered_class` and the whole factor falls
back to the matching-cost manifest path):

    gtsam::BetweenFactor<gtsam::Pose3 | gtsam::Vector3 | imuBias::ConstantBias>
    gtsam::PriorFactor<gtsam::Pose3 | gtsam::Vector3 | imuBias::ConstantBias>
    gtsam::PoseTranslationPrior<gtsam::Pose3>
    gtsam_points::LinearDampingFactor
    gtsam_points::RotateVector3Factor

values.bin is a `gtsam::Values` (ptr_map of Key -> GenericValue<Pose3 |
Vector3 | imuBias::ConstantBias>).

This module implements the boost binary-archive PROTOCOL (native
little-endian, 64-bit std::size_t — the layout every x86-64/aarch64 build
of boost >= 1.44 writes) from scratch:

  archive header:  std::string signature ("serialization::archive" as
                   8-byte length + bytes) + library version (uint16)
  class info:      written ONCE per class, at its first appearance:
                   [tracking: bool u8][class version: u32]
                   (class_id_optional is a no-op in binary archives)
  pointer saves:   [class_id: i16]; if the id is new: GUID class name
                   (8-byte length + bytes, polymorphic classes only)
                   followed by the class-info preamble.  Tracked objects
                   then carry [object_id: u32]; a repeated object writes
                   only [class_id: i16][object_id: u32] of the earlier
                   save (gtsam SHARES noise models across factors, so this
                   path is live in real files).  NULL pointers write
                   class_id -1.
  collections:     std::vector<T>/ptr_map write no class info
                   (object_serializable trait); vector<arithmetic> is
                   [count: u64][raw data], vector<class> is
                   [count: u64][item_version: u32][elements...]
  Eigen matrices:  fixed-size -> raw doubles; dynamic vectors ->
                   [size: u64][raw]; dynamic matrices ->
                   [rows: u64][cols: u64][raw column-major]
                   (gtsam/base/{Vector,Matrix}.h split serializers)

New-vs-reference ids are distinguished the same way boost does it: a
class_id equal to the number of classes registered so far is a new class,
smaller is a back-reference; likewise for object ids.  By-value class saves
register a class id WITHOUT writing it (the binary archive skips
class_id_optional), so the reader must mirror the registration order of the
writer's type traversal — the schema table below encodes that traversal.

Scope and assumptions (documented, not silently guessed):
  * Rot3: WRITE side emits rotation-matrix mode (9 doubles
    rot11..rot33 — the reference links a default GTSAM_USE_QUATERNIONS=OFF
    build). READ side self-discriminates: quaternion-mode archives
    (4 doubles w,x,y,z, optionally behind the Quaternion sub-object's
    class-info preamble) are detected from the first Rot3's payload shape
    and converted — see BoostBinaryReader._read_rot3. Support matrix:
    read {matrix, quaternion} x write {matrix}.
  * noiseModel::Diagonal serializes sigmas_/invsigmas_/precisions_;
    Isotropic adds sigma_/invsigma_; Gaussian carries
    boost::optional<Matrix> sqrt_information_ (bool flag + matrix).
  * boost >= 1.56 layouts for boost::optional (flag + value, no
    item_version) — the Ubuntu boosts the reference supports (>= 1.65).
  * library versions >= 8 (boost >= 1.44) accepted on read.

Every reader has a matching writer so the port's dumps can carry real
graph.bin/values.bin for the reference to open, and so round-trip tests
exercise both directions independently.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"serialization::archive"
LIBRARY_VERSION = 17          # boost 1.71+ writes 17; any >= 8 is accepted
NULL_POINTER_CLASS_ID = -1


# ---------------------------------------------------------------------------
# primitive layer
# ---------------------------------------------------------------------------

class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _unpack(self, fmt: str):
        v = struct.unpack_from(fmt, self.data, self.off)[0]
        self.off += struct.calcsize(fmt)
        return v

    def u8(self) -> int: return self._unpack("<B")
    def u16(self) -> int: return self._unpack("<H")
    def i16(self) -> int: return self._unpack("<h")
    def u32(self) -> int: return self._unpack("<I")
    def i32(self) -> int: return self._unpack("<i")
    def u64(self) -> int: return self._unpack("<Q")
    def f64(self) -> float: return self._unpack("<d")

    def raw(self, n: int) -> bytes:
        b = self.data[self.off:self.off + n]
        if len(b) != n:
            raise ValueError("boost archive truncated")
        self.off += n
        return b

    def f64s(self, n: int) -> np.ndarray:
        return np.frombuffer(self.raw(8 * n), "<f8").copy()

    def string(self) -> str:
        n = self.u64()
        if n > len(self.data) - self.off:
            raise ValueError("boost archive: bad string length")
        return self.raw(n).decode("latin-1")


class Writer:
    def __init__(self):
        self.chunks: List[bytes] = []

    def _pack(self, fmt: str, v):
        self.chunks.append(struct.pack(fmt, v))

    def u8(self, v): self._pack("<B", v)
    def u16(self, v): self._pack("<H", v)
    def i16(self, v): self._pack("<h", v)
    def u32(self, v): self._pack("<I", v)
    def i32(self, v): self._pack("<i", v)
    def u64(self, v): self._pack("<Q", v)
    def f64(self, v): self._pack("<d", float(v))

    def f64s(self, arr):
        self.chunks.append(np.ascontiguousarray(arr, "<f8").tobytes())

    def string(self, s: str):
        b = s.encode("latin-1")
        self.u64(len(b))
        self.chunks.append(b)

    def bytes_(self) -> bytes:
        return b"".join(self.chunks)


# ---------------------------------------------------------------------------
# type schema
#
# Each archive-visible class is one entry:
#   guid      exported class name (polymorphic pointer types only)
#   tracked   boost tracking trait resolved for this program's save graph
#             (track_selectively + saved-through-pointer => True)
#   version   class serialization version written in the class-info preamble
#   fields    ordered (name, type) pairs; `type` is a primitive tag, another
#             class name, or a parameterized tag tuple
#
# Primitive tags: u64 f64 bool size_t enum4 vecXd matXd keyvector
#                 raw3 raw9 (fixed Eigen), sptr:<class>, opt_matXd
# Class refs:     base:<class> (base_object — class info once, never
#                 tracked), val:<class> (member by value)
# ---------------------------------------------------------------------------

SCHEMA: Dict[str, dict] = {
    # ---- geometry ----------------------------------------------------- #
    # field name "." = the python value IS the field (no wrapping dict)
    "Vector3": dict(tracked=False, version=0, fields=[(".", "raw3")]),
    "Rot3": dict(tracked=False, version=0, fields=[("mat", "rot3")]),
    # Synthetic entry for the Eigen::Quaterniond sub-object a
    # GTSAM_USE_QUATERNIONS build serializes inside Rot3 (read-side only;
    # registered to keep the archive's class-id sequence aligned).
    "Quaternion": dict(tracked=False, version=0, fields=[(".", "raw3")]),
    "Pose3": dict(tracked=False, version=0,
                  fields=[("R", "val:Rot3"), ("t", "val:Vector3")]),
    "ConstantBias": dict(tracked=False, version=0,
                         fields=[("biasAcc", "val:Vector3"),
                                 ("biasGyro", "val:Vector3")]),

    # ---- noise models (gtsam/linear/NoiseModel.h) --------------------- #
    "noiseModel::Base": dict(tracked=False, version=0,
                             fields=[("dim", "size_t")]),
    "noiseModel::Gaussian": dict(
        guid="gtsam::noiseModel::Gaussian", tracked=True, version=0,
        fields=[("base", "base:noiseModel::Base"),
                ("sqrt_information", "opt_matXd")]),
    "noiseModel::Diagonal": dict(
        guid="gtsam::noiseModel::Diagonal", tracked=True, version=0,
        fields=[("base", "base:noiseModel::Gaussian"),
                ("sigmas", "vecXd"), ("invsigmas", "vecXd"),
                ("precisions", "vecXd")]),
    "noiseModel::Constrained": dict(
        guid="gtsam_noiseModel::Constrained", tracked=True, version=0,
        fields=[("base", "base:noiseModel::Diagonal"), ("mu", "vecXd")]),
    "noiseModel::Isotropic": dict(
        guid="gtsam::noiseModel::Isotropic", tracked=True, version=0,
        fields=[("base", "base:noiseModel::Diagonal"),
                ("sigma", "f64"), ("invsigma", "f64")]),
    "noiseModel::Unit": dict(
        guid="gtsam_noiseModel::Unit", tracked=True, version=0,
        fields=[("base", "base:noiseModel::Isotropic")]),
    "noiseModel::Robust": dict(
        guid="gtsam::noiseModel::Robust", tracked=True, version=0,
        fields=[("base", "base:noiseModel::Base"),
                ("robust", "sptr:mEstimator::Base"),
                ("noise", "sptr:noiseModel::Base")]),

    # ---- m-estimators -------------------------------------------------- #
    "mEstimator::Base": dict(tracked=False, version=0,
                             fields=[("reweight", "enum4")]),
    "mEstimator::Null": dict(
        guid="gtsam::noiseModel::mEstimator::Null", tracked=True, version=0,
        fields=[("base", "base:mEstimator::Base")]),
    "mEstimator::Huber": dict(
        guid="gtsam::noiseModel::mEstimator::Huber", tracked=True, version=0,
        fields=[("base", "base:mEstimator::Base"), ("k", "f64")]),
    "mEstimator::Fair": dict(
        guid="gtsam::noiseModel::mEstimator::Fair", tracked=True, version=0,
        fields=[("base", "base:mEstimator::Base"), ("c", "f64")]),
    "mEstimator::Tukey": dict(
        guid="gtsam::noiseModel::mEstimator::Tukey", tracked=True, version=0,
        fields=[("base", "base:mEstimator::Base"),
                ("c", "f64"), ("csquared", "f64")]),

    # ---- factor bases --------------------------------------------------- #
    "Factor": dict(tracked=False, version=0, fields=[("keys", "keyvector")]),
    "NonlinearFactor": dict(tracked=False, version=0,
                            fields=[("base", "base:Factor")]),
    "NoiseModelFactor": dict(
        tracked=False, version=0,
        fields=[("base", "base:NonlinearFactor"),
                ("noiseModel", "sptr:noiseModel::Base")]),

    # ---- concrete factors (export_factors.cpp:48-60) ------------------- #
    "BetweenFactor<Pose3>": dict(
        guid="gtsam::BetweenFactor<gtsam::Pose3>", tracked=True, version=0,
        fields=[("base", "base:NoiseModelFactor"),
                ("measured", "val:Pose3")]),
    "BetweenFactor<Vector3>": dict(
        guid="gtsam::BetweenFactor<gtsam::Vector3>", tracked=True, version=0,
        fields=[("base", "base:NoiseModelFactor"),
                ("measured", "val:Vector3")]),
    "BetweenFactor<ConstantBias>": dict(
        guid="gtsam::BetweenFactor<gtsam::imuBias::ConstantBias>",
        tracked=True, version=0,
        fields=[("base", "base:NoiseModelFactor"),
                ("measured", "val:ConstantBias")]),
    "PriorFactor<Pose3>": dict(
        guid="gtsam::PriorFactor<gtsam::Pose3>", tracked=True, version=0,
        fields=[("base", "base:NoiseModelFactor"), ("prior", "val:Pose3")]),
    "PriorFactor<Vector3>": dict(
        guid="gtsam::PriorFactor<gtsam::Vector3>", tracked=True, version=0,
        fields=[("base", "base:NoiseModelFactor"), ("prior", "val:Vector3")]),
    "PriorFactor<ConstantBias>": dict(
        guid="gtsam::PriorFactor<gtsam::imuBias::ConstantBias>",
        tracked=True, version=0,
        fields=[("base", "base:NoiseModelFactor"),
                ("prior", "val:ConstantBias")]),
    "PoseTranslationPrior<Pose3>": dict(
        guid="gtsam::PoseTranslationPrior<gtsam::Pose3>", tracked=True,
        version=0,
        fields=[("base", "base:NoiseModelFactor"),
                ("measured", "val:Vector3")]),
    "LinearDampingFactor": dict(
        guid="gtsam_points::LinearDampingFactor", tracked=True, version=0,
        fields=[("base", "base:NonlinearFactor"), ("mu", "vecXd")]),
    "RotateVector3Factor": dict(
        guid="gtsam_points::RotateVector3Factor", tracked=True, version=0,
        fields=[("base", "base:NoiseModelFactor"), ("v", "val:Vector3")]),

    # ---- values --------------------------------------------------------- #
    "Value": dict(tracked=False, version=0, fields=[]),
    "GenericValue<Pose3>": dict(
        guid="gtsam::GenericValue<gtsam::Pose3>", tracked=True, version=0,
        fields=[("base", "base:Value"), ("value", "val:Pose3")]),
    "GenericValue<Vector3>": dict(
        guid="gtsam::GenericValue<gtsam::Vector3>", tracked=True, version=0,
        fields=[("base", "base:Value"), ("value", "val:Vector3")]),
    "GenericValue<Rot3>": dict(
        guid="gtsam::GenericValue<gtsam::Rot3>", tracked=True, version=0,
        fields=[("base", "base:Value"), ("value", "val:Rot3")]),
    "GenericValue<ConstantBias>": dict(
        guid="gtsam::GenericValue<gtsam::imuBias::ConstantBias>",
        tracked=True, version=0,
        fields=[("base", "base:Value"), ("value", "val:ConstantBias")]),

    # shared_ptr<T> wrappers: class info once (version 1, never tracked),
    # then the raw-pointer protocol (boost/serialization/shared_ptr.hpp).
    "sptr<noiseModel::Base>": dict(tracked=False, version=1, fields=None),
    "sptr<mEstimator::Base>": dict(tracked=False, version=1, fields=None),
    "sptr<NonlinearFactor>": dict(tracked=False, version=1, fields=None),

    # top-level containers
    "NonlinearFactorGraph": dict(
        tracked=False, version=0,
        fields=[("base", "base:FactorGraph")]),
    "FactorGraph": dict(tracked=False, version=0,
                        fields=[("factors", "factorvector")]),
    "Values": dict(tracked=False, version=0, fields=[("values", "ptrmap")]),
    # boost::ptr_map has its own class info (serialize_ptr_map.hpp free
    # serialize function, no version override).
    "ptr_map": dict(tracked=False, version=0, fields=None),
}

GUID_TO_TYPE = {info["guid"]: name for name, info in SCHEMA.items()
                if info.get("guid")}


class _Context:
    """Per-archive protocol state shared by reader and writer."""

    def __init__(self):
        self.class_ids: Dict[str, int] = {}   # type name -> class id
        self.class_order: List[str] = []      # id -> type name
        self.info_written: set = set()        # types whose preamble was done
        self.objects: List[Any] = []          # tracked objects in save order
        self.object_ids: Dict[int, int] = {}  # id(obj) -> object id (writer)

    def register_class(self, name: str) -> int:
        if name not in self.class_ids:
            self.class_ids[name] = len(self.class_order)
            self.class_order.append(name)
        return self.class_ids[name]


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class BoostBinaryWriter:
    def __init__(self):
        self.w = Writer()
        self.ctx = _Context()
        self.w.string(SIGNATURE.decode())
        self.w.u16(LIBRARY_VERSION)

    # -- protocol pieces -------------------------------------------------- #

    def _class_info(self, tname: str):
        """Emit the class-info preamble once (tracking byte + version)."""
        self.ctx.register_class(tname)
        if tname in self.ctx.info_written:
            return
        self.ctx.info_written.add(tname)
        info = SCHEMA[tname]
        self.w.u8(1 if info["tracked"] else 0)
        self.w.u32(info["version"])

    def save_value(self, tname: str, value):
        """By-value save: class info once (class_id_optional is skipped in
        binary archives), object id if tracked, then members."""
        self._class_info(tname)
        if SCHEMA[tname]["tracked"]:
            self.w.u32(len(self.ctx.objects))
            self.ctx.objects.append(value)
        self._fields(tname, value)

    def save_pointer(self, tname: Optional[str], value):
        """Polymorphic pointer save: class id (+ GUID & class info when
        first seen), object id / object reference, then members."""
        if value is None:
            self.w.i16(NULL_POINTER_CLASS_ID)
            return
        first = tname not in self.ctx.class_ids
        cid = self.ctx.register_class(tname)
        self.w.i16(cid)
        if first:
            guid = SCHEMA[tname].get("guid")
            if guid is None:
                raise ValueError(f"pointer save of unexported class {tname}")
            self.w.string(guid)
            self.ctx.info_written.add(tname)
            self.w.u8(1 if SCHEMA[tname]["tracked"] else 0)
            self.w.u32(SCHEMA[tname]["version"])
        if SCHEMA[tname]["tracked"]:
            oid = self.ctx.object_ids.get(id(value))
            if oid is not None:
                self.w.u32(oid)          # object_reference: already saved
                return
            oid = len(self.ctx.objects)
            self.ctx.object_ids[id(value)] = oid
            self.ctx.objects.append(value)
            self.w.u32(oid)
        self._fields(tname, value)

    def _sptr(self, base: str, value):
        self._class_info(f"sptr<{base}>")
        self.save_pointer(value.get("_type") if value else None, value)

    # -- field encoding ---------------------------------------------------- #

    def _fields(self, tname: str, value):
        for fname, ftype in SCHEMA[tname]["fields"]:
            if fname == ".":
                v = value
            else:
                v = value.get(fname) if isinstance(value, dict) else None
            self._field(ftype, v)

    def _field(self, ftype: str, v):
        w = self.w
        if ftype == "u64":
            w.u64(int(v))
        elif ftype == "f64":
            w.f64(v)
        elif ftype == "size_t":
            w.u64(int(v))
        elif ftype == "enum4":
            w.i32(int(v))
        elif ftype == "raw3":
            w.f64s(np.asarray(v, np.float64).reshape(3))
        elif ftype in ("raw9", "rot3"):
            # row-major rot11..rot33 (gtsam Rot3 serializes element-wise;
            # we WRITE matrix mode only — the reference links a default
            # GTSAM_USE_QUATERNIONS=OFF build)
            w.f64s(np.asarray(v, np.float64).reshape(3, 3).ravel())
        elif ftype == "vecXd":
            arr = np.asarray(v, np.float64).ravel()
            w.u64(arr.size)
            w.f64s(arr)
        elif ftype == "matXd":
            arr = np.asarray(v, np.float64)
            w.u64(arr.shape[0])
            w.u64(arr.shape[1])
            w.f64s(arr.T.ravel())        # column-major
        elif ftype == "opt_matXd":
            w.u8(0 if v is None else 1)
            if v is not None:
                self._field("matXd", v)
        elif ftype == "keyvector":
            keys = np.asarray(v, np.uint64).ravel()
            w.u64(keys.size)
            self.w.chunks.append(keys.astype("<u8").tobytes())
        elif ftype.startswith("base:"):
            base = ftype[5:]
            self._class_info(base)
            self._fields(base, v if isinstance(v, dict) else {})
        elif ftype.startswith("val:"):
            self.save_value(ftype[4:], v)
        elif ftype.startswith("sptr:"):
            self._sptr(ftype[5:], v)
        elif ftype == "factorvector":
            w.u64(len(v))
            w.u32(SCHEMA["sptr<NonlinearFactor>"]["version"])  # item_version
            for f in v:
                self._sptr("NonlinearFactor", f)
        elif ftype == "ptrmap":
            self._class_info("ptr_map")
            w.u64(len(v))
            for key in v:                  # ptr_map iterates key-ascending
                w.u64(int(key))
                self.save_pointer(v[key]["_type"], v[key])
        else:
            raise ValueError(f"unknown field type {ftype}")

    def bytes_(self) -> bytes:
        return self.w.bytes_()


def _is_rotation(m: np.ndarray, tol: float = 1e-6) -> bool:
    with np.errstate(over="ignore", invalid="ignore"):
        return bool(np.all(np.isfinite(m))
                    and np.abs(m @ m.T - np.eye(3)).max() < tol
                    and abs(np.linalg.det(m) - 1.0) < tol)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class BoostBinaryReader:
    def __init__(self, data: bytes):
        self.r = Reader(data)
        self.ctx = _Context()
        # Rot3 serialization mode, discriminated from the first Rot3's
        # payload: "matrix" (9 doubles, default gtsam) or "quaternion"
        # (GTSAM_USE_QUATERNIONS=ON: 4 doubles w,x,y,z, optionally behind
        # the Quaternion sub-object's class-info preamble).
        self._rot3_mode = None
        self._quat_preamble = False
        sig = self.r.string()
        if sig != SIGNATURE.decode():
            raise ValueError(f"not a boost binary archive (signature {sig!r})")
        self.library_version = self.r.u16()
        if self.library_version < 8:
            raise ValueError(
                f"boost archive library version {self.library_version} "
                "predates the stable binary layout (boost < 1.44)")

    def _class_info(self, tname: str):
        self.ctx.register_class(tname)
        if tname in self.ctx.info_written:
            return
        self.ctx.info_written.add(tname)
        tracked = self.r.u8()
        version = self.r.u32()
        info = SCHEMA[tname]
        if bool(tracked) != info["tracked"] or version != info["version"]:
            raise ValueError(
                f"boost archive: class {tname} preamble mismatch "
                f"(tracked={tracked} version={version}, expected "
                f"{int(info['tracked'])}/{info['version']}) — "
                "layout drift, refusing to guess")

    def load_value(self, tname: str):
        self._class_info(tname)
        if SCHEMA[tname]["tracked"]:
            oid = self.r.u32()
            if oid < len(self.ctx.objects):
                return self.ctx.objects[oid]
            slot = len(self.ctx.objects)
            self.ctx.objects.append(None)
            v = self._fields(tname)
            self.ctx.objects[slot] = v
            return v
        return self._fields(tname)

    def load_pointer(self):
        cid = self.r.i16()
        if cid == NULL_POINTER_CLASS_ID:
            return None
        if cid == len(self.ctx.class_order):           # first appearance
            guid = self.r.string()
            tname = GUID_TO_TYPE.get(guid)
            if tname is None:
                raise ValueError(f"boost archive: unknown class GUID {guid!r}")
            self.ctx.register_class(tname)
            self.ctx.info_written.add(tname)
            tracked = self.r.u8()
            version = self.r.u32()
            info = SCHEMA[tname]
            if bool(tracked) != info["tracked"] or version != info["version"]:
                raise ValueError(
                    f"boost archive: {guid} preamble mismatch "
                    f"(tracked={tracked} version={version})")
        elif cid < len(self.ctx.class_order):
            tname = self.ctx.class_order[cid]
        else:
            raise ValueError(f"boost archive: class id {cid} out of range")
        if SCHEMA[tname]["tracked"]:
            oid = self.r.u32()
            if oid < len(self.ctx.objects):
                return self.ctx.objects[oid]           # object_reference
            if oid != len(self.ctx.objects):
                raise ValueError(f"boost archive: object id {oid} out of order")
            slot = len(self.ctx.objects)
            self.ctx.objects.append(None)
            v = self._fields(tname)
            v["_type"] = tname
            self.ctx.objects[slot] = v
            return v
        v = self._fields(tname)
        v["_type"] = tname
        return v

    def _read_rot3(self) -> np.ndarray:
        """Self-discriminating Rot3 read: default gtsam serializes 9 row-
        major doubles (rot11..rot33); a GTSAM_USE_QUATERNIONS=ON build
        serializes the Eigen quaternion (w,x,y,z per the quaternion
        serializer in gtsam/base/Vector.h), preceded ONCE by that
        sub-object's boost class-info preamble. The mode is decided on the
        FIRST Rot3 — a valid rotation matrix read as 9 doubles is
        orthonormal, while a quaternion payload misread as 9 doubles
        essentially never is — and then pinned for the whole archive
        (mixed modes are impossible in one gtsam build)."""
        r = self.r
        if self._rot3_mode is None:
            off0 = r.off
            try:
                m = r.f64s(9).reshape(3, 3)
            except ValueError:
                m = None
            if m is not None and _is_rotation(m):
                self._rot3_mode = "matrix"
                return m
            self._rot3_mode = "quaternion"
            for preamble in (True, False):
                r.off = off0
                try:
                    if preamble:
                        trk = r.u8()
                        ver = r.u32()
                        if trk not in (0, 1) or ver > 255:
                            continue
                    q = r.f64s(4)
                except ValueError:
                    continue
                if np.all(np.isfinite(q)) \
                        and abs(float(q @ q) - 1.0) < 1e-6:
                    self._quat_preamble = preamble
                    if preamble:
                        # Mirror the writer's class registration so later
                        # class ids stay aligned.
                        self.ctx.register_class("Quaternion")
                        self.ctx.info_written.add("Quaternion")
                    return _quat_to_mat(q)
            raise ValueError(
                "boost archive: Rot3 payload is neither an orthonormal "
                "3x3 (matrix-mode gtsam) nor a unit quaternion "
                "(GTSAM_USE_QUATERNIONS build) - refusing to guess")
        if self._rot3_mode == "matrix":
            m = r.f64s(9).reshape(3, 3)
            if not _is_rotation(m, tol=1e-3):
                raise ValueError("boost archive: non-orthonormal Rot3")
            return m
        q = r.f64s(4)
        if not np.all(np.isfinite(q)) or abs(float(q @ q) - 1.0) > 1e-3:
            raise ValueError("boost archive: non-unit quaternion in Rot3")
        return _quat_to_mat(q)

    def _sptr(self, base: str):
        self._class_info(f"sptr<{base}>")
        return self.load_pointer()

    def _fields(self, tname: str):
        fields = SCHEMA[tname]["fields"]
        if len(fields) == 1 and fields[0][0] == ".":
            return self._field(fields[0][1])
        out: Dict[str, Any] = {}
        for fname, ftype in fields:
            out[fname] = self._field(ftype)
        return out

    def _field(self, ftype: str):
        r = self.r
        if ftype == "u64" or ftype == "size_t":
            return r.u64()
        if ftype == "f64":
            return r.f64()
        if ftype == "enum4":
            return r.i32()
        if ftype == "raw3":
            return r.f64s(3)
        if ftype == "raw9":
            return r.f64s(9).reshape(3, 3)
        if ftype == "rot3":
            return self._read_rot3()
        if ftype == "vecXd":
            return r.f64s(r.u64())
        if ftype == "matXd":
            rows = r.u64()
            cols = r.u64()
            return r.f64s(rows * cols).reshape(cols, rows).T
        if ftype == "opt_matXd":
            return self._field("matXd") if r.u8() else None
        if ftype == "keyvector":
            n = r.u64()
            return np.frombuffer(r.raw(8 * n), "<u8").copy()
        if ftype.startswith("base:"):
            base = ftype[5:]
            self._class_info(base)
            return self._fields(base)
        if ftype.startswith("val:"):
            return self.load_value(ftype[4:])
        if ftype.startswith("sptr:"):
            return self._sptr(ftype[5:])
        if ftype == "factorvector":
            n = r.u64()
            item_version = r.u32()
            if item_version != SCHEMA["sptr<NonlinearFactor>"]["version"]:
                raise ValueError(
                    f"boost archive: factor item_version {item_version}")
            return [self._sptr("NonlinearFactor") for _ in range(n)]
        if ftype == "ptrmap":
            self._class_info("ptr_map")
            n = r.u64()
            out = {}
            for _ in range(n):
                key = r.u64()
                out[key] = self.load_pointer()
            return out
        raise ValueError(f"unknown field type {ftype}")


# ---------------------------------------------------------------------------
# high-level graph/values API
# ---------------------------------------------------------------------------

def symbol(chr_: str, index: int) -> int:
    """gtsam::Symbol key encoding (char in the top byte)."""
    return (ord(chr_) << 56) | index


def symbol_split(key: int) -> Tuple[str, int]:
    c = (key >> 56) & 0xFF
    return (chr(c) if 0x20 <= c < 0x7F else "?", key & (2**56 - 1))


def read_graph(path_or_bytes) -> List[dict]:
    """Parse a graph.bin: list of factor dicts
    {_type, keys (uint64 array), noiseModel dict or None, measured/prior/...}.
    """
    data = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
            else open(path_or_bytes, "rb").read())
    rd = BoostBinaryReader(bytes(data))
    graph = rd.load_value("NonlinearFactorGraph")
    return graph["base"]["factors"]


def read_values(path_or_bytes) -> Dict[int, dict]:
    """Parse a values.bin: {key: {_type, value...}}."""
    data = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
            else open(path_or_bytes, "rb").read())
    rd = BoostBinaryReader(bytes(data))
    vals = rd.load_value("Values")
    return vals["values"]


def write_graph(factors: List[dict]) -> bytes:
    wr = BoostBinaryWriter()
    wr.save_value("NonlinearFactorGraph",
                  {"base": {"factors": factors}})
    return wr.bytes_()


def write_values(values: Dict[int, dict]) -> bytes:
    wr = BoostBinaryWriter()
    wr.save_value("Values", {"values": dict(sorted(values.items()))})
    return wr.bytes_()


# -- helpers to build/interpret the parsed structures ----------------------- #

def noise_information(model: Optional[dict]) -> Tuple[np.ndarray, bool]:
    """Information matrix (dim x dim) + robust flag from a parsed noise
    model (mirrors gtsam::noiseModel semantics: Gaussian stores upper-
    triangular sqrt information R with info = R^T R; Diagonal stores
    sigmas; Isotropic one sigma; Unit identity; Robust wraps another)."""
    if model is None:
        return np.eye(6), False
    t = model["_type"]
    if t == "noiseModel::Robust":
        info, _ = noise_information(model["noise"])
        return info, True
    if t == "noiseModel::Unit":
        dim = model["base"]["base"]["base"]["base"]["dim"]
        return np.eye(int(dim)), False
    if t == "noiseModel::Isotropic":
        dim = model["base"]["base"]["base"]["dim"]
        s = model["sigma"]
        return np.eye(int(dim)) / (s * s), False
    if t in ("noiseModel::Diagonal", "noiseModel::Constrained"):
        sig = np.asarray(model["sigmas"] if t == "noiseModel::Diagonal"
                         else model["base"]["sigmas"], np.float64)
        with np.errstate(divide="ignore"):
            prec = np.where(sig > 0, 1.0 / np.square(sig), 1e12)
        return np.diag(prec), False
    if t == "noiseModel::Gaussian":
        R = model["sqrt_information"]
        if R is None:
            dim = model["base"]["dim"]
            return np.eye(int(dim)), False
        return R.T @ R, False
    raise ValueError(f"unknown noise model {t}")


def make_isotropic_precision(dim: int, precision: float) -> dict:
    """noiseModel::Isotropic::Precision(dim, p) as a parsed-form dict."""
    sigma = 1.0 / np.sqrt(precision)
    sig = np.full(dim, sigma)
    return {"_type": "noiseModel::Isotropic",
            "base": {"base": {"base": {"dim": dim},
                              "sqrt_information": None},
                     "sigmas": sig, "invsigmas": 1.0 / sig,
                     "precisions": 1.0 / np.square(sig)},
            "sigma": sigma, "invsigma": 1.0 / sigma}


def make_gaussian_information(info: np.ndarray) -> dict:
    """noiseModel::Gaussian::Information(H) (upper-triangular Cholesky)."""
    info = np.asarray(info, np.float64)
    # gtsam computes R with info = R^T R (RtR upper triangular).
    L = np.linalg.cholesky(info)
    return {"_type": "noiseModel::Gaussian",
            "base": {"dim": info.shape[0]},
            "sqrt_information": L.T}


def pose3_from_matrix(T: np.ndarray) -> dict:
    T = np.asarray(T, np.float64)
    return {"R": {"mat": T[:3, :3]}, "t": T[:3, 3]}


def pose3_to_matrix(p: dict) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = np.asarray(p["R"]["mat"], np.float64).reshape(3, 3)
    T[:3, 3] = np.asarray(p["t"], np.float64).reshape(3)
    return T


def make_between_pose3(key1: int, key2: int, T: np.ndarray,
                       noise: dict) -> dict:
    return {"_type": "BetweenFactor<Pose3>",
            "base": {"base": {"base": {"keys": np.array([key1, key2],
                                                        np.uint64)}},
                     "noiseModel": noise},
            "measured": pose3_from_matrix(T)}


def make_prior_pose3(key: int, T: np.ndarray, noise: dict) -> dict:
    return {"_type": "PriorFactor<Pose3>",
            "base": {"base": {"base": {"keys": np.array([key], np.uint64)}},
                     "noiseModel": noise},
            "prior": pose3_from_matrix(T)}


def make_generic_pose3(T: np.ndarray) -> dict:
    return {"_type": "GenericValue<Pose3>", "base": {},
            "value": pose3_from_matrix(T)}


def make_generic_vector3(v) -> dict:
    return {"_type": "GenericValue<Vector3>", "base": {},
            "value": np.asarray(v, np.float64).reshape(3)}


def make_generic_bias(acc, gyro) -> dict:
    return {"_type": "GenericValue<ConstantBias>", "base": {},
            "value": {"biasAcc": np.asarray(acc, np.float64).reshape(3),
                      "biasGyro": np.asarray(gyro, np.float64).reshape(3)}}
