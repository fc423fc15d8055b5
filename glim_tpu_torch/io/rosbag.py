"""Pure-Python ROS bag ingestion: ROS1 ``.bag``, rosbag2 (sqlite3), MCAP
(host copy of ``glim_tpu/io/rosbag.py``).

The reference consumes live ROS topics or plays rosbags through the
glim_rosbag executable (reference docs/quickstart.md:40-79); the port does
not depend on ROS, so this module reads the three standard bag storage
formats directly:

  * ROS1 ``*.bag`` (format 2.0): record stream with connection / chunk /
    message-data records; uncompressed and bz2 chunks are handled, lz4
    only if the codec module happens to be importable. Payloads use ROS1
    serialization (packed little-endian, no alignment).
  * rosbag2 sqlite3 (``*.db3`` + metadata.yaml): topics/messages tables,
    message payloads are CDR-encapsulated.
  * MCAP (``*.mcap``): schema/channel/message/chunk records; uncompressed
    and zlib chunks are handled, zstd/lz4 only if the codec module happens
    to be importable.

A minimal decoder (XCDR1 for ROS2, packed unaligned for ROS1) extracts
exactly the two message types the pipeline needs — ``sensor_msgs/msg/PointCloud2`` and
``sensor_msgs/msg/Imu`` — and hands PointCloud2 to the existing duck-typed
converter (``ros/cloud_converter.extract_raw_points``, the
util/ros_cloud_converter.hpp equivalent). A point payload stays one
``bytes`` object that the converter reads through numpy views.

No network, no ROS install, stdlib only.
"""

from __future__ import annotations

import os
import sqlite3
import struct
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np


# ------------------------------------------------------------------- CDR

class CdrReader:
    """Minimal XCDR1 reader. Alignment is relative to the start of the
    serialized payload (after the 4-byte RTPS encapsulation header).

    With ``ros1=True`` the same reader parses ROS1 serialization instead:
    no encapsulation header, packed little-endian, no alignment."""

    def __init__(self, buf: bytes, ros1: bool = False):
        self.ros1 = ros1
        if ros1:
            self.little = True
            self.buf = memoryview(buf)
        else:
            if len(buf) < 4:
                raise ValueError("CDR payload too short")
            # Encapsulation: {0x00, 0x01}=BE/LE CDR, {0x02,0x03}=PL_CDR.
            self.little = buf[1] in (0x01, 0x03)
            self.buf = memoryview(buf)[4:]
        self.pos = 0
        self._end = "<" if self.little else ">"

    def _align(self, n: int) -> None:
        if self.ros1:
            return
        r = self.pos % n
        if r:
            self.pos += n - r

    def _prim(self, fmt: str, size: int):
        self._align(size)
        v = struct.unpack_from(self._end + fmt, self.buf, self.pos)[0]
        self.pos += size
        return v

    def uint8(self):
        return self._prim("B", 1)

    def int8(self):
        return self._prim("b", 1)

    def uint16(self):
        return self._prim("H", 2)

    def uint32(self):
        return self._prim("I", 4)

    def int32(self):
        return self._prim("i", 4)

    def uint64(self):
        return self._prim("Q", 8)

    def float32(self):
        return self._prim("f", 4)

    def float64(self):
        return self._prim("d", 8)

    def boolean(self):
        return bool(self.uint8())

    def string(self) -> str:
        n = self.uint32()
        s = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return s.split(b"\0", 1)[0].decode("utf-8", "replace")

    def bytes_seq(self) -> bytes:
        n = self.uint32()
        b = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return b

    def float64_array(self, n: int) -> np.ndarray:
        self._align(8)
        out = np.frombuffer(self.buf, dtype=("<f8" if self.little else ">f8"),
                            count=n, offset=self.pos)
        self.pos += 8 * n
        return np.asarray(out, np.float64)


@dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int


@dataclass
class PointCloud2Msg:
    """Duck-typed sensor_msgs/PointCloud2 (what extract_raw_points expects)."""

    header: object = None
    height: int = 0
    width: int = 0
    fields: List[PointField] = field(default_factory=list)
    is_bigendian: bool = False
    point_step: int = 0
    row_step: int = 0
    data: bytes = b""
    is_dense: bool = True


@dataclass
class _Stamp:
    sec: int
    nanosec: int


@dataclass
class _Header:
    stamp: _Stamp
    frame_id: str


def _read_header(r: CdrReader) -> _Header:
    if r.ros1:
        r.uint32()                   # std_msgs/Header.seq (ROS1 only)
    sec = r.int32()
    nanosec = r.uint32()
    frame_id = r.string()
    return _Header(_Stamp(sec, nanosec), frame_id)


def decode_pointcloud2(payload: bytes, fmt: str = "cdr") -> PointCloud2Msg:
    r = CdrReader(payload, ros1=(fmt == "ros1"))
    msg = PointCloud2Msg()
    msg.header = _read_header(r)
    msg.height = r.uint32()
    msg.width = r.uint32()
    n_fields = r.uint32()
    for _ in range(n_fields):
        name = r.string()
        offset = r.uint32()
        datatype = r.uint8()
        count = r.uint32()
        msg.fields.append(PointField(name, offset, datatype, count))
    msg.is_bigendian = r.boolean()
    msg.point_step = r.uint32()
    msg.row_step = r.uint32()
    msg.data = r.bytes_seq()
    try:
        msg.is_dense = r.boolean()
    except struct.error:         # a payload that ends before is_dense
        pass
    return msg


@dataclass
class ImuMsg:
    stamp: float
    orientation: np.ndarray          # (4,) xyzw
    angular_velocity: np.ndarray     # (3,)
    linear_acceleration: np.ndarray  # (3,)


@dataclass
class ImageMsg:
    """Duck-typed sensor_msgs/Image with an encoding-aware array decoder."""

    stamp: float
    frame_id: str
    height: int
    width: int
    encoding: str
    is_bigendian: bool
    step: int
    data: bytes

    def to_array(self) -> np.ndarray:
        """Decode to (H, W) or (H, W, C) numpy (uint8/uint16/float32)."""
        return image_msg_to_array(self)


# Channel count + dtype per common sensor_msgs image encoding.
_IMAGE_ENCODINGS = {
    "mono8": (1, np.uint8), "8uc1": (1, np.uint8),
    "mono16": (1, np.uint16), "16uc1": (1, np.uint16),
    "rgb8": (3, np.uint8), "bgr8": (3, np.uint8), "8uc3": (3, np.uint8),
    "rgba8": (4, np.uint8), "bgra8": (4, np.uint8), "8uc4": (4, np.uint8),
    "32fc1": (1, np.float32),
    "bayer_rggb8": (1, np.uint8), "bayer_bggr8": (1, np.uint8),
    "bayer_gbrg8": (1, np.uint8), "bayer_grbg8": (1, np.uint8),
}


def image_msg_to_array(msg) -> np.ndarray:
    """Encoding-aware sensor_msgs/Image -> numpy, for both the bag reader's
    ImageMsg and live rclpy messages (same attribute surface). Raises
    ValueError on unknown encodings rather than guessing."""
    enc = str(getattr(msg, "encoding", "mono8")).lower()
    if enc not in _IMAGE_ENCODINGS:
        raise ValueError(f"unsupported image encoding {enc!r}")
    ch, dtype = _IMAGE_ENCODINGS[enc]
    h, w = int(msg.height), int(msg.width)
    step = int(getattr(msg, "step", 0)) or w * ch * np.dtype(dtype).itemsize
    buf = np.frombuffer(bytes(msg.data), np.uint8).reshape(h, step)
    row_bytes = w * ch * np.dtype(dtype).itemsize
    img = buf[:, :row_bytes].reshape(h, -1).view(dtype)
    if getattr(msg, "is_bigendian", False) and np.dtype(dtype).itemsize > 1:
        img = img.byteswap()
    img = img.reshape(h, w, ch)
    return img[:, :, 0] if ch == 1 else img


def decode_image(payload: bytes, fmt: str = "cdr") -> ImageMsg:
    r = CdrReader(payload, ros1=(fmt == "ros1"))
    h = _read_header(r)
    height = r.uint32()
    width = r.uint32()
    encoding = r.string()
    is_bigendian = bool(r.uint8())
    step = r.uint32()
    data = r.bytes_seq()
    return ImageMsg(stamp=h.stamp.sec + h.stamp.nanosec * 1e-9,
                    frame_id=h.frame_id, height=height, width=width,
                    encoding=encoding, is_bigendian=is_bigendian,
                    step=step, data=data)


def decode_imu(payload: bytes, fmt: str = "cdr") -> ImuMsg:
    r = CdrReader(payload, ros1=(fmt == "ros1"))
    h = _read_header(r)
    quat = r.float64_array(4)
    _ = r.float64_array(9)           # orientation covariance
    gyro = r.float64_array(3)
    _ = r.float64_array(9)
    acc = r.float64_array(3)
    _ = r.float64_array(9)
    return ImuMsg(stamp=h.stamp.sec + h.stamp.nanosec * 1e-9,
                  orientation=quat, angular_velocity=gyro,
                  linear_acceleration=acc)


# -------------------------------------------------------- rosbag2 sqlite3

def read_rosbag2_db3(path: str) -> Iterator[Tuple[str, str, int, bytes]]:
    """Yield (topic, type, stamp_ns, payload) from a rosbag2 .db3 file (or a
    bag directory containing one)."""
    if os.path.isdir(path):
        db3s = sorted(f for f in os.listdir(path) if f.endswith(".db3"))
        if not db3s:
            raise FileNotFoundError(f"no .db3 file in {path}")
        for f in db3s:
            yield from read_rosbag2_db3(os.path.join(path, f))
        return
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        topics = {tid: (name, typ) for tid, name, typ in conn.execute(
            "SELECT id, name, type FROM topics")}
        cur = conn.execute(
            "SELECT topic_id, timestamp, data FROM messages ORDER BY timestamp")
        for topic_id, stamp, data in cur:
            name, typ = topics[topic_id]
            yield name, typ, stamp, data
    finally:
        conn.close()


# ------------------------------------------------------------- ROS1 .bag

ROSBAG1_MAGIC = b"#ROSBAG V2.0\n"

# Record op codes (rosbag format 2.0).
_R1_MSG_DATA = 0x02
_R1_CHUNK = 0x05
_R1_CONNECTION = 0x07


def _ros1_fields(buf: memoryview) -> dict:
    """Parse a ROS1 record header: sequence of <u32 len><name>=<value>."""
    fields = {}
    pos = 0
    n = len(buf)
    while pos + 4 <= n:
        (flen,) = struct.unpack_from("<I", buf, pos)
        item = bytes(buf[pos + 4:pos + 4 + flen])
        name, _, value = item.partition(b"=")
        fields[name.decode("ascii", "replace")] = value
        pos += 4 + flen
    return fields


def _ros1_records(buf: memoryview) -> Iterator[Tuple[dict, memoryview]]:
    """Yield (header_fields, data) records from a ROS1 record stream."""
    pos = 0
    n = len(buf)
    while pos + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, pos)
        header = _ros1_fields(buf[pos + 4:pos + 4 + hlen])
        pos += 4 + hlen
        if pos + 4 > n:
            break
        (dlen,) = struct.unpack_from("<I", buf, pos)
        yield header, buf[pos + 4:pos + 4 + dlen]
        pos += 4 + dlen


def _ros1_decompress(comp: str, data: memoryview) -> memoryview:
    if comp in ("", "none"):
        return data
    if comp == "bz2":
        import bz2
        return memoryview(bz2.decompress(bytes(data)))
    if comp == "lz4":
        try:
            import lz4.frame
            return memoryview(lz4.frame.decompress(bytes(data)))
        except ImportError:
            raise RuntimeError(
                "ROS1 chunk uses lz4 compression and no lz4 module is "
                "available; re-record with --bz2 or uncompressed")
    raise RuntimeError(f"unknown ROS1 chunk compression {comp!r}")


def read_rosbag1(path: str) -> Iterator[Tuple[str, str, int, bytes]]:
    """Yield (topic, type, stamp_ns, payload) from a ROS1 .bag (v2.0).

    The record stream is walked sequentially (no index needed): connection
    records inside chunks precede the message-data records that use them,
    so one pass suffices. Payloads use ROS1 serialization (``fmt='ros1'``
    for the decoders). Replaces the reference's rosbag::Bag playback in
    glim_rosbag (reference docs/quickstart.md:40-79)."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(ROSBAG1_MAGIC):
        raise ValueError(f"{path}: not a ROS1 v2.0 bag")
    buf = memoryview(raw)[len(ROSBAG1_MAGIC):]

    conns = {}      # conn id -> (topic, type)

    def handle(header: dict, data: memoryview):
        op = header.get("op", b"\x00")[0]
        if op == _R1_CONNECTION:
            (cid,) = struct.unpack("<I", header["conn"])
            # The connection *data* is itself a field sequence carrying the
            # full connection header (topic, type, md5sum, definition).
            info = _ros1_fields(data)
            topic = info.get("topic", header.get("topic", b"?")).decode(
                "utf-8", "replace")
            typ = info.get("type", b"?").decode("utf-8", "replace")
            conns[cid] = (topic, typ)
        elif op == _R1_MSG_DATA:
            (cid,) = struct.unpack("<I", header["conn"])
            sec, nsec = struct.unpack("<II", header["time"])
            topic, typ = conns.get(cid, ("?", "?"))
            return topic, typ, sec * 1_000_000_000 + nsec, bytes(data)
        return None

    for header, data in _ros1_records(buf):
        op = header.get("op", b"\x00")[0]
        if op == _R1_CHUNK:
            comp = header.get("compression", b"none").decode("ascii")
            inner = _ros1_decompress(comp, data)
            for h2, d2 in _ros1_records(inner):
                out = handle(h2, d2)
                if out:
                    yield out
        else:
            out = handle(header, data)
            if out:
                yield out


# ------------------------------------------------------------------ MCAP

_MCAP_MAGIC = b"\x89MCAP0\r\n"


def _mcap_records(buf: memoryview) -> Iterator[Tuple[int, memoryview]]:
    pos = 0
    n = len(buf)
    while pos + 9 <= n:
        op = buf[pos]
        (length,) = struct.unpack_from("<Q", buf, pos + 1)
        body = buf[pos + 9:pos + 9 + length]
        yield op, body
        pos += 9 + length


def _mcap_str(buf: memoryview, pos: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, pos)
    return bytes(buf[pos + 4:pos + 4 + n]).decode("utf-8", "replace"), pos + 4 + n


def read_mcap(path: str) -> Iterator[Tuple[str, str, int, bytes]]:
    """Yield (topic, type, stamp_ns, payload) from an MCAP file."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(_MCAP_MAGIC):
        raise ValueError(f"{path}: not an MCAP file")
    buf = memoryview(raw)[len(_MCAP_MAGIC):]

    schemas = {}       # schema_id -> type name
    channels = {}      # channel_id -> (topic, type)

    def handle(op: int, body: memoryview):
        if op == 0x03:          # Schema
            (sid,) = struct.unpack_from("<H", body, 0)
            name, _ = _mcap_str(body, 2)
            schemas[sid] = name
        elif op == 0x04:        # Channel
            (cid,) = struct.unpack_from("<H", body, 0)
            (sid,) = struct.unpack_from("<H", body, 2)
            topic, _ = _mcap_str(body, 4)
            channels[cid] = (topic, schemas.get(sid, ""))
        elif op == 0x05:        # Message
            (cid,) = struct.unpack_from("<H", body, 0)
            (log_time,) = struct.unpack_from("<Q", body, 6)
            payload = bytes(body[2 + 4 + 8 + 8:])
            topic, typ = channels.get(cid, ("?", "?"))
            return (topic, typ, log_time, payload)
        return None

    for op, body in _mcap_records(buf):
        if op == 0x06:          # Chunk: nested records, maybe compressed
            # Chunk layout: start(8) end(8) uncomp_size(8) crc(4)
            # compression string, records_size(8), records.
            pos = 8 + 8 + 8 + 4
            comp, pos = _mcap_str(body, pos)
            (rec_size,) = struct.unpack_from("<Q", body, pos)
            pos += 8
            records = body[pos:pos + rec_size]
            if comp == "":
                inner = records
            elif comp == "zlib":
                import zlib
                inner = memoryview(zlib.decompress(bytes(records)))
            elif comp == "zstd":
                try:
                    import zstandard
                    inner = memoryview(zstandard.ZstdDecompressor()
                                       .decompress(bytes(records)))
                except ImportError:
                    raise RuntimeError(
                        "MCAP chunk uses zstd compression and no zstd module "
                        "is available; re-record with --compression none")
            elif comp == "lz4":
                try:
                    import lz4.frame
                    inner = memoryview(lz4.frame.decompress(bytes(records)))
                except ImportError:
                    raise RuntimeError(
                        "MCAP chunk uses lz4 compression and no lz4 module "
                        "is available; re-record with --compression none")
            else:
                raise RuntimeError(f"unknown MCAP compression {comp!r}")
            for op2, body2 in _mcap_records(inner):
                out = handle(op2, body2)
                if out:
                    yield out
        else:
            out = handle(op, body)
            if out:
                yield out
        if op == 0x02:          # Footer
            break


# --------------------------------------------------------------- frontend

def _is_rosbag1(path: str) -> bool:
    if path.endswith(".bag"):
        return True
    try:
        with open(path, "rb") as f:
            return f.read(len(ROSBAG1_MAGIC)) == ROSBAG1_MAGIC
    except OSError:
        return False


def read_bag(path: str) -> Iterator[Tuple[str, str, int, bytes, str]]:
    """Dispatch on bag flavor: ROS1 .bag / directory with .db3 / .db3 file /
    .mcap. Yields (topic, type, stamp_ns, payload, fmt) where fmt is the
    payload serialization ('ros1' or 'cdr')."""
    if os.path.isdir(path):
        entries = os.listdir(path)
        if any(e.endswith(".mcap") for e in entries):
            for e in sorted(entries):
                if e.endswith(".mcap"):
                    for rec in read_mcap(os.path.join(path, e)):
                        yield rec + ("cdr",)
            return
        if any(e.endswith(".bag") for e in entries) and \
                not any(e.endswith(".db3") for e in entries):
            for e in sorted(entries):
                if e.endswith(".bag"):
                    for rec in read_rosbag1(os.path.join(path, e)):
                        yield rec + ("ros1",)
            return
        for rec in read_rosbag2_db3(path):
            yield rec + ("cdr",)
    elif path.endswith(".mcap"):
        for rec in read_mcap(path):
            yield rec + ("cdr",)
    elif _is_rosbag1(path):
        for rec in read_rosbag1(path):
            yield rec + ("ros1",)
    else:
        for rec in read_rosbag2_db3(path):
            yield rec + ("cdr",)


def bag_topics(path: str) -> dict:
    """Map topic -> (type, count) without decoding payloads."""
    out = {}
    for topic, typ, _, _, _ in read_bag(path):
        t, c = out.get(topic, (typ, 0))
        out[topic] = (typ, c + 1)
    return out


def iter_sensor_messages(path: str, points_topic: Optional[str] = None,
                         imu_topic: Optional[str] = None,
                         image_topic: Optional[str] = None):
    """Yield ('points', RawPoints) / ('imu', ImuMsg) / ('image', ImageMsg)
    in bag time order.

    Topics are auto-discovered from message types when not given."""
    from glim_tpu_torch.ros.cloud_converter import extract_raw_points

    for topic, typ, stamp_ns, payload, fmt in read_bag(path):
        base = typ.replace("/msg/", "/")
        if base.endswith("sensor_msgs/PointCloud2") and \
                (points_topic is None or topic == points_topic):
            msg = decode_pointcloud2(payload, fmt)
            raw = extract_raw_points(msg)
            if raw is not None:
                yield "points", raw
        elif base.endswith("sensor_msgs/Imu") and \
                (imu_topic is None or topic == imu_topic):
            yield "imu", decode_imu(payload, fmt)
        elif base.endswith("sensor_msgs/Image") and \
                (image_topic is None or topic == image_topic):
            yield "image", decode_image(payload, fmt)
