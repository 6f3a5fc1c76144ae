"""Minimal pure-Python rosbag v2.0 reader + grid_map_msgs/GridMap decoder.

The reference checkpoints its map state to rosbag files
(TraversabilityEstimation.cpp:125-152,318-329 via
GridMapRosConverter::loadFromBag/saveToBag). This module reads and writes
those bags without any ROS dependency (``struct``, ``bz2``, numpy), the
port's own copy of the JAX package's module: a bag written by either loads
in the other.

Only what such checkpoints need is implemented: bag format 2.0, chunk compressions
none/bz2, and deserialization of ``grid_map_msgs/GridMap``.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_CHUNK = 0x05
_OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields: Dict[bytes, bytes] = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        entry = buf[off : off + flen]
        off += flen
        key, _, value = entry.partition(b"=")
        fields[key] = value
    return fields


def _iter_records(buf: bytes, start: int = 0):
    off = start
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off : off + dlen]
        off += dlen
        yield header, data


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    raw: bytes
    conn_id: int
    time_ns: int = 0


def read_bag(path: str) -> List[BagMessage]:
    """Return all messages in the bag (decompressing chunks as needed)."""
    with open(path, "rb") as f:
        blob = f.read()
    magic = b"#ROSBAG V2.0\n"
    if not blob.startswith(magic):
        raise ValueError(f"{path}: not a rosbag v2.0 file")
    connections: Dict[int, Tuple[str, str]] = {}
    messages: List[Tuple[int, int, bytes]] = []

    def handle(header: Dict[bytes, bytes], data: bytes):
        op = header.get(b"op", b"\x00")[0]
        if op == _OP_CONNECTION:
            conn_id = struct.unpack("<I", header[b"conn"])[0]
            conn_fields = _parse_header(data)
            topic = header.get(b"topic", b"").decode()
            msg_type = conn_fields.get(b"type", b"").decode()
            connections[conn_id] = (topic, msg_type)
        elif op == _OP_MSG:
            conn_id = struct.unpack("<I", header[b"conn"])[0]
            t = 0
            if b"time" in header:
                secs, nsecs = struct.unpack("<II", header[b"time"])
                t = secs * 1_000_000_000 + nsecs
            messages.append((conn_id, t, data))
        elif op == _OP_CHUNK:
            compression = header.get(b"compression", b"none").decode()
            if compression == "none":
                inner = data
            elif compression == "bz2":
                inner = bz2.decompress(data)
            elif compression == "lz4":
                import lz4.frame  # pragma: no cover - not in goldens

                inner = lz4.frame.decompress(data)
            else:
                raise ValueError(f"unsupported chunk compression: {compression}")
            for h, d in _iter_records(inner):
                handle(h, d)

    for header, data in _iter_records(blob, len(magic)):
        handle(header, data)

    out = []
    for conn_id, t, raw in messages:
        topic, msg_type = connections.get(conn_id, ("", ""))
        out.append(BagMessage(topic=topic, msg_type=msg_type, raw=raw, conn_id=conn_id, time_ns=t))
    return out


# ---------------------------------------------------------------------------
# grid_map_msgs/GridMap deserialization
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u16(self) -> int:
        (v,) = struct.unpack_from("<H", self.buf, self.off)
        self.off += 2
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off : self.off + n].decode()
        self.off += n
        return s

    def f32_array(self, n: int) -> np.ndarray:
        a = np.frombuffer(self.buf, dtype="<f4", count=n, offset=self.off).copy()
        self.off += 4 * n
        return a


@dataclass
class GridMapMessage:
    frame_id: str
    resolution: float
    length: Tuple[float, float]
    position: Tuple[float, float, float]
    orientation: Tuple[float, float, float, float]
    layers: List[str]
    basic_layers: List[str]
    data: Dict[str, np.ndarray] = field(default_factory=dict)  # (rows, cols)
    outer_start_index: int = 0
    inner_start_index: int = 0

    @property
    def size(self) -> Tuple[int, int]:
        for arr in self.data.values():
            return arr.shape
        return (0, 0)


def decode_grid_map(raw: bytes) -> GridMapMessage:
    r = _Reader(raw)
    # GridMapInfo.header (std_msgs/Header)
    r.u32()  # seq
    r.u32()  # stamp secs
    r.u32()  # stamp nsecs
    frame_id = r.string()
    resolution = r.f64()
    length_x = r.f64()
    length_y = r.f64()
    px, py, pz = r.f64(), r.f64(), r.f64()
    ox, oy, oz, ow = r.f64(), r.f64(), r.f64(), r.f64()
    layers = [r.string() for _ in range(r.u32())]
    basic_layers = [r.string() for _ in range(r.u32())]
    n_arrays = r.u32()
    data: Dict[str, np.ndarray] = {}
    for li in range(n_arrays):
        dims = []
        for _ in range(r.u32()):
            label = r.string()
            size = r.u32()
            stride = r.u32()
            dims.append((label, size, stride))
        r.u32()  # data_offset
        values = r.f32_array(r.u32())
        # grid_map stores matrices with dim[0]=column_index (outer),
        # dim[1]=row_index (inner): data[col * rows + row].
        if len(dims) == 2:
            if dims[0][0].startswith("column"):
                cols, rows = dims[0][1], dims[1][1]
                mat = values.reshape(cols, rows).T
            else:
                rows, cols = dims[0][1], dims[1][1]
                mat = values.reshape(rows, cols)
        else:  # pragma: no cover - defensive
            mat = values.reshape(-1, 1)
        data[layers[li]] = np.ascontiguousarray(mat)
    outer_start = r.u16()
    inner_start = r.u16()
    if outer_start or inner_start:
        # Undo the circular-buffer start index (we keep dense storage).
        data = {
            k: np.roll(np.roll(v, -outer_start, axis=0), -inner_start, axis=1)
            for k, v in data.items()
        }
    return GridMapMessage(
        frame_id=frame_id,
        resolution=resolution,
        length=(length_x, length_y),
        position=(px, py, pz),
        orientation=(ox, oy, oz, ow),
        layers=layers,
        basic_layers=basic_layers,
        data=data,
        outer_start_index=outer_start,
        inner_start_index=inner_start,
    )


def load_grid_map_bag(path: str, topic: Optional[str] = None) -> GridMapMessage:
    """Load the first grid_map_msgs/GridMap message from a bag file."""
    for msg in read_bag(path):
        if msg.msg_type.endswith("GridMap") and (topic is None or msg.topic == topic):
            return decode_grid_map(msg.raw)
    raise ValueError(f"no GridMap message found in {path}")


# ---------------------------------------------------------------------------
# rosbag v2.0 WRITER + grid_map_msgs/GridMap encoder
# ---------------------------------------------------------------------------
# Parity with the reference's save_traversability_map_to_bag service
# (TraversabilityEstimation.cpp:318-329 via GridMapRosConverter::saveToBag):
# emits a standards-conformant bag (header + one uncompressed chunk + index
# data + chunk-info index) that both this module's reader and stock ROS
# tooling can load. Connection metadata (md5sum, message definition) matches
# grid_map_msgs/GridMap.

_OP_INDEX = 0x04
_OP_CHUNK_INFO = 0x06

_GRID_MAP_MD5 = "95681e052b1f73bf87b7eb984382b401"

_GRID_MAP_MSG_DEF = """\
# Grid map header
GridMapInfo info

# Grid map layer names.
string[] layers

# Grid map basic layer names (optional). The basic layers
# determine which layers from `layers` need to be valid
# in order for a cell of the grid map to be valid.
string[] basic_layers

# Grid map data.
std_msgs/Float32MultiArray[] data

# Row start index (default 0).
uint16 outer_start_index

# Column start index (default 0).
uint16 inner_start_index

================================================================================
MSG: grid_map_msgs/GridMapInfo
# Header (time and frame)
Header header

# Resolution of the grid [m/cell].
float64 resolution

# Length in x-direction [m].
float64 length_x

# Length in y-direction [m].
float64 length_y

# Pose of the grid map center in the frame defined in `header` [m].
geometry_msgs/Pose pose
================================================================================
MSG: std_msgs/Header
# Standard metadata for higher-level stamped data types.
# This is generally used to communicate timestamped data 
# in a particular coordinate frame.
# 
# sequence ID: consecutively increasing ID 
uint32 seq
#Two-integer timestamp that is expressed as:
# * stamp.sec: seconds (stamp_secs) since epoch (in Python the variable is called 'secs')
# * stamp.nsec: nanoseconds since stamp_secs (in Python the variable is called 'nsecs')
# time-handling sugar is provided by the client library
time stamp
#Frame this data is associated with
# 0: no frame
# 1: global frame
string frame_id

================================================================================
MSG: geometry_msgs/Pose
# A representation of pose in free space, composed of position and orientation. 
Point position
Quaternion orientation

================================================================================
MSG: geometry_msgs/Point
# This contains the position of a point in free space
float64 x
float64 y
float64 z

================================================================================
MSG: geometry_msgs/Quaternion
# This represents an orientation in free space in quaternion form.

float64 x
float64 y
float64 z
float64 w

================================================================================
MSG: std_msgs/Float32MultiArray
# Please look at the MultiArrayLayout message definition for
# documentation on all multiarrays.

MultiArrayLayout  layout        # specification of data layout
float32[]         data          # array of data


================================================================================
MSG: std_msgs/MultiArrayLayout
# The multiarray declares a generic multi-dimensional array of a
# particular data type.  Dimensions are ordered from outer most
# to inner most.

MultiArrayDimension[] dim # Array of dimension properties
uint32 data_offset        # padding elements at front of data

# Accessors should ALWAYS be written in terms of dimension stride
# and specified outer-most dimension first.
# 
# multiarray(i,j,k) = data[data_offset + dim_stride[1]*i + dim_stride[2]*j + k]
#
# A standard, 3-channel 640x480 image with interleaved color channels
# would be specified as:
#
# dim[0].label  = "height"
# dim[0].size   = 480
# dim[0].stride = 3*640*480 = 921600  (note dim[0] stride is just size of image)
# dim[1].label  = "width"
# dim[1].size   = 640
# dim[1].stride = 3*640 = 1920
# dim[2].label  = "channel"
# dim[2].size   = 3
# dim[2].stride = 3
#
# multiarray(i,j,k) refers to the ith row, jth column, and kth channel.

================================================================================
MSG: std_msgs/MultiArrayDimension
string label   # label of given dimension
uint32 size    # size of given dimension (in type units)
uint32 stride  # stride of given dimension
"""


def _header_bytes(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        entry = k + b"=" + v
        out += struct.pack("<I", len(entry)) + entry
    return out


def _record(fields: Dict[bytes, bytes], data: bytes) -> bytes:
    h = _header_bytes(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def u16(self, v: int):
        self.buf += struct.pack("<H", v)

    def u32(self, v: int):
        self.buf += struct.pack("<I", v)

    def f64(self, v: float):
        self.buf += struct.pack("<d", v)

    def string(self, s: str):
        b = s.encode()
        self.u32(len(b))
        self.buf += b

    def f32_array(self, a: np.ndarray):
        self.buf += np.ascontiguousarray(a, dtype="<f4").tobytes()


def encode_grid_map(msg: GridMapMessage, stamp_ns: int = 0) -> bytes:
    """Serialize a GridMapMessage to the grid_map_msgs/GridMap wire format
    (the exact inverse of decode_grid_map; column-major Float32MultiArrays
    with grid_map's column_index/row_index dim labels)."""
    w = _Writer()
    # GridMapInfo.header
    w.u32(0)  # seq
    w.u32(stamp_ns // 1_000_000_000)
    w.u32(stamp_ns % 1_000_000_000)
    w.string(msg.frame_id)
    w.f64(msg.resolution)
    w.f64(msg.length[0])
    w.f64(msg.length[1])
    for v in msg.position:
        w.f64(v)
    for v in msg.orientation:
        w.f64(v)
    layers = msg.layers or list(msg.data)
    w.u32(len(layers))
    for name in layers:
        w.string(name)
    w.u32(len(msg.basic_layers))
    for name in msg.basic_layers:
        w.string(name)
    w.u32(len(layers))
    for name in layers:
        mat = np.asarray(msg.data[name], dtype=np.float32)
        rows, cols = mat.shape
        # grid_map stores Eigen matrices column-major:
        # dim[0]=column_index (outer), dim[1]=row_index (inner)
        w.u32(2)
        w.string("column_index")
        w.u32(cols)
        w.u32(rows * cols)
        w.string("row_index")
        w.u32(rows)
        w.u32(rows)
        w.u32(0)  # data_offset
        w.u32(rows * cols)
        w.f32_array(mat.T)  # column-major = transpose then C-order
    w.u16(msg.outer_start_index)
    w.u16(msg.inner_start_index)
    return bytes(w.buf)


def write_grid_map_bag(
    path: str,
    msg: GridMapMessage,
    topic: str = "grid_map",
    stamp_ns: int = 1_000_000_000,
) -> None:
    """Write one GridMap message into a rosbag v2.0 file.

    Layout: magic, 4096-byte bag-header record, one uncompressed chunk
    (connection record + message record), per-connection index-data record,
    then the index section (connection record + chunk-info record) that
    index_pos points at — the structure `rosbag record` produces.
    """
    secs, nsecs = stamp_ns // 1_000_000_000, stamp_ns % 1_000_000_000
    time_field = struct.pack("<II", secs, nsecs)

    conn_fields = {
        b"topic": topic.encode(),
        b"type": b"grid_map_msgs/GridMap",
        b"md5sum": _GRID_MAP_MD5.encode(),
        b"message_definition": _GRID_MAP_MSG_DEF.encode(),
        b"latching": b"1",
    }
    conn_record = _record(
        {b"op": bytes([_OP_CONNECTION]), b"conn": struct.pack("<I", 0),
         b"topic": topic.encode()},
        _header_bytes(conn_fields),
    )
    payload = encode_grid_map(msg, stamp_ns)
    msg_record = _record(
        {b"op": bytes([_OP_MSG]), b"conn": struct.pack("<I", 0),
         b"time": time_field},
        payload,
    )
    chunk_data = conn_record + msg_record

    magic = b"#ROSBAG V2.0\n"
    out = bytearray(magic)

    # bag header record, padded to 4096 bytes total with spaces (bag spec)
    def bag_header(index_pos: int) -> bytes:
        fields = {
            b"op": bytes([_OP_BAGHDR]),
            b"index_pos": struct.pack("<Q", index_pos),
            b"conn_count": struct.pack("<I", 1),
            b"chunk_count": struct.pack("<I", 1),
        }
        h = _header_bytes(fields)
        pad = 4096 - 4 - len(h) - 4
        return struct.pack("<I", len(h)) + h + struct.pack("<I", pad) + b" " * pad

    out += bag_header(0)  # placeholder; rewritten once index_pos is known
    chunk_pos = len(out)
    out += _record(
        {b"op": bytes([_OP_CHUNK]), b"compression": b"none",
         b"size": struct.pack("<I", len(chunk_data))},
        chunk_data,
    )
    # index data: offset of the MESSAGE record within the uncompressed chunk
    out += _record(
        {b"op": bytes([_OP_INDEX]), b"ver": struct.pack("<I", 1),
         b"conn": struct.pack("<I", 0), b"count": struct.pack("<I", 1)},
        time_field + struct.pack("<I", len(conn_record)),
    )
    index_pos = len(out)
    out += conn_record
    out += _record(
        {b"op": bytes([_OP_CHUNK_INFO]), b"ver": struct.pack("<I", 1),
         b"chunk_pos": struct.pack("<Q", chunk_pos),
         b"start_time": time_field, b"end_time": time_field,
         b"count": struct.pack("<I", 1)},
        struct.pack("<II", 0, 1),
    )
    out[len(magic) : len(magic) + 4096] = bag_header(index_pos)
    with open(path, "wb") as f:
        f.write(bytes(out))


def save_grid_map_bag(
    path: str,
    layers: Dict[str, np.ndarray],
    resolution: float,
    position=(0.0, 0.0),
    frame_id: str = "map",
    basic_layers=("traversability",),
    topic: str = "grid_map",
) -> None:
    """Convenience wrapper: layer dict -> GridMapMessage -> bag file."""
    first = next(iter(layers.values()))
    rows, cols = np.asarray(first).shape
    msg = GridMapMessage(
        frame_id=frame_id,
        resolution=resolution,
        length=(rows * resolution, cols * resolution),
        position=(float(position[0]), float(position[1]), 0.0),
        orientation=(0.0, 0.0, 0.0, 1.0),
        layers=list(layers),
        basic_layers=[b for b in basic_layers if b in layers],
        data={k: np.asarray(v, np.float32) for k, v in layers.items()},
    )
    write_grid_map_bag(path, msg, topic=topic)
