"""TensorBoard scalar event files, written and read without TensorFlow or
tensorboard.

An event file `events.out.tfevents.<secs>.<host>` is a sequence of
TFRecords, each

    u64 length (little-endian) | u32 masked CRC32C of those 8 bytes
    | data | u32 masked CRC32C of the data

with masked(c) = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32 and CRC32C the
Castagnoli polynomial.  Each data is a serialized `tensorflow.Event`: the
first carries wall_time and file_version "brain.Event:2"; each later one
wall_time (field 1, double), step (field 2, varint) and a summary (field
5) of one Value per scalar: tag (field 1) and simple_value (field 2,
float).  The reader also takes tf.summary's form of a scalar, a 0-d float
TensorProto in Value field 8, so it reads the JAX package's files too.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Tuple

FILE_VERSION = "brain.Event:2"


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1            # int64 as protobuf encodes it
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int = 0, scalars: Dict[str, float] = None,
                 file_version: str = None) -> bytes:
    """A serialized Event: wall_time, step, and either file_version or a
    summary of `scalars` (tag -> simple_value, f32)."""
    out = _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _field(2, 0) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode())
                         + _field(2, 5) + struct.pack("<f", value))
            for tag, value in scalars.items())
        out += _bytes_field(5, summary)
    return out


def record(data: bytes) -> bytes:
    """One TFRecord around `data`."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc(length)) + data
            + struct.pack("<I", masked_crc(data)))


class EventWriter:
    """Appends scalar events to a new event file under `logdir`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}")
        self._fh = open(self.path, "ab")
        self._fh.write(record(encode_event(now, file_version=FILE_VERSION)))
        self._fh.flush()

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        """One event at `step` holding every (tag, value) of `values`."""
        if values:
            self._fh.write(record(encode_event(time.time(), step, values)))
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def records(path: str) -> Iterator[bytes]:
    """The data of each TFRecord of `path`, both CRCs checked."""
    with open(path, "rb") as f:
        blob = f.read()
    pos = 0
    while pos < len(blob):
        header = blob[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", blob[pos + 8:pos + 12])
        if crc != masked_crc(header):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        data = blob[pos + 12:pos + 12 + n]
        (crc,) = struct.unpack("<I", blob[pos + 12 + n:pos + 16 + n])
        if len(data) != n or crc != masked_crc(data):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        yield data
        pos += 16 + n


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def parse_message(buf: bytes) -> Dict[int, list]:
    """A protobuf message's fields: number -> [value, ...] in order (varints
    as ints, fixed64/fixed32 as their 8 or 4 raw bytes, others as bytes)."""
    fields: Dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        fields.setdefault(num, []).append(val)
    return fields


def _tensor_scalar(buf: bytes) -> float:
    """The value of a 0-d DT_FLOAT or DT_DOUBLE TensorProto."""
    t = parse_message(buf)
    dtype = t.get(1, [1])[0]
    fmt = "<d" if dtype == 2 else "<f"
    if 4 in t:                                  # tensor_content
        return struct.unpack_from(fmt, t[4][0])[0]
    vals = t.get(6 if dtype == 2 else 5, [])
    raw = vals[0] if vals else b""
    if len(raw) < struct.calcsize(fmt):
        raise ValueError("tensor holds no scalar")
    return struct.unpack_from(fmt, raw)[0]      # packed or single value


def read_scalars(path: str) -> List[Tuple[int, str, float]]:
    """(step, tag, value) of every scalar in an event file, in order; a
    simple_value or a tf.summary scalar tensor, each as a Python float."""
    out = []
    for data in records(path):
        event = parse_message(data)
        step = event.get(2, [0])[0]
        for summary in event.get(5, []):
            for value in parse_message(summary).get(1, []):
                v = parse_message(value)
                tag = v[1][0].decode()
                if 2 in v:
                    out.append((step, tag, struct.unpack("<f", v[2][0])[0]))
                elif 8 in v:
                    out.append((step, tag, _tensor_scalar(v[8][0])))
    return out


def read_dir(logdir: str) -> List[Tuple[int, str, float]]:
    """read_scalars over every event file under `logdir`, files by name."""
    paths = sorted(os.path.join(root, f) for root, _, files in os.walk(logdir)
                   for f in files if f.startswith("events.out.tfevents."))
    return [s for p in paths for s in read_scalars(p)]
