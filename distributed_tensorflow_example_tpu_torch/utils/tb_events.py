"""TensorBoard event-file writer and reader, with no TensorFlow (an
adapted copy of ``distributed_tensorflow_example_tpu/utils/tb_events.py``,
which carries its CRC in the data package; here it is this module's).

Two stable wire formats:

- TFRecord framing: ``<len u64><masked crc32c(len) u32><payload>
  <masked crc32c(payload) u32>`` (little-endian);
- the ``Event``/``Summary`` protobuf messages, hand-encoded (wall_time=1,
  step=2, file_version=3, summary=5; Summary.Value tag=1,
  simple_value=2, histo=5).

The records are byte for byte the reference writer's for the same step,
tag, value(s) and ``wall_time``. :func:`read_records` walks a file
checking both CRCs of every record; :func:`read_scalars` decodes its
scalar summaries.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator

import numpy as np

# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli) and the TFRecord mask
# ---------------------------------------------------------------------------

_CRC_TABLE: list[int] | None = None


def _crc_table() -> list[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data`` (RFC 3720)."""
    table = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ table[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord CRC mask: rotr(crc, 15) + 0xa282ead8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding (wire types 0=varint, 1=fixed64, 2=bytes,
# 5=fixed32)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(step: int, tag: str, value: float,
                  wall_time: float) -> bytes:
    sval = _bytes(1, tag.encode()) + _float(2, float(value))
    summary = _bytes(1, sval)
    return _double(1, wall_time) + _int64(2, step) + _bytes(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _bytes(3, b"brain.Event:2")


# ---------------------------------------------------------------------------
# HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5 (doubles),
# bucket_limit=6 bucket=7 (packed doubles); bucket[i] counts the values
# in (bucket_limit[i-1], bucket_limit[i]]
# ---------------------------------------------------------------------------

_DBL_MAX = 1.7976931348623157e308


def _packed_doubles(field: int, values) -> bytes:
    payload = np.asarray(values, np.float64).tobytes()
    return _key(field, 2) + _varint(len(payload)) + payload


def _tf_bucket_limits(max_abs: float) -> list:
    """TF's default exponential buckets (1e-12 growing x1.1) up to the
    data's range, mirrored negative, with the DBL_MAX catch-all."""
    pos = []
    v = 1e-12
    while v < max_abs * 1.1 and len(pos) < 1000:
        pos.append(v)
        v *= 1.1
    if not pos:
        pos = [1e-12]
    return [-x for x in reversed(pos)] + pos + [_DBL_MAX]


def _histogram_proto(values) -> bytes:
    v = np.asarray(values, np.float64).reshape(-1)
    # the finite distribution: NaN/inf would overflow the bucket list
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros((1,), np.float64)
    limits = np.asarray(_tf_bucket_limits(float(np.max(np.abs(v)))))
    idx = np.clip(np.searchsorted(limits, v, side="left"), 0,
                  len(limits) - 1)
    counts = np.bincount(idx, minlength=len(limits)).astype(np.float64)
    nz = np.nonzero(counts)[0]
    lo, hi = int(nz[0]), int(nz[-1])        # trim empty head and tail
    return (_double(1, float(v.min())) + _double(2, float(v.max()))
            + _double(3, float(v.size)) + _double(4, float(v.sum()))
            + _double(5, float((v * v).sum()))
            + _packed_doubles(6, limits[lo:hi + 1])
            + _packed_doubles(7, counts[lo:hi + 1]))


def _histo_event(step: int, tag: str, values, wall_time: float) -> bytes:
    value = _bytes(1, tag.encode()) + _bytes(5, _histogram_proto(values))
    summary = _bytes(1, value)
    return _double(1, wall_time) + _int64(2, step) + _bytes(5, summary)


def frame(payload: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, payload, its masked CRC."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


class EventFileWriter:
    """Append summaries to an ``events.out.tfevents.*`` file.

    Usage::

        w = EventFileWriter(logdir)
        w.scalars(step, {"loss": 0.3, "accuracy": 0.9})
        w.close()
    """

    def __init__(self, logdir: str, *, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._record(_file_version_event(time.time()))
        self._f.flush()

    def _record(self, payload: bytes) -> None:
        self._f.write(frame(payload))

    def scalar(self, step: int, tag: str, value: float,
               wall_time: float | None = None) -> None:
        self._record(_scalar_event(step, tag, value,
                                   time.time() if wall_time is None
                                   else wall_time))

    def scalars(self, step: int, values: dict[str, float],
                wall_time: float | None = None) -> None:
        wt = time.time() if wall_time is None else wall_time
        for tag, v in values.items():
            self.scalar(step, tag, v, wt)
        self._f.flush()

    def histogram(self, step: int, tag: str, values,
                  wall_time: float | None = None) -> None:
        """``tf.summary.histogram`` parity: any array-like, bucketed
        TF-style."""
        self._record(_histo_event(step, tag, values,
                                  time.time() if wall_time is None
                                  else wall_time))
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def read_records(path: str) -> Iterator[bytes]:
    """Every record's payload, each length and payload checked against
    its masked CRC32C; ValueError on a torn or damaged record."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        if off + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at {off}")
        header = data[off:off + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[off + 8:off + 12])
        if hcrc != masked_crc32c(header):
            raise ValueError(f"{path}: length CRC mismatch at {off}")
        end = off + 12 + n
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated record at {off}")
        payload = data[off + 12:end]
        (pcrc,) = struct.unpack("<I", data[end:end + 4])
        if pcrc != masked_crc32c(payload):
            raise ValueError(f"{path}: payload CRC mismatch at {off}")
        yield payload
        off = end + 4


def _fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """(field, wire type, value) of a protobuf message: varints as ints,
    fixed64/fixed32 as their 8 or 4 bytes, length-delimited as bytes."""
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(buf, off)
        elif wire == 1:
            val, off = buf[off:off + 8], off + 8
        elif wire == 2:
            n, off = _read_varint(buf, off)
            val, off = buf[off:off + n], off + n
        elif wire == 5:
            val, off = buf[off:off + 4], off + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _read_varint(buf: bytes, off: int) -> tuple[int, int]:
    shift = out = 0
    while True:
        b = buf[off]
        off += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, off
        shift += 7


def read_scalars(path: str) -> list[tuple[int, str, float, float]]:
    """(step, tag, simple_value, wall_time) of every scalar summary in an
    event file, each record's CRCs checked."""
    out = []
    for payload in read_records(path):
        wall, step, summary = 0.0, 0, None
        for field, _, val in _fields(payload):
            if field == 1:
                (wall,) = struct.unpack("<d", val)
            elif field == 2:
                step = val
            elif field == 5:
                summary = val
        if summary is None:
            continue
        for field, _, value in _fields(summary):
            if field != 1:
                continue
            tag, simple = None, None
            for f2, _, v2 in _fields(value):
                if f2 == 1:
                    tag = v2.decode()
                elif f2 == 2:
                    (simple,) = struct.unpack("<f", v2)
            if tag is not None and simple is not None:
                out.append((step, tag, simple, wall))
    return out
