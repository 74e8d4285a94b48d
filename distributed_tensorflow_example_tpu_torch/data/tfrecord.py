"""TFRecord container and ``tf.train.Example`` codec (an adapted copy of
``distributed_tensorflow_example_tpu/data/tfrecord.py``; numpy only).

The source's input files were TFRecords of serialized
``tf.train.Example`` protos, and BERT-style pretraining data ships the
same way. Both layers are here without TensorFlow or protobuf:

- the record framing (u64le length | masked crc32c | data | masked
  crc32c), CRC-32C in C++ when the native library is available
  (``data/_native/dataloader.cpp`` ``dl_crc32c``, ``dl_tfrecord_index``)
  and a pure-Python table otherwise;
- a hand-written wire-format codec for the fixed ``Example`` schema
  (Features -> map<string, Feature> -> Bytes/Float/Int64List), which
  reads packed and unpacked repeated encodings alike.

The tests hold both against the reference's copy and, where TensorFlow
imports, against TensorFlow's own writer and parser.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Iterator

import numpy as np

from . import native

# ---------------------------------------------------------------------------
# CRC-32C + record masking
# ---------------------------------------------------------------------------

_CRC_TABLE: np.ndarray | None = None


def _crc_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = np.empty(256, np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table[i] = c
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c_py(data: bytes) -> int:
    table = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ int(table[(c ^ b) & 0xFF])
    return c ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli). C++ slicing-by-8 when available."""
    if native.available():
        return native.crc32c(data)
    return _crc32c_py(data)


def masked_crc32c(data: bytes) -> int:
    """The TFRecord CRC mask: rotr(crc, 15) + 0xa282ead8 (avoids CRCs of
    CRC-bearing data looking valid)."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------


class TFRecordWriter:
    """``tf.python_io.TFRecordWriter`` parity: append framed records.

    >>> with TFRecordWriter(path) as w:
    ...     w.write(example_bytes)
    """

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "TFRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def is_gzipped(path: str) -> bool:
    """True when the file starts with the gzip magic + deflate method
    byte (tfds/beam pipelines often ship GZIP-compressed TFRecord
    shards). Three bytes, not two: a raw TFRecord whose first record
    length happens to start 0x1f 0x8b must not be misclassified."""
    with open(path, "rb") as f:
        return f.read(3) == b"\x1f\x8b\x08"


def tfrecord_iterator(path: str, *, verify: bool = True
                      ) -> Iterator[bytes]:
    """Stream records from a TFRecord file
    (``tf.compat.v1.io.tf_record_iterator`` parity). ``verify`` (the
    default, matching the reference RecordReader's always-on masked-CRC
    validation — a silently corrupt shard must fail, not feed garbage
    into training; CRC-32C runs in C++ when the native library is
    loaded) checks both per-record CRCs and raises ValueError on
    corruption; pass ``verify=False`` as an explicit opt-out.
    GZIP-compressed files (TFRecordOptions GZIP) are detected by magic
    and streamed through decompression (sequential access only — the
    random-access/offset paths reject gzip with a clear error)."""
    if is_gzipped(path):
        import gzip
        import zlib
        try:
            with gzip.open(path, "rb") as f:
                yield from _iter_stream(f, path, verify, size=None)
        except (EOFError, gzip.BadGzipFile, zlib.error) as e:
            # one CORRUPTION contract for both paths: ValueError.
            # (No broad OSError here: a transient I/O failure must not
            # be rebranded as data corruption)
            raise ValueError(f"{path}: corrupt gzip stream ({e})") from e
        return
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        yield from _iter_stream(f, path, verify, size=size)


#: single-record sanity bound for streams with unknowable total size
_SANITY_CAP = 1 << 40


def _iter_stream(f, path: str, verify: bool,
                 size: "int | None") -> Iterator[bytes]:
    """Record framing over a readable stream. ``size`` (plain files)
    enables the huge-length bound check BEFORE read() — a corrupt
    length must be a clean ValueError, not an attempted 2^64-byte
    allocation; compressed streams have no cheap size, so reads are
    capped at a sanity bound instead."""
    pos = 0
    while True:
        header = f.read(12)
        if not header:
            return
        if len(header) != 12:
            raise ValueError(f"{path}: truncated record header")
        pos += 12
        (length,) = struct.unpack("<Q", header[:8])
        if size is not None:
            remaining = size - pos
            if remaining < 4 or length > remaining - 4:
                raise ValueError(f"{path}: truncated record data")
        elif length > _SANITY_CAP:
            raise ValueError(f"{path}: implausible record length "
                             f"{length} (corrupt stream?)")
        if verify:
            (want,) = struct.unpack("<I", header[8:12])
            if masked_crc32c(header[:8]) != want:
                raise ValueError(f"{path}: corrupt length crc")
        data = f.read(length)
        footer = f.read(4)
        if len(data) != length or len(footer) != 4:
            raise ValueError(f"{path}: truncated record data")
        pos += length + 4
        if verify:
            (want,) = struct.unpack("<I", footer)
            if masked_crc32c(data) != want:
                raise ValueError(f"{path}: corrupt data crc")
        yield data


class TFRecordFile:
    """Index-backed random access over one TFRecord file.

    The index (data offsets and lengths) comes from the C++ scanner when
    the native library is available (CRC checks off the GIL included),
    and from a Python pass otherwise.
    """

    def __init__(self, path: str, *, verify: bool = True):
        self.path = path
        if native.available():
            self._offsets, self._lengths = native.tfrecord_index(
                path, verify=verify)
        else:
            # the seek-based header scan (gzip-rejecting: random access
            # needs raw byte offsets)
            self._offsets, self._lengths = index_record_offsets(path)
            if verify:
                for _ in tfrecord_iterator(path, verify=True):
                    pass
        self._f = open(path, "rb")

    def __len__(self) -> int:
        return len(self._offsets)

    def __getitem__(self, i: int) -> bytes:
        self._f.seek(int(self._offsets[i]))
        return self._f.read(int(self._lengths[i]))

    def __iter__(self) -> Iterator[bytes]:
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TFRecordFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# tf.train.Example wire-format codec
# ---------------------------------------------------------------------------
# Schema (proto3):
#   Example  { Features features = 1; }
#   Features { map<string, Feature> feature = 1; }
#   Feature  { oneof kind { BytesList bytes_list = 1;
#                           FloatList float_list = 2;
#                           Int64List int64_list = 3; } }
#   BytesList { repeated bytes value = 1; }
#   FloatList { repeated float value = 1; }   // packed
#   Int64List { repeated int64 value = 1; }   // packed


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def encode_example(features: dict[str, Any]) -> bytes:
    """Serialize a feature dict to ``tf.train.Example`` bytes.

    Value typing follows tf conventions: bytes/str → BytesList,
    float arrays → FloatList, int arrays → Int64List. Map entries are
    emitted in sorted key order (any order parses back identically).
    """
    feats = bytearray()
    for key in sorted(features):
        val = features[key]
        if isinstance(val, (bytes, str)):
            val = [val]
        arr = val if isinstance(val, (list, tuple)) else np.asarray(val)
        if isinstance(arr, (list, tuple)) and (
                not arr or isinstance(arr[0], (bytes, str))):
            # plain python lists are bytes lists — including EMPTY ones
            # (an untyped [] cannot round-trip as a numeric list; typed
            # empties arrive as numpy arrays and keep their kind)
            items = b"".join(
                _ld(1, v.encode() if isinstance(v, str) else v)
                for v in arr)
            feature = _ld(1, items)                       # bytes_list
        else:
            a = np.asarray(arr)
            if a.dtype.kind == "f":
                packed = a.astype("<f4").tobytes()
                feature = _ld(2, _ld(1, packed))          # float_list
            elif a.dtype.kind in "iu":
                packed = b"".join(
                    _varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                    for v in a.reshape(-1))
                feature = _ld(3, _ld(1, packed))          # int64_list
            else:
                raise TypeError(
                    f"unsupported feature dtype for {key!r}: {a.dtype}")
        entry = _ld(1, key.encode()) + _ld(2, feature)    # map entry
        feats += _ld(1, entry)
    return bytes(_ld(1, bytes(feats)))                    # Example.features


def _parse_fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = buf[pos:pos + 4]
            pos += 4
        elif wt == 1:
            v = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _to_int64(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


def _decode_feature(buf: bytes) -> Any:
    for field, wt, v in _parse_fields(buf):
        if field == 1 and wt == 2:                        # BytesList
            return [bv for f2, w2, bv in _parse_fields(v)
                    if f2 == 1 and w2 == 2]
        if field == 2:                                    # FloatList
            out: list[float] = []
            for f2, w2, fv in _parse_fields(v):
                if f2 != 1:
                    continue
                if w2 == 2:                               # packed
                    out.extend(np.frombuffer(fv, "<f4").tolist())
                elif w2 == 5:                             # unpacked
                    out.append(struct.unpack("<f", fv)[0])
            return np.asarray(out, np.float32)
        if field == 3:                                    # Int64List
            ints: list[int] = []
            for f2, w2, iv in _parse_fields(v):
                if f2 != 1:
                    continue
                if w2 == 2:                               # packed
                    pos = 0
                    while pos < len(iv):
                        u, pos = _read_varint(iv, pos)
                        ints.append(_to_int64(u))
                elif w2 == 0:                             # unpacked
                    ints.append(_to_int64(iv))
            return np.asarray(ints, np.int64)
    return None


def decode_example(data: bytes) -> dict[str, Any]:
    """Parse ``tf.train.Example`` bytes into {name: value}: BytesList →
    list[bytes], FloatList → f32 array, Int64List → i64 array."""
    out: dict[str, Any] = {}
    for field, wt, v in _parse_fields(data):
        if field != 1 or wt != 2:
            continue                                      # Example.features
        for f2, w2, entry in _parse_fields(v):
            if f2 != 1 or w2 != 2:
                continue                                  # map entry
            key = None
            val = None
            for f3, w3, ev in _parse_fields(entry):
                if f3 == 1 and w3 == 2:
                    key = ev.decode()
                elif f3 == 2 and w3 == 2:
                    val = _decode_feature(ev)
            if key is not None:
                out[key] = val
    return out


# ---------------------------------------------------------------------------
# Dataset-level helpers
# ---------------------------------------------------------------------------


def write_examples(path: str, examples: "list[dict[str, Any]]") -> None:
    """Write a list of feature dicts as one TFRecord file of Examples."""
    with TFRecordWriter(path) as w:
        for ex in examples:
            w.write(encode_example(ex))


def load_token_records(paths: "list[str]", feature: str = "input_ids",
                       *, verify: bool = True) -> np.ndarray:
    """[N, S] int32 token matrix from TFRecords of Examples — the BERT
    pretraining data format (create_pretraining_data-style files). All
    records must carry ``feature`` with one fixed length."""
    rows: list[np.ndarray] = []
    for path in sorted(paths):
        for rec in tfrecord_iterator(path, verify=verify):
            ex = decode_example(rec)
            if feature not in ex:
                raise ValueError(
                    f"{path}: record without {feature!r} feature "
                    f"(has {sorted(ex)})")
            rows.append(np.asarray(ex[feature], np.int32))
    if not rows:
        raise ValueError(f"no records in {paths}")
    lens = {len(r) for r in rows}
    if len(lens) != 1:
        raise ValueError(
            f"records disagree on {feature!r} length: {sorted(lens)}")
    return np.stack(rows)


def find_tfrecords(data_dir: str, prefix: str = "") -> "list[str]":
    """All ``{prefix}*.tfrecord`` files under data_dir, sorted."""
    try:
        names = sorted(os.listdir(data_dir))
    except OSError:
        return []
    return [os.path.join(data_dir, n) for n in names
            if n.startswith(prefix) and n.endswith(".tfrecord")]


def split_shards(data_dir: str, split: str) -> "list[str]":
    """Shard files for a dataset split. Accepts BOTH spellings in the
    wild: ``{split}*.tfrecord`` and the classic extensionless
    ``{split}-00000-of-01024`` (tf-slim/tfds ImageNet shards carry no
    suffix); the tf-slim ``validation-*`` naming satisfies ``val``."""
    def matching(prefix: str) -> "list[str]":
        try:
            names = sorted(os.listdir(data_dir))
        except OSError:
            return []
        # delimiter-or-nothing after the prefix: 'train' must not
        # sweep in 'trainer_debug.tfrecord'
        pat = re.compile(
            rf"{re.escape(prefix)}(-\d+-of-\d+(\.tfrecord)?"
            rf"|([._-].*)?\.tfrecord)$")
        return [os.path.join(data_dir, n) for n in names
                if pat.fullmatch(n)]

    shards = matching(split)
    if not shards and split == "val":
        shards = matching("validation")
    return shards


#: accepted Example feature-key spellings (tf-slim / tfds image exports)
IMAGE_KEYS = ("image/encoded", "image")
LABEL_KEYS = ("image/class/label", "label")


def extract_image_label(example: dict) -> tuple[bytes, int]:
    """(encoded image bytes, integer label) from a decoded image
    Example — the one probing helper shared by the streaming and eager
    loaders."""
    img = label = None
    for k in IMAGE_KEYS:
        if k in example:
            img = example[k][0]              # BytesList -> first entry
            break
    for k in LABEL_KEYS:
        if k in example:
            label = int(np.asarray(example[k]).reshape(-1)[0])
            break
    if img is None or label is None:
        raise ValueError(
            f"record lacks image/label features (has {sorted(example)}; "
            f"wanted one of {IMAGE_KEYS} and one of {LABEL_KEYS})")
    return img, label


def index_record_offsets(path: str) -> "tuple[np.ndarray, np.ndarray]":
    """(data_offsets, data_lengths) for a TFRecord file by header scan
    only — seeks past payloads, so indexing cost scales with record
    COUNT, not dataset bytes (the C++ scanner in data/native.py does the
    same off the GIL; this is the pure-Python fallback)."""
    if is_gzipped(path):
        raise ValueError(
            f"{path} is GZIP-compressed: offset indexing needs byte "
            "offsets; decompress the shard or use tfrecord_iterator")
    size = os.path.getsize(path)
    offs: list[int] = []
    lens: list[int] = []
    with open(path, "rb") as f:
        pos = 0
        while True:
            header = f.read(12)
            if not header:
                break
            if len(header) != 12:
                raise ValueError(f"{path}: truncated record header")
            pos += 12
            (length,) = struct.unpack("<Q", header[:8])
            remaining = size - pos
            if remaining < 4 or length > remaining - 4:
                raise ValueError(f"{path}: truncated record data")
            offs.append(pos)
            lens.append(length)
            pos += length + 4
            f.seek(pos)
    return np.asarray(offs, np.int64), np.asarray(lens, np.int64)
