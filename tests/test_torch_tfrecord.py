"""The port's TFRecord container and ``tf.train.Example`` codec
(``data/tfrecord.py``) and its C++ framing (``data/native.py``) against
the JAX package's copies, on fixture files written here from a numpy
seed: record bytes, decoded Examples, CRCs, offset indexes, the token and
image helpers and BERT's TFRecord token files, all equal exactly; with
TensorFlow's own writer and parser as a second oracle where it imports.
"""

import gzip
import os
import struct

import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.data import bert_data as jbert
from distributed_tensorflow_example_tpu.data import tfrecord as jtfr
from distributed_tensorflow_example_tpu_torch.data import bert_data as tbert
from distributed_tensorflow_example_tpu_torch.data import native
from distributed_tensorflow_example_tpu_torch.data import tfrecord as ttfr

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _examples(n=12, seed=0):
    """Feature dicts of every kind the codec takes: bytes and str lists,
    f32 and int arrays (negative and 64-bit ints included), empties."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        out.append({
            "input_ids": rs.randint(0, 30522, size=rs.randint(1, 40)),
            "weights": rs.randn(rs.randint(0, 6)).astype(np.float32),
            "neg": np.asarray([-1, -(2 ** 40), 2 ** 62 + i], np.int64),
            "image/encoded": [rs.bytes(rs.randint(0, 300))],
            "name": f"record-{i}",
            "tags": [b"a", "bé"],
            "empty": [],
        })
    return out


def test_encode_example_bytes_equal_the_reference():
    for ex in _examples():
        assert ttfr.encode_example(ex) == jtfr.encode_example(ex)


def test_decode_example_equals_the_reference_packed_and_unpacked():
    """Both codecs decode the same dicts, from the packed encoding and
    from hand-built unpacked repeats (wire types 5 and 0)."""
    for ex in _examples():
        raw = ttfr.encode_example(ex)
        _same_decoded(ttfr.decode_example(raw), jtfr.decode_example(raw))
    # unpacked FloatList (wire 5) and Int64List (wire 0)
    floats = b"".join(ttfr._varint((1 << 3) | 5) + struct.pack("<f", v)
                      for v in (1.5, -2.25))
    ints = b"".join(ttfr._varint(1 << 3) + ttfr._varint(v & (2**64 - 1))
                    for v in (7, -3))
    feats = (ttfr._ld(1, ttfr._ld(1, b"f") + ttfr._ld(2, ttfr._ld(2, floats)))
             + ttfr._ld(1, ttfr._ld(1, b"i")
                        + ttfr._ld(2, ttfr._ld(3, ints))))
    raw = ttfr._ld(1, feats)
    got = ttfr.decode_example(raw)
    _same_decoded(got, jtfr.decode_example(raw))
    np.testing.assert_array_equal(got["f"], np.float32([1.5, -2.25]))
    np.testing.assert_array_equal(got["i"], np.int64([7, -3]))


def _same_decoded(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three token-record shards written by the port's writer (two train,
    one test) and the same records by the reference's writer."""
    d = tmp_path_factory.mktemp("tfr")
    rs = np.random.RandomState(3)
    toks = rs.randint(0, 30522, size=(30, 16)).astype(np.int32)
    paths = {}
    for name, rows in (("train-0.tfrecord", toks[:12]),
                       ("train-1.tfrecord", toks[12:24]),
                       ("test-0.tfrecord", toks[24:])):
        p = str(d / name)
        ttfr.write_examples(p, [{"input_ids": r} for r in rows])
        jtfr.write_examples(str(d / ("ref_" + name)),
                            [{"input_ids": r} for r in rows])
        paths[name] = p
    return str(d), paths, toks


def test_writer_bytes_equal_the_reference(shards):
    d, paths, _ = shards
    for name, p in paths.items():
        with open(p, "rb") as f, open(os.path.join(d, "ref_" + name),
                                      "rb") as g:
            assert f.read() == g.read(), name


def test_crc32c_native_python_and_reference_agree():
    rs = np.random.RandomState(5)
    for n in (0, 1, 7, 8, 9, 63, 4096 + 3):
        data = rs.bytes(n)
        want = jtfr._crc32c_py(data)
        assert ttfr._crc32c_py(data) == want
        assert native.crc32c(data) == want
        assert ttfr.masked_crc32c(data) == jtfr.masked_crc32c(data)
    # the CRC-32C check value of "123456789"
    assert native.crc32c(b"123456789") == 0xE3069283


def test_iterator_and_random_access_equal_the_reference(shards):
    d, paths, toks = shards
    for p in paths.values():
        got = list(ttfr.tfrecord_iterator(p))
        assert got == list(jtfr.tfrecord_iterator(p))
        with ttfr.TFRecordFile(p) as f:
            assert len(f) == len(got)
            assert [f[i] for i in reversed(range(len(f)))] == got[::-1]


def test_native_index_equals_the_python_scan_and_the_reference(shards):
    _, paths, _ = shards
    for p in paths.values():
        offs, lens = native.tfrecord_index(p, verify=True)
        po, pl = ttfr.index_record_offsets(p)
        jo, jl = jtfr.index_record_offsets(p)
        for a in (po, jo):
            np.testing.assert_array_equal(offs, a)
        for a in (pl, jl):
            np.testing.assert_array_equal(lens, a)
        assert offs.dtype == lens.dtype == np.int64


@pytest.mark.parametrize("where", ["length", "data", "footer"])
def test_a_one_byte_corruption_raises_on_every_path(shards, tmp_path, where):
    """One flipped byte (in a record's length, payload or data CRC) fails
    the Python iterator, the native index with verify and TFRecordFile."""
    _, paths, _ = shards
    raw = bytearray(open(paths["train-0.tfrecord"], "rb").read())
    n0 = struct.unpack("<Q", raw[:8])[0]
    pos = {"length": 0, "data": 12 + n0 // 2, "footer": 12 + n0}[where]
    raw[pos] ^= 0x01
    p = str(tmp_path / "bad.tfrecord")
    open(p, "wb").write(bytes(raw))
    with pytest.raises(ValueError):
        list(ttfr.tfrecord_iterator(p))
    with pytest.raises(ValueError):
        list(jtfr.tfrecord_iterator(p))
    with pytest.raises(ValueError):
        native.tfrecord_index(p, verify=True)
    with pytest.raises(ValueError):
        ttfr.TFRecordFile(p)


def test_truncation_and_gzip(shards, tmp_path):
    _, paths, _ = shards
    raw = open(paths["train-1.tfrecord"], "rb").read()
    cut = str(tmp_path / "cut.tfrecord")
    open(cut, "wb").write(raw[:-3])
    for fn in (lambda: list(ttfr.tfrecord_iterator(cut)),
               lambda: ttfr.index_record_offsets(cut),
               lambda: native.tfrecord_index(cut)):
        with pytest.raises(ValueError):
            fn()
    gz = str(tmp_path / "train-gz.tfrecord")
    with gzip.open(gz, "wb") as f:
        f.write(raw)
    assert ttfr.is_gzipped(gz) and not ttfr.is_gzipped(cut)
    assert list(ttfr.tfrecord_iterator(gz)) == list(
        jtfr.tfrecord_iterator(paths["train-1.tfrecord"]))
    for fn in (ttfr.index_record_offsets, native.tfrecord_index):
        with pytest.raises(ValueError, match="GZIP"):
            fn(gz)


def test_dataset_helpers_equal_the_reference(shards, tmp_path):
    d, paths, toks = shards
    for prefix in ("", "train", "test"):
        assert ttfr.find_tfrecords(d, prefix) == jtfr.find_tfrecords(
            d, prefix)
    got = ttfr.load_token_records(ttfr.find_tfrecords(d, "train"))
    np.testing.assert_array_equal(got, jtfr.load_token_records(
        jtfr.find_tfrecords(d, "train")))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        ttfr.load_token_records([paths["train-0.tfrecord"],
                                 paths["train-1.tfrecord"]]), toks[:24])
    names = ["train-00000-of-01024", "train-00001-of-01024.tfrecord",
             "train.tfrecord", "trainer_debug.tfrecord",
             "validation-00000-of-00128", "val_x.tfrecord", "notes.txt"]
    for n in names:
        open(tmp_path / n, "wb").close()
    for split in ("train", "val", "validation", "test"):
        assert ttfr.split_shards(str(tmp_path), split) == \
            jtfr.split_shards(str(tmp_path), split), split
    for ex in ({"image/encoded": [b"jpg"], "image/class/label": [7]},
               {"image": [b"png"], "label": np.asarray([3], np.int64)}):
        assert ttfr.extract_image_label(ex) == jtfr.extract_image_label(ex)
    with pytest.raises(ValueError, match="lacks image/label"):
        ttfr.extract_image_label({"x": [b""]})


def test_bert_tfrecord_token_files_equal_the_reference(shards):
    """BERT's pre-tokenized TFRecords (train*/test* shards) mask into the
    reference's arrays bit for bit."""
    d, _, _ = shards
    kw = dict(vocab_size=30522, seq_len=16, max_predictions=4)
    for a, b in zip(tbert.get_bert_data(d, **kw),
                    jbert.get_bert_data(d, **kw)):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tensorflow_reads_and_writes_the_same_records(shards, tmp_path):
    """TensorFlow as the second oracle: its reader and Example parser take
    the port's files, and the port reads TF's writer's files."""
    tf = pytest.importorskip("tensorflow")
    _, paths, toks = shards
    p = paths["train-0.tfrecord"]
    got = [tf.train.Example.FromString(r.numpy()) for r in
           tf.data.TFRecordDataset(p)]
    assert [list(e.features.feature["input_ids"].int64_list.value)
            for e in got] == toks[:12].tolist()
    ex = _examples(3)
    q = str(tmp_path / "tf.tfrecord")
    with tf.io.TFRecordWriter(q) as w:
        for e in ex:
            w.write(ttfr.encode_example(e))
    recs = list(ttfr.tfrecord_iterator(q))
    assert recs == [ttfr.encode_example(e) for e in ex]
    for e, r in zip(ex, recs):
        proto = tf.train.Example.FromString(r)
        f = proto.features.feature
        np.testing.assert_array_equal(f["input_ids"].int64_list.value,
                                      e["input_ids"])
        np.testing.assert_array_equal(f["weights"].float_list.value,
                                      e["weights"])
        assert list(f["neg"].int64_list.value) == e["neg"].tolist()
        assert f["image/encoded"].bytes_list.value[0] == \
            e["image/encoded"][0]
        # TF's own serialization of the same proto decodes alike
        _same_decoded(ttfr.decode_example(proto.SerializeToString()),
                      ttfr.decode_example(r))
