"""The port's streaming image pipeline (``data/streaming.py``) against the
JAX package's, on a folder tree and TFRecord shards written here from a
numpy seed: every batch equal bit for bit, plain, augmented and with the
fast decode, across process counts, epochs and ``skip`` (which decodes
nothing it skips), ``label_offset`` on shards, the bad-image policy
(skip and refill, the per-epoch cap, an all-bad batch), the port's
``microbatches`` layout against its ``ShardedLoader``; then the CLI's
``--streaming`` over a folder and over shards, whose Trainer closes the
source's decode pool.
"""

import io

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from PIL import Image  # noqa: E402

from distributed_tensorflow_example_tpu.data import streaming as jstream  # noqa: E402
from distributed_tensorflow_example_tpu.data import tfrecord as jtfr  # noqa: E402
from distributed_tensorflow_example_tpu.runtime import faults as jfaults  # noqa: E402
from distributed_tensorflow_example_tpu_torch.cli import train as tcli  # noqa: E402
from distributed_tensorflow_example_tpu_torch.data import imagenet as timg  # noqa: E402
from distributed_tensorflow_example_tpu_torch.data import loader as tloader  # noqa: E402
from distributed_tensorflow_example_tpu_torch.data import streaming as tstream  # noqa: E402
from distributed_tensorflow_example_tpu_torch.runtime import faults as tfaults  # noqa: E402

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

SIZE = 24


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A folder tree (train 3 classes x 8 PNGs of 40x36, val 3 x 2) and
    the same train images as JPEG records in two shards, labels + 1 (the
    tf-slim layout), with a val shard."""
    root = tmp_path_factory.mktemp("stream")
    tree, shards = root / "tree", root / "shards"
    rs = np.random.RandomState(0)
    recs = {"train": [], "val": []}
    for split, n in (("train", 8), ("val", 2)):
        for c in range(3):
            d = tree / split / f"class_{c}"
            d.mkdir(parents=True)
            for i in range(n):
                arr = rs.randint(0, 255, size=(40, 36, 3), dtype=np.uint8)
                Image.fromarray(arr).save(d / f"img_{i}.png")
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG", quality=90)
                recs[split].append({"image/encoded": [buf.getvalue()],
                                    "image/class/label": [c + 1]})
    shards.mkdir()
    half = len(recs["train"]) // 2
    jtfr.write_examples(str(shards / "train-00000-of-00002"),
                        recs["train"][:half])
    jtfr.write_examples(str(shards / "train-00001-of-00002"),
                        recs["train"][half:])
    jtfr.write_examples(str(shards / "validation-00000-of-00001"),
                        recs["val"])
    return str(tree), str(shards)


def _make(mod, kind, data, **kw):
    tree, shards = data
    if kind == "folder":
        return mod.StreamingImageFolder(tree, "train", image_size=SIZE,
                                        decode_threads=3, **kw)
    return mod.StreamingTFRecordImages(shards, "train", image_size=SIZE,
                                       decode_threads=3, label_offset=-1,
                                       **kw)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k


MODES = {"plain": {}, "augment": {"augment": True},
         "fast": {"fast_decode": True},
         "augment_fast": {"augment": True, "fast_decode": True}}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", ["folder", "tfrecord"])
def test_batches_equal_the_reference_across_processes(data, kind, mode):
    """8 batches of 6 (24 images: two epochs and two batches): each
    process's batch equals the reference's, and the two processes' slices
    make the one-process batch."""
    kw = dict(global_batch=6, seed=5, **MODES[mode])
    one = _make(tstream, kind, data, **kw)
    parts = [_make(tstream, kind, data, process_index=i, num_processes=2,
                   **kw) for i in range(2)]
    refs = [_make(jstream, kind, data, process_index=i, num_processes=2,
                  **kw) for i in range(2)]
    its = [iter(s) for s in [one] + parts + refs]
    for _ in range(8):
        whole, p0, p1, r0, r1 = (next(it) for it in its)
        _equal(p0, r0)
        _equal(p1, r1)
        _equal(whole, {k: np.concatenate([p0[k], p1[k]]) for k in whole})
    if kind == "tfrecord":
        assert set(whole["y"].tolist()) <= {0, 1, 2}
    for s in [one] + parts + refs:
        s.close()


@pytest.mark.parametrize("kind", ["folder", "tfrecord"])
def test_skip_resumes_exactly_without_decoding(data, kind, monkeypatch):
    kw = dict(global_batch=6, seed=2, augment=True)
    full = _make(tstream, kind, data, **kw)
    it = iter(full)
    wanted = [next(it) for _ in range(7)][5:]      # batches 5, 6 (epoch 1)
    resumed = _make(tstream, kind, data, **kw)
    decoded = []
    orig = resumed._decode
    monkeypatch.setattr(resumed, "_decode", lambda idx, epoch: (
        decoded.append(len(idx)) or orig(idx, epoch)))
    resumed.skip(5)
    rit = iter(resumed)
    for w in wanted:
        _equal(next(rit), w)
    assert decoded == [6, 6]                 # only the two batches served
    full.close()
    resumed.close()


def test_plain_stream_equals_the_eager_path(data):
    tree, _ = data
    eager = timg.load_imagenet_folder(tree, "train", image_size=SIZE)
    ref = tloader.ShardedLoader({"x": eager["train_x"],
                                 "y": eager["train_y"]}, 6, seed=4)
    stream = _make(tstream, "folder", data, global_batch=6, seed=4)
    for a, b in zip(iter(stream), iter(ref)):
        _equal(a, b)
        if stream.epoch == 2:
            break
    stream.close()


@pytest.mark.parametrize("kind", ["folder", "tfrecord"])
def test_microbatch_layout_equals_the_sharded_loader(data, kind):
    """The port's ``microbatches``: each process's batch is its slice of
    every microbatch, the indices ``ShardedLoader`` takes."""
    src = _make(tstream, kind, data, global_batch=12, seed=1)
    n = src.n
    arrays = {"i": np.arange(n)}
    for pi in range(2):
        s = _make(tstream, kind, data, global_batch=12, seed=1,
                  process_index=pi, num_processes=2, microbatches=2)
        got = []
        s._decode = lambda idx, epoch: {"i": np.asarray(idx)}
        loader = tloader.ShardedLoader(arrays, 12, seed=1, process_index=pi,
                                       num_processes=2, microbatches=2)
        for a, b in zip(iter(s), iter(loader)):
            got.append(a)
            np.testing.assert_array_equal(a["i"], b["i"])
            if len(got) == 5:
                break
        s.close()
    src.close()


def test_streaming_source_autodetects_and_guards(data):
    tree, shards = data
    for mod in (tstream, jstream):
        assert mod.StreamingSource(shards, "train").tfrecords
        assert not mod.StreamingSource(tree, "train").tfrecords
    kw = dict(start_step=3, process_index=1, num_processes=2, seed=7,
              prefetch=0)
    a = tstream.StreamingSource(shards, "train", image_size=SIZE,
                                label_offset=-1, decode_threads=2)
    b = jstream.StreamingSource(shards, "train", image_size=SIZE,
                                label_offset=-1, decode_threads=2)
    ia, ib = a.make_loader(6, **kw), b.make_loader(6, **kw)
    for _ in range(3):
        _equal(next(ia), next(ib))
    a.close()
    b.close()
    with pytest.raises(ValueError, match="label_offset"):
        tstream.StreamingSource(tree, "train", label_offset=-1).make_loader(6)
    with pytest.raises(ValueError, match="max_per_class"):
        tstream.StreamingSource(shards, "train",
                                max_per_class=2).make_loader(6)


def _bad_tree(tmp_path, n_good, n_bad):
    rs = np.random.RandomState(1)
    root = tmp_path / "train" / "class_0"
    root.mkdir(parents=True)
    for i in range(n_good):
        Image.fromarray(rs.randint(0, 255, (48, 48, 3),
                                   dtype=np.uint8)).save(root / f"g{i}.png")
    for i in range(n_bad):
        (root / f"z_bad{i}.png").write_bytes(b"not an image at all")
    return str(tmp_path)


@pytest.mark.parametrize("case", ["refill", "cap", "all_bad"])
def test_bad_image_policy_equals_the_reference(tmp_path, monkeypatch, case):
    """An undecodable image is retried, then skipped and its slot refilled
    from the batch (the reference's batch bit for bit); past the per-epoch
    cap, or with no good sample, the batch raises."""
    for mod in (tfaults, jfaults):
        monkeypatch.setattr(mod, "RETRY_BASE_DELAY", 0.001)
    good, bad, cap, frag = {"refill": (7, 1, 64, None),
                            "cap": (6, 2, 1, "cap"),
                            "all_bad": (0, 8, 64, "every sample")}[case]
    tree = _bad_tree(tmp_path, good, bad)
    kw = dict(image_size=SIZE, global_batch=8, shuffle=False, seed=0,
              max_skipped_per_epoch=cap)
    srcs = [m.StreamingImageFolder(tree, "train", **kw)
            for m in (tstream, jstream)]
    try:
        if frag:
            for s in srcs:
                with pytest.raises(RuntimeError, match=frag):
                    next(s.epoch_batches(0))
        else:
            a, b = (next(s.epoch_batches(0)) for s in srcs)
            _equal(a, b)
            assert srcs[0]._skip["total"] == 1
            assert a["x"].shape == (8, SIZE, SIZE, 3)
    finally:
        for s in srcs:
            s.close()


@pytest.mark.parametrize("kind", ["folder", "tfrecord"])
def test_cli_streams_resnet50(data, kind, monkeypatch):
    """``cli.train --model resnet50 --streaming`` trains a step from the
    folder tree (with ``--augment --fast_decode``) or the shards (with
    ``--label_offset -1``), evaluates the eager val split, and the
    Trainer closes the source."""
    tree, shards = data
    closed = []
    orig = tstream.StreamingSource.close
    monkeypatch.setattr(tstream.StreamingSource, "close",
                        lambda self: closed.append(self) or orig(self))
    extra = (["--data_dir", tree, "--augment", "--fast_decode"]
             if kind == "folder" else
             ["--data_dir", shards, "--label_offset", "-1"])
    assert tcli.main(["--model", "resnet50", "--device", "cpu",
                      "--streaming", "--batch_size", "2", "--train_steps",
                      "1", "--optimizer", "momentum", "--learning_rate",
                      "0.01"] + extra) == 0
    assert len(closed) == 1 and closed[0]._folder._pool._shutdown
