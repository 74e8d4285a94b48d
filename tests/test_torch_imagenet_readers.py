"""The port's ImageNet readers (``data/imagenet.py``) against the JAX
package's, on image files written here from a numpy seed: decoded and
augmented pixels (PNG and JPEG, the plain and the DCT-scaled ``fast``
decode) bit for bit, the folder index with ``max_per_class``, the eager
folder and TFRecord loads with ``label_offset``, and the CLI's ImageNet
``--data_dir`` eagerly, with ``--max_per_class`` and under ``--eval_only``;
without Pillow a real ImageNet directory stops the CLI naming Pillow.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from PIL import Image  # noqa: E402

from distributed_tensorflow_example_tpu.data import imagenet as jimg  # noqa: E402
from distributed_tensorflow_example_tpu.data import tfrecord as jtfr  # noqa: E402
from distributed_tensorflow_example_tpu_torch.cli import train as tcli  # noqa: E402
from distributed_tensorflow_example_tpu_torch.data import imagenet as timg  # noqa: E402

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _encoded(arr: np.ndarray, fmt: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **(
        {"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """train: 3 classes x 5 images, val: 3 x 1, PNG and JPEG of mixed
    sizes and aspect ratios (resize, crop and draft all do work)."""
    root = tmp_path_factory.mktemp("imgtree")
    rs = np.random.RandomState(0)
    for split, n in (("train", 5), ("val", 1)):
        for c in range(3):
            d = root / split / f"n0{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = rs.randint(40, 160), rs.randint(40, 160)
                arr = rs.randint(0, 255, size=(h, w, 3), dtype=np.uint8)
                fmt, ext = (("PNG", "png"), ("JPEG", "JPEG"))[i % 2]
                (d / f"img_{i}.{ext}").write_bytes(_encoded(arr, fmt))
            (d / "notes.txt").write_text("not an image")
    return str(root)


def _sources(tree):
    paths, _ = jimg.index_image_folder(tree, "train")
    return paths


@pytest.mark.parametrize("fast", [False, True])
def test_decode_image_pixels_equal_the_reference(tree, fast):
    for p in _sources(tree):
        for src in (p, open(p, "rb").read()):
            a = timg.decode_image(src, 32, fast=fast)
            b = jimg.decode_image(src, 32, fast=fast)
            assert a.dtype == b.dtype == np.float32 and a.shape == (32, 32, 3)
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("fast", [False, True])
def test_augment_image_pixels_equal_the_reference(tree, fast):
    """The same (seed, epoch, index) generator gives the same crop, flip
    and pixels; a draft large enough to engage is covered by a 16-pixel
    target on the 40-160-pixel sources."""
    for i, p in enumerate(_sources(tree)):
        for size in (16, 48):
            a = timg.augment_image(p, size, np.random.default_rng([0, 1, i]),
                                   fast=fast)
            b = jimg.augment_image(p, size, np.random.default_rng([0, 1, i]),
                                   fast=fast)
            assert a.tobytes() == b.tobytes()
            assert a.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("cap", [None, 2])
def test_index_and_eager_folder_load_equal_the_reference(tree, cap):
    pa, la = timg.index_image_folder(tree, "train", max_per_class=cap)
    pb, lb = jimg.index_image_folder(tree, "train", max_per_class=cap)
    assert pa == pb and la.tobytes() == lb.tobytes()
    assert len(pa) == 3 * (cap or 5)
    a = timg.load_imagenet_folder(tree, "train", image_size=24,
                                  max_per_class=cap)
    b = jimg.load_imagenet_folder(tree, "train", image_size=24,
                                  max_per_class=cap)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    g = timg.get_imagenet(tree, max_per_class=cap)
    assert g["train_x"].shape == (3 * (cap or 5), 224, 224, 3)
    assert g["test_x"].shape[0] == 3          # val is never capped


@pytest.mark.parametrize("offset", [0, -1])
def test_eager_tfrecord_load_equals_the_reference(tree, tmp_path, offset):
    paths, labels = jimg.index_image_folder(tree, "train")
    shard = str(tmp_path / "validation-00000-of-00001")
    jtfr.write_examples(shard, [
        {"image/encoded": [open(p, "rb").read()],
         "image/class/label": np.asarray([y + 1], np.int64)}
        for p, y in zip(paths, labels)])
    for cap in (None, 4):
        a = timg.load_imagenet_tfrecords(str(tmp_path), "val", image_size=24,
                                         max_images=cap, label_offset=offset)
        b = jimg.load_imagenet_tfrecords(str(tmp_path), "val", image_size=24,
                                         max_images=cap, label_offset=offset)
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
        assert a["val_y"].tolist() == (labels + 1 + offset)[:cap].tolist()


def test_cli_imagenet_folder_eagerly_then_eval_only(tree, tmp_path):
    """``--model resnet50 --data_dir TREE --max_per_class 2`` trains one
    step on the eager arrays; ``--eval_only`` evaluates its checkpoint on
    the val split without decoding the train split."""
    ck = str(tmp_path / "ck")
    base = ["--model", "resnet50", "--device", "cpu", "--data_dir", tree,
            "--batch_size", "2", "--optimizer", "momentum",
            "--learning_rate", "0.01", "--ckpt_dir", ck]
    assert tcli.main(base + ["--train_steps", "1", "--max_per_class", "2",
                             "--save_steps", "1"]) == 0
    called = []
    orig = timg.load_imagenet_folder

    def spy(data_dir, split="train", **kw):
        called.append(split)
        return orig(data_dir, split, **kw)

    timg.load_imagenet_folder = spy
    try:
        assert tcli.main(base + ["--eval_only"]) == 0
    finally:
        timg.load_imagenet_folder = orig
    assert called == ["val"]


def test_cli_imagenet_guards(tree, tmp_path, monkeypatch):
    """The reference's messages: ``--augment``/``--fast_decode`` need
    ``--streaming`` on files and are refused on the synthetic set, TFRecord
    train shards need ``--streaming``, ``--fast_decode`` is ImageNet's;
    and with Pillow unimportable a real ImageNet directory exits naming
    Pillow instead of training on the synthetic set."""
    base = ["--device", "cpu", "--train_steps", "1"]
    for extra, frag in (
            (["--model", "resnet50", "--augment", "--data_dir", tree],
             "--augment requires --streaming"),
            (["--model", "resnet50", "--fast_decode", "--data_dir", tree],
             "--fast_decode requires --streaming"),
            (["--model", "resnet50", "--augment"],
             "not supported with --synthetic"),
            (["--model", "mlp", "--fast_decode"], "JPEG decode knob"),
            (["--model", "mlp", "--augment"], "no augmentation pipeline")):
        with pytest.raises(SystemExit, match=frag):
            tcli.main(base + extra)
    d = tmp_path / "shards"
    d.mkdir()
    jtfr.write_examples(str(d / "train-00000-of-00001"), [
        {"image/encoded": [b"x"], "image/class/label": [0]}])
    with pytest.raises(SystemExit, match="pass --streaming"):
        tcli.main(base + ["--model", "resnet50", "--data_dir", str(d)])
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for extra in ([], ["--streaming"], ["--streaming", "--eval_only",
                                        "--ckpt_dir", str(tmp_path)]):
        with pytest.raises(SystemExit, match="Pillow"):
            tcli.main(base + ["--model", "resnet50", "--data_dir", tree]
                      + extra)
    assert os.listdir(tmp_path) == ["shards"]
