"""ImageNet: the folder-tree and TFRecord readers (PIL) and the synthetic
set (an adapted copy of ``distributed_tensorflow_example_tpu/data/
imagenet.py``).

Real layout: ``<data_dir>/{train,val}/<class_dir>/*.{JPEG,jpg,png}``,
classes sorted for the labels (torchvision's convention), or TFRecord
shards of ``tf.train.Example`` records (``image/encoded``,
``image/class/label``). Images are resized (short side) and center-cropped
to ``image_size``, or randomly crop-resized and flipped for training
(``augment_image``), the pixels the reference's bit for bit: the same PIL
calls and numpy random streams. Pillow is imported only inside the
functions that decode.

Synthetic: ImageNet-shaped (224x224x3, 1000 classes) class-conditional
textures, so ResNet-50 trains and is measured without a dataset, array
for array the reference's.
"""

from __future__ import annotations

import math
import os

import numpy as np

_EXTS = (".jpeg", ".jpg", ".png")


def require_pil() -> None:
    """RuntimeError naming Pillow when it cannot be imported: real images
    never fall back to the synthetic set."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "decoding real ImageNet images needs Pillow (the PIL package), "
            "which cannot be imported here; omit --data_dir for the "
            "synthetic set") from e


def _list_classes(split_dir: str) -> list[str]:
    return sorted(d for d in os.listdir(split_dir)
                  if os.path.isdir(os.path.join(split_dir, d)))


def _open_image(src):
    """PIL open from a path or from encoded bytes (a TFRecord's
    'image/encoded' feature decodes through the same routine as a
    file)."""
    import io
    require_pil()
    from PIL import Image
    if isinstance(src, (bytes, bytearray, memoryview)):
        return Image.open(io.BytesIO(src))
    return Image.open(src)


def decode_image(path: str, image_size: int, *,
                 fast: bool = False) -> np.ndarray:
    """Decode + short-side resize + center crop -> [S,S,3] f32 in [0,1].
    The one decode routine shared by the eager loader and the streaming
    pipeline so both produce bit-identical pixels (with ``fast=False``).
    ``path`` may also be the encoded image bytes (TFRecord path).

    ``fast=True`` enables JPEG DCT-domain downscaling (``Image.draft``):
    libjpeg decodes at 1/2–1/8 scale directly when the source is much
    larger than the target, which saves most of the decode for a small
    pixel deviation. Opt-in because the pixels differ from the plain
    decode.
    """
    img = _open_image(path)
    if fast:
        img.draft("RGB", (image_size, image_size))
    img = img.convert("RGB")
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)))
    w, h = img.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    return np.asarray(img, np.float32) / 255.0


def augment_image(path: str, image_size: int,
                  rng: np.random.Generator, *,
                  fast: bool = False) -> np.ndarray:
    """Training augmentation: random-resized crop (scale 0.08–1.0, ratio
    3/4–4/3 — the standard ResNet ImageNet recipe) + horizontal flip,
    -> [S,S,3] f32 in [0,1].

    Determinism: the caller derives ``rng`` from (seed, epoch, global
    image index), so the augmented pixel stream is independent of process
    count and batch composition, and exact-resume replays it bit-exactly.
    ``path`` may also be the encoded image bytes (TFRecord path).
    """
    img = _open_image(path)
    if fast:
        # DCT-scale decode — but conservatively: random-resized crop may
        # take as little as 8% of the area (a 0.283x-short-side window),
        # so draft to ~4x the target to keep even the smallest crop at or
        # above native target resolution (no systematic upsample blur).
        # Draft therefore engages only for very large sources here; the
        # big win stays on the plain-decode path. Crop geometry uses the
        # drafted size — deterministic per (seed, epoch, index).
        img.draft("RGB", (4 * image_size, 4 * image_size))
    img = img.convert("RGB")
    w, h = img.size
    area = float(w * h)
    crop = None
    for _ in range(10):
        target = area * rng.uniform(0.08, 1.0)
        ratio = math.exp(rng.uniform(math.log(3 / 4), math.log(4 / 3)))
        cw = int(round(math.sqrt(target * ratio)))
        ch = int(round(math.sqrt(target / ratio)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            crop = img.crop((left, top, left + cw, top + ch))
            break
    if crop is None:                       # degenerate aspect: center crop
        side = min(w, h)
        left, top = (w - side) // 2, (h - side) // 2
        crop = img.crop((left, top, left + side, top + side))
    arr = np.asarray(crop.resize((image_size, image_size)),
                     np.float32) / 255.0
    if rng.random() < 0.5:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr)


def index_image_folder(data_dir: str, split: str = "train", *,
                       max_per_class: int | None = None
                       ) -> tuple[list[str], np.ndarray]:
    """(paths, labels) for a torchvision-layout folder tree — the cheap
    metadata pass the streaming pipeline builds on (no pixel IO)."""
    split_dir = os.path.join(data_dir, split)
    classes = _list_classes(split_dir)
    if not classes:
        raise FileNotFoundError(f"no class dirs under {split_dir}")
    paths: list[str] = []
    labels: list[int] = []
    for label, cls in enumerate(classes):
        cdir = os.path.join(split_dir, cls)
        files = sorted(f for f in os.listdir(cdir)
                       if f.lower().endswith(_EXTS))
        if max_per_class:
            files = files[:max_per_class]
        paths.extend(os.path.join(cdir, f) for f in files)
        labels.extend([label] * len(files))
    return paths, np.asarray(labels, np.int32)


def load_imagenet_folder(data_dir: str, split: str = "train", *,
                         image_size: int = 224,
                         max_per_class: int | None = None
                         ) -> dict[str, np.ndarray]:
    """Eagerly decodes a folder tree into arrays. Use ``max_per_class`` to
    bound memory (full ImageNet does not fit in host RAM as float32)."""
    require_pil()

    # one file-selection pass shared with the streaming pipeline: the
    # eager/streaming bit-identity guarantee rests on indexing + decoding
    # through the same code
    paths, labels = index_image_folder(data_dir, split,
                                       max_per_class=max_per_class)
    xs = [decode_image(p, image_size) for p in paths]
    return {f"{split}_x": np.stack(xs), f"{split}_y": labels}


def load_imagenet_tfrecords(data_dir: str, split: str = "val", *,
                            image_size: int = 224,
                            max_images: int | None = None,
                            label_offset: int = 0
                            ) -> dict[str, np.ndarray]:
    """Eagerly decode image TFRecord shards (the classic
    ``validation-00000-of-00128`` distribution format) into arrays —
    the eval-split counterpart of the streaming TFRecord pipeline.
    Records are ``tf.train.Example`` with ``image/encoded`` +
    ``image/class/label``; ``label_offset`` must match the train
    side's (tf-slim shards are 1-indexed: pass -1)."""
    from .tfrecord import (decode_example, extract_image_label,
                           split_shards, tfrecord_iterator)
    shards = split_shards(data_dir, split)
    if not shards:
        raise FileNotFoundError(
            f"no {split} TFRecord shards under {data_dir!r}")
    xs, ys = [], []
    for path in shards:
        for rec in tfrecord_iterator(path):
            img, label = extract_image_label(decode_example(rec))
            xs.append(decode_image(img, image_size))
            ys.append(label + label_offset)
            if max_images is not None and len(xs) >= max_images:
                break
        if max_images is not None and len(xs) >= max_images:
            break
    return {f"{split}_x": np.stack(xs),
            f"{split}_y": np.asarray(ys, np.int32)}


def synthetic_imagenet(num_train: int = 512, num_test: int = 128,
                       num_classes: int = 1000, image_size: int = 224,
                       seed: int = 0, noise: float = 0.1
                       ) -> dict[str, np.ndarray]:
    """ImageNet-shaped synthetic data. Prototypes are low-res textures
    upsampled to full size (keeps the generator's memory footprint small
    while remaining class-separable)."""
    rs = np.random.RandomState(seed)
    small = rs.rand(num_classes, 16, 16, 3).astype(np.float32)
    reps = image_size // 16

    def draw(n, rstate):
        y = rstate.randint(0, num_classes, size=n).astype(np.int32)
        proto = np.repeat(np.repeat(small[y], reps, axis=1), reps, axis=2)
        x = proto + rstate.randn(*proto.shape).astype(np.float32) * noise
        return np.clip(x, 0.0, 1.0), y

    tx, ty = draw(num_train, rs)
    vx, vy = draw(num_test, np.random.RandomState(seed + 1))
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy}


def get_imagenet(data_dir: str | None, synthetic: bool = False,
                 max_per_class: int | None = None,
                 **synth_kw) -> dict[str, np.ndarray]:
    """The folder tree under ``data_dir`` decoded eagerly (train, then the
    whole val split), else the synthetic set. ``max_per_class`` bounds the
    train decode: full ImageNet as float32 host arrays is ~770 GB, so pass
    a bound (``--max_per_class``) or stream (``data/streaming.py``) beyond
    fine-tune scale. No default cap: a dataset cut the user did not ask
    for would falsify an accuracy comparison."""
    if data_dir and not synthetic:
        train = load_imagenet_folder(data_dir, "train",
                                     max_per_class=max_per_class)
        # never cap val: eval numbers must be comparable across runs with
        # different train caps (val is ~50/class — no memory pressure)
        val = load_imagenet_folder(data_dir, "val")
        return {"train_x": train["train_x"], "train_y": train["train_y"],
                "test_x": val["val_x"], "test_y": val["val_y"]}
    return synthetic_imagenet(**synth_kw)
