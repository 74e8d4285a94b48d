"""CIFAR-10: the binary-format reader, the learnable synthetic set and the
pad-4 crop + flip augmentation (an adapted copy of
``distributed_tensorflow_example_tpu/data/cifar.py``; numpy only).

Real format (the ``cifar-10-batches-bin`` distribution): records of
1 label byte + 3072 pixel bytes (CHW planar R, G, B, 32x32), 10000
records per ``data_batch_N.bin`` / ``test_batch.bin`` file. Output is
NHWC float32 in [0, 1], array for array the reference's. With
``native`` (``--native``) the files parse in C++ (``data/native.py``)
into the same arrays, byte for byte.
"""

from __future__ import annotations

import os

import numpy as np

_REC = 1 + 3072
_TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
_TEST_FILE = "test_batch.bin"


def read_cifar_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(images [n, 32, 32, 3] f32 in [0, 1], labels [n] int32)."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % _REC:
        raise ValueError(f"{path}: size {raw.size} not a multiple of "
                         f"record size {_REC}")
    raw = raw.reshape(-1, _REC)
    labels = raw[:, 0].astype(np.int32)
    imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return imgs.astype(np.float32) / 255.0, labels


def load_cifar10(data_dir: str, native: bool = False
                 ) -> dict[str, np.ndarray]:
    """The five train batches and the test batch under ``data_dir`` (or
    its ``cifar-10-batches-bin`` subdirectory); ``native``: the C++
    parser, raising when its library cannot be built."""
    sub = os.path.join(data_dir, "cifar-10-batches-bin")
    root = sub if os.path.isdir(sub) else data_dir
    read = read_cifar_bin
    if native:
        from . import native as native_mod
        read = native_mod.read_cifar_bin
    xs, ys = [], []
    for f in _TRAIN_FILES:
        x, y = read(os.path.join(root, f))
        xs.append(x)
        ys.append(y)
    vx, vy = read(os.path.join(root, _TEST_FILE))
    return {"train_x": np.concatenate(xs), "train_y": np.concatenate(ys),
            "test_x": vx, "test_y": vy}


def synthetic_cifar10(num_train: int = 4096, num_test: int = 512,
                      seed: int = 0, noise: float = 0.15
                      ) -> dict[str, np.ndarray]:
    """Class-conditional color-texture prototypes, 32x32x3 in [0, 1]."""
    rs = np.random.RandomState(seed)
    protos = rs.rand(10, 32, 32, 3).astype(np.float32) * 0.6 + 0.2

    def draw(n, rstate):
        y = rstate.randint(0, 10, size=n).astype(np.int32)
        x = protos[y] + rstate.randn(n, 32, 32, 3).astype(np.float32) * noise
        return np.clip(x, 0.0, 1.0), y

    tx, ty = draw(num_train, rs)
    vx, vy = draw(num_test, np.random.RandomState(seed + 1))
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy}


def get_cifar10(data_dir: str | None, synthetic: bool = False,
                native: bool = False, **synth_kw) -> dict[str, np.ndarray]:
    if data_dir and not synthetic:
        return load_cifar10(data_dir, native)
    return synthetic_cifar10(**synth_kw)


def augment_batch(x: np.ndarray, *, epoch: int, indices: np.ndarray,
                  seed: int, pad: int = 4) -> np.ndarray:
    """The CIFAR ResNet recipe (He et al.): zero-pad ``pad`` px, a random
    HxW crop, a horizontal flip with p=0.5. Each image's rng keys on
    (seed, epoch, its global dataset index), so the stream does not
    depend on the process count and replays exactly on resume."""
    n, h, w, c = x.shape
    padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    out = np.empty_like(x)
    for j, i in enumerate(indices):
        rng = np.random.default_rng([seed, epoch, int(i)])
        dy = int(rng.integers(0, 2 * pad + 1))
        dx = int(rng.integers(0, 2 * pad + 1))
        img = padded[j, dy:dy + h, dx:dx + w]
        if rng.random() < 0.5:
            img = img[:, ::-1]
        out[j] = img
    return out


def make_augment_transform(seed: int, pad: int = 4):
    """The loader's ``transform`` hook applying :func:`augment_batch` to
    the ``x`` key (labels untouched)."""
    def transform(batch, epoch, indices):
        return dict(batch, x=augment_batch(batch["x"], epoch=epoch,
                                           indices=indices, seed=seed,
                                           pad=pad))
    return transform
