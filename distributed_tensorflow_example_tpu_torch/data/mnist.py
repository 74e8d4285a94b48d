"""MNIST: the IDX-format readers and the learnable synthetic set (an
adapted copy of ``distributed_tensorflow_example_tpu/data/mnist.py``;
numpy only).

The real ``train-images-idx3-ubyte`` (plain or ``.gz``) files parse when
a data directory is given: a 16-byte big-endian header ``magic, n, rows,
cols``, then uint8 pixels; labels have an 8-byte header. Without one,
:func:`synthetic_mnist` draws the reference's class-conditional sparse
stroke prototypes, array for array the reference's. With ``native``
(``--native``) plain files parse in C++ (``data/native.py``) into the
same arrays as the numpy readers here.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_IMG_MAGIC = 2051
_LBL_MAGIC = 2049


def _open(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def read_idx_images(path: str) -> np.ndarray:
    """[n, rows, cols] uint8 from an IDX image file (or its ``.gz``)."""
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != _IMG_MAGIC:
            raise ValueError(f"{path}: bad IDX image magic {magic}")
        buf = f.read(n * rows * cols)
    return np.frombuffer(buf, np.uint8).reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    """[n] uint8 from an IDX label file (or its ``.gz``)."""
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != _LBL_MAGIC:
            raise ValueError(f"{path}: bad IDX label magic {magic}")
        buf = f.read(n)
    return np.frombuffer(buf, np.uint8)


def _reader_pair(path: str, native: bool):
    """The C++ parsers for a plain file under ``native`` (raising when the
    library cannot be built), the numpy ones otherwise and for ``.gz``."""
    if native and os.path.exists(path):
        from . import native as native_mod
        return native_mod.read_idx_images, native_mod.read_idx_labels
    return read_idx_images, read_idx_labels


def load_mnist(data_dir: str, native: bool = False) -> dict[str, np.ndarray]:
    """{'train_x', 'train_y', 'test_x', 'test_y'}: x in [0, 1] f32
    flattened to 784 (the reference's input shape), y int32."""
    def split(img, lbl):
        ip = os.path.join(data_dir, img)
        read_imgs, read_lbls = _reader_pair(ip, native)
        x = read_imgs(ip)
        y = read_lbls(os.path.join(data_dir, lbl))
        return (x.reshape(len(x), -1).astype(np.float32) / 255.0,
                y.astype(np.int32))

    tx, ty = split("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    vx, vy = split("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy}


def synthetic_mnist(num_train: int = 8192, num_test: int = 1024,
                    seed: int = 0, noise: float = 0.25
                    ) -> dict[str, np.ndarray]:
    """Class-conditional 'digits' with MNIST-like statistics: 10 fixed
    sparse stroke prototypes (~18% active pixels, near real MNIST's
    ~19%), samples = prototype + noise on the active pixels, clipped to
    [0, 1]. The sparsity keeps input norms, and so the gradient scale,
    near real MNIST's: SGD at the reference's lr 0.5 stays stable and the
    MLP passes 0.95 accuracy."""
    rs = np.random.RandomState(seed)
    mask = (rs.rand(10, 784) < 0.18).astype(np.float32)
    protos = (mask * (0.5 + 0.5 * rs.rand(10, 784))).astype(np.float32)

    def draw(n, rstate):
        y = rstate.randint(0, 10, size=n).astype(np.int32)
        x = protos[y] + rstate.randn(n, 784).astype(np.float32) * noise \
            * (protos[y] > 0)
        return np.clip(x, 0.0, 1.0), y

    tx, ty = draw(num_train, rs)
    vx, vy = draw(num_test, np.random.RandomState(seed + 1))
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy}


def get_mnist(data_dir: str | None, synthetic: bool = False,
              native: bool = False, **synth_kw) -> dict[str, np.ndarray]:
    """Real MNIST when ``data_dir`` is given (raising when its files are
    missing: training on synthetic data instead would falsify an
    accuracy claim; ``native``: the C++ parsers), synthetic otherwise."""
    if data_dir and not synthetic:
        return load_mnist(data_dir, native)
    return synthetic_mnist(**synth_kw)
