"""The port's C++ native loader (``data/native.py`` over its own copy of
``dataloader.cpp``, built into ``build/native/``) against the numpy paths
of both packages, on fixture files written here from a numpy seed: the
IDX and CIFAR parsers' arrays equal byte for byte; ``NativeLoader``'s
batch sequence equal to the port's ``ShardedLoader`` and the reference's
across epochs, resume offsets, 2 processes and ``microbatches=2``; an
explicit ``--native`` whose library cannot be built raises; the CLI's
``--native`` run ends on the Python loader's params bit for bit.
"""

import glob
import os
import struct

import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.data import cifar as jcifar
from distributed_tensorflow_example_tpu.data import loader as jloader
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.data import cifar as tcifar
from distributed_tensorflow_example_tpu_torch.data import loader as tloader
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.data import native

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_library_builds_from_the_port_source_into_build_native():
    assert native.available(), native._error
    assert native._SO == os.path.join(ROOT, "build", "native",
                                      "libdtxdata.so")
    assert os.path.exists(native._SO)
    assert native._SRC.startswith(os.path.join(
        ROOT, "distributed_tensorflow_example_tpu_torch"))
    assert native.require().dl_abi_version() == 3


def _write_idx(d, n=9, r=5, c=6, seed=3):
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 256, size=(n, r, c)).astype(np.uint8)
    lbls = rs.randint(0, 10, size=n).astype(np.uint8)
    ip, lp = os.path.join(d, "imgs"), os.path.join(d, "lbls")
    with open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, r, c) + imgs.tobytes())
    with open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lbls.tobytes())
    return ip, lp, imgs, lbls


def test_idx_parsers_equal_both_numpy_readers(tmp_path):
    ip, lp, imgs, lbls = _write_idx(str(tmp_path))
    for got, ref in ((native.read_idx_images(ip), tmnist.read_idx_images(ip)),
                     (native.read_idx_images(ip), jmnist.read_idx_images(ip)),
                     (native.read_idx_labels(lp), tmnist.read_idx_labels(lp)),
                     (native.read_idx_labels(lp), jmnist.read_idx_labels(lp))):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(native.read_idx_images(ip), imgs)
    bad = str(tmp_path / "bad")
    with open(bad, "wb") as f:
        f.write(struct.pack(">IIII", 7, 1, 1, 1) + b"\0")
    with pytest.raises(ValueError):
        native.read_idx_images(bad)


def _write_cifar(d, n_per_file=20, seed=0):
    rs = np.random.RandomState(seed)
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for name in names:
        rec = np.concatenate(
            [rs.randint(0, 10, size=(n_per_file, 1)),
             rs.randint(0, 256, size=(n_per_file, 3072))], 1).astype(np.uint8)
        rec.tofile(os.path.join(d, name))
    return [os.path.join(d, n) for n in names]


def test_cifar_parser_equals_both_numpy_readers_byte_for_byte(tmp_path):
    """Every byte value in every channel: the C++ parser divides by 255
    in f32, as the numpy readers do (the reference's C++ copy multiplies
    by 1/255 and misses some values by an ulp)."""
    p = str(tmp_path / "all.bin")
    vals = np.arange(256, dtype=np.uint8)
    rec = np.zeros((256, 3073), np.uint8)
    rec[:, 0] = vals % 10
    rec[:, 1:] = np.repeat(vals[:, None], 3072, 1)
    rec.tofile(p)
    for path in [p] + _write_cifar(str(tmp_path))[:1]:
        nx, ny = native.read_cifar_bin(path)
        for rx, ry in (tcifar.read_cifar_bin(path),
                       jcifar.read_cifar_bin(path)):
            assert nx.dtype == rx.dtype and nx.shape == rx.shape
            assert nx.tobytes() == rx.tobytes()
            assert ny.dtype == ry.dtype and ny.tobytes() == ry.tobytes()


def test_load_with_native_equals_load_without(tmp_path):
    _write_cifar(str(tmp_path))
    a = tcifar.get_cifar10(str(tmp_path), native=True)
    b = tcifar.get_cifar10(str(tmp_path))
    c = jcifar.load_cifar10(str(tmp_path))
    for k in a:
        assert a[k].tobytes() == b[k].tobytes()
        np.testing.assert_allclose(a[k], c[k], rtol=0, atol=6e-8)
    m = tmp_path / "mnist"
    m.mkdir()
    for img, lbl, n in (("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                         12), ("t10k-images-idx3-ubyte",
                               "t10k-labels-idx1-ubyte", 5)):
        ip, lp, _, _ = _write_idx(str(m), n=n, r=28, c=28, seed=n)
        os.rename(ip, m / img)
        os.rename(lp, m / lbl)
    a = tmnist.get_mnist(str(m), native=True)
    b = jmnist.get_mnist(str(m))
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def _arrays(n=64, seed=1):
    """A BERT-like 6-array batch of mixed dtypes and ranks."""
    rs = np.random.RandomState(seed)
    return {
        "input_ids": rs.randint(0, 1000, size=(n, 16)).astype(np.int32),
        "attention_mask": rs.randint(0, 2, size=(n, 16)).astype(np.int32),
        "token_type_ids": np.zeros((n, 16), np.int32),
        "masked_positions": rs.randint(0, 16, size=(n, 4)).astype(np.int32),
        "masked_labels": rs.randint(0, 1000, size=(n, 4)).astype(np.int32),
        "masked_weights": rs.rand(n, 4).astype(np.float32),
    }


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("procs,micro", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_native_batches_equal_the_sharded_loaders(procs, micro):
    """Three epochs (4 batches each, 64 rows of 16): every rank's batch
    equals the port's ShardedLoader's and, without microbatches, the
    reference's."""
    a = _arrays()
    for pi in range(procs):
        kw = dict(seed=5, process_index=pi, num_processes=procs)
        nat = native.NativeLoader(a, 16, microbatches=micro, **kw)
        it = iter(nat)
        py = iter(tloader.ShardedLoader(a, 16, microbatches=micro, **kw))
        ref = iter(jloader.ShardedLoader(a, 16, **kw)) if micro == 1 \
            else None
        for _ in range(12):
            nb = next(it)
            _equal(nb, next(py))
            if ref is not None:
                _equal(nb, next(ref))
        it.close()
        assert nat._handle is None


@pytest.mark.parametrize("start", [0, 3, 4, 9])
def test_make_loader_native_resumes_like_the_python_path(start):
    """``make_loader(native=True, start_step=k)`` yields the batches k, k+1,
    ... of the Python path and of the reference's loader; no shuffle
    takes the rows in order."""
    a = _arrays()
    kw = dict(seed=2, start_step=start, process_index=1, num_processes=2)
    nat = tloader.make_loader(a, 16, native=True, **kw)
    py = tloader.make_loader(a, 16, **kw)
    ref = jloader.make_loader(a, 16, **kw)
    for _ in range(6):
        nb = next(nat)
        _equal(nb, next(py))
        _equal(nb, next(ref))
    nat.close()
    it = tloader.make_loader(a, 8, native=True, shuffle=False)
    _equal(next(it), {k: v[:8] for k, v in a.items()})
    it.close()


def test_make_loader_native_prefetches_and_closes(monkeypatch):
    """With ``prefetch`` the native batches come through the same
    PrefetchIterator as the Python path's, equal to them; closing the
    iterator ends the producer thread, which stops the C++ threads."""
    closed = []                  # the handles that close() released
    orig = native.NativeLoader.close

    def spy(self):
        handle = self._handle
        orig(self)
        if handle:
            closed.append(handle)

    monkeypatch.setattr(native.NativeLoader, "close", spy)
    a = _arrays()
    kw = dict(seed=3, start_step=2, prefetch=2)
    nat = tloader.make_loader(a, 16, native=True, **kw)
    py = tloader.make_loader(a, 16, **kw)
    assert isinstance(nat, tloader.PrefetchIterator)
    for _ in range(7):
        _equal(next(nat), next(py))
    nat.close()
    py.close()
    nat._thread.join(timeout=10)
    assert not nat._thread.is_alive()
    assert len(closed) == 1


def test_native_bypassed_by_a_transform_and_layout_errors():
    a = _arrays()

    def flip(batch, epoch, idx):
        return dict(batch, masked_weights=-batch["masked_weights"])

    it = tloader.make_loader(a, 16, native=True, transform=flip, seed=0)
    ref = tloader.ShardedLoader(a, 16, transform=flip, seed=0)
    _equal(next(it), next(iter(ref)))
    with pytest.raises(ValueError, match="empty"):
        native.NativeLoader({}, 4)
    with pytest.raises(ValueError, match="length mismatch"):
        native.NativeLoader({"x": np.zeros((8, 2)), "y": np.zeros(6)}, 4)
    with pytest.raises(ValueError, match="divisible"):
        native.NativeLoader(a, 16, num_processes=2, microbatches=3)
    with pytest.raises(ValueError, match="global_batch"):
        native.NativeLoader(a, 128)


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_explicit_native_raises_when_the_library_cannot_build(
        tmp_path, monkeypatch, cxx):
    """An unusable compiler: ``available()`` is False (the TFRecord readers
    take their Python paths), while ``--native`` raises with the
    compiler's failure instead of falling back."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "native" / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setenv("CXX", cxx)
    assert not native.available()
    with pytest.raises(RuntimeError, match="building the native loader"):
        native.require()
    with pytest.raises(RuntimeError, match="native loader is unavailable"):
        tloader.make_loader(_arrays(), 16, native=True)
    with pytest.raises(RuntimeError, match=cxx):
        tcli.main(["--model", "mlp", "--device", "cpu", "--native",
                   "--train_steps", "1", "--batch_size", "64"])


def _ckpt_arrays(d: str) -> dict:
    (path,) = glob.glob(os.path.join(d, "*-7.npz"))
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_cli_native_trains_to_the_python_loaders_params(tmp_path):
    """``cli.train --model mlp --native`` on IDX files ends, after 7 steps
    across an epoch boundary, on the Python loader's checkpoint bit for
    bit."""
    m = tmp_path / "mnist"
    m.mkdir()
    for img, lbl, n in (("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                         96), ("t10k-images-idx3-ubyte",
                               "t10k-labels-idx1-ubyte", 16)):
        ip, lp, _, _ = _write_idx(str(m), n=n, r=28, c=28, seed=n)
        os.rename(ip, m / img)
        os.rename(lp, m / lbl)
    out = {}
    for name, extra in (("native", ["--native"]), ("python", [])):
        ck = str(tmp_path / name)
        assert tcli.main(["--model", "mlp", "--device", "cpu", "--data_dir",
                          str(m), "--batch_size", "32", "--train_steps",
                          "7", "--ckpt_dir", ck, "--save_steps", "7",
                          "--log_every_steps", "7"] + extra) == 0
        out[name] = _ckpt_arrays(ck)
    _equal(out["native"], out["python"])
