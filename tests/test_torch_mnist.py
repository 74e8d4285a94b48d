"""The port's MNIST slice against the JAX package's, on the CPU: the IDX
readers and the synthetic set (bitwise), the classification losses and
the shared eval (1e-6), the MLP's init (moments and truncation: the RNG
streams are not matched), its logits and a 20-step SGD trajectory on
weights bridged through the npz checkpoint format, checkpoints that
cross between the packages, the CLI with ``--model mlp`` and the port's
copy of the example script, run as a subprocess as a user runs it.

Tolerances are stated per test. f32 differences come from summation
order only (XLA's CPU dot against torch's); SGD at lr 0.5 carries them
from step to step, which the trajectory's 1e-5 allows for.
"""

import gzip
import json
import os
import re
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.cli import train as jcli
from distributed_tensorflow_example_tpu.data import loader as jloader
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu.models import base as jbase
from distributed_tensorflow_example_tpu.models.mlp import MLP as JMLP
from distributed_tensorflow_example_tpu.ops import losses as jlosses
from distributed_tensorflow_example_tpu.ops import nn as jnn
from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.data import loader as tloader
from distributed_tensorflow_example_tpu_torch.data import mnist as tmnist
from distributed_tensorflow_example_tpu_torch.models import base as tbase
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.mlp import (
    MLP, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.ops import losses as tlosses
from distributed_tensorflow_example_tpu_torch.ops import nn as tnn
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = "distributed_tensorflow_example_tpu_torch.examples.mnist_distributed"
LR, BATCH = 0.5, 256


def _sgd(cfg_mod, lr=LR):
    return cfg_mod.OptimizerConfig(name="sgd", learning_rate=lr)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _write_idx(path, magic, dims, payload, gz):
    raw = struct.pack(">" + "I" * (1 + len(dims)), magic, *dims) + \
        payload.tobytes()
    if gz:
        with gzip.open(path + ".gz", "wb") as f:
            f.write(raw)
    else:
        with open(path, "wb") as f:
            f.write(raw)


def _fixture_dir(tmp_path, gz, n_train=12, n_test=5):
    rs = np.random.RandomState(7)
    d = str(tmp_path / ("gz" if gz else "plain"))
    os.makedirs(d)
    for img, lbl, n in (("train-images-idx3-ubyte",
                         "train-labels-idx1-ubyte", n_train),
                        ("t10k-images-idx3-ubyte",
                         "t10k-labels-idx1-ubyte", n_test)):
        _write_idx(os.path.join(d, img), 2051, (n, 28, 28),
                   rs.randint(0, 256, (n, 28, 28)).astype(np.uint8), gz)
        _write_idx(os.path.join(d, lbl), 2049, (n,),
                   rs.randint(0, 10, n).astype(np.uint8), gz)
    return d


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_idx_readers_match_reference(tmp_path, gz):
    """Fixture IDX files, plain and gzipped: the readers and load_mnist
    give the reference's arrays exactly; a bad magic number raises in
    both packages."""
    d = _fixture_dir(tmp_path, gz)
    img = os.path.join(d, "train-images-idx3-ubyte")
    lbl = os.path.join(d, "train-labels-idx1-ubyte")
    got, want = tmnist.read_idx_images(img), jmnist.read_idx_images(img)
    assert got.shape == (12, 28, 28) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tmnist.read_idx_labels(lbl),
                                  jmnist.read_idx_labels(lbl))
    got, want = tmnist.load_mnist(d), jmnist.load_mnist(d)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["train_x"].shape == (12, 784)
    for reader, path in ((tmnist.read_idx_images, lbl),
                         (jmnist.read_idx_images, lbl),
                         (tmnist.read_idx_labels, img),
                         (jmnist.read_idx_labels, img)):
        with pytest.raises(ValueError, match="bad IDX"):
            reader(path)


def test_synthetic_mnist_equals_reference_and_get_mnist_raises(tmp_path):
    for kw in ({}, dict(num_train=300, num_test=40, seed=5, noise=0.1)):
        got, want = tmnist.synthetic_mnist(**kw), jmnist.synthetic_mnist(**kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    syn = tmnist.get_mnist(None, num_train=64, num_test=8)
    assert np.array_equal(syn["train_x"],
                          jmnist.synthetic_mnist(64, 8)["train_x"])
    # a data_dir without the files raises in both: no silent synthetic
    for get in (tmnist.get_mnist, jmnist.get_mnist):
        with pytest.raises(FileNotFoundError):
            get(str(tmp_path))


# ---------------------------------------------------------------------------
# losses, eval and init
# ---------------------------------------------------------------------------

def _logits_labels(n=37, c=10, seed=0):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(n, c) * 3).astype(np.float32)
    labels = rs.randint(0, c, n).astype(np.int32)
    where = (rs.rand(n) > 0.3).astype(np.float32)
    return logits, labels, where


LOSS_CASES = [
    ("softmax_xent", dict()), ("softmax_xent", dict(where=True)),
    ("softmax_xent_int_labels", dict()),
    ("softmax_xent_int_labels", dict(where=True)),
    ("softmax_xent_int_labels", dict(label_smoothing=0.1)),
    ("softmax_xent_int_labels", dict(where=True, label_smoothing=0.2)),
    ("accuracy", dict()), ("accuracy", dict(where=True)),
]


@pytest.mark.parametrize("name,kw", LOSS_CASES,
                         ids=[f"{n}-{'-'.join(k) or 'plain'}"
                              for n, k in LOSS_CASES])
def test_classification_losses_match_reference(name, kw):
    """Each loss and metric, with and without ``where`` and label
    smoothing: within 1e-6 of the reference on the same f32 inputs."""
    logits, labels, where = _logits_labels()
    kw = dict(kw)
    w = where if kw.pop("where", False) else None
    if name == "softmax_xent":
        onehot = np.eye(10, dtype=np.float32)[labels]
        onehot = 0.9 * onehot + 0.01                # soft targets too
        want = jlosses.softmax_xent(jnp.asarray(logits), jnp.asarray(onehot),
                                    where=None if w is None
                                    else jnp.asarray(w))
        got = tlosses.softmax_xent(torch.from_numpy(logits),
                                   torch.from_numpy(onehot),
                                   where=None if w is None
                                   else torch.from_numpy(w))
    else:
        want = getattr(jlosses, name)(
            jnp.asarray(logits), jnp.asarray(labels),
            where=None if w is None else jnp.asarray(w), **kw)
        got = getattr(tlosses, name)(
            torch.from_numpy(logits), torch.from_numpy(labels),
            where=None if w is None else torch.from_numpy(w), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_l2_regularization_and_smoothing_bounds_match_reference():
    rs = np.random.RandomState(1)
    tree = {"fc1": {"kernel": rs.randn(20, 8).astype(np.float32),
                    "bias": rs.randn(8).astype(np.float32)},
            "fc2": {"kernel": rs.randn(8, 3).astype(np.float32)}}
    want = jlosses.l2_regularization(
        jax.tree_util.tree_map(jnp.asarray, tree), 1e-3)
    got = tlosses.l2_regularization(
        {k: {n: torch.from_numpy(a) for n, a in v.items()}
         for k, v in tree.items()}, 1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    logits, labels, _ = _logits_labels()
    for eps in (-0.1, 1.0):
        for mod, arr in ((tlosses, torch.from_numpy),
                         (jlosses, jnp.asarray)):
            with pytest.raises(ValueError, match="label_smoothing"):
                mod.softmax_xent_int_labels(arr(logits), arr(labels),
                                            label_smoothing=eps)


def test_classification_eval_metrics_honour_the_padded_tail():
    """A tail of 5 real rows padded to 8 with copies of its first row:
    the metrics over the mask equal the reference's (1e-6) and the
    metrics of the 5 rows alone; top-5 accuracy too."""
    logits, labels, _ = _logits_labels(n=5, c=10, seed=3)
    pad = lambda a: np.concatenate([a, np.repeat(a[:1], 3, axis=0)])
    valid = np.array([1] * 5 + [0] * 3, np.float32)
    lp, yp = pad(logits), pad(labels)
    want = jbase.classification_eval_metrics(
        jnp.asarray(lp), {"y": jnp.asarray(yp),
                          "__valid__": jnp.asarray(valid)}, top5=True)
    got = tbase.classification_eval_metrics(
        torch.from_numpy(lp), {"y": torch.from_numpy(yp),
                               "__valid__": torch.from_numpy(valid)},
        top5=True)
    alone = tbase.classification_eval_metrics(
        torch.from_numpy(logits), {"y": torch.from_numpy(labels)},
        top5=True)
    assert sorted(got) == sorted(want) == ["accuracy", "loss",
                                           "top5_accuracy"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), alone[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


#: std of a standard normal truncated to [-2, 2]
TRUNC_STD = 0.8796256610342398


def test_truncated_normal_init_moments_and_bound():
    """The MLP's default init: stddev 1/sqrt(fan_in) truncated at 2
    sigma. Over 78,400 draws the mean is within 4 standard errors of 0,
    the std within 1% of the truncated law's (and of the reference's
    draw), and no draw passes 2/sqrt(fan_in). ``glorot`` and ``he`` keep
    their laws."""
    gen = torch.Generator().manual_seed(0)
    k = tnn.dense_init(gen, 784, 100)["kernel"].numpy().astype(np.float64)
    want_std = TRUNC_STD / np.sqrt(784)
    assert abs(k.mean()) < 4 * want_std / np.sqrt(k.size)
    assert abs(k.std() / want_std - 1) < 0.01
    assert np.abs(k).max() <= 2 / np.sqrt(784)
    assert np.abs(k).max() > 1.9 / np.sqrt(784)        # reaches the tails
    ref = np.asarray(jnn.dense_init(jax.random.key(0), 784, 100)["kernel"])
    assert abs(k.std() / ref.std() - 1) < 0.01
    assert np.abs(ref).max() <= 2 / np.sqrt(784)
    g = tnn.dense_init(gen, 784, 100, init="glorot")["kernel"].numpy()
    assert np.abs(g).max() <= np.sqrt(6 / 884)
    h = tnn.dense_init(gen, 784, 100, init="he")["kernel"].numpy()
    assert abs(h.std() / np.sqrt(2 / 784) - 1) < 0.01
    with pytest.raises(ValueError, match="unknown init"):
        tnn.dense_init(gen, 4, 4, init="lecun")
    m = MLP().init(torch.Generator().manual_seed(3))
    assert tuple(m["fc1"]["kernel"].shape) == (784, 100)
    assert float(m["fc2"]["kernel"].abs().max()) <= 2 / np.sqrt(100)
    assert float(m["fc1"]["bias"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the MLP on bridged weights
# ---------------------------------------------------------------------------

def _bridged(seed=0, **kw):
    """(reference MLP, its params, port MLP, the same params bridged
    through the npz key layout)."""
    jm, tm = JMLP(**kw), MLP(**{k: v for k, v in kw.items()})
    jp = jm.init(jax.random.key(seed))
    flat = jckpt._flatten(jax.device_get(jp))
    return jm, jp, tm, params_from_numpy(tm, flat, "cpu")


def test_mlp_logits_match_reference_f32_and_bf16():
    """f32: logits within 1e-6 abs (logits of size ~0.5; measured
    1.5e-7) and equal argmax. bf16 compute on f32 params: within 1e-2
    abs, five bf16 ulps of the largest logit (2^-9 at 0.5). Both packages
    round x, the kernels and each dense output to bf16 and accumulate in
    f32, so only a different f32 summation order can flip a rounding;
    measured 0."""
    jm, jp, tm, tp = _bridged()
    x = tmnist.synthetic_mnist(64, 8)["train_x"]
    want, _ = jm.apply(jp, {}, {"x": jnp.asarray(x)})
    got, _ = tm.apply(tp, {}, {"x": torch.from_numpy(x)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (64, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert np.array_equal(got.numpy().argmax(1), np.asarray(want).argmax(1))
    jb = JMLP(dtype=jnp.bfloat16)
    tb = MLP(dtype=torch.bfloat16)
    want_b, _ = jb.apply(jp, {}, {"x": jnp.asarray(x)})
    got_b, _ = tb.apply(tp, {}, {"x": torch.from_numpy(x)})
    assert got_b.dtype == torch.float32
    err = float(np.abs(got_b.numpy() - np.asarray(want_b, np.float32)).max())
    assert err <= 1e-2, err
    # params_from_numpy refuses keys and shapes the model does not have
    flat = params_to_numpy(tp)
    with pytest.raises(ValueError, match="mismatch"):
        params_from_numpy(tm, {**flat, "fc3/kernel": flat["fc1/bias"]},
                          "cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(MLP(hidden=64), flat, "cpu")


def _ref_sync():
    """The reference's MLP, its SGD sync step on one CPU device and its
    initial state (seed 0)."""
    jm = JMLP()
    jsync = JSyncReplicas(jm.loss, jopt.make_optimizer(_sgd(jconfig)),
                          local_mesh(1))
    js = jsync.init(jm.init, seed=0)
    return jm, jsync, js


def test_sgd_trajectory_matches_reference_sync_replicas(tmp_path):
    """20 fp32 SGD steps at lr 0.5 on global batches of 256 from the same
    loader: the reference's ``SyncReplicas`` on one device against the
    port's, the reference's initial state bridged through its npz
    checkpoint (``restore_or_init``). Each step's loss within 1e-5
    relative (measured 1.5e-6), the final params within 1e-5 absolute
    (measured 8.9e-8), every step's accuracy equal."""
    data = tmnist.synthetic_mnist(2048, 64)
    arrays = {"x": data["train_x"], "y": data["train_y"]}
    jm, jsync, js = _ref_sync()
    d = str(tmp_path / "bridge")
    jckpt.CheckpointManager(d).save(js, 0)
    tm = MLP()
    tsync = SyncReplicas(tm.loss, topt.make_optimizer(_sgd(tconfig)),
                         device="cpu")
    ts, restored = tckpt.restore_or_init(tckpt.CheckpointManager(d),
                                         tsync.init, tm.init, seed=1)
    assert restored and ts.step == 0
    tb = tloader.make_loader(arrays, BATCH, shuffle=True, seed=0)
    jb = jloader.make_loader(arrays, BATCH, shuffle=True, seed=0)
    jl, tl = [], []
    for _ in range(20):
        b = next(tb)
        np.testing.assert_array_equal(b["x"], next(jb)["x"])
        js, jmet = jsync.step(js, jsync.shard_batch(b))
        ts, tmet = tsync.step(ts, b)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        assert float(tmet["accuracy"]) == float(jmet["accuracy"])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < 0.2 * tl[0]                      # it learns
    want = jckpt._flatten(jax.device_get(js.params))
    got = params_to_numpy(ts.params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert ts.step == int(js.step) == 20


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint of the reference's MLP state (after 3 SGD steps)
    restores in the port bit for bit, and the port's checkpoint of that
    state restores in the reference bit for bit; the eval metrics of
    both agree within 1e-6."""
    data = tmnist.synthetic_mnist(1024, 256)
    jm, jsync, js = _ref_sync()
    loader = jloader.make_loader({"x": data["train_x"],
                                  "y": data["train_y"]}, BATCH, seed=0)
    for _ in range(3):
        js, _ = jsync.step(js, jsync.shard_batch(next(loader)))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.CheckpointManager(jdir).save(js)
    tm = MLP()
    tsync = SyncReplicas(tm.loss, topt.make_optimizer(_sgd(tconfig)),
                         device="cpu")
    on_port = tckpt.CheckpointManager(jdir).restore(tsync.init(tm.init))
    assert on_port.step == 3
    want = jckpt._flatten(jax.device_get(js.params))
    for k, v in params_to_numpy(on_port.params).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    tckpt.CheckpointManager(tdir).save(on_port)
    back = jckpt.CheckpointManager(tdir).restore(jsync.init(jm.init, seed=9))
    assert int(back.step) == 3
    got = jckpt._flatten(jax.device_get(back.params))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    test = {"x": data["test_x"], "y": data["test_y"]}
    jev = jm.eval_metrics(back.params, {}, jax.tree_util.tree_map(
        jnp.asarray, test))
    tev = tm.eval_metrics(on_port.params, {}, {k: torch.from_numpy(v)
                                              for k, v in test.items()})
    for k in jev:
        np.testing.assert_allclose(float(tev[k]), float(jev[k]), rtol=1e-6,
                                   err_msg=k)


def test_registry_builds_the_mlp_with_its_dtypes():
    m = get_model("mlp", tconfig.TrainConfig(model="mlp", dtype="bfloat16",
                                             param_dtype="bfloat16"))
    assert isinstance(m, MLP)
    assert m.dtype == torch.bfloat16 and m.param_dtype == torch.bfloat16
    p = m.init(torch.Generator().manual_seed(0))
    assert p["fc1"]["kernel"].dtype == torch.bfloat16
    batch = {k: torch.from_numpy(v) for k, v in m.dummy_batch(4).items()}
    loss, (aux, extras) = m.loss(p, {}, batch)
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    assert set(aux) == {"accuracy"} and extras == {}


# ---------------------------------------------------------------------------
# the CLI and the example
# ---------------------------------------------------------------------------

def test_cli_mlp_trains_writes_the_ring_and_resumes(tmp_path):
    """``cli.train --model mlp --device cpu``: 100 SGD steps at lr 0.5
    with a checkpoint every 50 in a ring of 2, then a resume to 150; the
    final eval accuracy is at least 0.95, the reference example's bar."""
    ck, m = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    argv = ["--model", "mlp", "--device", "cpu", "--batch_size", "256",
            "--learning_rate", "0.5", "--ckpt_dir", ck, "--save_steps", "50",
            "--max_to_keep", "2", "--log_every_steps", "50",
            "--metrics_path", m]
    assert tcli.main(argv + ["--train_steps", "100",
                             "--eval_every_steps", "100"]) == 0
    assert tckpt.CheckpointManager(ck).all_steps() == [50, 100]
    assert tcli.main(argv + ["--train_steps", "150", "--sync_mode",
                             "shard_map", "--mesh", "data=1",
                             "--eval_every_steps", "150"]) == 0
    assert tckpt.CheckpointManager(ck).all_steps() == [100, 150]
    with open(m) as f:
        recs = [json.loads(line) for line in f]
    starts = [r["start_step"] for r in recs if "start_step" in r]
    assert starts == [0, 100]
    evals = {r["step"]: r["eval"] for r in recs if "eval" in r}
    assert sorted(evals) == [100, 150]
    assert evals[150]["accuracy"] >= 0.95, evals
    assert any("examples_per_sec" in r for r in recs)


def test_cli_load_dataset_reads_mnist(tmp_path):
    """``--dataset mnist`` (or the MLP's default) loads the reference's
    synthetic MNIST, or the IDX files under ``--data_dir``, as the
    reference's ``load_dataset`` does."""
    d = _fixture_dir(tmp_path, gz=True)
    for name, data_dir in (("mlp", None), ("mnist", None), ("mnist", d)):
        cfg = tconfig.TrainConfig(model="mlp", data=tconfig.DataConfig(
            dataset=name, data_dir=data_dir))
        jcfg = jconfig.TrainConfig(model="mlp", data=jconfig.DataConfig(
            dataset=name, data_dir=data_dir))
        got, want = tcli.load_dataset(cfg), jcli.load_dataset(jcfg)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["x", "y"]
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_example_and_cli_raise_without_a_card(tmp_path, monkeypatch):
    """No fallback hides the device: without CUDA the example raises and
    the CLI exits before any work, unless ``--device cpu`` is given."""
    from distributed_tensorflow_example_tpu_torch.examples import \
        mnist_distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mnist_distributed.main(["--train_steps", "1", "--ckpt_dir", ck])
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli.main(["--model", "mlp", "--train_steps", "1", "--ckpt_dir",
                   ck])
    assert not os.path.exists(ck)


def _run_example(args, timeout=180):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    return subprocess.run([sys.executable, "-m", EXAMPLE, "--device", "cpu",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_example_worker_trains_saves_and_resumes(tmp_path):
    """The mirror of ``tests/test_example_script.py::
    test_worker_trains_saves_and_resumes`` on the port's copy."""
    ckpt = str(tmp_path / "ckpt")
    r = _run_example(["--train_steps", "120", "--log_every_steps", "60",
                      "--batch_size", "256", "--ckpt_dir", ckpt])
    assert r.returncode == 0, r.stdout + r.stderr
    assert re.search(r"^step 120: loss=[\d.]+ \([\d.]+ steps/s\)$",
                     r.stdout, re.M), r.stdout
    m = re.search(r"final test accuracy: ([\d.]+)", r.stdout)
    assert m and float(m.group(1)) >= 0.95, r.stdout
    assert any(f.startswith("ckpt-120") for f in os.listdir(ckpt))

    r2 = _run_example(["--train_steps", "180", "--log_every_steps", "60",
                       "--batch_size", "256", "--ckpt_dir", ckpt])
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "restored checkpoint at step 120" in r2.stdout
    assert "step 180" in r2.stdout and "step 120:" not in r2.stdout


def test_example_ps_branch_exits_zero_with_notice():
    r = _run_example(["--job_name", "ps", "--task_index", "0",
                      "--ps_hosts", "ps0:2222", "--worker_hosts", "w0:2222"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "No PS role on the card" in r.stdout + r.stderr
    assert "final test accuracy" not in r.stdout
