"""The port's BERT masked LM against the JAX package's, on the CPU: the
MLM data, the model's forward, loss, accuracy and every gradient on
bridged weights, ``remat``, LAMB steps, checkpoints both ways and the
training CLI.

Weights are initialised by the JAX package and cross as numpy arrays
keyed as its checkpoint keys them. Batches are the reference's synthetic
corpus cut to random lengths with trailing PAD, one row all PAD (no
predictions, every key masked), masked by each package's own
``apply_mlm_masking`` (whose arrays are asserted equal first). f32
throughout; tolerances are stated per test, f32 differences coming from
summation order only.
"""

import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.data import bert_data as jdata
from distributed_tensorflow_example_tpu.models.bert import Bert as JBert
from distributed_tensorflow_example_tpu.models.bert import \
    BertConfig as JBertConfig
from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.data import bert_data as tdata
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.bert import (
    Bert, BertConfig, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from distributed_tensorflow_example_tpu_torch.utils.pytree import (
    flatten_dict, unflatten_dict)

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

TINY = dict(vocab_size=1000, hidden=128, layers=2, heads=4,
            intermediate=256, max_len=128, max_predictions=8)
#: 2 heads of 64 at S = 128: the JAX package's Pallas flash kernels
#: engage (interpret mode on the CPU) instead of its XLA fallback
HEADS64 = dict(TINY, heads=2)
F32_TOL = 1e-4


def padded_seqs(n=6, s=64, vocab=1000, seed=0) -> np.ndarray:
    """The reference's synthetic corpus, each row cut to a random length
    with trailing PAD, the last row all PAD."""
    seqs = jdata.synthetic_corpus(n, s, vocab, seed)
    lens = np.random.RandomState(seed + 50).randint(s // 4, s + 1, n)
    lens[-1] = 0
    for i, n_tok in enumerate(lens):
        seqs[i, n_tok:] = jdata.PAD
    return seqs


def mlm_batch(n=6, s=64, max_predictions=8, seed=0) -> dict:
    return jdata.apply_mlm_masking(padded_seqs(n, s, seed=seed),
                                   vocab_size=TINY["vocab_size"],
                                   max_predictions=max_predictions,
                                   seed=seed + 2)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def make_pair(cfg=TINY, attention_impl="xla", lm_loss_impl="full",
              dropout=0.0, remat="none", seed=0):
    """The same BERT in both packages, same weights (the port's through
    the numpy bridge)."""
    jm = JBert(JBertConfig(**cfg, dropout=dropout, lm_loss_impl=lm_loss_impl),
               attention_impl=attention_impl)
    jp = jm.init(jax.random.key(seed))
    tm = Bert(BertConfig(**cfg, dropout=dropout, lm_loss_impl=lm_loss_impl),
              attention_impl=attention_impl, remat=remat)
    return jm, jp, tm, params_from_numpy(tm, jckpt._flatten(jp),
                                         device="cpu")


def value_and_grad(tm, tp, batch, gen=None):
    flat = {k: v.detach().requires_grad_() for k, v in
            flatten_dict(tp).items()}
    loss, (aux, _) = tm.loss(unflatten_dict(flat), {}, _torch(batch), gen)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), aux, dict(zip(flat, grads))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_prob,max_pred", [(0.15, 8), (0.4, 20)])
def test_mlm_masking_equals_reference(mask_prob, max_pred):
    """``apply_mlm_masking`` on padded rows (an all-PAD row among them):
    every array equal to the reference's, bit for bit; the all-PAD row
    has no predictions and no valid key."""
    seqs = padded_seqs(8, 48)
    kw = dict(vocab_size=1000, max_predictions=max_pred,
              mask_prob=mask_prob, seed=5)
    want = jdata.apply_mlm_masking(seqs, **kw)
    got = tdata.apply_mlm_masking(seqs, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert not got["masked_weights"][-1].any()
    assert not got["attention_mask"][-1].any()


@pytest.mark.parametrize("files", ["train_test", "tokens", "synthetic"])
def test_get_bert_data_equals_reference(tmp_path, files):
    """``get_bert_data`` from ``train.npy``/``test.npy`` with trailing
    PAD (truncated to seq_len), from one ``tokens.npy`` (split 95/5), and
    from the synthetic corpus: train and eval arrays equal to the
    reference's."""
    seqs = padded_seqs(40, 64)
    if files == "train_test":
        np.save(tmp_path / "train.npy", seqs[:32])
        np.save(tmp_path / "test.npy", seqs[32:])
    elif files == "tokens":
        np.save(tmp_path / "tokens.npy", seqs)
    kw = dict(vocab_size=1000, seq_len=48, max_predictions=8,
              mask_prob=0.15, num_train=32, num_test=8,
              synthetic=files == "synthetic")
    d = None if files == "synthetic" else str(tmp_path)
    for got, want in zip(tdata.get_bert_data(d, **kw),
                         jdata.get_bert_data(d, **kw)):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["input_ids"].shape[1] == 48


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def test_bridge_keys_shapes_and_registry():
    """Every reference key and shape is the port's; the bridge round-trips
    bit for bit; the registry's presets are the reference's."""
    jm, jp, tm, tp = make_pair()
    flat = jckpt._flatten(jp)
    assert {k: v.shape for k, v in flat.items()} == tm.param_shapes()
    back = params_to_numpy(tp)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tm, {k: v for k, v in flat.items()
                               if k != "mlm/bias"}, device="cpu")
    for name in ("bert", "bert_large", "bert_tiny"):
        cfg = get_model(name).cfg
        from distributed_tensorflow_example_tpu.models import get_model as jg
        want = jg(name).cfg
        for f in ("vocab_size", "hidden", "layers", "heads", "intermediate",
                  "max_len", "max_predictions", "dropout"):
            assert getattr(cfg, f) == getattr(want, f), (name, f)


@pytest.mark.parametrize("cfg,impl,loss_impl", [
    ("tiny", "xla", "full"), ("tiny", "flash", "full"),
    ("tiny", "xla", "fused"), ("heads64", "flash", "full")])
def test_forward_loss_and_every_grad_match_reference(cfg, impl, loss_impl):
    """``encode``, ``mlm_logits``, the loss, ``mlm_accuracy`` and the
    gradient of every parameter (the tied word table, which takes both
    the embedding's and the MLM decoder's gradient, named) against the
    reference, f32, trailing pads and an all-PAD row, no dropout. The
    port's flash path runs its autograd Function's plain versions; the
    reference's its Pallas kernels in interpret mode at 2 heads of 64
    and S = 128 (its XLA fallback at 4 heads of 32). Forward and loss
    within 1e-4; grads within rtol 1e-4 / atol 1e-6 (the attention's key
    biases have a zero gradient by the softmax's shift invariance, so
    theirs is rounding noise in both packages)."""
    shape = TINY if cfg == "tiny" else HEADS64
    s = 64 if cfg == "tiny" else 128
    jm, jp, tm, tp = make_pair(shape, impl, loss_impl)
    batch = mlm_batch(s=s)
    jb, tb = _jax(batch), _torch(batch)
    with torch.no_grad():
        seq = tm.encode(tp, tb)
        logits = tm.mlm_logits(tp, seq, tb["masked_positions"])
    jseq = jm.encode(jp, jb)
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jm.mlm_logits(jp, jseq,
                                                 jb["masked_positions"])),
        rtol=F32_TOL, atol=F32_TOL)
    assert np.isfinite(seq.numpy()).all()
    (jl, (jaux, _)), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {}, jb, None)
    tl, taux, tg = value_and_grad(tm, tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL)
    np.testing.assert_allclose(float(taux["mlm_accuracy"]),
                               float(jaux["mlm_accuracy"]), atol=F32_TOL)
    jg = jckpt._flatten(jg)
    assert sorted(jg) == sorted(tg)
    assert "embed/word/table" in tg
    for k, g in tg.items():
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   rtol=F32_TOL, atol=1e-6, err_msg=k)


def test_eval_metrics_and_valid_rows_match_reference():
    jm, jp, tm, tp = make_pair()
    batch = mlm_batch(seed=3)
    batch["__valid__"] = np.array([1, 1, 1, 0, 1, 1], np.int32)
    want = jm.eval_metrics(jp, {}, _jax(batch))
    got = tm.eval_metrics(tp, {}, _torch(batch))
    assert sorted(got) == sorted(want) == ["loss", "mlm_accuracy"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=F32_TOL, err_msg=k)


@pytest.mark.parametrize("model", ["bert", "gpt"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_none_with_dropout(model, remat):
    """With dropout 0.1 and one generator seed, ``remat`` "full" and
    "dots" recompute each layer with the masks it drew the first time:
    the loss is bitwise the one without remat, and every gradient equal
    up to f32 summation order (within 1e-6 of the leaf's largest
    gradient; measured: bitwise but for the type table, 2.4e-7)."""
    cfg = tconfig.TrainConfig(model=f"{model}_tiny", remat=remat)
    runs = {}
    for r in ("none", remat):
        m = get_model(f"{model}_tiny", cfg.replace(remat=r))
        p = m.init(0, device="cpu")
        batch = (mlm_batch(s=32) if model == "bert" else
                 {"input_ids": padded_seqs(4, 32), "attention_mask":
                  (padded_seqs(4, 32) != 0).astype(np.int32)})
        runs[r] = value_and_grad(m, p, batch, torch.Generator().manual_seed(9))
    (l0, _, g0), (l1, _, g1) = runs["none"], runs[remat]
    assert torch.equal(l0, l1)
    for k in g0:
        tol = 1e-6 * float(g0[k].abs().max())
        assert float((g0[k] - g1[k]).abs().max()) <= tol, k
    # dropout is on: another seed draws other masks
    m = get_model(f"{model}_tiny", cfg)
    other = value_and_grad(m, m.init(0, device="cpu"), batch,
                           torch.Generator().manual_seed(10))[0]
    assert not torch.equal(other, l0)


# ---------------------------------------------------------------------------
# training: LAMB, checkpoints, the CLI
# ---------------------------------------------------------------------------

LAMB = dict(name="lamb", learning_rate=1e-3, weight_decay=0.01)


def _lamb_pair(wd_mask: str):
    jm, jp, tm, tp = make_pair()
    opt = dict(LAMB, wd_mask=wd_mask)
    jsync = JSyncReplicas(jm.loss, jopt.make_optimizer(
        jconfig.OptimizerConfig(**opt)), local_mesh(1), donate=False)
    tsync = SyncReplicas(tm.loss, topt.make_optimizer(
        tconfig.OptimizerConfig(**opt)), device="cpu")
    return (jsync, jsync.init(lambda rng: jp, seed=0), tsync,
            tsync.init(lambda gen: tp, seed=0))


# LAMB is Adam's update scaled per leaf by ||p|| / ||u||: an element whose
# gradient is ~0 is divided by its own tiny RMS, so a rounding difference
# between the packages moves it by up to a fraction of a step; params are
# held to a tenth of the lr elementwise (measured: 1.2e-6 at lr 1e-3). The
# attention's key biases have a zero gradient up to rounding in both
# packages, which Adam turns into moves of up to an lr a step in either
# direction: held to 2 lr a step.
def _assert_params_close(tstate, jstate, steps, lr):
    want = jckpt._flatten(jax.device_get(jstate.params))
    got = params_to_numpy(tstate.params)
    assert sorted(got) == sorted(want)
    for k in want:
        atol = 2 * lr * steps if k.endswith("attn/k/bias") else 0.1 * lr
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("wd_mask", ["exclude_1d", "all"])
def test_lamb_trajectory_matches_reference(wd_mask):
    """5 LAMB steps (eps 1e-6, decay 0.01 under the mask, the trust
    ratio on every leaf) of BERT-tiny through the sync step in both
    packages, no dropout: loss and accuracy within 1e-5 each step, the
    params as :func:`_assert_params_close` holds them."""
    jsync, js, tsync, ts = _lamb_pair(wd_mask)
    for step in range(5):
        batch = mlm_batch(seed=step)
        js, jmet = jsync.step(js, jsync.shard_batch(_jax(batch)))
        ts, tmet = tsync.step(ts, batch)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["mlm_accuracy"]),
                                   float(jmet["mlm_accuracy"]), atol=1e-5)
        _assert_params_close(ts, js, step + 1, LAMB["learning_rate"])


def test_checkpoints_cross_both_ways(tmp_path):
    """A reference checkpoint of BERT-tiny after one LAMB step restores
    into the port (params and the whole optimizer state), and the port's
    next step equals the reference's; the port's checkpoint of that step
    restores into the reference with every key and value."""
    jsync, js, tsync, ts = _lamb_pair("exclude_1d")
    js, _ = jsync.step(js, jsync.shard_batch(_jax(mlm_batch(seed=0))))
    jckpt.CheckpointManager(str(tmp_path / "ref")).save(js, 1)
    ts, restored = tckpt.restore_or_init(
        tckpt.CheckpointManager(str(tmp_path / "ref")), tsync.init,
        lambda gen: ts.params, seed=3)
    assert restored and ts.step == 1
    batch = mlm_batch(seed=1)
    js, jmet = jsync.step(js, jsync.shard_batch(_jax(batch)))
    ts, tmet = tsync.step(ts, batch)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    _assert_params_close(ts, js, 2, LAMB["learning_rate"])
    tckpt.CheckpointManager(str(tmp_path / "port")).save(ts)
    back = jckpt.CheckpointManager(str(tmp_path / "port")).restore(js)
    assert int(back.step) == 2
    want = jckpt._flatten(jax.device_get(
        {"params": back.params, "opt_state": back.opt_state}))
    got = tckpt.state_arrays(ts)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(v), got[k], err_msg=k)


class _Tap(logging.Handler):
    """Collects the port's log lines (its ``dtx`` logger does not
    propagate to the root logger)."""

    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_cli_bert_tiny_ring_resume_and_levers(tmp_path):
    """``cli.train --model bert_tiny --device cpu`` with LAMB, the flash
    path, the fused head and ``--remat dots``: 6 steps with a checkpoint
    every 3 in a ring of 2, then a resume to 9; the logged loss falls and
    the final eval reports the MLM accuracy."""
    ck = str(tmp_path / "ck")

    def argv(steps):
        return ["--model", "bert_tiny", "--device", "cpu", "--batch_size",
                "8", "--seq_len", "64", "--optimizer", "lamb",
                "--learning_rate", "1e-2", "--attention", "flash",
                "--lm_loss_impl", "fused", "--remat", "dots",
                "--train_steps", str(steps), "--log_every_steps", "3",
                "--ckpt_dir", ck, "--save_steps", "3", "--max_to_keep", "2"]
    tap = _Tap()
    logging.getLogger("dtx").addHandler(tap)
    try:
        assert tcli.main(argv(6)) == 0
        assert tckpt.CheckpointManager(ck).all_steps() == [3, 6]
        assert tcli.main(argv(9)) == 0
        assert tckpt.CheckpointManager(ck).all_steps() == [6, 9]
    finally:
        logging.getLogger("dtx").removeHandler(tap)
    text = "\n".join(tap.lines)
    losses = [float(x) for x in re.findall(r"step \d+: loss=([0-9.]+)", text)]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    assert "restored checkpoint at step 6" in text
    assert re.search(r"final eval: .*'mlm_accuracy'", text)


@pytest.mark.parametrize("extra,frag", [
    (["--lm_loss_chunk", "8"], "causal-LM knob"),
    (["--lm_loss_impl", "chunked"], "needs lm_loss_chunk"),
    (["--token_accuracy_every_n", "2"], "causal-LM knob"),
    (["--seq_len", "4096", "--model", "bert_tiny"], None),
])
def test_cli_bert_refusals(tmp_path, extra, frag):
    """What the port refuses for BERT, and where: the chunked head's
    chunk and the accuracy cadence are the causal LM's (the reference's messages); a sequence past bert_tiny's
    positions grows its table (as the reference's factory does), so it
    trains."""
    argv = ["--model", "bert_tiny", "--device", "cpu", "--train_steps",
            "1", "--batch_size", "2"] + extra
    if frag is None:
        assert get_model("bert_tiny", tcli.config_from_args(
            tcli.build_parser().parse_args(argv))).cfg.max_len == 4096
        return
    with pytest.raises(SystemExit, match=frag):
        tcli.main(argv)


def test_cli_vocab_txt_corpus_names_its_slice(tmp_path):
    """A vocab.txt directory is a raw-text corpus (data/bert_text.py,
    tests/test_torch_bert_text.py): one past the model's vocab stops the
    run before anything is tokenized; tokens.npy beside it wins."""
    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[CLS]"] + ["w"] * 1000))
    with pytest.raises(SystemExit, match="vocab.txt has 1002 tokens"):
        tcli.main(["--model", "bert_tiny", "--device", "cpu",
                   "--train_steps", "1", "--data_dir", str(tmp_path)])
    np.save(tmp_path / "tokens.npy", padded_seqs(20, 32))
    assert tcli.main(["--model", "bert_tiny", "--device", "cpu",
                      "--train_steps", "2", "--batch_size", "4",
                      "--seq_len", "32", "--data_dir", str(tmp_path),
                      "--optimizer", "lars", "--learning_rate", "1.0"]) == 0
