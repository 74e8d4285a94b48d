"""The port's training entry point against the JAX package's, on the
CPU: the LM data and the loader (bitwise), the checkpoint ring (its rules
and checkpoints that cross between the packages, bitwise), the
``Trainer`` with the fused flash backward (f32, dropout off), exact
resume with dropout on, and ``cli/train.py`` (runs, refusals, the
generator export served by the port's ``PredictServer``).

Tolerances are stated per test; f32 differences come from summation
order only.
"""

import json
import os
import shutil
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.cli import train as jcli
from distributed_tensorflow_example_tpu.data import bert_data as jdata
from distributed_tensorflow_example_tpu.data import loader as jloader
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import hooks as jhooks
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu.train.trainer import \
    Trainer as JTrainer
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.data import bert_data as tdata
from distributed_tensorflow_example_tpu_torch.data import loader as tloader
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer
from distributed_tensorflow_example_tpu_torch.train import hooks as thooks
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

#: the Trainer-parity GPT: 2 heads of 64, so the reference's Pallas flash
#: kernels engage at S = 128 (interpret mode on the CPU)
PARITY = dict(vocab_size=1000, hidden=128, layers=2, heads=2,
              intermediate=256, max_len=128, dropout=0.0)
ADAMW = dict(name="adamw", learning_rate=1e-3, weight_decay=0.01,
             wd_mask="exclude_1d", grad_clip_norm=1.0, warmup_steps=1,
             decay_schedule="cosine", total_steps=4)


def _np_tree(arrays):
    return {k: np.asarray(v) for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# data and loader
# ---------------------------------------------------------------------------

def test_get_lm_data_matches_reference_bitwise(tmp_path):
    """The synthetic corpus, and pre-tokenized train.npy/test.npy
    truncated to seq_len, give the reference's arrays bit for bit."""
    kw = dict(vocab_size=1000, seq_len=48, num_train=40, num_test=8,
              seed=3)
    for got, want in zip(tdata.get_lm_data(None, **kw),
                         jdata.get_lm_data(None, **kw)):
        assert sorted(got) == sorted(want) == ["attention_mask",
                                               "input_ids"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 50, (10, 64)).astype(np.int64)
    np.save(tmp_path / "train.npy", toks[:8])
    np.save(tmp_path / "test.npy", toks[8:])
    for got, want in zip(tdata.get_lm_data(str(tmp_path), seq_len=32),
                         jdata.get_lm_data(str(tmp_path), seq_len=32)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(FileNotFoundError):
        tdata.load_tokenized(str(tmp_path / "nothing"))


@pytest.mark.parametrize("start_step", [0, 5, 23])
def test_sharded_loader_matches_reference_bitwise(start_step):
    """Batches over several epochs (7 batches an epoch, shuffled), from a
    fast-forwarded start, for both processes of a two-process run and
    for one process, with and without prefetch: the reference's, bit for
    bit."""
    rs = np.random.RandomState(1)
    arrays = {"input_ids": rs.randint(0, 9, (30, 5)).astype(np.int32),
              "attention_mask": rs.randint(0, 2, (30, 5)).astype(np.int32)}
    for procs, prefetch in ((1, 0), (2, 0), (2, 2)):
        for p in range(procs):
            kw = dict(start_step=start_step, process_index=p,
                      num_processes=procs, shuffle=True, seed=7,
                      prefetch=prefetch)
            got = tloader.make_loader(arrays, 4, **kw)
            want = jloader.make_loader(arrays, 4, **kw)
            for _ in range(16):
                g, w = next(got), next(want)
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
            for it in (got, want):
                if hasattr(it, "close"):
                    it.close()


# ---------------------------------------------------------------------------
# the checkpoint ring
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=64, hidden=32, layers=1, heads=2, intermediate=64,
            max_len=32, dropout=0.0)


def _port_state(steps=2, seed=0):
    """A tiny GPT's TrainState after ``steps`` AdamW steps (non-zero Adam
    moments and counts)."""
    m = GPT(GPTConfig(**TINY))
    sync = SyncReplicas(m.loss, topt.make_optimizer(
        tconfig.OptimizerConfig(**ADAMW)), device="cpu")
    state = sync.init(m.init, seed=seed)
    ids = np.random.RandomState(seed).randint(0, 64, (2, 16)).astype(
        np.int32)
    for _ in range(steps):
        state, _ = sync.step(state, {"input_ids": ids})
    return sync, state


def test_ring_keeps_max_to_keep_and_skips_corrupt_files(tmp_path):
    """``max_to_keep`` rotates the oldest file out; a truncated newest npz
    is skipped by ``latest_valid_step`` and by ``restore`` (which
    restores the previous step); when every candidate is corrupt,
    ``restore`` raises CorruptCheckpointError."""
    sync, state = _port_state(steps=1)
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(state.replace(step=step))
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["checkpoint", "ckpt-2.npz",
                                            "ckpt-3.npz"]
    with open(tmp_path / "checkpoint") as f:
        st = json.load(f)
    assert st["latest"] == "ckpt-3.npz"
    assert st["all_model_checkpoint_paths"] == ["ckpt-2.npz", "ckpt-3.npz"]
    p3 = mgr.checkpoint_path(3)
    size = os.path.getsize(p3)
    with open(p3, "r+b") as f:
        f.truncate(int(size * 0.6))
    with pytest.raises(tckpt.CorruptCheckpointError):
        mgr.verify_step(3)
    assert mgr.latest_valid_step() == 2
    template = sync.init(GPT(GPTConfig(**TINY)).init, seed=5)
    restored = mgr.restore(template)
    assert restored.step == 2
    with pytest.raises(tckpt.CorruptCheckpointError):
        mgr.restore(template, step=3)
    p2 = mgr.checkpoint_path(2)
    with open(p2, "r+b") as f:
        f.seek(os.path.getsize(p2) // 3)
        f.write(b"\0" * 4096)
    assert mgr.latest_valid_step() is None
    with pytest.raises(tckpt.CorruptCheckpointError, match="every"):
        mgr.restore(template)
    with pytest.raises(NotImplementedError, match="A6"):
        tckpt.CheckpointManager(str(tmp_path), sharded=True)


def _jax_state(steps=2, seed=0):
    """The reference's TrainState of the same tiny GPT after ``steps``
    AdamW steps."""
    m = JGPT(JGPTConfig(**TINY))
    sync = JSyncReplicas(m.loss, jopt.make_optimizer(
        jconfig.OptimizerConfig(**ADAMW)), local_mesh(1), donate=False)
    state = sync.init(m.init, seed=seed)
    ids = np.random.RandomState(seed).randint(0, 64, (2, 16)).astype(
        np.int32)
    for _ in range(steps):
        state, _ = sync.step(state, sync.shard_batch(
            {"input_ids": jnp.asarray(ids)}))
    return sync, state


def test_checkpoints_cross_between_the_packages_bitwise(tmp_path):
    """A TrainState written by the reference's CheckpointManager restores
    in the port's, and one written by the port's restores in the
    reference's: params, both Adam moments, the optimizer counts, step
    and anomaly_count, bit for bit."""
    jsync, jstate = _jax_state()
    jdir, tdir = str(tmp_path / "from_jax"), str(tmp_path / "from_port")
    jckpt.CheckpointManager(jdir).save(jstate)
    tsync, _ = _port_state(steps=0, seed=9)
    template = tsync.init(GPT(GPTConfig(**TINY)).init, seed=9)
    got = tckpt.CheckpointManager(jdir).restore(template)
    want = jckpt._flatten(jax.device_get(jstate))
    have = tckpt.state_arrays(got)
    assert got.step == int(jstate.step) == 2
    keys = sorted(k for k in want if not k.startswith("__prng"))
    assert sorted(k for k in have if not k.startswith("__prng")) == keys
    assert any("/mu/" in k for k in keys) and any("/nu/" in k for k in keys)
    for k in keys:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)

    _, tstate = _port_state(steps=2, seed=4)
    tckpt.CheckpointManager(tdir).save(tstate)
    jtemplate = jsync.init(JGPT(JGPTConfig(**TINY)).init, seed=4)
    back = jckpt.CheckpointManager(tdir).restore(jtemplate)
    want = tckpt.state_arrays(tstate)
    have = jckpt._flatten(jax.device_get(back))
    assert int(back.step) == 2
    for k in keys:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Trainer parity, fused flash backward
# ---------------------------------------------------------------------------

class _JRecord(jhooks.Hook):
    every_steps = 1

    def __init__(self):
        self.losses = []

    def after_step(self, trainer, step, metrics):
        self.losses.append(float(metrics["loss"]))


class _TRecord(thooks.Hook):
    every_steps = 1

    def __init__(self):
        self.losses = []

    def after_step(self, trainer, step, metrics):
        self.losses.append(float(metrics["loss"]))


def _train_cfg(pkg, ckpt_dir):
    return pkg.TrainConfig(
        model="gpt", train_steps=4, seed=0,
        attention_impl="flash", attention_bwd="fused",
        data=pkg.DataConfig(batch_size=4, seq_len=128, seed=0),
        optimizer=pkg.OptimizerConfig(**ADAMW),
        checkpoint=pkg.CheckpointConfig(directory=ckpt_dir, save_steps=2),
        obs=pkg.ObservabilityConfig(log_every_steps=1))


def test_trainer_parity_with_the_fused_backward(tmp_path):
    """Both Trainers start from one checkpoint the reference wrote and
    take 4 AdamW steps on the same batches, every layer's attention
    through the flash forward and the fused backward (the reference's
    Pallas kernels in interpret mode; the port's plain versions): the
    per-step losses within 1e-5 relative, the final params within the
    Adam tolerance of ``tests/test_torch_train.py`` (a tenth of the lr
    elementwise, at most 0.1% of a leaf's elements beyond 2e-6, the key
    biases, whose gradient is rounding only, within one lr a step), the
    two final evals within 1e-5, and the reference's ``evaluate`` on the
    port's final checkpoint within 1e-5 of the port's eval."""
    kw = dict(vocab_size=1000, seq_len=128, num_train=24, num_test=6)
    jtrain, jeval = jdata.get_lm_data(None, **kw)
    ttrain, teval = tdata.get_lm_data(None, **kw)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm = JGPT(JGPTConfig(**PARITY), attention_impl="flash",
              attention_kwargs={"bwd_variant": "fused"})
    jcfg = _train_cfg(jconfig, jdir)
    jrec = _JRecord()
    jtr = JTrainer(jm, jcfg, jtrain, jeval, mesh=local_mesh(1),
                   hooks=[jrec], process_index=0, num_processes=1)
    jckpt.CheckpointManager(jdir).save(jtr.sync.init(jm.init, seed=0), 0)
    shutil.copytree(jdir, tdir)

    tm = GPT(GPTConfig(**PARITY), attention_impl="flash",
             attention_kwargs={"bwd_variant": "fused"})
    trec = _TRecord()
    ttr = Trainer(tm, _train_cfg(tconfig, tdir), ttrain, teval,
                  hooks=[trec], device="cpu")
    with ttr:
        tstate, tsum = ttr.train()
    with jtr:
        jstate, jsum = jtr.train()
    assert ttr.start_step == jtr.start_step == 0
    assert len(trec.losses) == len(jrec.losses) == 4
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-5)
    assert tstate.step == int(jstate.step) == 4

    lr = ADAMW["learning_rate"]
    want = jckpt._flatten(jax.device_get(jstate.params))
    got = params_to_numpy(tstate.params)
    assert sorted(got) == sorted(want)
    for k in want:
        atol = 4 * lr if k.endswith("attn/k/bias") else 0.1 * lr
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)
        if not k.endswith("attn/k/bias"):
            assert float(np.mean(np.abs(got[k] - want[k]) > 2e-6)) <= 1e-3
    for k in jsum["eval"]:
        np.testing.assert_allclose(tsum["eval"][k], jsum["eval"][k],
                                   rtol=1e-5, err_msg=k)
    assert tckpt.CheckpointManager(tdir).all_steps() == [0, 2, 4]
    on_port = jckpt.CheckpointManager(tdir).restore(jstate)
    assert int(on_port.step) == 4
    jev = jtr.evaluate(on_port)
    for k in jev:
        np.testing.assert_allclose(jev[k], tsum["eval"][k], rtol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# cli/train.py
# ---------------------------------------------------------------------------

_CLI = ["--model", "gpt_tiny", "--device", "cpu", "--seq_len", "32",
        "--batch_size", "4", "--optimizer", "adamw",
        "--learning_rate", "1e-3", "--log_every_steps", "3",
        "--attention", "flash", "--attention_bwd", "fused"]


def test_exact_resume_through_the_cli(tmp_path):
    """Dropout on (gpt_tiny's 0.1): a straight 6-step run and a 3 + 3
    run on one --ckpt_dir end with bitwise-equal checkpoints (params,
    Adam moments, step), as the reference's example script resumes
    (``tests/test_example_script.py:37``)."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert tcli.main(_CLI + ["--train_steps", "6", "--ckpt_dir", a,
                             "--save_steps", "3"]) == 0
    assert tcli.main(_CLI + ["--train_steps", "3", "--ckpt_dir", b,
                             "--save_steps", "3"]) == 0
    assert tckpt.CheckpointManager(b).latest_step() == 3
    assert tcli.main(_CLI + ["--train_steps", "6", "--ckpt_dir", b,
                             "--save_steps", "3"]) == 0
    straight = tckpt.load_npz(os.path.join(a, "ckpt-6.npz"))
    resumed = tckpt.load_npz(os.path.join(b, "ckpt-6.npz"))
    assert sorted(straight) == sorted(resumed)
    assert any("/mu/" in k for k in straight)
    for k in straight:
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


def test_cli_runs_and_the_ps_role_exits_zero(tmp_path, capsys):
    metrics = str(tmp_path / "m.jsonl")
    assert tcli.main(_CLI + ["--train_steps", "3", "--eval_every_steps",
                             "3", "--metrics_path", metrics]) == 0
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    assert recs[0]["config"]["attention_bwd"] == "fused"
    assert any("eval" in r and r["step"] == 3 for r in recs)
    assert any("steps_per_sec" in r for r in recs)
    for argv in (["--job_name", "ps"],
                 ["--job_name", "ps", "--task_index", "1",
                  "--ps_hosts", "ps0:2222,ps1:2222",
                  "--worker_hosts", "w0:2222,w1:2222"]):
        assert tcli.main(argv) == 0
        assert jcli.main(argv) == 0


def test_cli_without_cuda_exits_before_any_work(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "ck")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli.main(["--model", "gpt_tiny", "--train_steps", "1",
                   "--ckpt_dir", d])
    assert not os.path.exists(d)


def _refused(tmp_path):
    gen = str(tmp_path / "gen")
    return [
        (["--model", "gpt_tiny", "--train_steps", "1", "--gen_top_k", "5"],
         "export_generator"),
        (["--model", "mlp", "--train_steps", "1", "--export_generator",
          gen], "causal-LM knob"),
        (["--model", "mlp", "--train_steps", "1", "--lm_loss_chunk", "16"],
         "causal-LM knob"),
        (["--model", "gpt_tiny", "--attention_block_q", "64"],
         "require attention_impl='flash'"),
        (["--model", "gpt_tiny", "--attention_bwd", "fused"],
         "require attention_impl='flash'"),
        (["--model", "gpt_tiny", "--attention", "flash",
          "--attention_block_k", "100"], "positive multiple of 128"),
        (["--model", "gpt_tiny", "--lm_loss_impl", "chunked"],
         "needs lm_loss_chunk > 0"),
        (["--model", "gpt_tiny", "--lm_loss_vocab_block", "64"],
         "requires lm_loss_impl='fused'"),
        (["--model", "gpt_tiny", "--token_accuracy_every_n", "0"],
         "must be >= 1"),
        (["--model", "gpt_tiny", "--on_anomaly", "rollback"],
         "needs checkpoint.directory"),
        (["--model", "gpt_tiny", "--check_nans", "--on_anomaly", "skip"],
         "pairs with on_anomaly='halt'"),
        (["--model", "gpt_tiny", "--max_anomalies", "-1"], "must be >= 0"),
        (["--model", "gpt_tiny", "--export_generator", gen, "--gen_top_p",
          "0.5"], "set --gen_temperature > 0"),
        (["--model", "gpt_tiny", "--export_generator", gen, "--gen_batch",
          "0"], "--gen_batch must be >= 1"),
        (["--model", "gpt_tiny", "--moe_experts", "4"], "MoE routing knob"),
        (["--model", "gpt_tiny", "--label_smoothing", "0.1"],
         "image classifiers"),
        (["--eval_only"], "--eval_only requires --ckpt_dir"),
    ]


def test_cli_refuses_what_the_reference_refuses(tmp_path):
    """Every argv the reference's CLI refuses before any work is refused
    by the port's with the same message fragment (the mirror of
    ``tests/test_gpt.py:505-515``, widened to the reference's other
    checks)."""
    for argv, frag in _refused(tmp_path):
        for main in (jcli.main, tcli.main):
            with pytest.raises(SystemExit, match=frag.replace(
                    "(", r"\(").replace(")", r"\)")):
                main(argv)


# --model mlp, --sync_mode shard_map and two worker hosts now train
# (tests/test_torch_mnist.py, tests/test_torch_distributed.py): their rows
# pair them with a knob that is still refused. A data axis of 2 in one
# rank would need two cards in one process (A6). The conv models train
# too (tests/test_torch_conv.py): the row that named resnet20 names a
# model still to come, and ImageNet's readers and knobs name A5b. BERT,
# lars/lamb, the fused and chunked LM heads and --remat train too
# (tests/test_torch_bert.py): their rows name what stays refused around
# them (a vocab.txt corpus, the MoE and pipeline BERTs). adafactor, the
# best checkpoint, async saves, early stop, --eval_only, rollback, fault
# specs and the summary, TensorBoard, timing, profiler and trace sinks
# train too (tests/test_torch_ckpt_best.py, test_torch_self_healing.py,
# test_torch_eval_timing.py, test_torch_tb_events.py,
# test_torch_adafactor.py; LIFTED below), and so do the debug tools
# (tests/test_torch_debug_tools.py): of their slices only sharded saves
# (A6) stay refused.
LATER = [
    (["--model", "mlp", "--steps_per_loop", "2"], "A3c-2b"),
    (["--model", "bert_tiny", "--data_dir", "VOCAB"], "A5b"),
    (["--model", "moe_bert_tiny"], "A5b"),
    (["--model", "pipe_bert_tiny"], "A6"),
    (["--model", "moe_bert"], "A5b"),
    (["--steps_per_loop", "2"], "A3c-2b"),
    (["--mesh", "data=2"], "A6"),
    (["--sync_mode", "shard_map", "--max_inflight_steps", "2"], "A3c-2b"),
    (["--model", "pipe_moe_bert_tiny"], "A6"),
    (["--sharded_save"], "A6"),
    (["--warm_start", "w"], "A5b"),
    (["--moment_dtype", "bfloat16"], "A5b"),
    (["--ema_decay", "0.9"], "A5b"),
    (["--streaming"], "A5b"),
    (["--max_per_class", "5"], "A5b"),
    (["--label_offset", "-1"], "A5b"),
    (["--augment", "--model", "resnet50"], "A5b"),
    (["--data_dir", "IMAGENET", "--model", "resnet50"], "A5b"),
    # --export_dir itself is lifted (A4a): exporting a model the port
    # lacks still refuses, naming that model's slice
    (["--export_dir", "EXPORT", "--model", "moe_bert_tiny"], "A5b"),
    (["--worker_hosts", "w0:1,w1:1", "--steps_per_loop", "2"], "A3c-2b"),
]


@pytest.mark.parametrize("extra,slice_", LATER,
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(x.lstrip("-") for x in v[:2]))
def test_cli_refuses_a_later_slice_before_any_work(tmp_path, extra,
                                                   slice_):
    """A knob of a later slice exits naming its slice before the model,
    the data or the checkpoint directory is touched (a raw-text BERT
    corpus, ``VOCAB``: a directory holding only a vocab.txt, exits
    before any token is read)."""
    ck = str(tmp_path / "ck")
    vocab = tmp_path / "vocab"
    vocab.mkdir()
    (vocab / "vocab.txt").write_text("[PAD]\n[CLS]\n")
    extra = [ck if x == "CKPT" else str(tmp_path / "exp")
             if x == "EXPORT" else str(vocab) if x == "VOCAB" else x
             for x in extra]
    argv = ["--model", "gpt_tiny", "--device", "cpu", "--train_steps",
            "1"] + extra
    with pytest.raises(SystemExit, match=f"slice {slice_}"):
        tcli.main(argv)
    assert not os.path.exists(ck)


# every flag the rest-of-training slices (A3c-3b, A3c-4, A3c-4b) ported
LIFTED = [
    ["--optimizer", "adafactor"],
    ["--keep_best_metric", "loss"],
    ["--async_save"],
    ["--summary_every_steps", "5"],
    ["--param_histograms_every_steps", "5"],
    ["--tb_logdir", "tb"],
    ["--early_stop_metric", "loss"],
    ["--eval_only"],
    ["--eval_step", "3"],
    ["--eval_best"],
    ["--on_anomaly", "rollback"],
    ["--fault_spec", "ckpt.write:step=1"],
    ["--profile_dir", "prof"],
    ["--profile_steps", "2,4"],
    ["--step_timing"],
    ["--trace_path", "trace.json"],
    ["--trace_buffer_events", "128"],
    # the debug tools (A3c-4b)
    ["--debug_checks"],
    ["--debug_nans"],
    ["--profiler_port", "6006"],
    # the forward's serving artifact (A4a)
    ["--export_dir", "exp"],
]


@pytest.mark.parametrize("extra", LIFTED,
                         ids=lambda v: v[0].lstrip("-"))
def test_cli_no_longer_refuses_a_lifted_flag(extra):
    """A flag of the rest-of-training slice parses and sets no later-slice
    refusal (each one trains in the test files named above LATER)."""
    args = tcli.build_parser().parse_args(
        ["--model", "gpt_tiny", "--device", "cpu"] + extra)
    assert [what for what, on, _ in tcli._later_slice(args) if on] == []
    tcli.refuse_later_slices(args)


def test_cli_refuses_the_tile_levers_and_jax_key_impls(tmp_path):
    """The tile levers pass the reference's validation but the Hopper
    kernels' tiles are fixed: refused before the first forward, not deep
    in a run; so are JAX's hardware key implementations."""
    for extra, frag in ((["--attention", "flash", "--attention_block_q",
                          "64"], "fixed 64x64 tiles"),
                        (["--attention", "flash", "--attention_bwd_block",
                          "128"], "fixed 64x64 tiles"),
                        (["--prng_impl", "rbg"], "JAX key implementation")):
        with pytest.raises(SystemExit, match=frag):
            tcli.main(["--model", "gpt_tiny", "--device", "cpu"] + extra)


def test_cli_export_generator_serve_generate(tmp_path):
    """Train through the CLI with --export_generator, serve the artifact
    with the port's PredictServer and POST :generate: tokens of the
    right shape (the mirror of ``tests/test_gpt.py:480-503``)."""
    d = str(tmp_path / "gen")
    rc = tcli.main(["--model", "gpt_tiny", "--device", "cpu",
                    "--train_steps", "2", "--batch_size", "8",
                    "--seq_len", "32", "--optimizer", "adamw",
                    "--learning_rate", "1e-3", "--export_generator", d,
                    "--gen_prompt_len", "8", "--gen_max_new", "4",
                    "--gen_batch", "2", "--gen_eos_id", "3"])
    assert rc == 0
    with PredictServer(d, device="cpu") as srv:
        ids = np.random.RandomState(0).randint(0, 1000, (2, 8)).tolist()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/models/{srv.name}:generate",
            data=json.dumps({"inputs": {"input_ids": ids}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            out = json.loads(r.read())
    toks = np.asarray(out["generations"])
    assert toks.shape == (2, 4) and toks.dtype.kind == "i"
