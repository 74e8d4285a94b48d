"""The port's adafactor against the JAX package's (optax's chain), on the
CPU: 5-step f32 trajectories on factored and unfactored leaves, with and
without momentum and the decay rate, at rtol 1e-5 (atol 1e-7 for the
elements the decay cancels to near zero); the factoring rule and the
state's shapes; the state through the npz bridge in both directions,
bitwise; training under ``SyncReplicas`` and the memory claim (the
counterparts of ``tests/test_config_knobs.py:423`` and ``:454``); and the
CLI's ``--optimizer adafactor`` with a resume.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig)
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from distributed_tensorflow_example_tpu_torch.utils.pytree import \
    tree_leaves

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

#: a factored matrix, a matrix below min_dim_size_to_factor, a vector and
#: a 4-D kernel that factors over its two largest axes
SHAPES = {"a": (256, 192), "b": (64, 32), "c": (7,), "d": (3, 3, 128, 160)}


@pytest.mark.parametrize("kw", [
    dict(momentum=0.0),
    dict(momentum=0.9),
    dict(momentum=0.0, weight_decay=0.01),
    dict(momentum=0.9, weight_decay=0.01, wd_mask="all", warmup_steps=2,
         decay_schedule="cosine", total_steps=5, grad_clip_norm=1.0),
], ids=["plain", "momentum", "decay", "momentum-decay-schedule-clip"])
def test_adafactor_trajectory_matches_reference(kw):
    rs = np.random.RandomState(0)
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    jt = jopt.make_optimizer(jconfig.OptimizerConfig(
        name="adafactor", learning_rate=0.01, **kw))
    tt = topt.make_optimizer(tconfig.OptimizerConfig(
        name="adafactor", learning_rate=0.01, **kw))
    keys = sorted(SHAPES)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = [torch.from_numpy(p0[k].copy()) for k in keys]
    js, ts = jt.init(jp), tt.init(tp)
    for step in range(5):
        g = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
        ju, js = jt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = tt.update([torch.from_numpy(g[k]) for k in keys], ts, tp)
        tp = topt.apply_updates(tp, tu)
        for k, got in zip(keys, tp):
            np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} step {step + 1}")


@pytest.mark.parametrize("shape", [(256, 192), (192, 256), (128, 128),
                                   (127, 512), (64, 32), (7,), (300,),
                                   (3, 3, 128, 160), (2, 130, 140)])
def test_factored_state_shapes_match_reference(shape):
    """The factoring rule (the two largest axes, numpy's argsort order,
    the second at least 128) gives the reference's slot shapes."""
    jst = optax.adafactor(0.1).init({"w": jnp.zeros(shape)})[0]
    tst = topt.scale_by_factored_rms().init([torch.zeros(shape)])
    for slot in ("v_row", "v_col", "v"):
        assert tuple(tst[slot][0].shape) == tuple(
            getattr(jst, slot)["w"].shape), slot


# ---------------------------------------------------------------------------
# checkpoints, both directions
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=64, hidden=32, layers=1, heads=2, intermediate=128,
            max_len=32, dropout=0.0)
ADAFACTOR = dict(name="adafactor", learning_rate=1e-2, momentum=0.9,
                 weight_decay=0.001)


def _port_state(steps, seed):
    m = GPT(GPTConfig(**TINY))
    sync = SyncReplicas(m.loss, topt.make_optimizer(
        tconfig.OptimizerConfig(**ADAFACTOR)), device="cpu")
    state = sync.init(m.init, seed=seed)
    ids = np.random.RandomState(seed).randint(0, 64, (2, 16)).astype(
        np.int32)
    for _ in range(steps):
        state, _ = sync.step(state, {"input_ids": ids})
    return sync, state


def _jax_state(steps, seed):
    m = JGPT(JGPTConfig(**TINY))
    sync = JSyncReplicas(m.loss, jopt.make_optimizer(
        jconfig.OptimizerConfig(**ADAFACTOR)), local_mesh(1), donate=False)
    state = sync.init(m.init, seed=seed)
    ids = np.random.RandomState(seed).randint(0, 64, (2, 16)).astype(
        np.int32)
    for _ in range(steps):
        state, _ = sync.step(state, sync.shard_batch(
            {"input_ids": jnp.asarray(ids)}))
    return sync, state


def test_adafactor_checkpoints_cross_between_the_packages(tmp_path):
    """An adafactor TrainState (factored rows and columns, the full ``v``
    of the unfactored leaves, the momentum average, the counts) written
    by either package restores in the other, bit for bit."""
    _, jstate = _jax_state(2, seed=0)
    jdir, tdir = str(tmp_path / "from_jax"), str(tmp_path / "from_port")
    jckpt.CheckpointManager(jdir).save(jstate)
    tsync, _ = _port_state(0, seed=9)
    got = tckpt.CheckpointManager(jdir).restore(
        tsync.init(GPT(GPTConfig(**TINY)).init, seed=9))
    want = jckpt._flatten(jax.device_get(jstate))
    have = tckpt.state_arrays(got)
    keys = sorted(k for k in want if not k.startswith("__prng"))
    assert sorted(k for k in have if not k.startswith("__prng")) == keys
    for slot in ("/v_row/", "/v_col/", "/v/", "/ema/"):
        assert any(slot in k for k in keys), slot
    for k in keys:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)

    _, tstate = _port_state(2, seed=4)
    tckpt.CheckpointManager(tdir).save(tstate)
    jsync, _ = _jax_state(0, seed=4)
    back = jckpt.CheckpointManager(tdir).restore(
        jsync.init(JGPT(JGPTConfig(**TINY)).init, seed=4))
    want = tckpt.state_arrays(tstate)
    have = jckpt._flatten(jax.device_get(back))
    assert int(back.step) == 2
    for k in keys:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the reference's knob tests, held to the port
# ---------------------------------------------------------------------------

def _n_opt(state) -> int:
    return sum(int(x.numel()) for x in tree_leaves(state))


def test_adafactor_trains_and_factored_state_is_small():
    """adafactor trains the MLP under SyncReplicas (the loss drops) and,
    with momentum 0, a matrix big enough to factor keeps rows and
    columns, not a full second moment."""
    m = get_model("mlp", tconfig.TrainConfig(model="mlp"))
    sync = SyncReplicas(m.loss, topt.make_optimizer(
        tconfig.OptimizerConfig(name="adafactor", learning_rate=0.01,
                                momentum=0.0)), device="cpu")
    state = sync.init(m.init)
    batch = m.dummy_batch(64)
    losses = []
    for _ in range(8):
        state, metrics = sync.step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    tx = topt.make_optimizer(tconfig.OptimizerConfig(name="adafactor",
                                                     momentum=0.0))
    assert _n_opt(tx.init([torch.ones(512, 256)])) < 0.05 * 512 * 256


def test_adafactor_momentum_knob_is_load_bearing():
    params = [torch.ones(64, 32)]
    n0 = _n_opt(topt.make_optimizer(tconfig.OptimizerConfig(
        name="adafactor", momentum=0.0)).init(params))
    n9 = _n_opt(topt.make_optimizer(tconfig.OptimizerConfig(
        name="adafactor", momentum=0.9)).init(params))
    assert n9 >= n0 + 64 * 32, (n0, n9)


def test_cli_adafactor_trains_and_resumes(tmp_path):
    """``--optimizer adafactor`` (a refused flag before this slice) trains
    gpt_tiny through the CLI; a second run resumes from its checkpoint,
    the factored state restored."""
    ck = str(tmp_path / "ck")
    argv = ["--model", "gpt_tiny", "--device", "cpu", "--seq_len", "32",
            "--batch_size", "4", "--optimizer", "adafactor", "--momentum",
            "0", "--learning_rate", "1e-2", "--ckpt_dir", ck,
            "--save_steps", "3", "--log_every_steps", "3"]
    assert tcli.main(argv + ["--train_steps", "3"]) == 0
    arrays = tckpt.load_npz(tckpt.CheckpointManager(ck).checkpoint_path(3))
    assert int(arrays["opt_state/0/0/count"]) == 3
    assert not any(k.startswith("opt_state/0/4/") for k in arrays)
    assert tcli.main(argv + ["--train_steps", "6"]) == 0
    assert tckpt.CheckpointManager(ck).all_steps() == [3, 6]
