"""The port's ring attention over gloo ``seq`` ranks against the JAX
package's ``make_ring_attention`` and ``multi_head_attention`` on a CPU
mesh of the same shape.

One spawn of 4 ranks (``tests/_torch_fsdp_worker.py``, no JAX) runs the
ring at ``seq=4`` on whole [2, 32, 4, 8] q, k and v (each rank cuts its
block of 8 positions, runs the ring and joins the output): full, causal,
padded (row 0 valid up to 24, so its last block is all padding; row 1
up to 20) and causal with the padding, each with the gradients of q, k
and v of a fixed weighting of the output; then bert_tiny's loss and
gradients at (data=2, seq=2) with and without the ring, and gpt_tiny's
with and without the causal ring, from the reference's initial params;
then ``cli/train.py --model mlp --mesh
data=-1,seq=2`` resuming from the reference's own step-2 checkpoint. The
reference runs the ring on 4 devices of the ``cpu8`` mesh, BERT-tiny
with its ring on a (data=2, seq=2) mesh, and its CLI on all 8 devices
(data=4, seq=2: the MLP's step does not depend on how the batch is
split). Tolerances are stated per test; f32 differences come from the
order of the online softmax's sums.
"""

import os
import shutil
import socket
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.cli import train as jcli
from distributed_tensorflow_example_tpu.models.bert import Bert as JBert
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu.models.bert import \
    BertConfig as JBertConfig
from distributed_tensorflow_example_tpu.ops.attention import \
    multi_head_attention as jmha
from distributed_tensorflow_example_tpu.parallel.mesh import \
    local_mesh as jlocal_mesh
from distributed_tensorflow_example_tpu.parallel.ring_attention import \
    make_ring_attention as jring
from distributed_tensorflow_example_tpu_torch.config import MeshShape
from distributed_tensorflow_example_tpu_torch.parallel.mesh import Mesh
from distributed_tensorflow_example_tpu_torch.parallel.mesh import \
    mesh_sizes
from distributed_tensorflow_example_tpu_torch.parallel.ring_attention \
    import make_ring_attention
from _torch_fsdp_worker import BERT_TINY, GPT_TINY
from test_torch_fsdp import global_batches, load, run_ranks, shared_once

torch.set_num_threads(1)

WORLD = 4
CASES = {"full": (False, None), "causal": (True, None),
         "padded": (False, "pad"), "causal-padded": (True, "pad")}
#: the reference's own gradient tolerance (tests/test_bert_and_ring.py)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
CLI = ["--model", "mlp", "--batch_size", "64",
       "--learning_rate", "0.5", "--mesh", "data=-1,seq=2",
       "--save_steps", "2", "--log_every_steps", "2"]


def ring_inputs() -> dict:
    rs = np.random.RandomState(0)
    q, k, v, w = (rs.randn(2, 32, 4, 8).astype(np.float32)
                  for _ in range(4))
    pad = np.ones((2, 32), np.int32)
    pad[0, 24:] = 0                 # row 0's last block: all padding
    pad[1, 20:] = 0
    return {"q": q, "k": k, "v": v, "w": w, "pad": pad}


def _reference_ring(x: dict) -> dict:
    """The reference's ring on a seq=4 mesh and its plain attention: each
    case's output and the gradients of q, k and v of sum(out * w)."""
    mesh = jlocal_mesh(4, {"seq": 4})
    out = {}
    for name, (causal, mask) in CASES.items():
        m = None if mask is None else jnp.asarray(x[mask])

        def ring_loss(q, k, v, causal=causal, m=m):
            o = jring(mesh, causal=causal)(q, k, v, mask=m)
            return jnp.sum(o * x["w"]), o

        def plain_loss(q, k, v, causal=causal, m=m):
            o = jmha(q, k, v, causal=causal,
                     mask=None if m is None else m[:, None, None, :])
            return jnp.sum(o * x["w"]), o

        for tag, fn in (("ring", ring_loss), ("plain", plain_loss)):
            grads, o = jax.jit(jax.grad(fn, argnums=(0, 1, 2),
                                        has_aux=True))(x["q"], x["k"],
                                                       x["v"])
            out[f"{tag}/{name}/out"] = np.asarray(o)
            for n, g in zip("qkv", grads):
                out[f"{tag}/{name}/d{n}"] = np.asarray(g)
    return out


def _bert_batch() -> dict:
    return global_batches("bert_tiny")[0]


def _write_params(tmp) -> dict:
    """BERT-tiny's and GPT-tiny's reference inits (dropout off), flat in
    ``tmp/params.npz`` and ``tmp/gpt_params.npz``: {name: (model,
    params)}."""
    out = {"bert": JBert(JBertConfig(**BERT_TINY)),
           "gpt": JGPT(JGPTConfig(**GPT_TINY))}
    for i, (name, jm) in enumerate(out.items()):
        params = jm.init(jax.random.key(i))
        flat = {k[len("params/"):]: v for k, v in
                jckpt._flatten({"params": params}).items()}
        np.savez(tmp / ("params.npz" if name == "bert"
                        else "gpt_params.npz"), **flat)
        out[name] = (jm, params)
    return out


def _reference_losses(models: dict) -> dict:
    """Each model's loss over the global batch with ring attention on a
    (data=2, seq=2) mesh (GPT's causal) and with plain attention."""
    mesh = jlocal_mesh(4, {"data": 2, "seq": 2})
    batch = {k: jnp.asarray(v) for k, v in _bert_batch().items()}
    out = {}
    for name, (jm, params) in models.items():
        if name == "bert":
            ring = JBert(JBertConfig(**BERT_TINY), attention_fn=jring(mesh))
            b = batch
        else:
            ring = JGPT(JGPTConfig(**GPT_TINY),
                        attention_fn=jring(mesh, causal=True))
            b = {k: batch[k] for k in ("input_ids", "attention_mask")}
        out[name] = {tag: float(jax.jit(lambda p, m=m, b=b: m.loss(
            p, {}, b, None)[0])(params))
            for tag, m in (("ring", ring), ("plain", jm))}
    return out


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _build(tmp):
    """The inputs, the params and the reference CLI's step-2 checkpoint,
    then the ranks in the background while the reference computes."""
    x = ring_inputs()
    np.savez(tmp / "ring.npz", **x)
    np.savez(tmp / "bert_batch.npz", **_bert_batch())
    models = _write_params(tmp)
    # the reference's CLI: 2 steps, a copy of its step-2 checkpoint for
    # the port, then on to 4
    ref_dir, port_dir = tmp / "ref_cli", tmp / "port_cli"
    assert jcli.main(CLI + ["--ckpt_dir", str(ref_dir), "--train_steps",
                            "2"]) == 0
    shutil.copytree(ref_dir, port_dir)
    tasks = [
        {"kind": "ring", "name": "ring", "mesh": {"seq": 4},
         "inputs": str(tmp / "ring.npz"),
         "cases": [{"name": n, "causal": c, "mask": m}
                   for n, (c, m) in CASES.items()]},
        {"kind": "bert_ring", "name": "bert", "mesh": {"data": 2, "seq": 2},
         "params": str(tmp / "params.npz"),
         "gpt_params": str(tmp / "gpt_params.npz"),
         "batch": str(tmp / "bert_batch.npz")},
        {"kind": "cli", "ports": _free_ports(1),
         "argvs": [CLI + ["--device", "cpu", "--ckpt_dir", str(port_dir),
                          "--train_steps", "4"]]}]
    with ThreadPoolExecutor(1) as ex:
        spawned = ex.submit(run_ranks, WORLD, tasks, tmp)
        ref = {"ring": _reference_ring(x), **_reference_losses(models)}
        assert jcli.main(CLI + ["--ckpt_dir", str(ref_dir),
                                "--train_steps", "4"]) == 0
        spawned.result()
    return {"ref": ref, "tmp": tmp,
            "ring": [load(tmp, "ring", r) for r in range(WORLD)],
            "bert": [load(tmp, "bert", r) for r in range(WORLD)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "ring_runs", _build)


@pytest.mark.parametrize("case", ["full", "causal", "padded"])
def test_ring_forward_matches_the_reference(runs, case):
    """Each rank's joined output equals the reference's ring and its
    plain attention (2e-6 absolute, outputs of order 1)."""
    for r in range(WORLD):
        got = runs["ring"][r][f"{case}/out"]
        for tag in ("ring", "plain"):
            np.testing.assert_allclose(
                got, runs["ref"]["ring"][f"{tag}/{case}/out"], rtol=0,
                atol=2e-6, err_msg=f"{tag} rank {r}")


@pytest.mark.parametrize("case", list(CASES))
def test_ring_gradients_match_the_reference(runs, case):
    """The gradients of q, k and v through the ring's hops equal the
    reference ring's and its plain attention's at the reference's own
    tolerance (rtol 5e-4, atol 5e-5)."""
    for r in range(WORLD):
        for n in "qkv":
            got = runs["ring"][r][f"{case}/d{n}"]
            for tag in ("ring", "plain"):
                np.testing.assert_allclose(
                    got, runs["ref"]["ring"][f"{tag}/{case}/d{n}"], **GRAD_TOL,
                    err_msg=f"{tag} d{n} rank {r}")


def test_every_seq_rank_holds_the_same_output_and_gradients(runs):
    """The join and the cut are a conjugate pair: every rank ends with
    the same whole output and the same whole gradients, bit for bit, so
    the layers before the attention (replicated along ``seq``) train
    alike on every rank."""
    for case in CASES:
        for key in ("out", "dq", "dk", "dv"):
            for r in range(1, WORLD):
                np.testing.assert_array_equal(
                    runs["ring"][r][f"{case}/{key}"],
                    runs["ring"][0][f"{case}/{key}"], err_msg=case)


def test_fully_padded_block_leaves_rows_finite(runs):
    """Row 0's last block holds only padding: the zeroed probabilities
    keep its normaliser clean, so every query row (the padded ones
    included, which attend to the valid keys) is finite and equals the
    plain attention."""
    out = runs["ring"][0]["padded/out"]
    assert np.isfinite(out).all()
    assert np.abs(out[0, 24:]).max() > 0.1
    np.testing.assert_allclose(out[0, 24:],
                               runs["ref"]["ring"]["plain/padded/out"][0, 24:],
                               rtol=0, atol=2e-6)


def test_ring_refuses_unexpected_kwargs_and_a_conflicting_causal():
    """The reference's two refusals, on a mesh of one rank."""
    x = {k: torch.from_numpy(v) for k, v in ring_inputs().items()}
    mesh = Mesh(mesh_sizes(MeshShape(), 1))
    attn = make_ring_attention(mesh)
    with pytest.raises(TypeError, match="unexpected kwargs"):
        attn(x["q"], x["k"], x["v"], impl="flash")
    with pytest.raises(ValueError, match="conflicts with"):
        attn(x["q"], x["k"], x["v"], causal=True)
    causal = make_ring_attention(mesh, causal=True)
    with pytest.raises(ValueError, match="conflicts with"):
        causal(x["q"], x["k"], x["v"], causal=False)
    # a matching flag and the one-rank ring are the plain attention
    from distributed_tensorflow_example_tpu_torch.ops.attention import \
        multi_head_attention
    np.testing.assert_allclose(
        causal(x["q"], x["k"], x["v"], causal=True).numpy(),
        multi_head_attention(x["q"], x["k"], x["v"], causal=True).numpy(),
        rtol=0, atol=2e-6)


def test_bert_tiny_loss_with_ring_attention_matches_the_reference(runs):
    """BERT-tiny at (data=2, seq=2) with ``attention_fn`` the ring: the
    token-weighted mean of the two data ranks' losses equals the
    reference's ring loss and plain loss over the global batch (1e-5
    relative), and each rank's loss equals its plain-attention loss."""
    outs = runs["bert"]
    # ranks 0 and 2 are the two data rows (rank = data * 2 + seq)
    num = sum(float(outs[r]["ring/loss"]) * float(outs[r]["ring/weight"])
              for r in (0, 2))
    den = sum(float(outs[r]["ring/weight"]) for r in (0, 2))
    for tag in ("ring", "plain"):
        assert num / den == pytest.approx(runs["ref"]["bert"][tag],
                                          rel=1e-5)
    for r in range(WORLD):
        assert float(outs[r]["ring/loss"]) == pytest.approx(
            float(outs[r]["plain/loss"]), rel=1e-6)


def test_bert_tiny_gradients_through_the_ring_equal_plain_attention(runs):
    """Every parameter's gradient with the ring equals the plain
    attention's on the same rows (the reference's ring gradient
    tolerance), and the two ``seq`` ranks of a data row hold the same
    gradients bit for bit."""
    outs = runs["bert"]
    keys = [k[len("ring/grad/"):] for k in outs[0]
            if k.startswith("ring/grad/")]
    assert len(keys) > 20
    for r in range(WORLD):
        for k in keys:
            np.testing.assert_allclose(outs[r][f"ring/grad/{k}"],
                                       outs[r][f"plain/grad/{k}"],
                                       **GRAD_TOL, err_msg=f"{k} rank {r}")
    for a, b in ((0, 1), (2, 3)):
        for k in keys:
            np.testing.assert_array_equal(outs[a][f"ring/grad/{k}"],
                                          outs[b][f"ring/grad/{k}"],
                                          err_msg=k)


def test_gpt_tiny_causal_ring_matches_the_reference(runs):
    """GPT-tiny at (data=2, seq=2) with ``attention_fn`` the causal ring
    (called with ``causal=True``, as GPT's layer calls it): the
    token-weighted mean of the data ranks' losses equals the reference's
    causal ring loss and plain loss (1e-5 relative); every gradient
    equals the plain attention's on the same rows (rtol 5e-4, atol
    5e-5), the same on both ``seq`` ranks of a data row, bit for bit."""
    outs = runs["bert"]
    num = sum(float(outs[r]["gpt/ring/loss"])
              * float(outs[r]["gpt/ring/weight"]) for r in (0, 2))
    den = sum(float(outs[r]["gpt/ring/weight"]) for r in (0, 2))
    for tag in ("ring", "plain"):
        assert num / den == pytest.approx(runs["ref"]["gpt"][tag], rel=1e-5)
    keys = [k[len("gpt/ring/grad/"):] for k in outs[0]
            if k.startswith("gpt/ring/grad/")]
    assert len(keys) > 20
    for r in range(WORLD):
        for k in keys:
            np.testing.assert_allclose(outs[r][f"gpt/ring/grad/{k}"],
                                       outs[r][f"gpt/plain/grad/{k}"],
                                       **GRAD_TOL, err_msg=f"{k} rank {r}")
    for a, b in ((0, 1), (2, 3)):
        for k in keys:
            np.testing.assert_array_equal(outs[a][f"gpt/ring/grad/{k}"],
                                          outs[b][f"gpt/ring/grad/{k}"],
                                          err_msg=k)


def test_cli_on_a_data_seq_mesh_matches_the_reference(runs):
    """``cli/train.py --mesh data=-1,seq=2`` over 4 gloo workers
    (data=2, seq=2; the model replicated along ``seq``) resumes the
    reference CLI's step-2 checkpoint and writes at step 4 the params
    the reference's CLI wrote (data=4, seq=2 on 8 devices), to 1e-5 of
    each leaf's largest value."""
    tmp = runs["tmp"]
    with np.load(os.path.join(tmp / "port_cli", "ckpt-4.npz")) as z:
        got = {k: z[k] for k in z.files}
    with np.load(os.path.join(tmp / "ref_cli", "ckpt-4.npz")) as z:
        want = {k: z[k] for k in z.files}
    keys = [k for k in want if k.startswith("params/")]
    assert len(keys) == 4
    for k in keys:
        w = want[k]
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=k)
    assert int(got["step"]) == 4
