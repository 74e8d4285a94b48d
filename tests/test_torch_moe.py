"""The port's MoE FFN and MoE-BERT against the JAX package's, on the CPU:
``moe_ffn`` (top-1 and top-2, generous and overflowing capacity) with its
dispatch tensors, aux statistics and router gradients; the z-loss and the
router jitter; MoE-BERT-tiny's loss, metrics and every gradient on
bridged weights (XLA and flash attention, the fused MLM head); ``--remat``;
the CLI's MoE knobs; vector metrics through the sync step, the CLI's
JSONL (one rank and two gloo ranks) and its scalar sinks; the
static-batch export served on ``:predict`` with the scheduler on and off.

Inputs are seeded numpy arrays, weights the reference's init crossing as
numpy arrays keyed as its checkpoint keys them. f32 throughout; the
tolerances are stated per test (f32 summation order only). Routing is a
discrete choice: each test that holds the dispatch tensors equal states
the smallest gap between a token's top-1 and top-2 router probabilities
in its inputs (:func:`top_gap`), so that a flip from a near-tie would be
explained, not hidden.
"""

import json
import logging
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import serving as jserving
from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.cli import train as jcli
from distributed_tensorflow_example_tpu.config import TrainConfig as JConfig
from distributed_tensorflow_example_tpu.data import bert_data as jdata
from distributed_tensorflow_example_tpu.models import get_model as jget_model
from distributed_tensorflow_example_tpu.models.moe import MoeBert as JMoeBert
from distributed_tensorflow_example_tpu.models.moe import \
    MoeBertConfig as JMoeBertConfig
from distributed_tensorflow_example_tpu.ops import moe as jmoe
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.models import (get_model,
                                                             list_models)
from distributed_tensorflow_example_tpu_torch.models.moe import (
    MoeBert, MoeBertConfig, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.ops import losses
from distributed_tensorflow_example_tpu_torch.ops import moe as tmoe
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.serving import (
    export_model, load_servable, read_meta, static_batch)
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from distributed_tensorflow_example_tpu_torch.utils import tb_events
from distributed_tensorflow_example_tpu_torch.utils.pytree import (
    flatten_dict, unflatten_dict)

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=1000, hidden=128, layers=2, heads=4,
            intermediate=256, max_len=128, max_predictions=8, n_experts=4,
            capacity_factor=2.0)
#: 2 heads of 64 at S = 128: the reference's Pallas flash kernels engage
#: (interpret mode on the CPU)
HEADS64 = dict(TINY, heads=2)
F32_TOL = 1e-4
#: the smallest top-1/top-2 router-probability gap a test's inputs may
#: hold: far above f32 rounding (~1e-7), so the two packages' argmax agree
MIN_GAP = 1e-5
WAIT_S = 60
RANK_TIMEOUT_S = 150


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def ffn_params(n_experts=4, hidden=16, inter=32, seed=0) -> dict:
    """The reference's MoE FFN init as numpy arrays."""
    p = jmoe.moe_ffn_init(jax.random.key(seed), n_experts, hidden, inter)
    return jax.tree_util.tree_map(np.asarray, p)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def top_gap(kernel: np.ndarray, x2: np.ndarray, k: int = 1) -> float:
    """The smallest gap between a token's consecutive router
    probabilities among its k + 1 largest (top-1 against top-2 for top-1
    routing; also top-2 against top-3 for top-2), f64, from the
    reference's formula."""
    logits = x2.astype(np.float64) @ kernel.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = np.sort(p, axis=-1)[:, ::-1][:, :k + 1]
    return float((top[:, :-1] - top[:, 1:]).min())


def gelu(x):
    return 0.5 * x * (1 + np.tanh(np.sqrt(2 / np.pi)
                                  * (x + 0.044715 * x ** 3)))


def brute_force(params: dict, x2: np.ndarray, k: int) -> np.ndarray:
    """out[t] = sum over t's top-k experts of p_e * FFN_e(x_t), f64, no
    dispatch tensors (generous capacity: nothing dropped)."""
    x2 = x2.astype(np.float64)
    logits = x2 @ params["router"]["kernel"]
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.zeros_like(x2)
    for t in range(len(x2)):
        for e in np.argsort(-p[t], kind="stable")[:k]:
            h = gelu(x2[t] @ params["w_in"][e] + params["b_in"][e])
            out[t] += p[t, e] * (h @ params["w_out"][e] + params["b_out"][e])
    return out


def padded_seqs(n=6, s=64, vocab=1000, seed=0) -> np.ndarray:
    """The reference's synthetic corpus, each row cut to a random length
    with trailing PAD, the last row all PAD."""
    seqs = jdata.synthetic_corpus(n, s, vocab, seed)
    lens = np.random.RandomState(seed + 50).randint(s // 4, s + 1, n)
    lens[-1] = 0
    for i, n_tok in enumerate(lens):
        seqs[i, n_tok:] = jdata.PAD
    return seqs


def mlm_batch(n=6, s=64, seed=0) -> dict:
    return jdata.apply_mlm_masking(padded_seqs(n, s, seed=seed),
                                   vocab_size=1000, max_predictions=8,
                                   seed=seed + 2)


def make_pair(cfg=TINY, attention_impl="xla", lm_loss_impl="full",
              dropout=0.0, remat="none", seed=0, **moe_kw):
    """The same MoE-BERT in both packages, the port's weights the
    reference's through the numpy bridge."""
    jm = JMoeBert(JMoeBertConfig(**cfg, dropout=dropout,
                                 lm_loss_impl=lm_loss_impl, **moe_kw),
                  attention_impl=attention_impl)
    jp = jm.init(jax.random.key(seed))
    tm = MoeBert(MoeBertConfig(**cfg, dropout=dropout,
                               lm_loss_impl=lm_loss_impl, **moe_kw),
                 attention_impl=attention_impl, remat=remat)
    return jm, jp, tm, params_from_numpy(tm, jckpt._flatten(jp),
                                         device="cpu")


class RouteTap:
    """Records every call of a package's ``_route`` (its dispatch tensor,
    and the :func:`top_gap` of its input) while it is installed."""

    def __init__(self, module, monkeypatch, to_numpy):
        self.dispatch, self.gaps = [], []
        inner = module._route

        def tap(router_params, x2, n_experts, k, *a, **kw):
            out = inner(router_params, x2, n_experts, k, *a, **kw)
            self.dispatch.append(to_numpy(out[0]))
            self.gaps.append(top_gap(to_numpy(router_params["kernel"]),
                                     to_numpy(x2), k))
            return out
        monkeypatch.setattr(module, "_route", tap)


def _np_torch(x):
    return x.detach().cpu().numpy()


def value_and_grad(tm, tp, batch, gen=None):
    flat = {k: v.detach().requires_grad_() for k, v in
            flatten_dict(tp).items()}
    loss, (aux, _) = tm.loss(unflatten_dict(flat), {},
                             {k: torch.from_numpy(np.asarray(v))
                              for k, v in batch.items()}, gen)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), aux, dict(zip(flat, grads))


# ---------------------------------------------------------------------------
# the registry and the weight bridge
# ---------------------------------------------------------------------------

def test_moe_models_register_with_the_references_configs():
    """``moe_bert`` and ``moe_bert_tiny`` register, with the reference's
    preset fields; the bridge crosses every key both ways and refuses a
    missing one."""
    assert {"moe_bert", "moe_bert_tiny"} <= set(list_models())
    for name in ("moe_bert", "moe_bert_tiny"):
        got = get_model(name, tconfig.TrainConfig(model=name))
        want = jget_model(name, JConfig(model=name))
        assert isinstance(got, MoeBert)
        for f in ("vocab_size", "hidden", "layers", "heads", "intermediate",
                  "max_len", "max_predictions", "dropout", "n_experts",
                  "top_k", "capacity_factor", "moe_every", "aux_weight",
                  "router_z_weight", "jitter"):
            assert getattr(got.cfg, f) == getattr(want.cfg, f), (name, f)
    jm, jp, tm, tp = make_pair()
    flat = jckpt._flatten(jp)
    assert {k: v.shape for k, v in flat.items()} == tm.param_shapes()
    assert "layer_1/moe/router/kernel" in flat and "layer_1/ffn/in/kernel" \
        not in flat and "layer_0/ffn/in/kernel" in flat
    back = params_to_numpy(tp)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tm, {k: v for k, v in flat.items()
                               if k != "layer_1/moe/w_in"}, device="cpu")
    own = tm.init(0, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_dict(own).items()} \
        == tm.param_shapes()


# ---------------------------------------------------------------------------
# moe_ffn against the reference and a brute-force oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_ffn_equals_reference(monkeypatch, top_k, capacity_factor,
                                  dtype):
    """Output (within 1e-5 of its largest value) and the aux statistics
    (within 1e-6) against the reference's ``moe_ffn`` on the same inputs,
    the dispatch tensors equal, in both compute dtypes. Under bf16 both
    packages round the experts' operands and the GELU's output to bf16
    and nothing else; one more rounding of a GEMM's output to bf16 moves
    the output by ~2^-9 of a value, far past the tolerance. At
    capacity factor 8 nothing is dropped; at 1.0 top-1 drops 9 of 48
    assignments and top-2 48 of 96. The inputs' smallest gap
    (:func:`top_gap`) is 2.9e-3 for top-1 and top-2 (asserted >=
    MIN_GAP)."""
    p = ffn_params()
    p["router"]["kernel"] = p["router"]["kernel"] * 25.0
    x = np.random.RandomState(0).randn(3, 16, 16).astype(np.float32)
    taps = [RouteTap(tmoe, monkeypatch, _np_torch),
            RouteTap(jmoe, monkeypatch, np.asarray)]
    got, gaux = tmoe.moe_ffn(_t(p), torch.from_numpy(x), n_experts=4,
                             top_k=top_k, capacity_factor=capacity_factor,
                             dtype=getattr(torch, dtype))
    want, waux = jmoe.moe_ffn(_j(p), jnp.asarray(x), n_experts=4,
                              top_k=top_k, capacity_factor=capacity_factor,
                              dtype=getattr(jnp, dtype))
    assert taps[0].gaps[0] >= MIN_GAP
    np.testing.assert_array_equal(taps[0].dispatch[0], taps[1].dispatch[0])
    want = np.asarray(want)
    assert float(gaux["dropped_fraction"]) * 48 * top_k == {
        8.0: 0, 1.0: 9 if top_k == 1 else 48}[capacity_factor]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert sorted(gaux) == sorted(waux)
    for k in waux:
        np.testing.assert_allclose(gaux[k].numpy(), np.asarray(waux[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    if capacity_factor == 8.0 and dtype == "float32":
        oracle = brute_force(p, x.reshape(48, 16), top_k).reshape(x.shape)
        np.testing.assert_allclose(got.numpy(), oracle, rtol=0,
                                   atol=1e-5 * np.abs(oracle).max())


def test_capacity_overflow_drops_tokens_in_token_order(monkeypatch):
    """A zero router sends all 8 tokens to expert 0 (the first maximum,
    in both packages: the gap is 0 by construction, and argmax's tie rule
    decides). Capacity 2 keeps tokens 0 and 1 and zeroes the rest
    (dropped fraction 6/8, expert_load [1, 0, 0, 0]); capacity 1 keeps
    token 0 (7/8); generous capacity drops none. Dispatch tensors equal
    the reference's."""
    p = ffn_params()
    p["router"]["kernel"] = np.zeros_like(p["router"]["kernel"])
    x = np.random.RandomState(3).randn(1, 8, 16).astype(np.float32)
    for cf, kept in ((1.0, 2), (0.5, 1), (8.0, 8)):
        taps = [RouteTap(tmoe, monkeypatch, _np_torch),
                RouteTap(jmoe, monkeypatch, np.asarray)]
        out, aux = tmoe.moe_ffn(_t(p), torch.from_numpy(x), n_experts=4,
                                capacity_factor=cf)
        _, waux = jmoe.moe_ffn(_j(p), jnp.asarray(x), n_experts=4,
                               capacity_factor=cf)
        monkeypatch.undo()
        np.testing.assert_array_equal(taps[0].dispatch[0],
                                      taps[1].dispatch[0])
        out = out.numpy()[0]
        assert np.abs(out[:kept]).min(axis=-1).min() > 0
        np.testing.assert_array_equal(out[kept:], 0.0)
        cap = max(1, int(np.ceil(8 / 4 * cf)))
        assert float(aux["dropped_fraction"]) == pytest.approx(1 - kept / 8)
        np.testing.assert_allclose(aux["expert_load"].numpy(),
                                   [kept / cap, 0, 0, 0])
        for k in waux:
            np.testing.assert_allclose(aux[k].numpy(), np.asarray(waux[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_gradients_equal_reference(top_k):
    """The gradient of ``sum(out^2) + lb_loss + z_loss`` for every leaf
    (the router's through the gate, the load-balancing mean
    probabilities and the z-loss) against ``jax.grad`` of the same
    function, within 1e-4 of each leaf's largest value; the router's is
    nonzero. Smallest gap of the inputs (:func:`top_gap`): 3.0e-2 for
    top-1, 4.6e-4 for top-2."""
    p = ffn_params(seed=4)
    p["router"]["kernel"] = p["router"]["kernel"] * 25.0
    x = np.random.RandomState(4).randn(2, 8, 16).astype(np.float32)
    assert top_gap(p["router"]["kernel"], x.reshape(16, 16),
                   top_k) >= MIN_GAP

    def jloss(q):
        out, aux = jmoe.moe_ffn(q, jnp.asarray(x), n_experts=4,
                                top_k=top_k, capacity_factor=1.5)
        return jnp.sum(jnp.square(out)) + aux["lb_loss"] + aux["z_loss"]

    want = jckpt._flatten(jax.grad(jloss)(_j(p)))
    tp = {k: v.requires_grad_() for k, v in flatten_dict(_t(p)).items()}
    out, aux = tmoe.moe_ffn(unflatten_dict(tp), torch.from_numpy(x),
                            n_experts=4, top_k=top_k, capacity_factor=1.5)
    loss = torch.sum(out ** 2) + aux["lb_loss"] + aux["z_loss"]
    got = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=k)
    assert float(got["router/kernel"].abs().max()) > 0


def test_z_loss_and_its_gradient_equal_reference():
    """The router z-loss ``mean(logsumexp(logits)^2)`` of a large-logit
    router (kernel x 200) and its gradient against the reference's
    (within 1e-5 relative); 100 SGD steps on the z-loss alone shrink it
    below half its start in the port, as the ST-MoE claim goes."""
    p = ffn_params()
    p["router"]["kernel"] = p["router"]["kernel"] * 200.0
    x = np.random.RandomState(0).randn(2, 8, 16).astype(np.float32)

    def jz(k):
        q = dict(_j(p), router={"kernel": k})
        return jmoe.moe_ffn(q, jnp.asarray(x), n_experts=4,
                            capacity_factor=8.0)[1]["z_loss"]

    k0 = jnp.asarray(p["router"]["kernel"])
    wz, wg = float(jz(k0)), np.asarray(jax.grad(jz)(k0))
    k = torch.from_numpy(p["router"]["kernel"].copy()).requires_grad_()
    tp = dict(_t(p), router={"kernel": k})
    z = tmoe.moe_ffn(tp, torch.from_numpy(x), n_experts=4,
                     capacity_factor=8.0)[1]["z_loss"]
    (g,) = torch.autograd.grad(z, [k])
    assert float(z) == pytest.approx(wz, rel=1e-5)
    np.testing.assert_allclose(g.numpy(), wg, rtol=0,
                               atol=1e-5 * np.abs(wg).max())
    start = float(z)
    with torch.no_grad():
        kk = k.detach().clone()
    for _ in range(100):
        kk.requires_grad_()
        zz = tmoe.moe_ffn(dict(tp, router={"kernel": kk}),
                          torch.from_numpy(x), n_experts=4,
                          capacity_factor=8.0)[1]["z_loss"]
        (gg,) = torch.autograd.grad(zz, [kk])
        kk = (kk - 0.05 * gg).detach()
    assert float(zz) < 0.5 * start


# ---------------------------------------------------------------------------
# router jitter
# ---------------------------------------------------------------------------

def test_jitter_noise_is_keyed_bounded_and_train_only():
    """The noise is a function of its key (same key, same draws; another
    key, others), lies in [1 - j, 1 + j), and moves the routing only with
    a key: ``moe_ffn`` without one is bitwise the unjittered layer. Its
    draws are torch's, not JAX's (not compared)."""
    a = tmoe.jitter_noise(7, (512, 16), 0.3, "cpu")
    assert torch.equal(a, tmoe.jitter_noise(7, (512, 16), 0.3, "cpu"))
    assert not torch.equal(a, tmoe.jitter_noise(8, (512, 16), 0.3, "cpu"))
    assert float(a.min()) >= 0.7 and float(a.max()) < 1.3
    assert float(a.max() - a.min()) > 0.5        # it spans the range
    p = _t(ffn_params())
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 8, 16)
                         .astype(np.float32))
    base, _ = tmoe.moe_ffn(p, x, n_experts=4, capacity_factor=8.0)
    off, _ = tmoe.moe_ffn(p, x, n_experts=4, capacity_factor=8.0,
                          jitter=0.5)
    assert torch.equal(off, base)
    on, _ = tmoe.moe_ffn(p, x, n_experts=4, capacity_factor=8.0, key=3,
                         jitter=0.5)
    again, _ = tmoe.moe_ffn(p, x, n_experts=4, capacity_factor=8.0, key=3,
                            jitter=0.5)
    assert torch.equal(on, again) and not torch.equal(on, base)


def test_moe_bert_jitter_runs_in_training_only():
    """MoE-BERT with jitter 0.3 and no dropout: its eval forward (no
    generator) equals the unjittered model's bitwise; its training loss
    with a generator differs from the unjittered one, and is the same
    for the same generator seed."""
    kw = dict(TINY, dropout=0.0)
    plain = MoeBert(MoeBertConfig(**kw))
    jit = MoeBert(MoeBertConfig(**kw, jitter=0.3))
    p = plain.init(0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in mlm_batch(s=32).items()}
    with torch.no_grad():
        assert torch.equal(plain.encode(p, b), jit.encode(p, b))
        assert torch.equal(plain.eval_metrics(p, {}, b)["loss"],
                           jit.eval_metrics(p, {}, b)["loss"])
        l0 = plain.loss(p, {}, b, torch.Generator().manual_seed(5))[0]
        l1 = jit.loss(p, {}, b, torch.Generator().manual_seed(5))[0]
        l2 = jit.loss(p, {}, b, torch.Generator().manual_seed(5))[0]
    assert torch.equal(l1, l2) and not torch.equal(l0, l1)


# ---------------------------------------------------------------------------
# MoE-BERT against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,impl,loss_impl,top_k", [
    ("tiny", "xla", "full", 1), ("tiny", "xla", "full", 2),
    ("tiny", "xla", "fused", 1), ("heads64", "flash", "full", 1)])
def test_moe_bert_loss_metrics_and_every_grad_match_reference(
        monkeypatch, cfg, impl, loss_impl, top_k):
    """MoE-BERT-tiny's loss and every metric (``expert_load`` [4]
    included) within 1e-4, the gradient of every parameter within rtol
    1e-4 / atol 1e-6, f32, trailing pads and an all-PAD row, no dropout
    or jitter; the MoE layer's dispatch tensors equal the reference's.
    ``fused`` runs the blockwise MLM head in both packages; ``flash`` the
    port's flash Function's plain versions against the reference's Pallas
    kernels in interpret mode (2 heads of 64, S = 128). The smallest gap
    (:func:`top_gap`) of the routed hidden states is asserted >= MIN_GAP:
    measured 8.5e-5 (tiny, top-1), 5.4e-5 (tiny, top-2) and 1.1e-5
    (heads64, flash), against f32 differences of ~1e-7 between the
    packages' probabilities."""
    shape = TINY if cfg == "tiny" else HEADS64
    s = 64 if cfg == "tiny" else 128
    jm, jp, tm, tp = make_pair(shape, impl, loss_impl, top_k=top_k)
    batch = mlm_batch(s=s)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    taps = [RouteTap(tmoe, monkeypatch, _np_torch),
            RouteTap(jmoe, monkeypatch, np.asarray)]
    with torch.no_grad():
        tl0, (tm0, _) = tm.loss(tp, {}, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    jl0, (jm0, _) = jm.loss(jp, {}, jb, None)
    assert len(taps[0].dispatch) == len(taps[1].dispatch) == 1
    assert min(taps[0].gaps) >= MIN_GAP
    np.testing.assert_array_equal(taps[0].dispatch[0], taps[1].dispatch[0])
    monkeypatch.undo()
    # the port's loss also reports, for its sync step, its prediction
    # weight and its routing losses' part (``ops/losses.py``)
    assert sorted(tm0) == sorted(
        list(jm0) + [losses.LOSS_WEIGHT, losses.LOSS_GLOBAL])
    for k in jm0:
        np.testing.assert_allclose(np.asarray(tm0[k]), np.asarray(jm0[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)
    assert tm0["expert_load"].shape == (4,)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, {}, jb, None)
    tl, _, tg = value_and_grad(tm, tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL)
    np.testing.assert_allclose(float(tl0), float(jl0), rtol=F32_TOL)
    jg = jckpt._flatten(jg)
    assert sorted(jg) == sorted(tg)
    assert float(tg["layer_1/moe/router/kernel"].abs().max()) > 0
    for k, g in tg.items():
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   rtol=F32_TOL, atol=1e-6, err_msg=k)


def test_moe_bert_eval_metrics_match_reference():
    """``eval_metrics`` (loss and MLM accuracy, a ``__valid__`` row mask
    on the tail) against the reference's, within 1e-4."""
    jm, jp, tm, tp = make_pair()
    batch = mlm_batch(seed=3)
    batch["__valid__"] = np.array([1, 1, 1, 0, 1, 1], np.int32)
    want = jm.eval_metrics(jp, {}, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    got = tm.eval_metrics(tp, {}, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    assert sorted(got) == sorted(want) == ["loss", "mlm_accuracy"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=F32_TOL, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grads_equal_none_with_dropout_and_jitter(remat, dtype):
    """Dropout 0.1 and router jitter 0.1, one generator seed, f32 and
    bf16 compute (the experts' f32-accumulating GEMMs recomputed under
    both policies): under ``remat`` full and dots each layer (the MoE
    layer's jitter included) is recomputed with the draws it made the
    first time; the loss is bitwise the one without remat and every
    gradient equal within 1e-6 of the leaf's largest value (f32
    summation order)."""
    cfg = tconfig.TrainConfig(model="moe_bert_tiny", moe_jitter=0.1,
                              dtype=dtype)
    runs = {}
    for r in ("none", remat):
        m = get_model("moe_bert_tiny", cfg.replace(remat=r))
        runs[r] = value_and_grad(m, m.init(0, device="cpu"),
                                 mlm_batch(s=32),
                                 torch.Generator().manual_seed(9))
    (l0, a0, g0), (l1, a1, g1) = runs["none"], runs[remat]
    assert torch.equal(l0, l1)
    assert torch.equal(a0["expert_load"], a1["expert_load"])
    for k in g0:
        tol = 1e-6 * float(g0[k].abs().max())
        assert float((g0[k] - g1[k]).abs().max()) <= tol, k


# ---------------------------------------------------------------------------
# the CLI's knobs and guard
# ---------------------------------------------------------------------------

def test_cli_knobs_reach_the_model_as_in_the_reference():
    """Each ``moe_*`` TrainConfig field lands in the model's config in
    both packages; out-of-range values raise the reference's ValueError
    in both; every MoE flag parses into the port's config."""
    kw = dict(moe_experts=2, moe_top_k=2, moe_capacity_factor=3.0,
              moe_every=1, moe_aux_weight=0.05, moe_router_z_weight=1e-3,
              moe_jitter=0.01)
    got = get_model("moe_bert_tiny", tconfig.TrainConfig(
        model="moe_bert_tiny", **kw)).cfg
    want = jget_model("moe_bert_tiny", JConfig(model="moe_bert_tiny",
                                               **kw)).cfg
    for f in ("n_experts", "top_k", "capacity_factor", "moe_every",
              "aux_weight", "router_z_weight", "jitter"):
        assert getattr(got, f) == getattr(want, f), f
    for bad, frag in ((dict(moe_top_k=9), "moe_top_k"),
                      (dict(moe_experts=0), "moe_experts"),
                      (dict(moe_capacity_factor=0.0), "capacity_factor"),
                      (dict(moe_every=99), "moe_every"),
                      (dict(moe_aux_weight=-1.0), "moe_aux_weight"),
                      (dict(moe_router_z_weight=-0.1), "moe_router_z"),
                      (dict(moe_jitter=1.5), "moe_jitter")):
        for get, Cfg in ((get_model, tconfig.TrainConfig),
                         (jget_model, JConfig)):
            with pytest.raises(ValueError, match=frag):
                get("moe_bert_tiny", Cfg(model="moe_bert_tiny", **bad))
    args = tcli.build_parser().parse_args(
        ["--model", "moe_bert", "--moe_experts", "4", "--moe_top_k", "2",
         "--moe_capacity_factor", "1.5", "--moe_every", "3",
         "--moe_aux_weight", "0.02", "--moe_router_z_weight", "1e-3",
         "--moe_jitter", "0.05"])
    m = get_model("moe_bert", tcli.config_from_args(args)).cfg
    assert (m.n_experts, m.top_k, m.capacity_factor, m.moe_every,
            m.aux_weight, m.router_z_weight, m.jitter) == (
        4, 2, 1.5, 3, 0.02, 1e-3, 0.05)
    assert m.vocab_size == 30522


@pytest.mark.parametrize("flag", ["--moe_top_k", "--moe_jitter"])
def test_cli_guard_refuses_moe_knobs_on_other_models(flag):
    """An MoE knob on a non-MoE model exits with the reference's message
    in both packages, before any work."""
    argv = ["--model", "bert_tiny", "--device", "cpu", "--train_steps", "1",
            flag, "0.5" if flag == "--moe_jitter" else "2"]
    for main in (tcli.main, jcli.main):
        with pytest.raises(SystemExit, match="MoE routing knob"):
            main([a for a in argv if main is tcli.main
                  or a not in ("--device", "cpu")])


# ---------------------------------------------------------------------------
# vector metrics: the sync step, the CLI's sinks, two ranks
# ---------------------------------------------------------------------------

def test_sync_step_carries_vector_metrics_through_every_path():
    """``expert_load`` [4] through ``SyncReplicas``: with ``accum_steps``
    2 it is the mean of the two microbatches' vectors (within 1e-6); a
    NaN batch under ``skip`` fills every entry with -1.0; ``debug_checks``
    names a non-finite vector leaf."""
    m = MoeBert(MoeBertConfig(**dict(TINY, dropout=0.0)))
    tx = topt.make_optimizer(tconfig.OptimizerConfig(name="adamw",
                                                     learning_rate=1e-3))
    batch = mlm_batch(n=8, s=32)
    sync = SyncReplicas(m.loss, tx, device="cpu",
                        sync=tconfig.SyncConfig(accum_steps=2))
    state = sync.init(m.init, seed=0)
    halves = [{k: torch.from_numpy(v[i * 4:(i + 1) * 4])
               for k, v in batch.items()} for i in range(2)]
    with torch.no_grad():
        want = torch.stack([m.loss(state.params, {}, h)[1][0]["expert_load"]
                            for h in halves]).mean(0)
    _, met = sync.step(state, batch)
    assert met["expert_load"].shape == (4,)
    np.testing.assert_allclose(met["expert_load"].numpy(), want.numpy(),
                               atol=1e-6)
    skip = SyncReplicas(m.loss, tx, device="cpu", anomaly_policy="skip")
    bad = dict(batch, masked_weights=np.full_like(batch["masked_weights"],
                                                  np.nan))
    _, met = skip.step(skip.init(m.init, seed=0), bad)
    assert met["expert_load"].tolist() == [-1.0] * 4
    assert float(met["loss"]) == -1.0 and int(met["anomaly_count"]) == 1
    grads = [torch.zeros(1)] * len(flatten_dict(state.params))
    with pytest.raises(FloatingPointError, match="aux/expert_load"):
        SyncReplicas._check_finite(
            state, grads, torch.tensor(1.0),
            {"mlm_accuracy": torch.tensor(0.5),
             "expert_load": torch.tensor([0.5, float("nan")])})


def test_cli_writes_vector_metrics_to_the_jsonl_only(tmp_path):
    """``cli.train --model moe_bert_tiny`` on the CPU: the summary hook's
    JSONL rows carry ``expert_load`` as a list of 4 (and
    ``dropped_token_fraction`` in [0, 1)), TensorBoard holds the scalar
    metrics and no ``expert_load`` tag, the logging hook's line has no
    vector, and the loss falls."""
    m, tb = str(tmp_path / "m.jsonl"), str(tmp_path / "tb")
    records = []

    class _Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    lg = logging.getLogger("dtx.hooks")
    h = _Grab()
    lg.addHandler(h)
    try:
        assert tcli.main(["--model", "moe_bert_tiny", "--device", "cpu",
                          "--batch_size", "8", "--seq_len", "32",
                          "--optimizer", "adamw", "--learning_rate", "3e-3",
                          "--train_steps", "6", "--log_every_steps", "3",
                          "--summary_every_steps", "1", "--metrics_path", m,
                          "--tb_logdir", tb]) == 0
    finally:
        lg.removeHandler(h)
    with open(m) as f:
        rows = [r for r in map(json.loads, f) if "expert_load" in r]
    assert [r["step"] for r in rows] == list(range(1, 7))
    for r in rows:
        assert isinstance(r["expert_load"], list) \
            and len(r["expert_load"]) == 4
        assert all(0.0 <= v <= 1.0 for v in r["expert_load"])
        assert 0.0 <= r["dropped_token_fraction"] < 1.0
        assert r["expert_load_min"] == min(r["expert_load"])
    assert rows[-1]["loss"] < rows[0]["loss"]
    path = [os.path.join(tb, f) for f in os.listdir(tb)][0]
    tags = {rec[1] for rec in tb_events.read_scalars(path)}
    assert {"loss", "mlm_loss", "expert_load_max",
            "dropped_token_fraction"} <= tags
    assert not any(t.startswith("expert_load/") or t == "expert_load"
                   for t in tags)
    logged = [r for r in records if r.startswith("step 3: loss=")]
    assert logged and "expert_load=" not in logged[0] \
        and "expert_load_min=" in logged[0]


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_two_gloo_ranks_write_vector_metrics(tmp_path):
    """``cli.train --model moe_bert_tiny`` as two workers (gloo, routing
    each global microbatch as one, ``--accum_steps 2``): rank 0
    alone writes the JSONL, whose every step row carries ``expert_load``
    as a list of 4 in [0, 1], the mean over the ranks of their
    microbatch means; both ranks exit 0."""
    m = str(tmp_path / "m.jsonl")
    hosts = ",".join(f"127.0.0.1:{p}" for p in _free_ports(2))
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))

    def rank(i):
        return subprocess.run(
            [sys.executable, "-m",
             "distributed_tensorflow_example_tpu_torch.cli.train",
             "--model", "moe_bert_tiny", "--device", "cpu", "--batch_size",
             "16", "--seq_len", "32", "--optimizer", "adamw",
             "--learning_rate", "1e-3", "--train_steps", "3",
             "--accum_steps", "2", "--summary_every_steps", "1",
             "--metrics_path", m, "--worker_hosts", hosts, "--task_index",
             str(i)], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=RANK_TIMEOUT_S)
    with ThreadPoolExecutor(2) as ex:
        out = list(ex.map(rank, range(2)))
    for r in out:
        assert r.returncode == 0, r.stdout + r.stderr
    with open(m) as f:
        recs = [json.loads(line) for line in f]
    starts = [r for r in recs if "start_step" in r]
    assert len(starts) == 1 and starts[0]["num_processes"] == 2
    rows = [r for r in recs if "expert_load" in r]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for r in rows:
        assert len(r["expert_load"]) == 4
        assert all(0.0 <= v <= 1.0 for v in r["expert_load"])
        assert np.isfinite(r["loss"]) and 0.0 <= r[
            "dropped_token_fraction"] < 1.0


# ---------------------------------------------------------------------------
# the static-batch export on :predict
# ---------------------------------------------------------------------------

EXPORT_B = 4


def _features(n: int, seed: int = 0) -> dict:
    """``n`` rows of MoE-BERT's serving features (S = 16, trailing pads,
    the first row unpadded, 3 masked positions)."""
    rs = np.random.RandomState(seed + n)
    s = 16
    lens = rs.randint(s // 2, s + 1, n)
    lens[0] = s
    return {"input_ids": rs.randint(1, 1000, (n, s)).astype(np.int32),
            "token_type_ids": np.zeros((n, s), np.int32),
            "attention_mask": (np.arange(s)[None] < lens[:, None]).astype(
                np.int32),
            "masked_positions": rs.randint(0, s // 2, (n, 3)).astype(
                np.int32)}


@pytest.fixture(scope="module")
def moe_export(tmp_path_factory):
    """(reference model and params, the port's export directory) of
    MoE-BERT-tiny at a static batch of EXPORT_B, the reference's init
    weights bridged in."""
    jm = jget_model("moe_bert_tiny", JConfig(model="moe_bert_tiny"))
    jp = jm.init(jax.random.key(0))
    tm = get_model("moe_bert_tiny", tconfig.TrainConfig(
        model="moe_bert_tiny"))
    tp = params_from_numpy(tm, jckpt._flatten(jp), device="cpu")
    d = str(tmp_path_factory.mktemp("moe_export"))
    export_model(tm, tp, {}, d, sample_batch=_features(EXPORT_B))
    return jm, jp, d


def test_static_export_metadata_equals_the_references(moe_export,
                                                      tmp_path):
    """The port's export.json for MoE-BERT is static-batch
    (``batch_polymorphic: false``) with the reference's input signature,
    model name and param count for the same sample batch (the reference
    falls back from its symbolic-batch trace)."""
    jm, jp, d = moe_export
    meta = read_meta(d)
    jd = str(tmp_path / "ref")
    jserving.export_model(jm, jp, {}, jd, platforms=("cpu",),
                          sample_batch=_features(EXPORT_B))
    with open(os.path.join(jd, "export.json")) as f:
        jmeta = json.load(f)
    assert jmeta["batch_polymorphic"] is False
    for key in ("model", "input_signature", "param_count",
                "batch_polymorphic"):
        assert meta[key] == jmeta[key], key


def _post(port: int, name: str, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("scheduler", ["off", "on"])
def test_static_export_serves_padded_rows_on_both_paths(moe_export,
                                                        scheduler):
    """1 to 4 rows POSTed to ``:predict`` answer row for row what the
    reference's MoE-BERT gives on the batch padded to 4 with row 0
    (within 1e-5 of the largest logit: f32 summation order); 5 rows get a
    400 naming the static batch. With the scheduler on every dispatch
    runs exactly 4 rows (the batcher caps its batch there) and the pad
    rows are counted."""
    jm, jp, d = moe_export
    feats = _features(EXPORT_B, seed=1)
    with PredictServer(d, device="cpu", scheduler=scheduler,
                       batch_max_wait_ms=1.0) as srv:
        for n in range(1, EXPORT_B + 1):
            rows = {k: v[:n] for k, v in feats.items()}
            padded = {k: np.concatenate([v, np.repeat(v[:1], EXPORT_B - n,
                                                      axis=0)])
                      for k, v in rows.items()}
            want = np.asarray(jm.apply(jp, {}, {k: jnp.asarray(v) for k, v
                                                in padded.items()})[0])[:n]
            got = np.asarray(_post(srv.port, srv.name, {
                "inputs": {k: v.tolist() for k, v in rows.items()}})[
                    "predictions"])
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, srv.name, {"inputs": {
                k: np.concatenate([v, v[:1]]).tolist()
                for k, v in feats.items()}})
        assert e.value.code == 400
        assert "static batch of 4" in json.loads(e.value.read())["error"]
        if scheduler == "on":
            assert srv.batcher.static_batch == EXPORT_B
            assert srv.batcher.batch_max_size == EXPORT_B
            assert srv.batcher.rows == 1 + 2 + 3 + 4
            assert srv.batcher.padded_rows == 3 + 2 + 1 + 0
        else:
            assert srv.batcher is None


def test_static_servable_pads_with_row_zero_and_truncates(moe_export):
    """The loaded artifact itself holds the static-batch rule: 1 to 4
    rows answer what the same servable gives on the batch padded to 4
    with row 0, bitwise (the same forward at the same batch); 5 rows are
    a ValueError naming the static batch."""
    _, _, d = moe_export
    sv = load_servable(d, device="cpu")
    assert static_batch(sv.meta) == EXPORT_B
    feats = _features(EXPORT_B, seed=2)
    for n in range(1, EXPORT_B + 1):
        rows = {k: v[:n] for k, v in feats.items()}
        padded = {k: np.concatenate([v, np.repeat(v[:1], EXPORT_B - n,
                                                  axis=0)])
                  for k, v in rows.items()}
        got = sv(rows)
        assert got.shape[0] == n
        np.testing.assert_array_equal(got, sv(padded)[:n])
    with pytest.raises(ValueError, match="static batch of 4"):
        sv({k: np.concatenate([v, v[:1]]) for k, v in feats.items()})
