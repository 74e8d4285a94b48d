"""The port's GPT (inference half) against the JAX package's, on bridged
weights, on the CPU.

A small GPT (vocab 512, hidden 128, 2 heads of 64, 2 layers, max_len
256) is initialised by the JAX package, its parameters cross over as
numpy arrays keyed as the reference checkpoint keys them, and both
packages run the same token ids. In f32 the two differ only in matmul
summation order, so logits and caches agree to 1e-4 and greedy tokens
are equal. The helpers here are shared with ``test_torch_serving.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt.checkpoint import _flatten
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu_torch.config import TrainConfig
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.ops.attention import NEG_INF

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

SMALL = dict(vocab_size=512, hidden=128, layers=2, heads=2,
             intermediate=256, max_len=256)
F32_TOL = 1e-4


def make_pair(dtype="float32", attention_impl="xla", seed=0):
    """(jax model, jax params, port model, port params) with the same
    weights: the port's come through the numpy bridge."""
    jm = JGPT(JGPTConfig(**SMALL), dtype=getattr(jnp, dtype),
              attention_impl=attention_impl)
    jp = jm.init(jax.random.key(seed))
    tm = GPT(GPTConfig(**SMALL), dtype=getattr(torch, dtype),
             attention_impl=attention_impl)
    tp = params_from_numpy(tm, _flatten(jp), device="cpu")
    return jm, jp, tm, tp


def prompts(b=3, s=12, seed=1):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], (b, s)).astype(np.int32)


def ragged_mask(b=3, s=12):
    """Left-aligned real tokens of lengths s, s-5, 1 (pads on the right,
    the client's convention; generate right-packs them)."""
    m = np.zeros((b, s), np.int32)
    for i, n in enumerate([s, s - 5, 1][:b]):
        m[i, :n] = 1
    return m


def jax_generate(jm, jp, ids, max_new, mask=None, **kw):
    return np.asarray(jm.generate(
        jp, jnp.asarray(ids), max_new, decode_impl="loop",
        prompt_mask=None if mask is None else jnp.asarray(mask), **kw))


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_bridge_keys_shapes_and_round_trip(pair):
    jm, jp, tm, tp = pair
    flat = _flatten(jp)
    assert {k: v.shape for k, v in flat.items()} == tm.param_shapes()
    back = params_to_numpy(tp)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tm, {k: v for k, v in flat.items()
                               if k != "wte/table"}, device="cpu")
    bad = dict(flat)
    bad["layer_0/attn/q/kernel"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tm, bad, device="cpu")


def test_apply_logits_match_in_f32(pair):
    jm, jp, tm, tp = pair
    ids = prompts(s=20)
    mask = np.ones_like(ids)
    mask[1, 15:] = 0
    want, _ = jm.apply(jp, None, {"input_ids": jnp.asarray(ids),
                                  "attention_mask": jnp.asarray(mask)})
    got, _ = tm.apply(tp, None, {"input_ids": torch.from_numpy(ids),
                                 "attention_mask": torch.from_numpy(mask)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_apply_logits_close_in_bf16():
    """bf16 compute in both packages, f32 logits (never rounded to bf16,
    so greedy argmax sees the same near-ties): the rounding points are
    the same, but XLA and PyTorch round intermediate bf16 values from
    differently ordered f32 sums, so agreement is to a few bf16 ulps of
    the logits' scale (std ~0.5): 0.05."""
    jm, jp, tm, tp = make_pair("bfloat16")
    ids = prompts(s=20)
    want, _ = jm.apply(jp, None, {"input_ids": jnp.asarray(ids)})
    got, _ = tm.apply(tp, None, {"input_ids": torch.from_numpy(ids)})
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-2)


def test_prefill_caches_match(pair):
    jm, jp, tm, tp = pair
    ids = prompts()
    total = ids.shape[1] + 6
    jh, jc = jm._prefill(jp, jnp.asarray(ids), total)
    th, tc = tm._prefill(tp, torch.from_numpy(ids), total)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=F32_TOL,
                               atol=F32_TOL)
    for i in range(SMALL["layers"]):
        for n in ("k", "v"):
            got, want = tc[f"layer_{i}"][n], jc[f"layer_{i}"][n]
            assert tuple(got.shape) == tuple(want.shape)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=f"layer {i} {n}")


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_matches_reference_loop(pair, ragged):
    """Greedy tokens equal the reference's ``decode_impl="loop"`` (its
    parity oracle), through the port's stacked path (the kernel path)
    and its loop path."""
    jm, jp, tm, tp = pair
    ids = prompts()
    mask = ragged_mask() if ragged else None
    want = jax_generate(jm, jp, ids, 10, mask)
    t_mask = None if mask is None else torch.from_numpy(mask)
    got = tm.generate(tp, torch.from_numpy(ids), 10, prompt_mask=t_mask)
    got_loop = tm.generate(tp, torch.from_numpy(ids), 10,
                           prompt_mask=t_mask, decode_impl="loop")
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_loop.numpy(), want)


def test_stacked_step_matches_loop_step(pair):
    """One decode step: the stacked step (fused QKV, the decode-kernel
    wrapper) reproduces the per-layer loop step's logits and cache
    writes."""
    _, _, tm, tp = pair
    ids = torch.from_numpy(prompts())
    total = ids.shape[1] + 4
    _, caches = tm._prefill(tp, ids, total)
    tok = torch.tensor([5, 7, 11], dtype=torch.int32)
    pad = torch.tensor([0, 2, 5], dtype=torch.int32)
    loop_caches = {n: {m: x.clone() for m, x in c.items()}
                   for n, c in caches.items()}
    want, want_c = tm._decode_step(tp, loop_caches, tok, ids.shape[1], pad)
    got, got_c = tm._decode_step_stacked(
        tp, tm.stack_decode_params(tp), tm._stack_caches(caches), tok,
        ids.shape[1], pad)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    for i in range(SMALL["layers"]):
        for n in ("k", "v"):
            np.testing.assert_allclose(
                got_c[n][i].numpy(), want_c[f"layer_{i}"][n].numpy(),
                rtol=1e-6, atol=1e-6, err_msg=f"layer {i} {n}")


def test_flash_prefill_matches_reference_flash():
    """``attention_impl="flash"`` in both packages: the reference's
    Pallas kernel (interpret mode; S = 128 so it engages) and the port's
    flash wrapper (its plain version on the CPU) give the same prefill
    and the same greedy tokens, plain and ragged."""
    jm, jp, tm, tp = make_pair(attention_impl="flash")
    ids = prompts(b=2, s=128, seed=3)
    mask = np.ones_like(ids)
    mask[1, 100:] = 0
    jh, _ = jm._prefill(jp, jnp.asarray(ids), 130)
    th, _ = tm._prefill(tp, torch.from_numpy(ids), 130)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=F32_TOL,
                               atol=F32_TOL)
    want = jax_generate(jm, jp, ids, 3, mask)
    got = tm.generate(tp, torch.from_numpy(ids), 3,
                      prompt_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_eos_early_stop_matches_reference(pair):
    jm, jp, tm, tp = pair
    ids = prompts()
    free = jax_generate(jm, jp, ids, 8)
    eos = int(free[0, 2])                  # row 0 stops at step 2
    want = jax_generate(jm, jp, ids, 8, eos_id=eos, pad_id=-1)
    got = tm.generate(tp, torch.from_numpy(ids), 8, eos_id=eos, pad_id=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 3:] == -1).all()


def test_filter_logits_masks_equal_reference(pair):
    jm, _, tm, _ = pair
    rs = np.random.RandomState(4)
    logits = rs.randn(4, 512).astype(np.float32)
    logits[1, :6] = logits[1].max()        # a tie at the top
    logits[2, ::7] = 0.25                  # a run of ties mid-distribution
    for top_k, top_p in [(1, 0.0), (5, 0.0), (40, 0.0), (0, 0.3),
                         (0, 0.9), (20, 0.5), (512, 1.0)]:
        want = np.asarray(jm._filter_logits(jnp.asarray(logits), top_k,
                                            top_p))
        got = tm._filter_logits(torch.from_numpy(logits), top_k,
                                top_p).numpy()
        np.testing.assert_array_equal(got > NEG_INF / 2, want > NEG_INF / 2,
                                      err_msg=f"top_k={top_k} top_p={top_p}")
        np.testing.assert_array_equal(got, want)


def test_sampled_generation_is_deterministic_per_seed(pair):
    _, _, tm, tp = pair
    ids = torch.from_numpy(prompts())

    def run(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tm.generate(tp, ids, 12, temperature=0.9, rng=g,
                           prompt_mask=torch.from_numpy(ragged_mask()), **kw)

    a, b, c = run(7, top_k=50), run(7, top_k=50), run(8, top_k=50)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # top_k=1 keeps only the argmax: sampling equals greedy
    greedy = tm.generate(tp, ids, 12,
                         prompt_mask=torch.from_numpy(ragged_mask()))
    assert torch.equal(run(3, top_k=1), greedy)


@pytest.mark.parametrize("kwargs,match", [
    (dict(top_k=5), "temperature"),
    (dict(temperature=1.0, top_p=1.5, rng=True), "top_p"),
    (dict(temperature=1.0, top_k=-3, rng=True), "top_k"),
    (dict(temperature=1.0), "needs rng"),
    (dict(prompt_mask=np.ones((2, 4), np.int32)), "prompt_mask"),
    (dict(max_new_tokens=400), "max_len"),
    (dict(max_new_tokens=-1), "max_new_tokens"),
    (dict(decode_impl="scan"), "decode_impl"),
    (dict(decode_impl="loop", decode_attention="xla"), "decode_attention"),
])
def test_generate_argument_checks_match_reference(pair, kwargs, match):
    """Every argument check of the reference's generate raises the same
    ValueError in both packages."""
    jm, jp, tm, tp = pair
    ids = np.zeros((1, 4), np.int32)
    kwargs = dict(kwargs)
    n = kwargs.pop("max_new_tokens", 2)
    jkw, tkw = dict(kwargs), dict(kwargs)
    if kwargs.pop("rng", None):
        jkw["rng"], tkw["rng"] = jax.random.key(0), torch.Generator()
    if "prompt_mask" in kwargs:
        jkw["prompt_mask"] = jnp.asarray(kwargs["prompt_mask"])
        tkw["prompt_mask"] = torch.from_numpy(kwargs["prompt_mask"])
    with pytest.raises(ValueError, match=match):
        jm.generate(jp, jnp.asarray(ids), n, **jkw)
    with pytest.raises(ValueError, match=match):
        tm.generate(tp, torch.from_numpy(ids), n, **tkw)


def test_registered_configs():
    m = get_model("gpt", TrainConfig(model="gpt", dtype="bfloat16",
                                     attention_impl="flash"))
    c = m.cfg
    assert (c.vocab_size, c.hidden, c.layers, c.heads, c.intermediate,
            c.max_len) == (30522, 768, 12, 12, 3072, 1024)
    assert m.dtype == torch.bfloat16 and m.param_dtype == torch.float32
    assert m.attention_impl == "flash" and m.head_dim == 64
    tiny = get_model("gpt_tiny")
    assert (tiny.cfg.vocab_size, tiny.cfg.hidden) == (1000, 128)
    # the MLP registers since the MNIST slice, BERT since slice A3c-3,
    # MoE-BERT since A5b-1, the pipeline models since A6c, the
    # expert-parallel pipeline models since A6d; a name no package
    # registers is a KeyError
    assert get_model("mlp").hidden == 100
    assert get_model("bert_tiny").cfg.hidden == 128
    assert get_model("moe_bert_tiny").cfg.n_experts == 4
    assert get_model("pipe_bert_tiny").cfg.layers == 4
    assert get_model("pipe_mlp").cfg.blocks == 4
    assert get_model("pipe_moe_bert_tiny").cfg.n_experts == 4
    with pytest.raises(KeyError, match="unknown model"):
        get_model("pipe_gpt_tiny")
