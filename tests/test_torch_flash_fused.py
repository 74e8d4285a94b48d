"""The port's fused flash-attention backward (B3's plain version and its
route through ``flash_attention(bwd_variant="fused")``) against the
split backward and the JAX package's fused Pallas kernel, on the CPU.

On CPU tensors the fused wrapper is its plain version, which forms p and
ds once and takes the split plain versions' ops on them, so fused ==
split bitwise, as the reference's own contract holds for its kernels
(``tests/test_flash_attention.py:169-198``). Against the reference's
fused kernel, run in interpret mode where it engages (S a multiple of
128, D = 64, ``block_q=64``, ``block_k=128``), in f32, the two differ
only in summation order: grads within rtol 1e-4 / atol 1e-5, the
tolerance of ``tests/test_torch_flash_bwd.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.ops.cuda import \
    flash_attention as tflash

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

jflash = importlib.import_module(
    "distributed_tensorflow_example_tpu.ops.pallas.flash_attention")

RTOL, ATOL = 1e-4, 1e-5
B, H, D = 2, 2, 64


def _inputs(s, seed, n=3):
    rs = np.random.RandomState(seed)
    return [(0.4 * rs.randn(B, s, H, D)).astype(np.float32)
            for _ in range(n)]


def _port_grads(arrs, mask, causal, variant, cut=None):
    """Grads of sum(o[:, :cut]^2) w.r.t. q, k, v through the port's
    Function with the given backward variant."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    o = tflash.flash_attention(
        q, k, v, causal=causal, bwd_variant=variant,
        mask=None if mask is None else torch.from_numpy(mask))
    (o[:, :cut] ** 2).sum().backward()
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("causal", [False, True])
def test_fused_matches_split_bitwise(causal):
    arrs = _inputs(128, seed=12 + causal)
    for a, b in zip(_port_grads(arrs, None, causal, "split"),
                    _port_grads(arrs, None, causal, "fused")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fused_matches_split_bitwise_masked():
    """S = 200 (no tile multiple), keys 150.. masked, loss over the first
    150 queries."""
    arrs = _inputs(200, seed=13)
    mask = np.ones((B, 200), np.int32)
    mask[:, 150:] = 0
    for a, b in zip(_port_grads(arrs, mask, False, "split", cut=150),
                    _port_grads(arrs, mask, False, "fused", cut=150)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("s,causal,masked", [
    (128, True, False), (128, True, True), (256, True, False),
    (256, True, True), (128, False, True)])
def test_fused_grads_match_pallas_fused_interpret(s, causal, masked):
    """The port's fused grads against the reference's fused kernel
    (``_bwd_fused_kernel``, interpret mode); a left pad of 37 keys in
    row 1 when masked, whose queries (causal) see no key and get dq = 0
    in both."""
    assert jflash.kernel_engages(s, D, block_q=64, block_k=128)
    assert jflash.effective_bwd_variant(s, D, "fused") == "fused"
    arrs = _inputs(s, seed=s + 3 * causal + masked)
    mask = None
    if masked:
        mask = np.ones((B, s), np.int32)
        mask[1, :37] = 0
    got = _port_grads(arrs, mask, causal, "fused")
    m = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        return jnp.sum(jflash.flash_attention(
            q, k, v, mask=m, causal=causal, block_q=64, block_k=128,
            bwd_variant="fused") ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")
    if masked:
        dq, dk, dv = (g.numpy() for g in got)
        assert not dk[1, :37].any() and not dv[1, :37].any()
        if causal:
            assert not dq[1, :37].any()


@pytest.mark.parametrize("seq,head_dim", [
    (512, 64), (32768, 64), (32769, 64), (16384, 128), (16385, 128),
    (4096, 256)])
@pytest.mark.parametrize("variant", ["split", "fused"])
def test_effective_bwd_variant_agrees_with_the_reference(seq, head_dim,
                                                         variant):
    """Both sides of the 8 MiB dq-slab limit: S * D * 4 bytes > 8 MiB
    runs split in both packages."""
    assert tflash._FUSED_SLAB_LIMIT == jflash._FUSED_SLAB_LIMIT
    assert tflash.BWD_VARIANTS == jflash.BWD_VARIANTS
    got = tflash.effective_bwd_variant(seq, head_dim, variant)
    assert got == jflash.effective_bwd_variant(seq, head_dim, variant)
    over = seq * head_dim * 4 > 8 * 2**20
    assert got == ("split" if over or variant == "split" else "fused")


def test_fused_wrapper_is_its_plain_version_on_the_cpu():
    """On CPU tensors the wrapper returns its plain version's outputs,
    bitwise equal to the split plain versions', and counts no launch,
    also through the Function's backward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(128, seed=5, n=4))
    mask = torch.ones((B, 128), dtype=torch.int32)
    mask[1, :9] = 0
    o, lse = tflash.flash_attention_fwd(q, k, v, mask, causal=True)
    dsum = tflash.flash_attention_dsum(do, o)
    before = tflash.flash_attention_bwd_fused.launches
    got = tflash.flash_attention_bwd_fused(q, k, v, do, lse, dsum, mask,
                                           True)
    plain = tflash.flash_attention_bwd_fused_plain(q, k, v, do, lse, dsum,
                                                   mask, True)
    split = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, mask,
                                             True)
    for g, p, s in zip(got, plain, split):
        np.testing.assert_array_equal(g.numpy(), p.numpy())
        np.testing.assert_array_equal(g.numpy(), s.numpy())
    _port_grads(_inputs(128, seed=6), None, True, "fused")
    assert tflash.flash_attention_bwd_fused.launches == before
    # an unknown variant is refused before any work
    with pytest.raises(ValueError, match="bwd_variant"):
        tflash.flash_attention(q, k, v, bwd_variant="ring")


def test_gpt_with_attention_bwd_fused_takes_the_fused_backward(monkeypatch):
    """``get_model`` with ``attention_impl="flash"`` and
    ``attention_bwd="fused"`` builds a GPT whose backward calls the fused
    wrapper once a layer (on the card: one B3 launch a layer) and the
    split wrappers never."""
    calls = {"fused": 0, "dq": 0, "dkv": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name, attr in (("fused", "flash_attention_bwd_fused"),
                       ("dq", "flash_attention_bwd_dq"),
                       ("dkv", "flash_attention_bwd_dkv")):
        monkeypatch.setattr(tflash, attr, counted(name,
                                                  getattr(tflash, attr)))
    cfg = tconfig.TrainConfig(model="gpt_tiny", attention_impl="flash",
                              attention_bwd="fused")
    model = get_model("gpt_tiny", cfg)
    assert model.attention_kwargs == {"bwd_variant": "fused"}
    params = model.init(0, device="cpu")
    leaves = [p.requires_grad_() for p in
              jax.tree_util.tree_leaves(params, is_leaf=torch.is_tensor)]
    ids = torch.from_numpy(
        np.random.RandomState(0).randint(0, 1000, (2, 64)).astype(np.int32))
    loss, _ = model.loss(params, {}, {"input_ids": ids})
    loss.backward()
    assert calls == {"fused": model.cfg.layers, "dq": 0, "dkv": 0}
    assert all(p.grad is not None for p in leaves)
