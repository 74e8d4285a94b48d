"""The port's flash-attention backward against the JAX package's, on the
CPU.

On CPU tensors ``flash_attention`` runs the port's autograd Function
with the plain versions of B1, B2a and B2b, so these tests hold the
backward's algebra (and the graph it builds) to the JAX package's Pallas
backward, run in interpret mode at shapes where it engages (S a multiple
of 128, D = 64, ``block_k=128``), in f32. The two differ only in
summation order: grads within rtol 1e-4 / atol 1e-5, as the JAX
package's own grad tests hold its kernel to its XLA path
(``tests/test_flash_attention.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu_torch.ops import attention as tattn
from distributed_tensorflow_example_tpu_torch.ops.cuda import \
    flash_attention as tflash

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

jflash = importlib.import_module(
    "distributed_tensorflow_example_tpu.ops.pallas.flash_attention")

RTOL, ATOL = 1e-4, 1e-5
B, H, D = 2, 2, 64


def _inputs(s, seed):
    rs = np.random.RandomState(seed)
    return [(0.4 * rs.randn(B, s, H, D)).astype(np.float32)
            for _ in range(3)]


def _left_pad_mask(s, pads):
    m = np.ones((B, s), np.int32)
    for i, p in enumerate(pads):
        m[i, :p] = 0
    return m


def _port_grads(arrs, mask, causal):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs)
    o = tflash.flash_attention(
        q, k, v, causal=causal,
        mask=None if mask is None else torch.from_numpy(mask))
    (o ** 2).sum().backward()
    return o, (q.grad, k.grad, v.grad)


def _ref_grads(arrs, mask, causal):
    m = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v, mask=m, causal=causal,
                                              block_k=128) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal,masked", [(True, False), (False, True),
                                           (True, True)])
def test_flash_grads_match_pallas_interpret(s, causal, masked):
    """Grads of sum(o^2) w.r.t. q, k and v: causal, key-masked (a left
    pad), and both, where the left-pad rows see no key at all and get
    zero grads in both packages."""
    assert jflash.kernel_engages(s, D, block_k=128)
    arrs = _inputs(s, seed=s + 3 * causal + masked)
    mask = _left_pad_mask(s, [0, 37]) if masked else None
    _, got = _port_grads(arrs, mask, causal)
    want = _ref_grads(arrs, mask, causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")
    if masked:
        dq, dk, dv = (g.numpy() for g in got)
        assert not dk[1, :37].any() and not dv[1, :37].any()
        if causal:
            assert not dq[1, :37].any()


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_plain_matches_reference_bwd(causal):
    """``flash_attention_bwd_plain`` directly against the reference's
    ``_bwd`` (the split kernels in interpret mode) on the same q, k, v,
    o, L and dO, with a left-pad key mask."""
    s = 128
    q, k, v = _inputs(s, seed=7 + causal)
    do = (0.3 * np.random.RandomState(9).randn(B, s, H, D)).astype(
        np.float32)
    mask = _left_pad_mask(s, [0, 21])

    def fold(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, s, D)

    def unfold(x):
        return np.asarray(x).reshape(B, H, s, D).transpose(0, 2, 1, 3)

    o3, L = jflash._fwd(fold(q), fold(k), fold(v), jnp.asarray(mask),
                        heads=H, blk_q=128, blk_k=128, causal=causal)
    want = jflash._bwd(fold(q), fold(k), fold(v), o3, fold(do), L,
                       jnp.asarray(mask), heads=H, blk_q=128, blk_k=128,
                       causal=causal)
    o = torch.from_numpy(unfold(o3).copy())
    lse = torch.from_numpy(np.asarray(L)[..., 0].reshape(B, H, s).copy())
    got = tflash.flash_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), o, lse,
        torch.from_numpy(do), torch.from_numpy(mask), causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), unfold(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")


def test_flash_output_carries_the_graph_on_the_cpu():
    """The flash output has a grad_fn (the port's Function) and the grads
    reach q, k and v; the backward's wrappers take their plain versions
    on CPU tensors and count no launch. Under ``no_grad``, or with no
    input requiring grad, nothing is recorded."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _inputs(128, seed=1))
    before = (tflash.flash_attention_bwd_dq.launches,
              tflash.flash_attention_bwd_dkv.launches)
    o = tattn.multi_head_attention(q, k, v, causal=True, impl="flash")
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    o.sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (q, k, v))
    assert (tflash.flash_attention_bwd_dq.launches,
            tflash.flash_attention_bwd_dkv.launches) == before
    with torch.no_grad():
        assert tflash.flash_attention(q, k, v, causal=True).grad_fn is None
    qd, kd, vd = (t.detach() for t in (q, k, v))
    assert tflash.flash_attention(qd, kd, vd, causal=True).grad_fn is None


def test_bwd_wrappers_are_their_plain_versions_on_the_cpu():
    arrs = _inputs(128, seed=2)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    do = torch.from_numpy(_inputs(128, seed=3)[0])
    mask = torch.from_numpy(_left_pad_mask(128, [0, 5]))
    o, lse = tflash.flash_attention_fwd(q, k, v, mask, causal=True)
    dsum = tflash.flash_attention_dsum(do, o)
    assert tuple(dsum.shape) == (B, H, 128) and dsum.is_contiguous()
    dq = tflash.flash_attention_bwd_dq(q, k, v, do, lse, dsum, mask, True)
    dk, dv = tflash.flash_attention_bwd_dkv(q, k, v, do, lse, dsum, mask,
                                            True)
    want = tflash.flash_attention_bwd_plain(q, k, v, o, lse, do, mask, True)
    for got, ref in zip((dq, dk, dv), want):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_fused_backward_and_tile_levers_are_refused():
    q = torch.zeros(1, 8, 1, 64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="A3b"):
        tflash.flash_attention(q, q, q, bwd_variant="fused")
    with pytest.raises(NotImplementedError, match="bwd_block"):
        tflash.flash_attention(q, q, q, bwd_block=128)
    with pytest.raises(ValueError, match="bwd_variant"):
        tflash.flash_attention(q, q, q, bwd_variant="ring")
    m = q.detach().to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention_bwd_dq(m, m, m, m, None, None)
