"""The port's nn primitives against the JAX package's ``ops/nn.py``.

Same inputs (numpy, seeded) through both; each case states its
tolerance. f32 cases differ only in summation order; bf16 cases are
allowed one bf16 rounding step (2**-7 relative) where an f32 sum that
differs in its last bits rounds to the neighbouring bf16 value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ops import nn as jnn
from distributed_tensorflow_example_tpu_torch.ops import nn as tnn

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

BF16_RTOL = 2.0 ** -7


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    """jax array or torch tensor -> f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _dense_params(rs, din, dout):
    return {"kernel": (rs.randn(din, dout) / np.sqrt(din)).astype(np.float32),
            "bias": rs.randn(dout).astype(np.float32)}


def test_dense_f32_matches_reference():
    rs = np.random.RandomState(0)
    p = _dense_params(rs, 32, 48)
    x = rs.randn(4, 7, 32).astype(np.float32)
    want = jnn.dense({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x))
    got = tnn.dense({k: _t(v) for k, v in p.items()}, _t(x))
    assert got.dtype == torch.float32
    # f32: summation order only
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_dense_bf16_contract():
    """bf16 operands, f32 accumulation rounded ONCE to bf16, then the
    bias added in bf16: the port's output is bf16 and equals the
    reference within one bf16 rounding step, and equals the contract
    written out by hand."""
    rs = np.random.RandomState(1)
    p = _dense_params(rs, 64, 96)
    x = rs.randn(3, 5, 64).astype(np.float32)
    want = jnn.dense({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), dtype=jnp.bfloat16)
    got = tnn.dense({k: _t(v) for k, v in p.items()}, _t(x),
                    dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                               atol=BF16_RTOL)
    acc = (_t(x).to(torch.bfloat16).double()
           @ _t(p["kernel"]).to(torch.bfloat16).double())
    by_hand = acc.to(torch.bfloat16) + _t(p["bias"]).to(torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(by_hand), rtol=BF16_RTOL,
                               atol=BF16_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spread", [1.0, 1e-3])
def test_layernorm_matches_reference(dtype, spread):
    """Statistics in f32 with eps 1e-6. The small-spread case (variance
    ~1e-6) tells eps 1e-6 from PyTorch's default 1e-5 by ~40%. The
    mean scales with the spread so both cases are equally conditioned
    (f32 cancellation in x - mean stays far below the tolerance)."""
    rs = np.random.RandomState(2)
    x = (spread * (3.0 + rs.randn(6, 128))).astype(np.float32)
    p = {"scale": rs.randn(128).astype(np.float32),
         "bias": rs.randn(128).astype(np.float32)}
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                                else jnp.float32)
    tx = _t(x).to(getattr(torch, dtype))
    want = jnn.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jx)
    got = tnn.layernorm({k: _t(v) for k, v in p.items()}, tx)
    assert got.dtype == tx.dtype
    tol = 1e-4 if dtype == "float32" else 2 * BF16_RTOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_layernorm_eps_is_the_references():
    rs = np.random.RandomState(3)
    x = (1e-3 * rs.randn(2, 64)).astype(np.float32)
    p = {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)}
    got = tnn.layernorm({k: _t(v) for k, v in p.items()}, _t(x))
    torch_default = torch.nn.functional.layer_norm(_t(x), (64,))
    assert not np.allclose(_np(got), _np(torch_default), rtol=1e-2)
    want = jnn.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_embedding_is_a_plain_take():
    rs = np.random.RandomState(4)
    table = rs.randn(50, 16).astype(np.float32)
    ids = rs.randint(0, 50, (3, 9)).astype(np.int32)
    want = jnn.embedding({"table": jnp.asarray(table)}, jnp.asarray(ids))
    got = tnn.embedding({"table": _t(table)}, _t(ids).long())
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gelu_is_the_tanh_approximation():
    import jax
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = jax.nn.gelu(jnp.asarray(x))          # approximate=True default
    got = tnn.gelu(_t(x))
    # f32 transcendental implementations differ in the last bits
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(_t(x))
    assert not np.allclose(_np(got), _np(exact), rtol=0, atol=1e-5)


def test_initialisers_are_seeded_and_shaped():
    gen = torch.Generator().manual_seed(5)
    d = tnn.dense_init(gen, 128, 256, init="glorot")
    assert d["kernel"].shape == (128, 256) and d["bias"].shape == (256,)
    limit = np.sqrt(6.0 / (128 + 256))          # glorot-uniform bound
    assert float(d["kernel"].abs().max()) <= limit
    assert float(d["bias"].abs().max()) == 0.0
    e = tnn.embedding_init(torch.Generator().manual_seed(5), 100, 32)
    assert abs(float(e["table"].std()) - 0.02) < 0.003
    d2 = tnn.dense_init(torch.Generator().manual_seed(5), 128, 256,
                        init="glorot")
    assert torch.equal(d["kernel"], d2["kernel"])
