"""The port's convolutional slice against the JAX package's, on the CPU:
the conv, pool and batch-norm ops (values and gradients), the conv init's
moments, LeNet, ResNet-20 and a tiny bottleneck ResNet with the ImageNet
stem on weights bridged through the npz checkpoint format, a 5-step
momentum trajectory through both ``SyncReplicas``, the CIFAR reader, the
synthetic sets and the augmentation, checkpoints that carry the batch
norm statistics both ways, and the CLI with ``lenet`` and ``resnet20``.

Tolerances are stated per test. f32 differences come from summation
order. The reference's gradients through batch norm carry more rounding
than the port's (its f32 reductions on the CPU sum in sequence, and
``E[x^2] - mean^2`` and the norm's backward cancel): where a test holds
gradients or a trajectory, an f64 evaluation of the same function is
the oracle that tells rounding from a different function.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.cli import train as jcli
from distributed_tensorflow_example_tpu.data import cifar as jcifar
from distributed_tensorflow_example_tpu.data import imagenet as jimagenet
from distributed_tensorflow_example_tpu.data import loader as jloader
from distributed_tensorflow_example_tpu.data import mnist as jmnist
from distributed_tensorflow_example_tpu.models import lenet as jlenet
from distributed_tensorflow_example_tpu.models import resnet as jresnet
from distributed_tensorflow_example_tpu.ops import nn as jnn
from distributed_tensorflow_example_tpu.parallel.mesh import local_mesh
from distributed_tensorflow_example_tpu.parallel.sync_replicas import \
    SyncReplicas as JSyncReplicas
from distributed_tensorflow_example_tpu.train import optimizers as jopt
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.data import cifar as tcifar
from distributed_tensorflow_example_tpu_torch.data import \
    imagenet as timagenet
from distributed_tensorflow_example_tpu_torch.data import loader as tloader
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models import lenet as tlenet
from distributed_tensorflow_example_tpu_torch.models import resnet as tresnet
from distributed_tensorflow_example_tpu_torch.ops import nn as tnn
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train import optimizers as topt
from distributed_tensorflow_example_tpu_torch.utils.pytree import (
    flatten_dict, tree_map, unflatten_dict)

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _vjp_ref(fn, *args, ct):
    """(output, grads of <output, ct> in every arg) of a JAX function."""
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return out, vjp(jnp.asarray(ct))


def _vjp_port(fn, *args, ct):
    ts = [_t(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, grad_outputs=_t(ct))
    return out, grads


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

CONV_CASES = [(k, s, n, pad) for k in (1, 3, 5, 7) for s in (1, 2)
              for n in (9, 12) for pad in ("SAME", "VALID")]


@pytest.mark.parametrize("k,stride,size,padding", CONV_CASES,
                         ids=[f"k{k}-s{s}-n{n}-{p}"
                              for k, s, n, p in CONV_CASES])
def test_conv2d_matches_reference(k, stride, size, padding):
    """NHWC x HWIO at every kernel size of the two ResNets and LeNet,
    strides 1 and 2, odd and even sizes, "SAME" (asymmetric at stride 2:
    a torch padding of k // 2 would shift the windows) and "VALID":
    output, and the gradients of x, the kernel and the bias under a
    random cotangent, within 1e-5 of the largest value (f32; sums of at
    most 7*7*3 products forward, 12*12*2 backward)."""
    rs = np.random.RandomState(k * 100 + stride * 10 + size)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    w = rs.randn(k, k, 3, 4).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    out = jnn.conv2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride, padding=padding)
    ct = rs.randn(*out.shape).astype(np.float32)
    want, jg = _vjp_ref(lambda x, w, b: jnn.conv2d(
        {"kernel": w, "bias": b}, x, stride=stride, padding=padding),
        x, w, b, ct=ct)
    got, tg = _vjp_port(lambda x, w, b: tnn.conv2d(
        {"kernel": w, "bias": b}, x, stride=stride, padding=padding),
        x, w, b, ct=ct)
    assert tuple(got.shape) == want.shape
    for name, g, r in (("y", got, want),) + tuple(
            zip(("dx", "dw", "db"), tg, jg)):
        r = np.asarray(r)
        np.testing.assert_allclose(_np(g), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


def test_same_padding_is_xlas_split():
    """The pads that the asymmetric cases come to: 7x7/2 on 224 pads
    (2, 3), 3x3/2 on an even size (0, 1), 3x3/2 on 7 (1, 1), 3x3/1
    (1, 1) and 1x1/2 none."""
    assert tnn._same_pads(224, 7, 2) == (2, 3)
    assert tnn._same_pads(56, 3, 2) == (0, 1)
    assert tnn._same_pads(32, 3, 2) == (0, 1)
    assert tnn._same_pads(7, 3, 2) == (1, 1)
    assert tnn._same_pads(28, 3, 1) == (1, 1)
    assert tnn._same_pads(56, 1, 2) == (0, 0)
    with pytest.raises(ValueError, match="SAME"):
        tnn.conv2d({"kernel": torch.zeros(3, 3, 1, 1)},
                   torch.zeros(1, 5, 5, 1), padding="same")


@pytest.mark.parametrize("stride", [1, 2])
def test_f32_conv_runs_without_tf32(monkeypatch, stride):
    """The card's f32 conv path (``_F32Conv2d``, run here on CPU tensors):
    forward and both gradients bitwise those of ``F.conv2d`` under
    autograd, with cuDNN's TF32 flag read False inside the forward and
    inside the backward, and the caller's True back after each."""
    seen = []
    conv, grads = tnn.F.conv2d, tnn._conv2d_grads

    def spy_conv(*a, **k):
        seen.append(("forward", torch.backends.cudnn.allow_tf32))
        return conv(*a, **k)

    def spy_grads(*a, **k):
        seen.append(("backward", torch.backends.cudnn.allow_tf32))
        return grads(*a, **k)

    rs = np.random.RandomState(stride)
    x = _t(rs.randn(2, 9, 9, 5).astype(np.float32)).permute(0, 3, 1, 2)
    w = _t(rs.randn(4, 3, 3, 5).astype(np.float32)).permute(0, 3, 1, 2)
    ct = _t(rs.randn(2, 4, 9 // stride, 9 // stride).astype(np.float32))
    want = conv(x, w, stride=stride)
    ct = ct[..., :want.shape[2], :want.shape[3]]
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want_g = torch.autograd.grad(conv(xr, wr, stride=stride), [xr, wr], ct)
    monkeypatch.setattr(tnn.F, "conv2d", spy_conv)
    monkeypatch.setattr(tnn, "_conv2d_grads", spy_grads)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    got = tnn._F32Conv2d.apply(xr, wr, stride)
    assert torch.backends.cudnn.allow_tf32
    got_g = torch.autograd.grad(got, [xr, wr], ct)
    assert torch.backends.cudnn.allow_tf32
    assert seen == [("forward", False), ("backward", False)]
    assert torch.equal(got, want)
    for g, r in zip(got_g, want_g):
        assert torch.equal(g, r)


def test_conv2d_bf16_compute_matches_reference():
    """bf16 compute on f32 params: both packages round x and the kernel
    to bf16, accumulate in f32 and round the output to bf16, so they
    differ by a rounding flip at most: within 2 bf16 ulps of the largest
    output (2 * 2^-8 of it)."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 10, 10, 8).astype(np.float32)
    w = rs.randn(3, 3, 8, 16).astype(np.float32)
    want = np.asarray(jnn.conv2d({"kernel": jnp.asarray(w)},
                                 jnp.asarray(x), stride=2,
                                 dtype=jnp.bfloat16), np.float32)
    got = tnn.conv2d({"kernel": _t(w)}, _t(x), stride=2,
                     dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=2 * 2 ** -8 * np.abs(want).max())


POOL_CASES = [(kind, w, s, pad, n) for kind in ("max", "avg")
              for w, s in ((2, 2), (3, 2), (3, 1))
              for pad in ("VALID", "SAME") for n in (7, 8)]


@pytest.mark.parametrize("kind,window,stride,padding,size", POOL_CASES,
                         ids=[f"{k}-w{w}s{s}-{p}-n{n}"
                              for k, w, s, p, n in POOL_CASES])
def test_pools_match_reference(kind, window, stride, padding, size):
    """max_pool (SAME pads -inf) and avg_pool (SAME pads 0 and still
    divides by window^2): output and input gradient equal the
    reference's within 1e-6 (max pool: the same element; avg: a sum of
    at most 9 terms)."""
    rs = np.random.RandomState(size * 7 + window)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    jf = getattr(jnn, f"{kind}_pool")
    tf = getattr(tnn, f"{kind}_pool")
    shape = jf(jnp.asarray(x), window, stride, padding).shape
    ct = rs.randn(*shape).astype(np.float32)
    want, (jgx,) = _vjp_ref(lambda x: jf(x, window, stride, padding), x,
                            ct=ct)
    got, (tgx,) = _vjp_port(lambda x: tf(x, window, stride, padding), x,
                            ct=ct)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(_np(tgx), np.asarray(jgx), atol=1e-6)


BN_CASES = [(train, stats, xdt) for train in (True, False)
            for stats in ("float32", "bfloat16")
            for xdt in ("float32", "bfloat16")]


@pytest.mark.parametrize("train,stats,xdt", BN_CASES,
                         ids=[f"{'train' if t else 'eval'}-{s}-x{x}"
                              for t, s, x in BN_CASES])
def test_batchnorm_matches_reference(train, stats, xdt):
    """Batch norm with the reference's rules: biased variance clamped at
    0, running statistics that keep 0.9 of the old value, the fold into
    x * inv + off applied in x's dtype.

    All f32: a channel whose mean is 20 times its spread is included,
    where E[x^2] - mean^2 cancels ~9 bits in either package, differently
    summed (measured 2e-5 of the largest y); y, the new running
    statistics and the gradients of x, scale and bias within 1e-4 of
    each one's largest value. bf16 x or statistics (channel means near
    0: bf16 statistics of a far-off mean are a coin toss in either
    package): y and the running statistics within 2 bf16 ulps (2^-7) of
    the largest value, the gradient of x within 3e-2 of its largest (it
    adds two bf16 paths; measured 9e-3). With bf16 x the gradients of
    the scale and bias are sums of 144 bf16 products: the port rounds
    its f32 sum once, the reference's sum rounds along the way (measured
    30% apart on a channel whose terms cancel), so the port's are held
    within 3e-2 to the reference's function on the same bf16-rounded x
    evaluated in f32."""
    rs = np.random.RandomState(11)
    exact = stats == xdt == "float32"
    offsets = [0, 4, -1, 20, 0.5] if exact else [0, 0.4, -0.1, 0.2, 0.05]
    x = (rs.randn(4, 6, 6, 5) * [1, 2, 0.5, 1, 3]
         + offsets).astype(np.float32)
    scale = rs.rand(5).astype(np.float32) + 0.5
    bias = rs.randn(5).astype(np.float32)
    ext = {"mean": rs.randn(5).astype(np.float32),
           "var": rs.rand(5).astype(np.float32) + 0.5}
    jdt, tdt = getattr(jnp, stats), getattr(torch, stats)
    xt = _t(x).to(getattr(torch, xdt))
    ct = _t(rs.randn(*x.shape).astype(np.float32)).to(xt.dtype)

    def ref(x, ct):
        def fn(x, s, b):
            return jnn.batchnorm(
                {"scale": s, "bias": b},
                {k: jnp.asarray(v) for k, v in ext.items()}, x,
                train=train, stats_dtype=jdt)
        (y, e), vjp = jax.vjp(fn, x, jnp.asarray(scale), jnp.asarray(bias))
        return y, e, vjp((ct, jax.tree_util.tree_map(jnp.zeros_like, e)))

    # the bf16-rounded x and cotangent, as numpy f32 (exact in f32)
    x_in, ct_in = _np(xt), _np(ct)
    jy, jext, jg = ref(jnp.asarray(x_in).astype(getattr(jnp, xdt)),
                       jnp.asarray(ct_in).astype(getattr(jnp, xdt)))
    _, _, jg32 = ref(jnp.asarray(x_in), jnp.asarray(ct_in))
    xt = xt.requires_grad_(True)
    st, bt = _t(scale).requires_grad_(True), _t(bias).requires_grad_(True)
    ty, text = tnn.batchnorm({"scale": st, "bias": bt},
                             {k: _t(v) for k, v in ext.items()}, xt,
                             train=train, stats_dtype=tdt)
    tg = torch.autograd.grad(ty, (xt, st, bt), grad_outputs=ct)
    assert ty.dtype == xt.dtype
    assert all(v.dtype == torch.float32 for v in text.values())
    tol = 1e-4 if exact else 2 ** -7
    gtol = 1e-4 if exact else 3e-2
    wg = jg if xdt == "float32" else jg32
    pairs = [("y", ty, jy, tol), ("dx", tg[0], jg[0], gtol),
             ("dscale", tg[1], wg[1], gtol), ("dbias", tg[2], wg[2], gtol)
             ] + [(f"extras/{k}", text[k], jext[k], tol)
                  for k in ("mean", "var")]
    for name, g, r, t in pairs:
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(_np(g), r, rtol=0,
                                   atol=t * np.abs(r).max(), err_msg=name)
    if not train:
        assert np.array_equal(_np(text["mean"]), ext["mean"])


def test_conv2d_init_moments():
    """He-normal HWIO: over 3x3x64x64 = 36,864 draws the mean is within 4
    standard errors of 0 and the std within 1.5% of sqrt(2 / fan_in), as
    the reference's draw; the bias is zero, and ``use_bias=False`` has
    none (the JAX and torch random streams differ by design)."""
    gen = torch.Generator().manual_seed(0)
    p = tnn.conv2d_init(gen, 3, 3, 64, 64)
    k = p["kernel"].numpy().astype(np.float64)
    std = np.sqrt(2 / (3 * 3 * 64))
    assert p["kernel"].shape == (3, 3, 64, 64)
    assert abs(k.mean()) < 4 * std / np.sqrt(k.size)
    assert abs(k.std() / std - 1) < 0.015
    ref = np.asarray(jnn.conv2d_init(jax.random.key(0), 3, 3, 64, 64)
                     ["kernel"])
    assert abs(k.std() / ref.std() - 1) < 0.015
    assert float(p["bias"].abs().max()) == 0.0 and p["bias"].shape == (64,)
    assert "bias" not in tnn.conv2d_init(gen, 1, 1, 4, 8, use_bias=False)
    bp, be = tnn.batchnorm_init(7)
    assert float(bp["scale"].sum()) == 7 and float(be["var"].sum()) == 7
    assert float(bp["bias"].abs().sum()) == 0 == float(be["mean"].abs()
                                                         .sum())


# ---------------------------------------------------------------------------
# models on bridged weights
# ---------------------------------------------------------------------------

def _bridge(tree):
    """A reference pytree -> the port's nested dict of CPU tensors,
    through the checkpoint's flat keys."""
    return tckpt.from_numpy(jckpt._flatten(jax.device_get(tree)), "cpu")


def _same_keys_and_shapes(port_tree, ref_tree):
    got = {k: tuple(v.shape) for k, v in flatten_dict(port_tree).items()}
    want = {k: tuple(np.shape(v)) for k, v in
            jckpt._flatten(jax.device_get(ref_tree)).items()}
    assert got == want


def test_lenet_logits_match_reference():
    """LeNet on bridged weights, f32: logits within 1e-5 of the largest
    (measured ~1e-7), NHWC and flat-784 input alike, same argmax; the
    port's own init has the reference's keys and shapes. bf16 compute:
    within 2e-2 of the largest logit (bf16 rounding of four layers)."""
    jm, tm = jlenet.LeNet(), tlenet.LeNet()
    jp = jm.init(jax.random.key(0))
    tp = _bridge(jp)
    _same_keys_and_shapes(tm.init(0, device="cpu"), jp)
    x = jmnist.synthetic_mnist(16, 4)["train_x"]
    want, _ = jm.apply(jp, {}, {"x": jnp.asarray(x)})
    want = np.asarray(want)
    for xin in (x, x.reshape(-1, 28, 28, 1)):
        got, ex = tm.apply(tp, {}, {"x": _t(xin)})
        assert got.dtype == torch.float32 and ex == {}
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert np.array_equal(_np(got).argmax(1), want.argmax(1))
    jb, tb = jlenet.LeNet(dtype=jnp.bfloat16), \
        tlenet.LeNet(dtype=torch.bfloat16)
    wb = np.asarray(jb.apply(jp, {}, {"x": jnp.asarray(x)})[0])
    gb = _np(tb.apply(tp, {}, {"x": _t(x)})[0])
    np.testing.assert_allclose(gb, wb, rtol=0, atol=2e-2 * np.abs(wb).max())


def _grads(model, params, extras, batch):
    """(loss, aux, new_extras, flat grads) of the port's loss."""
    flat = {k: v.detach().requires_grad_(True)
            for k, v in flatten_dict(params).items()}
    loss, (aux, new) = model.loss(unflatten_dict(flat), extras, batch)
    g = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), aux, new, {k: x.detach() for k, x in zip(flat, g)}


RESNETS = {
    "resnet20": (("resnet20", "_BasicBlock", [3, 3, 3], [16, 32, 64], 10,
                  32, False), 32),
    # every asymmetric pad: the 7x7/2 stem, the 3x3/2 max pool and a
    # 3x3/2 conv in each of stages 2-4
    "tiny_imagenet_stem": (("t", "_BottleneckBlock", [1, 1, 1, 1],
                            [8, 16, 32, 64], 10, 64, True), 64),
}


def _resnet_pair(name, **kw):
    """The configuration ``name`` of RESNETS in both packages (``kw``:
    the port's dtypes; the reference's take the same names)."""
    (label, block, *rest), _ = RESNETS[name]
    jkw = {k: getattr(jnp, str(v).split(".")[-1]) for k, v in kw.items()}
    return (jresnet.ResNet(label, getattr(jresnet, block), *rest, **jkw),
            tresnet.ResNet(label, getattr(tresnet, block), *rest, **kw))


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_loss_grads_and_extras_match_reference(name):
    """ResNet-20, and the tiny bottleneck ResNet with the ImageNet stem at
    64x64, on bridged weights, one training forward and backward on a
    batch of 8 centred images: the eval-mode logits within 1e-5 of the
    largest, the loss within 1e-5 relative, the new running statistics
    within 1e-5 of each leaf's largest, every gradient as below; the
    port's own init has the reference's keys and shapes.

    Gradients, each leaf against its largest value: both packages in f64
    (f64 compute and batch statistics; the logits and the loss stay f32
    in both) agree within 1e-5 (measured 2e-6), so the two compute one
    function; the port's f32 gradients stand within 1e-4 of that (~4e-6)
    and the reference's f32 within 3e-2 (its f32 reductions on the CPU
    sum in sequence, and the norm's backward cancels: measured 1.6e-2 on
    ResNet-20's s1b1/conv2), which bounds the port against it too."""
    hw = RESNETS[name][1]
    jm, tm = _resnet_pair(name)
    jp, je = jm.init(jax.random.key(0))
    _same_keys_and_shapes(tm.init(0, device="cpu")[0], jp)
    _same_keys_and_shapes(tm.init(0, device="cpu")[1], je)
    tp, te = _bridge(jp), _bridge(je)
    rs = np.random.RandomState(5)
    b = {"x": rs.randn(8, hw, hw, 3).astype(np.float32),
         "y": rs.randint(0, 10, 8).astype(np.int32)}
    tb = {k: _t(v) for k, v in b.items()}

    want_logits = np.asarray(jm.apply(jp, je, b, train=False)[0])
    got_logits, same = tm.apply(tp, te, tb, train=False)
    assert same is te
    np.testing.assert_allclose(_np(got_logits), want_logits, rtol=0,
                               atol=1e-5 * np.abs(want_logits).max())

    (jl, (jaux, jne)), jg = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, je, b, None)
    loss, aux, ne, g = _grads(tm, tp, te, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert float(aux["accuracy"]) == float(jaux["accuracy"])
    jne = jckpt._flatten(jax.device_get(jne))
    ne = flatten_dict(ne)
    assert sorted(ne) == sorted(jne)
    for k in jne:
        assert ne[k].dtype == torch.float32, k
        np.testing.assert_allclose(_np(ne[k]), jne[k], rtol=0,
                                   atol=1e-5 * np.abs(jne[k]).max(),
                                   err_msg=k)

    f64 = dict(dtype=torch.float64, bn_stats_dtype=torch.float64)
    _, t64 = _resnet_pair(name, **f64)
    _, _, _, g64 = _grads(t64, tree_map(lambda t: t.double(), tp),
                          tree_map(lambda t: t.double(), te),
                          {"x": tb["x"].double(), "y": tb["y"]})
    with jax.enable_x64(True):
        j64, _ = _resnet_pair(name, **f64)
        up = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), (jp, je))
        _, jg64 = jax.value_and_grad(j64.loss, has_aux=True)(
            *up, {"x": jnp.asarray(b["x"], jnp.float64),
                  "y": jnp.asarray(b["y"])}, None)
        jg64 = jckpt._flatten(jax.device_get(jg64))
    jg = jckpt._flatten(jax.device_get(jg))
    assert sorted(g) == sorted(jg) == sorted(g64) == sorted(jg64)
    for k in g64:
        o = g64[k].numpy()
        scale = np.abs(o).max()
        assert np.abs(jg64[k] - o).max() <= 1e-5 * scale, k
        assert np.abs(g[k].double().numpy() - o).max() <= 1e-4 * scale, k
        assert np.abs(jg[k] - o).max() <= 3e-2 * scale, k
        assert np.abs(g[k].numpy() - jg[k]).max() <= 3e-2 * scale, k


def test_resnet50_preset_shapes_and_top5():
    """The registered ResNet-50: 25,557,032 params (the canonical
    ResNet-50), f32 running statistics for its 53 batch norms, logits
    [2, 1000] at 224x224 and eval metrics with top-5; the bf16 compute
    preset keeps f32 params."""
    m = get_model("resnet50", tconfig.TrainConfig(model="resnet50",
                                                  dtype="bfloat16"))
    p, e = m.init(0, device="cpu")
    assert sum(int(v.numel()) for v in flatten_dict(p).values()) \
        == 25_557_032
    assert len(flatten_dict(e)) == 2 * 53
    assert all(v.dtype == torch.float32 for v in flatten_dict(e).values())
    assert all(v.dtype == torch.float32 for v in flatten_dict(p).values())
    batch = {k: _t(v) for k, v in m.dummy_batch(2).items()}
    logits, _ = m.apply(p, e, batch)
    assert tuple(logits.shape) == (2, 1000) and logits.dtype == torch.float32
    ev = m.eval_metrics(p, e, batch)
    assert sorted(ev) == ["accuracy", "loss", "top5_accuracy"]
    with pytest.raises(ValueError, match="bn_stats_dtype"):
        get_model("resnet20", tconfig.TrainConfig(bn_stats_dtype="f16"))


def test_cli_knobs_reach_the_models():
    """``--label_smoothing`` reaches all three models and
    ``--bn_stats_dtype`` the ResNets, through the CLI's config as the
    reference's registry takes them; ``--augment`` reaches the loader's
    config."""
    for name in ("lenet", "resnet20", "resnet50"):
        args = tcli.build_parser().parse_args(
            ["--model", name, "--label_smoothing", "0.1",
             "--bn_stats_dtype", "bfloat16", "--augment"])
        cfg = tcli.config_from_args(args)
        m = get_model(name, cfg)
        assert m.label_smoothing == 0.1 and cfg.data.augment
        if name != "lenet":
            assert m.bn_stats_dtype == torch.bfloat16
    m = get_model("resnet20", tconfig.TrainConfig(model="resnet20"))
    assert m.bn_stats_dtype == torch.float32 and m.label_smoothing == 0.0


def _momentum(cfg_mod, lr=0.05):
    return cfg_mod.OptimizerConfig(name="momentum", learning_rate=lr)


def _to_f64(state):
    return state.replace(**{part: tree_map(
        lambda t: t.double() if t.is_floating_point() else t,
        getattr(state, part)) for part in ("params", "extras", "opt_state")})


def _resnet20_trajectories(tmp_path, accum: int,
                           opt=lambda mod: _momentum(mod, 0.01)):
    """5 f32 steps of ResNet-20 (``opt``: momentum SGD, lr 0.01) on
    global batches of 16 synthetic CIFAR images from the same loader,
    from the reference's initial state bridged through its npz
    checkpoint: the reference's ``SyncReplicas`` on one CPU device, the
    port's, and the port's same steps in f64. Returns (init, losses and
    final params/extras of the port in f32, of the port in f64, of the
    reference), the states as flat ``params/...``/``extras/...``
    dicts."""
    d = tcifar.synthetic_cifar10(160, 8)
    arrays = {"x": d["train_x"], "y": d["train_y"]}
    jm = jresnet._make_resnet20(jconfig.TrainConfig())
    jsync = JSyncReplicas(jm.loss, jopt.make_optimizer(
        opt(jconfig)), local_mesh(1),
        sync=jconfig.SyncConfig(accum_steps=accum))
    js = jsync.init(jm.init, seed=0)
    bridge = str(tmp_path / "bridge")
    jckpt.CheckpointManager(bridge).save(js, 0)
    init = tckpt.load_npz(os.path.join(bridge, "ckpt-0.npz"))
    tm = get_model("resnet20", tconfig.TrainConfig(model="resnet20"))
    _, t64 = _resnet_pair("resnet20", dtype=torch.float64,
                          bn_stats_dtype=torch.float64)
    runs = {}
    for name, model, cast in (("f32", tm, None), ("f64", t64, _to_f64)):
        sync = SyncReplicas(model.loss, topt.make_optimizer(
            opt(tconfig)), device="cpu",
            sync=tconfig.SyncConfig(accum_steps=accum))
        st, restored = tckpt.restore_or_init(
            tckpt.CheckpointManager(bridge), sync.init, tm.init, seed=1)
        assert restored
        st = cast(st) if cast else st
        batches = tloader.make_loader(arrays, 16, seed=0)
        losses = []
        for _ in range(5):
            b = next(batches)
            if cast:
                b = dict(b, x=b["x"].astype(np.float64))
            st, m = sync.step(st, b)
            losses.append(float(m["loss"]))
        runs[name] = (np.array(losses), tckpt.to_numpy(
            {"params": st.params, "extras": st.extras}))
    jb = jloader.make_loader(arrays, 16, seed=0)
    jl = []
    for _ in range(5):
        js, jmet = jsync.step(js, jsync.shard_batch(next(jb)))
        jl.append(float(jmet["loss"]))
    want = jckpt._flatten(jax.device_get(
        {"params": js.params, "extras": js.extras}))
    return init, runs["f32"], runs["f64"], (np.array(jl), want)


#: per leaf, against its own move over the 5 steps (the f64 run's), for
#: the params and the running statistics. The port's f32 run against its
#: f64 run, with one microbatch of 16 (measured 2.5e-4 and 1.7e-6) and
#: with two of 8 (measured 0.12 and 7.8e-4: over 8 images the variance
#: E[x^2] - mean^2 loses digits in f32, in the reference too); the
#: reference's f32 run against the same f64 run, its own rounding
#: (measured 0.14 and 9.4e-4 with one microbatch, 9.6e-2 and 1.2e-3
#: with two).
TRAJ_PORT_TOL = {1: {"params/": 1e-3, "extras/": 1e-4},
                 2: {"params/": 0.2, "extras/": 1e-2}}
TRAJ_REF_TOL = {"params/": 0.2, "extras/": 1e-2}


@pytest.mark.parametrize("accum", [1, 2])
def test_resnet20_momentum_trajectory_matches_reference(tmp_path, accum):
    """5 f32 momentum-SGD steps of ResNet-20 (:func:`_resnet20_
    trajectories`): the port against its own f64 run and against the
    reference. With ``accum_steps=2`` the batch norm statistics are
    those of each microbatch, threaded through the two in order.

    Each loss within 2e-4 relative of the reference's and of the f64
    run's (measured 3e-5 and 5e-5). Each param and running statistic,
    against its own move over the 5 steps: the port's within
    TRAJ_PORT_TOL of the f64 run, the reference's within TRAJ_REF_TOL of
    it (so the reference and the port's f64 run take one trajectory);
    and the port within 0.1 of the largest move of any leaf of its kind
    from the f64 run and from the reference (measured 2.7e-2)."""
    init, (l32, got), (l64, oracle), (jl, want) = _resnet20_trajectories(
        tmp_path, accum)
    np.testing.assert_allclose(l32, l64, rtol=2e-4)
    np.testing.assert_allclose(l32, jl, rtol=2e-4)
    assert sorted(got) == sorted(want) == sorted(oracle)
    for part in ("params/", "extras/"):
        keys = [k for k in oracle if k.startswith(part)]
        move = {k: np.abs(oracle[k] - init[k]).max() for k in keys}
        top = max(move.values())
        for k in keys:
            assert np.abs(got[k] - oracle[k]).max() <= \
                TRAJ_PORT_TOL[accum][part] * move[k], k
            assert np.abs(want[k] - oracle[k]).max() <= \
                TRAJ_REF_TOL[part] * move[k], k
            assert np.abs(got[k] - oracle[k]).max() <= 0.1 * top, k
            assert np.abs(got[k] - want[k]).max() <= 0.1 * top, k


def _lars(wd_mask):
    return lambda mod: mod.OptimizerConfig(
        name="lars", learning_rate=0.1, weight_decay=1e-4, wd_mask=wd_mask)


@pytest.mark.parametrize("wd_mask", ["exclude_1d", "all"])
def test_resnet20_lars_trajectory_matches_reference(tmp_path, wd_mask):
    """5 f32 LARS steps of ResNet-20 (lr 0.1, decay 1e-4 and the trust
    ratio, coefficient 0.001, on the leaves of ``wd_mask``, then -lr,
    then the momentum trace), held as the momentum trajectory is: the
    losses within 2e-4 relative of the reference's and of the port's
    f64 run, each param against its own move (the f64 run's) within
    TRAJ_REF_TOL for both packages (batch norm's f32 gradients stand off
    by a few percent of a leaf in each), and within 0.1 of the largest
    move of any param from the f64 run and from the reference. (At lr
    1.0 the port's own f32 and f64 runs part by 1.7e-3 of the loss by
    step 5: small-batch batch-norm training amplifies f32 rounding.)"""
    init, (l32, got), (l64, oracle), (jl, want) = _resnet20_trajectories(
        tmp_path, 1, _lars(wd_mask))
    np.testing.assert_allclose(l32, l64, rtol=2e-4)
    np.testing.assert_allclose(l32, jl, rtol=2e-4)
    assert sorted(got) == sorted(want) == sorted(oracle)
    keys = [k for k in oracle if k.startswith("params/")]
    move = {k: np.abs(oracle[k] - init[k]).max() for k in keys}
    top = max(move.values())
    for k in keys:
        for run in (got, want):
            assert np.abs(run[k] - oracle[k]).max() <= \
                TRAJ_REF_TOL["params/"] * move[k], k
        assert np.abs(got[k] - want[k]).max() <= 0.1 * top, k


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _write_cifar(path, n, rs):
    rec = np.concatenate([rs.randint(0, 10, (n, 1)),
                          rs.randint(0, 256, (n, 3072))], axis=1)
    rec.astype(np.uint8).tofile(path)


def test_cifar_reader_matches_reference(tmp_path, monkeypatch):
    """Fixture binary batches (5 train files and the test file, in the
    ``cifar-10-batches-bin`` subdirectory): ``read_cifar_bin`` and
    ``load_cifar10`` give the reference's numpy reader's arrays exactly
    (CHW planar to NHWC, /255), and its C++ reader's within one f32 ulp
    of 1 (it multiplies by 1/255); a file of a wrong size raises in
    both."""
    rs = np.random.RandomState(2)
    root = tmp_path / "cifar-10-batches-bin"
    root.mkdir()
    for i in range(1, 6):
        _write_cifar(str(root / f"data_batch_{i}.bin"), 3, rs)
    _write_cifar(str(root / "test_batch.bin"), 4, rs)
    one = str(root / "test_batch.bin")
    for g, w in zip(tcifar.read_cifar_bin(one), jcifar.read_cifar_bin(one)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    native = jcifar.load_cifar10(str(tmp_path))
    monkeypatch.setattr(jcifar, "_reader", lambda: jcifar.read_cifar_bin)
    got, want = tcifar.load_cifar10(str(tmp_path)), \
        jcifar.load_cifar10(str(tmp_path))
    np.testing.assert_allclose(got["train_x"], native["train_x"], rtol=0,
                               atol=2 ** -23)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    assert got["train_x"].shape == (15, 32, 32, 3)
    raw = np.fromfile(one, np.uint8).reshape(4, 3073)
    assert got["test_x"][1, 2, 3, 0] == \
        np.float32(raw[1, 1 + 2 * 32 + 3]) / np.float32(255)
    bad = str(tmp_path / "bad.bin")
    np.zeros(3000, np.uint8).tofile(bad)
    for read in (tcifar.read_cifar_bin, jcifar.read_cifar_bin):
        with pytest.raises(ValueError, match="record size"):
            read(bad)
    np.testing.assert_array_equal(
        tcifar.get_cifar10(str(tmp_path))["test_y"], want["test_y"])


def test_synthetic_sets_and_augmentation_equal_reference():
    """``synthetic_cifar10``, ``synthetic_imagenet`` (at a small size and
    at its 224 shape), ``get_cifar10``/``get_imagenet`` without files,
    and ``augment_batch`` through the loader's transform, per process
    and epoch: bitwise the reference's arrays. ``get_imagenet`` with a
    missing data directory raises as the reference's does (the readers:
    ``tests/test_torch_imagenet_readers.py``)."""
    for kw in ({}, dict(num_train=100, num_test=20, seed=3, noise=0.2)):
        g, w = tcifar.synthetic_cifar10(**kw), jcifar.synthetic_cifar10(**kw)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
    for kw in (dict(num_train=6, num_test=3, num_classes=7, image_size=64,
                    seed=2), dict(num_train=2, num_test=1)):
        g, w = timagenet.synthetic_imagenet(**kw), \
            jimagenet.synthetic_imagenet(**kw)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
    assert g["train_x"].shape == (2, 224, 224, 3)
    g = timagenet.get_imagenet(None, num_train=2, num_test=1,
                               num_classes=5, image_size=32)
    w = jimagenet.get_imagenet(None, num_train=2, num_test=1,
                               num_classes=5, image_size=32)
    assert np.array_equal(g["train_x"], w["train_x"])
    for mod in (timagenet, jimagenet):
        with pytest.raises(FileNotFoundError, match="nonexistent"):
            mod.get_imagenet("/nonexistent/imagenet")
    assert np.array_equal(tcifar.get_cifar10(None, num_train=8,
                                             num_test=2)["train_x"],
                          jcifar.synthetic_cifar10(8, 2)["train_x"])

    d = tcifar.synthetic_cifar10(num_train=64, num_test=8)
    arrays = {"x": d["train_x"], "y": d["train_y"]}
    for p, n in ((0, 1), (1, 2)):
        tl = tloader.ShardedLoader(arrays, 16, process_index=p,
                                   num_processes=n, seed=7,
                                   transform=tcifar.make_augment_transform(7))
        jl = jloader.ShardedLoader(arrays, 16, process_index=p,
                                   num_processes=n, seed=7,
                                   transform=jcifar.make_augment_transform(7))
        for epoch in (0, 1):
            for a, b in zip(tl.epoch_batches(epoch), jl.epoch_batches(epoch)):
                assert np.array_equal(a["x"], b["x"])
                assert np.array_equal(a["y"], b["y"])
    x = d["train_x"][:5]
    idx = np.array([3, 9, 1, 0, 60])
    assert np.array_equal(
        tcifar.augment_batch(x, epoch=2, indices=idx, seed=1, pad=2),
        jcifar.augment_batch(x, epoch=2, indices=idx, seed=1, pad=2))


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lenet", "resnet20"])
def test_checkpoints_cross_with_extras(tmp_path, name):
    """A reference checkpoint of the model after 2 momentum steps (params,
    the momentum buffers and, for ResNet-20, the batch norm running
    statistics under ``extras/``) restores in the port bit for bit, and
    the port's checkpoint of it restores in the reference bit for bit;
    their eval metrics agree within 1e-5."""
    jm = (jlenet.LeNet() if name == "lenet"
          else jresnet._make_resnet20(jconfig.TrainConfig()))
    tm = get_model(name, tconfig.TrainConfig(model=name))
    jsync = JSyncReplicas(jm.loss, jopt.make_optimizer(_momentum(jconfig)),
                          local_mesh(1))
    js = jsync.init(jm.init, seed=0)
    batch = jm.dummy_batch(8)
    for _ in range(2):
        js, _ = jsync.step(js, jsync.shard_batch(batch))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.CheckpointManager(jdir).save(js)
    tsync = SyncReplicas(tm.loss, topt.make_optimizer(_momentum(tconfig)),
                         device="cpu")
    on_port = tckpt.CheckpointManager(jdir).restore(tsync.init(tm.init))
    assert on_port.step == 2
    want = jckpt._flatten(jax.device_get(
        {"params": js.params, "extras": js.extras}))
    got = tckpt.to_numpy({"params": on_port.params,
                          "extras": on_port.extras})
    assert sorted(got) == sorted(want)
    assert any(k.startswith("extras/") for k in want) == (name != "lenet")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tckpt.CheckpointManager(tdir).save(on_port)
    back = jckpt.CheckpointManager(tdir).restore(jsync.init(jm.init, seed=9))
    assert int(back.step) == 2
    again = jckpt._flatten(jax.device_get(
        {"params": back.params, "extras": back.extras,
         "opt_state": back.opt_state}))
    full = jckpt._flatten(jax.device_get(
        {"params": js.params, "extras": js.extras,
         "opt_state": js.opt_state}))
    for k in full:
        np.testing.assert_array_equal(again[k], full[k], err_msg=k)
    jev = jm.eval_metrics(back.params, back.extras,
                          jax.tree_util.tree_map(jnp.asarray, batch))
    tev = tm.eval_metrics(on_port.params, on_port.extras,
                          {k: _t(v) for k, v in batch.items()})
    for k in jev:
        np.testing.assert_allclose(float(tev[k]), float(jev[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_cli_resnet20_augment_ring_and_resume(tmp_path):
    """``cli.train --model resnet20 --augment --device cpu``: 6 momentum
    steps on batches of 16 with a checkpoint every 3 in a ring of 2,
    then a resume to 9; the ring rotates, the second run starts at 6,
    the loss stays finite and the final eval reports top-5. The CLI's
    datasets are the reference's (``load_dataset``, equal arrays)."""
    ck, m = str(tmp_path / "ck"), str(tmp_path / "m.jsonl")
    argv = ["--model", "resnet20", "--augment", "--device", "cpu",
            "--batch_size", "16", "--optimizer", "momentum",
            "--learning_rate", "0.05", "--label_smoothing", "0.1",
            "--ckpt_dir", ck, "--save_steps", "3", "--max_to_keep", "2",
            "--log_every_steps", "3", "--metrics_path", m]
    assert tcli.main(argv + ["--train_steps", "6"]) == 0
    assert tckpt.CheckpointManager(ck).all_steps() == [3, 6]
    assert tcli.main(argv + ["--train_steps", "9", "--eval_every_steps",
                             "9"]) == 0
    assert tckpt.CheckpointManager(ck).all_steps() == [6, 9]
    with open(m) as f:
        recs = [json.loads(line) for line in f]
    assert [r["start_step"] for r in recs if "start_step" in r] == [0, 6]
    evals = [r["eval"] for r in recs if "eval" in r]
    assert evals and "top5_accuracy" in evals[-1]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    saved = tckpt.load_npz(os.path.join(ck, "ckpt-9.npz"))
    assert "extras/stem_bn/mean" in saved
    cfg = tconfig.TrainConfig(model="resnet20", data=tconfig.DataConfig(
        dataset="resnet20"))
    jcfg = jconfig.TrainConfig(model="resnet20", data=jconfig.DataConfig(
        dataset="resnet20"))
    for g, w in zip(tcli.load_dataset(cfg), jcli.load_dataset(jcfg)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_cli_lenet_learns_on_synthetic_mnist(tmp_path):
    """``cli.train --model lenet --device cpu`` on the synthetic MNIST set
    (flat 784 rows, reshaped by the model): 60 momentum steps on batches
    of 64 reach the reference example's 0.95 test accuracy."""
    m = str(tmp_path / "m.jsonl")
    assert tcli.main(["--model", "lenet", "--device", "cpu", "--batch_size",
                      "64", "--optimizer", "momentum", "--learning_rate",
                      "0.05", "--train_steps", "60", "--log_every_steps",
                      "30", "--eval_every_steps", "60", "--metrics_path",
                      m]) == 0
    with open(m) as f:
        evals = [json.loads(line)["eval"] for line in f if '"eval"' in line]
    assert evals[-1]["accuracy"] >= 0.95, evals


@pytest.mark.parametrize("name", ["lenet", "resnet20", "resnet50"])
def test_cli_conv_models_need_a_card_unless_asked(tmp_path, monkeypatch,
                                                  name):
    """No CPU fallback: without CUDA the CLI exits before any work for
    each conv model, unless ``--device cpu`` is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli.main(["--model", name, "--train_steps", "1", "--ckpt_dir", ck])
    assert not os.path.exists(ck)
