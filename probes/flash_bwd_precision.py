"""How much of a deep BERT layer's q/k gradient a bf16 flash backward
keeps, in both packages, on the CPU.

A 12-layer BERT (hidden 128, 2 heads of 64, so the JAX package's Pallas
kernels run, in interpret mode), one batch of 4 x 128 synthetic tokens
with trailing PAD and an all-PAD row, random init, no dropout: the
gradient of each named leaf under bf16 compute with the flash attention
and with the einsum attention, in the JAX package and in the port
(whose flash path on the CPU is its kernels' plain versions), each
against the JAX package's f32 einsum path. Prints each leaf's norm as a
share of the global norm and each path's relative error.

    python probes/flash_bwd_precision.py [layers]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_tensorflow_example_tpu.ckpt.checkpoint import \
    _flatten  # noqa: E402
from distributed_tensorflow_example_tpu.data import \
    bert_data as jdata  # noqa: E402
from distributed_tensorflow_example_tpu.models.bert import (  # noqa: E402
    Bert as JBert, BertConfig as JBertConfig)
from distributed_tensorflow_example_tpu_torch.models.bert import (  # noqa: E402,E501
    Bert, BertConfig, params_from_numpy)
from distributed_tensorflow_example_tpu_torch.utils.pytree import (  # noqa: E402,E501
    flatten_dict, unflatten_dict)


def main() -> None:
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    cfg = dict(vocab_size=1000, hidden=128, layers=layers, heads=2,
               intermediate=256, max_len=128, max_predictions=20,
               dropout=0.0)
    seqs = jdata.synthetic_corpus(4, 128, 1000, 11)
    for i, n in enumerate((128, 100, 60, 0)):
        seqs[i, n:] = jdata.PAD
    batch = jdata.apply_mlm_masking(seqs, vocab_size=1000,
                                    max_predictions=20, seed=2)
    oracle = JBert(JBertConfig(**cfg), dtype=jnp.float32)
    params = oracle.init(jax.random.key(0))

    def jax_grads(model):
        (_, _), g = jax.value_and_grad(model.loss, has_aux=True)(
            params, {}, {k: jnp.asarray(v) for k, v in batch.items()}, None)
        return {k: np.asarray(v, np.float32) for k, v in _flatten(g).items()}

    def port_grads(model):
        tp = params_from_numpy(model, _flatten(params), device="cpu")
        flat = {k: v.detach().requires_grad_()
                for k, v in flatten_dict(tp).items()}
        loss, _ = model.loss(unflatten_dict(flat), {},
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()})
        g = torch.autograd.grad(loss, list(flat.values()))
        return {k: x.float().numpy() for k, x in zip(flat, g)}

    want = jax_grads(oracle)
    runs = {
        f"reference {impl}": jax_grads(JBert(
            JBertConfig(**cfg), dtype=jnp.bfloat16, attention_impl=impl))
        for impl in ("flash", "xla")}
    runs.update({
        f"port {impl}": port_grads(Bert(
            BertConfig(**cfg), dtype=torch.bfloat16, attention_impl=impl))
        for impl in ("flash", "xla")})
    total = np.sqrt(sum((v ** 2).sum() for v in want.values()))
    for i in (0, layers // 2, layers - 1):
        for name in ("q", "k"):
            key = f"layer_{i}/attn/{name}/kernel"
            n = np.linalg.norm(want[key])
            print(f"{key}: {n / total:.2e} of the global norm; bf16 error "
                  "against f32: " + ", ".join(
                      f"{run} {np.linalg.norm(g[key] - want[key]) / n:.3e}"
                      for run, g in runs.items()))


if __name__ == "__main__":
    main()
