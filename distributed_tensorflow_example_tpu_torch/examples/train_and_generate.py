"""Train a causal LM and generate from it — the decoder workflow, on the
PyTorch port (a port copy of ``examples/train_and_generate.py``)::

    python -m distributed_tensorflow_example_tpu_torch.examples.train_and_generate \\
        --workdir /tmp/lm [--device cpu]

Steps (each maps to one framework feature):

1. train    — a short ``gpt_tiny`` next-token run, checkpointed
   (``Trainer`` + ``CheckpointManager``; eval reports loss / perplexity /
   token accuracy).
2. reload   — the checkpoint restored into a fresh state the same way
   any training run resumes (``restore_or_init``).
3. generate — greedy, temperature-sampled (a ``torch.Generator``),
   nucleus with an EOS stop, and ragged-prompt continuations through
   the KV-cache decode path (``GPT.generate``: one prefill forward, then
   one decode step a token).

``gpt_tiny`` has heads of 32 (hidden 128 over 4 heads), and the
hand-written flash and decode kernels take heads of 64 or 128 only. The
reference takes its Pallas decode kernel only on a TPU and only for
such heads (``ops/pallas/decode_attention.py``), and trains with XLA
attention, so on its TPU too this workflow runs no kernel. The port asks
for the plain attention explicitly, training and decoding
(``attention_impl="xla"``, ``decode_attention="xla"``), and says so: on
the card the kernels' wrappers refuse a head of 32 rather than fall back.
It runs on the card unless ``--device cpu`` asks for the CPU.
"""

import argparse
import os
import sys

import numpy as np
import torch

from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import (
    CheckpointManager, restore_or_init)
from distributed_tensorflow_example_tpu_torch.config import (
    CheckpointConfig, DataConfig, MeshShape, OptimizerConfig, TrainConfig)
from distributed_tensorflow_example_tpu_torch.data.bert_data import \
    get_lm_data
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.train.optimizers import \
    make_optimizer
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer

#: the attention both phases ask for (gpt_tiny's heads of 32 fit no kernel)
ATTENTION = "xla"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default="/tmp/dtx_lm")
    ap.add_argument("--train_steps", type=int, default=60)
    ap.add_argument("--prompt_len", type=int, default=8)
    ap.add_argument("--new_tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    ckpt_dir = os.path.join(args.workdir, "ckpt")

    # 1. train -----------------------------------------------------------
    cfg = TrainConfig(
        model="gpt_tiny", train_steps=args.train_steps,
        mesh=MeshShape(data=-1),       # every rank on the data axis
        data=DataConfig(batch_size=32, seq_len=64),
        optimizer=OptimizerConfig(name="adamw", learning_rate=3e-3),
        checkpoint=CheckpointConfig(directory=ckpt_dir,
                                    save_steps=args.train_steps),
        eval_every_steps=args.train_steps, seed=0,
        attention_impl=ATTENTION)
    model = get_model("gpt_tiny", cfg)
    print(f"attention: {ATTENTION} for training and decode (gpt_tiny's "
          f"heads of {model.head_dim} fit no hand-written kernel; the "
          "reference takes XLA here too)")
    train_arrays, eval_arrays = get_lm_data(
        None, vocab_size=model.cfg.vocab_size, seq_len=64, synthetic=True)
    with Trainer(model, cfg, train_arrays, eval_arrays,
                 device=args.device) as trainer:
        _, summary = trainer.train()
    print(f"trained to step {summary['final_step']}: "
          f"perplexity {summary['eval']['perplexity']:.1f}, "
          f"token accuracy {summary['eval']['token_accuracy']:.3f}")

    # 2. reload ----------------------------------------------------------
    sync = SyncReplicas(model.loss, make_optimizer(cfg.optimizer),
                        cfg.mesh, device=args.device)
    state, restored = restore_or_init(
        CheckpointManager(ckpt_dir),
        lambda: sync.init(model.init, seed=cfg.seed))
    assert restored, "checkpoint must be found"

    # 3. generate --------------------------------------------------------
    # prompt: the start of a held-out eval sequence; the synthetic corpus
    # has bigram structure, so a trained model visibly continues patterns
    params = state.params
    dev = sync.device
    prompt = torch.as_tensor(eval_arrays["input_ids"][:2, :args.prompt_len],
                             device=dev)
    gen = dict(decode_attention=ATTENTION)
    greedy = model.generate(params, prompt, args.new_tokens, **gen)
    sampled = model.generate(
        params, prompt, args.new_tokens, temperature=0.8,
        rng=torch.Generator(device=dev).manual_seed(0), **gen)
    # nucleus sampling with EOS early-stop: the serving-style call —
    # top_p keeps the smallest high-probability token set, eos_id stops
    # a row the moment it emits that token (pad_id fills the tail)
    eos = int(greedy[0, args.new_tokens // 2])
    nucleus = model.generate(
        params, prompt, args.new_tokens, temperature=0.8, top_p=0.9,
        eos_id=eos, pad_id=-1,
        rng=torch.Generator(device=dev).manual_seed(1), **gen)
    # ragged prompts: row 1 uses only half its prompt (prompt_mask is
    # right-padded per row); generation continues each row from ITS
    # real tokens
    pmask = np.ones(tuple(prompt.shape), np.int32)
    pmask[1, args.prompt_len // 2:] = 0
    ragged = model.generate(params, prompt, args.new_tokens,
                            prompt_mask=torch.as_tensor(pmask, device=dev),
                            **gen)
    for b in range(prompt.shape[0]):
        print(f"prompt : {prompt[b].tolist()}")
        print(f"greedy : {greedy[b].tolist()}")
        print(f"sampled: {sampled[b].tolist()}")
        print(f"nucleus(eos={eos}): {nucleus[b].tolist()}")
        print(f"ragged : {ragged[b].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
