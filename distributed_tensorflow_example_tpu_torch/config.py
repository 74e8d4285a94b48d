"""Config dataclasses (port of ``distributed_tensorflow_example_tpu/
config.py``, the fields GPT construction and generation read).

Field names and defaults are the reference's, so a config reads the same
in both packages; the training, data-pipeline, mesh and observability
knobs arrive with the slices that read them.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class DataConfig:
    """The data fields a language model reads."""

    seq_len: int = 128
    vocab_size: int = 30522


@dataclasses.dataclass
class TrainConfig:
    """Top-level config (the fields GPT inference reads)."""

    model: str = "mlp"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    dtype: str = "float32"           # compute dtype: float32 | bfloat16
    param_dtype: str = "float32"
    attention_impl: str = "xla"      # xla | flash (hand-written kernel)
    # flash-kernel tuning levers (attention_impl="flash" only; 0 = the
    # kernel default)
    attention_block_q: int = 0
    attention_block_k: int = 0
    attention_bwd_block: int = 0
    attention_bwd: str = "split"     # split | fused (backward variant)

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def flash_attention_kwargs(cfg: TrainConfig) -> dict:
    """Validated flash-kernel kwargs from the ``attention_*`` lever knobs.

    Returns {} when every lever is at its default (any ``attention_impl``
    is fine then); raises ValueError when a lever is set without
    ``attention_impl="flash"`` or carries a value the reference's kernel
    could never tile. The same validation as the reference's, so a
    config is accepted or refused identically by both packages."""
    levers = dict(block_q=cfg.attention_block_q,
                  block_k=cfg.attention_block_k,
                  bwd_block=cfg.attention_bwd_block)
    if cfg.attention_bwd not in ("split", "fused"):
        raise ValueError(f"attention_bwd must be 'split' or 'fused', "
                         f"got {cfg.attention_bwd!r}")
    set_levers = {k: v for k, v in levers.items() if v != 0}
    if cfg.attention_bwd != "split":
        set_levers["bwd_variant"] = cfg.attention_bwd
    if not set_levers:
        return {}
    if cfg.attention_impl != "flash":
        raise ValueError(
            f"attention block/bwd levers ({', '.join(set_levers)}) tune "
            f"the flash kernel and require attention_impl='flash', "
            f"got {cfg.attention_impl!r}")
    for name, mult in (("block_q", 8), ("block_k", 128),
                       ("bwd_block", 128)):
        v = levers[name]
        if v < 0 or v % mult:
            raise ValueError(
                f"attention_{name}={v} invalid: must be a positive "
                f"multiple of {mult} or 0 for the kernel default")
    return set_levers
