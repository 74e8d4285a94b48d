"""Token data of the language models (an adapted copy of
``distributed_tensorflow_example_tpu/data/bert_data.py``): the synthetic
bigram corpus and pre-tokenized ``.npy`` files, packed for the causal LM
as ``{input_ids, attention_mask}`` or masked for BERT's MLM in the
static-shape layout (``max_predictions`` slots a sequence)::

    input_ids, token_type_ids, attention_mask: [N, S] int32
    masked_positions, masked_labels: [N, M] int32; masked_weights: [N, M] f32

numpy only; the arrays are the reference's bit for bit. Special ids
follow the bert-base-uncased convention ([PAD]=0, [CLS]=101, [SEP]=102,
[MASK]=103). TFRecord token files and the raw-text pipeline
(``data/bert_text.py``, a vocab.txt corpus) arrive with slice A5b.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.logging import get_logger

PAD, CLS, SEP, MASK = 0, 101, 102, 103
_SPECIALS = (PAD, CLS, SEP, MASK)
_FIRST_REGULAR = 110            # ids below this are reserved/special


def synthetic_corpus(num_seqs: int = 2048, seq_len: int = 128,
                     vocab_size: int = 30522, seed: int = 0) -> np.ndarray:
    """[N, S] int32 token sequences with bigram structure: token t is
    followed by (t*7+11)%V with prob 0.5 else a Zipf draw, so the next
    token is partly predictable from context."""
    rs = np.random.RandomState(seed)
    v_eff = vocab_size - _FIRST_REGULAR

    def zipf_draw(n):
        # bounded zipf over the regular-token range
        z = rs.zipf(1.3, size=n)
        return (np.minimum(z, v_eff) - 1) + _FIRST_REGULAR

    seqs = np.empty((num_seqs, seq_len), np.int32)
    seqs[:, 0] = CLS
    cur = zipf_draw(num_seqs)
    seqs[:, 1] = cur
    for j in range(2, seq_len - 1):
        follow = (cur * 7 + 11) % v_eff + _FIRST_REGULAR
        fresh = zipf_draw(num_seqs)
        take = rs.rand(num_seqs) < 0.5
        cur = np.where(take, follow, fresh).astype(np.int32)
        seqs[:, j] = cur
    seqs[:, -1] = SEP
    return seqs


def apply_mlm_masking(seqs: np.ndarray, *, vocab_size: int,
                      max_predictions: int = 20, mask_prob: float = 0.15,
                      seed: int = 0,
                      specials: tuple[int, ...] | None = None,
                      pad: int = PAD, mask: int = MASK,
                      first_regular: int = _FIRST_REGULAR
                      ) -> dict[str, np.ndarray]:
    """The canonical BERT masking in the static-shape layout: of the
    maskable positions (not a special id) a share ``mask_prob`` (at least
    one, at most ``max_predictions``) is chosen, and of those 80% become
    [MASK], 10% a random regular token and 10% stay. A row with nothing
    maskable (all PAD) gets no predictions: weight 0 in every slot."""
    if specials is None:
        specials = _SPECIALS
    rs = np.random.RandomState(seed)
    n, s = seqs.shape
    m = max_predictions

    # vectorized: a random key per position, the non-maskable ones pushed
    # to the back, each row's first k of the sorted keys taken
    maskable = ~np.isin(seqs, specials)
    cand_counts = maskable.sum(axis=1)
    k = np.minimum.reduce([
        np.full(n, m),
        cand_counts,
        np.maximum(1, np.round(cand_counts * mask_prob).astype(np.int64)),
    ])
    k = np.where(cand_counts == 0, 0, k)      # all-PAD rows: no predictions

    keys = rs.rand(n, s) + np.where(maskable, 0.0, 10.0)
    order = np.argsort(keys, axis=1)[:, :m].astype(np.int32)   # [n, m]
    sel = np.arange(m)[None, :] < k[:, None]                    # validity
    positions = np.where(sel, order, 0).astype(np.int32)
    orig = np.take_along_axis(seqs, positions, axis=1)
    labels = np.where(sel, orig, 0).astype(np.int32)
    weights = sel.astype(np.float32)

    decide = rs.rand(n, m)
    rand_tok = rs.randint(first_regular, vocab_size, size=(n, m))
    new_tok = np.where(decide < 0.8, mask,
                       np.where(decide < 0.9, rand_tok, orig)).astype(np.int32)
    input_ids = seqs.copy()
    rows = np.broadcast_to(np.arange(n)[:, None], (n, m))[sel]
    input_ids[rows, positions[sel]] = new_tok[sel]

    return {
        "input_ids": input_ids.astype(np.int32),
        "token_type_ids": np.zeros((n, s), np.int32),
        "attention_mask": (seqs != pad).astype(np.int32),
        "masked_positions": positions,
        "masked_labels": labels,
        "masked_weights": weights,
    }


def load_tokenized(data_dir: str) -> tuple[np.ndarray, np.ndarray]:
    """Pre-tokenized [N,S] int32 arrays: ``train.npy`` + ``test.npy``, or a
    single ``tokens.npy`` split 95/5."""
    tr, te = (os.path.join(data_dir, f) for f in ("train.npy", "test.npy"))
    if os.path.exists(tr) and os.path.exists(te):
        return np.load(tr).astype(np.int32), np.load(te).astype(np.int32)
    single = os.path.join(data_dir, "tokens.npy")
    if os.path.exists(single):
        toks = np.load(single).astype(np.int32)
        cut = max(1, int(len(toks) * 0.95))
        return toks[:cut], toks[cut:]
    raise FileNotFoundError(
        f"no train.npy/test.npy or tokens.npy under {data_dir!r}")


def _load_seqs(data_dir, seq_len, vocab_size, synthetic,
               num_train, num_test, seed):
    """The token source: pre-tokenized files (truncated to seq_len with a
    warning) or the synthetic corpus."""
    if data_dir and not synthetic:
        train_seqs, test_seqs = load_tokenized(data_dir)
        if train_seqs.shape[1] > seq_len:
            get_logger("data").warning(
                "truncating pre-tokenized sequences from %d to seq_len=%d",
                train_seqs.shape[1], seq_len)
            train_seqs = train_seqs[:, :seq_len]
            test_seqs = test_seqs[:, :seq_len]
        return train_seqs, test_seqs
    return (synthetic_corpus(num_train, seq_len, vocab_size, seed),
            synthetic_corpus(num_test, seq_len, vocab_size, seed + 1))


def get_bert_data(data_dir: str | None, *, vocab_size: int = 30522,
                  seq_len: int = 128, max_predictions: int = 20,
                  mask_prob: float = 0.15, synthetic: bool = False,
                  num_train: int = 2048, num_test: int = 256,
                  seed: int = 0) -> tuple[dict, dict]:
    """MLM batches (train, eval) in the layout above, from pre-tokenized
    files or the synthetic corpus; the masks draw from ``seed + 2``
    (train) and ``seed + 3`` (eval), as in the reference."""
    train_seqs, test_seqs = _load_seqs(data_dir, seq_len, vocab_size,
                                       synthetic, num_train, num_test,
                                       seed)
    kw = dict(vocab_size=vocab_size, max_predictions=max_predictions,
              mask_prob=mask_prob)
    return (apply_mlm_masking(train_seqs, seed=seed + 2, **kw),
            apply_mlm_masking(test_seqs, seed=seed + 3, **kw))


def get_lm_data(data_dir: str | None, *, vocab_size: int = 30522,
                seq_len: int = 128, synthetic: bool = False,
                num_train: int = 2048, num_test: int = 256,
                seed: int = 0) -> tuple[dict, dict]:
    """Causal-LM batches ``{input_ids, attention_mask}`` (train, eval):
    PAD positions (token 0) carry no loss and are invisible as keys."""
    train_seqs, test_seqs = _load_seqs(data_dir, seq_len, vocab_size,
                                       synthetic, num_train, num_test,
                                       seed)

    def pack(seqs):
        return {"input_ids": seqs.astype(np.int32),
                "attention_mask": (seqs != PAD).astype(np.int32)}

    return pack(train_seqs), pack(test_seqs)
