"""Raw-text BERT MLM pipeline: WordPiece tokenization and packing (an
adapted copy of ``distributed_tensorflow_example_tpu/data/bert_text.py``).

Point it at a text corpus and a ``vocab.txt`` and it produces the static
MLM batch layout of ``data/bert_data.py``. Tokenization is
``transformers.BertTokenizerFast`` on the LOCAL vocab file only, imported
inside the function that tokenizes, never on another training path, and
nothing is fetched from the network.

Layout: ``vocab.txt`` one token per line (line number = id) holding
[PAD], [UNK], [CLS], [SEP], [MASK]; the special ids are read from the
tokenizer, and random-replacement tokens during masking are drawn from
the ids above the highest special id, so keep the specials at the front
of the vocab (the standard layout).

Packing follows BERT pretraining: each document's token stream is cut
into (seq_len - 2)-token pieces, wrapped with [CLS]/[SEP], and the last
short piece padded. Blank lines separate documents.
"""

from __future__ import annotations

import os

import numpy as np

from .bert_data import apply_mlm_masking


def _tokenizer(vocab_file: str, do_lower_case: bool = True):
    try:
        from transformers import BertTokenizerFast
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "tokenizing a text corpus needs the transformers package, "
            "which cannot be imported here (only the text pipeline needs "
            "it); pass pre-tokenized train.npy/test.npy or tokens.npy") from e
    return BertTokenizerFast(vocab_file=vocab_file,
                             do_lower_case=do_lower_case)


def _iter_documents(text_path: str, exclude: str | None = None):
    """Documents from a .txt file (blank-line separated) or every *.txt
    in a directory (one document per blank-line-separated block).
    ``exclude`` drops one path — the vocab.txt living in the same corpus
    directory must never be tokenized as training text."""
    skip = os.path.abspath(exclude) if exclude else None
    paths = ([text_path] if os.path.isfile(text_path) else
             sorted(os.path.join(text_path, f)
                    for f in os.listdir(text_path) if f.endswith(".txt")))
    paths = [p for p in paths if os.path.abspath(p) != skip]
    if not paths:
        raise FileNotFoundError(
            f"no corpus .txt files under {text_path!r} (vocab.txt alone "
            "is not a corpus)")
    for p in paths:
        with open(p) as f:
            doc: list[str] = []
            for line in f:
                line = line.strip()
                if line:
                    doc.append(line)
                elif doc:
                    yield " ".join(doc)
                    doc = []
            if doc:
                yield " ".join(doc)


def tokenize_corpus(text_path: str, vocab_file: str, *,
                    seq_len: int = 128, do_lower_case: bool = True
                    ) -> tuple[np.ndarray, dict[str, int]]:
    """Tokenize + pack a text corpus -> ([N, seq_len] int32, special ids).

    Returns the packed sequences and ``{"pad", "cls", "sep", "mask",
    "unk", "vocab_size", "first_regular"}``.
    """
    tok = _tokenizer(vocab_file, do_lower_case)
    ids = {"pad": tok.pad_token_id, "cls": tok.cls_token_id,
           "sep": tok.sep_token_id, "mask": tok.mask_token_id,
           "unk": tok.unk_token_id, "vocab_size": tok.vocab_size}
    ids["first_regular"] = max(ids["pad"], ids["cls"], ids["sep"],
                               ids["mask"], ids["unk"]) + 1
    if ids["first_regular"] >= ids["vocab_size"]:
        raise ValueError(
            f"vocab.txt must place the special tokens at the FRONT: the "
            f"highest special id is {ids['first_regular'] - 1} but the "
            f"vocab has only {ids['vocab_size']} entries, leaving no "
            "regular-token range for MLM random replacement")
    body = seq_len - 2
    rows: list[np.ndarray] = []
    for doc in _iter_documents(text_path, exclude=vocab_file):
        stream = tok(doc, add_special_tokens=False)["input_ids"]
        for start in range(0, len(stream), body):
            chunk = stream[start:start + body]
            if not chunk:
                continue
            row = np.full(seq_len, ids["pad"], np.int32)
            row[0] = ids["cls"]
            row[1:1 + len(chunk)] = chunk
            row[1 + len(chunk)] = ids["sep"]
            rows.append(row)
    if not rows:
        raise ValueError(f"corpus at {text_path!r} tokenized to nothing")
    return np.stack(rows), ids


def get_bert_text_data(text_path: str, vocab_file: str, *,
                       seq_len: int = 128, max_predictions: int = 20,
                       mask_prob: float = 0.15, seed: int = 0,
                       test_fraction: float = 0.05
                       ) -> tuple[dict, dict, int]:
    """(train_arrays, eval_arrays, vocab_size) in the MLM batch layout:
    the text-corpus counterpart of ``bert_data.get_bert_data``."""
    seqs, ids = tokenize_corpus(text_path, vocab_file, seq_len=seq_len)
    # deterministic split AFTER a seeded shuffle: adjacent chunks come
    # from the same document, so a tail split would skew eval
    rs = np.random.RandomState(seed)
    perm = rs.permutation(len(seqs))
    seqs = seqs[perm]
    n_test = max(1, int(len(seqs) * test_fraction)) if len(seqs) > 1 else 0
    test, train = seqs[:n_test], seqs[n_test:]
    if len(train) == 0:
        train = test                      # single-sequence corpora: smoke
    kw = dict(vocab_size=ids["vocab_size"],
              max_predictions=max_predictions, mask_prob=mask_prob,
              specials=(ids["pad"], ids["cls"], ids["sep"], ids["mask"],
                        ids["unk"]),
              pad=ids["pad"], mask=ids["mask"],
              first_regular=ids["first_regular"])
    return (apply_mlm_masking(train, seed=seed + 2, **kw),
            apply_mlm_masking(test if n_test else train,
                              seed=seed + 3, **kw),
            ids["vocab_size"])
