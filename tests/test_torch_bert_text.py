"""The port's raw-text BERT pipeline (``data/bert_text.py``) against the
JAX package's, on a fixture ``vocab.txt`` and corpus written here from a
numpy seed: the packed sequences, the special ids and the masked MLM
batches bit for bit; the vocab file never tokenized as text; misplaced
specials refused; and the CLI's text path (a vocab.txt directory trains
bert_tiny, ``.npy`` files win over the text, a vocab past the model's
table stops the run before tokenizing).
"""

import os
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from distributed_tensorflow_example_tpu.data import bert_text as jtext  # noqa: E402
from distributed_tensorflow_example_tpu_torch import config as tconfig  # noqa: E402
from distributed_tensorflow_example_tpu_torch.cli import train as tcli  # noqa: E402
from distributed_tensorflow_example_tpu_torch.data import bert_text as ttext  # noqa: E402
from distributed_tensorflow_example_tpu_torch.models import get_model  # noqa: E402

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [chr(c) for c in range(ord("a"), ord("z") + 1)]
             + ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)]
             + ["the", "quick", "brown", "fox", "jump", "over",
                "lazy", "dog", "pack", "my", "box", "with", "five",
                "dozen", "liquor", "jug", "##ump"])
    (d / "vocab.txt").write_text("\n".join(vocab))
    rs = np.random.RandomState(0)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy",
             "dog", "pack", "my", "box", "with", "five", "dozen",
             "liquor", "jugs", "Zebra"]
    docs = [" ".join(rs.choice(words, size=rs.randint(5, 120)))
            for _ in range(30)]
    (d / "corpus.txt").write_text("\n\n".join(docs))
    (d / "more.txt").write_text("the lazy dog\nover the box\n\n\nfive")
    return str(d)


@pytest.mark.parametrize("seq_len", [16, 32])
def test_tokenize_and_pack_equal_the_reference(corpus, seq_len):
    vocab = os.path.join(corpus, "vocab.txt")
    for src in (corpus, os.path.join(corpus, "corpus.txt")):
        a, ia = ttext.tokenize_corpus(src, vocab, seq_len=seq_len)
        b, ib = jtext.tokenize_corpus(src, vocab, seq_len=seq_len)
        assert ia == ib
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()
    assert (a[:, 0] == ia["cls"]).all()
    assert ia["first_regular"] == 5


@pytest.mark.parametrize("seed", [0, 3])
def test_masked_text_batches_equal_the_reference(corpus, seed):
    vocab = os.path.join(corpus, "vocab.txt")
    kw = dict(seq_len=32, max_predictions=6, mask_prob=0.2, seed=seed)
    got = ttext.get_bert_text_data(corpus, vocab, **kw)
    want = jtext.get_bert_text_data(corpus, vocab, **kw)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k
    w = got[0]["masked_weights"].astype(bool)
    assert not np.isin(got[0]["masked_labels"][w], range(5)).any()


def test_vocab_never_tokenized_and_misplaced_specials(corpus, tmp_path):
    vocab = os.path.join(corpus, "vocab.txt")
    only = tmp_path / "only"
    only.mkdir()
    shutil.copy(vocab, only / "vocab.txt")
    with pytest.raises(FileNotFoundError, match="not a corpus"):
        ttext.tokenize_corpus(str(only), str(only / "vocab.txt"))
    lines = open(vocab).read().splitlines()
    (tmp_path / "bad.txt").write_text(
        "\n".join([x for x in lines if x != "[MASK]"] + ["[MASK]"]))
    for mod in (ttext, jtext):
        with pytest.raises(ValueError, match="FRONT"):
            mod.tokenize_corpus(os.path.join(corpus, "corpus.txt"),
                                str(tmp_path / "bad.txt"), seq_len=32)


def test_cli_text_corpus_paths(corpus, tmp_path):
    """bert_tiny trains 2 steps from the corpus directory (vocab.txt found
    there); ``load_dataset`` gives the text pipeline's arrays; tokens.npy
    beside the vocab wins; a vocab larger than bert_tiny's table stops the
    run naming it."""
    assert tcli.main(["--model", "bert_tiny", "--device", "cpu",
                      "--data_dir", corpus, "--seq_len", "32",
                      "--train_steps", "2", "--batch_size", "8",
                      "--optimizer", "adamw", "--learning_rate", "1e-3"]) == 0
    cfg = tconfig.TrainConfig(model="bert_tiny", data=tconfig.DataConfig(
        dataset="bert_tiny", data_dir=corpus, seq_len=32, seed=4))
    model = get_model("bert_tiny", cfg)
    tr, te = tcli.load_dataset(cfg, model)
    want = ttext.get_bert_text_data(
        corpus, os.path.join(corpus, "vocab.txt"), seq_len=32,
        max_predictions=model.cfg.max_predictions, seed=4)
    for a, b in ((tr, want[0]), (te, want[1])):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
    both = tmp_path / "both"
    shutil.copytree(corpus, both)
    np.save(both / "tokens.npy", np.random.RandomState(0).randint(
        110, 999, size=(64, 32)).astype(np.int32))
    cfg.data.data_dir = str(both)
    tr, te = tcli.load_dataset(cfg, model)
    assert len(tr["input_ids"]) + len(te["input_ids"]) == 64
    big = tmp_path / "big"
    big.mkdir()
    shutil.copy(os.path.join(corpus, "corpus.txt"), big / "corpus.txt")
    lines = open(os.path.join(corpus, "vocab.txt")).read().splitlines()
    (big / "vocab.txt").write_text("\n".join(
        lines + [f"tok{i}" for i in range(model.cfg.vocab_size)]))
    with pytest.raises(SystemExit, match="vocab.txt has"):
        tcli.main(["--model", "bert_tiny", "--device", "cpu", "--data_dir",
                   str(big), "--seq_len", "32", "--train_steps", "1"])
