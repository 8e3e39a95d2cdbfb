"""The port's copy of the tokenizer against the original
(rtvc_tpu_torch.tokenization vs rtvc_tpu.tokenization).

The copy exists because importing ``rtvc_tpu`` imports jax; these tests
hold it to the original: the same synthetic vocabulary, the same
``tokenize``/``encode``/``decode``/``encode_caption`` output over the
strings of tests/test_tokenizer.py and seeded random text (letters,
digits, punctuation, accents, CJK, control characters, special-token
literals), and vocab files that either side reads back.
"""

import numpy as np
import pytest

from rtvc_tpu import tokenization as jtok
from rtvc_tpu.tokenization import vocab as jvocab
from rtvc_tpu_torch import tokenization as ptok
from rtvc_tpu_torch.tokenization import vocab as pvocab

FIXED = [
    "A man is playing guitar", "guitarist", "dog,cat", "a man is running",
    " ".join(["dog"] * 60), "üñîçødé_zzz€", "a dog runs", "",
    "Don't stop! It's a man's dog, isn't it?", "[CLS] a [UNK] dog [SEP]",
    "x[MASK]y [PAD]", "Ünïcödé ÀÉÎ 東京 タワー", "tab\tnew\nline\r end",
    "a" * 120, "basketball basketballs footballer", "3.14 + 2 = 5.14 $%&",
]
ALPHABET = list("abcdefghijklmnopqrstuvwxyz ABCXYZ 0123456789 .,!?;:'\"()-&")
ALPHABET += ["é", "ü", "ñ", "东", "京", "\t", "\n", "\x00", "​", " ",
             "[UNK]", "[SEP]", "##", "man", "dog", "playing"]


def _random_texts(n: int = 300):
    rng = np.random.default_rng(17)
    return ["".join(rng.choice(ALPHABET, size=int(rng.integers(0, 40))))
            for _ in range(n)]


TEXTS = FIXED + _random_texts()


@pytest.fixture(scope="module")
def pair():
    return (jtok.BertWordPieceTokenizer(jtok.build_synthetic_vocab()),
            ptok.BertWordPieceTokenizer(ptok.build_synthetic_vocab()))


@pytest.mark.parametrize("extra,size", [(None, 2048), (["Zebra", "qux"], 2048),
                                         (None, 300)])
def test_synthetic_vocab_equals_original(extra, size):
    assert (ptok.build_synthetic_vocab(extra, size)
            == jtok.build_synthetic_vocab(extra, size))


def test_special_ids_equal_original(pair):
    j, p = pair
    for name in ("pad_token_id", "unk_token_id", "cls_token_id",
                 "sep_token_id", "mask_token_id", "vocab_size"):
        assert getattr(p, name) == getattr(j, name), name
    for name in ("PAD_ID", "UNK_ID", "CLS_ID", "SEP_ID", "MASK_ID",
                 "BERT_VOCAB_SIZE", "PAD_TOKEN", "UNK_TOKEN", "CLS_TOKEN",
                 "SEP_TOKEN", "MASK_TOKEN"):
        assert getattr(pvocab, name) == getattr(jvocab, name), name


def test_tokenize_and_encode_equal_original(pair):
    j, p = pair
    for text in TEXTS:
        assert p.tokenize(text) == j.tokenize(text), repr(text)
        assert p.encode(text) == j.encode(text), repr(text)
        kw = dict(add_special_tokens=True, max_length=12, truncation=True)
        assert p.encode(text, **kw) == j.encode(text, **kw), repr(text)
        assert p(text) == j(text), repr(text)


@pytest.mark.parametrize("max_text_len", [40, 10, 3])
def test_encode_caption_equals_original(pair, max_text_len):
    j, p = pair
    for text in TEXTS:
        assert (ptok.encode_caption(text, p, max_text_len)
                == jtok.encode_caption(text, j, max_text_len)), repr(text)


def test_decode_equals_original(pair):
    """Over the encodings of every text and over random id rows (specials,
    unknown ids past the vocab, the tokens the cleanup glues)."""
    j, p = pair
    rng = np.random.default_rng(23)
    rows = [j.encode(t, add_special_tokens=True) for t in TEXTS]
    rows += [list(rng.integers(0, 2200, size=int(rng.integers(0, 30))))
             for _ in range(200)]
    rows += [rng.integers(0, 2200, size=26).astype(np.int32)]
    for ids in rows:
        for skip in (True, False):
            for clean in (True, False):
                assert (p.decode(ids, skip, clean)
                        == j.decode(ids, skip, clean)), (ids, skip, clean)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_vocab_file_round_trips(tmp_path, writer):
    vocab = ptok.build_synthetic_vocab(["zebra"])
    path = str(tmp_path / "sub" / "vocab.txt")
    (pvocab if writer == "port" else jvocab).save_vocab(vocab, path)
    assert pvocab.load_vocab(path) == jvocab.load_vocab(path) == vocab
    p = ptok.BertWordPieceTokenizer(vocab_file=path)
    j = jtok.BertWordPieceTokenizer(vocab_file=path)
    assert p.vocab == j.vocab and p.cls_token_id == 101
    assert p.decode(p.encode("a zebra runs")) == "a zebra runs"
