"""Vocabulary loading and synthetic-vocab construction.

A copy of ``rtvc_tpu/tokenization/vocab.py``, unchanged below this
paragraph: importing ``rtvc_tpu`` imports jax.
tests/test_torch_tokenization.py holds the copy equal to the original.

The reference relied on ``BertTokenizer.from_pretrained('bert-base-uncased')``
(reference src/models/model.py:733) which needs network access. Here the
tokenizer is driven by a plain ``vocab.txt`` (one token per line, id = line
number — the exact HF/BERT format), so a user can drop in the real
30,522-entry bert-base-uncased vocab for bit-identical ids. For tests and
offline smoke runs, :func:`build_synthetic_vocab` constructs a deterministic
WordPiece vocabulary with the same special-token layout as bert-base-uncased
([PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

PAD_TOKEN = "[PAD]"
UNK_TOKEN = "[UNK]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
MASK_TOKEN = "[MASK]"

# bert-base-uncased id layout
PAD_ID = 0
UNK_ID = 100
CLS_ID = 101
SEP_ID = 102
MASK_ID = 103
BERT_VOCAB_SIZE = 30522


def load_vocab(path: str) -> Dict[str, int]:
    """Load a BERT-format vocab file (token per line)."""
    vocab: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for idx, line in enumerate(f):
            token = line.rstrip("\n")
            if token:
                vocab[token] = idx
    return vocab


def save_vocab(vocab: Dict[str, int], path: str) -> None:
    inv = {i: t for t, i in vocab.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(max(inv) + 1):
            f.write(inv.get(i, f"[unused_{i}]") + "\n")


# A compact core word list so synthetic captions round-trip through whole-word
# tokens; everything else falls back to character-level WordPiece pieces.
_CORE_WORDS: List[str] = (
    "a the is are was were be being been to of and in on at for with from by "
    "man woman person people boy girl child dog cat car road street ball game "
    "video man's playing running walking singing dancing cooking talking "
    "eating drinking riding driving jumping swimming flying sitting standing "
    "shows showing show plays play talks talk sings sing runs run walks walk "
    "someone something group two three four five six red blue green black "
    "white small big large little young old new field water food kitchen "
    "music song stage room house ball basketball football soccer guitar piano "
    "camera phone computer screen table chair tv news anchor reporter clip "
    "scene movie film cartoon animation character speaking interview crowd "
    "audience player team match race horse bird fish monkey lion tiger bear "
    "makeup hair face hand hands head body wearing shirt dress hat glasses "
    "outside inside beach ocean mountain sky sun night day morning city town "
    "park garden tree grass flower snow rain wind fire toy doll train plane "
    "boat bike motorcycle bus truck about into over under through around up "
    "down his her their its our your my he she it they we you i this that "
    "there here very really then when while as an or not no yes how what who"
).split()


def build_synthetic_vocab(extra_words: Optional[Iterable[str]] = None,
                          size: int = 2048) -> Dict[str, int]:
    """Deterministic small vocab with bert-base-uncased special-token ids.

    Layout: ids 0..98 unused fillers + specials pinned at the exact
    bert-base-uncased positions, then a-z single chars, '##'-prefixed chars,
    digits, punctuation, then whole words. Total padded to ``size``.
    """
    tokens: Dict[int, str] = {
        PAD_ID: PAD_TOKEN,
        UNK_ID: UNK_TOKEN,
        CLS_ID: CLS_TOKEN,
        SEP_ID: SEP_TOKEN,
        MASK_ID: MASK_TOKEN,
    }
    next_id = 104
    pieces: List[str] = []
    chars = "abcdefghijklmnopqrstuvwxyz0123456789"
    pieces += list(chars)
    pieces += ["##" + c for c in chars]
    pieces += list(".,!?;:'\"()-&/%$#@")
    pieces += ["##'", "##s", "##ing", "##ed", "##er", "##es", "##ly", "##y"]
    words = list(_CORE_WORDS)
    if extra_words:
        words += [w.lower() for w in extra_words]
    seen = set(tokens.values())
    for tok in pieces + words:
        if tok in seen:
            continue
        tokens[next_id] = tok
        seen.add(tok)
        next_id += 1
    vocab = {}
    for i in range(max(size, next_id)):
        vocab[tokens.get(i, f"[unused_{i}]")] = i
    return {t: i for t, i in vocab.items()}
