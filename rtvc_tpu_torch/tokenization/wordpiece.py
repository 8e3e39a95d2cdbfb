"""Pure-Python BERT tokenizer (BasicTokenizer + WordPiece) and caption codec.

A copy of ``rtvc_tpu/tokenization/wordpiece.py``, unchanged below this
paragraph: importing ``rtvc_tpu`` imports jax.
tests/test_torch_tokenization.py holds the copy equal to the original.

Reimplements the tokenizer behavior the reference got from HuggingFace
``BertTokenizer('bert-base-uncased', do_lower_case=True)``:

- basic tokenization: whitespace split, lowercasing, accent stripping (NFD),
  punctuation splitting, CJK-character isolation, control-char removal;
- WordPiece: greedy longest-match-first subword segmentation with ``##``
  continuation prefix and ``[UNK]`` fallback for unsegmentable words
  (max 100 chars per word, as in BERT);
- ``encode_caption``: the reference's exact caption-encoding recipe
  (reference src/utils/tokenizer.py:5-27) — tokenize WITHOUT special tokens,
  if longer than ``max_text_len - 2`` keep the TAIL, then prepend [CLS]
  and append NO [SEP];
- ``decode(..., skip_special_tokens=True)``: HF-compatible detokenization
  used for predictions/GT (reference model.py:1013-1016).

No torch, no network: the vocab comes from a file or the synthetic builder.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence

from .vocab import (
    CLS_TOKEN,
    MASK_TOKEN,
    PAD_TOKEN,
    SEP_TOKEN,
    UNK_TOKEN,
    build_synthetic_vocab,
    load_vocab,
)


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-letter/number blocks are treated as punctuation (BERT rule).
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """BERT basic tokenizer: clean, lowercase, strip accents, split punct."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return [t for t in tokens if t]

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]


class WordPiece:
    """Greedy longest-match-first WordPiece with '##' continuation."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = UNK_TOKEN,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


class BertWordPieceTokenizer:
    """Drop-in offline replacement for the HF BertTokenizer surface we need."""

    def __init__(self, vocab: Optional[Dict[str, int]] = None,
                 vocab_file: Optional[str] = None, do_lower_case: bool = True):
        if vocab is None:
            vocab = load_vocab(vocab_file) if vocab_file else build_synthetic_vocab()
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.basic = BasicTokenizer(do_lower_case)
        self.wordpiece = WordPiece(vocab)
        self.pad_token_id = vocab[PAD_TOKEN]
        self.unk_token_id = vocab[UNK_TOKEN]
        self.cls_token_id = vocab[CLS_TOKEN]
        self.sep_token_id = vocab[SEP_TOKEN]
        self.mask_token_id = vocab[MASK_TOKEN]
        # HF ``all_special_ids`` for BERT — [UNK] included, so
        # ``decode(skip_special_tokens=True)`` drops unknowns exactly as the
        # reference's HF tokenizer did before the metric sweep.
        self._special_ids = {
            self.pad_token_id, self.unk_token_id, self.cls_token_id,
            self.sep_token_id, self.mask_token_id,
        }
        # HF never splits special-token literals appearing in raw text
        # (tokens_trie split before _tokenize) — '[UNK]' in a caption stays
        # one token, case-sensitively. Longest-first keeps parity if one
        # special is a prefix of another.
        self._never_split = sorted(
            (PAD_TOKEN, UNK_TOKEN, CLS_TOKEN, SEP_TOKEN, MASK_TOKEN),
            key=len, reverse=True)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for segment in self._split_on_specials(text):
            if segment in self._never_split:
                out.append(segment)
                continue
            for word in self.basic.tokenize(segment):
                out.extend(self.wordpiece.tokenize(word))
        return out

    def _split_on_specials(self, text: str) -> List[str]:
        segments = [text]
        for special in self._never_split:
            next_segments: List[str] = []
            for seg in segments:
                if seg in self._never_split:
                    next_segments.append(seg)
                    continue
                parts = seg.split(special)
                for i, part in enumerate(parts):
                    if i:
                        next_segments.append(special)
                    if part:
                        next_segments.append(part)
            segments = next_segments
        return segments

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def encode(self, text: str, add_special_tokens: bool = False,
               max_length: Optional[int] = None, truncation: bool = False) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if truncation and max_length is not None:
            budget = max_length - (2 if add_special_tokens else 0)
            ids = ids[:budget]
        if add_special_tokens:
            ids = [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True,
               clean_up_tokenization_spaces: bool = True) -> str:
        tokens: List[str] = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self._special_ids:
                continue
            tokens.append(self.inv_vocab.get(i, UNK_TOKEN))
        # HF convert_tokens_to_string: space-join, glue '##' continuations.
        text = " ".join(tokens).replace(" ##", "").strip()
        if clean_up_tokenization_spaces:
            text = self.clean_up_tokenization(text)
        return text

    @staticmethod
    def clean_up_tokenization(text: str) -> str:
        """HF ``clean_up_tokenization`` — the reference decoded predictions
        and GT captions with this ON (transformers 4.35.0 default), so the
        strings entering its metric sweep had ``don ' t`` -> ``don't`` and
        no space before ``.?!,`` (reference model.py:1013-1016)."""
        return (text.replace(" .", ".").replace(" ?", "?")
                .replace(" !", "!").replace(" ,", ",")
                .replace(" ' ", "'").replace(" n't", "n't")
                .replace(" 'm", "'m").replace(" 's", "'s")
                .replace(" 've", "'ve").replace(" 're", "'re"))

    def __call__(self, text: str, padding: str = "do_not_pad",
                 truncation: bool = True, add_special_tokens: bool = False,
                 max_length: int = 40) -> Dict[str, List[int]]:
        ids = self.encode(text, add_special_tokens=add_special_tokens,
                          max_length=max_length, truncation=truncation)
        return {"input_ids": ids}


def encode_caption(caption: str, tokenizer: BertWordPieceTokenizer,
                   max_text_len: int = 40) -> List[int]:
    """Reference-faithful caption encoding (src/utils/tokenizer.py:5-27).

    Tokenize without special tokens (HF truncation to ``max_text_len`` first),
    keep the LAST ``max_text_len - 2`` ids if longer, prepend [CLS]; no [SEP]
    is appended (a reference quirk preserved on purpose — decode loops stop on
    SEP emitted by the model, not by the labels).
    """
    encoding = tokenizer(caption, padding="do_not_pad", truncation=True,
                         add_special_tokens=False, max_length=max_text_len)
    payload = encoding["input_ids"]
    if len(payload) > max_text_len - 2:
        payload = payload[-(max_text_len - 2):]
    return [tokenizer.cls_token_id] + payload
