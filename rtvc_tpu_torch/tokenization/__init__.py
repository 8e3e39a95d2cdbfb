"""The BERT WordPiece tokenizer and its vocabulary: a copy of
``rtvc_tpu/tokenization`` (pure Python; importing ``rtvc_tpu`` imports
jax), held equal to the original by tests/test_torch_tokenization.py."""

from .wordpiece import BertWordPieceTokenizer, encode_caption
from .vocab import load_vocab, build_synthetic_vocab

__all__ = [
    "BertWordPieceTokenizer",
    "encode_caption",
    "load_vocab",
    "build_synthetic_vocab",
]
