"""Tokenizers of the port: copies of ``hetu_tpu/tokenizers``."""
from .bert_tokenizer import (
    BasicTokenizer, WordpieceTokenizer, BertTokenizer, load_vocab,
    whitespace_tokenize,
)
from .gpt2_tokenizer import GPT2Tokenizer, bytes_to_unicode

__all__ = ["BasicTokenizer", "WordpieceTokenizer", "BertTokenizer",
           "load_vocab", "whitespace_tokenize", "GPT2Tokenizer",
           "bytes_to_unicode"]
