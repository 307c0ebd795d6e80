"""BERT WordPiece tokenizer: the port's own copy of
``hetu_tpu/tokenizers/bert_tokenizer.py`` (stdlib only), whose reference is
Hetu's ``python/hetu/tokenizers/bert_tokenizer.py:12-19``: basic
tokenization + greedy longest-match wordpiece.

Self-contained: vocabularies load from local files (this image has no
egress, so the reference's S3 vocab-download map is names-only here; pass a
vocab path). The algorithm matches the canonical BERT behavior: text
cleanup, optional lowercasing with accent stripping, punctuation splitting,
CJK character isolation, then greedy ``##``-continuation wordpieces.
"""
from __future__ import annotations

import collections
import unicodedata

# kept for API parity with the reference's PRETRAINED_VOCAB_ARCHIVE_MAP;
# this environment cannot download, so these are names only
PRETRAINED_VOCAB_NAMES = [
    "bert-base-uncased", "bert-large-uncased", "bert-base-cased",
    "bert-large-cased", "bert-base-multilingual-uncased",
    "bert-base-multilingual-cased", "bert-base-chinese",
]
VOCAB_NAME = "vocab.txt"


def load_vocab(vocab_file):
    """Load a vocabulary file into an ordered token -> id dict."""
    vocab = collections.OrderedDict()
    with open(vocab_file, "r", encoding="utf-8") as reader:
        for index, line in enumerate(reader):
            token = line.rstrip("\n")
            if token:
                vocab[token] = index
    return vocab


def whitespace_tokenize(text):
    text = text.strip()
    return text.split() if text else []


def _is_whitespace(ch):
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    # ASCII non-alphanumerics count as punctuation (BERT convention: "$" or
    # "@" split too, even though unicode doesn't class them as P*)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp):
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """Cleanup + punctuation/CJK splitting (+ lowercase/accent-strip)."""

    def __init__(self, do_lower_case=True,
                 never_split=("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text):
        text = self._clean_text(text)
        text = self._pad_cjk(text)
        tokens = whitespace_tokenize(text)
        out = []
        for tok in tokens:
            if tok in self.never_split:
                out.append(tok)
                continue
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            out.extend(self._split_punct(tok))
        return whitespace_tokenize(" ".join(out))

    def _clean_text(self, text):
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text):
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text):
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(text):
        pieces = []
        cur = []
        for ch in text:
            if _is_punctuation(ch):
                if cur:
                    pieces.append("".join(cur))
                    cur = []
                pieces.append(ch)
            else:
                cur.append(ch)
        if cur:
            pieces.append("".join(cur))
        return pieces


class WordpieceTokenizer:
    """Greedy longest-match-first wordpiece with ``##`` continuations."""

    def __init__(self, vocab, unk_token="[UNK]", max_input_chars_per_word=100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text):
        out = []
        for token in whitespace_tokenize(text):
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            pieces = []
            start = 0
            bad = False
            while start < len(chars):
                end = len(chars)
                cur = None
                while start < end:
                    sub = "".join(chars[start:end])
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        cur = sub
                        break
                    end -= 1
                if cur is None:
                    bad = True
                    break
                pieces.append(cur)
                start = end
            out.extend([self.unk_token] if bad else pieces)
        return out


class BertTokenizer:
    """End-to-end: basic tokenization then wordpiece
    (reference BertTokenizer)."""

    def __init__(self, vocab_file, do_lower_case=True, max_len=None,
                 never_split=("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")):
        self.vocab = (vocab_file if isinstance(vocab_file, dict)
                      else load_vocab(vocab_file))
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic_tokenizer = BasicTokenizer(do_lower_case, never_split)
        self.wordpiece_tokenizer = WordpieceTokenizer(self.vocab)
        self.max_len = max_len if max_len is not None else int(1e12)

    def tokenize(self, text):
        tokens = []
        for tok in self.basic_tokenizer.tokenize(text):
            if tok in self.basic_tokenizer.never_split:
                tokens.append(tok)
            else:
                tokens.extend(self.wordpiece_tokenizer.tokenize(tok))
        return tokens

    def convert_tokens_to_ids(self, tokens):
        ids = [self.vocab.get(t, self.vocab.get("[UNK]")) for t in tokens]
        if len(ids) > self.max_len:
            raise ValueError(
                f"sequence length {len(ids)} exceeds max_len {self.max_len}")
        return ids

    def convert_ids_to_tokens(self, ids):
        return [self.ids_to_tokens[i] for i in ids]

    def encode(self, text):
        return self.convert_tokens_to_ids(self.tokenize(text))
