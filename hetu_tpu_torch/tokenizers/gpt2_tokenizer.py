"""GPT-2 byte-level BPE tokenizer: the port's own copy of
``hetu_tpu/tokenizers/gpt2_tokenizer.py`` (stdlib plus ``regex``), the
tokenizer of the GPT-2 inference path (tokenize -> checkpoint ->
``models/generate`` decode).

Beyond reference parity: the reference ships only the BERT WordPiece
tokenizer (``python/hetu/tokenizers``); it has no BPE. This is an
independent implementation of the canonical algorithm (Radford et al.
2019): UTF-8 bytes are mapped to printable unicode proxies, text is
pre-split by the GPT-2 regex pattern, and each pre-token is merged
greedily by ascending merge rank. ``tests/test_gpt2_tokenizer.py`` pins
token-for-token equality against ``transformers.GPT2Tokenizer`` over
byte-level-odd inputs (emoji, CJK, control chars, long words).

Vocabulary files are the standard ``vocab.json`` + ``merges.txt`` pair
(this image has no egress — point at local files; any HF GPT-2 tokenizer
directory works).
"""
from __future__ import annotations

import json
from functools import lru_cache

try:                      # the canonical pattern needs \p classes;
    import regex as _re   # transformers depends on `regex`, so it is
    _HAS_REGEX = True     # present wherever the oracle is
except ImportError:       # pragma: no cover - exercised only without regex
    _re = None
    _HAS_REGEX = False

# GPT-2's pre-tokenization pattern: contractions, letter runs (with an
# optional leading space), number runs, other-symbol runs, trailing spaces
_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
            r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


@lru_cache()
def bytes_to_unicode():
    """The GPT-2 byte->printable-unicode table: printable ASCII and two
    Latin-1 ranges map to themselves, the remaining 68 bytes map to
    256+i so every byte has a visible, json-safe proxy character."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2Tokenizer:
    """vocab.json + merges.txt -> encode/decode matching HF's GPT2Tokenizer
    (the slow/reference implementation) token for token."""

    def __init__(self, vocab_file, merges_file, errors="replace",
                 special_tokens=("<|endoftext|>",)):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder = json.load(f)
        # special tokens are never split by BPE; ones absent from the
        # vocab are appended in the GIVEN order. HF appends its specials
        # in special-token-ATTRIBUTE order (bos, eos, unk, sep, pad, cls,
        # mask, additional) — pass yours in that order and the appended
        # ids line up with the transformers oracle (pinned by test)
        self.special_tokens = tuple(dict.fromkeys(special_tokens))
        for tok in self.special_tokens:
            if tok not in self.encoder:
                self.encoder[tok] = len(self.encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            # HF drops the first line (assumed #version header) and the
            # last (assumed empty from the trailing newline) UNCONDITIONALLY
            # — mirror that exactly, or ranks shift by one on files
            # without a header / without a trailing newline
            lines = f.read().split("\n")[1:-1]
        merges = [tuple(line.split()) for line in lines]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.errors = errors
        self._cache = {}
        if not _HAS_REGEX:
            raise ImportError(
                "GPT2Tokenizer needs the `regex` module for the canonical "
                "\\p{L}/\\p{N} pre-tokenization pattern")
        self._pat = _re.compile(_PATTERN)

    # -- BPE over one pre-token (already byte-mapped) ---------------------
    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        while len(word) > 1:
            pair = min(_pairs(word),
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if pair not in self.bpe_ranks:
                break
            a, b = pair
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == a and word[i + 1] == b):
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        self._cache[token] = out
        return out

    def _split_specials(self, text: str) -> list[str]:
        """Split into alternating plain-text / special-token chunks; BPE
        never crosses a special-token boundary."""
        chunks = [text]
        # longest-first: a special that is a substring of another (e.g.
        # "<|end|>" vs "<|endoftext|>") must not tear the longer one apart
        # — HF matches added tokens longest-first the same way
        for tok in sorted(self.special_tokens, key=len, reverse=True):
            nxt = []
            for c in chunks:
                if c in self.special_tokens:
                    nxt.append(c)
                    continue
                parts = c.split(tok)
                for i, p in enumerate(parts):
                    if i:
                        nxt.append(tok)
                    if p:
                        nxt.append(p)
            chunks = nxt
        return chunks

    def tokenize(self, text: str) -> list[str]:
        toks = []
        for chunk in self._split_specials(text):
            if chunk in self.special_tokens:
                toks.append(chunk)
                continue
            for pre in self._pat.findall(chunk):
                mapped = "".join(self.byte_encoder[b]
                                 for b in pre.encode("utf-8"))
                toks.extend(self._bpe(mapped))
        return toks

    def encode(self, text: str) -> list[int]:
        out = []
        for t in self.tokenize(text):
            try:
                out.append(self.encoder[t])
            except KeyError:
                raise ValueError(
                    f"token {t!r} produced by merges.txt is absent from "
                    f"vocab.json — the vocab/merges pair is mismatched "
                    f"(files from different checkpoints?)") from None
        return out

    def decode(self, ids) -> str:
        # byte proxies must be concatenated ACROSS tokens before UTF-8
        # decoding (a multi-byte char can span BPE tokens); specials are
        # literal text and flush the pending byte run
        out, run = [], []

        def flush():
            if run:
                out.append(bytearray(self.byte_decoder[c]
                                     for c in "".join(run))
                           .decode("utf-8", errors=self.errors))
                run.clear()

        for i in ids:
            tok = self.decoder[int(i)]
            if tok in self.special_tokens:
                flush()
                out.append(tok)
            else:
                run.append(tok)
        flush()
        return "".join(out)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)
