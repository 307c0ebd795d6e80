"""hetu_tpu_torch's tokenizers and BERT data pipeline against the JAX
package's: ``hetu_tpu_torch.tokenizers`` is a copy of
``hetu_tpu.tokenizers``, and ``hetu_tpu_torch/examples/processBertData.py``
of ``examples/nlp/processBertData.py``; both must give the same output.

Vocabularies and merges are built in place (no files are downloaded), as
``tests/test_nlp.py`` and ``tests/test_gpt2_tokenizer.py`` build them.
Tolerance: none; tokens, ids, round trips and instances are equal.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

import hetu_tpu_torch
from hetu_tpu.tokenizers import (BasicTokenizer as JBasic,
                                 BertTokenizer as JBert,
                                 GPT2Tokenizer as JGPT2,
                                 WordpieceTokenizer as JWordpiece,
                                 bytes_to_unicode)
from hetu_tpu_torch.examples import processBertData as tpbd
from hetu_tpu_torch.examples import train_hetu_bert
from hetu_tpu_torch.tokenizers import (BasicTokenizer, BertTokenizer,
                                       GPT2Tokenizer, WordpieceTokenizer,
                                       load_vocab)


def _load_reference(name):
    """A module of ``examples/nlp`` by its path, off ``sys.path``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples", "nlp", name + ".py")
    spec = importlib.util.spec_from_file_location("reference_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jpbd = _load_reference("processBertData")

WP_VOCAB = {t: i for i, t in enumerate(
    ["[UNK]", "[CLS]", "[SEP]", "want", "##want", "##ed", "wa", "un", "runn",
     "##ing", ","])}
BERT_TEXTS = ["unwanted running", "unwantedX running", "", "UNwantéd,running",
              " \tHeLLo!how  \n Are yoU?  ", "Héllo", "ah博推zz",
              "[CLS] want [SEP]", "a\x00b control\x07chars"]
GPT2_TEXTS = [
    "the thin man and the thinner man ran there",
    "The 123 quick 9 brown foxes' dens,  jumped!\n\nover\tthe lazy dog.",
    "it's the engineer's 123rd theorem",
    "emoji 😀 and 😀😀 stacked",
    "中文字符 mixed with the latin and ß ü ø",
    "   leading spaces and trailing   ",
    "a\x00b control\x07chars",
    "supercalifragilisticexpialidocious antidisestablishmentarianism",
    "",
    "'s't're've'm'll'd leading contractions",
    "the end<|endoftext|>the<|endoftext|>",
]


def test_the_package_exports_the_tokenizers():
    assert hetu_tpu_torch.BertTokenizer is BertTokenizer
    assert hetu_tpu_torch.GPT2Tokenizer is GPT2Tokenizer
    assert hetu_tpu_torch.tokenizers.bytes_to_unicode() == bytes_to_unicode()


@pytest.mark.parametrize("lower", [True, False])
def test_basic_and_wordpiece_match_jax(lower):
    for text in BERT_TEXTS:
        assert (BasicTokenizer(do_lower_case=lower).tokenize(text)
                == JBasic(do_lower_case=lower).tokenize(text))
        assert (WordpieceTokenizer(WP_VOCAB).tokenize(text)
                == JWordpiece(WP_VOCAB).tokenize(text))


def test_bert_tokenizer_matches_jax(tmp_path):
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("\n".join(WP_VOCAB) + "\n")
    for source in (str(vocab_file), dict(WP_VOCAB)):
        ours, ref = BertTokenizer(source), JBert(source)
        for text in BERT_TEXTS:
            toks = ours.tokenize(text)
            assert toks == ref.tokenize(text)
            ids = ours.convert_tokens_to_ids(toks)
            assert ids == ref.convert_tokens_to_ids(toks)
            assert ours.convert_ids_to_tokens(ids) == toks
            assert ours.encode(text) == ref.encode(text)
    assert ours.tokenize("UNwantéd,running") == [
        "un", "##want", "##ed", ",", "runn", "##ing"]
    assert list(load_vocab(str(vocab_file)).items())[:2] == [
        ("[UNK]", 0), ("[CLS]", 1)]


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    b2u = bytes_to_unicode()
    vocab = {c: i for i, c in enumerate(sorted(b2u.values()))}
    merges = ["t h", "th e", "h e", "i n", "a n", "e r", "Ġ t", "Ġt h",
              "Ġth e", "Ġ a", "Ġa n", "an d", "Ġan d", "r e", "o u",
              "1 2", "12 3", "' s", "e e"]
    emo = "".join(b2u[b] for b in "😀".encode("utf-8"))
    merges.append(f"{emo[0]} {emo[1]}")
    for m in merges:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    with open(d / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(d / "merges.txt", "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(d / "vocab.json"), str(d / "merges.txt")


@pytest.mark.parametrize("specials", [None, ("<b>", "<e>", "<u>")])
def test_gpt2_tokenizer_matches_jax(bpe_files, specials):
    kw = {} if specials is None else dict(special_tokens=specials)
    ours, ref = GPT2Tokenizer(*bpe_files, **kw), JGPT2(*bpe_files, **kw)
    texts = GPT2_TEXTS + ([f"th{specials[1]}the{specials[0]}x{specials[2]}"]
                          if specials else [])
    for text in texts:
        assert ours.tokenize(text) == ref.tokenize(text)
        ids = ours.encode(text)
        assert ids == ref.encode(text)
        assert ours.decode(ids) == text == ref.decode(ids)


def test_gpt2_random_bytes_round_trip(bpe_files):
    ours, ref = GPT2Tokenizer(*bpe_files), JGPT2(*bpe_files)
    rng = np.random.RandomState(0)
    for _ in range(30):
        text = bytes(rng.randint(0, 256, rng.randint(1, 40)).tolist()
                     ).decode("utf-8", errors="replace")
        ids = ours.encode(text)
        assert ids == ref.encode(text)
        assert ours.decode(ids) == ref.decode(ids) == text


def test_gpt2_tokenizer_needs_regex(bpe_files, monkeypatch):
    from hetu_tpu_torch.tokenizers import gpt2_tokenizer
    monkeypatch.setattr(gpt2_tokenizer, "_HAS_REGEX", False)
    with pytest.raises(ImportError, match="regex"):
        GPT2Tokenizer(*bpe_files)


def _same_instances(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) == 6
        for u, v in zip(x[:5], y[:5]):
            assert u.dtype == v.dtype and np.array_equal(u, v)
        assert x[5] == y[5]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bert_instances_equal_jax(seed):
    sents = train_hetu_bert.SAMPLE_SENTENCES
    vocab = train_hetu_bert.build_vocab(sents)
    for max_seq, max_pred in ((32, 5), (24, 3), (128, 20)):
        got = tpbd.create_instances_from_document(
            sents, BertTokenizer(vocab), max_seq_length=max_seq,
            max_predictions_per_seq=max_pred, seed=seed)
        want = jpbd.create_instances_from_document(
            sents, JBert(vocab), max_seq_length=max_seq,
            max_predictions_per_seq=max_pred, seed=seed)
        _same_instances(got, want)
    # the corpus the trainer runs: a vocabulary of 65, 47 instances
    assert len(vocab) == 65 and len(got) == 47


def test_masked_lm_predictions_equal_jax():
    tokens = ["[CLS]"] + "the quick brown fox jumps over".split() + ["[SEP]"]
    words = list(train_hetu_bert.build_vocab(
        train_hetu_bert.SAMPLE_SENTENCES))
    for seed in range(5):
        got = tpbd.create_masked_lm_predictions(
            tokens, 0.5, 3, words, np.random.RandomState(seed))
        want = jpbd.create_masked_lm_predictions(
            tokens, 0.5, 3, words, np.random.RandomState(seed))
        assert got[0] == want[0]
        assert [tuple(m) for m in got[1]] == [tuple(m) for m in want[1]]
