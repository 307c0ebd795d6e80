"""BERT pretraining data pipeline on the port (a copy of
``examples/nlp/processBertData.py``): sentence-pair instances with
masked-LM (15%, 80/10/10) and next-sentence-prediction labels, built on the
``hetu_tpu_torch.tokenizers`` WordPiece tokenizer. The draws are the
reference's, from one ``numpy.random.RandomState``, so one seed gives the
same instances in both packages."""
import collections

import numpy as np

MaskedLmInstance = collections.namedtuple("MaskedLmInstance",
                                          ["index", "label"])


def create_masked_lm_predictions(tokens, masked_lm_prob, max_predictions,
                                 vocab_words, rng):
    """Standard BERT masking: pick up to 15% of non-special positions;
    80% -> [MASK], 10% -> random token, 10% -> unchanged."""
    cand = [i for i, t in enumerate(tokens) if t not in ("[CLS]", "[SEP]")]
    rng.shuffle(cand)
    n_pred = min(max_predictions, max(1, int(round(len(tokens)
                                                   * masked_lm_prob))))
    out = list(tokens)
    masked = []
    for idx in sorted(cand[:n_pred]):
        if rng.rand() < 0.8:
            repl = "[MASK]"
        elif rng.rand() < 0.5:
            repl = vocab_words[rng.randint(0, len(vocab_words))]
        else:
            repl = tokens[idx]
        masked.append(MaskedLmInstance(index=idx, label=tokens[idx]))
        out[idx] = repl
    return out, masked


def create_instances_from_document(sentences, tokenizer, max_seq_length=128,
                                   masked_lm_prob=0.15,
                                   max_predictions_per_seq=20, seed=0):
    """Yield (input_ids, input_mask, segment_ids, mlm_positions, mlm_ids,
    nsp_label) numpy rows from a list of sentence strings."""
    rng = np.random.RandomState(seed)
    tokenized = [tokenizer.tokenize(s) for s in sentences if s.strip()]
    vocab_words = list(tokenizer.vocab.keys())
    max_tokens = max_seq_length - 3  # [CLS] a [SEP] b [SEP]
    instances = []
    for i in range(len(tokenized) - 1):
        a = list(tokenized[i])   # copies: truncation must not corrupt the
        if rng.rand() < 0.5 or len(tokenized) <= 2:
            b = list(tokenized[i + 1])  # stored corpus for later instances
            nsp = 1  # actual next sentence
        else:
            # negative sample: any sentence EXCEPT a and its real successor
            choices = [j for j in range(len(tokenized))
                       if j not in (i, i + 1)]
            b = list(tokenized[choices[rng.randint(0, len(choices))]])
            nsp = 0
        while len(a) + len(b) > max_tokens:
            (a if len(a) > len(b) else b).pop()
        tokens = ["[CLS]"] + a + ["[SEP]"] + b + ["[SEP]"]
        segment = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        tokens, masked = create_masked_lm_predictions(
            tokens, masked_lm_prob, max_predictions_per_seq, vocab_words, rng)
        ids = tokenizer.convert_tokens_to_ids(tokens)
        pad = max_seq_length - len(ids)
        input_mask = [1] * len(ids) + [0] * pad
        ids = ids + [tokenizer.vocab["[PAD]"]] * pad
        segment = segment + [0] * pad
        mlm_pos = [m.index for m in masked]
        mlm_ids = tokenizer.convert_tokens_to_ids([m.label for m in masked])
        mlm_pad = max_predictions_per_seq - len(mlm_pos)
        mlm_pos = mlm_pos + [0] * mlm_pad
        mlm_ids = mlm_ids + [0] * mlm_pad
        instances.append((np.asarray(ids, np.int32),
                          np.asarray(input_mask, np.int32),
                          np.asarray(segment, np.int32),
                          np.asarray(mlm_pos, np.int32),
                          np.asarray(mlm_ids, np.int32), nsp))
    return instances
