"""Graph-API transformer LM trainer on the port (a copy of
``examples/nlp/train_hetu_transformer.py`` over ``hetu_tpu_torch``): a
word-level LM over a built-in text sample tokenized by the BERT WordPiece
tokenizer (``hetu_tpu_torch.tokenizers``) with a corpus-derived
vocabulary, the causal LM of ``examples/hetu_transformer.py`` trained with
Adam through ``Executor.run`` on ``cuda:0``.

  python -m hetu_tpu_torch.examples.train_hetu_transformer [--steps 200]

The reference picks its device from ``JAX_PLATFORMS``; here the executor
runs on ``ht.gpu(0)``, and a caller picks the CPU by ``main(argv,
device="cpu")``, as the tests do.
"""
import argparse
import collections
import time

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch.examples.hetu_transformer import transformer_lm
from hetu_tpu_torch.tokenizers import BertTokenizer

SAMPLE_TEXT = """
the quick brown fox jumps over the lazy dog . the dog barks at the fox ,
and the fox runs into the woods . in the woods the fox meets another fox .
the two foxes play in the woods until the dog finds them again . then the
quick brown fox jumps over the lazy dog once more , and the game repeats .
every day the dog chases the fox and every day the fox escapes into the
woods . the lazy dog never learns , and the quick fox never tires .
""" * 8


def build_vocab(text, min_count=1):
    """Word-level vocab with wordpiece suffix entries for coverage."""
    counts = collections.Counter(text.split())
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    for word, c in counts.most_common():
        if c >= min_count and word not in vocab:
            vocab[word] = len(vocab)
    # character fallbacks so wordpiece never hits [UNK] on this corpus
    for ch in sorted(set(text.replace(" ", "").replace("\n", ""))):
        for piece in (ch, "##" + ch):
            if piece not in vocab:
                vocab[piece] = len(vocab)
    return vocab


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--timing", action="store_true")
    return ap.parse_args(argv)


def build(args, device=None, kernels=None):
    """The corpus's token ids and the trainer: ``(ids, executor, tokens,
    labels)``, the executor on the CPU for ``device="cpu"``, else on
    ``cuda:0``; ``kernels`` as ``Executor``'s."""
    vocab = build_vocab(SAMPLE_TEXT)
    tok = BertTokenizer(vocab)
    ids = np.asarray(tok.encode(SAMPLE_TEXT), np.float32)
    print(f"corpus: {ids.size} tokens, vocab {len(vocab)}")

    tokens = ht.Variable(name="tokens", trainable=False)
    labels = ht.Variable(name="labels", trainable=False)
    loss, logits, _ = transformer_lm(
        tokens, labels, len(vocab), args.batch_size, args.seq_len,
        d_model=args.d_model, n_heads=args.n_heads, n_layers=args.n_layers)
    opt = ht.optim.AdamOptimizer(learning_rate=args.lr)
    train_op = opt.minimize(loss)
    ex = ht.Executor({"train": [loss, train_op]},
                     ctx=ht.cpu(0) if device == "cpu" else ht.gpu(0), seed=0,
                     kernels=kernels)
    return ids, ex, tokens, labels


def batches(ids, args):
    """The training windows, step after step: ``(inputs, next tokens)``,
    each (B, T)."""
    B, T = args.batch_size, args.seq_len
    rng = np.random.RandomState(0)
    while True:
        starts = rng.randint(0, ids.size - T - 1, B)
        yield (np.stack([ids[s:s + T] for s in starts]),
               np.stack([ids[s + 1:s + T + 1] for s in starts]))


def main(argv=None, device=None):
    """Train; returns the per-step losses. ``device="cpu"`` runs the
    executor on the CPU, anything else on ``cuda:0``."""
    args = parse_args(argv)
    ids, ex, tokens, labels = build(args, device)

    t0 = time.time()
    window, losses = [], []
    for step, (bx, by) in zip(range(args.steps), batches(ids, args)):
        lv = ex.run("train", feed_dict={tokens: bx, labels: by})[0]
        losses.append(float(np.mean(lv.asnumpy())))
        window.append(losses[-1])
        if (step + 1) % 50 == 0:
            ppl = float(np.exp(np.mean(window)))
            print(f"step {step + 1}: loss {np.mean(window):.4f} ppl {ppl:.1f}")
            window = []
    if args.timing:
        print(f"{args.steps} steps in {time.time() - t0:.1f}s "
              f"({(time.time() - t0) / args.steps * 1000:.1f} ms/step)")
    return losses


if __name__ == "__main__":
    main()
