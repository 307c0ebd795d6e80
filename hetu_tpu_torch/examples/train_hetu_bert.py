"""BERT pretraining trainer on the port, the pipeline end to end (a copy of
``examples/nlp/train_hetu_bert.py`` over ``hetu_tpu_torch``):

  corpus sentences -> WordPiece tokenizer (hetu_tpu_torch.tokenizers)
    -> sentence-pair MLM/NSP instances (processBertData)
    -> pretrain step on hetu_tpu_torch.models.bert (flash attention on the
       card when the sequence is a multiple of 128)
    -> step-numbered checkpoints with exact resume (hetu_tpu_torch.checkpoint).

Trains over a built-in corpus with a vocabulary built from it, on
``cuda:0`` in bf16, or on the CPU in f32 under ``--cpu``.

  python -m hetu_tpu_torch.examples.train_hetu_bert --num-epoch 20 --cpu
  python -m hetu_tpu_torch.examples.train_hetu_bert --ckpt-dir D --resume
"""
import argparse
import collections
import time

import numpy as np
import torch

from hetu_tpu_torch import checkpoint
from hetu_tpu_torch.examples import processBertData as pbd
from hetu_tpu_torch.models import bert
from hetu_tpu_torch.tokenizers import BertTokenizer

SAMPLE_SENTENCES = [
    "the quick brown fox jumps over the lazy dog",
    "the dog barks at the fox near the old oak tree",
    "the fox runs into the deep dark woods",
    "in the woods the fox meets another clever fox",
    "the two foxes play among the tall trees until sunset",
    "the tired dog finds the foxes at the edge of the woods",
    "the quick fox jumps over the sleeping dog once more",
    "every day the dog chases the fox across the green field",
    "every evening the fox escapes into the quiet woods",
    "the lazy dog never learns and the quick fox never tires",
    "a young fox watches the game from a hollow log",
    "the old tree stands at the center of the dark woods",
] * 4


def build_vocab(sentences):
    counts = collections.Counter(w for s in sentences for w in s.split())
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    for word, _ in counts.most_common():
        vocab.setdefault(word, len(vocab))
    return vocab


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=128)
    ap.add_argument("--max-seq-length", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--num-epoch", type=int, default=20)
    ap.add_argument("--learning-rate", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save a step-numbered checkpoint every N epochs")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def pretrain_data(max_seq_length, device):
    """The corpus's vocabulary and its MLM/NSP instances as one batch
    dict: ``(vocab, full)``."""
    vocab = build_vocab(SAMPLE_SENTENCES)
    tok = BertTokenizer(vocab)
    instances = pbd.create_instances_from_document(
        SAMPLE_SENTENCES, tok, max_seq_length=max_seq_length,
        max_predictions_per_seq=5)
    return vocab, bert.batch_from_instances(instances, device)


def config(args, vocab_size):
    return bert.BertConfig(
        vocab_size=vocab_size, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
        max_seq_len=args.max_seq_length,
        dtype=torch.float32 if args.cpu else torch.bfloat16, remat=False)


def run(args, params=None, on_step=None):
    """Train as ``main`` does; ``params`` (the model's initial parameters
    on the run's device) replace the seeded ones, and ``on_step(epoch,
    step, loss, mlm, nsp)`` sees each step. Returns ``(the last epoch's
    mean loss, the final state {"params", "opt"})``; the loss is None
    when a resumed run had nothing left to train."""
    device = "cpu" if args.cpu else torch.device("cuda", 0)
    vocab, full = pretrain_data(args.max_seq_length, device)
    n = len(full["input_ids"])
    print(f"vocab {len(vocab)}, {n} pretrain instances", flush=True)

    cfg = config(args, len(vocab))
    if params is None:
        params = bert.init_params(0, cfg, device)
    opt = bert.init_opt_state(params)
    step_fn = bert.make_pretrain_step(cfg, lr=args.learning_rate)

    ck = None
    start_epoch = 0
    if args.ckpt_dir:
        ck = checkpoint.TrainCheckpointer(args.ckpt_dir, keep=3)
        if args.resume and ck.latest_step() is not None:
            state, start_epoch = ck.restore_latest(
                like={"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            start_epoch += 1
            print(f"resumed from epoch {start_epoch - 1}", flush=True)

    if start_epoch >= args.num_epoch:
        # a resumed run that had already finished: nothing to train or save
        if ck is not None:
            ck.close()
        print("training already complete; nothing to do", flush=True)
        return None, {"params": params, "opt": opt}

    steps = max(1, n // args.batch_size)
    tot = 0.0
    for epoch in range(start_epoch, args.num_epoch):
        # per-epoch seed: a resumed run sees the permutations an
        # uninterrupted run would
        order = np.random.RandomState(epoch).permutation(n)
        tot = tot_mlm = tot_nsp = 0.0
        t0 = time.time()
        for s in range(steps):
            idx = torch.from_numpy(
                order[s * args.batch_size:(s + 1) * args.batch_size]
            ).to(device)
            batch = {k: v[idx] for k, v in full.items()}
            loss, (mlm, nsp), params, opt = step_fn(params, opt, batch)
            loss, mlm, nsp = float(loss), float(mlm), float(nsp)
            if on_step is not None:
                on_step(epoch, s, loss, mlm, nsp)
            tot += loss
            tot_mlm += mlm
            tot_nsp += nsp
        print(f"epoch {epoch}: loss {tot/steps:.4f} "
              f"(mlm {tot_mlm/steps:.4f} nsp {tot_nsp/steps:.4f}) "
              f"{time.time()-t0:.2f}s", flush=True)
        if ck is not None and args.ckpt_every and \
                (epoch + 1) % args.ckpt_every == 0:
            ck.save_step(epoch, {"params": params, "opt": opt})
    if ck is not None:
        if ck.latest_step() != args.num_epoch - 1:
            ck.save_step(args.num_epoch - 1, {"params": params, "opt": opt})
        ck.close()
    return tot / steps, {"params": params, "opt": opt}


def main(argv=None):
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
