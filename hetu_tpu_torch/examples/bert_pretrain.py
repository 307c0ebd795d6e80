"""BERT pretraining on the port: ``make_pretrain_step`` (MLM + NSP, AdamW)
for ``--steps`` steps on a synthetic phase-1 batch, at BERT-base width
(``models.bert.BERT_BASE``: 12 layers, d 768, 12 heads, FF 3072, vocab
30522, bf16 compute over f32 params, remat on) with random weights from a
seed.

    python -m hetu_tpu_torch.examples.bert_pretrain [--steps 20] [--batch 32]
        [--seq 128] [--pred 20] [--lr 1e-4] [--profile DIR] [--gpu 0 | -1]

``--seq 512 --pred 76`` is the phase-2 shape ``bench.py``'s BERT section
trains. Prints one JSON line per step (losses, kernel launches), then one
summary line: the mean step time over the steps after 3 warm-up steps
(host clock around each step, which ends in ``torch.cuda.synchronize()``),
sequences and tokens per second (tokens: batch × seq, padding included;
``real_tokens`` counts the mask), and the launches per step.
``--profile DIR`` adds the device time of one step summed over kernels
from ``torch.profiler`` (kernel events only), the device's busy share, and
that time by kernel group (``bert_forward.kernel_group``); the full table
goes to ``DIR/profile_bert_pretrain.txt``. ``--gpu -1`` runs on the CPU
(plain kernel versions; times are the CPU's).
"""
import argparse
import json
import os
import time

import torch

from hetu_tpu_torch.examples import bert_forward
from hetu_tpu_torch.models import bert

WARMUP = 3


def run(device, steps=20, batch_size=32, seq_len=128, n_pred=20, lr=1e-4,
        profile_dir=None, profile_iters=5, seed=0, cfg=bert.BERT_BASE):
    """Yields one dict per step, then the summary dict."""
    params = bert.init_params(seed, cfg, device)
    opt = bert.init_opt_state(params)
    batch = bert_forward.phase1_batch(cfg, batch_size, seq_len, n_pred,
                                      seed=seed, device=device)
    step = bert.make_pretrain_step(cfg, lr=lr)
    state = {"params": params, "opt": opt}

    def one_step():
        loss, parts, state["params"], state["opt"] = step(
            state["params"], state["opt"], batch)
        return loss, parts

    times, per_step = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        (loss, (mlm, nsp)), launches = bert_forward.counted(one_step)
        times.append(time.perf_counter() - t0)
        per_step.append(launches)
        yield {"step": i, "loss": float(loss), "mlm": float(mlm),
               "nsp": float(nsp), "ms": times[-1] * 1e3,
               "launches": launches}
    timed = times[WARMUP:] or times
    ms = sum(timed) / len(timed) * 1e3
    tokens = batch_size * seq_len
    res = {"summary": "bert_pretrain", "steps": steps, "batch": batch_size,
           "seq_len": seq_len, "mlm_slots": n_pred, "lr": lr,
           "real_tokens": int(batch["input_mask"].sum()),
           "real_mlm_slots": int(batch["mlm_weights"].sum()),
           "step_ms": ms, "sequences_per_s": batch_size / ms * 1e3,
           "tokens_per_s": tokens / ms * 1e3,
           "launches_per_step": per_step[-1],
           "launches_same_every_step": all(c == per_step[-1]
                                           for c in per_step)}
    if profile_dir is not None:
        os.makedirs(profile_dir, exist_ok=True)
        res["profile"] = bert_forward.profile(
            one_step, ms, profile_iters,
            os.path.join(profile_dir, "profile_bert_pretrain.txt"))
    yield res


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--pred", type=int, default=20)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--profile", default=None, metavar="DIR")
    parser.add_argument("--gpu", type=int, default=0)
    args = parser.parse_args(argv)
    device = "cpu" if args.gpu < 0 else torch.device("cuda", args.gpu)
    if args.profile and args.gpu < 0:
        raise SystemExit("--profile measures the card; it needs --gpu >= 0")
    if args.gpu >= 0:
        print(torch.cuda.get_device_name(args.gpu), flush=True)
    for res in run(device, args.steps, args.batch, args.seq, args.pred,
                   args.lr, args.profile):
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
