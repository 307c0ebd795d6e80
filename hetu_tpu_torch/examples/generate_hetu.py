"""Inference demo for the port's LM (a copy of
``examples/nlp/generate_hetu.py`` over ``hetu_tpu_torch``): train briefly
on a tiny synthetic corpus with ``transformer.make_train_step``, then
decode with every strategy of ``models/generate.py``: greedy, temperature
/ top-k sampling, beam search, EOS-aware early exit, and a ragged batch
(per-row prompt lengths in one call). Runs on ``cuda:0``, or on the CPU
under ``--cpu``.

    python -m hetu_tpu_torch.examples.generate_hetu [--steps 200]
        [--beam 4] [--max-len 16] [--cpu]
"""
import argparse
import time

import numpy as np
import torch

from hetu_tpu_torch.models import generate as gen
from hetu_tpu_torch.models import transformer as tfm


def make_corpus(vocab, n=4096, seed=0):
    """Synthetic 'language': arithmetic-progression sequences with a step
    drawn per sequence, enough structure for greedy decode to visibly
    learn the pattern."""
    rng = np.random.RandomState(seed)
    start = rng.randint(1, vocab - 64, n)
    step = rng.randint(1, 5, n)
    T = 16
    seqs = (start[:, None] + step[:, None] * np.arange(T)) % (vocab - 1) + 1
    return seqs.astype(np.int32)


def config():
    """The demo's LM: f32, sequences of 16 (the corpus's) in a 32-position
    table, an untied (D, V) head."""
    return tfm.TransformerConfig(vocab_size=256, d_model=128, n_heads=4,
                                 n_layers=2, d_ff=256, max_seq_len=32,
                                 dtype=torch.float32, remat=False)


def batch(data, i):
    """Step ``i``'s 64 sequences and their next tokens (wrapping)."""
    tok = data[(i * 64) % len(data):(i * 64) % len(data) + 64]
    return tok, torch.roll(tok, -1, dims=1)


def main(argv=None):
    ap = argparse.ArgumentParser()

    def positive_int(v):
        v = int(v)
        if v < 1:
            raise argparse.ArgumentTypeError("--steps must be >= 1")
        return v

    ap.add_argument("--steps", type=positive_int, default=200)
    ap.add_argument("--beam", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else torch.device("cuda", 0)

    cfg = config()
    params = tfm.init_params(0, cfg, device)
    opt = tfm.init_opt_state(params)
    step_fn = tfm.make_train_step(cfg, lr=3e-3)

    data = torch.from_numpy(make_corpus(cfg.vocab_size)).to(device)
    t0 = time.time()
    loss = None
    for i in range(args.steps):
        loss, params, opt = step_fn(params, opt, *batch(data, i))
    print(f"trained {args.steps} steps, final loss "
          f"{float(loss):.3f} ({time.time() - t0:.1f}s)")

    prompt = data[:4, :6]
    M = args.max_len

    greedy = gen.make_generate_fn(cfg, max_len=M)
    toks, _ = greedy(params, prompt, 1)
    toks = toks.cpu().numpy()
    print("greedy:      ", toks[0])

    sampler = gen.make_generate_fn(cfg, max_len=M, sample=True, top_k=8)
    stoks, _ = sampler(params, prompt, 2, temperature=0.8)
    print("top-k sample:", stoks.cpu().numpy()[0])

    beam = gen.make_beam_search_fn(cfg, max_len=M, beam_size=args.beam)
    btoks, scores = beam(params, prompt)
    print(f"beam (K={args.beam}):", btoks.cpu().numpy()[0, 0],
          f"score {float(scores[0, 0]):.2f}")

    # a mid-rollout token as eos, single row: the loop exits as soon as
    # every row has finished, so this visibly stops early
    eos = int(toks[0, M // 2])
    eosfn = gen.make_eos_generate_fn(cfg, max_len=M, eos_id=eos)
    _, nstep = eosfn(params, prompt[:1], 3)
    print(f"eos-aware:    exited after {nstep}/{M - 1} steps "
          f"(eos_id {eos})")

    lens = [2, 4, 6, 3]
    rt, _ = greedy(params, prompt, 4, prompt_lens=lens)
    rt = rt.cpu().numpy()
    print("ragged batch: per-row prompt lens", lens)
    for b in (1, 3):
        ln = lens[b]
        print(f"  row {b}: prompt {rt[b, :ln]} -> generated {rt[b, ln:]}")
    return float(loss)


if __name__ == "__main__":
    main()
