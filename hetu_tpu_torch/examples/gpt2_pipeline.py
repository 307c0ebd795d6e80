"""The offline GPT-2 pipeline in one script, tokenizer to deploy (a copy of
``examples/nlp/gpt2_pipeline.py`` over ``hetu_tpu_torch``):

1. build a byte-level BPE tokenizer from local vocab/merges files (or a
   tiny demo vocabulary when none are given; there is no network),
2. load a ``transformers`` GPT-2 checkpoint (a local directory by
   ``--from-pretrained``, or a small random one) weight for weight into
   the trunk (``models/hf_gpt2``), the LM head tied to the embedding,
3. fine-tune a few steps on synthetic token streams
   (``transformer.make_train_step``),
4. decode with the KV cache (greedy, top-k sampling, and speculative
   decoding against a self-draft),
5. export the trained weights back into a live ``transformers`` model and
   check that HF's greedy generation matches the port's token for token.

Runs on ``cuda:0``; a caller picks the CPU by ``main(argv,
device="cpu")``, as the tests do. ``main`` runs the legs below in order:
``demo_tokenizer``, ``load`` (needs ``transformers``), ``import_model``,
``tune`` (over ``tuning``, one step a ``next``), ``decode`` and ``deploy``
(needs ``transformers``); a caller
holding a stand-in checkpoint runs the middle legs without the package.

    python -m hetu_tpu_torch.examples.gpt2_pipeline [--steps 30]
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

from hetu_tpu_torch.models import generate as gen
from hetu_tpu_torch.models import transformer as tfm
from hetu_tpu_torch.models.hf_gpt2 import export_to_hf, params_from_hf
from hetu_tpu_torch.tokenizers import GPT2Tokenizer, bytes_to_unicode

PROMPT = "the thin"


def demo_tokenizer():
    """A tiny byte-level BPE over files in a temporary directory."""
    b2u = bytes_to_unicode()
    vocab = {c: i for i, c in enumerate(sorted(b2u.values()))}
    merges = ["t h", "th e", "i n", "a n", "Ġ t", "Ġt h", "Ġth e"]
    for m in merges:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "vocab.json"), "w") as f:
            json.dump(vocab, f)
        with open(os.path.join(d, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
        return GPT2Tokenizer(os.path.join(d, "vocab.json"),
                             os.path.join(d, "merges.txt"))


def load(from_pretrained=None):
    """(tokenizer, transformers GPT2LMHeadModel): a local directory's, or
    the demo tokenizer and a small random model drawn after
    ``torch.manual_seed(0)``."""
    import transformers
    torch.manual_seed(0)
    if from_pretrained:
        model = transformers.GPT2LMHeadModel.from_pretrained(from_pretrained)
        tok = GPT2Tokenizer(os.path.join(from_pretrained, "vocab.json"),
                            os.path.join(from_pretrained, "merges.txt"))
    else:
        tok = demo_tokenizer()
        model = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=tok.vocab_size, n_positions=64, n_embd=64,
            n_layer=2, n_head=4))
    return tok, model.eval()


def import_model(model, device=None):
    """Import the checkpoint (the head tied to the embedding; remat off)."""
    params, cfg = params_from_hf(model, device=device)
    cfg = dataclasses.replace(cfg, remat=False)
    print(f"imported GPT-2: L={cfg.n_layers} D={cfg.d_model} "
          f"V={cfg.vocab_size} ({tfm.count_params(params):,} params, "
          "tied head)")
    return params, cfg


def batches(cfg, device=None):
    """Each tuning step's (inputs, targets): synthetic streams of 8 x
    min(33, max positions) tokens from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    T = min(33, cfg.max_seq_len)
    while True:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, T))).to(
            device)
        yield toks[:, :-1], toks[:, 1:]


def tuning(params, cfg):
    """AdamW steps on ``batches``, one a ``next``: yields each step's loss
    (a tensor) and the params after it."""
    step = tfm.make_train_step(cfg, lr=3e-4)
    opt = tfm.init_opt_state(params)
    for x, y in batches(cfg, params["embed"].device):
        loss, params, opt = step(params, opt, x, y)
        yield loss, params


def tune(params, cfg, steps, log=print):
    """``steps`` steps of ``tuning``; returns the params and the
    losses."""
    losses = []
    for it, (loss, params) in zip(range(steps), tuning(params, cfg)):
        losses.append(float(loss))
        if it % 10 == 0 or it == steps - 1:
            log(f"step {it:3d}  loss {losses[-1]:.4f}")
    return params, losses


def decode(params, cfg, tok, max_len, spec_k, log=print):
    """Tokenize PROMPT and decode it greedily, by top-k sampling and by
    speculative decoding against a self-draft; returns the prompt's ids,
    the greedy and speculative tokens (numpy) and the verify rounds."""
    ids = np.asarray([tok.encode(PROMPT)], np.int64)
    greedy = gen.generate(params, cfg, ids, max_len=max_len)
    log("greedy   : " + repr(tok.decode(greedy[0])))
    sampled = gen.generate(params, cfg, ids, max_len=max_len,
                           temperature=0.9, rng=7)
    log("sampled  : " + repr(tok.decode(sampled[0])))
    spec_fn = gen.make_speculative_generate_fn(cfg, cfg, max_len, k=spec_k)
    spec, rounds = spec_fn(params, params, ids)
    spec = spec.cpu().numpy()
    log(f"speculative (self-draft k={spec_k}): "
        f"{'identical' if np.array_equal(spec, greedy) else 'different'} "
        f"tokens in {int(rounds)} verify rounds")
    return ids, greedy, spec, rounds


def deploy(params, cfg, model, ids, greedy, max_len):
    """Export into a fresh transformers model of ``model``'s config; True
    when HF's greedy generation equals ``greedy``."""
    fresh = type(model)(model.config).eval()
    export_to_hf(params, cfg, fresh)
    with torch.no_grad():
        # eos_token_id=None: real GPT-2 checkpoints define eos=50256 and HF
        # would stop early on it, while this greedy decode is fixed-length
        ref = fresh.generate(
            torch.tensor(ids, dtype=torch.long),
            attention_mask=torch.ones(ids.shape, dtype=torch.long),
            max_new_tokens=max_len - ids.shape[1],
            do_sample=False, pad_token_id=0, eos_token_id=None)
    return np.array_equal(greedy, ref.numpy())


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--from-pretrained", default=None,
                    help="local HF GPT-2 directory (weights + tokenizer); "
                         "default: small random model + demo tokenizer")
    ap.add_argument("--steps", type=int, default=30,
                    help="fine-tune steps (min 1)")
    ap.add_argument("--max-len", type=int, default=32)
    ap.add_argument("--spec-k", type=int, default=3)
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    device = torch.device("cuda", 0) if device is None else device

    tok, model = load(args.from_pretrained)
    params, cfg = import_model(model, device)
    params, losses = tune(params, cfg, args.steps)
    ids, greedy, spec, _ = decode(params, cfg, tok, args.max_len,
                                  args.spec_k)
    hf_match = deploy(params, cfg, model, ids, greedy, args.max_len)
    # pinned on the CPU, as the reference pins them off the TPU: on the
    # card the chunked verify and cuBLAS may break an exact logit tie
    # otherwise than a one-token step or torch's CPU forward
    if torch.device(device).type == "cpu":
        assert np.array_equal(spec, greedy), "spec != greedy"
        assert hf_match, "HF deploy mismatch"
    print("exported to transformers: HF greedy generation "
          + ("identical" if hf_match else "near-identical"))
    return losses[-1]


if __name__ == "__main__":
    main()
    sys.exit(0)
