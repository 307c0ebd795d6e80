"""Fine-tune a HuggingFace BERT checkpoint through the port (a copy of
``examples/nlp/finetune_hf_bert.py`` over ``hetu_tpu_torch``).

Take a ``transformers`` BERT (a locally instantiated one by default, or
``--from-pretrained`` a local directory), import it weight for weight
(``models/hf_bert.py``), graft a fresh classification head, and fine-tune
with ``bert.make_finetune_step`` (AdamW; flash attention and the embedding
gradient's kernel on the card). Runs on ``cuda:0``; a caller picks the CPU
by ``main(argv, device="cpu")``, as the tests do.

Synthetic task: the label is whether low-id tokens outnumber high-id
tokens in the sequence, separable from mean-pooled embeddings, so
fine-tuning must push accuracy well above chance within ~100 steps.

``main`` runs the legs below in order: ``demo_model`` (the only one that
needs ``transformers``), ``import_model``, ``batches`` and ``tune`` (over
``tuning``, one step a ``next``), then
``heldout_accuracy``; a caller holding a stand-in checkpoint (a ``config``
and a ``state_dict()``) runs the same legs without the package.

    python -m hetu_tpu_torch.examples.finetune_hf_bert [--steps 100]
"""
import argparse
import dataclasses
import sys

import numpy as np
import torch

from hetu_tpu_torch.models import bert
from hetu_tpu_torch.models.hf_bert import params_from_hf


def make_task(rng, n, seq_len, vocab_size):
    ids = rng.integers(4, vocab_size, size=(n, seq_len))
    labels = (ids < vocab_size // 2).sum(1) > (seq_len // 2)
    return ids.astype(np.int32), labels.astype(np.int32)


def demo_model(from_pretrained=None):
    """The ``transformers`` BertModel the reference starts from: a local
    directory's, or a small random one drawn after ``torch.manual_seed(0)``."""
    import transformers
    torch.manual_seed(0)   # deterministic random init for the demo path
    if from_pretrained:
        model = transformers.BertModel.from_pretrained(from_pretrained)
    else:
        model = transformers.BertModel(transformers.BertConfig(
            vocab_size=500, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64))
    return model.eval()


def import_model(model, n_classes, device=None, seed=0):
    """Import the checkpoint (remat off) and graft a fresh classification
    head drawn from ``seed`` on the imported trunk and pooler."""
    params, cfg = params_from_hf(model, device=device)
    cfg = dataclasses.replace(cfg, remat=False)
    print(f"imported BERT: L={cfg.n_layers} D={cfg.d_model} "
          f"V={cfg.vocab_size} ({bert.count_params(params):,} params)")
    return bert.init_classifier_params(seed, cfg, n_classes,
                                       pretrained=params), cfg


def batches(rng, ids, labels, batch_size, device=None):
    """Each step's batch: ``batch_size`` rows drawn from ``rng``, as the
    reference draws them, with zero segment ids."""
    while True:
        sel = rng.integers(0, len(ids), size=batch_size)
        yield {k: torch.from_numpy(v[sel]).to(device) for k, v in (
            ("input_ids", ids), ("segment_ids", np.zeros_like(ids)),
            ("label", labels))}


def tuning(params, cfg, data, lr):
    """Fine-tuning steps on ``data``'s batches, one a ``next``: yields each
    step's loss and batch accuracy (tensors) and the params after it."""
    step = bert.make_finetune_step(cfg, lr=lr)
    opt = bert.init_opt_state(params)
    for batch in data:
        loss, acc, params, opt = step(params, opt, batch)
        yield loss, acc, params


def tune(params, cfg, data, steps, lr, log=print):
    """``steps`` fine-tuning steps on ``data``'s batches; returns the
    params and the losses."""
    losses = []
    for it, (loss, acc, params) in zip(range(steps),
                                       tuning(params, cfg, data, lr)):
        losses.append(float(loss))
        if it % 20 == 0 or it == steps - 1:
            log(f"step {it:4d}  loss {losses[-1]:.4f}  "
                f"batch acc {float(acc):.3f}")
    return params, losses


def heldout_accuracy(params, cfg, rng, seq_len, device=None, n=1024):
    """Accuracy over ``n`` fresh rows (a batch's accuracy is a 32-sample
    estimate)."""
    hids, hlabels = make_task(rng, n, seq_len, cfg.vocab_size)
    ids = torch.from_numpy(hids).to(device)
    with torch.no_grad():
        logits = bert.classify_logits(params, ids, torch.zeros_like(ids), cfg)
    return float(np.mean(np.argmax(logits.cpu().numpy(), -1) == hlabels))


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--from-pretrained", default=None,
                    help="local directory with a saved HF BERT; default: "
                         "a small randomly initialized BertModel")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-classes", type=int, default=2)
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0) if device is None else device

    params, cfg = import_model(demo_model(args.from_pretrained),
                               args.n_classes, device)
    rng = np.random.default_rng(0)
    ids, labels = make_task(rng, 4096, args.seq_len, cfg.vocab_size)
    params, _ = tune(params, cfg, batches(rng, ids, labels, args.batch_size,
                                          device), args.steps, args.lr)
    heldout = heldout_accuracy(params, cfg, rng, args.seq_len, device)
    print(f"held-out acc over 1024: {heldout:.3f}")
    return heldout


if __name__ == "__main__":
    sys.exit(0 if main() > 0.8 else 1)
