"""BERT forward on the port: the pretraining loss evaluated without
gradient on a synthetic phase-1 batch, and the classifier answering a
batch of requests, at BERT-base width (``models.bert.BERT_BASE``: 12
layers, d 768, 12 heads, FF 3072, vocab 30522, bf16) with random weights
from a seed.

    python -m hetu_tpu_torch.examples.bert_forward [--batch 32] [--seq 128]
        [--requests 8] [--iters 20] [--profile DIR] [--gpu 0 | -1]

Prints one JSON line per entry point: the losses or logits, the mean
forward time over ``--iters`` calls after warm-up (host clock around calls
that end in ``torch.cuda.synchronize()``), sequences per second and the
kernel launches of one call. ``--profile DIR`` adds, per entry point, the
device time of one call summed over kernels from ``torch.profiler``
(kernel events only), the device's busy share, and that time by group
(``kernel_group``): flash attention, the fused linear+CE, the dense
products (cuBLAS GEMMs) and the rest; the full tables go to
``DIR/profile_bert_<entry>.txt``.
``--gpu -1`` runs on the CPU (plain kernel versions; times are the CPU's).
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from hetu_tpu_torch.kernels import registry
from hetu_tpu_torch.models import bert

CLS, SEP, MASK = 101, 102, 103   # the BERT uncased vocabulary's ids
FIRST_WORD = 1000                # ids below are special or unused


def _segments(rng, n, seq_len, vocab):
    """One packed row: [CLS] A [SEP] B [SEP] over ``n`` real tokens, then
    padding. Returns (ids, mask, segment ids, real positions to mask)."""
    ids = np.zeros(seq_len, np.int32)
    ids[:n] = rng.randint(FIRST_WORD, vocab, n)
    sep = rng.randint(n // 4, 3 * n // 4)
    ids[0], ids[sep], ids[n - 1] = CLS, SEP, SEP
    pos = np.arange(seq_len)
    mask = (pos < n).astype(np.int32)
    seg = ((pos > sep) & (pos < n)).astype(np.int32)
    words = np.setdiff1d(np.arange(1, n - 1), [sep])
    return ids, mask, seg, words


def phase1_batch(cfg, batch_size=32, seq_len=128, n_pred=20, seed=0,
                 device=None):
    """A synthetic phase-1 pretraining batch in the data pipeline's row
    format (``batch_from_instances``): lengths drawn in [seq_len/2,
    seq_len], 15 % of the words masked (at most ``n_pred`` slots a row; the
    rest are padded slots of weight 0), a random NSP label."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(batch_size):
        n = rng.randint(seq_len // 2, seq_len + 1)
        ids, mask, seg, words = _segments(rng, n, seq_len, cfg.vocab_size)
        k = min(n_pred, max(1, int(round(0.15 * n))))
        pos = np.zeros(n_pred, np.int32)
        pos[:k] = np.sort(rng.choice(words, k, replace=False))
        mids = np.zeros(n_pred, np.int32)
        mids[:k] = ids[pos[:k]]
        ids[pos[:k]] = MASK
        rows.append((ids, mask, seg, pos, mids, rng.randint(0, 2)))
    return bert.batch_from_instances(rows, device)


def requests(cfg, n=8, seq_len=128, seed=1, device=None):
    """``n`` classification requests padded to ``seq_len``: lengths drawn
    in [seq_len/2, seq_len]. Returns (input_ids, segment_ids, input_mask)."""
    rng = np.random.RandomState(seed)
    rows = [_segments(rng, rng.randint(seq_len // 2, seq_len + 1), seq_len,
                      cfg.vocab_size)[:3] for _ in range(n)]
    ids, mask, seg = (torch.from_numpy(np.stack(c)).to(device)
                      for c in zip(*rows))
    return ids, seg, mask


def forward_ms(fn, iters=20, warmup=3):
    """Mean host-clock ms of ``fn`` over ``iters`` calls after ``warmup``,
    each timed window ending in a device synchronise."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def counted(fn):
    """(``fn()``, the kernel launches it made): the counts are zeroed just
    before the call and read just after it."""
    registry.reset_launch_counts()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {k: v for k, v in registry.launch_counts().items() if v}


def kernel_group(name):
    """The group of a device kernel's name: each ported kernel of
    ``csrc/``, the dense products (cuBLAS), the optimizer's foreach
    kernels, and the rest."""
    if "flash_fwd_kernel" in name:
        return "flash_attention_fwd"
    if "flash_bwd_" in name:
        return "flash_attention_bwd"
    if "linear_nll_bwd" in name:
        return "fused_linear_nll_bwd"
    if "linear_nll" in name:
        return "fused_linear_nll_fwd"
    if "spmm_kernel" in name:
        return "csr_spmm"
    if "spmv_kernel" in name:
        return "csr_spmv"
    if "segsum_kernel" in name:
        return "fused_embed_grad"
    if "sgd_kernel" in name:
        return "fused_sgd"
    if "adam_kernel" in name:
        return "fused_adam"
    if any(s in name for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "dense_matmul"
    if "multi_tensor_apply" in name or "foreach" in name:
        return "optimizer_foreach"
    return "other"


def profile(fn, ms, iters, path):
    """Device time of one call of ``fn`` by kernel group (kernel events
    only), over ``iters`` profiled calls; the tables go to ``path``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    table = prof.key_averages()
    groups, kernels = {}, []
    for e in table:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.self_device_time_total <= 0):
            continue
        us = e.self_device_time_total / iters
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us
        kernels.append({"name": e.key[:90], "group": g, "us": us,
                        "calls": e.count / iters})
    kernels.sort(key=lambda r: -r["us"])
    with open(path, "w") as f:
        f.write(table.table(sort_by="self_device_time_total", row_limit=40))
    device_ms = sum(groups.values()) / 1e3
    return {"device_ms": device_ms, "device_busy_share": device_ms / ms,
            "groups_us": groups, "top_kernels": kernels[:10]}


def run(device, batch_size=32, seq_len=128, n_requests=8, iters=20,
        profile_dir=None, seed=0, cfg=bert.BERT_BASE):
    """Both entry points once with counted launches, then timed; yields one
    result dict per entry point."""
    params = bert.init_params(seed, cfg, device)
    batch = phase1_batch(cfg, batch_size, seq_len, seed=seed, device=device)
    cls_params = bert.init_classifier_params(seed + 1, cfg, 2,
                                             pretrained=params)
    ids, seg, mask = requests(cfg, n_requests, seq_len, seed + 1, device)
    entries = [
        ("pretrain_loss", batch_size,
         lambda: bert.pretrain_loss(params, batch, cfg)),
        ("classify_logits", n_requests,
         lambda: bert.classify_logits(cls_params, ids, seg, cfg,
                                      input_mask=mask)),
    ]
    with torch.inference_mode():
        for name, n_seq, fn in entries:
            out, launches = counted(fn)
            ms = forward_ms(fn, iters)
            res = {"entry": name, "batch": n_seq, "seq_len": seq_len,
                   "ms": ms, "sequences_per_s": n_seq / ms * 1e3,
                   "launches": launches}
            if name == "pretrain_loss":
                res.update(loss=float(out[0]), mlm=float(out[1][0]),
                           nsp=float(out[1][1]))
            else:
                res.update(logits_shape=list(out.shape),
                           logits_absmax=float(out.abs().max()))
            if profile_dir is not None:
                os.makedirs(profile_dir, exist_ok=True)
                res["profile"] = profile(fn, ms, iters, os.path.join(
                    profile_dir, f"profile_bert_{name}.txt"))
            yield res


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--profile", default=None, metavar="DIR")
    parser.add_argument("--gpu", type=int, default=0)
    args = parser.parse_args(argv)
    device = "cpu" if args.gpu < 0 else torch.device("cuda", args.gpu)
    if args.profile and args.gpu < 0:
        raise SystemExit("--profile measures the card; it needs --gpu >= 0")
    if args.gpu >= 0:
        print(torch.cuda.get_device_name(args.gpu), flush=True)
    for res in run(device, args.batch, args.seq, args.requests, args.iters,
                   args.profile):
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
