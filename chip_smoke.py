#!/usr/bin/env python3
"""On-card smoke test of hetu_tpu_torch, the PyTorch/CUDA port: builds the
CUDA kernels from this checkout and holds each against its plain PyTorch
version on the card; trains the full-width MLP of
``examples/cnn/models/MLP.py`` (3072-256-256-10, synthetic CIFAR10, batch
128) through ``hetu_tpu_torch.Executor``; runs the BERT-base forward
(``hetu_tpu_torch.models.bert``, random weights from a seed): the
pretraining loss without gradient on a synthetic phase-1 batch (32 x 128)
and the classifier on 8 requests; then trains BERT-base with
``make_pretrain_step`` for 20 steps on that batch, checks its first step's
gradients against ``kernels="off"``, and fine-tunes the classifier for 5
steps with ``make_finetune_step``; then trains the full-width GCN of
``examples/gnn`` (``dense_model``, 128 -> 256 -> 40) for 30 epochs on a
synthetic graph at ogbn-arxiv's size through ``Executor.run``, checks its
first epoch's loss and gradients against ``kernels="off"``, and runs one
``csrmv_op`` program; then trains WDL-Criteo (``examples/ctr``) at its
published widths and the full Criteo-Kaggle vocabulary (33,762,577 rows)
for 30 steps through ``Executor.run``, checks its first step's loss and
gradients against ``kernels="off"`` and that the rows no step looked up
kept their bits, and runs one ``embedding_lookup_gradient_op`` program in
dense and in rows mode. Each path is checked to have gone through its
kernels.

    python3 chip_smoke.py

Needs one CUDA card (``cuda:0``) and ``nvcc``; exits non-zero, printing no
result, when either is missing or any phase fails. Prints one JSON line per
phase, then the ``kernels`` JSON line, the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH = 128
SGD_STEPS, SGD_LR = 200, 0.1
ADAM_STEPS, ADAM_LR = 50, 1e-3
# The full-width MLP's parameters, in the executor's order (fc1..fc3).
MLP_SHAPES = [(3072, 256), (256,), (256, 256), (256,), (256, 10), (10,)]
ODD_SHAPE = (2**24 + 3,)
# Kernel vs plain version on the card. SGD: each product rounds where the
# plain version rounds it (-fmad=false), so they agree to f32 rounding.
# Adam: powf in the kernel and torch.pow may differ by an ulp in beta**t.
TOL = {"fused_sgd": dict(rtol=1e-6, atol=1e-7),
       "fused_adam": dict(rtol=1e-5, atol=1e-6)}
# The mean loss of the last 10 steps must fall below these. The JAX
# package's own CPU run of this configuration (hetu_tpu.Executor, seed 0,
# the same synthetic CIFAR10, batch 128; `python tools/port_reference.py
# smoke-config` with JAX_PLATFORMS=cpu) went from 2.85 (SGD) and 1.12
# (Adam) over the first 10 steps to 2.1e-6 after 200 SGD steps at lr 0.1
# and 4.1e-7 after 50 Adam steps at lr 1e-3; the thresholds leave room for
# the port's different initial weights.
SGD_LOSS_MAX, ADAM_LOSS_MAX = 1e-2, 1e-2

# Attention checks (B, H, S, D, dtype, causal, key padding): the BERT-base
# layer (the main path's shape; its times go into the kernels line), a long
# causal sequence, and a small f32 case also held against the unfused
# softmax(q k^T) v in f32.
ATTN_CASES = [(32, 12, 128, 64, torch.bfloat16, False, True),
              (8, 12, 512, 64, torch.bfloat16, True, False),
              (2, 4, 256, 128, torch.float32, True, True)]
# Fused linear+CE checks (N, V, D, layout), bf16: BERT-base's MLM loss (32
# rows x 20 slots against the tied (V, D) embedding, with the MLM bias; the
# main path's shape) and a GPT-2 LM head ((D, V), N ragged against 64).
CE_CASES = [(640, 30522, 768, "vd"), (1000, 50257, 768, "dv")]
# The backward also at the MLM shape in f32, where no output rounding hides
# dh's softmax term (~1e-4 of its onehot term, below a bf16 rounding).
CE_BWD_CASES = ([c + (torch.bfloat16,) for c in CE_CASES]
                + [(640, 30522, 768, "vd", torch.float32)])
# Kernel vs plain version: o in bf16 may differ by one bf16 rounding (the
# same f32 sums in another order); f32 by summation order alone; lse, the
# target logit and the NLL are f32 sums over 128 keys or 30k-50k logits.
TOL.update({
    "flash_attention_fwd": {"o_bf16": dict(rtol=2e-2, atol=2e-2),
                            "o_f32": dict(rtol=2e-5, atol=2e-5),
                            "lse": dict(rtol=0, atol=1e-3)},
    "fused_linear_nll_fwd": {"lse_tl_nll": dict(rtol=0, atol=1e-3)},
    # the backward kernels against their plain versions: each gradient is
    # an f32 sum rounded once to the output dtype on both sides, so bf16
    # outputs may differ by a bf16 rounding and f32 ones by summation
    # order; db is an f32 sum over the rows. The f32 attention case is
    # also held against autograd of the unfused f32 softmax(q k^T) v.
    # Gradients can be far smaller than an absolute tolerance (at the MLM
    # shape dh is ~3e-5 and dW ~1e-6 off the target rows), so each output
    # is also held by its relative L2 error, ||got - want|| / ||want||:
    # one bf16 rounding of every element is at most 2^-9 ~ 2e-3. For the
    # fused CE the onehot term dominates dW and db; their entries of the
    # vocabulary ids no row targets hold the softmax term alone and are
    # held by the same relative error ("untargeted").
    "flash_attention_bwd": {"bf16": dict(rtol=2e-2, atol=2e-2),
                            "f32": dict(rtol=2e-5, atol=2e-5),
                            "f32_vs_autograd": dict(rtol=0, atol=2e-5),
                            "rel_l2_bf16": 1e-2, "rel_l2_f32": 2e-5},
    "fused_linear_nll_bwd": {"dh_dw_bf16": dict(rtol=2e-2, atol=2e-2),
                             "dh_dw_f32": dict(rtol=2e-5, atol=2e-5),
                             "db": dict(rtol=0, atol=1e-3),
                             "rel_l2_bf16": 1e-2, "rel_l2_f32": 2e-5}})
# The BERT-base forward with the kernels against kernels="off" (the plain
# versions on the card): losses rel 5e-3; classifier logits (|x| < ~1)
# atol 2e-2, for bf16 activations rounded at other places over 12 layers.
BERT_REL, LOGITS_ATOL = 5e-3, 2e-2
BERT_BATCH, BERT_SEQ, BERT_PRED, BERT_REQUESTS, BERT_ITERS = 32, 128, 20, 8, 20
# BERT-base pretraining: 20 AdamW steps at lr 1e-4 on the phase-1 batch,
# 3 of them warm-up for the step time; the first loss within
# FIRST_LOSS_TOL of ln V + ln 2, the loss at random init. The first step's
# gradients with the kernels against kernels="off" (plain versions on the
# card), at full width twice: in f32, every parameter's gradient within a
# relative L2 error of GRAD_REL (the two sides differ by summation order
# only); in bf16, the main path's dtype, all gradients together within
# GRAD_REL, and by what bf16 rounding itself costs, measured from the f32
# gradient: the kernels' bf16 gradients, all together, at most
# BF16_EXCESS times as far (rel L2) from it as the plain versions' bf16
# gradients are; each tensor's at most BF16_EXCESS times the larger of
# the plain versions' distance for that tensor and for all together (a
# tensor of few elements, such as nsp_b's 2, can sit below the model's
# bf16 noise by chance). Both bf16 sides round at the same places and the
# kernels match their plain versions to about a bf16 rounding, so the
# distances should be alike; a kernel fault that only bf16 shows makes
# the kernels' grow.
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR, GRAD_REL, FIRST_LOSS_TOL = (
    20, 3, 1e-4, 2e-2, 0.5)
BF16_EXCESS = 2.0
FINETUNE_STEPS, FINETUNE_LR = 5, 2e-5
# CSR products on the GCN's adjacency (the arxiv-sized graph), at the main
# path's shapes: A·X at F = 128 (layer 1), A·H at F = 256 (layer 2), Aᵀ·dZ
# at F = 256 (layer 2's backward), and the vector product on A. Kernel and
# plain version sum each row in CSR order with one f32 accumulator, each
# product rounded before the add (-fmad=false): bit-equal expected, each
# output held by its relative L2 error.
CSR_CASES = [("A", 128), ("A", 256), ("A^T", 256)]
TOL.update({"csr_spmm": {"rel_l2": 1e-6}, "csr_spmv": {"rel_l2": 1e-6}})
# The GCN (run_single's dense_model at ogbn-arxiv's widths, hidden 256,
# SGD lr 0.5): per epoch 3 csr_spmm (2 forward, 1 backward) and 4
# fused_sgd launches. The first epoch's loss and gradients with the
# kernels against kernels="off", in f32: the sparse products are bit-equal
# and the dense ones are cuBLAS's on both sides, so rel L2 <= GCN_REL.
GCN_EPOCHS, GCN_LR, GCN_REL = 30, 0.5, 1e-5
GCN_LAUNCHES = {"csr_spmm": 3, "fused_sgd": 4}
# The embedding gradient's segment sum (fused_embed_grad): at the main
# path's shape, WDL-Criteo's step (the first batch's 128 x 26 ids over the
# full vocabulary, d = 128), and at the other shapes the CTR models and the
# edge cases give it: one id 3,328 times (one long run), d = 1 (DeepFM's
# first-order table), d = 8 (Deep Crossing, WDL-Adult) and one row. Kernel
# and plain version add each id's rows in sorted order into one f32
# accumulator: bit-equal expected, each output held by its relative L2
# error.
EMBED_CASES = [("wdl", 128), ("single_id", 128), ("d1", 1), ("d8", 8),
               ("n1", 128)]
TOL["fused_embed_grad"] = {"rel_l2": 1e-6}
# WDL-Criteo (examples/ctr/models/wdl_criteo.py) at its published widths
# and the full Criteo-Kaggle vocabulary (its own default): 26 slots x 128
# over 33,762,577 rows (17.3 GB of f32), MLP 13-256-256-256, joint layer
# 3,584 -> 1, SGD lr 0.01, batch 128, 30 steps through Executor.run. Per
# step 1 fused_embed_grad (the table's gradient) and 5 fused_sgd launches.
# The first step's loss and gradients against kernels="off": the segment
# sums are bit-equal and the dense products are cuBLAS's on both sides, so
# rel L2 <= CTR_REL. Rows no step looks up (a seeded sample of CTR_SAMPLE
# rows) must keep their initial bits; the rows looked up must move.
CTR_VOCAB, CTR_DIM, CTR_BATCH, CTR_STEPS, CTR_REL = (33762577, 128, 128, 30,
                                                      1e-6)
CTR_LAUNCHES = {"fused_embed_grad": 1, "fused_sgd": 5}
CTR_SAMPLE, CTR_PROFILE_STEPS, CTR_OFF_VOCAB = 10**6, 3, 100000

# Peak rates for the bound, by card name: device-memory bytes/s, float32
# (non-tensor-core) flop/s and bf16 dense tensor-core flop/s, from NVIDIA's
# data sheets.
CARDS = [("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100", 3.35e12, 67e12, 989e12), ("H200", 4.8e12, 67e12, 989e12)]


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_peaks(name):
    for key, bw, f32, bf16 in CARDS:
        if key in name:
            return bw, f32, bf16
    raise RuntimeError(f"chip_smoke: no peak rates known for card {name!r}")


def bound(nbytes, nflops, bw, flops):
    """(least ms for the work, what bounds it) at the card's peak rates."""
    t_bytes, t_ops = nbytes / bw * 1e3, nflops / flops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, iters=200, warmup=20):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=200):
    """Device time of ``fn`` without the host's launch cost: ``fn`` captured
    once in a CUDA graph, the graph replayed and timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters)


def timings(kernel, plain, library):
    """Per optimizer step at the MLP's shapes: device time (``ms``, CUDA
    graph replay) and the time when launched one by one from Python, as the
    eager executor launches them (``launched_ms``)."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        out[key] = graph_ms(fn)
        out[key.replace("ms", "launched_ms")] = time_ms(fn)
    return out


def max_err(a, b, tol):
    torch.testing.assert_close(a, b, **tol)
    return float((a - b).abs().max())


def rel_l2(a, b):
    """||a - b|| / ||b||, in f32 (||a - b|| where b is all zeros)."""
    den = float(torch.linalg.vector_norm(b.float()))
    num = float(torch.linalg.vector_norm(a.float() - b.float()))
    return num / den if den > 0 else num


def rel_errs(names, got, want, limit, what):
    """Each output's relative L2 error against the plain version; fails
    above ``limit``."""
    errs = {n: rel_l2(g, w) for n, g, w in zip(names, got, want)}
    for n, e in errs.items():
        check(e <= limit, f"{what}: {n} differs from the plain version by "
              f"rel L2 {e} > {limit}")
    return errs


def kernel_phase(fused_opt, dev, bw, flops):
    """Each kernel against its plain version at the MLP's shapes and one
    odd size; times at the MLP's shapes (one optimizer step: six launches,
    warm L2, as right after the backward pass)."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    lr = torch.tensor(1e-3, device=dev)
    out = {}

    # -- fused_sgd -------------------------------------------------------
    err = 0.0
    for shape, l2reg in [(s, 0.0) for s in MLP_SHAPES] + [(ODD_SHAPE, 1e-4)]:
        p, g = rand(shape), rand(shape)
        want = fused_opt._sgd_plain(p, g, lr, l2reg=l2reg)
        got = fused_opt._sgd_kernel(p.clone(), g, lr, l2reg=l2reg)
        err = max(err, max_err(got, want, TOL["fused_sgd"]))
    ps = [rand(s) for s in MLP_SHAPES]
    gs = [rand(s) for s in MLP_SHAPES]
    n = sum(p.numel() for p in ps)
    out["fused_sgd"] = dict(
        max_abs_err=err,
        # read p, g and lr; write p. Two flops per element (mul, sub).
        bound=bound(12 * n + 4 * len(ps), 2 * n, bw, flops),
        **timings(lambda: [fused_opt._sgd_kernel(p, g, lr, l2reg=0.0)
                           for p, g in zip(ps, gs)],
                  lambda: [fused_opt._sgd_plain(p, g, lr, l2reg=0.0)
                           for p, g in zip(ps, gs)],
                  lambda: [torch.add(p, g, alpha=-1e-3)
                           for p, g in zip(ps, gs)]))

    # -- fused_adam ------------------------------------------------------
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-7)
    err = 0.0
    for shape, wd in [(s, 0.0) for s in MLP_SHAPES] + [(ODD_SHAPE, 0.01)]:
        p, g, m = rand(shape), rand(shape), rand(shape, 0.1)
        v = rand(shape, 0.1).abs()
        t = torch.tensor(3.0, device=dev)
        want = fused_opt._adam_plain(p, g, m, v, t, lr, weight_decay=wd, **hyper)
        got = fused_opt._adam_kernel(p.clone(), g, m.clone(), v.clone(), t, lr,
                                     weight_decay=wd, **hyper)
        for a, b in zip(got, want):
            err = max(err, max_err(a, b, TOL["fused_adam"]))
    ms_ = [rand(s, 0.1) for s in MLP_SHAPES]
    vs_ = [rand(s, 0.1).abs() for s in MLP_SHAPES]
    ts = [torch.tensor(3.0, device=dev) for _ in MLP_SHAPES]
    steps = [torch.tensor(3.0, device=dev) for _ in MLP_SHAPES]

    def adam_kernel():
        for p, g, m, v, t in zip(ps, gs, ms_, vs_, ts):
            fused_opt._adam_kernel(p, g, m, v, t, lr, weight_decay=0.0, **hyper)

    def adam_plain():
        for p, g, m, v, t in zip(ps, gs, ms_, vs_, ts):
            fused_opt._adam_plain(p, g, m, v, t, lr, weight_decay=0.0, **hyper)

    out["fused_adam"] = dict(
        max_abs_err=err,
        # read p, g, m, v, t, lr; write p, m, v. About 14 flops per element.
        bound=bound(28 * n + 8 * len(ps), 14 * n, bw, flops),
        **timings(adam_kernel, adam_plain, lambda: torch._fused_adamw_(
            ps, gs, ms_, vs_, [], steps, lr=1e-3, beta1=0.9, beta2=0.999,
            weight_decay=0.0, eps=1e-7, amsgrad=False, maximize=False)))
    return out


def _attention_inputs(gen, dev, b, h, s, d, dtype, pad):
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    kb = None
    if pad:   # key padding from lengths drawn in [S/2, S], as BERT's mask
        lengths = torch.randint(s // 2, s + 1, (b,), generator=gen,
                                device=dev)
        kb = torch.where(torch.arange(s, device=dev)[None, :]
                         < lengths[:, None], 0.0, -1e30)
    return q, k, v, kb


def attention_phase(fa, dev, bw, f32, bf16):
    """flash_attention_fwd against its plain version (and, in f32, against
    unfused attention) at ATTN_CASES; timed at each case."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = TOL["flash_attention_fwd"]
    cases = []
    for b, h, s, d, dtype, causal, pad in ATTN_CASES:
        q, k, v, kb = _attention_inputs(gen, dev, b, h, s, d, dtype, pad)
        kw = dict(scale=d ** -0.5, causal=causal, block_q=min(128, s),
                  block_k=min(128, s))
        o, lse = fa._flash_fwd_kernel(q, k, v, kb, **kw)
        want_o, want_lse = fa._flash_fwd_plain(q, k, v, kb, **kw)
        torch.cuda.synchronize()
        o_tol = tol["o_bf16"] if dtype == torch.bfloat16 else tol["o_f32"]
        case = {"shape": [b, h, s, d], "dtype": str(dtype)[6:],
                "causal": causal, "key_padding": pad,
                "o_max_abs_err": max_err(o.float(), want_o.float(), o_tol),
                "lse_max_abs_err": max_err(lse, want_lse, tol["lse"])}
        if dtype == torch.float32:
            sc = torch.matmul(q, k.transpose(-1, -2)) * kw["scale"]
            if kb is not None:
                sc = sc + kb[:, None, None, :]
            if causal:
                sc = torch.where(torch.ones(s, s, dtype=torch.bool,
                                            device=dev).tril(), sc, -1e30)
            unfused = torch.matmul(torch.softmax(sc, -1), v)
            case["o_vs_unfused_max_abs_err"] = max_err(o, unfused,
                                                       tol["o_f32"])
        es = q.element_size()
        pairs = s * (s + 1) // 2 if causal else s * s
        case["bound"] = bound(
            # read q, k, v (and the bias) once, write o and lse
            4 * b * h * s * d * es + b * h * s * 4 + (b * s * 4 if pad else 0),
            # q k^T and p v over the (query, key) pairs the mask keeps
            4 * b * h * pairs * d, bw, bf16 if dtype == torch.bfloat16 else f32)
        mask = None if kb is None else (kb == 0)[:, None, None, :]
        case.update(
            ms=graph_ms(lambda: fa._flash_fwd_kernel(q, k, v, kb, **kw)),
            # the public entry the model calls, launched one call at a time
            launched_ms=time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal, kw["scale"], kw["block_q"], kw["block_k"],
                kb)),
            plain_ms=graph_ms(lambda: fa._flash_fwd_plain(q, k, v, kb, **kw),
                              iters=20),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal,
                scale=kw["scale"])))
        cases.append(case)
    return cases


def ce_phase(ce, dev, bw, bf16):
    """fused_linear_nll_fwd against its plain version at CE_CASES, timed."""
    gen = torch.Generator(device=dev).manual_seed(2)
    tol = TOL["fused_linear_nll_fwd"]["lse_tl_nll"]
    cases = []
    for n, v, d, layout in CE_CASES:
        w_dv = layout == "dv"
        h = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((v, d), generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        if w_dv:
            w = w.t().contiguous()
        b = torch.randn((v,), generator=gen, device=dev) * 0.02
        t = torch.randint(0, v, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        kw = dict(block_n=128, block_v=512, w_dv=w_dv)
        lse, tl = ce._linear_nll_fwd_kernel(h, w, b, t, **kw)
        want_lse, want_tl = ce._linear_nll_fwd_plain(h, w, b, t, **kw)
        torch.cuda.synchronize()
        err = max(max_err(lse, want_lse, tol), max_err(tl, want_tl, tol),
                  max_err(lse - tl, want_lse - want_tl, tol))

        def library():
            logits = torch.matmul(h, w if w_dv else w.t()).float() + b
            return (torch.logsumexp(logits, -1)
                    - torch.gather(logits, 1, t.long()[:, None])[:, 0])

        cases.append({
            "shape": [n, v, d], "layout": layout, "dtype": "bfloat16",
            "max_abs_err": err, "mean_nll": float((lse - tl).mean()),
            # read h, W, b and the targets once; write lse and tl
            "bound": bound(2 * (n * d + v * d) + 4 * v + 4 * n + 8 * n,
                           2 * n * v * d, bw, bf16),
            "ms": graph_ms(lambda: ce._linear_nll_fwd_kernel(h, w, b, t, **kw)),
            "launched_ms": time_ms(
                lambda: ce.fused_linear_nll(h, w, b, t, w_layout=layout), 50),
            "plain_ms": graph_ms(
                lambda: ce._linear_nll_fwd_plain(h, w, b, t, **kw), iters=20),
            "library_ms": graph_ms(library)})
    return cases


def attention_bwd_phase(fa, dev, bw, f32, bf16):
    """flash_attention_bwd against its plain version (and, in f32, against
    autograd of unfused attention) at ATTN_CASES; timed at each case."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = TOL["flash_attention_bwd"]
    cases = []
    for b, h, s, d, dtype, causal, pad in ATTN_CASES:
        q, k, v, kb = _attention_inputs(gen, dev, b, h, s, d, dtype, pad)
        do = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
        kw = dict(scale=d ** -0.5, causal=causal, block_q=min(128, s),
                  block_k=min(128, s))
        o, lse = fa._flash_fwd_plain(q, k, v, kb, **kw)
        args = (q, k, v, o, lse, do, kb)
        got = fa._flash_bwd_kernel(*args, **kw)
        want = fa._flash_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        bf = dtype == torch.bfloat16
        g_tol = tol["bf16"] if bf else tol["f32"]
        case = {"shape": [b, h, s, d], "dtype": str(dtype)[6:],
                "causal": causal, "key_padding": pad,
                "max_abs_err": max(max_err(g.float(), w.float(), g_tol)
                                   for g, w in zip(got, want)),
                "rel_l2": rel_errs(
                    ("dq", "dk", "dv"), got, want,
                    tol["rel_l2_bf16" if bf else "rel_l2_f32"],
                    f"flash_attention_bwd {[b, h, s, d]}")}
        mask = None if kb is None else (kb == 0)[:, None, None, :]
        if dtype == torch.float32:
            qkv = [x.clone().requires_grad_() for x in (q, k, v)]
            sc = torch.matmul(qkv[0], qkv[1].transpose(-1, -2)) * kw["scale"]
            if kb is not None:
                sc = sc + kb[:, None, None, :]
            if causal:
                sc = torch.where(torch.ones(s, s, dtype=torch.bool,
                                            device=dev).tril(), sc, -1e30)
            ref = torch.autograd.grad(
                torch.matmul(torch.softmax(sc, -1), qkv[2]), qkv, do)
            case["vs_autograd_max_abs_err"] = max(
                max_err(g, r, tol["f32_vs_autograd"])
                for g, r in zip(got, ref))
        es = q.element_size()
        pairs = s * (s + 1) // 2 if causal else s * s
        case["bound"] = bound(
            # read q, k, v, o, dO (and lse, the bias) once; write dq, dk, dv
            8 * b * h * s * d * es + b * h * s * 4 + (b * s * 4 if pad else 0),
            # q k^T (recomputed), dO v^T, ds k, p^T dO, ds^T q over the
            # (query, key) pairs the mask keeps
            10 * b * h * pairs * d, bw, bf16 if dtype == torch.bfloat16 else f32)
        lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=mask, is_causal=causal,
                scale=kw["scale"])

        # the library's backward alone: SDPA forward+backward (one
        # torch.autograd.grad over the same inputs and dO) minus its forward
        lib_fwd = graph_ms(sdpa)
        lib_both = graph_ms(lambda: torch.autograd.grad(sdpa(), (lq, lk, lv),
                                                        do))
        case.update(
            ms=graph_ms(lambda: fa._flash_bwd_kernel(*args, **kw)),
            launched_ms=time_ms(lambda: fa._flash_bwd_kernel(*args, **kw)),
            plain_ms=graph_ms(lambda: fa._flash_bwd_plain(*args, **kw),
                              iters=20),
            library_ms=lib_both - lib_fwd, library_fwd_bwd_ms=lib_both)
        cases.append(case)
    return cases


def ce_bwd_phase(ce, dev, bw, bf16):
    """fused_linear_nll_bwd against its plain version at CE_BWD_CASES; the
    bf16 cases timed."""
    gen = torch.Generator(device=dev).manual_seed(4)
    tol = TOL["fused_linear_nll_bwd"]
    cases = []
    for n, v, d, layout, dtype in CE_BWD_CASES:
        w_dv = layout == "dv"
        bf = dtype == torch.bfloat16
        h = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        w = (torch.randn((v, d), generator=gen, device=dev) * 0.02).to(dtype)
        if w_dv:
            w = w.t().contiguous()
        b = torch.randn((v,), generator=gen, device=dev) * 0.02
        t = torch.randint(0, v, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        ct = torch.rand((n,), generator=gen, device=dev) / n
        kw = dict(block_n=128, block_v=512, w_dv=w_dv)
        lse, _ = ce._linear_nll_fwd_plain(h, w, b, t, **kw)
        args = (h, w, b, t, lse, ct)
        got = ce._linear_nll_bwd_kernel(*args, **kw)
        want = ce._linear_nll_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        check(got[0].dtype == h.dtype and got[1].dtype == w.dtype
              and got[2].dtype == torch.float32, "fused CE grad dtypes")
        g_tol = tol["dh_dw_bf16"] if bf else tol["dh_dw_f32"]
        err = max(max_err(got[0].float(), want[0].float(), g_tol),
                  max_err(got[1].float(), want[1].float(), g_tol),
                  max_err(got[2], want[2], tol["db"]))
        limit = tol["rel_l2_bf16" if bf else "rel_l2_f32"]
        what = f"fused_linear_nll_bwd {[n, v, d]} {layout} {str(dtype)[6:]}"
        rel = rel_errs(("dh", "dW", "db"), got, want, limit, what)
        # the vocabulary ids no row targets: dW's rows (columns for "dv")
        # and db's entries there hold the softmax term alone
        free = torch.ones(v, dtype=torch.bool, device=dev)
        free[t.long()] = False

        def vocab_major(x):
            return x.t() if w_dv else x
        rel.update(rel_errs(
            ("dW_untargeted", "db_untargeted"),
            (vocab_major(got[1])[free], got[2][free]),
            (vocab_major(want[1])[free], want[2][free]), limit, what))
        case = {"shape": [n, v, d], "layout": layout,
                "dtype": str(dtype)[6:], "max_abs_err": err, "rel_l2": rel,
                "absmax": {nm: float(x.float().abs().max()) for nm, x in
                           zip(("dh", "dW", "db"), want)}}
        if not bf:
            cases.append(case)
            continue

        def library():
            # one materialised pass: logits, softmax - onehot, g.W, g^T.h
            logits = torch.matmul(h, w if w_dv else w.t()).float() + b
            g = torch.softmax(logits, -1)
            g[torch.arange(n, device=dev), t.long()] -= 1.0
            g = (g * ct[:, None]).to(h.dtype)
            dh = torch.matmul(g, w.t() if w_dv else w)
            dw = torch.matmul(h.t(), g) if w_dv else torch.matmul(g.t(), h)
            return dh, dw, g.float().sum(0)

        case.update({
            # read h, W, b, targets, lse and ct once; write dh, dW and db
            "bound": bound(2 * 2 * (n * d + v * d) + 8 * v + 12 * n,
                           # the logits (recomputed), g.W and g^T.h
                           3 * 2 * n * v * d, bw, bf16),
            "ms": graph_ms(lambda: ce._linear_nll_bwd_kernel(*args, **kw),
                           iters=20),
            "launched_ms": time_ms(
                lambda: ce._linear_nll_bwd_kernel(*args, **kw), 20),
            "plain_ms": graph_ms(lambda: ce._linear_nll_bwd_plain(*args, **kw),
                                 iters=20),
            "library_ms": graph_ms(library, iters=20)})
        cases.append(case)
    return cases


def csr_check(kind, a, dense, kernel, plain, library, registry, what, bw,
              f32):
    """One csr_spmm/csr_spmv case: the kernel against its plain version on
    the same inputs, then timed."""
    got, want = kernel(a, dense), plain(a, dense)
    torch.cuda.synchronize()
    rel = rel_l2(got, want)
    check(rel <= TOL[kind]["rel_l2"], f"{kind} {what} differs from the plain "
          f"version by rel L2 {rel}")
    f = dense.shape[1] if dense.ndim == 2 else 1
    case = {"matrix": what, "shape": [a.nrow, a.ncol, a.nnz, f],
            "bit_equal": bool(torch.equal(got, want)),
            "max_abs_err": float((got - want).abs().max()), "rel_l2": rel,
            # read rowptr, col and values once and each dense row once
            # (the least; a row's neighbours may fetch it again), write the
            # output once; one multiply and one add per entry and column
            "bound": bound(8 * a.nnz + 4 * (a.nrow + 1) + 4 * a.ncol * f
                           + 4 * a.nrow * f, 2 * a.nnz * f, bw, f32),
            "ms": graph_ms(lambda: kernel(a, dense)),
            # through the registry gate, one call at a time
            "launched_ms": time_ms(lambda: registry.dispatch(kind, a, dense)),
            "plain_ms": graph_ms(lambda: plain(a, dense), iters=3)}
    try:        # cuSPARSE, a yardstick only
        case["library_ms"] = time_ms(library, iters=50)
    except RuntimeError as e:
        case.update(library_ms=None, library_error=str(e)[:200])
    return case


def csr_phase(cs, registry, adj, dev, bw, f32):
    """csr_spmm and csr_spmv against their plain versions on the GCN's
    adjacency at CSR_CASES and on A·x; timed at each."""
    gen = torch.Generator(device=dev).manual_seed(5)
    forms = {"A": adj.csr, "A^T": adj.csr_t}
    lib = {k: torch.sparse_csr_tensor(c.rowptr, c.col, c.val,
                                      (c.nrow, c.ncol), check_invariants=False)
           for k, c in forms.items()}
    spmm = []
    for form, f in CSR_CASES:
        a = forms[form]
        b = torch.randn((a.ncol, f), generator=gen, device=dev)
        spmm.append(csr_check(
            "csr_spmm", a, b, cs._spmm_kernel, cs._spmm_plain,
            lambda: torch.sparse.mm(lib[form], b), registry, form, bw, f32))
    x = torch.randn((adj.ncol,), generator=gen, device=dev)
    spmv = [csr_check("csr_spmv", adj.csr, x, cs._spmv_kernel,
                      cs._spmv_plain, lambda: torch.mv(lib["A"], x),
                      registry, "A", bw, f32)]
    return spmm, spmv


def gcn_phase(ht, gnn_main, cs, registry, counted, dev, bw, f32):
    """The GCN on the arxiv-sized graph: the CSR kernels against their
    plain versions on its adjacency; the first epoch's loss and gradients
    against kernels="off"; one csrmv_op program; then GCN_EPOCHS epochs
    through Executor.run, each with the launch counts zeroed just before
    it and read just after."""
    data = gnn_main.load_graph("arxiv")
    tr = gnn_main.Trainer(dev, "gcn", "arxiv", lr=GCN_LR, data=data)
    spmm, spmv = csr_phase(cs, registry, tr.adj, dev, bw, f32)
    emit("csr_spmm_checked", tolerance=TOL["csr_spmm"], cases=spmm + spmv)

    # -- the first epoch's gradients against the plain versions -----------
    off = gnn_main.Trainer(dev, "gcn", "arxiv", lr=GCN_LR, kernels="off",
                           data=data)
    for n_k, n_o in zip(tr.ex.param_nodes, off.ex.param_nodes):
        check(torch.equal(tr.ex.state["params"][id(n_k)],
                          off.ex.state["params"][id(n_o)]),
              f"initial {n_k.name} differs between the two executors")
    (loss_k, g_k), counts = counted(tr.gradients)
    check(counts == {"csr_spmm": 3}, f"the gradient launched {counts}, "
          "expected 3 csr_spmm")
    (loss_o, g_o), off_counts = counted(off.gradients)
    check(off_counts == {}, f"kernels='off' launched {off_counts}")
    loss_rel = abs(float(loss_k) - float(loss_o)) / abs(float(loss_o))
    grad_rel = rel_errs(sorted(g_k), [g_k[k] for k in sorted(g_k)],
                        [g_o[k] for k in sorted(g_k)], GCN_REL,
                        "GCN first-epoch gradient")
    check(loss_rel <= GCN_REL, f"GCN first loss {float(loss_k)} vs "
          f"kernels='off' {float(loss_o)}")
    (_, _), off_epoch = counted(off.epoch)
    check(off_epoch == {}, f"a kernels='off' epoch launched {off_epoch}")
    emit("gcn_grad_check", loss=float(loss_k), off_loss=float(loss_o),
         loss_rel=loss_rel, grad_rel_l2=grad_rel, tolerance=GCN_REL,
         launches=counts)
    del off, g_k, g_o

    # -- csrmv_op through Executor.run, with and without the kernels ------
    adj_ = ht.Variable(name="adj", trainable=False)
    x_ = ht.Variable(name="x", trainable=False)
    z, zt = ht.csrmv_op(adj_, x_), ht.csrmv_op(adj_, x_, trans=True)
    x = torch.randn((tr.adj.ncol,), generator=torch.Generator(
        device=dev).manual_seed(6), device=dev)
    mv = {}
    for kernels in (None, "off"):
        ex = ht.Executor([z, zt], ctx=ht.gpu(dev.index or 0),
                         kernels=kernels)
        mv[kernels] = counted(lambda: [r.handle for r in ex.run(
            "default", feed_dict={adj_: tr.adj, x_: x})])
    check(mv[None][1] == {"csr_spmv": 2} and mv["off"][1] == {},
          f"csrmv_op launched {mv[None][1]}, under off {mv['off'][1]}")
    mv_rel = rel_errs(("A x", "A^T x"), mv[None][0], mv["off"][0],
                      TOL["csr_spmv"]["rel_l2"], "csrmv_op")
    emit("csrmv_program", nodes=tr.adj.nrow, entries=tr.adj.csr.nnz,
         rel_l2=mv_rel, launches=mv[None][1])

    # -- the main path: GCN_EPOCHS epochs with the kernels ----------------
    del tr
    rows = list(gnn_main.run(dev, "gcn", "arxiv", epochs=GCN_EPOCHS,
                             lr=GCN_LR, data=data))
    epochs, summary = rows[:-1], rows[-1]
    losses = [r["train_loss"] for r in epochs]
    for r in epochs:
        check(r["launches"] == GCN_LAUNCHES, f"epoch {r['epoch']} launched "
              f"{r['launches']}, expected {GCN_LAUNCHES}")
    check(np.isfinite(losses).all(), f"losses {losses}")
    check(abs(losses[0] - float(loss_k)) / losses[0] < 1e-6,
          "the first epoch's loss differs from the gradient check's")
    check(losses[-1] < 0.5 * losses[0], f"GCN loss {losses[0]} -> "
          f"{losses[-1]} did not halve in {GCN_EPOCHS} epochs")
    emit("gcn_train", arch="gcn", graph="arxiv", lr=GCN_LR,
         epochs=GCN_EPOCHS, **{k: summary[k] for k in (
             "nodes", "entries", "features", "hidden", "classes",
             "csr_build_ms", "epoch_ms", "launches_per_epoch")},
         losses=losses, test_acc=[r["test_acc"] for r in epochs],
         epoch_ms_each=[r["ms"] for r in epochs])
    launches = {k: sum(r["launches"].get(k, 0) for r in epochs)
                for k in GCN_LAUNCHES}
    return spmm, spmv, {"csr_spmm": launches["csr_spmm"],
                        "csr_spmv": mv[None][1]["csr_spmv"]}


def _embed_inputs(case, d, first_ids, gen, dev):
    """(vec, idx) of one EMBED_CASES case; ids as float32, as fed."""
    ids = first_ids.reshape(-1)
    idx = {"wdl": first_ids, "n1": ids[:1],
           "single_id": torch.full_like(ids, 4321.0)}.get(case, ids)
    return torch.randn((idx.numel(), d), generator=gen, device=dev), idx


def embed_grad_phase(eg, registry, first_ids, dev, bw, f32):
    """fused_embed_grad against its plain version on the same sorted rows
    at EMBED_CASES, each timed: replayed (``ms``), launched through the
    registry one call at a time, and eagerly the plain version and
    torch.segment_reduce (the library's sorted segment sum, a yardstick
    only), all after the prep the path runs first."""
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = []
    for case, d in EMBED_CASES:
        vec, idx = _embed_inputs(case, d, first_ids, gen, dev)
        sv, _, _, count, offs = eg._prep(vec, idx, CTR_VOCAB)
        got, want = eg._segsum_kernel(sv, offs), eg._segsum_plain(sv, offs)
        torch.cuda.synchronize()
        rel = rel_l2(got, want)
        check(rel <= TOL["fused_embed_grad"]["rel_l2"], f"fused_embed_grad "
              f"{case} differs from the plain version by rel L2 {rel}")
        n = sv.shape[0]
        lengths = (offs[1:] - offs[:-1]).long()

        def library():
            return torch.segment_reduce(sv, "sum", lengths=lengths,
                                        unsafe=True)

        lib = library()
        c = {"case": case, "shape": [n, d], "unique": int(count),
             "longest": int(lengths.max()),
             "bit_equal": bool(torch.equal(got, want)),
             "max_abs_err": float((got - want).abs().max()), "rel_l2": rel,
             "library_rel_l2": rel_l2(lib, want),
             # read sv and the offsets once, write out once; at most one
             # add per element of sv
             "bound": bound(8 * n * d + 4 * (n + 1), n * d, bw, f32),
             "ms": graph_ms(lambda: eg._segsum_kernel(sv, offs)),
             "launched_ms": time_ms(lambda: registry.dispatch(
                 "fused_embed_grad", sv, offs)),
             "plain_ms": time_ms(lambda: eg._segsum_plain(sv, offs),
                                 iters=10, warmup=2),
             # eagerly: a capture that fails on a host sync inside the
             # library would leave the stream unusable
             "library_ms": time_ms(library, iters=50)}
        cases.append(c)
    return cases


def _table_probe(g, rows):
    """What is kept of a (vocab, d) table gradient, so that no second one
    is held: its rows ``rows``, its norm, and whether it is zero in every
    other row (``g`` is the caller's to spend: those rows are zeroed in
    place, then its least and largest elements read, with no temporary of
    its size)."""
    kept = {"rows": g.index_select(0, rows),
            "norm": float(torch.linalg.vector_norm(g))}
    g.index_fill_(0, rows, 0.0)
    kept["zero_elsewhere"] = float(g.min()) == 0.0 == float(g.max())
    return kept


def _peak_gb(dev):
    """Peak device memory since the last reset, in GB; resets it."""
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    return peak


def ctr_grad_check(tr, counted, rows0):
    """The first step's loss and five gradients with the kernels against
    kernels="off", on one executor (one table on the card)."""
    table = tr.tables[0].name
    probes = {}
    for kernels in (None, "off"):
        (loss, grads), counts = counted(lambda: tr.gradients(kernels))
        probes[kernels] = (loss, _table_probe(grads.pop(table), rows0),
                           grads, counts)
    (loss_k, t_k, g_k, counts), (loss_o, t_o, g_o, off_counts) = (
        probes[None], probes["off"])
    check(counts == {"fused_embed_grad": 1}, f"the gradient launched "
          f"{counts}, expected 1 fused_embed_grad")
    check(off_counts == {}, f"kernels='off' launched {off_counts}")
    check(len(g_k) == 4, f"gradients {sorted(g_k)} besides the table")
    check(t_k["zero_elsewhere"] and t_o["zero_elsewhere"],
          "the table gradient is nonzero outside the looked-up rows")
    names = sorted(g_k)
    grad_rel = rel_errs(names + [table + " (looked-up rows)"],
                        [g_k[k] for k in names] + [t_k["rows"]],
                        [g_o[k] for k in names] + [t_o["rows"]], CTR_REL,
                        "WDL-Criteo first-step gradient")
    loss_rel = abs(float(loss_k) - float(loss_o)) / abs(float(loss_o))
    norm_rel = abs(t_k["norm"] - t_o["norm"]) / t_o["norm"]
    check(loss_rel <= CTR_REL and norm_rel <= CTR_REL,
          f"first loss {float(loss_k)} vs kernels='off' {float(loss_o)}, "
          f"table gradient norm {t_k['norm']} vs {t_o['norm']}")
    emit("ctr_grad_check", loss=float(loss_k), off_loss=float(loss_o),
         loss_rel=loss_rel, grad_rel_l2=grad_rel, table_norm=t_k["norm"],
         table_norm_rel=norm_rel, tolerance=CTR_REL, launches=counts)
    return float(loss_k)


def ctr_program(ht, counted, first_ids, rows0, dev):
    """The explicit embedding_lookup_gradient_op through Executor.run, in
    dense and in rows mode, with the kernels and with kernels="off"."""
    vec_ = ht.Variable(name="vec", trainable=False)
    idx_ = ht.Variable(name="idx", trainable=False)
    g = ht.embedding_lookup_gradient_op(vec_, idx_, (CTR_VOCAB, CTR_DIM))
    vec = torch.randn(tuple(first_ids.shape) + (CTR_DIM,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(10))
    out = {}
    for mode in ("dense", "rows"):
        (g.to_rows if mode == "rows" else g.to_dense)()
        for kernels in (None, "off"):
            ex = ht.Executor([g], ctx=ht.gpu(dev.index or 0),
                             kernels=kernels)
            res, counts = counted(lambda: ex.run(
                feed_dict={vec_: vec, idx_: first_ids})[0])
            if mode == "dense":
                kept = _table_probe(res.handle, rows0)
            else:
                kept = {"rows": res.rows.handle, "grads": res.grads.handle}
            del res
            check(counts == ({} if kernels else {"fused_embed_grad": 1}),
                  f"the {mode} program launched {counts} under "
                  f"kernels={kernels}")
            out[mode, kernels] = kept
    dense, dense_off = out["dense", None], out["dense", "off"]
    rows, rows_off = out["rows", None], out["rows", "off"]
    k = rows0.numel()
    check(dense["zero_elsewhere"] and dense_off["zero_elsewhere"]
          and torch.equal(rows["rows"], rows_off["rows"])
          and torch.equal(rows["rows"][:k].long(), rows0),
          "the programs' rows differ")
    rel = rel_errs(["dense", "rows"], [dense["rows"], rows["grads"]],
                   [dense_off["rows"], rows_off["grads"]], CTR_REL,
                   "embedding_lookup_gradient_op")
    check(torch.equal(dense["rows"], rows["grads"][:k]),
          "dense mode's looked-up rows differ from rows mode's sums")
    emit("ctr_gradient_program", ids=int(first_ids.numel()), unique=k,
         vocab=CTR_VOCAB, dim=CTR_DIM, rel_l2=rel,
         launches={"fused_embed_grad": 1})


def ctr_off_step(ctr_main, counted, dev):
    """One training step with the kernels and one with kernels="off" from
    the same initial values, at the reference's default vocabulary
    (CTR_OFF_VOCAB rows: at the full one, the plain SGD's two table-sized
    temporaries do not fit beside the table and its gradient). No launch
    under off; every parameter the same after the step."""
    data = ctr_main.load_data("wdl_criteo", CTR_OFF_VOCAB)
    params, counts = {}, {}
    for kernels in (None, "off"):
        tr = ctr_main.Trainer(dev, "wdl_criteo", CTR_BATCH, CTR_OFF_VOCAB,
                              data=data, kernels=kernels)
        _, counts[kernels] = counted(tr.step)
        params[kernels] = {p.name: tr.param(p) for p in tr.params}
    check(counts[None] == CTR_LAUNCHES and counts["off"] == {},
          f"a step launched {counts[None]}, under kernels='off' "
          f"{counts['off']}")
    names = sorted(params[None])
    rel = rel_errs(names, [params[None][k] for k in names],
                   [params["off"][k] for k in names], CTR_REL,
                   "WDL-Criteo parameters after one step")
    emit("ctr_off_step", vocab=CTR_OFF_VOCAB, param_rel_l2=rel,
         launches=counts[None], off_launches=counts["off"])


def ctr_phase(ht, ctr_main, eg, registry, counted, dev, bw, f32):
    """WDL-Criteo at the full Criteo vocabulary: fused_embed_grad against
    its plain version; the first step's gradients against kernels="off";
    CTR_STEPS steps through Executor.run (ctr_main.run), the launch counts
    zeroed just before each step and read just after; the rows no step
    looked up unchanged; the step profiled; then the explicit gradient
    op, and a whole step against kernels="off" at a cut vocabulary."""
    import tempfile
    data = ctr_main.load_data("wdl_criteo", CTR_VOCAB)
    first_ids = torch.from_numpy(data[0][1][:CTR_BATCH]).to(dev)
    rows0 = torch.unique(first_ids.long())
    embed = embed_grad_phase(eg, registry, first_ids, dev, bw, f32)
    emit("fused_embed_grad_checked", tolerance=TOL["fused_embed_grad"],
         cases=embed)

    torch.cuda.empty_cache()
    _peak_gb(dev)
    tr = ctr_main.Trainer(dev, "wdl_criteo", CTR_BATCH, CTR_VOCAB, data=data)
    table = tr.param(tr.tables[0])
    check(table.device == dev and tuple(table.shape) == (CTR_VOCAB, CTR_DIM),
          f"the table is {tuple(table.shape)} on {table.device}")
    peak_gb = {"init": _peak_gb(dev)}
    first_loss = ctr_grad_check(tr, counted, rows0)
    peak_gb["grad_check"] = _peak_gb(dev)

    # rows that no training step looks up, and rows that some step does
    looked = np.unique(data[0][1][:CTR_STEPS * CTR_BATCH].astype(np.int64))
    sample = np.setdiff1d(np.random.RandomState(9).randint(
        0, CTR_VOCAB, CTR_SAMPLE), looked)
    sample, looked = (torch.from_numpy(a).to(dev) for a in (sample, looked))
    before, before_looked = (table.index_select(0, sample),
                             table.index_select(0, looked))
    with tempfile.TemporaryDirectory() as prof:
        it = ctr_main.run(dev, trainer=tr, steps=CTR_STEPS, profile_dir=prof,
                          profile_iters=CTR_PROFILE_STEPS)
        epoch = next(it)
        peak_gb["train"] = _peak_gb(dev)
        untouched = bool(torch.equal(table.index_select(0, sample), before))
        moved = int((table.index_select(0, looked) != before_looked)
                    .any(1).sum())
        summary = next(it)              # the profile's steps train on
    losses = epoch["losses"]
    check(epoch["launches_per_step"] == CTR_LAUNCHES
          and epoch["launches_same_every_step"],
          f"a step launched {epoch['launches_per_step']}, expected "
          f"{CTR_LAUNCHES} every step")
    check(epoch["launches"] == {k: CTR_STEPS * v
                                for k, v in CTR_LAUNCHES.items()},
          f"{CTR_STEPS} steps launched {epoch['launches']}")
    check(np.isfinite(losses).all(), f"losses {losses}")
    check(abs(losses[0] - first_loss) / first_loss < 1e-6,
          "the first step's loss differs from the gradient check's")
    check(untouched, "a row no step looked up changed")
    check(moved == looked.numel(), f"{looked.numel() - moved} looked-up rows "
          "did not move")
    prof = summary["profile"]
    emit("ctr_train", model="wdl_criteo", vocab=CTR_VOCAB, dim=CTR_DIM,
         batch=CTR_BATCH, ids_per_step=CTR_BATCH * 26, params=tr.n_params,
         table_gb=table.numel() * 4 / 1e9, steps=CTR_STEPS,
         init_s=tr.init_ms / 1e3, step_ms=summary["step_ms"],
         samples_per_s=summary["samples_per_s"],
         device_ms=prof["device_ms"],
         device_busy_share=prof["device_busy_share"],
         groups_us=prof["groups_us"], losses=losses,
         train_acc=epoch["train_acc"], train_auc=epoch["train_auc"],
         sampled_untouched_rows=int(sample.numel()), untouched=untouched,
         looked_up_rows=int(looked.numel()), moved=moved,
         launches_per_step=epoch["launches_per_step"])
    del tr, table, before, before_looked
    torch.cuda.empty_cache()
    ctr_program(ht, counted, first_ids, rows0, dev)
    peak_gb["program"] = _peak_gb(dev)
    emit("ctr_memory", peak_gb=peak_gb)
    ctr_off_step(ctr_main, counted, dev)
    return embed, {"fused_embed_grad": epoch["launches"]["fused_embed_grad"]}


def bert_train_phase(bert, tfm, bert_forward, bert_pretrain, registry, dev):
    """BERT-base pretraining: the first step's gradients with the kernels
    against kernels="off", then TRAIN_STEPS steps of make_pretrain_step,
    each with the launch counts zeroed just before it and read just after;
    then FINETUNE_STEPS steps of make_finetune_step on the requests."""
    cfg = bert.BERT_BASE
    want = {"flash_attention_fwd": 2 * cfg.n_layers,   # forward + remat
            "flash_attention_bwd": cfg.n_layers,
            "fused_linear_nll_fwd": 1, "fused_linear_nll_bwd": 1}
    params = bert.init_params(0, cfg, dev)
    batch = bert_forward.phase1_batch(cfg, BERT_BATCH, BERT_SEQ, BERT_PRED,
                                      seed=0, device=dev)

    def grads(c):
        return bert_forward.counted(lambda: tfm.value_and_grad(
            bert.pretrain_loss, params, batch, c, has_aux=True))

    # -- the first step's gradients against the plain versions -------------
    # f32 first: its gradient with the kernels, held per tensor to
    # kernels="off", is the reference both bf16 gradients are measured from
    agree, ref = {}, None
    for name, c in (("float32", dataclasses.replace(cfg, dtype=torch.float32)),
                    ("bfloat16", cfg)):
        ((loss_k, _), g_k), counts = grads(c)
        check(counts == want, f"{name} pretrain gradient launched {counts}, "
              f"expected {want}")
        with registry.active("off"):
            ((loss_o, _), g_o), off_counts = grads(c)
        check(off_counts == {}, f"kernels='off' launched {off_counts}")
        paths, flat_k = zip(*tfm.tree_leaves(g_k, with_paths=True))
        flat_o = tfm.tree_leaves(g_o)
        per = {p: rel_l2(a, b) for p, a, b in zip(paths, flat_k, flat_o)}
        worst = max(per, key=per.get)
        agree[name] = dict(
            loss=float(loss_k), off_loss=float(loss_o),
            loss_rel=abs(float(loss_k) - float(loss_o)) / abs(float(loss_o)),
            grad_rel_l2_all=rel_l2(torch.cat([g.flatten() for g in flat_k]),
                                   torch.cat([g.flatten() for g in flat_o])),
            grad_rel_l2_max=per[worst], grad_rel_l2_worst=worst)
        if name == "bfloat16":
            # bf16 rounding through 12 layers and back, measured: each
            # tensor's distance from the f32 gradient, and all tensors'
            # together, with the kernels and with the plain versions
            vs_k = {p: rel_l2(a, r) for p, a, r in zip(paths, flat_k, ref)}
            vs_o = {p: rel_l2(b, r) for p, b, r in zip(paths, flat_o, ref)}
            ref_all = torch.cat([g.flatten() for g in ref])
            k_all = rel_l2(torch.cat([g.flatten() for g in flat_k]), ref_all)
            o_all = rel_l2(torch.cat([g.flatten() for g in flat_o]), ref_all)
            del ref_all
            limit = {p: BF16_EXCESS * max(vs_o[p], o_all) for p in paths}
            use = {p: vs_k[p] / limit[p] for p in paths}
            worst_x = max(use, key=use.get)
            agree[name].update(
                vs_f32_all=k_all, off_vs_f32_all=o_all, vs_f32=vs_k,
                off_vs_f32=vs_o, excess_limit=BF16_EXCESS,
                worst_share_of_limit=use[worst_x], worst=worst_x)
            first_loss = float(loss_k)
        emit("bert_grad_check", dtype=name, grad_rel_l2_tol=GRAD_REL,
             **agree[name])
        check(agree[name]["loss_rel"] < BERT_REL, f"{name} first loss "
              f"{float(loss_k)} vs kernels='off' {float(loss_o)}")
        check(agree[name]["grad_rel_l2_all"] < GRAD_REL, f"{name} gradients "
              f"differ from kernels='off': {agree[name]}")
        if name == "float32":
            check(per[worst] < GRAD_REL, f"float32 gradient of {worst} "
                  f"differs from kernels='off' by rel L2 {per[worst]}")
            ref = flat_k
        else:
            check(k_all <= BF16_EXCESS * o_all, f"bfloat16 gradients are rel "
                  f"L2 {k_all} from the f32 ones, kernels='off' {o_all}")
            check(use[worst_x] <= 1, f"bfloat16 gradient of {worst_x} is "
                  f"rel L2 {vs_k[worst_x]} from the f32 one, above "
                  f"{limit[worst_x]} (kernels='off' {vs_o[worst_x]})")
        del g_k, g_o, flat_k, flat_o
    del ref
    # the off step itself launches nothing (on copies: a step updates in
    # place)
    copy = tfm.tree_map(torch.clone, params)
    step_off = bert.make_pretrain_step(cfg, lr=TRAIN_LR)
    with registry.active("off"):
        (off_step_loss, _, _, _), off_step_counts = bert_forward.counted(
            lambda: step_off(copy, bert.init_opt_state(copy), batch))
    check(off_step_counts == {}, f"kernels='off' step launched "
          f"{off_step_counts}")
    check(float(off_step_loss) == agree["bfloat16"]["off_loss"],
          "the off step's loss differs from the off gradient's")
    del copy, params

    # -- the main path: TRAIN_STEPS steps with the kernels -----------------
    rows = list(bert_pretrain.run(dev, TRAIN_STEPS, BERT_BATCH, BERT_SEQ,
                                  BERT_PRED, TRAIN_LR, cfg=cfg))
    steps, summary = rows[:-1], rows[-1]
    losses = [r["loss"] for r in steps]
    for r in steps:
        check(r["launches"] == want, f"step {r['step']} launched "
              f"{r['launches']}, expected {want}")
    check(np.isfinite(losses).all(), f"losses {losses}")
    ln = float(np.log(cfg.vocab_size) + np.log(2))
    check(abs(losses[0] - ln) < FIRST_LOSS_TOL,
          f"first loss {losses[0]} is not within {FIRST_LOSS_TOL} of {ln}")
    check(abs(losses[0] - first_loss) / losses[0] < BERT_REL,
          "the step's first loss differs from the gradient check's")
    last5 = float(np.mean(losses[-5:]))
    check(last5 < losses[0], f"mean of the last 5 losses {last5} is not "
          f"below the first {losses[0]}")
    emit("bert_pretrain", config="BERT_BASE", remat=cfg.remat,
         batch=BERT_BATCH, seq_len=BERT_SEQ, mlm_slots=BERT_PRED,
         lr=TRAIN_LR, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP,
         losses=losses, first_loss=losses[0], ln_vocab_plus_ln2=ln,
         mean_last5=last5, step_ms=summary["step_ms"],
         sequences_per_s=summary["sequences_per_s"],
         tokens_per_s=summary["tokens_per_s"],
         launches_per_step=summary["launches_per_step"])

    # -- fine-tuning the classifier on the requests -------------------------
    cls = bert.init_classifier_params(1, cfg, 2, pretrained=bert.init_params(
        0, cfg, dev))
    opt = bert.init_opt_state(cls)
    ids, seg, mask = bert_forward.requests(cfg, BERT_REQUESTS, BERT_SEQ,
                                           seed=1, device=dev)
    fb = {"input_ids": ids, "segment_ids": seg, "input_mask": mask,
          "label": torch.arange(BERT_REQUESTS, device=dev) % 2}
    step = bert.make_finetune_step(cfg, lr=FINETUNE_LR)
    ft_losses = []
    for i in range(FINETUNE_STEPS):
        (loss, acc, cls, opt), counts = bert_forward.counted(
            lambda: step(cls, opt, fb))
        ft_want = {"flash_attention_fwd": 2 * cfg.n_layers,
                   "flash_attention_bwd": cfg.n_layers}
        check(counts == ft_want, f"finetune step {i} launched {counts}, "
              f"expected {ft_want}")
        ft_losses.append(float(loss))
    check(np.isfinite(ft_losses).all(), f"finetune losses {ft_losses}")
    emit("bert_finetune", requests=BERT_REQUESTS, seq_len=BERT_SEQ,
         lr=FINETUNE_LR, steps=FINETUNE_STEPS, losses=ft_losses,
         launches_per_step=counts)
    return summary["launches_per_step"]


def bert_phase(bert, bert_forward, registry, dev):
    """The BERT-base forward: the pretraining loss without gradient and the
    classifier on requests, each once with the launch counts zeroed just
    before it and read just after, then against kernels="off", then timed."""
    cfg = bert.BERT_BASE
    params = bert.init_params(0, cfg, dev)
    batch = bert_forward.phase1_batch(cfg, BERT_BATCH, BERT_SEQ, BERT_PRED,
                                      seed=0, device=dev)
    cls_params = bert.init_classifier_params(1, cfg, 2, pretrained=params)
    ids, seg, mask = bert_forward.requests(cfg, BERT_REQUESTS, BERT_SEQ,
                                           seed=1, device=dev)

    def pretrain():
        loss, (mlm, nsp) = bert.pretrain_loss(params, batch, cfg)
        return torch.stack([loss, mlm, nsp])

    def classify():
        return bert.classify_logits(cls_params, ids, seg, cfg,
                                    input_mask=mask)

    with torch.inference_mode():
        # -- the main path, with the kernels -------------------------------
        losses, pre_counts = bert_forward.counted(pretrain)
        logits, cls_counts = bert_forward.counted(classify)
        loss, mlm, nsp = (float(x) for x in losses)
        check(pre_counts == {"flash_attention_fwd": cfg.n_layers,
                             "fused_linear_nll_fwd": 1},
              f"pretrain_loss launched {pre_counts}, expected "
              f"{cfg.n_layers} flash_attention_fwd and 1 fused_linear_nll_fwd")
        check(cls_counts == {"flash_attention_fwd": cfg.n_layers},
              f"classify_logits launched {cls_counts}, expected "
              f"{cfg.n_layers} flash_attention_fwd")
        check(np.isfinite([loss, mlm, nsp]).all(), f"losses {losses}")
        check(abs(mlm - np.log(cfg.vocab_size)) < 0.5,
              f"mlm {mlm} at init is not within 0.5 of ln V")
        check(abs(nsp - np.log(2)) < 0.2,
              f"nsp {nsp} at init is not within 0.2 of ln 2")
        check(tuple(logits.shape) == (BERT_REQUESTS, 2)
              and bool(torch.isfinite(logits).all()), f"logits {logits}")
        # -- the same inputs through the plain versions on the card --------
        with registry.active("off"):
            off_losses, off_counts = bert_forward.counted(pretrain)
            off_logits, _ = bert_forward.counted(classify)
            off_ms = bert_forward.forward_ms(pretrain, iters=5)
        check(off_counts == {}, "kernels='off' launched a kernel")
        rel = (losses - off_losses).abs() / off_losses.abs()
        check(bool((rel < BERT_REL).all()),
              f"losses {losses.tolist()} vs kernels='off' "
              f"{off_losses.tolist()}: rel {rel.tolist()}")
        logits_err = float((logits - off_logits).abs().max())
        check(logits_err < LOGITS_ATOL,
              f"classifier logits differ from kernels='off' by {logits_err}")
        # -- timed ---------------------------------------------------------
        ms = bert_forward.forward_ms(pretrain, BERT_ITERS)
        cls_ms = bert_forward.forward_ms(classify, BERT_ITERS)
    emit("bert_forward", config="BERT_BASE", layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, vocab=cfg.vocab_size,
         dtype="bfloat16", params=bert.count_params(params),
         batch=BERT_BATCH, seq_len=BERT_SEQ, mlm_slots=BERT_PRED,
         real_mlm_slots=int(batch["mlm_weights"].sum()),
         loss=loss, mlm=mlm, nsp=nsp, ln_vocab=float(np.log(cfg.vocab_size)),
         off_rel_diff=[float(x) for x in rel], launches=pre_counts,
         forward_ms=ms, sequences_per_s=BERT_BATCH / ms * 1e3,
         off_forward_ms=off_ms)
    emit("bert_requests", requests=BERT_REQUESTS, seq_len=BERT_SEQ,
         logits_absmax=float(logits.abs().max()),
         off_max_abs_diff=logits_err, launches=cls_counts, ms=cls_ms,
         requests_per_s=BERT_REQUESTS / cls_ms * 1e3)
    return pre_counts


def train(ht, cnn_main, data, opt, lr, steps, kernels=None, ctx=None,
          validate=False):
    """One fresh executor on the MLP: (losses, step ms, validation)."""
    loss, y, y_, train_op = cnn_main.build("mlp", "CIFAR10", BATCH, opt, lr,
                                           data=data)
    ex = ht.Executor({"train": [loss, y, train_op], "validate": [loss, y, y_]},
                     ctx=ctx, seed=0, kernels=kernels)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "the executor must keep f32 matmuls in full f32")
    losses = []
    t0 = None
    for i in range(steps):
        if i == min(10, steps - 1):  # first steps carry cuBLAS/allocator set-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        lv, yv, _ = ex.run("train")
        losses.append(lv.handle)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - min(10, steps - 1))
    check(tuple(yv.shape) == (BATCH, data[5]), f"logits shape {yv.shape}")
    losses = torch.stack(losses).cpu().numpy()
    val = None
    if validate:
        vl, correct = [], []
        for _ in range(ex.get_batch_num("validate")):
            l, yp, yt = ex.run("validate", convert_to_numpy_ret_vals=True)
            vl.append(float(l))
            correct.extend(np.argmax(yp, 1) == np.argmax(yt, 1))
        val = {"loss": float(np.mean(vl)), "acc": float(np.mean(correct))}
    return losses, step_ms, val


def kernels_line(kern, attn, ces, attn_bwd, ce_bwd, spmm, spmv, embed,
                 launches):
    """The ``kernels`` JSON object: one entry per ported kernel."""
    replaces = {"fused_sgd": "hetu_tpu/kernels/fused_opt.py:164",
                "fused_adam": "hetu_tpu/kernels/fused_opt.py:95",
                "flash_attention_fwd": "hetu_tpu/kernels/flash_attention.py:111",
                "fused_linear_nll_fwd": "hetu_tpu/kernels/fused_ce.py:223",
                "flash_attention_bwd": "hetu_tpu/kernels/flash_attention.py:240",
                "fused_linear_nll_bwd": "hetu_tpu/kernels/fused_ce.py:252",
                "csr_spmm": "hetu_tpu/kernels/csr_spmm.py:78",
                "csr_spmv": "hetu_tpu/kernels/csr_spmm.py:142",
                "fused_embed_grad": "hetu_tpu/kernels/embed_grad.py:108"}
    sources = {"fused_sgd": "fused_opt.cu", "fused_adam": "fused_opt.cu",
               "flash_attention_fwd": "flash_attention.cu",
               "fused_linear_nll_fwd": "fused_ce.cu",
               "flash_attention_bwd": "flash_attention.cu",
               "fused_linear_nll_bwd": "fused_ce.cu",
               "csr_spmm": "csr_spmm.cu", "csr_spmv": "csr_spmm.cu",
               "fused_embed_grad": "embed_grad.cu"}
    # the BERT kernels' entries are timed at the main path's shapes (their
    # first cases); max_abs_err is the largest over all their cases
    kern = dict(kern)
    kern["flash_attention_fwd"] = dict(attn[0], max_abs_err=max(
        max(c["o_max_abs_err"], c["lse_max_abs_err"]) for c in attn))
    kern["fused_linear_nll_fwd"] = dict(ces[0], max_abs_err=max(
        c["max_abs_err"] for c in ces))
    kern["flash_attention_bwd"] = dict(attn_bwd[0], max_abs_err=max(
        c["max_abs_err"] for c in attn_bwd))
    kern["fused_linear_nll_bwd"] = dict(ce_bwd[0], max_abs_err=max(
        c["max_abs_err"] for c in ce_bwd))
    # csr_spmm at layer 2's forward (F = 256); epoch_ms sums the three
    # shapes an epoch launches
    kern["csr_spmm"] = dict(spmm[1], max_abs_err=max(
        c["max_abs_err"] for c in spmm), epoch_ms=sum(c["ms"] for c in spmm))
    kern["csr_spmv"] = spmv[0]
    # fused_embed_grad at WDL-Criteo's step, the first case
    kern["fused_embed_grad"] = dict(embed[0], max_abs_err=max(
        c["max_abs_err"] for c in embed))
    return {"kernels": [dict(
        name=k, route="cuda", source="hetu_tpu_torch/csrc/" + sources[k],
        replaces=replaces[k], launches=launches[k],
        max_abs_err=v["max_abs_err"], tolerance=TOL[k], ms=v["ms"],
        plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
        bound_by=v["bound"][1], library_ms=v["library_ms"],
        **{f: v[f] for f in ("launched_ms", "plain_launched_ms",
                             "library_launched_ms", "shape", "epoch_ms")
           if f in v})
        for k, v in kern.items()]}


def main():
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.examples import (bert_forward, bert_pretrain,
                                         cnn_main, ctr_main, gnn_main)
    from hetu_tpu_torch.kernels import (_build, csr_spmm, embed_grad,
                                        flash_attention, fused_ce, fused_opt,
                                        registry)
    from hetu_tpu_torch.models import bert, transformer

    # -- 1. device --------------------------------------------------------
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    bw, f32, bf16 = card_peaks(name)
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p) for p in libs.values()])

    # -- 3. kernels against their plain versions ---------------------------
    kern = kernel_phase(fused_opt, dev, bw, f32)
    emit("kernels_checked", shapes=[list(s) for s in MLP_SHAPES + [ODD_SHAPE]],
         tolerance={k: TOL[k] for k in kern},
         **{k: {"max_abs_err": v["max_abs_err"]} for k, v in kern.items()})
    attn = attention_phase(flash_attention, dev, bw, f32, bf16)
    emit("flash_attention_checked", tolerance=TOL["flash_attention_fwd"],
         cases=attn)
    ces = ce_phase(fused_ce, dev, bw, bf16)
    emit("fused_linear_nll_checked", tolerance=TOL["fused_linear_nll_fwd"],
         cases=ces)
    attn_bwd = attention_bwd_phase(flash_attention, dev, bw, f32, bf16)
    emit("flash_attention_bwd_checked", tolerance=TOL["flash_attention_bwd"],
         cases=attn_bwd)
    ce_bwd = ce_bwd_phase(fused_ce, dev, bw, bf16)
    emit("fused_linear_nll_bwd_checked",
         tolerance=TOL["fused_linear_nll_bwd"], cases=ce_bwd)

    # -- 4. train the full-width MLP through the executor ------------------
    data = cnn_main.load_dataset("CIFAR10")
    n_params = sum(int(np.prod(s)) for s in MLP_SHAPES)
    launches = {}
    for opt, lr, steps, loss_max in (("sgd", SGD_LR, SGD_STEPS, SGD_LOSS_MAX),
                                     ("adam", ADAM_LR, ADAM_STEPS, ADAM_LOSS_MAX)):
        kname = "fused_sgd" if opt == "sgd" else "fused_adam"
        registry.reset_launch_counts()
        losses, step_ms, val = train(ht, cnn_main, data, opt, lr, steps,
                                     validate=True)
        counts = registry.launch_counts()
        launches[kname] = counts[kname]
        check(np.all(np.isfinite(losses)), f"{opt}: non-finite loss")
        last = float(np.mean(losses[-10:]))
        check(last < loss_max, f"{opt}: mean loss of the last 10 steps "
              f"{last} is not below {loss_max}")
        check(counts[kname] == 6 * steps,
              f"{opt}: {kname} launched {counts[kname]} times in {steps} "
              f"steps, expected {6 * steps}")
        check(sum(counts.values()) == counts[kname],
              f"{opt}: unexpected launches {counts}")
        off, _, _ = train(ht, cnn_main, data, opt, lr, 5, kernels="off")
        check(registry.launch_counts()[kname] == counts[kname],
              "kernels='off' launched a kernel")
        np.testing.assert_allclose(losses[:5], off, rtol=1e-5)
        emit("train", opt=opt, lr=lr, steps=steps, batch=BATCH,
             params=n_params, step_ms=step_ms,
             samples_per_s=BATCH / step_ms * 1e3, first_loss=float(losses[0]),
             last_loss=float(losses[-1]), mean_last10=last, validate=val,
             launches=counts, first5_vs_off_max_rel=float(
                 np.max(np.abs(losses[:5] - off) / np.abs(off))))

    # -- 5. the port on the card against the port on the CPU, small input ---
    small = (data[0][:1024, :64], data[1][:1024], data[2][:256, :64],
             data[3][:256], 64, 10)
    for opt, lr in (("sgd", SGD_LR), ("adam", ADAM_LR)):
        gpu_l, _, _ = train(ht, cnn_main, small, opt, lr, 8)
        cpu_l, _, _ = train(ht, cnn_main, small, opt, lr, 8, ctx=ht.cpu(0))
        # matmul sums run in another order on the card than on the CPU
        np.testing.assert_allclose(gpu_l, cpu_l, rtol=1e-4)
        emit("parity_cpu", opt=opt, steps=8,
             max_rel=float(np.max(np.abs(gpu_l - cpu_l) / np.abs(cpu_l))))

    # -- 6. the BERT-base forward ------------------------------------------
    forward_launches = bert_phase(bert, bert_forward, registry, dev)
    check(set(forward_launches) == {"flash_attention_fwd",
                                    "fused_linear_nll_fwd"},
          f"the forward launched {forward_launches}")

    # -- 7. BERT-base pretraining and fine-tuning ---------------------------
    launches.update(bert_train_phase(bert, transformer, bert_forward,
                                     bert_pretrain, registry, dev))

    # -- 8. the GCN on an arxiv-sized graph, and csrmv_op ------------------
    spmm, spmv, csr_launches = gcn_phase(ht, gnn_main, csr_spmm, registry,
                                         bert_forward.counted, dev, bw, f32)
    launches.update(csr_launches)

    # -- 9. WDL-Criteo at the full Criteo vocabulary -----------------------
    torch.cuda.empty_cache()
    embed, ctr_launches = ctr_phase(ht, ctr_main, embed_grad, registry,
                                    bert_forward.counted, dev, bw, f32)
    launches.update(ctr_launches)

    print(json.dumps(kernels_line(kern, attn, ces, attn_bwd, ce_bwd, spmm,
                                  spmv, embed, launches)), flush=True)
    print(json.dumps({"phase": "done",
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
