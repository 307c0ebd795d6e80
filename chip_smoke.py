#!/usr/bin/env python3
"""On-card smoke test of hetu_tpu_torch, the PyTorch/CUDA port: builds the
CUDA kernels from this checkout and holds each against its plain PyTorch
version on the card; trains the full-width MLP of
``examples/cnn/models/MLP.py`` (3072-256-256-10, synthetic CIFAR10, batch
128) through ``hetu_tpu_torch.Executor``; then runs the BERT-base forward
(``hetu_tpu_torch.models.bert``, random weights from a seed): the
pretraining loss without gradient on a synthetic phase-1 batch (32 x 128)
and the classifier on 8 requests. Each path is checked to have gone
through its kernels.

    python3 chip_smoke.py

Needs one CUDA card (``cuda:0``) and ``nvcc``; exits non-zero, printing no
result, when either is missing or any phase fails. Prints one JSON line per
phase, then the ``kernels`` JSON line, the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""
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
# Kernel vs plain version: o in bf16 may differ by one bf16 rounding (the
# same f32 sums in another order); f32 by summation order alone; lse, the
# target logit and the NLL are f32 sums over 128 keys or 30k-50k logits.
TOL.update({
    "flash_attention_fwd": {"o_bf16": dict(rtol=2e-2, atol=2e-2),
                            "o_f32": dict(rtol=2e-5, atol=2e-5),
                            "lse": dict(rtol=0, atol=1e-3)},
    "fused_linear_nll_fwd": {"lse_tl_nll": dict(rtol=0, atol=1e-3)}})
# The BERT-base forward with the kernels against kernels="off" (the plain
# versions on the card): losses rel 5e-3; classifier logits (|x| < ~1)
# atol 2e-2, for bf16 activations rounded at other places over 12 layers.
BERT_REL, LOGITS_ATOL = 5e-3, 2e-2
BERT_BATCH, BERT_SEQ, BERT_PRED, BERT_REQUESTS, BERT_ITERS = 32, 128, 20, 8, 20

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


def attention_phase(fa, dev, bw, f32, bf16):
    """flash_attention_fwd against its plain version (and, in f32, against
    unfused attention) at ATTN_CASES; timed at each case."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = TOL["flash_attention_fwd"]
    cases = []
    for b, h, s, d, dtype, causal, pad in ATTN_CASES:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        kb = None
        if pad:   # key padding from lengths drawn in [S/2, S], as BERT's mask
            lengths = torch.randint(s // 2, s + 1, (b,), generator=gen,
                                    device=dev)
            kb = torch.where(torch.arange(s, device=dev)[None, :]
                             < lengths[:, None], 0.0, -1e30)
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


def kernels_line(kern, attn, ces, launches):
    """The ``kernels`` JSON object: one entry per ported kernel."""
    replaces = {"fused_sgd": "hetu_tpu/kernels/fused_opt.py:164",
                "fused_adam": "hetu_tpu/kernels/fused_opt.py:95",
                "flash_attention_fwd": "hetu_tpu/kernels/flash_attention.py:111",
                "fused_linear_nll_fwd": "hetu_tpu/kernels/fused_ce.py:223"}
    sources = {"fused_sgd": "fused_opt.cu", "fused_adam": "fused_opt.cu",
               "flash_attention_fwd": "flash_attention.cu",
               "fused_linear_nll_fwd": "fused_ce.cu"}
    # the new kernels' entries are timed at the main path's shapes (their
    # first cases); max_abs_err is the largest over all their cases
    kern = dict(kern)
    kern["flash_attention_fwd"] = dict(attn[0], max_abs_err=max(
        max(c["o_max_abs_err"], c["lse_max_abs_err"]) for c in attn))
    kern["fused_linear_nll_fwd"] = dict(ces[0], max_abs_err=max(
        c["max_abs_err"] for c in ces))
    return {"kernels": [dict(
        name=k, route="cuda", source="hetu_tpu_torch/csrc/" + sources[k],
        replaces=replaces[k], launches=launches[k],
        max_abs_err=v["max_abs_err"], tolerance=TOL[k], ms=v["ms"],
        plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
        bound_by=v["bound"][1], library_ms=v["library_ms"],
        **{f: v[f] for f in ("launched_ms", "plain_launched_ms",
                             "library_launched_ms", "shape") if f in v})
        for k, v in kern.items()]}


def main():
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.examples import bert_forward, cnn_main
    from hetu_tpu_torch.kernels import (_build, flash_attention, fused_ce,
                                        fused_opt, registry)
    from hetu_tpu_torch.models import bert

    # -- 1. device --------------------------------------------------------
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
    launches.update(bert_phase(bert, bert_forward, registry, dev))

    print(json.dumps(kernels_line(kern, attn, ces, launches)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
