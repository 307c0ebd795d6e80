#!/usr/bin/env python3
"""On-card smoke test of hetu_tpu_torch, the PyTorch/CUDA port: builds the
CUDA kernels from this checkout, holds each against its plain PyTorch
version on the card, then trains the full-width MLP of
``examples/cnn/models/MLP.py`` (3072-256-256-10, synthetic CIFAR10, batch
128) through ``hetu_tpu_torch.Executor`` and checks that the training went
through the kernels.

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

# Peak rates for the bound, by card name: device-memory bytes/s and
# float32 (non-tensor-core) flop/s, from NVIDIA's data sheets.
CARDS = [("H100 NVL", 3.9e12, 60e12), ("H100 PCIe", 2.0e12, 51e12),
         ("H100", 3.35e12, 67e12), ("H200", 4.8e12, 67e12)]


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_peaks(name):
    for key, bw, flops in CARDS:
        if key in name:
            return bw, flops
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


def main():
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.examples import cnn_main
    from hetu_tpu_torch.kernels import _build, fused_opt, registry

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
    bw, flops = card_peaks(name)
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p) for p in libs.values()])

    # -- 3. kernels against their plain versions ---------------------------
    kern = kernel_phase(fused_opt, dev, bw, flops)
    emit("kernels_checked", shapes=[list(s) for s in MLP_SHAPES + [ODD_SHAPE]],
         tolerance=TOL, **{k: {"max_abs_err": v["max_abs_err"]}
                           for k, v in kern.items()})

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

    replaces = {"fused_sgd": "hetu_tpu/kernels/fused_opt.py:164",
                "fused_adam": "hetu_tpu/kernels/fused_opt.py:95"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": "hetu_tpu_torch/csrc/fused_opt.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": v["max_abs_err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
         "bound_by": v["bound"][1], "library_ms": v["library_ms"],
         "launched_ms": v["launched_ms"],
         "plain_launched_ms": v["plain_launched_ms"],
         "library_launched_ms": v["library_launched_ms"]}
        for k, v in kern.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
