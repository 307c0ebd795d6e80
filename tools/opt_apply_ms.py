#!/usr/bin/env python
"""Time one optimizer apply of the full-width MLP's six parameters
(3072-256-256-10) on a CUDA card, host cost included, for the tree given.

    python tools/opt_apply_ms.py [--root DIR] [--iters 200]

``--root`` is the checkout whose ``hetu_tpu_torch`` is imported (default:
the one this script is in), so that an older tree's apply is timed by the
same code: run it once per tree, the trees in turns.

For SGD (lr 0.1) and Adam (lr 1e-3), one JSON line each:

- ``apply_ms``: what ``OptimizerOp.apply_updates`` calls for the six
  parameters: ``Optimizer.apply_group`` where the tree has it, else
  ``apply_dense`` once per parameter;
- ``per_param_ms``: six ``fused_opt.sgd_step``/``adam_step`` calls, one
  per parameter;
- ``launches``: the kernel launches of one apply and of six per-parameter
  calls.

Each time is the mean over ``--iters`` eager calls between two CUDA
events, after 20 warm-up calls: host time, dispatch and launches
included, as chip_smoke.py's ``step_launched_ms``. Parameters and
gradients are seeded random f32 tensors on the card.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(3072, 256), (256,), (256, 256), (256,), (256, 10), (10,)]


def time_ms(fn, iters, warmup=20):
    import torch
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


def launches_of(registry, fn):
    import torch
    registry.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    return sum(registry.launch_counts().values())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("opt_apply_ms needs a CUDA card")
    from hetu_tpu_torch import optimizer
    from hetu_tpu_torch.kernels import fused_opt, registry
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    for name, opt in (("sgd", optimizer.SGDOptimizer(0.1)),
                      ("adam", optimizer.AdamOptimizer(1e-3))):
        ps = [torch.randn(s, generator=gen, device=dev) * 0.1
              for s in SHAPES]
        gs = [torch.randn(s, generator=gen, device=dev) * 0.01
              for s in SHAPES]
        slots = [opt.slot_init(p) for p in ps]
        lr = opt.lr_tensor(dev)

        if hasattr(opt, "apply_group"):
            def apply():
                opt.apply_group(ps, gs, slots)
        else:
            def apply():
                for p, g, s in zip(ps, gs, slots):
                    opt.apply_dense(p, g, s)

        if name == "sgd":
            def per_param():
                for p, g in zip(ps, gs):
                    fused_opt.sgd_step(opt, p, g, lr)
        else:
            def per_param():
                for p, g, s in zip(ps, gs, slots):
                    fused_opt.adam_step(opt, p, g, s, lr)

        with torch.no_grad():
            print(json.dumps({
                "opt": name, "root": os.path.abspath(args.root),
                "apply_group": hasattr(opt, "apply_group"),
                "apply_ms": time_ms(apply, args.iters),
                "per_param_ms": time_ms(per_param, args.iters),
                "launches": {"apply": launches_of(registry, apply),
                             "per_param": launches_of(registry, per_param)},
                "iters": args.iters}), flush=True)


if __name__ == "__main__":
    main()
