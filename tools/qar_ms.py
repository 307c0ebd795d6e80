#!/usr/bin/env python
"""Time one quantized gradient all-reduce of the full-width MLP's three
quantized weights (3072x256, 256x256, 256x10) on a CUDA card, host cost
included, for the tree given.

    python tools/qar_ms.py [--root DIR] [--iters 200]

``--root`` is the checkout whose ``hetu_tpu_torch`` is imported (default:
the one this script is in), so that an older tree's all-reduce is timed by
the same code: run it once per tree, the trees in turns.

The all-reduce is made as that tree's executor makes it in a
data-parallel step: one ``comm_quant.quantized_allreduce_group`` over the
three gradients through one persistent ``QarGroup`` where the tree has
them, else ``quantized_allreduce`` once per gradient; error feedback on
(the policy's default), each call's new residuals fed to the next. It runs
over a one-rank NCCL process group (a file store in a temporary
directory), block 256, for int8 and fp8, one JSON line each:

- ``allreduce_ms``: the mean over ``--iters`` eager calls between two CUDA
  events, after 20 warm-up calls: host time, dispatch, collectives and
  launches included;
- ``device_us``: device time a call, summed over its device events
  (``torch.profiler`` over 20 calls), ``device_events`` their count a
  call, and ``by_kernel`` each event name's µs a call;
- ``launches``: the port's kernel launches a call (registry counts).

Gradients are seeded random f32 tensors on the card.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(3072, 256), (256, 256), (256, 10)]
PROFILED = 20


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


def device_events(fn):
    """{event name: device µs a call}, over PROFILED calls."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    out, count = {}, 0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            out[e.key[:80]] = e.self_device_time_total / PROFILED
            count += e.count
    return out, count / PROFILED


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("qar_ms needs a CUDA card")
    from hetu_tpu_torch import comm_quant as cq
    from hetu_tpu_torch.kernels import registry
    from hetu_tpu_torch.parallel import multihost
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    store = tempfile.mkdtemp(prefix="qar_ms_")
    grouped = hasattr(cq, "quantized_allreduce_group")
    try:
        multihost.initialize("file://" + os.path.join(store, "rendezvous"),
                             world_size=1, rank=0, device=dev)
        for mode in ("int8", "fp8"):
            gen = torch.Generator(device=dev).manual_seed(0)
            xs = [torch.randn(s, generator=gen, device=dev) * 0.01
                  for s in SHAPES]
            pol = cq.QuantPolicy(mode)
            if grouped:
                state = cq.QarGroup([x.numel() for x in xs], 1, pol, dev)
                resid = [state.residual_views()]

                def allreduce():
                    _, resid[0] = cq.quantized_allreduce_group(
                        xs, resid[0], None, pol, state)
            else:
                resid = [torch.zeros(cq.shard_size(x.numel(), 1, pol.block),
                                     device=dev) for x in xs]

                def allreduce():
                    for i, x in enumerate(xs):
                        _, resid[i] = cq.quantized_allreduce(
                            x, resid[i], None, pol)

            with torch.no_grad():
                ms = time_ms(allreduce, args.iters)
                by_kernel, events = device_events(allreduce)
                registry.reset_launch_counts()
                allreduce()
                torch.cuda.synchronize()
                launches = {k: v for k, v in registry.launch_counts().items()
                            if v}
            print(json.dumps({
                "mode": mode, "root": os.path.abspath(args.root),
                "grouped": grouped, "allreduce_ms": ms,
                "device_us": sum(by_kernel.values()),
                "device_events": events, "by_kernel": by_kernel,
                "launches": launches, "iters": args.iters}), flush=True)
    finally:
        multihost.shutdown()
        shutil.rmtree(store, ignore_errors=True)


if __name__ == "__main__":
    main()
