#!/usr/bin/env python
"""Time one embedding gradient of a batch on a CUDA card, host cost
included, for the tree given.

    python tools/embed_grad_ms.py [--root DIR] [--iters 100]

``--root`` is the checkout whose ``hetu_tpu_torch`` is imported (default:
the one this script is in), so that an older tree's gradient is timed by
the same code: run it once per tree, the trees in turns.

Cases, one JSON line each:

- ``ctr``: WDL-Criteo's step, the first batch's 128 x 26 ids over the full
  Criteo vocabulary (33,762,577 rows), d = 128, through
  ``embed_grad.embed_grad_rows`` (the compact form: the sort and its
  bookkeeping, the segment sum), and ``ctr_single_id``: one id 3,328
  times (one long run);
- ``ctr_dense``: the same ids through ``embed_grad.embed_grad_dense``, the
  form the WDL step's backward runs (the sort, the zeroed 17.29 GB table,
  the segment sum written into it);
- ``bert_p1_token``, ``bert_p1_type``, ``bert_p2_token``,
  ``bert_p2_type``: BERT-base's two lookups (the token ids into 30,522
  rows, the type ids into 2) of its synthetic phase-1 (32 x 128) and
  phase-2 (32 x 512) batches, d = 768, through
  ``embed_grad.embed_grad_dense`` (the table gradient), and beside it
  ``index_put_ms``: PyTorch's backward of ``table[ids]``, ``index_put_``
  with accumulate into a zeroed table (``indexing_backward``).

Fields: ``ms``, the mean over ``--iters`` eager calls between two CUDA
events after 10 warm-up calls (host time, dispatch and launches
included); ``device_us``, the device time a call summed over its device
events (``torch.profiler`` over 20 calls), ``device_events`` their count a
call and ``by_kernel`` each event name's µs a call, ``fill_us`` the part
of ``device_us`` spent in fills (``FillFunctor``: the zeroed output),
``past_fill_us`` the rest; ``launches``, the
port's kernel launches a call (registry counts). Row gradients are seeded
random f32 tensors on the card.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILED = 20
CTR_VOCAB, CTR_BATCH, CTR_DIM = 33762577, 128, 128


def time_ms(fn, iters, warmup=10):
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
    """({event name: device µs a call}, events a call), over PROFILED
    calls."""
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


def measure(fn, iters, registry=None):
    import torch
    res = {"ms": time_ms(fn, iters)}
    by_kernel, events = device_events(fn)
    fill = sum(us for nm, us in by_kernel.items() if "FillFunctor" in nm)
    res.update(device_us=sum(by_kernel.values()), fill_us=fill,
               past_fill_us=sum(by_kernel.values()) - fill,
               device_events=events, by_kernel=by_kernel)
    if registry is not None:
        registry.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        res["launches"] = sum(registry.launch_counts().values())
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("embed_grad_ms needs a CUDA card")
    from hetu_tpu_torch.examples import bert_forward, ctr_main
    from hetu_tpu_torch.kernels import embed_grad, registry
    from hetu_tpu_torch.models import bert
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)

    data = ctr_main.load_data("wdl_criteo", CTR_VOCAB)
    ids = torch.from_numpy(data[0][1][:CTR_BATCH]).to(dev)
    vec = torch.randn(tuple(ids.shape) + (CTR_DIM,), generator=gen,
                      device=dev)
    ctr_shape = (CTR_VOCAB, CTR_DIM)
    for case, fn in (
            ("ctr", lambda: embed_grad.embed_grad_rows(vec, ids, CTR_VOCAB)),
            ("ctr_single_id", lambda: embed_grad.embed_grad_rows(
                vec, torch.full_like(ids, 4321.0), CTR_VOCAB)),
            ("ctr_dense", lambda: embed_grad.embed_grad_dense(
                vec, ids, ctr_shape))):
        res = measure(fn, args.iters, registry)
        print(json.dumps({"case": case, "root": args.root,
                          "shape": [ids.numel(), CTR_DIM], **res}),
              flush=True)

    cfg = bert.BERT_BASE
    for phase, seq, pred in (("p1", 128, 20), ("p2", 512, 76)):
        batch = bert_forward.phase1_batch(cfg, 32, seq, pred, seed=0,
                                          device=dev)
        for what, key, vocab in (("token", "input_ids", cfg.vocab_size),
                                 ("type", "segment_ids",
                                  cfg.type_vocab_size)):
            ids = batch[key]
            g = torch.randn(tuple(ids.shape) + (cfg.d_model,), generator=gen,
                            device=dev)
            shape = (vocab, cfg.d_model)
            flat, long_ids = g.reshape(-1, cfg.d_model), ids.reshape(-1).long()
            res = measure(lambda: embed_grad.embed_grad_dense(
                g, ids, shape), args.iters, registry)
            base = measure(lambda: torch.zeros(
                shape, device=dev).index_put_((long_ids,), flat,
                                              accumulate=True), args.iters)
            res.update({f"index_put_{k}": v for k, v in base.items()})
            print(json.dumps({
                "case": f"bert_{phase}_{what}", "root": args.root,
                "shape": [ids.numel(), cfg.d_model], "vocab": vocab,
                "longest": int(torch.bincount(long_ids).max()), **res}),
                flush=True)


if __name__ == "__main__":
    main()
