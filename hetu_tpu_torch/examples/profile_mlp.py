"""Where the time of one training step of the full-width MLP goes on the
card: the same configuration as chip_smoke.py (3072-256-256-10, synthetic
CIFAR10, batch 128, SGD at lr 0.1 and Adam at lr 1e-3), profiled with
``torch.profiler`` over a steady window.

    python -m hetu_tpu_torch.examples.profile_mlp [--steps 50] [--out DIR]
        [--dp off int8 fp8]

Prints one JSON line per optimizer: the step time without the profiler,
the device time per step summed over kernels, the device's busy share
(device time / step time), and the kernels by device time per step
(kernel events only; the aten rows that launched them are not counted
twice). The
full ``key_averages`` tables go to ``DIR/profile_mlp_<opt>.txt``. Needs a
CUDA card. ``--dp MODE ...`` profiles the data-parallel step as well
(``comm_mode="AllReduce"``), once per ``comm_quant`` mode, at world size 1
over NCCL with an explicit one-rank dp mesh, so that the quantized
all-reduce runs on one card.
"""
import argparse
import json
import os
import shutil
import tempfile
import time

import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.examples import cnn_main

WARMUP = 20


def _step_ms(ex, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        ex.run("train")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def profile(data, opt, lr, steps, out_dir, tag="", **ex_kw):
    loss, _, _, train_op = cnn_main.build("mlp", "CIFAR10", 128, opt, lr,
                                          data=data)
    ex = ht.Executor({"train": [loss, train_op]}, seed=0, **ex_kw)
    _step_ms(ex, WARMUP)
    step_ms = _step_ms(ex, steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _step_ms(ex, steps)
    table = prof.key_averages()
    # device-side events only: an aten op's row repeats its kernels' time
    kernels = sorted(((e.key, e.self_device_time_total / steps, e.count / steps)
                      for e in table
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    device_us = sum(us for _, us, _ in kernels)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_mlp_{opt}{tag}.txt"),
              "w") as f:
        f.write(table.table(sort_by="self_device_time_total", row_limit=40))
        f.write("\n")
        f.write(table.table(sort_by="self_cpu_time_total", row_limit=40))
    return {"opt": opt, "dp": tag[1:] or None, "steps": steps,
            "step_ms": step_ms,
            "device_ms_per_step": device_us / 1e3,
            "device_busy_share": device_us / 1e3 / step_ms,
            "kernels_us_per_step": [
                {"name": name[:80], "us": us, "calls": calls}
                for name, us, calls in kernels[:12]]}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--out", default="profile_mlp_out")
    parser.add_argument("--dp", nargs="*", default=[],
                        choices=["off", "int8", "fp8"],
                        help="also the data-parallel step, per comm_quant")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mlp needs a CUDA card")
    print(torch.cuda.get_device_name(0), flush=True)
    data = cnn_main.load_dataset("CIFAR10")
    for opt, lr in (("sgd", 0.1), ("adam", 1e-3)):
        print(json.dumps(profile(data, opt, lr, args.steps, args.out)),
              flush=True)
    if not args.dp:
        return
    from hetu_tpu_torch.parallel import multihost
    store = tempfile.mkdtemp(prefix="profile_mlp_dp_")
    try:
        multihost.initialize("file://" + os.path.join(store, "rendezvous"),
                             world_size=1, rank=0,
                             device=torch.device("cuda", 0))
        mesh = multihost.global_mesh(1)
        for opt, lr in (("sgd", 0.1), ("adam", 1e-3)):
            for mode in args.dp:
                print(json.dumps(profile(
                    data, opt, lr, args.steps, args.out, tag="_" + mode,
                    comm_mode="AllReduce", mesh=mesh, comm_quant=mode)),
                    flush=True)
    finally:
        multihost.shutdown()
        shutil.rmtree(store, ignore_errors=True)


if __name__ == "__main__":
    main()
