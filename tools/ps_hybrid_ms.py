"""Time WDL-Criteo's Hybrid step on the card against a local PS cluster:
the table's init on the servers, and the step's wall time, device time
and PS legs under ASP and BSP, with prefetch on and off.

    python tools/ps_hybrid_ms.py [--vocab 33762577] [--init-servers 1 4]
        [--servers 4] [--steps 30] [--modes asp_prefetch bsp_prefetch
        asp_off bsp_off] [--root DIR]

Each init count and each mode gets a fresh cluster on this machine (the
process is worker 0) and a fresh executor (``ctr_main.Trainer``, seed 0,
batch 128, published widths). For every mode one JSON line: the init's
seconds, the mean wall ms of a step after ``ctr_main.WARMUP`` steps (host
clock, each step's launches read after a synchronise), the device ms of a
step by ``torch.profiler`` over 3 more steps, and the PS legs in ms a
step on the host clock: ``pre_step`` and ``post_step`` (what the step's
own thread waits for), ``pull_rpc`` and ``push_rpc`` (the RPCs, on
whichever thread runs them; a push's includes its wait for the gradient's
copy to the host). ``--root`` runs the tree at DIR instead of this
checkout's. Prints the card's name and power limit first.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

MODES = {"asp_prefetch": dict(bsp=False, prefetch=True),
         "bsp_prefetch": dict(bsp=True, prefetch=True),
         "asp_off": dict(bsp=False, prefetch=False),
         "bsp_off": dict(bsp=True, prefetch=False)}
LEGS = ("pre_step_s", "post_step_s", "pull_rpc_s", "push_rpc_s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=33762577)
    ap.add_argument("--init-servers", type=int, nargs="*", default=[1, 4])
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--modes", nargs="*", default=list(MODES),
                    choices=list(MODES))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from hetu_tpu_torch.examples import ctr_main
    from hetu_tpu_torch.ps import local_cluster as lc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    # a server answers InitTensor once its share of the table is drawn
    os.environ.setdefault("DMLC_PS_RECV_TIMEOUT_MS", "900000")
    dev = torch.device("cuda", 0)
    data = ctr_main.load_data("wdl_criteo", args.vocab)

    def trainer(**ps_options):
        t0 = time.perf_counter()
        tr = ctr_main.Trainer(dev, "wdl_criteo", 128, args.vocab, data=data,
                              comm_mode="Hybrid", ps_options=ps_options)
        return tr, time.perf_counter() - t0

    for n in args.init_servers:
        with lc.local_cluster(n_servers=n):
            tr, init_s = trainer(prefetch=False)
            tr.ex.close()
        print(json.dumps({"init": {"servers": n, "vocab": args.vocab,
                                   "seconds": init_s}}), flush=True)
    for mode in args.modes:
        with lc.local_cluster(n_servers=args.servers):
            tr, init_s = trainer(**MODES[mode])
            with tempfile.TemporaryDirectory() as prof:
                rows = list(ctr_main.run(dev, trainer=tr, steps=args.steps,
                                         profile_dir=prof, profile_iters=3))
            tr.ex.close()
        epoch, summary = rows[0], rows[-1]
        n = args.steps + 3
        print(json.dumps({
            "mode": mode, "servers": args.servers, "vocab": args.vocab,
            "init_s": init_s, "step_ms": summary["step_ms"],
            "device_ms": summary["profile"]["device_ms"],
            "device_busy_share": summary["profile"]["device_busy_share"],
            "groups_us": summary["profile"]["groups_us"],
            "legs_ms": {k[:-2]: summary["ps"][k] / n * 1e3 for k in LEGS},
            "launches_per_step": epoch["launches_per_step"],
            "losses_first_last": [epoch["losses"][0], epoch["losses"][-1]],
            "ps": summary["ps"]}), flush=True)


if __name__ == "__main__":
    main()
