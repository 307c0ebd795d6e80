#!/usr/bin/env python
"""Reference numbers that the PyTorch/CUDA port (hetu_tpu_torch) is held
against, computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/port_reference.py mlp-parity
    JAX_PLATFORMS=cpu python tools/port_reference.py smoke-config

``mlp-parity``: the narrow MLP of tests/test_torch_mlp.py (32-64-64-10,
batch 128) in both packages from the reference's saved initial state, 10
steps per optimizer; prints the max relative per-step loss difference and
the max absolute difference of the parameters and optimizer slots.

``smoke-config``: the training configuration of chip_smoke.py — the
full-width MLP of examples/cnn (3072-256-256-10) on synthetic CIFAR10,
batch 128, seed 0, 200 SGD steps at lr 0.1 and a fresh executor for 50
Adam steps at lr 1e-3 — run by ``hetu_tpu.Executor`` on the CPU; prints
the mean loss of the first and the last 10 steps. chip_smoke.py's loss
thresholds come from here. It builds the 614 MB dataset in host memory.
"""
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]


def mlp_parity():
    import hetu_tpu as jt
    import hetu_tpu_torch as pt
    import test_torch_mlp as T

    for opt in sorted(T.OPTS):
        jex, pex = T.build(jt, opt, jt.cpu(0)), T.build(pt, opt, pt.cpu(0))
        with tempfile.TemporaryDirectory() as d:
            jex.save(d)
            pex.load(d)
        want, got = T._losses(jex), T._losses(pex)
        jp, js = T._state(jex, T._jax_np)
        pp, ps = T._state(pex, T._torch_np)
        param = max(float(np.max(np.abs(pp[k] - jp[k]))) for k in jp)
        slot = max((float(np.max(np.abs(T._torch_np(g[k]) - T._jax_np(w[k]))))
                    for g, w in zip(ps[0], js[0]) for k in g), default=0.0)
        print(f"{opt:12s} loss max rel {np.max(np.abs(got - want) / want):.2e}"
              f"  params max abs {param:.2e}  slots max abs {slot:.2e}")


def smoke_config():
    import hetu_tpu as ht
    sys.path.insert(0, os.path.join(REPO, "examples", "cnn"))
    from models import mlp

    tx, ty, vx, vy = ht.data.normalize_cifar(num_class=10)
    tx, vx = tx.reshape(tx.shape[0], -1), vx.reshape(vx.shape[0], -1)
    for name, opt, steps in (("sgd", ht.optim.SGDOptimizer(0.1), 200),
                             ("adam", ht.optim.AdamOptimizer(1e-3), 50)):
        x = ht.dataloader_op([ht.Dataloader(tx, 128, "train")])
        y_ = ht.dataloader_op([ht.Dataloader(ty, 128, "train")])
        loss, _ = mlp(x, y_, 10, 3072)
        ex = ht.Executor({"train": [loss, opt.minimize(loss)]},
                         ctx=ht.cpu(0), seed=0)
        losses = [float(ex.run("train")[0].asnumpy()) for _ in range(steps)]
        print(f"{name}: {steps} steps, mean loss of the first 10 "
              f"{np.mean(losses[:10]):.4g}, of the last 10 "
              f"{np.mean(losses[-10:]):.4g}")


if __name__ == "__main__":
    modes = {"mlp-parity": mlp_parity, "smoke-config": smoke_config}
    if len(sys.argv) != 2 or sys.argv[1] not in modes:
        sys.exit(f"usage: {sys.argv[0]} {{{'|'.join(modes)}}}")
    modes[sys.argv[1]]()
