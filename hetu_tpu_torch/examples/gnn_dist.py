"""Distributed 1.5D GCN training on the port (counterpart of
``examples/gnn/run_dist.py``; reference ``examples/gnn/run_dist.py:17-49``
and ``tests/test_DistGCN``'s mpirun -np 8 --replication 2).

One process per rank, started by the port's runner; the ranks form a
``(world / replication, replication)`` grid (``multihost.process_grid``)
and ``parallel.distgcn`` runs the two-layer GCN over it: each rank holds
its block of the adjacency and of the features, the logits of its row
shard, and the two weights. The loss is the mean over all nodes of the
masked cross-entropy, each rank adding its shard's part; the weights'
gradients are the grid's (``distgcn.gcn_forward``), and the SGD step is a
plain tensor update on every rank, as in the reference.

    python -m hetu_tpu_torch.runner -w 8 python -m \\
        hetu_tpu_torch.examples.gnn_dist --replication 2 [--gpu -1]
    python -m hetu_tpu_torch.examples.gnn_dist --replication 1   # one rank

``--gpu -1`` runs the ranks on the CPU over gloo; otherwise each rank takes
the card ``LOCAL_RANK`` (without the runner: card ``--gpu``) and joins
over NCCL, one card per rank. Without the runner the script is a world of
one rank. Rank 0 prints one JSON line
per epoch (the loss, the test accuracy over the nodes outside the mask,
the epoch's ms on the host clock and its kernel launches), then a summary.
"""
import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from hetu_tpu_torch.examples import bert_forward
from hetu_tpu_torch.examples.gnn_model import (
    convert_to_one_hot, normalize_adj, synthetic_graph)
from hetu_tpu_torch.kernels import registry
from hetu_tpu_torch.parallel import distgcn, multihost


def init_weights(feat_dim, hidden, classes, seed=0):
    """``run_dist.py``'s weights: normal draws of ``RandomState(seed)``
    times 0.2, float32."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(feat_dim, hidden) * 0.2).astype(np.float32),
            (rng.randn(hidden, classes) * 0.2).astype(np.float32)]


def train_mask(n):
    """``run_dist.py``'s training mask: 70 % of the nodes."""
    return (np.random.RandomState(1).rand(n) < 0.7).astype(np.float32)


class Trainer:
    """This rank's part of the 1.5D GCN on ``grid``, on the device of the
    process group, from :func:`init_weights`.

    ``data``: ``(rows, cols, feats, labels, n_classes)`` of a graph of
    ``n`` nodes (``n`` divisible by the grid's size). ``kernels`` is the
    dispatch mode of the local block products (``registry.active``)."""

    def __init__(self, grid, data, hidden=32, lr=0.5, kernels=None):
        rows, cols, feats, labels, n_classes = data
        n = feats.shape[0]
        self.grid, self.n, self.lr = grid, n, lr
        self.kernels = registry.resolve_mode(kernels)
        self.device = multihost.device()
        vals = normalize_adj(rows, cols, n)
        t0 = time.perf_counter()
        self.adj, self.h = distgcn.shard_gcn_inputs(
            grid, rows, cols, vals, feats, n, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.csr_build_ms = (time.perf_counter() - t0) * 1e3
        nr = n // grid.gr
        mine = slice(grid.i * nr, (grid.i + 1) * nr)
        mask = train_mask(n)[mine]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.onehot = put(convert_to_one_hot(labels, n_classes)[mine])
        self.mask = put(mask)
        self.test = put(mask == 0)
        self.labels = put(labels[mine])
        self.ws = [put(w).requires_grad_()
                   for w in init_weights(feats.shape[1], hidden, n_classes)]
        self.shape = dict(nodes=n, entries=int(np.asarray(rows).size),
                          features=int(feats.shape[1]), hidden=hidden,
                          classes=n_classes, grid=[grid.gr, grid.gc],
                          block_entries=self.adj.csr.nnz)

    def _col_sum(self, t):
        t = t.detach().clone()
        multihost.collective(torch.distributed.all_reduce, t,
                             group=self.grid.col_group)
        return t

    def gradients(self):
        """``(loss, logits, grads)`` at the current weights, without an
        update: the whole loss (the column group's sum of the ranks'
        shares), this rank's logits (its row shard) and the weights'
        gradients over the grid."""
        with registry.active(self.kernels):
            logits = distgcn.gcn_forward(self.grid, self.adj, self.h,
                                         self.ws, self.n)
            logp = torch.log_softmax(logits, dim=1)
            per_node = -(self.onehot * logp).sum(1)
            share = (per_node * self.mask).sum() / self.n
            grads = torch.autograd.grad(share, self.ws)
        return self._col_sum(share), logits.detach(), list(grads)

    def step(self):
        """One training epoch: ``(loss, logits)`` before the update."""
        loss, logits, grads = self.gradients()
        with torch.no_grad():
            for w, g in zip(self.ws, grads):
                w -= self.lr * g
        return loss, logits

    def test_accuracy(self, logits):
        """Accuracy over the nodes outside the training mask, the whole
        graph's (summed over the column group)."""
        hits = (logits.argmax(1) == self.labels) & self.test
        counts = self._col_sum(torch.stack([hits.sum(), self.test.sum()])
                               .double())
        return float(counts[0] / counts[1])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(grid, data, epochs=30, hidden=32, lr=0.5, trainer=None):
    """Yields one dict per epoch, then the summary dict. ``trainer`` is a
    :class:`Trainer` to use instead of a new one."""
    tr = trainer or Trainer(grid, data, hidden, lr)
    times, per_epoch = [], []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        (loss, logits), launches = bert_forward.counted(tr.step)
        _sync(tr.device)
        times.append(time.perf_counter() - t0)
        per_epoch.append(launches)
        yield {"epoch": epoch, "loss": float(loss),
               "test_acc": tr.test_accuracy(logits), "ms": times[-1] * 1e3,
               "launches": launches}
    timed = times[3:] or times
    yield {"summary": "gnn_dist", **tr.shape, "lr": tr.lr, "epochs": epochs,
           "csr_build_ms": tr.csr_build_ms,
           "epoch_ms": sum(timed) / len(timed) * 1e3,
           "launches_per_epoch": per_epoch[-1],
           "launches_same_every_epoch": all(c == per_epoch[-1]
                                            for c in per_epoch)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replication", type=int, default=2)
    ap.add_argument("--num-epoch", type=int, default=30)
    ap.add_argument("--hidden-size", type=int, default=32)
    ap.add_argument("--nodes", type=int, default=256)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--learning-rate", type=float, default=0.5)
    ap.add_argument("--gpu", type=int, default=0,
                    help="-1: the CPU over gloo; else this card (under the "
                         "runner: the card LOCAL_RANK)")
    args = ap.parse_args(argv)

    device = torch.device("cpu") if args.gpu < 0 else torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK") or args.gpu))
    store = None
    if not multihost.initialize(device=device):
        store = tempfile.mkdtemp(prefix="gnn_dist_")
        multihost.initialize("file://" + os.path.join(store, "store"), 1, 0,
                             device=device)
    try:
        n_dev, r = multihost.process_count(), args.replication
        if n_dev % r:
            raise SystemExit(f"--replication {r} does not divide the "
                             f"{n_dev} ranks")
        gr = n_dev // r
        grid = multihost.process_grid(gr, r)
        dev = multihost.device()
        rank0 = multihost.process_index() == 0
        if rank0:
            print(json.dumps({"grid": {"gr": gr, "gc": r},
                              "device": str(dev)}), flush=True)
        n = args.nodes - args.nodes % (gr * r)   # divisible by both axes
        rows, cols, feats, labels = synthetic_graph(n, args.classes)
        data = (rows, cols, feats, labels, args.classes)
        for res in run(grid, data, args.num_epoch, args.hidden_size,
                       args.learning_rate):
            if rank0:
                print(json.dumps(res), flush=True)
    finally:
        multihost.shutdown()
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)


if __name__ == "__main__":
    main()
