"""Full-batch GNN training on the port (counterpart of
``examples/gnn/run_single.py``): ``dense_model`` (two GCN or GraphSAGE
layers, softmax cross-entropy over the training mask, SGD) through
``Executor.run``, the normalized adjacency fed as an ``ND_Sparse_Array``.

    python -m hetu_tpu_torch.examples.gnn_main [--arch gcn|sage]
        [--graph small|arxiv] [--hidden-size N] [--num-epoch 30]
        [--learning-rate 0.5] [--profile DIR] [--gpu 0 | -1]

``--graph small`` is ``run_single.py``'s graph (``synthetic_graph``: 256
nodes, 16 features, 4 classes; hidden 32); ``--graph arxiv`` is
``arxiv_graph``, at ogbn-arxiv's size and widths (169,343 nodes, 2.5 M
entries, 128 features, 40 classes; hidden 256). 70 % of the nodes train,
the rest are the test set (``run_single.py``'s mask). Features, labels,
mask and adjacency go to the device once; each epoch feeds them.

Prints one JSON line per epoch (training loss, test accuracy, the epoch's
ms on the host clock, which ends in ``torch.cuda.synchronize()``, and the
kernel launches it made), then one summary line: the mean epoch time after
3 warm-up epochs and the launches per epoch. ``--profile DIR`` adds the
device time of one epoch by kernel group from ``torch.profiler`` (kernel
events only) and the device's busy share; the table goes to
``DIR/profile_gnn_<arch>_<graph>.txt``. ``--gpu -1`` runs on the CPU (the
kernels' plain versions; times are the CPU's).
"""
import argparse
import json
import os
import time

import numpy as np
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch.examples import bert_forward
from hetu_tpu_torch.examples.gnn_model import (
    GCN, SageConv, arxiv_graph, convert_to_one_hot, dense_model,
    normalize_adj, synthetic_graph)
from hetu_tpu_torch.graph.node import find_topo_sort

ARCHS = {"gcn": GCN, "sage": SageConv}
HIDDEN = {"small": 32, "arxiv": 256}
WARMUP = 3


def load_graph(graph, seed=0):
    """``(rows, cols, feats, labels, n_classes)`` of a named graph."""
    if graph == "small":
        return (*synthetic_graph(256, 4, seed=seed), 4)
    if graph == "arxiv":
        return (*arxiv_graph(seed=seed), 40)
    raise ValueError(f"graph must be small or arxiv, got {graph!r}")


def _ctx(device):
    device = torch.device(device)
    return ht.cpu(0) if device.type == "cpu" else ht.gpu(device.index or 0)


class Trainer:
    """``dense_model`` on one graph: the executor (targets ``default``, one
    training epoch, and ``grads``, the loss and the parameters' gradients
    without an update) and the feeds, all on ``device``. ``data`` is
    ``load_graph(graph, seed)``, when the caller has it already."""

    def __init__(self, device, arch="gcn", graph="small", hidden=None,
                 lr=0.5, seed=0, kernels=None, data=None):
        ctx = _ctx(device)
        rows, cols, feats, labels, n_classes = data or load_graph(graph, seed)
        n = feats.shape[0]
        self.hidden = hidden or HIDDEN[graph]
        (self.loss, self.y, train_op), (feat_, y_, mask_, adj_) = dense_model(
            feats.shape[1], self.hidden, n_classes, lr, arch=ARCHS[arch])
        self.params = [p for p in find_topo_sort([self.loss])
                       if p.is_placeholder and p.trainable]
        grads = ht.gradients(self.loss, self.params)
        self.ex = ht.Executor({"default": [self.loss, self.y, train_op],
                               "grads": [self.loss] + grads},
                              ctx=ctx, seed=seed, kernels=kernels)
        mask = (np.random.RandomState(1).rand(n) < 0.7).astype(np.float32)
        t0 = time.perf_counter()
        self.adj = ht.sparse_array(normalize_adj(rows, cols, n),
                                   (rows, cols), (n, n), ctx=ctx)
        if ctx.device_type == "gpu":
            torch.cuda.synchronize()
        self.csr_build_ms = (time.perf_counter() - t0) * 1e3
        self.feed = {feat_: ht.array(feats, ctx=ctx),
                     y_: ht.array(convert_to_one_hot(labels, n_classes),
                                  ctx=ctx),
                     mask_: ht.array(mask, ctx=ctx), adj_: self.adj}
        dev = ctx.torch_device()
        self.test = torch.from_numpy(mask == 0).to(dev)
        self.labels = torch.from_numpy(labels).to(dev)
        self.shape = dict(nodes=n, entries=int(rows.size),
                          features=int(feats.shape[1]), hidden=self.hidden,
                          classes=n_classes)

    def epoch(self):
        """One training epoch: (loss, logits) tensors."""
        lv, yv, _ = self.ex.run("default", feed_dict=self.feed)
        return lv.handle, yv.handle

    def gradients(self):
        """The loss and the parameters' gradients at the current state,
        without an update: (loss, {param name: gradient})."""
        out = self.ex.run("grads", feed_dict=self.feed)
        return out[0].handle, {p.name: g.handle
                               for p, g in zip(self.params, out[1:])}

    def test_accuracy(self, logits):
        pred = logits.argmax(1)
        return float((pred[self.test] == self.labels[self.test]).float()
                     .mean())


def run(device, arch="gcn", graph="small", hidden=None, epochs=30, lr=0.5,
        profile_dir=None, profile_iters=5, seed=0, kernels=None, data=None):
    """Yields one dict per epoch, then the summary dict."""
    tr = Trainer(device, arch, graph, hidden, lr, seed, kernels, data)
    times, per_epoch = [], []
    for i in range(epochs):
        t0 = time.perf_counter()
        (loss, logits), launches = bert_forward.counted(tr.epoch)
        times.append(time.perf_counter() - t0)
        per_epoch.append(launches)
        yield {"epoch": i, "train_loss": float(loss),
               "test_acc": tr.test_accuracy(logits), "ms": times[-1] * 1e3,
               "launches": launches}
    timed = times[WARMUP:] or times
    ms = sum(timed) / len(timed) * 1e3
    res = {"summary": "gnn_main", "arch": arch, "graph": graph, **tr.shape,
           "lr": lr, "epochs": epochs, "csr_build_ms": tr.csr_build_ms,
           "epoch_ms": ms, "launches_per_epoch": per_epoch[-1],
           "launches_same_every_epoch": all(c == per_epoch[-1]
                                            for c in per_epoch)}
    if profile_dir is not None:
        os.makedirs(profile_dir, exist_ok=True)
        res["profile"] = bert_forward.profile(
            tr.epoch, ms, profile_iters,
            os.path.join(profile_dir, f"profile_gnn_{arch}_{graph}.txt"))
    yield res


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", choices=sorted(ARCHS), default="gcn")
    parser.add_argument("--graph", choices=("small", "arxiv"),
                        default="small")
    parser.add_argument("--hidden-size", type=int, default=None)
    parser.add_argument("--num-epoch", type=int, default=30)
    parser.add_argument("--learning-rate", type=float, default=0.5)
    parser.add_argument("--profile", default=None, metavar="DIR")
    parser.add_argument("--gpu", type=int, default=0)
    args = parser.parse_args(argv)
    device = "cpu" if args.gpu < 0 else torch.device("cuda", args.gpu)
    if args.profile and args.gpu < 0:
        raise SystemExit("--profile measures the card; it needs --gpu >= 0")
    if args.gpu >= 0:
        print(torch.cuda.get_device_name(args.gpu), flush=True)
    for res in run(device, args.arch, args.graph, args.hidden_size,
                   args.num_epoch, args.learning_rate, args.profile):
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
