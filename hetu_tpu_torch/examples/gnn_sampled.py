"""Sampled-subgraph GCN over a live parameter server and the embedding
cache, on the port (counterpart of ``examples/gnn/run_sampled.py``, the
reference's GraphMix-style GNN training mode):

- the graph lives on the host; each step a worker samples a fixed-size
  1-hop subgraph (``SubgraphSampler``),
- the node embeddings are a table on the PS behind ``CacheSparseTable``
  (LRU/LFU/LFUOpt, bounded staleness): each batch pulls only its sampled
  rows, and their gradients push back through the cache,
- the sampler feeds the executor through ``GNNDataLoaderOp``'s double
  buffering: batch N+1's cache pull is issued while step N trains,
- the dense GCN weights train on the device with Adam (``fused_adam``,
  one launch a step); the embedding rows arrive as a placeholder and leave
  as an explicit gradient target (``ht.gradients``).

Standalone (starts a local scheduler and server, and is its worker):
  python -m hetu_tpu_torch.examples.gnn_sampled --num-epoch 10 [--cpu]
Under ``python -m hetu_tpu_torch.runner -c cluster.yml`` (``DMLC_*`` set):
the same command, one process per worker.
"""
import argparse
import os
import time

import numpy as np

from hetu_tpu_torch.kernels import registry


# ---------------------------------------------------------------------------
# synthetic partitioned graph (no-egress stand-in for Reddit/OGB: a planted
# 4-community SBM whose labels are recoverable from graph structure)
# ---------------------------------------------------------------------------

def make_graph(n_nodes, n_classes, avg_degree, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, n_nodes)
    p_in = avg_degree / (n_nodes / n_classes) * 0.8
    p_out = avg_degree / n_nodes * 0.2
    adj = [[] for _ in range(n_nodes)]
    for u in range(n_nodes):
        same = np.where(labels == labels[u])[0]
        diff = np.where(labels != labels[u])[0]
        nbr = np.concatenate([
            same[rng.rand(len(same)) < p_in],
            diff[rng.rand(len(diff)) < p_out]])
        for v in nbr:
            if v != u:
                adj[u].append(int(v))
                adj[int(v)].append(u)
    return [np.unique(a) for a in adj], labels


class SubgraphSampler:
    """Fixed-shape 1-hop sampler: NSEED seed nodes + neighbors, capped at
    NMAX total, zero-padded. Padding is inert: padded adjacency rows/cols
    are all-zero (no self-loop), so padded embedding rows get exactly zero
    gradient and their (deduped) pushes are no-ops."""

    def __init__(self, adj, labels, nseed, nmax, fanout, seed=0):
        self.adj, self.labels = adj, labels
        self.nseed, self.nmax, self.fanout = nseed, nmax, fanout
        self.rng = np.random.RandomState(seed)
        self.order = self.rng.permutation(len(adj))
        self.cursor = 0

    def next(self):
        n = len(self.adj)
        if self.cursor + self.nseed > n:
            self.order = self.rng.permutation(n)
            self.cursor = 0
        seeds = self.order[self.cursor:self.cursor + self.nseed]
        self.cursor += self.nseed
        nodes = list(seeds)
        seen = set(seeds.tolist())
        for s in seeds:
            nb = self.adj[s]
            if len(nb) > self.fanout:
                nb = self.rng.choice(nb, self.fanout, replace=False)
            for v in nb:
                if v not in seen and len(nodes) < self.nmax:
                    seen.add(int(v))
                    nodes.append(int(v))
        ids = np.zeros(self.nmax, np.uint64)
        ids[:len(nodes)] = nodes
        pos = {v: i for i, v in enumerate(nodes)}
        a = np.zeros((self.nmax, self.nmax), np.float32)
        a[:len(nodes), :len(nodes)] = np.eye(len(nodes))  # self-loops
        for i, u in enumerate(nodes):
            for v in self.adj[u]:
                j = pos.get(int(v))
                if j is not None:
                    a[i, j] = 1.0
        deg = np.maximum(a.sum(1), 1.0)
        dinv = 1.0 / np.sqrt(deg)
        norm_adj = (a * dinv[:, None]) * dinv[None, :]    # D^-1/2 A D^-1/2
        return {"adj": norm_adj, "ids": ids,
                "y": self.labels[seeds].astype(np.float32)}


class BatchFeed:
    """Two-slot pipeline rotated in lockstep with ``GNNDataLoaderOp.step``:
    the batch being BUILT becomes the op's _next (its cache pull issued
    asynchronously now), the previous _next becomes the current batch."""

    def __init__(self, sampler, table, hidden):
        self.sampler, self.table, self.hidden = sampler, table, hidden
        self.cur = None
        self._next = None

    def handler(self, _graph):
        b = self.sampler.next()
        b["rows"] = np.zeros((self.sampler.nmax, self.hidden), np.float32)
        b["wait"] = self.table.embedding_lookup(b["ids"], b["rows"])
        self.cur, self._next = self._next, b
        return b["adj"]


# ---------------------------------------------------------------------------
# training worker
# ---------------------------------------------------------------------------

def device_ctx(cpu):
    """``ht.cpu(0)`` with ``cpu``, else the card ``LOCAL_RANK``."""
    import hetu_tpu_torch as ht
    if cpu:
        return ht.cpu(0)
    return ht.gpu(int(os.environ.get("LOCAL_RANK") or 0))


def build(args, adj_in, ctx, seed, kernels=None):
    """The model on the graph batch ``adj_in`` (a ``GNNDataLoaderOp``) and
    its executor: ``(executor, (x, y_), train target)``, the target being
    ``[loss, grad_x, pred, train_op]``."""
    import hetu_tpu_torch as ht
    from hetu_tpu_torch.graph.gradients import gradients as ht_gradients

    x = ht.placeholder_op(name="x")
    y_ = ht.placeholder_op(name="y")
    w1 = ht.init.xavier_uniform((args.hidden, args.hidden), name="w1")
    w2 = ht.init.xavier_uniform((args.hidden, args.classes), name="w2")
    h = ht.relu_op(ht.matmul_op(adj_in, ht.matmul_op(x, w1)))
    logits = ht.slice_op(ht.matmul_op(adj_in, ht.matmul_op(h, w2)),
                         (0, 0), (args.nseed, args.classes))
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(logits, ht.one_hot_op(y_, args.classes)),
        [0])
    (grad_x,) = ht_gradients(loss, [x])
    opt = ht.optim.AdamOptimizer(learning_rate=args.learning_rate)
    train_op = opt.minimize(loss, var_list=[w1, w2])
    pred = ht.softmax_op(logits)
    target = [loss, grad_x, pred, train_op]
    ex = ht.Executor({"train": target}, ctx=ctx, seed=seed, kernels=kernels)
    return ex, (x, y_), target


def train(client, rank, args, init=None, stats=None):
    """Train on this worker; returns the per-epoch ``(loss, accuracy)``.
    ``init``: ``{parameter name: array}`` to start the dense weights from
    (``interop.params_from_numpy``); ``stats``, a dict, receives each
    step's loss (``losses``), kernel launches (``launches``) and host ms
    (``ms``)."""
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.cstable import CacheSparseTable
    from hetu_tpu_torch.dataloader import GNNDataLoaderOp

    adj, labels = make_graph(args.nodes, args.classes, args.degree)
    sampler = SubgraphSampler(adj, labels, args.nseed, args.nmax,
                              args.fanout, seed=100 + rank)

    client.InitTensor(args.table_id, sparse=2, length=args.nodes,
                      width=args.hidden, init_type="normal", init_a=0.0,
                      init_b=0.1)
    table = CacheSparseTable(args.cache_limit, args.nodes, args.hidden,
                             args.table_id, policy=args.cache_policy,
                             bound=args.bound)
    if args.cache_perf:
        table.perf_enabled(True)
    feed = BatchFeed(sampler, table, args.hidden)

    adj_in = GNNDataLoaderOp(feed.handler)
    ex, (x, y_), _ = build(args, adj_in, device_ctx(args.cpu), rank)
    if init is not None:
        interop.params_from_numpy(ex, init)
    if stats is not None:
        for k in ("losses", "launches", "ms"):
            stats.setdefault(k, [])

    GNNDataLoaderOp.step(None)   # build batch 1 into _next
    GNNDataLoaderOp.step(None)   # batch 1 -> current; batch 2 building
    # per-epoch step count splits the graph across the LIVE cluster size
    nworld = max(client.nrank, 1)
    steps = max(1, args.nodes // (args.nseed * nworld))
    history = []
    try:
        for epoch in range(args.num_epoch):
            tot_loss = tot_acc = 0.0
            t0 = time.time()
            for _ in range(steps):
                b = feed.cur
                b["wait"].wait()          # this batch's rows have landed
                if stats is not None:
                    registry.reset_launch_counts()
                t1 = time.perf_counter()
                lv, gx, pv, _ = ex.run("train",
                                       feed_dict={x: b["rows"], y_: b["y"]})
                gx = gx.asnumpy()         # waits for the step on the card
                if stats is not None:
                    stats["ms"].append((time.perf_counter() - t1) * 1e3)
                    stats["launches"].append(
                        {k: v for k, v in registry.launch_counts().items()
                         if v})
                table.embedding_update(b["ids"], -args.learning_rate * gx)
                GNNDataLoaderOp.step(None)  # rotate; issue next cache pull
                tot_loss += float(np.mean(lv.asnumpy()))
                if stats is not None:
                    stats["losses"].append(float(np.mean(lv.asnumpy())))
                tot_acc += float(np.mean(np.argmax(pv.asnumpy(), 1)
                                         == b["y"]))
            history.append((tot_loss / steps, tot_acc / steps))
            if rank == 0:
                print(f"[rank {rank}] epoch {epoch}: "
                      f"loss {history[-1][0]:.4f} acc {history[-1][1]:.3f} "
                      f"({time.time() - t0:.2f}s)", flush=True)
        if args.cache_perf and rank == 0:
            print(f"cache miss rate: {table.overall_miss_rate():.3f}",
                  flush=True)
    finally:
        # drain in-flight cache pulls BEFORE anyone calls Finalize — a pull
        # mid-recv when the sockets close wedges the cache worker thread
        for b in (feed.cur, feed._next):
            if b is not None and "wait" in b:
                b["wait"].wait()
        adj_in.close()   # deregister: a later run's step() must not fire us
        ex.close()
    return history


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--nseed", type=int, default=32)
    ap.add_argument("--nmax", type=int, default=128)
    ap.add_argument("--fanout", type=int, default=8)
    ap.add_argument("--num-epoch", type=int, default=10)
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--workers", type=int, default=1,
                    help="standalone only: size of the self-provisioned "
                         "cluster (under the runner the live nrank is used)")
    ap.add_argument("--table-id", type=int, default=7)
    ap.add_argument("--cache-limit", type=int, default=128)
    ap.add_argument("--cache-policy", default="LRU",
                    choices=["LRU", "LFU", "LFUOpt"])
    ap.add_argument("--bound", type=int, default=2)
    ap.add_argument("--cache-perf", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (tests, hosts without a card)")
    return ap.parse_args(argv)


def main(argv=None, stats=None):
    """Train as ``run_sampled.py`` does; returns the history. ``stats``
    goes to :func:`train`."""
    from hetu_tpu_torch.ps.client import PSClient
    args = parse_args(argv)
    if "DMLC_ROLE" in os.environ:      # launched by the runner: just train
        client = PSClient.from_env()
        try:
            return train(client, client.rank, args, stats=stats)
        finally:
            client.close()

    from hetu_tpu_torch.ps.local_cluster import local_cluster
    with local_cluster(n_servers=1, n_workers=1):
        from hetu_tpu_torch.ps import get_worker_communicate
        return train(get_worker_communicate(), 0, args, stats=stats)


if __name__ == "__main__":
    main()
