"""Neural Collaborative Filtering on the port (counterpart of
``examples/rec``: ``hetu_ncf.py``'s ``neural_mf``, ``movielens.py``'s
``getdata`` and ``run_hetu.py``'s trainer).

GMF (the elementwise product of user and item factors) fused with an MLP
tower over the concatenated latents; one embedding table per side carries
both. In local mode a training step takes each table's gradient through
the sorted segment sum (``fused_embed_grad``, one launch a table) and
applies SGD through ``fused_sgd`` (one launch for all the parameters);
under ``--comm PS`` or ``Hybrid`` the tables live on the parameter server
(``graph/ps_runtime.py``), as for CTR.

    python -m hetu_tpu_torch.examples.ncf [--batch-size 1024] [--nepoch 1]
        [--gpu 0 | -1]
    python -m hetu_tpu_torch.runner -c cluster.yml python -m \\
        hetu_tpu_torch.examples.ncf --comm Hybrid [--cache LFUOpt] [--bsp]

The data is ``getdata``'s seeded synthetic implicit feedback in ml-1m's
form (or a local ``.npz`` with ``path=``). Prints one JSON line per epoch
(mean loss and accuracy, each step's loss, the mean ms per step on the
host clock, the launches of a step); under the PS modes the PS runtime's
counters follow. ``--gpu -1`` runs on the CPU.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch import init
from hetu_tpu_torch.examples import bert_forward

PS_MODES = ("PS", "Hybrid")
# ml-1m (MovieLens 1M): 6,040 users, 3,706 rated movies
ML1M = dict(num_users=6040, num_items=3706)


def neural_mf(user_input, item_input, y_, num_users, num_items,
              embed_dim=8, layers=(64, 32, 16, 8), learning_rate=0.01,
              embed_stddev=0.01):
    width = embed_dim + layers[0] // 2
    user_table = init.random_normal((num_users, width), stddev=embed_stddev,
                                    name="user_embed", is_embed=True,
                                    ctx=ht.cpu(0))
    item_table = init.random_normal((num_items, width), stddev=embed_stddev,
                                    name="item_embed", is_embed=True,
                                    ctx=ht.cpu(0))
    user_latent = ht.array_reshape_op(
        ht.embedding_lookup_op(user_table, user_input), (-1, width))
    item_latent = ht.array_reshape_op(
        ht.embedding_lookup_op(item_table, item_input), (-1, width))

    mf_user = ht.slice_op(user_latent, (0, 0), (-1, embed_dim))
    mlp_user = ht.slice_op(user_latent, (0, embed_dim), (-1, -1))
    mf_item = ht.slice_op(item_latent, (0, 0), (-1, embed_dim))
    mlp_item = ht.slice_op(item_latent, (0, embed_dim), (-1, -1))

    mf_vector = ht.mul_op(mf_user, mf_item)
    x = ht.concat_op(mlp_user, mlp_item, axis=1)
    for i in range(len(layers) - 1):
        w = init.random_normal((layers[i], layers[i + 1]), stddev=0.1,
                               name=f"W{i + 1}")
        x = ht.relu_op(ht.matmul_op(x, w))
    w_out = init.random_normal((embed_dim + layers[-1], 1), stddev=0.1,
                               name="W_out")
    y = ht.sigmoid_op(ht.matmul_op(ht.concat_op(mf_vector, x, axis=1), w_out))
    loss = ht.reduce_mean_op(ht.binarycrossentropy_op(y, y_), [0])
    opt = ht.optim.SGDOptimizer(learning_rate=learning_rate)
    return loss, y, opt.minimize(loss)


def getdata(dataset="ml-1m", path=None, num_users=600, num_items=1200,
            n_pos=20000, num_negatives=4, seed=0):
    """``(users, items, labels, num_users, num_items)``: the arrays of
    ``path`` (a local ``.npz`` with those keys) where it exists, else
    seeded synthetic implicit feedback of ml-1m's form, 4 negatives per
    positive, the same draws as ``movielens.py``'s."""
    if path and os.path.exists(path):
        data = np.load(path)
        return (data["users"], data["items"], data["labels"],
                int(data["num_users"]), int(data["num_items"]))
    rng = np.random.RandomState(seed)
    # each user has a latent preference over items: positives are sampled
    # from the top half of their preference ranking, so NCF can learn
    u_pref = rng.randn(num_users, 8)
    i_pref = rng.randn(num_items, 8)
    scores = u_pref @ i_pref.T
    pools = {}      # a user's ranking, sorted once
    users, items, labels = [], [], []
    for _ in range(n_pos):
        u = rng.randint(num_users)
        if u not in pools:
            pools[u] = np.argsort(-scores[u])[:num_items // 2]
        pos_pool = pools[u]
        items.append(pos_pool[rng.randint(len(pos_pool))])
        users.append(u)
        labels.append(1.0)
        for _ in range(num_negatives):
            users.append(u)
            items.append(rng.randint(num_items))
            labels.append(0.0)
    users = np.asarray(users, np.float32).reshape(-1, 1)
    items = np.asarray(items, np.float32).reshape(-1, 1)
    labels = np.asarray(labels, np.float32).reshape(-1, 1)
    perm = rng.permutation(len(users))
    return users[perm], items[perm], labels[perm], num_users, num_items


def _ctx(device):
    device = torch.device(device)
    return ht.cpu(0) if device.type == "cpu" else ht.gpu(device.index or 0)


class Trainer:
    """NCF on ``device``: the executor with a ``train`` target over
    dataloaders of ``data`` (``getdata()``'s form; default ``getdata()``).
    ``comm_mode`` ``"PS"`` or ``"Hybrid"`` puts the tables on the
    parameter server; ``ps_options`` go to the executor (``bsp``,
    ``prefetch``, ``cstable_policy``, ``cache_bound``)."""

    def __init__(self, device, data=None, batch_size=1024, seed=0,
                 kernels=None, comm_mode=None, ps_options=None,
                 **model_kwargs):
        users, items, labels, num_users, num_items = data or getdata()
        self.device, self.batch_size = device, batch_size
        self.shape = dict(users=num_users, items=num_items,
                          samples=int(labels.shape[0]), batch=batch_size)
        user_in, item_in, y_ = (
            ht.dataloader_op([ht.Dataloader(x, batch_size, "train")])
            for x in (users, items, labels))
        self.loss, self.y, train_op = neural_mf(user_in, item_in, y_,
                                                num_users, num_items,
                                                **model_kwargs)
        self.ex = ht.Executor({"train": [self.loss, self.y, y_, train_op]},
                              ctx=_ctx(device), seed=seed, kernels=kernels,
                              comm_mode=comm_mode, **(ps_options or {}))

    def param(self, node) -> torch.Tensor:
        return self.ex.state["params"][id(node)]

    def step(self):
        """One training step: (loss, prediction, labels) tensors."""
        return tuple(r.handle for r in self.ex.run("train")[:3])


def run(device, nepoch=1, steps=None, trainer=None, **trainer_kwargs):
    """Yields one dict per epoch. ``steps`` caps the training steps of an
    epoch; ``trainer`` is a :class:`Trainer` to use instead of a new one."""
    tr = trainer or Trainer(device, **trainer_kwargs)
    n = tr.ex.get_batch_num("train")
    steps = min(steps or n, n)
    for ep in range(nepoch):
        losses, accs, times, per_step = [], [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            (loss, pred, y), counts = bert_forward.counted(tr.step)
            times.append(time.perf_counter() - t0)
            per_step.append(counts)
            losses.append(float(loss.mean()))
            accs.append(float(((pred > 0.5).float() == y).float().mean()))
        res = {"epoch": ep, "steps": steps, "loss": float(np.mean(losses)),
               "acc": float(np.mean(accs)), "losses": losses,
               "ms_per_step": float(np.mean(times)) * 1e3,
               "launches_per_step": per_step[-1],
               "launches_same_every_step": all(c == per_step[-1]
                                               for c in per_step)}
        if tr.ex.ps_runtime is not None:
            tr.ex.ps_runtime.drain()      # the epoch's pushes land
            res["ps"] = dict(tr.ex.ps_runtime.perf)
        yield res


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--comm", default=None, choices=[None, *PS_MODES])
    parser.add_argument("--cache", default=None,
                        choices=[None, "LRU", "LFU", "LFUOpt"])
    parser.add_argument("--bsp", action="store_true")
    parser.add_argument("--batch-size", type=int, default=1024)
    parser.add_argument("--nepoch", type=int, default=1)
    parser.add_argument("--gpu", type=int, default=0)
    args = parser.parse_args(argv)
    if args.comm in PS_MODES and not os.environ.get("DMLC_PS_ROOT_URI"):
        raise SystemExit(
            f"--comm {args.comm} trains against a parameter-server cluster: "
            "run it under python -m hetu_tpu_torch.runner -c <cluster yaml "
            "with servers:>")
    rank, gpu, comm = 0, args.gpu, None
    if args.comm in PS_MODES:
        ht.worker_init()
        rank = ht.get_worker_communicate().rank
    try:
        if args.comm == "Hybrid":
            comm, rank = ht.mpi_nccl_init(init_nccl=args.gpu >= 0)
            gpu = comm.local_rank() if args.gpu >= 0 else -1
        device = "cpu" if gpu < 0 else torch.device("cuda", gpu)
        ps_options = None
        if args.comm in PS_MODES:
            ps_options = dict(bsp=args.bsp, cstable_policy=args.cache)
        for res in run(device, args.nepoch,
                       batch_size=args.batch_size, comm_mode=args.comm,
                       ps_options=ps_options):
            if rank == 0:
                print(json.dumps(res), flush=True)
    finally:
        if args.comm in PS_MODES:
            ht.worker_finish()
        if comm is not None:
            ht.mpi_nccl_finish(comm)


if __name__ == "__main__":
    main()
