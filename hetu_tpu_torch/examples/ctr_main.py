"""CTR training on the port (counterpart of ``examples/ctr/run_hetu.py``):
a model of ``ctr_models`` fed by ``Dataloader``s, with a ``train`` and a
``validate`` target, reporting loss, accuracy and AUC, in local mode and
under the comm modes ``AllReduce``, ``PS`` and ``Hybrid``.

    python -m hetu_tpu_torch.examples.ctr_main [--model wdl_criteo]
        [--batch-size 128] [--dim 100000] [--nepoch 1] [--steps N] [--val]
        [--profile DIR] [--gpu 0 | -1]
    python -m hetu_tpu_torch.runner -w 2 python -m \
        hetu_tpu_torch.examples.ctr_main --comm AllReduce --dim 1000 --gpu -1
    python -m hetu_tpu_torch.runner -c cluster.yml python -m \
        hetu_tpu_torch.examples.ctr_main --comm Hybrid [--cache LFUOpt]
        [--bsp] [--bound 100]

``--dim`` is the Criteo vocabulary (``HETU_CTR_DIM``, default 100000 as
in the reference; ``33762577`` is full Criteo-Kaggle). The data is the
reference's seeded synthetic set (8,192 training and 2,048 validation
rows). Every training step takes the table's gradient through the sorted
segment sum (``fused_embed_grad``) and applies SGD through ``fused_sgd``,
one launch for all the parameters.

Prints one JSON line per epoch (mean loss, accuracy and AUC over its
steps, each step's loss, the mean ms per step on the host clock after
``WARMUP`` steps, and the launches of the epoch and of each step), with
the validation's loss, accuracy and AUC after ``--val``; then a summary
line with the time to initialize the parameters and place them on the
device. ``--profile DIR`` adds the device time of one step by kernel group
from ``torch.profiler`` (kernel events only) and the device's busy share;
the table goes to ``DIR/profile_ctr_<model>.txt``. ``--gpu -1`` runs on
the CPU (the kernels' plain versions; times are the CPU's).

``--comm AllReduce`` trains data-parallel under ``hetu_tpu_torch.runner``,
one process per device (gloo on the CPU with ``--gpu -1``, NCCL on the
cards, one card per worker), as ``run_hetu.py`` passes ``comm_mode`` to its
executor: each rank takes its share of every batch, and the table's
dense gradient is all-reduced with the others. Only rank 0 prints; the
loss, accuracy and AUC are the global batch's.

``--comm Hybrid`` and ``--comm PS`` run under a parameter-server cluster
(``hetu_tpu_torch.runner -c`` with a yaml that lists ``servers:``): the
embedding tables live on the servers, and each step pulls the batch's
rows and pushes their gradients (``graph/ps_runtime.py``). Under Hybrid
the dense parameters stay on the device (all-reduced over the workers);
under PS they live on the servers too. ``--cache`` puts the
bounded-staleness cache (``--bound`` versions) in front of each table,
and ``--bsp`` adds a worker barrier after each step's pushes.
The summary line adds the PS runtime's counters and its host seconds
(``ps``).
"""
import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

import hetu_tpu_torch as ht
from hetu_tpu_torch import metrics
from hetu_tpu_torch.examples import bert_forward, ctr_models
from hetu_tpu_torch.graph.node import find_topo_sort

MODELS = ("wdl_adult", "wdl_criteo", "dfm_criteo", "dcn_criteo", "dc_criteo")
PS_MODES = ("PS", "Hybrid")
WARMUP = 3


def load_data(model, dim, seed=0):
    """``(train, validate)`` of the model's synthetic set."""
    if model == "wdl_adult":
        return ctr_models.load_adult_data(seed=seed)
    return ctr_models.load_criteo_data(feature_dimension=dim, seed=seed)


def _loader(train, validate, batch):
    """A dataloader op over ``train``/``validate``, plus ``grads``: the
    first training batch alone (so every gradient probe sees the batch of
    the first training step)."""
    return ht.dataloader_op([ht.Dataloader(train, batch, "train"),
                             ht.Dataloader(validate, batch, "validate"),
                             ht.Dataloader(train[:batch], batch, "grads")])


def build(model, batch, dim, data, **model_kwargs):
    """The model on dataloader ops, as ``run_hetu.py``'s ``build``:
    ``(loss, y, labels, train_op)``."""
    train, validate = data
    if model == "wdl_adult":
        X_deep = [_loader(train[0][i], validate[0][i], batch)
                  for i in range(12)]
        X_wide = _loader(train[1], validate[1], batch)
        y_ = _loader(train[2], validate[2], batch)
        return ctr_models.wdl_adult(X_deep, X_wide, y_, **model_kwargs)
    dense, sparse, y_ = (_loader(tr, va, batch)
                         for tr, va in zip(train, validate))
    return getattr(ctr_models, model)(dense, sparse, y_,
                                      feature_dimension=dim, **model_kwargs)


def _ctx(device):
    device = torch.device(device)
    return ht.cpu(0) if device.type == "cpu" else ht.gpu(device.index or 0)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Trainer:
    """One CTR model on ``device``: the executor with the targets
    ``train``, ``validate`` and ``grads`` (the loss and every parameter's
    gradient on the first training batch, without an update). ``data`` is
    ``load_data(model, dim, seed)``, when the caller has it already.
    ``comm_mode="AllReduce"`` trains data-parallel over the process group
    this process joined (``grads``' per-rank gradients have no placement
    then: it serves local mode). Under ``"PS"`` and ``"Hybrid"`` the tables
    live on the parameter server, and there is no ``grads`` target (no
    table gradient exists on the device); ``ps_options`` go to the
    executor (``bsp``, ``prefetch``, ``cstable_policy``, ``cache_bound``)."""

    def __init__(self, device, model="wdl_criteo", batch_size=128,
                 dim=100000, seed=0, kernels=None, data=None,
                 comm_mode=None, ps_options=None, **model_kwargs):
        if model not in MODELS:
            raise ValueError(f"model must be one of {MODELS}, got {model!r}")
        self.device = device
        self.model, self.batch_size = model, batch_size
        self.data = data or load_data(model, dim, seed)
        self.loss, self.y, self.labels, train_op = build(
            model, batch_size, dim, self.data, **model_kwargs)
        topo = find_topo_sort([self.loss])
        self.params = [n for n in topo if n.is_placeholder and n.trainable]
        self.tables = [n.embed_node for n in topo
                       if hasattr(n, "embed_node")]
        targets = {"train": [self.loss, self.y, self.labels, train_op],
                   "validate": [self.loss, self.y, self.labels]}
        if comm_mode not in PS_MODES:
            targets["grads"] = [self.loss] + ht.gradients(self.loss,
                                                          self.params)
        t0 = time.perf_counter()
        self.ex = ht.Executor(targets, ctx=_ctx(device), seed=seed,
                              kernels=kernels, comm_mode=comm_mode,
                              **(ps_options or {}))
        _sync(device)
        # parameters drawn on the host and placed on the device (under the
        # PS modes: the tables declared and initialized on the servers)
        self.init_ms = (time.perf_counter() - t0) * 1e3
        self.n_params = sum(int(np.prod(n.shape)) for n in self.params)

    def param(self, node) -> torch.Tensor:
        return self.ex.state["params"][id(node)]

    def step(self):
        """One training step: (loss, prediction, labels) tensors."""
        return tuple(r.handle for r in self.ex.run("train")[:3])

    def validate(self):
        return tuple(r.handle for r in self.ex.run("validate"))

    def gradients(self, kernels=None):
        """The loss and ``{param name: gradient}`` on the first training
        batch at the current state, without an update. ``kernels`` sets
        the dispatch mode of this call alone: the same executor, so the
        same parameters (at the full Criteo vocabulary a second table
        would not fit beside the first and its gradient)."""
        config = self.ex.config
        mode = config.kernels
        if kernels is not None:
            config.kernels = ht.kernels.registry.resolve_mode(kernels)
        try:
            out = self.ex.run("grads")
        finally:
            config.kernels = mode
        return out[0].handle, {p.name: g.handle
                               for p, g in zip(self.params, out[1:])}


def _accuracy(labels, pred):
    if labels.shape[1] == 1:
        return float(np.equal(labels, pred > 0.5).astype(np.float32).mean())
    return float(np.equal(np.argmax(labels, 1),
                          np.argmax(pred, 1)).astype(np.float32).mean())


def _auc(labels, pred):
    """ROC AUC of a binary batch (NaN where a batch holds one class)."""
    if labels.shape[1] != 1:
        return float("nan")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return metrics.auc(labels.ravel(), pred.ravel())


def _means(rows):
    loss, acc, auc = (np.array(c, dtype=np.float64) for c in zip(*rows))
    return {"loss": float(loss.mean()), "acc": float(acc.mean()),
            "auc": float(np.nanmean(auc)) if np.isfinite(auc).any()
            else None}


def _evaluate(values):
    loss, pred, labels = (v.detach().cpu().numpy() for v in values)
    return float(np.mean(loss)), _accuracy(labels, pred), _auc(labels, pred)


def run(device, model="wdl_criteo", batch_size=128, dim=100000, nepoch=1,
        steps=None, val=False, profile_dir=None, profile_iters=3, seed=0,
        kernels=None, trainer=None, comm_mode=None, ps_options=None):
    """Yields one dict per epoch, then the summary dict. ``steps`` caps the
    training steps of an epoch; ``trainer`` is a :class:`Trainer` to use
    instead of a new one."""
    tr = trainer or Trainer(device, model, batch_size, dim, seed, kernels,
                            comm_mode=comm_mode, ps_options=ps_options)
    n_train = tr.ex.get_batch_num("train")
    steps = min(steps or n_train, n_train)
    times, per_step = [], []
    for ep in range(nepoch):
        rows, losses, launches = [], [], {}
        for _ in range(steps):
            t0 = time.perf_counter()
            out, counts = bert_forward.counted(tr.step)
            times.append(time.perf_counter() - t0)
            per_step.append(counts)
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            rows.append(_evaluate(out))
            losses.append(rows[-1][0])
        res = {"epoch": ep, "steps": steps,
               **{f"train_{k}": v for k, v in _means(rows).items()},
               "losses": losses,
               "ms_per_step": sum(times[-steps:]) / steps * 1e3,
               "launches": launches,
               "launches_per_step": per_step[-1],
               "launches_same_every_step": all(
                   c == per_step[-1] for c in per_step[-steps:])}
        if val:
            vrows = [_evaluate(tr.validate())
                     for _ in range(tr.ex.get_batch_num("validate"))]
            res.update({f"val_{k}": v for k, v in _means(vrows).items()})
        yield res
    timed = times[WARMUP:] or times
    ms = sum(timed) / len(timed) * 1e3
    res = {"summary": "ctr_main", "model": tr.model,
           "batch_size": tr.batch_size,
           "vocab": [tuple(t.shape) for t in tr.tables],
           "params": tr.n_params, "init_ms": tr.init_ms,
           "step_ms": ms, "samples_per_s": tr.batch_size / ms * 1e3,
           "launches_per_step": per_step[-1],
           "launches_same_every_step": all(c == per_step[-1]
                                           for c in per_step)}
    if profile_dir is not None:
        os.makedirs(profile_dir, exist_ok=True)
        res["profile"] = bert_forward.profile(
            tr.step, ms, profile_iters,
            os.path.join(profile_dir, f"profile_ctr_{tr.model}.txt"))
    if tr.ex.ps_runtime is not None:
        tr.ex.ps_runtime.drain()          # the last step's pushes land
        res["ps"] = dict(tr.ex.ps_runtime.perf)
    yield res


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="wdl_criteo", choices=MODELS)
    parser.add_argument("--comm", default=None,
                        choices=[None, "PS", "Hybrid", "AllReduce"])
    parser.add_argument("--cache", default=None,
                        choices=[None, "LRU", "LFU", "LFUOpt"])
    parser.add_argument("--bsp", action="store_true")
    parser.add_argument("--bound", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--nepoch", type=int, default=1)
    parser.add_argument("--steps", type=int, default=None,
                        help="training steps per epoch (default: all)")
    parser.add_argument("--dim", type=int,
                        default=int(os.environ.get("HETU_CTR_DIM", 100000)),
                        help="feature dimension (full Criteo: 33762577)")
    parser.add_argument("--val", action="store_true")
    parser.add_argument("--profile", default=None, metavar="DIR")
    parser.add_argument("--gpu", type=int, default=0)
    args = parser.parse_args(argv)
    if args.profile and args.gpu < 0:
        raise SystemExit("--profile measures the card; it needs --gpu >= 0")
    if args.comm in PS_MODES and not os.environ.get("DMLC_PS_ROOT_URI"):
        raise SystemExit(
            f"--comm {args.comm} trains against a parameter-server cluster: "
            "run it under python -m hetu_tpu_torch.runner -c <cluster yaml "
            "with servers:>")
    rank, gpu, comm = 0, args.gpu, None
    if args.comm in PS_MODES:
        ht.worker_init()
    try:
        if args.comm in ("AllReduce", "Hybrid"):
            comm, rank = ht.mpi_nccl_init(init_nccl=args.gpu >= 0)
            gpu = comm.local_rank() if args.gpu >= 0 else -1
        device = "cpu" if gpu < 0 else torch.device("cuda", gpu)
        if gpu >= 0 and rank == 0:
            print(torch.cuda.get_device_name(gpu), flush=True)
        ps_options = None
        if args.comm in PS_MODES:
            ps_options = dict(bsp=args.bsp, cstable_policy=args.cache,
                              cache_bound=args.bound)
        for res in run(device, args.model, args.batch_size, args.dim,
                       args.nepoch, args.steps, args.val, args.profile,
                       comm_mode=args.comm, ps_options=ps_options):
            if rank == 0:
                print(json.dumps(res), flush=True)
    finally:
        if args.comm in PS_MODES:
            ht.worker_finish()
        if comm is not None:
            ht.mpi_nccl_finish(comm)


if __name__ == "__main__":
    main()
