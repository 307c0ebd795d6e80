"""PS and Hybrid execution: the bridge between the executor's step on the
device and the host-resident parameter server (counterpart of
``hetu_tpu/graph/ps_runtime.py``).

- A sparse embedding table lives on the server, never on the device:
  before a step the executor pulls the batch's rows of each table
  (``SparsePull``, or the bounded-staleness cache of ``cstable_policy``)
  and enters them as the lookup's output; after it, it pushes their
  gradients.
- Under ``comm_mode="PS"`` the dense parameters live on the server too:
  the step reads their latest pulled values, and each push is a
  ``DDPushPull`` that brings the new values back.
- SGD is applied by prescaling on the worker (the push carries
  ``-lr(step)·g`` and the server adds it); Momentum, AdaGrad and Adam run
  on the server, with per-step ``[lr, l2reg, weight_decay]`` riding the
  pushes.
- ASP by default; ``bsp=True`` adds a worker barrier after each step's
  pushes. ``prefetch=True`` moves the pushes onto a push stream (a
  thread) and pulls batch N+1's rows while step N runs: under ASP on a
  pull stream of its own (the rows may miss this step's pushes, a
  staleness of one step), under BSP on the push stream, behind the
  barrier, so the order is exact.

A gradient on the card reaches the host through pinned buffers: the
executor's thread queues the copies on the step's stream
(``non_blocking=True``) and records an event after them; the push thread
waits on that event before it reads the buffers. Nothing blocks the
executor's thread on the device.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import warnings
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from .node import Op, PlaceholderOp


class _SerialIO:
    """A thread that runs the closures submitted to it, in order.

    The native agent is thread-safe, but the Python client keeps shared
    staging state: all client calls of one stream go through one of
    these, and calls of two streams take the runtime's rpc lock around
    their issue."""

    def __init__(self, name: str):
        self._q: "queue.Queue" = queue.Queue()
        self._t = threading.Thread(target=self._loop, name=name, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — delivered via future
                fut.set_exception(e)

    def submit(self, fn) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn))
        return fut

    def drain(self):
        """Block until everything submitted so far has completed."""
        self.submit(lambda: None).result()

    def stop(self):
        self.drain()
        self._q.put(None)
        self._t.join(timeout=10)


def _dedup_sum_rows(flat_idx: np.ndarray, g: np.ndarray):
    """Sum the rows of duplicate ids before the wire: a stateful server
    optimizer must see one summed gradient per row and step; for prescaled
    SGD it only shrinks the request. A stable sort and ``np.add.reduceat``
    over the runs, as the JAX package sums them."""
    uniq, inv = np.unique(flat_idx, return_inverse=True)
    if uniq.size == flat_idx.size:
        return flat_idx, g
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(uniq.size))
    acc = np.add.reduceat(g[order], starts, axis=0)
    return uniq, np.ascontiguousarray(acc, np.float32)


_INIT_SPEC_BY_CLASS = {
    # initializer class name -> (server init type, (a attribute, b attribute))
    "ConstantInit": ("constant", ("constant", None)),
    "ZerosInit": ("constant", ("constant", None)),
    "OnesInit": ("constant", ("constant", None)),
    "UniformInit": ("uniform", ("low", "high")),
    "NormalInit": ("normal", ("mean", "stddev")),
    "TruncatedNormalInit": ("truncated_normal", ("mean", "stddev")),
}


def _ps_init_spec(node: PlaceholderOp):
    """The server-side init of a variable's initializer, ``(type, a, b)``;
    None where the value is drawn on the host and assigned instead (an
    explicit value, a Xavier or He variant)."""
    init = node.initializer
    if init is None:
        return None
    spec = _INIT_SPEC_BY_CLASS.get(type(init).__name__)
    if spec is None:
        return None
    itype, (a_attr, b_attr) = spec
    a = float(getattr(init, a_attr, 0.0)) if a_attr else 0.0
    b = float(getattr(init, b_attr, 1.0)) if b_attr else 1.0
    return itype, a, b


class PSParam:
    """One PS-hosted parameter."""

    def __init__(self, node: PlaceholderOp, ps_id: int, sparse: bool):
        self.node = node
        self.ps_id = ps_id
        self.sparse = sparse
        self.shape = tuple(node.shape)
        self.cache = None            # a CacheSparseTable under cstable_policy
        self.lookup_ops: list[Op] = []
        self.host_value: Optional[np.ndarray] = None  # dense params only


class HostGrad:
    """A step's gradient on its way to the host: the tensors (copied into
    pinned buffers when they were on the card) and the event after those
    copies. :meth:`numpy` waits for the event and returns the arrays."""

    def __init__(self, tensors):
        self.event = None
        out = []
        for t in tensors:
            t = t.detach()
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                out.append(buf)
            else:
                out.append(t.clone())
        cuda = [t for t in tensors if t.is_cuda]
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(cuda[0].device))
        self._bufs = out

    def numpy(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return [b.numpy() for b in self._bufs]


class PSRuntime:
    """The PS-hosted parameters of one executor and their traffic."""

    def __init__(self, config, topo: list[Op]):
        from .. import ps as ps_pkg
        self.config = config
        if ps_pkg._worker is None and os.environ.get("DMLC_PS_ROOT_URI"):
            # a launched worker starts its agent with its first executor
            ps_pkg.worker_init()
        self.comm = ps_pkg.get_worker_communicate()
        self.bsp = bool(config.bsp)
        # the agent is one per process: set the wire explicitly, so that
        # an executor does not inherit another's setting (the PS wire is
        # the int8 container for any active quantization mode)
        self.comm_quant = getattr(config, "comm_quant", "off") or "off"
        self.comm.SetCommQuant(self.comm_quant != "off")

        # -- the PS-hosted variables ---------------------------------------
        embed_vars = set()
        lookups_by_var: dict[int, list[Op]] = {}
        for op in topo:
            embed = getattr(op, "embed_node", None)
            if embed is not None and isinstance(embed, PlaceholderOp):
                embed_vars.add(id(embed))
                lookups_by_var.setdefault(id(embed), []).append(op)
        self.params: dict[int, PSParam] = {}
        # an id base lets several executors of one process address disjoint
        # server tensors (two runs against one live cluster)
        next_id = int(os.environ.get("HETU_PS_ID_BASE", "0"))
        for op in topo:
            if not (isinstance(op, PlaceholderOp) and op.trainable):
                continue
            sparse = op.is_embed or id(op) in embed_vars
            if config.comm_mode == "Hybrid" and not sparse:
                continue  # dense params are all-reduced under Hybrid
            p = PSParam(op, next_id, sparse)
            p.lookup_ops = lookups_by_var.get(id(op), [])
            self.params[id(op)] = p
            next_id += 1

        self._opt_nodes = [n for n in topo if n.is_optimizer]
        self._server_opt = self._deduce_server_opt()
        self._init_params()

        # -- async I/O: the push stream, and the pull stream (the push
        #    stream itself under BSP) ---------------------------------------
        self.async_enabled = bool(config.prefetch)
        self._rpc_lock = threading.Lock()
        self._io_push: Optional[_SerialIO] = None
        self._io_pull: Optional[_SerialIO] = None
        if self.async_enabled:
            self._io_push = _SerialIO("hetu-ps-push")
            self._io_pull = (self._io_push if self.bsp
                             else _SerialIO("hetu-ps-pull"))
        self._prefetched: dict[int, tuple] = {}
        self._pending_pushes: list[Future] = []
        self._dense_push_fut: dict[int, Future] = {}
        # counts, and seconds on the host clock: the RPCs (on whichever
        # thread runs them; a push's includes its wait for the gradient's
        # copy to the host) and the executor thread's pre-step and
        # post-step legs (the waits the step itself sees)
        self.perf = {"sync_pulls": 0, "prefetch_issued": 0,
                     "prefetch_hits": 0, "prefetch_misses": 0,
                     "async_pushes": 0, "pull_rpc_s": 0.0,
                     "push_rpc_s": 0.0, "pre_step_s": 0.0,
                     "post_step_s": 0.0}
        ps_pkg._register_runtime(self)

    # ------------------------------------------------------------------
    def _deduce_server_opt(self):
        """The server-side optimizer of the graph's optimizer. SGD is
        prescaled on the worker (each push is ``-lr(step)·g``), so a
        schedule holds; its l2 term needs the rate on the server, so l2reg
        rides the push options. A stateful optimizer runs on the server,
        with ``[lr(step), l2reg, weight_decay]`` refreshed before each
        push where a schedule or a regularizer needs them."""
        for opt_node in self._opt_nodes:
            o = opt_node.optimizer
            name = type(o).__name__
            scheduled = hasattr(o.learning_rate, "get_traced")
            lr = float(o.lr_value(0))
            l2reg = float(getattr(o, "l2reg", 0.0) or 0.0)
            wd = float(getattr(o, "weight_decay", 0.0) or 0.0)
            if name == "SGDOptimizer":
                return {"otype": "sgd", "lrs": (lr,), "prescale": True,
                        "opt": o, "l2reg": l2reg, "wd": 0.0,
                        "per_step": l2reg > 0.0}
            base = None
            if name == "MomentumOptimizer":
                base = {"otype": "nesterov" if o.nesterov else "momentum",
                        "lrs": (lr, o.momentum)}
            elif name == "AdaGradOptimizer":
                base = {"otype": "adagrad", "lrs": (lr, o.eps)}
            elif name in ("AdamOptimizer", "AdamWOptimizer"):
                base = {"otype": "adam",
                        "lrs": (lr, o.beta1, o.beta2, o.epsilon)}
            if base is not None:
                base.update(prescale=False, opt=o, l2reg=l2reg, wd=wd,
                            per_step=scheduled or l2reg > 0.0 or wd > 0.0)
                if (l2reg > 0.0 or wd > 0.0) and any(
                        p.sparse for p in self.params.values()):
                    warnings.warn(
                        "l2reg/weight_decay on PS-hosted sparse embeddings "
                        "is lazy: only the rows of a batch are regularized "
                        "(a table on the device shrinks every row every "
                        "step)", stacklevel=3)
                return base
        return {"otype": "sgd", "lrs": (0.01,), "prescale": True, "opt": None,
                "l2reg": 0.0, "wd": 0.0, "per_step": False}

    def _prescale_lr(self, step: int) -> float:
        o = self._server_opt.get("opt")
        if o is None:
            return 0.01
        return float(o.lr_value(step))

    def _init_params(self):
        """Declare each PS-hosted variable on its server. A server-side
        initializer (constant, uniform, normal, truncated normal) is drawn
        there from ``seed + ps_id``, as in the JAX package, so both
        packages start from the same table. Any other value is drawn on
        worker 0's host and assigned past the server's optimizer: from a
        ``torch.Generator`` seeded from ``(seed, ps_id)``, where the JAX
        package draws from ``jax.random`` (the values differ)."""
        cfg = self.config
        if cfg.cstable_policy and (not self._server_opt["prescale"]
                                   or self._server_opt["l2reg"] > 0.0):
            raise NotImplementedError(
                "cstable_policy requires worker-side lr-scaled SGD without "
                "l2reg: the cache applies the pushed gradients to its own "
                "rows, which a stateful or regularizing server optimizer "
                "would not match")
        for p in self.params.values():
            opt = self._server_opt
            if p.sparse:
                rows, width = int(p.shape[0]), int(np.prod(p.shape[1:]))
                kind = 2 if cfg.cstable_policy else 1
            else:
                rows, width = int(np.prod(p.shape)), 1
                kind = 0
            spec = _ps_init_spec(p.node)
            if spec is not None:
                itype, a, b = spec
                self.comm.InitTensor(p.ps_id, kind, rows, width, itype, a, b,
                                     seed=cfg.seed + p.ps_id,
                                     opt_type=opt["otype"], lrs=opt["lrs"])
            else:
                self.comm.InitTensor(p.ps_id, kind, rows, width, "constant",
                                     0.0, 1.0, seed=cfg.seed,
                                     opt_type=opt["otype"], lrs=opt["lrs"])
                if self.comm.rank == 0:
                    seed = np.random.SeedSequence(
                        [int(cfg.seed), int(p.ps_id)]).generate_state(
                            1, np.uint64)[0]
                    gen = torch.Generator().manual_seed(int(seed))
                    value = p.node.instantiate(gen).float().numpy()
                    if p.sparse:
                        self.comm.SparseAssign(
                            p.ps_id, np.arange(rows, dtype=np.int64),
                            value.reshape(rows, width))
                    else:
                        self.comm.Assign(p.ps_id, value.ravel())
                self.comm.BarrierWorker()
            if p.sparse and cfg.cstable_policy:
                from ..cstable import CacheSparseTable
                limit = max(1, int(rows * 0.1))
                p.cache = CacheSparseTable(limit, rows, width, p.ps_id,
                                           policy=cfg.cstable_policy,
                                           bound=cfg.cache_bound)
            if not p.sparse:
                buf = np.zeros(rows, np.float32)
                self.comm.Pull(p.ps_id, buf)
                self.comm.Wait(p.ps_id)
                p.host_value = buf.reshape(p.shape)

    # ------------------------------------------------------------------
    # before the step: stage the batch's rows and the dense values
    # ------------------------------------------------------------------
    def _pull_rows(self, p: PSParam, idx: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        width = int(np.prod(p.shape[1:]))
        flat = np.ascontiguousarray(idx, dtype=np.int64).ravel()
        dest = np.zeros((flat.size, width), np.float32)
        if p.cache is not None:
            with self._rpc_lock:
                p.cache.embedding_lookup(flat.astype(np.uint64), dest,
                                         sync=True)
        else:
            with self._rpc_lock:
                self.comm.SparsePull(p.ps_id, flat, dest)
            self.comm.Wait(p.ps_id)
        self.perf["pull_rpc_s"] += time.perf_counter() - t0
        return dest.reshape(tuple(np.shape(idx)) + tuple(p.shape[1:]))

    def stage_lookup(self, p: PSParam, idx: np.ndarray) -> np.ndarray:
        """Pull the batch's rows. With async I/O the pull runs on the pull
        stream: under BSP that is the push stream, so it waits behind this
        worker's pushes and the barrier."""
        self.perf["sync_pulls"] += 1
        if self.async_enabled:
            return self._io_pull.submit(
                lambda: self._pull_rows(p, idx)).result()
        return self._pull_rows(p, idx)

    def prefetch_lookup(self, key: int, p: PSParam, idx: np.ndarray):
        """Queue the pull of batch N+1's rows on the pull stream."""
        idx = np.array(idx, copy=True)
        self.perf["prefetch_issued"] += 1
        self._prefetched[key] = (idx, self._io_pull.submit(
            lambda: self._pull_rows(p, idx)))

    def take_prefetched(self, key: int, idx) -> Optional[np.ndarray]:
        """The prefetched rows of ``key`` if they were pulled for ``idx``,
        else None (after letting the pull finish)."""
        ent = self._prefetched.pop(key, None)
        if ent is None:
            return None
        expected, fut = ent
        if np.array_equal(expected, np.asarray(idx)):
            self.perf["prefetch_hits"] += 1
            return fut.result()
        self.perf["prefetch_misses"] += 1
        fut.result()
        return None

    def wait_dense(self, p: PSParam):
        """Block until the latest async ``DDPushPull`` of ``p`` has
        refreshed ``host_value``."""
        fut = self._dense_push_fut.get(id(p.node))
        if fut is not None:
            fut.result()

    # ------------------------------------------------------------------
    # after the step: push the gradients
    # ------------------------------------------------------------------
    def _refresh_push_opts(self, p: PSParam, step: int):
        opt = self._server_opt
        if not opt.get("per_step"):
            return
        o = opt.get("opt")
        lr = float(o.lr_value(step)) if o is not None else float(opt["lrs"][0])
        self.comm.SetPushOpts(p.ps_id, lr, opt["l2reg"], opt["wd"])

    def _push_one(self, p: PSParam, grad: HostGrad, kind: str, idx,
                  step: int) -> int:
        t0 = time.perf_counter()
        nbytes = self._push_one_body(p, grad, kind, idx, step)
        self.perf["push_rpc_s"] += time.perf_counter() - t0
        return nbytes

    def _push_one_body(self, p: PSParam, grad: HostGrad, kind: str, idx,
                       step: int) -> int:
        """Push one gradient; returns its payload in bytes. ``kind`` is
        ``"rows"`` (the compact ``(rows, grads)`` pair of the rows route),
        ``"lookups"`` (one row-gradient array per lookup of ``idx``) or
        ``"dense"``."""
        opt = self._server_opt
        arrays = grad.numpy()
        self._refresh_push_opts(p, step)
        if p.sparse:
            width = int(np.prod(p.shape[1:]))
            if kind == "rows":
                # the device summed each id already; drop the vocab
                # sentinel tail and any id outside [0, vocab): a padding
                # id must not update a real row
                flat_idx = arrays[0].astype(np.int64).ravel()
                g = arrays[1].reshape(flat_idx.size, width)
                keep = (flat_idx >= 0) & (flat_idx < int(p.shape[0]))
                if not keep.all():
                    flat_idx, g = flat_idx[keep], np.ascontiguousarray(
                        g[keep])
            else:
                flat_idx = np.concatenate(
                    [np.ascontiguousarray(i, np.int64).ravel() for i in idx])
                g = np.concatenate([a.reshape(-1, width) for a in arrays],
                                   axis=0)
                flat_idx, g = _dedup_sum_rows(flat_idx, g)
            if opt["prescale"]:
                g = -self._prescale_lr(step) * g
            if p.cache is not None:
                with self._rpc_lock:
                    p.cache.embedding_update(flat_idx.astype(np.uint64), g,
                                             sync=True)
            else:
                with self._rpc_lock:
                    self.comm.SparsePush(p.ps_id, flat_idx, g)
                self.comm.Wait(p.ps_id)
            return g.nbytes + flat_idx.nbytes
        g = arrays[0].ravel()
        if opt["prescale"]:
            g = -self._prescale_lr(step) * g
        out = np.empty_like(p.host_value).ravel()
        with self._rpc_lock:
            self.comm.DDPushPull(p.ps_id, g, out)
        self.comm.Wait(p.ps_id)
        p.host_value = out.reshape(p.shape)
        return g.nbytes

    def push_grad(self, p: PSParam, grad: HostGrad, kind: str, idx,
                  step: int = 0):
        """A push on the executor's thread (``prefetch=False``)."""
        self._push_one(p, grad, kind, idx, step)
        if self.bsp:
            self.comm.BarrierWorker()

    def push_grads_async(self, items, step: int):
        """Queue one step's pushes on the push stream; ``items`` is
        ``[(PSParam, HostGrad, kind, idx), ...]``. The push thread waits
        for each gradient's copy to the host, so the caller returns while
        the step may still run on the card."""

        def _do():
            for p, grad, kind, idx in items:
                self._push_one(p, grad, kind, idx, step)
            if self.bsp:
                self.comm.BarrierWorker()
            self.perf["async_pushes"] += len(items)

        fut = self._io_push.submit(_do)
        self._pending_pushes.append(fut)
        if len(self._pending_pushes) > 64:
            # a bounded backlog: the oldest push lands before another is
            # queued
            self._pending_pushes.pop(0).result()
        for p, *_ in items:
            if not p.sparse:
                self._dense_push_fut[id(p.node)] = fut
        return fut

    def drain(self):
        """Complete all in-flight PS traffic; a failed push raises here."""
        if self._io_push is not None:
            self._io_push.drain()
        if self._io_pull is not None and self._io_pull is not self._io_push:
            self._io_pull.drain()
        pending, self._pending_pushes = self._pending_pushes, []
        for fut in pending:
            fut.result()

    def shutdown(self):
        """Stop the I/O threads, after draining them; later steps push on
        the executor's thread."""
        if self._io_push is not None:
            self._io_push.stop()
        if self._io_pull is not None and self._io_pull is not self._io_push:
            self._io_pull.stop()
        self._io_push = self._io_pull = None
        self.async_enabled = False

    # ------------------------------------------------------------------
    def save(self, directory: str):
        """Worker 0 has each server write its PS-hosted parameters into
        ``directory``."""
        self.drain()
        if self.comm.rank == 0:
            for p in self.params.values():
                self.comm.SaveParam(p.ps_id, directory)
        self.comm.BarrierWorker()

    def load(self, directory: str):
        self.drain()
        self._prefetched.clear()  # rows pulled before the load are stale
        if self.comm.rank == 0:
            for p in self.params.values():
                self.comm.LoadParam(p.ps_id, directory)
        self.comm.BarrierWorker()
        for p in self.params.values():
            if not p.sparse:
                p.host_value = self._pull_dense(p)

    def _pull_dense(self, p: PSParam) -> np.ndarray:
        buf = np.zeros(int(np.prod(p.shape)), np.float32)
        self.comm.Pull(p.ps_id, buf)
        self.comm.Wait(p.ps_id)
        return buf.reshape(p.shape)

    def pull_dense_value(self, p: PSParam) -> np.ndarray:
        """The server's current value of a dense parameter."""
        self.drain()
        return self._pull_dense(p)

    def pull_sparse_rows(self, p: PSParam, idx: np.ndarray) -> np.ndarray:
        """The server's current rows ``idx`` of a table."""
        self.drain()
        return self._pull_rows(p, idx)
