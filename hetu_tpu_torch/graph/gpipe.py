"""Graph-API pipeline parallelism: the GPipe subexecutor (counterpart of
``hetu_tpu/graph/gpipe.py``, the reference's ``SubExecutor4Gpipe``,
``gpu_ops/executor.py:435-767``).

``Executor(..., gpipe=True)`` cuts the graph at context boundaries: each
``ht.context(...)`` is a stage, in order of first appearance, and a value
that a later stage reads is an output of its own stage and an input of
the later one. ``run`` takes a list of microbatch feed dicts (or, fed by
dataloaders, ``gpipe_microbatches`` batches of each), runs all forwards,
then all backwards in reverse microbatch order with the loss's cotangent
at 1/M, so the pipeline step equals one device's step on the
concatenated batch, and applies the optimizer once per stage (one group
launch of the fused optimizer kernel per stage). BatchNorm's running
statistics thread through the microbatches in order.

Processes: a device's id in a context is the rank that runs it, as in
the reference, where rank i drives ``gpu(i)``; each process runs the
stage whose context holds its rank (on the device it joined the process
group on) and keeps each microbatch's graph until its backward. Values
cross a stage boundary as point-to-point messages, each after a header
with its shape and dtype (the reference's shape handshake): activations
forward, their gradients back (``multihost.send``/``recv``; NCCL, or
gloo with host staging where it was asked for). A context of several
devices (``ht.context([d0, d1])``) is a stage with a dp group of those
ranks: each takes its contiguous share of every microbatch, its gradients
are averaged over the group before the apply, and it exchanges boundary
values with the rank at its dp index in the neighbouring stages (their
widths must match). A process alone in its world runs every stage
itself. Every process returns every fetched value: a stage's lead rank
broadcasts its stage's values, each the global microbatch's.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..context import DeviceGroup
from ..kernels import registry
from ..ndarray import NDArray
from ..parallel import multihost
from .executor import SubExecutor, TraceContext
from .node import Op, find_topo_sort

# dtypes of the boundary handshake, by code
_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.uint8, torch.bool]
_HEADER = 10            # dtype code, ndim, up to 8 dimensions


class _Stage:
    """One pipeline stage: its ranks (one per dp share) and the forward
    subgraph placed on them."""

    def __init__(self, index: int, group: DeviceGroup):
        self.index = index
        self.group = group
        self.ranks = [c.device_id for c in group.flat()]
        self.nodes: list[Op] = []        # compute nodes, topo order
        self.param_nodes: list[Op] = []
        self.feed_nodes: list[Op] = []
        self.state_nodes: list[Op] = []  # stateful ops (BatchNorm stats)
        self.in_nodes: list[Op] = []     # boundary inputs from earlier stages
        self.out_nodes: list[Op] = []    # values later stages or fetches read
        self.var_idx: list[int] = []     # its params' places in opt.vars

    @property
    def dp(self) -> int:
        return len(self.ranks)

    def dp_group(self):
        """The stage's dp group (looked up on each use), or None for one
        rank."""
        return multihost.group(self.ranks) if self.dp > 1 else None


class SubExecutor4Gpipe:
    """GPipe schedule over context-partitioned stages (reference
    executor.py:435)."""

    def __init__(self, name: str, eval_nodes: list[Op], executor):
        self.name = name
        self.eval_nodes = eval_nodes
        self.executor = executor
        self.config = executor.config

        topo = find_topo_sort(eval_nodes)
        opt_nodes = [n for n in topo if n.is_optimizer]
        if len(opt_nodes) > 1:
            raise ValueError(
                f"gpipe=True needs at most one optimizer in the graph, "
                f"found {len(opt_nodes)}")
        if self.config.comm_mode not in (None, "AllReduce"):
            raise NotImplementedError(
                f"gpipe=True with comm_mode={self.config.comm_mode!r}: "
                "PS/Hybrid embeddings cannot ride the pipeline schedule; "
                "pipeline+DP is expressed by multi-device stage contexts "
                "(comm_mode='AllReduce' or default)")
        self.opt_node = opt_nodes[0] if opt_nodes else None
        self.loss = None
        self.opt_vars = []
        if self.opt_node is not None:
            if self.opt_node.optimizer.clip_grad_norm is not None:
                raise NotImplementedError(
                    "gpipe=True with clip_grad_norm: the norm spans the "
                    "stages' processes, and the pipeline applies each "
                    "stage's update on its own")
            grad0 = self.opt_node.inputs[0]
            # comm_mode='AllReduce' wraps grads in AllReduce markers; under
            # gpipe the dp mean is each stage group's, so unwrap them
            from .ops.comm import AllReduceCommunicateOp
            if isinstance(grad0, AllReduceCommunicateOp):
                grad0 = grad0.inputs[0]
            if not getattr(grad0, "is_gradient", False):
                raise ValueError(
                    "gpipe optimizer inputs must be gradient nodes")
            self.loss = grad0.gctx.loss
            self.opt_vars = list(self.opt_node.vars)

        fwd_evals = [n for n in eval_nodes if not n.is_optimizer]
        if self.loss is not None and self.loss not in fwd_evals:
            fwd_evals.append(self.loss)
        self.fwd_evals = fwd_evals
        fwd_topo = [n for n in find_topo_sort(fwd_evals)
                    if not (n.is_gradient or n.is_optimizer)]
        from ..dataloader import DataloaderOp
        self.dataloader_nodes = [n for n in fwd_topo if n.is_dataloader]
        for n in self.dataloader_nodes:
            if not isinstance(n, DataloaderOp):
                raise NotImplementedError(
                    f"gpipe dataloader feeds support plain dataloader_op "
                    f"nodes; {type(n).__name__} must be fed explicitly")

        self.training = self.opt_node is not None
        self.stages = self._partition(fwd_topo)
        self._place()

    # ------------------------------------------------------------------
    def _partition(self, fwd_topo: list[Op]) -> list[_Stage]:
        """Group forward nodes into stages by their context, in order of
        first appearance (reference context.py:369-387)."""
        stage_of: dict[int, int] = {}
        stages: list[_Stage] = []
        group_index: dict[DeviceGroup, int] = {}
        for n in fwd_topo:
            if n.is_placeholder or n.is_dataloader:
                continue  # assigned to its earliest consumer below
            if not isinstance(n.raw_ctx, DeviceGroup):
                raise ValueError(
                    f"gpipe=True but {n.name!r} has no placement context; "
                    "wrap each pipeline stage in `with ht.context(...)` "
                    "(reference examples/runner/parallel/gpipe.py)")
            if n.raw_ctx not in group_index:
                group_index[n.raw_ctx] = len(stages)
                stages.append(_Stage(len(stages), n.raw_ctx))
            s = group_index[n.raw_ctx]
            for i in n.inputs:
                if id(i) in stage_of and stage_of[id(i)] > s:
                    raise ValueError(
                        f"{n.name!r} (stage {s}) consumes {i.name!r} from a "
                        f"later stage {stage_of[id(i)]}; pipeline edges must "
                        "flow forward")
            stage_of[id(n)] = s
            stages[s].nodes.append(n)
        if not stages:
            raise ValueError("gpipe=True but the graph has no stage contexts")
        for st in stages:
            st.state_nodes = [n for n in st.nodes if n.stateful]
        # params, feeds and dataloaders belong to their earliest consumer
        for n in fwd_topo:
            if not (n.is_placeholder or n.is_dataloader):
                continue
            consumers = [stage_of[id(c)] for c in fwd_topo
                         if not (c.is_placeholder or c.is_dataloader)
                         and any(i is n for i in c.inputs)]
            if not consumers:
                continue
            s = min(consumers)
            stage_of[id(n)] = s
            if n.is_dataloader or getattr(n, "is_feed", False):
                stages[s].feed_nodes.append(n)
            else:
                stages[s].param_nodes.append(n)
        # boundary edges: a value a later stage reads is an output of its
        # own stage and an input of every later consumer
        self.consumers: dict[int, list[int]] = {}
        for n in fwd_topo:
            if id(n) not in stage_of:
                continue
            s = stage_of[id(n)]
            later = sorted({stage_of[id(c)] for c in fwd_topo
                            if not c.is_placeholder
                            and any(i is n for i in c.inputs)
                            and stage_of[id(c)] > s})
            if later or any(n is e for e in self.fwd_evals):
                stages[s].out_nodes.append(n)
            self.consumers[id(n)] = later
            for t in later:
                stages[t].in_nodes.append(n)
        self._stage_of = stage_of
        return stages

    def _place(self):
        """Which stages this process runs, its dp index in each, the
        stages' groups (made now, in one order on every rank) and each
        stage's params' places among the optimizer's vars."""
        world = multihost.process_count()
        me = multihost.process_index()
        if world == 1:
            wide = [st.index for st in self.stages if st.dp > 1]
            if wide:
                raise ValueError(
                    f"stages {wide} span several devices: a stage context "
                    "of N devices runs N processes (python -m "
                    "hetu_tpu_torch.runner -w ...)")
            self.local = {st.index: 0 for st in self.stages}
        else:
            seen: dict[int, int] = {}
            for st in self.stages:
                for r in st.ranks:
                    if not 0 <= r < world:
                        raise ValueError(
                            f"stage {st.index}'s context names device {r}, "
                            f"but the world has ranks 0..{world - 1}")
                    if r in seen:
                        raise ValueError(
                            f"rank {r} is in stages {seen[r]} and "
                            f"{st.index}: one stage a process")
                    seen[r] = st.index
            self.local = {st.index: st.ranks.index(me) for st in self.stages
                          if me in st.ranks}
            for st in self.stages:
                if st.dp > 1:
                    multihost.group(st.ranks)
            for n_id, later in self.consumers.items():
                s = self._stage_of[n_id]
                for t in later:
                    if self.stages[t].dp != self.stages[s].dp:
                        raise NotImplementedError(
                            f"stages {s} and {t} have dp widths "
                            f"{self.stages[s].dp} and {self.stages[t].dp}; "
                            "a boundary between unequal widths reshards, "
                            "which comes with slice 8c")
        if self.training:
            var_pos = {id(v): i for i, v in enumerate(self.opt_vars)}
            for st in self.stages:
                st.var_idx = [var_pos[id(v)] for v in st.param_nodes
                              if id(v) in var_pos]

    # ------------------------------------------------------------------
    def _peer(self, st: _Stage, other: _Stage) -> int:
        """The rank of ``other`` that exchanges boundary values with this
        process's share of ``st``."""
        return other.ranks[self.local[st.index]]

    def _send(self, value, dst: int, pending: list) -> None:
        t = value.detach()
        header = torch.zeros(_HEADER, dtype=torch.int64)
        header[0], header[1] = _DTYPES.index(t.dtype), t.ndim
        header[2:2 + t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
        dev = multihost.device()
        pending.append(multihost.send(header.to(dev), dst))
        pending.append(multihost.send(t.contiguous(), dst))

    def _recv(self, src: int) -> torch.Tensor:
        header = multihost.recv((_HEADER,), torch.int64, src).cpu()
        ndim = int(header[1])
        shape = tuple(int(d) for d in header[2:2 + ndim])
        return multihost.recv(shape, _DTYPES[int(header[0])], src)

    def _share(self, st: _Stage, value):
        """This process's contiguous share of a microbatch input of a
        stage with a dp group."""
        if st.dp == 1 or not isinstance(value, torch.Tensor) \
                or value.ndim == 0:
            return value
        b = value.shape[0]
        if b % st.dp:
            raise ValueError(
                f"stage {st.index}: microbatch dim 0 ({b}) must divide the "
                f"stage's dp width ({st.dp}); size the microbatches "
                "accordingly")
        k = b // st.dp
        i = self.local[st.index]
        return value[i * k:(i + 1) * k]

    def _cast(self, value):
        cdtype = self.config.compute_dtype
        if isinstance(value, torch.Tensor) and value.is_floating_point() \
                and value.dtype != cdtype:
            return value.to(cdtype)
        return value

    # ------------------------------------------------------------------
    def _feed_lists(self, feed_dict):
        if not feed_dict:
            # {} / [] mean None: the dataloader path must not silently run
            # a 1-microbatch step
            feed_dict = None
        if isinstance(feed_dict, dict):
            feed_dict = [feed_dict]
        if feed_dict is None and self.dataloader_nodes:
            M = self.config.gpipe_microbatches
            if not M:
                raise ValueError(
                    "gpipe with dataloader feeds and no feed_dicts list "
                    "needs Executor(..., gpipe_microbatches=M)")
            feed_dict = [{} for _ in range(M)]
        if not isinstance(feed_dict, (list, tuple)) or not feed_dict:
            raise ValueError(
                "gpipe run() takes a non-empty list of microbatch feed_dicts")
        if self.dataloader_nodes:
            feed_dict = [dict(fd) for fd in feed_dict]
            for fd in feed_dict:
                for n in self.dataloader_nodes:
                    if n in fd:
                        raise ValueError(
                            f"{n.name!r} is a dataloader node; its batches "
                            "come from the loader, not the feed list")
                    fd[n] = np.asarray(n.get_batch(self.name))
        for m, fd in enumerate(feed_dict):
            for st in self.stages:
                for n in st.feed_nodes:
                    if n not in fd:
                        raise ValueError(
                            f"microbatch {m}: missing feed for {n.name!r}")
        return feed_dict

    def run(self, feed_dict=None, convert_to_numpy_ret_vals=False,
            eval_node_list=None):
        """One GPipe step over a list of microbatch feed dicts (reference
        executor.py:592). Returns, per eval node, the list of its
        per-microbatch values (None for the optimizer)."""
        ex = self.executor
        feed_dict = self._feed_lists(feed_dict)
        M = len(feed_dict)
        step = ex.state["step"]
        training = self.training
        local = [st for st in self.stages if st.index in self.local]
        params = ex.state["params"]
        # the step's leaves: microbatches' gradients accumulate in them
        leaves = {id(n): (params[id(n)].detach().requires_grad_()
                          if training else params[id(n)])
                  for st in local for n in st.param_nodes}
        state = {id(n): ex.state["op_state"][id(n)]
                 for st in local for n in st.state_nodes}
        cfg = self.config
        sent: list = []
        values = [dict() for _ in range(M)]     # m -> id(node) -> value
        kept = [dict() for _ in range(M)]       # m -> stage -> (ins, outs)

        with registry.active(cfg.kernels), torch.set_grad_enabled(training):
            # ---- forward fill: all microbatches through all stages ------
            for m in range(M):
                for st in local:
                    env: dict[int, Any] = {}
                    for n in st.param_nodes:
                        env[id(n)] = self._cast(leaves[id(n)])
                    for n in st.feed_nodes:
                        env[id(n)] = self._cast(self._share(
                            st, ex._prepare_input(feed_dict[m][n])))
                    ins = []
                    for n in st.in_nodes:
                        src = self.stages[self._stage_of[id(n)]]
                        v = (values[m][id(n)] if src.index in self.local
                             else self._recv(self._peer(st, src)))
                        if training and v.is_floating_point():
                            v = v.detach().requires_grad_()
                        env[id(n)] = v
                        ins.append(v)
                    tc = _StageContext(
                        cfg, training, env, params, step, m, st,
                        {id(n): state[id(n)] for n in st.state_nodes})
                    for node in st.nodes:
                        vals = [self._cast(env[id(i)]) for i in node.inputs]
                        if node.stateful:
                            out = SubExecutor._stateful(node, vals, tc)
                        else:
                            out = node.compute(vals, tc)
                        env[id(node)] = out
                    if training:
                        state.update(tc.op_state_updates)
                    outs = [env[id(n)] for n in st.out_nodes]
                    for n, v in zip(st.out_nodes, outs):
                        values[m][id(n)] = v
                        for t in self.consumers.get(id(n), ()):
                            if t not in self.local:
                                self._send(v, self._peer(st, self.stages[t]),
                                           sent)
                    kept[m][st.index] = (ins, outs)

            if training:
                ex.state["op_state"].update(state)
                self._backward(local, kept, M, sent)
                self._apply(local, leaves, step)
                ex.state["step"] = step + 1
        for w in sent:
            w.wait()
        return self._collect(values, M, eval_node_list,
                             convert_to_numpy_ret_vals)

    def _backward(self, local, kept, M, sent):
        """All backwards, reverse microbatch, reverse stage; each stage's
        outputs take their consumers' gradients (the loss 1/M)."""
        for m in reversed(range(M)):
            cts: dict[int, Any] = {}
            for st in reversed(local):
                ins, outs = kept[m].pop(st.index)
                pairs = []
                for n, v in zip(st.out_nodes, outs):
                    if not (isinstance(v, torch.Tensor)
                            and v.is_floating_point()):
                        continue
                    ct = cts.pop(id(n), None)
                    for t in self.consumers.get(id(n), ()):
                        if t not in self.local:
                            g = self._recv(self._peer(st, self.stages[t]))
                            ct = g if ct is None else ct + g
                    if n is self.loss:
                        seed = torch.full_like(v, 1.0 / M)
                        ct = seed if ct is None else ct + seed
                    if ct is not None and v.requires_grad:
                        pairs.append((v, ct.to(v.dtype)))
                if pairs:
                    torch.autograd.backward([v for v, _ in pairs],
                                            [c for _, c in pairs])
                for n, v in zip(st.in_nodes, ins):
                    if not v.is_floating_point():
                        continue
                    g = v.grad if v.grad is not None else torch.zeros_like(v)
                    src = self.stages[self._stage_of[id(n)]]
                    if src.index in self.local:
                        cts[id(n)] = g if id(n) not in cts else cts[id(n)] + g
                    else:
                        self._send(g, self._peer(st, src), sent)

    @torch.no_grad()
    def _apply(self, local, leaves, step):
        """One optimizer apply per stage, after its gradients' mean over
        the stage's dp group (reference executor.py:734-742)."""
        ex = self.executor
        opt = self.opt_node.optimizer
        slots = list(ex.state["slots"][id(self.opt_node)])
        for st in local:
            if not st.var_idx:
                continue
            nodes = [self.opt_vars[i] for i in st.var_idx]
            ps = [ex.state["params"][id(n)] for n in nodes]
            gs = [leaves[id(n)].grad if leaves[id(n)].grad is not None
                  else torch.zeros_like(p) for n, p in zip(nodes, ps)]
            gs = [g if g.dtype == p.dtype else g.to(p.dtype)
                  for g, p in zip(gs, ps)]
            if st.dp > 1:
                multihost.all_reduce_(gs, st.dp_group(), mean=True)
            new_p, new_s = opt.apply_group(ps, gs, [slots[i]
                                                    for i in st.var_idx],
                                           step)
            for n, p in zip(nodes, new_p):
                ex.state["params"][id(n)] = p
            for i, s in zip(st.var_idx, new_s):
                slots[i] = s
        ex.state["slots"][id(self.opt_node)] = tuple(slots)

    def _global(self, st: _Stage, v):
        """A stage's value for the whole microbatch: a one-element value is
        the mean over the stage's dp ranks, a batch-major one their rows
        in rank order."""
        if st.dp == 1 or not isinstance(v, torch.Tensor):
            return v
        v = v.detach()
        group = st.dp_group()
        if v.numel() == 1:
            y = v.float().clone()
            multihost.all_reduce_([y], group, mean=True)
            return y.to(v.dtype)
        return torch.cat(multihost.all_gather(v, group))

    def _collect(self, values, M, eval_node_list, to_numpy):
        """Per eval node its per-microbatch values, on every process."""
        wanted = (eval_node_list if eval_node_list is not None
                  else self.eval_nodes)
        fetched: dict[int, list] = {}
        for st in self.stages:
            mine = [n for n in st.out_nodes if any(n is w for w in wanted)]
            if not mine:
                continue
            box = [None]
            if st.index in self.local:
                # by position: node ids differ between processes
                box = [[[_host(self._global(st, values[m][id(n)]))
                         for m in range(M)] for n in mine]]
            if multihost.process_count() > 1:
                dist.broadcast_object_list(box, src=st.ranks[0])
            fetched.update(zip(map(id, mine), box[0]))
        results = []
        for node in wanted:
            if node.is_optimizer:
                results.append(None)
            elif id(node) in fetched:
                vals = fetched[id(node)]
                results.append([v if to_numpy else NDArray(
                    torch.from_numpy(v)) for v in vals])
            else:
                raise ValueError(f"{node.name!r} is not among subexecutor "
                                 f"{self.name!r}'s eval nodes")
        return results


def _host(v) -> np.ndarray:
    """A fetched value as numpy (bf16 widened to float32)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy().copy()
    return np.asarray(v)


class _StageContext(TraceContext):
    """The step context of one (microbatch, stage): random bits seeded per
    (executor seed, step, microbatch, stage, node), so two microbatches or
    stages never draw one mask; a batch statistic summed over the stage's
    dp group."""

    def __init__(self, config, training, env, params, step, m, stage,
                 op_state_in):
        super().__init__(config, training, env, params, 0, {}, step,
                         {id(n): i for i, n in enumerate(stage.nodes)},
                         op_state_in)
        self.microbatch, self.stage = m, stage

    @property
    def sync_group(self):
        return self.stage.dp_group()

    def next_rng(self, node):
        i = self._node_index.get(id(node), node.id)
        seed = np.random.SeedSequence(
            [int(self.config.seed), int(self.step), self.microbatch,
             self.stage.index, int(i)]).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=self.config.device)
        gen.manual_seed(int(seed))
        return gen
