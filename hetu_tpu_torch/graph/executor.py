"""Executor: runs named evaluation targets of a graph, one eager PyTorch
step per ``run`` (counterpart of the core of
``hetu_tpu/graph/executor.py``).

The reference traces one jitted XLA program per (target, shape signature).
Here a step walks the target's topological order once: parameters and
inputs enter as tensors on the executor's device, each op computes
eagerly, a ``GradientOp`` takes ``torch.autograd.grad`` over the evaluated
forward, and the optimizer ops update parameters and slots in place
through the CUDA kernels. State (parameters in ``param_nodes`` order, the
optimizer slots) and its on-disk format (``save``/``load``) are the
reference's, so checkpoints move between the two packages.

Entry points run on the card unless the caller asks for the CPU:
``ctx=None`` is ``cuda:0``, and without CUDA it raises rather than fall
back. Every parameter lives on the executor's device: a Variable's own
``ctx`` (``ctx=ht.cpu(0)`` on the CTR models' tables) is a placement hint
for the PS modes, which local mode ignores, as the JAX executor does.

Data parallelism (``comm_mode="AllReduce"``) runs one process per device,
as Hetu's own MPI ranks do, where the JAX package runs one controller
over a GSPMD mesh; the results are the JAX executor's:

- **Mesh.** ``HetuConfig(mesh=...)`` takes a ``DeviceMesh`` with a
  ``dp_axis`` dimension, of any size, one rank included. Without one, a
  mesh over the whole world is deduced for ``"AllReduce"`` when the
  process group holds more than one process (the JAX rule: a mesh is
  deduced only for more than one device). Without a mesh the all-reduce
  is the identity, as local mode.
- **Feeds.** Every rank is fed the global batch. A batch input (a fed
  placeholder, unless ``Variable(..., batch=False)``, or a dataloader
  batch) whose axis 0 dp divides is cut, and each rank takes its
  contiguous share; otherwise it warns "not divisible by dp" and every
  rank runs the whole batch, which gives the one-device result.
- **Gradients.** Each ``AllReduceCommunicateOp`` sums the ranks'
  gradients and divides by dp: the gradient of the global batch's mean.
  Marked ops of large parameters go through the quantized all-reduce
  (``comm_quant``), with this rank's shard of the error-feedback
  residual in ``state["qresid"]``: the marked inputs of one optimizer
  node run as one group (``comm_quant.quantized_allreduce_group``, one
  launch of each kernel) just before the node's apply.
- **Parameters** are drawn from the seed on every rank, then broadcast
  from rank 0 once at build, so ranks cannot start apart.
- **Fetched values** are the global batch's. A fetched batch input is
  its global value. A value computed from a cut batch input is placed
  by its shape: a value whose axis 0 is the share's length is gathered
  along axis 0 in rank order; a value of one element (0-d, or a mean
  over axis 0 that kept its axes, as the CTR models' ``(1,)`` loss) is
  taken for a batch mean, and is the mean of the ranks' values. Any
  other value computed from a cut input raises ``ValueError`` naming its
  node. Values that no cut input reaches (parameters, the all-reduced
  gradients) are the same on every rank and are returned as they are.

Op state, random bits and the compute dtype, as the reference threads
them:

- **Op state.** A stateful op (BatchNorm's running mean and variance)
  has its state in ``state["op_state"]``, made from its ``state_init``;
  each step hands it to ``compute_stateful`` and a training run replaces
  it with what the op returned (a ``validate`` run reads it only). The
  state keeps its own dtype under bf16 compute. ``save`` writes it as
  the reference does: ``aux["op_state"]``, keyed by the stateful node's
  index.
- **Random bits.** ``TraceContext.next_rng(node)`` is a
  ``torch.Generator`` on the executor's device, seeded from the executor
  seed, the step and the node's index in the target's topological order
  (not its global id, which depends on how many nodes earlier code
  built). A dropout gradient op asking for its forward node's generator
  in the same step draws the same mask. The bits differ from
  ``jax.random``'s.
- **Compute dtype.** ``dtype="bfloat16"`` (or ``torch.bfloat16``) casts
  every floating input of every op to bf16, parameters and feeds
  included; the parameters, the optimizer slots and the updates stay
  float32 (the gradients are cast to float32 before the optimizer, and
  before a data-parallel all-reduce), as the reference's mixed
  precision. A bf16 value fetched as numpy comes back as float32 (numpy
  has no bfloat16).

Float32 convolutions and products run in full float32: the executor sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False. ``cudnn.benchmark`` is left
off, so cuDNN picks its algorithms by heuristic, the same each run.

The PS and Hybrid comm modes (``graph/ps_runtime.py``) keep every
sparse embedding table on the parameter server, and under ``"PS"`` the
dense parameters too:

- **Tables.** A variable read through an embedding lookup is a sparse
  table. Before each step the executor pulls the batch's rows of each
  table (once for the union of the ids, where several lookups share a
  table) and enters them as the lookup's output, a leaf that requires
  grad: it takes the table's place among its gradient context's ``xs``,
  so the push carries ``d loss / d rows``, ``(batch, slots, width)``, and
  no table-sized gradient exists on the device. An explicit
  ``embedding_lookup_gradient_op`` whose only consumer is a push flips to
  rows mode and pushes ``fused_embed_grad``'s compact form.
- **Dense parameters** under ``"PS"`` enter each step from their last
  pulled values; under ``"Hybrid"`` they stay on the device and are
  all-reduced over the dp group (deduced, as for ``"AllReduce"``, where
  the process group holds more than one process). On dp ranks each rank
  pulls the rows of its share of the batch and pushes its row gradients
  divided by dp, so the server sums the global batch's gradient.
- **Pushes.** After the step each push op's gradient (float32) goes to
  the server: on the executor's thread with ``prefetch=False``, else on
  the runtime's push stream, with the pull of the next batch's rows
  queued behind it; ``bsp=True`` adds a worker barrier after a step's
  pushes. ``close()`` drains the streams; ``save``/``load`` include the
  server's parameters.

Lint, plan, telemetry, watch, pilot and elastic arrive with later
slices; so does capturing the step in a CUDA graph.
"""
from __future__ import annotations

import os
import pickle
import time
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .. import comm_quant as cq
from ..context import DeviceGroup
from ..kernels import registry
from ..ndarray import NDArray, ND_Sparse_Array
from ..parallel import multihost
from . import ps_runtime
from .node import Op, find_topo_sort
from .ops.comm import AllReduceCommunicateOp
from .ops.embedding import IndexedRows, embed_grad_push_routable
from .ops.ps import ParameterServerCommunicateOp, ParameterServerSparsePullOp

COMM_MODES = (None, "AllReduce", "PS", "Hybrid")

# the value a PS-resident table takes in a step: only its lookups read it,
# and their rows are staged
_PS_RESIDENT = object()


def _resolve_device(ctx, mesh, dp_rank: int, dp: int) -> torch.device:
    """This process's device. ``ctx=None`` is the device the process group
    was joined on when there is a mesh, else ``cuda:0``. A group of several
    devices is one device per dp rank: this rank takes its own."""
    if ctx is None:
        dev = (multihost.device() if mesh is not None
               else torch.device("cuda", 0))
    else:
        ctxs = (ctx if isinstance(ctx, DeviceGroup) else DeviceGroup(ctx)).flat()
        if len(ctxs) == 1:
            dev = ctxs[0].torch_device()
        elif mesh is not None and len(ctxs) == dp:
            dev = ctxs[dp_rank].torch_device()
        else:
            raise NotImplementedError(
                f"ctx={ctx!r}: hetu_tpu_torch runs one process per device; "
                f"a group of {len(ctxs)} devices needs a dp mesh of as many "
                "processes (python -m hetu_tpu_torch.runner -w N, "
                "comm_mode='AllReduce'), and model parallelism arrives with "
                "slice 8")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the executor runs on {dev} (ctx={ctx!r}) but "
            "torch.cuda.is_available() is False; pass ctx=ht.cpu(0) to run "
            "on the CPU")
    return dev


def _compute_dtype(dtype) -> torch.dtype:
    """The compute dtype: float32 (``np.float32``, ``"float32"``,
    ``torch.float32``) or bfloat16 (``"bfloat16"``, ``torch.bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        t = dtype
    elif isinstance(dtype, str):
        t = getattr(torch, dtype, None)
    else:
        try:
            t = {np.dtype(np.float32): torch.float32}.get(np.dtype(dtype))
        except TypeError:
            t = None
    if t not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16 (\"bfloat16\" "
                         f"or torch.bfloat16), got {dtype!r}")
    return t


class HetuConfig:
    """Execution configuration (reference executor.py:103): the device,
    the seed, the compute dtype, the comm mode with its dp mesh and
    quantization policy, and the kernel mode. Options of the reference
    that the port has not yet reached raise, naming their slice."""

    def __init__(self, eval_node_list, ctx=None, seed=None, comm_mode=None,
                 mesh=None, dp_axis="dp", gpipe=False, dtype=np.float32,
                 comm_quant=None, comm_quant_block=None,
                 comm_quant_min_size=None, comm_quant_error_feedback=None,
                 comm_quant_force=(), kernels=None, bsp=False, prefetch=True,
                 cstable_policy=None, cache_bound=100):
        self.eval_node_list = eval_node_list
        self.ctx = ctx
        self.seed = seed if seed is not None else np.random.randint(0, 2**31 - 1)
        # compute dtype (reference executor.py:124-128): bf16 compute over
        # f32 master parameters, slots and updates
        self.compute_dtype = _compute_dtype(dtype)
        if comm_mode not in COMM_MODES:
            raise ValueError(f"comm_mode must be one of {COMM_MODES}, got "
                             f"{comm_mode!r}")
        self.comm_mode = comm_mode
        # the PS modes (reference executor.py:96-118): BSP adds a worker
        # barrier after each step's pushes; prefetch pushes on a stream of
        # their own and pulls the next batch's rows behind them;
        # cstable_policy puts a bounded-staleness cache of cache_bound in
        # front of each table.
        self.bsp = bool(bsp)
        self.prefetch = bool(prefetch)
        self.cstable_policy = cstable_policy
        self.cache_bound = cache_bound
        if gpipe:
            raise NotImplementedError(
                "gpipe=True: pipeline parallelism arrives with slice 8 (TP, "
                "PP, ZeRO)")
        self.dp_axis = dp_axis
        # quantized communication (docs/COMM_QUANT.md of the JAX package):
        # explicit arguments, then HETU_COMM_QUANT*, then off
        self.comm_quant_policy = cq.resolve_policy(
            comm_quant, comm_quant_block, comm_quant_min_size,
            comm_quant_error_feedback, comm_quant_force)
        self.comm_quant = self.comm_quant_policy.mode
        self.kernels = registry.resolve_mode(kernels)
        if mesh is not None and dp_axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(
                f"mesh must be a torch.distributed DeviceMesh with a "
                f"{dp_axis!r} dimension, got {mesh!r}")
        if mesh is None and comm_mode in ("AllReduce", "Hybrid") \
                and multihost.process_count() > 1:
            mesh = multihost.global_mesh()
        self.mesh = mesh
        group = self.dp_group
        self.dp_rank = dist.get_rank(group) if group is not None else 0
        self.dp_size = dist.get_world_size(group) if group is not None else 1
        self.device = _resolve_device(ctx, mesh, self.dp_rank, self.dp_size)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"the mesh is over {mesh.device_type!r} devices but this "
                f"executor runs on {self.device}")

    @property
    def dp_group(self):
        """The dp process group, or None without a mesh. Looked up on each
        use and never stored: a group held past ``multihost.shutdown``
        would be torn down at interpreter exit."""
        return self.mesh.get_group(self.dp_axis) if self.mesh is not None \
            else None


class TraceContext:
    """Per-step services handed to ``Op.compute`` (the reference's per-trace
    context): the step's values, the parameters, the op state, random
    bits, autodiff and the gradient all-reduce."""

    def __init__(self, config: HetuConfig, training: bool, env: dict,
                 params: dict, n_grad_contexts: int, qresid_in: dict,
                 step: int = 0, node_index: dict = None,
                 op_state_in: dict = None):
        self.config = config
        self.training = training
        self.env = env
        self.params = params            # id(node) -> state tensor
        self.step = step
        # each node's position in the target's topological order: what the
        # random bits are seeded from (reference executor.py:345-353)
        self._node_index = node_index or {}
        self.op_state_in = op_state_in or {}
        self.op_state_updates: dict[int, Any] = {}
        self.param_updates: dict[int, Any] = {}
        self.slot_updates: dict[int, Any] = {}
        # error-feedback residuals by quantized AllReduce op id: this
        # rank's shard of the previous step's error in, this step's out
        self.qresid_in = qresid_in
        self.qresid_updates: dict[int, Any] = {}
        self.grad_cache: dict[int, dict[int, Any]] = {}
        # the gradients of this step's PS pushes, by push op
        self.ps_grad_outputs: dict[int, Any] = {}
        # one backward per GradientContext; the graph is kept for the next
        # context while any remains
        self._grads_left = n_grad_contexts

    @property
    def sync_group(self):
        """The dp group a batch statistic is summed over (BatchNorm), or
        None where this process holds the whole batch."""
        return self.config.dp_group if self.config.dp_size > 1 else None

    def next_rng(self, node: Op) -> torch.Generator:
        """A generator on the executor's device for ``node``'s random bits
        in this step, seeded from (executor seed, step, the node's index in
        the topological order). The same node gets the same generator state
        every time it asks in one step."""
        i = self._node_index.get(id(node), node.id)
        seed = np.random.SeedSequence(
            [int(self.config.seed), int(self.step), int(i)]).generate_state(
                1, np.uint64)[0]
        gen = torch.Generator(device=self.config.device)
        gen.manual_seed(int(seed))
        return gen

    def gradient_of(self, gctx, x: Op):
        key = id(gctx)
        if key not in self.grad_cache:
            loss = self.env[id(gctx.loss)]
            xs = [self.env[id(n)] for n in gctx.xs]
            self._grads_left -= 1
            if loss.requires_grad:
                grads = torch.autograd.grad(
                    loss.sum(), xs, retain_graph=self._grads_left > 0,
                    allow_unused=True)
            else:   # the loss does not depend on any x
                grads = [None] * len(xs)
            self.grad_cache[key] = {
                id(n): torch.zeros_like(v) if g is None else g
                for n, v, g in zip(gctx.xs, xs, grads)}
        return self.grad_cache[key][id(x)]

    def ps_push_pull(self, op, grad):
        """A PS push inside the step: keep its gradient for the post-step
        push, in float32 (the server keeps float32); a rows-mode pair keeps
        its int32 ids. On dp ranks a gradient is divided by dp: the server
        sums the ranks' pushes into the global batch's gradient."""
        dp = self.config.dp_size

        def f32(g):
            g = _f32(g.detach())
            return g / dp if dp > 1 else g

        if isinstance(grad, IndexedRows):
            out = IndexedRows(grad.rows, f32(grad.grads))
        elif isinstance(grad, tuple):     # one table, several lookups
            out = tuple(f32(g) for g in grad)
        else:
            out = f32(grad)
        self.ps_grad_outputs[id(op)] = out
        return None

    def allreduce_group(self, ops, xs, state):
        """The quantized all-reduce of the marked ``ops`` (inputs of one
        optimizer node), whose inputs' values are ``xs``, as one group
        through ``state`` (a ``comm_quant.QarGroup``); the values, in
        ``ops``' order."""
        cfg = self.config
        resid = [self.qresid_in.get(id(op)) for op in ops]
        xs = [_f32(x) for x in xs]
        with torch.no_grad():
            values, new = cq.quantized_allreduce_group(
                xs, None if any(r is None for r in resid) else resid,
                cfg.dp_group, cfg.comm_quant_policy, state)
        if new is not None:
            for op, r in zip(ops, new):
                self.qresid_updates[id(op)] = r
        return values

    def allreduce(self, x, param_node=None, op=None):
        """The mean of the dp ranks' ``x``, in float32 (a bf16 gradient is
        summed in f32 for the f32 master parameters); the identity without
        a mesh. An op the executor marked takes the quantized all-reduce."""
        cfg = self.config
        group = cfg.dp_group
        if group is None:
            return x
        x = _f32(x)
        with torch.no_grad():
            if op is not None and op.comm_quant \
                    and cfg.comm_quant_policy.active \
                    and x.is_floating_point():
                out, new_resid = cq.quantized_allreduce(
                    x, self.qresid_in.get(id(op)), group,
                    cfg.comm_quant_policy)
                if new_resid is not None:
                    self.qresid_updates[id(op)] = new_resid
                return out
            y = x.detach().clone(memory_format=torch.contiguous_format)
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
            return y.div_(cfg.dp_size)


def _f32(x):
    """A floating tensor of a lower precision as float32."""
    if isinstance(x, torch.Tensor) and x.is_floating_point() \
            and x.dtype != torch.float32:
        return x.float()
    return x


class SubExecutor:
    """One named evaluation target (reference SubExecutor executor.py:769)."""

    def __init__(self, name: str, eval_nodes: list[Op], executor: "Executor"):
        self.name = name
        self.eval_nodes = eval_nodes
        self.executor = executor
        self.config = executor.config
        self.topo = find_topo_sort(eval_nodes)
        topo_ids = {id(n) for n in self.topo}
        self.training = any(n.is_optimizer for n in self.topo)
        self.param_nodes = [n for n in executor.param_nodes if id(n) in topo_ids]
        self.feed_nodes = [n for n in self.topo
                           if n.is_placeholder and getattr(n, "is_feed", False)]
        self.dataloader_nodes = [n for n in self.topo if n.is_dataloader]
        self.optimizer_nodes = [n for n in self.topo if n.is_optimizer]
        self.stateful_nodes = [n for n in self.topo if n.stateful]
        self.node_index = {id(n): i for i, n in enumerate(self.topo)}
        # optimizer ops last: they update parameters in place, so every
        # other node must have read the pre-step values first
        self.order = ([n for n in self.topo if not n.is_optimizer]
                      + self.optimizer_nodes)
        gctxs = {id(n.gctx): n.gctx for n in self.topo if n.is_gradient}
        self.n_grad_contexts = len(gctxs)
        # values autograd differentiates against enter the step as leaves
        # that require grad (an intermediate x is cut there, as the
        # reference's re-trace treats it as an independent input)
        self.grad_x_ids = {id(x) for g in gctxs.values() for x in g.xs}

        # -- PS bookkeeping (reference executor.py:575-600) -----------------
        ps = executor.ps_runtime
        self.ps_staged_ops = []    # lookups and sparse pulls of PS tables
        self.ps_sparse_vars = []   # PS-resident tables in the topo
        self.ps_dense_vars = []    # PS-hosted dense params, fed per step
        self.ps_comm_ops = []      # the pushes, in topo order
        if ps is not None:
            for n in self.topo:
                embed = getattr(n, "embed_node", None)
                if embed is not None and id(embed) in ps.params \
                        and ps.params[id(embed)].sparse:
                    self.ps_staged_ops.append(n)
                if isinstance(n, ParameterServerCommunicateOp) \
                        and n.ps_param_node is not None:
                    self.ps_comm_ops.append(n)
                if n.is_placeholder and id(n) in ps.params:
                    (self.ps_sparse_vars if ps.params[id(n)].sparse
                     else self.ps_dense_vars).append(n)
            for op in self.ps_staged_ops:
                idx_node = op.inputs[1]
                if not (idx_node in self.feed_nodes
                        or idx_node in self.dataloader_nodes):
                    raise ValueError(
                        f"PS-hosted lookup {op.name!r}: the index input "
                        f"{idx_node.name!r} must be a feed or dataloader "
                        "node (its value is needed on the host to pull rows)")
        # a table read by several lookups pulls the union of their ids once
        self._staged_by_table: dict[int, list] = {}
        for op in self.ps_staged_ops:
            self._staged_by_table.setdefault(id(op.embed_node), []).append(op)

        # -- device-resident datasets (reference executor.py:609-630) -------
        # A small, sequential (no shuffle/func, drop_last) dataset uploads to
        # the device ONCE and the step slices its batch by a cursor: no
        # host-to-device copy per step. A PS lookup's ids are needed on the
        # host, so their loader stays there.
        self.resident_dl: dict[int, tuple] = {}
        self._dl_cursor: dict[int, int] = {}
        limit = float(os.environ.get("HETU_DEVICE_DATA_MB", "1024")) * 1e6
        ps_idx = {id(op.inputs[1]) for op in self.ps_staged_ops}
        for n in self.dataloader_nodes:
            dl = getattr(n, "dataloaders", {}).get(self.name)
            if (dl is not None and dl.func is None and not dl.shuffle
                    and dl.drop_last and id(n) not in ps_idx
                    and dl._data.nbytes <= limit):
                self.resident_dl[id(n)] = (
                    executor._prepare_input(dl._data), dl.batch_size,
                    dl.batch_num)
        self.host_dl_nodes = [n for n in self.dataloader_nodes
                              if id(n) not in self.resident_dl]
        self.res_dl_nodes = [n for n in self.dataloader_nodes
                             if id(n) in self.resident_dl]

        # -- data parallelism: which batch inputs reach each node ----------
        # (a fetched value computed from a cut input is placed by the rule
        # in the module docstring; an all-reduce's output is every rank's)
        self.batch_inputs = {id(n) for n in self.dataloader_nodes} | {
            id(n) for n in self.feed_nodes if getattr(n, "batch", True)}
        self.batch_deps: dict[int, frozenset] = {}
        for n in self.topo:
            if id(n) in self.batch_inputs:
                deps = frozenset((id(n),))
            elif isinstance(n, AllReduceCommunicateOp) or n.is_optimizer:
                deps = frozenset()
            else:
                deps = frozenset().union(
                    *(self.batch_deps[id(i)] for i in n.inputs))
            self.batch_deps[id(n)] = deps

        # -- the quantized all-reduce, one group per optimizer node --------
        # {id(optimizer node): (marked ops, QarGroup)}; the walk skips the
        # ops and runs the group just before the node's apply
        self.qar_groups = self._group_qar_ops()
        self.qar_deferred = {id(op) for ops, _ in self.qar_groups.values()
                             for op in ops}

    def _group_qar_ops(self) -> dict:
        """Each optimizer node's marked inputs with the group state the
        executor made for them, where the node alone reads each of them.
        Otherwise (a hand-built ``allreduceCommunicate_op`` of a parameter
        whose value another node of this target also reads, say a gradient
        norm or a fetched value; ``insert_comm_ops`` wires each op it makes
        to its optimizer alone) every marked op of that node is computed
        when the walk reaches it, as a group of one
        (``TraceContext.allreduce``)."""
        readers: dict[int, list] = {}
        for n in self.topo:
            for i in n.inputs:
                readers.setdefault(id(i), []).append(n)
        groups = {}
        for node in self.optimizer_nodes:
            ops, state = self.executor.qar_groups.get(id(node), ((), None))
            if ops and all(len(readers[id(op)]) == 1 for op in ops):
                groups[id(node)] = (ops, state)
        return groups

    def _cast(self, value):
        """A floating tensor in the compute dtype (bf16 mode); anything
        else as it is."""
        cdtype = self.config.compute_dtype
        if isinstance(value, torch.Tensor) and value.is_floating_point() \
                and value.dtype != cdtype:
            return value.to(cdtype)
        return value

    def _leaf(self, node: Op, value):
        # a fed ND_Sparse_Array is no tensor: it never requires grad
        if id(node) in self.grad_x_ids and isinstance(value, torch.Tensor) \
                and value.is_floating_point():
            return value.detach().requires_grad_()
        return value

    def _enter(self, node: Op, value, cut: dict, whole: dict):
        """One input's value for this step: a batch input cut to this dp
        rank's share where dp divides its axis 0 (``cut``: its share's
        length, ``whole``: its global value)."""
        if id(node) in self.batch_inputs and self.config.dp_size > 1:
            local = self.executor._split_batch(value)
            if local is not value:
                cut[id(node)] = local.shape[0]
                whole[id(node)] = value
                value = local
        return self._leaf(node, self._cast(value))

    def _place(self, node: Op, v, cut: dict, whole: dict):
        """A fetched value computed from a cut batch input, as the global
        batch's (the rule in the module docstring)."""
        if id(node) in whole:
            return whole[id(node)]
        cfg = self.config
        lens = {cut[i] for i in self.batch_deps[id(node)] if i in cut}
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.ndim and len(lens) == 1 and v.shape[0] in lens:
                out = v.new_empty((v.shape[0] * cfg.dp_size,) + v.shape[1:])
                multihost.collective(dist.all_gather_into_tensor, out,
                                     v.contiguous(), group=cfg.dp_group)
                return out
            if v.numel() == 1:      # a batch mean: the mean of the ranks'
                t = v.clone()
                dist.all_reduce(t, op=dist.ReduceOp.SUM, group=cfg.dp_group)
                return t / cfg.dp_size
        shape = tuple(getattr(v, "shape", ()))
        raise ValueError(
            f"cannot fetch {node.name!r} under data parallelism: it is "
            f"computed from this rank's share of the batch (shares of "
            f"{sorted(lens)} rows), but it is neither one element (a batch "
            f"mean) nor batch-major (shape {shape}); fetch a batch mean or "
            "per-sample values instead")

    def run(self, feed_dict=None, convert_to_numpy_ret_vals=False,
            eval_node_list=None):
        ex = self.executor
        feed_dict = feed_dict or {}
        params = ex.state["params"]
        env: dict[int, Any] = {}
        cut: dict[int, int] = {}
        whole: dict[int, Any] = {}
        for node in self.param_nodes:
            env[id(node)] = self._leaf(node, self._cast(params[id(node)]))
        for node in self.feed_nodes:
            if node not in feed_dict:
                raise ValueError(f"Missing feed for placeholder {node.name!r}")
            env[id(node)] = self._enter(
                node, ex._prepare_input(feed_dict[node]), cut, whole)
        batch_host = {}
        for node in self.host_dl_nodes:
            batch_host[id(node)] = node.get_batch(self.name)
            env[id(node)] = self._enter(
                node, ex._prepare_input(batch_host[id(node)]), cut, whole)
        for node in self.res_dl_nodes:
            data, bs, bnum = self.resident_dl[id(node)]
            cur = self._dl_cursor.get(id(node), 0)
            self._dl_cursor[id(node)] = cur + 1
            start = (cur % bnum) * bs
            env[id(node)] = self._enter(node, data[start:start + bs], cut,
                                        whole)
        staged_idx = {}
        if ex.ps_runtime is not None:
            t0 = time.perf_counter()
            staged_idx = self._ps_pre_step(env, feed_dict, batch_host)
            ex.ps_runtime.perf["pre_step_s"] += time.perf_counter() - t0

        tc = TraceContext(self.config, self.training, env, params,
                          self.n_grad_contexts, ex.state["qresid"],
                          ex.state["step"], self.node_index,
                          {id(n): ex.state["op_state"][id(n)]
                           for n in self.stateful_nodes})
        slots_in = {id(n): ex.state["slots"][id(n)] for n in self.optimizer_nodes}
        with registry.active(self.config.kernels), \
                torch.set_grad_enabled(self.n_grad_contexts > 0):
            for node in self.order:
                if id(node) in env or id(node) in self.qar_deferred:
                    continue
                if node.is_placeholder:
                    raise ValueError(f"Placeholder {node.name} was not fed")
                if node.is_optimizer:
                    if id(node) in self.qar_groups:
                        ops, state = self.qar_groups[id(node)]
                        env.update(zip(map(id, ops), tc.allreduce_group(
                            ops, [env[id(op.inputs[0])] for op in ops],
                            state)))
                    node.apply_updates(env, slots_in[id(node)], tc)
                    env[id(node)] = None
                    continue
                vals = [env[id(i)] for i in node.inputs]
                if self.config.compute_dtype != torch.float32:
                    # every op boundary in the compute dtype: a stateful
                    # op's f32 output must not pull the next op back to f32
                    # (reference executor.py:468-478)
                    vals = [self._cast(v) for v in vals]
                if node.stateful:
                    out = self._stateful(node, vals, tc)
                else:
                    out = node.compute(vals, tc)
                env[id(node)] = self._leaf(node, out)
        if self.ps_comm_ops:
            t0 = time.perf_counter()
            self._ps_post_step(tc, staged_idx)
            ex.ps_runtime.perf["post_step_s"] += time.perf_counter() - t0

        if self.training:
            for node in self.param_nodes:
                params[id(node)] = tc.param_updates.get(id(node), params[id(node)])
            for node in self.optimizer_nodes:
                ex.state["slots"][id(node)] = tc.slot_updates[id(node)]
            ex.state["op_state"].update(tc.op_state_updates)
            ex.state["qresid"].update(tc.qresid_updates)
            ex.state["step"] += 1

        # an output that shares storage with a parameter (the parameter
        # itself, a reshape or broadcast of it) is copied: training steps
        # update parameters in place
        param_ptrs = {params[id(n)].untyped_storage().data_ptr()
                      for n in self.param_nodes}
        results = []
        wanted = eval_node_list if eval_node_list is not None else self.eval_nodes
        eval_ids = {id(n) for n in self.eval_nodes}
        for node in wanted:
            if node.is_optimizer or isinstance(node,
                                               ParameterServerCommunicateOp):
                results.append(None)
                continue
            if id(node) not in eval_ids:
                raise ValueError(
                    f"Node {node.name!r} is not among subexecutor "
                    f"{self.name!r}'s eval nodes; include it in the "
                    "eval_node_dict at Executor construction")
            v = env[id(node)]
            if self.batch_deps[id(node)] & cut.keys():
                v = self._place(node, v, cut, whole)
            if isinstance(v, IndexedRows):   # a rows-mode gradient: the pair
                results.append(IndexedRows(*(
                    _output(t, param_ptrs, convert_to_numpy_ret_vals)
                    for t in v)))
            else:
                results.append(_output(v, param_ptrs,
                                       convert_to_numpy_ret_vals))
        return results

    # -- the PS traffic at the step's boundary (reference executor.py:
    #    1364-1410, 1486-1530) ----------------------------------------------
    def _ps_ids(self, node, feed_dict, batch_host) -> np.ndarray:
        """The host value of a lookup's index input (a feed or a
        dataloader batch); on dp ranks this rank's share of it."""
        if node in feed_dict:
            v = feed_dict[node]
            if hasattr(v, "asnumpy"):
                v = v.asnumpy()
            elif isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            v = np.asarray(v)
        else:
            v = np.asarray(batch_host[id(node)])
        return self._ps_share(v)

    def _ps_share(self, v: np.ndarray) -> np.ndarray:
        cfg = self.config
        if cfg.dp_size > 1 and v.ndim and v.shape[0] % cfg.dp_size == 0:
            k = v.shape[0] // cfg.dp_size
            return v[cfg.dp_rank * k:(cfg.dp_rank + 1) * k]
        return v

    def _ps_pre_step(self, env, feed_dict, batch_host) -> dict:
        """Pull this batch's rows of every PS table and enter them as the
        lookups' outputs; enter each PS-hosted dense parameter's latest
        value. Returns each lookup's host ids, by op id."""
        ex = self.executor
        ps = ex.ps_runtime
        staged_idx: dict[int, np.ndarray] = {}
        staged_rows: dict[int, np.ndarray] = {}
        for tid, ops in self._staged_by_table.items():
            p = ps.params[tid]
            for op in ops:
                staged_idx[id(op)] = self._ps_ids(op.inputs[1], feed_dict,
                                                  batch_host)
            if len(ops) == 1:
                op = ops[0]
                idx = staged_idx[id(op)]
                rows = (ps.take_prefetched(id(op), idx)
                        if ps.async_enabled else None)
                if rows is None:
                    rows = ps.stage_lookup(p, idx)
                staged_rows[id(op)] = rows
            else:
                flat = [np.ascontiguousarray(staged_idx[id(op)],
                                             np.int64).ravel() for op in ops]
                union = np.unique(np.concatenate(flat))
                urows = (ps.take_prefetched(tid, union)
                         if ps.async_enabled else None)
                if urows is None:
                    urows = ps.stage_lookup(p, union)      # (U, *tail)
                tail = tuple(p.shape[1:])
                for op, f in zip(ops, flat):
                    pos = np.searchsorted(union, f)
                    staged_rows[id(op)] = urows[pos].reshape(
                        tuple(np.shape(staged_idx[id(op)])) + tail)
        for op in self.ps_staged_ops:
            env[id(op)] = self._leaf(op, self._cast(
                ex._prepare_input(staged_rows[id(op)])))
        for node in self.ps_sparse_vars:
            env[id(node)] = _PS_RESIDENT
        for node in self.ps_dense_vars:
            p = ps.params[id(node)]
            ps.wait_dense(p)       # an async DDPushPull refreshes host_value
            env[id(node)] = self._leaf(node, self._cast(
                ex._prepare_input(p.host_value)))
        return staged_idx

    def _ps_post_step(self, tc: TraceContext, staged_idx: dict):
        """Push each push op's gradient: its copy to the host is queued on
        the step's stream here, and the push waits for it. With async I/O
        the pushes go on the push stream, followed by the pulls of the next
        batch's rows (lookups fed by a dataloader)."""
        ps = self.executor.ps_runtime
        step = tc.step
        items = []
        for op in self.ps_comm_ops:
            grad = tc.ps_grad_outputs[id(op)]
            p = ps.params[id(op.ps_param_node)]
            if isinstance(grad, IndexedRows):
                items.append((p, ps_runtime.HostGrad(grad), "rows", None))
            elif p.sparse:
                items.append((p, ps_runtime.HostGrad(
                    grad if isinstance(grad, tuple) else (grad,)), "lookups",
                    [staged_idx[id(lk)] for lk in op.staged_lookups]))
            else:
                items.append((p, ps_runtime.HostGrad((grad,)), "dense",
                              None))
        if not ps.async_enabled:
            for item in items:
                ps.push_grad(*item, step=step)
            return
        ps.push_grads_async(items, step)
        for tid, ops in self._staged_by_table.items():
            idx_nodes = [op.inputs[1] for op in ops]
            if not all(n in self.dataloader_nodes for n in idx_nodes):
                continue
            nxt = [self._ps_share(np.asarray(n.peek_batch(self.name)))
                   for n in idx_nodes]
            if len(ops) == 1:
                ps.prefetch_lookup(id(ops[0]), ps.params[tid], nxt[0])
            else:
                ps.prefetch_lookup(tid, ps.params[tid], np.unique(
                    np.concatenate([np.ascontiguousarray(i, np.int64).ravel()
                                    for i in nxt])))

    @staticmethod
    def _stateful(node: Op, vals, tc: TraceContext):
        """A stateful op's output; its new state (detached, each leaf in
        its old dtype: bf16 compute must not round the f32 running stats,
        reference executor.py:494-499) goes to ``tc.op_state_updates``."""
        state_in = tc.op_state_in[id(node)]
        out, new = node.compute_stateful(vals, state_in, tc)
        tc.op_state_updates[id(node)] = {
            k: v.detach().to(state_in[k].dtype) for k, v in new.items()}
        return out


def _output(v: torch.Tensor, param_ptrs: set, to_numpy: bool):
    """One eval result, detached; a copy where it shares a parameter's
    storage (training updates parameters in place). As numpy, a bf16
    value comes back as float32."""
    v = v.detach()
    if v.untyped_storage().data_ptr() in param_ptrs:
        v = v.clone()
    return NDArray(v).asnumpy() if to_numpy else NDArray(v)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class Executor:
    """User-facing executor (reference executor.py:301)."""

    def __init__(self, eval_node_dict, ctx=None, seed=None, comm_mode=None,
                 **kwargs):
        if isinstance(eval_node_dict, (list, tuple)):
            eval_node_dict = {"default": list(eval_node_dict)}
        self.eval_node_dict = {k: list(v) for k, v in eval_node_dict.items()}
        all_nodes = [n for nodes in self.eval_node_dict.values() for n in nodes]
        config = self.config = HetuConfig(all_nodes, ctx=ctx, seed=seed,
                                          comm_mode=comm_mode, **kwargs)
        self.comm_mode = config.comm_mode
        # float32 matrix products and convolutions in full float32 (TF32
        # would keep about three decimal digits; PyTorch enables it for
        # cuDNN's convolutions by default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        full_topo = find_topo_sort(all_nodes)
        # under PS/Hybrid a variable read through an embedding lookup is a
        # sparse table (insert_comm_ops and PSRuntime classify alike)
        if config.comm_mode in ("PS", "Hybrid"):
            for node in full_topo:
                embed = getattr(node, "embed_node", None)
                if embed is not None and getattr(embed, "trainable", False):
                    embed.is_embed = True
        for node in full_topo:
            if node.is_optimizer:
                node.insert_comm_ops(config)
        full_topo = find_topo_sort(all_nodes)   # with the comm ops
        # graph nodes are shared between executors: a gradient op that an
        # earlier executor's PS wiring flipped to rows mode comes back
        # dense (under the PS modes any rows-mode op does, as the
        # reference resets them, and this executor's wiring flips the ones
        # it routes; an op the caller flipped stays in rows mode
        # otherwise), and a push forgets an earlier wiring
        ps_modes = config.comm_mode in ("PS", "Hybrid")
        for node in full_topo:
            if getattr(node, "rows_mode", False) and (
                    ps_modes or getattr(node, "rows_by_ps", False)):
                node.to_dense()
                node.rows_by_ps = False
            if isinstance(node, ParameterServerCommunicateOp):
                node.ps_param_node = None
                node.staged_lookups = None
        self.ps_runtime = None
        if config.comm_mode in ("PS", "Hybrid"):
            self.ps_runtime = ps_runtime.PSRuntime(config, full_topo)
            self._rewire_ps_gradients(full_topo)
        ps_resident = (set(self.ps_runtime.params)
                       if self.ps_runtime is not None else set())
        self.param_nodes = [n for n in full_topo
                            if n.is_placeholder and not getattr(n, "is_feed", True)
                            and id(n) not in ps_resident]

        # -- parameter initialization: one CPU generator per parameter,
        # seeded from (executor seed, topo index), then moved to the device
        params = {}
        for i, node in enumerate(self.param_nodes):
            seed_i = np.random.SeedSequence([int(config.seed), i]).generate_state(
                1, np.uint64)[0]
            gen = torch.Generator().manual_seed(int(seed_i))
            params[id(node)] = self._place_param(node, node.instantiate(gen))
        if config.dp_group is not None:
            # every rank drew the same values; rank 0's are the ones kept
            src = dist.get_global_rank(config.dp_group, 0)
            for p in params.values():
                dist.broadcast(p, src=src, group=config.dp_group)

        # -- quantized all-reduce: which ops, and their residuals ----------
        # (reference executor.py:1862-1907) The mark is reset first: graph
        # nodes are shared between executors, and a mark left by an earlier
        # quantized executor must not reach this one.
        qpol = config.comm_quant_policy
        self.qar_ops = []
        qresid = {}
        for node in full_topo:
            if not isinstance(node, AllReduceCommunicateOp):
                continue
            node.comm_quant = False
            if not qpol.active or config.mesh is None:
                continue
            pn = node.param_node
            val = params.get(id(pn)) if pn is not None else None
            if val is None or not val.is_floating_point():
                continue
            if qpol.applies(pn, val.numel()):
                node.comm_quant = True
                self.qar_ops.append(node)
                if qpol.error_feedback:
                    qresid[id(node)] = torch.zeros(
                        cq.shard_size(val.numel(), config.dp_size, qpol.block),
                        dtype=torch.float32, device=config.device)
        # the marked inputs of each optimizer node are all-reduced as one
        # group, whose state (plan, buffers, residuals) is made here once:
        # each op's residual is a view of its group's residual buffer
        self.qar_groups = {}
        grouped = set()
        marked = {id(n) for n in self.qar_ops}
        for node in full_topo:
            if not node.is_optimizer:
                continue
            ops = [i for i in node.inputs
                   if id(i) in marked and id(i) not in grouped]
            if not ops:
                continue
            grouped.update(map(id, ops))
            state = cq.QarGroup([params[id(op.param_node)].numel()
                                 for op in ops], config.dp_size, qpol,
                                config.device)
            self.qar_groups[id(node)] = (ops, state)
            if qpol.error_feedback:
                qresid.update(zip(map(id, ops), state.residual_views()))
        self.comm_quant_report = None
        if self.qar_ops:
            self.comm_quant_report = cq.allreduce_wire_report(
                {n.param_node.name: params[id(n.param_node)].numel()
                 for n in self.qar_ops}, qpol, config.dp_size)

        slots, op_state = {}, {}
        for node in full_topo:
            if node.is_optimizer:
                slots[id(node)] = node.init_slots(
                    {id(v): params[id(v)] for v in node.vars
                     if id(v) in params})
            if node.stateful:
                op_state[id(node)] = self._place_state(node.state_init())
        self.state = {"params": params, "slots": slots, "op_state": op_state,
                      "qresid": qresid, "step": 0}

        self.subexecutors = {name: SubExecutor(name, nodes, self)
                             for name, nodes in self.eval_node_dict.items()}

    # ------------------------------------------------------------------
    def _rewire_ps_gradients(self, topo):
        """Point each push's gradient at the lookup's output instead of the
        table (reference executor.py:2016-2080): the staged rows take the
        table's place among its gradient context's ``xs``, so autograd
        gives ``d loss / d rows`` and never a table-sized gradient. An
        explicit ``embedding_lookup_gradient_op`` whose only consumer is
        the push flips to rows mode (``fused_embed_grad``'s compact form)."""
        ps = self.ps_runtime
        loss_topo_ids: dict[int, set] = {}
        ps_by_name = {p.node.name: p for p in ps.params.values()}
        consumers: dict[int, list] = {}
        for n in topo:
            for i in n.inputs:
                consumers.setdefault(id(i), []).append(n)
        eval_ids = {id(n) for ns in self.eval_node_dict.values() for n in ns}
        for node in topo:
            if not isinstance(node, ParameterServerCommunicateOp):
                continue
            grad_node = node.inputs[0]
            if not getattr(grad_node, "is_gradient", False):
                if embed_grad_push_routable(node, grad_node, consumers,
                                            eval_ids) \
                        and node.ps_id in ps_by_name:
                    p = ps_by_name[node.ps_id]
                    if p.sparse and tuple(grad_node.embed_shape) == p.shape:
                        grad_node.to_rows()
                        grad_node.rows_by_ps = True
                        node.ps_param_node = p.node
                continue
            var = grad_node.x
            p = ps.params.get(id(var))
            if p is None:
                continue
            node.ps_param_node = var
            if not p.sparse:
                continue  # a dense PS param is fed whole: its own gradient
            # the lookups on THIS gradient's loss graph: another target's
            # lookup (a validate head) or an inference-only sparse pull
            # yields no gradient
            loss = grad_node.gctx.loss
            loss_ids = loss_topo_ids.get(id(loss))
            if loss_ids is None:
                loss_ids = {id(n) for n in find_topo_sort([loss])}
                loss_topo_ids[id(loss)] = loss_ids
            lookups = [lk for lk in p.lookup_ops
                       if id(lk) in loss_ids
                       and not isinstance(lk, ParameterServerSparsePullOp)]
            if not lookups:
                raise ValueError(
                    f"PS-hosted embedding {var.name!r} has a gradient but no "
                    "lookup op reads it on the loss graph: a sparse PS table "
                    "trains only through embedding_lookup_op")
            node.staged_lookups = lookups
            xs = grad_node.gctx.xs
            grad_node.x = lookups[0]
            for i, x in enumerate(xs):
                if x is var:
                    xs[i] = lookups[0]
            if len(lookups) == 1:
                grad_node.inputs = [grad_node.gctx.loss, lookups[0]]
            else:
                # one table, several lookups: the gradient of each; the push
                # concatenates their rows and sums duplicates on the host
                grad_node.multi_x = lookups
                grad_node.inputs = [grad_node.gctx.loss] + lookups
                for lk in lookups[1:]:
                    if all(x is not lk for x in xs):
                        xs.append(lk)

    def close(self):
        """Drain and stop the PS streams (reference executor.py:2374).
        Safe to call more than once; later steps push on the caller's
        thread."""
        if self.ps_runtime is not None:
            self.ps_runtime.drain()
            self.ps_runtime.shutdown()

    def fetch_dense_parameter_value(self, nodes):
        """Current parameter values; a PS-hosted dense parameter is pulled
        from its server."""
        out = []
        for n in nodes:
            p = (self.ps_runtime.params.get(id(n))
                 if self.ps_runtime is not None else None)
            if p is not None:
                out.append(NDArray(torch.from_numpy(
                    self.ps_runtime.pull_dense_value(p))))
            else:
                out.append(NDArray(self.state["params"][id(n)]))
        return out

    def _prepare_input(self, value) -> torch.Tensor:
        """Stage one host value onto the executor's device. A sparse array
        moves only from another device, once (``ND_Sparse_Array.to``)."""
        if isinstance(value, ND_Sparse_Array):
            return value.to(self.config.device)
        if isinstance(value, NDArray):
            value = value.handle
        if isinstance(value, torch.Tensor):
            return value.detach().to(self.config.device)
        arr = np.asarray(value)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.config.device)

    def _split_batch(self, value):
        """This dp rank's contiguous share of ``value``'s axis 0, or
        ``value`` itself, with a warning, where dp does not divide it."""
        dp = self.config.dp_size
        if not isinstance(value, torch.Tensor) or value.ndim == 0:
            return value
        b = value.shape[0]
        if b % dp:
            warnings.warn(
                f"batch dim {b} is not divisible by dp={dp}: the feed is "
                "REPLICATED across the dp axis instead of sharded (correct "
                "but slow) — pad the batch or use drop_last", stacklevel=4)
            return value
        k = b // dp
        return value[self.config.dp_rank * k:(self.config.dp_rank + 1) * k]

    def _place_state(self, state: dict) -> dict:
        """An op's state (a dict of host arrays) on the executor's device,
        each leaf in its own dtype."""
        return {k: torch.from_numpy(np.array(v)).to(self.config.device)
                for k, v in state.items()}

    def _place_param(self, node, value) -> torch.Tensor:
        """A host value as this parameter's device-resident tensor (the same
        placement rule for init, load and interop)."""
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value, dtype=node.dtype))
        return value.to(self.config.device).contiguous()

    def run(self, name="default", eval_node_list=None, feed_dict=None,
            convert_to_numpy_ret_vals=False):
        if isinstance(name, (dict, list, tuple)):  # run(feed_dict) legacy form
            feed_dict, name = name, "default"
        sub = self.subexecutors[name]
        return sub.run(feed_dict=feed_dict,
                       convert_to_numpy_ret_vals=convert_to_numpy_ret_vals,
                       eval_node_list=eval_node_list)

    def get_batch_num(self, name="default"):
        """Batches per epoch for the target's dataloaders (min across them)."""
        nums = [n.get_batch_num(name)
                for n in self.subexecutors[name].dataloader_nodes]
        return min(nums) if nums else None

    def _param_file_names(self):
        """Stable, collision-free file name per parameter: duplicates get a
        deterministic __<k> suffix (construction order)."""
        counts: dict[str, int] = {}
        names = []
        for node in self.param_nodes:
            k = counts.get(node.name, 0)
            counts[node.name] = k + 1
            names.append(node.name if k == 0 else f"{node.name}__{k}")
        return names

    def _opt_nodes(self):
        return self._nodes_of("optimizer_nodes")

    def _stateful_nodes(self):
        """The stateful nodes in the order the checkpoint numbers them
        (reference executor.py:2365)."""
        return self._nodes_of("stateful_nodes")

    def _nodes_of(self, attr):
        seen, out = set(), []
        for sub in self.subexecutors.values():
            for n in getattr(sub, attr):
                if id(n) not in seen:
                    seen.add(id(n))
                    out.append(n)
        return out

    # -- checkpoint in the reference's on-disk format (executor.py:2289) --
    def save(self, file_path: str):
        """One ``<param>.npy`` per parameter plus ``executor_state.pkl``
        with ``step``, ``slots``, the op state ``op_state`` (BatchNorm's
        running stats, keyed by the stateful node's index) and the
        error-feedback residuals ``qresid`` (each in its parameter's full
        shape, float32) — what ``hetu_tpu``'s ``load`` reads. Under data parallelism every rank
        calls it (the residuals are gathered from their shards) and dp
        rank 0 writes."""
        qresid = {str(i): self._full_qresid(n)
                  for i, n in enumerate(self._qresid_ordered())}
        if self.ps_runtime is not None:
            os.makedirs(file_path, exist_ok=True)
            self.ps_runtime.save(file_path)
        if self.config.dp_rank == 0:
            os.makedirs(file_path, exist_ok=True)
            for node, fname in zip(self.param_nodes,
                                   self._param_file_names()):
                np.save(os.path.join(file_path, fname + ".npy"),
                        self.state["params"][id(node)].detach().cpu().numpy())
            aux = {
                "step": self.state["step"],
                "slots": {str(i): _tree_map(
                    lambda t: t.detach().cpu().numpy(),
                    self.state["slots"][id(n)])
                    for i, n in enumerate(self._opt_nodes())},
                "op_state": {str(i): _tree_map(
                    lambda t: t.detach().cpu().numpy(),
                    self.state["op_state"][id(n)])
                    for i, n in enumerate(self._stateful_nodes())},
                "qresid": qresid,
            }
            with open(os.path.join(file_path, "executor_state.pkl"),
                      "wb") as f:
                pickle.dump(aux, f)
        if self.config.dp_group is not None:
            dist.barrier(group=self.config.dp_group)

    def _qresid_ordered(self):
        """The quantized all-reduce ops that hold a residual, in the order
        the checkpoint numbers them (the marking's scan order)."""
        return [n for n in self.qar_ops if id(n) in self.state["qresid"]]

    def _full_qresid(self, op) -> np.ndarray:
        """An op's residual in its parameter's shape, gathered from the dp
        ranks' shards."""
        shard = self.state["qresid"][id(op)]
        cfg = self.config
        if cfg.dp_group is not None:
            full = shard.new_empty(shard.numel() * cfg.dp_size)
            multihost.collective(dist.all_gather_into_tensor, full, shard,
                                 group=cfg.dp_group)
            shard = full
        param = self.state["params"][id(op.param_node)]
        return shard[:param.numel()].reshape(param.shape).cpu().numpy()

    def load(self, file_path: str):
        """Read a directory written by ``save`` here or by ``hetu_tpu``'s
        ``Executor.save``."""
        if self.ps_runtime is not None:
            self.ps_runtime.load(file_path)
        for node, fname in zip(self.param_nodes, self._param_file_names()):
            path = os.path.join(file_path, fname + ".npy")
            if os.path.exists(path):
                self.state["params"][id(node)] = self._place_param(
                    node, np.load(path))
        aux_path = os.path.join(file_path, "executor_state.pkl")
        if os.path.exists(aux_path):
            with open(aux_path, "rb") as f:
                aux = pickle.load(f)
            self.state["step"] = int(aux.get("step", 0))
            for i, n in enumerate(self._opt_nodes()):
                if str(i) in aux.get("slots", {}):
                    self.state["slots"][id(n)] = _tree_map(
                        lambda a: torch.from_numpy(np.array(a)).to(
                            self.config.device),
                        aux["slots"][str(i)])
            for i, n in enumerate(self._stateful_nodes()):
                if str(i) in aux.get("op_state", {}):
                    self.state["op_state"][id(n)] = self._place_state(
                        aux["op_state"][str(i)])
            # each residual in full shape, cut to this dp rank's shard and
            # copied into its entry (a view of its group's buffer)
            for i, n in enumerate(self._qresid_ordered()):
                if str(i) in aux.get("qresid", {}):
                    shard = self.state["qresid"][id(n)]
                    flat = np.zeros(shard.numel() * self.config.dp_size,
                                    np.float32)
                    full = np.asarray(aux["qresid"][str(i)], np.float32)
                    flat[:full.size] = full.reshape(-1)
                    r = self.config.dp_rank
                    shard.copy_(torch.from_numpy(
                        flat[r * shard.numel():(r + 1) * shard.numel()]))


# ---------------------------------------------------------------------------
# distributed bootstrap shims (reference executor.py:2406-2431), so that the
# reference's call sites (``comm, rank = ht.mpi_nccl_init()``) run unchanged
# ---------------------------------------------------------------------------

class _Comm:
    """The reference's communicator handle: this process's rank and the
    world's size."""

    def __init__(self):
        self.rank = multihost.process_index()
        self.nrank = multihost.process_count()

    def local_rank(self):
        return int(os.environ.get("LOCAL_RANK", self.rank))


def wrapped_mpi_nccl_init(init_nccl=True, devices=None):
    """Join the process group that ``hetu_tpu_torch.runner`` set up in the
    environment, over NCCL on ``cuda:LOCAL_RANK`` (``init_nccl=True``) or
    over gloo on the CPU (``init_nccl=False``). Outside the runner it is a
    world of one process and joins nothing."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    multihost.initialize(device=torch.device("cuda", local) if init_nccl
                         else torch.device("cpu"))
    return _Comm()


def mpi_nccl_init(init_nccl=True):
    comm = wrapped_mpi_nccl_init(init_nccl)
    return comm, comm.rank


def mpi_nccl_finish(comm=None):
    multihost.shutdown()


def new_group_comm(devices=None):
    """The default group: sub-groups arrive with slice 8."""
    if devices is not None:
        raise NotImplementedError(
            "new_group_comm(devices): sub-groups of pipeline stages arrive "
            "with slice 8 (TP, PP, ZeRO)")
    return None
