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
Lint, plan, telemetry, watch, pilot, elastic, PS and mesh arrive with
later slices; so does capturing the step in a CUDA graph.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..context import DeviceGroup
from ..kernels import registry
from ..ndarray import NDArray, ND_Sparse_Array
from .node import Op, find_topo_sort
from .ops.embedding import IndexedRows


def _resolve_device(ctx) -> torch.device:
    """The one device this slice runs on: ``ctx=None`` is ``cuda:0``."""
    if ctx is None:
        dev = torch.device("cuda", 0)
    else:
        ctxs = (ctx if isinstance(ctx, DeviceGroup) else DeviceGroup(ctx)).flat()
        if len(ctxs) != 1:
            raise NotImplementedError(
                f"ctx={ctx!r}: hetu_tpu_torch runs on one device in this "
                "slice; pass one context such as ht.gpu(0) or ht.cpu(0)")
        dev = ctxs[0].torch_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the executor runs on {dev} (ctx={ctx!r}) but "
            "torch.cuda.is_available() is False; pass ctx=ht.cpu(0) to run "
            "on the CPU")
    return dev


class HetuConfig:
    """Execution configuration (reference executor.py:103): the device,
    the seed and the kernel mode. Options of the reference that this slice
    has not ported are refused."""

    def __init__(self, eval_node_list, ctx=None, seed=None, comm_mode=None,
                 kernels=None):
        self.eval_node_list = eval_node_list
        self.ctx = ctx
        self.seed = seed if seed is not None else np.random.randint(0, 2**31 - 1)
        self.comm_mode = comm_mode
        self.kernels = registry.resolve_mode(kernels)
        self.device = _resolve_device(ctx)


class TraceContext:
    """Per-step services handed to ``Op.compute`` (the reference's per-trace
    context): the step's values, the parameters, and autodiff."""

    def __init__(self, training: bool, env: dict, params: dict,
                 n_grad_contexts: int):
        self.training = training
        self.env = env
        self.params = params            # id(node) -> state tensor
        self.param_updates: dict[int, Any] = {}
        self.slot_updates: dict[int, Any] = {}
        self.grad_cache: dict[int, dict[int, Any]] = {}
        # one backward per GradientContext; the graph is kept for the next
        # context while any remains
        self._grads_left = n_grad_contexts

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

        # -- device-resident datasets (reference executor.py:609-630) -------
        # A small, sequential (no shuffle/func, drop_last) dataset uploads to
        # the device ONCE and the step slices its batch by a cursor: no
        # host-to-device copy per step.
        self.resident_dl: dict[int, tuple] = {}
        self._dl_cursor: dict[int, int] = {}
        limit = float(os.environ.get("HETU_DEVICE_DATA_MB", "1024")) * 1e6
        for n in self.dataloader_nodes:
            dl = n.dataloaders.get(self.name)
            if (dl is not None and dl.func is None and not dl.shuffle
                    and dl.drop_last and dl._data.nbytes <= limit):
                self.resident_dl[id(n)] = (
                    executor._prepare_input(dl._data), dl.batch_size,
                    dl.batch_num)
        self.host_dl_nodes = [n for n in self.dataloader_nodes
                              if id(n) not in self.resident_dl]
        self.res_dl_nodes = [n for n in self.dataloader_nodes
                             if id(n) in self.resident_dl]

    def _leaf(self, node: Op, value):
        # a fed ND_Sparse_Array is no tensor: it never requires grad
        if id(node) in self.grad_x_ids and isinstance(value, torch.Tensor) \
                and value.is_floating_point():
            return value.detach().requires_grad_()
        return value

    def run(self, feed_dict=None, convert_to_numpy_ret_vals=False,
            eval_node_list=None):
        ex = self.executor
        feed_dict = feed_dict or {}
        params = ex.state["params"]
        env: dict[int, Any] = {}
        for node in self.param_nodes:
            env[id(node)] = self._leaf(node, params[id(node)])
        for node in self.feed_nodes:
            if node not in feed_dict:
                raise ValueError(f"Missing feed for placeholder {node.name!r}")
            env[id(node)] = self._leaf(node, ex._prepare_input(feed_dict[node]))
        for node in self.host_dl_nodes:
            env[id(node)] = self._leaf(
                node, ex._prepare_input(node.get_batch(self.name)))
        for node in self.res_dl_nodes:
            data, bs, bnum = self.resident_dl[id(node)]
            cur = self._dl_cursor.get(id(node), 0)
            self._dl_cursor[id(node)] = cur + 1
            start = (cur % bnum) * bs
            env[id(node)] = self._leaf(node, data[start:start + bs])

        tc = TraceContext(self.training, env, params, self.n_grad_contexts)
        slots_in = {id(n): ex.state["slots"][id(n)] for n in self.optimizer_nodes}
        with registry.active(self.config.kernels), \
                torch.set_grad_enabled(self.n_grad_contexts > 0):
            for node in self.order:
                if id(node) in env:
                    continue
                if node.is_placeholder:
                    raise ValueError(f"Placeholder {node.name} was not fed")
                if node.is_optimizer:
                    node.apply_updates(env, slots_in[id(node)], tc)
                    env[id(node)] = None
                    continue
                env[id(node)] = self._leaf(
                    node, node.compute([env[id(i)] for i in node.inputs], tc))

        if self.training:
            for node in self.param_nodes:
                params[id(node)] = tc.param_updates.get(id(node), params[id(node)])
            for node in self.optimizer_nodes:
                ex.state["slots"][id(node)] = tc.slot_updates[id(node)]
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
            if node.is_optimizer:
                results.append(None)
                continue
            if id(node) not in eval_ids:
                raise ValueError(
                    f"Node {node.name!r} is not among subexecutor "
                    f"{self.name!r}'s eval nodes; include it in the "
                    "eval_node_dict at Executor construction")
            v = env[id(node)]
            if isinstance(v, IndexedRows):   # a rows-mode gradient: the pair
                results.append(IndexedRows(*(
                    _output(t, param_ptrs, convert_to_numpy_ret_vals)
                    for t in v)))
            else:
                results.append(_output(v, param_ptrs,
                                       convert_to_numpy_ret_vals))
        return results


def _output(v: torch.Tensor, param_ptrs: set, to_numpy: bool):
    """One eval result, detached; a copy where it shares a parameter's
    storage (training updates parameters in place)."""
    v = v.detach()
    if v.untyped_storage().data_ptr() in param_ptrs:
        v = v.clone()
    return v.cpu().numpy() if to_numpy else NDArray(v)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class Executor:
    """User-facing executor (reference executor.py:301)."""

    def __init__(self, eval_node_dict, ctx=None, seed=None, comm_mode=None,
                 kernels=None):
        if isinstance(eval_node_dict, (list, tuple)):
            eval_node_dict = {"default": list(eval_node_dict)}
        self.eval_node_dict = {k: list(v) for k, v in eval_node_dict.items()}
        all_nodes = [n for nodes in self.eval_node_dict.values() for n in nodes]
        config = self.config = HetuConfig(all_nodes, ctx=ctx, seed=seed,
                                          comm_mode=comm_mode, kernels=kernels)
        self.comm_mode = config.comm_mode
        # float32 matrix products in full float32 (the PyTorch default,
        # stated here: TF32 would keep about three decimal digits)
        torch.backends.cuda.matmul.allow_tf32 = False

        full_topo = find_topo_sort(all_nodes)
        for node in full_topo:
            if node.is_optimizer:
                node.insert_comm_ops(config)
        self.param_nodes = [n for n in full_topo
                            if n.is_placeholder and not getattr(n, "is_feed", True)]

        # -- parameter initialization: one CPU generator per parameter,
        # seeded from (executor seed, topo index), then moved to the device
        params = {}
        for i, node in enumerate(self.param_nodes):
            seed_i = np.random.SeedSequence([int(config.seed), i]).generate_state(
                1, np.uint64)[0]
            gen = torch.Generator().manual_seed(int(seed_i))
            params[id(node)] = self._place_param(node, node.instantiate(gen))
        slots = {}
        for node in full_topo:
            if node.is_optimizer:
                slots[id(node)] = node.init_slots(
                    {id(v): params[id(v)] for v in node.vars})
        self.state = {"params": params, "slots": slots, "step": 0}

        self.subexecutors = {name: SubExecutor(name, nodes, self)
                             for name, nodes in self.eval_node_dict.items()}

    # ------------------------------------------------------------------
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
        seen, out = set(), []
        for sub in self.subexecutors.values():
            for n in sub.optimizer_nodes:
                if id(n) not in seen:
                    seen.add(id(n))
                    out.append(n)
        return out

    # -- checkpoint in the reference's on-disk format (executor.py:2289) --
    def save(self, file_path: str):
        """One ``<param>.npy`` per parameter plus ``executor_state.pkl``
        with ``step`` and ``slots`` — what ``hetu_tpu``'s ``load`` reads."""
        os.makedirs(file_path, exist_ok=True)
        for node, fname in zip(self.param_nodes, self._param_file_names()):
            np.save(os.path.join(file_path, fname + ".npy"),
                    self.state["params"][id(node)].detach().cpu().numpy())
        aux = {
            "step": self.state["step"],
            "slots": {str(i): _tree_map(lambda t: t.detach().cpu().numpy(),
                                        self.state["slots"][id(n)])
                      for i, n in enumerate(self._opt_nodes())},
            "op_state": {},
            "qresid": {},
        }
        with open(os.path.join(file_path, "executor_state.pkl"), "wb") as f:
            pickle.dump(aux, f)

    def load(self, file_path: str):
        """Read a directory written by ``save`` here or by ``hetu_tpu``'s
        ``Executor.save``."""
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
