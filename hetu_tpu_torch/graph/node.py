"""Graph node (Op) base classes for the define-then-run frontend
(counterpart of ``hetu_tpu/graph/node.py``).

``compute`` is a plain function of torch tensors, called eagerly once per
step by the executor. Autodiff is graph-level via
``hetu_tpu_torch.graph.gradients`` (``torch.autograd.grad`` over the
evaluated forward), so ops carry no symbolic ``gradient`` method; the
explicit ``*_gradient_op`` constructors exist for API parity. Stateful ops
(BatchNorm's running stats) declare their state through ``stateful``/
``state_init`` and the executor threads it from step to step; an op that
draws random bits (dropout) sets ``needs_rng`` and takes a generator from
the step context (``tc.next_rng``).
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..context import get_current_context, DeviceGroup
from ..ndarray import ND_Sparse_Array

_id_counter = itertools.count()


def _as_meta(x) -> torch.Tensor:
    """A shape tuple / array / tensor as a tensor on the ``meta`` device.

    Bare shape tuples keep the historical ``infer_shape`` contract of
    assuming float32 inputs (reference Node.py:95 is shape-only). A sparse
    array passes through: the sparse ops read only its shape."""
    if isinstance(x, ND_Sparse_Array):
        return x
    if isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        dtype = torch.from_numpy(np.empty(0, np.dtype(x.dtype))).dtype
        return torch.empty(tuple(x.shape), dtype=dtype, device="meta")
    return torch.empty(tuple(int(s) for s in x), dtype=torch.float32,
                       device="meta")


class Op:
    """Base graph node. Users compose these via the ``*_op`` constructors."""

    # class-level flags the executor dispatches on
    is_placeholder = False   # fed via feed_dict or a Variable
    is_dataloader = False
    is_optimizer = False
    is_gradient = False
    stateful = False         # has state threaded by the executor
    needs_rng = False        # draws random bits in a training step

    def __init__(self, inputs: Sequence["Op"], ctx=None, name: Optional[str] = None):
        self.id = next(_id_counter)
        self.inputs = list(inputs)
        if ctx is None:
            ctx = get_current_context()
        self.raw_ctx = ctx if (ctx is None or isinstance(ctx, DeviceGroup)) else DeviceGroup(ctx)
        self.name = name or f"{type(self).__name__}_{self.id}"

    # ------------------------------------------------------------------
    def compute(self, input_vals, tc):
        """Eager computation: list of tensors -> tensor."""
        raise NotImplementedError(type(self).__name__)

    def compute_stateful(self, input_vals, state, tc):
        """Stateful computation -> ``(output, new_state)``."""
        raise NotImplementedError(type(self).__name__)

    def state_init(self):
        """Initial state of a stateful op: a dict of numpy arrays."""
        raise NotImplementedError(type(self).__name__)

    def infer_meta(self, inputs, training: bool = False) -> torch.Tensor:
        """Abstract-evaluate this op on ``meta`` tensors: input shapes/dtypes
        -> an output meta tensor, without touching any data.

        ``inputs`` items may be bare shape tuples (assumed float32),
        tensors or arrays. A stateful op is evaluated through
        ``compute_stateful`` over its ``state_init`` on meta tensors."""
        metas = [_as_meta(s) for s in inputs]
        tc = _AbstractTraceContext(training)
        if self.stateful:
            state = {k: _as_meta(v) for k, v in self.state_init().items()}
            return self.compute_stateful(metas, state, tc)[0]
        return self.compute(metas, tc)

    def infer_shape(self, input_shapes):
        """Shape inference via abstract evaluation (reference Node.py:95)."""
        out = self.infer_meta(input_shapes)
        return tuple(out.shape) if hasattr(out, "shape") else None

    # -- operator overloads (reference Node.py:33-71) -------------------
    def __add__(self, other):
        from .ops import add_op, addbyconst_op
        if isinstance(other, Op):
            return add_op(self, other)
        return addbyconst_op(self, other)

    __radd__ = __add__

    def __mul__(self, other):
        from .ops import mul_op, mul_byconst_op
        if isinstance(other, Op):
            return mul_op(self, other)
        return mul_byconst_op(self, other)

    __rmul__ = __mul__

    def __sub__(self, other):
        from .ops import add_op, addbyconst_op, opposite_op
        if isinstance(other, Op):
            return add_op(self, opposite_op(other))
        return addbyconst_op(self, -other)

    def __rsub__(self, other):
        from .ops import addbyconst_op, opposite_op
        return addbyconst_op(opposite_op(self), other)

    def __neg__(self):
        from .ops import opposite_op
        return opposite_op(self)

    def __truediv__(self, other):
        from .ops import div_op, mul_byconst_op
        if isinstance(other, Op):
            return div_op(self, other)
        return mul_byconst_op(self, 1.0 / other)

    def __rtruediv__(self, other):
        from .ops import div_const_op
        return div_const_op(other, self)

    def __repr__(self):
        return self.name


class _AbstractTraceContext:
    """Step context for abstract evaluation (``infer_shape``/``infer_meta``)."""

    def __init__(self, training: bool = False):
        self.training = bool(training)
        self.sync_group = None

    def next_rng(self, node):
        """No generator: meta tensors draw no bits."""
        return None


class FunctionalOp(Op):
    """An op whose compute is a closed-over plain function — the workhorse."""

    def __init__(self, opname: str, fn: Callable, inputs: Sequence[Op], ctx=None,
                 name: Optional[str] = None, **attrs):
        super().__init__(inputs, ctx, name or f"{opname}_{next(_id_counter)}")
        self.opname = opname
        self.fn = fn
        self.attrs = attrs

    def compute(self, input_vals, tc):
        return self.fn(*input_vals, **self.attrs)


class PlaceholderOp(Op):
    """Leaf node: a trainable Variable, a constant, or a fed placeholder.

    Reference ``gpu_ops/Variable.py`` — ``Variable(name, value=...)`` with an
    initializer produces a parameter; with neither it is fed via feed_dict.
    """

    is_placeholder = True

    def __init__(self, name, value=None, initializer=None, trainable=None,
                 dtype=np.float32, ctx=None, batch=None, **kwargs):
        super().__init__([], ctx, name)
        # is dim 0 a batch dimension, cut over data parallelism? Fed
        # placeholders: yes unless batch=False (a constant mask, say).
        # ``kwargs`` are accepted for API parity.
        self.batch = True if batch is None else bool(batch)
        self.initializer = initializer
        self.dtype = np.dtype(dtype)
        if value is not None and not isinstance(value, np.ndarray):
            value = np.asarray(value, dtype=self.dtype)
        self.value = value
        has_data = value is not None or initializer is not None
        if trainable is None:
            trainable = has_data
        if trainable and not has_data:
            raise ValueError(
                f"Variable {name!r} is trainable=True but has neither a value "
                "nor an initializer; fed placeholders must be trainable=False")
        self.trainable = trainable
        self.shape = None
        if value is not None:
            self.shape = tuple(value.shape)
        elif initializer is not None:
            self.shape = tuple(initializer.shape)

    @property
    def is_feed(self) -> bool:
        return self.value is None and self.initializer is None

    def instantiate(self, generator: torch.Generator) -> torch.Tensor:
        """Produce the initial parameter value on the CPU (executor init)."""
        if self.value is not None:
            return torch.from_numpy(np.array(self.value, dtype=self.dtype))
        if self.initializer is not None:
            return self.initializer.init(generator, self.dtype)
        raise ValueError(f"Placeholder {self.name} has no value; feed it via feed_dict")

    def compute(self, input_vals, tc):
        raise AssertionError("PlaceholderOp values are supplied by the executor")


def Variable(name, value=None, initializer=None, trainable=None, dtype=np.float32,
             ctx=None, batch=None, **kwargs):
    """Create a variable/placeholder node (reference gpu_ops/Variable.py)."""
    return PlaceholderOp(name, value=value, initializer=initializer,
                         trainable=trainable, dtype=dtype, ctx=ctx,
                         batch=batch, **kwargs)


placeholder_op = Variable


def find_topo_sort(node_list: Sequence[Op]) -> list[Op]:
    """Post-order DFS topological sort (reference executor.py:1175)."""
    visited: set[int] = set()
    order: list[Op] = []

    def dfs(node: Op):
        stack = [(node, iter(node.inputs))]
        if id(node) in visited:
            return
        visited.add(id(node))
        while stack:
            cur, it = stack[-1]
            advanced = False
            for child in it:
                if id(child) not in visited:
                    visited.add(id(child))
                    stack.append((child, iter(child.inputs)))
                    advanced = True
                    break
            if not advanced:
                order.append(cur)
                stack.pop()

    for n in node_list:
        dfs(n)
    return order
