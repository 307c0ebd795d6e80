"""Graph-level autodiff: ``ht.gradients(loss, node_list)`` (counterpart of
``hetu_tpu/graph/gradients.py``).

The reference takes ``jax.grad`` of a re-trace of the downstream sub-graph.
Here the executor evaluates the forward once with ``requires_grad`` on the
``xs`` and a ``GradientOp`` asks the step context for
``torch.autograd.grad`` of ``sum(loss)``, cached per ``GradientContext``
so that one backward pass serves every x of one ``gradients()`` call.
"""
from __future__ import annotations

from typing import Sequence

from .node import Op


class GradientContext:
    """Shared bookkeeping for one ``gradients(loss, xs)`` call."""

    def __init__(self, loss: Op, xs: list[Op]):
        self.loss = loss
        self.xs = xs


class GradientOp(Op):
    """d(loss)/d(x) for one x. Inputs = [loss, x] so topo ordering places the
    full forward graph before the gradient is needed.

    ``multi_x``: a tuple of nodes whose gradients this node yields as a
    tuple instead of one tensor (the PS route of the CTR slice sets it; no
    code of this slice does)."""

    is_gradient = True

    def __init__(self, gctx: GradientContext, x: Op):
        super().__init__([gctx.loss, x], ctx=x.raw_ctx)
        self.gctx = gctx
        self.x = x
        self.multi_x = None
        self.name = f"Gradient({x.name})"

    def compute(self, input_vals, tc):
        if self.multi_x is not None:
            return tuple(tc.gradient_of(self.gctx, x) for x in self.multi_x)
        return tc.gradient_of(self.gctx, self.x)


def gradients(loss: Op, node_list: Sequence[Op], insert_grad=None) -> list[Op]:
    """Return gradient nodes of ``loss`` w.r.t. each node in ``node_list``
    (reference executor.py:1096 signature)."""
    gctx = GradientContext(loss, list(node_list))
    return [GradientOp(gctx, x) for x in node_list]
