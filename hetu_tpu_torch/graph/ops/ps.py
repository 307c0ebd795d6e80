"""Parameter-server communication ops, graph-level markers (counterpart of
``hetu_tpu/graph/ops/ps.py``).

The executor moves the PS traffic to the step's boundary: before the
step it pulls the batch's rows of each PS-hosted table (and the values of
PS-hosted dense parameters), after it it pushes each gradient that a
``ParameterServerCommunicateOp`` carries. Inside the step the push op
only hands its gradient to the step context (``tc.ps_push_pull``), which
collects it for the post-step push.
"""
from __future__ import annotations

from ..node import Op


class ParameterServerCommunicateOp(Op):
    """Push a gradient to the PS (the server applies the update)."""

    is_ps = True

    def __init__(self, node, ps_id=None, optimizer=None, ctx=None):
        super().__init__([node], ctx)
        self.ps_id = ps_id
        self.optimizer = optimizer
        # set by the executor's PS wiring: the PS-hosted variable this push
        # serves, and for a table the lookup op(s) whose row gradients it
        # carries
        self.ps_param_node = None
        self.staged_lookups = None

    def compute(self, input_vals, tc):
        return tc.ps_push_pull(self, input_vals[0])


def parameterServerCommunicate_op(node, ps_id=None, optimizer=None, ctx=None):
    return ParameterServerCommunicateOp(node, ps_id, optimizer, ctx)


class ParameterServerSparsePullOp(Op):
    """Rows of a PS-hosted table for inference; the executor stages them
    as it stages a lookup's."""

    is_ps = True

    def __init__(self, node_embed, node_index, ctx=None):
        super().__init__([node_embed, node_index], ctx)
        self.embed_node = node_embed

    def compute(self, input_vals, tc):
        raise AssertionError(
            "ParameterServerSparsePullOp values are staged by the executor")


def parameterServerSparsePull_op(node_embed, node_index, ctx=None):
    return ParameterServerSparsePullOp(node_embed, node_index, ctx)
