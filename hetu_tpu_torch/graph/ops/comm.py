"""Communication ops: the gradient all-reduce and the host/device transfer
markers (counterpart of ``hetu_tpu/graph/ops/comm.py``).

The reference backs the all-reduce with MPI+NCCL; the JAX package
compiles it into the XLA program as a sharding constraint. Here it is a
``torch.distributed`` collective over the executor's dp process group
(NCCL for CUDA tensors, gloo for CPU ones), issued eagerly by the step
context (``TraceContext.allreduce``). Pipeline send/receive and the
``dispatch`` tensor-parallel marker arrive with slice 8.
"""
from __future__ import annotations

from ..node import Op, FunctionalOp


class AllReduceCommunicateOp(Op):
    """Gradient all-reduce over data parallelism (reference
    AllReduceCommunicate.py:8): the mean of the ranks' gradients.
    ``param_node`` is the parameter whose gradient this is."""

    # the Executor sets this on each op whose gradient the comm_quant
    # policy compresses; the step runs the marked inputs of each optimizer
    # node as one group (comm_quant.quantized_allreduce_group), and
    # TraceContext.allreduce a marked op that something else reads first
    comm_quant = False

    def __init__(self, node, comm=None, ctx=None, param_node=None):
        super().__init__([node], ctx)
        self.comm = comm
        self.param_node = param_node

    def compute(self, input_vals, tc):
        return tc.allreduce(input_vals[0], self.param_node, op=self)


def allreduceCommunicate_op(node, comm=None, ctx=None, param_node=None):
    return AllReduceCommunicateOp(node, comm, ctx, param_node)


class GroupAllReduceCommunicateOp(AllReduceCommunicateOp):
    """Sub-group all-reduce of pipeline + data parallelism (reference
    :73). Only the default group, the dp group itself, is ported: a
    sub-group of pipeline stages arrives with slice 8."""

    def __init__(self, node, group=None, ctx=None):
        if group is not None:
            raise NotImplementedError(
                "groupallreduceCommunicate_op with a group: sub-groups of "
                "pipeline stages arrive with slice 8 (TP, PP, ZeRO); the "
                "default group is the dp group")
        super().__init__(node, None, ctx)
        self.group = group


def groupallreduceCommunicate_op(node, group=None, ctx=None):
    return GroupAllReduceCommunicateOp(node, group, ctx)


def datah2d_op(node, ctx=None):
    """Host-to-device transfer marker (reference DataTransfer.py): the
    executor places every value on its device, so this is an identity."""
    return FunctionalOp("DataH2D", lambda x: x, [node], ctx)


def datad2h_op(node, ctx=None):
    return FunctionalOp("DataD2H", lambda x: x, [node], ctx)


def dispatch(node, parts, duplicate=1):
    """The tensor-parallel partition marker: a GSPMD PartitionSpec in the
    JAX package, explicit splits and collectives here, in slice 8."""
    raise NotImplementedError(
        "ht.dispatch (tensor parallelism) arrives with slice 8 (TP, PP, "
        "ZeRO); hetu_tpu_torch runs data parallelism only")
