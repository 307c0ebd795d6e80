"""Communication ops: the gradient all-reduce and the host/device transfer
markers (counterpart of ``hetu_tpu/graph/ops/comm.py``).

The reference backs the all-reduce with MPI+NCCL; the JAX package
compiles it into the XLA program as a sharding constraint. Here it is a
``torch.distributed`` collective over the executor's dp process group
(NCCL for CUDA tensors, gloo for CPU ones), issued eagerly by the step
context (``TraceContext.allreduce``). The group all-reduce runs over a
sub-group that ``new_group_comm(devices)`` made. Pipeline send and
receive are stage-boundary markers: the GPipe executor
(``graph/gpipe.py``) cuts the graph at context boundaries and carries the
values between stage processes. The ``dispatch`` tensor-parallel marker
arrives with slice 8c.
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
    :73): the mean of ``node`` over ``group``, a
    :class:`~hetu_tpu_torch.graph.executor.CommGroup` from
    ``new_group_comm(devices)``; the default group is the dp group."""

    def __init__(self, node, group=None, ctx=None):
        if group is not None and not callable(getattr(group, "mean", None)):
            raise TypeError(f"groupallreduceCommunicate_op takes the group "
                            f"new_group_comm(devices) made, got {group!r}")
        super().__init__(node, None, ctx)
        self.group = group

    def compute(self, input_vals, tc):
        if self.group is None:
            return tc.allreduce(input_vals[0], self.param_node, op=self)
        return self.group.mean(input_vals[0])


def groupallreduceCommunicate_op(node, group=None, ctx=None):
    return GroupAllReduceCommunicateOp(node, group, ctx)


def datah2d_op(node, ctx=None):
    """Host-to-device transfer marker (reference DataTransfer.py): the
    executor places every value on its device, so this is an identity."""
    return FunctionalOp("DataH2D", lambda x: x, [node], ctx)


def datad2h_op(node, ctx=None):
    return FunctionalOp("DataD2H", lambda x: x, [node], ctx)


class PipelineSendOp(Op):
    """Stage-boundary send marker (reference PipelineSend.py:19-44): an
    identity pinned to the sending stage's context. The GPipe executor
    cuts the graph at context boundaries and sends the value to the
    consuming stage's process itself (with the reference's shape
    handshake); the marker makes the cut explicit."""

    def __init__(self, node, destination=None, comm=None, stream=None,
                 ctx=None):
        super().__init__([node], ctx)
        self.destination = destination
        # the paired receives, registered by PipelineReceiveOp
        self.receivers: list["PipelineReceiveOp"] = []

    def compute(self, input_vals, tc):
        return input_vals[0]


def pipeline_send_op(node, destination=None, comm=None, stream=None,
                     ctx=None):
    return PipelineSendOp(node, destination, comm, stream, ctx)


class PipelineReceiveOp(Op):
    """Stage-boundary receive marker (reference PipelineReceive.py:20-48):
    ``source`` is the paired :class:`PipelineSendOp` node (or any producer
    node), paired at placement time, so the pair is a graph edge that the
    topological order, autodiff and the GPipe executor's boundary
    transfer all see. The reference pairs by device rank at run time."""

    def __init__(self, source=None, comm=None, stream=None, ctx=None):
        if not isinstance(source, Op):
            raise TypeError(
                "pipeline_receive_op(source=...) takes the paired "
                "pipeline_send_op NODE (placement-time pairing), got "
                f"{source!r}")
        super().__init__([source], ctx)
        self.source = source
        if isinstance(source, PipelineSendOp):
            source.receivers.append(self)

    def compute(self, input_vals, tc):
        return input_vals[0]


def pipeline_receive_op(source=None, comm=None, stream=None, ctx=None):
    return PipelineReceiveOp(source, comm, stream, ctx)


def dispatch(node, parts, duplicate=1):
    """The tensor-parallel partition marker: a GSPMD PartitionSpec in the
    JAX package, explicit splits and collectives here, in slice 8c."""
    raise NotImplementedError(
        "ht.dispatch (tensor parallelism, DispatchOp and "
        "dispatch_gradient) arrives with slice 8c; hetu_tpu_torch runs "
        "data and pipeline parallelism")
