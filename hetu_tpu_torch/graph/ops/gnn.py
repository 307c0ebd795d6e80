"""Graph-neural-network ops (counterpart of
``hetu_tpu/graph/ops/gnn.py``): the DistGCN 1.5D GCN product as a graph
op.

``distgcn_15d_op(A, H, W)`` computes ``Z = A @ H (@ W)``: ``csrmm_op``,
then ``matmul_op``. The process-topology arguments of the reference
signature (size, replication, device_id, comm, comm_groups) are accepted
for API compatibility, as in the JAX package; the 1.5D schedule over a
grid of processes is :mod:`hetu_tpu_torch.parallel.distgcn`.
"""
from __future__ import annotations

from .matmul import csrmm_op, matmul_op


def distgcn_15d_op(node_A, node_B, node_C=None, node_Count_Self=None,
                   node_Count_All=None, size=1, replication=1, device_id=0,
                   comm=None, comm_groups=None, need_W=True, ctx=None):
    """``A`` the sparse adjacency (a fed ``ND_Sparse_Array``), ``B`` the
    features, ``C`` the weight."""
    z = csrmm_op(node_A, node_B, ctx=ctx)
    if need_W and node_C is not None:
        z = matmul_op(z, node_C, ctx=ctx)
    return z
