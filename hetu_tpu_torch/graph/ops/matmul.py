"""Dense matrix-multiply ops (counterpart of the dense part of
``hetu_tpu/graph/ops/matmul.py``).

These products sit outside any TPU kernel (XLA served them), so here they
go to ``torch.matmul``: float32 in full float32, since the executor keeps
``torch.backends.cuda.matmul.allow_tf32`` False. The CSR products arrive
with the GNN slice.
"""
from __future__ import annotations

import torch

from ..node import FunctionalOp


def matmul_op(node_A, node_B, trans_A=False, trans_B=False, ctx=None):
    def _mm(a, b, ta=trans_A, tb=trans_B):
        if ta:
            a = a.T
        if tb:
            b = b.T
        return torch.matmul(a, b)

    return FunctionalOp("MatMul", _mm, [node_A, node_B], ctx)


def batch_matmul_op(node_A, node_B, trans_A=False, trans_B=False, ctx=None):
    def _bmm(a, b, ta=trans_A, tb=trans_B):
        if ta:
            a = a.transpose(-1, -2)
        if tb:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return FunctionalOp("BatchMatMul", _bmm, [node_A, node_B], ctx)


def matrix_dot_op(node_A, node_B, axes=0, ctx=None):
    """Elementwise multiply (reference MatrixDot.py — despite the name, its
    kernel is an elementwise product; kept for API parity)."""
    return FunctionalOp("MatrixDot", torch.mul, [node_A, node_B], ctx)
