"""Matrix-multiply ops (counterpart of ``hetu_tpu/graph/ops/matmul.py``).

The dense products sit outside any TPU kernel (XLA served them), so here
they go to ``torch.matmul``: float32 in full float32, since the executor
keeps ``torch.backends.cuda.matmul.allow_tf32`` False. The CSR products
take a fed ``ND_Sparse_Array`` and go through the ``csr_spmm`` and
``csr_spmv`` kernels (``kernels/csr_spmm.py``), forward and backward.
"""
from __future__ import annotations

import torch

from ...kernels import csr_spmm
from ..node import FunctionalOp, Op


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


# ---------------------------------------------------------------------------
# CSR sparse products (reference matmul.py:58-103). The sparse operand is a
# fed ND_Sparse_Array; its CSR forms were built once, on its device.
# ---------------------------------------------------------------------------

class SparseInputOp(Op):
    """Fed node whose value is an ``ND_Sparse_Array``."""

    is_placeholder = True

    def __init__(self, name=None, ctx=None):
        super().__init__([], ctx, name or "SparseInput")
        self.trainable = False
        self.is_feed = True


def _sparse_product(fn, a, dense, trans):
    if dense.device.type == "meta":      # abstract evaluation (infer_meta)
        nrow = a.ncol if trans else a.nrow
        return torch.empty((nrow,) + tuple(dense.shape[1:]),
                           dtype=torch.float32, device="meta")
    return fn(a, dense, trans=trans)


def csrmv_op(node_A, node_B, trans=False, ctx=None):
    """Sparse(A) @ dense-vector(B); ``trans`` multiplies by Aᵀ."""

    def _mv(a, x, t=trans):
        return _sparse_product(csr_spmm.matvec, a, x, t)

    return FunctionalOp("CSRMatVec", _mv, [node_A, node_B], ctx)


def csrmm_op(node_A, node_B, trans_A=False, trans_B=False, ctx=None):
    """Sparse(A) @ dense-matrix(B); ``trans_A``/``trans_B`` transpose
    either operand."""

    def _mm(a, b, ta=trans_A, tb=trans_B):
        if tb:
            b = b.T
        return _sparse_product(csr_spmm.matmat, a, b, ta)

    return FunctionalOp("CSRMatMat", _mm, [node_A, node_B], ctx)
