"""Embedding lookup and its explicit gradient (counterpart of
``hetu_tpu/graph/ops/embedding.py``).

``embedding_lookup_op`` gathers rows of a table; autograd takes the
table's gradient through ``kernels/embed_grad.py``'s
:class:`~hetu_tpu_torch.kernels.embed_grad.EmbeddingLookup`, whose
backward is the sorted segment sum (``fused_embed_grad``), written
straight into the table-shaped gradient: the sum of each id's rows in one
fixed order, where ``index_add_`` adds with atomics.

``embedding_lookup_gradient_op`` is the explicit form. In dense mode it is
the ``(vocab, dim)`` table gradient (``embed_grad_dense``); in rows mode
(:meth:`to_rows`) it is the compact :class:`IndexedRows` pair, which an
eval target returns as such. Under the PS modes the executor flips an op
whose only consumer is a PS push to rows mode
(:func:`embed_grad_push_routable`): the rows leave the device anyway, so
the ``(vocab, dim)`` table is never made.

Ids arrive as float32 when the data is float32 (the CTR loaders); they are
truncated to int32, as ``astype(jnp.int32)`` truncates them.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ...kernels import embed_grad
from ..node import FunctionalOp


class IndexedRows(NamedTuple):
    """IndexedSlices-style sparse gradient: ``rows`` (n,) int32 unique row
    ids padded with the vocab-size sentinel, ``grads`` (n, dim) per-row
    sums (zeros past the valid prefix)."""

    rows: Any
    grads: Any


def embed_grad_push_routable(push, grad_op, consumers, eval_ids) -> bool:
    """The structural half of the rows route's conditions: ``grad_op`` is
    an explicit gradient op in dense mode, this push (which names its
    table) is its only consumer, and it is no eval target. The executor
    checks the rest: the push's table is PS-hosted, sparse, and of the
    op's shape. ``consumers``: ``{id(node): [consumer, ...]}`` over the
    topo; ``eval_ids``: the ids of the eval targets."""
    if getattr(grad_op, "rows_mode", None) is not False:
        return False
    if getattr(push, "ps_id", None) is None:
        return False
    if any(c is not push for c in consumers.get(id(grad_op), ())):
        return False
    return id(grad_op) not in eval_ids


def embedding_lookup_op(embedding, index, ctx=None):
    op = FunctionalOp("EmbeddingLookUp", embed_grad.lookup,
                      [embedding, index], ctx)
    op.embed_node = embedding
    return op


def embedding_lookup_gradient_op(vectors, index, embed_shape, ctx=None):
    """The table-shaped gradient of a lookup from its rows' gradients
    ``vectors``; :meth:`to_rows` switches it to the compact form."""
    shape = tuple(int(s) for s in embed_shape)

    def _grad_dense(vec, idx):
        return embed_grad.embed_grad_dense(vec, idx, shape)

    def _grad_rows(vec, idx):
        rows, grads, _count = embed_grad.embed_grad_rows(vec, idx, shape[0])
        return IndexedRows(rows, grads)

    op = FunctionalOp("EmbeddingLookUpGradient", _grad_dense,
                      [vectors, index], ctx)
    op.embed_shape = shape
    op.rows_mode = False
    op._dense_fn = _grad_dense
    op._rows_fn = _grad_rows

    def _infer_meta(inputs, training=False):
        # the identity shape rule: dense mode is table-shaped, rows mode a
        # pair as long as the lookup's ids; nothing is sorted or summed
        if not op.rows_mode:
            return torch.empty(shape, dtype=torch.float32, device="meta")
        idx = inputs[1] if len(inputs) > 1 else ()
        idx_shape = tuple(idx.shape) if hasattr(idx, "shape") else tuple(idx)
        n = 1
        for s in idx_shape:
            n *= int(s)
        return IndexedRows(
            torch.empty((n,), dtype=torch.int32, device="meta"),
            torch.empty((n, shape[-1]), dtype=torch.float32, device="meta"))

    op.infer_meta = _infer_meta

    def to_rows():
        op.fn = op._rows_fn
        op.rows_mode = True
        return op

    def to_dense():
        op.fn = op._dense_fn
        op.rows_mode = False
        return op

    op.to_rows = to_rows
    op.to_dense = to_dense
    return op
