"""Shape/layout ops: reshape, transpose, slice, split, concat, pad, broadcast,
reductions, one-hot (counterpart of ``hetu_tpu/graph/ops/shape.py``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..node import FunctionalOp


def array_reshape_op(node, output_shape, ctx=None):
    return FunctionalOp("ArrayReshape",
                        lambda x, s=tuple(output_shape): torch.reshape(x, s),
                        [node], ctx)


def array_reshape_gradient_op(node_in, node_out, ctx=None):
    """Reshape grad back to the forward input's shape."""
    return FunctionalOp("ArrayReshapeGradient",
                        lambda x_in, g: torch.reshape(g, x_in.shape),
                        [node_in, node_out], ctx)


def _transpose(x, perm):
    # jnp.transpose(x, None) reverses the axes
    return x.permute(tuple(reversed(range(x.dim()))) if perm is None
                     else tuple(perm))


def transpose_op(node, perm=None, ctx=None):
    return FunctionalOp("Transpose", lambda x, p=perm: _transpose(x, p), [node], ctx)


def slice_op(node, begin, size, ctx=None):
    begin = tuple(int(b) for b in begin)
    size = tuple(int(s) for s in size)

    def _slice(x):
        idx = tuple(slice(b, x.shape[i] if s == -1 else b + s)
                    for i, (b, s) in enumerate(zip(begin, size)))
        return x[idx]

    return FunctionalOp("Slice", _slice, [node], ctx)


def slice_gradient_op(node, begin, size=None, ctx=None):
    """Scatter the sliced grad back into zeros of the forward-input shape.

    ``size`` here is the forward input's full shape (the reference recovers it
    from the paired forward op at placement time, Slice.py).
    """
    begin = tuple(int(b) for b in begin)
    out_shape = None if size is None else tuple(int(s) for s in size)

    def _grad(g):
        if out_shape is None:
            raise ValueError("slice_gradient_op needs the input shape")
        out = g.new_zeros(out_shape)
        idx = tuple(slice(b, b + n) for b, n in zip(begin, g.shape))
        out[idx] = g
        return out

    return FunctionalOp("SliceGradient", _grad, [node], ctx)


def split_op(node, axes, indices, splits, ctx=None):
    """Take partition ``indices[k]`` of ``splits[k]`` along each ``axes[k]``
    (reference Split.py — multi-axis block split used by model parallelism)."""
    axes = [int(a) for a in np.atleast_1d(axes)]
    indices = [int(i) for i in np.atleast_1d(indices)]
    splits = [int(s) for s in np.atleast_1d(splits)]

    def _split(x):
        out = x
        for ax, idx, sp in zip(axes, indices, splits):
            dim = out.shape[ax]
            if dim % sp:
                raise ValueError(f"axis {ax} size {dim} not divisible by {sp}")
            part = dim // sp
            out = out.narrow(ax, idx * part, part)
        return out

    return FunctionalOp("Split", _split, [node], ctx)


def split_gradient_op(node, axes, indices, splits, ctx=None):
    axes = [int(a) for a in np.atleast_1d(axes)]
    indices = [int(i) for i in np.atleast_1d(indices)]
    splits = [int(s) for s in np.atleast_1d(splits)]

    def _grad(g):
        shape = list(g.shape)
        idx = [slice(None)] * g.dim()
        for ax, i, sp in zip(axes, indices, splits):
            shape[ax] = g.shape[ax] * sp
            idx[ax] = slice(i * g.shape[ax], (i + 1) * g.shape[ax])
        out = g.new_zeros(tuple(shape))
        out[tuple(idx)] = g
        return out

    return FunctionalOp("SplitGradient", _grad, [node], ctx)


def concat_op(node_A, node_B, axis=0, ctx=None):
    return FunctionalOp("Concat",
                        lambda a, b, ax=axis: torch.cat([a, b], dim=ax),
                        [node_A, node_B], ctx)


def concat_gradient_op(grad_node, input_node, axis, idx, ctx=None):
    """Slice the grad chunk belonging to input ``idx`` (0 or 1) back out."""

    def _grad(g, x_in, ax=int(axis), which=int(idx)):
        size = x_in.shape[ax]
        start = 0 if which == 0 else g.shape[ax] - size
        return g.narrow(ax, start, size)

    return FunctionalOp("ConcatGradient", _grad, [grad_node, input_node], ctx)


def _torch_pads(pads, ndim):
    """numpy-style [(lo, hi)] over the trailing dims -> F.pad's flat list,
    which starts at the LAST dim."""
    full = [(0, 0)] * (ndim - len(pads)) + list(pads)
    return [v for lo_hi in reversed(full) for v in lo_hi]


def pad_op(node, paddings, mode="CONSTANT", constant_values=0, ctx=None):
    pads = [tuple(int(v) for v in p) for p in paddings]
    if mode.upper() != "CONSTANT":
        raise ValueError("only CONSTANT pad supported (as reference)")

    def _pad(x):
        return F.pad(x, _torch_pads(pads, x.dim()), value=constant_values)

    return FunctionalOp("Pad", _pad, [node], ctx)


def pad_gradient_op(node, paddings, mode="CONSTANT", ctx=None):
    pads = [tuple(int(v) for v in p) for p in paddings]

    def _grad(g):
        full = [(0, 0)] * (g.dim() - len(pads)) + pads
        idx = tuple(slice(lo, g.shape[i] - hi) for i, (lo, hi) in enumerate(full))
        return g[idx]

    return FunctionalOp("PadGradient", _grad, [node], ctx)


def broadcastto_op(node_A, node_B, ctx=None):
    """Broadcast A to B's shape with numpy trailing-dim alignment
    (reference Broadcast.py)."""
    return FunctionalOp("BroadcastTo", lambda a, b: a.expand(b.shape),
                        [node_A, node_B], ctx)


def broadcast_shape_op(node, shape, add_axes=(), ctx=None):
    shape = tuple(int(s) for s in shape)
    add_axes = tuple(int(a) for a in add_axes)

    def _bc(x):
        y = x
        for ax in sorted(add_axes):
            y = y.unsqueeze(ax)
        return y.expand(shape)

    return FunctionalOp("BroadcastShape", _bc, [node], ctx)


def reduce_sum_op(node, axes, keepdims=False, ctx=None):
    axes = tuple(int(a) for a in np.atleast_1d(axes))
    return FunctionalOp("ReduceSum",
                        lambda x: torch.sum(x, dim=axes, keepdim=keepdims),
                        [node], ctx)


def reduce_mean_op(node, axes, keepdims=False, ctx=None):
    axes = tuple(int(a) for a in np.atleast_1d(axes))
    return FunctionalOp("ReduceMean",
                        lambda x: torch.mean(x, dim=axes, keepdim=keepdims),
                        [node], ctx)


def reducesumaxiszero_op(node, ctx=None):
    return FunctionalOp("ReduceSumAxisZero", lambda x: torch.sum(x, dim=0),
                        [node], ctx)


def _one_hot(x, n):
    # a comparison, not F.one_hot: it runs on meta tensors and, like
    # jax.nn.one_hot, gives an all-zero row for an out-of-range index
    classes = torch.arange(n, device=x.device)
    return (x.to(torch.int64).unsqueeze(-1) == classes).to(torch.float32)


def one_hot_op(node, num_classes, ctx=None):
    return FunctionalOp("OneHot", lambda x, n=int(num_classes): _one_hot(x, n),
                        [node], ctx)
