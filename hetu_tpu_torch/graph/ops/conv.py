"""Conv2d and pooling ops, NCHW (counterpart of
``hetu_tpu/graph/ops/conv.py``).

The reference lowers these to ``lax.conv_general_dilated`` and
``lax.reduce_window``, outside any Pallas kernel; here they are cuDNN's
convolutions and PyTorch's pooling. Float32 convolutions run in full
float32 (the executor turns cuDNN's TF32 off). The output dtype follows
the inputs, so under bf16 compute a convolution and its transpose see
matching input dtypes.

The explicit gradient ops (reference ``conv2d_gradient_of_data``/
``_filter``, the pool gradients) are differentiable in the incoming
gradient, as the reference's ``jax.vjp`` of the forward is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..node import FunctionalOp


def _conv2d(x, w, padding, stride):
    return F.conv2d(x, w, stride=int(stride), padding=int(padding))


def conv2d_op(node_A, node_B, padding=0, stride=1, ctx=None):
    op = FunctionalOp("Conv2d", lambda x, w: _conv2d(x, w, padding, stride),
                      [node_A, node_B], ctx)
    op.export_attrs = {"padding": int(padding), "stride": int(stride)}
    return op


def conv2d_gradient_of_data_op(node_filter, node_grad_y, padding=0, stride=1,
                               ctx=None):
    """d(conv)/d(input) given (filter, dY) — reference
    Conv2d_Gradient_of_DataOp. The input's spatial size is rebuilt from dY,
    the filter, the stride and the padding as the reference rebuilds it
    (H_in = (H_out - 1)·s + kH - 2p), which is the transposed
    convolution's own output size."""
    p, s = int(padding), int(stride)
    return FunctionalOp(
        "Conv2dGradientOfData",
        lambda w, dy: F.conv_transpose2d(dy, w, stride=s, padding=p),
        [node_filter, node_grad_y], ctx)


def conv2d_gradient_of_filter_op(input_X, gradient_Y, padding=0, stride=1,
                                 ctx=None):
    """d(conv)/d(filter) given (X, dY); the filter's size is rebuilt as the
    reference rebuilds it (kH = H_in + 2p - (H_out - 1)·s)."""
    p, s = int(padding), int(stride)

    def _grad(x, dy):
        kh = x.shape[2] + 2 * p - (dy.shape[2] - 1) * s
        kw = x.shape[3] + 2 * p - (dy.shape[3] - 1) * s
        return torch.nn.grad.conv2d_weight(
            x, (dy.shape[1], x.shape[1], kh, kw), dy, stride=s, padding=p)

    return FunctionalOp("Conv2dGradientOfFilter", _grad, [input_X, gradient_Y],
                        ctx)


def conv2d_broadcastto_op(node_A, node_B, ctx=None):
    """Broadcast per-channel bias (C,) over (N,C,H,W) (reference Conv2dBroadcast)."""
    return FunctionalOp("Conv2dBroadcastTo",
                        lambda b, x: b[None, :, None, None].expand(x.shape),
                        [node_A, node_B], ctx)


def conv2d_reducesum_op(node_A, ctx=None):
    """Reduce (N,C,H,W) over N,H,W -> (C,) — gradient of the bias broadcast."""
    return FunctionalOp("Conv2dReduceSum", lambda x: x.sum(dim=(0, 2, 3)),
                        [node_A], ctx)


# ---------------------------------------------------------------------------
# pooling: windows over a padded input, the output floor((H + 2p - k)/s) + 1
# ---------------------------------------------------------------------------

def _padded(x, kh, kw, p, value):
    """``x`` and the padding left for PyTorch's pool: PyTorch's pools take
    at most half the kernel as padding, so a wider one is applied here
    (``value`` -inf for max, 0 for the average) and the pool gets none."""
    if p <= kh // 2 and p <= kw // 2:
        return x, p
    return F.pad(x, (p, p, p, p), value=value), 0


def _max_pool(x, kh, kw, p, s):
    x, p = _padded(x, kh, kw, p, float("-inf"))
    return F.max_pool2d(x, (kh, kw), (s, s), p)


def _avg_pool(x, kh, kw, p, s):
    # count_include_pad: the reference divides by the kernel's area
    x, p = _padded(x, kh, kw, p, 0.0)
    return F.avg_pool2d(x, (kh, kw), (s, s), p, count_include_pad=True)


def _pool_grad(pool, dy, x):
    """The vector-Jacobian product of ``pool`` at ``x`` with ``dy``,
    differentiable in ``dy`` (a pool's gradient does not move with ``x``
    except across a max's ties)."""
    with torch.enable_grad():
        xd = x.detach().requires_grad_()
        (g,) = torch.autograd.grad(pool(xd), xd, dy,
                                   create_graph=dy.requires_grad)
    return g


def max_pool2d_op(node_A, kernel_H, kernel_W, padding, stride, ctx=None):
    kh, kw, p, s = int(kernel_H), int(kernel_W), int(padding), int(stride)
    op = FunctionalOp("MaxPool2d", lambda x: _max_pool(x, kh, kw, p, s),
                      [node_A], ctx)
    op.export_attrs = {"kernel_H": kh, "kernel_W": kw, "padding": p, "stride": s}
    return op


def max_pool2d_gradient_op(node_out, node_out_gradient, node_in,
                           kernel_H, kernel_W, padding, stride, ctx=None):
    kh, kw, p, s = int(kernel_H), int(kernel_W), int(padding), int(stride)
    return FunctionalOp(
        "MaxPool2dGradient",
        lambda _y, dy, x: _pool_grad(
            lambda v: _max_pool(v, kh, kw, p, s), dy, x),
        [node_out, node_out_gradient, node_in], ctx)


def avg_pool2d_op(node_A, kernel_H, kernel_W, padding, stride, ctx=None):
    kh, kw, p, s = int(kernel_H), int(kernel_W), int(padding), int(stride)
    op = FunctionalOp("AvgPool2d", lambda x: _avg_pool(x, kh, kw, p, s),
                      [node_A], ctx)
    op.export_attrs = {"kernel_H": kh, "kernel_W": kw, "padding": p, "stride": s}
    return op


def avg_pool2d_gradient_op(node_out, node_out_gradient, node_in,
                           kernel_H, kernel_W, padding, stride, ctx=None):
    kh, kw, p, s = int(kernel_H), int(kernel_W), int(padding), int(stride)
    return FunctionalOp(
        "AvgPool2dGradient",
        lambda _y, dy, x: _pool_grad(
            lambda v: _avg_pool(v, kh, kw, p, s), dy, x),
        [node_out, node_out_gradient, node_in], ctx)
