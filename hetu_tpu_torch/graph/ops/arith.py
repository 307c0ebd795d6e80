"""Elementwise arithmetic + activation ops (counterpart of
``hetu_tpu/graph/ops/arith.py``), as plain torch expressions."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..node import FunctionalOp


def add_op(node_A, node_B, ctx=None):
    return FunctionalOp("AddElewise", torch.add, [node_A, node_B], ctx)


def addbyconst_op(node, const_val, ctx=None):
    return FunctionalOp("AddConst", lambda x, c=const_val: x + c, [node], ctx)


def mul_op(node_A, node_B, ctx=None):
    return FunctionalOp("MultiplyElewise", torch.mul, [node_A, node_B], ctx)


def mul_byconst_op(node, const_val, ctx=None):
    return FunctionalOp("MultiplyConst", lambda x, c=const_val: x * c, [node], ctx)


def div_op(node_A, node_B, ctx=None):
    return FunctionalOp("Division", torch.div, [node_A, node_B], ctx)


def div_const_op(const_val, node_A, ctx=None):
    return FunctionalOp("DivConst", lambda x, c=const_val: c / x, [node_A], ctx)


def opposite_op(node, ctx=None):
    return FunctionalOp("Opposite", torch.neg, [node], ctx)


def sqrt_op(node, ctx=None):
    return FunctionalOp("Sqrt", torch.sqrt, [node], ctx)


def rsqrt_op(node, ctx=None):
    return FunctionalOp("ReciprocalSqrt", torch.rsqrt, [node], ctx)


def oneslike_op(node, ctx=None):
    return FunctionalOp("OnesLike", torch.ones_like, [node], ctx)


def zeroslike_op(node, ctx=None):
    return FunctionalOp("ZerosLike", torch.zeros_like, [node], ctx)


def where_op(cond, node_A, node_B, ctx=None):
    return FunctionalOp("Where", lambda c, a, b: torch.where(c != 0, a, b),
                        [cond, node_A, node_B], ctx)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _relu(x):
    # maximum against 0, not torch.relu: at x == 0 both packages then split
    # the gradient in half, as jnp.maximum's derivative does
    return torch.maximum(x, x.new_zeros(()))


def relu_op(node, ctx=None):
    return FunctionalOp("Relu", _relu, [node], ctx)


def relu_gradient_op(node, grad_node, ctx=None):
    """dL/dx for relu given forward input (reference Relu.py ReluGradientOp)."""
    return FunctionalOp("ReluGradient", lambda x, g: torch.where(x > 0, g, 0.0),
                        [node, grad_node], ctx)


def leaky_relu_op(node, alpha, ctx=None):
    return FunctionalOp("LeakyRelu",
                        lambda x, a=alpha: torch.where(x > 0, x, a * x),
                        [node], ctx)


def leaky_relu_gradient_op(node_A, node_B, alpha, ctx=None):
    return FunctionalOp("LeakyReluGradient",
                        lambda x, g, a=alpha: torch.where(x > 0, g, a * g),
                        [node_A, node_B], ctx)


def sigmoid_op(node, ctx=None):
    return FunctionalOp("Sigmoid", torch.sigmoid, [node], ctx)


def tanh_op(node, ctx=None):
    return FunctionalOp("Tanh", torch.tanh, [node], ctx)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def gelu_op(node, ctx=None):
    return FunctionalOp("Gelu", _gelu, [node], ctx)


def exp_op(node, ctx=None):
    return FunctionalOp("Exp", torch.exp, [node], ctx)


def log_op(node, ctx=None):
    return FunctionalOp("Log", torch.log, [node], ctx)


def softmax_func(y):
    """Numerically-stable softmax over the last axis (reference Softmax.py)."""
    return torch.softmax(y, dim=-1)


def softmax_op(node, ctx=None):
    return FunctionalOp("Softmax", softmax_func, [node], ctx)


def softmax_gradient_op(node_y, grad, ctx=None):
    """Backward of softmax given forward *output* y (reference SoftmaxGradient)."""

    def _grad(y, dy):
        return y * (dy - torch.sum(dy * y, dim=-1, keepdim=True))

    return FunctionalOp("SoftmaxGradient", _grad, [node_y, grad], ctx)
