"""Normalization ops: BatchNorm (stateful running stats), LayerNorm,
InstanceNorm2d (counterpart of ``hetu_tpu/graph/ops/norm.py``).

The statistics are computed here, as the reference computes them: the
mean, then the mean of the squared deviations (the biased variance), and
the running stats ``m·old + (1 - m)·new``. ``F.batch_norm`` would weight
its momentum the other way and store the unbiased variance, so it is not
used.

Under data parallelism (a dp group of more than one rank) each rank holds
a share of the batch, where the reference's ``jnp.mean`` over the
dp-sharded batch axis is the global batch's. BatchNorm therefore sums its
per-channel statistics over the group, differentiably (:class:`_SumOverRanks`):
the output, the gradient and the running stats are the one-device result
on the global batch on every rank.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..node import FunctionalOp, Op


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``group``; its gradient is the sum
    of the ranks' incoming gradients (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def _moments(x, axes, group):
    """Per-channel mean and biased variance of ``x`` over ``axes``, keeping
    those axes; over every rank's share of the batch where ``group`` is a
    dp group (the ranks' shares are equal, as the executor cuts them, or
    whole copies, which the same sums treat alike)."""
    if group is None:
        mean = x.mean(dim=axes, keepdim=True)
        d = x - mean
        return mean, (d * d).mean(dim=axes, keepdim=True)
    n = dist.get_world_size(group) * int(np.prod([x.shape[a] for a in axes]))
    mean = _SumOverRanks.apply(x.sum(dim=axes, keepdim=True), group) / n
    d = x - mean
    return mean, _SumOverRanks.apply((d * d).sum(dim=axes, keepdim=True),
                                     group) / n


class BatchNormOp(Op):
    """Batch normalization over (N, C, H, W) with per-channel scale/bias.

    Reference gpu_ops/BatchNorm.py: inputs (x, scale, bias); running stats
    are op state, updated only in training."""

    stateful = True

    def __init__(self, node_in, bn_scale, bn_bias, momentum=0.99, eps=0.01,
                 ctx=None):
        super().__init__([node_in, bn_scale, bn_bias], ctx)
        self.momentum = float(momentum)
        self.eps = float(eps)

    def state_init(self):
        shape = getattr(self.inputs[1], "shape", None)
        if shape is None:
            raise ValueError("BatchNorm scale must be a Variable with known "
                             "shape")
        c = int(np.prod(shape))
        return {"mean": np.zeros((c,), np.float32),
                "var": np.ones((c,), np.float32)}

    def compute_stateful(self, input_vals, state, tc):
        x, scale, bias = input_vals
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if tc.training:
            axes = (0,) + tuple(range(2, x.ndim))
            mean, var = _moments(x, axes, tc.sync_group)
            mean, var = mean.reshape(-1), var.reshape(-1)
            m = self.momentum
            new_state = {
                "mean": m * state["mean"] + (1.0 - m) * mean.detach(),
                "var": m * state["var"] + (1.0 - m) * var.detach(),
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        norm = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                      + self.eps)
        return norm * scale.reshape(shape) + bias.reshape(shape), new_state


def batch_normalization_op(node_in, bn_scale, bn_bias, momentum=0.99,
                           eps=0.01, ctx=None):
    return BatchNormOp(node_in, bn_scale, bn_bias, momentum, eps, ctx)


def _normalized(x, axes, eps):
    mean, var = _moments(x, axes, None)
    return (x - mean) / torch.sqrt(var + eps)


def layer_normalization_op(node_in, ln_scale, ln_bias, eps=0.01, ctx=None):
    return FunctionalOp(
        "LayerNorm",
        lambda x, s, b, e=float(eps): _normalized(x, (-1,), e) * s + b,
        [node_in, ln_scale, ln_bias], ctx)


def instance_normalization2d_op(node_in, eps=0.01, ctx=None):
    return FunctionalOp(
        "InstanceNorm2d", lambda x, e=float(eps): _normalized(x, (2, 3), e),
        [node_in], ctx)
