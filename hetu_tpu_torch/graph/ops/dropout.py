"""Dropout / Dropout2d — ops that draw random bits (counterpart of
``hetu_tpu/graph/ops/dropout.py``).

The mask comes from ``tc.next_rng(node)``: a generator on the executor's
device seeded from the executor seed, the step and the node's index in
the target's topological order, so a step's mask is a function of those
three and the reference's hidden mask buffer is not needed. The gradient
op asks for its forward node's generator and draws the same mask in the
same step. The bits differ from ``jax.random``'s; the drop rate, the
scale and the mask's shape are the reference's.
"""
from __future__ import annotations

import torch

from ..node import Op


def _dropped(x, keep_prob, channelwise, gen):
    """``x / keep_prob`` where the mask keeps, 0 elsewhere; the mask is one
    draw per element, or per (sample, channel) where ``channelwise``."""
    shape = (tuple(x.shape[:2]) + (1,) * (x.ndim - 2) if channelwise
             else tuple(x.shape))
    keep = torch.rand(shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class DropoutOp(Op):
    needs_rng = True

    def __init__(self, node_in, keep_prob, ctx=None, channelwise=False):
        super().__init__([node_in], ctx)
        self.keep_prob = float(keep_prob)
        self.channelwise = channelwise

    def compute(self, input_vals, tc):
        (x,) = input_vals
        if not tc.training or self.keep_prob >= 1.0:
            return x
        return _dropped(x, self.keep_prob, self.channelwise,
                        tc.next_rng(self))


def dropout_op(node_in, keep_prob, ctx=None):
    return DropoutOp(node_in, keep_prob, ctx)


def dropout2d_op(node_in, keep_prob, ctx=None):
    """Drops whole channels of an (N, C, H, W) tensor (reference Dropout2d)."""
    return DropoutOp(node_in, keep_prob, ctx, channelwise=True)


class DropoutGradientOp(Op):
    """API-parity gradient op: regenerates the forward mask from the paired
    forward node's generator and applies it to the incoming grad."""

    needs_rng = True

    def __init__(self, node_in, keep_prob, forward_node, ctx=None,
                 channelwise=False):
        super().__init__([node_in], ctx)
        self.keep_prob = float(keep_prob)
        self.forward_node = forward_node
        self.channelwise = channelwise

    def compute(self, input_vals, tc):
        (g,) = input_vals
        if not tc.training or self.keep_prob >= 1.0:
            return g
        return _dropped(g, self.keep_prob, self.channelwise,
                        tc.next_rng(self.forward_node))


def dropout_gradient_op(node_in, keep_prob, forward_node, ctx=None):
    return DropoutGradientOp(node_in, keep_prob, forward_node, ctx)


def dropout2d_gradient_op(node_in, keep_prob, forward_node, ctx=None):
    return DropoutGradientOp(node_in, keep_prob, forward_node, ctx,
                             channelwise=True)
