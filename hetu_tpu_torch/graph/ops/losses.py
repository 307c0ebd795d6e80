"""Loss ops: softmax cross-entropy and binary cross-entropy (counterpart of
``hetu_tpu/graph/ops/losses.py``, same log-softmax formulation)."""
from __future__ import annotations

import torch

from ..node import FunctionalOp


def _softmax_ce(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(labels * logp, dim=-1)


def softmaxcrossentropy_op(node_A, node_B, use_cudnn=True, ctx=None):
    """Per-example CE between logits (N, C) and one-hot labels (N, C).

    ``use_cudnn`` is accepted and ignored (reference SoftmaxCrossEntropy.py).
    """
    return FunctionalOp("SoftmaxCrossEntropy", _softmax_ce, [node_A, node_B], ctx)


def softmaxcrossentropy_gradient_op(node_A, node_B, node_C, use_cudnn=True, ctx=None):
    """(softmax(logits) - labels) * dL — reference SoftmaxCrossEntropyGradient."""

    def _grad(logits, labels, dl):
        return (torch.softmax(logits, dim=-1) - labels) * dl[..., None]

    return FunctionalOp("SoftmaxCrossEntropyGradient", _grad,
                        [node_A, node_B, node_C], ctx)


_BCE_EPS = 1e-7  # f32-meaningful clip: 1.0 - 1e-12 rounds to 1.0 in f32


def binarycrossentropy_op(node_A, node_B, ctx=None):
    """Elementwise BCE between prediction probabilities and labels
    (reference BinaryCrossEntropy.py)."""

    def _bce(pred, label):
        pred = torch.clamp(pred, _BCE_EPS, 1.0 - _BCE_EPS)
        return -(label * torch.log(pred) + (1.0 - label) * torch.log(1.0 - pred))

    return FunctionalOp("BinaryCrossEntropy", _bce, [node_A, node_B], ctx)


def binarycrossentropy_gradient_op(node_A, node_B, node_C, ctx=None):
    def _grad(pred, label, dl):
        pred = torch.clamp(pred, _BCE_EPS, 1.0 - _BCE_EPS)
        return (pred - label) / (pred * (1.0 - pred)) * dl

    return FunctionalOp("BinaryCrossEntropyGradient", _grad,
                        [node_A, node_B, node_C], ctx)
