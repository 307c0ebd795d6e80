"""Parameter initializers (counterpart of ``hetu_tpu/initializers.py``).

Same class hierarchy and ``init.*`` helper surface. Values are drawn on the
CPU from the ``torch.Generator`` the executor seeds per parameter, so a
seed gives the same weights whichever device trains them; they differ
from ``hetu_tpu``'s ``jax.random`` draws (tests carry weights across with
``Executor.load`` or ``interop.params_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from .graph.node import Variable


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class BaseInit:
    def __init__(self, shape):
        self.shape = tuple(int(s) for s in shape)

    def init(self, generator: torch.Generator, dtype=np.float32) -> torch.Tensor:
        raise NotImplementedError

    # fan sizes with the reference's conv-aware convention
    def _fans(self):
        shape = self.shape
        if len(shape) == 2:
            return shape[0], shape[1]
        if len(shape) in (3, 4, 5):
            receptive = int(np.prod(shape[2:]))
            return shape[1] * receptive, shape[0] * receptive
        n = int(np.prod(shape))
        return n, n


class ConstantInit(BaseInit):
    def __init__(self, constant, shape):
        super().__init__(shape)
        self.constant = float(constant)

    def init(self, generator, dtype=np.float32):
        return torch.full(self.shape, self.constant, dtype=_torch_dtype(dtype))


class ZerosInit(ConstantInit):
    def __init__(self, shape):
        super().__init__(0.0, shape)


class OnesInit(ConstantInit):
    def __init__(self, shape):
        super().__init__(1.0, shape)


class UniformInit(BaseInit):
    def __init__(self, low, high, shape):
        super().__init__(shape)
        self.low = float(low)
        self.high = float(high)

    def init(self, generator, dtype=np.float32):
        u = torch.empty(self.shape, dtype=torch.float32)
        u.uniform_(self.low, self.high, generator=generator)
        return u.to(_torch_dtype(dtype))


class NormalInit(BaseInit):
    def __init__(self, mean, stddev, shape):
        super().__init__(shape)
        self.mean = float(mean)
        self.stddev = float(stddev)

    def init(self, generator, dtype=np.float32):
        z = torch.randn(self.shape, generator=generator, dtype=torch.float32)
        return (self.mean + self.stddev * z).to(_torch_dtype(dtype))


class TruncatedNormalInit(BaseInit):
    def __init__(self, mean, stddev, shape):
        super().__init__(shape)
        self.mean = float(mean)
        self.stddev = float(stddev)

    def init(self, generator, dtype=np.float32):
        z = torch.empty(self.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (self.mean + self.stddev * z).to(_torch_dtype(dtype))


class GeneralizedXavierUniformInit(UniformInit):
    def __init__(self, gain, mode, shape):
        fan_in, fan_out = BaseInit(shape)._fans()
        fan = {"fan_in": fan_in, "fan_out": fan_out,
               "avg": (fan_in + fan_out) / 2.0}[mode]
        limit = float(np.sqrt(gain / fan))
        super().__init__(-limit, limit, shape)


class XavierUniformInit(GeneralizedXavierUniformInit):
    def __init__(self, shape):
        super().__init__(3.0, "avg", shape)


class HeUniformInit(GeneralizedXavierUniformInit):
    def __init__(self, shape):
        super().__init__(6.0, "fan_in", shape)


class LecunUniformInit(GeneralizedXavierUniformInit):
    def __init__(self, shape):
        super().__init__(3.0, "fan_in", shape)


class GeneralizedXavierNormalInit(NormalInit):
    def __init__(self, gain, mode, shape):
        fan_in, fan_out = BaseInit(shape)._fans()
        fan = {"fan_in": fan_in, "fan_out": fan_out,
               "avg": (fan_in + fan_out) / 2.0}[mode]
        stddev = float(np.sqrt(gain / fan))
        super().__init__(0.0, stddev, shape)


class XavierNormalInit(GeneralizedXavierNormalInit):
    def __init__(self, shape):
        super().__init__(1.0, "avg", shape)


class HeNormalInit(GeneralizedXavierNormalInit):
    def __init__(self, shape):
        super().__init__(2.0, "fan_in", shape)


class LecunNormalInit(GeneralizedXavierNormalInit):
    def __init__(self, shape):
        super().__init__(1.0, "fan_in", shape)


# ---------------------------------------------------------------------------
# user-facing helpers (reference initializers.py:214-297): each returns a
# Variable node carrying its initializer.
# ---------------------------------------------------------------------------

def _make(initializer, name, trainable, ctx, **kwargs):
    return Variable(name=name, initializer=initializer, trainable=trainable,
                    ctx=ctx, **kwargs)


def zeros(shape, name=None, trainable=True, ctx=None, **kwargs):
    return _make(ZerosInit(shape), name, trainable, ctx, **kwargs)


def ones(shape, name=None, trainable=True, ctx=None, **kwargs):
    return _make(OnesInit(shape), name, trainable, ctx, **kwargs)


def constant(shape, fill_value=0.0, name=None, trainable=True, ctx=None, **kwargs):
    return _make(ConstantInit(fill_value, shape), name, trainable, ctx, **kwargs)


def truncated_normal(shape, mean=0.0, stddev=1.0, name=None, trainable=True,
                     ctx=None, **kwargs):
    return _make(TruncatedNormalInit(mean, stddev, shape), name, trainable, ctx,
                 **kwargs)


def random_normal(shape, mean=0.0, stddev=1.0, name=None, trainable=True,
                  ctx=None, **kwargs):
    return _make(NormalInit(mean, stddev, shape), name, trainable, ctx, **kwargs)


def random_uniform(shape, minval=-1.0, maxval=1.0, name=None, trainable=True,
                   ctx=None, **kwargs):
    return _make(UniformInit(minval, maxval, shape), name, trainable, ctx, **kwargs)


def xavier_normal(shape, name=None, trainable=True, ctx=None, **kwargs):
    return _make(XavierNormalInit(shape), name, trainable, ctx, **kwargs)


def xavier_uniform(shape, name=None, trainable=True, ctx=None, **kwargs):
    return _make(XavierUniformInit(shape), name, trainable, ctx, **kwargs)


def he_normal(shape, name=None, trainable=True, ctx=None, **kwargs):
    return _make(HeNormalInit(shape), name, trainable, ctx, **kwargs)


def he_uniform(shape, name=None, trainable=True, ctx=None, **kwargs):
    return _make(HeUniformInit(shape), name, trainable, ctx, **kwargs)


def lecun_normal(shape, name=None, trainable=True, ctx=None, **kwargs):
    return _make(LecunNormalInit(shape), name, trainable, ctx, **kwargs)


def lecun_uniform(shape, name=None, trainable=True, ctx=None, **kwargs):
    return _make(LecunUniformInit(shape), name, trainable, ctx, **kwargs)
