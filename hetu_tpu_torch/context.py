"""Device placement language: DeviceGroup + ``with ht.context(...)`` scoping
(counterpart of ``hetu_tpu/context.py``).

The port runs one process per device: a group of several devices is the
data-parallel ranks' devices, one per rank (the executor takes its own).
The placement of model-parallel tuples onto several cards arrives with
the tensor-parallel slice.
"""
from __future__ import annotations

import contextlib
import re

from .ndarray import DLContext, cpu, gpu

_context_stack: list["DeviceGroup"] = []


def _parse_ctx_literal(c):
    """Parse one context literal: DLContext | 'gpu:N' | 'tpu:N' | 'cpu:0'."""
    if isinstance(c, DLContext):
        return c
    if isinstance(c, str):
        m = re.fullmatch(r"(?P<type>cpu|gpu|tpu|cuda):?(?P<id>\d+)?",
                         c.lower().strip())
        if m is None:
            raise ValueError(f"Cannot parse context {c!r}")
        dev_id = int(m.group("id") or 0)
        return cpu(dev_id) if m.group("type") == "cpu" else gpu(dev_id)
    raise ValueError(f"Cannot parse context {c!r}")


class DeviceGroup:
    """An ordered group of devices a (sub)graph is placed on.

    Reference context.py:6 — accepts a single context, a list, or nested
    tuples; a tuple denotes a model-parallel worker group.
    """

    def __init__(self, ctxs):
        self._contexts = self._parse_contexts(ctxs)

    @staticmethod
    def _parse_contexts(ctxs):
        if isinstance(ctxs, DeviceGroup):
            return ctxs._contexts
        if isinstance(ctxs, str):
            ctxs = [s for s in ctxs.split(",") if s.strip()]
        # a bare tuple is ONE model-parallel subgroup; a list is the group list
        if not isinstance(ctxs, list):
            ctxs = [ctxs]
        result = []
        for c in ctxs:
            if isinstance(c, tuple):
                result.append(tuple(_parse_ctx_literal(x) for x in c))
            else:
                result.append(_parse_ctx_literal(c))
        return result

    def flat(self):
        out = []
        for c in self._contexts:
            out.extend(c) if isinstance(c, tuple) else out.append(c)
        return out

    def __repr__(self):
        return f"DeviceGroup({self._contexts})"


@contextlib.contextmanager
def context(ctx):
    """``with ht.context('gpu:0')`` — ops built inside get this placement
    (reference context.py:117-124)."""
    group = ctx if isinstance(ctx, DeviceGroup) else DeviceGroup(ctx)
    _context_stack.append(group)
    try:
        yield group
    finally:
        _context_stack.pop()


def get_current_context():
    return _context_stack[-1] if _context_stack else None
