"""Quantized communication for the data-parallel gradient all-reduce
(counterpart of ``hetu_tpu/comm_quant.py``).

One policy knob, ``HetuConfig(comm_quant="off"|"int8"|"fp8")`` or
``HETU_COMM_QUANT`` (plus ``_BLOCK``, ``_MIN`` and ``_EF``), chooses
whether the gradient all-reduce of each large parameter is exact or
compressed. The compressed all-reduce (:func:`quantized_allreduce`) is a
reduce-scatter in float32, so the sum itself stays exact, then a
blockwise quantize of this rank's shard (int8 or fp8 with one float32
scale per block), an all-gather of the one-byte payload and its scales,
and a dequantize: the EQuARX decomposition the JAX package expresses
through GSPMD sharding constraints, here written out over a
``torch.distributed`` process group. An optional error-feedback residual,
executor state, carries the quantization error into the next step.

Scheme: ``scale = max|block| / Q`` (Q = 127 for int8, 448 for fp8
e4m3fn), ``q = round_half_even(v / scale)``, ``dq = q · scale``; an
all-zero block stores scale 0 and dequantizes to zeros. The quantize and
dequantize are the CUDA kernels of :mod:`.kernels.quant_comm`.

The PS path's int8 wire container is host C++ and arrives with the PS
slice; :func:`np_quantize_blocks` is a copy of the JAX package's numpy
mirror of it, kept here because the port imports nothing of that package.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .kernels import quant_comm
from .parallel import multihost

MODES = ("off", "int8", "fp8")

# wire block for dense payloads
DEFAULT_BLOCK = 256
# parameters below this element count are exempt (biases, norm scales)
DEFAULT_MIN_SIZE = 2048

_INT8_Q = 127.0
_FP8_Q = 448.0  # float8_e4m3fn max finite


def _env(name, dflt):
    v = os.environ.get(name)
    return v if v not in (None, "") else dflt


def _env_bool(name, dflt):
    v = os.environ.get(name)
    if v is None or v == "":
        return dflt
    return v.strip().lower() in ("1", "true", "yes", "on")


def fp8_dtype():
    """The fp8 wire dtype (``torch.float8_e4m3fn``), or None when this
    PyTorch build has none."""
    return getattr(torch, "float8_e4m3fn", None)


class QuantPolicy:
    """Per-parameter quantization decisions for one executor.

    ``mode``: "off" | "int8" | "fp8". ``block``: scale granularity.
    ``min_size``: parameters with fewer elements are exempt.
    ``error_feedback``: carry the quantization error as residual state.
    ``force``: parameter names quantized regardless of the size threshold.
    """

    def __init__(self, mode="off", block=DEFAULT_BLOCK,
                 min_size=DEFAULT_MIN_SIZE, error_feedback=True, force=()):
        if mode not in MODES:
            raise ValueError(
                f"comm_quant must be one of {MODES}, got {mode!r}")
        if int(block) <= 0:
            raise ValueError(f"comm_quant block must be positive, got {block}")
        self.mode = mode
        self.block = int(block)
        self.min_size = int(min_size)
        self.error_feedback = bool(error_feedback)
        self.force = tuple(force or ())
        if mode == "fp8" and fp8_dtype() is None:
            raise ValueError(
                "comm_quant='fp8' needs a PyTorch build with float8_e4m3fn; "
                "use 'int8' on this environment")

    @property
    def active(self) -> bool:
        return self.mode != "off"

    def applies(self, param_node, size: int) -> bool:
        """Does this policy quantize a parameter of ``size`` elements?"""
        if not self.active:
            return False
        name = getattr(param_node, "name", None)
        if name is not None and name in self.force:
            return True
        return int(size) >= self.min_size

    def __repr__(self):
        return (f"QuantPolicy({self.mode!r}, block={self.block}, "
                f"min_size={self.min_size}, ef={self.error_feedback})")


def resolve_policy(mode=None, block=None, min_size=None, error_feedback=None,
                   force=()) -> QuantPolicy:
    """Explicit arguments win, then ``HETU_COMM_QUANT`` /
    ``HETU_COMM_QUANT_BLOCK`` / ``HETU_COMM_QUANT_MIN`` /
    ``HETU_COMM_QUANT_EF``, then the defaults (off)."""
    if mode is None:
        mode = _env("HETU_COMM_QUANT", "off")
    if block is None:
        block = int(_env("HETU_COMM_QUANT_BLOCK", DEFAULT_BLOCK))
    if min_size is None:
        min_size = int(_env("HETU_COMM_QUANT_MIN", DEFAULT_MIN_SIZE))
    if error_feedback is None:
        error_feedback = _env_bool("HETU_COMM_QUANT_EF", True)
    return QuantPolicy(mode, block=block, min_size=min_size,
                       error_feedback=error_feedback, force=force)


# ---------------------------------------------------------------------------
# the quantized all-reduce over a process group
# ---------------------------------------------------------------------------

def shard_size(n: int, dp: int, block: int) -> int:
    """Elements of one rank's shard: ``n`` padded to a multiple of
    ``dp · block``, over ``dp``. Every shard starts on a block boundary, so
    its blocks are the reference's global blocks."""
    chunk = dp * block
    return -(-n // chunk) * block


def quantized_allreduce(x: torch.Tensor, residual, group,
                        policy: QuantPolicy):
    """One quantized gradient all-reduce over ``group``: the mean of the
    ranks' ``x``, through the wire format of ``policy``.

    1. Flatten ``x`` and pad it to a multiple of ``dp · block``.
    2. ``reduce_scatter_tensor`` in float32, then divide by dp: this rank's
       shard of the mean.
    3. Add this rank's shard of ``residual`` (error feedback), once.
    4. Quantize the shard (kernel ``quant_blocks``).
    5. ``all_gather_into_tensor`` the payload, as uint8 on every backend
       (gloo has no float8), and the scales.
    6. Dequantize (kernel ``dequant_blocks``), cut to n and reshape.

    ``residual`` is None (no error feedback) or this rank's float32 shard
    of ``shard_size`` elements. Returns ``(value, new_residual)``:
    ``value`` has ``x``'s shape and dtype; ``new_residual`` is the shard's
    quantization error (the shard minus its dequantized self), or None.
    """
    dp = dist.get_world_size(group)
    rank = dist.get_rank(group)
    block = policy.block
    n = x.numel()
    size = shard_size(n, dp, block)
    flat = torch.zeros(size * dp, dtype=torch.float32, device=x.device)
    flat[:n] = x.reshape(-1)
    shard = torch.empty(size, dtype=torch.float32, device=x.device)
    multihost.collective(dist.reduce_scatter_tensor, shard, flat,
                         op=dist.ReduceOp.SUM, group=group)
    shard = shard / dp
    if residual is not None:
        shard = shard + residual
    q, scales, _ = quant_comm.quantize_blocks(shard, block, policy.mode)
    q_all = torch.empty(size * dp, dtype=torch.uint8, device=x.device)
    s_all = torch.empty(scales.numel() * dp, dtype=torch.float32,
                        device=x.device)
    multihost.collective(dist.all_gather_into_tensor, q_all,
                         q.view(torch.uint8), group=group)
    multihost.collective(dist.all_gather_into_tensor, s_all, scales,
                         group=group)
    dq = quant_comm.dequantize_blocks(q_all.view(q.dtype), s_all, size * dp,
                                      block)
    new_residual = None
    if residual is not None:
        new_residual = shard - dq[rank * size:(rank + 1) * size]
    return dq[:n].reshape(x.shape).to(x.dtype), new_residual


def allreduce_wire_report(sizes: dict, policy: QuantPolicy,
                          dp: int) -> dict:
    """Analytic per-step wire accounting for the quantized all-reduce
    (``sizes``: quantized parameter name -> element count). ``raw_bytes``
    is the float32 all-reduce's payload (reduce-scatter + all-gather =
    2·N·4 per step), ``wire_bytes`` the quantized decomposition's (float32
    reduce-scatter + 1-byte all-gather + scales)."""
    raw = wire = 0
    for n in sizes.values():
        nb = -(-n // policy.block)
        raw += 2 * n * 4
        wire += n * 4 + n + nb * 4
    return {"params": len(sizes), "elements": sum(sizes.values()),
            "raw_bytes": raw, "wire_bytes": wire, "dp": dp,
            "ratio": round(raw / wire, 3) if wire else None}


# ---------------------------------------------------------------------------
# numpy mirror of the PS wire quantizer (a copy of the JAX package's)
# ---------------------------------------------------------------------------

def np_quantize_blocks(vals, block: int):
    """Bit-exact host mirror of the PS path's C++ int8 quantizer: the same
    float32 operations, the same round half to even."""
    flat = np.ascontiguousarray(vals, np.float32).ravel()
    n = flat.size
    nb = -(-n // block)
    padded = np.zeros(nb * block, np.float32)
    padded[:n] = flat
    blocks = padded.reshape(nb, block)
    amax = np.max(np.abs(blocks), axis=1).astype(np.float32)
    scales = (amax / np.float32(_INT8_Q)).astype(np.float32)
    safe = np.where(scales > 0, scales, np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(blocks / safe[:, None]), -127, 127).astype(np.int8)
    return q.reshape(-1)[: nb * block], scales, n


def np_dequantize_blocks(q, scales, n: int, block: int):
    nb = scales.size
    vals = (q.reshape(nb, block).astype(np.float32)
            * scales[:, None].astype(np.float32)).reshape(-1)
    return vals[:n]


def np_roundtrip(vals, block: int):
    """Quantize then dequantize through the wire mirror; keeps the shape."""
    a = np.ascontiguousarray(vals, np.float32)
    q, s, n = np_quantize_blocks(a, block)
    return np_dequantize_blocks(q, s, n, block).reshape(a.shape)
