"""Quantized communication for the data-parallel gradient all-reduce
(counterpart of ``hetu_tpu/comm_quant.py``).

One policy knob, ``HetuConfig(comm_quant="off"|"int8"|"fp8")`` or
``HETU_COMM_QUANT`` (plus ``_BLOCK``, ``_MIN`` and ``_EF``), chooses
whether the gradient all-reduce of each large parameter is exact or
compressed. The compressed all-reduce is a reduce-scatter in float32, so
the sum itself stays exact, then a blockwise quantize of this rank's
shard (int8 or fp8 with one float32 scale per block), an all-gather of
the one-byte payload and its scales, and a dequantize: the EQuARX
decomposition the JAX package expresses through GSPMD sharding
constraints, here written out over a ``torch.distributed`` process group.
An optional error-feedback residual, executor state, carries the
quantization error into the next step. The executor runs it once per
optimizer node and step over all of the node's quantized gradients
(:func:`quantized_allreduce_group` through a persistent
:class:`QarGroup`: one bucket copy, one reduce-scatter, one quantize, one
all-gather, one dequantize); :func:`quantized_allreduce` is its group of
one.

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

shard_size = quant_comm.shard_size


class QarGroup:
    """The persistent state of one group's quantized all-reduce: the plan
    (:func:`~.kernels.quant_comm.qar_plan`) of its tensors' ``sizes`` over
    ``dp`` ranks, and the buffers every step reuses, allocated once:

    - ``bucket``: the ranks' shards of every tensor, rank-major, float32,
      zero-padded (the padding is never written, so it stays zero);
    - ``shard``: this rank's reduce-scattered sum;
    - ``send``/``recv``: a rank's ``[payload, padded to 16 | scales]``
      (uint8 on every backend: gloo has no float8), and all ranks' of it;
    - two residual buffers of a shard each (error feedback): a step reads
      the one its residuals are views of and writes the other, so the
      caller commits the new residual by keeping the views returned, and
      a step that raises leaves the old one as it was.
    """

    def __init__(self, sizes, dp: int, policy: QuantPolicy, device):
        self.policy = policy
        pl = self.plan = quant_comm.qar_plan(
            tuple(int(s) for s in sizes), int(dp), policy.block)
        f32 = torch.float32
        self.bucket = torch.zeros(pl.shard * pl.dp, dtype=f32, device=device)
        self.shard = torch.empty(pl.shard, dtype=f32, device=device)
        self.send = torch.zeros(pl.chunk, dtype=torch.uint8, device=device)
        self.recv = torch.empty(pl.chunk * pl.dp, dtype=torch.uint8,
                                device=device)
        # the payload and scales in the send buffer, and each rank's (a row
        # per rank) in the receive buffer
        dtype = quant_comm._wire_dtype(policy.mode)
        scales = slice(pl.q_bytes, pl.q_bytes + 4 * pl.blocks)
        self.send_q = self.send[:pl.shard].view(dtype)
        self.send_scales = self.send[scales].view(f32)
        rows = self.recv.view(pl.dp, pl.chunk)
        self.recv_q = rows[:, :pl.shard].view(dtype)
        self.recv_scales = rows[:, scales].view(f32)
        # the copies into the bucket: x_p's elements [lo, hi) into rank r's
        # shard of p
        self._copies, self._bucket_views = [], []
        for p, (n, s_p, off) in enumerate(zip(pl.sizes, pl.shard_sizes,
                                              pl.shard_offs)):
            for r in range(pl.dp):
                lo, hi = r * s_p, min(n, (r + 1) * s_p)
                if hi > lo:
                    at = r * pl.shard + off
                    self._copies.append((p, lo, hi))
                    self._bucket_views.append(self.bucket[at:at + hi - lo])
        self._resid = None

    def fill_bucket(self, xs) -> None:
        """Copy the ``xs`` into the bucket, one multi-tensor copy."""
        flats = [x.reshape(-1) for x in xs]
        torch._foreach_copy_(self._bucket_views,
                             [flats[p][lo:hi] for p, lo, hi in self._copies])

    def residual_views(self, i: int = 0) -> list:
        """Per tensor, its shard of residual buffer ``i`` (0 or 1)."""
        if self._resid is None:
            bufs = [torch.zeros_like(self.shard) for _ in range(2)]
            self._resid = [(b, [b[o:o + s] for o, s in zip(
                self.plan.shard_offs, self.plan.shard_sizes)]) for b in bufs]
        return self._resid[i][1]

    def _residual_buffers(self, residuals):
        """(in, out, out's views): the buffer ``residuals`` are views of,
        else buffer 0 after copying them in; and the other."""
        self.residual_views()
        (a, va), (b, vb) = self._resid
        for (buf, views), (other, oviews) in (((a, va), (b, vb)),
                                             ((b, vb), (a, va))):
            if all(r.data_ptr() == v.data_ptr() and r.numel() == v.numel()
                   for r, v in zip(residuals, views)):
                return buf, other, oviews
        torch._foreach_copy_(va, [r.reshape(-1) for r in residuals])
        return a, b, vb

    def __call__(self, xs, residuals, group):
        """One step: returns ``(values, new_residuals)`` as
        :func:`quantized_allreduce_group`."""
        pl = self.plan
        self.fill_bucket(xs)
        multihost.collective(dist.reduce_scatter_tensor, self.shard,
                             self.bucket, op=dist.ReduceOp.SUM, group=group)
        r_in = r_out = new = None
        if residuals is not None:
            r_in, r_out, new = self._residual_buffers(residuals)
        quant_comm.quantize_shard(self.shard, pl, self.policy.mode, r_in,
                                  (self.send_q, self.send_scales, r_out))
        multihost.collective(dist.all_gather_into_tensor, self.recv,
                             self.send, group=group)
        out = quant_comm.dequantize_group(
            self.recv_q, self.recv_scales, pl, torch.empty(pl.out_size, dtype=torch.float32,
                                            device=self.shard.device))
        values = [out[o:o + x.numel()].view(x.shape).to(x.dtype)
                  for o, x in zip(pl.out_offs, xs)]
        return values, (None if new is None else list(new))


def quantized_allreduce_group(xs, residuals, group, policy: QuantPolicy,
                              state: QarGroup | None = None):
    """The quantized gradient all-reduce of a group of tensors over
    ``group``: the mean of the ranks' ``xs``, each through the wire format
    of ``policy``, in one launch of each kernel for the whole group.

    1. One multi-tensor copy (``torch._foreach_copy_``) of the ``xs`` into
       the zero-padded bucket: each tensor padded to a multiple of
       ``dp · block``, its ranks' shards rank-major, so this rank's shard
       of the group is the concatenation of its shard of each tensor.
    2. ``reduce_scatter_tensor`` in float32: this rank's shard of the sum.
    3. The quantize (kernel ``quant_blocks``): the mean over dp, this
       rank's shard of the ``residuals`` added (error feedback), the
       payload and scales into the send buffer, the new residual.
    4. One ``all_gather_into_tensor`` of payload and scales together.
    5. The dequantize (kernel ``dequant_blocks``) of every rank's payload,
       only the elements kept, into one new param-major float32 tensor.

    ``residuals`` is None (no error feedback) or, per tensor, this rank's
    float32 shard of ``shard_size`` elements. Returns ``(values,
    new_residuals)``: ``values`` views of the output in each ``x``'s shape
    (and dtype); ``new_residuals`` each shard's quantization error (the
    shard minus its dequantized self), or None. ``state``: the
    :class:`QarGroup` whose buffers the step reuses (new ones without).

    Per element this is the arithmetic of :func:`quantized_allreduce` run
    on each tensor alone. At dp <= 2 the bucketed
    reduce-scatter sums the same two addends per element as a per-tensor
    one, so the values are bit-equal; at dp > 2 NCCL and gloo may add the
    ranks in another order at another bucket position, which moves a sum
    by float32 rounding, and its quantized value by at most one
    quantization step (the block's scale).
    """
    if state is None:
        state = QarGroup([x.numel() for x in xs],
                         dist.get_world_size(group), policy, xs[0].device)
    return state(xs, residuals, group)


def quantized_allreduce(x: torch.Tensor, residual, group,
                        policy: QuantPolicy):
    """One quantized gradient all-reduce over ``group``: the mean of the
    ranks' ``x``, through the wire format of ``policy``;
    :func:`quantized_allreduce_group` for a group of one.

    ``residual`` is None (no error feedback) or this rank's float32 shard
    of ``shard_size`` elements. Returns ``(value, new_residual)``:
    ``value`` has ``x``'s shape and dtype; ``new_residual`` is the shard's
    quantization error (the shard minus its dequantized self), or None.
    """
    values, new = quantized_allreduce_group(
        [x], None if residual is None else [residual], group, policy)
    return values[0], None if new is None else new[0]


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
