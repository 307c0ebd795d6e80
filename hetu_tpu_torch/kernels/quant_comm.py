"""Blockwise quantize and dequantize of the quantized all-reduce:
hand-written CUDA for Hopper, in ``csrc/quant_comm.cu`` (counterpart of
``hetu_tpu/kernels/quant_comm.py``).

``quant_blocks`` replaces ``hetu_tpu/kernels/quant_comm.py:_quant_pallas``
(body ``_quant_kernel``); ``dequant_blocks`` replaces ``_dequant_pallas``
(body ``_dequant_kernel``). ``comm_quant.quantized_allreduce_group``
launches each once per optimizer node and step, over every quantized
gradient of the node: the quantize on this rank's reduce-scattered shard
of the group (the mean over dp, the error-feedback residual in and out
fused in), the dequantize on the all-gathered payload of all ranks,
straight into one param-major output.

    q, scales, n = quantize_blocks(x, block, mode)     # mode "int8" | "fp8"
    x_hat = dequantize_blocks(q, scales, n, block)

are the single-tensor forms, groups of one with no prologue: ``q`` is the
padded payload (``ceil(n / block) * block`` elements, int8 or
``float8_e4m3fn``), ``scales`` one float32 per block, ``n`` the element
count; the signatures are the JAX package's. Per block, ``scale =
max|x| / Q`` (Q = 127 for int8, 448 for fp8), a zero block divides by 1,
int8 rounds half to even and clips to ±127, fp8 casts. The payload
crosses the wire, so the kernel, the plain version and the reference's
``comm_quant.quantize_blocks`` agree bit for bit; ``csrc/quant_comm.cu``
says how (an IEEE division, round half to even, a saturating fp8
conversion, a max that keeps NaN).

The group's work split is :func:`qar_plan`'s, computed once in Python per
``(sizes, dp, block)``, uploaded once per device (:func:`plan_on`), and
read by the C code as given: per tensor its element count ``n_p``, its
shard ``S_p = shard_size(n_p, dp, block)`` (a multiple of ``block``, so
every block of the rank's shard belongs to one tensor), its offset in the
rank's concatenated shard, its first block there, and its offset in the
param-major output (a multiple of 4 elements, so each output starts
16-byte aligned). The dequantize finds a block's tensor by a binary
search over the first blocks, so a group has no cap on its tensors.

``_quant_plain``/``_dequant_plain`` are that arithmetic in plain PyTorch,
per tensor; ``_quant_group_plain``/``_dequant_group_plain`` compose them
into the group forms: what a CPU tensor runs, what ``kernels="off"``
runs, and the oracle the kernels are held against. A CUDA tensor launches
the kernel or raises.

Bound on an H100 SXM (3.35 TB/s): bytes, ``13n + 4nb`` for the quantize
with error feedback (``5n + 4nb`` without), ``n + 4nb + 4n`` for the
dequantize; at the MLP's three quantized gradients (854,528 elements)
3.3 µs and 1.3 µs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, registry

_SRC = "quant_comm"
_Q = {"int8": 127.0, "fp8": 448.0}
# blocks the vector paths take (block = 32 * E, E elements a lane); any
# other block runs the scalar path
_VEC_BLOCKS = (64, 128, 256)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared: every pointer and
    the stream as c_void_p, the sizes as c_int64."""
    lib = _build.load(_SRC)
    P, I, N = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hetu_quant_group.argtypes = [P, P, P, P, P, I, I, I, I, N, N, P]
    lib.hetu_quant_group.restype = ctypes.c_int
    lib.hetu_dequant_group.argtypes = [P, I, P, I, P, P, I, I, I, I, N, N, P]
    lib.hetu_dequant_group.restype = ctypes.c_int
    return lib


def _wire_dtype(mode: str) -> torch.dtype:
    """The payload's dtype: int8, or float8_e4m3fn for ``"fp8"``."""
    if mode not in _Q:
        raise ValueError(f"quantize_blocks: mode must be int8/fp8, "
                         f"got {mode!r}")
    return torch.float8_e4m3fn if mode == "fp8" else torch.int8


def _n_blocks(n: int, block: int) -> int:
    return -(-n // block)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_size(n: int, dp: int, block: int) -> int:
    """Elements of one rank's shard: ``n`` padded to a multiple of
    ``dp · block``, over ``dp``. Every shard starts on a block boundary, so
    its blocks are the reference's global blocks."""
    return _n_blocks(n, dp * block) * block


class QarPlan(NamedTuple):
    """The split of one group of ``sizes`` over ``dp`` ranks. Per tensor
    ``p``: ``shard_sizes[p]`` (``S_p``), ``shard_offs[p]`` (its offset in
    the rank's concatenated shard of ``shard`` elements),
    ``first_blocks[p]`` (``shard_offs[p] / block``; ``first_blocks[-1]``
    is ``blocks``), ``out_offs[p]`` (its offset in the param-major output
    of ``out_size`` floats). ``q_bytes`` is the payload's length in a
    rank's send buffer, padded to 16; its scales follow, and ``chunk``
    bytes (a multiple of 16) is what each rank sends. ``vec``: the
    elements a lane takes on the vector path, 0 for the scalar one.
    ``array`` is the int64 table the C code reads: first blocks, then
    sizes, shard sizes and output offsets."""
    sizes: tuple
    dp: int
    block: int
    shard_sizes: tuple
    shard_offs: tuple
    first_blocks: tuple
    out_offs: tuple
    shard: int
    blocks: int
    out_size: int
    q_bytes: int
    chunk: int
    vec: int
    array: tuple


@functools.lru_cache(maxsize=256)
def qar_plan(sizes: tuple, dp: int, block: int) -> QarPlan:
    """The plan of a group of tensors of ``sizes`` elements over ``dp``
    ranks at ``block``. Cached per ``(sizes, dp, block)``."""
    shard_sizes = tuple(shard_size(n, dp, block) for n in sizes)
    shard_offs, out_offs, at, out = [], [], 0, 0
    for n, s in zip(sizes, shard_sizes):
        shard_offs.append(at)
        out_offs.append(out)
        at += s
        out = _round_up(out + n, 4)
    first = tuple(o // block for o in shard_offs) + (at // block,)
    out_size = out_offs[-1] + sizes[-1] if sizes else 0
    q_bytes = _round_up(at, 16)
    return QarPlan(
        sizes=tuple(sizes), dp=dp, block=block, shard_sizes=shard_sizes,
        shard_offs=tuple(shard_offs), first_blocks=first,
        out_offs=tuple(out_offs), shard=at, blocks=at // block,
        out_size=out_size, q_bytes=q_bytes,
        chunk=q_bytes + _round_up(4 * (at // block), 16),
        vec=block // 32 if block in _VEC_BLOCKS else 0,
        array=first + tuple(sizes) + shard_sizes + tuple(out_offs))


@functools.lru_cache(maxsize=256)
def plan_on(plan: QarPlan, device: torch.device) -> torch.Tensor:
    """The plan's int64 table on ``device``, uploaded once."""
    return torch.tensor(plan.array, dtype=torch.int64, device=device)


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

def _mean(x: torch.Tensor, dp: int) -> torch.Tensor:
    """The mean over dp ranks of their reduce-scattered sum: the IEEE
    quotient ``x / dp``, divided by a tensor (on CUDA PyTorch divides by a
    Python scalar as a product with its rounded reciprocal, which agrees
    with the quotient only where 1 / dp is exact: dp = 1, 2, 4, 8).
    ``csrc/quant_comm.cu`` computes the same; at dp = 1 both skip it."""
    return x if dp == 1 else x / x.new_full((1,), float(dp))


def _quant_plain(x: torch.Tensor, *, block: int, mode: str):
    """``comm_quant.quantize_blocks`` in PyTorch: (q, scales, n)."""
    dtype = _wire_dtype(mode)
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    nb = _n_blocks(n, block)
    if nb * block > n:
        flat = torch.nn.functional.pad(flat, (0, nb * block - n))
    blocks = flat.view(nb, block)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # divided by a tensor, not by the Python float: on CUDA PyTorch divides
    # by a scalar as a product with its rounded reciprocal, an ulp off the
    # IEEE quotient that the reference and the kernel take
    scales = amax / torch.full_like(amax, _Q[mode])
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    v = blocks / safe
    if mode == "int8":
        v = torch.clamp(torch.round(v), -127, 127)
    return v.to(dtype).reshape(-1), scales.reshape(-1), n


def _quant_outputs(x, block, residual, out):
    """``out`` as (q as uint8, scales, new residual), or new tensors."""
    n = x.numel()
    if out is not None:
        q, scales, new = out
        return q.view(torch.uint8), scales, new
    nb = _n_blocks(n, block)
    return (torch.empty(nb * block, dtype=torch.uint8, device=x.device),
            torch.empty(nb, dtype=torch.float32, device=x.device),
            None if residual is None else torch.empty(
                n, dtype=torch.float32, device=x.device))


def _quant_group_plain(x: torch.Tensor, *, block: int, mode: str, dp: int = 1,
                       residual=None, out=None):
    """The quantize of the all-reduce in PyTorch, per element in this
    order: ``v = x / dp`` (:func:`_mean`), ``v + residual``, then
    :func:`_quant_plain`, and the new residual ``v - dq`` with ``dq``
    :func:`_dequant_plain`'s. Returns ``(q, scales, new_residual)`` (None
    without ``residual``), written into ``out``'s tensors where given."""
    dtype = _wire_dtype(mode)
    v = _mean(x.reshape(-1).to(torch.float32), dp)
    if residual is not None:
        v = v + residual
    q, scales, n = _quant_plain(v, block=block, mode=mode)
    new = None
    if residual is not None:
        new = v - _dequant_plain(q, scales, n=n, block=block)
    if out is None:
        return q, scales, new
    oq, oscales, onew = _quant_outputs(x, block, residual, out)
    oq.copy_(q.view(torch.uint8))
    oscales.copy_(scales)
    if new is not None:
        onew.copy_(new)
    return oq.view(dtype), oscales, onew


def _quant_kernel(x: torch.Tensor, *, block: int, mode: str, dp: int = 1,
                  residual=None, out=None):
    """Launch the quantize (``hetu_quant_group``) once: ``(q, scales,
    new_residual)``, into ``out``'s tensors where given. n = 0 launches
    nothing."""
    dtype = _wire_dtype(mode)
    flat = x.reshape(-1).to(torch.float32).contiguous()
    n = flat.numel()
    nb = _n_blocks(n, block)
    q, scales, new = _quant_outputs(flat, block, residual, out)
    if n:
        vec = block // 32 if block in _VEC_BLOCKS and _aligned(
            flat, residual, new, q) else 0
        with torch.cuda.device(x.device):
            rc = _lib().hetu_quant_group(
                flat.data_ptr(), _ptr(residual), _ptr(new), q.data_ptr(),
                scales.data_ptr(), n, block, nb, dp, int(mode == "fp8"), vec,
                _stream())
        if rc != 0:
            raise RuntimeError(f"quant_blocks: kernel launch failed with "
                               f"CUDA error {rc}")
        _QUANT.launches += 1
    return q.view(dtype), scales, new


def _ptr(t):
    return None if t is None else t.data_ptr()


def _quant_eligible(x, *, block: int, mode: str, dp: int = 1, residual=None,
                    out=None):
    """``x`` a float tensor; ``residual`` (or None) and the new residual of
    ``out`` float32, contiguous, of x's element count, on its device;
    ``out``'s payload one byte an element of whole blocks, its scales
    float32, one a block."""
    if mode not in _Q:
        return False, f"mode must be int8/fp8, got {mode!r}"
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return False, f"the payload must be a float tensor, got " \
                      f"{getattr(x, 'dtype', type(x).__name__)}"
    if int(block) < 1:
        return False, f"block must be >= 1, got {block}"
    if int(dp) < 1:
        return False, f"dp must be >= 1, got {dp}"
    n = x.numel()
    nb = _n_blocks(n, int(block))
    q, scales, new = out if out is not None else (None, None, None)
    if out is not None and (residual is None) != (new is None):
        return False, "out's new residual must be given with the residual"
    for nm, t, size, dtypes in (
            ("residual", residual, n, (torch.float32,)),
            ("the new residual", new, n, (torch.float32,)),
            ("q", q, nb * int(block),
             (torch.uint8, torch.int8, torch.float8_e4m3fn)),
            ("scales", scales, nb, (torch.float32,))):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.device != x.device:
            return False, f"{nm} is on {getattr(t, 'device', None)}, x on " \
                          f"{x.device}"
        if t.dtype not in dtypes or not t.is_contiguous() \
                or t.numel() != size:
            return False, (f"{nm} must be a contiguous {dtypes[0]} tensor "
                           f"of {size} elements, got {t.dtype} "
                           f"{tuple(t.shape)}")
    return True, None


_QUANT = registry.register_kernel(
    "quant_blocks", kernel_fn=_quant_kernel, plain_fn=_quant_group_plain,
    eligibility=_quant_eligible)


# ---------------------------------------------------------------------------
# dequantize
# ---------------------------------------------------------------------------

def _dequant_plain(q: torch.Tensor, scales: torch.Tensor, *, n: int,
                   block: int) -> torch.Tensor:
    """``comm_quant.dequantize_blocks`` in PyTorch: q·scale per block in
    float32, the first n elements."""
    nb = scales.numel()
    vals = (q.reshape(nb, block).to(torch.float32)
            * scales.reshape(nb, 1)).reshape(-1)
    return vals[:n]


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1) if t.dim() == 1 else t


def _dequant_group_plain(q: torch.Tensor, scales: torch.Tensor, *, n: int,
                         block: int, plan=None, out=None) -> torch.Tensor:
    """The group dequantize in PyTorch: for each tensor of ``plan``, each
    rank's shard through :func:`_dequant_plain`, joined in rank order and
    cut to its first ``n_p`` values, as a tensor's all-reduce alone keeps
    them. ``q``/``scales``: one row per rank (a 1-D pair without a plan).
    Returns ``out`` (or a new float32 tensor) holding the param-major
    values."""
    if plan is None:
        vals = _dequant_plain(q, scales, n=n, block=block)
        return vals if out is None else out.copy_(vals)
    q, scales = _rows(q), _rows(scales)
    if out is None:
        out = torch.empty(plan.out_size, dtype=torch.float32, device=q.device)
    for size, s_p, first, at in zip(plan.sizes, plan.shard_sizes,
                                    plan.first_blocks, plan.out_offs):
        k = s_p // block
        parts = [_dequant_plain(q[r, first * block:(first + k) * block],
                                scales[r, first:first + k], n=s_p,
                                block=block) for r in range(plan.dp)]
        out[at:at + size] = torch.cat(parts)[:size]
    return out


def _dequant_kernel(q: torch.Tensor, scales: torch.Tensor, *, n: int,
                    block: int, plan=None, out=None) -> torch.Tensor:
    """Launch the dequantize (``hetu_dequant_group``) once over the plan's
    tensors (without a plan: one tensor of n elements): ``out``, or a new
    float32 tensor of the plan's ``out_size``. n = 0 launches nothing."""
    if plan is None:
        plan = qar_plan((int(n),), 1, block)
    if out is None:
        out = torch.empty(plan.out_size, dtype=torch.float32, device=q.device)
    rq, rs = _rows(q), _rows(scales)
    if n:
        vec = plan.vec if _aligned(rq, out) and (
            rq.size(0) == 1 or rq.stride(0) % 16 == 0) else 0
        with torch.cuda.device(q.device):
            rc = _lib().hetu_dequant_group(
                rq.data_ptr(), rq.stride(0), rs.data_ptr(), rs.stride(0),
                out.data_ptr(), plan_on(plan, q.device).data_ptr(),
                len(plan.sizes), plan.blocks, block, plan.dp,
                int(q.dtype == torch.float8_e4m3fn), vec, _stream())
        if rc != 0:
            raise RuntimeError(f"dequant_blocks: kernel launch failed with "
                               f"CUDA error {rc}")
        _DEQUANT.launches += 1
    return out


def _dequant_eligible(q, scales, *, n: int, block: int, plan=None, out=None):
    """``q`` int8 or float8_e4m3fn and ``scales`` float32 on one CUDA
    device, rows contiguous. Without a plan: 1-D, contiguous, one block per
    scale, 0 <= n <= q.numel(). With one: a row per rank holding the
    plan's shard and its scales, n the plan's element count. ``out``: a
    contiguous float32 tensor of the plan's ``out_size``."""
    for nm, t in (("q", q), ("scales", scales)):
        if not isinstance(t, torch.Tensor):
            return False, f"{nm} must be a tensor, got {type(t).__name__}"
        if t.device != q.device:
            return False, f"{nm} is on {t.device}, q on {q.device}"
        if plan is None and not t.is_contiguous():
            return False, f"{nm} is not contiguous"
        if t.dim() not in (1, 2) or t.stride(-1) != 1:
            return False, f"{nm} must be 1-D or rows of contiguous elements"
    if q.dtype not in (torch.int8, torch.float8_e4m3fn):
        return False, f"q must be int8 or float8_e4m3fn, got {q.dtype}"
    if scales.dtype != torch.float32:
        return False, f"scales must be float32, got {scales.dtype}"
    if plan is None:
        if q.dim() != 1 or int(block) < 1 \
                or q.numel() != scales.numel() * int(block):
            return False, (f"q has {q.numel()} elements, expected "
                           f"{scales.numel()} blocks of {block}")
        if not 0 <= int(n) <= q.numel():
            return False, f"n = {n} is outside [0, {q.numel()}]"
        size = int(n)
    else:
        rq, rs = _rows(q), _rows(scales)
        if plan.block != int(block) or int(n) != sum(plan.sizes):
            return False, (f"the plan is for block {plan.block} and "
                           f"{sum(plan.sizes)} elements, the call for "
                           f"block {block} and n = {n}")
        if rq.size(0) != plan.dp or rs.size(0) != plan.dp \
                or rq.size(1) < plan.shard or rs.size(1) < plan.blocks:
            return False, (f"q {tuple(rq.shape)} and scales "
                           f"{tuple(rs.shape)} must hold {plan.dp} rows of "
                           f"{plan.shard} and {plan.blocks} elements")
        size = plan.out_size
    if out is not None and (
            not isinstance(out, torch.Tensor) or out.device != q.device
            or out.dtype != torch.float32 or not out.is_contiguous()
            or out.numel() != size):
        return False, (f"out must be a contiguous float32 tensor of {size} "
                       f"elements on {q.device}")
    return True, None


_DEQUANT = registry.register_kernel(
    "dequant_blocks", kernel_fn=_dequant_kernel,
    plain_fn=_dequant_group_plain, eligibility=_dequant_eligible)


# ---------------------------------------------------------------------------
# public forms (signatures of hetu_tpu.kernels.quant_comm), and the group
# forms of the quantized all-reduce
# ---------------------------------------------------------------------------

def quantize_blocks(x: torch.Tensor, block: int, mode: str = "int8"):
    """Registry-dispatched blockwise quantize: ``(q, scales, n)``."""
    q, scales, _ = registry.dispatch("quant_blocks", x, block=int(block),
                                     mode=mode)
    return q, scales, x.numel()


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, n: int,
                      block: int) -> torch.Tensor:
    """Registry-dispatched inverse of :func:`quantize_blocks`: the first
    ``n`` values, float32."""
    return registry.dispatch("dequant_blocks", q, scales, n=int(n),
                             block=int(block))


def quantize_shard(shard: torch.Tensor, plan: QarPlan, mode: str,
                   residual, out):
    """The all-reduce's quantize of this rank's shard of a group, one
    dispatch: the mean over ``plan.dp``, plus ``residual`` (or None), into
    ``out`` = (payload, scales, new residual or None)."""
    return registry.dispatch("quant_blocks", shard, block=plan.block,
                             mode=mode, dp=plan.dp, residual=residual,
                             out=out)


def dequantize_group(q: torch.Tensor, scales: torch.Tensor, plan: QarPlan,
                     out: torch.Tensor) -> torch.Tensor:
    """The all-reduce's dequantize of every rank's payload (``q`` and
    ``scales``, a row per rank) into ``out``, param-major, one dispatch."""
    return registry.dispatch("dequant_blocks", q, scales,
                             n=sum(plan.sizes), block=plan.block, plan=plan,
                             out=out)
