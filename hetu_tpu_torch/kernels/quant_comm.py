"""Blockwise quantize and dequantize of the quantized all-reduce:
hand-written CUDA for Hopper, in ``csrc/quant_comm.cu`` (counterpart of
``hetu_tpu/kernels/quant_comm.py``).

``quant_blocks`` replaces ``hetu_tpu/kernels/quant_comm.py:_quant_pallas``
(body ``_quant_kernel``); ``dequant_blocks`` replaces ``_dequant_pallas``
(body ``_dequant_kernel``). ``comm_quant.quantized_allreduce`` launches
each once per quantized parameter per step: the quantize on this rank's
reduce-scattered shard, the dequantize on the all-gathered payload.

    q, scales, n = quantize_blocks(x, block, mode)     # mode "int8" | "fp8"
    x_hat = dequantize_blocks(q, scales, n, block)

``q`` is the padded payload (``ceil(n / block) * block`` elements, int8 or
``float8_e4m3fn``), ``scales`` one float32 per block, ``n`` the element
count; the signatures are the JAX package's. Per block, ``scale =
max|x| / Q`` (Q = 127 for int8, 448 for fp8), a zero block divides by 1,
int8 rounds half to even and clips to ±127, fp8 casts. The payload
crosses the wire, so the kernel, the plain version and the reference's
``comm_quant.quantize_blocks`` agree bit for bit; ``csrc/quant_comm.cu``
says how (an IEEE division, round half to even, a saturating fp8
conversion, a max that keeps NaN).

``_quant_plain``/``_dequant_plain`` are that arithmetic in plain PyTorch:
what a CPU tensor runs, what ``kernels="off"`` runs, and the oracle the
kernels are held against. A CUDA tensor launches the kernel or raises.

Bound on an H100 SXM (3.35 TB/s): bytes, ``5n + 4nb`` for the quantize
and ``n + 4nb + 4n`` for the dequantize; at the MLP's 786,432-element
gradient about 1.2 µs, below a launch's latency.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, registry

_SRC = "quant_comm"
_Q = {"int8": 127.0, "fp8": 448.0}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared: every pointer and
    the stream as c_void_p, the sizes as c_int64."""
    lib = _build.load(_SRC)
    P, I = ctypes.c_void_p, ctypes.c_int64
    lib.hetu_quant_blocks.argtypes = [P, P, P, I, I, I, ctypes.c_int, P]
    lib.hetu_quant_blocks.restype = ctypes.c_int
    lib.hetu_dequant_blocks.argtypes = [P, P, P, I, I, ctypes.c_int, P]
    lib.hetu_dequant_blocks.restype = ctypes.c_int
    return lib


def _wire_dtype(mode: str) -> torch.dtype:
    """The payload's dtype: int8, or float8_e4m3fn for ``"fp8"``."""
    if mode not in _Q:
        raise ValueError(f"quantize_blocks: mode must be int8/fp8, "
                         f"got {mode!r}")
    return torch.float8_e4m3fn if mode == "fp8" else torch.int8


def _n_blocks(n: int, block: int) -> int:
    return -(-n // block)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

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


def _quant_kernel(x: torch.Tensor, *, block: int, mode: str):
    """Launch ``quant_kernel``: new (q, scales) and n. n = 0 launches
    nothing."""
    dtype = _wire_dtype(mode)
    flat = x.reshape(-1).to(torch.float32).contiguous()
    n = flat.numel()
    nb = _n_blocks(n, block)
    q = torch.empty(nb * block, dtype=torch.uint8, device=x.device)
    scales = torch.empty(nb, dtype=torch.float32, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            rc = _lib().hetu_quant_blocks(
                flat.data_ptr(), q.data_ptr(), scales.data_ptr(), n, block,
                nb, int(mode == "fp8"),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"quant_blocks: kernel launch failed with "
                               f"CUDA error {rc}")
        _QUANT.launches += 1
    return q.view(dtype), scales, n


def _quant_eligible(x, *, block: int, mode: str):
    if mode not in _Q:
        return False, f"mode must be int8/fp8, got {mode!r}"
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return False, f"the payload must be a float tensor, got " \
                      f"{getattr(x, 'dtype', type(x).__name__)}"
    if int(block) < 1:
        return False, f"block must be >= 1, got {block}"
    return True, None


_QUANT = registry.register_kernel(
    "quant_blocks", kernel_fn=_quant_kernel, plain_fn=_quant_plain,
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


def _dequant_kernel(q: torch.Tensor, scales: torch.Tensor, *, n: int,
                    block: int) -> torch.Tensor:
    """Launch ``dequant_kernel``: a new (n,) float32. n = 0 launches
    nothing."""
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    if n:
        with torch.cuda.device(q.device):
            rc = _lib().hetu_dequant_blocks(
                q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, block,
                int(q.dtype == torch.float8_e4m3fn),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"dequant_blocks: kernel launch failed with "
                               f"CUDA error {rc}")
        _DEQUANT.launches += 1
    return out


def _dequant_eligible(q, scales, *, n: int, block: int):
    """``q`` int8 or float8_e4m3fn and ``scales`` float32, contiguous on
    one CUDA device, ``q`` one block per scale, 0 <= n <= q.numel()."""
    for nm, t in (("q", q), ("scales", scales)):
        if not isinstance(t, torch.Tensor):
            return False, f"{nm} must be a tensor, got {type(t).__name__}"
        if t.device != q.device:
            return False, f"{nm} is on {t.device}, q on {q.device}"
        if not t.is_contiguous():
            return False, f"{nm} is not contiguous"
    if q.dtype not in (torch.int8, torch.float8_e4m3fn):
        return False, f"q must be int8 or float8_e4m3fn, got {q.dtype}"
    if scales.dtype != torch.float32:
        return False, f"scales must be float32, got {scales.dtype}"
    if int(block) < 1 or q.numel() != scales.numel() * int(block):
        return False, (f"q has {q.numel()} elements, expected "
                       f"{scales.numel()} blocks of {block}")
    if not 0 <= int(n) <= q.numel():
        return False, f"n = {n} is outside [0, {q.numel()}]"
    return True, None


_DEQUANT = registry.register_kernel(
    "dequant_blocks", kernel_fn=_dequant_kernel, plain_fn=_dequant_plain,
    eligibility=_dequant_eligible)


# ---------------------------------------------------------------------------
# public forms (signatures of hetu_tpu.kernels.quant_comm)
# ---------------------------------------------------------------------------

def quantize_blocks(x: torch.Tensor, block: int, mode: str = "int8"):
    """Registry-dispatched blockwise quantize: ``(q, scales, n)``."""
    return registry.dispatch("quant_blocks", x, block=int(block), mode=mode)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, n: int,
                      block: int) -> torch.Tensor:
    """Registry-dispatched inverse of :func:`quantize_blocks`: the first
    ``n`` values, float32."""
    return registry.dispatch("dequant_blocks", q, scales, n=int(n),
                             block=int(block))
