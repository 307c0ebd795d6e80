"""Fused optimizer step kernels: hand-written CUDA for Hopper, in
``csrc/fused_opt.cu`` (counterpart of ``hetu_tpu/kernels/fused_opt.py``).

``fused_sgd`` replaces ``hetu_tpu/kernels/fused_opt.py:_sgd_pallas`` (body
``_sgd_kernel``); ``fused_adam`` replaces ``_adam_pallas`` (body
``_adam_kernel``). Both serve every dense apply of ``SGDOptimizer`` and
``AdamOptimizer``/``AdamWOptimizer``, one launch per parameter.

Bound on an H100 SXM (3.35 TB/s): SGD moves 12 bytes per element (read p,
g; write p), Adam 28 (read p, g, m, v; write p, m, v), at a few flops per
element — both are memory-bound, and the kernels make exactly one pass
with no intermediate in device memory. At the MLP's 855,050 parameters a
step's bound is 3.1 us (SGD) and 7.1 us (Adam); the six launches per step
cost more than that, which a later multi-tensor launch addresses.

The kernels update ``p``, ``m`` and ``v`` in place, unlike the JAX ones,
to save a copy; the step functions below run under ``torch.no_grad()`` on
tensors autograd does not track, and make the plain path write in place
too, so callers see one behaviour on every device. ``lr`` and ``t`` are
1-element float32 tensors on the device; ``t + 1`` is a torch op after
the launch (the kernel must not write ``t``: its blocks run in no order).

``_sgd_plain``/``_adam_plain`` are the same expression sequence as
``_sgd_xla``/``_adam_xla`` in plain PyTorch: what a CPU tensor runs, what
``kernels="off"`` runs, and the oracle the kernels are held against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, registry

_SRC = "fused_opt"


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared: every pointer and
    the stream as c_void_p, n as c_int64 (ctypes would cut them to int)."""
    lib = _build.load(_SRC)
    P, F, I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
    lib.hetu_fused_sgd.argtypes = [P, P, P, F, I, P]
    lib.hetu_fused_sgd.restype = ctypes.c_int
    lib.hetu_fused_adam.argtypes = [P, P, P, P, P, P, F, F, F, F, F, F, I, P]
    lib.hetu_fused_adam.restype = ctypes.c_int
    return lib


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


# ---------------------------------------------------------------------------
# Adam (bias-corrected; optional decoupled weight decay)
# ---------------------------------------------------------------------------

def _adam_plain(param, grad, m, v, t, lr, *, beta1, beta2, eps, weight_decay):
    """``hetu_tpu.kernels.fused_opt._adam_xla`` in PyTorch: returns
    ``(new_param, m, v, t + 1)`` as new tensors."""
    t = t + 1.0
    m = beta1 * m + (1.0 - beta1) * grad
    v = beta2 * v + (1.0 - beta2) * grad * grad
    m_hat = m / (1.0 - beta1 ** t)
    v_hat = v / (1.0 - beta2 ** t)
    new_param = param - lr * m_hat / (torch.sqrt(v_hat) + eps)
    if weight_decay > 0:
        new_param = new_param - lr * weight_decay * param
    return new_param, m, v, t


def _adam_kernel(param, grad, m, v, t, lr, *, beta1, beta2, eps, weight_decay):
    """Launch ``adam_kernel``: updates param, m, v in place; returns
    ``(param, m, v, t + 1)``."""
    lib = _lib()
    with torch.cuda.device(param.device):
        rc = lib.hetu_fused_adam(
            param.data_ptr(), grad.data_ptr(), m.data_ptr(), v.data_ptr(),
            t.data_ptr(), lr.data_ptr(), beta1, beta2, 1.0 - beta1,
            1.0 - beta2, eps, weight_decay, param.numel(),
            torch.cuda.current_stream().cuda_stream)
    _check_rc("fused_adam", rc)
    _ADAM.launches += 1
    return param, m, v, t + 1.0


def _adam_eligible(param, grad, m, v, t, lr, **_kw):
    return registry.check_tensors({"param": param, "grad": grad, "m": m,
                                   "v": v}, param, {"t": t, "lr": lr})


_ADAM = registry.register_kernel(
    "fused_adam", kernel_fn=_adam_kernel, plain_fn=_adam_plain,
    eligibility=_adam_eligible)


# ---------------------------------------------------------------------------
# SGD (l2 folded into the same pass)
# ---------------------------------------------------------------------------

def _sgd_plain(param, grad, lr, *, l2reg):
    """``hetu_tpu.kernels.fused_opt._sgd_xla`` in PyTorch (a new tensor)."""
    if l2reg > 0:
        grad = grad + l2reg * param
    return param - lr * grad


def _sgd_kernel(param, grad, lr, *, l2reg):
    """Launch ``sgd_kernel``: updates param in place and returns it."""
    lib = _lib()
    with torch.cuda.device(param.device):
        rc = lib.hetu_fused_sgd(
            param.data_ptr(), grad.data_ptr(), lr.data_ptr(), l2reg,
            param.numel(), torch.cuda.current_stream().cuda_stream)
    _check_rc("fused_sgd", rc)
    _SGD.launches += 1
    return param


def _sgd_eligible(param, grad, lr, **_kw):
    return registry.check_tensors({"param": param, "grad": grad}, param,
                                  {"lr": lr})


_SGD = registry.register_kernel(
    "fused_sgd", kernel_fn=_sgd_kernel, plain_fn=_sgd_plain,
    eligibility=_sgd_eligible)


# ---------------------------------------------------------------------------
# optimizer.py entry points (signatures of hetu_tpu's adam_step/sgd_step)
# ---------------------------------------------------------------------------

def _write_back(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    if src is not dst:
        dst.copy_(src)
    return dst


def adam_step(opt, param, grad, slot, lr):
    """Registry-dispatched Adam apply for one parameter, in place. ``opt``
    is the AdamOptimizer; ``lr`` a 1-element f32 tensor on param's device."""
    with torch.no_grad():
        new_p, m, v, t = registry.dispatch(
            "fused_adam", param, grad, slot["m"], slot["v"], slot["t"], lr,
            beta1=opt.beta1, beta2=opt.beta2, eps=opt.epsilon,
            weight_decay=opt.weight_decay)
        return _write_back(param, new_p), {"m": _write_back(slot["m"], m),
                                           "v": _write_back(slot["v"], v),
                                           "t": t}


def sgd_step(opt, param, grad, lr):
    """Registry-dispatched SGD apply for one parameter, in place."""
    with torch.no_grad():
        return _write_back(param, registry.dispatch(
            "fused_sgd", param, grad, lr, l2reg=opt.l2reg))
