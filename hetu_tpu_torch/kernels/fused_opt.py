"""Fused optimizer step kernels: hand-written CUDA for Hopper, in
``csrc/fused_opt.cu`` (counterpart of ``hetu_tpu/kernels/fused_opt.py``).

``fused_sgd`` replaces ``hetu_tpu/kernels/fused_opt.py:_sgd_pallas`` (body
``_sgd_kernel``); ``fused_adam`` replaces ``_adam_pallas`` (body
``_adam_kernel``). Both serve every dense apply of ``SGDOptimizer`` and
``AdamOptimizer``/``AdamWOptimizer``: the optimizer node applies all of a
device's parameters as one group, in one launch per :data:`MAX_TENSORS`
tensors (:func:`sgd_group_step`, :func:`adam_group_step`).

Bound on an H100 SXM (3.35 TB/s): SGD moves 12 bytes per element (read p,
g; write p), Adam 28 (read p, g, m, v; write p, m, v), at a few flops per
element — both are memory-bound. At the MLP's 855,050 parameters a step's
bound is 3.1 us (SGD) and 7.1 us (Adam), below one launch's cost, hence
one launch per group; at a CTR table's billions of elements the bytes
bound it, hence 16-byte accesses with several loads in flight.

The kernel and plain functions take lists of tensors (a single tensor is
a group of one, and gets single tensors back). Each call's split is
:func:`opt_plan`'s, which the C entries launch as given: per tensor, its
count of ``float4`` vectors (0 unless every pointer of the tensor is
16-byte aligned) and the offset and length of its scalar part; and the
launches, as ranges of at most :data:`MAX_TENSORS` tensors.

The kernels update ``p``, ``m`` and ``v`` in place, unlike the JAX ones,
to save a copy; the step functions below run under ``torch.no_grad()`` on
tensors autograd does not track, and make the plain path write in place
too, so callers see one behaviour on every device. ``lr`` and each ``t``
are 1-element float32 tensors on the device; ``t + 1`` is one
``torch._foreach_add`` over the group's ``t`` after the launch (the kernel
must not write ``t``: its blocks run in no order).

``_sgd_plain``/``_adam_plain`` apply the same expression sequence as
``_sgd_xla``/``_adam_xla`` in plain PyTorch to each tensor: what a CPU
tensor runs, what ``kernels="off"`` runs, and the oracle the kernels are
held against.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, registry

_SRC = "fused_opt"
# tensors one launch takes: kMaxTensors of csrc/fused_opt.cu, which refuses
# a plan made for another count
MAX_TENSORS = 48


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared: every pointer, the
    pointer arrays and the stream as c_void_p, the plan's arrays as int64
    pointers (ctypes would cut a pointer passed as an int to 32 bits)."""
    lib = _build.load(_SRC)
    P, F, N = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    I64 = ctypes.POINTER(ctypes.c_int64)
    plan = [I64, I64, I64, N, N, N, P]
    lib.hetu_fused_sgd_multi.argtypes = [P, P, P, F] + plan
    lib.hetu_fused_sgd_multi.restype = ctypes.c_int
    lib.hetu_fused_adam_multi.argtypes = [P, P, P, P, P, P] + [F] * 6 + plan
    lib.hetu_fused_adam_multi.restype = ctypes.c_int
    return lib


class OptPlan(NamedTuple):
    """The split the C entries launch: ``launches`` as ``(first, count)``
    ranges of tensors, ``count <= max_tensors``; per tensor, ``n_vec``
    float4 vectors from its start, then the scalar elements
    ``[tail_off, tail_off + tail_len)``. The three per-tensor arrays are
    the ``c_int64`` arrays the C entries read."""
    launches: tuple
    max_tensors: int
    n_vec: ctypes.Array
    tail_off: ctypes.Array
    tail_len: ctypes.Array


@functools.lru_cache(maxsize=256)
def opt_plan(sizes: tuple, aligned: tuple) -> OptPlan:
    """The plan of a group of tensors of ``sizes`` elements; ``aligned[i]``
    says whether every pointer of tensor ``i`` is 16-byte aligned. Cached
    per ``(sizes, aligned)``."""
    n = len(sizes)
    n_vec = [s // 4 if a else 0 for s, a in zip(sizes, aligned)]
    tail_off = [4 * v for v in n_vec]
    arr = ctypes.c_int64 * n
    return OptPlan(
        launches=tuple((i, min(MAX_TENSORS, n - i))
                       for i in range(0, n, MAX_TENSORS)),
        max_tensors=MAX_TENSORS, n_vec=arr(*n_vec), tail_off=arr(*tail_off),
        tail_len=arr(*[s - o for s, o in zip(sizes, tail_off)]))


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _launch(spec, entry, aligned, more, scalars):
    """Launch ``entry`` once per range of the group's plan, counting each
    launch. Its arguments: the pointer arrays of the tensor lists
    ``aligned`` (``aligned[0]`` the parameters; their pointers' alignment
    decides the plan) and ``more``, then ``scalars``, then the plan and the
    stream."""
    ptrs = [[x.data_ptr() for x in xs] for xs in aligned]
    params = aligned[0]
    plan = opt_plan(tuple(p.numel() for p in params),
                    tuple(all(a % 16 == 0 for a in col)
                          for col in zip(*ptrs)))
    arr = ctypes.c_void_p * len(params)
    args = ([arr(*x) for x in ptrs]
            + [arr(*[x.data_ptr() for x in xs]) for xs in more])
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for first, count in plan.launches:
            _check_rc(spec.name, entry(
                *args, *scalars, plan.n_vec, plan.tail_off, plan.tail_len,
                first, count, plan.max_tensors, stream))
            spec.launches += 1


def _grouped(n_lists, unwrap=True):
    """Let ``fn``, written for groups (its first ``n_lists`` arguments are
    lists of tensors), take single tensors as a group of one; with
    ``unwrap``, its list results come back as single tensors too."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not isinstance(args[0], torch.Tensor):
                return fn(*args, **kwargs)
            out = fn(*[[a] for a in args[:n_lists]], *args[n_lists:],
                     **kwargs)
            if not unwrap:
                return out
            return out[0] if isinstance(out, list) else tuple(
                o[0] for o in out)
        return wrapper
    return deco


def _group_eligible(named: dict, shared: dict, per_tensor: dict):
    """``registry.check_tensors`` for each tensor ``i`` of the group: the
    lists of ``named`` shaped like ``named["param"][i]``, the 1-element
    ``shared`` and ``per_tensor[...][i]``. Each check holds tensor ``i``'s
    parameter against the shared scalars' device, so the whole group is on
    one CUDA device. Returns (ok, reason)."""
    params = named["param"]
    if not params:
        return False, "the group is empty"
    for nm, xs in {**named, **per_tensor}.items():
        if len(xs) != len(params):
            return False, (f"{nm} has {len(xs)} tensors, param "
                           f"{len(params)}")
    for i, p in enumerate(params):
        ok, why = registry.check_tensors(
            {nm: xs[i] for nm, xs in named.items()}, p,
            {**shared, **{nm: xs[i] for nm, xs in per_tensor.items()}})
        if not ok:
            return False, f"tensor {i} of the group: {why}"
    return True, None


# ---------------------------------------------------------------------------
# Adam (bias-corrected; optional decoupled weight decay)
# ---------------------------------------------------------------------------

def _adam_one(param, grad, m, v, t, lr, beta1, beta2, eps, weight_decay):
    t = t + 1.0
    m = beta1 * m + (1.0 - beta1) * grad
    v = beta2 * v + (1.0 - beta2) * grad * grad
    m_hat = m / (1.0 - beta1 ** t)
    v_hat = v / (1.0 - beta2 ** t)
    new_param = param - lr * m_hat / (torch.sqrt(v_hat) + eps)
    if weight_decay > 0:
        new_param = new_param - lr * weight_decay * param
    return new_param, m, v, t


@_grouped(5)
def _adam_plain(params, grads, ms, vs, ts, lr, *, beta1, beta2, eps,
                weight_decay):
    """``hetu_tpu.kernels.fused_opt._adam_xla`` in PyTorch, tensor by
    tensor: returns the lists ``(new_params, ms, vs, ts + 1)`` of new
    tensors."""
    out = [_adam_one(*x, lr, beta1, beta2, eps, weight_decay)
           for x in zip(params, grads, ms, vs, ts)]
    return tuple(list(col) for col in zip(*out))


@_grouped(5)
def _adam_kernel(params, grads, ms, vs, ts, lr, *, beta1, beta2, eps,
                 weight_decay):
    """Launch ``adam_kernel`` over the group: updates params, ms, vs in
    place; returns ``(params, ms, vs, ts + 1)``."""
    _launch(_ADAM, _lib().hetu_fused_adam_multi, (params, grads, ms, vs),
            (ts,), (lr.data_ptr(), beta1, beta2, 1.0 - beta1, 1.0 - beta2,
                    eps, weight_decay))
    return params, ms, vs, list(torch._foreach_add(ts, 1.0))


@_grouped(5, unwrap=False)
def _adam_eligible(params, grads, ms, vs, ts, lr, **_kw):
    return _group_eligible({"param": params, "grad": grads, "m": ms,
                            "v": vs}, {"lr": lr}, {"t": ts})


_ADAM = registry.register_kernel(
    "fused_adam", kernel_fn=_adam_kernel, plain_fn=_adam_plain,
    eligibility=_adam_eligible)


# ---------------------------------------------------------------------------
# SGD (l2 folded into the same pass)
# ---------------------------------------------------------------------------

def _sgd_one(param, grad, lr, l2reg):
    if l2reg > 0:
        grad = grad + l2reg * param
    return param - lr * grad


@_grouped(2)
def _sgd_plain(params, grads, lr, *, l2reg):
    """``hetu_tpu.kernels.fused_opt._sgd_xla`` in PyTorch, tensor by
    tensor (a list of new tensors)."""
    return [_sgd_one(p, g, lr, l2reg) for p, g in zip(params, grads)]


@_grouped(2)
def _sgd_kernel(params, grads, lr, *, l2reg):
    """Launch ``sgd_kernel`` over the group: updates params in place and
    returns them."""
    _launch(_SGD, _lib().hetu_fused_sgd_multi, (params, grads), (),
            (lr.data_ptr(), l2reg))
    return params


@_grouped(2, unwrap=False)
def _sgd_eligible(params, grads, lr, **_kw):
    return _group_eligible({"param": params, "grad": grads}, {"lr": lr}, {})


_SGD = registry.register_kernel(
    "fused_sgd", kernel_fn=_sgd_kernel, plain_fn=_sgd_plain,
    eligibility=_sgd_eligible)


# ---------------------------------------------------------------------------
# optimizer.py entry points (signatures of hetu_tpu's adam_step/sgd_step,
# and their group forms)
# ---------------------------------------------------------------------------

def _write_back(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    if src is not dst:
        dst.copy_(src)
    return dst


def adam_group_step(opt, params, grads, slots, lr):
    """Registry-dispatched Adam apply for a group of parameters on one
    device, in place: one dispatch, one launch per :data:`MAX_TENSORS`
    parameters. ``opt`` is the AdamOptimizer; ``slots`` the parameters'
    ``{"m", "v", "t"}``; ``lr`` a 1-element f32 tensor on their device.
    Returns ``(params, new slots)``."""
    with torch.no_grad():
        new_p, ms, vs, ts = registry.dispatch(
            "fused_adam", list(params), list(grads),
            [s["m"] for s in slots], [s["v"] for s in slots],
            [s["t"] for s in slots], lr, beta1=opt.beta1, beta2=opt.beta2,
            eps=opt.epsilon, weight_decay=opt.weight_decay)
        return ([_write_back(p, x) for p, x in zip(params, new_p)],
                [{"m": _write_back(s["m"], m), "v": _write_back(s["v"], v),
                  "t": t} for s, m, v, t in zip(slots, ms, vs, ts)])


def sgd_group_step(opt, params, grads, lr):
    """Registry-dispatched SGD apply for a group of parameters on one
    device, in place: one dispatch, one launch per :data:`MAX_TENSORS`
    parameters. Returns the parameters."""
    with torch.no_grad():
        new = registry.dispatch("fused_sgd", list(params), list(grads), lr,
                                l2reg=opt.l2reg)
        return [_write_back(p, x) for p, x in zip(params, new)]


def adam_step(opt, param, grad, slot, lr):
    """:func:`adam_group_step` for one parameter: ``(param, new slot)``."""
    params, slots = adam_group_step(opt, [param], [grad], [slot], lr)
    return params[0], slots[0]


def sgd_step(opt, param, grad, lr):
    """:func:`sgd_group_step` for one parameter."""
    return sgd_group_step(opt, [param], [grad], lr)[0]
