"""Kernel dispatch registry: the one gate between graph code and the
hand-written CUDA kernels (counterpart of ``hetu_tpu/kernels/registry.py``).

Every kernel registers a :class:`KernelSpec` — ``{name, kernel_fn,
plain_fn, eligibility}`` — and every call site goes through
:func:`dispatch`. The mode (``HetuConfig(kernels="off"|"auto"|"force")`` /
``HETU_KERNELS``) and the device of the call's tensors decide what runs:

- ``off``   — the plain PyTorch version, on any device: the user's
  explicit choice, as in the JAX package.
- ``auto``  — a CUDA tensor launches the kernel; a CPU tensor runs the
  plain version (there is no kernel for the CPU).
- ``force`` — the kernel; a CPU tensor raises.

On CUDA, ``auto`` and ``force`` are the same: an ineligible call
(dtype, layout, device mismatch) raises :class:`KernelEligibilityError`
and never falls back to the plain version.

Dispatch decisions are made per call (the port runs eagerly), and
:func:`dispatch_stats` tallies them. Each wrapper also keeps a launch count
(``KernelSpec.launches``) that it raises by one where it launches its kernel
and nowhere else; :func:`launch_counts` reads them.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Optional

import torch

MODES = ("off", "auto", "force")


class KernelEligibilityError(ValueError):
    """A CUDA call the kernel cannot take, or kernels="force" on the CPU."""

    def __init__(self, kernel: str, reason: str):
        super().__init__(
            f"{kernel} cannot serve this call — {reason}. A CUDA tensor "
            "always takes the kernel; pass tensors it accepts, or choose "
            "kernels='off' for the plain PyTorch version")
        self.kernel = kernel
        self.reason = reason


class KernelSpec:
    """One registered kernel: the wrapper that launches the CUDA kernel, the
    plain PyTorch expression it must match, and the per-call eligibility
    predicate ``eligibility(*args, **kwargs) -> (ok, reason)``."""

    def __init__(self, name: str, kernel_fn: Callable, plain_fn: Callable,
                 eligibility: Callable):
        self.name = name
        self.kernel_fn = kernel_fn
        self.plain_fn = plain_fn
        self.eligibility = eligibility
        self.launches = 0


_REGISTRY: dict[str, KernelSpec] = {}

# process-local dispatch tallies: {(kernel, path): count}
_stats: dict[tuple, int] = {}
_stats_lock = threading.Lock()

# scoped-mode stack (the executor pushes config.kernels around each step)
_tls = threading.local()


def register_kernel(name: str, *, kernel_fn: Callable, plain_fn: Callable,
                    eligibility: Callable) -> KernelSpec:
    spec = KernelSpec(name, kernel_fn, plain_fn, eligibility)
    _REGISTRY[name] = spec
    return spec


def resolve_mode(mode: Optional[str] = None) -> str:
    """Explicit wins, then ``HETU_KERNELS``, then ``auto``."""
    if mode is None:
        mode = os.environ.get("HETU_KERNELS") or "auto"
    if mode not in MODES:
        raise ValueError(f"kernels must be one of {MODES}, got {mode!r}")
    return mode


class active:
    """``with active("force"): ...`` — scope the dispatch mode. Re-entrant;
    the innermost scope wins."""

    def __init__(self, mode: Optional[str]):
        self.mode = resolve_mode(mode)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.mode)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()
        return False


def current_mode() -> str:
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1]
    return resolve_mode(None)


def bind(fn: Callable) -> Callable:
    """``fn`` bound to the mode current now: each later call runs under that
    mode, on whichever thread it runs. Autograd backwards and the
    recompute of a checkpointed block take it, because PyTorch runs a CUDA
    backward on its own thread, which the caller's (thread-local)
    :class:`active` scope does not reach."""
    mode = current_mode()

    def bound(*args, **kwargs):
        with active(mode):
            return fn(*args, **kwargs)
    return bound


def _count(kernel: str, path: str) -> None:
    with _stats_lock:
        key = (kernel, path)
        _stats[key] = _stats.get(key, 0) + 1


def dispatch_stats() -> dict:
    """``{(kernel, path): count}`` snapshot of every dispatch decision this
    process made. Paths: ``cuda`` (kernel under auto), ``forced`` (kernel
    under force), ``plain`` (auto on a CPU tensor), ``off`` (mode off)."""
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        _stats.clear()


def launch_counts() -> dict[str, int]:
    """``{kernel: launches}`` — what each wrapper counted at its launches."""
    return {name: spec.launches for name, spec in _REGISTRY.items()}


def reset_launch_counts() -> None:
    for spec in _REGISTRY.values():
        spec.launches = 0


def dispatch(name: str, *args, **kwargs):
    """Serve one kernel call through the mode/device/eligibility gate. The
    device is that of the first argument (a tensor, or a CSR matrix), or of
    its first tensor where it is a list (a group of tensors)."""
    spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"no kernel {name!r} registered "
                       f"(have: {sorted(_REGISTRY)})")
    mode = current_mode()
    if mode == "off":
        _count(name, "off")
        return spec.plain_fn(*args, **kwargs)
    first = args[0]
    group = isinstance(first, (list, tuple))
    if group:
        if not first:
            raise KernelEligibilityError(name, "the group is empty")
        first = first[0]
    device = first.device
    if device.type == "cpu":
        if mode == "force":
            raise KernelEligibilityError(
                name, "kernels='force' on a CPU tensor (the kernel runs "
                "only on CUDA)")
        if group:
            _check_group_on_cpu(name, args)
        _count(name, "plain")
        return spec.plain_fn(*args, **kwargs)
    ok, reason = spec.eligibility(*args, **kwargs)
    if not ok:
        raise KernelEligibilityError(name, reason or "ineligible")
    _count(name, "forced" if mode == "force" else "cuda")
    return spec.kernel_fn(*args, **kwargs)


def _check_group_on_cpu(name: str, args) -> None:
    """A group whose first tensor is on the CPU takes the plain version only
    if every tensor of its lists is on the CPU: a CUDA tensor later in the
    list launches the kernel or raises, never the plain version."""
    for xs in args:
        if isinstance(xs, (list, tuple)):
            for i, x in enumerate(xs):
                if isinstance(x, torch.Tensor) and x.device.type != "cpu":
                    raise KernelEligibilityError(
                        name, f"tensor {i} of the group is on {x.device}, "
                        "its first tensor on the CPU")


def check_tensors(named: dict, like: torch.Tensor, scalars: dict):
    """Shared eligibility body of the elementwise kernels: every tensor in
    ``named`` is a contiguous f32 CUDA tensor shaped like ``like`` on its
    device, non-empty; every tensor in ``scalars`` is a 1-element f32 tensor
    on that device. Returns (ok, reason)."""
    for nm, x in list(named.items()) + list(scalars.items()):
        if not isinstance(x, torch.Tensor):
            return False, f"{nm} must be a tensor, got {type(x).__name__}"
        if x.device.type != "cuda" or x.device != like.device:
            return False, (f"{nm} is on {x.device}, the call is on "
                           f"{like.device}")
        if x.dtype != torch.float32:
            return False, f"{nm} must be float32, got {x.dtype}"
    for nm, x in named.items():
        if not x.is_contiguous():
            return False, f"{nm} is not contiguous"
        if x.shape != like.shape:
            return False, (f"{nm} has shape {tuple(x.shape)}, expected "
                           f"{tuple(like.shape)}")
    for nm, x in scalars.items():
        if x.numel() != 1:
            return False, f"{nm} must hold one element, has {x.numel()}"
    if like.numel() == 0:
        return False, "the tensor is empty"
    return True, None
