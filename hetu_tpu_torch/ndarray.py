"""Device contexts and array handles (counterpart of ``hetu_tpu/ndarray.py``).

A ``DLContext`` names a device (``cpu(0)``, ``gpu(i)``); ``torch_device()``
resolves it to a ``torch.device``. ``gpu(i)`` is ``cuda:i``; ``tpu(i)`` is
kept as an alias of ``gpu(i)`` so model code written against ``hetu_tpu``
runs unchanged. An ``NDArray`` is a thin handle over a ``torch.Tensor``.
Sparse arrays and ``IndexedSlices`` arrive with the CTR slice.
"""
from __future__ import annotations

import numpy as np
import torch


class DLContext:
    """A device placement tag: ``cpu(0)`` or ``gpu(3)``."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type == "tpu":  # compat alias: hetu_tpu model code says tpu
            device_type = "gpu"
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"device_type must be cpu or gpu, got "
                             f"{device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, DLContext)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def cpu(dev_id: int = 0) -> DLContext:
    return DLContext("cpu", dev_id)


def gpu(dev_id: int = 0) -> DLContext:
    return DLContext("gpu", dev_id)


tpu = gpu


def is_gpu_ctx(ctx) -> bool:
    """True when ctx is an accelerator (reference ndarray.py:106)."""
    return isinstance(ctx, DLContext) and ctx.device_type == "gpu"


is_tpu_ctx = is_gpu_ctx


def resolve_device(device=None) -> torch.device:
    """The device of a functional entry point (the models, ``interop``):
    ``None`` is ``cuda:0``; a ``DLContext``, a string or a
    ``torch.device`` names another. A CUDA device without CUDA raises
    rather than run on the CPU."""
    if device is None:
        dev = torch.device("cuda", 0)
    elif isinstance(device, DLContext):
        dev = device.torch_device()
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the call runs on {dev} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


class NDArray:
    """Thin handle over a ``torch.Tensor`` with the reference's surface."""

    __slots__ = ("handle", "ctx")

    def __init__(self, handle: torch.Tensor, ctx: DLContext | None = None):
        self.handle = handle
        self.ctx = ctx

    @property
    def shape(self):
        return tuple(self.handle.shape)

    @property
    def dtype(self):
        return np.dtype(str(self.handle.dtype).replace("torch.", ""))

    def asnumpy(self) -> np.ndarray:
        return self.handle.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.asnumpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return f"NDArray(shape={self.shape}, dtype={self.dtype}, ctx={self.ctx})"


def array(arr, ctx: DLContext | None = None, dtype=None) -> NDArray:
    """Create an NDArray on ``ctx`` (reference ndarray.py:419 ``array``);
    floating inputs become float32, as in ``hetu_tpu``."""
    if isinstance(arr, NDArray):
        arr = arr.asnumpy()
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    if dtype is None and np.issubdtype(np.asarray(arr).dtype, np.floating):
        dtype = np.float32
    np_arr = np.ascontiguousarray(np.asarray(arr, dtype=dtype))
    dev = ctx.torch_device() if ctx is not None else torch.device("cpu")
    return NDArray(torch.from_numpy(np_arr).to(dev), ctx)


def empty(shape, ctx: DLContext | None = None, dtype=np.float32) -> NDArray:
    """Allocate an array (zero-filled, as ``hetu_tpu.empty`` is)."""
    return array(np.zeros(tuple(shape), dtype), ctx=ctx, dtype=dtype)
