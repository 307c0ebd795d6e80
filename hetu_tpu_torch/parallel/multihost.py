"""The multi-process world: one process per device over
``torch.distributed`` (counterpart of ``hetu_tpu/parallel/multihost.py``).

The JAX package is single-controller: one process per host joins
``jax.distributed`` and one mesh spans every chip. The port follows
PyTorch's idiom and Hetu's own MPI ranks instead: one process per
device, joined in one process group, NCCL for CUDA tensors and gloo for
CPU tensors. ``hetu_tpu_torch.runner`` starts the processes and exports
the rank environment that :func:`initialize` reads.

Gloo also carries CUDA tensors where it is asked for by name
(``backend="gloo"``, the runner's ``--backend gloo``): NCCL refuses two
ranks on one card, so two stage processes sharing a card meet over gloo.
PyTorch's gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``
only; :func:`send`, :func:`recv` and :func:`all_gather` stage a CUDA
tensor through pinned host memory when the group's backend is gloo, and
pass it as it is to NCCL.

A :class:`torch.distributed.device_mesh.DeviceMesh` with a ``"dp"``
dimension stands for the JAX package's ``jax.sharding.Mesh``
(:func:`global_mesh`); ``HetuConfig(mesh=...)`` takes one.
:func:`process_grid` lays a ``(gr, gc)`` grid over the ranks, with a
group for each row and each column, for DistGCN's 1.5D products
(``parallel/distgcn.py``).
"""
from __future__ import annotations

import os
import warnings
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# the device this process's collectives run on, set by initialize()
_device: Optional[torch.device] = None
# the meshes global_mesh made, whose groups shutdown() releases
_meshes: list = []
# the grids process_grid made, whose groups shutdown() releases
_grids: list = []
# the sub-groups group() made, by their ranks; shutdown() releases them
_groups: dict = {}
# the bytes this rank put into each kind of collective since the last
# reset_traffic(): an all-reduce's tensor, an all-gather's piece, a sent
# message (what a step's collectives move, as the smoke reports it)
_traffic = {"all_reduce": 0, "all_gather": 0, "send": 0}


def traffic() -> dict:
    """A copy of the bytes counted by kind (see ``_traffic``)."""
    return dict(_traffic)


def reset_traffic() -> None:
    for k in _traffic:
        _traffic[k] = 0


def _count(kind: str, t: torch.Tensor) -> None:
    _traffic[kind] += t.numel() * t.element_size()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device=None, backend: Optional[str] = None) -> bool:
    """Join (or create) the process group. Idempotent.

    The rendezvous is ``init_method`` (``file://<path>`` or
    ``tcp://host:port``), else ``HETU_INIT_METHOD`` (a file store the
    runner creates), else ``env://`` when ``MASTER_ADDR`` is set. World
    size and rank come from the arguments, else ``WORLD_SIZE``/``RANK``.
    With no world given at all this is a one-process no-op that returns
    False, so scripts can call it unconditionally.

    ``device``: this process's device (default ``HETU_DEVICE``, which
    the runner's ``--devices`` sets, else ``cuda:LOCAL_RANK``).
    ``backend``: ``"nccl"`` or ``"gloo"`` (default ``HETU_BACKEND``, which
    the runner's ``--backend`` sets, else NCCL for a CUDA device and gloo
    for the CPU). NCCL's communicator is created here and checked with
    one all-reduce, so a failed NCCL init raises now rather than at the
    first gradient. Gloo is taken for a CUDA device only where it is
    asked for: never because CUDA or NCCL is missing.
    """
    global _device
    if is_initialized():
        return True
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None:
        init_method = os.environ.get("HETU_INIT_METHOD") or (
            "env://" if os.environ.get("MASTER_ADDR") else None)
    if world_size is None and init_method is None:
        return False
    if world_size is None or rank is None or init_method is None:
        raise ValueError(
            f"initialize: a world needs its size, this rank and a "
            f"rendezvous; got world_size={world_size}, rank={rank}, "
            f"init_method={init_method!r} (set WORLD_SIZE, RANK and "
            "HETU_INIT_METHOD or MASTER_ADDR/MASTER_PORT, or run under "
            "python -m hetu_tpu_torch.runner)")
    if device is None:
        device = os.environ.get("HETU_DEVICE") or torch.device(
            "cuda", _env_int("LOCAL_RANK") or 0)
    device = torch.device(device)
    backend = backend or os.environ.get("HETU_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"initialize: backend must be 'nccl' or 'gloo', "
                         f"got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"initialize: NCCL needs a CUDA device, got "
                         f"{device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"initialize: {backend} on {device} needs CUDA, and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "join over gloo")
        torch.cuda.set_device(device)
    if backend == "nccl":
        dist.init_process_group("nccl", init_method=init_method,
                                world_size=world_size, rank=rank,
                                device_id=device)
        probe = torch.ones(1, device=device)
        dist.all_reduce(probe)
        if int(probe.item()) != world_size:
            raise RuntimeError(f"initialize: NCCL all-reduce over "
                               f"{world_size} ranks gave {probe.item()}")
    else:
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world_size, rank=rank)
    _device = device
    return True


def collective(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` for a ``torch.distributed`` collective whose
    name later PyTorch releases deprecate: ``reduce_scatter_tensor`` and
    ``all_gather_into_tensor`` are the names every supported release has
    (the card's 2.11 lacks their successors), so the warning is dropped."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".* is deprecated")
        return fn(*args, **kwargs)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through host memory: a CUDA tensor
    on a gloo group (chosen by the group's backend, never by catching a
    failure)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA tensor ``t``."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


class Sent:
    """An outstanding :func:`send`: ``wait()`` completes it (once; a
    second call returns at once, where gloo's work would wait for a
    second completion that never comes). It keeps the sent buffer (or its
    staged host copy) alive until then."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        if self.work is not None:
            self.work.wait()
        self.work = self.buf = None


def send(t: torch.Tensor, dst: int, group=None) -> Sent:
    """Send ``t`` to global rank ``dst`` without blocking; the caller must
    ``wait()`` the handle (and must not write ``t`` before then on
    NCCL). Messages between two ranks arrive in the order sent."""
    buf = _host(t) if _staged(t, group) else t.contiguous()
    _count("send", buf)
    return Sent(dist.isend(buf, dst=dst, group=group), buf)


def recv(shape, dtype, src: int, group=None) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from global rank
    ``src``, onto this process's device; blocks until it arrives."""
    buf = torch.empty(tuple(shape), dtype=dtype, device=device())
    if _staged(buf, group):
        host = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        dist.recv(host, src=src, group=group)
        return buf.copy_(host)
    dist.recv(buf, src=src, group=group)
    return buf


def all_gather(t: torch.Tensor, group=None) -> list:
    """Every rank's ``t`` (one shape on all) in group-rank order, on
    ``t``'s device."""
    n = dist.get_world_size(group)
    _count("all_gather", t)
    if _staged(t, group):
        h = _host(t.detach())
        out = [torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
               for _ in range(n)]
        dist.all_gather(out, h, group=group)
        return [o.to(t.device) for o in out]
    t = t.detach().contiguous()
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t, group=group)
    return out


def all_reduce_(tensors, group=None, mean: bool = False) -> None:
    """Sum ``tensors`` (float32, one device) over ``group`` in place, as
    one flat bucket (one collective); ``mean`` divides by the group's
    size. Gloo takes CUDA tensors for this collective as they are."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _count("all_reduce", flat)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if mean:
        flat.div_(dist.get_world_size(group))
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


# -- group collectives for autograd ------------------------------------------
#
# The tensor, sequence and expert axes split a layer's tensors over a group
# of ranks. Each collective below is a ``torch.autograd.Function`` whose
# backward is the adjoint of its forward under the port's rule: a rank's
# loss counts once over tp and ep (every rank of those groups computes the
# same value), and its gradients are averaged over the data ranks (dp x sp).
# A group of one rank (None) makes each the identity: no collective runs on
# an axis of size 1. Sums run in f32 (gloo takes CUDA tensors for
# all_reduce as they are); gathers and ring messages stage a CUDA tensor
# through pinned host memory on gloo, as send/recv/all_gather do.

def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over ``group``, in f32, cast back to
    ``t``'s dtype."""
    out = t.detach().to(torch.float32, copy=True).contiguous()
    _count("all_reduce", out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.dtype)


def _gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return torch.cat(all_gather(t.contiguous(), group), dim)


def _chunk(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    k = t.shape[dim] // n
    return t.narrow(dim, i * k, k).contiguous()


class _CopyTo(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, an all-reduce backward (a
    replicated input whose consumers on each rank are partial)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's ``g``: an all-reduce forward (partial sums made whole),
    the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """An all-reduce forward and backward: a sum over the data ranks, each
    of whose losses reads the whole sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """An all-gather along ``dim`` (group-rank order). Backward
    ``"reduce_scatter"``: each rank's piece of the gradient summed over the
    group (the consumers on each rank are partial); ``"slice"``: the rank's
    own piece (the consumers are the same on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, group, grad):
        ctx.dim, ctx.group, ctx.grad = dim, group, grad
        return _gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "reduce_scatter":
            g = _sum(g, ctx.group)
        return _chunk(g, ctx.dim, ctx.group), None, None, None


def ring_peers(group) -> tuple:
    """``(next, prev)``: the global ranks after and before this one in
    ``group``'s ring (its ranks in ascending order)."""
    ranks = dist.get_process_group_ranks(group)
    i = ranks.index(dist.get_rank())
    return ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)]


class RingTransfer:
    """``tensors`` on their way to the next rank of ``group``'s ring, and
    the previous rank's on their way here: the sends are posted when it is
    made, the receives completed by ``wait()``, so work between the two
    overlaps the transfer. The sends never block, so every rank sending
    first cannot deadlock (blocking gloo sends between neighbours would).
    No autograd."""

    def __init__(self, tensors, group):
        nxt, self.prev = ring_peers(group)
        self.group = group
        self.like = [(t.shape, t.dtype, t.device) for t in tensors]
        self.sent = [send(t, nxt, group) for t in tensors]

    def wait(self) -> list:
        got = [recv(shape, dtype, self.prev, self.group).to(dev)
               for shape, dtype, dev in self.like]
        for s in self.sent:
            s.wait()
        return got


def ring_exchange(tensors, group) -> list:
    """The previous rank's ``tensors`` in ``group``'s ring, ours sent to
    the next (``RingTransfer``)."""
    return RingTransfer(tensors, group).wait()


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f`` over ``group`` (identity where it is None)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g`` over ``group``: ``x`` summed (identity where the
    group is None)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def sum_both(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, its gradient summed too."""
    return x if group is None else _SumBoth.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group,
               grad: str = "reduce_scatter") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order;
    the backward per ``grad`` (``"reduce_scatter"`` or ``"slice"``, see
    ``_Gather``)."""
    if group is None:
        return x
    if grad not in ("reduce_scatter", "slice"):
        raise ValueError(f"grad must be 'reduce_scatter' or 'slice', got "
                         f"{grad!r}")
    return _Gather.apply(x, dim % x.dim(), group, grad)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, without autograd."""
    if group is None:
        return x
    out = x.detach().to(torch.float32, copy=True).contiguous()
    _count("all_reduce", out)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def shutdown() -> None:
    """Leave the process group: a barrier, then destroy it in this
    process, and release the groups that the meshes of
    :func:`global_mesh` (``DeviceMesh._pg_registry``) and the grids of
    :func:`process_grid` hold. A gloo group that outlives the process
    group, to be torn down at interpreter exit after its peer has left,
    aborts the process ("terminate called without an active exception"),
    about one exit in ten under load."""
    global _device
    if is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    for ref in _meshes:
        mesh = ref()
        if mesh is not None:
            getattr(mesh, "_pg_registry", {}).clear()
            mesh._hetu_data_group = None
    _meshes.clear()
    for grid in _grids:
        grid.release()
    _grids.clear()
    _groups.clear()
    _device = None


def device() -> torch.device:
    """The device this process's collectives run on (the CPU when no
    world was joined)."""
    return _device if _device is not None else torch.device("cpu")


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def barrier() -> None:
    """Block until every process arrives."""
    if is_initialized():
        dist.barrier()


def process_allgather(x) -> np.ndarray:
    """Every process's host value ``x`` (one shape on all), stacked along a
    new axis 0 in rank order."""
    a = np.asarray(x)
    if not is_initialized():
        return a[None]
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def broadcast_from_chief(x):
    """Process 0's host value ``x`` (any picklable value), on every
    process."""
    if not is_initialized():
        return x
    box = [x]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def global_mesh(dp: int = 0, pp: int = 1, tp: int = 1, sp: int = 1,
                ep: int = 1):
    """A mesh over every process, on this process's device type. With the
    model axes at 1, a one-dimensional ``DeviceMesh`` named ``"dp"``
    (``dp`` is the world size, or 0 for "whatever it is"); else the
    five-axis mesh of ``parallel.mesh``, ``dp=0`` filling dp with whatever
    ranks remain after ``pp * tp * sp * ep``, as the reference's."""
    from torch.distributed.device_mesh import init_device_mesh
    if not is_initialized():
        raise RuntimeError("global_mesh: call multihost.initialize() first")
    if (pp, tp, sp, ep) != (1, 1, 1, 1):
        from . import mesh as meshlib
        if dp == 0:
            return meshlib.auto_mesh(tp=tp, pp=pp, sp=sp, ep=ep)
        return meshlib.make_mesh(dp=dp, pp=pp, tp=tp, sp=sp, ep=ep)
    if dp not in (0, process_count()):
        raise ValueError(f"global_mesh(dp={dp}): the dp axis spans the "
                         f"whole world of {process_count()} processes")
    mesh = init_device_mesh(device().type, (process_count(),),
                            mesh_dim_names=("dp",))
    _meshes.append(weakref.ref(mesh))
    return mesh


def group(ranks):
    """The process group of global ``ranks`` (ascending), made once per
    process by ``dist.new_group``, a collective of the whole world: every
    rank asks for each group, in one order, also ranks outside it. Not
    kept by callers past :func:`shutdown`, which releases it; the world
    itself where ``ranks`` are all of it."""
    ranks = tuple(sorted(int(r) for r in ranks))
    if not is_initialized():
        raise RuntimeError("group: call multihost.initialize() first")
    if ranks == tuple(range(process_count())):
        return dist.group.WORLD
    if ranks not in _groups:
        _groups[ranks] = dist.new_group(list(ranks))
    return _groups[ranks]


class ProcessGrid:
    """This rank's point ``(i, j)`` of a ``(gr, gc)`` grid laid over ranks
    ``0 .. gr * gc - 1``, rank ``i * gc + j`` at ``(i, j)``: the order of
    ``np.array(jax.devices()).reshape(gr, gc)`` in the JAX package, so a
    rank's tensors compare with one device's shard there.

    ``row_group`` holds the ``gc`` ranks at this ``i`` and ``col_group``
    the ``gr`` ranks at this ``j``; a group's ranks are in ascending order,
    so a rank's place in its column group is ``i`` and in its row group
    ``j``."""

    def __init__(self, gr, gc, i, j, row_group, col_group):
        self.gr, self.gc, self.i, self.j = gr, gc, i, j
        self.row_group, self.col_group = row_group, col_group

    def release(self) -> None:
        self.row_group = self.col_group = None

    def __repr__(self):
        return (f"ProcessGrid(gr={self.gr}, gc={self.gc}, i={self.i}, "
                f"j={self.j})")


def process_grid(gr: int, gc: int) -> Optional[ProcessGrid]:
    """A ``(gr, gc)`` grid over the first ``gr * gc`` ranks of the world.

    ``dist.new_group`` is a collective of the whole world: every rank,
    inside the grid or not, makes every group here, in one fixed order
    (the rows' by ``i``, then the columns' by ``j``). Returns this
    rank's :class:`ProcessGrid`, or None on a rank outside the grid.
    :func:`shutdown` releases the groups."""
    if not is_initialized():
        raise RuntimeError("process_grid: call multihost.initialize() first")
    n = gr * gc
    if gr < 1 or gc < 1 or n > process_count():
        raise ValueError(f"process_grid({gr}, {gc}): a grid of {n} ranks "
                         f"in a world of {process_count()}")
    rows = [dist.new_group([i * gc + j for j in range(gc)])
            for i in range(gr)]
    cols = [dist.new_group([i * gc + j for i in range(gr)])
            for j in range(gc)]
    if process_index() >= n:
        return None
    i, j = divmod(process_index(), gc)
    grid = ProcessGrid(gr, gc, i, j, rows[i], cols[j])
    _grids.append(grid)
    return grid
