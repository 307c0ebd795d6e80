"""The multi-process world: one process per device over
``torch.distributed`` (counterpart of ``hetu_tpu/parallel/multihost.py``).

The JAX package is single-controller: one process per host joins
``jax.distributed`` and one mesh spans every chip. The port follows
PyTorch's idiom and Hetu's own MPI ranks instead: one process per
device, joined in one process group, NCCL for CUDA tensors and gloo for
CPU tensors. ``hetu_tpu_torch.runner`` starts the processes and exports
the rank environment that :func:`initialize` reads.

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


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device=None) -> bool:
    """Join (or create) the process group. Idempotent.

    The rendezvous is ``init_method`` (``file://<path>`` or
    ``tcp://host:port``), else ``HETU_INIT_METHOD`` (a file store the
    runner creates), else ``env://`` when ``MASTER_ADDR`` is set. World
    size and rank come from the arguments, else ``WORLD_SIZE``/``RANK``.
    With no world given at all this is a one-process no-op that returns
    False, so scripts can call it unconditionally.

    ``device``: this process's device. A CUDA device (the default:
    ``cuda:LOCAL_RANK``) joins over NCCL, whose communicator is created
    here and checked with one all-reduce, so a failed NCCL init raises
    now rather than at the first gradient; the CPU joins over gloo.
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
        device = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"initialize: NCCL on {device} needs CUDA, and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "join over gloo")
        torch.cuda.set_device(device)
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
    _meshes.clear()
    for grid in _grids:
        grid.release()
    _grids.clear()
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


def global_mesh(dp: int = 0):
    """A one-dimensional ``DeviceMesh`` named ``"dp"`` over every process,
    on this process's device type. ``dp`` is the world size, or 0 for
    "whatever it is"; the model axes (tp, pp) arrive with slice 8."""
    from torch.distributed.device_mesh import init_device_mesh
    if not is_initialized():
        raise RuntimeError("global_mesh: call multihost.initialize() first")
    if dp not in (0, process_count()):
        raise ValueError(f"global_mesh(dp={dp}): the dp axis spans the "
                         f"whole world of {process_count()} processes")
    mesh = init_device_mesh(device().type, (process_count(),),
                            mesh_dim_names=("dp",))
    _meshes.append(weakref.ref(mesh))
    return mesh


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
