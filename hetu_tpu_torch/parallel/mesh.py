"""The five-axis device mesh over the process group (counterpart of
``hetu_tpu/parallel/mesh.py``).

The JAX package lays one ``jax.sharding.Mesh`` with the axes ``(dp, pp,
ep, sp, tp)`` over its devices and lets GSPMD place the collectives. The
port runs one process per device, so a mesh here is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks in the
same axis order (rank ``((d * pp + p) * ep + e) * sp + s) * tp + t`` at
``(d, p, e, s, t)``, the order of ``np.asarray(devices).reshape(dp, pp,
ep, sp, tp)``), with one process group per axis. A rank's tensors then
compare with one device's shard of the JAX array.

The ``tp``, ``sp`` and ``ep`` axes split tensors inside a layer: each
rank holds its tp slice of the Megatron-split weights and its ep share of
the experts (``transformer.shard_params``), and its sp chunk of the
sequence. The data ranks of a rank are those that differ from it only in
dp and sp: they see different tokens, and a step averages its gradients
over them (``data_group``; made once per mesh where both axes exceed 1).
"""
from __future__ import annotations

import weakref
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from . import multihost

AXES = ("dp", "pp", "ep", "sp", "tp")


def make_mesh(dp: int = 1, pp: int = 1, tp: int = 1, sp: int = 1,
              ep: int = 1, devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` named ``AXES`` over ``devices`` (global ranks, in
    mesh order; default every rank of the world), on this process's
    device type. Every rank of the world calls it: each axis's groups are
    made by a collective of the whole world. Size-1 axes hold one rank
    each and carry no traffic."""
    if not multihost.is_initialized():
        raise RuntimeError("make_mesh: call multihost.initialize() first")
    ranks = (list(range(multihost.process_count())) if devices is None
             else [int(r) for r in devices])
    want = dp * pp * ep * sp * tp
    if want != len(ranks):
        raise ValueError(f"mesh {dp}x{pp}x{ep}x{sp}x{tp}={want} != "
                         f"{len(ranks)} ranks")
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.tensor(ranks).reshape(dp, pp, ep, sp, tp)
    mesh = DeviceMesh(multihost.device().type, grid, mesh_dim_names=AXES)
    # the data ranks' groups (dp x sp), one per (pp, ep, tp) point, made by
    # every rank in one order (each new_group is a collective of the world)
    mesh._hetu_data_group = None
    if dp > 1 and sp > 1:
        me = multihost.process_index()
        for p in range(pp):
            for e in range(ep):
                for t in range(tp):
                    line = sorted(grid[:, p, e, :, t].flatten().tolist())
                    g = dist.new_group(line)
                    if me in line:
                        mesh._hetu_data_group = g
    multihost._meshes.append(weakref.ref(mesh))
    return mesh


def auto_mesh(n_devices: Optional[int] = None, tp: int = 1, pp: int = 1,
              sp: int = 1, ep: int = 1):
    """Fill dp with whatever ranks remain after the model axes."""
    n = n_devices or multihost.process_count()
    model = tp * pp * sp * ep
    if n % model:
        raise ValueError(f"{n} ranks not divisible by tp*pp*sp*ep={model}")
    return make_mesh(dp=n // model, pp=pp, tp=tp, sp=sp, ep=ep,
                     devices=range(n))


class Named(NamedTuple):
    """A placement: which mesh axis, if any, splits each dimension (the
    port's stand-in for ``NamedSharding(mesh, P(*spec))``)."""
    mesh: object
    spec: tuple


def named(mesh, *spec) -> Named:
    return Named(mesh, tuple(spec))


# -- reading a mesh -----------------------------------------------------------

def check_mesh(mesh) -> None:
    """Refuse an object that is no ``DeviceMesh`` (the JAX package's
    ``Mesh``, say). ``None`` (one device) passes."""
    if mesh is None:
        return
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise NotImplementedError(
            f"mesh={mesh!r} is no DeviceMesh: hetu_tpu_torch takes a "
            "torch.distributed DeviceMesh from parallel.mesh.make_mesh or "
            "multihost.global_mesh")



def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (1 without a mesh or where the
    mesh has no such axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 where the axis is absent)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``, or None where
    it holds this rank alone. Looked up on each use, never stored (see
    ``multihost.shutdown``)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def axis_ranks(mesh, axis: str) -> list[int]:
    """The global ranks of this rank's line along ``axis``, in axis
    order."""
    if axis_size(mesh, axis) == 1:
        return [multihost.process_index()]
    return dist.get_process_group_ranks(mesh.get_group(axis))


def data_group(mesh):
    """The group of this rank's data ranks (dp x sp), or None where it
    holds this rank alone. Its ranks in ascending order are in the order
    of the global batch's tokens: rows over dp, each row's chunks over
    sp."""
    dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
    if dp == 1:
        return axis_group(mesh, "sp")
    if sp == 1:
        return axis_group(mesh, "dp")
    return mesh._hetu_data_group


# -- shards that a one-process checkpoint must not write ----------------------

def mark_shard(t: torch.Tensor, what: str) -> torch.Tensor:
    """Mark ``t`` as one rank's part of a state (a ZeRO-1 slot shard, a
    pipeline stage's blocks): ``checkpoint.save`` refuses a state that
    holds one. In-place updates keep the mark."""
    t._hetu_shard = what
    return t


def shard_of(t) -> Optional[str]:
    return getattr(t, "_hetu_shard", None)
