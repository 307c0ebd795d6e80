"""Checkpoint / resume for the port's train states (counterpart of
``hetu_tpu/checkpoint.py``), for one process.

A state is a nested dict of tensors (and numpy arrays), as the train steps
keep them: ``{"params": ..., "opt": {"m": ..., "v": ..., "t": ...}}``.
``save`` writes it as one file of CPU tensors, with their dtypes and
shapes as they are, into a temporary directory beside ``path`` and then
renames that directory into place, so a crash mid-save never leaves a
half-written checkpoint and never destroys the previous one. ``restore``
reads it back onto the devices and dtypes of ``like``, or as numpy arrays.
``TrainCheckpointer`` numbers the checkpoints by step and keeps the newest
``keep``.

The reference's sharded restore (``mesh=``, ``specs=``) is not ported: it
comes with slice 8c, where this module moves to
``torch.distributed.checkpoint``. A state that holds one rank's part of a
whole (ZeRO-1's slot shards, a pipeline stage's blocks: tensors marked by
``parallel.mesh.mark_shard``) is refused before anything is written, for
the same reason.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from .parallel.mesh import shard_of

_FILE = "state.pt"


def _no_mesh(mesh, specs):
    if mesh is not None or specs is not None:
        raise NotImplementedError(
            "a sharded restore (mesh=, specs=) is not ported to "
            "hetu_tpu_torch yet: it comes with slice 8c "
            "(torch.distributed.checkpoint; ROADMAP Queue 1)")


def _refuse_shards(tree, where=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _refuse_shards(v, f"{where}/{k}")
    elif shard_of(tree) is not None:
        raise NotImplementedError(
            f"checkpoint entry {where} is one rank's {shard_of(tree)} "
            "shard: a ZeRO-1 or pipeline state is saved by the sharded "
            "checkpoint of slice 8c (torch.distributed.checkpoint); this "
            "one-process checkpoint writes whole states only")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        return torch.from_numpy(np.array(tree))
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"a checkpoint holds tensors and numpy arrays, got "
                        f"{type(tree).__name__}")
    return tree.detach().to("cpu", copy=True)


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(path: str, state: Any, force: bool = False) -> None:
    """Write ``state`` to the directory ``path`` and return once it is on
    disk. An existing checkpoint at ``path`` is refused unless
    ``force=True``, which replaces it; either way the new one is complete
    before it takes the name."""
    _refuse_shards(state)
    path = os.path.abspath(os.fspath(path))
    if os.path.exists(path) and not force:
        raise FileExistsError(f"a checkpoint exists at {path}; pass "
                              "force=True to replace it")
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp-" + os.path.basename(path) + "-",
                           dir=parent)
    try:
        with open(os.path.join(tmp, _FILE), "wb") as f:
            torch.save(_to_cpu(state), f)
            f.flush()
            os.fsync(f.fileno())
        old = None
        if os.path.exists(path):
            # the old checkpoint leaves its name only once the new one is
            # complete, and is removed only after the new one took it
            old = tempfile.mkdtemp(prefix=".old-" + os.path.basename(path)
                                   + "-", dir=parent)
            os.rename(path, os.path.join(old, "ckpt"))
        os.rename(tmp, path)
        _fsync_dir(parent)
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _like(tree, like, where=""):
    """``tree``'s tensors on ``like``'s devices, checked against its
    structure, shapes and dtypes."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint structure at {where or '/'} "
                             f"differs from like's")
        return {k: _like(tree[k], like[k], f"{where}/{k}") for k in like}
    if tuple(tree.shape) != tuple(like.shape) or tree.dtype != like.dtype:
        raise ValueError(f"checkpoint entry {where}: {tree.dtype} "
                         f"{tuple(tree.shape)}, like has {like.dtype} "
                         f"{tuple(like.shape)}")
    return tree.to(like.device)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    # numpy has no bfloat16: such a tensor comes back widened to float32,
    # which holds each of its values exactly
    if tree.dtype == torch.bfloat16:
        tree = tree.float()
    return tree.numpy()


def restore(path: str, like: Any = None, mesh=None, specs: Any = None):
    """Read the checkpoint at ``path``. With ``like`` (a state of tensors
    of the same structure), the tensors come back on ``like``'s devices,
    and their shapes and dtypes must equal ``like``'s; with no ``like``,
    as numpy arrays (bfloat16 widened to float32)."""
    _no_mesh(mesh, specs)
    path = os.path.abspath(os.fspath(path))
    tree = torch.load(os.path.join(path, _FILE), map_location="cpu",
                      weights_only=True)
    return _numpy(tree) if like is None else _like(tree, like)


class TrainCheckpointer:
    """Step-numbered checkpoints with retention (resume from the latest):
    ``TrainCheckpointer(dir, keep=3)``: ``save_step(step, state)``,
    ``latest_step()``, ``restore_latest(like)``. Step ``s`` lives in
    ``dir/s``."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(os.fspath(directory))
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isfile(os.path.join(self.directory, n,
                                                      _FILE)))

    def save_step(self, step: int, state: Any, force: bool = False) -> None:
        """Write the checkpoint of ``step`` and return once it is on disk.
        An existing one of the same step is refused unless ``force=True``,
        which replaces it (an emergency save may land on a step the
        cadence already wrote). Then only the newest ``keep`` steps are
        kept."""
        save(os.path.join(self.directory, str(int(step))), state,
             force=force)
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, like: Any = None, mesh=None, specs: Any = None):
        """``(state, step)`` of the newest checkpoint, ``(None, None)``
        when there is none; ``like`` as in ``restore``."""
        _no_mesh(mesh, specs)
        step = self.latest_step()
        if step is None:
            return None, None
        return restore(os.path.join(self.directory, str(step)), like), step

    def close(self):
        """Nothing stays open between calls; kept for the reference's
        interface."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
