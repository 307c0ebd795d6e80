"""Carrying state across from ``hetu_tpu``: set the port's parameters and
optimizer slots from numpy arrays keyed by the reference's parameter names
(``Executor._param_file_names``, the names of ``Executor.save``'s files).
``Executor.load`` reads a whole directory that ``hetu_tpu``'s
``Executor.save`` wrote. ``tree_from_numpy`` carries a functional model's
params tree (``hetu_tpu.models``' nested dicts) across as tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .ndarray import resolve_device


def params_from_numpy(executor, arrays: dict, slots: dict | None = None):
    """``arrays``: ``{param name: ndarray}``; ``slots``: optional
    ``{param name: {slot key: ndarray}}`` (e.g. ``{"m", "v", "t"}`` for
    Adam). Unknown names or mismatched shapes raise."""
    by_name = dict(zip(executor._param_file_names(), executor.param_nodes))

    def node_of(name):
        if name not in by_name:
            raise KeyError(f"no parameter {name!r}; the executor has "
                           f"{sorted(by_name)}")
        return by_name[name]

    params = executor.state["params"]
    for name, arr in arrays.items():
        node = node_of(name)
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(params[id(node)].shape):
            raise ValueError(f"{name}: shape {arr.shape} does not match "
                             f"{tuple(params[id(node)].shape)}")
        params[id(node)] = executor._place_param(node, arr)
    for name, slot in (slots or {}).items():
        node = node_of(name)
        for opt in executor._opt_nodes():
            if node not in opt.vars:
                continue
            i = opt.vars.index(node)
            old = executor.state["slots"][id(opt)]
            new = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
                       executor.config.device) for k, v in slot.items()}
            if set(new) != set(old[i]):
                raise ValueError(f"{name}: slot keys {sorted(new)} do not "
                                 f"match {sorted(old[i])}")
            executor.state["slots"][id(opt)] = old[:i] + (new,) + old[i + 1:]


def tree_from_numpy(tree, device=None, like=None):
    """The JAX package's params pytree, given as nested dicts of numpy
    arrays (``jax.tree.map(np.asarray, params)``), as the port's dict of
    tensors with the same keys, shapes and dtypes, on ``device`` (default
    ``cuda:0``). ``like``: the port's tree for the same config (e.g.
    ``bert.init_params(0, cfg, "cpu")``); keys, shapes or dtypes that
    differ from it raise."""
    device = resolve_device(device)

    def convert(node, ref, path):
        if isinstance(node, dict):
            if ref is not None and (not isinstance(ref, dict)
                                    or set(node) != set(ref)):
                have = sorted(ref) if isinstance(ref, dict) else "a tensor"
                raise KeyError(f"{path or 'params'}: keys {sorted(node)} do "
                               f"not match the port's {have}")
            return {k: convert(v, None if ref is None else ref[k],
                               f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(ref, dict):
            raise KeyError(f"{path}: an array where the port has keys "
                           f"{sorted(ref)}")
        out = torch.from_numpy(np.array(node, copy=True, order="C"))
        if ref is not None and (out.shape != ref.shape
                                or out.dtype != ref.dtype):
            raise ValueError(f"{path}: {out.dtype} {tuple(out.shape)} does "
                             f"not match the port's {ref.dtype} "
                             f"{tuple(ref.shape)}")
        return out.to(device)

    return convert(tree, like, "")
