"""Carrying state across from ``hetu_tpu``: set the port's parameters and
optimizer slots from numpy arrays keyed by the reference's parameter names
(``Executor._param_file_names``, the names of ``Executor.save``'s files).
``Executor.load`` reads a whole directory that ``hetu_tpu``'s
``Executor.save`` wrote.
"""
from __future__ import annotations

import numpy as np
import torch


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
