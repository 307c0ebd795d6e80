"""Shared helpers of the HuggingFace checkpoint importers (counterpart of
``hetu_tpu/models/hf_common.py``): the torch -> numpy -> device conversion
in one place, so dtype handling cannot drift between the model families,
and the bidirectionally validated load into a live ``transformers`` model.
The Llama importer relays out on the checkpoint's own device instead (a
1.1 B-parameter checkpoint on the card would otherwise go through the
host), with the same f32 cast.

No module of the port imports ``transformers``: an importer reads only
``model.config`` and ``model.state_dict()``, so a stand-in object with
those two attributes imports exactly as a ``transformers`` model does, on
a host without the package. ``load_into_hf`` takes the live model from its
caller.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ndarray import resolve_device


def np_f32(t) -> np.ndarray:
    """torch tensor -> float32 numpy (covers f16/bf16 checkpoints)."""
    return t.detach().to("cpu").float().numpy()


def as_numpy(x) -> np.ndarray:
    """A params leaf (a tensor on any device, or an array) as numpy, with
    its dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def tree_to_torch(params: dict, device=None) -> dict:
    """One-level params dict (leaves or one nested dict) -> f32 tensors on
    ``device`` (default ``cuda:0``, as ``resolve_device``)."""
    device = resolve_device(device)

    def put(v):
        return torch.from_numpy(np.array(v, dtype=np.float32, copy=True,
                                         order="C")).to(device)

    return {k: (put(v) if not isinstance(v, dict)
                else {kk: put(vv) for kk, vv in v.items()})
            for k, v in params.items()}


def check_cfg(cfg, want, fields):
    """Refuse a caller's config that disagrees with the checkpoint's on
    any of ``fields``: a truncated or reshaped import must not run."""
    mismatched = [f for f in fields if getattr(cfg, f) != getattr(want, f)]
    if mismatched:
        raise ValueError(
            "cfg disagrees with the checkpoint's architecture on "
            + ", ".join(f"{f} ({getattr(cfg, f)} != {getattr(want, f)})"
                        for f in mismatched))


def load_into_hf(sd: dict, model, scope: str, skip_target=lambda k: False,
                 droppable=()):
    """Load an unscoped HF-named numpy state dict into a live transformers
    ``model``, shared by the exporters so the validation cannot drift.

    Validates BOTH directions, so a silently partial deploy cannot happen:
    - every exported key must land in the target (an unmatched trunk key,
      e.g. ``encoder.layer.8.*`` against a 6-layer model, is an
      architecture mismatch and raises; keys under a ``droppable`` prefix,
      heads the target model class does not have, may be dropped);
    - every target key must be filled (except ``skip_target`` buffers);
    - shape mismatches raise inside ``load_state_dict`` itself.
    """
    target = model.state_dict()
    scoped, unmatched = {}, []
    for k, v in sd.items():
        name = (k if k in target
                else scope + k if scope + k in target else None)
        if name is None:
            if not k.startswith(tuple(droppable)):
                unmatched.append(k)
            continue
        scoped[name] = torch.tensor(as_numpy(v))   # an owning copy
    if unmatched:
        raise ValueError(
            f"export keys with no slot in the target model (architecture "
            f"mismatch?): {unmatched[:6]}{'...' if len(unmatched) > 6 else ''}")
    missing = [k for k in target if k not in scoped and not skip_target(k)]
    if missing:
        raise ValueError(f"export cannot fill target keys: {missing}")
    model.load_state_dict(scoped, strict=False)
    return model
