"""HuggingFace ViT checkpoint import and export (counterpart of
``hetu_tpu/models/hf_vit.py``), the vision side of the interop.

``transformers`` ViT (ViTModel / ViTForImageClassification) is the
trunk's pre-LN dialect with projection biases: HF's ``layernorm_before``
is ln1 (before attention), ``layernorm_after`` ln2 (before the MLP), erf
gelu at eps 1e-12, and the final ``layernorm`` lnf. The stride-P patch
conv flattens to ``models/vit.py``'s single patch matmul by pure reshape:
the kernel's (C, Ps, Ps) receptive field is one flattened patch.

The importer reads only ``model.config`` and ``model.state_dict()``, so a
stand-in with those two attributes imports as a ``transformers`` model
does.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .hf_common import as_numpy, check_cfg, load_into_hf, np_f32, \
    tree_to_torch
from .vit import ViTConfig

_ARCH_FIELDS = ("image_size", "patch_size", "n_channels", "d_model",
                "n_heads", "n_layers", "d_ff", "ln_eps", "gelu_exact")
# HF name under encoder.layer.N. -> (the block param, transposed?)
_BLOCK = {"attention.output.dense.weight": ("wo", True),
          "attention.output.dense.bias": ("bo", False),
          # pre-LN: layernorm_before runs before attention (ln1),
          # layernorm_after before the MLP (ln2)
          "layernorm_before.weight": ("ln1_scale", False),
          "layernorm_before.bias": ("ln1_bias", False),
          "layernorm_after.weight": ("ln2_scale", False),
          "layernorm_after.bias": ("ln2_bias", False),
          "intermediate.dense.weight": ("w1", True),
          "intermediate.dense.bias": ("b1", False),
          "output.dense.weight": ("w2", True),
          "output.dense.bias": ("b2", False)}
_QKV = ("query", "key", "value")


def config_from_hf(hf_config, **overrides) -> ViTConfig:
    act = getattr(hf_config, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise NotImplementedError(f"hidden_act={act!r}: only gelu variants")
    if not getattr(hf_config, "qkv_bias", True):
        raise NotImplementedError("qkv_bias=False ViT variants")
    kw = dict(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        n_channels=hf_config.num_channels,
        d_model=hf_config.hidden_size,
        n_heads=hf_config.num_attention_heads,
        n_layers=hf_config.num_hidden_layers,
        d_ff=hf_config.intermediate_size,
        ln_eps=hf_config.layer_norm_eps,
        gelu_exact=(act == "gelu"),
    )
    kw.update(overrides)
    return ViTConfig(**kw)


def _has_classifier(model) -> bool:
    return any(k.startswith("classifier.") for k in model.state_dict())


def params_from_hf(model, cfg: ViTConfig = None, device=None):
    """(ViTModel/ViTForImageClassification or a stand-in, cfg?) ->
    (params, cfg), the params f32 on ``device`` (default ``cuda:0``); a
    caller-supplied cfg is validated against the checkpoint's
    architecture, the classifier head included: an n_classes that
    disagrees with the checkpoint's refuses, and n_classes=0 DROPS the
    checkpoint's head."""
    # num_labels is the authoritative HF field; id2label can be absent or
    # inconsistent on hand-edited configs
    ckpt_classes = ((getattr(model.config, "num_labels", 0)
                     or len(getattr(model.config, "id2label", {}) or {}))
                    if _has_classifier(model) else 0)
    want = config_from_hf(model.config, n_classes=ckpt_classes)
    if cfg is None:
        cfg = want
    fields = _ARCH_FIELDS
    if cfg.n_classes not in (0, ckpt_classes):
        fields += ("n_classes",)
    check_cfg(cfg, want, fields)
    sd: Dict[str, Any] = {}
    for k, v in model.state_dict().items():
        if k.startswith("vit."):
            k = k[len("vit."):]
        sd[k] = np_f32(v)
    L, D = cfg.n_layers, cfg.d_model

    def layer(i, name):
        return sd[f"encoder.layer.{i}.{name}"]

    blocks = {
        "wqkv": np.stack([np.concatenate(
            [layer(i, f"attention.attention.{p}.weight").T for p in _QKV],
            axis=1) for i in range(L)]),                     # (L, D, 3D)
        "bqkv": np.stack([np.concatenate(
            [layer(i, f"attention.attention.{p}.bias") for p in _QKV])
            for i in range(L)]),
    }
    for name, (ours, tr) in _BLOCK.items():
        blocks[ours] = np.stack([layer(i, name).T if tr else layer(i, name)
                                 for i in range(L)])
    # the stride-P conv kernel (D, C, Ps, Ps): its (C, Ps, Ps) receptive
    # field flattens to one patch row, so reshape + transpose IS the matmul
    # weight
    conv_w = sd["embeddings.patch_embeddings.projection.weight"]
    params = {
        "patch_w": conv_w.reshape(D, -1).T,            # (C*Ps*Ps, D)
        "patch_b": sd["embeddings.patch_embeddings.projection.bias"],
        "cls_token": sd["embeddings.cls_token"],
        "pos": sd["embeddings.position_embeddings"][0],
        "lnf_scale": sd["layernorm.weight"],
        "lnf_bias": sd["layernorm.bias"],
        "blocks": blocks,
    }
    if "classifier.weight" in sd and cfg.n_classes:
        params["cls_w"] = sd["classifier.weight"].T
        params["cls_b"] = sd["classifier.bias"]
    return tree_to_torch(params, device), cfg


def state_dict_from_params(params, cfg: ViTConfig):
    """Inverse of ``params_from_hf``: params -> HF-named numpy state dict,
    so trained ViT weights deploy back through ``transformers``."""
    blocks = {k: as_numpy(v) for k, v in params["blocks"].items()}
    D = cfg.d_model
    sd = {
        "embeddings.cls_token": as_numpy(params["cls_token"]),
        "embeddings.position_embeddings": as_numpy(params["pos"])[None],
        "embeddings.patch_embeddings.projection.weight":
            as_numpy(params["patch_w"]).T.reshape(
                D, cfg.n_channels, cfg.patch_size, cfg.patch_size),
        "embeddings.patch_embeddings.projection.bias":
            as_numpy(params["patch_b"]),
        "layernorm.weight": as_numpy(params["lnf_scale"]),
        "layernorm.bias": as_numpy(params["lnf_bias"]),
    }
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        wqkv, bqkv = blocks["wqkv"][i], blocks["bqkv"][i]
        for j, part in enumerate(_QKV):
            sd[p + f"attention.attention.{part}.weight"] = \
                wqkv[:, j * D:(j + 1) * D].T
            sd[p + f"attention.attention.{part}.bias"] = \
                bqkv[j * D:(j + 1) * D]
        for name, (ours, tr) in _BLOCK.items():
            sd[p + name] = blocks[ours][i].T if tr else blocks[ours][i]
    if "cls_w" in params:
        sd["classifier.weight"] = as_numpy(params["cls_w"]).T
        sd["classifier.bias"] = as_numpy(params["cls_b"])
    return sd


def export_to_hf(params, cfg: ViTConfig, model):
    """Load params into a live transformers ViT ``model``
    (ViTForImageClassification, or ViTModel built with
    ``add_pooling_layer=False``: this ViT has no pooler, and leaving a
    random pooler in the target would be a partial deploy). Validated both
    ways (``hf_common.load_into_hf``)."""
    sd = state_dict_from_params(params, cfg)
    return load_into_hf(sd, model, scope="vit.",
                        droppable=("classifier.",))
