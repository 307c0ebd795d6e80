"""HuggingFace GPT-2 checkpoint import and export (counterpart of
``hetu_tpu/models/hf_gpt2.py``): the trunk is GPT-2 once
``attn_proj_bias=True``.

Pre-LN blocks (ln_1 -> attention -> residual, ln_2 -> MLP -> residual),
learned positions, tanh-approximate gelu (HF ``gelu_new``), LN eps 1e-5, a
final ``ln_f``, and the LM head tied to the token embedding
(``cfg.tied_head``) exactly as HF ties lm_head to wte: no transposed copy,
one tensor and one gradient under fine-tuning. Loading is a pure weight
relayout, and the imported model rides every path of the trunk: flash
attention, the fused LM-CE kernel, the KV-cache decode.

HF layout: ``Conv1D`` stores its weight as (in, out), the trunk's
orientation, so no block weight is transposed; ``c_attn`` is the fused
(D, 3D) qkv projection, the trunk's ``wqkv``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .hf_common import as_numpy, check_cfg, load_into_hf, np_f32, \
    tree_to_torch
from .transformer import TransformerConfig

_ARCH_FIELDS = ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
                "max_seq_len", "ln_eps", "gelu_exact", "attn_proj_bias",
                "causal", "post_ln", "tied_head", "n_experts")
# HF name under h.N. -> the trunk's block param, both (in, out)
_BLOCK = {"ln_1.weight": "ln1_scale", "ln_1.bias": "ln1_bias",
          "attn.c_attn.weight": "wqkv", "attn.c_attn.bias": "bqkv",
          "attn.c_proj.weight": "wo", "attn.c_proj.bias": "bo",
          "ln_2.weight": "ln2_scale", "ln_2.bias": "ln2_bias",
          "mlp.c_fc.weight": "w1", "mlp.c_fc.bias": "b1",
          "mlp.c_proj.weight": "w2", "mlp.c_proj.bias": "b2"}


def config_from_hf(hf_config, **overrides) -> TransformerConfig:
    """transformers.GPT2Config -> a TransformerConfig. Refuses attention
    variants the trunk does not implement: importing them would run but
    be numerically wrong."""
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh", "gelu"):
        raise NotImplementedError(f"activation {act!r}: only gelu variants")
    unsupported = [flag for flag, bad in (
        ("scale_attn_by_inverse_layer_idx", True),  # scores / (layer+1)
        ("reorder_and_upcast_attn", True),
        ("scale_attn_weights", False),              # skip the 1/sqrt(hd)
        ("add_cross_attention", True),
    ) if getattr(hf_config, flag, not bad) == bad]
    if unsupported:
        raise NotImplementedError(
            "GPT-2 attention variant(s) not supported: "
            + ", ".join(unsupported))
    kw = dict(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.n_embd,
        n_heads=hf_config.n_head,
        n_layers=hf_config.n_layer,
        d_ff=(hf_config.n_inner if hf_config.n_inner
              else 4 * hf_config.n_embd),
        max_seq_len=hf_config.n_positions,
        ln_eps=hf_config.layer_norm_epsilon,
        gelu_exact=(act == "gelu"),
        attn_proj_bias=True,
        tied_head=True,      # lm_head shares wte, as in HF
        causal=True,
        dtype=torch.float32,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def params_from_hf(model, cfg: TransformerConfig = None, device=None):
    """(GPT2Model/GPT2LMHeadModel or a stand-in, cfg?) -> (params, cfg),
    the params f32 on ``device`` (default ``cuda:0``). A caller-supplied
    ``cfg`` is validated against the checkpoint (shape AND dialect
    fields): a truncated or reshaped import refuses."""
    want = config_from_hf(model.config)
    if cfg is None:
        cfg = want
    check_cfg(cfg, want, _ARCH_FIELDS)
    sd: Dict[str, Any] = {}
    for k, v in model.state_dict().items():
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        if not k.startswith(("h.", "wte.", "wpe.", "ln_f.")):
            continue   # lm_head.weight (the tied duplicate of wte), buffers
        if ".attn.bias" in k or ".attn.masked_bias" in k:
            continue   # causal-mask buffers on older transformers versions
        sd[k] = np_f32(v)
    blocks = {ours: np.stack([sd[f"h.{i}.{name}"]
                              for i in range(cfg.n_layers)])
              for name, ours in _BLOCK.items()}
    params = {
        # cfg.tied_head: the LM head IS this embedding (no copy)
        "embed": sd["wte.weight"],
        "pos": sd["wpe.weight"],
        "blocks": blocks,
        "lnf_scale": sd["ln_f.weight"],
        "lnf_bias": sd["ln_f.bias"],
    }
    return tree_to_torch(params, device), cfg


def state_dict_from_params(params, cfg: TransformerConfig):
    """Inverse of ``params_from_hf``: params -> HF-named numpy state dict
    (unscoped ``wte/wpe/h.N/ln_f`` names), transpose-free like the
    import."""
    blocks = {k: as_numpy(v) for k, v in params["blocks"].items()}
    sd = {
        "wte.weight": as_numpy(params["embed"]),
        "wpe.weight": as_numpy(params["pos"]),
        "ln_f.weight": as_numpy(params["lnf_scale"]),
        "ln_f.bias": as_numpy(params["lnf_bias"]),
    }
    for i in range(cfg.n_layers):
        for name, ours in _BLOCK.items():
            sd[f"h.{i}.{name}"] = blocks[ours][i]
    return sd


def export_to_hf(params, cfg: TransformerConfig, model):
    """Load params into a live transformers GPT-2 ``model`` (GPT2Model or
    GPT2LMHeadModel). Requires ``cfg.tied_head``: HF GPT-2 ties lm_head to
    wte (one tensor), so an untied head has no faithful place in the
    target; loading it into lm_head would silently overwrite wte through
    the tie. Returns the model."""
    if not cfg.tied_head:
        raise ValueError(
            "export_to_hf needs cfg.tied_head=True: HF GPT-2 ties lm_head "
            "to wte, so a separately trained (D, V) head cannot be "
            "represented in a GPT-2 checkpoint")
    sd = dict(state_dict_from_params(params, cfg))
    if any(k.startswith("lm_head.") for k in model.state_dict()):
        sd["lm_head.weight"] = sd["wte.weight"]   # the tie, explicitly
    return load_into_hf(
        sd, model, scope="transformer.",
        # causal-mask buffers on older transformers versions
        skip_target=lambda k: (".attn.bias" in k
                               or ".attn.masked_bias" in k))
