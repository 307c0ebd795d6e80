"""HuggingFace Llama-family checkpoint import and export (counterpart of
``hetu_tpu/models/hf_llama.py``): RoPE, RMSNorm, SwiGLU and GQA.

``transformers`` Llama (LlamaModel / LlamaForCausalLM; windowless
Mistral-class configs share the layout, while sliding-window attention and
a non-default head_dim or rope_scaling refuse at import) is the trunk's
Llama dialect: pre-LN with RMSNorm (``input_layernorm`` -> ln1,
``post_attention_layernorm`` -> ln2, the final ``model.norm`` -> lnf; the
unused *_bias params import as zeros), rotary position embeddings (HF's
rotate_half convention, ``transformer._rope``), the SwiGLU MLP
(gate/up/down -> w1/w3/w2), grouped-query attention when
num_key_value_heads < num_attention_heads, no learned position table, and
an untied (D, V) lm_head unless the config ties it. Import is a pure
weight relayout; the imported model rides the KV-cache decode (rotated
keys in the cache), speculative decoding and the training step.

The importer reads only ``model.config`` and ``model.state_dict()``: a
stand-in with those two attributes imports as a ``transformers`` model
does, and the port never imports ``transformers`` itself.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ndarray import resolve_device
from .hf_common import as_numpy, check_cfg, load_into_hf
from .transformer import TransformerConfig

_ARCH_FIELDS = ("vocab_size", "d_model", "n_heads", "n_kv_heads", "n_layers",
                "d_ff", "max_seq_len", "ln_eps", "norm", "rope", "rope_theta",
                "mlp", "use_pos_emb", "tied_head", "causal", "post_ln",
                "attn_proj_bias", "n_experts")


def config_from_hf(hf_config, **overrides) -> TransformerConfig:
    """transformers.LlamaConfig -> a TransformerConfig; refuses variants
    the trunk does not implement (importing them would run but be
    numerically wrong)."""
    act = getattr(hf_config, "hidden_act", "silu")
    if act not in ("silu", "swish"):
        raise NotImplementedError(f"hidden_act={act!r}: only silu")
    if getattr(hf_config, "attention_bias", False):
        raise NotImplementedError("attention_bias=True Llama variants")
    if getattr(hf_config, "sliding_window", None):
        # Mistral-style windowed attention: the trunk attends fully, so
        # any sequence longer than the window would silently diverge
        raise NotImplementedError(
            f"sliding_window={hf_config.sliding_window}: only full "
            "attention (windowless Mistral-class configs import fine)")
    hd = hf_config.hidden_size // hf_config.num_attention_heads
    if getattr(hf_config, "head_dim", hd) not in (None, hd):
        raise NotImplementedError(
            f"head_dim={hf_config.head_dim} != hidden_size/num_heads "
            f"({hd}): the trunk derives head_dim from d_model")
    scaling = getattr(hf_config, "rope_scaling", None)
    if scaling not in (None, {}) and (
            not isinstance(scaling, dict)
            or scaling.get("rope_type", scaling.get("type")) != "default"):
        raise NotImplementedError(f"rope_scaling={scaling!r}")
    kw = dict(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=(hf_config.num_key_value_heads
                    if hf_config.num_key_value_heads
                    != hf_config.num_attention_heads else 0),
        n_layers=hf_config.num_hidden_layers,
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        ln_eps=hf_config.rms_norm_eps,
        norm="rmsnorm",
        rope=True,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        mlp="swiglu",
        use_pos_emb=False,
        tied_head=bool(getattr(hf_config, "tie_word_embeddings", False)),
        causal=True,
        dtype=torch.float32,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def params_from_hf(model, cfg: TransformerConfig = None, device=None):
    """(LlamaModel/LlamaForCausalLM or a stand-in, cfg?) -> (params, cfg),
    the params f32 on ``device`` (default ``cuda:0``); a caller-supplied
    cfg is validated against the checkpoint.

    The relayout runs on the checkpoint's own device: it only transposes,
    stacks and concatenates, so its bits are those of the JAX package's
    numpy relayout, and a 1.1 B-parameter checkpoint already on the card
    never makes the round trip through the host."""
    want = config_from_hf(model.config)
    if cfg is None:
        cfg = want
    check_cfg(cfg, want, _ARCH_FIELDS)
    device = resolve_device(device)
    sd: Dict[str, torch.Tensor] = {}
    for k, v in model.state_dict().items():
        if k.startswith("model."):
            k = k[len("model."):]
        if "rotary_emb" in k:
            continue              # inv_freq buffers; recomputed by _rope
        sd[k] = v.detach().float()
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff

    def put(t):
        # an owning, contiguous f32 copy on ``device``
        return t.to(device, torch.float32, copy=True,
                    memory_format=torch.contiguous_format)

    def stack(name, transpose=True):
        return put(torch.stack([sd[f"layers.{i}.{name}"].T if transpose
                                else sd[f"layers.{i}.{name}"]
                                for i in range(L)]))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    wqkv = put(torch.stack([
        torch.cat([sd[f"layers.{i}.self_attn.{p}_proj.weight"].T
                   for p in "qkv"], dim=1)
        for i in range(L)]))              # (L, D, (nh + 2 nkv) hd)
    blocks = {
        "wqkv": wqkv,
        "wo": stack("self_attn.o_proj.weight"),
        "ln1_scale": stack("input_layernorm.weight", False),
        "ln1_bias": zeros(L, D),                    # unused (rmsnorm)
        "ln2_scale": stack("post_attention_layernorm.weight", False),
        "ln2_bias": zeros(L, D),
        "w1": stack("mlp.gate_proj.weight"),
        "w3": stack("mlp.up_proj.weight"),
        "w2": stack("mlp.down_proj.weight"),
        "b1": zeros(L, F),                          # unused (swiglu)
        "b2": zeros(L, D),
    }
    params = {
        "embed": put(sd["embed_tokens.weight"]),
        "blocks": blocks,
        "lnf_scale": put(sd["norm.weight"]),
        "lnf_bias": zeros(D),                       # unused (rmsnorm)
    }
    if not cfg.tied_head:
        if "lm_head.weight" not in sd:
            raise ValueError(
                "untied config but the checkpoint has no lm_head (pass a "
                "LlamaForCausalLM, or a config with tie_word_embeddings)")
        params["head"] = put(sd["lm_head.weight"].T)
    return params, cfg


def state_dict_from_params(params, cfg: TransformerConfig):
    """Inverse relayout: params -> HF-named numpy state dict (unscoped
    ``embed_tokens/layers.N/norm`` names, and ``lm_head`` when untied)."""
    blocks = {k: as_numpy(v) for k, v in params["blocks"].items()}
    nh, nkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    sd = {
        "embed_tokens.weight": as_numpy(params["embed"]),
        "norm.weight": as_numpy(params["lnf_scale"]),
    }
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        wqkv = blocks["wqkv"][i]
        sd[p + "self_attn.q_proj.weight"] = wqkv[:, :nh * hd].T
        sd[p + "self_attn.k_proj.weight"] = \
            wqkv[:, nh * hd:(nh + nkv) * hd].T
        sd[p + "self_attn.v_proj.weight"] = wqkv[:, (nh + nkv) * hd:].T
        sd[p + "self_attn.o_proj.weight"] = blocks["wo"][i].T
        sd[p + "input_layernorm.weight"] = blocks["ln1_scale"][i]
        sd[p + "post_attention_layernorm.weight"] = blocks["ln2_scale"][i]
        sd[p + "mlp.gate_proj.weight"] = blocks["w1"][i].T
        sd[p + "mlp.up_proj.weight"] = blocks["w3"][i].T
        sd[p + "mlp.down_proj.weight"] = blocks["w2"][i].T
    if not cfg.tied_head:
        sd["lm_head.weight"] = as_numpy(params["head"]).T
    return sd


def export_to_hf(params, cfg: TransformerConfig, model):
    """Load params into a live transformers Llama ``model`` (LlamaModel or
    LlamaForCausalLM); bidirectionally validated."""
    sd = dict(state_dict_from_params(params, cfg))
    target = model.state_dict()
    if cfg.tied_head and any(k.startswith("lm_head.") for k in target):
        sd["lm_head.weight"] = sd["embed_tokens.weight"]
    return load_into_hf(
        sd, model, scope="model.",
        # rope inv_freq buffers on some transformers versions
        skip_target=lambda k: "rotary_emb" in k,
        droppable=("lm_head.",))
