"""Seeded random HuggingFace checkpoints without ``transformers``: a
stand-in for a ``transformers`` model, carrying only what the port's
importers read (``config``, a namespace of the HF config's fields, and
``state_dict()``, HF's parameter names and layouts), so the HF paths run
on a host where the package is not installed.

Each function below takes the HF config's fields (the published
configurations, or small ones in the tests), draws every tensor from one
seeded generator on ``device`` (matrices and biases normal x 0.02, norm
scales 1 + normal x 0.02), and returns a ``StandIn``. Names and shapes are
the ``transformers`` classes' own (``LlamaForCausalLM``,
``GPT2LMHeadModel``, ``BertForSequenceClassification``,
``ViTForImageClassification``); the CPU tests hold them against those
classes.
"""
from __future__ import annotations

import types

import torch

# TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T, config.json
TINYLLAMA = dict(vocab_size=32000, hidden_size=2048, num_hidden_layers=22,
                 num_attention_heads=32, num_key_value_heads=4,
                 intermediate_size=5632, max_position_embeddings=2048,
                 rms_norm_eps=1e-5, rope_theta=10000.0,
                 tie_word_embeddings=False, hidden_act="silu",
                 attention_bias=False, rope_scaling=None)
# gpt2 (GPT-2 small), config.json
GPT2_SMALL = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                  n_head=12, n_inner=None, layer_norm_epsilon=1e-5,
                  activation_function="gelu_new")
# bert-base-uncased, config.json
BERT_BASE = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 layer_norm_eps=1e-12, hidden_act="gelu",
                 position_embedding_type="absolute")
# google/vit-base-patch16-224, config.json (ImageNet-1k head)
VIT_B16 = dict(image_size=224, patch_size=16, num_channels=3,
               hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
               intermediate_size=3072, layer_norm_eps=1e-12,
               hidden_act="gelu", qkv_bias=True, num_labels=1000)


class StandIn:
    """``config`` and ``state_dict()``, all an importer reads."""

    def __init__(self, config: dict, tensors: dict):
        self.config = types.SimpleNamespace(**config)
        self._tensors = tensors

    def state_dict(self):
        return dict(self._tensors)


def _is_norm_scale(name):
    module, _, leaf = name.rpartition(".")
    module = module.rpartition(".")[2]
    return leaf == "weight" and ("norm" in module.lower()
                                 or module.startswith("ln_"))


def _draw(shapes, seed, device):
    """{name: shape} -> {name: tensor}, one generator in name order; norm
    scales near 1."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        x = torch.randn(shape, generator=gen, device=device) * 0.02
        out[name] = x + 1.0 if _is_norm_scale(name) else x
    return out


def llama(seed=0, device="cpu", **config) -> StandIn:
    """A ``LlamaForCausalLM`` state dict (``model.*``, and ``lm_head``
    unless tied)."""
    c = dict(TINYLLAMA, **config)
    D, F, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    hd = D // c["num_attention_heads"]
    kv = c["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (V, D)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({p + "self_attn.q_proj.weight": (D, D),
                       p + "self_attn.k_proj.weight": (kv, D),
                       p + "self_attn.v_proj.weight": (kv, D),
                       p + "self_attn.o_proj.weight": (D, D),
                       p + "mlp.gate_proj.weight": (F, D),
                       p + "mlp.up_proj.weight": (F, D),
                       p + "mlp.down_proj.weight": (D, F),
                       p + "input_layernorm.weight": (D,),
                       p + "post_attention_layernorm.weight": (D,)})
    shapes["model.norm.weight"] = (D,)
    if not c["tie_word_embeddings"]:
        shapes["lm_head.weight"] = (V, D)
    return StandIn(c, _draw(shapes, seed, device))


def gpt2(seed=0, device="cpu", **config) -> StandIn:
    """A ``GPT2LMHeadModel`` state dict (``transformer.*``; ``lm_head`` is
    the same tensor as ``wte``, as HF ties them)."""
    c = dict(GPT2_SMALL, **config)
    D, V = c["n_embd"], c["vocab_size"]
    F = c["n_inner"] or 4 * D
    shapes = {"transformer.wte.weight": (V, D),
              "transformer.wpe.weight": (c["n_positions"], D)}
    for i in range(c["n_layer"]):
        p = f"transformer.h.{i}."
        shapes.update({p + "ln_1.weight": (D,), p + "ln_1.bias": (D,),
                       p + "attn.c_attn.weight": (D, 3 * D),
                       p + "attn.c_attn.bias": (3 * D,),
                       p + "attn.c_proj.weight": (D, D),
                       p + "attn.c_proj.bias": (D,),
                       p + "ln_2.weight": (D,), p + "ln_2.bias": (D,),
                       p + "mlp.c_fc.weight": (D, F),
                       p + "mlp.c_fc.bias": (F,),
                       p + "mlp.c_proj.weight": (F, D),
                       p + "mlp.c_proj.bias": (D,)})
    shapes.update({"transformer.ln_f.weight": (D,),
                   "transformer.ln_f.bias": (D,)})
    tensors = _draw(shapes, seed, device)
    tensors["lm_head.weight"] = tensors["transformer.wte.weight"]
    return StandIn(c, tensors)


def _encoder_layer(shapes, p, D, F, qkv, names):
    """One BERT/ViT encoder layer's names under ``p``."""
    for part in ("query", "key", "value"):
        shapes[p + f"{qkv}.{part}.weight"] = (D, D)
        shapes[p + f"{qkv}.{part}.bias"] = (D,)
    shapes.update({p + "attention.output.dense.weight": (D, D),
                   p + "attention.output.dense.bias": (D,),
                   p + "intermediate.dense.weight": (F, D),
                   p + "intermediate.dense.bias": (F,),
                   p + "output.dense.weight": (D, F),
                   p + "output.dense.bias": (D,)})
    for ln in names:
        shapes[p + f"{ln}.weight"] = (D,)
        shapes[p + f"{ln}.bias"] = (D,)


def bert_classifier(seed=0, device="cpu", num_labels=2, **config) -> StandIn:
    """A ``BertForSequenceClassification`` state dict (``bert.*`` with the
    pooler, and ``classifier``)."""
    c = dict(BERT_BASE, num_labels=num_labels, **config)
    D, F = c["hidden_size"], c["intermediate_size"]
    shapes = {"bert.embeddings.word_embeddings.weight": (c["vocab_size"], D),
              "bert.embeddings.position_embeddings.weight":
                  (c["max_position_embeddings"], D),
              "bert.embeddings.token_type_embeddings.weight":
                  (c["type_vocab_size"], D),
              "bert.embeddings.LayerNorm.weight": (D,),
              "bert.embeddings.LayerNorm.bias": (D,)}
    for i in range(c["num_hidden_layers"]):
        _encoder_layer(shapes, f"bert.encoder.layer.{i}.", D, F,
                       "attention.self",
                       ("attention.output.LayerNorm", "output.LayerNorm"))
    shapes.update({"bert.pooler.dense.weight": (D, D),
                   "bert.pooler.dense.bias": (D,),
                   "classifier.weight": (num_labels, D),
                   "classifier.bias": (num_labels,)})
    return StandIn(c, _draw(shapes, seed, device))


def vit_classifier(seed=0, device="cpu", **config) -> StandIn:
    """A ``ViTForImageClassification`` state dict (``vit.*`` without a
    pooler, and ``classifier``)."""
    c = dict(VIT_B16, **config)
    D, F, P = c["hidden_size"], c["intermediate_size"], c["patch_size"]
    n = (c["image_size"] // P) ** 2 + 1
    shapes = {"vit.embeddings.cls_token": (1, 1, D),
              "vit.embeddings.position_embeddings": (1, n, D),
              "vit.embeddings.patch_embeddings.projection.weight":
                  (D, c["num_channels"], P, P),
              "vit.embeddings.patch_embeddings.projection.bias": (D,)}
    for i in range(c["num_hidden_layers"]):
        _encoder_layer(shapes, f"vit.encoder.layer.{i}.", D, F,
                       "attention.attention",
                       ("layernorm_before", "layernorm_after"))
    shapes.update({"vit.layernorm.weight": (D,), "vit.layernorm.bias": (D,),
                   "classifier.weight": (c["num_labels"], D),
                   "classifier.bias": (c["num_labels"],)})
    return StandIn(c, _draw(shapes, seed, device))
