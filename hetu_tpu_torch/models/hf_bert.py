"""HuggingFace BERT checkpoint import and export (counterpart of
``hetu_tpu/models/hf_bert.py``): weight for weight into ``models/bert.py``
params, so the forward outputs match the torch model's.

HF BERT is the canonical post-LN dialect (``BertConfig.hf()``): LN after
each residual add, an embedding LayerNorm (mapped onto the trunk's ``lnf``
params, which the post-LN path applies after the embedding sum), erf gelu,
eps 1e-12 and biases on every projection. The import refuses configs that
disagree: post-LN weights in the pre-LN trunk would run but mean nothing.
``BertModel``, ``BertForPreTraining`` and ``BertForSequenceClassification``
import with whatever heads they carry (MLM transform and bias, NSP,
pooler, classifier).

The importer reads only ``model.config`` and ``model.state_dict()``; no
torch tensor of the checkpoint leaks out: everything goes through numpy
to f32 tensors on the requested device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .bert import BertConfig
from .hf_common import as_numpy, check_cfg, load_into_hf, np_f32, \
    tree_to_torch

_ARCH_FIELDS = ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
                "max_seq_len", "type_vocab_size", "ln_eps", "gelu_exact")
# HF name under encoder.layer.N. -> (the block param, transposed?)
_BLOCK = {"attention.output.dense.weight": ("wo", True),
          "attention.output.dense.bias": ("bo", False),
          # post-LN: ln1 runs after the attention residual, ln2 after the MLP
          "attention.output.LayerNorm.weight": ("ln1_scale", False),
          "attention.output.LayerNorm.bias": ("ln1_bias", False),
          "intermediate.dense.weight": ("w1", True),
          "intermediate.dense.bias": ("b1", False),
          "output.dense.weight": ("w2", True),
          "output.dense.bias": ("b2", False),
          "output.LayerNorm.weight": ("ln2_scale", False),
          "output.LayerNorm.bias": ("ln2_bias", False)}
# top-level HF name -> (the param, transposed?); a head is imported when
# its keys are in the checkpoint
_TOP = {"embeddings.word_embeddings.weight": ("embed", False),
        "embeddings.position_embeddings.weight": ("pos", False),
        "embeddings.token_type_embeddings.weight": ("type_emb", False),
        # post-LN repurposes lnf as the embedding LayerNorm (bert.encode)
        "embeddings.LayerNorm.weight": ("lnf_scale", False),
        "embeddings.LayerNorm.bias": ("lnf_bias", False),
        "pooler.dense.weight": ("pool_w", True),
        "pooler.dense.bias": ("pool_b", False),
        "cls.predictions.transform.dense.weight": ("mlm_dense", True),
        "cls.predictions.transform.dense.bias": ("mlm_dense_b", False),
        "cls.predictions.transform.LayerNorm.weight": ("mlm_ln_scale", False),
        "cls.predictions.transform.LayerNorm.bias": ("mlm_ln_bias", False),
        "cls.predictions.bias": ("mlm_bias", False),
        "cls.seq_relationship.weight": ("nsp_w", True),
        "cls.seq_relationship.bias": ("nsp_b", False),
        "classifier.weight": ("cls_w", True),
        "classifier.bias": ("cls_b", False)}


def config_from_hf(hf_config) -> BertConfig:
    """transformers.BertConfig -> BertConfig.hf() with matching shapes."""
    act = getattr(hf_config, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise NotImplementedError(f"hidden_act={act!r}: only gelu variants")
    pe = getattr(hf_config, "position_embedding_type", "absolute")
    if pe != "absolute":
        # relative_key(_query) adds distance-embedding terms inside the
        # attention scores; importing would silently drop them
        raise NotImplementedError(
            f"position_embedding_type={pe!r}: only 'absolute'")
    if getattr(hf_config, "is_decoder", False) or getattr(
            hf_config, "add_cross_attention", False):
        raise NotImplementedError(
            "decoder/cross-attention BERT variants are not supported")
    return BertConfig.hf(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_heads=hf_config.num_attention_heads,
        n_layers=hf_config.num_hidden_layers,
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        ln_eps=hf_config.layer_norm_eps,
        gelu_exact=(act == "gelu"),
        dtype=torch.float32,
    )


def params_from_hf(model, cfg: BertConfig = None, device=None):
    """(a transformers BERT model or a stand-in, cfg?) -> (params, cfg),
    the params f32 on ``device`` (default ``cuda:0``).

    ``model``: BertModel, BertForPreTraining or
    BertForSequenceClassification (anything whose state dict carries the
    ``embeddings./encoder.`` keys). Heads present in the checkpoint are
    mapped; absent heads are missing from the returned params, and callers
    wanting fresh heads graft them (``bert.init_classifier_params``).

    A caller-supplied ``cfg`` is validated against the checkpoint: dialect
    (post-LN, biases, gelu flavour, LN eps) AND shapes."""
    if cfg is None:
        cfg = config_from_hf(model.config)
    if not (cfg.post_ln and cfg.attn_proj_bias):
        raise ValueError(
            "HF BERT weights are post-LN with projection biases; build the "
            "config with BertConfig.hf() (got post_ln=%s attn_proj_bias=%s)"
            % (cfg.post_ln, cfg.attn_proj_bias))
    check_cfg(cfg, config_from_hf(model.config), _ARCH_FIELDS)
    # BertForPreTraining nests the encoder under bert.; BertModel does not
    sd = {k[len("bert."):] if k.startswith("bert.") else k: np_f32(v)
          for k, v in model.state_dict().items()}

    def layer(i, name):
        return sd[f"encoder.layer.{i}.{name}"]

    L = cfg.n_layers
    # per-layer stacks, leading L axis
    blocks = {
        "wqkv": np.stack([np.concatenate(
            [layer(i, f"attention.self.{p}.weight").T
             for p in ("query", "key", "value")], axis=1)
            for i in range(L)]),                              # (L, D, 3D)
        "bqkv": np.stack([np.concatenate(
            [layer(i, f"attention.self.{p}.bias")
             for p in ("query", "key", "value")]) for i in range(L)]),
    }
    for name, (ours, tr) in _BLOCK.items():
        blocks[ours] = np.stack([layer(i, name).T if tr else layer(i, name)
                                 for i in range(L)])
    params: Dict[str, Any] = {"blocks": blocks}
    for name, (ours, tr) in _TOP.items():
        if name in sd:
            params[ours] = sd[name].T if tr else sd[name]
    # the MLM decode is tied to params["embed"], as in HF
    return tree_to_torch(params, device), cfg


def state_dict_from_params(params, cfg: BertConfig):
    """Inverse of ``params_from_hf``: params -> HF-named numpy state dict
    (unscoped ``embeddings./encoder./pooler.`` names plus whatever heads
    are present), so trained weights deploy back through
    ``transformers``; ``export_to_hf`` loads it into a model."""
    blocks = {k: as_numpy(v) for k, v in params["blocks"].items()}
    D = cfg.d_model
    sd = {}
    for name, (ours, tr) in _TOP.items():
        if ours in params:
            v = as_numpy(params[ours])
            sd[name] = v.T if tr else v
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        wqkv, bqkv = blocks["wqkv"][i], blocks["bqkv"][i]
        for j, part in enumerate(("query", "key", "value")):
            sd[p + f"attention.self.{part}.weight"] = \
                wqkv[:, j * D:(j + 1) * D].T
            sd[p + f"attention.self.{part}.bias"] = bqkv[j * D:(j + 1) * D]
        for name, (ours, tr) in _BLOCK.items():
            sd[p + name] = blocks[ours][i].T if tr else blocks[ours][i]
    if "mlm_dense" in params:
        # HF ties cls.predictions.decoder to word_embeddings; emit it
        # explicitly so untied consumers load the right matrix too
        sd["cls.predictions.decoder.weight"] = as_numpy(params["embed"])
        sd["cls.predictions.decoder.bias"] = as_numpy(params["mlm_bias"])
    return sd


def export_to_hf(params, cfg: BertConfig, model):
    """Load params into a live transformers BERT ``model`` (any of the
    supported classes), scoped under ``bert.`` for the ForXxx wrappers.
    Validated both ways (``hf_common.load_into_hf``): only HEADS the target
    class lacks (cls.*/classifier./pooler.) may be dropped, since deploying
    an encoder into a wrapper with other heads is a legitimate export."""
    sd = state_dict_from_params(params, cfg)
    return load_into_hf(
        sd, model, scope="bert.",
        # registered buffers (position_ids/token_type_ids on some
        # transformers versions) are positional constants, not weights
        skip_target=lambda k: k.endswith(("position_ids",
                                          "token_type_ids")),
        droppable=("cls.", "classifier.", "pooler."))
