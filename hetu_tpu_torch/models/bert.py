"""BERT, forward (counterpart of ``hetu_tpu/models/bert.py``): the
bidirectional encoder on the transformer trunk (``causal=False``) with
token-type embeddings, the MLM head (dense + gelu + LN, decode tied to the
token embedding, plus an output bias), the NSP head on the pooled [CLS]
vector, and a classifier head for serving.

``encode``, ``pretrain_loss``, ``classify_logits`` and the train steps
``make_pretrain_step`` (MLM + NSP pretraining) and ``make_finetune_step``
(the classifier) run the ported kernels on the card: flash attention
forward and backward in every encoder layer, the fused linear+CE forward
and backward for the MLM loss, and in the backward the embedding gradient's
segment sum for the token and the type embedding (both gathered by
``kernels/embed_grad.py:lookup``). The steps use the trunk's AdamW
(``transformer.adamw_update``) and update params and optimizer state in
place. ``param_specs`` is mesh code and comes with the parallel slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import transformer as tfm
from ..kernels import embed_grad
from ..kernels.fused_ce import fused_linear_nll, should_fuse
from ..ndarray import resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dtype: Any = torch.bfloat16
    remat: bool = True
    attn_impl: str = "auto"
    # MLM loss through the fused linear+CE kernel, which never
    # materializes the (B*P, V) logits. "auto": CUDA tensors; True forces
    # it (tests); False disables.
    fused_mlm_ce: Any = "auto"
    # Architecture dialect: the default is the pre-LN trunk; ``hf()``
    # flips all four knobs to the canonical Devlin/HuggingFace BERT —
    # post-LN blocks, embedding LayerNorm (the trunk's lnf params, applied
    # after the embedding sum), erf gelu, eps 1e-12, qkv/out biases.
    post_ln: bool = False
    ln_eps: float = 1e-5
    gelu_exact: bool = False
    attn_proj_bias: bool = False

    @classmethod
    def hf(cls, **overrides) -> "BertConfig":
        """The canonical (HuggingFace-compatible) BERT architecture."""
        overrides.setdefault("post_ln", True)
        overrides.setdefault("ln_eps", 1e-12)
        overrides.setdefault("gelu_exact", True)
        overrides.setdefault("attn_proj_bias", True)
        return cls(**overrides)

    def trunk(self) -> tfm.TransformerConfig:
        return tfm.TransformerConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_heads=self.n_heads, n_layers=self.n_layers, d_ff=self.d_ff,
            max_seq_len=self.max_seq_len, dtype=self.dtype, remat=self.remat,
            attn_impl=self.attn_impl, causal=False,
            post_ln=self.post_ln, ln_eps=self.ln_eps,
            gelu_exact=self.gelu_exact, attn_proj_bias=self.attn_proj_bias)


BERT_BASE = BertConfig()


def init_params(rng, cfg: BertConfig, device=None):
    """Random params from ``rng`` (a ``torch.Generator`` or an int seed) on
    ``device`` (default ``cuda:0``), in the reference's layout."""
    device = resolve_device(device)
    D, V = cfg.d_model, cfg.vocab_size
    ks = tfm.split_generator(rng, 5)
    params = tfm.init_params(ks[0], cfg.trunk(), device)
    del params["head"]   # MLM decode is tied to the token embedding

    def normal(gen, shape):
        return tfm._init_normal(gen, shape, 0.02, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    params["type_emb"] = normal(ks[1], (cfg.type_vocab_size, D))
    params["mlm_dense"] = normal(ks[2], (D, D))
    if cfg.attn_proj_bias:
        params["mlm_dense_b"] = zeros(D)
    params["mlm_ln_scale"] = torch.ones((D,), dtype=torch.float32,
                                        device=device)
    params["mlm_ln_bias"] = zeros(D)
    params["mlm_bias"] = zeros(V)
    params["pool_w"] = normal(ks[3], (D, D))
    params["pool_b"] = zeros(D)
    params["nsp_w"] = normal(ks[4], (D, 2))
    params["nsp_b"] = zeros(2)
    return params


def encode(params, input_ids, segment_ids, cfg: BertConfig, mesh=None,
           input_mask=None):
    """-> final hidden states (B, T, D). Pre-LN: trunk then the final LN
    (lnf). Post-LN: lnf is the embedding LayerNorm, and the trunk output is
    final as it is."""
    trunk = cfg.trunk()
    h = tfm.embed_tokens(params, input_ids, trunk)
    h = h + embed_grad.lookup(params["type_emb"], segment_ids).to(h.dtype)
    if cfg.post_ln:
        h = tfm._layer_norm(h, params["lnf_scale"], params["lnf_bias"],
                            cfg.ln_eps)
    attn_bias = None
    if input_mask is not None:
        # (B, T) 1/0 -> additive (B, 1, 1, T): padded keys get -1e30
        attn_bias = (1.0 - input_mask.float())[:, None, None, :] * -1e30
    h, _aux = tfm.encode(params, h, trunk, mesh, attn_bias)
    if cfg.post_ln:
        return h
    return tfm._layer_norm(h, params["lnf_scale"], params["lnf_bias"],
                           cfg.ln_eps)


def mlm_transform(params, h, positions, cfg: BertConfig):
    """Gather (B, P) masked positions from h (B, T, D) and run the MLM
    transform (dense + bias + gelu + LN) -> (B, P, D)."""
    idx = positions.long()[..., None].expand(-1, -1, h.shape[-1])
    g = tfm._mm(torch.gather(h, 1, idx), params["mlm_dense"])
    if "mlm_dense_b" in params:
        g = g + params["mlm_dense_b"].to(g.dtype)
    g = tfm._gelu(g, cfg)
    return tfm._layer_norm(g, params["mlm_ln_scale"], params["mlm_ln_bias"],
                           cfg.ln_eps)


def mlm_logits(params, h, positions, cfg: BertConfig):
    """MLM transform + decode tied to the token embedding -> (B, P, V) f32
    (the materializing form; the fused path skips this tensor)."""
    g = mlm_transform(params, h, positions, cfg)
    return tfm._mm32(g, params["embed"].t()) + params["mlm_bias"]


def _pool(params, h):
    """Tanh-dense pooling of the [CLS] vector -> (B, D) f32."""
    return torch.tanh(h[:, 0, :].float() @ params["pool_w"] + params["pool_b"])


def nsp_logits(params, h):
    """Pooled [CLS] -> (B, 2) f32."""
    return _pool(params, h) @ params["nsp_w"] + params["nsp_b"]


def pretrain_loss(params, batch, cfg: BertConfig, mesh=None):
    """batch: dict of tensors with the data pipeline's rows. Returns
    ``(loss, (mlm, nsp))``, mlm averaged over the weighted slots."""
    h = encode(params, batch["input_ids"], batch["segment_ids"], cfg, mesh,
               batch.get("input_mask"))
    if should_fuse(cfg.fused_mlm_ce, mesh, h.device):
        g = mlm_transform(params, h, batch["mlm_positions"], cfg)
        B, Pm, D = g.shape
        per_slot = fused_linear_nll(
            g.reshape(B * Pm, D), params["embed"].to(g.dtype),
            params["mlm_bias"], batch["mlm_ids"].reshape(-1)).reshape(B, Pm)
    else:
        logits = mlm_logits(params, h, batch["mlm_positions"], cfg)
        logp = torch.log_softmax(logits.float(), -1)
        per_slot = -torch.gather(logp, -1,
                                 batch["mlm_ids"].long()[..., None])[..., 0]
    w = batch["mlm_weights"].float()
    mlm = torch.sum(per_slot * w) / torch.clamp_min(torch.sum(w), 1.0)
    nl = torch.log_softmax(nsp_logits(params, h), -1)
    nsp = -torch.mean(torch.gather(nl, -1,
                                   batch["nsp_label"].long()[:, None])[:, 0])
    return mlm + nsp, (mlm, nsp)


_HEADS = ("mlm_dense", "mlm_dense_b", "mlm_ln_scale", "mlm_ln_bias",
          "mlm_bias", "nsp_w", "nsp_b")


def init_classifier_params(rng, cfg: BertConfig, n_classes: int,
                           pretrained=None, device=None):
    """Task params: the (possibly pretrained) encoder trunk + pooler, with
    a fresh classification head; the MLM/NSP heads are dropped. Reused
    tensors are copied, so the caller's tree stays its own."""
    k_trunk, k_head = tfm.split_generator(rng, 2)
    base = (pretrained if pretrained is not None
            else init_params(k_trunk, cfg, device))
    device = base["embed"].device

    def copy(x):
        return ({k: copy(v) for k, v in x.items()} if isinstance(x, dict)
                else x.clone())

    params = {k: copy(v) for k, v in base.items() if k not in _HEADS}
    params["cls_w"] = tfm._init_normal(k_head, (cfg.d_model, n_classes), 0.02,
                                       device)
    params["cls_b"] = torch.zeros((n_classes,), dtype=torch.float32,
                                  device=device)
    return params


def classify_logits(params, input_ids, segment_ids, cfg: BertConfig,
                    mesh=None, input_mask=None):
    """-> (B, n_classes) f32 logits of the classifier on pooled [CLS]."""
    h = encode(params, input_ids, segment_ids, cfg, mesh, input_mask)
    return _pool(params, h) @ params["cls_w"] + params["cls_b"]


def make_pretrain_step(cfg: BertConfig, mesh=None, lr: float = 1e-4):
    """Returns ``step(params, opt_state, batch) -> (loss, (mlm, nsp),
    params, opt_state)``: ``pretrain_loss``'s gradient and one AdamW
    update. The step updates ``params`` and ``opt_state``'s ``m`` and ``v``
    in place, as the reference donates its buffers. A mesh raises
    ``NotImplementedError``."""
    tfm._check_train_options(cfg.trunk(), mesh)

    def step(params, opt_state, batch):
        (loss, parts), grads = tfm.value_and_grad(
            pretrain_loss, params, batch, cfg, mesh, has_aux=True)
        params, opt_state = tfm.adamw_update(params, grads, opt_state, lr=lr)
        return loss, parts, params, opt_state

    return step


def make_finetune_step(cfg: BertConfig, lr: float = 2e-5, mesh=None):
    """Returns ``step(params, opt_state, batch{input_ids, segment_ids,
    label, [input_mask]}) -> (loss, acc, params, opt_state)`` for the
    classifier params of ``init_classifier_params``; params and optimizer
    state are updated in place, as in ``make_pretrain_step``."""
    tfm._check_train_options(cfg.trunk(), mesh)

    def loss_fn(params, batch):
        logits = classify_logits(params, batch["input_ids"],
                                 batch["segment_ids"], cfg, mesh,
                                 batch.get("input_mask"))
        label = batch["label"].long()
        lp = torch.log_softmax(logits, -1)
        loss = -torch.mean(torch.gather(lp, -1, label[:, None])[:, 0])
        acc = torch.mean((torch.argmax(logits, -1) == label).float())
        return loss, acc

    def step(params, opt_state, batch):
        (loss, acc), grads = tfm.value_and_grad(loss_fn, params, batch,
                                                has_aux=True)
        params, opt_state = tfm.adamw_update(params, grads, opt_state, lr=lr)
        return loss, acc, params, opt_state

    return step


def batch_from_instances(instances, device=None):
    """Stack rows of the pretrain data pipeline (input_ids, input_mask,
    segment_ids, mlm_positions, mlm_ids, nsp_label) into the batch dict
    ``pretrain_loss`` takes, as tensors on ``device`` (default ``cuda:0``).
    Slot weights come from the position padding (position 0 is always
    [CLS], which the masker never selects, so pos == 0 is a padded slot)."""
    device = resolve_device(device)
    cols = list(zip(*instances))
    ids, mask, seg, pos, mids = (np.stack(c).astype(np.int32)
                                 for c in cols[:5])
    arrays = {"input_ids": ids, "input_mask": mask, "segment_ids": seg,
              "mlm_positions": pos, "mlm_ids": mids,
              "mlm_weights": (pos != 0).astype(np.float32),
              "nsp_label": np.asarray(cols[5], np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


init_opt_state = tfm.init_opt_state
count_params = tfm.count_params
