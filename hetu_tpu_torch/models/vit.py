"""Vision Transformer on the trunk (counterpart of
``hetu_tpu/models/vit.py``): the block stack of ``models/transformer.py``
under a patch-embedding front end, HF-compatible.

Architecturally HF ViT is the trunk's pre-LN dialect with projection
biases (``layernorm_before`` -> ln1 before attention, ``layernorm_after``
-> ln2 before the MLP, erf gelu, eps 1e-12, final LayerNorm -> lnf), so
``models/hf_vit.py`` loads ``transformers`` ViT checkpoints weight for
weight. The stride-P patch conv is exactly a linear map over
non-overlapping patches: ``patchify`` and one matmul.

Attention: ViT-B/16's sequence is 197 (196 patches and [CLS]), not a
multiple of 128, so ``attn_impl="auto"`` takes the unfused ``dot`` form on
the card, as the reference does off the TPU; the sequence is not padded to
reach the flash kernel. Training (``make_train_step``) uses the trunk's
AdamW and updates params and optimizer state in place. ``param_specs`` is
mesh code and comes with the parallel slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import transformer as tfm
from ..ndarray import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    n_channels: int = 3
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    n_classes: int = 0          # 0 = no classification head
    dtype: Any = torch.float32
    remat: bool = False
    attn_impl: str = "auto"
    # canonical ViT dialect (HF-compatible); the trunk stays pre-LN
    ln_eps: float = 1e-12
    gelu_exact: bool = True

    @property
    def n_patches(self) -> int:
        assert self.image_size % self.patch_size == 0
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.n_patches + 1   # + [CLS]

    def trunk(self) -> tfm.TransformerConfig:
        return tfm.TransformerConfig(
            vocab_size=2,            # unused (no token embedding)
            d_model=self.d_model, n_heads=self.n_heads,
            n_layers=self.n_layers, d_ff=self.d_ff,
            max_seq_len=self.seq_len, dtype=self.dtype, remat=self.remat,
            attn_impl=self.attn_impl, causal=False,
            ln_eps=self.ln_eps, gelu_exact=self.gelu_exact,
            attn_proj_bias=True)


VIT_BASE = ViTConfig()


def init_params(rng, cfg: ViTConfig, device=None):
    """Random params from ``rng`` (a ``torch.Generator`` or an int seed) on
    ``device`` (default ``cuda:0``), in the reference's layout: blocks and
    final norm only, no token embedding, position table or LM head."""
    device = resolve_device(device)
    D = cfg.d_model
    pdim = cfg.patch_size * cfg.patch_size * cfg.n_channels
    ks = tfm.split_generator(rng, 5)
    trunk = tfm.init_trunk_params(ks[0], cfg.trunk(), device)

    def normal(gen, shape):
        return tfm._init_normal(gen, shape, 0.02, device)

    params = {
        "patch_w": normal(ks[1], (pdim, D)),
        "patch_b": torch.zeros((D,), dtype=torch.float32, device=device),
        "cls_token": normal(ks[2], (1, 1, D)),
        "pos": normal(ks[3], (cfg.seq_len, D)),
        "blocks": trunk["blocks"],
        "lnf_scale": trunk["lnf_scale"],
        "lnf_bias": trunk["lnf_bias"],
    }
    if cfg.n_classes:
        params["cls_w"] = normal(ks[4], (D, cfg.n_classes))
        params["cls_b"] = torch.zeros((cfg.n_classes,), dtype=torch.float32,
                                      device=device)
    return params


def patchify(images, cfg: ViTConfig):
    """images (B, C, H, W) -> (B, N, P*P*C) non-overlapping patches, each
    flattened in (c, ph, pw) order: the stride-P conv's receptive field
    layout, so HF conv kernels map onto ``patch_w`` by pure reshape."""
    B, C, H, W = images.shape
    Ps = cfg.patch_size
    x = images.reshape(B, C, H // Ps, Ps, W // Ps, Ps)
    x = x.permute(0, 2, 4, 1, 3, 5)            # (B, gh, gw, C, Ps, Ps)
    return x.reshape(B, (H // Ps) * (W // Ps), C * Ps * Ps)


def encode(params, images, cfg: ViTConfig, mesh=None):
    """images (B, C, H, W) f32 -> final hidden states (B, N+1, D) after
    the final LayerNorm ([CLS] first, as in HF)."""
    B = images.shape[0]
    patches = patchify(images.float(), cfg)
    # f32 patches times the weight rounded to cfg.dtype, summed in f32
    w = params["patch_w"].to(cfg.dtype).float()
    h = (torch.matmul(patches, w) + params["patch_b"]).to(cfg.dtype)
    cls = params["cls_token"].to(cfg.dtype).expand(B, 1, cfg.d_model)
    h = torch.cat([cls, h], dim=1)
    h = h + params["pos"].to(cfg.dtype)[None]
    h, _aux = tfm.encode(params, h, cfg.trunk(), mesh)
    return tfm._layer_norm(h, params["lnf_scale"], params["lnf_bias"],
                           cfg.ln_eps)


def classify_logits(params, images, cfg: ViTConfig, mesh=None):
    """-> (B, n_classes) f32 from the [CLS] hidden state (HF's
    ViTForImageClassification head: the classifier on hidden[:, 0])."""
    h = encode(params, images, cfg, mesh)
    return h[:, 0, :].float() @ params["cls_w"] + params["cls_b"]


def make_train_step(cfg: ViTConfig, lr: float = 1e-3, mesh=None):
    """Returns ``step(params, opt_state, images, labels) -> (loss, acc,
    params, opt_state)``: the classifier's cross entropy, its gradient and
    one AdamW update, params and optimizer state updated in place (the
    reference donates them). A mesh raises ``NotImplementedError``."""
    assert cfg.n_classes > 0, "training needs a classification head"
    tfm._check_train_options(cfg.trunk(), mesh)

    def loss_fn(params, images, labels):
        logits = classify_logits(params, images, cfg, mesh)
        lp = torch.log_softmax(logits, -1)
        labels = labels.long()
        loss = -torch.mean(torch.gather(lp, -1, labels[:, None])[:, 0])
        acc = torch.mean((torch.argmax(logits, -1) == labels).float())
        return loss, acc

    def step(params, opt_state, images, labels):
        (loss, acc), grads = tfm.value_and_grad(loss_fn, params, images,
                                                labels, has_aux=True)
        params, opt_state = tfm.adamw_update(params, grads, opt_state, lr=lr)
        return loss, acc, params, opt_state

    return step


init_opt_state = tfm.init_opt_state
count_params = tfm.count_params
