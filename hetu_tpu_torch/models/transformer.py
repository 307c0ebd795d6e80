"""Transformer trunk, forward and training (counterpart of
``hetu_tpu/models/transformer.py``): the shared block stack of the causal
LM and the bidirectional BERT encoder, with the reference's names,
signatures and parameter layout (a dict whose ``blocks`` entry holds each
per-layer tensor stacked over a leading ``L`` axis).

Params are f32 and cast to ``cfg.dtype`` (bf16 by default) at use; dense
projections are ``torch.matmul`` (the JAX package leaves them to XLA, so
they are not kernels to port) with f32 accumulation, cast back where the
reference casts. Attention runs the ported flash kernels
(``kernels/flash_attention.py``) or the unfused ``dot`` form; the LM loss
runs the ported fused linear+CE kernels (``kernels/fused_ce.py``) or the
materialising form. The token embedding is gathered by
``kernels/embed_grad.py:lookup``, so its gradient is the sorted segment sum
``fused_embed_grad``. ``encode`` is a Python loop over the layers in place
of the reference's ``lax.scan``; under ``cfg.remat`` each block is
recomputed in the backward (``torch.utils.checkpoint``), as
``jax.checkpoint`` does there.

Training: ``init_opt_state``, ``adamw_update`` (the reference's AdamW,
plain PyTorch, as the reference leaves it to XLA) and ``make_train_step``.
Training-time dropout (``cfg.dropout_rate > 0``) takes an integer
``dropout_rng`` in the place of the reference's ``jax.random`` key:
``fold_in`` mixes a layer, site or microbatch index into it where the
reference folds or splits its key, and each mask is drawn by
``_dropout_mask`` from a ``torch.Generator`` on the tensor's device seeded
with that site's value. A mask is a function of its seed alone, so a block
recomputed in the backward (remat) draws the same bits.

The switch top-1 MoE MLP (``n_experts > 0``, ``_moe_mlp``) runs on one
device in the reference's dense formulation: (S, E, cap) dispatch and
combine products, the capacity ``int(capacity_factor * S / E)``, tokens
past an expert's capacity dropped, and the Switch aux loss summed over the
layers into ``encode``'s ``aux_sum``. Not ported, and refused with
``NotImplementedError``: ring attention, any mesh (the ``ep`` sharding of
the experts with it) and ZeRO-1 (slice 8, the parallel slices).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import embed_grad, registry
from ..kernels.flash_attention import flash_attention
from ..kernels.fused_ce import fused_linear_nll, should_fuse
from ..ndarray import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 8
    d_ff: int = 2048
    max_seq_len: int = 1024
    n_experts: int = 0          # 0 = dense MLP; >0 = switch MoE
    capacity_factor: float = 1.25
    dropout_rate: float = 0.0
    dtype: Any = torch.bfloat16  # compute dtype
    remat: bool = True          # recompute each block in the backward
    causal: bool = True         # False = bidirectional encoder (BERT)
    # "auto" picks the fused flash kernel for CUDA tensors when the
    # sequence is a multiple of 128, the unfused dot form otherwise
    attn_impl: str = "auto"     # auto | dot | flash | ring (slice 8)
    # LM loss through the fused linear+CE kernel: "auto" = CUDA tensors;
    # True forces (tests); False always materializes the logits
    fused_lm_ce: Any = "auto"
    post_ln: bool = False       # LN after each residual add (canonical BERT)
    ln_eps: float = 1e-5        # HF BERT uses 1e-12
    gelu_exact: bool = False    # erf gelu (HF "gelu") vs tanh approximation
    attn_proj_bias: bool = False  # biases on the qkv and output projections
    tied_head: bool = False     # LM head shares the token embedding
    norm: str = "layernorm"     # "rmsnorm": Llama family (biases ignored)
    rope: bool = False          # rotary position embeddings on q/k
    rope_theta: float = 10000.0
    mlp: str = "gelu"           # "swiglu": down(silu(gate(x))·up(x))
    n_kv_heads: int = 0         # grouped-query attention: 0 = n_heads
    use_pos_emb: bool = True    # False: no learned position table

    def __post_init__(self):
        if self.mlp == "swiglu" and self.n_experts > 0:
            raise ValueError(
                "mlp='swiglu' with n_experts>0: the MoE expert MLP is "
                "gelu-only — a swiglu config would silently train a "
                "different architecture than requested")

    @property
    def kv_heads(self):
        n = self.n_kv_heads or self.n_heads
        if self.n_heads % n:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {n}")
        return n

    @property
    def head_dim(self):
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def split_generator(rng, n: int) -> list[torch.Generator]:
    """``n`` CPU generators seeded from ``rng`` (a ``torch.Generator`` or
    an int seed): the counterpart of ``jax.random.split``. Same seed, same
    children; the values differ from ``jax.random``'s."""
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator().manual_seed(int(rng))
    seeds = torch.randint(0, 2**62, (n,), generator=rng, device=rng.device)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def _init_normal(gen, shape, scale, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(device)


def init_trunk_params(rng, cfg: TransformerConfig, device=None):
    """The block stack + final norm only. ``init_params`` shares the same
    generator schedule, so a trunk initialized here equals one sliced out
    of it."""
    return _init_trunk(split_generator(rng, 12), cfg, resolve_device(device))


def _init_trunk(ks, cfg: TransformerConfig, device):
    L, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff
    E = cfg.n_experts

    def norm(gen, shape, scale):
        return _init_normal(gen, shape, scale, device)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    qkv_width = (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim
    blocks = {
        "ln1_scale": ones(L, D),
        "ln1_bias": zeros(L, D),
        "wqkv": norm(ks[0], (L, D, qkv_width), 0.02),
        "wo": norm(ks[1], (L, D, D), 0.02 / math.sqrt(2 * L)),
        "ln2_scale": ones(L, D),
        "ln2_bias": zeros(L, D),
    }
    if cfg.attn_proj_bias:
        blocks["bqkv"] = zeros(L, qkv_width)
        blocks["bo"] = zeros(L, D)
    if cfg.mlp == "swiglu":
        blocks["w3"] = norm(ks[8], (L, D, Fd), 0.02)
    if E > 0:
        blocks.update({
            "router": norm(ks[2], (L, D, E), 0.02),
            "w1": norm(ks[3], (L, E, D, Fd), 0.02),
            "b1": zeros(L, E, Fd),
            "w2": norm(ks[4], (L, E, Fd, D), 0.02 / math.sqrt(2 * L)),
            "b2": zeros(L, E, D),
        })
    else:
        blocks.update({
            "w1": norm(ks[3], (L, D, Fd), 0.02),
            "b1": zeros(L, Fd),
            "w2": norm(ks[4], (L, Fd, D), 0.02 / math.sqrt(2 * L)),
            "b2": zeros(L, D),
        })
    return {"blocks": blocks, "lnf_scale": ones(D), "lnf_bias": zeros(D)}


def init_params(rng, cfg: TransformerConfig, device=None):
    """Random params from ``rng`` (a ``torch.Generator`` or an int seed) on
    ``device`` (default ``cuda:0``)."""
    device = resolve_device(device)
    D, V = cfg.d_model, cfg.vocab_size
    ks = split_generator(rng, 12)
    params = _init_trunk(ks, cfg, device)
    params["embed"] = _init_normal(ks[5], (V, D), 0.02, device)
    if cfg.use_pos_emb:
        params["pos"] = _init_normal(ks[6], (cfg.max_seq_len, D), 0.02, device)
    if not cfg.tied_head:
        params["head"] = _init_normal(ks[7], (D, V), 0.02, device)
    return params


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (dp/tp/sp/ep sharding) is not ported to hetu_tpu_torch "
            "yet: it comes with slice 8 (meshes, TP, PP, ZeRO; ROADMAP "
            "Queue 1)")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mm(x, w):
    """``einsum(x, w.astype(x.dtype), preferred_element_type=f32)
    .astype(x.dtype)``: the product in x's dtype, accumulated in f32."""
    return torch.matmul(x, w.to(x.dtype))


def _mm32(x, w):
    """The same product left in f32 (``preferred_element_type=f32`` with no
    cast back): x and w rounded to x's dtype, multiplied in f32."""
    return torch.matmul(x.float(), w.to(x.dtype).float())


_MASK64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A 64-bit seed from ``seed`` and ``data`` (the counterpart of
    ``jax.random.fold_in``): the splitmix64 finalizer over the seed's own
    mix plus the data, so nearby seeds and indices give unrelated
    values."""
    z = (_mix64(int(seed)) + 0x9E3779B97F4A7C15 * (int(data) + 1)) & _MASK64
    return _mix64(z)


def _mix64(z: int) -> int:
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _dropout_mask(shape, rate: float, seed: int, device) -> torch.Tensor:
    """The keep mask of one dropout site: ``True`` with probability
    ``1 - rate``, drawn from a generator on ``device`` seeded with
    ``seed``, so the same seed gives the same bits (the reference's
    ``jax.random.bernoulli(key, 1 - rate, shape)``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def _dropout(x, rate: float, seed):
    """Inverted dropout; identity when rate == 0 or seed is None (eval)."""
    if rate == 0.0 or seed is None:
        return x
    keep = _dropout_mask(x.shape, rate, seed, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _layer_norm(x, scale, bias, eps=1e-5):
    """The reference's f32 LayerNorm cast back to x's dtype, as one
    ``F.layer_norm`` on the f32 input (3 launches on the card, not 10)."""
    return F.layer_norm(x.float(), x.shape[-1:], scale, bias, eps).to(x.dtype)


def _gelu(x, cfg: TransformerConfig):
    # HF BERT's "gelu" is the exact erf form; the reference's default is
    # the tanh approximation
    return F.gelu(x, approximate="none" if cfg.gelu_exact else "tanh")


def _rms_norm(x, scale, eps):
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype)


def _norm(x, scale, bias, cfg: TransformerConfig):
    """LayerNorm (default) or RMSNorm (``bias`` ignored)."""
    if cfg.norm == "rmsnorm":
        return _rms_norm(x, scale, cfg.ln_eps)
    return _layer_norm(x, scale, bias, cfg.ln_eps)


def _rope(x, pos0, theta):
    """Rotary position embeddings, HF rotate_half convention: x (B, nh, T,
    hd) at absolute positions pos0..pos0+T-1."""
    B, nh, T, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    t = pos0 + torch.arange(T, dtype=torch.float32, device=x.device)
    freqs = torch.outer(t, inv)                       # (T, hd/2)
    cos = torch.cat([torch.cos(freqs)] * 2, -1)       # (T, hd)
    sin = torch.cat([torch.sin(freqs)] * 2, -1)
    x32 = x.float()
    x1, x2 = x32[..., :hd // 2], x32[..., hd // 2:]
    rotated = torch.cat([-x2, x1], -1)
    return (x32 * cos + rotated * sin).to(x.dtype)


def _is_key_padding_bias(attn_bias):
    """A (B, 1, 1, T) additive bias is per key (the padding-mask form BERT
    builds from input_mask): the flash kernel folds it into its scores.
    Any other bias shape needs the unfused path."""
    return (attn_bias is not None and attn_bias.dim() == 4
            and attn_bias.shape[1] == 1 and attn_bias.shape[2] == 1)


def _resolve_attn_impl(cfg: TransformerConfig, mesh, T, attn_bias=None,
                       device=None):
    """The reference's rule with the card in the TPU's place: ``auto``
    picks ``flash`` for CUDA tensors when T % 128 == 0, else ``dot``."""
    impl = cfg.attn_impl
    if attn_bias is not None and not _is_key_padding_bias(attn_bias):
        if impl not in ("auto", "dot"):
            warnings.warn(
                f"attn_impl={impl!r} requested but a non-key-padding "
                "attn_bias is present: falling back to the unfused 'dot' "
                "path", stacklevel=3)
        return "dot"
    if attn_bias is not None and impl == "flash" and T % min(128, T):
        warnings.warn(
            f"attn_impl='flash' with a padding mask needs seq_len divisible "
            f"by 128 (got {T}): falling back to the unfused 'dot' path",
            stacklevel=3)
        return "dot"
    if impl != "auto":
        return impl
    _no_mesh(mesh)   # the reference's sp > 1 -> "ring" rule needs a mesh
    if device is not None and torch.device(device).type == "cuda" \
            and T % 128 == 0:
        return "flash"
    return "dot"


def _attention_core(q, k, v, cfg: TransformerConfig, mesh, impl,
                    attn_bias=None):
    """q/k/v: (B, nh, T, hd) -> (B, nh, T, hd). ``flash``: the ported
    online-softmax kernel, folding a key-padding ``attn_bias`` (B, 1, 1, T)
    into its scores; ``dot``: the unfused reference form, any additive
    ``attn_bias``; ``ring`` is not ported (the reference runs it only over
    a mesh's ``sp`` axis)."""
    if impl == "ring":
        raise NotImplementedError(
            "attn_impl='ring' (sequence-parallel ring attention) is not "
            "ported to hetu_tpu_torch yet: it comes with slice 8 and the "
            "mesh's sp axis (meshes, TP, PP, ZeRO; ROADMAP Queue 1)")
    hd = q.shape[-1]
    if impl == "flash":
        kb = None
        if attn_bias is not None:
            # (B, 1, 1, T) -> the (B, T) per-key form; a broadcast-batch
            # (1, 1, 1, T) mask expands to the real batch
            kb = attn_bias.reshape(attn_bias.shape[0], attn_bias.shape[-1])
            if kb.shape[0] == 1 and q.shape[0] > 1:
                kb = kb.expand(q.shape[0], kb.shape[1])
            kb = kb.float().contiguous()
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               cfg.causal, k_bias=kb)
    T = q.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    if cfg.causal:
        pos = torch.arange(T, device=q.device)
        scores = torch.where(pos[None, :] <= pos[:, None], scores, -1e30)
    if attn_bias is not None:
        scores = scores + attn_bias.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _attention(h, p, cfg: TransformerConfig, mesh, attn_bias=None):
    B, T, D = h.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    nkv = cfg.kv_heads
    impl = _resolve_attn_impl(cfg, mesh, T, attn_bias, device=h.device)
    qkv = _mm(h, p["wqkv"])
    if cfg.attn_proj_bias:
        qkv = qkv + p["bqkv"].to(h.dtype)
    q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    q = q.reshape(B, T, nh, hd).transpose(1, 2)
    k = k.reshape(B, T, nkv, hd).transpose(1, 2)
    v = v.reshape(B, T, nkv, hd).transpose(1, 2)
    if cfg.rope:
        # rotate before any gqa broadcast (rope is per kv head)
        q = _rope(q, 0, cfg.rope_theta)
        k = _rope(k, 0, cfg.rope_theta)
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
    out = _attention_core(q, k, v, cfg, mesh, impl, attn_bias)
    out = _mm(out.transpose(1, 2).reshape(B, T, D), p["wo"])
    if cfg.attn_proj_bias:
        out = out + p["bo"].to(h.dtype)
    return out


def _dense_mlp(h, p, cfg, mesh):
    if cfg.mlp == "swiglu":
        # Llama MLP: down(silu(gate(x)) * up(x)); b1/b2 exist but are unused
        gate = _mm32(h, p["w1"])
        up = _mm32(h, p["w3"])
        return _mm((F.silu(gate) * up).to(h.dtype), p["w2"])
    u = _gelu(_mm(h, p["w1"]) + p["b1"].to(h.dtype), cfg)
    return _mm(u, p["w2"]) + p["b2"].to(h.dtype)


def moe_route(x, router, cfg: TransformerConfig):
    """The switch router over x (S, D): ``(probs (S, E) f32, gate (S,),
    expert (S,), onehot (S, E) int64, pos (S,), keep (S,), cap)``. Each
    token goes to its argmax expert (ties to the first index) at the next
    free slot ``pos`` of that expert's buffer of ``cap`` slots; ``keep`` is
    False for a token past the capacity, which is dropped."""
    S = x.shape[0]
    E = cfg.n_experts
    cap = max(1, int(cfg.capacity_factor * S / E))
    probs = torch.softmax(x.float() @ router.float(), -1)
    gate, expert = torch.amax(probs, -1), torch.argmax(probs, -1)
    # the position within the expert's buffer, counted in integers
    onehot = F.one_hot(expert, E)
    pos = (torch.cumsum(onehot, 0) * onehot).amax(-1) - 1
    return probs, gate, expert, onehot, pos, pos < cap, cap


def _moe_mlp(h, p, cfg: TransformerConfig, mesh):
    """Switch-style top-1 MoE with capacity, on one device (``moe_route``);
    a dropped token is a zero row of the dispatch, so it adds nothing.
    Returns ``(out (B, T, D), the Switch aux loss)``."""
    B, T, D = h.shape
    E = cfg.n_experts
    x = h.reshape(B * T, D)
    probs, gate, _, onehot, pos, keep, cap = moe_route(x, p["router"], cfg)
    # (pos == slot) is all-zero past the capacity (jax.nn.one_hot's row
    # for an index out of range), and keep masks it explicitly as the
    # reference does
    slot = pos[:, None] == torch.arange(cap, device=x.device)
    dispatch = (onehot.to(x.dtype)[:, :, None] * slot.to(x.dtype)[:, None, :]
                * keep[:, None, None].to(x.dtype))           # (S, E, cap)
    expert_in = torch.einsum("sec,sd->ecd", dispatch, x)     # (E, cap, D)
    u = _gelu(_mm(expert_in, p["w1"]) + p["b1"][:, None, :].to(x.dtype), cfg)
    y = _mm(u, p["w2"]) + p["b2"][:, None, :].to(x.dtype)   # (E, cap, D)
    combine = dispatch * gate[:, None, None].to(x.dtype)
    out = torch.einsum("sec,ecd->sd", combine, y)
    # aux load-balancing loss (Switch Transformer eq. 4)
    density = onehot.float().mean(0)
    density_proxy = probs.mean(0)
    aux = E * torch.sum(density * density_proxy)
    return out.reshape(B, T, D), aux


def _block(h, layer_params, cfg: TransformerConfig, mesh, attn_bias=None,
           dropout_rng=None):
    """One transformer block. Pre-LN (default): LN -> sublayer ->
    residual. Post-LN (``cfg.post_ln``): sublayer -> residual -> LN.
    ``dropout_rng`` (an integer seed, the layer's fold): dropout on the
    attention output (site 0) and the MLP output (site 1), the reference's
    ``split`` of its key into two.

    Any dialect knob added here must be mirrored in
    ``generate._decode_layer``, the KV-cache form of this block (decoding
    refuses the MoE, as the reference's does). Returns ``(h, aux)``: the
    MoE's aux loss, 0 for a dense MLP."""
    post = cfg.post_ln
    attn_in = h if post else _norm(
        h, layer_params["ln1_scale"], layer_params["ln1_bias"], cfg)
    attn_out = _attention(attn_in, layer_params, cfg, mesh, attn_bias)
    if dropout_rng is not None:
        attn_out = _dropout(attn_out, cfg.dropout_rate,
                            fold_in(dropout_rng, 0))
    h = h + attn_out
    if post:
        h = _norm(h, layer_params["ln1_scale"], layer_params["ln1_bias"], cfg)
    mlp_in = h if post else _norm(
        h, layer_params["ln2_scale"], layer_params["ln2_bias"], cfg)
    if cfg.n_experts > 0:
        out, aux = _moe_mlp(mlp_in, layer_params, cfg, mesh)
    else:
        out = _dense_mlp(mlp_in, layer_params, cfg, mesh)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if dropout_rng is not None:
        out = _dropout(out, cfg.dropout_rate, fold_in(dropout_rng, 1))
    h = h + out
    if post:
        h = _norm(h, layer_params["ln2_scale"], layer_params["ln2_bias"], cfg)
    return h, aux


def embed_tokens(params, tokens, cfg: TransformerConfig):
    """(..., T) integer tokens -> (..., T, D) embeddings (+ learned
    positions, unless the dialect carries positions via rope)."""
    T = tokens.shape[-1]
    h = embed_grad.lookup(params["embed"], tokens).to(cfg.dtype)
    if cfg.use_pos_emb:
        h = h + params["pos"][:T].to(cfg.dtype)
    return h


def head_matrix(params, cfg: TransformerConfig):
    """The (D, V) vocab projection as ``lm_head``'s ``_mm32`` multiplies
    it: rounded to ``cfg.dtype``, then widened to f32."""
    w = params["embed"].t() if cfg.tied_head else params["head"]
    return w.to(cfg.dtype).float()


def lm_head(params, h, cfg: TransformerConfig, head=None):
    """Final norm (pre-LN only) + vocab projection -> f32 logits. ``head``:
    ``head_matrix(params, cfg)`` made once by a caller that applies the
    head many times (a decoder); by default it is formed at this call."""
    if not cfg.post_ln:
        h = _norm(h, params["lnf_scale"], params["lnf_bias"], cfg)
    if head is None:
        head = head_matrix(params, cfg)
    return torch.matmul(h.float(), head)


def nll_loss(logits, targets):
    logp = torch.log_softmax(logits.float(), -1)
    return torch.mean(-torch.gather(logp, -1, targets.long()[..., None])[..., 0])


def encode(params, h, cfg: TransformerConfig, mesh: Optional[Any] = None,
           attn_bias=None, dropout_rng=None):
    """Run the block stack on embedded input h (B, T, D) -> (h, aux_sum).
    ``attn_bias`` (a padding mask) is the same for every layer. With
    ``cfg.remat`` and gradients enabled, each block keeps only its inputs
    and is recomputed in the backward, under the kernel mode of this call
    (``registry.bind``). ``dropout_rng``: an integer seed for
    training-time dropout when ``cfg.dropout_rate > 0``, folded with each
    layer's index; omit it for deterministic eval. The masks are drawn
    inside the block from seeds alone, so the recompute draws the same
    bits (no generator state crosses the checkpoint)."""
    _no_mesh(mesh)
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    # one unbind per stacked tensor: its backward stacks the L layer
    # gradients once, where indexing x[li] would zero-fill and add a whole
    # (L, ...) gradient per layer
    names = list(params["blocks"])
    layers = zip(*(params["blocks"][n].unbind(0) for n in names))
    remat = cfg.remat and torch.is_grad_enabled()
    block = registry.bind(lambda h, layer_params, rng: _block(
        h, layer_params, cfg, mesh, attn_bias=attn_bias, dropout_rng=rng))

    for li, layer in enumerate(layers):
        layer_params = dict(zip(names, layer))
        rng = None if dropout_rng is None else fold_in(dropout_rng, li)
        if remat:
            h, aux = checkpoint(block, h, layer_params, rng,
                                use_reentrant=False)
        else:
            h, aux = block(h, layer_params, rng)
        aux_sum = aux_sum + aux
    return h, aux_sum


def forward_hidden(params, tokens, cfg: TransformerConfig, mesh=None,
                   dropout_rng=None):
    """tokens (B, T) -> (hidden (B, T, D), aux) before the LM head."""
    h = embed_tokens(params, tokens, cfg)
    return encode(params, h, cfg, mesh, dropout_rng=dropout_rng)


def forward(params, tokens, cfg: TransformerConfig, mesh=None,
            dropout_rng=None):
    """tokens (B, T) -> logits (B, T, V)."""
    h, aux_sum = forward_hidden(params, tokens, cfg, mesh,
                                dropout_rng=dropout_rng)
    return lm_head(params, h, cfg), aux_sum


def loss_fn(params, tokens, targets, cfg: TransformerConfig, mesh=None,
            aux_weight=0.01, dropout_rng=None):
    if should_fuse(cfg.fused_lm_ce, mesh, params["embed"].device):
        # the (B*T, V) logits never exist; the head keeps its native
        # orientation (tied: the (V, D) embedding; untied: the (D, V) head)
        h, aux = forward_hidden(params, tokens, cfg, mesh,
                                dropout_rng=dropout_rng)
        if not cfg.post_ln:
            h = _norm(h, params["lnf_scale"], params["lnf_bias"], cfg)
        B, T, D = h.shape
        if cfg.tied_head:
            w, layout = params["embed"].to(h.dtype), "vd"
        else:
            w, layout = params["head"].to(h.dtype), "dv"
        V = w.shape[0] if layout == "vd" else w.shape[1]
        per = fused_linear_nll(
            h.reshape(B * T, D), w,
            torch.zeros((V,), dtype=torch.float32, device=h.device),
            targets.reshape(-1), w_layout=layout)
        return torch.mean(per) + aux_weight * aux
    logits, aux = forward(params, tokens, cfg, mesh, dropout_rng=dropout_rng)
    return nll_loss(logits, targets) + aux_weight * aux


# ---------------------------------------------------------------------------
# train step: AdamW, params and optimizer state updated in place
# ---------------------------------------------------------------------------

def count_params(params) -> int:
    """Total parameter count of a (nested dict) params tree."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())


def tree_leaves(tree, with_paths=False, _prefix="") -> list:
    """The tensors of a nested dict, in key order; with ``with_paths``,
    ``(path, tensor)`` pairs, the path as ``/blocks/wq``."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k], with_paths,
                                                      f"{_prefix}/{k}")]
    return [(_prefix, tree) if with_paths else tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def value_and_grad(fn, params, *args, has_aux=False, **kwargs):
    """``jax.value_and_grad(fn, has_aux=has_aux)(params, *args)``:
    ``(value, grads)``, where ``value`` is ``fn``'s output (with its aux
    when ``has_aux``) and ``grads`` mirrors ``params``. A tensor the loss
    does not reach gets a zero gradient, as in JAX. ``params`` are read
    through leaves that share their storage, so the caller's tensors are
    neither copied nor marked as requiring grad."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        out = fn(leaves, *args, **kwargs)
        loss = out[0] if has_aux else out
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return _detach(out), tree_map(lambda _: next(it), leaves)


def _detach(x):
    if isinstance(x, tuple):
        return tuple(_detach(y) for y in x)
    return x.detach()


def init_opt_state(params):
    """AdamW state: zero ``m`` and ``v`` shaped like ``params``, and the
    step count ``t`` as a 0-d f32 tensor on the params' device."""
    device = tree_leaves(params)[0].device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.float32, device=device)}


@torch.no_grad()
def adamw_update(params, grads, opt_state, lr=1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, wd=0.01):
    """The reference's AdamW: ``t += 1``; ``m = b1·m + (1−b1)·g``;
    ``v = b2·v + (1−b2)·g²``; ``p −= lr·(m̂/(√v̂ + eps) + wd·p)`` with
    ``m̂ = m/(1−b1^t)``, ``v̂ = v/(1−b2^t)``. Updates ``params`` and the
    state's ``m`` and ``v`` in place (the reference donates them) with
    ``torch._foreach_*`` ops, and returns ``(params, opt_state)`` with a
    new ``t``."""
    ps, gs = tree_leaves(params), tree_leaves(grads)
    ms, vs = tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])
    t = opt_state["t"] + 1.0
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
    upd = torch._foreach_div(ms, 1 - b1 ** t)
    denom = torch._foreach_div(vs, 1 - b2 ** t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(upd, denom)
    torch._foreach_add_(upd, ps, alpha=wd)
    torch._foreach_add_(ps, upd, alpha=-lr)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "t": t}


def _check_train_options(cfg, mesh, zero1=False):
    _no_mesh(mesh)
    if zero1:
        raise NotImplementedError(
            "zero1=True (optimizer state sharded over a dp mesh) is not "
            "ported to hetu_tpu_torch yet: it comes with slice 8 (meshes, "
            "TP, PP, ZeRO; ROADMAP Queue 1)")


def make_train_step(cfg: TransformerConfig, mesh=None, lr=1e-3,
                    accum_steps: int = 1, zero1: bool = False):
    """Returns ``step(params, opt_state, tokens, targets) -> (loss, params,
    opt_state)``: ``loss_fn``'s gradient and one ``adamw_update``.

    State rule: the step updates ``params`` and ``opt_state``'s ``m`` and
    ``v`` in place and returns them, as the reference donates its buffers;
    keep a copy of anything you need from before the step.

    ``accum_steps > 1``: tokens/targets carry a leading accumulation axis
    (A, B, T); the microbatches' losses and gradients are averaged, in a
    Python loop, before the single optimizer update.

    ``cfg.dropout_rate > 0``: the step takes a trailing ``dropout_rng``, an
    integer seed (pass a fresh one each step); a missing one raises. Each
    accumulation microbatch folds in its index, as the reference does.
    With no dropout the step keeps the 4-argument signature.

    A mesh and ``zero1=True`` raise ``NotImplementedError`` (slice 8)."""
    _check_train_options(cfg, mesh, zero1)
    use_dropout = cfg.dropout_rate > 0.0

    def step(params, opt_state, tokens, targets, dropout_rng=None):
        if use_dropout and dropout_rng is None:
            # a forgotten key must not silently train without dropout
            raise ValueError("cfg.dropout_rate > 0: pass dropout_rng to "
                             "the train step")
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, tokens, targets,
                                         cfg, mesh, dropout_rng=dropout_rng)
        else:
            if tokens.shape[0] != accum_steps:
                raise ValueError(f"leading (accumulation) axis "
                                 f"{tokens.shape[0]} != accum_steps "
                                 f"{accum_steps}")
            loss, grads = None, None
            for mi in range(accum_steps):
                rng = (None if dropout_rng is None
                       else fold_in(dropout_rng, mi))
                l, g = value_and_grad(loss_fn, params, tokens[mi],
                                      targets[mi], cfg, mesh,
                                      dropout_rng=rng)
                if grads is None:
                    loss, grads = l, g
                else:
                    loss = loss + l
                    torch._foreach_add_(tree_leaves(grads), tree_leaves(g))
            loss = loss / accum_steps
            torch._foreach_div_(tree_leaves(grads), accum_steps)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
        return loss, params, opt_state

    if use_dropout:
        return step
    return lambda params, opt_state, tokens, targets: step(
        params, opt_state, tokens, targets)
