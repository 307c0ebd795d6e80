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

The switch top-1 MoE MLP (``n_experts > 0``, ``_moe_mlp``) runs in the
reference's dense formulation: (S, E, cap) dispatch and combine products,
the capacity ``int(capacity_factor * S / E)`` over the global batch, tokens
past an expert's capacity dropped, and the Switch aux loss summed over the
layers into ``encode``'s ``aux_sum``.

Meshes (``parallel/mesh.py``). ``make_train_step(cfg, mesh)`` takes the
global batch on every rank and runs this rank's share of it: its dp
coordinate's contiguous rows and, under sp, its chunk of each sequence
(rows ``s·T/sp .. (s+1)·T/sp``); the gradients are averaged over the data
ranks (dp × sp) and AdamW applied; with ``zero1=True`` each rank keeps and
updates only its shard (over dp) of ``m`` and ``v``
(``shard_first_free_dim``'s layout) and the updated params are
all-gathered. The params are this rank's slice (``shard_params``):
Megatron's tp (``wqkv``, ``w1``, ``w3`` column-parallel behind
``multihost.copy_to``; ``wo``, ``w2`` row-parallel with
``multihost.reduce_from``; the embedding and positions split on D and
their looked-up columns all-gathered; the untied head split on V with a
vocab-parallel NLL, the tied head on the embedding's D split), the
experts over ep (``_moe_mlp``: no token moves, the ep ranks sum their
outputs). ``wqkv`` is split by heads, so each rank's q, k and v are its own
heads'; where tp does not divide ``kv_heads`` the ranks of a query group
hold its kv head and ``sum_shared_kv_`` sums that column's gradient.
Attention under sp is ring attention (``parallel/ring_attention.py``) for
``auto``; positions are absolute. A rank's loss counts once over tp and
ep (each rank of those groups computes the same value) and its gradients
are averaged over the data ranks; the collectives' backwards are written
for that rule. Under a mesh a dropout mask is drawn over the whole batch
and each rank keeps its rows and chunk (``batch_share``), so the masks do
not depend on the mesh. A mesh keeps the unfused LM head, as the
reference does.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
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
from ..parallel import mesh as meshlib
from ..parallel import multihost


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
    attn_impl: str = "auto"     # auto | dot | flash | ring
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
    if torch.device(device).type == "meta":      # shapes only
        return torch.empty(shape, dtype=torch.float32, device="meta")
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


def param_specs(cfg: TransformerConfig):
    """Each parameter's partition spec, a tuple naming the mesh axis that
    splits each dimension (None: whole), as the reference's: Megatron tp,
    experts over ep, the rest whole. ``shard_params`` cuts each rank's
    slice by them (``wqkv``/``bqkv`` by heads); ZeRO-1's slot layout
    (``shard_first_free_dim``) reads them to find each slot's dp
    dimension."""
    moe = cfg.n_experts > 0
    blocks = {"ln1_scale": (None, None), "ln1_bias": (None, None),
              "wqkv": (None, None, "tp"), "wo": (None, "tp", None),
              "ln2_scale": (None, None), "ln2_bias": (None, None)}
    if cfg.attn_proj_bias:
        blocks["bqkv"] = (None, "tp")
        blocks["bo"] = (None, None)
    if cfg.mlp == "swiglu":
        blocks["w3"] = (None, None, "tp")
    if moe:
        blocks.update({"router": (None, None, None),
                       "w1": (None, "ep", None, "tp"),
                       "b1": (None, "ep", "tp"),
                       "w2": (None, "ep", "tp", None),
                       "b2": (None, "ep", None)})
    else:
        blocks.update({"w1": (None, None, "tp"), "b1": (None, "tp"),
                       "w2": (None, "tp", None), "b2": (None, None)})
    specs = {"embed": (None, "tp"), "blocks": blocks, "lnf_scale": (None,),
             "lnf_bias": (None,)}
    if cfg.use_pos_emb:
        specs["pos"] = (None, "tp")
    if not cfg.tied_head:
        specs["head"] = (None, "tp")
    return specs


# ---------------------------------------------------------------------------
# the Megatron layout: each rank's slice of the params
# ---------------------------------------------------------------------------

def head_layout(cfg: TransformerConfig, tp: int, t: int):
    """``(q0, nq, kv_lo, kv_hi)``: tp rank ``t`` holds query heads ``q0 ..
    q0 + nq - 1`` and the kv heads ``kv_lo .. kv_hi - 1`` they read. Where
    tp divides ``kv_heads`` those are ``kv_heads / tp`` heads of its own;
    where it does not (MQA/GQA with fewer kv heads than tp ranks), the kv
    head a query group reads is held by every rank of that group."""
    nh, g = cfg.n_heads, cfg.n_heads // cfg.kv_heads
    if nh % tp:
        raise ValueError(f"n_heads {nh} is not divisible by tp {tp}")
    nq = nh // tp
    q0 = t * nq
    return q0, nq, q0 // g, (q0 + nq - 1) // g + 1


def qkv_columns(cfg: TransformerConfig, tp: int, t: int) -> torch.Tensor:
    """The columns of the fused ``wqkv`` (and ``bqkv``) that tp rank ``t``
    holds: its query heads' q columns, then its kv heads' k and v columns.

    The port splits the fused projection by heads, so each rank's q, k and
    v are its own heads'; the reference's spec ``P(None, None, "tp")``
    splits it contiguously and GSPMD reshuffles that. Gathered back, both
    are the same tensor."""
    q0, nq, lo, hi = head_layout(cfg, tp, t)
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.kv_heads
    return torch.cat([torch.arange(q0 * hd, (q0 + nq) * hd),
                      nh * hd + torch.arange(lo * hd, hi * hd),
                      (nh + nkv) * hd + torch.arange(lo * hd, hi * hd)])


def kv_expand(cfg: TransformerConfig, tp: int, t: int, device):
    """Each of rank ``t``'s query heads' kv head, as an index into its own
    kv heads (None where they map one to one)."""
    q0, nq, lo, hi = head_layout(cfg, tp, t)
    if hi - lo == nq:
        return None
    g = cfg.n_heads // cfg.kv_heads
    return (torch.arange(q0, q0 + nq) // g - lo).to(device)


_QKV = ("wqkv", "bqkv")
_SPLIT_AXES = ("tp", "ep")


def _split(x, spec, name, cfg, mesh, gather=False):
    """``x``'s slice on this rank (``gather``: the inverse, this rank's
    slice made whole by an all-gather over each splitting axis)."""
    for ax, part in enumerate(tuple(spec)):
        if part not in _SPLIT_AXES:
            continue
        n = meshlib.axis_size(mesh, part)
        if n == 1:
            continue
        r = meshlib.axis_rank(mesh, part)
        if part == "tp" and name in _QKV:
            if gather:
                pieces = multihost.all_gather(x.contiguous(),
                                              meshlib.axis_group(mesh, "tp"))
                shape = list(x.shape)
                shape[ax] = (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim
                full = torch.zeros(shape, dtype=x.dtype, device=x.device)
                for j, piece in enumerate(pieces):
                    full.index_copy_(ax, qkv_columns(cfg, n, j).to(
                        x.device), piece)
                x = full
            else:
                x = x.index_select(ax, qkv_columns(cfg, n, r).to(x.device))
            continue
        if gather:
            x = torch.cat(multihost.all_gather(
                x.contiguous(), meshlib.axis_group(mesh, part)), ax)
        else:
            if x.shape[ax] % n:
                raise ValueError(f"{name}: dimension {ax} of "
                                 f"{tuple(x.shape)} is not divisible by "
                                 f"{part}={n}")
            k = x.shape[ax] // n
            x = x.narrow(ax, r * k, k)
    return x.contiguous() if gather else x.contiguous().clone()


def _map_specs(fn, params, specs, cfg, mesh):
    def go(node, spec, name):
        if isinstance(node, dict):
            return {k: go(v, spec[k], k) for k, v in node.items()}
        return fn(node, spec, name, cfg, mesh)
    return go(params, specs, "")


def shard_params(params, cfg: TransformerConfig, mesh, specs=None):
    """This rank's slice of the whole ``params`` (a new tree): each tensor
    cut on the dimensions its spec (``specs``, default ``param_specs(cfg)``)
    splits over ``tp`` or ``ep``, ``wqkv``/``bqkv`` by heads
    (``qkv_columns``). dp, sp and pp split no parameter here (a pipeline
    stage takes its blocks in ``pipeline.init_pipeline_params``)."""
    return _map_specs(_split, params, specs or param_specs(cfg), cfg, mesh)


def gather_params(params, cfg: TransformerConfig, mesh, specs=None):
    """The inverse of ``shard_params``: every rank's slices made whole, by
    all-gathers over tp and ep (every rank of those groups calls it)."""
    return _map_specs(functools.partial(_split, gather=True), params,
                      specs or param_specs(cfg), cfg, mesh)


def sum_shared_kv_(grads, cfg: TransformerConfig, mesh) -> None:
    """Where tp ranks share a kv head (tp does not divide ``kv_heads``),
    each holds its query heads' part of that column's gradient: sum the k/v
    columns of ``wqkv``/``bqkv`` over the ranks that hold them, in place
    (one all-reduce over tp of the whole kv width, each rank's columns
    scattered into it)."""
    tp, t = meshlib.axis_size(mesh, "tp"), meshlib.axis_rank(mesh, "tp")
    if tp == 1 or cfg.kv_heads % tp == 0:
        return
    q0, nq, lo, hi = head_layout(cfg, tp, t)
    hd, nkv = cfg.head_dim, cfg.kv_heads
    nql, nkl = nq * hd, (hi - lo) * hd
    cols = torch.cat([torch.arange(lo * hd, hi * hd),
                      nkv * hd + torch.arange(lo * hd, hi * hd)])
    for name in _QKV:
        g = grads["blocks"].get(name)
        if g is None:
            continue
        kv = g.narrow(-1, nql, 2 * nkl)
        full = torch.zeros(g.shape[:-1] + (2 * nkv * hd,), dtype=torch.float32,
                           device=g.device)
        full.index_copy_(-1, cols.to(g.device), kv.float())
        full = multihost._sum(full, meshlib.axis_group(mesh, "tp"))
        kv.copy_(full.index_select(-1, cols.to(g.device)))


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


# (r, n, sr, sn): this process holds rows r*B .. (r+1)*B of a batch of n*B
# rows, and positions sr*T .. (sr+1)*T of sequences of sn*T
_share = contextvars.ContextVar("batch_share", default=(0, 1, 0, 1))


@contextlib.contextmanager
def batch_share(rank: int, n: int, seq_rank: int = 0, seq_n: int = 1):
    """Within the block, a dropout mask is drawn over the batch of ``n``
    dp ranks' rows (and ``seq_n`` sp ranks' chunks of each sequence) and
    this rank keeps its own, so a mesh step draws the masks a one-device
    step draws. Wraps the forward and the backward (remat recomputes the
    masks there)."""
    token = _share.set((rank, n, seq_rank, seq_n))
    try:
        yield
    finally:
        _share.reset(token)


def _dropout(x, rate: float, seed):
    """Inverted dropout; identity when rate == 0 or seed is None (eval)."""
    if rate == 0.0 or seed is None:
        return x
    r, n, sr, sn = _share.get()
    if n > 1 or sn > 1:
        b, t = x.shape[0], x.shape[1]
        keep = _dropout_mask((n * b, sn * t) + tuple(x.shape[2:]), rate,
                             seed, x.device)[r * b:(r + 1) * b,
                                             sr * t:(sr + 1) * t]
    else:
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
    picks ``ring`` under ``sp > 1``, else ``flash`` for CUDA tensors when
    the (whole) sequence T % 128 == 0, else ``dot``."""
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
    if meshlib.axis_size(mesh, "sp") > 1:
        return "ring"   # key-padding biases rotate with the k/v chunks
    if device is not None and torch.device(device).type == "cuda" \
            and T % 128 == 0:
        return "flash"
    return "dot"


def _key_bias(attn_bias, B):
    """(B, 1, 1, T) -> the (B, T) per-key f32 form; a broadcast-batch
    (1, 1, 1, T) mask expands to the real batch."""
    if attn_bias is None:
        return None
    kb = attn_bias.reshape(attn_bias.shape[0], attn_bias.shape[-1])
    if kb.shape[0] == 1 and B > 1:
        kb = kb.expand(B, kb.shape[1])
    return kb.float().contiguous()


def _attention_core(q, k, v, cfg: TransformerConfig, mesh, impl,
                    attn_bias=None):
    """q/k/v: (B, nh, T, hd) -> (B, nh, T, hd), this rank's heads and its
    chunk of the sequence. ``flash``: the ported online-softmax kernel,
    folding a key-padding ``attn_bias`` (B, 1, 1, T) into its scores;
    ``dot``: the unfused reference form, any additive ``attn_bias``;
    ``ring``: ``parallel/ring_attention.py`` over the mesh's ``sp`` axis
    (one chunk without one).

    Under ``sp > 1`` an explicit ``dot`` or ``flash`` gathers k and v over
    sp (the reference's Ulysses form); the flash kernel's causal mask
    assumes q and k aligned, so ``flash`` there gathers q too, runs the
    whole sequence and keeps this rank's rows."""
    sp = meshlib.axis_size(mesh, "sp")
    if impl == "ring":
        from ..parallel.ring_attention import ring_attention
        return ring_attention(q, k, v, _key_bias(attn_bias, q.shape[0]),
                              group=meshlib.axis_group(mesh, "sp"),
                              causal=cfg.causal)
    hd = q.shape[-1]
    Tl = q.shape[2]
    s = meshlib.axis_rank(mesh, "sp")
    if sp > 1:
        group = meshlib.axis_group(mesh, "sp")
        k = multihost.gather_dim(k, 2, group)
        v = multihost.gather_dim(v, 2, group)
        if attn_bias is not None:
            attn_bias = multihost._gather_cat(attn_bias.detach(), -1, group)
    if impl == "flash":
        kb = _key_bias(attn_bias, q.shape[0])
        if sp > 1:
            q = multihost.gather_dim(q, 2, group)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            cfg.causal, k_bias=kb)
        return o if sp == 1 else o.narrow(2, s * Tl, Tl)
    T = k.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
    if cfg.causal:
        qpos = s * Tl + torch.arange(Tl, device=q.device)
        kpos = torch.arange(T, device=q.device)
        scores = torch.where(kpos[None, :] <= qpos[:, None], scores, -1e30)
    if attn_bias is not None:
        scores = scores + attn_bias.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _row_sum(part, group, dtype):
    """A row-parallel product's partial sums made whole over ``group``
    (Megatron's ``g``, summed in f32), in ``dtype``."""
    if group is None:
        return part
    return multihost.reduce_from(part.float(), group).to(dtype)


def _attention(h, p, cfg: TransformerConfig, mesh, attn_bias=None):
    """Self-attention of this rank's heads (tp) over its chunk of the
    sequence (sp): ``wqkv`` column-parallel behind Megatron's ``f``, ``wo``
    row-parallel with its all-reduce; q and k rotated at their absolute
    positions ``s * T + t``."""
    B, T, D = h.shape
    hd = cfg.head_dim
    tp, t = meshlib.axis_size(mesh, "tp"), meshlib.axis_rank(mesh, "tp")
    sp = meshlib.axis_size(mesh, "sp")
    _, nq, lo, hi = head_layout(cfg, tp, t)
    nkl = hi - lo
    tp_group = meshlib.axis_group(mesh, "tp")
    impl = _resolve_attn_impl(cfg, mesh, T * sp, attn_bias, device=h.device)
    qkv = _mm(multihost.copy_to(h, tp_group), p["wqkv"])
    if cfg.attn_proj_bias:
        qkv = qkv + p["bqkv"].to(h.dtype)
    q, k, v = torch.split(qkv, [nq * hd, nkl * hd, nkl * hd], dim=-1)
    q = q.reshape(B, T, nq, hd).transpose(1, 2)
    k = k.reshape(B, T, nkl, hd).transpose(1, 2)
    v = v.reshape(B, T, nkl, hd).transpose(1, 2)
    if cfg.rope:
        # rotate before any gqa broadcast (rope is per kv head)
        pos0 = meshlib.axis_rank(mesh, "sp") * T
        q = _rope(q, pos0, cfg.rope_theta)
        k = _rope(k, pos0, cfg.rope_theta)
    expand = kv_expand(cfg, tp, t, h.device)
    if impl == "ring":
        # the ring carries the unrepeated kv heads and expands them locally
        from ..parallel.ring_attention import ring_attention
        out = ring_attention(q, k, v, _key_bias(attn_bias, B),
                             group=meshlib.axis_group(mesh, "sp"),
                             causal=cfg.causal, expand=expand)
    else:
        if expand is not None:
            k, v = k.index_select(1, expand), v.index_select(1, expand)
        out = _attention_core(q, k, v, cfg, mesh, impl, attn_bias)
    out = _mm(out.transpose(1, 2).reshape(B, T, nq * hd), p["wo"])
    out = _row_sum(out, tp_group, h.dtype)
    if cfg.attn_proj_bias:
        out = out + p["bo"].to(h.dtype)
    return out


def _dense_mlp(h, p, cfg, mesh):
    """The MLP: ``w1``/``w3`` column-parallel, ``w2`` row-parallel over
    the mesh's tp axis (whole without one)."""
    group = meshlib.axis_group(mesh, "tp")
    x = multihost.copy_to(h, group)
    if cfg.mlp == "swiglu":
        # Llama MLP: down(silu(gate(x)) * up(x)); b1/b2 exist but are unused
        gate = _mm32(x, p["w1"])
        up = _mm32(x, p["w3"])
        return _row_sum(_mm((F.silu(gate) * up).to(h.dtype), p["w2"]),
                        group, h.dtype)
    u = _gelu(_mm(x, p["w1"]) + p["b1"].to(h.dtype), cfg)
    return _row_sum(_mm(u, p["w2"]), group, h.dtype) + p["b2"].to(h.dtype)


def moe_route(x, router, cfg: TransformerConfig):
    """The switch router over x (S, D): ``(probs (S, E) f32, gate (S,),
    expert (S,), onehot (S, E) int64, pos (S,), keep (S,), cap)``. Each
    token goes to its argmax expert (ties to the first index) at the next
    free slot ``pos`` of that expert's buffer of ``cap`` slots; ``keep`` is
    False for a token past the capacity, which is dropped."""
    return _route(x, router, cfg, None, 1)[:7]


def _route(x, router, cfg: TransformerConfig, mesh, rows: int):
    """``moe_route`` over this rank's tokens x (S, D), ``rows`` rows of
    its share of the global batch, and the global batch's count of tokens
    a expert, ``total (E,)``. On a mesh whose data ranks (dp × sp) split
    the batch, ``pos`` and ``cap`` follow the reference's global order
    (b-major, t-minor over the global batch): a token's slot counts the
    tokens routed to its expert before it, from an all-gather of each
    row's per-expert counts over the data ranks; ``cap`` is
    ``capacity_factor · S_global / E``. Without one both are the local
    batch's."""
    S, E = x.shape[0], cfg.n_experts
    dp, sp = meshlib.axis_size(mesh, "dp"), meshlib.axis_size(mesh, "sp")
    d, s = meshlib.axis_rank(mesh, "dp"), meshlib.axis_rank(mesh, "sp")
    cap = max(1, int(cfg.capacity_factor * S * dp * sp / E))
    probs = torch.softmax(x.float() @ router.float(), -1)
    gate, expert = torch.amax(probs, -1), torch.argmax(probs, -1)
    # the position within the expert's buffer, counted in integers
    onehot = F.one_hot(expert, E)
    per_row = onehot.reshape(rows, S // rows, E)
    counts = per_row.sum(1)                                   # (rows, E)
    data = meshlib.data_group(mesh)
    if data is not None:
        counts = torch.stack(multihost.all_gather(counts, data))
    counts = counts.reshape(dp, sp, rows, E)
    ordered = counts.sum(1).reshape(dp * rows, E)  # global rows, in order
    before = (torch.cumsum(ordered, 0) - ordered)[d * rows:(d + 1) * rows]
    before = before + counts[d, :s].sum(0)        # the row's earlier chunks
    pos = ((before[:, None, :] + torch.cumsum(per_row, 1)) * per_row).amax(
        -1).reshape(S) - 1
    return (probs, gate, expert, onehot, pos, pos < cap, cap,
            counts.sum((0, 1, 2)))


# the MoE layers' routing, recorded while ``moe_log()`` is open
_moe_log = contextvars.ContextVar("moe_log", default=None)


@contextlib.contextmanager
def moe_log():
    """Within the block each MoE layer appends its routing to the list it
    yields: ``{"keep": this rank's tokens' keep mask (S,) on the CPU,
    "dropped": the tokens dropped in the global batch, "tokens": the
    global batch's tokens, "cap": the capacity}`` (one read from the device
    a layer; run it on a forward without remat)."""
    log = []
    token = _moe_log.set(log)
    try:
        yield log
    finally:
        _moe_log.reset(token)


def _record_moe(keep, dropped, tokens, cap):
    log = _moe_log.get()
    if log is not None:
        log.append({"keep": keep.detach().cpu(), "dropped": int(dropped),
                    "tokens": int(tokens), "cap": int(cap)})


def _moe_mlp(h, p, cfg: TransformerConfig, mesh):
    """Switch-style top-1 MoE with capacity (``_route``): dense (S, E, cap)
    dispatch and combine products, a dropped token a zero row of the
    dispatch, so it adds nothing. Returns ``(out (B, T, D), the Switch aux
    loss)``.

    On a mesh, the reference's layout: the batch is split over dp (rows)
    and sp (each row's chunks) and whole across ep and tp; each ep rank
    holds ``E / ep`` experts, their ``d_ff`` split over tp. So no token
    moves: each rank routes its tokens in the global order, runs its own
    experts' slice of the dispatch, and the ep ranks sum their outputs;
    the aux loss's densities are sums over the data ranks."""
    B, T, D = h.shape
    E = cfg.n_experts
    ep, er = meshlib.axis_size(mesh, "ep"), meshlib.axis_rank(mesh, "ep")
    if E % ep:
        raise ValueError(f"n_experts {E} is not divisible by ep {ep}")
    El, e0 = E // ep, er * (E // ep)
    x = h.reshape(B * T, D)
    probs, gate, _, onehot, pos, keep, cap, total = _route(
        x, p["router"], cfg, mesh, B)
    S_glob = B * T * meshlib.axis_size(mesh, "dp") * meshlib.axis_size(
        mesh, "sp")
    if _moe_log.get() is not None:
        _record_moe(keep, S_glob - int(torch.clamp_max(total, cap).sum()),
                    S_glob, cap)
    tp_group = meshlib.axis_group(mesh, "tp")
    ep_group = meshlib.axis_group(mesh, "ep")
    # the experts' input and gate reach partial consumers on each ep (and
    # tp) rank: Megatron's f there; the router's own path is replicated
    xe = multihost.copy_to(multihost.copy_to(x, ep_group), tp_group)
    gate_e = multihost.copy_to(gate, ep_group)
    # (pos == slot) is all-zero past the capacity (jax.nn.one_hot's row
    # for an index out of range), and keep masks it explicitly as the
    # reference does
    slot = pos[:, None] == torch.arange(cap, device=x.device)
    dispatch = (onehot[:, e0:e0 + El].to(x.dtype)[:, :, None]
                * slot.to(x.dtype)[:, None, :]
                * keep[:, None, None].to(x.dtype))          # (S, El, cap)
    expert_in = torch.einsum("sec,sd->ecd", dispatch, xe)   # (El, cap, D)
    u = _gelu(_mm(expert_in, p["w1"]) + p["b1"][:, None, :].to(x.dtype), cfg)
    y = (_row_sum(_mm(u, p["w2"]), tp_group, x.dtype)
         + p["b2"][:, None, :].to(x.dtype))                  # (El, cap, D)
    combine = dispatch * gate_e[:, None, None].to(x.dtype)
    out = _row_sum(torch.einsum("sec,ecd->sd", combine, y), ep_group,
                   x.dtype)
    # aux load-balancing loss (Switch Transformer eq. 4) over the global
    # batch
    density = total.float() / S_glob
    density_proxy = multihost.sum_both(probs.sum(0),
                                       meshlib.data_group(mesh)) / S_glob
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


def embed_tokens(params, tokens, cfg: TransformerConfig, mesh=None,
                 pos0: Optional[int] = None):
    """(..., T) integer tokens -> (..., T, D) embeddings (+ learned
    positions, unless the dialect carries positions via rope). On a mesh
    the tokens are this rank's chunk, at positions ``pos0`` (default: its
    sp coordinate times T) on; the tables' D split over tp is looked up
    (the shard's gradient stays on ``fused_embed_grad``) and the columns
    all-gathered."""
    T = tokens.shape[-1]
    if pos0 is None:
        pos0 = meshlib.axis_rank(mesh, "sp") * T
    h = embed_grad.lookup(params["embed"], tokens).to(cfg.dtype)
    if cfg.use_pos_emb:
        h = h + params["pos"][pos0:pos0 + T].to(cfg.dtype)
    return multihost.gather_dim(h, -1, meshlib.axis_group(mesh, "tp"),
                                grad="slice")


def head_matrix(params, cfg: TransformerConfig):
    """The (D, V) vocab projection as ``lm_head``'s ``_mm32`` multiplies
    it: rounded to ``cfg.dtype``, then widened to f32 (on a tp mesh this
    rank's part: the tied embedding's (D/tp, V), the head's (D, V/tp))."""
    w = params["embed"].t() if cfg.tied_head else params["head"]
    return w.to(cfg.dtype).float()


def lm_head(params, h, cfg: TransformerConfig, head=None, mesh=None,
            gather: bool = True):
    """Final norm (pre-LN only) + vocab projection -> f32 logits. ``head``:
    ``head_matrix(params, cfg)`` made once by a caller that applies the
    head many times (a decoder); by default it is formed at this call.

    On a tp mesh the tied head multiplies this rank's D columns by its
    embedding shard and sums over tp (whole logits); the untied head gives
    this rank's vocab slice, gathered over tp unless ``gather=False``
    (``vocab_nll`` reads the slice)."""
    if not cfg.post_ln:
        h = _norm(h, params["lnf_scale"], params["lnf_bias"], cfg)
    if head is None:
        head = head_matrix(params, cfg)
    group = meshlib.axis_group(mesh, "tp")
    if group is None:
        return torch.matmul(h.float(), head)
    x = multihost.copy_to(h, group)
    if cfg.tied_head:
        Dl = head.shape[0]
        x = x.narrow(-1, meshlib.axis_rank(mesh, "tp") * Dl, Dl)
        return multihost.reduce_from(torch.matmul(x.float(), head), group)
    logits = torch.matmul(x.float(), head)
    return multihost.gather_dim(logits, -1, group, grad="slice") if gather \
        else logits


def nll_loss(logits, targets):
    logp = torch.log_softmax(logits.float(), -1)
    return torch.mean(-torch.gather(logp, -1, targets.long()[..., None])[..., 0])


class _VocabNLL(torch.autograd.Function):
    """Per-token NLL over logits whose vocabulary is split over a group:
    the max, the sum of exponentials and the target's logit are
    all-reduced; the gradient is this rank's slice of ``softmax - onehot``
    (no collective)."""

    @staticmethod
    def forward(ctx, logits, targets, v0, group):
        Vl = logits.shape[-1]
        m = multihost.max_over(logits.amax(-1), group)
        e = torch.exp(logits - m[..., None])
        se = multihost._sum(e.sum(-1), group)
        local = targets - v0
        ours = (local >= 0) & (local < Vl)
        tl = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
        tl = multihost._sum(torch.where(ours, tl, 0.0), group)
        ctx.save_for_backward(e / se[..., None], local, ours)
        return torch.log(se) + m - tl

    @staticmethod
    def backward(ctx, g):
        prob, local, ours = ctx.saved_tensors
        Vl = prob.shape[-1]
        grad = prob.clone().scatter_add_(
            -1, local.clamp(0, Vl - 1)[..., None],
            -ours.to(prob.dtype)[..., None])
        return grad * g[..., None], None, None, None


def vocab_nll(logits, targets, mesh=None):
    """The mean NLL of ``targets`` under ``logits`` whose last dimension is
    this rank's vocabulary slice on a tp mesh (``lm_head(...,
    gather=False)``), the whole vocabulary without one."""
    group = meshlib.axis_group(mesh, "tp")
    if group is None:
        return nll_loss(logits, targets)
    v0 = meshlib.axis_rank(mesh, "tp") * logits.shape[-1]
    return torch.mean(_VocabNLL.apply(logits.float(), targets.long(), v0,
                                      group))


def lm_nll(params, h, targets, cfg: TransformerConfig, mesh=None):
    """The LM head's mean NLL of ``targets`` from the trunk's output ``h``:
    on a tp mesh through this rank's vocabulary slice (untied head) or the
    whole logits of the D-split tied head."""
    return vocab_nll(lm_head(params, h, cfg, mesh=mesh, gather=False),
                     targets, None if cfg.tied_head else mesh)


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
    bits (no generator state crosses the checkpoint). On a mesh ``h`` is
    this rank's rows and sequence chunk."""
    meshlib.check_mesh(mesh)
    return run_blocks(params["blocks"], h, cfg, mesh, attn_bias, dropout_rng)


def run_blocks(blocks, h, cfg: TransformerConfig, mesh=None, attn_bias=None,
               dropout_rng=None, first_layer: int = 0):
    """``encode``'s loop over the layers stacked in ``blocks`` (each tensor
    (L', ...)), the first of them layer ``first_layer`` of the model (a
    pipeline stage's): its dropout seed folds that global index."""
    aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    # one unbind per stacked tensor: its backward stacks the L layer
    # gradients once, where indexing x[li] would zero-fill and add a whole
    # (L, ...) gradient per layer
    names = list(blocks)
    layers = zip(*(blocks[n].unbind(0) for n in names))
    remat = cfg.remat and torch.is_grad_enabled()
    block = registry.bind(lambda h, layer_params, rng: _block(
        h, layer_params, cfg, mesh, attn_bias=attn_bias, dropout_rng=rng))

    for li, layer in enumerate(layers, start=first_layer):
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
    meshlib.check_mesh(mesh)
    h = embed_tokens(params, tokens, cfg, mesh)
    return encode(params, h, cfg, mesh, dropout_rng=dropout_rng)


def forward(params, tokens, cfg: TransformerConfig, mesh=None,
            dropout_rng=None):
    """tokens (B, T) -> logits (B, T, V). On a mesh: this rank's tokens
    (its rows and sequence chunk) and their whole-vocabulary logits."""
    h, aux_sum = forward_hidden(params, tokens, cfg, mesh,
                                dropout_rng=dropout_rng)
    return lm_head(params, h, cfg, mesh=mesh), aux_sum


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
    h, aux = forward_hidden(params, tokens, cfg, mesh,
                            dropout_rng=dropout_rng)
    return lm_nll(params, h, targets, cfg, mesh) + aux_weight * aux


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
    t = opt_state["t"] + 1.0
    _adamw(tree_leaves(params), tree_leaves(grads),
           tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]), t, lr,
           b1, b2, eps, wd)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "t": t}


def _adamw(ps, gs, ms, vs, t, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.01):
    """``adamw_update`` over lists of tensors (params may be views: a
    ZeRO-1 rank's shards of its params), in place."""
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


# ---------------------------------------------------------------------------
# data parallelism and ZeRO-1 over a mesh's dp axis
# ---------------------------------------------------------------------------

def shard_first_free_dim(spec, shape, dp: int):
    """Add ``"dp"`` to a spec on the first dimension that no axis splits
    and ``dp`` divides (the ZeRO-1 slot layout rule, shared with the
    pipeline steps, whose block specs carry a leading ``"pp"``)."""
    shape = tuple(shape)
    parts = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for ax, part in enumerate(parts):
        if part is None and shape[ax] % dp == 0:
            return parts[:ax] + ("dp",) + parts[ax + 1:]
    return parts


def zero1_specs(specs, params, mesh):
    """ZeRO-1's slot layout for ``params`` (a tree of tensors, ``"meta"``
    ones included) with partition ``specs`` (a tree of the same keys):
    each slot split over ``dp`` on its first free, dp-divisible dimension
    (``shard_first_free_dim``). The one recipe of the trunk, BERT and the
    pipeline schedules."""
    if isinstance(specs, dict):
        return {k: zero1_specs(specs[k], params[k], mesh) for k in specs}
    return shard_first_free_dim(specs, params.shape,
                                meshlib.axis_size(mesh, "dp"))


def zero1_opt_specs(cfg: TransformerConfig, mesh):
    """ZeRO-1 for the trunk (``zero1_specs`` over ``param_specs``). A rank
    keeps, updates and stores only its shard of each AdamW m/v slot, and
    all-gathers the updated params: the optimizer state shrinks about dp
    times, the step math is the replicated step's."""
    return zero1_specs(param_specs(cfg), init_params(0, cfg, "meta"), mesh)


def place_opt_state(opt_state, specs, mesh):
    """This rank's part of an AdamW state laid out by ``specs``: each m/v
    leaf cut to its shard where a spec names ``"dp"`` (marked, so the
    one-process checkpoint refuses it), whole elsewhere; the step count
    whole. The one placement recipe of the trunk and both pipeline
    schedules."""
    dp, r = meshlib.axis_size(mesh, "dp"), meshlib.axis_rank(mesh, "dp")

    def place(x, spec):
        if "dp" not in spec:
            return x
        ax = spec.index("dp")
        k = x.shape[ax] // dp
        return meshlib.mark_shard(x.narrow(ax, r * k, k).clone(), "zero1")

    return {"m": tree_map(place, opt_state["m"], specs),
            "v": tree_map(place, opt_state["v"], specs),
            "t": opt_state["t"]}


def shard_opt_state(opt_state, cfg: TransformerConfig, mesh,
                    zero1: bool = False):
    """This rank's AdamW state for ``make_train_step(cfg, mesh,
    zero1=zero1)``: the ZeRO-1 shards when ``zero1``, else as it is
    (each rank holds every slot whole)."""
    if not zero1:
        return opt_state
    return place_opt_state(opt_state, zero1_opt_specs(cfg, mesh), mesh)


class DataParallel:
    """The data side of a train step on a mesh, shared by the trunk, BERT,
    ViT and the pipeline schedules: this rank's share of a global batch
    (its dp rows; ``seq_share`` its sp chunk of each row), the gradients'
    sum or mean over the data ranks (dp x sp, ``meshlib.data_group``), and
    AdamW over whole tensors or, with ZeRO-1 ``specs``, over this rank's
    shard of each over dp (the slots are shards already; the updated
    params are all-gathered). One code path for NCCL and gloo
    (``multihost``'s helpers pick the transport by the group's
    backend)."""

    def __init__(self, mesh, zero1_specs=None):
        self.size = meshlib.axis_size(mesh, "dp")
        self.rank = meshlib.axis_rank(mesh, "dp")
        self.sp = meshlib.axis_size(mesh, "sp")
        self.sp_rank = meshlib.axis_rank(mesh, "sp")
        self.mesh = mesh
        self.specs = zero1_specs

    @property
    def group(self):
        return meshlib.axis_group(self.mesh, "dp")

    @property
    def data_group(self):
        return meshlib.data_group(self.mesh)

    def share(self, x, axis: int = 0):
        """This rank's contiguous rows of ``x`` along ``axis``."""
        return self._part(x, axis, self.size, self.rank, "dp")

    def seq_share(self, x, axis: int = 1):
        """This rank's contiguous chunk of ``x``'s sequence ``axis`` (its
        sp coordinate's)."""
        return self._part(x, axis, self.sp, self.sp_rank, "sp")

    @staticmethod
    def _part(x, axis, n_ranks, rank, name):
        if n_ranks == 1:
            return x
        n = x.shape[axis]
        if n % n_ranks:
            raise ValueError(f"dimension {n} is not divisible by "
                             f"{name}={n_ranks}")
        k = n // n_ranks
        return x.narrow(axis, rank * k, k)

    def batch(self, tree, axis: int = 0):
        return tree_map(lambda x: self.share(x, axis), tree)

    def sum_(self, tensors):
        """Sum f32 ``tensors`` over the data ranks, in place."""
        if self.data_group is not None:
            multihost.all_reduce_(tensors, self.data_group)

    def mean_(self, tensors):
        """Average f32 ``tensors`` over the data ranks, in place."""
        if self.data_group is not None:
            multihost.all_reduce_(tensors, self.data_group, mean=True)

    @torch.no_grad()
    def apply(self, params, grads, opt_state, lr):
        """AdamW on this rank's part (every rank holds the mean gradient);
        returns ``(params, opt_state)`` as ``adamw_update`` does."""
        if self.specs is None:
            return adamw_update(params, grads, opt_state, lr=lr)
        t = opt_state["t"] + 1.0
        ps, gs = tree_leaves(params), tree_leaves(grads)
        # each param's spec, in the params' own key order
        axes = tree_leaves(tree_map(
            lambda _, s: s.index("dp") if "dp" in s else None, params,
            self.specs))

        def part(x, ax):
            if ax is None:
                return x
            k = x.shape[ax] // self.size
            return x.narrow(ax, self.rank * k, k)

        _adamw([part(p, a) for p, a in zip(ps, axes)],
               [part(g, a) for g, a in zip(gs, axes)],
               tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]), t,
               lr)
        if self.size > 1:
            self._gather([(p, a) for p, a in zip(ps, axes) if a is not None])
        return params, {"m": opt_state["m"], "v": opt_state["v"], "t": t}

    def _gather(self, sharded):
        """All-gather the updated shards of ``sharded`` (``(param, axis)``
        pairs) as one flat bucket, one collective (as ``all_reduce_``
        buckets the gradients), and copy the other ranks' pieces into
        place."""
        ks = [p.shape[ax] // self.size for p, ax in sharded]
        flat = torch.cat([p.narrow(ax, self.rank * k, k).reshape(-1)
                          for (p, ax), k in zip(sharded, ks)])
        for j, piece in enumerate(multihost.all_gather(flat, self.group)):
            if j == self.rank:
                continue
            i = 0
            for (p, ax), k in zip(sharded, ks):
                dst = p.narrow(ax, j * k, k)
                dst.copy_(piece[i:i + dst.numel()].view(dst.shape))
                i += dst.numel()


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

    ``mesh`` (any of dp, tp, sp, ep; pp, which the trunk replicates
    over): every rank passes the global batch and gets the global loss;
    ``params`` are this rank's (``shard_params``); see the module
    docstring. ``zero1=True`` (a mesh only): place the state with
    ``shard_opt_state(opt, cfg, mesh, zero1=True)`` first."""
    meshlib.check_mesh(mesh)
    if zero1 and mesh is None:
        raise ValueError("zero1=True shards AdamW's m and v over a mesh's "
                         "dp axis: pass mesh=")
    dp = DataParallel(mesh, zero1_opt_specs(cfg, mesh) if zero1 else None)
    use_dropout = cfg.dropout_rate > 0.0

    def step(params, opt_state, tokens, targets, dropout_rng=None):
        if use_dropout and dropout_rng is None:
            # a forgotten key must not silently train without dropout
            raise ValueError("cfg.dropout_rate > 0: pass dropout_rng to "
                             "the train step")
        axis = 0 if accum_steps == 1 else 1
        tokens, targets = (dp.seq_share(dp.share(x, axis), axis + 1)
                           for x in (tokens, targets))
        with batch_share(dp.rank, dp.size, dp.sp_rank, dp.sp):
            loss, grads = _loss_and_grads(params, tokens, targets, cfg, mesh,
                                          accum_steps, dropout_rng)
        sum_shared_kv_(grads, cfg, mesh)
        dp.mean_([loss] + tree_leaves(grads))
        params, opt_state = dp.apply(params, grads, opt_state, lr)
        return loss, params, opt_state

    if use_dropout:
        return step
    return lambda params, opt_state, tokens, targets: step(
        params, opt_state, tokens, targets)


def _loss_and_grads(params, tokens, targets, cfg, mesh, accum_steps,
                    dropout_rng):
    if accum_steps == 1:
        return value_and_grad(loss_fn, params, tokens, targets, cfg, mesh,
                              dropout_rng=dropout_rng)
    if tokens.shape[0] != accum_steps:
        raise ValueError(f"leading (accumulation) axis {tokens.shape[0]} "
                         f"!= accum_steps {accum_steps}")
    loss, grads = None, None
    for mi in range(accum_steps):
        rng = None if dropout_rng is None else fold_in(dropout_rng, mi)
        l, g = value_and_grad(loss_fn, params, tokens[mi], targets[mi], cfg,
                              mesh, dropout_rng=rng)
        if grads is None:
            loss, grads = l, g
        else:
            loss = loss + l
            torch._foreach_add_(tree_leaves(grads), tree_leaves(g))
    torch._foreach_div_(tree_leaves(grads), accum_steps)
    return loss / accum_steps, grads
