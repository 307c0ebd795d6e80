"""Transformer LM on the graph API, on the port: a copy of
``examples/nlp/hetu_transformer.py``'s ``transformer_lm`` (multihead
attention, layernorm, FFN, dropout and token embeddings as graph ops)
over ``hetu_tpu_torch``.

A decoder-only causal LM built from graph ops alone (embedding_lookup /
batch_matmul / softmax / layer_normalization / dropout), shapes fixed at
build time. Its two lookups (tokens, positions) take the table gradients
through ``fused_embed_grad``; under Adam every step is one ``fused_adam``
apply. Parameter names, shapes and initializers are the reference's, so
checkpoints move between the two packages. The reference's trainer
(``examples/nlp/train_hetu_transformer.py``) tokenizes with the
tokenizers, which come to the port with slice 5d.
"""
import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch import init


def layer_norm(x, feature_size, name, eps=1e-8):
    scale = init.ones((feature_size,), name=name + "_scale")
    bias = init.zeros((feature_size,), name=name + "_bias")
    return ht.layer_normalization_op(x, scale, bias, eps=eps)


def dense(x, fan_in, fan_out, name, activation=None):
    w = init.xavier_normal((fan_in, fan_out), name=name + "_weight")
    b = init.zeros((fan_out,), name=name + "_bias")
    y = ht.matmul_op(ht.array_reshape_op(x, (-1, fan_in)), w)
    y = y + ht.broadcastto_op(b, y)
    if activation is not None:
        y = activation(y)
    return y


def get_token_embeddings(vocab_size, num_units, name="embedding_table"):
    return init.xavier_normal((vocab_size, num_units), name=name)


def multihead_attention(x, batch, seq_len, d_model, n_heads, mask, name,
                        dropout_prob=0.1):
    """Causal multihead self-attention over (B, T, D)."""
    hd = d_model // n_heads

    def split_heads(t):
        t = ht.array_reshape_op(t, (batch, seq_len, n_heads, hd))
        return ht.transpose_op(t, (0, 2, 1, 3))     # (B, H, T, hd)

    q = split_heads(ht.array_reshape_op(
        dense(x, d_model, d_model, name + "_q"), (batch, seq_len, d_model)))
    k = split_heads(ht.array_reshape_op(
        dense(x, d_model, d_model, name + "_k"), (batch, seq_len, d_model)))
    v = split_heads(ht.array_reshape_op(
        dense(x, d_model, d_model, name + "_v"), (batch, seq_len, d_model)))

    scores = ht.batch_matmul_op(q, k, trans_B=True)     # (B, H, T, T)
    scores = ht.mul_byconst_op(scores, 1.0 / np.sqrt(hd))
    scores = scores + ht.broadcastto_op(mask, scores)   # -inf above diagonal
    attn = ht.softmax_op(scores)
    attn = ht.dropout_op(attn, 1.0 - dropout_prob)
    ctx = ht.batch_matmul_op(attn, v)                   # (B, H, T, hd)
    ctx = ht.transpose_op(ctx, (0, 2, 1, 3))
    ctx = ht.array_reshape_op(ctx, (batch, seq_len, d_model))
    out = dense(ctx, d_model, d_model, name + "_proj")
    return ht.array_reshape_op(out, (batch, seq_len, d_model))


def feed_forward(x, batch, seq_len, d_model, d_ff, name, dropout_prob=0.1):
    h = dense(x, d_model, d_ff, name + "_in", activation=ht.relu_op)
    h = ht.dropout_op(h, 1.0 - dropout_prob)
    h = dense(h, d_ff, d_model, name + "_out")
    return ht.array_reshape_op(h, (batch, seq_len, d_model))


def transformer_lm(tokens, labels, vocab_size, batch, seq_len, d_model=64,
                   n_heads=4, n_layers=2, d_ff=256, dropout_prob=0.1):
    """Build the causal LM graph. ``tokens``/``labels`` are fed (B, T)
    int-valued placeholders; returns (loss, logits, mask_node)."""
    table = get_token_embeddings(vocab_size, d_model)
    pos_table = init.xavier_normal((seq_len, d_model), name="pos_embedding")
    h = ht.embedding_lookup_op(table, tokens)            # (B, T, D)
    pos_idx = ht.Variable(
        "pos_idx", value=np.arange(seq_len, dtype=np.float32),
        trainable=False, batch=False)
    pos = ht.embedding_lookup_op(pos_table, pos_idx)     # (T, D)
    h = h + ht.broadcastto_op(pos, h)

    causal = np.triu(np.full((seq_len, seq_len), -1e9, np.float32), k=1)
    mask = ht.Variable("causal_mask", value=causal, trainable=False,
                       batch=False)

    for i in range(n_layers):
        a = multihead_attention(layer_norm(h, d_model, f"ln1_{i}"), batch,
                                seq_len, d_model, n_heads, mask,
                                f"attn_{i}", dropout_prob)
        h = h + a
        f = feed_forward(layer_norm(h, d_model, f"ln2_{i}"), batch, seq_len,
                         d_model, d_ff, f"ffn_{i}", dropout_prob)
        h = h + f

    h = layer_norm(h, d_model, "ln_f")
    logits = dense(h, d_model, vocab_size, "lm_head")    # (B*T, V)
    targets = ht.one_hot_op(ht.array_reshape_op(labels, (-1,)), vocab_size)
    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(logits, targets), [0])
    return loss, logits, mask
