"""The CTR model zoo on the port (copies of ``examples/ctr/models``:
``common``, ``wdl_criteo``, ``deepfm_criteo``, ``dcn_criteo``,
``dc_criteo``, ``wdl_adult`` and ``load_data``, importing
``hetu_tpu_torch as ht``).

Each model function takes its inputs as graph nodes and returns
``(loss, y, y_, train_op)``, as the reference's do. ``feature_dimension`` defaults to
Criteo-Kaggle's 33,762,577 rows (pass a smaller value for small runs).
The tables carry ``ctx=ht.cpu(0)`` as in the reference: a placement hint
for the PS modes, which local mode ignores (the table lives on the
executor's device).

The data loaders generate the reference's seeded synthetic sets, with the
same shapes and dtypes as the real ones: the real Criteo and Adult files
are not in the repository.
"""
import os

import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch import init

# Criteo-Kaggle's vocabulary over its 26 sparse slots
CRITEO_VOCAB = 33762577


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

def dense_layer(x, in_dim, out_dim, name, activation=None, stddev=0.1,
                bias=True, xavier=False):
    if xavier:
        w = init.xavier_normal([in_dim, out_dim], name=f"{name}_w")
    else:
        w = init.random_normal([in_dim, out_dim], stddev=stddev,
                               name=f"{name}_w")
    y = ht.matmul_op(x, w)
    if bias:
        b = init.zeros([out_dim], name=f"{name}_b") if xavier else \
            init.random_normal([out_dim], stddev=stddev, name=f"{name}_b")
        y = y + ht.broadcastto_op(b, y)
    if activation == "relu":
        y = ht.relu_op(y)
    elif activation == "sigmoid":
        y = ht.sigmoid_op(y)
    return y


def mlp(x, dims, name, stddev=0.1, out_activation=None):
    for i in range(len(dims) - 1):
        act = "relu" if i < len(dims) - 2 else out_activation
        x = dense_layer(x, dims[i], dims[i + 1], f"{name}{i + 1}",
                        activation=act, stddev=stddev, bias=False)
    return x


def bce_loss_and_train(y, y_, lr):
    loss = ht.reduce_mean_op(ht.binarycrossentropy_op(y, y_), [0])
    opt = ht.optim.SGDOptimizer(learning_rate=lr)
    return loss, opt.minimize(loss)


# ---------------------------------------------------------------------------
# Wide & Deep on Criteo: one shared table over 26 sparse slots and an MLP
# over the 13 numeric fields, joined by a final linear layer
# ---------------------------------------------------------------------------

def wdl_criteo(dense_input, sparse_input, y_,
               feature_dimension=CRITEO_VOCAB, embedding_size=128,
               learning_rate=0.01, n_slots=26, n_dense=13, stddev=0.01):
    table = init.random_normal([feature_dimension, embedding_size],
                               stddev=stddev, name="snd_order_embedding",
                               is_embed=True, ctx=ht.cpu(0))
    emb = ht.embedding_lookup_op(table, sparse_input)
    emb = ht.array_reshape_op(emb, (-1, n_slots * embedding_size))

    deep = mlp(dense_input, [n_dense, 256, 256, 256], "W", stddev=stddev)
    joint = ht.concat_op(emb, deep, axis=1)
    w_out = init.random_normal([256 + n_slots * embedding_size, 1],
                               stddev=stddev, name="W4")
    y = ht.sigmoid_op(ht.matmul_op(joint, w_out))
    loss, train_op = bce_loss_and_train(y, y_, learning_rate)
    return loss, y, y_, train_op


# ---------------------------------------------------------------------------
# DeepFM on Criteo: first-order embedding, the FM second-order interaction
# (sum-square minus square-sum) and a DNN over the second-order embeddings
# ---------------------------------------------------------------------------

def dfm_criteo(dense_input, sparse_input, y_,
               feature_dimension=CRITEO_VOCAB, embedding_size=128,
               learning_rate=0.01, n_slots=26, n_dense=13):
    emb1 = init.random_normal([feature_dimension, 1], stddev=0.01,
                              name="fst_order_embedding", is_embed=True,
                              ctx=ht.cpu(0))
    fm_w = init.random_normal([n_dense, 1], stddev=0.01,
                              name="dense_parameter")
    first_sparse = ht.embedding_lookup_op(emb1, sparse_input)
    y1 = ht.matmul_op(dense_input, fm_w) + ht.reduce_sum_op(first_sparse,
                                                            axes=1)

    emb2 = init.random_normal([feature_dimension, embedding_size],
                              stddev=0.01, name="snd_order_embedding",
                              is_embed=True, ctx=ht.cpu(0))
    e = ht.embedding_lookup_op(emb2, sparse_input)
    sum_e = ht.reduce_sum_op(e, axes=1)
    square_of_sum = ht.mul_op(sum_e, sum_e)
    sum_of_square = ht.reduce_sum_op(ht.mul_op(e, e), axes=1)
    y2 = ht.reduce_sum_op((square_of_sum + -1 * sum_of_square) * 0.5,
                          axes=1, keepdims=True)

    flat = ht.array_reshape_op(e, (-1, n_slots * embedding_size))
    y3 = mlp(flat, [n_slots * embedding_size, 256, 256, 1], "W", stddev=0.01)

    y = ht.sigmoid_op(y1 + y2 + y3)
    loss, train_op = bce_loss_and_train(y, y_, learning_rate)
    return loss, y, y_, train_op


# ---------------------------------------------------------------------------
# Deep & Cross Network on Criteo: x_{l+1} = x0 * (x_l w) + b + x_l beside a
# deep tower
# ---------------------------------------------------------------------------

def _cross_layer(x0, xl, width, layer_idx):
    w = init.random_normal((width, 1), stddev=0.01,
                           name=f"cross_w{layer_idx}")
    b = init.random_normal((width,), stddev=0.01, name=f"cross_b{layer_idx}")
    xlw = ht.matmul_op(xl, w)
    y = ht.mul_op(x0, ht.broadcastto_op(xlw, x0))
    return y + xl + ht.broadcastto_op(b, y)


def dcn_criteo(dense_input, sparse_input, y_,
               feature_dimension=CRITEO_VOCAB, embedding_size=128,
               learning_rate=0.003, n_slots=26, n_dense=13, cross_layers=3):
    table = init.random_normal([feature_dimension, embedding_size],
                               stddev=0.01, name="snd_order_embedding",
                               is_embed=True, ctx=ht.cpu(0))
    emb = ht.embedding_lookup_op(table, sparse_input)
    emb = ht.array_reshape_op(emb, (-1, n_slots * embedding_size))
    x0 = ht.concat_op(emb, dense_input, axis=1)
    width = n_slots * embedding_size + n_dense

    xl = x0
    for i in range(cross_layers):
        xl = _cross_layer(x0, xl, width, i)

    deep = mlp(x0, [width, 256, 256, 256], "W", stddev=0.01)
    joint = ht.concat_op(xl, deep, axis=1)
    w_out = init.random_normal([width + 256, 1], stddev=0.01, name="W4")
    y = ht.sigmoid_op(ht.matmul_op(joint, w_out))
    loss, train_op = bce_loss_and_train(y, y_, learning_rate)
    return loss, y, y_, train_op


# ---------------------------------------------------------------------------
# Deep Crossing on Criteo: stacked residual units over the concatenated
# embeddings and dense features
# ---------------------------------------------------------------------------

def _residual_unit(x, dim, hidden, layer_idx):
    # scale-aware init, as the reference's: its fixed stddev=0.1 blows up
    # for wide residual stacks
    h = dense_layer(x, dim, hidden, f"res{layer_idx}_1", activation="relu",
                    xavier=True)
    h = dense_layer(h, hidden, dim, f"res{layer_idx}_2", xavier=True)
    return ht.relu_op(h + x)


def dc_criteo(dense_input, sparse_input, y_, feature_dimension=CRITEO_VOCAB,
              embedding_size=8, learning_rate=0.001, n_slots=26, n_dense=13,
              num_layers=5):
    table = init.random_normal([feature_dimension, embedding_size],
                               stddev=0.01, name="snd_order_embedding",
                               is_embed=True, ctx=ht.cpu(0))
    emb = ht.embedding_lookup_op(table, sparse_input)
    emb = ht.array_reshape_op(emb, (-1, n_slots * embedding_size))
    x = ht.concat_op(emb, dense_input, axis=1)
    dim = n_slots * embedding_size + n_dense

    for i in range(num_layers):
        x = _residual_unit(x, dim, dim, i)

    w_out = init.random_normal([dim, 1], stddev=0.1, name="W4")
    y = ht.sigmoid_op(ht.matmul_op(x, w_out))
    loss, train_op = bce_loss_and_train(y, y_, learning_rate)
    return loss, y, y_, train_op


# ---------------------------------------------------------------------------
# Wide & Deep on the Adult census data: 8 categorical slots with a table
# each and 4 numeric fields feed the deep tower; the wide part joins the
# raw wide features with the deep output
# ---------------------------------------------------------------------------

def wdl_adult(X_deep, X_wide, y_, dim_wide=809, embed_rows=50, embed_dim=8):
    n_cat, n_num = 8, 4
    deep_in = n_cat * embed_dim + n_num

    parts = []
    for i in range(n_cat):
        table = init.random_normal([embed_rows, embed_dim], stddev=0.1,
                                   name=f"Embedding_deep_{i}", is_embed=True)
        parts.append(ht.array_reshape_op(
            ht.embedding_lookup_op(table, X_deep[i]), (-1, embed_dim)))
    for i in range(n_num):
        parts.append(ht.array_reshape_op(X_deep[n_cat + i], (-1, 1)))
    deep = parts[0]
    for p in parts[1:]:
        deep = ht.concat_op(deep, p, 1)

    w1 = init.random_normal([deep_in, 50], stddev=0.1, name="W1")
    b1 = init.random_normal([50], stddev=0.1, name="b1")
    w2 = init.random_normal([50, 20], stddev=0.1, name="W2")
    b2 = init.random_normal([20], stddev=0.1, name="b2")
    h = ht.matmul_op(deep, w1)
    h = ht.relu_op(h + ht.broadcastto_op(b1, h))
    h = ht.matmul_op(h, w2)
    dmodel = ht.relu_op(h + ht.broadcastto_op(b2, h))

    w_out = init.random_normal([dim_wide + 20, 2], stddev=0.1, name="W")
    wmodel = ht.matmul_op(ht.concat_op(X_wide, dmodel, 1), w_out)

    loss = ht.reduce_mean_op(
        ht.softmaxcrossentropy_op(wmodel, y_), [0])
    opt = ht.optim.SGDOptimizer(learning_rate=5 / 128)
    return loss, ht.softmax_op(wmodel), y_, opt.minimize(loss)


# ---------------------------------------------------------------------------
# data: the reference's seeded synthetic sets where the files are absent
# ---------------------------------------------------------------------------

def _synth_criteo(n_samples, feature_dimension, rng):
    dense = rng.randn(n_samples, 13).astype(np.float32)
    sparse = rng.randint(0, feature_dimension,
                         (n_samples, 26)).astype(np.float32)
    # labels correlate with dense features so training can learn
    labels = (dense.sum(1, keepdims=True) > 0).astype(np.float32)
    return dense, sparse, labels


def load_criteo_data(path=None, feature_dimension=CRITEO_VOCAB, n_train=8192,
                     n_test=2048, seed=0):
    """Returns (train, test) tuples of (dense, sparse, labels)."""
    if path and os.path.exists(path):
        data = np.load(path)
        return ((data["train_dense"], data["train_sparse"],
                 data["train_labels"]),
                (data["test_dense"], data["test_sparse"],
                 data["test_labels"]))
    rng = np.random.RandomState(seed)
    return (_synth_criteo(n_train, feature_dimension, rng),
            _synth_criteo(n_test, feature_dimension, rng))


def load_adult_data(path=None, n_train=8192, n_test=2048, seed=0,
                    dim_wide=809, embed_rows=50):
    """Adult census: 8 categorical slots, 4 numeric, wide features, labels
    one-hot over 2 classes (the reference's wdl_adult input layout)."""
    if path and os.path.exists(path):
        data = np.load(path)
        return ((data["train_deep"], data["train_wide"],
                 data["train_labels"]),
                (data["test_deep"], data["test_wide"], data["test_labels"]))
    rng = np.random.RandomState(seed)

    def synth(n):
        cat = [rng.randint(0, embed_rows, (n, 1)).astype(np.float32)
               for _ in range(8)]
        num = [rng.randn(n, 1).astype(np.float32) for _ in range(4)]
        wide = rng.randn(n, dim_wide).astype(np.float32)
        y = (wide[:, :1] + num[0] > 0).astype(np.int64).ravel()
        labels = np.eye(2, dtype=np.float32)[y]
        return cat + num, wide, labels

    return synth(n_train), synth(n_test)
