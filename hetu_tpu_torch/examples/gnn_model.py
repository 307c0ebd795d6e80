"""GNN models and graphs on the port: copies of the builders of
``examples/gnn/gnn_model`` (``layer.py``: ``GCN``, ``SageConv``;
``model.py``: ``dense_model``, ``convert_to_one_hot``; ``utils.py``:
``synthetic_graph``, ``normalize_adj``), importing ``hetu_tpu_torch``,
plus ``arxiv_graph``, a seeded synthetic graph at ogbn-arxiv's size and
widths. ``sparse_model`` looks its integer features up in an embedding
table (the table's gradient through ``fused_embed_grad``) before the GCN
stack (its products through ``csr_spmm``).
"""
import numpy as np

import hetu_tpu_torch as ht
from hetu_tpu_torch import init


# -- layers (examples/gnn/gnn_model/layer.py) -------------------------------

class GCN:
    """h' = act(A_norm @ h @ W + b); ``norm_adj`` is a fed sparse Variable."""

    def __init__(self, in_features, out_features, norm_adj, activation=None,
                 name="gcn"):
        self.output_width = out_features
        self.weight = init.xavier_uniform((in_features, out_features),
                                          name=name + "_weight")
        self.bias = init.zeros((out_features,), name=name + "_bias")
        self.norm_adj = norm_adj
        self.activation = activation

    def __call__(self, x):
        msg = ht.distgcn_15d_op(self.norm_adj, x, self.weight)
        y = msg + ht.broadcastto_op(self.bias, msg)
        if self.activation == "relu":
            y = ht.relu_op(y)
        return y


class SageConv:
    """GraphSAGE mean aggregator: concat(h, A_norm @ h) @ W."""

    def __init__(self, in_features, out_features, norm_adj, activation=None,
                 name="sage"):
        self.output_width = out_features
        self.weight = init.xavier_uniform((2 * in_features, out_features),
                                          name=name + "_weight")
        self.bias = init.zeros((out_features,), name=name + "_bias")
        self.norm_adj = norm_adj
        self.activation = activation

    def __call__(self, x):
        neigh = ht.csrmm_op(self.norm_adj, x)
        h = ht.concat_op(x, neigh, axis=1)
        y = ht.matmul_op(h, self.weight)
        y = y + ht.broadcastto_op(self.bias, y)
        if self.activation == "relu":
            y = ht.relu_op(y)
        return y


# -- models (examples/gnn/gnn_model/model.py) -------------------------------

def convert_to_one_hot(vals, max_val=0):
    if max_val == 0:
        max_val = vals.max() + 1
    one_hot = np.zeros((vals.size, max_val), np.float32)
    one_hot[np.arange(vals.size), vals] = 1
    return one_hot


def dense_model(feature_dim, hidden_layer_size, num_classes, lr, arch=GCN):
    """Full-batch node classification: feats/labels/mask fed per step,
    normalized adjacency fed as a sparse Variable."""
    y_ = ht.Variable(name="y_", trainable=False)
    mask_ = ht.Variable(name="mask_", trainable=False)
    feat = ht.Variable(name="feat", trainable=False)
    norm_adj_ = ht.Variable(name="message_passing", trainable=False)

    gcn1 = arch(feature_dim, hidden_layer_size, norm_adj_, activation="relu",
                name="gcn1")
    gcn2 = arch(gcn1.output_width, num_classes, norm_adj_, name="gcn2")
    y = gcn2(gcn1(feat))
    loss = ht.softmaxcrossentropy_op(y, y_)
    train_loss = ht.reduce_mean_op(loss * mask_, [0])
    train_op = ht.optim.SGDOptimizer(lr).minimize(train_loss)
    return [train_loss, y, train_op], [feat, y_, mask_, norm_adj_]


def sparse_model(num_int_feature, hidden_layer_size, embedding_idx_max,
                 embedding_width, num_classes, lr):
    """Integer-feature variant: per-node categorical features pass through an
    embedding table before the GCN stack (reference sparse_model)."""
    y_ = ht.Variable(name="y_", trainable=False)
    mask_ = ht.Variable(name="mask_", trainable=False)
    index_ = ht.Variable(name="index_", trainable=False)
    norm_adj_ = ht.Variable(name="message_passing", trainable=False)

    embedding = init.random_normal((embedding_idx_max, embedding_width),
                                   stddev=0.1, name="gnn_embedding")
    embed = ht.embedding_lookup_op(embedding, index_)
    feat = ht.array_reshape_op(embed, (-1, num_int_feature * embedding_width))

    gcn1 = GCN(num_int_feature * embedding_width, hidden_layer_size,
               norm_adj_, activation="relu", name="gcn1")
    gcn2 = GCN(gcn1.output_width, num_classes, norm_adj_, name="gcn2")
    y = gcn2(gcn1(feat))
    loss = ht.softmaxcrossentropy_op(y, y_)
    train_loss = ht.reduce_mean_op(loss * mask_, [0])
    train_op = ht.optim.SGDOptimizer(lr).minimize(train_loss)
    return [train_loss, y, train_op], [index_, y_, mask_, norm_adj_]


# -- graphs (examples/gnn/gnn_model/utils.py) -------------------------------

def synthetic_graph(n_nodes=256, n_classes=4, feat_dim=16, avg_deg=6, seed=0):
    """Community-structured random graph: nodes in the same class link with
    higher probability, features are noisy class prototypes — learnable by a
    2-layer GCN."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, n_nodes)
    protos = rng.randn(n_classes, feat_dim).astype(np.float32)
    feats = protos[labels] + 0.5 * rng.randn(n_nodes, feat_dim).astype(np.float32)
    p_in = avg_deg / (n_nodes / n_classes) * 0.7
    p_out = avg_deg / n_nodes * 0.3
    rows, cols = [], []
    for i in range(n_nodes):
        same = labels == labels[i]
        prob = np.where(same, p_in, p_out)
        nbrs = np.where(rng.rand(n_nodes) < prob)[0]
        rows.extend([i] * len(nbrs))
        cols.extend(nbrs)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    # symmetrize + self loops, so the D^-1/2 A D^-1/2 normalization below is
    # the genuine GCN normalization (in-degree == out-degree)
    rows, cols = (np.concatenate([rows, cols, np.arange(n_nodes)]),
                  np.concatenate([cols, rows, np.arange(n_nodes)]))
    return rows, cols, feats, labels


def normalize_adj(rows, cols, n_nodes):
    """Symmetric GCN normalization D^-1/2 (A) D^-1/2 as COO values."""
    deg = np.bincount(rows, minlength=n_nodes).astype(np.float32)
    deg = np.maximum(deg, 1.0)
    vals = 1.0 / np.sqrt(deg[rows] * deg[cols])
    return vals.astype(np.float32)


# ogbn-arxiv (OGB's node-property benchmark): 169,343 papers, 1,166,243
# directed citations, 128 features, 40 subject classes
ARXIV = dict(n_nodes=169_343, n_edges=1_166_243, n_classes=40, feat_dim=128)


def arxiv_graph(n_nodes=ARXIV["n_nodes"], n_edges=ARXIV["n_edges"],
                n_classes=ARXIV["n_classes"], feat_dim=ARXIV["feat_dim"],
                same_class=0.7, seed=0):
    """A seeded synthetic graph at ogbn-arxiv's size and widths, in the form
    of ``synthetic_graph``: ``(rows, cols, feats, labels)``.

    Each directed edge (a citation) has a uniform source, so the mean
    out-degree is n_edges / n_nodes (6.9); its destination is drawn by a
    heavy-tailed popularity (Pareto, shape 2), from the source's class with
    probability ``same_class`` and from all nodes otherwise. The edges are
    then symmetrized and self loops added, as ``synthetic_graph`` does:
    2 * n_edges + n_nodes entries (2,501,829), duplicates kept. Features
    are class prototypes plus unit noise. Vectorized: no n x n draw."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    protos = rng.standard_normal((n_classes, feat_dim), dtype=np.float32)
    feats = protos[labels] + rng.standard_normal((n_nodes, feat_dim),
                                                 dtype=np.float32)
    popularity = rng.pareto(2.0, n_nodes) + 1.0
    by_class = np.argsort(labels, kind="stable")
    cum = np.cumsum(popularity[by_class])
    before = np.concatenate([[0.0], cum])       # weight before position i
    start = np.searchsorted(labels[by_class], np.arange(n_classes + 1))
    src = rng.integers(0, n_nodes, n_edges)
    same = rng.random(n_edges) < same_class
    lo = np.where(same, before[start[labels[src]]], 0.0)
    hi = np.where(same, before[start[labels[src] + 1]], cum[-1])
    u = lo + rng.random(n_edges) * (hi - lo)
    dst = by_class[np.minimum(np.searchsorted(cum, u, side="right"),
                              n_nodes - 1)]
    rows = np.concatenate([src, dst, np.arange(n_nodes)])
    cols = np.concatenate([dst, src, np.arange(n_nodes)])
    return rows, cols, feats, labels
