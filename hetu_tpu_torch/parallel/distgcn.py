"""DistGCN's 1.5D hybrid-parallel sparse product over a grid of processes
(counterpart of ``hetu_tpu/parallel/distgcn.py``; reference
``gpu_ops/DistGCN_15d.py:19-60``).

The adjacency is row-partitioned over ``gr`` row shards and its
contraction (column) range split over ``gc`` replicas; ``gr * gc``
processes, one per device, form a :class:`multihost.ProcessGrid`, rank
``i * gc + j`` at point ``(i, j)``. The JAX package runs the same schedule
as one program over a ``(gr, gc)`` device mesh inside a ``shard_map``;
here each rank runs its own part, and the mesh's collectives are
``torch.distributed`` calls in the grid's groups:

- the features ``H`` are row-sharded over the whole grid, gc-major: point
  ``(i, j)`` holds global block ``j * gr + i`` of ``N / (gr * gc)`` rows
  (the JAX package's ``P((gc, gr), None)``);
- ``all_gather`` over ``gr`` (the reference's column-group broadcasts) is
  ``all_gather_into_tensor`` in the column group: column slice ``j``,
  rows ``[j * N / gc, (j + 1) * N / gc)``;
- the local block product is ``csr_spmm`` (``kernels/csr_spmm.py``) on
  the rank's own block of the adjacency, as a CSR built once from its
  entries (no padding: each rank has its own shapes); its backward runs
  the same kernel on the transposed CSR;
- ``psum`` over ``gc`` (the row-group all-reduce) is ``all_reduce`` in the
  row group: ``Z``'s rows ``[i * N / gr, (i + 1) * N / gr)``, the same on
  every rank of the row.

Gradients follow one rule: a value held the same on every rank of a row
(``Z``, the logits) has its whole gradient on each of them. So the
``all_reduce``'s backward passes ``dZ`` through; the gather's is a
reduce-scatter in the column group; a weight held on every rank sums its
gradient over the column group, once over the grid's row shards
(:func:`gcn_forward`). A loss is each rank's share of it from its own
rows, the sum over the column group being the whole loss.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import csr_spmm
from ..ndarray import ND_Sparse_Array
from . import multihost


def partition_adjacency(rows: np.ndarray, cols: np.ndarray,
                        values: np.ndarray, n_nodes: int,
                        gr: int, gc: int):
    """Partition a COO adjacency for the (gr, gc) mesh.

    Returns ``(vals, local_rows, local_cols)`` each shaped
    ``(gr, gc, nnz_max)`` — device (i, j) owns entries with
    ``row in [i*Nr, (i+1)*Nr)`` and ``col in [j*Nc, (j+1)*Nc)``, with local
    indices. Zero-padded to the max block nnz (padded entries have value 0
    and indices 0, contributing nothing to the segment sum).
    """
    assert n_nodes % gr == 0 and n_nodes % gc == 0, \
        "pad the graph so n_nodes divides both mesh axes"
    nr, nc = n_nodes // gr, n_nodes // gc
    # single sort pass instead of gr*gc boolean scans of the nnz arrays
    bi = rows // nr
    bj = cols // nc
    order = np.lexsort((bj, bi))
    rows, cols, values = rows[order], cols[order], values[order]
    block_key = bi[order] * gc + bj[order]
    splits = np.searchsorted(block_key, np.arange(gr * gc + 1))
    counts = np.diff(splits)
    nnz_max = int(counts.max()) if counts.size else 0
    vals = np.zeros((gr, gc, nnz_max), np.float32)
    lrows = np.zeros((gr, gc, nnz_max), np.int32)
    lcols = np.zeros((gr, gc, nnz_max), np.int32)
    for k in range(gr * gc):
        i, j = divmod(k, gc)
        lo, hi = splits[k], splits[k + 1]
        vals[i, j, :hi - lo] = values[lo:hi]
        lrows[i, j, :hi - lo] = rows[lo:hi] - i * nr
        lcols[i, j, :hi - lo] = cols[lo:hi] - j * nc
    return vals, lrows, lcols


def _sizes(grid, n_nodes: int):
    """Rows of a row shard, of a column slice and of a feature block."""
    if n_nodes % (grid.gr * grid.gc):
        raise ValueError(f"{n_nodes} nodes do not divide over a "
                         f"{grid.gr} x {grid.gc} grid: pad the graph")
    return (n_nodes // grid.gr, n_nodes // grid.gc,
            n_nodes // (grid.gr * grid.gc))


# ---------------------------------------------------------------------------
# the collectives, with their gradients
# ---------------------------------------------------------------------------

class _GatherColumn(torch.autograd.Function):
    """The column group's blocks stacked in order (``all_gather`` over gr);
    the gradient of this rank's block is the column group's sum of the
    stacked gradient's piece (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, h, grid):
        ctx.grid = grid
        out = h.new_empty((grid.gr * h.shape[0],) + tuple(h.shape[1:]))
        multihost.collective(dist.all_gather_into_tensor, out, h,
                             group=grid.col_group)
        return out

    @staticmethod
    def backward(ctx, d):
        grid = ctx.grid
        out = d.new_empty((d.shape[0] // grid.gr,) + tuple(d.shape[1:]))
        multihost.collective(dist.reduce_scatter_tensor, out, d.contiguous(),
                             group=grid.col_group)
        return out, None


class _SumRow(torch.autograd.Function):
    """The row group's sum (``psum`` over gc). Its output is the same on
    every rank of the row, and so is its whole gradient: passed through."""

    @staticmethod
    def forward(ctx, z, grid):
        out = z.clone()
        multihost.collective(dist.all_reduce, out, group=grid.row_group)
        return out

    @staticmethod
    def backward(ctx, dz):
        return dz, None


class _Replicated(torch.autograd.Function):
    """A weight held on every rank: the identity, whose gradient is summed
    over the column group, once over the grid's row shards (each rank of a
    row holds the same, whole, gradient of its shard's part)."""

    @staticmethod
    def forward(ctx, w, grid):
        ctx.grid = grid
        return w.view_as(w)

    @staticmethod
    def backward(ctx, dw):
        dw = dw.contiguous().clone()
        multihost.collective(dist.all_reduce, dw, group=ctx.grid.col_group)
        return dw, None


def _reshard_plan(grid, n_nodes: int):
    """The exchange in this rank's column group from row shards to feature
    blocks. Point (i, j) needs block ``b = j * gr + i``, which lies in row
    shard ``b // gc`` at block offset ``b % gc``; it takes it from the rank
    of its own column that holds that shard. Returns, in the column group's
    rank order, the rows this rank sends to each and receives from each,
    and the first row of its shard that it sends (its blocks to send are
    consecutive)."""
    nr, _, nb = _sizes(grid, n_nodes)
    src = [(grid.j * grid.gr + i) // grid.gc for i in range(grid.gr)]
    send = [nb if s == grid.i else 0 for s in src]
    recv = [nb if k == src[grid.i] else 0 for k in range(grid.gr)]
    mine = [grid.j * grid.gr + i for i, s in enumerate(src) if s == grid.i]
    first = (mine[0] % grid.gc) * nb if mine else 0
    return send, recv, first, nr


class _Reshard(torch.autograd.Function):
    """Row shard over gr (replicated over gc) to this rank's feature block
    (gc-major over the grid): an all-to-all in the column group. The
    backward sends each block's gradient home to the rank of its column
    that sent the block, then sums over the row group, so that every rank
    of a row holds its shard's whole gradient."""

    @staticmethod
    def forward(ctx, z, grid, n_nodes):
        send, recv, first, _ = plan = _reshard_plan(grid, n_nodes)
        ctx.grid, ctx.plan = grid, plan
        inp = z[first:first + sum(send)].contiguous()
        out = z.new_empty((sum(recv),) + tuple(z.shape[1:]))
        multihost.collective(dist.all_to_all_single, out, inp, recv, send,
                             group=grid.col_group)
        return out

    @staticmethod
    def backward(ctx, d):
        grid = ctx.grid
        send, recv, first, nr = ctx.plan
        back = d.new_empty((sum(send),) + tuple(d.shape[1:]))
        multihost.collective(dist.all_to_all_single, back, d.contiguous(),
                             send, recv, group=grid.col_group)
        dz = d.new_zeros((nr,) + tuple(d.shape[1:]))
        dz[first:first + sum(send)] = back
        multihost.collective(dist.all_reduce, dz, group=grid.row_group)
        return dz, None, None


# ---------------------------------------------------------------------------
# the public surface
# ---------------------------------------------------------------------------

def spmm_15d(grid, adj: ND_Sparse_Array, h: torch.Tensor, n_nodes: int):
    """``Z = A @ H`` with the 1.5D schedule on ``grid``.

    ``adj``: this rank's block of the adjacency (:func:`shard_gcn_inputs`),
    ``N / gr`` by ``N / gc``. ``h``: this rank's feature block, (N / (gr *
    gc), F). Returns this rank's rows of Z, (N / gr, F): row shard ``i``,
    the same on every rank of the row."""
    h_slice = _GatherColumn.apply(h.contiguous(), grid)
    z = csr_spmm.matmat(adj, h_slice)
    return _SumRow.apply(z, grid)


def shard_gcn_inputs(grid, rows, cols, values, h, n_nodes, device=None):
    """This rank's inputs of :func:`spmm_15d`: its block of the COO
    adjacency (entries in input order, local indices), as an
    ``ND_Sparse_Array`` whose CSR forms are built here once, and its block
    of the features ``h``, both on ``device`` (default: the device of the
    process group, ``multihost.device()``)."""
    nr, nc, nb = _sizes(grid, n_nodes)
    device = torch.device(device) if device is not None \
        else multihost.device()
    rows, cols = np.asarray(rows), np.asarray(cols)
    mine = (rows // nr == grid.i) & (cols // nc == grid.j)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    adj = ND_Sparse_Array(put(np.asarray(values)[mine], np.float32),
                          put(rows[mine] - grid.i * nr, np.int32),
                          put(cols[mine] - grid.j * nc, np.int32), nr, nc)
    b = grid.j * grid.gr + grid.i
    return adj, put(np.asarray(h)[b * nb:(b + 1) * nb], np.float32)


def gcn_forward(grid, adj, h, weights, n_nodes):
    """Multi-layer GCN forward: Z_l = relu(A @ H_l @ W_l); the last layer
    has no relu (logits). ``weights`` are held on every rank, each taken
    through the column group's gradient sum. Between layers the activations
    move from row shards to feature blocks (an all-to-all in the column
    group); the logits stay row shard ``i``, (N / gr, classes)."""
    for k, w in enumerate(weights):
        z = spmm_15d(grid, adj, h, n_nodes)
        h = z @ _Replicated.apply(w, grid)
        if k < len(weights) - 1:
            h = _Reshard.apply(torch.relu(h), grid, n_nodes)
    return h
