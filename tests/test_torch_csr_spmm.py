"""hetu_tpu_torch's CSR sparse products against the JAX package, on the CPU.

The port's plain ``csr_spmm``/``csr_spmv`` (what a CPU tensor runs; they
sum each row in CSR order, as the CUDA kernels do) are held against
``hetu_tpu.kernels.csr_spmm``'s XLA expressions (``_spmm_xla``/
``_spmv_xla``, a gather and a ``segment_sum``) and against its Pallas
kernels run directly (``_spmm_pallas``/``_spmv_pallas``, interpret mode
off the TPU, at sizes they accept: F a multiple of 128, nrow and K
multiples of 8). The CUDA kernels run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: the reference sums in another order (``segment_sum``), so the
grade is docs/KERNELS.md's for the segment-sum kernels, allclose 1e-4,
and the relative L2 error of the whole output at most 1e-6 (a few f32
roundings per element, ~1e-7).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hetu_tpu as jt
from hetu_tpu.kernels import csr_spmm as jcs
import hetu_tpu_torch as pt
from hetu_tpu_torch.ndarray import CSRMatrix
from hetu_tpu_torch.kernels import csr_spmm as tcs, registry as treg
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
REL_L2 = 1e-6


@pytest.fixture(autouse=True)
def _clean_counts():
    treg.reset_stats()
    treg.reset_launch_counts()
    yield
    treg.reset_stats()


def _coo(case, seed=0):
    """(values, rows, cols, nrow, ncol) of a named COO matrix; the entries
    are in random order (unsorted) unless the case says otherwise."""
    rng = np.random.RandomState(seed)
    nrow, ncol, nnz = 24, 16, 160
    rows = rng.randint(0, nrow, nnz)
    cols = rng.randint(0, ncol, nnz)
    if case == "duplicates":        # every entry twice, some thrice
        rows = np.concatenate([rows, rows, rows[:20]])
        cols = np.concatenate([cols, cols, cols[:20]])
    elif case == "empty_rows":      # rows 3, 8-12 and the last hold nothing
        keep = ~np.isin(rows, [3, 8, 9, 10, 11, 12, nrow - 1])
        rows, cols = rows[keep], cols[keep]
    elif case == "nnz0":
        rows, cols = rows[:0], cols[:0]
    elif case == "sorted":
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
    elif case == "one_row":
        nrow, rows = 1, np.zeros_like(rows)
    elif case == "heavy_row":       # one row holds 120 of 280 entries
        rows = np.concatenate([rows, np.full(120, 5)])
        cols = np.concatenate([cols, rng.randint(0, ncol, 120)])
    elif case == "long_row":        # rows past 3 chunks and just past one
        c = max(tcs.SPMM_CHUNK, tcs.SPMV_CHUNK)
        extra = np.repeat([9, 2, 17], [4 * c + 7, 3 * c + 5, c + 1])
        rows = np.concatenate([rows, extra])
        cols = np.concatenate([cols, rng.randint(0, ncol, extra.size)])
        order = rng.permutation(rows.size)
        rows, cols = rows[order], cols[order]
    vals = rng.randn(rows.size).astype(np.float32)
    return vals, rows.astype(np.int32), cols.astype(np.int32), nrow, ncol


CASES = ["unsorted", "sorted", "duplicates", "empty_rows", "nnz0", "one_row",
         "heavy_row", "long_row"]


def _rel_l2(got, want):
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return num / den if den > 0 else num


def _close(got, want):
    np.testing.assert_allclose(got, want, **TOL)
    assert _rel_l2(got, want) <= REL_L2


def _sparse(vals, rows, cols, nrow, ncol):
    return pt.sparse_array(vals, (rows, cols), (nrow, ncol), ctx=pt.cpu(0))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("trans", [False, True])
def test_plain_matches_xla(case, trans):
    vals, rows, cols, nrow, ncol = _coo(case)
    a = _sparse(vals, rows, cols, nrow, ncol)
    if trans:       # Aᵀ: the reference swaps rows and cols (matmul.py:99)
        rows, cols, nrow, ncol = cols, rows, ncol, nrow
    rng = np.random.RandomState(1)
    b = rng.randn(ncol, 40).astype(np.float32)
    x = b[:, 0].copy()
    z = tcs.matmat(a, torch.from_numpy(b), trans=trans).numpy()
    zv = tcs.matvec(a, torch.from_numpy(x), trans=trans).numpy()
    want = np.asarray(jcs._spmm_xla(vals, rows, cols, jnp.asarray(b),
                                    nrow=nrow))
    want_v = np.asarray(jcs._spmv_xla(vals, rows, cols, jnp.asarray(x),
                                      nrow=nrow))
    assert z.shape == want.shape == (nrow, 40) and z.dtype == np.float32
    assert zv.shape == want_v.shape == (nrow,)
    _close(z, want)
    _close(zv, want_v)
    assert treg.launch_counts() == dict.fromkeys(treg.launch_counts(), 0)
    assert treg.dispatch_stats() == {("csr_spmm", "plain"): 1,
                                     ("csr_spmv", "plain"): 1}


@pytest.mark.parametrize("case", ["unsorted", "duplicates", "empty_rows",
                                  "long_row"])
def test_plain_matches_pallas_interpret(case):
    """``_spmm_pallas``/``_spmv_pallas`` themselves, in interpret mode."""
    vals, rows, cols, nrow, ncol = _coo(case, seed=2)
    rng = np.random.RandomState(3)
    b = rng.randn(ncol, 128).astype(np.float32)
    x = rng.randn(ncol).astype(np.float32)
    assert jcs._spmm_eligible(vals, rows, cols, b, nrow=nrow)[0]
    a = _sparse(vals, rows, cols, nrow, ncol)
    want = np.asarray(jcs._spmm_pallas(vals, rows, cols, jnp.asarray(b),
                                       nrow=nrow))
    want_v = np.asarray(jcs._spmv_pallas(vals, rows, cols, jnp.asarray(x),
                                         nrow=nrow))
    _close(tcs.matmat(a, torch.from_numpy(b)).numpy(), want)
    _close(tcs.matvec(a, torch.from_numpy(x)).numpy(), want_v)


def test_plain_sums_each_row_in_csr_order():
    """The plain version's order is the kernel's: one f32 accumulator per
    element, ((0 + v0·b0) + v1·b1) + ... over the row's entries in input
    order. Terms 1, 1e8, -1e8 in that order give 0, not 1."""
    a = _sparse(np.array([1.0, 1e8, -1e8], np.float32), np.zeros(3, int),
                np.array([0, 1, 2]), 1, 3)
    b = torch.ones(3, 2)
    assert tcs.matmat(a, b).tolist() == [[0.0, 0.0]]
    assert tcs.matvec(a, b[:, 0].contiguous()).tolist() == [0.0]
    a = _sparse(np.array([1e8, -1e8, 1.0], np.float32), np.zeros(3, int),
                np.array([0, 1, 2]), 1, 3)
    assert tcs.matmat(a, b).tolist() == [[1.0, 1.0]]


def _long_row_csr(chunk, vals_at_boundary):
    """One row of ``chunk - 1`` zeros, then ``vals_at_boundary`` (the
    first of them the chunk's last entry), over columns 0, 1, ..."""
    vals = np.concatenate([np.zeros(chunk - 1), vals_at_boundary])
    return _sparse(vals.astype(np.float32), np.zeros(vals.size, int),
                   np.arange(vals.size), 1, vals.size)


@pytest.mark.parametrize("product,chunk", [("matmat", tcs.SPMM_CHUNK),
                                           ("matvec", tcs.SPMV_CHUNK)])
def test_plain_folds_split_rows_in_chunk_order(product, chunk):
    """A split row is its chunks' partials folded left to right: 1e8 ends
    the first chunk, -1e8 and 1 open the second, so the partials are 1e8
    and -1e8 (1 is lost beside -1e8) and the row sums to 0; the serial sum
    ((1e8 - 1e8) + 1) would give 1. Rows of at most one chunk keep the
    serial sum (test_plain_sums_each_row_in_csr_order)."""
    a = _long_row_csr(chunk, [1e8, -1e8, 1.0])
    b = torch.ones(a.ncol, 2)
    if product == "matmat":
        assert tcs.matmat(a, b).tolist() == [[0.0, 0.0]]
    else:
        assert tcs.matvec(a, b[:, 0].contiguous()).tolist() == [0.0]
    # the same three terms inside the first chunk: the serial answer
    a = _long_row_csr(chunk - 3, [1e8, -1e8, 1.0])
    assert a.csr.nnz == chunk - 1
    got = (tcs.matmat(a, b)[0, 0] if product == "matmat"
           else tcs.matvec(a, b[:, 0].contiguous())[0])
    assert float(got) == 1.0


def _loop_reference(csr, b, chunk):
    """The kernels' order as a loop of numpy float32 operations: per row,
    each chunk of ``chunk`` entries summed from 0 in CSR order, then the
    partials folded left to right."""
    rowptr, col, val = (t.numpy() for t in (csr.rowptr, csr.col, csr.val))
    out = np.zeros((csr.nrow,) + b.shape[1:], np.float32)
    for r in range(csr.nrow):
        parts = []
        for c0 in range(rowptr[r], max(rowptr[r + 1], rowptr[r] + 1), chunk):
            acc = np.zeros(b.shape[1:], np.float32)
            for j in range(c0, min(c0 + chunk, rowptr[r + 1])):
                acc = acc + val[j] * b[col[j]]
            parts.append(acc)
        out[r] = functools.reduce(lambda x, y: x + y, parts)
    return out


@pytest.mark.parametrize("case", ["heavy_row", "long_row"])
def test_plain_order_is_the_chunked_loop(case):
    """The plain versions are bit-equal to the order written as a loop."""
    vals, rows, cols, nrow, ncol = _coo(case, seed=12)
    a = _sparse(vals, rows, cols, nrow, ncol)
    rng = np.random.RandomState(13)
    for csr in (a.csr, a.csr_t):
        b = rng.randn(csr.ncol, 5).astype(np.float32)
        np.testing.assert_array_equal(
            tcs._spmm_plain(csr, torch.from_numpy(b)).numpy(),
            _loop_reference(csr, b, tcs.SPMM_CHUNK))
        np.testing.assert_array_equal(
            tcs._spmv_plain(csr, torch.from_numpy(b[:, 0].copy())).numpy(),
            _loop_reference(csr, b[:, 0], tcs.SPMV_CHUNK))


def _lengths_csr(lengths, seed=0):
    """A CSR matrix whose rows hold ``lengths`` entries, in random order."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(len(lengths)), lengths)
    rows = rows[rng.permutation(rows.size)]
    return _sparse(rng.randn(rows.size).astype(np.float32), rows,
                   rng.randint(0, 8, rows.size), len(lengths), 8).csr


@pytest.mark.parametrize("chunk", sorted({tcs.SPMM_CHUNK, tcs.SPMV_CHUNK, 4}))
def test_chunk_plan_covers_every_entry_once(chunk):
    """chunk_plan's arrays, walked as the C code reads them: rows of 0, 1,
    chunk - 1, chunk, chunk + 1 and 3·chunk + 5 entries (twice, in another
    order the second time)."""
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, 3 * chunk + 5]
    lengths = lengths + lengths[::-1]
    a = _lengths_csr(lengths)
    plan = tcs.chunk_plan(a, chunk)
    assert tcs.chunk_plan(a, chunk) is plan           # cached on the CSR
    assert plan.chunk == chunk and plan.chunks.dtype == torch.int32
    assert plan.splits.dtype == torch.int32
    assert plan.chunks.is_contiguous() and plan.splits.is_contiguous()
    rowptr = a.rowptr.tolist()
    row, start, end, slot = plan.chunks.tolist()
    split_row, first, parts = plan.splits.tolist()
    # contiguous, in CSR order, every entry once, at most `chunk` long
    assert start[0] == 0 and end[-1] == a.nnz
    assert all(s == e for s, e in zip(start[1:], end[:-1]))
    assert all(0 <= e - s <= chunk for s, e in zip(start, end))
    assert row == sorted(row)
    expect_split, next_slot = [], 0
    for r, n in enumerate(lengths):
        mine = [c for c in range(len(row)) if row[c] == r]
        assert len(mine) == max(1, -(-n // chunk))
        assert start[mine[0]] == rowptr[r] and end[mine[-1]] == rowptr[r + 1]
        if n <= chunk:        # one chunk, written straight to the output
            assert [slot[c] for c in mine] == [-1]
        else:                 # consecutive slots, in chunk order
            assert [slot[c] for c in mine] == list(
                range(next_slot, next_slot + len(mine)))
            expect_split.append((r, next_slot, len(mine)))
            next_slot += len(mine)
    assert list(zip(split_row, first, parts)) == expect_split
    assert plan.nslot == next_slot == sum(parts)


def test_chunk_sizes_are_the_kernels():
    """The wrapper's chunk sizes are the ones the C entries accept."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tcs.__file__), os.pardir, "csrc",
                            "csr_spmm.cu")).read()
    consts = dict(re.findall(r"constexpr int (k\w+Chunk) = (\d+);", src))
    assert consts == {"kSpmmChunk": str(tcs.SPMM_CHUNK),
                      "kSpmvChunk": str(tcs.SPMV_CHUNK)}


def test_csr_forms_are_stable_sorts():
    vals, rows, cols, nrow, ncol = _coo("duplicates")
    a = _sparse(vals, rows, cols, nrow, ncol)
    assert (a.nrow, a.ncol, a.shape) == (nrow, ncol, (nrow, ncol))
    np.testing.assert_array_equal(a.data.numpy(), vals)    # COO kept as fed
    np.testing.assert_array_equal(a.row.numpy(), rows)
    np.testing.assert_array_equal(a.col.numpy(), cols)
    for csr, r, c, n, m in ((a.csr, rows, cols, nrow, ncol),
                            (a.csr_t, cols, rows, ncol, nrow)):
        order = np.argsort(r, kind="stable")
        assert csr.rowptr.dtype == csr.col.dtype == torch.int32
        assert csr.val.dtype == torch.float32
        assert (csr.nrow, csr.ncol, csr.nnz) == (n, m, r.size)
        np.testing.assert_array_equal(
            csr.rowptr.numpy(),
            np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))]))
        np.testing.assert_array_equal(csr.col.numpy(), c[order])
        np.testing.assert_array_equal(csr.val.numpy(), vals[order])
    with pytest.raises(ValueError, match="outside"):
        _sparse(vals, rows, cols, nrow - 1, ncol)


@pytest.mark.parametrize("trans", [False, True])
def test_gradient_matches_jax(trans):
    """dB = Aᵀ·dZ (and dx for the vector) against ``jax.grad`` through
    ``_spmm_xla``/``_spmv_xla``."""
    vals, rows, cols, nrow, ncol = _coo("duplicates", seed=4)
    a = _sparse(vals, rows, cols, nrow, ncol)
    if trans:
        rows, cols, nrow, ncol = cols, rows, ncol, nrow
    rng = np.random.RandomState(5)
    b = rng.randn(ncol, 24).astype(np.float32)
    w = rng.randn(nrow, 24).astype(np.float32)
    want = jax.grad(lambda bb: jnp.sum(jcs._spmm_xla(
        vals, rows, cols, bb, nrow=nrow) * w))(jnp.asarray(b))
    want_v = jax.grad(lambda xx: jnp.sum(jcs._spmv_xla(
        vals, rows, cols, xx, nrow=nrow) * w[:, 0]))(jnp.asarray(b[:, 0]))
    tb = torch.from_numpy(b).requires_grad_()
    tx = torch.from_numpy(b[:, 0].copy()).requires_grad_()
    (got,) = torch.autograd.grad(
        (tcs.matmat(a, tb, trans=trans) * torch.from_numpy(w)).sum(), tb)
    (got_v,) = torch.autograd.grad(
        (tcs.matvec(a, tx, trans=trans) * torch.from_numpy(w[:, 0])).sum(),
        tx)
    _close(got.numpy(), np.asarray(want))
    _close(got_v.numpy(), np.asarray(want_v))
    # forward and backward each dispatched once per product
    assert treg.dispatch_stats() == {("csr_spmm", "plain"): 2,
                                     ("csr_spmv", "plain"): 2}


def test_backward_runs_under_the_forward_mode():
    """The backward dispatches under the mode its forward ran under."""
    vals, rows, cols, nrow, ncol = _coo("unsorted")
    a = _sparse(vals, rows, cols, nrow, ncol)
    b = torch.randn(ncol, 4, requires_grad=True)
    with treg.active("off"):
        z = tcs.matmat(a, b)
    z.sum().backward()
    assert treg.dispatch_stats() == {("csr_spmm", "off"): 2}


def _graph(ht, op, trans_a, trans_b, nrow, ncol, f):
    adj = ht.Variable(name="adj", trainable=False)
    b = ht.Variable(name="b", trainable=False)
    if op == "mm":
        out = ht.csrmm_op(adj, b, trans_A=trans_a, trans_B=trans_b)
    else:
        out = ht.csrmv_op(adj, b, trans=trans_a)
    return adj, b, out


@pytest.mark.parametrize("op,trans_a,trans_b", [
    ("mm", False, False), ("mm", True, False), ("mm", False, True),
    ("mm", True, True), ("mv", False, False), ("mv", True, False)])
def test_ops_match_the_jax_executor(op, trans_a, trans_b):
    """``csrmm_op``/``csrmv_op`` through both packages' executors."""
    vals, rows, cols, nrow, ncol = _coo("duplicates", seed=6)
    k = nrow if trans_a else ncol
    rng = np.random.RandomState(7)
    b = rng.randn(*((k,) if op == "mv" else (12, k) if trans_b
                    else (k, 12))).astype(np.float32)
    outs = []
    for ht, ctx in ((jt, jt.cpu(0)), (pt, pt.cpu(0))):
        adj, bn, out = _graph(ht, op, trans_a, trans_b, nrow, ncol, 12)
        ex = ht.Executor([out], ctx=ctx)
        sp = ht.sparse_array(vals, (rows, cols), (nrow, ncol), ctx=ctx)
        outs.append(ex.run("default", feed_dict={adj: sp, bn: b},
                           convert_to_numpy_ret_vals=True)[0])
    want, got = outs
    _close(got, want)


def test_distgcn_and_sparse_input_op_match_the_jax_executor():
    vals, rows, cols, nrow, ncol = _coo("unsorted", seed=8)
    rng = np.random.RandomState(9)
    h = rng.randn(ncol, 10).astype(np.float32)
    w = rng.randn(10, 6).astype(np.float32)
    outs = []
    for ht, ctx in ((jt, jt.cpu(0)), (pt, pt.cpu(0))):
        adj = ht.graph.ops.matmul.SparseInputOp(name="adj")
        hn = ht.Variable(name="h", trainable=False)
        z = ht.distgcn_15d_op(adj, hn, ht.Variable(name="w", value=w))
        ex = ht.Executor([z], ctx=ctx)
        sp = ht.sparse_array(vals, (rows, cols), (nrow, ncol), ctx=ctx)
        outs.append(ex.run("default", feed_dict={adj: sp, hn: h},
                           convert_to_numpy_ret_vals=True)[0])
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_sparse_feed_stays_where_it_is_and_never_requires_grad():
    vals, rows, cols, nrow, ncol = _coo("unsorted")
    sp = _sparse(vals, rows, cols, nrow, ncol)
    adj = pt.Variable(name="adj", trainable=False)
    x = pt.Variable(name="x", trainable=False)
    w = pt.init.ones((ncol, 3), name="w")
    loss = pt.reduce_mean_op(pt.csrmm_op(adj, pt.matmul_op(x, w)), [0, 1])
    ex = pt.Executor([loss, pt.optim.SGDOptimizer(0.1).minimize(loss)],
                     ctx=pt.cpu(0))
    assert ex._prepare_input(sp) is sp           # same device: no copy
    x_np = np.ones((ncol, ncol), np.float32)
    l0 = ex.run("default", feed_dict={adj: sp, x: x_np})[0].asnumpy()
    l1 = ex.run("default", feed_dict={adj: sp, x: x_np})[0].asnumpy()
    assert np.isfinite([l0, l1]).all() and l1 != l0
    assert sp.to("cpu") is sp
    # abstract evaluation reads the sparse operand's shape only
    assert pt.csrmm_op(adj, x).infer_shape([sp, (ncol, 5)]) == (nrow, 5)
    assert pt.csrmv_op(adj, x, trans=True).infer_shape(
        [sp, (nrow,)]) == (ncol,)


def test_cpu_calls_launch_nothing_and_force_raises():
    vals, rows, cols, nrow, ncol = _coo("unsorted")
    a = _sparse(vals, rows, cols, nrow, ncol)
    b = torch.randn(ncol, 8)
    with treg.active("force"), pytest.raises(treg.KernelEligibilityError,
                                             match="CPU"):
        tcs.matmat(a, b)
    # a matrix off the CPU never takes the plain version: here one on the
    # meta device (not CUDA) is refused by eligibility
    meta = CSRMatrix(*(torch.empty(t.shape, dtype=t.dtype, device="meta")
                       for t in (a.csr.rowptr, a.csr.col, a.csr.val)),
                     nrow, ncol)
    with pytest.raises(treg.KernelEligibilityError, match="meta"):
        treg.dispatch("csr_spmm", meta, b.to("meta"))
    assert treg.launch_counts() == dict.fromkeys(treg.launch_counts(), 0)


def test_coo_entries_match_the_reference():
    vals, rows, cols, nrow, ncol = _coo("duplicates", seed=10)
    b = np.random.RandomState(11).randn(ncol, 7).astype(np.float32)
    got = tcs.coo_matmat(torch.from_numpy(vals), torch.from_numpy(rows),
                         torch.from_numpy(cols), nrow, torch.from_numpy(b))
    got_v = tcs.coo_matvec(torch.from_numpy(vals), torch.from_numpy(rows),
                           torch.from_numpy(cols), nrow,
                           torch.from_numpy(b[:, 0].copy()))
    with jt.kernels.registry.active("off"):
        want = jcs.coo_matmat(vals, rows, cols, nrow, jnp.asarray(b))
        want_v = jcs.coo_matvec(vals, rows, cols, nrow, jnp.asarray(b[:, 0]))
    _close(got.numpy(), np.asarray(want))
    _close(got_v.numpy(), np.asarray(want_v))
