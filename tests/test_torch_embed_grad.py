"""hetu_tpu_torch's embedding gradient against the JAX package, on the CPU.

The port's prep (stable sort, segment ids, unique rows) and its plain
segment sum (what a CPU tensor runs; it adds each id's rows in sorted
order, as the CUDA kernel ``fused_embed_grad`` does) are held against
``hetu_tpu.kernels.embed_grad``: ``_prep``, ``_segsum_xla`` (a
``segment_sum``), and ``_segsum_pallas`` run in interpret mode under
``registry.active("force")`` at the sizes it accepts (n a multiple of
128, d = 128). Then the public forms (``embed_grad_rows``,
``embed_grad_dense``), the lookup's autograd gradient against
``jax.grad`` through the JAX ``embedding_lookup_op``, and the explicit
``embedding_lookup_gradient_op`` through both executors. The CUDA kernel
runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: ``rows`` and ``count`` (integers) exactly; the sums allclose
1e-5 and relative L2 of the whole output at most 1e-6 (the reference sums
in another order; a few f32 roundings per element are ~1e-7).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hetu_tpu as jt
from hetu_tpu.kernels import embed_grad as jeg, registry as jreg
import hetu_tpu_torch as pt
from hetu_tpu_torch import initializers as tinit
from hetu_tpu_torch.kernels import embed_grad as teg, registry as treg
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
REL_L2 = 1e-6
VOCAB = 1000


@pytest.fixture(autouse=True)
def _clean_counts():
    treg.reset_stats()
    treg.reset_launch_counts()
    yield
    treg.reset_stats()


def _ids(case, seed=0):
    """(vec, idx) of a named id set: ids as float32, as the CTR data feeds
    them; the ids in random order unless the case says otherwise."""
    rng = np.random.RandomState(seed)
    n, d = {"n_odd": (77, 16), "d1": (96, 1), "d8": (200, 8),
            "tile": (256, 128)}.get(case, (130, 16))
    idx = rng.randint(0, VOCAB, n)
    if case in ("duplicates", "tile"):   # n lookups over 17 distinct rows
        idx = rng.randint(0, 17, n)
    elif case == "single_id":
        idx = np.full(n, 123)
    elif case == "sorted":
        idx = np.sort(rng.randint(0, 40, n))
    vec = rng.randn(n, d).astype(np.float32)
    return vec, idx.astype(np.float32)


CASES = ["uniform", "duplicates", "single_id", "sorted", "n_odd", "d1", "d8"]


def _rel_l2(got, want):
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return num / den if den > 0 else num


def _close(got, want):
    np.testing.assert_allclose(got, want, **TOL)
    assert _rel_l2(got, want) <= REL_L2


def _rows(vec, idx, vocab=VOCAB):
    rows, grads, count = teg.embed_grad_rows(torch.from_numpy(vec),
                                             torch.from_numpy(idx), vocab)
    return rows.numpy(), grads.numpy(), int(count)


@pytest.mark.parametrize("case", CASES)
def test_prep_and_plain_segment_sum_match_xla(case):
    vec, idx = _ids(case)
    sv, seg, rows, count, offs = teg._prep(torch.from_numpy(vec),
                                           torch.from_numpy(idx), VOCAB)
    jsv, jseg, jrows, jcount = jeg._prep(jnp.asarray(vec), jnp.asarray(idx),
                                         VOCAB)
    # the sorts are stable on both sides: the same rows in the same order
    np.testing.assert_array_equal(sv.numpy(), np.asarray(jsv))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert int(count) == int(jcount) == np.unique(idx).size
    n = vec.shape[0]
    assert offs.dtype == torch.int32 and offs.shape == (n + 1,)
    assert (offs[int(count):] == n).all()
    got = treg.dispatch("fused_embed_grad", sv, offs).numpy()
    _close(got, np.asarray(jeg._segsum_xla(jsv, jseg)))
    assert treg.dispatch_stats() == {("fused_embed_grad", "plain"): 1}
    assert treg.launch_counts()["fused_embed_grad"] == 0


@pytest.mark.parametrize("case", ["tile", "uniform_tile"])
def test_plain_matches_pallas_interpret(case):
    """``_segsum_pallas`` itself, in interpret mode, through the JAX
    registry under force (n % 128 == 0 and d == 128, its eligibility)."""
    vec, idx = _ids("tile", seed=0 if case == "tile" else 5)
    if case == "uniform_tile":
        idx = np.random.RandomState(6).randint(0, VOCAB, idx.size).astype(
            np.float32)
    jsv, jseg, _, _ = jeg._prep(jnp.asarray(vec), jnp.asarray(idx), VOCAB)
    assert jeg._segsum_eligible(jsv, jseg)[0]
    jreg.reset_stats()

    @jax.jit
    def forced(v, i):
        with jreg.active("force"):
            return jeg.embed_grad_rows(v, i, VOCAB)

    jrows, jgrads, jcount = forced(jnp.asarray(vec), jnp.asarray(idx))
    assert jreg.dispatch_stats() == {("fused_embed_grad", "forced"): 1}
    rows, grads, count = _rows(vec, idx)
    np.testing.assert_array_equal(rows, np.asarray(jrows))
    assert count == int(jcount)
    _close(grads, np.asarray(jgrads))


def test_plain_sums_each_id_in_batch_order():
    """The plain version's order is the kernel's: one f32 accumulator per
    element, ((0 + g0) + g1) + ... over an id's rows in batch order (the
    sort is stable). Rows 1, 1e8, -1e8 give 0; -1e8, 1e8, 1 give 1."""
    for vals, want in (([1.0, 1e8, -1e8], 0.0), ([-1e8, 1e8, 1.0], 1.0)):
        vec = np.array(vals, np.float32).reshape(3, 1)
        idx = np.full(3, 7.0, np.float32)
        _, grads, count = _rows(vec, idx)
        assert count == 1 and grads.tolist() == [[want], [0.0], [0.0]]


@pytest.mark.parametrize("case", CASES)
def test_public_forms_match_the_jax_functions(case):
    vec, idx = _ids(case, seed=3)
    rows, grads, count = _rows(vec, idx)
    jrows, jgrads, jcount = jeg.embed_grad_rows(jnp.asarray(vec),
                                                jnp.asarray(idx), VOCAB)
    np.testing.assert_array_equal(rows, np.asarray(jrows))
    assert rows.dtype == np.int32 and count == int(jcount)
    assert np.all(rows[count:] == VOCAB) and np.all(grads[count:] == 0.0)
    _close(grads, np.asarray(jgrads))
    shape = (VOCAB, vec.shape[1])
    dense = teg.embed_grad_dense(torch.from_numpy(vec), torch.from_numpy(idx),
                                 shape)
    assert tuple(dense.shape) == shape and dense.is_contiguous()
    _close(dense.numpy(), np.asarray(jeg.embed_grad_dense(
        jnp.asarray(vec), jnp.asarray(idx), shape)))
    _close(dense.numpy(), np.asarray(jeg.embed_grad_dense_xla(
        jnp.asarray(vec), jnp.asarray(idx), shape)))


def test_empty_batch():
    vec = torch.zeros((0, 16))
    idx = torch.zeros((0,))
    rows, grads, count = teg.embed_grad_rows(vec, idx, VOCAB)
    jrows, jgrads, jcount = jeg.embed_grad_rows(jnp.zeros((0, 16)),
                                                jnp.zeros((0,)), VOCAB)
    assert rows.shape == np.asarray(jrows).shape == (0,)
    assert grads.shape == np.asarray(jgrads).shape == (0, 16)
    assert int(count) == int(jcount) == 0
    dense = teg.embed_grad_dense(vec, idx, (VOCAB, 16))
    assert tuple(dense.shape) == (VOCAB, 16) and not dense.any()
    assert treg.dispatch_stats() == {}


@pytest.mark.parametrize("d", [1, 16])
def test_lookup_gradient_matches_jax_grad(d):
    """Autograd through the port's lookup (the gather forward, the segment
    sum backward) against ``jax.grad`` through ``jnp.take``'s vjp."""
    rng = np.random.RandomState(4)
    table = rng.randn(60, d).astype(np.float32)
    idx = rng.randint(0, 60, (8, 26)).astype(np.float32)    # duplicates
    w = rng.randn(8, 26, d).astype(np.float32)
    jop = jt.embedding_lookup_op(jt.Variable(name="t", value=table),
                                 jt.Variable(name="i", trainable=False))
    pop = pt.embedding_lookup_op(pt.Variable(name="t", value=table),
                                 pt.Variable(name="i", trainable=False))
    jfwd = np.asarray(jop.fn(jnp.asarray(table), jnp.asarray(idx)))
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jop.fn(t, jnp.asarray(idx)) * w))(jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    out = pop.fn(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(out.detach().numpy(), jfwd)
    (out * torch.from_numpy(w)).sum().backward()
    _close(t.grad.numpy(), want)
    assert treg.dispatch_stats() == {("fused_embed_grad", "plain"): 1}


def test_lookup_backward_runs_under_the_forward_mode():
    """The backward dispatches under the mode its forward ran under, on
    whichever thread autograd runs it."""
    t = torch.randn(10, 4, requires_grad=True)
    idx = torch.tensor([1.0, 2.0, 1.0])
    with treg.active("off"):
        out = teg.lookup(t, idx)
    out.sum().backward()
    assert treg.dispatch_stats() == {("fused_embed_grad", "off"): 1}
    np.testing.assert_array_equal(t.grad[1].numpy(), np.full(4, 2.0))
    with pytest.raises(ValueError, match="vocab, dim"):
        teg.lookup(torch.randn(10), idx)


def _grad_graph(ht, shape):
    vec_ = ht.Variable(name="vec", trainable=False)
    idx_ = ht.Variable(name="idx", trainable=False)
    return vec_, idx_, ht.embedding_lookup_gradient_op(vec_, idx_, shape)


@pytest.mark.parametrize("case", ["uniform", "duplicates", "d1"])
def test_explicit_gradient_op_matches_the_jax_executor(case):
    """Dense mode through both executors; rows mode through the port's
    executor, which returns the ``IndexedRows`` pair, against the JAX op's
    rows form (the JAX executor resets a rows-mode op to dense at build
    when no PS push consumes it)."""
    vec, idx = _ids(case, seed=7)
    shape = (VOCAB, vec.shape[1])
    jv, ji, jg = _grad_graph(jt, shape)
    pv, pi, pg = _grad_graph(pt, shape)
    want = jt.Executor({"d": [jg]}, ctx=jt.cpu(0)).run(
        "d", feed_dict={jv: vec, ji: idx}, convert_to_numpy_ret_vals=True)[0]
    pex = pt.Executor({"d": [pg]}, ctx=pt.cpu(0))
    got = pex.run("d", feed_dict={pv: vec, pi: idx},
                  convert_to_numpy_ret_vals=True)[0]
    assert got.shape == want.shape == shape
    _close(got, want)
    assert pg.infer_shape([vec.shape, idx.shape]) == shape

    pg.to_rows()
    jg.to_rows()
    jrows, jgrads = jg.fn(jnp.asarray(vec), jnp.asarray(idx))
    got = pex.run("d", feed_dict={pv: vec, pi: idx},
                  convert_to_numpy_ret_vals=True)[0]
    assert isinstance(got, pt.IndexedRows)
    np.testing.assert_array_equal(got.rows, np.asarray(jrows))
    _close(got.grads, np.asarray(jgrads))
    handles = pex.run("d", feed_dict={pv: vec, pi: idx})[0]
    assert isinstance(handles, pt.IndexedRows)
    np.testing.assert_array_equal(handles.rows.asnumpy(), got.rows)
    meta = pg.infer_meta([vec.shape, idx.shape])
    assert tuple(meta.rows.shape) == (idx.size,)
    assert tuple(meta.grads.shape) == (idx.size, vec.shape[1])
    pg.to_dense()
    assert not pg.rows_mode
    assert treg.dispatch_stats() == {("fused_embed_grad", "plain"): 3}
    assert treg.launch_counts()["fused_embed_grad"] == 0


def test_cpu_calls_launch_nothing_and_force_raises():
    vec, idx = _ids("uniform")
    sv, _, _, _, offs = teg._prep(torch.from_numpy(vec),
                                  torch.from_numpy(idx), VOCAB)
    with treg.active("force"), pytest.raises(treg.KernelEligibilityError,
                                             match="CPU"):
        treg.dispatch("fused_embed_grad", sv, offs)
    with treg.active("off"):
        treg.dispatch("fused_embed_grad", sv, offs)
    assert treg.dispatch_stats() == {("fused_embed_grad", "off"): 1}


def test_non_cpu_tensor_never_takes_the_plain_segment_sum():
    """A tensor off the CPU goes to the kernel path under auto: here (a
    meta tensor, not CUDA) eligibility refuses it and dispatch raises
    instead of running the plain version."""
    sv = torch.empty((8, 4), device="meta")
    offs = torch.empty((9,), dtype=torch.int32, device="meta")
    with treg.active("auto"), pytest.raises(treg.KernelEligibilityError,
                                            match="meta"):
        treg.dispatch("fused_embed_grad", sv, offs)
    assert treg.dispatch_stats() == {}


def test_a_variable_ctx_is_a_hint_the_executor_ignores():
    """``ctx=ht.gpu(0)`` on a table (the CTR models say ``ht.cpu(0)``) does
    not move it off the executor's device."""
    table = pt.init.random_normal((50, 4), stddev=0.1, name="table",
                                  is_embed=True, ctx=pt.gpu(0))
    idx_ = pt.Variable(name="idx", trainable=False)
    out = pt.embedding_lookup_op(table, idx_)
    ex = pt.Executor([out], ctx=pt.cpu(0), seed=1)
    assert ex.state["params"][id(table)].device.type == "cpu"
    got = ex.run(feed_dict={idx_: np.array([3.0, 4.0])})[0]
    assert got.shape == (2, 4)


@pytest.mark.parametrize("cls", [tinit.NormalInit, tinit.TruncatedNormalInit])
@pytest.mark.parametrize("mean,stddev", [(0.0, 0.01), (0.25, 0.06)])
def test_in_place_draw_is_bit_identical(cls, mean, stddev):
    """The initializers scale and shift their draw in place; the values are
    those of ``mean + stddev * z``, bit for bit."""
    shape = (300, 17)
    got = cls(mean, stddev, shape).init(torch.Generator().manual_seed(9))
    z = torch.empty(shape)
    gen = torch.Generator().manual_seed(9)
    if cls is tinit.NormalInit:
        z = torch.randn(shape, generator=gen, dtype=torch.float32)
    else:
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=gen)
    want = mean + stddev * z
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
