"""Parity of the convolution, pooling, normalization and dropout graph ops
of hetu_tpu_torch against hetu_tpu, forward and gradient, on the CPU.

Each case builds the same small graph in both packages from the same
seeded numpy inputs (trainable Variables), weights the op's output by a
fixed random tensor, sums it, and evaluates the output and ``gradients``
of that sum with respect to the differentiated inputs through each
package's ``Executor(ctx=cpu(0))``, as ``test_torch_graph.py`` does. The
explicit gradient ops are held the same way, differentiated in the
incoming gradient (and, for the convolution's, in the other operand).
``infer_shape`` must agree too. An executor without an optimizer runs no
training step, so dropout is the identity and BatchNorm reads its running
stats here; their training behaviour is in ``test_torch_norm.py``.

Tolerance rtol 1e-5 / atol 1e-6, as ``test_torch_graph.py``'s: XLA:CPU
and ATen sum a convolution's products and a norm's statistics in other
orders. The weighting tensor is drawn at 0.1 so that the gradients, sums
of up to a few hundred products, stay of order one, the scale that atol
is set for.
"""
import numpy as np
import pytest

import hetu_tpu as jt
import hetu_tpu_torch as pt
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


X7 = _r(2, 3, 7, 7, seed=1)
X8 = _r(2, 3, 8, 8, seed=2)
W3 = (_r(4, 3, 3, 3, seed=3) * 0.3).astype(np.float32)
X5 = _r(2, 3, 5, 5, seed=4)


def _conv(p, s):
    return lambda ht, x, w: ht.conv2d_op(x, w, padding=p, stride=s)


def _pool(kind, k, p, s):
    def build(ht, x):
        fn = ht.max_pool2d_op if kind == "max" else ht.avg_pool2d_op
        return fn(x, k, k, p, s)
    return build


def _pool_grad(kind, k, p, s):
    def build(ht, x, dy):
        fwd = ht.max_pool2d_op if kind == "max" else ht.avg_pool2d_op
        grad = (ht.max_pool2d_gradient_op if kind == "max"
                else ht.avg_pool2d_gradient_op)
        return grad(fwd(x, k, k, p, s), dy, x, k, k, p, s)
    return build


def _pool_out(h, k, p, s):
    return (h + 2 * p - k) // s + 1


# name -> (build(ht, *inputs) -> node, inputs, differentiated inputs (None:
# all))
CASES = {
    "conv2d_s1_p0": (_conv(0, 1), [X7, W3], None),
    "conv2d_s1_p1": (_conv(1, 1), [X7, W3], None),
    "conv2d_s2_p0": (_conv(0, 2), [X8, W3], None),
    "conv2d_s2_p1": (_conv(1, 2), [X8, W3], None),
    "conv2d_1x1_s2": (_conv(0, 2), [X8, _r(5, 3, 1, 1, seed=5)], None),
    "conv2d_gradient_of_data_s1_p1": (
        lambda ht, w, dy: ht.conv2d_gradient_of_data_op(w, dy, 1, 1),
        [W3, _r(2, 4, 7, 7, seed=6)], None),
    "conv2d_gradient_of_data_s2_p1": (
        lambda ht, w, dy: ht.conv2d_gradient_of_data_op(w, dy, 1, 2),
        [W3, _r(2, 4, 4, 4, seed=7)], None),
    "conv2d_gradient_of_data_s2_p0": (
        lambda ht, w, dy: ht.conv2d_gradient_of_data_op(w, dy, 0, 2),
        [W3, _r(2, 4, 3, 3, seed=8)], None),
    "conv2d_gradient_of_filter_s1_p1": (
        lambda ht, x, dy: ht.conv2d_gradient_of_filter_op(x, dy, 1, 1),
        [X7, _r(2, 4, 7, 7, seed=9)], None),
    "conv2d_gradient_of_filter_s2_p0": (
        lambda ht, x, dy: ht.conv2d_gradient_of_filter_op(x, dy, 0, 2),
        [X7, _r(2, 4, 3, 3, seed=10)], None),
    "conv2d_gradient_of_filter_s2_p1": (
        lambda ht, x, dy: ht.conv2d_gradient_of_filter_op(x, dy, 1, 2),
        [X8, _r(2, 4, 4, 4, seed=11)], None),
    "conv2d_broadcastto": (lambda ht, b, x: ht.conv2d_broadcastto_op(b, x),
                           [_r(3, seed=12), X5], [0]),
    "conv2d_reducesum": (lambda ht, x: ht.conv2d_reducesum_op(x), [X5], None),
    "max_pool2d_k2_s2_p0": (_pool("max", 2, 0, 2), [X8], None),
    "max_pool2d_k3_s2_p1": (_pool("max", 3, 1, 2), [X7], None),
    "max_pool2d_k2_s1_p1": (_pool("max", 2, 1, 1), [X5], None),
    # padding above half the kernel: padded here with -inf, then pooled
    "max_pool2d_k3_s2_p2": (_pool("max", 3, 2, 2), [X5], None),
    "avg_pool2d_k2_s2_p0": (_pool("avg", 2, 0, 2), [X8], None),
    "avg_pool2d_k3_s2_p1": (_pool("avg", 3, 1, 2), [X7], None),
    "avg_pool2d_k3_s2_p2": (_pool("avg", 3, 2, 2), [X5], None),
    "max_pool2d_gradient_k2_s2_p0": (
        _pool_grad("max", 2, 0, 2), [X8, _r(2, 3, 4, 4, seed=13)], [1]),
    "max_pool2d_gradient_k3_s2_p1": (
        _pool_grad("max", 3, 1, 2),
        [X7, _r(2, 3, _pool_out(7, 3, 1, 2), _pool_out(7, 3, 1, 2),
                seed=14)], [1]),
    "avg_pool2d_gradient_k2_s2_p0": (
        _pool_grad("avg", 2, 0, 2), [X8, _r(2, 3, 4, 4, seed=15)], [1]),
    "avg_pool2d_gradient_k3_s2_p1": (
        _pool_grad("avg", 3, 1, 2),
        [X7, _r(2, 3, _pool_out(7, 3, 1, 2), _pool_out(7, 3, 1, 2),
                seed=16)], [1]),
    "avg_pool2d_gradient_k3_s2_p2": (
        _pool_grad("avg", 3, 2, 2),
        [X5, _r(2, 3, _pool_out(5, 3, 2, 2), _pool_out(5, 3, 2, 2),
                seed=17)], [1]),
    "layer_normalization": (
        lambda ht, x, s, b: ht.layer_normalization_op(x, s, b),
        [_r(4, 5, 6, seed=18), _r(6, seed=19), _r(6, seed=20)], None),
    "layer_normalization_eps": (
        lambda ht, x, s, b: ht.layer_normalization_op(x, s, b, eps=1e-8),
        [_r(4, 6, seed=21), _r(6, seed=22), _r(6, seed=23)], None),
    "instance_normalization2d": (
        lambda ht, x: ht.instance_normalization2d_op(x),
        [_r(2, 3, 4, 5, seed=24)], None),
    # outside a training step: the running stats (mean 0, var 1)
    "batch_normalization_eval": (
        lambda ht, x, s, b: ht.batch_normalization_op(x, s, b),
        [X5, _r(3, seed=25), _r(3, seed=26)], None),
    # outside a training step dropout is the identity
    "dropout_eval": (lambda ht, x: ht.dropout_op(x, 0.5), [X5], None),
    "dropout2d_eval": (lambda ht, x: ht.dropout2d_op(x, 0.5), [X5], None),
    "dropout_gradient_eval": (
        lambda ht, x, g: ht.dropout_gradient_op(g, 0.5, ht.dropout_op(x, 0.5)),
        [X5, _r(2, 3, 5, 5, seed=27)], [1]),
    "dropout2d_gradient_eval": (
        lambda ht, x, g: ht.dropout2d_gradient_op(g, 0.5,
                                                  ht.dropout2d_op(x, 0.5)),
        [X5, _r(2, 3, 5, 5, seed=28)], [1]),
}

# the 16 op constructors of the three files; the cases above reach each
CONSTRUCTORS = (
    "conv2d_op", "conv2d_gradient_of_data_op", "conv2d_gradient_of_filter_op",
    "conv2d_broadcastto_op", "conv2d_reducesum_op", "max_pool2d_op",
    "max_pool2d_gradient_op", "avg_pool2d_op", "avg_pool2d_gradient_op",
    "batch_normalization_op", "layer_normalization_op",
    "instance_normalization2d_op", "dropout_op", "dropout_gradient_op",
    "dropout2d_op", "dropout2d_gradient_op")


def _run(ht, name):
    build, inputs, diff = CASES[name]
    diff = range(len(inputs)) if diff is None else diff
    xs = [ht.Variable(name=f"x{i}", value=v, trainable=i in diff)
          for i, v in enumerate(inputs)]
    out = build(ht, *xs)
    probe = ht.Executor([out], ctx=ht.cpu(0), seed=0).run()[0].asnumpy()
    w = ht.Variable(name="w", value=0.1 * _r(*probe.shape, seed=99),
                    trainable=False)
    loss = ht.reduce_sum_op(ht.mul_op(out, w), list(range(probe.ndim)))
    fetch = [out] + ht.gradients(loss, [xs[i] for i in diff])
    return ht.Executor(fetch, ctx=ht.cpu(0), seed=0).run(
        convert_to_numpy_ret_vals=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_forward_and_gradient_parity(name):
    want = _run(jt, name)
    got = _run(pt, name)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"output {k}")


# cases whose output node does not read the Variables directly
COMPOSITE = {n for n in CASES if "pool2d_gradient" in n}


@pytest.mark.parametrize("name", sorted(set(CASES) - COMPOSITE))
def test_infer_shape_on_meta_tensors(name):
    build, inputs, _ = CASES[name]
    jout = build(jt, *[jt.Variable(name=f"x{i}", value=v)
                       for i, v in enumerate(inputs)])
    pout = build(pt, *[pt.Variable(name=f"x{i}", value=v)
                       for i, v in enumerate(inputs)])
    assert all(isinstance(i, pt.graph.node.PlaceholderOp) for i in pout.inputs)
    shapes = [tuple(i.shape) for i in pout.inputs]
    meta = pout.infer_meta(shapes)
    assert meta.device.type == "meta"
    assert pout.infer_shape(shapes) == jout.infer_shape(shapes)


def test_every_constructor_is_exported_and_covered():
    import inspect
    from hetu_tpu_torch.graph.ops import conv, dropout, norm
    ported = {n for m in (conv, dropout, norm) for n, f in vars(m).items()
              if n.endswith("_op") and inspect.isfunction(f)
              and f.__module__ == m.__name__}
    assert ported == set(CONSTRUCTORS)
    for n in CONSTRUCTORS + ("BatchNormOp",):
        assert getattr(pt, n) is not None and hasattr(jt, n)


def test_max_pool_pads_with_minus_infinity():
    """Negative inputs under a padded max pool: the padding never wins."""
    x = -np.abs(_r(1, 1, 4, 4, seed=30)) - 1.0
    got = pt.Executor([pt.max_pool2d_op(pt.Variable(name="x", value=x), 3, 3,
                                        2, 2)], ctx=pt.cpu(0)).run(
        convert_to_numpy_ret_vals=True)[0]
    want = jt.Executor([jt.max_pool2d_op(jt.Variable(name="x", value=x), 3, 3,
                                         2, 2)], ctx=jt.cpu(0)).run(
        convert_to_numpy_ret_vals=True)[0]
    assert (got < -1.0).all()
    np.testing.assert_array_equal(got, want)
