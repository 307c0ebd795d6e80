"""Per-op parity of hetu_tpu_torch against hetu_tpu, forward and gradient.

Each case builds the same small graph in both packages from the same
numpy inputs (trainable Variables), weights the op's output by a fixed
random tensor, sums it, and evaluates the output and ``gradients`` of that
sum with respect to every float input through each package's
``Executor(ctx=cpu(0))``. ``infer_shape`` (meta tensors in the port,
``jax.eval_shape`` in the reference) must agree too.

Tolerance rtol 1e-5 / atol 1e-6: XLA:CPU and ATen evaluate exp/log/tanh/
erf and sums with different instruction sequences and orders, which
moves float32 results by a few ulps.
"""
import numpy as np
import pytest

import hetu_tpu as jt
import hetu_tpu_torch as pt
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _r(*shape, seed=0, pos=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(x) + 0.5 if pos else x


def _probs(*shape, seed=0):
    return (1.0 / (1.0 + np.exp(-_r(*shape, seed=seed)))).astype(np.float32)


def _onehot(n, c, seed=0):
    y = np.random.RandomState(seed).randint(0, c, n)
    return np.eye(c, dtype=np.float32)[y]


A, B = _r(4, 6, seed=1), _r(4, 6, seed=2)
P = _r(4, 6, seed=3, pos=True)

# name -> (build(ht, *inputs) -> node, inputs, which inputs are
# differentiated (None: all float inputs))
CASES = {
    "add": (lambda ht, a, b: ht.add_op(a, b), [A, B], None),
    "addbyconst": (lambda ht, a: ht.addbyconst_op(a, 2.5), [A], None),
    "mul": (lambda ht, a, b: ht.mul_op(a, b), [A, B], None),
    "mul_byconst": (lambda ht, a: ht.mul_byconst_op(a, -1.5), [A], None),
    "div": (lambda ht, a, p: ht.div_op(a, p), [A, P], None),
    "div_const": (lambda ht, p: ht.div_const_op(3.0, p), [P], None),
    "opposite": (lambda ht, a: ht.opposite_op(a), [A], None),
    "sqrt": (lambda ht, p: ht.sqrt_op(p), [P], None),
    "rsqrt": (lambda ht, p: ht.rsqrt_op(p), [P], None),
    "oneslike": (lambda ht, a: ht.oneslike_op(a), [A], []),
    "zeroslike": (lambda ht, a: ht.zeroslike_op(a), [A], []),
    "where": (lambda ht, c, a, b: ht.where_op(c, a, b),
              [(A > 0).astype(np.float32), A, B], [1, 2]),
    "relu": (lambda ht, a: ht.relu_op(a), [A], None),
    # at exactly 0 both packages hand half the gradient to each side
    "relu_at_zero": (lambda ht, a: ht.relu_op(a),
                     [np.array([[-1.0, 0.0, 2.0]], np.float32)], None),
    "relu_gradient": (lambda ht, a, g: ht.relu_gradient_op(a, g), [A, B], [1]),
    "leaky_relu": (lambda ht, a: ht.leaky_relu_op(a, 0.1), [A], None),
    "leaky_relu_gradient": (lambda ht, a, g: ht.leaky_relu_gradient_op(a, g, 0.1),
                            [A, B], [1]),
    "sigmoid": (lambda ht, a: ht.sigmoid_op(a), [A], None),
    "tanh": (lambda ht, a: ht.tanh_op(a), [A], None),
    "gelu": (lambda ht, a: ht.gelu_op(a), [A], None),
    "exp": (lambda ht, a: ht.exp_op(a), [A], None),
    "log": (lambda ht, p: ht.log_op(p), [P], None),
    "softmax": (lambda ht, a: ht.softmax_op(a), [A], None),
    "softmax_gradient": (lambda ht, a, g: ht.softmax_gradient_op(
        ht.softmax_op(a), g), [A, B], None),
    "overloads": (lambda ht, a, p: (2.0 - a) * p / 2.0 + 3.0 / p - (-a),
                  [A, P], None),
    "array_reshape": (lambda ht, a: ht.array_reshape_op(a, (3, 8)), [A], None),
    "array_reshape_gradient": (lambda ht, a, g: ht.array_reshape_gradient_op(
        a, g), [A, _r(24, seed=4)], [1]),
    "transpose": (lambda ht, a: ht.transpose_op(a), [A], None),
    "transpose_perm": (lambda ht, x: ht.transpose_op(x, (1, 2, 0)),
                       [_r(2, 3, 4, seed=5)], None),
    "slice": (lambda ht, a: ht.slice_op(a, (1, 2), (2, -1)), [A], None),
    "slice_gradient": (lambda ht, g: ht.slice_gradient_op(g, (1, 2), (4, 6)),
                       [_r(2, 4, seed=6)], None),
    "split": (lambda ht, a: ht.split_op(a, [1], [1], [3]), [A], None),
    "split_gradient": (lambda ht, g: ht.split_gradient_op(g, [1], [1], [3]),
                       [_r(4, 2, seed=7)], None),
    "concat": (lambda ht, a, b: ht.concat_op(a, b, axis=1), [A, B], None),
    "concat_gradient": (lambda ht, g, x: ht.concat_gradient_op(g, x, 1, 1),
                        [_r(4, 9, seed=8), _r(4, 3, seed=9)], [0]),
    "pad": (lambda ht, a: ht.pad_op(a, [(1, 2)], constant_values=0.5), [A], None),
    "pad_gradient": (lambda ht, g: ht.pad_gradient_op(g, [(1, 2)]), [A], None),
    "broadcastto": (lambda ht, b, a: ht.broadcastto_op(b, a),
                    [_r(6, seed=10), A], [0]),
    "broadcast_shape": (lambda ht, b: ht.broadcast_shape_op(b, (4, 6), (0,)),
                        [_r(6, seed=11)], None),
    "reduce_sum": (lambda ht, a: ht.reduce_sum_op(a, [1]), [A], None),
    "reduce_sum_keepdims": (lambda ht, x: ht.reduce_sum_op(x, [0, 2], True),
                            [_r(2, 3, 4, seed=12)], None),
    "reduce_mean": (lambda ht, a: ht.reduce_mean_op(a, [0]), [A], None),
    "reducesumaxiszero": (lambda ht, a: ht.reducesumaxiszero_op(a), [A], None),
    "one_hot": (lambda ht, i: ht.one_hot_op(i, 5),
                [np.array([0, 3, 4, 1, 7, -1], np.float32)], []),
    "matmul": (lambda ht, a, b: ht.matmul_op(a, b), [A, _r(6, 5, seed=13)], None),
    "matmul_trans": (lambda ht, a, b: ht.matmul_op(a, b, True, True),
                     [_r(6, 4, seed=14), _r(5, 6, seed=15)], None),
    "batch_matmul": (lambda ht, a, b: ht.batch_matmul_op(a, b, trans_B=True),
                     [_r(2, 3, 4, seed=16), _r(2, 5, 4, seed=17)], None),
    "matrix_dot": (lambda ht, a, b: ht.matrix_dot_op(a, b), [A, B], None),
    "softmaxcrossentropy": (lambda ht, a, y: ht.softmaxcrossentropy_op(a, y),
                            [A, _onehot(4, 6)], [0]),
    "softmaxcrossentropy_gradient": (
        lambda ht, a, y, d: ht.softmaxcrossentropy_gradient_op(a, y, d),
        [A, _onehot(4, 6), _r(4, seed=18)], [0, 2]),
    "binarycrossentropy": (lambda ht, p, y: ht.binarycrossentropy_op(p, y),
                           [_probs(4, 6), (A > 0).astype(np.float32)], [0]),
    "binarycrossentropy_gradient": (
        lambda ht, p, y, d: ht.binarycrossentropy_gradient_op(p, y, d),
        [_probs(4, 6), (A > 0).astype(np.float32), B], [0, 2]),
}


def _run(ht, name):
    build, inputs, diff = CASES[name]
    diff = range(len(inputs)) if diff is None else diff
    xs = [ht.Variable(name=f"x{i}", value=v, trainable=i in diff)
          for i, v in enumerate(inputs)]
    out = build(ht, *xs)
    fetch = [out]
    if diff:
        probe = ht.Executor([out], ctx=ht.cpu(0), seed=0).run()[0].asnumpy()
        w = ht.Variable(name="w", value=_r(*probe.shape, seed=99),
                        trainable=False)
        loss = ht.reduce_sum_op(ht.mul_op(out, w), list(range(probe.ndim)))
        fetch += ht.gradients(loss, [xs[i] for i in diff])
    return ht.Executor(fetch, ctx=ht.cpu(0), seed=0).run(
        convert_to_numpy_ret_vals=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_forward_and_gradient_parity(name):
    want = _run(jt, name)
    got = _run(pt, name)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"output {k}")


# cases whose output node does not read the Variables directly
COMPOSITE = {"overloads", "softmax_gradient"}


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


def test_executor_ctx_none_means_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = pt.Variable(name="x", value=A)
    for ctx in (None, pt.gpu(0), pt.tpu(0), "gpu:0"):
        with pytest.raises(RuntimeError, match=r"ctx=ht\.cpu\(0\)"):
            pt.Executor([pt.relu_op(x)], ctx=ctx)


def test_gradient_wrt_intermediate_and_two_gradient_calls():
    """gradients() w.r.t. an intermediate node treats it as an independent
    input (the reference's re-trace semantics), and two gradients() calls in
    one target each get their own backward."""
    def build(ht):
        x = ht.Variable(name="x", value=A)
        w = ht.Variable(name="w", value=_r(6, 3, seed=20))
        h = ht.tanh_op(ht.matmul_op(x, w))
        l1 = ht.reduce_sum_op(ht.mul_op(h, h), [0, 1])
        l2 = ht.reduce_mean_op(ht.exp_op(ht.matmul_op(x, w)), [0, 1])
        return [l1, l2] + ht.gradients(l1, [h, w]) + ht.gradients(l2, [x, w])

    want = jt.Executor(build(jt), ctx=jt.cpu(0)).run(convert_to_numpy_ret_vals=True)
    got = pt.Executor(build(pt), ctx=pt.cpu(0)).run(convert_to_numpy_ret_vals=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
