"""The CNN zoo (slice 2) as a whole: every model of ``examples/cnn/models``
trained through hetu_tpu_torch against hetu_tpu, step for step, on the CPU.

Each model is built in both packages (the JAX builders through
``conftest.import_example_models("cnn")``, the port's from
``hetu_tpu_torch.examples.cnn_models``) on seeded inputs at batch 8.
The JAX executor's initial state (parameters and BatchNorm's running
stats) is written with its ``Executor.save`` and read into the port with
``Executor.load``; both then train 2–3 SGD steps (Adam for ``vit``).
Per-step losses agree within rtol 1e-5 and the parameters after them
within atol 1e-5 (the convolutions, products and batch statistics sum in
other orders in XLA and ATen), and so are BatchNorm's running stats. The learning rates (``MODELS``) are small enough for
the deep BatchNorm models' steps to stay where the loss is smooth. A ReLU
whose input lies within the two packages' rounding (about 1e-5) of zero
takes the other side in one of them, and then, through BatchNorm's
coupling of a channel and a max pool's choice, moves the step's gradient
by far more than rounding: measured on the CPU, one such element in a
layer of 131,072 moves VGG-16's first gradient at batch 8 by 0.9 %
(relative L2), and one in a layer of 32,768 ResNet-18's at batch 4 by
0.7 %. At the rates used
here such a step moves a parameter by less than the tolerance. AlexNet's two dropouts draw other bits in
each package, so its parity runs with them at keep_prob 1 in both, and it
trains with them on the port alone. ResNet-34 runs on the port alone
(build, one step, a finite loss) to keep the file's time down; ResNet-18
carries the ResNet parity.

The bf16 compute mode: LeNet in bf16 on both executors from the same
parameters, 3 steps; losses and parameters within a relative L2 of 2e-2
of each other (the two packages round each op's bf16 result after sums
in other orders), parameters and slots float32.
"""
import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import hetu_tpu as jt
import hetu_tpu_torch as pt
from hetu_tpu_torch.examples import cnn_main, cnn_models
from hetu_tpu_torch.kernels import fused_opt, registry as treg
from conftest import import_example_models
from test_torch_threads import one_torch_thread  # noqa: F401

BATCH = 8
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=0, atol=1e-5)
BF16_REL = 2e-2

# model -> (input shape, steps, optimizer, learning rate, builder kwargs).
# The learning rates keep each step where the loss is smooth: on 8 random
# images a step of VGG at 1e-3, or of ResNet-18 at 1e-2, takes the loss
# from about 3-4 to about 0.1 (or past 16), and a relative difference of
# 1e-6 in the first gradient grows past 1e-4 by the next loss.
MODELS = {
    "mlp": ((3072,), 2, "sgd", 0.01, dict(input_dim=3072)),
    "logreg": ((784,), 3, "sgd", 0.01, dict(input_dim=784)),
    "cnn_3_layers": ((1, 28, 28), 3, "sgd", 0.01, {}),
    "lenet": ((1, 28, 28), 3, "sgd", 0.01, {}),
    "alexnet": ((3, 32, 32), 2, "sgd", 0.01, {}),
    "vgg16": ((3, 32, 32), 2, "sgd", 1e-4, {}),
    "vgg19": ((3, 32, 32), 2, "sgd", 1e-4, {}),
    "resnet18": ((3, 32, 32), 2, "sgd", 1e-3, {}),
    "rnn": ((784,), 3, "sgd", 0.01, {}),
    "lstm": ((784,), 3, "sgd", 0.01, {}),
    "vit": ((3, 32, 32), 3, "adam", 1e-3, dict(batch=BATCH)),
}


def _feed(shape, batch, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, *shape).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.randint(0, 10, batch)])


def _build(ht, fn, opt, lr=0.01, **kw):
    x = ht.Variable(name="x", trainable=False)
    y_ = ht.Variable(name="y_", trainable=False)
    loss, y = fn(x, y_, 10, **kw)
    make = (ht.optim.SGDOptimizer if opt == "sgd"
            else ht.optim.AdamOptimizer)
    return x, y_, loss, make(lr).minimize(loss)


def _no_dropout(monkeypatch):
    """Both packages' dropout at keep_prob 1 while a builder runs."""
    for ht in (jt, pt):
        orig = ht.dropout_op
        monkeypatch.setattr(ht, "dropout_op",
                            lambda x, keep, ctx=None, _o=orig: _o(x, 1.0))


def _train(ht, ex, x, y_, xv, yv, steps):
    return np.array([float(ex.run("train", feed_dict={x: xv, y_: yv})[0]
                           .asnumpy()) for _ in range(steps)])


def _params(ex, to_np):
    return {name: to_np(ex.state["params"][id(n)])
            for name, n in zip(ex._param_file_names(), ex.param_nodes)}


def _pair(name, tmp_path, monkeypatch, **ex_kw):
    """Both executors of ``name`` from the JAX one's saved initial state."""
    shape, steps, opt, lr, kw = MODELS[name]
    if name == "alexnet":
        _no_dropout(monkeypatch)
    jfn = getattr(import_example_models("cnn"), name)
    jx, jy, jloss, jop = _build(jt, jfn, opt, lr, **kw)
    px, py, ploss, pop = _build(pt, cnn_models.MODELS[name], opt, lr, **kw)
    jex = jt.Executor({"train": [jloss, jop]}, ctx=jt.cpu(0), seed=0,
                      **ex_kw.get("jax", {}))
    pex = pt.Executor({"train": [ploss, pop]}, ctx=pt.cpu(0), seed=1,
                      **ex_kw.get("port", {}))
    jex.save(str(tmp_path))
    pex.load(str(tmp_path))
    return (jex, jx, jy), (pex, px, py)


def _hold_adam(name, got, want, steps, lr, key_bias):
    """Adam's first steps move each element by about lr times the sign of
    its gradient, so an element whose gradient lies within rounding of 0
    may step either way in either package: all elements within
    2 · steps · lr, and all but one in a thousand within PARAM_TOL. An
    attention's ``key_bias`` is all such elements: softmax ignores a shift
    shared by every key, so its gradient is 0 in exact arithmetic."""
    err = np.abs(got - want)
    assert err.max() <= 2 * steps * lr + PARAM_TOL["atol"], name
    if not key_bias:
        assert np.mean(err > PARAM_TOL["atol"]) <= 1e-3, (name, err.max())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_reference(name, tmp_path, monkeypatch):
    shape, steps, opt, lr, _ = MODELS[name]
    (jex, jx, jy), (pex, px, py) = _pair(name, tmp_path, monkeypatch)
    xv, yv = _feed(shape, BATCH)
    treg.reset_stats()
    want = _train(jt, jex, jx, jy, xv, yv, steps)
    got = _train(pt, pex, px, py, xv, yv, steps)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert np.isfinite(got).all()
    jp = _params(jex, np.asarray)
    pp = _params(pex, lambda t: t.numpy())
    assert list(pp) == list(jp)
    for k in jp:
        if opt == "adam":
            _hold_adam(k, pp[k], jp[k], steps, lr, k.endswith("_k_b"))
        else:
            np.testing.assert_allclose(pp[k], jp[k], **PARAM_TOL, err_msg=k)
    # the running stats of every BatchNorm, where the model has them
    assert len(pex._stateful_nodes()) == len(jex._stateful_nodes())
    for pn, jn in zip(pex._stateful_nodes(), jex._stateful_nodes()):
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                pex.state["op_state"][id(pn)][k].numpy(),
                np.asarray(jex.state["op_state"][id(jn)][k]),
                **PARAM_TOL, err_msg=k)
    # one optimizer dispatch a step, all parameters as one group
    kname = "fused_sgd" if opt == "sgd" else "fused_adam"
    assert treg.dispatch_stats() == {(kname, "plain"): steps}


def test_resnet_parameter_counts_and_optimizer_launches():
    """ResNet-18's 62 tensors (11,173,962 parameters) are two launches of
    the SGD kernel an apply (48 tensors a launch), ResNet-34's 110 three."""
    for name, tensors, launches in (("resnet18", 62, 2), ("resnet34", 110, 3)):
        x, y_, loss, op = _build(pt, cnn_models.MODELS[name], "sgd")
        sizes = tuple(int(np.prod(v.shape)) for v in op.vars)
        assert len(sizes) == tensors
        assert len(fused_opt.opt_plan(sizes, (True,) * tensors).launches) \
            == launches
        if name == "resnet18":
            assert sum(sizes) == 11_173_962
        n_bn = sum(isinstance(n, pt.BatchNormOp)
                   for n in pt.find_topo_sort([loss]))
        assert n_bn == (tensors - 2) // 3


def test_resnet34_trains_a_step_on_the_port():
    x, y_, loss, op = _build(pt, cnn_models.resnet34, "sgd")
    ex = pt.Executor({"train": [loss, op]}, ctx=pt.cpu(0), seed=0)
    xv, yv = _feed((3, 32, 32), 2)
    lv = float(ex.run("train", feed_dict={x: xv, y_: yv})[0].asnumpy())
    assert np.isfinite(lv)
    assert len(ex.state["op_state"]) == 36
    assert all(np.isfinite(s["var"].numpy()).all()
               for s in ex.state["op_state"].values())


def test_alexnet_trains_with_dropout_on_the_port():
    x, y_, loss, op = _build(pt, cnn_models.alexnet, "sgd")
    ex = pt.Executor({"train": [loss, op], "validate": [loss]},
                     ctx=pt.cpu(0), seed=0)
    xv, yv = _feed((3, 32, 32), 4)
    losses = _train(pt, ex, x, y_, xv, yv, 2)
    assert np.isfinite(losses).all()
    # outside training the dropouts are identities: validate repeats
    v1 = ex.run("validate", feed_dict={x: xv, y_: yv})[0].asnumpy()
    v2 = ex.run("validate", feed_dict={x: xv, y_: yv})[0].asnumpy()
    assert v1 == v2


def test_bfloat16_lenet_matches_the_reference_in_bfloat16(tmp_path,
                                                          monkeypatch):
    (jex, jx, jy), (pex, px, py) = _pair(
        "lenet", tmp_path, monkeypatch,
        jax={"dtype": jnp.bfloat16}, port={"dtype": "bfloat16"})
    xv, yv = _feed((1, 28, 28), BATCH)
    want = _train(jt, jex, jx, jy, xv, yv, 3)
    got = _train(pt, pex, px, py, xv, yv, 3)
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL
    jp = _params(jex, np.asarray)
    pp = _params(pex, lambda t: t.numpy())
    for k in jp:
        assert pp[k].dtype == np.float32 and jp[k].dtype == np.float32
        assert np.linalg.norm(pp[k] - jp[k]) / np.linalg.norm(jp[k]) \
            < BF16_REL, k
    assert pex.config.compute_dtype == torch.bfloat16


def test_executor_dtype_forms():
    x = pt.Variable(name="x", value=np.ones((2, 3), np.float32))
    for dtype, want in ((np.float32, torch.float32),
                        ("float32", torch.float32),
                        ("bfloat16", torch.bfloat16),
                        (torch.bfloat16, torch.bfloat16)):
        ex = pt.Executor([pt.relu_op(x)], ctx=pt.cpu(0), dtype=dtype)
        assert ex.config.compute_dtype == want
        (out,) = ex.run()
        assert out.handle.dtype == want
        assert out.asnumpy().dtype == np.float32
    for bad in ("float16", np.float64, torch.float16):
        with pytest.raises(ValueError, match="bfloat16"):
            pt.Executor([pt.relu_op(x)], ctx=pt.cpu(0), dtype=bad)


def test_adam_slots_stay_float32_under_bfloat16():
    x, y_, loss, op = _build(pt, cnn_models.lenet, "adam")
    ex = pt.Executor({"train": [loss, op]}, ctx=pt.cpu(0), seed=0,
                     dtype="bfloat16")
    xv, yv = _feed((1, 28, 28), 4)
    _train(pt, ex, x, y_, xv, yv, 2)
    for slots in ex.state["slots"].values():
        for s in slots:
            assert all(v.dtype == torch.float32 for v in s.values())
    assert all(ex.state["params"][id(n)].dtype == torch.float32
               for n in ex.param_nodes)


def test_load_dataset_shapes_the_inputs_as_the_reference(monkeypatch):
    """``examples/cnn/main.py:74-85``'s shapes, on small stand-ins for the
    synthetic sets (drawing them whole takes seconds)."""
    def cifar(num_class=10):
        y = np.eye(num_class, dtype=np.float32)[:4]
        return np.zeros((4, 3, 32, 32), np.float32), y, \
            np.zeros((2, 3, 32, 32), np.float32), y[:2]

    mnist = [(np.zeros((4, 784), np.float32), np.eye(10)[:4])] * 3
    monkeypatch.setattr(pt.data, "normalize_cifar", cifar)
    monkeypatch.setattr(pt.data, "mnist", lambda: mnist)
    for model, dataset, shape in (("resnet18", "CIFAR10", (3, 32, 32)),
                                  ("mlp", "CIFAR10", (3072,)),
                                  ("lenet", "MNIST", (1, 28, 28)),
                                  ("cnn_3_layers", "MNIST", (1, 28, 28)),
                                  ("rnn", "MNIST", (784,)),
                                  ("vit", "CIFAR100", (3, 32, 32))):
        tx, ty, vx, vy, _, num_class = cnn_main.load_dataset(dataset, model)
        assert tx.shape[1:] == vx.shape[1:] == shape, model
        assert ty.shape[1] == num_class


def test_data_augmentation_matches_the_reference():
    imgs = np.random.RandomState(0).randn(6, 3, 8, 8).astype(np.float32)
    for kw in (dict(crop=True), dict(flip=True), dict(whiten=True),
               dict(noise=True), dict(crop=True, flip=True, whiten=True,
                                      noise=True)):
        np.random.seed(7)
        want = jt.data.data_augmentation(imgs, **kw)
        got = pt.data.data_augmentation(imgs, rng=np.random.RandomState(7),
                                        **kw)
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
        np.testing.assert_array_equal(
            pt.data.data_augmentation(imgs, mode="validate", **kw),
            jt.data.data_augmentation(imgs, mode="validate", **kw))


def test_cnn_main_trains_the_zoo_on_the_cpu(capsys):
    """The entry point on the CPU: a model of the zoo trains, and the JSON
    summary reports the dtype it ran in (nothing launches on the CPU)."""
    for model, dataset, dtype in (("lenet", "MNIST", "bfloat16"),
                                  ("cnn_3_layers", "MNIST", "float32")):
        cnn_main.main(["--model", model, "--dataset", dataset, "--gpu", "-1",
                       "--num-epochs", "0", "--steps", "2", "--batch-size",
                       "8", "--seed", "0", "--dtype", dtype])
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert res["model"] == model and res["dtype"] == dtype
        assert res["launches_per_step"] == {} and res["step_ms"] > 0
    with pytest.raises(SystemExit):
        cnn_main.main(["--model", "resnet18", "--dataset", "CIFAR10",
                       "--gpu", "-1", "--profile", "out"])
