"""The slice as a whole: the MLP training step of hetu_tpu_torch against
hetu_tpu, step for step, on the CPU.

A narrow MLP (32-64-64-10, batch 128, synthetic data) is built in both
packages. The JAX executor's initial state is written with its
``Executor.save`` and read into the port with ``Executor.load``; both then
train 10 steps. Per-step losses agree within rtol 1e-5; final parameters
and optimizer slots within rtol 1e-4 / atol 1e-5, looser because Eigen and
ATen sum the matmuls in different orders and the difference compounds over
ten updates (measured over the seven optimizers below by
``tools/port_reference.py mlp-parity``: max abs diff 1.8e-7 in the
parameters and 1.5e-8 in the slots, max relative diff 2.3e-7 in the
per-step losses).
"""
import logging
import os

import numpy as np
import pytest

import hetu_tpu as jt
import hetu_tpu_torch as pt
from hetu_tpu_torch import interop
from hetu_tpu_torch.kernels import registry as treg
from test_torch_threads import one_torch_thread  # noqa: F401

LOSS_TOL = dict(rtol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS = 10

OPTS = {
    "sgd": lambda ht: ht.optim.SGDOptimizer(0.1),
    "sgd_l2reg": lambda ht: ht.optim.SGDOptimizer(0.1, l2reg=1e-3),
    "adam": lambda ht: ht.optim.AdamOptimizer(1e-3),
    "adamw_clip": lambda ht: ht.optim.AdamWOptimizer(1e-3, clip_grad_norm=0.5),
    "momentum": lambda ht: ht.optim.MomentumOptimizer(0.05),
    "nesterov": lambda ht: ht.optim.MomentumOptimizer(0.05, nesterov=True),
    "adagrad": lambda ht: ht.optim.AdaGradOptimizer(
        0.05, initial_accumulator_value=0.1),
}


def _data():
    x, y = jt.data._synthetic_classification(2048, (32,), 10, seed=42)
    return x, jt.data.convert_to_one_hot(y, 10)


def fc(ht, x, shape, name, with_relu=True):
    weight = ht.init.random_normal(shape=shape, stddev=0.1, name=name + "_weight")
    bias = ht.init.random_normal(shape=shape[-1:], stddev=0.1, name=name + "_bias")
    x = ht.matmul_op(x, weight)
    x = x + ht.broadcastto_op(bias, x)
    return ht.relu_op(x) if with_relu else x


def build(ht, opt, ctx, data=None, **loader_kw):
    x_np, y_np = data if data is not None else _data()
    x = ht.dataloader_op([ht.Dataloader(x_np, 128, "train", **loader_kw),
                          ht.Dataloader(x_np[:512], 128, "validate")])
    y_ = ht.dataloader_op([ht.Dataloader(y_np, 128, "train", **loader_kw),
                           ht.Dataloader(y_np[:512], 128, "validate")])
    h = fc(ht, x, (32, 64), "fc1")
    h = fc(ht, h, (64, 64), "fc2")
    y = fc(ht, h, (64, 10), "fc3", with_relu=False)
    loss = ht.reduce_mean_op(ht.softmaxcrossentropy_op(y, y_), [0])
    train_op = OPTS[opt](ht).minimize(loss)
    return ht.Executor({"train": [loss, y, train_op], "validate": [loss, y, y_]},
                       ctx=ctx, seed=1)


def _losses(ex, n=STEPS):
    return np.array([float(ex.run("train")[0].asnumpy()) for _ in range(n)])


def _state(ex, to_np):
    """({param name: array}, [slot trees]) of an executor of either package."""
    params = {name: to_np(ex.state["params"][id(n)])
              for name, n in zip(ex._param_file_names(), ex.param_nodes)}
    slots = [ex.state["slots"][id(n)] for n in ex._opt_nodes()]
    return params, slots


def _jax_np(a):
    return np.asarray(a)


def _torch_np(t):
    return t.detach().cpu().numpy()


def _assert_slots_close(got, want, **tol):
    assert len(got) == len(want)
    for g_op, w_op in zip(got, want):
        assert len(g_op) == len(w_op)
        for g, w in zip(g_op, w_op):
            assert set(g) == set(w)
            for k in g:
                np.testing.assert_allclose(_torch_np(g[k]), _jax_np(w[k]),
                                           **tol, err_msg=k)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_mlp_steps_match_reference(opt, tmp_path):
    jex = build(jt, opt, jt.cpu(0))
    pex = build(pt, opt, pt.cpu(0))
    jex.save(str(tmp_path))          # state before step 1
    pex.load(str(tmp_path))
    want = _losses(jex)
    got = _losses(pex)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert got[-1] < got[0]
    jp, js = _state(jex, _jax_np)
    pp, ps = _state(pex, _torch_np)
    assert list(pp) == list(jp) == ["fc1_weight", "fc1_bias", "fc2_weight",
                                    "fc2_bias", "fc3_weight", "fc3_bias"]
    for name in jp:
        np.testing.assert_allclose(pp[name], jp[name], **STATE_TOL, err_msg=name)
    _assert_slots_close(ps, js, **STATE_TOL)
    assert pex.state["step"] == jex.state["step"] == STEPS
    # the validate target reads the trained weights and agrees as well
    np.testing.assert_allclose(
        pex.run("validate", convert_to_numpy_ret_vals=True)[0],
        jex.run("validate", convert_to_numpy_ret_vals=True)[0], rtol=1e-4)
    assert pex.get_batch_num("train") == jex.get_batch_num("train") == 16
    assert pex.get_batch_num("validate") == jex.get_batch_num("validate") == 4


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_checkpoints_round_trip_both_ways(opt, tmp_path):
    jex = build(jt, opt, jt.cpu(0))
    pex = build(pt, opt, pt.cpu(0))
    _losses(jex, 3)
    _losses(pex, 5)
    # port -> reference
    pex.save(str(tmp_path / "port"))
    jex.load(str(tmp_path / "port"))
    jp, js = _state(jex, _jax_np)
    pp, ps = _state(pex, _torch_np)
    for name in pp:
        np.testing.assert_array_equal(jp[name], pp[name])
    _assert_slots_close(ps, js, rtol=0, atol=0)
    assert jex.state["step"] == 5
    # reference -> port (a fresh port executor)
    _losses(jex, 2)
    jex.save(str(tmp_path / "ref"))
    pex2 = build(pt, opt, pt.cpu(0))
    pex2.load(str(tmp_path / "ref"))
    jp, js = _state(jex, _jax_np)
    pp, ps = _state(pex2, _torch_np)
    for name in jp:
        np.testing.assert_array_equal(pp[name], jp[name])
    _assert_slots_close(ps, js, rtol=0, atol=0)
    assert pex2.state["step"] == 7
    assert sorted(os.listdir(tmp_path / "ref")) == sorted(
        os.listdir(tmp_path / "port"))


def test_params_from_numpy_carries_state_across():
    jex = build(jt, "adam", jt.cpu(0))
    _losses(jex, 2)
    jp, js = _state(jex, _jax_np)
    pex = build(pt, "adam", pt.cpu(0))
    # the reference's optimizer slots, keyed by parameter name
    slots = {name: {k: np.asarray(v) for k, v in slot.items()}
             for name, slot in zip(jp, js[0])}
    interop.params_from_numpy(pex, jp, slots)
    train = pex.subexecutors["train"]
    for node in train.res_dl_nodes:      # the reference is 2 batches in
        train._dl_cursor[id(node)] = 2
    np.testing.assert_allclose(_losses(pex, 3), _losses(jex, 3), **LOSS_TOL)
    with pytest.raises(KeyError):
        interop.params_from_numpy(pex, {"no_such_param": np.zeros(3)})
    with pytest.raises(ValueError):
        interop.params_from_numpy(pex, {"fc3_bias": np.zeros(4)})


def test_host_fed_and_device_resident_batches_agree(monkeypatch):
    """The resident dataset (uploaded once, sliced by a cursor) and the
    host path (one batch per step) train the same bits."""
    resident = build(pt, "sgd", pt.cpu(0))
    assert len(resident.subexecutors["train"].res_dl_nodes) == 2
    monkeypatch.setenv("HETU_DEVICE_DATA_MB", "0")
    host = build(pt, "sgd", pt.cpu(0))
    assert len(host.subexecutors["train"].host_dl_nodes) == 2
    np.testing.assert_array_equal(_losses(resident, 20), _losses(host, 20))


def test_kernel_modes_on_the_cpu():
    """auto and off run the plain version on CPU tensors; force demands the
    CUDA kernel and raises."""
    treg.reset_stats()
    auto = _losses(build(pt, "adam", pt.cpu(0)), 3)
    off = build(pt, "adam", pt.cpu(0))
    off.config.kernels = "off"
    np.testing.assert_array_equal(auto, _losses(off, 3))
    stats = treg.dispatch_stats()
    # one group apply of the six parameters a step
    assert stats[("fused_adam", "plain")] == stats[("fused_adam", "off")] == 3
    forced = build(pt, "adam", pt.cpu(0))
    forced.config.kernels = "force"
    with pytest.raises(treg.KernelEligibilityError, match="force"):
        forced.run("train")


def test_shuffled_loader_matches_reference(tmp_path):
    """A shuffled loader stays on the host path in both packages and draws
    the same order from RandomState(seed)."""
    jex = build(jt, "sgd", jt.cpu(0), shuffle=True, seed=3)
    pex = build(pt, "sgd", pt.cpu(0), shuffle=True, seed=3)
    assert pex.subexecutors["train"].res_dl_nodes == []
    jex.save(str(tmp_path))
    pex.load(str(tmp_path))
    np.testing.assert_allclose(_losses(pex, 20), _losses(jex, 20), **LOSS_TOL)


def test_cnn_main_trains_logreg_on_the_cpu(caplog):
    from hetu_tpu_torch.examples import cnn_main
    with caplog.at_level(logging.INFO, logger=cnn_main.__name__):
        cnn_main.main(["--model", "logreg", "--dataset", "MNIST", "--gpu", "-1",
                       "--num-epochs", "0", "--validate",
                       "--learning-rate", "0.5"])
    acc = [float(r.getMessage().split("=")[1]) for r in caplog.records
           if r.getMessage().startswith("Train accuracy")]
    assert acc and acc[-1] > 0.9


def test_dataloader_state_moves_between_packages():
    """A shuffled loader's position (cursor, order, RNG) saved by one
    package resumes the same batch sequence in the other."""
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    jd = jt.Dataloader(x, 3, shuffle=True, seed=7, drop_last=False)
    pd = pt.Dataloader(x, 3, shuffle=True, seed=7, drop_last=False)
    for _ in range(4):
        np.testing.assert_array_equal(pd.get_arr(), jd.get_arr())
    pd2 = pt.Dataloader(x, 3, shuffle=True, seed=0, drop_last=False)
    pd2.load_state_dict(jd.state_dict())
    jd2 = jt.Dataloader(x, 3, shuffle=True, seed=0, drop_last=False)
    jd2.load_state_dict(pd.state_dict())
    for _ in range(12):      # across two epoch wraps and reshuffles
        want = jd.get_arr()
        np.testing.assert_array_equal(pd2.get_arr(), want)
        np.testing.assert_array_equal(jd2.get_arr(), want)
