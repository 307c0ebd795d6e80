"""hetu_tpu_torch's fused optimizer steps against the JAX package.

The port's plain SGD/Adam/AdamW (what a CPU tensor runs) is held against
``hetu_tpu.kernels.fused_opt``'s XLA expressions (``_sgd_xla``/
``_adam_xla``) and its Pallas kernels (``sgd_step``/``adam_step`` under
``registry.active("force")``, interpret mode on the CPU, both sides under
``jax.jit`` as tests/test_kernels.py runs them). The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: SGD rtol 1e-6 / atol 1e-7 (one multiply and one subtract per
element, rounded alike); Adam rtol 1e-5 / atol 1e-6, because beta**t and
sqrt may differ by an ulp between XLA:CPU and ATen.
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_tpu import optimizer as jopt
from hetu_tpu.kernels import fused_opt as jfo, registry as jreg
from hetu_tpu_torch import optimizer as topt
from hetu_tpu_torch.kernels import fused_opt as tfo, registry as treg
from test_torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(37, 19), (256,)]          # 37*19 = 703: not a multiple of 128
SGD_TOL = dict(rtol=1e-6, atol=1e-7)
ADAM_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 0.05


@pytest.fixture(autouse=True)
def _clean_counts():
    treg.reset_stats()
    treg.reset_launch_counts()
    yield
    treg.reset_stats()
    treg.reset_launch_counts()


def _jit_in_mode(fn, mode):
    @jax.jit
    def wrapped(*a):
        with jreg.active(mode):
            return fn(*a)
    return wrapped


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("l2reg", [0.0, 1e-2])
def test_sgd_plain_matches_jax(shape, l2reg):
    p, g = _rand(shape, 0), _rand(shape, 1)
    opt = jopt.SGDOptimizer(LR, l2reg=l2reg)
    want_xla = np.asarray(jax.jit(
        lambda p, g: jfo._sgd_xla(p, g, LR, l2reg=l2reg))(p, g))
    want_pallas = np.asarray(_jit_in_mode(
        lambda p, g: jfo.sgd_step(opt, p, g, LR), "force")(p, g))
    got = tfo._sgd_plain(torch.from_numpy(p), torch.from_numpy(g),
                         torch.tensor(LR), l2reg=l2reg).numpy()
    np.testing.assert_allclose(got, want_xla, **SGD_TOL)
    np.testing.assert_allclose(got, want_pallas, **SGD_TOL)
    # the step entry point updates the parameter in place, on the CPU
    # through the plain version
    pt = torch.from_numpy(p.copy())
    out = tfo.sgd_step(topt.SGDOptimizer(LR, l2reg=l2reg), pt,
                       torch.from_numpy(g), torch.tensor(LR))
    assert out is pt
    np.testing.assert_allclose(pt.numpy(), got, rtol=0, atol=0)


ADAM_CASES = {
    "adam": (jopt.AdamOptimizer, topt.AdamOptimizer, {}),
    "adam_l2reg": (jopt.AdamOptimizer, topt.AdamOptimizer, {"l2reg": 1e-2}),
    "adam_wd": (jopt.AdamOptimizer, topt.AdamOptimizer,
                {"weight_decay": 1e-2}),
    "adamw": (jopt.AdamWOptimizer, topt.AdamWOptimizer, {}),
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", sorted(ADAM_CASES))
def test_adam_five_steps_match_jax(shape, case):
    jcls, tcls, kw = ADAM_CASES[case]
    p0 = _rand(shape, 2)
    grads = [_rand(shape, 10 + k) for k in range(5)]

    jo = jcls(learning_rate=LR, **kw)
    want = {}
    for mode in ("off", "force"):    # XLA expression, Pallas kernel
        step = _jit_in_mode(lambda p, g, s: jo.apply_dense(p, g, s, LR), mode)
        p, slot = jnp.asarray(p0), jo.slot_init(jnp.asarray(p0))
        for g in grads:
            p, slot = step(p, g, slot)
        want[mode] = (np.asarray(p), {k: np.asarray(v) for k, v in slot.items()})

    to = tcls(learning_rate=LR, **kw)
    p = torch.from_numpy(p0.copy())
    slot = to.slot_init(p)
    for g in grads:
        p_out, slot = to.apply_dense(p, torch.from_numpy(g), slot)
        assert p_out is p                          # in place
    for mode, (wp, wslot) in want.items():
        np.testing.assert_allclose(p.numpy(), wp, **ADAM_TOL, err_msg=mode)
        assert set(slot) == set(wslot) == {"m", "v", "t"}
        for k in ("m", "v", "t"):
            np.testing.assert_allclose(slot[k].numpy(), wslot[k], **ADAM_TOL,
                                       err_msg=f"{mode} {k}")
    assert float(slot["t"]) == 5.0


# every kernel the port registers (hetu_tpu_torch.kernels imports them all)
KERNELS = ["fused_sgd", "fused_adam", "flash_attention_fwd",
           "fused_linear_nll_fwd", "flash_attention_bwd",
           "fused_linear_nll_bwd", "csr_spmm", "csr_spmv",
           "fused_embed_grad"]


def test_cpu_calls_take_the_plain_version_and_launch_nothing():
    p, g = torch.from_numpy(_rand((5, 3), 0)), torch.from_numpy(_rand((5, 3), 1))
    lr = torch.tensor(LR)
    tfo.sgd_step(topt.SGDOptimizer(LR), p, g, lr)
    o = topt.AdamOptimizer(LR)
    tfo.adam_step(o, p, g, o.slot_init(p), lr)
    assert treg.launch_counts() == dict.fromkeys(KERNELS, 0)
    assert treg.dispatch_stats() == {("fused_sgd", "plain"): 1,
                                     ("fused_adam", "plain"): 1}


def test_registry_modes():
    p, g = torch.ones(4), torch.ones(4)
    lr = torch.tensor(0.5)
    with treg.active("off"):
        out = treg.dispatch("fused_sgd", p, g, lr, l2reg=0.0)
    np.testing.assert_array_equal(out.numpy(), np.full(4, 0.5, np.float32))
    # force demands the kernel, which runs only on CUDA
    with treg.active("force"), pytest.raises(treg.KernelEligibilityError):
        treg.dispatch("fused_sgd", p, g, lr, l2reg=0.0)
    assert treg.dispatch_stats() == {("fused_sgd", "off"): 1}
    with pytest.raises(ValueError):
        treg.resolve_mode("sometimes")
    with pytest.raises(KeyError):
        treg.dispatch("no_such_kernel", p)


def test_bind_carries_the_mode_to_another_thread():
    """A function bound under a mode runs under it on any thread, as an
    autograd backward does; the thread's own mode is left as it was."""
    default = treg.current_mode()
    assert default != "off"
    with treg.active("off"):
        bound = treg.bind(treg.current_mode)
    seen = []
    th = threading.Thread(target=lambda: seen.extend(
        [bound(), treg.current_mode()]))
    th.start()
    th.join()
    assert seen == ["off", default]
    assert treg.current_mode() == default


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel path under auto: here (a meta
    tensor, not CUDA) eligibility refuses it and dispatch raises instead of
    running the plain version."""
    p = torch.empty(8, device="meta")
    with treg.active("auto"), pytest.raises(treg.KernelEligibilityError,
                                            match="meta"):
        treg.dispatch("fused_sgd", p, p, torch.empty((), device="meta"),
                      l2reg=0.0)
    assert treg.dispatch_stats() == {}
    assert treg.launch_counts() == dict.fromkeys(KERNELS, 0)
