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
import contextlib
import threading
import types

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
           "fused_embed_grad", "quant_blocks", "dequant_blocks"]


def test_cpu_calls_take_the_plain_version_and_launch_nothing():
    p, g = torch.from_numpy(_rand((5, 3), 0)), torch.from_numpy(_rand((5, 3), 1))
    lr = torch.tensor(LR)
    tfo.sgd_step(topt.SGDOptimizer(LR), p, g, lr)
    o = topt.AdamOptimizer(LR)
    tfo.adam_step(o, p, g, o.slot_init(p), lr)
    # a group is one dispatch
    tfo.sgd_group_step(topt.SGDOptimizer(LR), [p, g.clone()], [g, g], lr)
    tfo.adam_group_step(o, [p, g.clone()], [g, g],
                        [o.slot_init(p), o.slot_init(g)], lr)
    assert treg.launch_counts() == dict.fromkeys(KERNELS, 0)
    assert treg.dispatch_stats() == {("fused_sgd", "plain"): 2,
                                     ("fused_adam", "plain"): 2}


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


@pytest.mark.parametrize("kernel", ["fused_sgd", "fused_adam"])
@pytest.mark.parametrize("where", ["param", "grad"])
def test_group_with_a_cpu_first_tensor_never_runs_another_on_the_plain(
        kernel, where):
    """A group whose first tensor is on the CPU and a later one off it (a
    meta tensor, not CUDA) raises under auto instead of running the plain
    version on the later one."""
    cpu = [torch.zeros(8) for _ in range(3)]
    off = torch.empty(8, device="meta")
    ps = cpu[:2] + [off] if where == "param" else list(cpu)
    gs = cpu[:2] + [off] if where == "grad" else list(cpu)
    lr = torch.tensor(LR)
    with treg.active("auto"), pytest.raises(treg.KernelEligibilityError,
                                            match="tensor 2 .* meta"):
        if kernel == "fused_sgd":
            treg.dispatch(kernel, ps, gs, lr, l2reg=0.0)
        else:
            treg.dispatch(kernel, ps, gs, list(cpu), list(cpu),
                          [torch.zeros(()) for _ in cpu], lr, beta1=0.9,
                          beta2=0.999, eps=1e-8, weight_decay=0.0)
    assert treg.dispatch_stats() == {}
    assert treg.launch_counts() == dict.fromkeys(KERNELS, 0)


# -- the group kernels: opt_plan, the launch contract, group parity ----------

K = tfo.MAX_TENSORS
MLP_SMALL = [(24, 16), (16,), (16, 10), (10,)]     # the MLP's shapes, narrow
PLAN_CASES = {
    "mlp": ([3072 * 256, 256, 256 * 256, 256, 256 * 10, 10], [True] * 6),
    "odd": ([703, 5, 1, 2**20 + 3, 7], [True] * 5),
    "misaligned": ([703, 4096, 9, 2**16 + 1], [True, False, False, True]),
    "k_plus_3": ([(17 * i) % 61 + 1 for i in range(K + 3)],
                 [i % 5 != 2 for i in range(K + 3)]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_opt_plan_covers_every_element_once(case):
    """Walk opt_plan's arrays as the C entries read them: every element of
    every tensor is covered exactly once, float4 vectors only where the
    tensor is aligned, at most K tensors a launch, the launches in order."""
    sizes, aligned = PLAN_CASES[case]
    plan = tfo.opt_plan(tuple(sizes), tuple(aligned))
    assert plan is tfo.opt_plan(tuple(sizes), tuple(aligned))   # cached
    assert plan.max_tensors == K
    assert [first for first, _ in plan.launches] == list(
        range(0, len(sizes), K))
    assert sum(count for _, count in plan.launches) == len(sizes)
    assert all(1 <= count <= K for _, count in plan.launches)
    assert len(plan.launches) == -(-len(sizes) // K)
    for first, count in plan.launches:
        for k in range(first, first + count):
            n_vec, off, tail = (plan.n_vec[k], plan.tail_off[k],
                                plan.tail_len[k])
            assert n_vec == 0 or aligned[k]
            covered = np.zeros(sizes[k], np.int64)
            covered[:4 * n_vec] += 1
            covered[off:off + tail] += 1
            assert (covered == 1).all(), (case, k)
            assert tail < 4 if aligned[k] else n_vec == 0


class _FakeLib:
    """The C entries emulated over CPU tensors: each call walks the plan's
    arrays it is given over the launch's tensors, as the kernels do (float4
    vectors, then the scalar part), and updates them in place with the
    plain per-element expressions; it refuses what the C entry refuses."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.calls, self.vectorized = [], {}

    def _walk(self, ptr_arrays, n_vec, tail_off, tail_len, first, count,
              max_tensors, update):
        if not (max_tensors == K and 1 <= count <= K):
            return 1
        self.calls.append((first, count))
        for k in range(first, first + count):
            self.vectorized[k] = n_vec[k] > 0
            ptrs = [a[k] for a in ptr_arrays]
            flats = [self.by_ptr[ptr].view(-1) for ptr in ptrs]
            covered = np.zeros(flats[0].numel(), np.int64)
            if n_vec[k]:
                assert all(ptr % 16 == 0 for ptr in ptrs)
            for lo, hi in ((0, 4 * n_vec[k]),
                           (tail_off[k], tail_off[k] + tail_len[k])):
                covered[lo:hi] += 1
                if hi > lo:
                    update(k, [f[lo:hi] for f in flats])
            assert (covered == 1).all()
        return 0

    def hetu_fused_sgd_multi(self, p, g, lr, l2reg, *plan_and_launch):
        lr_t = self.by_ptr[lr]

        def update(_k, xs):
            xs[0].copy_(tfo._sgd_one(xs[0], xs[1], lr_t, l2reg))
        return self._walk((p, g), *plan_and_launch[:-1], update)

    def hetu_fused_adam_multi(self, p, g, m, v, t, lr, beta1, beta2, omb1,
                              omb2, eps, wd, *plan_and_launch):
        lr_t = self.by_ptr[lr]
        assert (omb1, omb2) == (1.0 - beta1, 1.0 - beta2)

        def update(k, xs):
            new = tfo._adam_one(*xs, self.by_ptr[t[k]], lr_t, beta1, beta2,
                                eps, wd)
            for x, y in zip(xs[:1] + xs[2:], new[:1] + new[1:3]):
                x.copy_(y)
        return self._walk((p, g, m, v), *plan_and_launch[:-1], update)


def _group_tensors(shapes, seed, misalign=()):
    """Seeded f32 tensors of ``shapes``; those at ``misalign`` are views at
    storage offset 1 (4 bytes off 16-byte alignment)."""
    out = []
    for i, s in enumerate(shapes):
        x = torch.from_numpy(_rand((int(np.prod(s)) + 1,), seed + i))
        x = x[1:] if i in misalign else x[:-1]
        out.append(x.view(s))
    return out


@pytest.mark.parametrize("case", ["mlp", "misaligned_p", "misaligned_g",
                                  "misaligned_m", "k_plus_3"])
def test_kernel_wrappers_launch_the_plan_as_given(monkeypatch, case):
    """_sgd_kernel/_adam_kernel on the CPU with the C entries emulated
    (_FakeLib): the pointer and plan arrays they pass, walked as the kernel
    walks them, give the plain versions' values bit for bit; one launch,
    counted, per range of at most K tensors."""
    shapes = {"k_plus_3": [((7 * i) % 23 + 1,) for i in range(K + 3)]}.get(
        case, MLP_SMALL + [(37, 19), (5,)])
    mis = {"misaligned_p": (1, 4), "misaligned_g": (0, 4),
           "misaligned_m": (2, 5)}.get(case, ())
    ps = _group_tensors(shapes, 0, mis if case == "misaligned_p" else ())
    gs = _group_tensors(shapes, 100, mis if case == "misaligned_g" else ())
    ms = _group_tensors(shapes, 200, mis if case == "misaligned_m" else ())
    vs = [x.abs() for x in _group_tensors(shapes, 300)]
    ts = [torch.tensor(float(i % 3)) for i in range(len(shapes))]
    lr = torch.tensor(LR)
    fake = _FakeLib(ps + gs + ms + vs + ts + [lr])
    monkeypatch.setattr(tfo, "_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    n_launch = -(-len(shapes) // K)

    def copies(xs):
        """Clones at the same offset from 16-byte alignment."""
        out = []
        for x in xs:
            off = x.storage_offset() % 4
            y = torch.empty(x.numel() + off)[off:].view(x.shape)
            out.append(y.copy_(x))
        fake.by_ptr.update({x.data_ptr(): x for x in out})
        return out

    want = tfo._sgd_plain(ps, gs, lr, l2reg=1e-2)
    got = tfo._sgd_kernel(copies(ps), gs, lr, l2reg=1e-2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fake.calls == [(i, min(K, len(shapes) - i))
                          for i in range(0, len(shapes), K)]
    assert treg.launch_counts()["fused_sgd"] == n_launch
    # a tensor of 4 elements or more runs float4 vectors where all its
    # pointers are aligned (SGD's: p and g)
    sizes = [int(np.prod(s)) for s in shapes]
    assert fake.vectorized == {
        k: n >= 4 and (k not in mis or case == "misaligned_m")
        for k, n in enumerate(sizes)}

    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-7, weight_decay=1e-2)
    want = tfo._adam_plain(ps, gs, ms, vs, ts, lr, **hyper)
    got = tfo._adam_kernel(copies(ps), gs, copies(ms), copies(vs), ts, lr,
                           **hyper)
    for a_list, b_list in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(a_list, b_list))
    assert treg.launch_counts()["fused_adam"] == n_launch
    assert fake.vectorized == {k: n >= 4 and k not in mis
                               for k, n in enumerate(sizes)}
    assert [float(t) for t in ts] == [float(i % 3) for i in range(len(ts))]


def test_a_plan_for_another_k_is_refused(monkeypatch):
    fake = _FakeLib([])
    plan = tfo.opt_plan((8,), (True,))
    assert fake._walk(([0], [0]), plan.n_vec, plan.tail_off, plan.tail_len,
                      0, 1, K + 1, None) == 1
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tfo._check_rc("fused_sgd", 1)


GROUP_SHAPES = MLP_SMALL + [(37, 19), (5,)]
GROUP_CASES = {
    "sgd": (jopt.SGDOptimizer, topt.SGDOptimizer, {}),
    "sgd_l2reg": (jopt.SGDOptimizer, topt.SGDOptimizer, {"l2reg": 1e-2}),
    "adam_wd": (jopt.AdamOptimizer, topt.AdamOptimizer,
                {"weight_decay": 1e-2}),
    "adamw": (jopt.AdamWOptimizer, topt.AdamWOptimizer, {}),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_step_matches_jax_per_tensor(case):
    """sgd_group_step/adam_group_step over the MLP's shapes (narrow) and
    odd sizes, 5 applies, against hetu_tpu.kernels.fused_opt's
    sgd_step/adam_step per tensor in force mode (the Pallas kernels,
    interpret mode on the CPU); one dispatch per apply."""
    jcls, tcls, kw = GROUP_CASES[case]
    sgd = "sgd" in case
    kname = "fused_sgd" if sgd else "fused_adam"
    p0 = [_rand(s, 20 + i) for i, s in enumerate(GROUP_SHAPES)]
    grads = [[_rand(s, 100 * k + i) for i, s in enumerate(GROUP_SHAPES)]
             for k in range(5)]

    jo = jcls(learning_rate=LR, **kw)
    if sgd:
        jstep = _jit_in_mode(lambda p, g: (jfo.sgd_step(jo, p, g, LR), ()),
                             "force")
    else:
        jstep = _jit_in_mode(lambda p, g, s: jfo.adam_step(jo, p, g, s, LR),
                             "force")
    want = []
    for i, p in enumerate(p0):
        p, slot = jnp.asarray(p), jo.slot_init(jnp.asarray(p))
        for g in grads:
            p, slot = jstep(p, g[i]) if sgd else jstep(p, g[i], slot)
        want.append((np.asarray(p), slot))

    to = tcls(learning_rate=LR, **kw)
    ps = [torch.from_numpy(p.copy()) for p in p0]
    slots = [to.slot_init(p) for p in ps]
    lr = to.lr_tensor(ps[0].device)
    for g in grads:
        gs = [torch.from_numpy(x) for x in g]
        if sgd:
            out = tfo.sgd_group_step(to, ps, gs, lr)
        else:
            out, slots = tfo.adam_group_step(to, ps, gs, slots, lr)
        assert all(a is b for a, b in zip(out, ps))        # in place
    tol = SGD_TOL if sgd else ADAM_TOL
    for i, (wp, wslot) in enumerate(want):
        np.testing.assert_allclose(ps[i].numpy(), wp, **tol, err_msg=str(i))
        for k in ("m", "v", "t") if not sgd else ():
            np.testing.assert_allclose(slots[i][k].numpy(), wslot[k], **tol,
                                       err_msg=f"{i} {k}")
    if not sgd:
        assert all(float(s["t"]) == 5.0 for s in slots)
    assert treg.dispatch_stats() == {(kname, "plain"): 5}
    assert treg.launch_counts() == dict.fromkeys(KERNELS, 0)


def test_optimizer_node_applies_one_group_per_device():
    """OptimizerOp.apply_updates: SGD, Adam and AdamW apply a device's
    parameters in one dispatch, with the gradient clip and Adam's l2 fold
    in their places, bit-equal to one apply_dense per parameter."""
    for opt, kname in ((topt.SGDOptimizer(LR, l2reg=1e-2), "fused_sgd"),
                       (topt.AdamOptimizer(LR, l2reg=1e-2,
                                           clip_grad_norm=1.0), "fused_adam"),
                       (topt.AdamWOptimizer(LR), "fused_adam")):
        ps = [torch.from_numpy(_rand(s, i))
              for i, s in enumerate(GROUP_SHAPES)]
        gs = [torch.from_numpy(_rand(s, 50 + i))
              for i, s in enumerate(GROUP_SHAPES)]
        want = [p.clone() for p in ps]
        scale = 1.0
        if opt.clip_grad_norm is not None:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
            scale = torch.clamp(opt.clip_grad_norm / (gnorm + 1e-12), max=1.0)
        want_slots = [opt.apply_dense(p, g * scale, opt.slot_init(p))[1]
                      for p, g in zip(want, gs)]
        treg.reset_stats()
        node = topt.OptimizerOp([object() for _ in ps], opt,
                                [object() for _ in ps])
        tc = types.SimpleNamespace(
            params={id(v): p for v, p in zip(node.vars, ps)},
            param_updates={}, slot_updates={})
        node.apply_updates({id(i): g for i, g in zip(node.inputs, gs)},
                           tuple(opt.slot_init(p) for p in ps), tc)
        assert treg.dispatch_stats() == {(kname, "plain"): 1}
        for v, p, w in zip(node.vars, ps, want):
            assert tc.param_updates[id(v)] is p
            assert torch.equal(p, w)
        for got, w in zip(tc.slot_updates[id(node)], want_slots):
            assert all(torch.equal(got[k], w[k]) for k in w)
