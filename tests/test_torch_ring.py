"""hetu_tpu_torch's ring attention (``parallel/ring_attention.py``) against
the JAX package's, on the CPU.

Four worker processes (one group for the file, file-store rendezvous,
port-only imports) run every case below on a mesh over all four ranks (sp
4) or over two rings of two (dp 2 x sp 2, each ring its own batch row):
each rank's chunk of q, k, v and the key bias, its output chunk and, from
a fixed output gradient, its dq, dk and dv, through ``ring_attention``
(one ``torch.autograd.Function`` whose blocks are #4 and #5) in two
dispatch modes: "plain" under ``kernels="off"`` and "flash" under the
default ``auto``, which on CPU tensors also takes #4's and #5's plain
versions, so the ring's chunk skipping, merge and the dk/dv ring of its
backward run as they do on the card. Each rank records the dispatch
paths each mode took. This test holds them
against ``hetu_tpu.parallel.ring_attention.ring_attention`` under its
``shard_map`` on the 8-device virtual mesh (``tests/test_attention.py:213``
to ``:273``), and against unsharded attention (``mha_reference``).

Cases: sp 2 and 4, causal and not, with and without a key-padding bias
(-1e9 on a padded tail, the reference's own test form), and a GQA case
whose k and v carry half the heads (the port rings them unrepeated; the
reference repeats them first). Two more cases pad with -1e30, as BERT
builds its mask: a tail that fills a whole chunk, and one row whose first
keys are padded, so under causal its first rows see no key and come out
0. There the reference's ring gives NaN gradients (its guard covers the
forward), so those cases are held against unsharded attention alone.

Tolerances: outputs rtol 1e-5, atol 1e-6; gradients rtol 1e-5 and atol
1e-6 times the tensor's largest magnitude (f32 sums in another order).
"""
import functools
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from hetu_tpu.kernels.flash_attention import mha_reference
from hetu_tpu.parallel.ring_attention import ring_attention as jring
from hetu_tpu.utils import shard_map
from hetu_tpu_torch.kernels import registry
from hetu_tpu_torch.parallel import ring_attention as tring
from test_torch_quant_comm import REPO, port_env
from test_torch_threads import one_torch_thread  # noqa: F401

B, H, T, HD = 2, 4, 16, 8
# name: (sp, causal, bias ("", "tail" at -1e9, "bert" at -1e30), kv heads)
CASES = {f"sp{sp}_{'causal' if c else 'full'}{'_' + b if b else ''}":
         (sp, c, b, H) for sp in (2, 4) for c in (True, False)
         for b in ("", "tail")}
CASES["sp4_causal_tail_gqa"] = (4, True, "tail", H // 2)
BERT_PAD = {f"sp4_{'causal' if c else 'full'}_bert": (4, c, "bert", H)
            for c in (True, False)}
CASES.update(BERT_PAD)

WORKER = r'''
import json
import sys

import numpy as np
import torch

from hetu_tpu_torch.kernels import registry
from hetu_tpu_torch.parallel import mesh as meshlib, multihost
from hetu_tpu_torch.parallel import ring_attention as ra

spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
multihost.initialize("file://" + sys.argv[3], 4, rank, device="cpu")
data = np.load(spec["data"])
meshes = {4: meshlib.make_mesh(sp=4), 2: meshlib.make_mesh(dp=2, sp=2)}
out = {}
for name, (sp, causal, bias, kv) in spec["cases"].items():
    mesh = meshes[sp]
    group = meshlib.axis_group(mesh, "sp")
    s, d = meshlib.axis_rank(mesh, "sp"), meshlib.axis_rank(mesh, "dp")
    rows = slice(None) if sp == 4 else slice(d, d + 1)
    t = data[name + "/q"].shape[2] // sp
    chunk = lambda x, ax=2: torch.from_numpy(np.ascontiguousarray(
        x[rows].take(range(s * t, (s + 1) * t), axis=ax)))
    q, k, v, do = (chunk(data[f"{name}/{x}"]) for x in ("q", "k", "v", "do"))
    kb = chunk(data[name + "/bias"], 1) if bias else None
    g = q.shape[1] // k.shape[1]
    expand = None if g == 1 else torch.arange(q.shape[1]) // g
    for form, mode in (("plain", "off"), ("flash", "auto")):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        registry.reset_stats()
        with registry.active(mode):
            o = ra.ring_attention(*leaves, kb, group=group, causal=causal,
                                  expand=expand)
            o.backward(do)
        out[f"{name}/{form}/o"] = o.detach().numpy()
        for n, x in zip(("dq", "dk", "dv"), leaves):
            out[f"{name}/{form}/{n}"] = x.grad.numpy()
        out[f"{name}/{form}/paths"] = np.array(sorted(
            "/".join(key) for key in registry.dispatch_stats()))
np.savez(sys.argv[4], **out)
multihost.shutdown()
'''

TOL = dict(rtol=1e-5, atol=1e-6)


def start_ranks(tmp, script, spec, n):
    """Start ``script`` as ranks 0..n-1 (``python -c script spec rank
    store out``, port-only imports, a file store in ``tmp``); returns the
    processes and their ``out`` paths. The caller computes its references
    while they run, then waits."""
    outs = [str(tmp / f"rank{r}.npz") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(spec), str(r), str(tmp / "store"),
         outs[r]], env=port_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    return procs, outs


def wait_ranks(procs, outs, timeout=300):
    """Each rank's results, once every rank exited 0."""
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(o)) for o in outs]


def _inputs(i, kv, bias):
    rng = np.random.RandomState(20 + i)
    q = (rng.randn(B, H, T, HD) * 0.3).astype(np.float32)
    k = (rng.randn(B, kv, T, HD) * 0.3).astype(np.float32)
    v = rng.randn(B, kv, T, HD).astype(np.float32)
    do = rng.randn(B, H, T, HD).astype(np.float32)
    kb = np.zeros((B, T), np.float32)
    if bias == "tail":
        kb[0, 13:] = kb[1, 10:] = -1e9
    elif bias == "bert":
        kb[0, 12:] = -1e30          # a padded tail (a chunk all padded)
        kb[1, :2] = -1e30           # leading pads: causal rows 0-1 see none
    return q, k, v, do, kb


def _jax_ring(sp, causal, q, k, v, kb, do):
    """The reference's ring under shard_map over ``sp`` devices: its output
    and the vjp of ``do``; k and v repeated to the query heads (the
    reference's GQA broadcast) inside the differentiated function."""
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    ring = shard_map(functools.partial(jring, axis_name="sp", causal=causal),
                     mesh=mesh,
                     in_specs=(P(None, None, "sp", None),) * 3
                     + (P(None, "sp"),),
                     out_specs=P(None, None, "sp", None))
    g = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return ring(q, jnp.repeat(k, g, 1), jnp.repeat(v, g, 1),
                    jnp.asarray(kb))

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (o, *vjp(jnp.asarray(do)))]


def _full(causal, q, k, v, kb, do):
    """Unsharded attention (the JAX package's oracle), rows that see no
    key set to 0 as the ring's guard gives them."""
    g = q.shape[1] // k.shape[1]
    seen = np.ones((B, 1, T, 1), bool)
    if causal:
        visible = (kb > -1e29)[:, None, :] & np.tril(np.ones((T, T), bool))
        seen = visible.any(-1)[:, None, :, None]

    def f(q, k, v):
        o = mha_reference(q, jnp.repeat(k, g, 1), jnp.repeat(v, g, 1),
                          causal, k_bias=jnp.asarray(kb))
        return jnp.where(seen, o, 0.0)

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (o, *vjp(jnp.asarray(do)))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    inputs, want = {}, {}
    for i, (name, (sp, causal, bias, kv)) in enumerate(CASES.items()):
        q, k, v, do, kb = _inputs(i, kv, bias)
        for n, x in zip(("q", "k", "v", "do", "bias"), (q, k, v, do, kb)):
            inputs[f"{name}/{n}"] = x
    np.savez(tmp / "in.npz", **inputs)
    with open(tmp / "spec.json", "w") as f:
        json.dump(dict(data=str(tmp / "in.npz"), cases=CASES), f)
    procs, outs = start_ranks(tmp, WORKER, tmp / "spec.json", 4)
    try:
        for name, (sp, causal, bias, kv) in CASES.items():
            x = [inputs[f"{name}/{n}"] for n in ("q", "k", "v", "bias", "do")]
            want[name] = (None if name in BERT_PAD else
                          _jax_ring(sp, causal, *x), _full(causal, *x))
    finally:
        got = wait_ranks(procs, outs)
    return got, want


def _assemble(outs, name, sp, key):
    """The whole tensor from the ranks' chunks: sp 4 is ranks 0-3 along
    the sequence; dp 2 x sp 2 is row d's chunks on ranks 2d, 2d + 1."""
    if sp == 4:
        return np.concatenate([o[key] for o in outs], 2)
    return np.concatenate([np.concatenate([outs[2 * d + s][key]
                                           for s in range(2)], 2)
                           for d in range(2)], 0)


def _close(got, want, what):
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", [n for n in CASES if n not in BERT_PAD])
@pytest.mark.parametrize("form", ["plain", "flash"])
def test_ring_matches_the_reference_ring_and_full_attention(ranks, name,
                                                            form):
    outs, want = ranks
    sp = CASES[name][0]
    ring, full = want[name]
    for i, part in enumerate(("o", "dq", "dk", "dv")):
        got = _assemble(outs, name, sp, f"{name}/{form}/{part}")
        _close(got, ring[i], f"{name} {form} {part} vs the JAX ring")
        _close(got, full[i], f"{name} {form} {part} vs full attention")


@pytest.mark.parametrize("name", list(BERT_PAD))
@pytest.mark.parametrize("form", ["plain", "flash"])
def test_ring_under_bert_padding_matches_full_attention(ranks, name, form):
    """-1e30 on a chunk's every key and on a row's every visible key: the
    reference's guard (``_NEG_INF / 2``), outputs and gradients finite."""
    outs, want = ranks
    _, full = want[name]
    for i, part in enumerate(("o", "dq", "dk", "dv")):
        got = _assemble(outs, name, 4, f"{name}/{form}/{part}")
        assert np.all(np.isfinite(got)), (name, form, part)
        _close(got, full[i], f"{name} {form} {part} vs full attention")


def test_rows_that_see_no_key_come_out_zero(ranks):
    outs, _ = ranks
    name = "sp4_causal_bert"
    for form in ("plain", "flash"):
        o = _assemble(outs, name, 4, f"{name}/{form}/o")
        dq = _assemble(outs, name, 4, f"{name}/{form}/dq")
        assert np.all(o[1, :, :2] == 0) and np.all(dq[1, :, :2] == 0)
        assert np.all(np.abs(o[1, :, 2:]).sum(-1) > 0)


def test_one_rank_ring_is_unsharded_attention():
    """Without a group the ring is its one diagonal step: #4 forward, #5
    backward, equal to unsharded attention."""
    q, k, v, do, kb = _inputs(0, H, "tail")
    for causal in (True, False):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        got = tring.ring_attention(*leaves, torch.from_numpy(kb), group=None,
                                   causal=causal)
        got.backward(torch.from_numpy(do))
        want = _full(causal, q, k, v, kb, do)
        np.testing.assert_allclose(got.detach().numpy(), want[0], **TOL)
        for x, w, part in zip(leaves, want[1:], ("dq", "dk", "dv")):
            _close(x.grad.numpy(), w, f"one rank, causal {causal}: {part}")


def test_the_kernel_form_raises_where_a_chunk_does_not_divide_its_blocks():
    """A chunk of 192 rows (over 128, not a multiple of it) cannot take #4
    and #5: the ring raises, and never falls back to a plain form."""
    q = torch.zeros((1, 2, 192, 16))
    with registry.active("force"), pytest.raises(ValueError,
                                                 match="must divide"):
        tring.ring_attention(q, q, q, group=object(), causal=True)


def test_the_plain_form_runs_only_on_cpu_tensors_or_under_off(ranks):
    """Every ring step goes through the kernel registry: on a CPU tensor
    under ``auto`` (the "flash" runs) it takes #4's and #5's plain
    versions, under ``off`` (the "plain" runs) the mode's own; nothing
    else runs them."""
    outs, _ = ranks
    paths = {"plain": {"flash_attention_fwd/off", "flash_attention_bwd/off"},
             "flash": {"flash_attention_fwd/plain",
                       "flash_attention_bwd/plain"}}
    for out in outs:
        for name in CASES:
            for form, want in paths.items():
                assert set(out[f"{name}/{form}/paths"]) == want, (name, form)


def test_a_one_rank_ring_under_force_reaches_the_kernel_dispatch():
    """Under ``kernels="force"`` a CPU tensor goes to the kernels, whose
    dispatch refuses it, also with one rank (no group): the ring runs no
    plain form of its own."""
    q = torch.zeros((1, 2, 16, 8))
    registry.reset_stats()
    with registry.active("force"), pytest.raises(
            registry.KernelEligibilityError, match="force"):
        tring.ring_attention(q, q, q, group=None, causal=True)
    assert registry.dispatch_stats() == {}
