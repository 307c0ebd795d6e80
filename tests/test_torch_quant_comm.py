"""hetu_tpu_torch's quantized all-reduce against the JAX package, on the CPU.

The port's plain blockwise quantize and dequantize (what a CPU tensor
runs, and what the CUDA kernels ``quant_blocks``/``dequant_blocks`` are
held against on the card) are held against ``hetu_tpu.comm_quant``'s
``quantize_blocks``/``dequantize_blocks``, against ``_quant_pallas``/
``_dequant_pallas`` of ``hetu_tpu.kernels.quant_comm`` run directly (in
interpret mode, off a TPU) and against the numpy wire mirror
``np_quantize_blocks``, in int8 and fp8, over the edge cases the kernel
must keep: a ragged tail, an all-zero block, a NaN, an infinity, exact
.5 ties, -0.0, and block maxima whose quotient by the scale is an ulp
above 448 or 127. Then the policy and the wire report, and
``quantized_allreduce`` over a gloo group of one process (in this
process) and of two (two worker processes that import only the port),
against the JAX one on a one-device and on the 8-device mesh.

Equality is bit for bit throughout: the payload ``q`` and the scales by
their bits, the dequantized values by their bits where they are numbers
and by position where they are NaN (a NaN's payload bits differ between
numpy's and PyTorch's fp8 conversions). The two-rank case feeds partial
gradients that are small multiples of 2^-10, so their sum is exact in
float32 in any order and the reduce-scatter cannot move a value across a
rounding boundary.
"""
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hetu_tpu import comm_quant as jcq
from hetu_tpu.kernels import quant_comm as jqc
from hetu_tpu_torch import comm_quant as tcq
from hetu_tpu_torch.kernels import quant_comm as tqc, registry as treg
from test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("int8", "fp8")
BLOCKS = (256, 128, 64, 7)
Q = {"int8": 127.0, "fp8": 448.0}


@pytest.fixture(autouse=True)
def _clean_counts():
    treg.reset_stats()
    treg.reset_launch_counts()
    yield
    assert treg.launch_counts()["quant_blocks"] == 0   # the CPU launches none


def _above_max(mode, count, seed):
    """``count`` block maxima a > 0 for which a / (a / Q) rounds above Q in
    float32: the quotient the kernel must still map to ±Q."""
    rng = np.random.RandomState(seed)
    a = (rng.rand(200000) * 10 + 0.01).astype(np.float32)
    qv = np.float32(Q[mode])
    found = a[a / (a / qv) > qv]
    assert found.size >= count
    return found[:count]


def _edge_vector(mode, seed=0):
    """Gaussian values with the edge cases laid out at block boundaries of
    every block size in BLOCKS (a multiple of 7 · 64 · 256 apart)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(6 * 7 * 256) * 3).astype(np.float32)
    x[7 * 256:8 * 256 + 64] = 0.0                      # all-zero blocks
    x[100] = np.nan
    x[3 * 7 * 256 + 5] = np.inf
    x[3 * 7 * 256 + 9] = -0.0
    # exact .5 ties: the block max is Q · 2^-3, so x / scale is x · 8
    t0 = 4 * 7 * 256
    x[t0:t0 + 7 * 64] = 0.125
    x[t0] = Q[mode] / 8
    halves = (np.arange(7 * 64 - 1) % 9 - 4 + 0.5) / 8
    x[t0 + 1:t0 + 7 * 64] = halves.astype(np.float32)
    # maxima whose quotient lands an ulp above Q, one per 7-block, signed
    hi = _above_max(mode, 60, seed)
    at = 5 * 7 * 256 + np.arange(60) * 7
    x[at] = hi * np.where(np.arange(60) % 2, -1, 1).astype(np.float32)
    for k in range(1, 7):
        x[at + k] = hi / (k + 2)
    return np.concatenate([x, (rng.randn(1001) * 1e-3).astype(np.float32)])


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def _same(a, b):
    """Bit-equal where numbers, NaN at the same places."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f" and a.dtype.itemsize == 4:
        na, nb = np.isnan(a), np.isnan(b)
        return a.shape == b.shape and np.array_equal(na, nb) and \
            np.array_equal(_bits(a[~na]), _bits(b[~nb]))
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _port_quant(x, block, mode):
    q, s, n = tqc._quant_plain(torch.from_numpy(x), block=block, mode=mode)
    return q.view(torch.uint8).numpy(), s.numpy(), n, q


# ---------------------------------------------------------------------------
# the plain versions against the reference's quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", BLOCKS)
def test_plain_matches_comm_quant_bit_for_bit(mode, block):
    x = _edge_vector(mode)
    qj, sj, nj = jcq.quantize_blocks(jnp.asarray(x), block, mode)
    q, s, n, qt = _port_quant(x, block, mode)
    assert n == nj == x.size
    assert _same(q, np.asarray(qj).view(np.uint8))
    assert _bits(s).tolist() == _bits(np.asarray(sj)).tolist()
    dj = jcq.dequantize_blocks(qj, sj, nj, block)
    dt = tqc._dequant_plain(qt, torch.from_numpy(s), n=n, block=block)
    assert _same(dt.numpy(), dj)
    assert dt.shape == (x.size,)


@pytest.mark.parametrize("mode", MODES)
def test_edge_cases_take_the_reference_values(mode):
    """What the edge cases must become, read off the port's plain version
    (which the test above holds equal to the reference)."""
    x = _edge_vector(mode)
    q, s, _, qt = _port_quant(x, 7, mode)
    deq = tqc._dequant_plain(qt, torch.from_numpy(s), n=x.size,
                             block=7).numpy()
    wire = qt.to(torch.float32).numpy()
    assert np.isnan(s[100 // 7]) and np.all(np.isnan(deq[98:105]))
    assert s[7 * 256 // 7] == 0.0 and np.all(deq[7 * 256:8 * 256] == 0.0)
    assert np.all(np.abs(wire[np.isfinite(wire)]) <= Q[mode])
    at = 5 * 7 * 256 + np.arange(60) * 7
    hi = np.abs(x[at])
    assert np.all(hi / s[at // 7] > Q[mode])             # the ulp above
    assert np.array_equal(wire[at], np.sign(x[at]) * Q[mode])
    if mode == "fp8":
        neg0 = 3 * 7 * 256 + 9
        assert q[neg0] == 0x80                             # -0.0 kept
    t0 = 4 * 7 * 256                                       # ties, block 7
    q8, _, _, _ = _port_quant(x[t0:t0 + 7 * 64], 7 * 64, mode)
    v = x[t0 + 1:t0 + 7 * 64] * 8
    if mode == "int8":
        assert np.array_equal(q8[1:].view(np.int8), np.rint(v))  # to even


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", (256, 128))
def test_plain_matches_the_pallas_kernels_in_interpret_mode(mode, block):
    """The payload bit for bit. The scales: the port's are the IEEE
    quotient amax / Q, as ``comm_quant.quantize_blocks`` (run op by op)
    and the numpy mirror compute them; ``_quant_pallas`` runs under jit,
    where XLA on the CPU turns the division by the constant Q into a
    product with the rounded 1/Q, one ulp off in some blocks (a difference
    inside the reference, recorded in ROADMAP Queue 3). Where the two
    scales agree, the dequantized values agree bit for bit."""
    x = _edge_vector(mode)[:7 * 256 * 4]
    qp, sp, n = jqc._quant_pallas(jnp.asarray(x), block=block, mode=mode)
    q, s, nt, qt = _port_quant(x, block, mode)
    assert n == nt
    assert _same(q, np.asarray(qp).view(np.uint8))
    amax = np.abs(np.pad(x, (0, (-x.size) % block))
                  .reshape(-1, block)).max(axis=1)
    sp = np.array(sp)
    assert _same(s, amax / np.float32(Q[mode]))
    assert _same(sp, amax * np.float32(1 / Q[mode]))
    ulps = np.abs(_bits(s).astype(np.int64) - _bits(sp).astype(np.int64))
    assert ulps[~np.isnan(s)].max() <= 1
    dp = np.asarray(jqc._dequant_pallas(qp, sp, n=n, block=block))
    dt = tqc._dequant_plain(qt, torch.from_numpy(s), n=n, block=block)
    agree = np.repeat(ulps == 0, block)[:n]
    assert agree.any()
    assert _same(dt.numpy()[agree], dp[agree])
    dt_sp = tqc._dequant_plain(qt, torch.from_numpy(sp), n=n, block=block)
    assert _same(dt_sp.numpy(), dp)     # the same q · scale, given its scale


@pytest.mark.parametrize("block", BLOCKS)
def test_plain_int8_matches_the_numpy_wire_mirror(block):
    x = _edge_vector("int8")
    x = x[np.isfinite(x)]      # the mirror's C++ twin refuses non-finite
    qn, sn, nn = jcq.np_quantize_blocks(x, block)
    q, s, n, qt = _port_quant(x, block, "int8")
    assert n == nn and _same(q, qn.view(np.uint8)) and _same(s, sn)
    dn = jcq.np_dequantize_blocks(qn, sn, nn, block)
    assert _same(tqc._dequant_plain(qt, torch.from_numpy(s), n=n,
                                    block=block).numpy(), dn)


@pytest.mark.parametrize("shape,block", [((13, 8), 8), ((1000,), 256),
                                         ((300, 7), 64), ((0,), 16)])
def test_numpy_mirror_copy_equals_the_reference(shape, block):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32) * 2
    for a, b in zip(tcq.np_quantize_blocks(x, block),
                    jcq.np_quantize_blocks(x, block)):
        assert _same(a, b) if isinstance(a, np.ndarray) else a == b
    q, s, n = jcq.np_quantize_blocks(x, block)
    assert _same(tcq.np_dequantize_blocks(q, s, n, block),
                 jcq.np_dequantize_blocks(q, s, n, block))
    assert _same(tcq.np_roundtrip(x, block), jcq.np_roundtrip(x, block))


def test_public_forms_dispatch_to_the_plain_versions_on_the_cpu():
    x = torch.from_numpy(_edge_vector("fp8"))
    q, s, n = tqc.quantize_blocks(x, 64, "fp8")
    want = tqc._quant_plain(x, block=64, mode="fp8")
    assert q.dtype == torch.float8_e4m3fn and n == want[2]
    assert torch.equal(q.view(torch.uint8), want[0].view(torch.uint8))
    out = tqc.dequantize_blocks(q, s, n, 64)
    assert _same(out.numpy(), tqc._dequant_plain(q, s, n=n, block=64).numpy())
    e = tqc.quantize_blocks(torch.zeros(0), 256, "int8")
    assert e[0].numel() == 0 and e[1].numel() == 0 and e[2] == 0
    assert tqc.dequantize_blocks(e[0], e[1], 0, 256).numel() == 0
    assert treg.dispatch_stats() == {("quant_blocks", "plain"): 2,
                                     ("dequant_blocks", "plain"): 2}
    with pytest.raises(ValueError, match="int8/fp8"):
        tqc.quantize_blocks(x, 64, "int4")


# ---------------------------------------------------------------------------
# policy and wire report
# ---------------------------------------------------------------------------

class _Node:
    def __init__(self, name):
        self.name = name


_ENVS = [{}, {"HETU_COMM_QUANT": "int8"},
         {"HETU_COMM_QUANT": "fp8", "HETU_COMM_QUANT_BLOCK": "64",
          "HETU_COMM_QUANT_MIN": "100", "HETU_COMM_QUANT_EF": "0"},
         {"HETU_COMM_QUANT": "int8", "HETU_COMM_QUANT_EF": "yes"}]


@pytest.mark.parametrize("env", _ENVS)
def test_policy_resolution_matches_the_reference(env, monkeypatch):
    for k in ("HETU_COMM_QUANT", "HETU_COMM_QUANT_BLOCK",
              "HETU_COMM_QUANT_MIN", "HETU_COMM_QUANT_EF"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for args in ((), ("off",), ("int8", 32, 10, False, ("tiny",))):
        pj, pt = jcq.resolve_policy(*args), tcq.resolve_policy(*args)
        for attr in ("mode", "block", "min_size", "error_feedback", "force",
                     "active"):
            assert getattr(pt, attr) == getattr(pj, attr), (args, attr)
        assert repr(pt) == repr(pj)
        for name, size in (("big", 10**6), ("small", 11), ("tiny", 4),
                           ("edge", pj.min_size)):
            assert pt.applies(_Node(name), size) == \
                pj.applies(_Node(name), size)
    for bad in (dict(mode="int4"), dict(mode="int8", block=0)):
        with pytest.raises(ValueError):
            tcq.QuantPolicy(**bad)
        with pytest.raises(ValueError):
            jcq.QuantPolicy(**bad)
    assert tcq.fp8_dtype() is torch.float8_e4m3fn
    assert (tcq.MODES, tcq.DEFAULT_BLOCK, tcq.DEFAULT_MIN_SIZE) == \
        (jcq.MODES, jcq.DEFAULT_BLOCK, jcq.DEFAULT_MIN_SIZE)


@pytest.mark.parametrize("sizes,block,dp", [
    ({"fc1": 786432, "fc2": 65536, "fc3": 2560}, 256, 1),
    ({"w0": 4096, "w1": 4097}, 64, 8), ({}, 256, 2),
    ({"a": 1}, 7, 3)])
def test_wire_report_matches_the_reference(sizes, block, dp):
    assert tcq.allreduce_wire_report(sizes, tcq.QuantPolicy("int8", block),
                                     dp) == \
        jcq.allreduce_wire_report(sizes, jcq.QuantPolicy("int8", block), dp)


# ---------------------------------------------------------------------------
# quantized_allreduce against the JAX one
# ---------------------------------------------------------------------------

def _jax_allreduce(x, resid, n_dev, mode, block):
    """The JAX package's quantized all-reduce on an ``n_dev``-device mesh,
    op by op: under jit, XLA on the CPU would divide by Q through its
    rounded reciprocal (see the interpret-mode test). ``resid`` None: no
    error feedback (the new residual is None)."""
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    pol = jcq.QuantPolicy(mode, block=block)
    out, new = jcq.quantized_allreduce(
        jnp.asarray(x), None if resid is None else jnp.asarray(resid), mesh,
        "dp", NamedSharding(mesh, P()), pol)
    return np.asarray(out), None if new is None else np.asarray(new)


def _padded_shards(resid, dp, block):
    size = tcq.shard_size(resid.size, dp, block)
    flat = np.zeros(size * dp, np.float32)
    flat[:resid.size] = resid.reshape(-1)
    return [flat[r * size:(r + 1) * size] for r in range(dp)]


CASES = [(m, b) for m in MODES for b in (256, 64)]


@pytest.fixture
def gloo_world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_quantized_allreduce_world_of_one_matches_jax(gloo_world_of_one):
    rng = np.random.RandomState(5)
    for mode, block in CASES:
        x = rng.randn(300, 70).astype(np.float32)
        resid = (rng.randn(300, 70) * 0.01).astype(np.float32)
        want, want_r = _jax_allreduce(x, resid, 1, mode, block)
        for r in (resid, None):
            (shard,) = _padded_shards(resid, 1, block) if r is not None \
                else (None,)
            out, new = tcq.quantized_allreduce(
                torch.from_numpy(x),
                None if shard is None else torch.from_numpy(shard),
                gloo_world_of_one, tcq.QuantPolicy(mode, block=block))
            assert out.shape == x.shape and out.dtype == torch.float32
            if r is None:
                assert new is None
                continue
            assert _same(out.numpy(), want), (mode, block)
            assert _same(new.numpy()[:x.size].reshape(x.shape), want_r)
            assert np.all(new.numpy()[x.size:] == 0)


WORKER = r"""
import sys
import numpy as np
import torch
from hetu_tpu_torch import comm_quant
from hetu_tpu_torch.parallel import multihost

inp, rank, store, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
d = np.load(inp)
multihost.initialize("file://" + store, 2, rank, device="cpu")
out = {}
for key in sorted(k for k in d.files if k.startswith("x_")):
    mode, block = key.split("_")[1], int(key.split("_")[2])
    v, new = comm_quant.quantized_allreduce(
        torch.from_numpy(d[key][rank]), torch.from_numpy(d["r" + key[1:]][rank]),
        None, comm_quant.QuantPolicy(mode, block=block))
    out["out" + key[1:]] = v.numpy()
    out["res" + key[1:]] = new.numpy()
multihost.shutdown()
np.savez(out_path, **out)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "hetu_tpu")]
"""


def port_env():
    """The environment of a process that runs the port alone: the repo on
    the path, one thread, and no rank or policy inherited from outside."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "HETU_INIT_METHOD",
              "HETU_COMM_QUANT"):
        env.pop(k, None)
    return env


def run_ranks(tmp_path, script, inputs, n=2, timeout=300):
    """Run ``script`` as ranks 0..n-1 (``python -c script inputs rank
    store out``, importing only the port, meeting at a file store in
    ``tmp_path``); returns each rank's ``out`` path."""
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(inputs), str(r),
         str(tmp_path / "store"), outs[r]], env=port_env(), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return outs


def test_quantized_allreduce_two_ranks_match_jax_on_eight_devices(tmp_path):
    assert jax.device_count() == 8
    rng = np.random.RandomState(6)
    inputs, want = {}, {}
    for mode, block in CASES:
        key = f"_{mode}_{block}"
        # partial sums: multiples of 2^-10 below 2^4, so p0 + p1 is exact
        parts = rng.randint(-2**13, 2**13, (2, 300, 70)) \
            .astype(np.float32) / 1024
        x = (parts[0] + parts[1]) / 2
        resid = (rng.randn(300, 70) * 0.01).astype(np.float32)
        inputs["x" + key] = parts
        inputs["r" + key] = np.stack(_padded_shards(resid, 2, block))
        want[key] = _jax_allreduce(x, resid, 8, mode, block)
    np.savez(tmp_path / "in.npz", **inputs)
    ranks = [dict(np.load(o))
             for o in run_ranks(tmp_path, WORKER, tmp_path / "in.npz")]
    for key, (out, new_r) in want.items():
        for got in ranks:
            assert _same(got["out" + key], out), key
        res = np.concatenate([g["res" + key] for g in ranks])
        assert _same(res[:out.size].reshape(out.shape), new_r), key
        assert np.all(res[out.size:] == 0)


# ---------------------------------------------------------------------------
# the group all-reduce (quantized_allreduce_group) against the JAX one, per
# tensor, over 3 steps
# ---------------------------------------------------------------------------

def _group_tensors(rng, step):
    """Five gradients of mixed sizes: ragged tails at every block of
    GROUP_CASES (sizes the 8-device mesh divides), an all-zero block, a NaN and a -0.0 (in step 0; the NaN's
    block stays NaN through the residual), as small multiples of 2^-10, so
    that two ranks' halves sum exactly in any order."""
    shapes = [(300, 70), (1000,), (7 * 64 + 8,), (64, 64), (264,)]
    xs = [rng.randint(-2**13, 2**13, s).astype(np.float32) / 1024
          for s in shapes]
    if step == 0:
        xs[0].reshape(-1)[:512] = 0.0            # all-zero blocks
        xs[0].reshape(-1)[1000] = np.nan
        xs[2][3] = -0.0
    return xs


GROUP_CASES = [(m, b, ef) for m in MODES for b in (256, 7)
               for ef in (True, False)]


def _jax_steps(xs_steps, n_dev, mode, block, ef):
    """Each tensor through the JAX package's quantized_allreduce, step by
    step, its residual carried: per step the values and new residuals."""
    out = []
    resid = [np.zeros_like(x) for x in xs_steps[0]] if ef else None
    for xs in xs_steps:
        got = [_jax_allreduce(x, None if resid is None else resid[i], n_dev,
                              mode, block) for i, x in enumerate(xs)]
        out.append(got)
        if ef:
            resid = [r for _, r in got]
    return out


def _full(shards, n):
    """A tensor's residual in full shape from its ranks' shards."""
    return np.concatenate([np.asarray(s) for s in shards])[:n]


def test_group_allreduce_world_of_one_matches_jax_per_tensor(
        gloo_world_of_one):
    rng = np.random.RandomState(11)
    xs_steps = [_group_tensors(rng, s) for s in range(3)]
    for mode, block, ef in GROUP_CASES:
        want = _jax_steps(xs_steps, 1, mode, block, ef)
        pol = tcq.QuantPolicy(mode, block=block, error_feedback=ef)
        state = tcq.QarGroup([x.size for x in xs_steps[0]], 1, pol, "cpu")
        resid = state.residual_views() if ef else None
        for step, xs in enumerate(xs_steps):
            vals, new = tcq.quantized_allreduce_group(
                [torch.from_numpy(x) for x in xs], resid, gloo_world_of_one,
                pol, state)
            assert (new is None) == (not ef)
            for i, (x, (w_val, w_res)) in enumerate(zip(xs, want[step])):
                what = (mode, block, ef, step, i)
                assert vals[i].shape == x.shape, what
                assert _same(vals[i].numpy(), w_val), what
                if ef:
                    assert _same(new[i].numpy()[:x.size].reshape(x.shape),
                                 w_res), what
                    pad = new[i].numpy()[x.size:]
                    assert np.all(pad == 0) or np.isnan(w_res).any(), what
            resid = new
        # a view of the other buffer each step; the group's one output
        if ef:
            assert {r.data_ptr() for r in resid} & {
                v.data_ptr() for v in state.residual_views(0)
                + state.residual_views(1)}
        assert len({v.untyped_storage().data_ptr() for v in vals}) == 1
    assert treg.dispatch_stats() == {
        ("quant_blocks", "plain"): 3 * len(GROUP_CASES),
        ("dequant_blocks", "plain"): 3 * len(GROUP_CASES)}


GROUP_WORKER = r"""
import json
import sys
import numpy as np
import torch
from hetu_tpu_torch import comm_quant
from hetu_tpu_torch.parallel import multihost

inp, rank, store, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
d = np.load(inp)
cases = json.loads(str(d["cases"]))
multihost.initialize("file://" + store, 2, rank, device="cpu")
out = {}
for mode, block, ef in cases:
    key = f"{mode}_{block}_{int(ef)}"
    n_t = int(d["n_tensors"])
    pol = comm_quant.QuantPolicy(mode, block=block, error_feedback=ef)
    xs0 = [d[f"x_0_{i}"][rank] for i in range(n_t)]
    state = comm_quant.QarGroup([x.size for x in xs0], 2, pol, "cpu")
    resid = state.residual_views() if ef else None
    for step in range(3):
        xs = [torch.from_numpy(d[f"x_{step}_{i}"][rank]) for i in range(n_t)]
        vals, resid = comm_quant.quantized_allreduce_group(xs, resid, None,
                                                           pol, state)
        for i in range(n_t):
            out[f"{key}/{step}/v{i}"] = vals[i].numpy()
            if ef:
                out[f"{key}/{step}/r{i}"] = resid[i].numpy().copy()
multihost.shutdown()
np.savez(out_path, **out)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "hetu_tpu")]
"""


def test_group_allreduce_two_ranks_match_jax_per_tensor(tmp_path):
    """Two gloo ranks, each feeding its half of every gradient (exact
    multiples of 2^-10, so the sum is exact in any order), against the JAX
    package on the 8-device mesh, per tensor, over 3 steps."""
    assert jax.device_count() == 8
    rng = np.random.RandomState(12)
    xs_steps = [_group_tensors(rng, s) for s in range(3)]
    halves = []
    for xs in xs_steps:
        h = []
        for x in xs:
            a = (rng.randint(-2**12, 2**12, x.shape) / 1024).astype(
                np.float32)
            a = np.where(np.isfinite(x), a, x)        # the NaN on both
            a = np.where(np.signbit(x) & (x == 0), x, a)  # and the -0.0
            h.append(np.stack([a, x - a]))
        halves.append(h)
    cases = [("int8", 256, True), ("fp8", 64, True), ("int8", 7, False)]
    inputs = {f"x_{s}_{i}": h for s, hs in enumerate(halves)
              for i, h in enumerate(hs)}
    np.savez(tmp_path / "in.npz", cases=json.dumps(cases),
             n_tensors=len(xs_steps[0]), **inputs)
    ranks = [dict(np.load(o)) for o in
             run_ranks(tmp_path, GROUP_WORKER, tmp_path / "in.npz")]
    for mode, block, ef in cases:
        key = f"{mode}_{block}_{int(ef)}"
        # the mean of the two halves
        want = _jax_steps([[x / 2 for x in xs] for xs in xs_steps], 8, mode,
                          block, ef)
        for step in range(3):
            for i, x in enumerate(xs_steps[step]):
                what = (key, step, i)
                for got in ranks:
                    assert _same(got[f"{key}/{step}/v{i}"], want[step][i][0]), \
                        what
                if ef:
                    res = _full([g[f"{key}/{step}/r{i}"] for g in ranks],
                                x.size)
                    assert _same(res.reshape(x.shape), want[step][i][1]), what


# ---------------------------------------------------------------------------
# qar_plan, walked as csrc/quant_comm.cu reads it, and the kernel wrappers
# against an emulation of the C entries
# ---------------------------------------------------------------------------

def _tensor_of(first, tensors, b):
    """``tensor_of`` of csrc/quant_comm.cu: the largest t with first[t] <=
    b, by the same binary search."""
    lo, hi = 0, tensors - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= b:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _plan_table(arr, tensors):
    """The plan's int64 table as the C code splits it: first blocks, sizes,
    shard sizes, output offsets."""
    p = tensors
    return arr[:p + 1], arr[p + 1:2 * p + 1], arr[2 * p + 1:3 * p + 1], \
        arr[3 * p + 1:4 * p + 1]


PLANS = [((786432, 65536, 2560), 1, 256), ((21000, 1000, 456, 4096, 264), 2, 64),
         ((5, 1, 300, 7), 3, 7), ((256,), 4, 256), ((1,), 1, 7),
         ((3000, 40), 8, 128)]


@pytest.mark.parametrize("sizes,dp,block", PLANS)
def test_qar_plan_covers_every_element_once(sizes, dp, block):
    """The dequantize's walk over dp x nb global blocks, each block's
    tensor found by the C code's search over the table it is given, writes
    every element of every tensor once, at a 16-byte aligned output of its
    own; the bucket's copies put each element where that walk reads it."""
    pl = tqc.qar_plan(sizes, dp, block)
    first, n, size, out_off = _plan_table(list(pl.array), len(sizes))
    assert len(pl.array) == 4 * len(sizes) + 1
    assert n == list(sizes) and first[0] == 0 and first[-1] == pl.blocks
    assert size == [tcq.shard_size(k, dp, block) for k in sizes]
    assert all(s % block == 0 for s in size) and pl.shard == pl.blocks * block
    assert [f * block for f in first[:-1]] == list(pl.shard_offs)
    assert all(o % 4 == 0 for o in out_off)
    assert all(out_off[t] + n[t] <= out_off[t + 1]
               for t in range(len(sizes) - 1))
    assert pl.out_size == out_off[-1] + n[-1]
    assert pl.q_bytes % 16 == 0 and pl.q_bytes >= pl.shard
    assert pl.chunk % 16 == 0 and pl.chunk >= pl.q_bytes + 4 * pl.blocks
    assert pl.vec == (block // 32 if block in (64, 128, 256) else 0)
    seen = [np.zeros(k, np.int64) for k in sizes]
    # rank r's element j of the shard, as the walk reads it: (tensor, index)
    read = {}
    for g in range(dp * pl.blocks):
        r, b = divmod(g, pl.blocks)
        t = _tensor_of(first, len(sizes), b)
        assert first[t] <= b < first[t + 1]
        i0 = r * size[t] + (b - first[t]) * block
        for k in range(block):
            if i0 + k < n[t]:
                seen[t][i0 + k] += 1
                read[r * pl.shard + b * block + k] = (t, i0 + k)
    assert all((s == 1).all() for s in seen)
    state = tcq.QarGroup(sizes, dp, tcq.QuantPolicy("int8", block=block),
                         "cpu")
    copied = {}
    for (t, lo, hi), view in zip(state._copies, state._bucket_views):
        at = view.data_ptr() - state.bucket.data_ptr()
        for k in range(hi - lo):
            copied[at // 4 + k] = (t, lo + k)
    assert copied == read


def _mem(ptr, count, dtype):
    """``count`` elements of ``dtype`` at address ``ptr`` of this process
    (a CPU tensor's memory), as a writable numpy array."""
    item = np.dtype(dtype).itemsize
    assert ptr % item == 0, "misaligned"
    return np.frombuffer((ctypes.c_char * (count * item)).from_address(ptr),
                         dtype=dtype, count=count)


def _decode(raw, fp8):
    t = torch.from_numpy(np.ascontiguousarray(raw))
    return t.view(torch.float8_e4m3fn if fp8 else torch.int8).to(
        torch.float32).numpy()


def _quiet(fn):
    """``fn`` without numpy's warnings for NaN and infinite blocks."""
    def quiet(*args):
        with np.errstate(invalid="ignore"):
            return fn(*args)
    return quiet


class _FakeLib:
    """The C entries of csrc/quant_comm.cu emulated in numpy over CPU
    memory, reading their arguments as the kernels do: the quantize block
    by block over n elements (the mean, then the residual, in, then the
    payload, the scales and the new residual out); the dequantize over
    dp x nb global blocks, each block's tensor found by the C code's search
    over the plan table at the pointer it is given. It returns 1 where the
    C entries refuse (a vector width that is not block / 32), asserts the
    alignment the vector paths need, records the path each call takes and
    counts the output elements it writes."""

    def __init__(self):
        self.calls, self.written = [], None

    @staticmethod
    def _path(block, vec, ptrs):
        if vec not in (0, 2, 4, 8) or (vec and block != 32 * vec):
            return None
        if vec:     # the wrappers pass a vector path only where aligned
            assert all(p % 16 == 0 for p in ptrs if p)
        return vec

    @_quiet
    def hetu_quant_group(self, x, r_in, r_out, q, scales, n, block, nb, dp,
                         fp8, vec, stream):
        if self._path(block, vec, (x, r_in, r_out, q)) is None:
            return 1
        self.calls.append(("quant", vec))
        v = np.zeros(nb * block, np.float32)
        v[:n] = _mem(x, n, np.float32)
        if dp > 1:
            v[:n] = v[:n] / np.float32(dp)
        if r_in:
            v[:n] = v[:n] + _mem(r_in, n, np.float32)
        blocks = v.reshape(nb, block)
        amax = np.abs(blocks).max(axis=1)
        amax[np.isnan(blocks).any(axis=1)] = np.nan
        scale = (amax / np.float32(448.0 if fp8 else 127.0)).astype(np.float32)
        safe = np.where(scale > 0, scale, np.float32(1.0))
        w = blocks / safe[:, None]
        if fp8:
            code = torch.from_numpy(w).to(torch.float8_e4m3fn).view(
                torch.uint8).numpy()
        else:
            w = np.where(np.isnan(w), 0, np.clip(np.rint(w), -127, 127))
            code = w.astype(np.int8).view(np.uint8)
        _mem(q, nb * block, np.uint8)[:] = code.reshape(-1)
        _mem(scales, nb, np.float32)[:] = scale
        if r_out:
            dq = _decode(code, fp8) * scale[:, None]
            _mem(r_out, n, np.float32)[:] = (blocks - dq).reshape(-1)[:n]
        return 0

    @_quiet
    def hetu_dequant_group(self, q, q_stride, scales, s_stride, out, plan,
                           tensors, nb, block, dp, fp8, vec, stream):
        if self._path(block, vec, (q, out)) is None:
            return 1
        if vec:
            assert dp == 1 or q_stride % 16 == 0
        self.calls.append(("dequant", vec))
        first, n, size, out_off = _plan_table(
            _mem(plan, 4 * tensors + 1, np.int64).tolist(), tensors)
        total = max(o + k for o, k in zip(out_off, n))
        o = _mem(out, total, np.float32)
        self.written = np.zeros(total, np.int64)
        for g in range(dp * nb):
            r, b = divmod(g, nb)
            t = _tensor_of(first, tensors, b)
            i0 = r * size[t] + (b - first[t]) * block
            if i0 >= n[t]:
                continue
            k = min(block, n[t] - i0)
            raw = _mem(q + r * q_stride + b * block, k, np.uint8)
            s = _mem(scales + 4 * (r * s_stride + b), 1, np.float32)
            at = out_off[t] + i0
            o[at:at + k] = _decode(raw, fp8) * s
            self.written[at:at + k] += 1
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    """The kernel wrappers over CPU tensors against :class:`_FakeLib`: the
    registry dispatches every call to the kernel, as on CUDA."""
    fake = _FakeLib()
    monkeypatch.setattr(tqc, "_lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(treg, "dispatch", lambda name, *a, **kw:
                        treg._REGISTRY[name].kernel_fn(*a, **kw))
    yield fake
    treg.reset_launch_counts()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", BLOCKS)
def test_group_kernels_walk_the_plan_as_given(gloo_world_of_one, fake_lib,
                                              mode, block):
    """quantized_allreduce_group through the kernel wrappers and the
    emulated C entries equals it through the plain versions, bit for bit,
    outputs and residuals, over 3 steps; one launch of each a step, on the
    vector path at blocks 256, 128 and 64."""
    rng = np.random.RandomState(13)
    steps = [[torch.from_numpy(x) for x in _group_tensors(rng, s)]
             for s in range(3)]
    sizes = [x.numel() for x in steps[0]]
    pol = tcq.QuantPolicy(mode, block=block)
    runs = {}
    for path in ("kernel", "plain"):
        state = tcq.QarGroup(sizes, 1, pol, "cpu")
        resid, got = state.residual_views(), []
        with contextlib.ExitStack() as stack:
            if path == "plain":
                stack.enter_context(pytest.MonkeyPatch.context()).setattr(
                    treg, "dispatch", lambda name, *a, **kw:
                    treg._REGISTRY[name].plain_fn(*a, **kw))
            for xs in steps:
                vals, resid = tcq.quantized_allreduce_group(
                    xs, resid, gloo_world_of_one, pol, state)
                got.append(([v.clone() for v in vals],
                            [r.clone() for r in resid]))
        runs[path] = got
    for (kv, kr), (pv, pr) in zip(runs["kernel"], runs["plain"]):
        assert all(_same(a.numpy(), b.numpy()) for a, b in zip(kv, pv))
        assert all(_same(a.numpy(), b.numpy()) for a, b in zip(kr, pr))
    vec = block // 32 if block in (64, 128, 256) else 0
    assert fake_lib.calls == [("quant", vec), ("dequant", vec)] * 3
    assert treg.launch_counts()["quant_blocks"] == 3
    assert treg.launch_counts()["dequant_blocks"] == 3
    # every element of every tensor written once, no padding between them
    pl = tqc.qar_plan(tuple(sizes), 1, block)
    want = np.zeros(pl.out_size, np.int64)
    for o, k in zip(pl.out_offs, sizes):
        want[o:o + k] = 1
    assert np.array_equal(fake_lib.written, want)


@pytest.mark.parametrize("mode,block,dp", [("int8", 256, 2), ("fp8", 64, 3),
                                           ("int8", 7, 3), ("fp8", 128, 8)])
def test_group_kernels_at_several_ranks(fake_lib, mode, block, dp):
    """The quantize's mean over dp and residual, and the dequantize of dp
    ranks' rows at the send buffer's stride, through the wrappers and the
    emulated C entries, against the plain group versions bit for bit."""
    sizes = (21000, 456, 264)
    pol = tcq.QuantPolicy(mode, block=block)
    state = tcq.QarGroup(sizes, dp, pol, "cpu")
    pl = state.plan
    gen = torch.Generator().manual_seed(dp)
    shard = torch.randn(pl.shard, generator=gen) * 3
    resid = torch.randn(pl.shard, generator=gen) * 0.01
    # the quantize: the mean (an IEEE quotient), the residual in and out
    want = tqc._quant_group_plain(shard, block=block, mode=mode, dp=dp,
                                  residual=resid)
    for out in (None, (state.send_q, state.send_scales,
                state.residual_views(1)[0].new_empty(pl.shard))):
        got = tqc._quant_kernel(shard, block=block, mode=mode, dp=dp,
                                residual=resid, out=out)
        assert all(_same(_u8(a), _u8(b)) for a, b in zip(got, want))
    # each rank's row of the receive buffer: its payload and scales
    rows = state.recv.view(dp, pl.chunk)
    for r in range(dp):
        q, s, _ = tqc._quant_plain(torch.randn(pl.shard, generator=gen),
                                   block=block, mode=mode)
        rows[r, :pl.shard] = q.view(torch.uint8)
        rows[r, pl.q_bytes:pl.q_bytes + 4 * pl.blocks] = s.view(torch.uint8)
    q, s = state.recv_q, state.recv_scales
    got = tqc._dequant_kernel(q, s, n=sum(sizes), block=block, plan=pl)
    want = tqc._dequant_group_plain(q, s, n=sum(sizes), block=block, plan=pl)
    assert got.shape == (pl.out_size,)
    for o, k in zip(pl.out_offs, sizes):
        assert _same(got[o:o + k].numpy(), want[o:o + k].numpy())
        assert fake_lib.written[o:o + k].tolist() == [1] * k
    assert fake_lib.written.sum() == sum(sizes)
    vec = pl.vec
    assert fake_lib.calls == [("quant", vec)] * 2 + [("dequant", vec)]


def _u8(t):
    return t.view(torch.uint8).numpy() if t.dtype != torch.float32 \
        else t.numpy()


def test_single_forms_are_groups_of_one(fake_lib):
    """quantize_blocks/dequantize_blocks through the wrappers: no prologue,
    one launch each, the plain versions' values; a misaligned input runs
    the scalar path, an empty one launches nothing."""
    x = torch.from_numpy(_edge_vector("int8"))
    for src, vec in ((x, 8), (torch.cat([x[:1], x])[1:], 0)):
        q, s, n = tqc.quantize_blocks(src, 256, "int8")
        qp, sp, _ = tqc._quant_plain(src, block=256, mode="int8")
        assert n == src.numel() and _same(_u8(q), _u8(qp)) and _same(s, sp)
        out = tqc.dequantize_blocks(q, s, n, 256)
        assert _same(out.numpy(), tqc._dequant_plain(qp, sp, n=n,
                                                     block=256).numpy())
        assert fake_lib.calls[-2:] == [("quant", vec), ("dequant", 8)]
    e = tqc.quantize_blocks(x[:0], 256, "fp8")
    assert tqc.dequantize_blocks(e[0], e[1], 0, 256).numel() == 0
    assert treg.launch_counts()["quant_blocks"] == 2
    assert treg.launch_counts()["dequant_blocks"] == 2


def test_a_refused_launch_raises_and_counts_nothing(fake_lib, monkeypatch):
    """A C entry that returns a CUDA error (as both refuse a vector width
    that is not block / 32: tests/test_torch_cuda.py) makes the wrapper
    raise, with no launch counted."""
    monkeypatch.setattr(fake_lib, "hetu_quant_group", lambda *a: 1)
    monkeypatch.setattr(fake_lib, "hetu_dequant_group", lambda *a: 1)
    with pytest.raises(RuntimeError, match="quant_blocks.*CUDA error 1"):
        tqc._quant_kernel(torch.ones(300), block=256, mode="int8")
    q, s, n = tqc._quant_plain(torch.ones(300), block=256, mode="int8")
    with pytest.raises(RuntimeError, match="dequant_blocks.*CUDA error 1"):
        tqc._dequant_kernel(q, s, n=n, block=256)
    assert treg.launch_counts()["quant_blocks"] == 0
    assert treg.launch_counts()["dequant_blocks"] == 0
