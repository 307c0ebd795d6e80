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
import os
import subprocess
import sys

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
    rounded reciprocal (see the interpret-mode test)."""
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
    pol = jcq.QuantPolicy(mode, block=block)
    out, new = jcq.quantized_allreduce(
        jnp.asarray(x), jnp.asarray(resid), mesh, "dp",
        NamedSharding(mesh, P()), pol)
    return np.asarray(out), np.asarray(new)


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
