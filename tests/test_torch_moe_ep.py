"""hetu_tpu_torch's switch MoE over a mesh's ep axis
(``transformer._moe_mlp`` on a mesh) against the JAX package's and its own one
process, on the CPU.

Four worker processes (one group for the file, file-store rendezvous,
port-only imports) run the MoE LM at dp 2 x ep 2 and at ep 2 x tp 2 (the
reference's ``tests/test_transformer.py:65`` on four devices): each rank's
routing in a forward (``transformer.moe_log``), the aux loss, the first
step's gradients and three steps' losses. The batch overflows the
experts' capacity in every layer (capacity factor 1.0 over 4 experts), so
tokens are dropped.

Held: each layer's kept tokens **equal** the one-process run's (each
rank's tokens at their places in the global batch: the routing follows the
reference's global order), and so does each layer's dropped count; the aux
loss, the loss and the gradients against the JAX package's on its
8-device virtual mesh (the same axes over four devices) and the port's one
process, rtol 1e-5 / atol 1e-6 (gradients atol 1e-6 times the tensor's
largest magnitude).
"""
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hetu_tpu.models import transformer as jtfm
from hetu_tpu.parallel import mesh as jmesh
from hetu_tpu_torch.interop import tree_from_numpy
from hetu_tpu_torch.models import transformer as tt
from test_torch_mesh import _flat
from test_torch_ring import start_ranks, wait_ranks
from test_torch_threads import one_torch_thread  # noqa: F401

MOE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=32,
           max_seq_len=32, n_experts=4, capacity_factor=1.0, remat=False)
B, T = 8, 16
LR, STEPS = 1e-2, 3
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MESHES = {"dp2ep2": dict(dp=2, ep=2), "ep2tp2": dict(ep=2, tp=2)}

WORKER = r'''
import json
import sys

import numpy as np
import torch

from hetu_tpu_torch import interop
from hetu_tpu_torch.models import transformer as tfm
from hetu_tpu_torch.parallel import mesh as meshlib, multihost

spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
multihost.initialize("file://" + sys.argv[3], 4, rank, device="cpu")
data = np.load(spec["data"])
params = {}
for k in data.files:
    if k.startswith("params/"):
        *path, leaf = k[len("params/"):].split("/")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = data[k]
cfg = tfm.TransformerConfig(**spec["cfg"], dtype=torch.float32)
tok = torch.from_numpy(data["tokens"]).long()
tgt = torch.from_numpy(data["targets"]).long()
out = {}


def put(prefix, value):
    if isinstance(value, dict):
        for k, v in value.items():
            put(f"{prefix}/{k}", v)
    else:
        out[prefix] = value.detach().numpy().copy()


for tag, kw in spec["meshes"].items():
    mesh = meshlib.make_mesh(**kw)
    p = interop.mesh_tree(params, cfg, mesh, "cpu")
    dp = tfm.DataParallel(mesh)
    x, y = dp.share(tok), dp.share(tgt)
    with tfm.moe_log() as log, torch.no_grad():
        _, aux = tfm.forward(p, x, cfg, mesh)
    out[tag + "/aux"] = aux.numpy()
    for i, layer in enumerate(log):
        out[f"{tag}/keep/{i}"] = layer["keep"].numpy()
        out[f"{tag}/dropped/{i}"] = np.asarray(layer["dropped"])
    loss, g = tfm.value_and_grad(tfm.loss_fn, p, x, y, cfg, mesh)
    dp.mean_([loss] + tfm.tree_leaves(g))
    out[tag + "/grad_loss"] = loss.numpy()
    put(tag + "/grads", tfm.gather_params(g, cfg, mesh))
    out[tag + "/expert_rows"] = np.asarray(p["blocks"]["w1"].shape[1])
    step, o, losses = tfm.make_train_step(cfg, mesh, lr=spec["lr"]), \
        tfm.init_opt_state(p), []
    for _ in range(spec["steps"]):
        loss, p, o = step(p, o, tok, tgt)
        losses.append(float(loss))
    out[tag + "/losses"] = np.asarray(losses)
np.savez(sys.argv[4], **out)
multihost.shutdown()
'''


def _jax_refs(cfg, params, tok, tgt):
    refs = {}
    for tag, kw in MESHES.items():
        mesh = jmesh.make_mesh(**kw, devices=jax.devices()[:4])
        p = jtfm.shard_params(jax.tree.map(jnp.asarray, params), cfg, mesh)
        x, y = jnp.asarray(tok), jnp.asarray(tgt)
        refs[tag + "/aux"] = float(jax.jit(
            lambda p, x: jtfm.forward(p, x, cfg, mesh)[1])(p, x))
        loss, g = jax.jit(jax.value_and_grad(
            lambda p, x, y: jtfm.loss_fn(p, x, y, cfg, mesh)))(p, x, y)
        refs[tag + "/grads"] = (float(loss), jax.tree.map(np.asarray, g))
        o, losses = jtfm.init_opt_state(p), []
        step = jtfm.make_train_step(cfg, mesh=mesh, lr=LR)
        for _ in range(STEPS):
            loss, p, o = step(p, o, x, y)
            losses.append(float(loss))
        refs[tag + "/losses"] = np.asarray(losses)
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    cfg = jtfm.TransformerConfig(**MOE, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(1), cfg))
    rng = np.random.RandomState(2)
    tok = rng.randint(0, MOE["vocab_size"], (B, T)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=1).astype(np.int32)
    inputs = _flat("params", params, {})
    inputs["tokens"], inputs["targets"] = tok, tgt
    np.savez(tmp / "in.npz", **inputs)
    with open(tmp / "spec.json", "w") as f:
        json.dump(dict(data=str(tmp / "in.npz"), cfg=MOE, lr=LR,
                       steps=STEPS, meshes=MESHES), f)
    procs, outs = start_ranks(tmp, WORKER, tmp / "spec.json", 4)
    try:
        refs = _jax_refs(cfg, params, tok, tgt)
    finally:
        got = wait_ranks(procs, outs)
    # the port's one process, from the same params
    tcfg = tt.TransformerConfig(**MOE, dtype=torch.float32)
    p = tree_from_numpy(params, "cpu")
    x, y = torch.from_numpy(tok).long(), torch.from_numpy(tgt).long()
    with tt.moe_log() as log, torch.no_grad():
        _, aux = tt.forward(p, x, tcfg)
    loss, g = tt.value_and_grad(tt.loss_fn, p, x, y, tcfg)
    one = dict(log=log, aux=float(aux), loss=float(loss),
               grads=_flat("", tt.tree_map(lambda t: t.numpy(), g), {}))
    return got, refs, one


def _rows(tag, r):
    """Rank r's rows of the global batch: its dp coordinate's."""
    d = r // 2 if tag == "dp2ep2" else 0
    n = 2 if tag == "dp2ep2" else 1
    return slice(d * B // n, (d + 1) * B // n)


@pytest.mark.parametrize("tag", list(MESHES))
def test_moe_over_ep_drops_the_one_process_tokens(ranks, tag):
    outs, _, one = ranks
    assert len(one["log"]) == MOE["n_layers"]
    for i, layer in enumerate(one["log"]):
        assert layer["dropped"] > 0, "the batch must overflow a capacity"
        keep = layer["keep"].numpy().reshape(B, T)
        for r, out in enumerate(outs):
            np.testing.assert_array_equal(
                out[f"{tag}/keep/{i}"], keep[_rows(tag, r)].reshape(-1),
                err_msg=f"{tag} layer {i} rank {r}")
            assert int(out[f"{tag}/dropped/{i}"]) == layer["dropped"]


@pytest.mark.parametrize("tag", list(MESHES))
def test_moe_over_ep_matches_jax_and_one_process(ranks, tag):
    outs, refs, one = ranks
    jloss, jgrads = refs[tag + "/grads"]
    for out in outs:
        # each ep rank holds half the experts
        assert int(out[tag + "/expert_rows"]) == MOE["n_experts"] // 2
        np.testing.assert_allclose(out[tag + "/aux"], refs[tag + "/aux"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(out[tag + "/aux"], one["aux"], **LOSS_TOL)
        np.testing.assert_allclose(out[tag + "/grad_loss"], jloss, **LOSS_TOL)
        np.testing.assert_allclose(out[tag + "/grad_loss"], one["loss"],
                                   **LOSS_TOL)
        for k, v in _flat("", jgrads, {}).items():
            scale = max(float(np.max(np.abs(v))), 1e-30)
            for want in (v, one["grads"][k]):
                np.testing.assert_allclose(out[tag + "/grads" + k], want,
                                           rtol=1e-5, atol=1e-6 * scale,
                                           err_msg=tag + k)
        np.testing.assert_allclose(out[tag + "/losses"],
                                   refs[tag + "/losses"], **LOSS_TOL)
