"""The graph-API transformer LM (``examples/nlp/hetu_transformer.py``'s
``transformer_lm``) on hetu_tpu_torch against hetu_tpu, on the CPU.

- **Parity at dropout 0.** A tiny LM (vocabulary 11, B 4, T 8, d 16, 2
  heads, 2 layers, d_ff 32) in both packages; the JAX executor's initial
  state moves to the port by ``save``/``load``; 3 Adam steps. Losses
  within rtol 1e-5; parameters within atol 1e-5 under
  ``test_torch_cnn._hold_adam``'s rule for Adam (an element whose gradient
  lies within rounding of 0 may step either way; the key biases' gradient
  is 0 in exact arithmetic). Each step takes the two lookups' table
  gradients through ``fused_embed_grad`` and one ``fused_adam`` apply
  (their plain versions on the CPU).
- Ports of ``tests/test_nlp.py::test_graph_api_transformer_causality`` and
  ``::test_graph_api_transformer_learns``.
- With dropout on (0.1, the trainer's default) the steps are finite and
  repeat under the same seed; evaluation (no optimizer) draws nothing.
"""
import os
import sys

import numpy as np

import hetu_tpu as jt
import hetu_tpu_torch as pt
from hetu_tpu_torch.examples import hetu_transformer as port_lm
from hetu_tpu_torch.kernels import registry as treg
from test_torch_cnn import _hold_adam, _params
from test_torch_threads import one_torch_thread  # noqa: F401

V, B, T = 11, 4, 8
WIDTHS = dict(d_model=16, n_heads=2, n_layers=2, d_ff=32)
LR, STEPS = 1e-3, 3


def _reference_lm():
    """``examples/nlp/hetu_transformer.py``'s builder (imported as
    ``tests/test_nlp.py`` imports it)."""
    nlp = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "nlp")
    if nlp not in sys.path:
        sys.path.insert(0, nlp)
    import hetu_transformer
    return hetu_transformer.transformer_lm


def _build(ht, lm, dropout_prob=0.0, lr=LR, **widths):
    tokens = ht.Variable(name="tokens", trainable=False)
    labels = ht.Variable(name="labels", trainable=False)
    loss, logits, _ = lm(tokens, labels, V, B, T,
                         dropout_prob=dropout_prob, **(widths or WIDTHS))
    op = ht.optim.AdamOptimizer(lr).minimize(loss)
    return tokens, labels, loss, logits, op


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, T + 1)).astype(np.float32)
    return ids[:, :-1], ids[:, 1:]


def test_lm_matches_reference_at_dropout_zero(tmp_path):
    jtok, jlab, jloss, _, jop = _build(jt, _reference_lm())
    ptok, plab, ploss, _, pop = _build(pt, port_lm.transformer_lm)
    jex = jt.Executor({"train": [jloss, jop]}, ctx=jt.cpu(0), seed=0)
    pex = pt.Executor({"train": [ploss, pop]}, ctx=pt.cpu(0), seed=1)
    jex.save(str(tmp_path))
    pex.load(str(tmp_path))
    treg.reset_stats()
    want, got = [], []
    for step in range(STEPS):
        bx, by = _batch(step)
        want.append(float(jex.run("train", feed_dict={jtok: bx, jlab: by})[0]
                          .asnumpy()))
        got.append(float(pex.run("train", feed_dict={ptok: bx, plab: by})[0]
                         .asnumpy()))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jp, pp = _params(jex, np.asarray), _params(pex, lambda t: t.numpy())
    assert list(pp) == list(jp)
    for k in jp:
        _hold_adam(k, pp[k], jp[k], STEPS, LR, k.endswith("_k_bias"))
    # per step: the token and the position lookup, one optimizer apply
    assert treg.dispatch_stats() == {("fused_embed_grad", "plain"): 2 * STEPS,
                                     ("fused_adam", "plain"): STEPS}


def test_graph_api_transformer_causality():
    """Changing a future token must not change earlier logits (the causal
    mask is real)."""
    B2, T2, V2 = 2, 8, 7
    tokens = pt.Variable(name="tokens", trainable=False)
    labels = pt.Variable(name="labels", trainable=False)
    loss, logits, _ = port_lm.transformer_lm(
        tokens, labels, V2, B2, T2, d_model=16, n_heads=2, n_layers=1,
        d_ff=32, dropout_prob=0.0)
    ex = pt.Executor({"eval": [logits]}, ctx=pt.cpu(0), seed=0)
    rng = np.random.RandomState(1)
    bx = rng.randint(0, V2, (B2, T2)).astype(np.float32)
    by = np.zeros((B2, T2), np.float32)
    (l1,) = ex.run("eval", feed_dict={tokens: bx, labels: by},
                   convert_to_numpy_ret_vals=True)
    bx2 = bx.copy()
    bx2[:, -1] = (bx2[:, -1] + 1) % V2          # perturb the LAST token only
    (l2,) = ex.run("eval", feed_dict={tokens: bx2, labels: by},
                   convert_to_numpy_ret_vals=True)
    l1 = l1.reshape(B2, T2, V2)
    l2 = l2.reshape(B2, T2, V2)
    np.testing.assert_allclose(l1[:, :-1], l2[:, :-1], rtol=1e-5, atol=1e-6)
    assert np.abs(l1[:, -1] - l2[:, -1]).max() > 1e-4


def test_graph_api_transformer_learns():
    """Tiny causal LM on a fixed repeating sequence: loss must fall
    substantially (the model memorizes the pattern)."""
    B2, T2, V2 = 4, 16, 11
    rng = np.random.RandomState(0)
    pattern = rng.randint(1, V2, 64)
    data = np.tile(pattern, 4).astype(np.float32)

    tokens = pt.Variable(name="tokens", trainable=False)
    labels = pt.Variable(name="labels", trainable=False)
    loss, logits, _ = port_lm.transformer_lm(
        tokens, labels, V2, B2, T2, d_model=32, n_heads=2, n_layers=1,
        d_ff=64, dropout_prob=0.0)
    train_op = pt.optim.AdamOptimizer(2e-3).minimize(loss)
    ex = pt.Executor({"train": [loss, train_op]}, ctx=pt.cpu(0), seed=0)

    losses = []
    for step in range(150):
        starts = rng.randint(0, data.size - T2 - 1, B2)
        bx = np.stack([data[s:s + T2] for s in starts])
        by = np.stack([data[s + 1:s + T2 + 1] for s in starts])
        lv = ex.run("train", feed_dict={tokens: bx, labels: by},
                    convert_to_numpy_ret_vals=True)[0]
        losses.append(float(np.mean(lv)))
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:10]), (
        np.mean(losses[:10]), np.mean(losses[-10:]))


def test_dropout_steps_are_finite_and_repeat_with_the_seed():
    def run(seed):
        tok, lab, loss, logits, op = _build(pt, port_lm.transformer_lm,
                                            dropout_prob=0.1)
        ex = pt.Executor({"train": [loss, op], "eval": [logits]},
                         ctx=pt.cpu(0), seed=seed)
        out = []
        for step in range(3):
            bx, by = _batch(step)
            out.append(float(ex.run("train", feed_dict={tok: bx, lab: by})[0]
                             .asnumpy()))
        bx, by = _batch(0)
        ev = [ex.run("eval", feed_dict={tok: bx, lab: by},
                     convert_to_numpy_ret_vals=True)[0] for _ in range(2)]
        return np.array(out), ev

    a, (e1, e2) = run(0)
    b, _ = run(0)
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(e1, e2)
