"""Training-time dropout in hetu_tpu_torch's transformer against the JAX
package's, on the CPU in f32.

The port draws each mask from a ``torch.Generator`` seeded by an integer
(``transformer.fold_in`` over the step's seed, the microbatch, the layer
and the site), where the reference draws ``jax.random.bernoulli`` from
keys folded and split the same way; the bits differ. So for parity the
test replaces the port's mask draw (``transformer._dropout_mask``, in this
test only) by a table from each site's port seed to the mask the
reference draws at that site's key. Then the two compute the same
function, and the loss and each gradient must agree within rel 1e-5 (the
gradients by relative L2 error, f32 sums in another order). Without the
table: remat on and off give bit-equal gradients (the recompute draws
the same masks), a missing key raises, and a mask drops its share.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_tpu.models import transformer as jt
from hetu_tpu_torch.interop import tree_from_numpy
from hetu_tpu_torch.models import transformer as tt
from test_torch_threads import one_torch_thread  # noqa: F401

LM = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_seq_len=16, dropout_rate=0.25)
B, T = 3, 16
SEED, KEY = 1234, 7
REL = 1e-5


def _pair(**kw):
    kw = dict(LM, **kw)
    jc = jt.TransformerConfig(dtype=jnp.float32, **kw)
    tc = tt.TransformerConfig(dtype=torch.float32, **kw)
    jp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jc))
    tp = tree_from_numpy(jp, "cpu", like=tt.init_params(0, tc, "cpu"))
    return jc, tc, jax.tree.map(jnp.asarray, jp), tp


def _batch(n=None):
    rng = np.random.RandomState(3)
    shape = (B, T) if n is None else (n, B, T)
    tok = rng.randint(0, LM["vocab_size"], shape).astype(np.int32)
    return tok, np.roll(tok, -1, axis=-1)


def _reference_masks(key, seed, shape, rate, n_layers):
    """{port seed of a site: the reference's keep mask at that site} for
    one forward: layer li folds its index into the key, and the block
    splits its key into the attention and the MLP site."""
    table = {}
    for li in range(n_layers):
        sites = jax.random.split(jax.random.fold_in(key, li))
        layer_seed = tt.fold_in(seed, li)
        for site in range(2):
            keep = jax.random.bernoulli(sites[site], 1.0 - rate, shape)
            table[tt.fold_in(layer_seed, site)] = torch.from_numpy(
                np.array(keep))
    return table


@pytest.fixture
def fed_masks(monkeypatch):
    """Installs a table of masks as the port's draw; returns the table."""
    table = {}

    def draw(shape, rate, seed, device):
        mask = table[seed]                   # every site must be in it
        assert tuple(mask.shape) == tuple(shape)
        return mask.to(device)

    monkeypatch.setattr(tt, "_dropout_mask", draw)
    return table


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _hold_grads(tgrads, jgrads):
    for path, g in tt.tree_leaves(tgrads, with_paths=True):
        want = jgrads
        for key in path.strip("/").split("/"):
            want = want[key]
        err = _rel_l2(g.numpy(), want)
        assert err <= REL, f"{path}: rel L2 {err}"


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dialect", [{}, dict(post_ln=True,
                                              attn_proj_bias=True)],
                         ids=["preln", "postln"])
def test_loss_and_gradients_match_jax_with_its_masks(fed_masks, remat,
                                                     dialect):
    jc, tc, jp, tp = _pair(remat=remat, **dialect)
    tok, tgt = _batch()
    fed_masks.update(_reference_masks(jax.random.PRNGKey(KEY), SEED,
                                      (B, T, LM["d_model"]),
                                      LM["dropout_rate"], LM["n_layers"]))
    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(
        jp, jnp.asarray(tok), jnp.asarray(tgt), jc,
        dropout_rng=jax.random.PRNGKey(KEY))
    tloss, tgrads = tt.value_and_grad(
        tt.loss_fn, tp, torch.from_numpy(tok), torch.from_numpy(tgt), tc,
        dropout_rng=SEED)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=REL)
    _hold_grads(tgrads, jgrads)
    # the masks did something: without dropout the gradient differs
    _, nodrop = tt.value_and_grad(tt.loss_fn, tp, torch.from_numpy(tok),
                                  torch.from_numpy(tgt), tc)
    w1 = tgrads["blocks"]["w1"].numpy()
    assert _rel_l2(nodrop["blocks"]["w1"].numpy(), w1) > 1e-2


def test_accumulation_folds_each_microbatch_index(fed_masks):
    jc, tc, jp, tp = _pair(remat=False)
    tok, tgt = _batch(n=2)
    key = jax.random.PRNGKey(KEY)
    for mi in range(2):
        fed_masks.update(_reference_masks(
            jax.random.fold_in(key, mi), tt.fold_in(SEED, mi),
            (B, T, LM["d_model"]), LM["dropout_rate"], LM["n_layers"]))
    jstep = jt.make_train_step(jc, lr=1e-3, accum_steps=2)
    jloss, _, jopt = jstep(jp, jt.init_opt_state(jp), jnp.asarray(tok),
                           jnp.asarray(tgt), key)
    tstep = tt.make_train_step(tc, lr=1e-3, accum_steps=2)
    tloss, _, topt = tstep(tp, tt.init_opt_state(tp), torch.from_numpy(tok),
                           torch.from_numpy(tgt), SEED)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=REL)
    # after one step m = (1 - b1) * the averaged gradient
    _hold_grads(topt["m"], jopt["m"])
    assert float(topt["t"]) == float(jopt["t"]) == 1.0


def test_remat_gives_bit_equal_gradients():
    """The recompute in the backward draws each mask again from its seed:
    with remat on, the gradients equal those with remat off bit for
    bit."""
    grads = {}
    tok, tgt = _batch()
    for remat in (False, True):
        tc = tt.TransformerConfig(dtype=torch.float32, remat=remat, **LM)
        tp = tt.init_params(0, tc, "cpu")
        loss, grads[remat] = tt.value_and_grad(
            tt.loss_fn, tp, torch.from_numpy(tok), torch.from_numpy(tgt), tc,
            dropout_rng=SEED)
    for a, b in zip(tt.tree_leaves(grads[False]), tt.tree_leaves(grads[True])):
        assert torch.equal(a, b)


def test_the_step_needs_its_key_and_one_key_gives_one_step():
    tc = tt.TransformerConfig(dtype=torch.float32, **LM)
    tok, tgt = (torch.from_numpy(x) for x in _batch())
    step = tt.make_train_step(tc, lr=1e-2)

    def run(*key):
        p = tt.init_params(0, tc, "cpu")
        return float(step(p, tt.init_opt_state(p), tok, tgt, *key)[0])

    with pytest.raises(ValueError, match="dropout_rng"):
        run()
    assert run(1) == run(1)
    assert run(1) != run(2)
    # eval: no key, the rate ignored, equal to the model without dropout
    p = tt.init_params(0, tc, "cpu")
    plain = tt.TransformerConfig(dtype=torch.float32,
                                 **dict(LM, dropout_rate=0.0))
    assert torch.equal(tt.forward(p, tok, tc)[0], tt.forward(p, tok, plain)[0])
    # a short run with dropout learns
    p, opt = tt.init_params(0, tc, "cpu"), None
    opt = tt.init_opt_state(p)
    losses = [float(step(p, opt, tok, tgt, tt.fold_in(5, i))[0])
              for i in range(20)]
    assert losses[-1] < losses[0]


def test_a_mask_drops_its_share_and_depends_on_its_seed_alone():
    shape = (64, 128, 96)
    keep = tt._dropout_mask(shape, 0.1, 11, "cpu")
    assert keep.dtype == torch.bool and tuple(keep.shape) == shape
    assert abs(1.0 - keep.float().mean().item() - 0.1) < 0.005
    assert torch.equal(keep, tt._dropout_mask(shape, 0.1, 11, "cpu"))
    assert not torch.equal(keep, tt._dropout_mask(shape, 0.1, 12, "cpu"))
    x = torch.ones(shape)
    y = tt._dropout(x, 0.1, 11)
    assert torch.equal(y, torch.where(keep, x / 0.9, 0.0))
    assert tt._dropout(x, 0.0, 11) is x and tt._dropout(x, 0.1, None) is x
    # fold_in: a 64-bit mix, distinct over nearby seeds and indices
    folds = {tt.fold_in(s, i) for s in range(50) for i in range(50)}
    assert len(folds) == 2500 and all(0 <= f < 2 ** 64 for f in folds)
