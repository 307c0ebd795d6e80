"""hetu_tpu_torch's NLP trainers and checkpoints on the CPU.

``examples/train_hetu_bert.py`` under ``--cpu`` (f32) starts from the JAX
package's initial parameters (``interop.tree_from_numpy``) and trains on
the instances and epoch permutations the reference's trainer
(``examples/nlp/train_hetu_bert.py``) builds; its per-step losses must be
within rel 1e-5 of the reference's ``make_pretrain_step`` on the same
batches (f32 sums in another order). A run checkpointed at epoch 2 and
resumed to epoch 5 must end bit-equal to an uninterrupted run.
``checkpoint``'s own semantics (refusal, ``force``, retention, an empty
directory, dtypes and the AdamW ``t`` kept) are held exactly.
``train_hetu_transformer`` and ``generate_hetu`` must run and learn.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hetu_tpu.models import bert as jb
from hetu_tpu.tokenizers import BertTokenizer as JBert
from hetu_tpu_torch import checkpoint
from hetu_tpu_torch.examples import (generate_hetu, train_hetu_bert,
                                     train_hetu_transformer)
from hetu_tpu_torch.interop import tree_from_numpy
from hetu_tpu_torch.models import bert as tb, transformer as tt
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_tokenizers import jpbd

EPOCHS = 3


def _jax_losses(args, jp):
    """The reference trainer's loop (its data, config and permutations)
    from ``jp``: the per-step (loss, mlm, nsp)."""
    vocab = train_hetu_bert.build_vocab(train_hetu_bert.SAMPLE_SENTENCES)
    full = jb.batch_from_instances(jpbd.create_instances_from_document(
        train_hetu_bert.SAMPLE_SENTENCES, JBert(vocab),
        max_seq_length=args.max_seq_length, max_predictions_per_seq=5))
    n = len(full["input_ids"])
    cfg = jb.BertConfig(
        vocab_size=len(vocab), d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
        max_seq_len=args.max_seq_length, dtype=jnp.float32, remat=False)
    step_fn = jb.make_pretrain_step(cfg, lr=args.learning_rate)
    params, opt = jp, jb.init_opt_state(jp)
    out = []
    for epoch in range(args.num_epoch):
        order = np.random.RandomState(epoch).permutation(n)
        for s in range(max(1, n // args.batch_size)):
            idx = order[s * args.batch_size:(s + 1) * args.batch_size]
            batch = {k: jnp.asarray(v[idx]) for k, v in full.items()}
            loss, (mlm, nsp), params, opt = step_fn(params, opt, batch)
            out.append((float(loss), float(mlm), float(nsp)))
    return out


def test_bert_trainer_losses_match_jax():
    args = train_hetu_bert.parse_args(["--cpu", "--num-epoch", str(EPOCHS)])
    cfg = train_hetu_bert.config(args, 65)
    jcfg = jb.BertConfig(vocab_size=65, d_model=64, n_heads=4, n_layers=2,
                         d_ff=128, max_seq_len=32, dtype=jnp.float32)
    jp = jax.tree.map(np.asarray, jb.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    tp = tree_from_numpy(jp, "cpu", like=tb.init_params(0, cfg, "cpu"))
    got = []
    last, final = train_hetu_bert.run(
        args, params=tp, on_step=lambda *r: got.append(r[2:]))
    want = _jax_losses(args, jax.tree.map(jnp.asarray, jp))
    assert len(got) == len(want) == 2 * EPOCHS      # 47 instances, batch 16
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-5)
    np.testing.assert_allclose(last, np.mean([w[0] for w in want[-2:]]),
                               rtol=1e-5)
    assert int(final["opt"]["t"]) == 2 * EPOCHS       # the final state


def _final(directory, step):
    state, got = checkpoint.TrainCheckpointer(directory).restore_latest()
    assert got == step
    return state


def test_bert_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, capsys):
    common = ["--cpu", "--ckpt-dir"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    train_hetu_bert.main(common + [a, "--num-epoch", "3", "--ckpt-every",
                                   "1"])
    assert checkpoint.TrainCheckpointer(a).all_steps() == [0, 1, 2]
    train_hetu_bert.main(common + [a, "--num-epoch", "6", "--ckpt-every",
                                   "1", "--resume"])
    assert "resumed from epoch 2" in capsys.readouterr().out
    # keep=3: the newest three epochs remain
    assert checkpoint.TrainCheckpointer(a).all_steps() == [3, 4, 5]
    train_hetu_bert.main(common + [b, "--num-epoch", "6"])
    ra, rb = _final(a, 5), _final(b, 5)
    flat_a = tt.tree_leaves(ra, with_paths=True)
    flat_b = dict(tt.tree_leaves(rb, with_paths=True))
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        assert x.dtype == flat_b[path].dtype
        assert np.array_equal(x, flat_b[path]), path
    assert float(ra["opt"]["t"]) == 12.0
    # a finished run resumed has nothing to do
    assert train_hetu_bert.main(common + [a, "--num-epoch", "6",
                                          "--resume"]) is None


def _state():
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 4, generator=g),
              "half": torch.randn(5, generator=g).to(torch.bfloat16),
              "nested": {"b": torch.arange(4, dtype=torch.int32)}}
    opt = tt.init_opt_state(params)
    opt["t"] = opt["t"] + 7.0
    return {"params": params, "opt": opt}


def test_save_and_restore_keep_values_dtypes_and_refuse_overwrite(tmp_path):
    state = _state()
    path = str(tmp_path / "ck")
    checkpoint.save(path, state)
    with pytest.raises(FileExistsError):
        checkpoint.save(path, state)
    back = checkpoint.restore(path, like=state)
    for (p, x), (_, y) in zip(tt.tree_leaves(back, with_paths=True),
                              tt.tree_leaves(state, with_paths=True)):
        assert x.dtype == y.dtype and torch.equal(x, y), p
    assert float(back["opt"]["t"]) == 7.0
    # force replaces; no temporary directory is left beside it
    state["params"]["w"] += 1
    checkpoint.save(path, state, force=True)
    assert torch.equal(checkpoint.restore(path, like=state)["params"]["w"],
                       state["params"]["w"])
    assert os.listdir(tmp_path) == ["ck"]
    # no like: numpy arrays, bfloat16 widened exactly to float32
    raw = checkpoint.restore(path)
    assert isinstance(raw["params"]["w"], np.ndarray)
    assert raw["params"]["half"].dtype == np.float32
    np.testing.assert_array_equal(raw["params"]["half"],
                                  state["params"]["half"].float().numpy())
    # like must match: a dtype or a key that differs raises
    wrong = dict(state, params=dict(state["params"],
                                    w=state["params"]["w"].double()))
    with pytest.raises(ValueError, match="/params/w"):
        checkpoint.restore(path, like=wrong)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.restore(path, like={"params": state["params"]})
    with pytest.raises(NotImplementedError, match="slice 8"):
        checkpoint.restore(path, like=state, mesh=object())


def test_a_failed_save_keeps_the_previous_checkpoint(tmp_path):
    state = _state()
    path = str(tmp_path / "ck")
    checkpoint.save(path, state)
    with pytest.raises(TypeError):
        checkpoint.save(path, {"bad": object()}, force=True)
    assert torch.equal(checkpoint.restore(path, like=state)["params"]["w"],
                       state["params"]["w"])
    assert os.listdir(tmp_path) == ["ck"]


def test_train_checkpointer_force_keep_and_empty(tmp_path):
    with checkpoint.TrainCheckpointer(str(tmp_path / "run"), keep=2) as ck:
        assert ck.latest_step() is None
        assert ck.restore_latest() == (None, None)
        state = _state()
        for step in range(4):
            state["opt"]["t"] = torch.tensor(float(step))
            ck.save_step(step, state)
        assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
        with pytest.raises(FileExistsError):
            ck.save_step(3, state)
        state["opt"]["t"] = torch.tensor(30.0)
        ck.save_step(3, state, force=True)
        back, step = ck.restore_latest(like=state)
        assert step == 3 and float(back["opt"]["t"]) == 30.0
        raw, _ = ck.restore_latest()
        assert float(raw["opt"]["t"]) == 30.0
        with pytest.raises(NotImplementedError, match="slice 8"):
            ck.restore_latest(like=state, specs={})


def test_graph_api_lm_trainer_learns_on_the_cpu():
    losses = train_hetu_transformer.main(["--steps", "100"], device="cpu")
    assert len(losses) == 100 and np.all(np.isfinite(losses))
    assert np.mean(losses[-20:]) < 0.5 * np.mean(losses[:20])


def test_generate_demo_runs_and_learns_on_the_cpu(capsys):
    loss = generate_hetu.main(["--steps", "60", "--beam", "2", "--max-len",
                               "12", "--cpu"])
    assert np.isfinite(loss) and loss < 3.0
    out = capsys.readouterr().out
    for line in ("greedy:", "top-k sample:", "beam (K=2):", "eos-aware:",
                 "ragged batch:"):
        assert line in out
