"""Pipeline parallelism of the transformer trunk over a mesh's ``pp`` axis
(counterpart of ``hetu_tpu/parallel/pipeline.py``): the GPipe step, the
1F1B step, their ZeRO-1 slot layout and the 1F1B schedule simulator.

The JAX package runs the whole pipeline as one jitted program: stage
weights stacked on a leading ``(pp, L/pp, ...)`` axis, activations moved
by ``lax.ppermute`` inside a ``shard_map``. The port follows its own
one-process-per-device rule and the reference's per-stage ranks: rank
``(d, s)`` of a ``(dp, pp)`` mesh holds stage ``s``'s blocks, whole, as
``(L/pp, ...)`` tensors (``init_pipeline_params``; ``interop.stage_tree``
and ``interop.stages_to_numpy`` map the JAX layout both ways) and its dp
share of each microbatch. Stages send activations forward and gradients
back by point-to-point messages over the ``pp`` group
(``multihost.send``/``recv``: NCCL, or gloo with host staging where the
group asked for it). Every rank holds the embedding, position table, final
norm and head whole, as the JAX package replicates them: their gradients
come from stage 0 (the token lookup, ``fused_embed_grad``) and the last
stage (the head, tied or not) and are summed over ``pp`` before the dp
mean, as ``shard_map``'s transpose of a replicated input sums them there.

- GPipe (``make_pipeline_train_step``): all forwards, each microbatch's
  graph kept (with ``cfg.remat`` each block recomputed in the backward),
  then all backwards in reverse microbatch order; one AdamW apply.
- 1F1B (``make_pipeline_train_step_1f1b``): each process runs its stage's
  micro-ops of the simulated table (``simulate_1f1b_schedule``, the JAX
  package's, tick for tick) in order, backward before forward within a
  tick. A forward runs without a graph and stashes its input (stage 0: the
  microbatch index); the backward recomputes the stage from it (remat at
  stage granularity), so at most ``min(window, M)`` inputs are stashed.
  It is not a tick-synchronous program: each process runs only its own
  micro-ops, so ``predication="masked"`` and ``"cond"`` give the same
  math and are both accepted.

Both take tokens and targets ``(M, mb, T)`` on every rank and return the
global loss: the last stage's mean NLL over the M microbatches plus
``aux_weight`` times the MoE aux loss summed over the stages, over M.
Dropout folds the key per (microbatch, global layer), as the trunk's
accumulation does, and under dp each rank keeps its rows of the whole
microbatch's mask (``transformer.batch_share``). Sends never block (the
receiver blocks), so the table's order cannot deadlock.
"""
from __future__ import annotations

import torch

from ..models import transformer as tfm
from . import mesh as meshlib
from . import multihost


def _stack_stages(params, pp: int):
    """Reshape per-layer stacked block params (L, ...) -> (pp, L//pp, ...)."""
    def reshape(x):
        L = x.shape[0]
        if L % pp:
            raise ValueError(f"n_layers {L} not divisible by pp {pp}")
        return x.reshape(pp, L // pp, *x.shape[1:])
    return tfm.tree_map(reshape, params)


def pipeline_spec(cfg: tfm.TransformerConfig, pp: int):
    """Partition specs of the pipeline params in the JAX layout: the
    blocks get a leading ``"pp"`` dimension, the rest is whole."""
    base = tfm.param_specs(cfg)
    blocks = {k: ("pp",) + s for k, s in base["blocks"].items()}
    return {**{k: () for k in base if k != "blocks"}, "blocks": blocks}


def _make_stage_fn(cfg: tfm.TransformerConfig, layers_per_stage: int,
                   mesh=None):
    """One stage's forward over one microbatch, shared by both schedules:
    ``stage_fn(h, stage_blocks, stage, rng_mb) -> (h, aux)``. Each layer
    folds its global index into the microbatch's dropout seed, as the
    trunk's accumulation (``fold_in(rng, mi)``, then ``fold_in(., li)``).
    The blocks run their tp, sp and ep collectives on the stage's own
    sub-groups of ``mesh`` (the ranks that share this rank's pp
    coordinate)."""
    def stage_fn(h, stage_blocks, stage, rng_mb):
        return tfm.run_blocks(stage_blocks, h, cfg, mesh, dropout_rng=rng_mb,
                              first_layer=stage * layers_per_stage)
    return stage_fn


def zero1_pipeline_opt_specs(cfg: tfm.TransformerConfig, mesh):
    """ZeRO-1 slot layout of the pipeline params (JAX layout: the blocks
    keep their leading ``"pp"``): ``transformer.zero1_specs`` over
    ``pipeline_spec``, as the trunk's."""
    pp = meshlib.axis_size(mesh, "pp")
    p = tfm.init_params(0, cfg, "meta")
    full = {**p, "blocks": _stack_stages(p["blocks"], pp)}
    return tfm.zero1_specs(pipeline_spec(cfg, pp), full, mesh)


def _local_specs(specs):
    """The specs of a rank's own tree: a block tensor is its stage's slice,
    without the ``"pp"`` dimension."""
    return {**{k: v for k, v in specs.items() if k != "blocks"},
            "blocks": {k: s[1:] for k, s in specs["blocks"].items()}}


def shard_pipeline_opt_state(opt_state, cfg: tfm.TransformerConfig, mesh,
                             zero1: bool = False):
    """This rank's AdamW state for a pipeline step built with ``zero1``:
    the ZeRO-1 shards of its tree when ``zero1``, else as it is."""
    if not zero1:
        return opt_state
    return tfm.place_opt_state(
        opt_state, _local_specs(zero1_pipeline_opt_specs(cfg, mesh)), mesh)


def init_pipeline_params(rng, cfg: tfm.TransformerConfig, mesh, device=None):
    """This rank's pipeline params: ``init_params(rng, cfg)``'s values (the
    same generator schedule), with only this stage's blocks, ``(L/pp,
    ...)`` each and marked as a stage's (``checkpoint.save`` refuses
    them), and of each tensor this rank's tp/ep slice
    (``transformer.shard_params``)."""
    pp, s = meshlib.axis_size(mesh, "pp"), meshlib.axis_rank(mesh, "pp")
    params = tfm.init_params(rng, cfg, device)
    blocks = _stack_stages(params["blocks"], pp)
    params["blocks"] = tfm.tree_map(lambda x: x[s].clone(), blocks)
    return stage_params(params, cfg, mesh)


def stage_params(params, cfg: tfm.TransformerConfig, mesh):
    """A stage's tree (its blocks ``(L/pp, ...)``, the rest whole) cut to
    this rank's tp/ep slices, its blocks marked as a stage's."""
    params = tfm.shard_params(params, cfg, mesh)
    for v in params["blocks"].values():
        meshlib.mark_shard(v, "pipeline stage")
    return params


# ---------------------------------------------------------------------------
# the per-stage engine shared by both schedules
# ---------------------------------------------------------------------------

class _Pipe:
    """One step's work on this rank: its stage, its peers and its share of
    the data; the forward and backward micro-ops and their messages."""

    def __init__(self, cfg, mesh, M, aux_weight, dp, stage_fn, params,
                 tokens, targets, dropout_rng):
        self.cfg, self.M, self.aux_weight = cfg, M, aux_weight
        self.pp = meshlib.axis_size(mesh, "pp")
        self.s = meshlib.axis_rank(mesh, "pp")
        self.first, self.last = self.s == 0, self.s == self.pp - 1
        ranks = meshlib.axis_ranks(mesh, "pp")
        self.prev = ranks[self.s - 1] if not self.first else None
        self.next = ranks[self.s + 1] if not self.last else None
        self.group = meshlib.axis_group(mesh, "pp")
        self.stage_fn, self.dp, self.mesh = stage_fn, dp, mesh
        self.tokens, self.targets = (dp.seq_share(dp.share(x, 1), 2)
                                     for x in (tokens, targets))
        self.rng = dropout_rng
        self.leaves = tfm.tree_map(lambda p: p.detach().requires_grad_(),
                                   params)
        self.other = {k: v for k, v in self.leaves.items() if k != "blocks"}
        mb, T = self.tokens.shape[1], self.tokens.shape[2]
        self.act_shape = (mb, T, cfg.d_model)
        self.sent: list = []
        dev = params["lnf_scale"].device
        self.nll_sum = torch.zeros((), dtype=torch.float32, device=dev)
        self.aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        self.bytes_sent = 0

    def mb_rng(self, m):
        return None if self.rng is None else tfm.fold_in(self.rng, m)

    def send(self, t, dst):
        self.sent.append(multihost.send(t.detach(), dst, self.group))
        self.bytes_sent += t.numel() * t.element_size()

    def stage_input(self, m):
        """Stage 0 embeds microbatch m (its graph reaches the embedding);
        another stage receives it from the previous stage."""
        if self.first:
            return tfm.embed_tokens(self.other, self.tokens[m], self.cfg,
                                    self.mesh)
        return multihost.recv(self.act_shape, self.cfg.dtype, self.prev,
                              self.group)

    def run_stage(self, h_in, m):
        """``(h_out, objective)``: the stage's output and its share of the
        loss (the last stage's NLL and every stage's aux term, over M)."""
        h_out, aux = self.stage_fn(h_in, self.leaves["blocks"], self.s,
                                   self.mb_rng(m))
        obj = aux * (self.aux_weight / self.M)
        self.aux_sum = self.aux_sum + aux.detach().float()
        if self.last:
            nll = tfm.lm_nll(self.other, h_out, self.targets[m], self.cfg,
                             self.mesh)
            self.nll_sum = self.nll_sum + nll.detach().float()
            obj = obj + nll / self.M
        return h_out, obj

    def backward(self, h_in, h_out, obj):
        """Backpropagate the stage: the last from its objective, the
        others from the gradient the next stage sends; send the input's
        gradient back."""
        outs, cts = [], []
        if not self.last:
            outs.append(h_out)
            cts.append(multihost.recv(self.act_shape, h_out.dtype, self.next,
                                      self.group))
        if obj.requires_grad:
            outs.append(obj)
            cts.append(torch.ones_like(obj))
        torch.autograd.backward(outs, cts)
        if not self.first:
            self.send(h_in.grad, self.prev)

    def finish(self, with_grads: bool = True):
        """``(loss, grads)``: the global loss; the stage's gradients (None
        without ``with_grads``), the replicated params' summed over pp,
        all averaged over dp."""
        for w in self.sent:
            w.wait()
        loss = self.nll_sum / self.M + self.aux_weight * self.aux_sum / self.M
        if not with_grads:
            if self.pp > 1:
                multihost.all_reduce_([loss], self.group)
            self.dp.mean_([loss])
            return loss, None
        grads = tfm.tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                             else p.grad, self.leaves)
        tfm.sum_shared_kv_(grads, self.cfg, self.mesh)
        if self.pp > 1:
            multihost.all_reduce_([loss] + [grads[k] for k in grads
                                            if k != "blocks"], self.group)
        self.dp.mean_([loss] + tfm.tree_leaves(grads))
        return loss, grads


def _make_step(cfg, mesh, num_microbatches, lr, aux_weight, zero1, schedule,
             forward=None):
    """The step, ``fwd_bwd`` and the dropout arity switch, shared by both
    schedules (the two steps stay drop-in interchangeable). ``forward``: a
    forward-only schedule, for ``fwd_loss``. ``step.info["bytes_sent"]``
    counts the bytes this rank sent to its neighbours in the last step."""
    meshlib.check_mesh(mesh)
    pp = meshlib.axis_size(mesh, "pp")
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp {pp}")
    specs = (_local_specs(zero1_pipeline_opt_specs(cfg, mesh)) if zero1
             else None)
    dp = tfm.DataParallel(mesh, specs)
    stage_fn = _make_stage_fn(cfg, cfg.n_layers // pp, mesh)
    M = num_microbatches
    use_dropout = cfg.dropout_rate > 0.0

    info = {"bytes_sent": 0}

    def run(params, tokens, targets, dropout_rng=None, sched=schedule):
        if use_dropout and dropout_rng is None:
            # a forgotten key must not silently train without dropout
            raise ValueError("cfg.dropout_rate > 0: pass dropout_rng to the "
                             "pipeline step")
        if tokens.shape[0] != M:
            raise ValueError(f"tokens hold {tokens.shape[0]} microbatches, "
                             f"the step was built for {M}")
        pipe = _Pipe(cfg, mesh, M, aux_weight, dp, stage_fn, params, tokens,
                     targets, dropout_rng)
        with tfm.batch_share(dp.rank, dp.size, dp.sp_rank, dp.sp), \
                torch.set_grad_enabled(sched is schedule):
            sched(pipe)
        info["bytes_sent"] = pipe.bytes_sent
        return pipe.finish(with_grads=sched is schedule)

    def step(params, opt_state, tokens, targets, dropout_rng=None):
        loss, grads = run(params, tokens, targets, dropout_rng)
        params, opt_state = dp.apply(params, grads, opt_state, lr)
        return loss, params, opt_state

    out = step if use_dropout else (
        lambda params, opt_state, tokens, targets: step(
            params, opt_state, tokens, targets))
    # the pipelined (loss, gradients) without the update, for gradient
    # parity against the JAX package's and between the two schedules
    out.fwd_bwd = run
    if forward is not None:
        out.fwd_loss = lambda params, tokens, targets, dropout_rng=None: run(
            params, tokens, targets, dropout_rng, sched=forward)[0]
    out.info = info
    return out


def _gpipe_forward(pipe: _Pipe):
    """All forwards; returns each microbatch's (input, output, objective)."""
    kept = []
    for m in range(pipe.M):
        h_in = pipe.stage_input(m)
        if not pipe.first and torch.is_grad_enabled():
            h_in.requires_grad_()
        h_out, obj = pipe.run_stage(h_in, m)
        if not pipe.last:
            pipe.send(h_out, pipe.next)
        kept.append((h_in, h_out, obj))
    return kept


def _gpipe(pipe: _Pipe):
    """All forwards, then all backwards in reverse microbatch order."""
    kept = _gpipe_forward(pipe)
    for m in reversed(range(pipe.M)):
        pipe.backward(*kept[m])
        kept[m] = None


def make_pipeline_train_step(cfg: tfm.TransformerConfig, mesh,
                             num_microbatches: int, lr: float = 1e-3,
                             aux_weight: float = 0.01, zero1: bool = False):
    """The GPipe step: ``step(params, opt_state, tokens, targets[,
    dropout_rng]) -> (loss, params, opt_state)``, tokens/targets ``(M, mb,
    T)``, params this rank's (``init_pipeline_params``). ``zero1``: shard
    AdamW's m/v over dp (place the state with
    ``shard_pipeline_opt_state(..., zero1=True)`` first). ``step.fwd_bwd``
    gives ``(loss, grads)`` without the update; ``step.fwd_loss`` the loss
    alone, forward only."""
    return _make_step(cfg, mesh, num_microbatches, lr, aux_weight, zero1,
                    _gpipe, forward=_gpipe_forward)


# ---------------------------------------------------------------------------
# 1F1B (PipeDream-flush): the JAX package's schedule simulator, exact
# ---------------------------------------------------------------------------

def resolve_inflight_window(pp: int, max_inflight: int = None) -> int:
    """The in-flight window: 2*pp by default (None only; an explicit 0 is
    refused, as every sub-1 window is)."""
    window = 2 * pp if max_inflight is None else int(max_inflight)
    if window < 1:
        raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    return window


def simulate_1f1b_schedule(pp: int, num_microbatches: int,
                           max_inflight: int = None):
    """Greedy dependency-driven 1F1B schedule table (host-side, static),
    the JAX package's: each tick, each stage may fire its next forward and
    its next backward.

    - F(m) on stage s: upstream F(m) done earlier (s>0); downstream has
      consumed F(m-1); in-flight microbatches below ``max_inflight``
      (default 2*pp).
    - B(m) on stage s: downstream B(m) done earlier (s<pp-1) or own F(m)
      done earlier (last stage); upstream has consumed B(m-1).

    A same-tick consumption frees a credit (receivers decide before
    senders: B in ascending stage order, F in descending), and B decides
    before F. Returns ``table``: a list over ticks of per-stage ``(fm, bm)``
    pairs, each an int microbatch or None."""
    M = num_microbatches
    W = resolve_inflight_window(pp, max_inflight)
    next_f = [0] * pp
    next_b = [0] * pp
    fwd_done = [[None] * M for _ in range(pp)]
    bwd_done = [[None] * M for _ in range(pp)]
    table = []
    t = 0
    while any(next_b[s] < M for s in range(pp)):
        brow = [None] * pp
        for s in range(pp):
            m = next_b[s]
            if m < M:
                if s == pp - 1:
                    ready = (fwd_done[s][m] is not None
                             and fwd_done[s][m] < t)
                else:
                    ready = (bwd_done[s + 1][m] is not None
                             and bwd_done[s + 1][m] < t)
                if ready and s > 0 and m > 0:
                    ready = (brow[s - 1] == m - 1
                             or (bwd_done[s - 1][m - 1] is not None
                                 and bwd_done[s - 1][m - 1] <= t))
                if ready:
                    brow[s] = m
        frow = [None] * pp
        for s in range(pp - 1, -1, -1):
            m = next_f[s]
            inflight = (next_f[s] - next_b[s]
                        - (1 if brow[s] is not None else 0))
            if m < M and inflight < W:
                ready = s == 0 or (fwd_done[s - 1][m] is not None
                                   and fwd_done[s - 1][m] < t)
                if ready and s < pp - 1 and m > 0:
                    ready = (frow[s + 1] == m - 1
                             or (fwd_done[s + 1][m - 1] is not None
                                 and fwd_done[s + 1][m - 1] <= t))
                if ready:
                    frow[s] = m
        row = list(zip(frow, brow))
        fired = False
        for s, (fm, bm) in enumerate(row):
            if fm is not None:
                fwd_done[s][fm] = t
                next_f[s] += 1
                fired = True
            if bm is not None:
                bwd_done[s][bm] = t
                next_b[s] += 1
                fired = True
        if not fired:
            raise RuntimeError(f"1F1B schedule deadlock at tick {t} "
                               f"(pp={pp}, M={M})")
        table.append(row)
        t += 1
    return table


def schedule_stats(pp: int, num_microbatches: int,
                   max_inflight: int = None) -> dict:
    """Per-stage bubble accounting of both schedules, the JAX package's:
    GPipe's M+pp-1 ticks a wave, bubble (pp-1)/(M+pp-1), a stash of one
    activation a tick; 1F1B's measured on the simulated table, its peak
    stash the high-water mark of forwarded, not yet backpropagated
    microbatches."""
    M = num_microbatches
    table = simulate_1f1b_schedule(pp, M, max_inflight)
    n_ticks = len(table)
    busy = [0] * pp
    inflight = [0] * pp
    peak = [0] * pp
    for row in table:
        for s, (fm, bm) in enumerate(row):
            if bm is not None:
                busy[s] += 1
                inflight[s] -= 1
            if fm is not None:
                busy[s] += 1
                inflight[s] += 1
                peak[s] = max(peak[s], inflight[s])
    g_ticks = M + pp - 1
    return {
        "gpipe": {"ticks_per_wave": g_ticks,
                  "bubble_fraction": round((pp - 1) / g_ticks, 4),
                  "peak_act_stash_per_stage": g_ticks},
        "1f1b": {"ticks": n_ticks,
                 "per_stage_busy": busy,
                 "bubble_fraction": round(
                     1.0 - sum(busy) / (2.0 * pp * n_ticks), 4),
                 "peak_act_stash_per_stage": max(peak)},
    }


def make_pipeline_train_step_1f1b(cfg: tfm.TransformerConfig, mesh,
                                  num_microbatches: int, lr: float = 1e-3,
                                  aux_weight: float = 0.01,
                                  zero1: bool = False,
                                  predication: str = "masked",
                                  max_inflight: int = None):
    """The 1F1B twin of ``make_pipeline_train_step``: the same signature
    and math, plus ``predication`` ("masked" or "cond": both run only this
    stage's micro-ops here) and ``max_inflight`` (the stash's window).
    ``step.fwd_bwd`` gives ``(loss, grads)``; ``step.table`` is the
    schedule it runs."""
    if predication not in ("masked", "cond"):
        raise ValueError(f"predication must be 'masked' or 'cond', got "
                         f"{predication!r}")
    pp = meshlib.axis_size(mesh, "pp")
    M = num_microbatches
    W = resolve_inflight_window(pp, max_inflight)
    table = simulate_1f1b_schedule(pp, M, W)
    ring = min(W, M)

    def schedule(pipe: _Pipe):
        stash = {}
        for row in table:
            fm, bm = row[pipe.s]
            if bm is not None:
                # recompute the stage from its stashed input, then back
                saved = stash.pop(bm)
                h_in = (pipe.stage_input(bm) if pipe.first
                        else saved.requires_grad_())
                h_out, obj = pipe.run_stage(h_in, bm)
                pipe.backward(h_in, h_out, obj)
            if fm is not None:
                if pipe.first:
                    stash[fm] = None          # stage 0 re-embeds from tokens
                else:
                    stash[fm] = pipe.stage_input(fm)
                if not pipe.last:
                    with torch.no_grad():
                        h_in = (pipe.stage_input(fm) if pipe.first
                                else stash[fm])
                        h_out, _ = pipe.stage_fn(h_in,
                                                 pipe.leaves["blocks"],
                                                 pipe.s, pipe.mb_rng(fm))
                    pipe.send(h_out, pipe.next)
                if len(stash) > ring:
                    raise RuntimeError(f"1F1B stash {len(stash)} over its "
                                       f"window {ring}")

    step = _make_step(cfg, mesh, num_microbatches, lr, aux_weight, zero1,
                    schedule)
    step.table = table
    return step
