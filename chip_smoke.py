#!/usr/bin/env python3
"""On-card smoke test of hetu_tpu_torch, the PyTorch/CUDA port: builds the
CUDA kernels from this checkout, checks from their SASS that the bf16
kernels of flash attention and the fused CE, forward and backward, run on
the tensor cores, and holds each kernel against its plain PyTorch version
on the card; trains the full-width MLP of
``examples/cnn/models/MLP.py`` (3072-256-256-10, synthetic CIFAR10, batch
128) through ``hetu_tpu_torch.Executor``, then trains it data-parallel
(``comm_mode="AllReduce"``) at world size 1 over NCCL with an explicit
one-rank dp mesh, under ``comm_quant`` off, int8 and fp8, after holding
the quantized all-reduce's quantize and dequantize kernels against their
plain versions bit for bit; runs the BERT-base forward
(``hetu_tpu_torch.models.bert``, random weights from a seed): the
pretraining loss without gradient on a synthetic phase-1 batch (32 x 128)
and the classifier on 8 requests; then trains BERT-base with
``make_pretrain_step`` for 20 steps on that batch, checks its first step's
gradients against ``kernels="off"``, does the same at the phase-2 shape
(32 x 512, 76 MLM slots) for 6 steps with the device time of a step, and
fine-tunes the classifier for 5 steps with ``make_finetune_step``; then trains the full-width GCN of
``examples/gnn`` (``dense_model``, 128 -> 256 -> 40) for 30 epochs on a
synthetic graph at ogbn-arxiv's size through ``Executor.run``, checks its
first epoch's loss and gradients against ``kernels="off"``, and runs one
``csrmv_op`` program; then trains WDL-Criteo (``examples/ctr``) at its
published widths and the full Criteo-Kaggle vocabulary (33,762,577 rows)
for 30 steps through ``Executor.run``, checks its first step's loss and
gradients against ``kernels="off"`` and that the rows no step looked up
kept their bits, and runs one ``embedding_lookup_gradient_op`` program in
dense and in rows mode; then trains ResNet-18 of ``examples/cnn`` at full
width (batch 128, synthetic CIFAR10, SGD at lr 0.1) through
``cnn_main.build`` and ``Executor.run`` for 30 steps in float32, its
first step against ``kernels="off"``, and 10 in bf16 compute; and trains
the graph-API transformer LM of ``examples/nlp/hetu_transformer.py`` at
its trainer's default widths for 30 Adam steps with dropout, its first
step at dropout 0 against ``kernels="off"``; and trains WDL-Criteo under
``comm_mode="Hybrid"`` against a local parameter-server cluster (the
script is worker 0; the table on four host servers, 16 M of the
vocabulary's rows, the dense MLP on the card) for 30 steps with BSP + prefetch
and 30 with prefetch off, after holding its first steps against local
mode and its first step against ``kernels="off"``, and pushes an explicit
``embedding_lookup_gradient_op`` through the rows route; trains DistGCN's
1.5D GCN (``parallel/distgcn.py`` through ``examples/gnn_dist.py``) on a
1 x 1 grid over NCCL at the arxiv-sized graph for 30 epochs, its first
epoch against ``kernels="off"``; runs the sampled-subgraph GCN
(``examples/gnn_sampled.py``) at its defaults against a local cluster of
one server, its first step against ``kernels="off"``; and trains NCF
(``examples/ncf.py``) at ml-1m's user and item counts for an epoch in
local mode, its first step against ``kernels="off"``, and 100 steps under
Hybrid. Each path is checked to have gone through its kernels.

    python3 chip_smoke.py
    python3 chip_smoke.py --bert-kernels   # sections 1-3 only: a minute
    python3 chip_smoke.py --csr-kernels    # build, the CSR kernels only
    python3 chip_smoke.py --opt-kernels    # build, the optimizer kernels only
    python3 chip_smoke.py --quant-kernels  # build, the quantize kernels only
    python3 chip_smoke.py --embed-kernels  # build, the embedding gradient only
    python3 chip_smoke.py --zoo            # build, ResNet-18 and the LM only
    python3 chip_smoke.py --ps             # build, the Hybrid phase only
    python3 chip_smoke.py --gnn            # build, DistGCN, sampled GCN, NCF

Needs one CUDA card (``cuda:0``) and ``nvcc``; exits non-zero, printing no
result, when either is missing or any phase fails. Prints one JSON line per
phase, then the ``kernels`` JSON line, the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package. ``--bert-kernels`` stops
after the kernels of the BERT path (the optimizers', flash attention's and
the fused CE's, forward and backward) are built, checked and timed, and
prints no result line: a quick check of a kernel change. ``--csr-kernels``
does the same for ``csr_spmm`` and ``csr_spmv`` on the GCN's adjacency,
``--opt-kernels`` for ``fused_sgd`` and ``fused_adam``, ``--quant-kernels``
for ``quant_blocks`` and ``dequant_blocks``, ``--embed-kernels`` for
``fused_embed_grad`` (at the CTR and the BERT path's shapes); ``--zoo``
builds and runs the ResNet-18 and LM phases (sections 10-11) alone;
``--ps`` the Hybrid phase (section 12) alone; ``--gnn`` the DistGCN,
sampled-GCN and NCF phases (sections 13-15) alone.
"""
import argparse
import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH = 128
SGD_STEPS, SGD_LR = 200, 0.1
ADAM_STEPS, ADAM_LR = 50, 1e-3
# The full-width MLP's parameters, in the executor's order (fc1..fc3).
MLP_SHAPES = [(3072, 256), (256,), (256, 256), (256,), (256, 10), (10,)]
ODD_SHAPE = (2**24 + 3,)
# The group kernels of fused_sgd and fused_adam against their plain
# versions, each case one group apply: the MLP's six shapes as one group;
# ODD_SHAPE with l2reg (SGD) and weight decay (Adam); VIEW_SHAPE with one
# of p, g, m, v a view at storage offset 1 (not 16-byte aligned: the
# kernel's scalar loop); MAX_TENSORS + 3 small tensors of odd sizes (two
# launches). Then one apply over LARGE_N elements (2^28: 3.2 GB moved by
# SGD) and its share of the memory rate.
VIEW_SHAPE, LARGE_N = (2**20 + 5,), 2**28
# Kernel vs plain version on the card. SGD: each product rounds where the
# plain version rounds it (-fmad=false), so they agree bit for bit.
# Adam: powf in the kernel and torch.pow may differ by an ulp in beta**t.
# Each kernel is bit-equal to itself on a rerun.
TOL = {"fused_sgd": "bit-equal",
       "fused_adam": dict(rtol=1e-5, atol=1e-6)}
# The mean loss of the last 10 steps must fall below these. The JAX
# package's own CPU run of this configuration (hetu_tpu.Executor, seed 0,
# the same synthetic CIFAR10, batch 128; `python tools/port_reference.py
# smoke-config` with JAX_PLATFORMS=cpu) went from 2.85 (SGD) and 1.12
# (Adam) over the first 10 steps to 2.1e-6 after 200 SGD steps at lr 0.1
# and 4.1e-7 after 50 Adam steps at lr 1e-3; the thresholds leave room for
# the port's different initial weights.
SGD_LOSS_MAX, ADAM_LOSS_MAX = 1e-2, 1e-2

# Attention checks (B, H, S, D, dtype, causal, key padding): the BERT-base
# layer (the main path's shape; its times go into the kernels line), the
# phase-2 BERT-base layer (S = 512), a long causal sequence, and a small f32
# case also held against the unfused softmax(q k^T) v in f32.
ATTN_CASES = [(32, 12, 128, 64, torch.bfloat16, False, True),
              (32, 12, 512, 64, torch.bfloat16, False, True),
              (8, 12, 512, 64, torch.bfloat16, True, False),
              (2, 4, 256, 128, torch.float32, True, True)]
# Fused linear+CE checks (N, V, D, layout), bf16: BERT-base's MLM loss (32
# rows x 20 slots against the tied (V, D) embedding, with the MLM bias; the
# main path's shape), a GPT-2 LM head ((D, V), N ragged against 128) and
# BERT-base's phase-2 MLM shape (32 rows x 76 slots).
CE_CASES = [(640, 30522, 768, "vd"), (1000, 50257, 768, "dv"),
            (2432, 30522, 768, "vd")]
# The backward at the same shapes, and at the MLM shape in f32, where no
# output rounding hides dh's softmax term (~1e-4 of its onehot term, below
# a bf16 rounding).
CE_BWD_CASES = ([c + (torch.bfloat16,) for c in CE_CASES]
                + [(640, 30522, 768, "vd", torch.float32)])
# Kernel vs plain version: o in bf16 may differ by one bf16 rounding of o
# and of p (the bf16 kernel rounds p once to bf16 as it enters p.V; the
# plain version keeps it f32), so it is also held by its relative L2 error,
# as the backward's outputs are (an absolute 2e-2 alone would pass zeros);
# f32 by summation order alone; lse, the target logit and the NLL are f32
# sums over 128-512 keys or 30k-50k logits. Each bf16 kernel is bit-equal
# to itself on a rerun.
TOL.update({
    "flash_attention_fwd": {"o_bf16": dict(rtol=2e-2, atol=2e-2),
                            "o_f32": dict(rtol=2e-5, atol=2e-5),
                            "lse": dict(rtol=0, atol=1e-3),
                            "rel_l2_bf16": 1e-2},
    "fused_linear_nll_fwd": {"lse_tl_nll": dict(rtol=0, atol=1e-3)},
    # the backward kernels against their plain versions: each gradient is
    # an f32 sum rounded once to the output dtype on both sides, so bf16
    # outputs may differ by a bf16 rounding and f32 ones by summation
    # order; db is an f32 sum over the rows. The f32 attention case is
    # also held against autograd of the unfused f32 softmax(q k^T) v.
    # Gradients can be far smaller than an absolute tolerance (at the MLM
    # shape dh is ~3e-5 and dW ~1e-6 off the target rows), so each output
    # is also held by its relative L2 error, ||got - want|| / ||want||:
    # one bf16 rounding of every element is at most 2^-9 ~ 2e-3. For the
    # fused CE the onehot term dominates dW and db; their entries of the
    # vocabulary ids no row targets hold the softmax term alone and are
    # held by the same relative error ("untargeted").
    "flash_attention_bwd": {"bf16": dict(rtol=2e-2, atol=2e-2),
                            "f32": dict(rtol=2e-5, atol=2e-5),
                            "f32_vs_autograd": dict(rtol=0, atol=2e-5),
                            "rel_l2_bf16": 1e-2, "rel_l2_f32": 2e-5},
    "fused_linear_nll_bwd": {"dh_dw_bf16": dict(rtol=2e-2, atol=2e-2),
                             "dh_dw_f32": dict(rtol=2e-5, atol=2e-5),
                             "db": dict(rtol=0, atol=1e-3),
                             "rel_l2_bf16": 1e-2, "rel_l2_f32": 2e-5}})
# The BERT-base forward with the kernels against kernels="off" (the plain
# versions on the card): losses rel 5e-3; classifier logits (|x| < ~1)
# atol 2e-2, for bf16 activations rounded at other places over 12 layers.
BERT_REL, LOGITS_ATOL = 5e-3, 2e-2
BERT_BATCH, BERT_SEQ, BERT_PRED, BERT_REQUESTS, BERT_ITERS = 32, 128, 20, 8, 20
# BERT-base's phase-2 shape (bench.py's BERT section, examples/
# bert_pretrain.py --seq 512 --pred 76): the first step's gradients under
# the phase-1 gates, then PHASE2_STEPS steps (bert_pretrain.WARMUP of them
# warm-up for the step time) and a profile of PHASE2_PROFILE steps for the
# device time.
PHASE2_SEQ, PHASE2_PRED, PHASE2_STEPS, PHASE2_PROFILE = 512, 76, 6, 2
# BERT-base pretraining: 20 AdamW steps at lr 1e-4 on the phase-1 batch,
# 3 of them warm-up for the step time; the first loss within
# FIRST_LOSS_TOL of ln V + ln 2, the loss at random init. The first step's
# gradients with the kernels against kernels="off" (plain versions on the
# card), at full width twice: in f32, every parameter's gradient within a
# relative L2 error of GRAD_REL (the two sides differ by summation order
# only); in bf16, the main path's dtype, all gradients together within
# GRAD_REL, and by what bf16 rounding itself costs, measured from the f32
# gradient: the kernels' bf16 gradients, all together, at most
# BF16_EXCESS times as far (rel L2) from it as the plain versions' bf16
# gradients are; each tensor's at most BF16_EXCESS times the larger of
# the plain versions' distance for that tensor and for all together (a
# tensor of few elements, such as nsp_b's 2, can sit below the model's
# bf16 noise by chance). Both bf16 sides round at the same places and the
# kernels match their plain versions to about a bf16 rounding, so the
# distances should be alike; a kernel fault that only bf16 shows makes
# the kernels' grow.
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR, GRAD_REL, FIRST_LOSS_TOL = (
    20, 3, 1e-4, 2e-2, 0.5)
BF16_EXCESS = 2.0
FINETUNE_STEPS, FINETUNE_LR = 5, 2e-5
# CSR products on the GCN's adjacency (the arxiv-sized graph), at the main
# path's shapes: A·X at F = 128 (layer 1), A·H at F = 256 (layer 2), Aᵀ·dZ
# at F = 256 (layer 2's backward), and the vector product on A. Kernel and
# plain version sum each chunk of a row (chunk_plan) in CSR order with one
# f32 accumulator, each product rounded before the add (-fmad=false), and
# fold a split row's partials in chunk order: each output must be bit-equal
# to the plain version and to a rerun, and within rel L2 1e-6 of it.
CSR_CASES = [("A", 128), ("A", 256), ("A^T", 256)]
TOL.update({"csr_spmm": {"rel_l2": 1e-6}, "csr_spmv": {"rel_l2": 1e-6}})
# The GCN (run_single's dense_model at ogbn-arxiv's widths, hidden 256,
# SGD lr 0.5): per epoch 3 csr_spmm (2 forward, 1 backward) and 1
# fused_sgd launch (its four parameters as one group). The first epoch's
# loss and gradients with the kernels against kernels="off", in f32: the sparse products are bit-equal
# and the dense ones are cuBLAS's on both sides, so rel L2 <= GCN_REL.
GCN_EPOCHS, GCN_LR, GCN_REL = 30, 0.5, 1e-5
GCN_LAUNCHES = {"csr_spmm": 3, "fused_sgd": 1}
# The embedding gradient's segment sum (fused_embed_grad): at the CTR
# path's shape, WDL-Criteo's step (the first batch's 128 x 26 ids over the
# full vocabulary, d = 128), and at the other shapes the CTR models and the
# edge cases give it: one id 3,328 times (one long run), d = 1 (DeepFM's
# first-order table), d = 8 (Deep Crossing, WDL-Adult) and one row, in the
# compact form (keys = ranks); then at the BERT path's two lookups at
# phase 2 (32 x 512 token ids, about 4,100 of them the padding id 0, into
# the 30,522-row table; their type ids into the 2-row one; d = 768), in the
# dense form the backward runs (keys = ids, into the table). Kernel and
# plain version add each id's pieces of a chunk in row order and fold them
# in chunk order: each output must be bit-equal to the plain version and to
# a rerun, and within rel L2 1e-6 of it.
EMBED_CASES = [("wdl", 128), ("single_id", 128), ("d1", 1), ("d8", 8),
               ("n1", 128), ("bert_token", 768), ("bert_type", 768)]
TOL["fused_embed_grad"] = {"rel_l2": 1e-6}
# WDL-Criteo (examples/ctr/models/wdl_criteo.py) at its published widths
# and the full Criteo-Kaggle vocabulary (its own default): 26 slots x 128
# over 33,762,577 rows (17.3 GB of f32), MLP 13-256-256-256, joint layer
# 3,584 -> 1, SGD lr 0.01, batch 128, 30 steps through Executor.run. Per
# step 1 fused_embed_grad (the table's gradient) and 1 fused_sgd launch
# (the table and the four dense parameters as one group).
# The first step's loss and gradients against kernels="off": the segment
# sums are bit-equal and the dense products are cuBLAS's on both sides, so
# rel L2 <= CTR_REL. Rows no step looks up (a seeded sample of CTR_SAMPLE
# rows) must keep their initial bits; the rows looked up must move.
CTR_VOCAB, CTR_DIM, CTR_BATCH, CTR_STEPS, CTR_REL = (33762577, 128, 128, 30,
                                                      1e-6)
CTR_LAUNCHES = {"fused_embed_grad": 1, "fused_sgd": 1}
CTR_SAMPLE, CTR_PROFILE_STEPS, CTR_OFF_VOCAB = 10**6, 3, 100000
# WDL-Criteo under comm_mode="Hybrid" (section 12): the same model and
# widths, its table on HYB_SERVERS host PS servers of a local cluster
# (the smoke is worker 0), the dense MLP on the card. HYB_VOCAB rows, cut
# from the full 33,762,577: the servers draw the table at about 4.4 s a
# million rows, one server after the other (on an H100 host, 18.0 s for
# 4 M rows on four servers and 20.4 s on one: tools/ps_hybrid_ms.py,
# PERF.md section 4), so the full vocabulary would take about 150 s, and
# 16 M rows (8.2 GB) about 70 s; the init is timed. HYB_STEPS steps with BSP + prefetch, then HYB_STEPS with prefetch
# off. Per step 1 fused_sgd (the four dense parameters) and
# no fused_embed_grad: the push carries the lookups' row gradients, and no
# table gradient exists on the card. Gates at CTR_OFF_VOCAB rows, each on
# a fresh cluster of HYB_SERVERS servers (the table's rows split over
# them as in the main run): the first HYB_GATE_STEPS steps (prefetch
# off) against local mode on the card from the same initial table and
# dense parameters (the losses, the touched rows, the rows' update
# w_after - w_before and the dense parameters within rel HYB_REL: the
# host sums an id's row gradients in another order than fused_embed_grad);
# the first step bit-equal to kernels="off"; and an explicit
# embedding_lookup_gradient_op pushed to the PS (the rows route: one
# fused_embed_grad in its compact form), whose rows on the server must
# equal -lr times its plain sums bit for bit.
HYB_VOCAB, HYB_SERVERS, HYB_STEPS, HYB_GATE_STEPS, HYB_REL = (
    16000000, 4, 30, 5, 1e-5)
HYB_LAUNCHES = {"fused_sgd": 1}
# The quantized all-reduce's blockwise quantize (quant_blocks) and
# dequantize (dequant_blocks), in int8 and fp8 at blocks 256 (the default
# and the main path's), 128, 64 and 7. The single-tensor forms (groups of
# one, no prologue) at: the MLP's three quantized gradients (fc1-fc3
# weights), an edge vector (a ragged tail, an all-zero block, a NaN, an
# infinity, exact .5 ties, -0.0) and a BERT-base-sized vector of 110 M
# elements, past 65,535 blocks. The group forms, at world size 1, with and
# without the error-feedback residual, at: the MLP's three quantized
# gradients as one group (as the DP step groups them), the edge vector
# and the 110 M vector. The payload crosses the wire: kernel and plain
# version must agree bit for bit (q, the scales, the residual and the
# dequantized values by their bits, NaN by position), and so must a rerun
# of the kernel. Timed at the main path's shapes: one group launch of
# each over the three gradients, with the residual.
QUANT_MODES, QUANT_BLOCKS = ("int8", "fp8"), (256, 128, 64, 7)
QUANT_SIZES = [("fc1", 786432), ("fc2", 65536), ("fc3", 2560),
               ("edge", 6 * 7 * 256 + 1001), ("bert_base", 110_000_000)]
QUANT_GROUPS = [("mlp", ("fc1", "fc2", "fc3")), ("edge", ("edge",)),
                ("bert_base", ("bert_base",))]
TOL.update({"quant_blocks": "bit-equal", "dequant_blocks": "bit-equal"})
# Data-parallel training of the same MLP (comm_mode="AllReduce") at world
# size 1 over NCCL, with an explicit one-rank dp mesh so the quantized
# all-reduce runs (the JAX package's rule: an explicit mesh of any size is
# taken as given), under comm_quant off, int8 and fp8, SGD and Adam, the
# steps of the MLP phase. Per step 1 fused_sgd/fused_adam launch and,
# quantized, 1 quant_blocks and 1 dequant_blocks (the fc1-fc3 weights as
# one group; the biases are below min_size). The first DP_CHECK_STEPS
# quantized steps against kernels="off": losses and parameters bit-equal
# under SGD, within TOL["fused_adam"] under Adam; and against the per-op
# path (each quantized weight alone through quantized_allreduce):
# bit-equal. The group all-reduce of the three gradients against
# quantized_allreduce per tensor, DP_CHECK_STEPS steps with the residual
# carried: bit-equal. DP off against local mode: bit-equal. The
# quantized loss curves against off: |l_q - l_off| <= DP_CURVE_TOL[mode] *
# max(1, l_off) over the first DP_CURVE_STEPS steps (one quantization step
# is scale/2 per element: 0.4 % of a block's largest gradient in int8,
# 6 % in fp8, partly carried by the error feedback).
DP_MODES, DP_CHECK_STEPS, DP_CURVE_STEPS = ("off", "int8", "fp8"), 5, 20
DP_CURVE_TOL = {"int8": 2e-2, "fp8": 1e-1}
DP_LAUNCHES = {"quant_blocks": 1, "dequant_blocks": 1}
# ResNet-18 (examples/cnn/models/ResNet.py at full width: stem 64, stages
# 64/128/256/512, 62 parameter tensors, 11,173,962 parameters) on the
# MLP's synthetic CIFAR10 in NCHW, batch 128, SGD at lr 0.1 (the
# reference's default), through cnn_main.build and Executor.run: 30 steps
# in float32, then 10 in bf16 compute over float32 parameters. Per step
# fused_sgd launches as often as opt_plan splits its 62 tensors (48 a
# launch: 2) and no other registered kernel launches. The first float32
# step against kernels="off" from the same seed, both with
# cudnn.deterministic set for that step (the two executors could
# otherwise pick other cuDNN algorithms): the loss within rel RESNET_REL,
# each parameter and BatchNorm running stat within relative L2 RESNET_REL.
# cudnn.benchmark stays off (cuDNN's heuristic picks the algorithms).
RESNET_STEPS, RESNET_BF16_STEPS, RESNET_LR, RESNET_REL = 30, 10, 0.1, 1e-5
RESNET_BF16_WARMUP = 3
# The graph-API transformer LM (examples/nlp/hetu_transformer.py) at
# train_hetu_transformer.py's default widths: B 8, T 32, d 64, 2 layers, 4
# heads, d_ff 256, dropout 0.1, on seeded ids over a 1,000-id vocabulary,
# Adam 1e-3, 30 steps. Per step 2 fused_embed_grad launches (the token and
# the position table) and fused_adam as often as opt_plan splits its 38
# tensors (1). The first step at dropout 0 against kernels="off": the loss
# and each parameter within rel (L2) LM_REL.
LM_VOCAB, LM_BATCH, LM_SEQ, LM_STEPS, LM_LR, LM_REL = (1000, 8, 32, 30, 1e-3,
                                                      1e-5)
LM_WIDTHS = dict(d_model=64, n_heads=4, n_layers=2, d_ff=256)
LM_DROPOUT = 0.1
# DistGCN (parallel/distgcn.py through examples/gnn_dist.py; section 13) on
# a 1 x 1 grid over NCCL (the card's host has one card, and NCCL refuses
# two ranks on one device): the arxiv-sized graph at the GCN's widths (128
# -> 256 -> 40), run_dist.py's weights (normal x 0.2 from RandomState(0))
# and its plain SGD step at lr 0.5, DGCN_EPOCHS epochs. Per epoch 3
# csr_spmm launches: two forward, one backward (the features need no
# gradient). The first epoch's loss, logits and both weights' gradients
# against kernels="off" within rel L2 GCN_REL; the loss at least halves.
DGCN_EPOCHS, DGCN_HIDDEN, DGCN_LR = 30, 256, 0.5
DGCN_LAUNCHES = {"csr_spmm": 3}
# The sampled-subgraph GCN (examples/gnn_sampled.py; section 14):
# gnn_sampled.main at the script's own defaults (512 nodes, 32 seeds and
# at most 128 nodes a subgraph, hidden 32, Adam 0.05, 10 epochs of 16
# steps), one server and one worker of a local cluster, the node
# embeddings in the cache's table on the server. Per step 1 fused_adam
# (w1 and w2 as one group). The first step from one executor's weights
# on one sampled batch against kernels="off": the loss, the rows'
# gradient and the prediction bit-equal, the updated weights within
# TOL["fused_adam"]. The epoch loss must fall.
SAMPLED_LAUNCHES = {"fused_adam": 1}
# NCF (examples/ncf.py; section 15) at ml-1m's 6,040 users and 3,706 items
# through getdata's own arguments, NCF_POS positives (4 negatives each;
# ml-1m has 1,000,209 ratings: cut to keep the phase near 30 s), batch
# 1,024 (run_hetu.py's), one epoch; lr 0.3 and embedding stddev 0.3
# (tests/test_ctr_models.py's test_ncf_trains: at neural_mf's 0.01 the
# logits stay near 0 for thousands of steps). Local mode: per step 1
# fused_sgd (all parameters) and 2 fused_embed_grad (the two tables); the
# first step against kernels="off" within rel (L2) NCF_REL; the loss falls
# (the mean of the last NCF_WINDOW steps below the first's). Then
# NCF_HYB_STEPS steps under Hybrid on a local cluster of one server (the
# tables on it, the MLP on the card): 1 fused_sgd a step, the loss falls.
NCF_POS, NCF_BATCH, NCF_REL, NCF_WINDOW, NCF_HYB_STEPS = (100_000, 1024,
                                                          1e-6, 20, 100)
NCF_MODEL = dict(learning_rate=0.3, embed_stddev=0.3)
NCF_LAUNCHES = {"fused_sgd": 1, "fused_embed_grad": 2}
NCF_HYB_LAUNCHES = {"fused_sgd": 1}

# The bf16 kernels, forward and backward (the *_tc_kernel functions of each
# source), and the SASS instruction each must hold: wgmma (HGMMA) in the
# fused CE's, mma.sync (HMMA) in flash attention's. Every one named here
# must be found, in each of its template instances.
TC_SASS = {"fused_ce": {"linear_nll_fwd_tc_kernel": "HGMMA",
                        "linear_nll_bwd_g_tc_kernel": "HGMMA",
                        "linear_nll_bwd_dh_tc_kernel": "HGMMA",
                        "linear_nll_bwd_dw_tc_kernel": "HGMMA"},
           "flash_attention": {"flash_fwd_tc_kernel": "HMMA",
                               "flash_bwd_dq_tc_kernel": "HMMA",
                               "flash_bwd_dkv_tc_kernel": "HMMA"}}

# Peak rates for the bound, by card name: device-memory bytes/s, float32
# (non-tensor-core) flop/s and bf16 dense tensor-core flop/s, from NVIDIA's
# data sheets.
CARDS = [("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100", 3.35e12, 67e12, 989e12), ("H200", 4.8e12, 67e12, 989e12)]


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_peaks(name):
    for key, bw, f32, bf16 in CARDS:
        if key in name:
            return bw, f32, bf16
    raise RuntimeError(f"chip_smoke: no peak rates known for card {name!r}")


def bound(nbytes, nflops, bw, flops):
    """(least ms for the work, what bounds it) at the card's peak rates."""
    t_bytes, t_ops = nbytes / bw * 1e3, nflops / flops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, iters=200, warmup=20):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=200):
    """Device time of ``fn`` without the host's launch cost: ``fn`` captured
    once in a CUDA graph, the graph replayed and timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters)


def device_split(fn, iters=20):
    """Device µs a call of ``fn`` by kernel name, from torch.profiler over
    ``iters`` calls: where one call makes several launches, each one's
    share."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            m = re.search(r"(\w+_kernel(<\w+>)?)", e.key)
            name = m.group(1) if m else e.key[:60]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / iters
    return out


def timings(kernel, plain, library):
    """One optimizer apply at the MLP's shapes: device time (``ms``, CUDA
    graph replay) and the time when called from Python, as the eager
    executor calls it (``launched_ms``)."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        out[key] = graph_ms(fn)
        out[key.replace("ms", "launched_ms")] = time_ms(fn)
    return out


def max_err(a, b, tol):
    torch.testing.assert_close(a, b, **tol)
    return float((a - b).abs().max())


def rel_l2(a, b):
    """||a - b|| / ||b||, in f32 (||a - b|| where b is all zeros)."""
    den = float(torch.linalg.vector_norm(b.float()))
    num = float(torch.linalg.vector_norm(a.float() - b.float()))
    return num / den if den > 0 else num


def rel_errs(names, got, want, limit, what):
    """Each output's relative L2 error against the plain version; fails
    above ``limit``."""
    errs = {n: rel_l2(g, w) for n, g, w in zip(names, got, want)}
    for n, e in errs.items():
        check(e <= limit, f"{what}: {n} differs from the plain version by "
              f"rel L2 {e} > {limit}")
    return errs


def tensor_core_phase(build):
    """The bf16 kernels run on the tensor cores: each kernel TC_SASS names
    is found, and each of its instances' SASS holds its tensor-core
    instruction, read with its registers and spills from a second compile
    of its source."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(TC_SASS)) as pool:
        found = dict(zip(TC_SASS, pool.map(build.resources, TC_SASS)))
    kernels = []
    for src, want in TC_SASS.items():
        # no name of TC_SASS holds another, so a substring names a kernel,
        # mangled or not
        tc = [k for k in found[src] if "_tc_kernel" in k["kernel"]]
        for name, op in want.items():
            inst = [k for k in tc if name in k["kernel"]]
            check(inst and all(k.get(op, 0) > 0 for k in inst),
                  f"csrc/{src}.cu: {name} not found or without {op}: "
                  f"{inst or [k['kernel'] for k in found[src]]}")
        unnamed = [k["kernel"] for k in tc
                   if not any(n in k["kernel"] for n in want)]
        check(not unnamed, f"csrc/{src}.cu: bf16 kernels TC_SASS does not "
              f"name: {unnamed}")
        kernels += [{"source": src, **k} for k in tc]
    emit("tensor_cores", seconds=time.perf_counter() - t0, kernels=kernels)


def _opt_cases(k):
    """(name, shapes, the arrays given as views at storage offset 1,
    whether l2reg (SGD) or weight decay (Adam) is on) of the group checks;
    k = MAX_TENSORS."""
    views = [(f"view_{a}", [VIEW_SHAPE], (a,), False) for a in "pgmv"]
    return ([("mlp", MLP_SHAPES, (), False), ("odd", [ODD_SHAPE], (), True)]
            + views + [("k_plus_3", [((37 * i) % 1001 + 1,)
                                     for i in range(k + 3)], (), False)])


def _offset_like(x, offset):
    """A copy of ``x`` that starts ``offset`` floats past a fresh (16-byte
    aligned) allocation."""
    y = torch.empty(x.numel() + offset, device=x.device)[offset:]
    return y.view(x.shape).copy_(x)


def _opt_inputs(rand, shapes, views, adam):
    """p, g (and m, v, a t per tensor) of one group; the arrays named in
    ``views`` at storage offset 1."""
    names = "pgmv" if adam else "pg"
    scale = {"p": 1.0, "g": 1.0, "m": 0.1, "v": 0.1}
    arrays = {a: [_offset_like(rand(s, scale[a]), int(a in views))
                  for s in shapes] for a in names}
    if adam:
        arrays["v"] = [v.abs_() for v in arrays["v"]]
        arrays["t"] = [torch.tensor(3.0 + i % 3, device=arrays["p"][0].device)
                       for i in range(len(shapes))]
    return arrays


def opt_group_check(fused_opt, registry, rand, lr, adam):
    """Each case of _opt_cases: the group kernel against the plain version
    (SGD bit-equal, Adam within TOL), bit-equal to a rerun, with the
    launches the plan gives (one per MAX_TENSORS tensors); returns the
    largest difference and the cases' rows."""
    kname = "fused_adam" if adam else "fused_sgd"
    err, rows = 0.0, []
    for name, shapes, views, decay in _opt_cases(fused_opt.MAX_TENSORS):
        if not adam and set(views) & set("mv"):
            continue
        x = _opt_inputs(rand, shapes, views, adam)
        if adam:
            kw = dict(beta1=0.9, beta2=0.999, eps=1e-7,
                      weight_decay=0.01 if decay else 0.0)
            want = fused_opt._adam_plain(x["p"], x["g"], x["m"], x["v"],
                                         x["t"], lr, **kw)
        else:
            kw = dict(l2reg=1e-4 if decay else 0.0)
            want = [fused_opt._sgd_plain(x["p"], x["g"], lr, **kw)]
        runs = []
        for _ in range(2):
            cp = {a: [_offset_like(t, int(a in views)) for t in x[a]]
                  for a in x if a in "pmv"}
            n0 = registry.launch_counts()[kname]
            if adam:
                got = fused_opt._adam_kernel(cp["p"], x["g"], cp["m"],
                                             cp["v"], x["t"], lr, **kw)
            else:
                got = [fused_opt._sgd_kernel(cp["p"], x["g"], lr, **kw)]
            torch.cuda.synchronize()
            n_launch = registry.launch_counts()[kname] - n0
            check(n_launch == -(-len(shapes) // fused_opt.MAX_TENSORS),
                  f"{kname} {name}: {n_launch} launches for "
                  f"{len(shapes)} tensors")
            runs.append(got)
        check(all(torch.equal(a, b) for ga, gb in zip(*runs)
                  for a, b in zip(ga, gb)), f"{kname} {name}: two runs differ")
        for got_list, want_list in zip(runs[0], want):
            for a, b in zip(got_list, want_list):
                if adam:
                    err = max(err, max_err(a, b, TOL[kname]))
                else:
                    check(torch.equal(a, b), f"fused_sgd {name}: differs "
                          "from the plain version")
        rows.append({"case": name, "tensors": len(shapes),
                     "elements": sum(int(np.prod(s)) for s in shapes),
                     "views": list(views), "launches": n_launch})
    return err, rows


def kernel_phase(fused_opt, registry, dev, bw, flops):
    """fused_sgd and fused_adam: the group kernels against their plain
    versions at _opt_cases; times of one apply at the MLP's shapes (all six
    parameters in one launch, warm L2, as right after the backward pass):
    the kernel by graph replay and launched eagerly, and the optimizer
    node's entry (dispatch, eligibility, launch) launched eagerly; one apply
    over LARGE_N elements."""
    from hetu_tpu_torch.optimizer import AdamOptimizer, SGDOptimizer
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    lr = torch.tensor(1e-3, device=dev)
    out, cases = {}, {}
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-7, weight_decay=0.0)
    sgd_opt, adam_opt = SGDOptimizer(1e-3), AdamOptimizer(1e-3)

    # -- fused_sgd -------------------------------------------------------
    err, cases["fused_sgd"] = opt_group_check(fused_opt, registry, rand, lr,
                                              adam=False)
    ps = [rand(s) for s in MLP_SHAPES]
    gs = [rand(s) for s in MLP_SHAPES]
    n = sum(p.numel() for p in ps)

    def sgd():
        return fused_opt._sgd_kernel(ps, gs, lr, l2reg=0.0)

    out["fused_sgd"] = dict(
        max_abs_err=err,
        # read p, g and lr; write p. Two flops per element (mul, sub).
        bound=bound(12 * n + 4, 2 * n, bw, flops),
        step_launched_ms=time_ms(lambda: fused_opt.sgd_group_step(
            sgd_opt, ps, gs, lr)),
        library_add6_ms=graph_ms(lambda: [torch.add(p, g, alpha=-1e-3)
                                          for p, g in zip(ps, gs)]),
        **timings(sgd, lambda: fused_opt._sgd_plain(ps, gs, lr, l2reg=0.0),
                  lambda: torch._foreach_add_(ps, gs, alpha=-1e-3)))

    # -- fused_adam ------------------------------------------------------
    err, cases["fused_adam"] = opt_group_check(fused_opt, registry, rand, lr,
                                               adam=True)
    ms_ = [rand(s, 0.1) for s in MLP_SHAPES]
    vs_ = [rand(s, 0.1).abs() for s in MLP_SHAPES]
    ts = [torch.tensor(3.0, device=dev) for _ in MLP_SHAPES]
    steps = [torch.tensor(3.0, device=dev) for _ in MLP_SHAPES]
    slots = [{"m": m, "v": v, "t": t} for m, v, t in zip(ms_, vs_, ts)]

    def adam():
        return fused_opt._adam_kernel(ps, gs, ms_, vs_, ts, lr, **hyper)

    out["fused_adam"] = dict(
        max_abs_err=err,
        # read p, g, m, v, each t and lr; write p, m, v (and the new t's).
        # About 14 flops per element.
        bound=bound(28 * n + 4 + 8 * len(ps), 14 * n, bw, flops),
        step_launched_ms=time_ms(lambda: fused_opt.adam_group_step(
            adam_opt, ps, gs, slots, lr)),
        **timings(adam, lambda: fused_opt._adam_plain(ps, gs, ms_, vs_, ts,
                                                      lr, **hyper),
                  lambda: torch._fused_adamw_(
                      ps, gs, ms_, vs_, [], steps, lr=1e-3, beta1=0.9,
                      beta2=0.999, weight_decay=0.0, eps=1e-7, amsgrad=False,
                      maximize=False)))

    # -- one apply over LARGE_N elements -----------------------------------
    big = {a: [rand((LARGE_N,), 0.1)] for a in "pgmv"}
    big["v"][0].abs_()
    big["t"] = [torch.tensor(3.0, device=dev)]
    big_steps = [torch.tensor(3.0, device=dev)]   # _fused_adamw_ adds to it

    def large_sgd():
        return fused_opt._sgd_kernel(big["p"], big["g"], lr, l2reg=0.0)

    def large_adam():
        return fused_opt._adam_kernel(big["p"], big["g"], big["m"], big["v"],
                                      big["t"], lr, **hyper)

    for kname, fn, nbytes, nflops, lib in (
            ("fused_sgd", large_sgd, 12 * LARGE_N + 4, 2 * LARGE_N,
             lambda: torch._foreach_add_(big["p"], big["g"], alpha=-1e-3)),
            ("fused_adam", large_adam, 28 * LARGE_N + 12, 14 * LARGE_N,
             lambda: torch._fused_adamw_(
                 big["p"], big["g"], big["m"], big["v"], [], big_steps,
                 lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.0,
                 eps=1e-7, amsgrad=False, maximize=False))):
        ms = graph_ms(fn, iters=20)
        b = bound(nbytes, nflops, bw, flops)
        out[kname]["large"] = {
            "elements": LARGE_N, "gb_moved": nbytes / 1e9, "ms": ms,
            "bound_ms": b[0], "bound_share": b[0] / ms,
            "library_ms": graph_ms(lib, iters=20)}
    del big
    torch.cuda.empty_cache()
    return out, cases


def _attention_inputs(gen, dev, b, h, s, d, dtype, pad):
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    kb = None
    if pad:   # key padding from lengths drawn in [S/2, S], as BERT's mask
        lengths = torch.randint(s // 2, s + 1, (b,), generator=gen,
                                device=dev)
        kb = torch.where(torch.arange(s, device=dev)[None, :]
                         < lengths[:, None], 0.0, -1e30)
    return q, k, v, kb


def attention_phase(fa, dev, bw, f32, bf16):
    """flash_attention_fwd against its plain version (bf16 o also by its
    relative L2 error; in f32, also against unfused attention) at
    ATTN_CASES, each kernel run twice and held bit-equal to itself; timed
    at each case."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = TOL["flash_attention_fwd"]
    cases = []
    for b, h, s, d, dtype, causal, pad in ATTN_CASES:
        q, k, v, kb = _attention_inputs(gen, dev, b, h, s, d, dtype, pad)
        kw = dict(scale=d ** -0.5, causal=causal, block_q=min(128, s),
                  block_k=min(128, s))
        o, lse = fa._flash_fwd_kernel(q, k, v, kb, **kw)
        again = fa._flash_fwd_kernel(q, k, v, kb, **kw)
        want_o, want_lse = fa._flash_fwd_plain(q, k, v, kb, **kw)
        torch.cuda.synchronize()
        what = f"flash_attention_fwd {[b, h, s, d]} {str(dtype)[6:]}"
        check(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
              f"{what}: two runs differ")
        bf = dtype == torch.bfloat16
        o_tol = tol["o_bf16"] if bf else tol["o_f32"]
        case = {"shape": [b, h, s, d], "dtype": str(dtype)[6:],
                "causal": causal, "key_padding": pad, "rerun_bit_equal": True,
                "o_max_abs_err": max_err(o.float(), want_o.float(), o_tol),
                "lse_max_abs_err": max_err(lse, want_lse, tol["lse"])}
        if bf:
            case["o_rel_l2"] = rel_errs(("o",), (o,), (want_o,),
                                        tol["rel_l2_bf16"], what)["o"]
        if dtype == torch.float32:
            sc = torch.matmul(q, k.transpose(-1, -2)) * kw["scale"]
            if kb is not None:
                sc = sc + kb[:, None, None, :]
            if causal:
                sc = torch.where(torch.ones(s, s, dtype=torch.bool,
                                            device=dev).tril(), sc, -1e30)
            unfused = torch.matmul(torch.softmax(sc, -1), v)
            case["o_vs_unfused_max_abs_err"] = max_err(o, unfused,
                                                       tol["o_f32"])
        es = q.element_size()
        pairs = s * (s + 1) // 2 if causal else s * s
        case["bound"] = bound(
            # read q, k, v (and the bias) once, write o and lse
            4 * b * h * s * d * es + b * h * s * 4 + (b * s * 4 if pad else 0),
            # q k^T and p v over the (query, key) pairs the mask keeps
            4 * b * h * pairs * d, bw, bf16 if dtype == torch.bfloat16 else f32)
        mask = None if kb is None else (kb == 0)[:, None, None, :]
        case.update(
            ms=graph_ms(lambda: fa._flash_fwd_kernel(q, k, v, kb, **kw)),
            # the public entry the model calls, launched one call at a time
            launched_ms=time_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal, kw["scale"], kw["block_q"], kw["block_k"],
                kb)),
            plain_ms=graph_ms(lambda: fa._flash_fwd_plain(q, k, v, kb, **kw),
                              iters=20),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal,
                scale=kw["scale"])))
        cases.append(case)
    return cases


def ce_phase(ce, dev, bw, bf16):
    """fused_linear_nll_fwd against its plain version at CE_CASES, the
    kernel run twice and held bit-equal to itself; timed."""
    gen = torch.Generator(device=dev).manual_seed(2)
    tol = TOL["fused_linear_nll_fwd"]["lse_tl_nll"]
    cases = []
    for n, v, d, layout in CE_CASES:
        w_dv = layout == "dv"
        h = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((v, d), generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        if w_dv:
            w = w.t().contiguous()
        b = torch.randn((v,), generator=gen, device=dev) * 0.02
        t = torch.randint(0, v, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        kw = dict(block_n=128, block_v=512, w_dv=w_dv)
        lse, tl = ce._linear_nll_fwd_kernel(h, w, b, t, **kw)
        again = ce._linear_nll_fwd_kernel(h, w, b, t, **kw)
        want_lse, want_tl = ce._linear_nll_fwd_plain(h, w, b, t, **kw)
        torch.cuda.synchronize()
        check(torch.equal(lse, again[0]) and torch.equal(tl, again[1]),
              f"fused_linear_nll_fwd {[n, v, d]} {layout}: two runs differ")
        err = max(max_err(lse, want_lse, tol), max_err(tl, want_tl, tol),
                  max_err(lse - tl, want_lse - want_tl, tol))

        def library():
            logits = torch.matmul(h, w if w_dv else w.t()).float() + b
            return (torch.logsumexp(logits, -1)
                    - torch.gather(logits, 1, t.long()[:, None])[:, 0])

        cases.append({
            "shape": [n, v, d], "layout": layout, "dtype": "bfloat16",
            "rerun_bit_equal": True, "max_abs_err": err,
            "mean_nll": float((lse - tl).mean()),
            # read h, W, b and the targets once; write lse and tl
            "bound": bound(2 * (n * d + v * d) + 4 * v + 4 * n + 8 * n,
                           2 * n * v * d, bw, bf16),
            "ms": graph_ms(lambda: ce._linear_nll_fwd_kernel(h, w, b, t, **kw)),
            "launched_ms": time_ms(
                lambda: ce.fused_linear_nll(h, w, b, t, w_layout=layout), 50),
            "plain_ms": graph_ms(
                lambda: ce._linear_nll_fwd_plain(h, w, b, t, **kw), iters=20),
            "library_ms": graph_ms(library)})
    return cases


def attention_bwd_phase(fa, dev, bw, f32, bf16):
    """flash_attention_bwd against its plain version (and, in f32, against
    autograd of unfused attention) at ATTN_CASES; timed at each case."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = TOL["flash_attention_bwd"]
    cases = []
    for b, h, s, d, dtype, causal, pad in ATTN_CASES:
        q, k, v, kb = _attention_inputs(gen, dev, b, h, s, d, dtype, pad)
        do = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
        kw = dict(scale=d ** -0.5, causal=causal, block_q=min(128, s),
                  block_k=min(128, s))
        o, lse = fa._flash_fwd_plain(q, k, v, kb, **kw)
        args = (q, k, v, o, lse, do, kb)
        got = fa._flash_bwd_kernel(*args, **kw)
        again = fa._flash_bwd_kernel(*args, **kw)
        want = fa._flash_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flash_attention_bwd {[b, h, s, d]}: two runs differ")
        bf = dtype == torch.bfloat16
        g_tol = tol["bf16"] if bf else tol["f32"]
        case = {"shape": [b, h, s, d], "dtype": str(dtype)[6:],
                "causal": causal, "key_padding": pad, "rerun_bit_equal": True,
                "max_abs_err": max(max_err(g.float(), w.float(), g_tol)
                                   for g, w in zip(got, want)),
                "rel_l2": rel_errs(
                    ("dq", "dk", "dv"), got, want,
                    tol["rel_l2_bf16" if bf else "rel_l2_f32"],
                    f"flash_attention_bwd {[b, h, s, d]}")}
        mask = None if kb is None else (kb == 0)[:, None, None, :]
        if dtype == torch.float32:
            qkv = [x.clone().requires_grad_() for x in (q, k, v)]
            sc = torch.matmul(qkv[0], qkv[1].transpose(-1, -2)) * kw["scale"]
            if kb is not None:
                sc = sc + kb[:, None, None, :]
            if causal:
                sc = torch.where(torch.ones(s, s, dtype=torch.bool,
                                            device=dev).tril(), sc, -1e30)
            ref = torch.autograd.grad(
                torch.matmul(torch.softmax(sc, -1), qkv[2]), qkv, do)
            case["vs_autograd_max_abs_err"] = max(
                max_err(g, r, tol["f32_vs_autograd"])
                for g, r in zip(got, ref))
        es = q.element_size()
        pairs = s * (s + 1) // 2 if causal else s * s
        case["bound"] = bound(
            # read q, k, v, o, dO (and lse, the bias) once; write dq, dk, dv
            8 * b * h * s * d * es + b * h * s * 4 + (b * s * 4 if pad else 0),
            # q k^T (recomputed), dO v^T, ds k, p^T dO, ds^T q over the
            # (query, key) pairs the mask keeps
            10 * b * h * pairs * d, bw, bf16 if dtype == torch.bfloat16 else f32)
        lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=mask, is_causal=causal,
                scale=kw["scale"])

        # the library's backward alone: SDPA forward+backward (one
        # torch.autograd.grad over the same inputs and dO) minus its forward
        lib_fwd = graph_ms(sdpa)
        lib_both = graph_ms(lambda: torch.autograd.grad(sdpa(), (lq, lk, lv),
                                                        do))
        case.update(
            ms=graph_ms(lambda: fa._flash_bwd_kernel(*args, **kw)),
            launched_ms=time_ms(lambda: fa._flash_bwd_kernel(*args, **kw)),
            plain_ms=graph_ms(lambda: fa._flash_bwd_plain(*args, **kw),
                              iters=20),
            library_ms=lib_both - lib_fwd, library_fwd_bwd_ms=lib_both)
        cases.append(case)
    return cases


def ce_bwd_phase(ce, dev, bw, bf16):
    """fused_linear_nll_bwd against its plain version at CE_BWD_CASES; the
    bf16 cases timed."""
    gen = torch.Generator(device=dev).manual_seed(4)
    tol = TOL["fused_linear_nll_bwd"]
    cases = []
    for n, v, d, layout, dtype in CE_BWD_CASES:
        w_dv = layout == "dv"
        bf = dtype == torch.bfloat16
        h = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        w = (torch.randn((v, d), generator=gen, device=dev) * 0.02).to(dtype)
        if w_dv:
            w = w.t().contiguous()
        b = torch.randn((v,), generator=gen, device=dev) * 0.02
        t = torch.randint(0, v, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        ct = torch.rand((n,), generator=gen, device=dev) / n
        kw = dict(block_n=128, block_v=512, w_dv=w_dv)
        lse, _ = ce._linear_nll_fwd_plain(h, w, b, t, **kw)
        args = (h, w, b, t, lse, ct)
        got = ce._linear_nll_bwd_kernel(*args, **kw)
        again = ce._linear_nll_bwd_kernel(*args, **kw)
        want = ce._linear_nll_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"fused_linear_nll_bwd {[n, v, d]} {layout}: two runs differ")
        check(got[0].dtype == h.dtype and got[1].dtype == w.dtype
              and got[2].dtype == torch.float32, "fused CE grad dtypes")
        g_tol = tol["dh_dw_bf16"] if bf else tol["dh_dw_f32"]
        err = max(max_err(got[0].float(), want[0].float(), g_tol),
                  max_err(got[1].float(), want[1].float(), g_tol),
                  max_err(got[2], want[2], tol["db"]))
        limit = tol["rel_l2_bf16" if bf else "rel_l2_f32"]
        what = f"fused_linear_nll_bwd {[n, v, d]} {layout} {str(dtype)[6:]}"
        rel = rel_errs(("dh", "dW", "db"), got, want, limit, what)
        # the vocabulary ids no row targets: dW's rows (columns for "dv")
        # and db's entries there hold the softmax term alone
        free = torch.ones(v, dtype=torch.bool, device=dev)
        free[t.long()] = False

        def vocab_major(x):
            return x.t() if w_dv else x
        rel.update(rel_errs(
            ("dW_untargeted", "db_untargeted"),
            (vocab_major(got[1])[free], got[2][free]),
            (vocab_major(want[1])[free], want[2][free]), limit, what))
        case = {"shape": [n, v, d], "layout": layout,
                "dtype": str(dtype)[6:], "rerun_bit_equal": True,
                "max_abs_err": err, "rel_l2": rel,
                "absmax": {nm: float(x.float().abs().max()) for nm, x in
                           zip(("dh", "dW", "db"), want)}}
        if not bf:
            cases.append(case)
            continue

        def library():
            # one materialised pass: logits, softmax - onehot, g.W, g^T.h
            logits = torch.matmul(h, w if w_dv else w.t()).float() + b
            g = torch.softmax(logits, -1)
            g[torch.arange(n, device=dev), t.long()] -= 1.0
            g = (g * ct[:, None]).to(h.dtype)
            dh = torch.matmul(g, w.t() if w_dv else w)
            dw = torch.matmul(h.t(), g) if w_dv else torch.matmul(g.t(), h)
            return dh, dw, g.float().sum(0)

        case.update({
            # read h, W, b, targets, lse and ct once; write dh, dW and db
            "bound": bound(2 * 2 * (n * d + v * d) + 8 * v + 12 * n,
                           # the logits (recomputed), g.W and g^T.h
                           3 * 2 * n * v * d, bw, bf16),
            "ms": graph_ms(lambda: ce._linear_nll_bwd_kernel(*args, **kw),
                           iters=20),
            "launched_ms": time_ms(
                lambda: ce._linear_nll_bwd_kernel(*args, **kw), 20),
            "plain_ms": graph_ms(lambda: ce._linear_nll_bwd_plain(*args, **kw),
                                 iters=20),
            "library_ms": graph_ms(library, iters=20)})
        cases.append(case)
    return cases


def csr_check(kind, a, dense, kernel, plain, library, registry, what, bw,
              f32, chunk_plan, chunk):
    """One csr_spmm/csr_spmv case: the kernel against its plain version on
    the same inputs, bit for bit, and against itself on a rerun; then
    timed, the library call by CUDA-graph replay where it can be captured,
    else by CUDA events around back-to-back eager calls."""
    got, want = kernel(a, dense), plain(a, dense)
    again = kernel(a, dense)
    torch.cuda.synchronize()
    rel = rel_l2(got, want)
    check(rel <= TOL[kind]["rel_l2"], f"{kind} {what} differs from the plain "
          f"version by rel L2 {rel}")
    check(same_bits(got, want), f"{kind} {what} is not bit-equal to its "
          f"plain version (rel L2 {rel})")
    check(same_bits(got, again), f"{kind} {what} differs from itself on a "
          "rerun")
    f = dense.shape[1] if dense.ndim == 2 else 1
    plan = chunk_plan(a, chunk)
    per_row = torch.bincount(plan.chunks[0].long(), minlength=1)
    dense_bytes = 8 * a.nnz + 4 * (a.nrow + 1) + 4 * a.nrow * f
    case = {"matrix": what, "shape": [a.nrow, a.ncol, a.nnz, f],
            "bit_equal": True, "rerun_bit_equal": True,
            "max_abs_err": float((got - want).abs().max()), "rel_l2": rel,
            "plan": {"chunk": chunk, "chunks": int(plan.chunks.shape[1]),
                     "split_rows": int(plan.splits.shape[1]),
                     "most_chunks_in_a_row": int(per_row.max())},
            # read rowptr, col and values once and each dense row once
            # (the least; a row's neighbours may fetch it again), write the
            # output once; one multiply and one add per entry and column
            "bound": bound(dense_bytes + 4 * a.ncol * f, 2 * a.nnz * f, bw,
                           f32),
            # the same, with a dense row read for every entry (no reuse)
            "gather_bound": bound(dense_bytes + 4 * a.nnz * f, 2 * a.nnz * f,
                                  bw, f32),
            "ms": graph_ms(lambda: kernel(a, dense)),
            # the chunk kernel's and the merge's device µs, eager
            "kernel_us": device_split(lambda: kernel(a, dense)),
            # through the registry gate, one call at a time
            "launched_ms": time_ms(lambda: registry.dispatch(kind, a, dense)),
            "plain_ms": graph_ms(lambda: plain(a, dense), iters=3)}
    try:        # cuSPARSE, a yardstick only
        case.update(library_ms=graph_ms(library, iters=50),
                    library_timing="graph")
    except RuntimeError as e:
        torch.cuda.synchronize()
        case["library_graph_error"] = str(e)[:200]
        try:
            case.update(library_ms=time_ms(library, iters=50),
                        library_timing="eager")
        except RuntimeError as e:
            case.update(library_ms=None, library_error=str(e)[:200])
    return case


def csr_phase(cs, registry, adj, dev, bw, f32):
    """csr_spmm and csr_spmv against their plain versions on the GCN's
    adjacency at CSR_CASES and on A·x; timed at each."""
    gen = torch.Generator(device=dev).manual_seed(5)
    forms = {"A": adj.csr, "A^T": adj.csr_t}
    lib = {k: torch.sparse_csr_tensor(c.rowptr, c.col, c.val,
                                      (c.nrow, c.ncol), check_invariants=False)
           for k, c in forms.items()}
    spmm = []
    for form, f in CSR_CASES:
        a = forms[form]
        b = torch.randn((a.ncol, f), generator=gen, device=dev)
        spmm.append(csr_check(
            "csr_spmm", a, b, cs._spmm_kernel, cs._spmm_plain,
            lambda: torch.sparse.mm(lib[form], b), registry, form, bw, f32,
            cs.chunk_plan, cs.SPMM_CHUNK))
    x = torch.randn((adj.ncol,), generator=gen, device=dev)
    spmv = [csr_check("csr_spmv", adj.csr, x, cs._spmv_kernel,
                      cs._spmv_plain, lambda: torch.mv(lib["A"], x),
                      registry, "A", bw, f32, cs.chunk_plan, cs.SPMV_CHUNK)]
    return spmm, spmv


def gcn_phase(ht, gnn_main, cs, registry, counted, dev, bw, f32):
    """The GCN on the arxiv-sized graph: the CSR kernels against their
    plain versions on its adjacency; the first epoch's loss and gradients
    against kernels="off"; one csrmv_op program; then GCN_EPOCHS epochs
    through Executor.run, each with the launch counts zeroed just before
    it and read just after."""
    data = gnn_main.load_graph("arxiv")
    tr = gnn_main.Trainer(dev, "gcn", "arxiv", lr=GCN_LR, data=data)
    spmm, spmv = csr_phase(cs, registry, tr.adj, dev, bw, f32)
    emit("csr_spmm_checked", tolerance=TOL["csr_spmm"], cases=spmm + spmv)

    # -- the first epoch's gradients against the plain versions -----------
    off = gnn_main.Trainer(dev, "gcn", "arxiv", lr=GCN_LR, kernels="off",
                           data=data)
    for n_k, n_o in zip(tr.ex.param_nodes, off.ex.param_nodes):
        check(torch.equal(tr.ex.state["params"][id(n_k)],
                          off.ex.state["params"][id(n_o)]),
              f"initial {n_k.name} differs between the two executors")
    (loss_k, g_k), counts = counted(tr.gradients)
    check(counts == {"csr_spmm": 3}, f"the gradient launched {counts}, "
          "expected 3 csr_spmm")
    (loss_o, g_o), off_counts = counted(off.gradients)
    check(off_counts == {}, f"kernels='off' launched {off_counts}")
    loss_rel = abs(float(loss_k) - float(loss_o)) / abs(float(loss_o))
    grad_rel = rel_errs(sorted(g_k), [g_k[k] for k in sorted(g_k)],
                        [g_o[k] for k in sorted(g_k)], GCN_REL,
                        "GCN first-epoch gradient")
    check(loss_rel <= GCN_REL, f"GCN first loss {float(loss_k)} vs "
          f"kernels='off' {float(loss_o)}")
    (_, _), off_epoch = counted(off.epoch)
    check(off_epoch == {}, f"a kernels='off' epoch launched {off_epoch}")
    emit("gcn_grad_check", loss=float(loss_k), off_loss=float(loss_o),
         loss_rel=loss_rel, grad_rel_l2=grad_rel, tolerance=GCN_REL,
         launches=counts)
    del off, g_k, g_o

    # -- csrmv_op through Executor.run, with and without the kernels ------
    adj_ = ht.Variable(name="adj", trainable=False)
    x_ = ht.Variable(name="x", trainable=False)
    z, zt = ht.csrmv_op(adj_, x_), ht.csrmv_op(adj_, x_, trans=True)
    x = torch.randn((tr.adj.ncol,), generator=torch.Generator(
        device=dev).manual_seed(6), device=dev)
    mv = {}
    for kernels in (None, "off"):
        ex = ht.Executor([z, zt], ctx=ht.gpu(dev.index or 0),
                         kernels=kernels)
        mv[kernels] = counted(lambda: [r.handle for r in ex.run(
            "default", feed_dict={adj_: tr.adj, x_: x})])
    check(mv[None][1] == {"csr_spmv": 2} and mv["off"][1] == {},
          f"csrmv_op launched {mv[None][1]}, under off {mv['off'][1]}")
    mv_rel = rel_errs(("A x", "A^T x"), mv[None][0], mv["off"][0],
                      TOL["csr_spmv"]["rel_l2"], "csrmv_op")
    emit("csrmv_program", nodes=tr.adj.nrow, entries=tr.adj.csr.nnz,
         rel_l2=mv_rel, launches=mv[None][1])

    # -- the main path: GCN_EPOCHS epochs with the kernels ----------------
    del tr
    rows = list(gnn_main.run(dev, "gcn", "arxiv", epochs=GCN_EPOCHS,
                             lr=GCN_LR, data=data))
    epochs, summary = rows[:-1], rows[-1]
    losses = [r["train_loss"] for r in epochs]
    for r in epochs:
        check(r["launches"] == GCN_LAUNCHES, f"epoch {r['epoch']} launched "
              f"{r['launches']}, expected {GCN_LAUNCHES}")
    check(np.isfinite(losses).all(), f"losses {losses}")
    check(abs(losses[0] - float(loss_k)) / losses[0] < 1e-6,
          "the first epoch's loss differs from the gradient check's")
    check(losses[-1] < 0.5 * losses[0], f"GCN loss {losses[0]} -> "
          f"{losses[-1]} did not halve in {GCN_EPOCHS} epochs")
    emit("gcn_train", arch="gcn", graph="arxiv", lr=GCN_LR,
         epochs=GCN_EPOCHS, **{k: summary[k] for k in (
             "nodes", "entries", "features", "hidden", "classes",
             "csr_build_ms", "epoch_ms", "launches_per_epoch")},
         losses=losses, test_acc=[r["test_acc"] for r in epochs],
         epoch_ms_each=[r["ms"] for r in epochs])
    launches = {k: sum(r["launches"].get(k, 0) for r in epochs)
                for k in GCN_LAUNCHES}
    return spmm, spmv, {"csr_spmm": launches["csr_spmm"],
                        "csr_spmv": mv[None][1]["csr_spmv"]}


def _embed_inputs(case, d, first_ids, bert_batch, gen, dev):
    """(vec, idx, vocab, form) of one EMBED_CASES case; CTR ids as float32,
    as fed; BERT's as the batch holds them."""
    ids = first_ids.reshape(-1)
    idx, vocab, form = {
        "wdl": (first_ids, CTR_VOCAB, "compact"),
        "n1": (ids[:1], CTR_VOCAB, "compact"),
        "single_id": (torch.full_like(ids, 4321.0), CTR_VOCAB, "compact"),
        "bert_token": (bert_batch["input_ids"], 30522, "dense"),
        "bert_type": (bert_batch["segment_ids"], 2, "dense")}.get(
            case, (ids, CTR_VOCAB, "compact"))
    return (torch.randn((idx.numel(), d), generator=gen, device=dev), idx,
            vocab, form)


def embed_grad_phase(eg, registry, first_ids, bert_batch, dev, bw, f32):
    """fused_embed_grad against its plain version at EMBED_CASES, after the
    prep the path runs first, each timed: replayed (``ms``), launched
    through the registry one call at a time, and eagerly the plain
    version, torch.segment_reduce on the sorted rows (the library's sorted
    segment sum, a yardstick only) and, at BERT's lookups, the two
    backwards PyTorch has for a gather: aten's embedding_dense_backward
    and index_put_ with accumulate (``indexing_backward``, which the BERT
    path ran before), each into the table; and the form the path calls
    (embed_grad_rows or embed_grad_dense: the sort, the zeroed output, the
    kernel)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = []
    for case, d in EMBED_CASES:
        vec, idx, vocab, form = _embed_inputs(case, d, first_ids, bert_batch,
                                              gen, dev)
        flat, order, sidx = eg._prep(vec, idx)
        seg, _, count = eg._ranks(sidx, vocab)
        key, rows = (seg, flat.shape[0]) if form == "compact" else (sidx,
                                                                      vocab)
        out = torch.zeros((rows, d), device=dev)
        got = eg._segsum_kernel(flat, order, key, out.clone())
        again = eg._segsum_kernel(flat, order, key, out.clone())
        want = eg._segsum_plain(flat, order, key, out.clone())
        torch.cuda.synchronize()
        rel = rel_l2(got, want)
        bits = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
        rerun = bool(torch.equal(again.view(torch.int32),
                                 got.view(torch.int32)))
        check(rel <= TOL["fused_embed_grad"]["rel_l2"] and bits and rerun,
              f"fused_embed_grad {case}: rel L2 {rel} from the plain "
              f"version, bit-equal {bits}, bit-equal on a rerun {rerun}")
        n = flat.shape[0]
        lengths = torch.bincount(seg, minlength=n)[:int(count)]
        sv = flat.index_select(0, order)
        # the rows the kernel writes: the compact form's count, the dense
        # form's distinct ids inside the table
        kept = torch.unique_consecutive(sidx[(sidx >= 0) & (sidx < vocab)])
        written = int(count) if form == "compact" else kept.numel()

        def library():
            return torch.segment_reduce(sv, "sum", lengths=lengths,
                                        unsafe=True)

        lib = library()
        c = {"case": case, "form": form, "shape": [n, d], "out_rows": rows,
             "unique": int(count), "longest": int(lengths.max()),
             "chunk": eg.chunk_rows(n, d), "bit_equal": bits,
             "rerun_bit_equal": rerun,
             "max_abs_err": float((got - want).abs().max()), "rel_l2": rel,
             "library_rel_l2": rel_l2(lib, want[:int(count)] if form ==
                                      "compact" else want[kept.long()]),
             # read the rows, order (int64) and the keys once, write each
             # summed row once; at most one add per element of the rows
             "bound": bound(4 * n * d + 12 * n + 4 * written * d, n * d, bw,
                            f32),
             "ms": graph_ms(lambda: eg._segsum_kernel(flat, order, key, out)),
             # the chunk and the fold launch's device µs
             "kernels_us": device_split(
                 lambda: eg._segsum_kernel(flat, order, key, out)),
             "launched_ms": time_ms(lambda: registry.dispatch(
                 "fused_embed_grad", flat, order, key, out)),
             "plain_ms": time_ms(lambda: eg._segsum_plain(flat, order, key,
                                                          out),
                                 iters=5, warmup=1),
             # eagerly: a capture that fails on a host sync inside the
             # library would leave the stream unusable
             "library_ms": time_ms(library, iters=50)}
        if form == "compact":
            c["form_launched_ms"] = time_ms(
                lambda: eg.embed_grad_rows(vec, idx, vocab), iters=50)
        else:
            ids = idx.reshape(-1).long()
            table = torch.zeros((vocab, d), device=dev)
            c["form_launched_ms"] = time_ms(
                lambda: eg.embed_grad_dense(vec, idx, (vocab, d)), iters=50)
            c["embedding_dense_backward_ms"] = time_ms(
                lambda: torch.ops.aten.embedding_dense_backward(
                    vec, ids, vocab, -1, False), iters=50)
            c["indexing_backward_ms"] = time_ms(
                lambda: table.index_put_((ids,), vec, accumulate=True),
                iters=50)
        cases.append(c)
        del flat, order, sidx, seg, out, got, again, want, sv, lib, kept
    return cases


def _table_probe(g, rows):
    """What is kept of a (vocab, d) table gradient, so that no second one
    is held: its rows ``rows``, its norm, and whether it is zero in every
    other row (``g`` is the caller's to spend: those rows are zeroed in
    place, then its least and largest elements read, with no temporary of
    its size)."""
    kept = {"rows": g.index_select(0, rows),
            "norm": float(torch.linalg.vector_norm(g))}
    g.index_fill_(0, rows, 0.0)
    kept["zero_elsewhere"] = float(g.min()) == 0.0 == float(g.max())
    return kept


def _peak_gb(dev):
    """Peak device memory since the last reset, in GB; resets it."""
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    return peak


def ctr_grad_check(tr, counted, rows0):
    """The first step's loss and five gradients with the kernels against
    kernels="off", on one executor (one table on the card)."""
    table = tr.tables[0].name
    probes = {}
    for kernels in (None, "off"):
        (loss, grads), counts = counted(lambda: tr.gradients(kernels))
        probes[kernels] = (loss, _table_probe(grads.pop(table), rows0),
                           grads, counts)
    (loss_k, t_k, g_k, counts), (loss_o, t_o, g_o, off_counts) = (
        probes[None], probes["off"])
    check(counts == {"fused_embed_grad": 1}, f"the gradient launched "
          f"{counts}, expected 1 fused_embed_grad")
    check(off_counts == {}, f"kernels='off' launched {off_counts}")
    check(len(g_k) == 4, f"gradients {sorted(g_k)} besides the table")
    check(t_k["zero_elsewhere"] and t_o["zero_elsewhere"],
          "the table gradient is nonzero outside the looked-up rows")
    names = sorted(g_k)
    grad_rel = rel_errs(names + [table + " (looked-up rows)"],
                        [g_k[k] for k in names] + [t_k["rows"]],
                        [g_o[k] for k in names] + [t_o["rows"]], CTR_REL,
                        "WDL-Criteo first-step gradient")
    loss_rel = abs(float(loss_k) - float(loss_o)) / abs(float(loss_o))
    norm_rel = abs(t_k["norm"] - t_o["norm"]) / t_o["norm"]
    check(loss_rel <= CTR_REL and norm_rel <= CTR_REL,
          f"first loss {float(loss_k)} vs kernels='off' {float(loss_o)}, "
          f"table gradient norm {t_k['norm']} vs {t_o['norm']}")
    emit("ctr_grad_check", loss=float(loss_k), off_loss=float(loss_o),
         loss_rel=loss_rel, grad_rel_l2=grad_rel, table_norm=t_k["norm"],
         table_norm_rel=norm_rel, tolerance=CTR_REL, launches=counts)
    return float(loss_k)


def ctr_program(ht, counted, first_ids, rows0, dev):
    """The explicit embedding_lookup_gradient_op through Executor.run, in
    dense and in rows mode, with the kernels and with kernels="off"."""
    vec_ = ht.Variable(name="vec", trainable=False)
    idx_ = ht.Variable(name="idx", trainable=False)
    g = ht.embedding_lookup_gradient_op(vec_, idx_, (CTR_VOCAB, CTR_DIM))
    vec = torch.randn(tuple(first_ids.shape) + (CTR_DIM,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(10))
    out = {}
    for mode in ("dense", "rows"):
        (g.to_rows if mode == "rows" else g.to_dense)()
        for kernels in (None, "off"):
            ex = ht.Executor([g], ctx=ht.gpu(dev.index or 0),
                             kernels=kernels)
            res, counts = counted(lambda: ex.run(
                feed_dict={vec_: vec, idx_: first_ids})[0])
            if mode == "dense":
                kept = _table_probe(res.handle, rows0)
            else:
                kept = {"rows": res.rows.handle, "grads": res.grads.handle}
            del res
            check(counts == ({} if kernels else {"fused_embed_grad": 1}),
                  f"the {mode} program launched {counts} under "
                  f"kernels={kernels}")
            out[mode, kernels] = kept
    dense, dense_off = out["dense", None], out["dense", "off"]
    rows, rows_off = out["rows", None], out["rows", "off"]
    k = rows0.numel()
    check(dense["zero_elsewhere"] and dense_off["zero_elsewhere"]
          and torch.equal(rows["rows"], rows_off["rows"])
          and torch.equal(rows["rows"][:k].long(), rows0),
          "the programs' rows differ")
    rel = rel_errs(["dense", "rows"], [dense["rows"], rows["grads"]],
                   [dense_off["rows"], rows_off["grads"]], CTR_REL,
                   "embedding_lookup_gradient_op")
    check(torch.equal(dense["rows"], rows["grads"][:k]),
          "dense mode's looked-up rows differ from rows mode's sums")
    emit("ctr_gradient_program", ids=int(first_ids.numel()), unique=k,
         vocab=CTR_VOCAB, dim=CTR_DIM, rel_l2=rel,
         launches={"fused_embed_grad": 1})


def ctr_off_step(ctr_main, counted, dev):
    """One training step with the kernels and one with kernels="off" from
    the same initial values, at the reference's default vocabulary
    (CTR_OFF_VOCAB rows: at the full one, the plain SGD's two table-sized
    temporaries do not fit beside the table and its gradient). No launch
    under off; every parameter the same after the step."""
    data = ctr_main.load_data("wdl_criteo", CTR_OFF_VOCAB)
    params, counts = {}, {}
    for kernels in (None, "off"):
        tr = ctr_main.Trainer(dev, "wdl_criteo", CTR_BATCH, CTR_OFF_VOCAB,
                              data=data, kernels=kernels)
        _, counts[kernels] = counted(tr.step)
        params[kernels] = {p.name: tr.param(p) for p in tr.params}
    check(counts[None] == CTR_LAUNCHES and counts["off"] == {},
          f"a step launched {counts[None]}, under kernels='off' "
          f"{counts['off']}")
    names = sorted(params[None])
    rel = rel_errs(names, [params[None][k] for k in names],
                   [params["off"][k] for k in names], CTR_REL,
                   "WDL-Criteo parameters after one step")
    emit("ctr_off_step", vocab=CTR_OFF_VOCAB, param_rel_l2=rel,
         launches=counts[None], off_launches=counts["off"])


def ctr_phase(ht, ctr_main, eg, registry, counted, bert_batch, dev, bw,
              f32):
    """WDL-Criteo at the full Criteo vocabulary: fused_embed_grad against
    its plain version (also at BERT's phase-2 lookups, ``bert_batch``); the
    first step's gradients against kernels="off";
    CTR_STEPS steps through Executor.run (ctr_main.run), the launch counts
    zeroed just before each step and read just after; the rows no step
    looked up unchanged; the step profiled; then the explicit gradient
    op, and a whole step against kernels="off" at a cut vocabulary."""
    import tempfile
    data = ctr_main.load_data("wdl_criteo", CTR_VOCAB)
    first_ids = torch.from_numpy(data[0][1][:CTR_BATCH]).to(dev)
    rows0 = torch.unique(first_ids.long())
    embed = embed_grad_phase(eg, registry, first_ids, bert_batch, dev, bw,
                             f32)
    emit("fused_embed_grad_checked", tolerance=TOL["fused_embed_grad"],
         cases=embed)

    torch.cuda.empty_cache()
    _peak_gb(dev)
    tr = ctr_main.Trainer(dev, "wdl_criteo", CTR_BATCH, CTR_VOCAB, data=data)
    table = tr.param(tr.tables[0])
    check(table.device == dev and tuple(table.shape) == (CTR_VOCAB, CTR_DIM),
          f"the table is {tuple(table.shape)} on {table.device}")
    peak_gb = {"init": _peak_gb(dev)}
    first_loss = ctr_grad_check(tr, counted, rows0)
    peak_gb["grad_check"] = _peak_gb(dev)

    # rows that no training step looks up, and rows that some step does
    looked = np.unique(data[0][1][:CTR_STEPS * CTR_BATCH].astype(np.int64))
    sample = np.setdiff1d(np.random.RandomState(9).randint(
        0, CTR_VOCAB, CTR_SAMPLE), looked)
    sample, looked = (torch.from_numpy(a).to(dev) for a in (sample, looked))
    before, before_looked = (table.index_select(0, sample),
                             table.index_select(0, looked))
    with tempfile.TemporaryDirectory() as prof:
        it = ctr_main.run(dev, trainer=tr, steps=CTR_STEPS, profile_dir=prof,
                          profile_iters=CTR_PROFILE_STEPS)
        epoch = next(it)
        peak_gb["train"] = _peak_gb(dev)
        untouched = bool(torch.equal(table.index_select(0, sample), before))
        moved = int((table.index_select(0, looked) != before_looked)
                    .any(1).sum())
        summary = next(it)              # the profile's steps train on
    losses = epoch["losses"]
    check(epoch["launches_per_step"] == CTR_LAUNCHES
          and epoch["launches_same_every_step"],
          f"a step launched {epoch['launches_per_step']}, expected "
          f"{CTR_LAUNCHES} every step")
    check(epoch["launches"] == {k: CTR_STEPS * v
                                for k, v in CTR_LAUNCHES.items()},
          f"{CTR_STEPS} steps launched {epoch['launches']}")
    check(np.isfinite(losses).all(), f"losses {losses}")
    check(abs(losses[0] - first_loss) / first_loss < 1e-6,
          "the first step's loss differs from the gradient check's")
    check(untouched, "a row no step looked up changed")
    check(moved == looked.numel(), f"{looked.numel() - moved} looked-up rows "
          "did not move")
    prof = summary["profile"]
    emit("ctr_train", model="wdl_criteo", vocab=CTR_VOCAB, dim=CTR_DIM,
         batch=CTR_BATCH, ids_per_step=CTR_BATCH * 26, params=tr.n_params,
         table_gb=table.numel() * 4 / 1e9, steps=CTR_STEPS,
         init_s=tr.init_ms / 1e3, step_ms=summary["step_ms"],
         samples_per_s=summary["samples_per_s"],
         device_ms=prof["device_ms"],
         device_busy_share=prof["device_busy_share"],
         groups_us=prof["groups_us"], losses=losses,
         train_acc=epoch["train_acc"], train_auc=epoch["train_auc"],
         sampled_untouched_rows=int(sample.numel()), untouched=untouched,
         looked_up_rows=int(looked.numel()), moved=moved,
         launches_per_step=epoch["launches_per_step"])
    del tr, table, before, before_looked
    torch.cuda.empty_cache()
    ctr_program(ht, counted, first_ids, rows0, dev)
    peak_gb["program"] = _peak_gb(dev)
    emit("ctr_memory", peak_gb=peak_gb)
    ctr_off_step(ctr_main, counted, dev)
    return embed, {"fused_embed_grad": epoch["launches"]["fused_embed_grad"]}


def _hybrid_trainer(ctr_main, dev, data, vocab, kernels=None, **ps_options):
    tr = ctr_main.Trainer(dev, "wdl_criteo", CTR_BATCH, vocab, data=data,
                          kernels=kernels, comm_mode="Hybrid",
                          ps_options=ps_options)
    rt = tr.ex.ps_runtime
    (table,) = [q for q in rt.params.values() if q.sparse]
    on_card = {n.name: tuple(tr.param(n).shape) for n in tr.ex.param_nodes}
    check(table.node is tr.tables[0] and table.node.name not in on_card
          and len(on_card) == 4,
          f"under Hybrid the card holds {on_card}; the table must be on "
          "the servers")
    return tr, rt, table


def hybrid_gates(ht, ctr_main, registry, counted, dev):
    """The Hybrid step at CTR_OFF_VOCAB rows: its first steps against local
    mode from the same initial values, its first step against
    kernels="off", each on a fresh cluster of HYB_SERVERS servers (the
    servers draw the same table from the same seed and ps id)."""
    from hetu_tpu_torch.ps import local_cluster as lc
    data = ctr_main.load_data("wdl_criteo", CTR_OFF_VOCAB)
    ids = data[0][1].astype(np.int64)
    touched1 = np.unique(ids[:CTR_BATCH])
    touched = np.unique(ids[:HYB_GATE_STEPS * CTR_BATCH])
    first = {}
    for kernels in (None, "off"):
        with lc.local_cluster(n_servers=HYB_SERVERS):
            tr, rt, table = _hybrid_trainer(ctr_main, dev, data,
                                            CTR_OFF_VOCAB, kernels,
                                            prefetch=False)
            if kernels is None:
                t0 = rt.pull_sparse_rows(table, np.arange(CTR_OFF_VOCAB))
                d0 = {n.name: tr.param(n).clone() for n in tr.ex.param_nodes}
            out, counts = counted(tr.step)
            first[kernels] = (
                out[0].cpu().numpy(), counts,
                {n.name: tr.param(n).cpu().numpy()
                 for n in tr.ex.param_nodes},
                rt.pull_sparse_rows(table, touched1))
            if kernels is None:
                losses = [float(out[0].mean())] + [
                    float(tr.step()[0].mean())
                    for _ in range(HYB_GATE_STEPS - 1)]
                rows = rt.pull_sparse_rows(table, touched)
                dense = {n.name: tr.param(n).cpu().numpy()
                         for n in tr.ex.param_nodes}
            tr.ex.close()
    (loss_k, counts, params_k, rows_k), (loss_o, off_counts, params_o,
                                         rows_o) = first[None], first["off"]
    check(counts == HYB_LAUNCHES and off_counts == {},
          f"the first Hybrid step launched {counts}, under kernels='off' "
          f"{off_counts}")
    check(np.array_equal(loss_k, loss_o) and np.array_equal(rows_k, rows_o)
          and all(np.array_equal(params_k[k], params_o[k]) for k in params_k),
          "the first Hybrid step differs from kernels='off'")

    loc = ctr_main.Trainer(dev, "wdl_criteo", CTR_BATCH, CTR_OFF_VOCAB,
                           data=data)
    with torch.no_grad():
        loc.param(loc.tables[0]).copy_(torch.from_numpy(t0))
        for n in loc.params:
            if n is not loc.tables[0]:
                loc.param(n).copy_(d0[n.name])
    local = [float(loc.step()[0].mean()) for _ in range(HYB_GATE_STEPS)]
    local_rows = loc.param(loc.tables[0]).index_select(
        0, torch.from_numpy(touched).to(dev)).cpu().numpy()
    loss_rel = float(np.max(np.abs(np.array(losses) - local)
                            / np.abs(local)))
    delta, local_delta = rows - t0[touched], local_rows - t0[touched]
    rows_rel = float(np.linalg.norm(rows - local_rows)
                     / np.linalg.norm(local_rows))
    update_rel = float(np.linalg.norm(delta - local_delta)
                       / np.linalg.norm(local_delta))
    local_dense = {n.name: loc.param(n).cpu().numpy() for n in loc.params
                   if n is not loc.tables[0]}
    check(sorted(local_dense) == sorted(dense),
          f"dense parameters {sorted(dense)}, local {sorted(local_dense)}")
    dense_rel = {k: float(np.linalg.norm(dense[k] - v) / np.linalg.norm(v))
                 for k, v in local_dense.items()}
    # the table moves by about 1e-4 of its rows in these steps: the update
    # is held on its own scale, so that a push off by a factor shows
    check(loss_rel <= HYB_REL and rows_rel <= HYB_REL
          and update_rel <= HYB_REL
          and max(dense_rel.values()) <= HYB_REL,
          f"Hybrid against local mode: losses rel {loss_rel}, touched rows "
          f"rel L2 {rows_rel}, their update rel L2 {update_rel}, dense "
          f"parameters rel L2 {dense_rel} (limit {HYB_REL})")
    emit("ctr_hybrid_gates", vocab=CTR_OFF_VOCAB, steps=HYB_GATE_STEPS,
         losses=losses, local_losses=local, loss_max_rel=loss_rel,
         touched_rows=int(touched.size), rows_rel_l2=rows_rel,
         rows_max_abs=float(np.abs(rows - local_rows).max()),
         update_rel_l2=update_rel, dense_rel_l2=dense_rel,
         servers=HYB_SERVERS, first_step_vs_off="bit-equal",
         launches=counts, tolerance=HYB_REL)
    del loc


def hybrid_rows_program(ht, ctr_main, eg, registry, counted, dev):
    """An explicit embedding_lookup_gradient_op pushed to the PS: the
    executor flips it to rows mode, one fused_embed_grad in its compact
    form, and the server adds -lr times the sums to a zero table."""
    from hetu_tpu_torch.ps import local_cluster as lc
    data = ctr_main.load_data("wdl_criteo", CTR_OFF_VOCAB)
    ids = torch.from_numpy(data[0][1][:CTR_BATCH]).to(dev)
    vec = torch.randn(tuple(ids.shape) + (CTR_DIM,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(11))
    with lc.local_cluster(n_servers=1):
        table = ht.init.zeros((CTR_OFF_VOCAB, CTR_DIM), name="ps_rows_table",
                              is_embed=True)
        idx_ = ht.Variable(name="idx", trainable=False)
        vec_ = ht.Variable(name="vec", trainable=False)
        look = ht.reduce_mean_op(ht.embedding_lookup_op(table, idx_),
                                 [0, 1, 2])
        g = ht.embedding_lookup_gradient_op(vec_, idx_,
                                            (CTR_OFF_VOCAB, CTR_DIM))
        push = ht.parameterServerCommunicate_op(g, ps_id=table.name)
        ex = ht.Executor({"train": [look, push]}, ctx=ctr_main._ctx(dev),
                         comm_mode="PS", prefetch=False)
        check(g.rows_mode and push.ps_param_node is table,
              "the push's gradient op did not take the rows route")
        _, counts = counted(lambda: ex.run(
            "train", feed_dict={idx_: ids, vec_: vec}))
        rt = ex.ps_runtime
        with registry.active("off"):
            rows, sums, count = eg.embed_grad_rows(vec, ids, CTR_OFF_VOCAB)
        k = int(count)
        rows = rows[:k].long().cpu().numpy()
        got = rt.pull_sparse_rows(rt.params[id(table)], rows)
        want = -rt._prescale_lr(0) * sums[:k].cpu().numpy()
        ex.close()
    check(counts == {"fused_embed_grad": 1},
          f"the rows-route program launched {counts}")
    check(np.array_equal(got, want), "the server's rows differ from -lr "
          "times the plain sums")
    emit("ctr_ps_rows_route", ids=int(ids.numel()), unique=k,
         vocab=CTR_OFF_VOCAB, dim=CTR_DIM, server_rows="bit-equal",
         launches=counts)
    return counts.get("fused_embed_grad", 0)


def hybrid_phase(ht, ctr_main, eg, registry, counted, dev):
    """WDL-Criteo under Hybrid at HYB_VOCAB rows on HYB_SERVERS servers:
    the gates, then HYB_STEPS steps with BSP + prefetch and HYB_STEPS with
    prefetch off through ctr_main.run, the launch counts zeroed just
    before each step and read just after. Each loop's line has the wall
    and device time of a step and its PS legs on the host clock."""
    import tempfile
    from hetu_tpu_torch.ps import local_cluster as lc
    hybrid_gates(ht, ctr_main, registry, counted, dev)
    rows_launches = hybrid_rows_program(ht, ctr_main, eg, registry, counted,
                                        dev)
    # a server answers InitTensor once its share of the table is drawn
    os.environ.setdefault("DMLC_PS_RECV_TIMEOUT_MS", "900000")
    data = ctr_main.load_data("wdl_criteo", HYB_VOCAB)
    launched = 0
    with lc.local_cluster(n_servers=HYB_SERVERS):
        t0 = time.perf_counter()
        tr, rt, table = _hybrid_trainer(ctr_main, dev, data, HYB_VOCAB,
                                        bsp=True, prefetch=True)
        init_s = time.perf_counter() - t0
        for mode in ("bsp_prefetch", "prefetch_off"):
            if mode == "prefetch_off":
                tr.ex.close()           # later steps push on this thread
            before = dict(rt.perf)
            with tempfile.TemporaryDirectory() as prof:
                it = ctr_main.run(dev, trainer=tr, steps=HYB_STEPS,
                                  profile_dir=prof,
                                  profile_iters=CTR_PROFILE_STEPS)
                epoch = next(it)
                summary = next(it)
            check(epoch["launches_per_step"] == HYB_LAUNCHES
                  and epoch["launches_same_every_step"]
                  and epoch["launches"] == {"fused_sgd": HYB_STEPS},
                  f"{mode}: a Hybrid step launched "
                  f"{epoch['launches_per_step']}, {HYB_STEPS} steps "
                  f"{epoch['launches']}; expected {HYB_LAUNCHES} a step")
            check(np.isfinite(epoch["losses"]).all(),
                  f"{mode}: losses {epoch['losses']}")
            n = HYB_STEPS + CTR_PROFILE_STEPS
            legs_ms = {k[:-2]: (summary["ps"][k] - before[k]) / n * 1e3
                       for k in ("pre_step_s", "post_step_s", "pull_rpc_s",
                                 "push_rpc_s")}
            prof = summary["profile"]
            launched += epoch["launches"].get("fused_sgd", 0)
            emit("ctr_hybrid_train", mode=mode, vocab=HYB_VOCAB,
                 servers=HYB_SERVERS, dim=CTR_DIM, batch=CTR_BATCH,
                 steps=HYB_STEPS, init_s=init_s,
                 device_params=sum(tr.param(q).numel()
                                   for q in tr.ex.param_nodes),
                 step_ms=summary["step_ms"],
                 samples_per_s=summary["samples_per_s"],
                 device_ms=prof["device_ms"],
                 device_busy_share=prof["device_busy_share"],
                 groups_us=prof["groups_us"], ps_legs_ms=legs_ms,
                 ps_counts={k: summary["ps"][k] - before[k] for k in (
                     "sync_pulls", "prefetch_hits", "prefetch_misses",
                     "async_pushes")},
                 losses=epoch["losses"], train_auc=epoch["train_auc"],
                 launches_per_step=epoch["launches_per_step"])
        tr.ex.close()
    return {"fused_sgd": launched}, {"fused_embed_grad": rows_launches}


def bert_grad_gate(bert, tfm, bert_forward, registry, cfg, params, batch,
                   want, phase):
    """The first step's gradients with the kernels against kernels="off",
    f32 then bf16 (GRAD_REL, BF16_EXCESS): one bert_grad_check line per
    dtype. Returns ``(first bf16 loss, its kernels="off" loss)``."""

    def grads(c):
        return bert_forward.counted(lambda: tfm.value_and_grad(
            bert.pretrain_loss, params, batch, c, has_aux=True))

    # f32 first: its gradient with the kernels, held per tensor to
    # kernels="off", is the reference both bf16 gradients are measured from
    agree, ref = {}, None
    for name, c in (("float32", dataclasses.replace(cfg, dtype=torch.float32)),
                    ("bfloat16", cfg)):
        ((loss_k, _), g_k), counts = grads(c)
        check(counts == want, f"{phase} {name} pretrain gradient launched "
              f"{counts}, expected {want}")
        with registry.active("off"):
            ((loss_o, _), g_o), off_counts = grads(c)
        check(off_counts == {}, f"kernels='off' launched {off_counts}")
        paths, flat_k = zip(*tfm.tree_leaves(g_k, with_paths=True))
        flat_o = tfm.tree_leaves(g_o)
        per = {p: rel_l2(a, b) for p, a, b in zip(paths, flat_k, flat_o)}
        worst = max(per, key=per.get)
        agree[name] = dict(
            loss=float(loss_k), off_loss=float(loss_o),
            loss_rel=abs(float(loss_k) - float(loss_o)) / abs(float(loss_o)),
            grad_rel_l2_all=rel_l2(torch.cat([g.flatten() for g in flat_k]),
                                   torch.cat([g.flatten() for g in flat_o])),
            grad_rel_l2_max=per[worst], grad_rel_l2_worst=worst)
        if name == "bfloat16":
            # bf16 rounding through 12 layers and back, measured: each
            # tensor's distance from the f32 gradient, and all tensors'
            # together, with the kernels and with the plain versions
            vs_k = {p: rel_l2(a, r) for p, a, r in zip(paths, flat_k, ref)}
            vs_o = {p: rel_l2(b, r) for p, b, r in zip(paths, flat_o, ref)}
            ref_all = torch.cat([g.flatten() for g in ref])
            k_all = rel_l2(torch.cat([g.flatten() for g in flat_k]), ref_all)
            o_all = rel_l2(torch.cat([g.flatten() for g in flat_o]), ref_all)
            del ref_all
            limit = {p: BF16_EXCESS * max(vs_o[p], o_all) for p in paths}
            use = {p: vs_k[p] / limit[p] for p in paths}
            worst_x = max(use, key=use.get)
            agree[name].update(
                vs_f32_all=k_all, off_vs_f32_all=o_all, vs_f32=vs_k,
                off_vs_f32=vs_o, excess_limit=BF16_EXCESS,
                worst_share_of_limit=use[worst_x], worst=worst_x)
        emit("bert_grad_check", bert_phase=phase, dtype=name,
             batch=list(batch["input_ids"].shape),
             mlm_slots=batch["mlm_ids"].shape[1], grad_rel_l2_tol=GRAD_REL,
             **agree[name])
        check(agree[name]["loss_rel"] < BERT_REL, f"{phase} {name} first "
              f"loss {float(loss_k)} vs kernels='off' {float(loss_o)}")
        check(agree[name]["grad_rel_l2_all"] < GRAD_REL, f"{phase} {name} "
              f"gradients differ from kernels='off': {agree[name]}")
        if name == "float32":
            check(per[worst] < GRAD_REL, f"{phase} float32 gradient of "
                  f"{worst} differs from kernels='off' by rel L2 {per[worst]}")
            ref = flat_k
        else:
            check(k_all <= BF16_EXCESS * o_all, f"{phase} bfloat16 gradients "
                  f"are rel L2 {k_all} from the f32 ones, kernels='off' "
                  f"{o_all}")
            check(use[worst_x] <= 1, f"{phase} bfloat16 gradient of "
                  f"{worst_x} is rel L2 {vs_k[worst_x]} from the f32 one, "
                  f"above {limit[worst_x]} (kernels='off' {vs_o[worst_x]})")
        del g_k, g_o, flat_k, flat_o
    return agree["bfloat16"]["loss"], agree["bfloat16"]["off_loss"]


def bert_train_phase(bert, tfm, bert_forward, bert_pretrain, registry, dev):
    """BERT-base pretraining: the first step's gradients with the kernels
    against kernels="off", then TRAIN_STEPS steps of make_pretrain_step,
    each with the launch counts zeroed just before it and read just after;
    then the same at the phase-2 shape (bert_phase2), and FINETUNE_STEPS
    steps of make_finetune_step on the requests."""
    cfg = bert.BERT_BASE
    want = {"flash_attention_fwd": 2 * cfg.n_layers,   # forward + remat
            "flash_attention_bwd": cfg.n_layers,
            "fused_linear_nll_fwd": 1, "fused_linear_nll_bwd": 1,
            "fused_embed_grad": 2}                   # token and type tables
    params = bert.init_params(0, cfg, dev)
    batch = bert_forward.phase1_batch(cfg, BERT_BATCH, BERT_SEQ, BERT_PRED,
                                      seed=0, device=dev)
    first_loss, off_loss = bert_grad_gate(
        bert, tfm, bert_forward, registry, cfg, params, batch, want, "phase1")
    # the off step itself launches nothing (on copies: a step updates in
    # place)
    copy = tfm.tree_map(torch.clone, params)
    step_off = bert.make_pretrain_step(cfg, lr=TRAIN_LR)
    with registry.active("off"):
        (off_step_loss, _, _, _), off_step_counts = bert_forward.counted(
            lambda: step_off(copy, bert.init_opt_state(copy), batch))
    check(off_step_counts == {}, f"kernels='off' step launched "
          f"{off_step_counts}")
    check(float(off_step_loss) == off_loss,
          "the off step's loss differs from the off gradient's")
    del copy, params

    # -- the main path: TRAIN_STEPS steps with the kernels -----------------
    rows = list(bert_pretrain.run(dev, TRAIN_STEPS, BERT_BATCH, BERT_SEQ,
                                  BERT_PRED, TRAIN_LR, cfg=cfg))
    steps, summary = rows[:-1], rows[-1]
    losses = [r["loss"] for r in steps]
    for r in steps:
        check(r["launches"] == want, f"step {r['step']} launched "
              f"{r['launches']}, expected {want}")
    check(np.isfinite(losses).all(), f"losses {losses}")
    ln = float(np.log(cfg.vocab_size) + np.log(2))
    check(abs(losses[0] - ln) < FIRST_LOSS_TOL,
          f"first loss {losses[0]} is not within {FIRST_LOSS_TOL} of {ln}")
    check(abs(losses[0] - first_loss) / losses[0] < BERT_REL,
          "the step's first loss differs from the gradient check's")
    last5 = float(np.mean(losses[-5:]))
    check(last5 < losses[0], f"mean of the last 5 losses {last5} is not "
          f"below the first {losses[0]}")
    emit("bert_pretrain", config="BERT_BASE", remat=cfg.remat,
         batch=BERT_BATCH, seq_len=BERT_SEQ, mlm_slots=BERT_PRED,
         lr=TRAIN_LR, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP,
         losses=losses, first_loss=losses[0], ln_vocab_plus_ln2=ln,
         mean_last5=last5, step_ms=summary["step_ms"],
         sequences_per_s=summary["sequences_per_s"],
         tokens_per_s=summary["tokens_per_s"],
         launches_per_step=summary["launches_per_step"])

    bert_phase2(bert, tfm, bert_forward, bert_pretrain, registry, dev, cfg,
                want)

    # -- fine-tuning the classifier on the requests -------------------------
    cls = bert.init_classifier_params(1, cfg, 2, pretrained=bert.init_params(
        0, cfg, dev))
    opt = bert.init_opt_state(cls)
    ids, seg, mask = bert_forward.requests(cfg, BERT_REQUESTS, BERT_SEQ,
                                           seed=1, device=dev)
    fb = {"input_ids": ids, "segment_ids": seg, "input_mask": mask,
          "label": torch.arange(BERT_REQUESTS, device=dev) % 2}
    step = bert.make_finetune_step(cfg, lr=FINETUNE_LR)
    ft_losses = []
    for i in range(FINETUNE_STEPS):
        (loss, acc, cls, opt), counts = bert_forward.counted(
            lambda: step(cls, opt, fb))
        ft_want = {"flash_attention_fwd": 2 * cfg.n_layers,
                   "flash_attention_bwd": cfg.n_layers,
                   "fused_embed_grad": 2}
        check(counts == ft_want, f"finetune step {i} launched {counts}, "
              f"expected {ft_want}")
        ft_losses.append(float(loss))
    check(np.isfinite(ft_losses).all(), f"finetune losses {ft_losses}")
    emit("bert_finetune", requests=BERT_REQUESTS, seq_len=BERT_SEQ,
         lr=FINETUNE_LR, steps=FINETUNE_STEPS, losses=ft_losses,
         launches_per_step=counts)
    return summary["launches_per_step"]


def phase2_batch(bert, bert_forward, dev):
    """BERT-base's synthetic phase-2 batch (PHASE2_SEQ tokens, PHASE2_PRED
    MLM slots a row), as bert_phase2 trains on it."""
    return bert_forward.phase1_batch(bert.BERT_BASE, BERT_BATCH, PHASE2_SEQ,
                                     PHASE2_PRED, seed=0, device=dev)


def bert_phase2(bert, tfm, bert_forward, bert_pretrain, registry, dev, cfg,
                want):
    """BERT-base at its phase-2 shape (PHASE2_SEQ tokens, PHASE2_PRED MLM
    slots a row): the first step's gradients under the phase-1 gates, then
    PHASE2_STEPS steps of the entry point, each with the launch counts zeroed
    just before it and read just after, and the device time of a step."""
    import tempfile
    params = bert.init_params(0, cfg, dev)
    batch = phase2_batch(bert, bert_forward, dev)
    first_loss, _ = bert_grad_gate(bert, tfm, bert_forward, registry, cfg,
                                   params, batch, want, "phase2")
    del params, batch
    with tempfile.TemporaryDirectory() as tmp:
        rows = list(bert_pretrain.run(
            dev, PHASE2_STEPS, BERT_BATCH, PHASE2_SEQ, PHASE2_PRED, TRAIN_LR,
            profile_dir=tmp, profile_iters=PHASE2_PROFILE, cfg=cfg))
    steps, summary = rows[:-1], rows[-1]
    losses = [r["loss"] for r in steps]
    for r in steps:
        check(r["launches"] == want, f"phase-2 step {r['step']} launched "
              f"{r['launches']}, expected {want}")
    check(np.isfinite(losses).all(), f"phase-2 losses {losses}")
    ln = float(np.log(cfg.vocab_size) + np.log(2))
    check(abs(losses[0] - ln) < FIRST_LOSS_TOL, f"phase-2 first loss "
          f"{losses[0]} is not within {FIRST_LOSS_TOL} of {ln}")
    check(abs(losses[0] - first_loss) / losses[0] < BERT_REL,
          "the phase-2 step's first loss differs from the gradient check's")
    prof = summary["profile"]
    emit("bert_pretrain_phase2", config="BERT_BASE", remat=cfg.remat,
         batch=BERT_BATCH, seq_len=PHASE2_SEQ, mlm_slots=PHASE2_PRED,
         lr=TRAIN_LR, steps=PHASE2_STEPS, warmup=bert_pretrain.WARMUP,
         losses=losses, first_loss=losses[0], ln_vocab_plus_ln2=ln,
         step_ms=summary["step_ms"], device_ms=prof["device_ms"],
         device_busy_share=prof["device_busy_share"],
         groups_us=prof["groups_us"],
         sequences_per_s=summary["sequences_per_s"],
         tokens_per_s=summary["tokens_per_s"],
         launches_per_step=summary["launches_per_step"])


def bert_phase(bert, bert_forward, registry, dev):
    """The BERT-base forward: the pretraining loss without gradient and the
    classifier on requests, each once with the launch counts zeroed just
    before it and read just after, then against kernels="off", then timed."""
    cfg = bert.BERT_BASE
    params = bert.init_params(0, cfg, dev)
    batch = bert_forward.phase1_batch(cfg, BERT_BATCH, BERT_SEQ, BERT_PRED,
                                      seed=0, device=dev)
    cls_params = bert.init_classifier_params(1, cfg, 2, pretrained=params)
    ids, seg, mask = bert_forward.requests(cfg, BERT_REQUESTS, BERT_SEQ,
                                           seed=1, device=dev)

    def pretrain():
        loss, (mlm, nsp) = bert.pretrain_loss(params, batch, cfg)
        return torch.stack([loss, mlm, nsp])

    def classify():
        return bert.classify_logits(cls_params, ids, seg, cfg,
                                    input_mask=mask)

    with torch.inference_mode():
        # -- the main path, with the kernels -------------------------------
        losses, pre_counts = bert_forward.counted(pretrain)
        logits, cls_counts = bert_forward.counted(classify)
        loss, mlm, nsp = (float(x) for x in losses)
        check(pre_counts == {"flash_attention_fwd": cfg.n_layers,
                             "fused_linear_nll_fwd": 1},
              f"pretrain_loss launched {pre_counts}, expected "
              f"{cfg.n_layers} flash_attention_fwd and 1 fused_linear_nll_fwd")
        check(cls_counts == {"flash_attention_fwd": cfg.n_layers},
              f"classify_logits launched {cls_counts}, expected "
              f"{cfg.n_layers} flash_attention_fwd")
        check(np.isfinite([loss, mlm, nsp]).all(), f"losses {losses}")
        check(abs(mlm - np.log(cfg.vocab_size)) < 0.5,
              f"mlm {mlm} at init is not within 0.5 of ln V")
        check(abs(nsp - np.log(2)) < 0.2,
              f"nsp {nsp} at init is not within 0.2 of ln 2")
        check(tuple(logits.shape) == (BERT_REQUESTS, 2)
              and bool(torch.isfinite(logits).all()), f"logits {logits}")
        # -- the same inputs through the plain versions on the card --------
        with registry.active("off"):
            off_losses, off_counts = bert_forward.counted(pretrain)
            off_logits, _ = bert_forward.counted(classify)
            off_ms = bert_forward.forward_ms(pretrain, iters=5)
        check(off_counts == {}, "kernels='off' launched a kernel")
        rel = (losses - off_losses).abs() / off_losses.abs()
        check(bool((rel < BERT_REL).all()),
              f"losses {losses.tolist()} vs kernels='off' "
              f"{off_losses.tolist()}: rel {rel.tolist()}")
        logits_err = float((logits - off_logits).abs().max())
        check(logits_err < LOGITS_ATOL,
              f"classifier logits differ from kernels='off' by {logits_err}")
        # -- timed ---------------------------------------------------------
        ms = bert_forward.forward_ms(pretrain, BERT_ITERS)
        cls_ms = bert_forward.forward_ms(classify, BERT_ITERS)
    emit("bert_forward", config="BERT_BASE", layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, vocab=cfg.vocab_size,
         dtype="bfloat16", params=bert.count_params(params),
         batch=BERT_BATCH, seq_len=BERT_SEQ, mlm_slots=BERT_PRED,
         real_mlm_slots=int(batch["mlm_weights"].sum()),
         loss=loss, mlm=mlm, nsp=nsp, ln_vocab=float(np.log(cfg.vocab_size)),
         off_rel_diff=[float(x) for x in rel], launches=pre_counts,
         forward_ms=ms, sequences_per_s=BERT_BATCH / ms * 1e3,
         off_forward_ms=off_ms)
    emit("bert_requests", requests=BERT_REQUESTS, seq_len=BERT_SEQ,
         logits_absmax=float(logits.abs().max()),
         off_max_abs_diff=logits_err, launches=cls_counts, ms=cls_ms,
         requests_per_s=BERT_REQUESTS / cls_ms * 1e3)
    return pre_counts


def same_bits(a, b):
    """Bit-equal tensors, NaN (float32 only) compared by position."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32),
                                               b[~nb].view(torch.int32))


def _quant_input(name, n, gen, dev):
    x = torch.randn(n, generator=gen, device=dev) * 3
    if name == "edge":
        x[7 * 256:8 * 256 + 64] = 0.0
        x[100] = float("nan")
        x[3 * 7 * 256 + 5] = float("inf")
        x[3 * 7 * 256 + 9] = -0.0
        t0 = 4 * 7 * 256        # x / scale = x * 8 in this 7 * 64 block:
        x[t0] = 127.0 / 8       # int8's ties at k + 0.5
        x[t0 + 1:t0 + 7 * 64] = (torch.arange(7 * 64 - 1, device=dev) % 9
                                 - 3.5) / 8
    return x


def emit_quant(cases, timings, bert):
    emit("quant_comm_checked", tolerance="bit-equal", rerun_bit_equal=True,
         cases=len(cases),
         group_cases=sum(c["form"] == "group" for c in cases),
         modes=list(QUANT_MODES), blocks=list(QUANT_BLOCKS),
         shapes=dict(QUANT_SIZES), groups=dict(QUANT_GROUPS),
         nan_scale_cases=sum(c.get("nan_scales", 0) > 0 for c in cases),
         timings=timings, bert_base=bert)


def quant_group_case(qc, cq, xs, mode, block, ef, gen, dev):
    """One group over ``xs`` at world size 1 (the bucket is the rank's
    shard), with a seeded residual or none: the quantize and the
    dequantize of what it sent through the kernels, twice, and through the
    plain group versions. Returns {output: bit-equal to plain and rerun}."""
    st = cq.QarGroup([x.numel() for x in xs], 1,
                     cq.QuantPolicy(mode, block=block), dev)
    st.fill_bucket(xs)
    pl = st.plan
    resid = (torch.randn(pl.shard, generator=gen, device=dev) * 0.01
             if ef else None)
    got = qc._quant_kernel(st.bucket, block=block, mode=mode, residual=resid,
                           out=(st.send_q, st.send_scales,
                                torch.empty_like(st.bucket) if ef else None))
    again = qc._quant_kernel(st.bucket, block=block, mode=mode,
                             residual=resid)
    want = qc._quant_group_plain(st.bucket, block=block, mode=mode,
                                 residual=resid)
    st.recv.copy_(st.send)          # world size 1: the one row received
    n = sum(pl.sizes)
    deq = [qc._dequant_kernel(st.recv_q, st.recv_scales, n=n, block=block,
                              plan=pl) for _ in range(2)]
    deq_plain = qc._dequant_group_plain(st.recv_q, st.recv_scales, n=n,
                                        block=block, plan=pl)
    torch.cuda.synchronize()
    ok = {k: all(a is None and w is None or same_bits(a, w)
                 for a in (g, r))
          for k, g, r, w in zip(("q", "scales", "residual"), got, again,
                                want)}
    ok["dequantized"] = all(same_bits(d[o:o + k], deq_plain[o:o + k])
                            for d in deq for o, k in zip(pl.out_offs,
                                                         pl.sizes))
    return ok, pl


def quant_phase(qc, cq, registry, dev, bw, f32):
    """quant_blocks and dequant_blocks against their plain versions and a
    rerun, bit for bit: the single forms at every QUANT_SIZES x QUANT_MODES
    x QUANT_BLOCKS case, the group forms at every QUANT_GROUPS x modes x
    blocks case with and without the residual; timed at the main path's
    shapes (one group launch of each at block 256, with the residual)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    inputs = {name: _quant_input(name, n, gen, dev) for name, n in QUANT_SIZES}
    cases = []
    for mode in QUANT_MODES:
        for block in QUANT_BLOCKS:
            for name, n in QUANT_SIZES:
                x = inputs[name]
                qk, sk, _ = qc._quant_kernel(x, block=block, mode=mode)
                qr, sr, _ = qc._quant_kernel(x, block=block, mode=mode)
                qp, sp, npl = qc._quant_plain(x, block=block, mode=mode)
                dk = qc._dequant_kernel(qk, sk, n=n, block=block)
                dp = qc._dequant_plain(qp, sp, n=npl, block=block)
                torch.cuda.synchronize()
                ok = {"q": same_bits(qk, qp) and same_bits(qr, qp),
                      "scales": same_bits(sk, sp) and same_bits(sr, sp),
                      "dequantized": same_bits(dk, dp)}
                check(all(ok.values()) and npl == n,
                      f"quant_comm {mode} block {block} {name}: kernel and "
                      f"plain version differ: {ok}")
                cases.append({"form": "single", "mode": mode,
                              "block": block, "shape": name, "n": n,
                              "blocks": sk.numel(),
                              "nan_scales": int(torch.isnan(sk).sum())})
                del qk, sk, qr, sr, qp, sp, dk, dp
            for name, members in QUANT_GROUPS:
                for ef in (True, False):
                    ok, pl = quant_group_case(
                        qc, cq, [inputs[m] for m in members], mode, block,
                        ef, gen, dev)
                    check(all(ok.values()), f"quant_comm group {mode} block "
                          f"{block} {name} residual={ef}: kernel, plain "
                          f"version and rerun differ: {ok}")
                    cases.append({"form": "group", "mode": mode,
                                  "block": block, "shape": name,
                                  "residual": ef, "n": sum(pl.sizes),
                                  "blocks": pl.blocks, "vec": pl.vec})
                    torch.cuda.empty_cache()
    mlp = [inputs[name] for name, _ in QUANT_SIZES[:3]]
    out = {}
    for mode in QUANT_MODES:
        st = cq.QarGroup([x.numel() for x in mlp], 1,
                         cq.QuantPolicy(mode), dev)
        st.fill_bucket(mlp)
        pl = st.plan
        n, nb = pl.shard, pl.blocks
        resid = torch.randn(n, generator=gen, device=dev) * 0.01
        q_out = (st.send_q, st.send_scales, torch.empty_like(resid))
        qc._quant_kernel(st.bucket, block=256, mode=mode, residual=resid,
                         out=q_out)
        st.recv.copy_(st.send)
        d_out = torch.empty(pl.out_size, device=dev)
        d_args = (st.recv_q, st.recv_scales)
        d_kw = dict(n=sum(pl.sizes), block=256, plan=pl, out=d_out)
        timed = {
            # read the sum and the residual; write q, the scales and the
            # residual; add, abs, max, divide, round, decode, multiply,
            # subtract
            "quant_blocks": (
                bound(13 * n + 4 * nb, 7 * n, bw, f32),
                lambda: qc._quant_kernel(st.bucket, block=256, mode=mode,
                                         residual=resid, out=q_out),
                lambda: qc._quant_group_plain(st.bucket, block=256,
                                              mode=mode, residual=resid,
                                              out=q_out),
                lambda: qc.quantize_shard(st.bucket, pl, mode, resid,
                                          q_out)),
            # read q and the scales, write n floats; one multiply each
            "dequant_blocks": (
                bound(n + 4 * nb + 4 * n, n, bw, f32),
                lambda: qc._dequant_kernel(*d_args, **d_kw),
                lambda: qc._dequant_group_plain(*d_args, **d_kw),
                lambda: qc.dequantize_group(*d_args, pl, d_out))}
        for k, (bnd, kern, plain, launched) in timed.items():
            out.setdefault(k, {})[mode] = {
                "bound": bnd, "ms": graph_ms(kern),
                "launched_ms": time_ms(launched),
                "plain_ms": graph_ms(plain),
                # no single PyTorch call quantizes blockwise
                "library_ms": None, "shape": [x.numel() for x in mlp]}
    big = inputs["bert_base"]
    nbig, nbbig = big.numel(), -(-big.numel() // 256)
    qb, sb, _ = qc._quant_kernel(big, block=256, mode="int8")
    rb = torch.randn(nbig, generator=gen, device=dev) * 0.01
    rb_out = torch.empty_like(rb)
    bert = {"quant_ms": graph_ms(lambda: qc._quant_kernel(
                big, block=256, mode="int8", out=(qb, sb, None)), iters=20),
            "quant_bound_ms": bound(5 * nbig + 4 * nbbig, 4 * nbig, bw,
                                    f32)[0],
            "quant_residual_ms": graph_ms(lambda: qc._quant_kernel(
                big, block=256, mode="int8", residual=rb,
                out=(qb, sb, rb_out)), iters=20),
            "quant_residual_bound_ms": bound(13 * nbig + 4 * nbbig,
                                             7 * nbig, bw, f32)[0]}
    db = torch.empty(nbig, device=dev)
    bert.update(dequant_ms=graph_ms(lambda: qc._dequant_kernel(
        qb, sb, n=nbig, block=256, out=db), iters=20),
        dequant_bound_ms=bound(5 * nbig + 4 * nbbig, nbig, bw, f32)[0])
    for k in ("quant", "quant_residual", "dequant"):
        bert[k + "_bound_share"] = bert[k + "_bound_ms"] / bert[k + "_ms"]
    return cases, out, bert


def qar_vs_per_tensor(cq, dev):
    """The group all-reduce of the MLP's three quantized gradients against
    quantized_allreduce per tensor (a group of one each), int8 and
    fp8, DP_CHECK_STEPS steps with the residual carried: bit-equal values
    and residuals. Needs the process group."""
    shapes = [(3072, 256), (256, 256), (256, 10)]
    gen = torch.Generator(device=dev).manual_seed(11)
    for mode in QUANT_MODES:
        pol = cq.QuantPolicy(mode)
        st = cq.QarGroup([a * b for a, b in shapes], 1, pol, dev)
        r_g = st.residual_views()
        r_t = [torch.zeros(cq.shard_size(a * b, 1, pol.block), device=dev)
               for a, b in shapes]
        for step in range(DP_CHECK_STEPS):
            xs = [torch.randn(s, generator=gen, device=dev) * 0.1
                  for s in shapes]
            v_g, r_g = cq.quantized_allreduce_group(xs, r_g, None, pol, st)
            per = [cq.quantized_allreduce(x, r, None, pol)
                   for x, r in zip(xs, r_t)]
            r_t = [r for _, r in per]
            check(all(same_bits(v, vg) and same_bits(r, rg)
                      for (v, r), vg, rg in zip(per, v_g, r_g)),
                  f"qar {mode} step {step}: the group differs from "
                  "quantized_allreduce per tensor")
    return {"modes": list(QUANT_MODES), "steps": DP_CHECK_STEPS,
            "tensors": len(shapes), "bit_equal": True}


def dp_phase(ht, cnn_main, cq, multihost, registry, data, dev, local):
    """The MLP data-parallel at world size 1 over NCCL with an explicit dp
    mesh, under DP_MODES, SGD and Adam; returns the launches of the runs
    with the kernels. ``local``: {opt: (losses, step ms)} of local mode."""
    import shutil
    import tempfile
    store = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    launches = dict.fromkeys(("quant_blocks", "dequant_blocks"), 0)
    try:
        multihost.initialize("file://" + os.path.join(store, "rendezvous"),
                             world_size=1, rank=0, device=dev)
        mesh = multihost.global_mesh(1)
        emit("qar_vs_per_tensor", **qar_vs_per_tensor(cq, dev))
        for opt, lr, steps, loss_max in (
                ("sgd", SGD_LR, SGD_STEPS, SGD_LOSS_MAX),
                ("adam", ADAM_LR, ADAM_STEPS, ADAM_LOSS_MAX)):
            kname = "fused_sgd" if opt == "sgd" else "fused_adam"
            curves, rows = {}, {}
            for mode in DP_MODES:
                registry.reset_launch_counts()
                losses, step_ms, _, ex = train(
                    ht, cnn_main, data, opt, lr, steps, comm_mode="AllReduce",
                    mesh=mesh, comm_quant=mode)
                counts = registry.launch_counts()
                want = {kname: steps}
                if mode != "off":
                    want.update({k: v * steps for k, v in DP_LAUNCHES.items()})
                    for k in launches:
                        launches[k] += counts[k]
                check({k: v for k, v in counts.items() if v} == want,
                      f"dp {opt} {mode}: launches {counts}, expected {want}")
                check(np.all(np.isfinite(losses)), f"dp {opt} {mode}: "
                      "non-finite loss")
                last = float(np.mean(losses[-10:]))
                check(last < loss_max, f"dp {opt} {mode}: mean loss of the "
                      f"last 10 steps {last} is not below {loss_max}")
                curves[mode] = losses
                rows[mode] = dict(step_ms=step_ms, first_loss=float(losses[0]),
                                  mean_last10=last,
                                  launches={k: v for k, v in counts.items()
                                            if v},
                                  report=ex.comm_quant_report)
            off = curves["off"]
            # DP off at world size 1 is local mode, bit for bit
            check(np.array_equal(off, local[opt][0]), f"dp {opt} off: the "
                  "losses differ from local mode's")
            for mode in DP_MODES[1:]:
                k = DP_CURVE_STEPS
                dev_ = np.abs(curves[mode][:k] - off[:k]) / np.maximum(
                    1.0, np.abs(off[:k]))
                rows[mode]["curve_max_rel_vs_off"] = float(dev_.max())
                check(dev_.max() <= DP_CURVE_TOL[mode], f"dp {opt} {mode}: "
                      f"the loss is {dev_.max()} from off's, above "
                      f"{DP_CURVE_TOL[mode]}")
                # the first steps against kernels="off"
                got = train(ht, cnn_main, data, opt, lr, DP_CHECK_STEPS,
                            comm_mode="AllReduce", mesh=mesh, comm_quant=mode)
                n_before = registry.launch_counts()
                want = train(ht, cnn_main, data, opt, lr, DP_CHECK_STEPS,
                             kernels="off", comm_mode="AllReduce", mesh=mesh,
                             comm_quant=mode)
                check(registry.launch_counts() == n_before,
                      "kernels='off' launched a kernel")
                pg = [got[3].state["params"][id(n)] for n in got[3].param_nodes]
                pw = [want[3].state["params"][id(n)]
                      for n in want[3].param_nodes]
                if opt == "sgd":
                    check(np.array_equal(got[0], want[0])
                          and all(torch.equal(a, b) for a, b in zip(pg, pw)),
                          f"dp sgd {mode}: the first {DP_CHECK_STEPS} steps "
                          "differ from kernels='off'")
                else:
                    np.testing.assert_allclose(got[0], want[0],
                                               **TOL["fused_adam"])
                    for a, b in zip(pg, pw):
                        torch.testing.assert_close(a, b, **TOL["fused_adam"])
                rows[mode]["vs_off_max_abs"] = max(
                    float((a - b).abs().max()) for a, b in zip(pg, pw))
                # the per-op path: each quantized weight alone
                per = train(ht, cnn_main, data, opt, lr, DP_CHECK_STEPS,
                            comm_mode="AllReduce", mesh=mesh,
                            comm_quant=mode, per_op=True)
                po = [per[3].state["params"][id(n)]
                      for n in per[3].param_nodes]
                check(np.array_equal(got[0], per[0])
                      and all(torch.equal(a, b) for a, b in zip(pg, po)),
                      f"dp {opt} {mode}: the first {DP_CHECK_STEPS} steps "
                      "differ from the per-op path's")
                rows[mode]["vs_per_op_bit_equal"] = True
            emit("dp_train", opt=opt, lr=lr, steps=steps, batch=BATCH,
                 world_size=1, backend="nccl", local_step_ms=local[opt][1],
                 **rows)
    finally:
        multihost.shutdown()
        shutil.rmtree(store, ignore_errors=True)
    return launches


def train(ht, cnn_main, data, opt, lr, steps, kernels=None, ctx=None,
          validate=False, per_op=False, **ex_kw):
    """One fresh executor on the MLP (``ex_kw``: more Executor options):
    (losses, step ms, validation, the executor). ``per_op``: each marked
    all-reduce alone (the per-op path), not as one group."""
    loss, y, y_, train_op = cnn_main.build("mlp", "CIFAR10", BATCH, opt, lr,
                                           data=data)
    ex = ht.Executor({"train": [loss, y, train_op], "validate": [loss, y, y_]},
                     ctx=ctx, seed=0, kernels=kernels, **ex_kw)
    if per_op:
        for sub in ex.subexecutors.values():
            sub.qar_groups, sub.qar_deferred = {}, set()
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "the executor must keep f32 matmuls in full f32")
    losses = []
    t0 = None
    for i in range(steps):
        if i == min(10, steps - 1):  # first steps carry cuBLAS/allocator set-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        lv, yv, _ = ex.run("train")
        losses.append(lv.handle)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - min(10, steps - 1))
    check(tuple(yv.shape) == (BATCH, data[5]), f"logits shape {yv.shape}")
    losses = torch.stack(losses).cpu().numpy()
    val = None
    if validate:
        vl, correct = [], []
        for _ in range(ex.get_batch_num("validate")):
            l, yp, yt = ex.run("validate", convert_to_numpy_ret_vals=True)
            vl.append(float(l))
            correct.extend(np.argmax(yp, 1) == np.argmax(yt, 1))
        val = {"loss": float(np.mean(vl)), "acc": float(np.mean(correct))}
    return losses, step_ms, val, ex


def _param_rel(ex_a, ex_b):
    """The largest relative L2 distance between two executors' parameters
    and op state (BatchNorm's running stats), and its tensor's name."""
    errs = {}
    for n_a, n_b in zip(ex_a.param_nodes, ex_b.param_nodes):
        errs[n_a.name] = rel_l2(ex_a.state["params"][id(n_a)],
                                ex_b.state["params"][id(n_b)])
    for i, (n_a, n_b) in enumerate(zip(ex_a._stateful_nodes(),
                                       ex_b._stateful_nodes())):
        for k, v in ex_a.state["op_state"][id(n_a)].items():
            errs[f"op_state{i}/{k}"] = rel_l2(
                v, ex_b.state["op_state"][id(n_b)][k])
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _opt_launches(fused_opt, train_op):
    """Launches of one optimizer apply over ``train_op``'s parameters, as
    opt_plan splits them (one per MAX_TENSORS tensors, whatever their
    alignment)."""
    sizes = tuple(int(np.prod(v.shape)) for v in train_op.vars)
    return len(fused_opt.opt_plan(sizes, (True,) * len(sizes)).launches)


def _steps(ex, target, counted, n, feed=None):
    """``n`` steps of ``target``: (losses, the launches of each step, step
    ms on the host clock to a synchronize, device ms a step by CUDA
    events). Each step's launches are zeroed just before it and read just
    after."""
    losses, per_step = [], []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        out, counts = counted(lambda: ex.run(target, feed_dict=feed))
        losses.append(out[0].handle.float().reshape(()))
        per_step.append(counts)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    return (torch.stack(losses).cpu().numpy(), per_step, host_ms,
            start.elapsed_time(end) / n)


def resnet_phase(ht, cnn_main, fused_opt, counted, mlp_data):
    """ResNet-18 at full width (RESNET_* above): returns the launches of
    its main-path runs."""
    tx, ty, vx, vy, _, num_class = mlp_data
    data = (tx.reshape(-1, 3, 32, 32), ty, vx.reshape(-1, 3, 32, 32), vy,
            3072, num_class)

    def executor(**kw):
        loss, y, y_, op = cnn_main.build("resnet18", "CIFAR10", BATCH, "sgd",
                                         RESNET_LR, data=data)
        return ht.Executor({"train": [loss, y, op]}, seed=0, **kw), op

    ex, op = executor()
    check(torch.backends.cudnn.allow_tf32 is False
          and torch.backends.cuda.matmul.allow_tf32 is False,
          "the executor must keep f32 convolutions and products in full f32")
    check(torch.backends.cudnn.benchmark is False,
          "cudnn.benchmark must stay off")
    per_step = _opt_launches(fused_opt, op)
    want = {"fused_sgd": per_step}
    n_params = sum(ex.state["params"][id(n)].numel() for n in ex.param_nodes)
    check(len(op.vars) == 62 and n_params == 11_173_962,
          f"ResNet-18 has {len(op.vars)} tensors, {n_params} parameters")
    off, _ = executor(kernels="off")
    # the first step, the kernels against their plain versions
    torch.backends.cudnn.deterministic = True
    try:
        first, counts0, _, _ = _steps(ex, "train", counted, 1)
        off_first, off_counts, _, _ = _steps(off, "train", counted, 1)
    finally:
        torch.backends.cudnn.deterministic = False
    check(off_counts == [{}], f"kernels='off' launched {off_counts}")
    loss_rel = abs(float(first[0]) - float(off_first[0])) / abs(
        float(off_first[0]))
    check(loss_rel <= RESNET_REL, f"resnet18 first loss {first[0]} vs "
          f"kernels='off' {off_first[0]}: rel {loss_rel}")
    state_rel, worst = _param_rel(ex, off)
    check(state_rel <= RESNET_REL, f"resnet18 after the first step: {worst} "
          f"differs from kernels='off' by rel L2 {state_rel}")
    del off
    torch.cuda.empty_cache()
    # the rest of the f32 run, timed
    rest, counts, step_ms, device_ms = _steps(ex, "train", counted,
                                              RESNET_STEPS - 1)
    losses = np.concatenate([first, rest])
    counts = counts0 + counts
    check(np.isfinite(losses).all(), f"resnet18 losses {losses}")
    last = float(np.mean(losses[-10:]))
    check(last < float(losses[0]), f"resnet18: mean of the last 10 losses "
          f"{last} is not below the first {losses[0]}")
    check(all(c == want for c in counts),
          f"resnet18 steps launched {counts}, expected {want} each")
    emit("resnet18", dtype="float32", steps=RESNET_STEPS, batch=BATCH,
         lr=RESNET_LR, params=n_params, tensors=len(op.vars),
         first_loss=float(losses[0]), last_loss=float(losses[-1]),
         mean_last10=last, step_ms=step_ms, device_ms_per_step=device_ms,
         samples_per_s=BATCH / step_ms * 1e3, launches_per_step=want,
         first_step_vs_off={"loss_rel": loss_rel, "state_rel_l2": state_rel,
                            "worst": worst, "tolerance": RESNET_REL,
                            "cudnn_deterministic": True},
         cudnn={"benchmark": False, "allow_tf32": False})
    launches = RESNET_STEPS * per_step
    del ex
    torch.cuda.empty_cache()
    # bf16 compute over f32 parameters
    ex, op = executor(dtype="bfloat16")
    # the first bf16 steps carry cuDNN's set-up of the bf16 convolutions:
    # timed after RESNET_BF16_WARMUP
    warm, counts, _, _ = _steps(ex, "train", counted, RESNET_BF16_WARMUP)
    losses, more, step_ms, device_ms = _steps(
        ex, "train", counted, RESNET_BF16_STEPS - RESNET_BF16_WARMUP)
    losses, counts = np.concatenate([warm, losses]), counts + more
    check(np.isfinite(losses).all(), f"resnet18 bf16 losses {losses}")
    check(all(c == want for c in counts),
          f"resnet18 bf16 steps launched {counts}, expected {want} each")
    f32 = all(ex.state["params"][id(n)].dtype == torch.float32
              for n in ex.param_nodes) and all(
        v.dtype == torch.float32 for s in ex.state["op_state"].values()
        for v in s.values()) and all(
        v.dtype == torch.float32 for slots in ex.state["slots"].values()
        for s in slots for v in (s.values() if isinstance(s, dict) else ()))
    check(f32, "bf16 compute left a parameter, slot or running stat in "
          "another dtype than float32")
    emit("resnet18", dtype="bfloat16", steps=RESNET_BF16_STEPS, batch=BATCH,
         timed_after=RESNET_BF16_WARMUP,
         first_loss=float(losses[0]), last_loss=float(losses[-1]),
         step_ms=step_ms, device_ms_per_step=device_ms,
         samples_per_s=BATCH / step_ms * 1e3, launches_per_step=want,
         state_float32=f32)
    return {"fused_sgd": launches + RESNET_BF16_STEPS * per_step}


def lm_phase(ht, hetu_transformer, fused_opt, counted):
    """The graph-API transformer LM (LM_* above): returns the launches of
    its main-path run."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, LM_VOCAB, (LM_BATCH, LM_SEQ + 1)).astype(np.float32)

    def executor(dropout, **kw):
        tokens = ht.Variable(name="tokens", trainable=False)
        labels = ht.Variable(name="labels", trainable=False)
        loss, _, _ = hetu_transformer.transformer_lm(
            tokens, labels, LM_VOCAB, LM_BATCH, LM_SEQ, dropout_prob=dropout,
            **LM_WIDTHS)
        op = ht.optim.AdamOptimizer(LM_LR).minimize(loss)
        ex = ht.Executor({"train": [loss, op]}, seed=0, **kw)
        return ex, op, {tokens: ids[:, :-1], labels: ids[:, 1:]}

    # the first step at dropout 0, the kernels against their plain versions
    ex0, op, feed0 = executor(0.0)
    off, _, feed_off = executor(0.0, kernels="off")
    want = {"fused_adam": _opt_launches(fused_opt, op), "fused_embed_grad": 2}
    first, c0, _, _ = _steps(ex0, "train", counted, 1, feed0)
    off_first, off_counts, _, _ = _steps(off, "train", counted, 1, feed_off)
    check(c0 == [want], f"the LM's first step launched {c0}, expected {want}")
    check(off_counts == [{}], f"kernels='off' launched {off_counts}")
    loss_rel = abs(float(first[0]) - float(off_first[0])) / abs(
        float(off_first[0]))
    state_rel, worst = _param_rel(ex0, off)
    check(loss_rel <= LM_REL and state_rel <= LM_REL,
          f"the LM's first step against kernels='off': loss rel {loss_rel}, "
          f"{worst} rel L2 {state_rel}")
    del ex0, off
    # the main path: dropout on, LM_STEPS steps
    ex, op, feed = executor(LM_DROPOUT)
    losses, counts, step_ms, device_ms = _steps(ex, "train", counted,
                                                LM_STEPS, feed)
    check(np.isfinite(losses).all(), f"LM losses {losses}")
    check(all(c == want for c in counts),
          f"LM steps launched {counts}, expected {want} each")
    emit("transformer_lm", vocab=LM_VOCAB, batch=LM_BATCH, seq=LM_SEQ,
         dropout=LM_DROPOUT, lr=LM_LR, steps=LM_STEPS, tensors=len(op.vars),
         params=sum(ex.state["params"][id(n)].numel() for n in ex.param_nodes),
         first_loss=float(losses[0]), last_loss=float(losses[-1]),
         step_ms=step_ms, device_ms_per_step=device_ms,
         tokens_per_s=LM_BATCH * LM_SEQ / step_ms * 1e3,
         launches_per_step=want,
         first_step_vs_off={"dropout": 0.0, "loss_rel": loss_rel,
                            "state_rel_l2": state_rel, "worst": worst,
                            "tolerance": LM_REL})
    return {k: LM_STEPS * v for k, v in want.items()}


def distgcn_phase(multihost, gnn_dist, gnn_main, counted, dev):
    """DistGCN on a 1 x 1 grid over NCCL (DGCN_* above): the first epoch
    against kernels="off", then DGCN_EPOCHS epochs through gnn_dist.run,
    each with the launch counts zeroed just before it and read just
    after; returns the launches of those epochs."""
    import shutil
    import tempfile
    from hetu_tpu_torch.examples import bert_forward
    store = tempfile.mkdtemp(prefix="chip_smoke_dgcn_")
    try:
        multihost.initialize("file://" + os.path.join(store, "rendezvous"),
                             world_size=1, rank=0, device=dev)
        grid = multihost.process_grid(1, 1)
        data = gnn_main.load_graph("arxiv")
        tr = gnn_dist.Trainer(grid, data, DGCN_HIDDEN, DGCN_LR)
        off = gnn_dist.Trainer(grid, data, DGCN_HIDDEN, DGCN_LR,
                               kernels="off")
        (loss_k, logits_k, g_k), counts = counted(tr.gradients)
        (loss_o, logits_o, g_o), off_counts = counted(off.gradients)
        check(counts == DGCN_LAUNCHES and off_counts == {},
              f"DistGCN's first epoch launched {counts}, under "
              f"kernels='off' {off_counts}; expected {DGCN_LAUNCHES}")
        loss_rel = abs(float(loss_k) - float(loss_o)) / abs(float(loss_o))
        check(loss_rel <= GCN_REL, f"DistGCN first loss {float(loss_k)} vs "
              f"kernels='off' {float(loss_o)}")
        rel = rel_errs(("logits", "w1", "w2"), [logits_k, *g_k],
                       [logits_o, *g_o], GCN_REL, "DistGCN first epoch")
        emit("distgcn_grad_check", grid=[1, 1], loss=float(loss_k),
             off_loss=float(loss_o), loss_rel=loss_rel, rel_l2=rel,
             bit_equal={k: bool(torch.equal(a, b)) for k, a, b in zip(
                 ("logits", "w1", "w2"), [logits_k, *g_k],
                 [logits_o, *g_o])},
             tolerance=GCN_REL, launches=counts)
        del off, g_k, g_o, logits_k, logits_o

        rows = list(gnn_dist.run(grid, data, DGCN_EPOCHS, trainer=tr))
        epochs, summary = rows[:-1], rows[-1]
        losses = [r["loss"] for r in epochs]
        for r in epochs:
            check(r["launches"] == DGCN_LAUNCHES, f"DistGCN epoch "
                  f"{r['epoch']} launched {r['launches']}, expected "
                  f"{DGCN_LAUNCHES}")
        check(np.isfinite(losses).all(), f"DistGCN losses {losses}")
        check(abs(losses[0] - float(loss_k)) / losses[0] < 1e-6,
              "DistGCN's first epoch loss differs from the gradient check's")
        check(losses[-1] < 0.5 * losses[0], f"DistGCN loss {losses[0]} -> "
              f"{losses[-1]} did not halve in {DGCN_EPOCHS} epochs")
        with tempfile.TemporaryDirectory() as d:
            prof = bert_forward.profile(tr.step, summary["epoch_ms"], 3,
                                        os.path.join(d, "distgcn.txt"))
        emit("distgcn_train", lr=DGCN_LR, epochs=DGCN_EPOCHS,
             **{k: summary[k] for k in (
                 "grid", "nodes", "entries", "block_entries", "features",
                 "hidden", "classes", "csr_build_ms", "epoch_ms",
                 "launches_per_epoch")},
             device_ms=prof["device_ms"],
             device_busy_share=prof["device_busy_share"],
             groups_us=prof["groups_us"], losses=losses,
             test_acc=[r["test_acc"] for r in epochs],
             epoch_ms_each=[r["ms"] for r in epochs])
        return {k: sum(r["launches"].get(k, 0) for r in epochs)
                for k in DGCN_LAUNCHES}
    finally:
        multihost.shutdown()
        shutil.rmtree(store, ignore_errors=True)


def sampled_phase(ht, gnn_sampled, counted, dev):
    """The sampled-subgraph GCN (SAMPLED_* above): the first step against
    kernels="off" on one batch, then gnn_sampled.main at its defaults,
    each step's launch counts zeroed just before it and read just after;
    returns the launches of the main run."""
    import tempfile
    from hetu_tpu_torch.dataloader import GNNDataLoaderOp
    from hetu_tpu_torch.examples import bert_forward
    args = gnn_sampled.parse_args([])
    adj, labels = gnn_sampled.make_graph(args.nodes, args.classes,
                                         args.degree)
    batch = gnn_sampled.SubgraphSampler(adj, labels, args.nseed, args.nmax,
                                        args.fanout, seed=100).next()
    rows = np.random.RandomState(0).normal(
        0.0, 0.1, (args.nmax, args.hidden)).astype(np.float32)
    first, keep = {}, None
    for kernels in (None, "off"):
        loader = GNNDataLoaderOp(lambda _graph: batch["adj"])
        try:
            ex, (x, y_), _ = gnn_sampled.build(
                args, loader, gnn_sampled.device_ctx(dev.type == "cpu"), 0,
                kernels)
            GNNDataLoaderOp.step(None)
            GNNDataLoaderOp.step(None)
            feed = {x: rows, y_: batch["y"]}
            before = [ex.state["params"][id(n)].clone()
                      for n in ex.param_nodes]
            out, counts = counted(lambda: [r.handle.clone() for r in ex.run(
                "train", feed_dict=feed)[:3]])
            after = [ex.state["params"][id(n)].clone()
                     for n in ex.param_nodes]
            first[kernels] = (before, out, counts, after)
            if kernels is None:
                # the device time of a step, on the card alone (no PS)
                _, _, host_ms, event_ms = _steps(ex, "train", counted, 20,
                                                 feed)
                with tempfile.TemporaryDirectory() as d:
                    prof = bert_forward.profile(
                        lambda: ex.run("train", feed_dict=feed), host_ms, 5,
                        os.path.join(d, "sampled.txt"))
                keep = dict(step_ms=host_ms, step_event_ms=event_ms,
                            device_ms=prof["device_ms"],
                            device_busy_share=prof["device_busy_share"],
                            groups_us=prof["groups_us"])
            ex.close()
        finally:
            loader.close()
    (b_k, out_k, c_k, a_k), (b_o, out_o, c_o, a_o) = first[None], first["off"]
    check(c_k == SAMPLED_LAUNCHES and c_o == {},
          f"the sampled GCN's first step launched {c_k}, under "
          f"kernels='off' {c_o}; expected {SAMPLED_LAUNCHES}")
    check(all(torch.equal(p, q) for p, q in zip(b_k, b_o)),
          "the two executors start from different weights")
    check(all(torch.equal(p, q) for p, q in zip(out_k, out_o)),
          "the sampled GCN's first step (loss, the rows' gradient, the "
          "prediction) differs from kernels='off'")
    for p, q in zip(a_k, a_o):
        torch.testing.assert_close(p, q, **TOL["fused_adam"])
    weights_bit_equal = all(torch.equal(p, q) for p, q in zip(a_k, a_o))

    stats = {}
    t0 = time.perf_counter()
    history = gnn_sampled.main([], stats=stats)
    run_s = time.perf_counter() - t0
    losses = [h[0] for h in history]
    check(all(c == SAMPLED_LAUNCHES for c in stats["launches"]),
          f"sampled GCN steps launched {stats['launches']}, expected "
          f"{SAMPLED_LAUNCHES} each")
    check(np.isfinite(stats["losses"]).all() and losses[-1] < losses[0],
          f"the sampled GCN's epoch loss {losses[0]} -> {losses[-1]} did "
          "not fall")
    n = len(stats["ms"])
    emit("gcn_sampled", nodes=args.nodes, nseed=args.nseed, nmax=args.nmax,
         hidden=args.hidden, epochs=args.num_epoch, steps=n,
         cache=args.cache_policy, bound=args.bound, run_s=run_s,
         first_step_vs_off={"outputs": "bit-equal",
                            "weights_bit_equal": weights_bit_equal,
                            "tolerance": TOL["fused_adam"]},
         step_ms_main_run=float(np.mean(stats["ms"][3:])),
         step_ms_main_run_median=float(np.median(stats["ms"])),
         card_alone=keep, epoch_losses=losses,
         epoch_acc=[h[1] for h in history],
         launches_per_step=SAMPLED_LAUNCHES)
    return {"fused_adam": sum(c.get("fused_adam", 0)
                              for c in stats["launches"])}


def ncf_phase(ncf, counted, dev):
    """NCF (NCF_* above): the first step against kernels="off", one epoch
    in local mode and NCF_HYB_STEPS steps under Hybrid through ncf.run,
    each step's launch counts zeroed just before it and read just after;
    returns the launches of both runs, by path."""
    import tempfile
    from hetu_tpu_torch.examples import bert_forward
    from hetu_tpu_torch.ps import local_cluster as lc
    t0 = time.perf_counter()
    data = ncf.getdata(**ncf.ML1M, n_pos=NCF_POS)
    data_s = time.perf_counter() - t0
    k = ncf.Trainer(dev, data, NCF_BATCH, **NCF_MODEL)
    o = ncf.Trainer(dev, data, NCF_BATCH, kernels="off", **NCF_MODEL)
    for n_k, n_o in zip(k.ex.param_nodes, o.ex.param_nodes):
        check(torch.equal(k.param(n_k), o.param(n_o)),
              f"initial {n_k.name} differs between the two executors")
    out_k, c_k = counted(k.step)
    out_o, c_o = counted(o.step)
    check(c_k == NCF_LAUNCHES and c_o == {}, f"NCF's first step launched "
          f"{c_k}, under kernels='off' {c_o}; expected {NCF_LAUNCHES}")
    loss_rel = rel_l2(out_k[0], out_o[0])
    state_rel, worst = _param_rel(k.ex, o.ex)
    check(loss_rel <= NCF_REL and state_rel <= NCF_REL,
          f"NCF's first step against kernels='off': loss rel {loss_rel}, "
          f"{worst} rel L2 {state_rel}")
    emit("ncf_first_step", loss_rel=loss_rel, state_rel_l2=state_rel,
         worst=worst, bit_equal=bool(torch.equal(out_k[0], out_o[0])) and
         state_rel == 0.0, tolerance=NCF_REL, launches=c_k)
    del k, o

    tr = ncf.Trainer(dev, data, NCF_BATCH, **NCF_MODEL)
    local = next(ncf.run(dev, trainer=tr))
    losses = np.array(local["losses"])
    check(local["launches_same_every_step"]
          and local["launches_per_step"] == NCF_LAUNCHES,
          f"NCF local steps launched {local['launches_per_step']}, "
          f"expected {NCF_LAUNCHES} each")
    check(np.isfinite(losses).all() and losses[-NCF_WINDOW:].mean()
          < losses[:NCF_WINDOW].mean(), "NCF's local loss did not fall: "
          f"{losses[:NCF_WINDOW].mean()} -> {losses[-NCF_WINDOW:].mean()}")
    with tempfile.TemporaryDirectory() as d:
        prof = bert_forward.profile(tr.step, local["ms_per_step"], 5,
                                    os.path.join(d, "ncf.txt"))
    emit("ncf_local", **tr.shape, n_pos=NCF_POS, getdata_s=data_s,
         steps=local["steps"], **NCF_MODEL, step_ms=local["ms_per_step"],
         device_ms=prof["device_ms"],
         device_busy_share=prof["device_busy_share"],
         groups_us=prof["groups_us"], first_loss=float(losses[0]),
         last_loss=float(losses[-1]),
         mean_first=float(losses[:NCF_WINDOW].mean()),
         mean_last=float(losses[-NCF_WINDOW:].mean()), acc=local["acc"],
         launches_per_step=local["launches_per_step"])
    del tr

    with lc.local_cluster(n_servers=1):
        t0 = time.perf_counter()
        hyb = ncf.Trainer(dev, data, NCF_BATCH, comm_mode="Hybrid",
                          **NCF_MODEL)
        init_s = time.perf_counter() - t0
        on_card = sorted(n.name for n in hyb.ex.param_nodes)
        check(on_card == ["W1", "W2", "W3", "W_out"],
              f"under Hybrid the card holds {on_card}")
        res = next(ncf.run(dev, steps=NCF_HYB_STEPS, trainer=hyb))
        hyb.ex.close()
    h_losses = np.array(res["losses"])
    check(res["launches_same_every_step"]
          and res["launches_per_step"] == NCF_HYB_LAUNCHES,
          f"NCF Hybrid steps launched {res['launches_per_step']}, expected "
          f"{NCF_HYB_LAUNCHES} each")
    check(np.isfinite(h_losses).all() and h_losses[-NCF_WINDOW:].mean()
          < h_losses[:NCF_WINDOW].mean(), "NCF's Hybrid loss did not fall")
    emit("ncf_hybrid", servers=1, steps=NCF_HYB_STEPS, init_s=init_s,
         step_ms=res["ms_per_step"], first_loss=float(h_losses[0]),
         last_loss=float(h_losses[-1]),
         mean_first=float(h_losses[:NCF_WINDOW].mean()),
         mean_last=float(h_losses[-NCF_WINDOW:].mean()),
         ps={k: res["ps"][k] for k in ("pre_step_s", "post_step_s",
                                       "sync_pulls", "async_pushes")},
         launches_per_step=res["launches_per_step"])
    return {"ncf_local": {k: v * local["steps"]
                          for k, v in NCF_LAUNCHES.items()},
            "ncf_hybrid": {k: v * NCF_HYB_STEPS
                           for k, v in NCF_HYB_LAUNCHES.items()}}


def gnn_phases(ht, multihost, counted, dev):
    """Sections 13-15: DistGCN, the sampled GCN and NCF; their launches by
    path."""
    from hetu_tpu_torch.examples import gnn_dist, gnn_main, gnn_sampled, ncf
    torch.cuda.empty_cache()
    out = {"distgcn": distgcn_phase(multihost, gnn_dist, gnn_main, counted,
                                    dev)}
    torch.cuda.empty_cache()
    out["gcn_sampled"] = sampled_phase(ht, gnn_sampled, counted, dev)
    out.update(ncf_phase(ncf, counted, dev))
    return out


def kernels_line(kern, attn, ces, attn_bwd, ce_bwd, spmm, spmv, embed,
                 quant, launches, by_path):
    """The ``kernels`` JSON object: one entry per ported kernel; its
    ``launches`` sum the main paths' runs, ``launches_by_path`` splits
    them where the zoo's paths (sections 10-11) add to them."""
    replaces = {"fused_sgd": "hetu_tpu/kernels/fused_opt.py:164",
                "fused_adam": "hetu_tpu/kernels/fused_opt.py:95",
                "flash_attention_fwd": "hetu_tpu/kernels/flash_attention.py:111",
                "fused_linear_nll_fwd": "hetu_tpu/kernels/fused_ce.py:223",
                "flash_attention_bwd": "hetu_tpu/kernels/flash_attention.py:240",
                "fused_linear_nll_bwd": "hetu_tpu/kernels/fused_ce.py:252",
                "csr_spmm": "hetu_tpu/kernels/csr_spmm.py:78",
                "csr_spmv": "hetu_tpu/kernels/csr_spmm.py:142",
                "fused_embed_grad": "hetu_tpu/kernels/embed_grad.py:108",
                "quant_blocks": "hetu_tpu/kernels/quant_comm.py:73",
                "dequant_blocks": "hetu_tpu/kernels/quant_comm.py:116"}
    sources = {"fused_sgd": "fused_opt.cu", "fused_adam": "fused_opt.cu",
               "flash_attention_fwd": "flash_attention.cu",
               "fused_linear_nll_fwd": "fused_ce.cu",
               "flash_attention_bwd": "flash_attention.cu",
               "fused_linear_nll_bwd": "fused_ce.cu",
               "csr_spmm": "csr_spmm.cu", "csr_spmv": "csr_spmm.cu",
               "fused_embed_grad": "embed_grad.cu",
               "quant_blocks": "quant_comm.cu",
               "dequant_blocks": "quant_comm.cu"}
    # the BERT kernels' entries are timed at the main path's shapes (their
    # first cases), and also at BERT-base's phase-2 shapes (S = 512; 32 x 76
    # MLM rows); max_abs_err is the largest over all their cases
    kern = dict(kern)
    kern["flash_attention_fwd"] = dict(attn[0], max_abs_err=max(
        max(c["o_max_abs_err"], c["lse_max_abs_err"]) for c in attn),
        phase2=_timed(attn[1]))
    kern["fused_linear_nll_fwd"] = dict(ces[0], max_abs_err=max(
        c["max_abs_err"] for c in ces), phase2=_timed(ces[2]))
    kern["flash_attention_bwd"] = dict(attn_bwd[0], max_abs_err=max(
        c["max_abs_err"] for c in attn_bwd), phase2=_timed(attn_bwd[1]))
    kern["fused_linear_nll_bwd"] = dict(ce_bwd[0], max_abs_err=max(
        c["max_abs_err"] for c in ce_bwd), phase2=_timed(ce_bwd[2]))
    # csr_spmm at layer 2's forward (F = 256); epoch_ms sums the three
    # shapes an epoch launches
    kern["csr_spmm"] = dict(spmm[1], max_abs_err=max(
        c["max_abs_err"] for c in spmm), epoch_ms=sum(c["ms"] for c in spmm))
    kern["csr_spmv"] = spmv[0]
    # fused_embed_grad at WDL-Criteo's step, the first case, and at
    # BERT-base's two phase-2 lookups
    kern["fused_embed_grad"] = dict(embed[0], max_abs_err=max(
        c["max_abs_err"] for c in embed), phase2={
            c["case"]: _timed(c) for c in embed if c["form"] == "dense"})
    # the quantized all-reduce's legs at one int8 step of the DP MLP (fp8
    # in the quant_comm_checked line); bit-equal at every case, so 0
    for k in ("quant_blocks", "dequant_blocks"):
        kern[k] = dict(quant[k]["int8"], max_abs_err=0.0)
    return {"kernels": [dict(
        name=k, route="cuda", source="hetu_tpu_torch/csrc/" + sources[k],
        replaces=replaces[k], launches=launches[k],
        **({"launches_by_path": by_path[k]} if len(by_path.get(k, {})) > 1
           else {}),
        max_abs_err=v["max_abs_err"], tolerance=TOL[k], ms=v["ms"],
        plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
        bound_by=v["bound"][1], library_ms=v["library_ms"],
        **{f: v[f] for f in ("launched_ms", "step_launched_ms",
                             "plain_launched_ms", "library_launched_ms",
                             "library_timing", "shape", "epoch_ms", "phase2",
                             "plan", "large")
           if f in v},
        **({"gather_bound_ms": v["gather_bound"][0]}
           if "gather_bound" in v else {}))
        for k, v in kern.items()]}


def _timed(case):
    """A case's shape, times and bound, for the kernels line."""
    return {"shape": case["shape"], "bound_ms": case["bound"][0],
            **{f: case[f] for f in ("ms", "launched_ms", "plain_ms",
                                    "library_ms")}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bert-kernels", action="store_true",
                    help="stop after the BERT path's kernel checks")
    ap.add_argument("--csr-kernels", action="store_true",
                    help="build, check the CSR kernels on the GCN's "
                         "adjacency, and stop")
    ap.add_argument("--opt-kernels", action="store_true",
                    help="build, check and time the optimizer kernels, "
                         "and stop")
    ap.add_argument("--quant-kernels", action="store_true",
                    help="build, check and time the quantized "
                         "all-reduce's kernels, and stop")
    ap.add_argument("--embed-kernels", action="store_true",
                    help="build, check and time the embedding gradient's "
                         "kernel, and stop")
    ap.add_argument("--zoo", action="store_true",
                    help="build, train ResNet-18 and the graph-API LM "
                         "(sections 10-11), and stop")
    ap.add_argument("--ps", action="store_true",
                    help="build, train WDL-Criteo under Hybrid against a "
                         "local PS cluster (section 12), and stop")
    ap.add_argument("--gnn", action="store_true",
                    help="build, train DistGCN, the sampled GCN and NCF "
                         "(sections 13-15), and stop")
    args = ap.parse_args(argv)
    import hetu_tpu_torch as ht
    from hetu_tpu_torch import comm_quant
    from hetu_tpu_torch.examples import (bert_forward, bert_pretrain,
                                         cnn_main, ctr_main, gnn_main,
                                         hetu_transformer)
    from hetu_tpu_torch.kernels import (_build, csr_spmm, embed_grad,
                                        flash_attention, fused_ce, fused_opt,
                                        quant_comm, registry)
    from hetu_tpu_torch.parallel import multihost
    from hetu_tpu_torch.models import bert, transformer

    # -- 1. device --------------------------------------------------------
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    bw, f32, bf16 = card_peaks(name)
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[os.path.relpath(p) for p in libs.values()])
    if args.quant_kernels:
        emit_quant(*quant_phase(quant_comm, comm_quant, registry, dev, bw,
                                f32))
        return 0
    if args.embed_kernels:
        data = ctr_main.load_data("wdl_criteo", CTR_VOCAB)
        first_ids = torch.from_numpy(data[0][1][:CTR_BATCH]).to(dev)
        emit("fused_embed_grad_checked", tolerance=TOL["fused_embed_grad"],
             cases=embed_grad_phase(embed_grad, registry, first_ids,
                                    phase2_batch(bert, bert_forward, dev),
                                    dev, bw, f32))
        return 0
    if args.zoo:
        resnet_phase(ht, cnn_main, fused_opt, bert_forward.counted,
                     cnn_main.load_dataset("CIFAR10"))
        lm_phase(ht, hetu_transformer, fused_opt, bert_forward.counted)
        return 0
    if args.ps:
        hybrid_phase(ht, ctr_main, embed_grad, registry,
                     bert_forward.counted, dev)
        return 0
    if args.gnn:
        gnn_phases(ht, multihost, bert_forward.counted, dev)
        return 0
    if args.csr_kernels:
        tr = gnn_main.Trainer(dev, "gcn", "arxiv", lr=GCN_LR)
        spmm, spmv = csr_phase(csr_spmm, registry, tr.adj, dev, bw, f32)
        emit("csr_spmm_checked", tolerance=TOL["csr_spmm"],
             cases=spmm + spmv)
        return 0
    if not args.opt_kernels:
        tensor_core_phase(_build)

    # -- 3. kernels against their plain versions ---------------------------
    kern, opt_cases = kernel_phase(fused_opt, registry, dev, bw, f32)
    emit("kernels_checked", cases=opt_cases,
         tolerance={k: TOL[k] for k in kern}, rerun_bit_equal=True,
         max_tensors=fused_opt.MAX_TENSORS, **kern)
    if args.opt_kernels:
        return 0
    attn = attention_phase(flash_attention, dev, bw, f32, bf16)
    emit("flash_attention_checked", tolerance=TOL["flash_attention_fwd"],
         cases=attn)
    ces = ce_phase(fused_ce, dev, bw, bf16)
    emit("fused_linear_nll_checked", tolerance=TOL["fused_linear_nll_fwd"],
         cases=ces)
    attn_bwd = attention_bwd_phase(flash_attention, dev, bw, f32, bf16)
    emit("flash_attention_bwd_checked", tolerance=TOL["flash_attention_bwd"],
         cases=attn_bwd)
    ce_bwd = ce_bwd_phase(fused_ce, dev, bw, bf16)
    emit("fused_linear_nll_bwd_checked",
         tolerance=TOL["fused_linear_nll_bwd"], cases=ce_bwd)
    if args.bert_kernels:
        return 0

    # -- 4. train the full-width MLP through the executor ------------------
    data = cnn_main.load_dataset("CIFAR10")
    n_params = sum(int(np.prod(s)) for s in MLP_SHAPES)
    launches, local = {}, {}
    for opt, lr, steps, loss_max in (("sgd", SGD_LR, SGD_STEPS, SGD_LOSS_MAX),
                                     ("adam", ADAM_LR, ADAM_STEPS, ADAM_LOSS_MAX)):
        kname = "fused_sgd" if opt == "sgd" else "fused_adam"
        registry.reset_launch_counts()
        losses, step_ms, val, _ = train(ht, cnn_main, data, opt, lr, steps,
                                     validate=True)
        counts = registry.launch_counts()
        launches[kname] = counts[kname]
        local[opt] = (losses, step_ms)
        check(np.all(np.isfinite(losses)), f"{opt}: non-finite loss")
        last = float(np.mean(losses[-10:]))
        check(last < loss_max, f"{opt}: mean loss of the last 10 steps "
              f"{last} is not below {loss_max}")
        check(counts[kname] == steps,
              f"{opt}: {kname} launched {counts[kname]} times in {steps} "
              f"steps, expected one a step")
        check(sum(counts.values()) == counts[kname],
              f"{opt}: unexpected launches {counts}")
        off, _, _, _ = train(ht, cnn_main, data, opt, lr, 5, kernels="off")
        check(registry.launch_counts()[kname] == counts[kname],
              "kernels='off' launched a kernel")
        np.testing.assert_allclose(losses[:5], off, rtol=1e-5)
        emit("train", opt=opt, lr=lr, steps=steps, batch=BATCH,
             params=n_params, step_ms=step_ms,
             samples_per_s=BATCH / step_ms * 1e3, first_loss=float(losses[0]),
             last_loss=float(losses[-1]), mean_last10=last, validate=val,
             launches=counts, first5_vs_off_max_rel=float(
                 np.max(np.abs(losses[:5] - off) / np.abs(off))))

    # -- 5. the port on the card against the port on the CPU, small input ---
    small = (data[0][:1024, :64], data[1][:1024], data[2][:256, :64],
             data[3][:256], 64, 10)
    for opt, lr in (("sgd", SGD_LR), ("adam", ADAM_LR)):
        gpu_l, _, _, _ = train(ht, cnn_main, small, opt, lr, 8)
        cpu_l, _, _, _ = train(ht, cnn_main, small, opt, lr, 8,
                               ctx=ht.cpu(0))
        # matmul sums run in another order on the card than on the CPU
        np.testing.assert_allclose(gpu_l, cpu_l, rtol=1e-4)
        emit("parity_cpu", opt=opt, steps=8,
             max_rel=float(np.max(np.abs(gpu_l - cpu_l) / np.abs(cpu_l))))

    # -- 5b. the quantized all-reduce's kernels; data-parallel training ----
    quant_cases, quant, quant_bert = quant_phase(quant_comm, comm_quant,
                                                 registry, dev, bw, f32)
    emit_quant(quant_cases, quant, quant_bert)
    launches.update(dp_phase(ht, cnn_main, comm_quant, multihost, registry,
                             data, dev, local))

    # -- 6. the BERT-base forward ------------------------------------------
    forward_launches = bert_phase(bert, bert_forward, registry, dev)
    check(set(forward_launches) == {"flash_attention_fwd",
                                    "fused_linear_nll_fwd"},
          f"the forward launched {forward_launches}")

    # -- 7. BERT-base pretraining and fine-tuning ---------------------------
    launches.update(bert_train_phase(bert, transformer, bert_forward,
                                     bert_pretrain, registry, dev))

    # -- 8. the GCN on an arxiv-sized graph, and csrmv_op ------------------
    spmm, spmv, csr_launches = gcn_phase(ht, gnn_main, csr_spmm, registry,
                                         bert_forward.counted, dev, bw, f32)
    launches.update(csr_launches)

    # -- 9. WDL-Criteo at the full Criteo vocabulary -----------------------
    torch.cuda.empty_cache()
    embed, ctr_launches = ctr_phase(
        ht, ctr_main, embed_grad, registry, bert_forward.counted,
        phase2_batch(bert, bert_forward, dev), dev, bw, f32)
    launches.update(ctr_launches)

    # -- 10. ResNet-18 at full width (the CNN zoo) --------------------------
    # -- 11. the graph-API transformer LM ------------------------------------
    # their launches add to the kernels' counts; by_path keeps them apart
    by_path = {k: {"earlier phases": v} for k, v in launches.items()}
    torch.cuda.empty_cache()
    for path, got in (("resnet18", resnet_phase(
            ht, cnn_main, fused_opt, bert_forward.counted, data)),
                      ("transformer_lm", lm_phase(
            ht, hetu_transformer, fused_opt, bert_forward.counted))):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
            by_path.setdefault(k, {})[path] = v

    # -- 12. WDL-Criteo under Hybrid, against a local PS cluster -----------
    torch.cuda.empty_cache()
    hybrid, rows_route = hybrid_phase(ht, ctr_main, embed_grad, registry,
                                      bert_forward.counted, dev)
    for path, got in (("ctr_hybrid", hybrid), ("ps_rows_route", rows_route)):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
            by_path.setdefault(k, {})[path] = v

    # -- 13. DistGCN on a 1 x 1 grid; 14. the sampled GCN; 15. NCF --------
    for path, got in gnn_phases(ht, multihost, bert_forward.counted,
                                dev).items():
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
            by_path.setdefault(k, {})[path] = v

    print(json.dumps(kernels_line(kern, attn, ces, attn_bwd, ce_bwd, spmm,
                                  spmv, embed, quant, launches, by_path)),
          flush=True)
    print(json.dumps({"phase": "done",
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
