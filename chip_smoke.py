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
Hybrid; then runs the BERT trainer (``examples/train_hetu_bert.py``) at
BERT-base widths on its corpus, checkpointed every epoch and resumed, the
resumed run held bit for bit against an uninterrupted one; decodes at
GPT-2 small widths (``models/generate.py``: greedy, sampling, beam, EOS,
ragged, speculative, each held to its gate); trains GPT-2 small with
dropout, remat on and off bit-equal; and runs the graph-API LM's trainer
and the generation demo; then (slice 5c) checks the attention, fused-CE
and embedding-gradient kernels at the shapes of TinyLlama-1.1B, the MoE
LM and the GPT-2 pipeline, imports
TinyLlama-1.1B at its published widths through ``models/hf_llama.py``
from a stand-in checkpoint drawn under HF's names (no transformers on the
card), exports it back bit for bit, decodes it greedily and trains it 5
steps at 2 x 2048 with remat; trains the switch-MoE LM at GPT-2 small
widths with 8 experts; imports ViT-B/16 through ``hf_vit`` (its logits
against the CPU's) and trains it; fine-tunes BERT-base imported through
``hf_bert`` by ``examples/finetune_hf_bert.py``'s legs; and runs
``examples/gpt2_pipeline.py``'s legs at GPT-2 small widths. Each path is
checked to have gone through its kernels.

    python3 chip_smoke.py
    python3 chip_smoke.py --bert-kernels   # sections 1-3 only: a minute
    python3 chip_smoke.py --csr-kernels    # build, the CSR kernels only
    python3 chip_smoke.py --opt-kernels    # build, the optimizer kernels only
    python3 chip_smoke.py --quant-kernels  # build, the quantize kernels only
    python3 chip_smoke.py --embed-kernels  # build, the embedding gradient only
    python3 chip_smoke.py --zoo            # build, ResNet-18 and the LM only
    python3 chip_smoke.py --ps             # build, the Hybrid phase only
    python3 chip_smoke.py --gnn            # build, DistGCN, sampled GCN, NCF
    python3 chip_smoke.py --nlp            # build, sections 16-20
    python3 chip_smoke.py --hf             # build, sections 21-25

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
sampled-GCN and NCF phases (sections 13-15) alone; ``--nlp`` the BERT
trainer, decoding, dropout, LM-trainer and demo phases (sections 16-20)
alone; ``--hf`` the kernels at slice 5c's shapes and the TinyLlama, MoE,
ViT, HF BERT and GPT-2 pipeline phases (sections 21-25) alone.
"""
import argparse
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# phase-2 BERT-base layer (S = 512), a long causal sequence, a small f32
# case also held against the unfused softmax(q k^T) v in f32, and GPT-2
# small's causal layer at T = 128 (the dropout path, section 18).
ATTN_CASES = [(32, 12, 128, 64, torch.bfloat16, False, True),
              (32, 12, 512, 64, torch.bfloat16, False, True),
              (8, 12, 512, 64, torch.bfloat16, True, False),
              (2, 4, 256, 128, torch.float32, True, True),
              (8, 12, 128, 64, torch.bfloat16, True, False)]
# Fused linear+CE checks (N, V, D, layout, dtype): BERT-base's MLM loss (32
# rows x 20 slots against the tied (V, D) embedding, with the MLM bias; the
# main path's shape), a GPT-2 LM head ((D, V), N ragged against 128),
# BERT-base's phase-2 MLM shape (32 rows x 76 slots), the BERT trainer's
# (16 x 5 slots against its 65-entry vocabulary: one partial tile,
# section 16), GPT-2 small's tied head at 8 x 128 rows (section 18), and
# generate_hetu's trainer in f32 (64 x 16 rows, an untied (D, V) head at
# V = 256, D = 128; section 20).
CE_CASES = [(640, 30522, 768, "vd", torch.bfloat16),
            (1000, 50257, 768, "dv", torch.bfloat16),
            (2432, 30522, 768, "vd", torch.bfloat16),
            (80, 65, 768, "vd", torch.bfloat16),
            (1024, 50257, 768, "vd", torch.bfloat16),
            (1024, 256, 128, "dv", torch.float32)]
# The backward at the same shapes, and at the MLM shape in f32, where no
# output rounding hides dh's softmax term (~1e-4 of its onehot term, below
# a bf16 rounding).
CE_BWD_CASES = CE_CASES + [(640, 30522, 768, "vd", torch.float32)]
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

# The BERT trainer (examples/train_hetu_bert.py; section 16) at BERT-base
# widths on its built-in corpus (a vocabulary of 65, 47 instances: 2 steps
# an epoch at batch 16), sequences of 128 so flash attention runs, remat
# off, bf16: BERT_TRAINER_EPOCHS epochs with a checkpoint every epoch, then
# resumed to twice that (a checkpoint at the end); an uninterrupted run of as many epochs (no
# checkpoint, its state held in memory) must end with the same parameters
# and optimizer state, bit for bit (every kernel of the step is
# rerun-equal and reduces in a fixed order), and so must the last
# checkpoint read back. Per step 12
# flash_attention_fwd and 12 _bwd, 1 fused_linear_nll_fwd and 1 _bwd (80
# MLM rows against the 65-entry vocabulary), 2 fused_embed_grad (token and
# type). The first step's gradients against kernels="off" as BERT-base
# pretraining's (bert_grad_gate: f32 within GRAD_REL, bf16 within
# BF16_EXCESS of the plain versions' distance from f32).
BERT_TRAINER_FLAGS = ["--d-model", "768", "--n-heads", "12", "--n-layers",
                      "12", "--d-ff", "3072", "--max-seq-length", "128",
                      "--batch-size", "16"]
BERT_TRAINER_EPOCHS = 3
BERT_TRAINER_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
                         "fused_linear_nll_fwd": 1, "fused_linear_nll_bwd": 1,
                         "fused_embed_grad": 2}
# Generation (models/generate.py; section 17) at the published GPT-2 small
# widths (the fields hf_gpt2 maps from a GPT2Config: vocabulary 50,257,
# 1,024 positions, d 768, 12 layers and heads, FF 3,072, projection biases,
# a tied head, tanh gelu, eps 1e-5), weights drawn from seed 0: DECODE_B
# prompts of DECODE_P seeded ids decoded to DECODE_LEN. Gates: greedy's
# per-position logits against tfm.forward over the produced sequence, by
# relative L2 within DECODE_REL_BF16 in bf16 (both sides round at the same
# places; cuBLAS sums a one-row product in another order than a 192-row
# one, and the difference crosses 12 layers) and DECODE_REL_F32 in f32;
# in f32, where seeded weights make exact logit ties vanishingly rare,
# tokens equal between the chunked and the tokenwise prefill, beam K = 1
# and greedy, the EOS loop and greedy up to its stop, each ragged row and
# its solo decode, speculative decoding (the target's first SPEC_LAYERS
# layers as the draft, SPEC_K proposals a round) and plain greedy; top-k
# sampling's tokens within the top k; beam K = 4's scores sorted.
# Speculative decoding is reported by its rounds and tokens a round, which
# are deterministic, and not timed: at B = 1 both it and plain greedy are
# bound by the host's Python loop, and single timings of the two came out
# in either order from run to run.
GPT2_SMALL = dict(vocab_size=50257, max_seq_len=1024, d_model=768,
                  n_layers=12, n_heads=12, d_ff=3072, attn_proj_bias=True,
                  tied_head=True, gelu_exact=False, ln_eps=1e-5)
DECODE_B, DECODE_P, DECODE_LEN, DECODE_TOPK, DECODE_BEAM = 8, 64, 192, 40, 4
DECODE_PROFILED = 16
DECODE_REL_BF16, DECODE_REL_F32 = 2e-2, 1e-4
DECODE_RAGGED = [64, 17, 40, 1, 33, 64, 50, 8]
SPEC_LAYERS, SPEC_K = 2, 4
# Training-time dropout (section 18) at GPT-2 small widths, rate 0.1, on
# DROP_B sequences of 128 (flash attention), bf16, AdamW at DROP_LR: the
# first step's gradients with remat equal those without, bit for bit, at
# one key (the recompute draws each mask again from its seed); a mask's
# dropped share within DROP_SHARE_TOL of the rate; DROP_STEPS steps give
# finite losses, the last below the first. Before them the first step's
# loss and gradients against kernels="off" at the same key (the same
# masks), under the gates of BERT-base pretraining's (GRAD_REL above: f32
# per tensor, bf16 against the plain versions' distance from f32). Per step with remat 24
# flash_attention_fwd (the forward and the recompute), 12 _bwd, 1
# fused_linear_nll_fwd and 1 _bwd (the tied head), 1 fused_embed_grad.
DROP_B, DROP_T, DROP_RATE, DROP_LR, DROP_STEPS = 8, 128, 0.1, 3e-4, 5
DROP_SHARE_TOL = 5e-3
DROP_LAUNCHES = {"flash_attention_fwd": 24, "flash_attention_bwd": 12,
                 "fused_linear_nll_fwd": 1, "fused_linear_nll_bwd": 1,
                 "fused_embed_grad": 1}
# The graph-API LM's trainer (examples/train_hetu_transformer.py; section
# 19) at its defaults for LM_TRAINER_STEPS steps: per step 1 fused_adam
# and 2 fused_embed_grad (tokens and positions); finite losses. Its first
# step (dropout 0.1 on both sides: the masks come from the executor's
# seed, step and node) against kernels="off": the loss and each parameter
# within rel (L2) LM_REL.
LM_TRAINER_STEPS = 30
LM_TRAINER_LAUNCHES = {"fused_adam": 1, "fused_embed_grad": 2}
# The generation demo (examples/generate_hetu.py; section 20) at --steps 60
# --beam 2 --max-len 12: its trainer (f32, sequences of 16: the dot path)
# launches per step 1 fused_linear_nll_fwd and 1 _bwd (the untied (D, V)
# head at V = 256) and 1 fused_embed_grad; decoding launches none. The
# final loss below 3.0, as tests/test_nlp.py holds the reference's. Its
# trainer's first step (seed 0, the first 64 sequences) against
# kernels="off": f32 only, each gradient within GRAD_REL.
DEMO_ARGS = ["--steps", "60", "--beam", "2", "--max-len", "12"]
DEMO_LOSS_MAX = 3.0
DEMO_LAUNCHES = {"fused_linear_nll_fwd": 1, "fused_linear_nll_bwd": 1,
                 "fused_embed_grad": 1}

# Slice 5c (sections 21-25): the HuggingFace family, the switch MoE, ViT.
# No checkpoint file is in the repository and the card's host has no
# transformers: each section draws its weights under HF's names and
# layouts from a seed (examples/hf_standins.py, the published config.json
# widths) and imports them through the port's hf_* importer from a
# stand-in holding a config and a state_dict().
# TinyLlama-1.1B (section 21, slice 5c's main path; hf_standins.TINYLLAMA:
# hidden 2048, 22 layers, 32 heads over 4 KV heads of 64, intermediate
# 5632, vocabulary 32,000, 2,048 positions, RMSNorm eps 1e-5, rope theta
# 10,000, an untied head; 1.10 B parameters): (a) state_dict_from_params
# gives the stand-in's tensors back bit for bit; (b) greedy decode of
# LLAMA_DECODE_B prompts of LLAMA_PROMPT seeded ids to LLAMA_NEW more
# tokens, held to section 17's gates (the logits against tfm.forward over
# the produced sequence by rel L2: in f32 within DECODE_REL_F32; in bf16
# within DECODE_REL_BF16, or within BF16_EXCESS times the bf16 forward's
# own distance from the f32 forward where that is larger: 22 layers of
# bf16 rounding take the decode 1.9 % from the forward on an H100, near
# DECODE_REL_BF16; decoding launches no kernel) and timed in bf16 as
# section 17 times its decode; (c) LLAMA_STEPS
# AdamW steps at lr LLAMA_LR in bf16 with remat at LLAMA_B x LLAMA_T
# (TinyLlama's pretraining context), the first step's gradients against
# kernels="off" by grad_gate (f32 and bf16): in bf16 its 22 layers over
# 4,096 tokens move the plain versions' gradients about 4.3 % (rel L2)
# from the f32 ones on an H100, and the kernels' as far (PERF.md), so the
# two are held together within BF16_EXCESS times the plain versions'
# distance (``deep``) where BERT-base's are held within GRAD_REL. Per
# step: 44
# flash_attention_fwd (causal over the 32 heads the 4 KV heads expand to;
# the forward and the recompute), 22 _bwd, 1 fused_linear_nll_fwd and 1
# _bwd (the untied (D, V) head) and 1 fused_embed_grad (the tokens). The
# kernels at this path's shapes (HF_*_CASES) against their plain versions
# under the gates above: causal attention at (2, 32, 2048, 64), the head at
# 4,096 rows x 32,000 x 2,048 (D, V), the token gradient into the
# 32,000 x 2,048 table from 4,096 ids.
LLAMA_DECODE_B, LLAMA_PROMPT, LLAMA_NEW = 8, 128, 64
LLAMA_B, LLAMA_T, LLAMA_STEPS, LLAMA_LR = 2, 2048, 5, 4e-4
LLAMA_LAUNCHES = {"flash_attention_fwd": 44, "flash_attention_bwd": 22,
                  "fused_linear_nll_fwd": 1, "fused_linear_nll_bwd": 1,
                  "fused_embed_grad": 1}
# The switch-MoE LM (section 22) at GPT-2 small's widths (GPT2_SMALL) with
# Switch-Base-8's expert count: MOE_E experts, capacity factor MOE_CAP
# (capacity int(1.25 x 8,192 / 8) = 1,280 tokens an expert), the dense
# (S, E, cap) dispatch and combine of the reference; MOE_STEPS AdamW steps
# at lr MOE_LR in bf16 with remat at MOE_B x MOE_T. Per step the kernels of
# section 18 (MOE_LAUNCHES; the MoE's products are PyTorch's). The first
# step's gradients against kernels="off" by grad_gate in f32 only: the
# router's argmax is discontinuous, and the two sides' bf16 roundings
# differ by about 2e-3, enough to send a token with a close top two to
# the other expert (and to shift the capacity slots after it), where f32's
# 1e-7 almost never does. In bf16, the path's dtype (the kernels'
# tensor-core forms), the first step's loss within BERT_REL of
# kernels="off" (a few rerouted tokens move it little), its gradients'
# distance reported. The dropped-token share of each layer and the aux
# loss of one bf16 forward are reported.
MOE_E, MOE_CAP, MOE_B, MOE_T, MOE_STEPS, MOE_LR = 8, 1.25, 8, 1024, 5, 3e-4
MOE_LAUNCHES = DROP_LAUNCHES
# ViT-B/16 (section 23; hf_standins.VIT_B16 = models/vit.py's VIT_BASE
# with a 1,000-class head): imported from a ViTForImageClassification
# stand-in; classify_logits on VIT_IMAGES seeded images in f32 against the
# port's own forward of the same weights on the CPU, rel L2 within VIT_REL
# (f32 sums in another order); VIT_STEPS steps of make_train_step at batch
# VIT_B (f32, the config's dtype). T = 197 is not a multiple of 128, so
# "auto" takes the dot form: no kernel launches on this path, as on the
# reference off the TPU (the sequence is not padded to reach a kernel).
VIT_IMAGES, VIT_B, VIT_STEPS, VIT_LR, VIT_REL = 8, 32, 5, 1e-4, 1e-5
# BERT-base through hf_bert (section 24; hf_standins.BERT_BASE, post-LN,
# eps 1e-12): a BertForSequenceClassification stand-in imported by
# finetune_hf_bert's legs (import_model grafts a fresh head, as the
# example does), then HFB_STEPS steps of its tune leg (make_finetune_step,
# f32 as imported, remat off) at HFB_B x HFB_T on its task with a
# key-padding mask (lengths drawn in [T/2, T]). Per step 12
# flash_attention_fwd and 12 _bwd (non-causal, the padding folded in) and
# 2 fused_embed_grad (tokens, types). The first step's gradients against
# kernels="off" by grad_gate; the tune leg's steps (finetune_hf_bert.
# tuning, one a call) timed by _timed_steps, as sections 21-23.
HFB_B, HFB_T, HFB_STEPS, HFB_LR = 32, 128, 5, 2e-5
HFB_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
                "fused_embed_grad": 2}
# gpt2_pipeline's legs (section 25) at GPT-2 small's widths, the
# vocabulary the demo tokenizer's (no GPT-2 vocab files in the
# repository): import (the head tied), the first step's gradients
# against kernels="off" by grad_gate (f32, the path's dtype), PIPE_STEPS
# tuning steps timed by _timed_steps (f32, PIPE_B x PIPE_T tokens: the dot
# form; per step 1 fused_linear_nll_fwd and 1 _bwd over the tied
# embedding, 1 fused_embed_grad), greedy, sampled and speculative
# decoding (speculative equal to greedy), and the tuned params exported by
# state_dict_from_params and imported again, bit for bit.
PIPE_STEPS, PIPE_MAX_LEN, PIPE_SPEC_K = 3, 32, 3
PIPE_B, PIPE_T, PIPE_VOCAB = 8, 32, 264
PIPE_LAUNCHES = {"fused_linear_nll_fwd": 1, "fused_linear_nll_bwd": 1,
                 "fused_embed_grad": 1}
# The kernels at the shapes of sections 21-25, held against their plain
# versions (forward and backward) under the gates of ATTN_CASES and
# CE_CASES: causal attention at TinyLlama's (2, 32, 2048, 64) and the
# MoE LM's (8, 12, 1024, 64), bf16; the fused CE at TinyLlama's untied
# head (4,096 rows x 32,000, (D, V)) and the MoE LM's tied one (8,192
# rows x 50,257, (V, D)), bf16, and at the GPT-2 pipeline's tied head in
# f32 (256 rows x the demo vocabulary's 264: a partial vocabulary tile);
# the token gradient into TinyLlama's 32,000 x 2,048 table from 4,096 ids.
HF_ATTN_CASES = [(LLAMA_B, 32, LLAMA_T, 64, torch.bfloat16, True, False),
                 (MOE_B, 12, MOE_T, 64, torch.bfloat16, True, False)]
HF_CE_CASES = [(LLAMA_B * LLAMA_T, 32000, 2048, "dv", torch.bfloat16),
               (MOE_B * MOE_T, 50257, 768, "vd", torch.bfloat16),
               (PIPE_B * PIPE_T, PIPE_VOCAB, 768, "vd", torch.float32)]
HF_EMBED_CASES = [("llama_token", 2048)]

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


def attention_phase(fa, dev, bw, f32, bf16, attn_cases=ATTN_CASES):
    """flash_attention_fwd against its plain version (bf16 o also by its
    relative L2 error; in f32, also against unfused attention) at
    ``attn_cases``, each kernel run twice and held bit-equal to itself;
    timed at each case."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(1)
    tol = TOL["flash_attention_fwd"]
    cases = []
    for b, h, s, d, dtype, causal, pad in attn_cases:
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


def ce_phase(ce, dev, bw, f32, bf16, ce_cases=CE_CASES):
    """fused_linear_nll_fwd against its plain version at ``ce_cases``, the
    kernel run twice and held bit-equal to itself; timed."""
    gen = torch.Generator(device=dev).manual_seed(2)
    tol = TOL["fused_linear_nll_fwd"]["lse_tl_nll"]
    cases = []
    for n, v, d, layout, dtype in ce_cases:
        w_dv = layout == "dv"
        h = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        w = (torch.randn((v, d), generator=gen, device=dev) * 0.02).to(dtype)
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

        es = h.element_size()
        cases.append({
            "shape": [n, v, d], "layout": layout, "dtype": str(dtype)[6:],
            "rerun_bit_equal": True, "max_abs_err": err,
            "mean_nll": float((lse - tl).mean()),
            # read h, W, b and the targets once; write lse and tl
            "bound": bound(es * (n * d + v * d) + 4 * v + 4 * n + 8 * n,
                           2 * n * v * d, bw,
                           bf16 if dtype == torch.bfloat16 else f32),
            "ms": graph_ms(lambda: ce._linear_nll_fwd_kernel(h, w, b, t, **kw)),
            "launched_ms": time_ms(
                lambda: ce.fused_linear_nll(h, w, b, t, w_layout=layout), 50),
            "plain_ms": graph_ms(
                lambda: ce._linear_nll_fwd_plain(h, w, b, t, **kw), iters=20),
            "library_ms": graph_ms(library)})
    return cases


def attention_bwd_phase(fa, dev, bw, f32, bf16, attn_cases=ATTN_CASES):
    """flash_attention_bwd against its plain version (and, in f32, against
    autograd of unfused attention) at ``attn_cases``; timed at each
    case."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = TOL["flash_attention_bwd"]
    cases = []
    for b, h, s, d, dtype, causal, pad in attn_cases:
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


def ce_bwd_phase(ce, dev, bw, bf16, ce_cases=CE_BWD_CASES):
    """fused_linear_nll_bwd against its plain version at ``ce_cases``; the
    bf16 cases timed."""
    gen = torch.Generator(device=dev).manual_seed(4)
    tol = TOL["fused_linear_nll_bwd"]
    cases = []
    for n, v, d, layout, dtype in ce_cases:
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
    """(vec, idx, vocab, form) of one EMBED_CASES or HF_EMBED_CASES case;
    CTR ids as float32, as fed; BERT's as the batch holds them; TinyLlama's
    a seeded LLAMA_B x LLAMA_T batch of its vocabulary's ids."""
    if case == "llama_token":
        from hetu_tpu_torch.examples import hf_standins
        vocab = hf_standins.TINYLLAMA["vocab_size"]
        idx = torch.randint(0, vocab, (LLAMA_B, LLAMA_T), generator=gen,
                            device=dev)
        return (torch.randn((idx.numel(), d), generator=gen, device=dev), idx,
                vocab, "dense")
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


def embed_grad_phase(eg, registry, first_ids, bert_batch, dev, bw, f32,
                     embed_cases=EMBED_CASES):
    """fused_embed_grad against its plain version at ``embed_cases``, after the
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
    for case, d in embed_cases:
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


def grad_gate(grads, tfm, registry, cfg, want, line, what,
              dtypes=("float32", "bfloat16"), deep=False, **fields):
    """The first step's loss and gradients with the kernels against
    kernels="off" on the same inputs, at ``cfg`` in each of ``dtypes``:
    ``grads(c)`` gives ``((loss, gradient tree), the launches it made)``
    under the config ``c``, and must launch ``want``. In f32 (first) each
    tensor's gradient within GRAD_REL; in bf16 all together within
    GRAD_REL, and each tensor's and all together at most BF16_EXCESS times
    as far from the f32 gradient as the plain versions' (see GRAD_REL
    above). ``deep``: a model whose bf16 rounding alone moves the plain
    versions' gradients further than GRAD_REL/BF16_EXCESS from the f32
    ones (TinyLlama, LLAMA_* above); its bf16 gradients all together are
    held against kernels="off" within BF16_EXCESS times that distance
    instead. One ``line`` a dtype, with ``fields``; a failure names
    ``what``. Returns the agreement by dtype."""
    agree, ref = {}, None
    for name in dtypes:
        c = dataclasses.replace(cfg, dtype=getattr(torch, name))
        (loss_k, g_k), counts = grads(c)
        check(counts == want, f"{what} {name} first-step gradient launched "
              f"{counts}, expected {want}")
        with registry.active("off"):
            (loss_o, g_o), off_counts = grads(c)
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
            # bf16 rounding through the layers and back, measured: each
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
        tol = (max(GRAD_REL, BF16_EXCESS * o_all)
               if deep and name == "bfloat16" else GRAD_REL)
        emit(line, dtype=name, grad_rel_l2_tol=tol, **fields, **agree[name])
        check(agree[name]["loss_rel"] < BERT_REL, f"{what} {name} first "
              f"loss {float(loss_k)} vs kernels='off' {float(loss_o)}")
        check(agree[name]["grad_rel_l2_all"] < tol, f"{what} {name} "
              f"gradients differ from kernels='off': {agree[name]}")
        if name == "float32":
            check(per[worst] < GRAD_REL, f"{what} float32 gradient of "
                  f"{worst} differs from kernels='off' by rel L2 {per[worst]}")
            ref = flat_k
        else:
            check(k_all <= BF16_EXCESS * o_all, f"{what} bfloat16 gradients "
                  f"are rel L2 {k_all} from the f32 ones, kernels='off' "
                  f"{o_all}")
            check(use[worst_x] <= 1, f"{what} bfloat16 gradient of "
                  f"{worst_x} is rel L2 {vs_k[worst_x]} from the f32 one, "
                  f"above {limit[worst_x]} (kernels='off' {vs_o[worst_x]})")
        del g_k, g_o, flat_k, flat_o
    return agree


def bert_grad_gate(bert, tfm, bert_forward, registry, cfg, params, batch,
                   want, phase):
    """``grad_gate`` on BERT's pretraining loss: one bert_grad_check line
    per dtype. Returns ``(first bf16 loss, its kernels="off" loss)``."""

    def grads(c):
        ((loss, _), g), counts = bert_forward.counted(
            lambda: tfm.value_and_grad(bert.pretrain_loss, params, batch, c,
                                       has_aux=True))
        return (loss, g), counts

    agree = grad_gate(grads, tfm, registry, cfg, want, "bert_grad_check",
                      f"BERT {phase}", bert_phase=phase, batch=list(batch["input_ids"].shape),
                      mlm_slots=batch["mlm_ids"].shape[1])
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


def _quiet(fn):
    """``(fn(), the lines it printed)``: an entry point's own prints are
    kept out of this script's output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bert_trainer_phase(bert, tfm, bert_forward, registry, dev):
    """Section 16 (BERT_TRAINER_* above): the first step's gradients
    against kernels="off", then train_hetu_bert checkpointed every epoch,
    resumed, and held bit for bit against an uninterrupted run. Returns
    the launches of the checkpointed and resumed runs (the main path)."""
    from hetu_tpu_torch import checkpoint
    from hetu_tpu_torch.examples import train_hetu_bert as thb
    args = thb.parse_args(BERT_TRAINER_FLAGS)
    vocab, full = thb.pretrain_data(args.max_seq_length, dev)
    cfg = thb.config(args, len(vocab))
    n = len(full["input_ids"])
    # the trainer's initial parameters (seed 0) and first batch (epoch 0's
    # permutation)
    params = bert.init_params(0, cfg, dev)
    first = torch.from_numpy(np.random.RandomState(0).permutation(n)[
        :args.batch_size]).to(dev)
    first = {k: v[first] for k, v in full.items()}
    bert_grad_gate(bert, tfm, bert_forward, registry, cfg, params, first,
                   BERT_TRAINER_LAUNCHES, "trainer")

    t_phase = time.perf_counter()
    per_step, losses, step_ms, clock = [], [], [], [0.0]

    def record(epoch, step, loss, mlm, nsp):
        # the step's launches, zeroed just before it and read just after
        per_step.append({k: v for k, v in registry.launch_counts().items()
                         if v})
        registry.reset_launch_counts()
        now = time.perf_counter()
        # an epoch's first step of the first run also holds the previous
        # epoch's checkpoint
        step_ms.append((step, (now - clock[0]) * 1e3))
        clock[0] = now
        losses.append(loss)

    def train(extra, init=None):
        registry.reset_launch_counts()
        clock[0] = time.perf_counter()
        (_, state), log = _quiet(lambda: thb.run(thb.parse_args(
            BERT_TRAINER_FLAGS + extra), params=init, on_step=record))
        return state, log

    def differ(x, y):
        return [p for (p, a), b in zip(tfm.tree_leaves(x, with_paths=True),
                                       tfm.tree_leaves(y))
                if a.dtype != b.dtype or not torch.equal(a, b)]

    root = tempfile.mkdtemp(prefix="chip_smoke_bert_")
    try:
        a = os.path.join(root, "a")
        epochs = str(BERT_TRAINER_EPOCHS)
        t0 = time.perf_counter()
        # the gate's parameters are the ones the trainer would draw itself;
        # the run updates them in place
        _, log1 = train(["--num-epoch", epochs, "--ckpt-dir", a,
                         "--ckpt-every", "1"], init=params)
        del params
        # resumed as tests/test_bert.py resumes the reference: its one
        # checkpoint is the one written at the end
        resumed, log2 = train(["--num-epoch", str(2 * BERT_TRAINER_EPOCHS),
                               "--ckpt-dir", a, "--resume"])
        main_s = time.perf_counter() - t0
        check(f"resumed from epoch {BERT_TRAINER_EPOCHS - 1}" in log2,
              f"the resumed run printed {log2}")
        n_main = len(per_step)
        check(n_main == 2 * BERT_TRAINER_EPOCHS * (n // args.batch_size),
              f"{n_main} steps in the checkpointed and resumed runs")
        # the uninterrupted run, held in memory (no checkpoint)
        whole, _ = train(["--num-epoch", str(2 * BERT_TRAINER_EPOCHS)])
        check(per_step[n_main:] and all(c == BERT_TRAINER_LAUNCHES
                                        for c in per_step),
              f"the trainer's steps launched {per_step}, expected "
              f"{BERT_TRAINER_LAUNCHES} each")
        check(np.isfinite(losses).all(), f"trainer losses {losses}")
        check(losses[n_main:] == losses[:n_main],
              f"the uninterrupted run's losses {losses[n_main:]} differ "
              f"from the resumed run's {losses[:n_main]}")
        bad = differ(resumed, whole)
        check(not bad, f"the resumed run's state differs from the "
              f"uninterrupted run's in {bad}")
        del resumed
        # the last checkpoint the resumed run wrote reads back as that state
        t0 = time.perf_counter()
        saved, step = checkpoint.TrainCheckpointer(a).restore_latest(
            like=whole)
        restore_s = time.perf_counter() - t0
        check(step == 2 * BERT_TRAINER_EPOCHS - 1, f"latest step {step}")
        bad = differ(saved, whole)
        check(not bad, f"the last checkpoint differs from the final state "
              f"in {bad}")
        ckpt_bytes = sum(x.numel() * x.element_size()
                         for x in tfm.tree_leaves(saved))
        del saved
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the device time of one step: the trainer's step on its first batch,
    # from the uninterrupted run's final state, profiled
    step_fn = bert.make_pretrain_step(cfg, lr=args.learning_rate)
    one = lambda: step_fn(whole["params"], whole["opt"], first)  # noqa: E731
    one_ms = min(_wall_ms(one) for _ in range(5))
    with tempfile.TemporaryDirectory() as d:
        prof = bert_forward.profile(one, one_ms, 3, os.path.join(d, "t.txt"))
    del whole, one
    later = [ms for s, ms in step_ms[:n_main] if s > 0]
    emit("bert_trainer", flags=BERT_TRAINER_FLAGS, vocab=len(vocab),
         instances=n, steps_per_epoch=n // args.batch_size,
         epochs=[BERT_TRAINER_EPOCHS, 2 * BERT_TRAINER_EPOCHS],
         losses=losses[:n_main], step_ms=later,
         epoch_first_step_ms=[ms for s, ms in step_ms[:n_main] if s == 0],
         one_step_ms=one_ms, device_ms=prof["device_ms"],
         device_busy_share=prof["device_ms"] / one_ms,
         device_groups_us=prof["groups_us"],
         main_path_s=main_s, restore_s=restore_s,
         checkpoint_bytes=ckpt_bytes, resumed_bit_equal=True,
         epoch_lines=[ln for ln in log1 + log2 if ln.startswith("epoch")],
         launches_per_step=BERT_TRAINER_LAUNCHES,
         seconds=time.perf_counter() - t_phase)
    return {k: v * n_main for k, v in BERT_TRAINER_LAUNCHES.items()}


def _gpt2(tfm, dev, **kw):
    cfg = tfm.TransformerConfig(**dict(dict(dtype=torch.bfloat16,
                                            remat=False), **GPT2_SMALL,
                                       **kw))
    return cfg, tfm.init_params(0, cfg, dev)


def _decode_times(tfm, gen, bert_forward, cfg, params, prompt, M, bw):
    """The time of a greedy decode step (a token in each row): the whole
    decode to ``M`` less the prefill and one step (a call with max_len =
    P) on the host clock; the device's kernels over DECODE_PROFILED steps
    (a call with max_len = P + DECODE_PROFILED) less the prefill's, from
    torch.profiler."""
    P = prompt.shape[1]
    greedy = gen.make_generate_fn(cfg, M)
    short = gen.make_generate_fn(cfg, P)
    mid = gen.make_generate_fn(cfg, P + DECODE_PROFILED)
    long_ms = min(_wall_ms(lambda: greedy(params, prompt, 0))
                  for _ in range(2))
    short_ms = min(_wall_ms(lambda: short(params, prompt, 0))
                   for _ in range(2))
    mid_ms = _wall_ms(lambda: mid(params, prompt, 0))
    with tempfile.TemporaryDirectory() as d:
        dev_mid = bert_forward.profile(lambda: mid(params, prompt, 0),
                                       mid_ms, 1, os.path.join(d, "m.txt"))
        dev_short = bert_forward.profile(lambda: short(params, prompt, 0),
                                         short_ms, 1, os.path.join(d, "s.txt"))
    return dict(
        decode_ms=long_ms, prefill_and_one_step_ms=short_ms,
        ms_per_token=(long_ms - short_ms) / (M - P),
        device_ms_per_token=(dev_mid["device_ms"] - dev_short["device_ms"])
        / DECODE_PROFILED, device_busy_share=dev_mid["device_busy_share"],
        device_groups_us=dev_mid["groups_us"],
        device_top_kernels=dev_mid["top_kernels"][:6],
        weights_read_bound_ms=sum(x.numel() * x.element_size() for x in
                                  tfm.tree_leaves(params)) / bw * 1e3)


def decode_phase(tfm, gen, bert_forward, counted, dev, bw):
    """Section 17 (GPT2_SMALL, DECODE_* above): generation at GPT-2 small
    widths, its gates, and the greedy decode's time a step."""
    t_phase = time.perf_counter()
    cfg, params = _gpt2(tfm, dev)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    B, P, M = DECODE_B, DECODE_P, DECODE_LEN
    prompt = torch.randint(0, cfg.vocab_size, (B, P),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    out = {}

    # greedy in bf16: the per-position logits against the full forward
    greedy = gen.make_generate_fn(cfg, M)
    (toks, logits), launches = counted(lambda: greedy(params, prompt, 0))
    check(launches == {}, f"decoding launched {launches}")
    with torch.no_grad():
        full, _ = tfm.forward(params, toks, cfg)
    out["bf16_logits_rel_l2"] = rel_l2(logits, full)
    check(out["bf16_logits_rel_l2"] <= DECODE_REL_BF16, f"bf16 decode "
          f"logits rel L2 {out['bf16_logits_rel_l2']} from the forward")
    del full, logits

    out.update(_decode_times(tfm, gen, bert_forward, cfg, params, prompt, M,
                             bw))

    # top-k sampling: every token among the top k of its step
    sampler = gen.make_generate_fn(cfg, M, sample=True, top_k=DECODE_TOPK)
    stoks, slogits = sampler(params, prompt, 1, 0.8)
    top = torch.topk(slogits[:, P - 1:M - 1], DECODE_TOPK, dim=-1).indices
    check(bool((top == stoks[:, P:, None]).any(-1).all()),
          "a top-k sample left the top k")
    check(torch.equal(sampler(params, prompt, 1, 0.8)[0], stoks),
          "one seed sampled two sequences")
    del slogits, top

    # f32: the forward, the prefill paths, beam, EOS, ragged, speculative
    greedy32 = gen.make_generate_fn(cfg32, M)
    toks32, logits32 = greedy32(params, prompt, 0)
    with torch.no_grad():
        full32, _ = tfm.forward(params, toks32, cfg32)
    out["f32_logits_rel_l2"] = rel_l2(logits32, full32)
    check(out["f32_logits_rel_l2"] <= DECODE_REL_F32, f"f32 decode logits "
          f"rel L2 {out['f32_logits_rel_l2']} from the forward")
    del full32, logits32
    tokenwise = gen.make_generate_fn(cfg32, M, chunked_prefill=False)
    check(torch.equal(tokenwise(params, prompt, 0)[0], toks32),
          "chunked and tokenwise prefill decoded other tokens")
    b1, _ = gen.make_beam_search_fn(cfg32, M, 1)(params, prompt)
    check(torch.equal(b1[:, 0], toks32), "beam K = 1 differs from greedy")
    bk, scores = gen.make_beam_search_fn(cfg32, M, DECODE_BEAM)(params,
                                                                prompt)
    check(bool((scores[:, :-1] >= scores[:, 1:]).all()),
          f"beam scores not sorted: {scores}")
    row = gen.generate(params, cfg32, prompt[:1], M)[0]
    eos = int(row[P + 4])
    etoks, stop = gen.make_eos_generate_fn(cfg32, M, eos)(params,
                                                          prompt[:1], 0)
    etoks = etoks[0].cpu().numpy()
    first_eos = P + int(np.argmax(row[P:] == eos))
    check(stop == first_eos < M - 1 and np.array_equal(
        etoks[:stop + 1], row[:stop + 1]) and (etoks[stop + 1:] == eos).all(),
        f"the EOS loop stopped at {stop}, greedy's first eos at {first_eos}")
    rt, _ = greedy32(params, prompt, 0, prompt_lens=DECODE_RAGGED)
    for b, ln in enumerate(DECODE_RAGGED):
        solo, _ = greedy32(params, prompt[b:b + 1, :ln], 0, prompt_lens=[ln])
        check(torch.equal(solo[0], rt[b]), f"ragged row {b} (length {ln}) "
              "differs from its solo decode")
    draft_cfg = dataclasses.replace(cfg32, n_layers=SPEC_LAYERS)
    draft = dict(params, blocks={k: v[:SPEC_LAYERS]
                                 for k, v in params["blocks"].items()})
    spec = gen.make_speculative_generate_fn(cfg32, draft_cfg, M, k=SPEC_K)
    stok, rounds = spec(params, draft, prompt[:1])
    check(np.array_equal(stok[0].cpu().numpy(), row),
          "speculative decoding differs from plain greedy")
    emit("decode_gpt2_small", config=GPT2_SMALL, weights="seed 0",
         batch=B, prompt=P, max_len=M, **out, top_k=DECODE_TOPK,
         beam=DECODE_BEAM, beam_scores=scores[0].tolist(), eos_id=eos,
         eos_stop=stop, ragged=DECODE_RAGGED,
         speculative=dict(draft_layers=SPEC_LAYERS, k=SPEC_K, rounds=rounds,
                          tokens_per_round=(M - P - 1) / rounds),
         tolerance=dict(bf16_rel_l2=DECODE_REL_BF16,
                        f32_rel_l2=DECODE_REL_F32), launches=launches,
         seconds=time.perf_counter() - t_phase)


def dropout_phase(tfm, registry, counted, dev):
    """Section 18 (DROP_* above): training-time dropout at GPT-2 small
    widths; returns the launches of its DROP_STEPS steps."""
    t_phase = time.perf_counter()
    cfg, params = _gpt2(tfm, dev, dropout_rate=DROP_RATE, remat=True)
    tok = torch.randint(0, cfg.vocab_size, (DROP_B, DROP_T + 1),
                        generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32).to(dev)
    x, y = tok[:, :-1].contiguous(), tok[:, 1:].contiguous()
    seed = 2026
    # the first step with the kernels against kernels="off", both drawing
    # the same masks from the same key
    grad_gate(lambda c: counted(lambda: tfm.value_and_grad(
        tfm.loss_fn, params, x, y, c, dropout_rng=seed)), tfm, registry, cfg,
        DROP_LAUNCHES, "dropout_grad_check", "GPT-2 small dropout",
        batch=[DROP_B, DROP_T], rate=DROP_RATE, remat=True)
    grads, counts = {}, {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        (loss, grads[remat]), counts[remat] = counted(
            lambda: tfm.value_and_grad(tfm.loss_fn, params, x, y, c,
                                       dropout_rng=seed))
    check(counts[True] == DROP_LAUNCHES and counts[False] == dict(
        DROP_LAUNCHES, flash_attention_fwd=DROP_LAUNCHES[
            "flash_attention_fwd"] // 2),
          f"the dropout step's gradient launched {counts}")
    differ = [p for (p, a), b in zip(
        tfm.tree_leaves(grads[True], with_paths=True),
        tfm.tree_leaves(grads[False])) if not torch.equal(a, b)]
    check(not differ, f"remat changed the gradients of {differ}")
    del grads
    keep = tfm._dropout_mask((DROP_B, DROP_T, cfg.d_model), DROP_RATE,
                             tfm.fold_in(seed, 0), dev)
    share = 1.0 - float(keep.float().mean())
    check(abs(share - DROP_RATE) <= DROP_SHARE_TOL,
          f"a mask dropped {share}, the rate is {DROP_RATE}")

    step = tfm.make_train_step(cfg, lr=DROP_LR)
    state = {"p": params, "o": tfm.init_opt_state(params)}
    losses, per_step, ms = [], [], []
    for i in range(DROP_STEPS):
        t0 = time.perf_counter()
        (loss, state["p"], state["o"]), c = counted(lambda: step(
            state["p"], state["o"], x, y, tfm.fold_in(seed, i + 1)))
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append(c)
    check(all(c == DROP_LAUNCHES for c in per_step),
          f"dropout steps launched {per_step}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"dropout losses {losses}")
    emit("dropout_gpt2_small", batch=DROP_B, seq=DROP_T, rate=DROP_RATE,
         lr=DROP_LR, remat_bit_equal=True, dropped_share=share,
         share_tolerance=DROP_SHARE_TOL, losses=losses, step_ms=ms,
         launches_per_step=DROP_LAUNCHES,
         seconds=time.perf_counter() - t_phase)
    return {k: v * DROP_STEPS for k, v in DROP_LAUNCHES.items()}


def lm_trainer_phase(counted):
    """Section 19 (LM_TRAINER_* above): train_hetu_transformer on the card,
    its first step against kernels="off"; returns its launches."""
    from hetu_tpu_torch.examples import train_hetu_transformer as tht
    args = tht.parse_args([])
    first, exs = {}, {}
    for mode in (None, "off"):
        (ids, exs[mode], tokens, labels), _ = _quiet(lambda: tht.build(
            args, kernels=mode))
        bx, by = next(tht.batches(ids, args))
        out, c = counted(lambda: exs[mode].run(
            "train", feed_dict={tokens: bx, labels: by}))
        first[mode] = (float(np.mean(out[0].asnumpy())), c)
    check(first[None][1] == LM_TRAINER_LAUNCHES and first["off"][1] == {},
          f"train_hetu_transformer's first step launched {first[None][1]}, "
          f"kernels='off' {first['off'][1]}")
    loss_rel = abs(first[None][0] - first["off"][0]) / abs(first["off"][0])
    state_rel, worst = _param_rel(exs[None], exs["off"])
    check(loss_rel <= LM_REL and state_rel <= LM_REL,
          f"train_hetu_transformer's first step against kernels='off': loss "
          f"rel {loss_rel}, {worst} rel L2 {state_rel}")
    del exs
    t0 = time.perf_counter()
    (losses, log), counts = counted(lambda: _quiet(lambda: tht.main(
        ["--steps", str(LM_TRAINER_STEPS)])))
    seconds = time.perf_counter() - t0
    want = {k: v * LM_TRAINER_STEPS for k, v in LM_TRAINER_LAUNCHES.items()}
    check(counts == want, f"train_hetu_transformer launched {counts}, "
          f"expected {want}")
    check(len(losses) == LM_TRAINER_STEPS and np.isfinite(losses).all(),
          f"train_hetu_transformer losses {losses}")
    emit("train_hetu_transformer", steps=LM_TRAINER_STEPS, seconds=seconds,
         ms_per_step=seconds * 1e3 / LM_TRAINER_STEPS, corpus=log[0],
         first_loss=losses[0], last_loss=losses[-1],
         launches_per_step=LM_TRAINER_LAUNCHES,
         first_step_vs_off={"loss_rel": loss_rel, "state_rel_l2": state_rel,
                            "worst": worst, "tolerance": LM_REL})
    return want


def generate_demo_phase(tfm, registry, counted, dev):
    """Section 20 (DEMO_* above): generate_hetu.main on the card, its
    trainer's first step against kernels="off"; returns its launches."""
    from hetu_tpu_torch.examples import generate_hetu
    cfg = generate_hetu.config()
    params = tfm.init_params(0, cfg, dev)
    tok, tgt = generate_hetu.batch(torch.from_numpy(
        generate_hetu.make_corpus(cfg.vocab_size)).to(dev), 0)
    grad_gate(lambda c: counted(lambda: tfm.value_and_grad(
        tfm.loss_fn, params, tok, tgt, c)), tfm, registry, cfg,
        DEMO_LAUNCHES, "generate_hetu_grad_check", "generate_hetu's trainer",
        dtypes=("float32",), batch=list(tok.shape))
    del params
    steps = int(DEMO_ARGS[DEMO_ARGS.index("--steps") + 1])
    t0 = time.perf_counter()
    (loss, log), counts = counted(lambda: _quiet(lambda: generate_hetu.main(
        DEMO_ARGS)))
    seconds = time.perf_counter() - t0
    want = {k: v * steps for k, v in DEMO_LAUNCHES.items()}
    check(counts == want, f"generate_hetu launched {counts}, expected {want}")
    check(np.isfinite(loss) and loss < DEMO_LOSS_MAX,
          f"generate_hetu's loss {loss} is not below {DEMO_LOSS_MAX}")
    emit("generate_hetu", args=DEMO_ARGS, seconds=seconds, loss=loss,
         loss_max=DEMO_LOSS_MAX, lines=log, launches_per_step=DEMO_LAUNCHES)
    return want


def nlp_phases(bert, tfm, bert_forward, registry, dev, bw):
    """Sections 16-20: the BERT trainer, decoding and dropout at GPT-2
    small widths, the graph-API LM's trainer and the generation demo;
    their launches by path."""
    from hetu_tpu_torch.models import generate as gen
    counted = bert_forward.counted
    torch.cuda.empty_cache()
    out = {"bert_trainer": bert_trainer_phase(bert, tfm, bert_forward,
                                              registry, dev)}
    torch.cuda.empty_cache()
    decode_phase(tfm, gen, bert_forward, counted, dev, bw)
    torch.cuda.empty_cache()
    out["gpt2_dropout"] = dropout_phase(tfm, registry, counted, dev)
    torch.cuda.empty_cache()
    out["train_hetu_transformer"] = lm_trainer_phase(counted)
    out["generate_hetu"] = generate_demo_phase(tfm, registry, counted, dev)
    return out


def _timed_steps(bert_forward, one_step, n, want, what):
    """``n`` calls of ``one_step`` (a training step; returns its loss),
    each with the launch counts zeroed just before it and read just after,
    all equal to ``want``. Returns the losses, each step's wall ms (host
    clock to a synchronize; the last step runs under torch.profiler, which
    gives its device ms by kernel group), their median over the steps
    after the first, and the peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    losses, ms, prof = [], [], None
    for i in range(n):
        box = []
        t0 = time.perf_counter()
        if i < n - 1:
            _, counts = bert_forward.counted(lambda: box.append(one_step()))
            ms.append((time.perf_counter() - t0) * 1e3)
        else:
            steady = float(np.median(ms[1:] or ms))
            with tempfile.TemporaryDirectory() as d:
                prof, counts = bert_forward.counted(
                    lambda: bert_forward.profile(
                        lambda: box.append(one_step()), steady, 1,
                        os.path.join(d, "step.txt")))
        losses.append(float(box[0]))
        check(counts == want, f"{what} step {i} launched {counts}, "
              f"expected {want}")
    check(np.isfinite(losses).all(), f"{what} losses {losses}")
    return dict(losses=losses, step_ms=ms, steady_step_ms=steady,
                device_ms=prof["device_ms"],
                device_busy_share=prof["device_busy_share"],
                device_groups_us=prof["groups_us"],
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def _lm_step(tfm, cfg, lr, params, x, y):
    """One ``make_train_step`` step a call on ``x``, ``y``, the params and
    AdamW state carried from call to call; returns the loss."""
    step = tfm.make_train_step(cfg, lr=lr)
    state = {"p": params, "o": tfm.init_opt_state(params)}

    def one():
        loss, state["p"], state["o"] = step(state["p"], state["o"], x, y)
        return loss
    return one


def _same_tensors(got: dict, want: dict, what):
    """``got`` (numpy) holds each of ``want``'s tensors bit for bit."""
    check(set(got) == set(want),
          f"{what}: keys {sorted(set(got) ^ set(want))[:4]}")
    differ = [k for k, v in want.items()
              if not np.array_equal(got[k], v.detach().cpu().numpy())]
    check(not differ, f"{what}: {differ[:4]} differ")


def _tokens(vocab, b, t, seed, dev):
    tok = torch.randint(0, vocab, (b, t + 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(seed)).to(dev)
    return tok[:, :-1].contiguous(), tok[:, 1:].contiguous()


def llama_phase(tfm, gen, bert_forward, registry, dev, bw):
    """Section 21 (LLAMA_* above): TinyLlama-1.1B imported from a stand-in,
    its export bit for bit, greedy decode, and LLAMA_STEPS training steps;
    returns the steps' launches."""
    from hetu_tpu_torch.examples import hf_standins
    from hetu_tpu_torch.models import hf_llama
    t_phase = time.perf_counter()
    counted = bert_forward.counted
    t0 = time.perf_counter()
    stand_in = hf_standins.llama(0, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, cfg = hf_llama.params_from_hf(stand_in, device=dev)
    torch.cuda.synchronize()
    out = dict(config=hf_standins.TINYLLAMA, weights="seed 0",
               params=tfm.count_params(params), draw_s=t1 - t0,
               import_s=time.perf_counter() - t1)
    _same_tensors({k if k == "lm_head.weight" else "model." + k: v for k, v
                   in hf_llama.state_dict_from_params(params, cfg).items()},
                  stand_in.state_dict(), "TinyLlama's export")
    del stand_in
    out["export_bit_equal"] = True

    # (b) greedy decode, held to section 17's gates: in f32 the logits
    # against the forward within DECODE_REL_F32; in bf16 within
    # DECODE_REL_BF16, or BF16_EXCESS times the bf16 forward's own distance
    # from the f32 one where 22 layers of rounding take it further
    dcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    P, M = LLAMA_PROMPT, LLAMA_PROMPT + LLAMA_NEW
    prompt = torch.randint(0, cfg.vocab_size, (LLAMA_DECODE_B, P),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    (toks, logits), launches = counted(
        lambda: gen.make_generate_fn(dcfg, M)(params, prompt, 0))
    check(launches == {}, f"TinyLlama's decode launched {launches}")
    toks32, logits32 = gen.make_generate_fn(cfg, M)(params, prompt, 0)
    with torch.no_grad():
        full32, _ = tfm.forward(params, toks32, cfg)
        f32_rel = rel_l2(logits32, full32)
        del logits32
        full, _ = tfm.forward(params, toks, dcfg)
        noise = rel_l2(full, tfm.forward(params, toks, cfg)[0])
    rel = rel_l2(logits, full)
    tol = max(DECODE_REL_BF16, BF16_EXCESS * noise)
    check(f32_rel <= DECODE_REL_F32, f"TinyLlama's f32 decode logits rel "
          f"L2 {f32_rel} from the forward")
    check(rel <= tol, f"TinyLlama's bf16 decode logits rel L2 {rel} from "
          f"the forward, above {tol}")
    del full, full32, logits
    out["decode"] = dict(batch=LLAMA_DECODE_B, prompt=P, max_len=M,
                         bf16_logits_rel_l2=rel, f32_logits_rel_l2=f32_rel,
                         bf16_forward_vs_f32_rel_l2=noise,
                         tolerance=dict(bf16_rel_l2=tol,
                                        f32_rel_l2=DECODE_REL_F32),
                         **_decode_times(tfm, gen, bert_forward, dcfg, params,
                                         prompt, M, bw))
    torch.cuda.empty_cache()

    # (c) training in bf16 with remat, the first step against "off"
    tcfg = dataclasses.replace(cfg, dtype=torch.bfloat16, remat=True)
    x, y = _tokens(cfg.vocab_size, LLAMA_B, LLAMA_T, 2, dev)
    grad_gate(lambda c: counted(lambda: tfm.value_and_grad(
        tfm.loss_fn, params, x, y, c)), tfm, registry, tcfg, LLAMA_LAUNCHES,
        "llama_grad_check", "TinyLlama", deep=True, batch=[LLAMA_B, LLAMA_T],
        remat=True)
    torch.cuda.empty_cache()
    train = _timed_steps(bert_forward, _lm_step(tfm, tcfg, LLAMA_LR, params,
                                                x, y),
                         LLAMA_STEPS, LLAMA_LAUNCHES, "TinyLlama")
    train["tokens_per_s"] = LLAMA_B * LLAMA_T / train["steady_step_ms"] * 1e3
    emit("llama_tinyllama", **out, train=dict(
        batch=LLAMA_B, seq=LLAMA_T, lr=LLAMA_LR, remat=True,
        dtype="bfloat16", launches_per_step=LLAMA_LAUNCHES, **train),
         seconds=time.perf_counter() - t_phase)
    return {k: v * LLAMA_STEPS for k, v in LLAMA_LAUNCHES.items()}


def moe_phase(tfm, bert_forward, registry, dev):
    """Section 22 (MOE_* above): the switch-MoE LM at GPT-2 small widths;
    returns its steps' launches."""
    t_phase = time.perf_counter()
    counted = bert_forward.counted
    cfg, params = _gpt2(tfm, dev, n_experts=MOE_E, capacity_factor=MOE_CAP,
                        remat=True)
    x, y = _tokens(cfg.vocab_size, MOE_B, MOE_T, 3, dev)
    grad_gate(lambda c: counted(lambda: tfm.value_and_grad(
        tfm.loss_fn, params, x, y, c)), tfm, registry, cfg, MOE_LAUNCHES,
        "moe_grad_check", "the switch-MoE LM", dtypes=("float32",),
        batch=[MOE_B, MOE_T], experts=MOE_E, remat=True)
    first = {}
    for side, scope in (("kernels", contextlib.nullcontext()),
                        ("off", registry.active("off"))):
        with scope:
            (loss, g), launches = counted(lambda: tfm.value_and_grad(
                tfm.loss_fn, params, x, y, cfg))
        want = MOE_LAUNCHES if side == "kernels" else {}
        check(launches == want, f"the switch-MoE LM's bf16 first step "
              f"({side}) launched {launches}, expected {want}")
        first[side] = (float(loss), torch.cat([t.flatten() for t in
                                               tfm.tree_leaves(g)]))
        del g
    loss_rel = abs(first["kernels"][0] - first["off"][0]) / abs(
        first["off"][0])
    bf16_first = dict(loss=first["kernels"][0], off_loss=first["off"][0],
                      loss_rel=loss_rel, loss_rel_tol=BERT_REL,
                      grad_rel_l2_all=rel_l2(first["kernels"][1],
                                             first["off"][1]))
    del first
    emit("moe_grad_check", dtype="bfloat16", **bf16_first)
    check(loss_rel < BERT_REL, f"the switch-MoE LM's bf16 first loss "
          f"{bf16_first}")
    # each layer's dropped share in one bf16 forward, read by wrapping the
    # MoE MLP with its router
    shares, moe_mlp = [], tfm._moe_mlp

    def spy(h, p, c, mesh):
        keep = tfm.moe_route(h.reshape(-1, h.shape[-1]), p["router"], c)[5]
        shares.append(1.0 - float(keep.float().mean()))
        return moe_mlp(h, p, c, mesh)

    tfm._moe_mlp = spy
    try:
        with torch.no_grad():
            _, aux = tfm.forward(params, x, cfg)
    finally:
        tfm._moe_mlp = moe_mlp
    check(len(shares) == cfg.n_layers and np.isfinite(float(aux)),
          f"MoE forward: shares {shares}, aux {aux}")
    torch.cuda.empty_cache()
    train = _timed_steps(bert_forward, _lm_step(tfm, cfg, MOE_LR, params, x,
                                                y),
                         MOE_STEPS, MOE_LAUNCHES, "the switch-MoE LM")
    check(train["losses"][-1] < train["losses"][0],
          f"MoE losses {train['losses']}")
    train["tokens_per_s"] = MOE_B * MOE_T / train["steady_step_ms"] * 1e3
    emit("moe_gpt2_small", config=GPT2_SMALL, experts=MOE_E,
         capacity_factor=MOE_CAP,
         capacity=int(MOE_CAP * MOE_B * MOE_T / MOE_E), batch=MOE_B,
         seq=MOE_T, lr=MOE_LR, dtype="bfloat16", remat=True,
         params=tfm.count_params(params), bf16_first_step=bf16_first,
         dropped_share_by_layer=shares,
         dropped_share=float(np.mean(shares)), aux_sum=float(aux),
         launches_per_step=MOE_LAUNCHES, **train,
         seconds=time.perf_counter() - t_phase)
    return {k: v * MOE_STEPS for k, v in MOE_LAUNCHES.items()}


def vit_phase(tfm, bert_forward, dev):
    """Section 23 (VIT_* above): ViT-B/16 imported from a stand-in, its
    logits against the CPU's, VIT_STEPS steps."""
    from hetu_tpu_torch.examples import hf_standins
    from hetu_tpu_torch.models import hf_vit, vit
    t_phase = time.perf_counter()
    params, cfg = hf_vit.params_from_hf(hf_standins.vit_classifier(0, dev),
                                        device=dev)
    check(cfg == dataclasses.replace(
        vit.VIT_BASE, n_classes=hf_standins.VIT_B16["num_labels"]),
          f"ViT-B/16 imported as {cfg}")
    impl = tfm._resolve_attn_impl(cfg.trunk(), None, cfg.seq_len, None, dev)
    check(impl == "dot", f"ViT-B/16's attention resolved to {impl}")
    gen = torch.Generator().manual_seed(4)
    shape = (cfg.n_channels, cfg.image_size, cfg.image_size)
    images = torch.randn((VIT_IMAGES,) + shape, generator=gen)
    with torch.no_grad():
        logits, launches = bert_forward.counted(
            lambda: vit.classify_logits(params, images.to(dev), cfg))
        ref = vit.classify_logits(tfm.tree_map(lambda t: t.cpu(), params),
                                  images, cfg)
    check(launches == {}, f"ViT-B/16's forward launched {launches}")
    rel = rel_l2(logits.cpu(), ref)
    check(rel <= VIT_REL, f"ViT-B/16 logits rel L2 {rel} from the CPU's")
    step = vit.make_train_step(cfg, lr=VIT_LR)
    state = {"p": params, "o": vit.init_opt_state(params)}
    imgs = torch.randn((VIT_B,) + shape, generator=gen).to(dev)
    labels = torch.randint(0, cfg.n_classes, (VIT_B,), generator=gen).to(dev)

    def one():
        loss, _, state["p"], state["o"] = step(state["p"], state["o"], imgs,
                                               labels)
        return loss
    train = _timed_steps(bert_forward, one, VIT_STEPS, {}, "ViT-B/16")
    train["images_per_s"] = VIT_B / train["steady_step_ms"] * 1e3
    emit("vit_b16", config=hf_standins.VIT_B16, weights="seed 0",
         attn_impl=impl, seq=cfg.seq_len, params=tfm.count_params(params),
         logits_vs_cpu_rel_l2=rel, tolerance=VIT_REL, images=VIT_IMAGES,
         batch=VIT_B, lr=VIT_LR, dtype="float32", **train,
         seconds=time.perf_counter() - t_phase)


def hf_bert_phase(bert, tfm, bert_forward, registry, dev):
    """Section 24 (HFB_* above): BERT-base through hf_bert and
    finetune_hf_bert's legs; returns the tuning's launches."""
    import torch.nn.functional as F
    from hetu_tpu_torch.examples import finetune_hf_bert as fhb, hf_standins
    t_phase = time.perf_counter()
    (params, cfg), _ = _quiet(lambda: fhb.import_model(
        hf_standins.bert_classifier(0, dev), 2, dev))
    rng = np.random.default_rng(0)
    ids, labels = fhb.make_task(rng, 4096, HFB_T, cfg.vocab_size)
    lengths = torch.Generator(device=dev).manual_seed(5)

    def padded(data):
        # a key-padding mask on each batch: lengths in [T/2, T]
        for batch in data:
            n = torch.randint(HFB_T // 2, HFB_T + 1, (HFB_B, 1),
                              generator=lengths, device=dev)
            batch["input_mask"] = (torch.arange(HFB_T, device=dev) < n).int()
            yield batch

    data = padded(fhb.batches(rng, ids, labels, HFB_B, dev))
    first = next(data)

    def loss_fn(p, c):
        return F.cross_entropy(bert.classify_logits(
            p, first["input_ids"], first["segment_ids"], c,
            input_mask=first["input_mask"]), first["label"].long())

    grad_gate(lambda c: bert_forward.counted(lambda: tfm.value_and_grad(
        loss_fn, params, c)), tfm, registry, cfg, HFB_LAUNCHES,
        "hf_bert_grad_check", "BERT-base fine-tuning", batch=[HFB_B, HFB_T])

    def replay():
        yield first
        yield from data

    steps = fhb.tuning(params, cfg, replay(), HFB_LR)
    train = _timed_steps(bert_forward, lambda: next(steps)[0], HFB_STEPS,
                         HFB_LAUNCHES, "finetune_hf_bert's tuning")
    emit("hf_bert_finetune", config=hf_standins.BERT_BASE, weights="seed 0",
         batch=HFB_B, seq=HFB_T, lr=HFB_LR, dtype="float32", remat=False,
         launches_per_step=HFB_LAUNCHES, **train,
         seconds=time.perf_counter() - t_phase)
    return {k: v * HFB_STEPS for k, v in HFB_LAUNCHES.items()}


def pipeline_phase(tfm, bert_forward, registry, dev):
    """Section 25 (PIPE_* above): gpt2_pipeline's legs at GPT-2 small's
    widths; returns the tuning's launches."""
    from hetu_tpu_torch.examples import gpt2_pipeline as gp, hf_standins
    from hetu_tpu_torch.models import hf_gpt2
    t_phase = time.perf_counter()
    tok = gp.demo_tokenizer()
    check(tok.vocab_size == PIPE_VOCAB,
          f"the demo tokenizer's vocabulary is {tok.vocab_size}")
    stand_in = hf_standins.gpt2(0, dev, vocab_size=tok.vocab_size)
    (params, cfg), log = _quiet(lambda: gp.import_model(stand_in, dev))
    check(cfg.tied_head and "head" not in params, "GPT-2's head is not tied")
    x, y = next(gp.batches(cfg, dev))
    check(list(x.shape) == [PIPE_B, PIPE_T], f"gpt2_pipeline's batch "
          f"{list(x.shape)}")
    grad_gate(lambda c: bert_forward.counted(lambda: tfm.value_and_grad(
        tfm.loss_fn, params, x, y, c)), tfm, registry, cfg, PIPE_LAUNCHES,
        "pipeline_grad_check", "gpt2_pipeline's tuning",
        dtypes=("float32",), batch=[PIPE_B, PIPE_T])
    steps, state = gp.tuning(params, cfg), {}

    def one():
        loss, state["params"] = next(steps)
        return loss

    train = _timed_steps(bert_forward, one, PIPE_STEPS, PIPE_LAUNCHES,
                         "gpt2_pipeline's tuning")
    params = state["params"]
    (ids, greedy, spec, rounds), decode_log = _quiet(lambda: gp.decode(
        params, cfg, tok, PIPE_MAX_LEN, PIPE_SPEC_K))
    check(np.array_equal(spec, greedy),
          "gpt2_pipeline's speculative decode differs from greedy")
    sd = hf_gpt2.state_dict_from_params(params, cfg)
    back = hf_standins.StandIn(vars(stand_in.config), {
        "transformer." + k: torch.from_numpy(v) for k, v in sd.items()})
    again, _ = hf_gpt2.params_from_hf(back, device=dev)
    differ = [p for (p, a), b in zip(tfm.tree_leaves(again, with_paths=True),
                                     tfm.tree_leaves(params))
              if not torch.equal(a, b)]
    check(not differ, f"the tuned GPT-2's round trip changed {differ}")
    emit("gpt2_pipeline", config=dict(hf_standins.GPT2_SMALL,
                                      vocab_size=tok.vocab_size),
         weights="seed 0", batch=[PIPE_B, PIPE_T], prompt=ids[0].tolist(),
         greedy=greedy[0].tolist(), speculative_rounds=int(rounds),
         lines=log + decode_log, round_trip_bit_equal=True,
         launches_per_step=PIPE_LAUNCHES, **train,
         seconds=time.perf_counter() - t_phase)
    return {k: v * PIPE_STEPS for k, v in PIPE_LAUNCHES.items()}


def hf_phases(bert, tfm, bert_forward, registry, dev, bw, f32, bf16):
    """Sections 21-25: the kernels at their shapes (HF_*_CASES), then
    TinyLlama, the switch-MoE LM, ViT-B/16, BERT-base through hf_bert and
    the GPT-2 pipeline; returns their kernel cases and their launches by
    path."""
    from hetu_tpu_torch.kernels import embed_grad, flash_attention, fused_ce
    from hetu_tpu_torch.models import generate as gen
    cases = {
        "attn": attention_phase(flash_attention, dev, bw, f32, bf16,
                                HF_ATTN_CASES),
        "attn_bwd": attention_bwd_phase(flash_attention, dev, bw, f32, bf16,
                                        HF_ATTN_CASES),
        "ce": ce_phase(fused_ce, dev, bw, f32, bf16, HF_CE_CASES),
        "ce_bwd": ce_bwd_phase(fused_ce, dev, bw, bf16, HF_CE_CASES),
        "embed": embed_grad_phase(embed_grad, registry, None, None, dev, bw,
                                  f32, HF_EMBED_CASES)}
    emit("slice_5c_kernels_checked",
         shapes="TinyLlama-1.1B's, the MoE LM's and the GPT-2 pipeline's",
         **cases)
    out = {}
    for path, run in (
            ("llama_tinyllama", lambda: llama_phase(
                tfm, gen, bert_forward, registry, dev, bw)),
            ("moe_gpt2_small", lambda: moe_phase(tfm, bert_forward, registry,
                                                 dev)),
            ("vit_b16", lambda: vit_phase(tfm, bert_forward, dev)),
            ("hf_bert_finetune", lambda: hf_bert_phase(
                bert, tfm, bert_forward, registry, dev)),
            ("gpt2_pipeline", lambda: pipeline_phase(tfm, bert_forward,
                                                     registry, dev))):
        torch.cuda.empty_cache()
        out[path] = run() or {}
    return cases, out


def kernels_line(kern, attn, ces, attn_bwd, ce_bwd, spmm, spmv, embed,
                 quant, hf, launches, by_path):
    """The ``kernels`` JSON object: one entry per ported kernel; its
    ``launches`` sum the main paths' runs, ``launches_by_path`` splits
    them where later paths (sections 10-25) add to them. ``hf``: the kernel
    cases of slice 5c (hf_phases), each kernel's under ``slice_5c`` (the
    fused CE's f32 backward case is checked, not timed)."""
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
    # MLM rows) and the shapes of sections 16, 18 and 20 (slice_5d: the
    # BERT trainer's MLM rows, GPT-2 small's causal layer and tied head,
    # generate_hetu's f32 head)
    kern = dict(kern)
    kern["flash_attention_fwd"] = dict(attn[0], max_abs_err=max(
        max(c["o_max_abs_err"], c["lse_max_abs_err"])
        for c in attn + hf["attn"]),
        phase2=_timed(attn[1]), slice_5d={"gpt2_causal": _timed(attn[4])},
        slice_5c={"tinyllama_causal": _timed(hf["attn"][0]),
                  "moe_causal": _timed(hf["attn"][1])})
    kern["fused_linear_nll_fwd"] = dict(ces[0], max_abs_err=max(
        c["max_abs_err"] for c in ces + hf["ce"]), phase2=_timed(ces[2]),
        slice_5d={"bert_trainer": _timed(ces[3]),
                  "gpt2_tied": _timed(ces[4]),
                  "generate_hetu_f32": _timed(ces[5])},
        slice_5c={"tinyllama_head_dv": _timed(hf["ce"][0]),
                  "moe_tied": _timed(hf["ce"][1]),
                  "pipeline_tied_f32": _timed(hf["ce"][2])})
    kern["flash_attention_bwd"] = dict(attn_bwd[0], max_abs_err=max(
        c["max_abs_err"] for c in attn_bwd + hf["attn_bwd"]),
        phase2=_timed(attn_bwd[1]),
        slice_5d={"gpt2_causal": _timed(attn_bwd[4])},
        slice_5c={"tinyllama_causal": _timed(hf["attn_bwd"][0]),
                  "moe_causal": _timed(hf["attn_bwd"][1])})
    kern["fused_linear_nll_bwd"] = dict(ce_bwd[0], max_abs_err=max(
        c["max_abs_err"] for c in ce_bwd + hf["ce_bwd"]),
        phase2=_timed(ce_bwd[2]),
        slice_5d={"bert_trainer": _timed(ce_bwd[3]),
                  "gpt2_tied": _timed(ce_bwd[4])},
        slice_5c={"tinyllama_head_dv": _timed(hf["ce_bwd"][0]),
                  "moe_tied": _timed(hf["ce_bwd"][1])})
    # max_abs_err is the largest over all their cases
    # csr_spmm at layer 2's forward (F = 256); epoch_ms sums the three
    # shapes an epoch launches
    kern["csr_spmm"] = dict(spmm[1], max_abs_err=max(
        c["max_abs_err"] for c in spmm), epoch_ms=sum(c["ms"] for c in spmm))
    kern["csr_spmv"] = spmv[0]
    # fused_embed_grad at WDL-Criteo's step, the first case, and at
    # BERT-base's two phase-2 lookups
    kern["fused_embed_grad"] = dict(embed[0], max_abs_err=max(
        c["max_abs_err"] for c in embed + hf["embed"]), phase2={
            c["case"]: _timed(c) for c in embed if c["form"] == "dense"},
        slice_5c={"tinyllama_token": _timed(hf["embed"][0])})
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
                             "slice_5d", "slice_5c", "plan", "large")
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
    ap.add_argument("--nlp", action="store_true",
                    help="build, run the BERT trainer, decoding and dropout "
                         "at GPT-2 small widths, the graph-API LM's "
                         "trainer and the generation demo (sections "
                         "16-20), and stop")
    ap.add_argument("--hf", action="store_true",
                    help="build, run TinyLlama-1.1B, the switch-MoE LM, "
                         "ViT-B/16, BERT-base through hf_bert and the GPT-2 "
                         "pipeline (sections 21-25), and stop")
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
    if args.nlp:
        nlp_phases(bert, transformer, bert_forward, registry, dev, bw)
        return 0
    if args.hf:
        hf_phases(bert, transformer, bert_forward, registry, dev, bw, f32,
                  bf16)
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
    ces = ce_phase(fused_ce, dev, bw, f32, bf16)
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
    # -- 16. the BERT trainer; 17. decoding; 18. dropout; 19. the graph-API
    # LM's trainer; 20. the generation demo ---------------------------------
    # -- 21. TinyLlama-1.1B; 22. the switch-MoE LM; 23. ViT-B/16; 24. BERT-base
    # through hf_bert; 25. the GPT-2 pipeline -------------------------------
    paths = list(gnn_phases(ht, multihost, bert_forward.counted,
                            dev).items())
    paths += nlp_phases(bert, transformer, bert_forward, registry, dev,
                        bw).items()
    hf_cases, hf_paths = hf_phases(bert, transformer, bert_forward, registry,
                                   dev, bw, f32, bf16)
    for path, got in paths + list(hf_paths.items()):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
            by_path.setdefault(k, {})[path] = v

    print(json.dumps(kernels_line(kern, attn, ces, attn_bwd, ce_bwd, spmm,
                                  spmv, embed, quant, hf_cases, launches,
                                  by_path)),
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
