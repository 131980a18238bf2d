#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (written for an H100, ``sm_90a``) and the CUDA toolkit;
takes no arguments.  It builds the port's CUDA kernels from
``src/repro_torch/csrc``, holds every kernel against its plain PyTorch
version on the card (and, for the sampling and decode kernels, the
reference's contracts: a permuted launch, the chi-square of seeded draws,
the argmax at T <= 0, the output of a paged slot whatever its other
slots' sentinels alias, a slot's output whatever the batch it is launched
in), serves a LAKP-pruned and a dense full-width
``capsnet-mnist`` through ``CapsuleEngine`` with the routing in the
hand-written kernel, trains a full-width ``capsnet-mnist`` on the card and
carries it through the paper's Fig. 6 pipeline (LAKP prune, masked
fine-tune, compact, deploy through the routing and softmax kernels, serve
the test set; with a save / crash / resume check and a save / reload of the
deployed model; and a few steps through ``RoutingSpec.optimized()``, whose
Eq. 2 softmax backward runs in its own kernel, held against autograd of the
plain softmax), trains a full-width ``llama3.2-1b`` on the synthetic
token stream (chunked attention, remat; its attention backward held
against the reference attention's, the attention kernels' refusal of a
gradient checked), LAKP-prunes every layer's FFN blocks and KV-head groups
and serves the pruned model through the kernels against the plain path,
trains the other LM families at full width (``train_family``:
``deepseek-moe-16b`` cut to 2 of 28 layers, its aux loss, its one-hot
dispatch's backward held against the scatter dispatch's, LAKP over each
layer's experts and the pruned model served through the kernels against
the plain path with no token routed to a pruned expert; ``xlstm-1.3b`` cut
to 8 of 48 layers and a full-size ``zamba2-1.2b``, each recurrent
block's backward on the card held against the CPU, the launcher training
``zamba2-1.2b`` on the card; a full-size ``hubert-xlarge``, its chunked
attention's backward held against the reference attention's; and, since
no AdamW step of it fits one card, the loss and gradients of one unit of
``llama-3.2-vision-90b`` with its cross gates open, chunked against
reference; each step timed and its peak memory set beside the dry run's
count), serves a full-width ``llama3.2-1b`` (random weights, seed 0) through
``ServeEngine`` with prefill attention, decode attention,
sampling and every projection (the fixed-order GEMM, whose rows
``gemm_probe`` holds bit-identical at every M from 75 to 8192, and at a
decode tick's 1, 3 and 8 and the warpgroup edge 64 / 65, for one weight of
each BN class, beside cuBLAS's) in the hand-written kernels (and ``generate()`` and the
interleave and SLO-batching schedulers on the same engine; and its
seeded requests alone, at 3 slots and under memory pressure, held to the
sampling contract against the same run: every logits row must be
bit-identical, and a token drawn from one the same;
``tools/trace_seeded.py`` names the op on demand), serves it
again from the paged KV cache (bf16 pages, then int8 pages, with a shared
prompt prefix; then under memory pressure: preemption, host spill and
prefix eviction in one serve) with
decode reading the pages in place through the paged decode kernels, holds
the int8 dense-cache decode kernel against the paged one on the same pool,
serves it disaggregated (a prefill engine and two decode engines joined by
cache handoffs under each transport, dense and paged, held against the
unified engine), serves the pruned CapsNet through a pool of two engines,
replays a seeded bursty trace against an autoscaled disaggregated pool,
serves a full-width ``deepseek-moe-16b`` (6 of 28 layers, bf16
parameters; one-hot and scatter dispatch) from dense slots and bf16 and
int8 pages and a full-width ``llama-3.2-vision-90b`` (5 layers: 4
self-attention, 1 cross-attention; bf16 parameters) from dense slots and
bf16 pages, each against its plain path and disaggregated, and the vision
model's cross path with image features, serves a full-width ``qwen3-1.7b``
(14 of 28 layers, float32 parameters; 4 requests from dense slots, bf16
and int8 pages)
and, at full width
cut to 4 layers with bf16 parameters, ``qwen1.5-110b`` (dense slots),
``mistral-large-123b`` (12 query heads per KV head: two chunks of the
decode kernel's heads; dense slots and int8 pages) and ``dbrx-132b`` (dense slots,
its moe admission numbers), each against its plain path, serves an
``xlstm-1.3b`` (8 of
48 layers) and a ``zamba2-1.2b`` (18 of 38 layers, float32 parameters;
admitted in one prefill group per prompt length) against their plain paths
and disaggregated, each at the published size over every transport (zamba2
also with bf16 parameters), runs the launcher at ``--no-reduced`` (and
its fit check's refusal of ``mistral-large-123b``), runs a
full-size ``hubert-xlarge`` encoder (flash attention
at head dim 80, non-causal) against its plain and float32 forwards, serves
data-parallel (``serve_sharded``: ``llama3.2-1b`` under a ``ShardedScheduler``
whose 2-way mesh names the one card twice, dense and paged, against the
unsharded engine; the multi-host disaggregated engine with two decode
engines under the auto and the device-to-device transport; the pruned
CapsNet through a sharded ``CapsuleEngine``), checks the dry run against
the card (``dryrun``: the production-mesh dry run of a few cells through
``python -m repro_torch.launch.dryrun``, then five cells sized for one
card, ``llama3.2-1b`` decode, prefill and train and ``capsnet-mnist``
inference and training, counted on the meta device and run on the card:
argument bytes against what the allocator holds, the counted peak against
the measured one, the roofline bound against the measured step, the
kernels of each path launched), holds the tuner's command line and
capslint's kernel-legality proof against the card (``tuning``:
``--selfcheck``; every tuner candidate the rule passes, at the example
cases and each kernel-table row's main-path shape, launched and held
against its plain version; every proven case scaled to the serving shape
buckets sorted into launched (each candidate run against the plain
version), witnessed and unwitnessed; the flash grid's edges launched;
configs built just past each shared-memory, cluster or block limit refused
before launch; ``--pretune all`` and each row's default against its tuned
config, timed back to back), serves through tuned kernel configs
(``serve_tuned``: the pruned CapsNet and full-width ``llama3.2-1b``
through ``kernel_tune=True`` engines against the untuned ones, then
through a planted cache of non-default configs, every resolved config
checked, then the launcher's ``--kernel-tune`` twice on one cache), and
times the eleven kernels
(the nine TPU entry points, the softmax backward and the GEMM; routing also at the
dense shape; routing, softmax, decode and sampling at every point of their
tunables' spaces:
``i_splits`` and threads, threads, ``kv_splits`` and threads, the cluster
size and threads; sampling on a served decode tick's logits; and flash,
decode and sampling at the geometries of qwen3-1.7b and the large models,
which the kernel table lists under their rows; each kernel a captured path
launches also inside one CUDA graph of 20 launches; and the fixed-order
GEMM at llama3.2-1b's projections, prefill and decode, beside cuBLAS).
The CapsNet forward and every LM family's decode tick and admission
(prefill, paged prefill, gather, inject) are replayed from CUDA graphs
(``repro_torch.graphs``): ``serve_pruned``, ``serve_dense``,
``serve_lm``, ``serve_paged``, ``serve_disagg``, ``serve_moe``,
``serve_vlm``, ``serve_ssm`` and ``serve_hybrid`` hold each graph against
the same code run eagerly (lengths, logits rows and every cache, pool or
state leaf bit for bit, the replayed launches against the counters, FPS,
tok/s, tick and admission ms both ways), and every phase's seconds line
counts the graphs it captured and replayed.  Every
profiler reading comes from a trace that holds every launch its calls made
(``trace_rule``), taken eagerly, or is null.  One JSON
object per phase goes to standard output, and a line of seconds after
each phase; the last three lines are the
kernel table, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.  Any failed phase ends
the script with a non-zero exit code and no result line.  With no CUDA
device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import configs as cfg_lib  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.checkpointing import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.core import capsnet, pruning  # noqa: E402
from repro_torch.data import synthetic_digits as sd  # noqa: E402
from repro_torch.data.tokens import TokenStream, TokenStreamConfig  # noqa: E402
from repro_torch.deploy import FastCapsPipeline, RoutingSpec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.attention.kernel import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain, decode_smem_bytes,
    flash_attention_cuda, flash_attention_dequant_cuda,
    flash_attention_dequant_plain, flash_attention_plain)
from repro_torch.kernels.gemm.kernel import (  # noqa: E402
    fixed_order_matmul_cuda, gemm_plan)
from repro_torch.kernels.registry import registry  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.roofline import (BF16_FLOP_PER_S,  # noqa: E402
                                         HBM_BYTES_PER_S)
from repro_torch.kernels.routing.routing_kernel import (  # noqa: E402
    fused_routing_cuda, routing_smem_bytes)
from repro_torch.kernels.sampling.kernel import fused_sampling_cuda  # noqa: E402
from repro_torch.kernels.softmax.kernel import (  # noqa: E402
    taylor_softmax_bwd_cuda, taylor_softmax_cuda)
from repro_torch.launch.train import accuracy  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba2 as mamba_lib  # noqa: E402
from repro_torch.models import xlstm as xlstm_lib  # noqa: E402
from repro_torch.models.common import (init_params,  # noqa: E402
                                       tree_leaves, tree_unflatten)
from repro_torch.optim import AdamWConfig, adamw  # noqa: E402
from repro_torch.parallel import sharding as shard_lib  # noqa: E402
from repro_torch.serving import (DecodeEngine,  # noqa: E402
                                 DisaggregatedEngine, DisaggScheduler,
                                 ImageRequest, InterleavingScheduler,
                                 PriorityScheduler, Request,
                                 ServeEngine, ShardedScheduler,
                                 SLOBatchScheduler, disaggregated_lm_engine,
                                 make_transport,
                                 multihost_disaggregated_lm_engine)
from repro_torch.traffic import (AutoscaleController,  # noqa: E402
                                 bursty_trace, default_classes,
                                 default_factory, replay)
from repro_torch.training import Trainer, TrainerConfig  # noqa: E402
from repro_torch.training.trainer import make_train_step  # noqa: E402

DEVICE = "cuda"
BATCH = 32

WRAPPERS = {"fused_routing": fused_routing_cuda,
            "taylor_softmax": taylor_softmax_cuda,
            "taylor_softmax_bwd": taylor_softmax_bwd_cuda,
            "flash_attention": flash_attention_cuda,
            "flash_attention_dequant": flash_attention_dequant_cuda,
            "decode_attention": decode_attention_cuda,
            "fused_sampling": fused_sampling_cuda,
            "fixed_order_matmul": fixed_order_matmul_cuda}

# decode_attention's four bodies, by the row of the kernel table each fills
# (the TPU entry point each replaces)
DECODE_ROWS = {"dense": "decode_attention",
               "int8": "decode_attention_dequant",
               "paged": "decode_attention_paged",
               "paged_int8": "decode_attention_paged_dequant"}

# The LM serving path (phase serve_lm): llama3.2-1b at full width, 8 slots
# of 1024 positions, 16 requests of 16-700 prompt tokens and 32 new tokens.
LM_ARCH = "llama3.2-1b"
LM_SLOTS = 8
LM_MAX_LEN = 1024
LM_REQUESTS = 16
LM_MAX_NEW = 32
# Greedy tokens of the kernel path and the plain path must agree up to the
# first position whose top-2 logit margin (on the path the margins were
# read on) is below MARGIN_STEPS bf16 steps of that row's largest |logit|:
# logits are bf16 products after layers whose attention sums run in another
# order on the two paths, so a margin under four steps of the row's own
# scale may flip.  At llama3.2-1b's |45| (a step of 0.25) the threshold is
# 1.0; at the N(0, 1)-scale logits of the other families (|3|), 0.0625.
MARGIN_STEPS = 4
MARGIN_RULE = (f"{MARGIN_STEPS} bf16 steps of the row's largest |logit|: "
               f"{MARGIN_STEPS} * 2^(floor(log2 max|z|) - 7)")


def margin_threshold(max_abs: float) -> float:
    """MARGIN_STEPS bf16 steps at a row's largest |logit| ``max_abs``."""
    return MARGIN_STEPS * 2.0 ** (
        math.floor(math.log2(max(max_abs, 1e-30))) - 7)


# serve_lm's SLOBatchScheduler run: the controller starts at
# SLO_INITIAL_BATCH and doubles after each full window of ticks under half
# of SLO_TARGET_MS (a target the decode ticks, 30-50 ms, never miss), so it
# admits 2, then 4, then 8 requests at a time.
SLO_TARGET_MS = 1000.0
SLO_INITIAL_BATCH = 2


# The training path (phase train_capsnet): full-width capsnet-mnist from
# seed 0, the synthetic digits (2048 train / 512 test, seed 0), batch 32;
# dense AdamW steps, the serve_pruned cut (LAKP 0.6 / 0.9, 7 of 32 capsule
# types: 252 capsules), masked fine-tuning, compaction, then deployment
# through the routing kernel.  Bars: tests/test_system.py's (dense test
# accuracy above 0.5, pruned + fine-tuned within 0.15 of it).
TRAIN_N, TEST_N = 2048, 512
TRAIN_STEPS, TRAIN_LR = 300, 1e-3
FT_STEPS, FT_LR = 100, 3e-4
TRAIN_PROFILE_STEPS = 10
RESUME_STEPS, RESUME_EVERY, RESUME_CRASH = 12, 4, 10
# classes of the kernel deployments must equal the reference's on every
# test image whose top-two capsule lengths (reference) differ by more
TRAIN_MARGIN = 1e-3
# Training through RoutingSpec.optimized() (the Eq. 2 softmax and its
# backward kernel): OPT_STEPS steps from a fresh init (seed 1), batch 32,
# lr FT_LR after OPT_WARMUP steps (at TRAIN_LR after 3 warmup steps the
# squash saturates at this init and the loss sits near 3.6 for 30 steps,
# with the reference routing too; this schedule takes it from about 2.7 to
# about 0.17 on the CPU, either routing).  The first step's gradients are
# held against autograd of the plain softmax (approx_math.taylor_softmax)
# on the same card: every leaf's largest difference within OPT_GRAD_TOL of
# its largest |gradient| (the backward kernel sums and rounds in another
# order than autograd's elementwise kernels, and cuDNN's convolution
# backward sums in an order that changes between runs; a lost or wrong
# softmax gradient moves a leaf by its own size).  Bars: the losses finite, the mean of the
# last five below the mean of the first five, and two backward launches a
# step (three routing iterations; the first one's softmax acts on b = 0,
# which needs no gradient).
OPT_STEPS, OPT_WARMUP = 30, 5
OPT_GRAD_TOL = 1e-3

# The LM training path (phase train_lm): llama3.2-1b at full width (16
# layers, d_model 2048, 32 x 64 heads over 8 KV heads, d_ff 8192, vocab
# 128256, tied embeddings), float32 parameters, bf16 compute, attn_impl
# "chunked" (the attention kernels have no backward, as the reference's
# Pallas kernels refuse jax.grad), remat on; TRAIN_LM_STEPS Trainer steps
# from seed 0 on the token stream (vocab 128256), batch 8 x 512, AdamW lr
# 1e-3 after 3 warmup steps.  Bars: every loss finite, the mean of the last
# five below the mean of the first five.  Then the chunked attention's
# backward against the reference attention's on one batch: the loss within
# TRAIN_LM_LOSS_TOL relative; every gradient leaf's difference within
# TRAIN_LM_GRAD_TOL of the leaf in L2 norm, and each dense leaf's largest
# difference within TRAIN_LM_GRAD_TOL of its RMS.  Both paths round p and
# the products to bf16 at other places, which the backward carries through
# 16 layers (the dense leaves' largest differences were 0.07-0.15 of their
# RMS on the card); a lost or wrong attention gradient moves a leaf by its
# own size.  The embedding table's gradient lives on the rows the batch's
# tokens index (about 4,000 of 128,256) beside the tied unembedding's small
# dense part, so its RMS over all rows is no scale for its largest
# difference (1.56 of it on the card) and only its L2 norm is held.  Then the
# attention wrappers' refusal of a gradient on the card, LAKP pruning in
# every layer (FFN: 8 blocks at sparsity 0.5; heads: 2 of 8 KV groups) and
# serving the pruned model through the kernels against the plain path.
TRAIN_LM_STEPS = 30
TRAIN_LM_SERVE_REQUESTS = 8
TRAIN_LM_BATCH, TRAIN_LM_SEQ = 8, 512
TRAIN_LM_LR, TRAIN_LM_WARMUP = 1e-3, 3
TRAIN_LM_PROFILE_STEPS = 3
TRAIN_LM_HELD_OUT_SEED = 99_991
TRAIN_LM_LOSS_TOL = 2.0 ** -7           # two bf16 steps, relative
TRAIN_LM_GRAD_TOL = 0.25                # of the leaf's L2 norm / RMS
SPARSE_GRAD_LEAVES = ("embed/tok",)
PRUNE_FFN_BLOCKS, PRUNE_FFN_SPARSITY = 8, 0.5
PRUNE_HEAD_SPARSITY = 0.25
# train_mfu's peak: BF16_FLOP_PER_S, the H100 SXM part's (nvidia-smi names
# it "NVIDIA H100 80GB HBM3")
BF16_PEAK_NAME = "H100 SXM dense bf16, NVIDIA data sheet"

# The paged serving path (phase serve_paged): the same model, engine width
# and cache length, pages of 16 rows in the default pool of 8 x 1024 / 16 =
# 512 pages; 16 requests of which 8 share a 256-token (16-page) prefix.
PAGE = 16
N_PAGES = LM_SLOTS * LM_MAX_LEN // PAGE
SHARED_PREFIX = 256
# serve_paged under pressure: half the pool.  The first 8 requests hold
# 192 pages at admission.  The page counts follow from the requests alone
# (lengths and shared prefix), not from the model: at 256 and 224 pages
# this schedule preempts 8 requests, spills 195 / 161 pages and evicts
# 179 / 181 cached ones; 192 pages cannot hold it.
PRESSURE_PAGES = N_PAGES // 2
PRESSURE_LEAD = 2
# The disaggregated serving path (phase serve_disagg): the same model and
# cache length, one prefill engine of 8 slots and two decode engines of 4,
# serve_lm's requests under each transport and serve_paged's from bf16 and
# int8 pages; the pruned CapsNet behind a pool of two engines; a 2 s seeded
# bursty trace (the launcher's --trace bursty at 60 req/s in the burst)
# against the dense pool autoscaled from one decode engine up to three.
DISAGG_DECODES = 2
DISAGG_SLOTS = 4
DISAGG_TRANSPORTS = ("in_process", "host_staged", "device_to_device")
TRACE_RATE, TRACE_HORIZON, TRACE_SEED = 60.0, 2.0, 0
TRACE_MAX_ENGINES = 3

# The moe and vlm serving paths (phases serve_moe, serve_vlm):
# deepseek-moe-16b at full width with its depth cut to MOE_LAYERS (of 28;
# d_model 2048, 16 x 128 heads over 16 KV heads, 64 routed + 2 shared
# experts of 1408, top-6, vocab 102400) and llama-3.2-vision-90b at full
# width with its depth cut to VLM_LAYERS (one unit of 4 self-attention
# blocks and one cross-attention block; d_model 8192, 64 x 128 query heads
# over 8 KV heads, d_ff 28672, vocab 128256, 1024 image tokens), both with
# bf16 parameters, random weights from seed 0, the engine width and cache
# length of serve_lm and the first FAMILY_REQUESTS of its (or
# serve_paged's) requests: one wave of 8.  bf16 parameters: float32
# deepseek-moe-16b and the engine's bf16 copy would need 101 GB.  The moe
# depth pays for the checks of ROADMAP §C 3-4 (the scatter dispatch, both
# models disaggregated over FAMILY_TRANSPORTS, the vlm cross path with
# image features: every cross gate at VLM_GATE, VLM_PROMPT prompt tokens,
# VLM_DECODE_STEPS decode steps), which run at the same widths.
MOE_ARCH = "deepseek-moe-16b"
MOE_LAYERS = 6
VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 5
FAMILY_REQUESTS = 8
QWEN3_REQUESTS = 4
RECURRENT_REQUESTS = 4
FAMILY_CUTS = {MOE_ARCH: ["param_dtype float32 -> bfloat16",
                          f"n_layers 28 -> {MOE_LAYERS}"],
               VLM_ARCH: ["param_dtype float32 -> bfloat16",
                          f"n_layers 100 -> {VLM_LAYERS} (1 unit: 4 "
                          f"self-attention + 1 cross-attention block)"]}
# The second dense model and the large configurations (phases serve_qwen3,
# serve_large; ROADMAP §C 4), each cache mode through serve_family_mode on
# serve_lm's engine width and cache length: the kernel path (rows 3, 5 or 7
# / 8, and 9) against the plain path by the margin rule, the seeded tokens
# bit-identical across two kernel runs; no tick breakdown, disaggregation
# or scatter dispatch (serve_moe's and serve_vlm's checks, which these
# models would repeat).  qwen3-1.7b (28 layers, d_model 2048, 16 x 128
# query heads over 8 KV heads (G 2), qk-norm, vocab 151936) at full width
# with float32 parameters, as serve_lm, its depth cut to QWEN3_LAYERS (the
# published size runs through the launcher), on the first QWEN3_REQUESTS of
# serve_lm's requests from dense slots and of serve_paged's from bf16 and
# int8 pages (16 each at 28 layers took the script 98 s on an H100, of a
# budget it could not spare; 8 took 41.5 s).
# Then, at full width with bf16 parameters, random weights from seed 0 and
# the depth cut to LARGE_LAYERS (the whole models need 220-492 GB), on the
# first FAMILY_REQUESTS requests: qwen1.5-110b (d_model 8192, 64 x 128 over
# 8 (G 8), QKV bias, d_ff 49152, vocab 152064) from dense slots;
# mistral-large-123b (d_model 12288, 96 x 128 over 8: G 12, two chunks of
# the decode kernel's 8 heads; d_ff 28672, vocab 32768) from dense slots and
# int8 pages; dbrx-132b (d_model 6144, 48 x 128 over 8 (G 6), 16 experts of
# 10752 top-4, vocab 100352) from dense slots with its admission tick's moe
# numbers (aux loss, capacities, drops) as serve_moe prints them.
QWEN3_ARCH = "qwen3-1.7b"
QWEN3_LAYERS = 14
QWEN3_MODES = ("dense", "paged", "paged_int8")
LARGE_LAYERS = 4
LARGE_MODES = (("qwen1.5-110b", ("dense",)),
               ("mistral-large-123b", ("dense", "paged_int8")),
               ("dbrx-132b", ("dense",)))
FAMILY_CUTS.update({
    QWEN3_ARCH: [f"requests {LM_REQUESTS} -> {QWEN3_REQUESTS}",
                 f"n_layers 28 -> {QWEN3_LAYERS} (the published size "
                 f"runs through the launcher: serve_hybrid's "
                 f"launcher_runs)"],
    **{arch: ["param_dtype float32 -> bfloat16",
              f"n_layers {layers} -> {LARGE_LAYERS}"]
       for arch, layers in (("qwen1.5-110b", 80), ("mistral-large-123b", 88),
                            ("dbrx-132b", 40))}})
FAMILY_TRANSPORTS = ("in_process", "device_to_device")
VLM_GATE = 0.5
VLM_PROMPT = 256
VLM_DECODE_STEPS = 8

# The recurrent and audio paths (phases serve_ssm, serve_hybrid,
# encode_audio), with float32 parameters: xlstm-1.3b (48 layers: 6 units of
# 7 mLSTM blocks and 1 sLSTM block, d_model 2048, 4 heads, vocab 50304)
# with its depth cut to SSM_LAYERS for the serve against the plain path and
# the in_process handoff, and zamba2-1.2b (38 Mamba-2 layers and one shared
# attention + MLP block at 6 sites, 32 heads of 64, vocab 32000) with its
# depth cut to HYBRID_LAYERS (3 sites) for the same and for its bf16 run,
# on serve_lm's engine width and cache length and the first
# RECURRENT_REQUESTS of its requests, unified, then disaggregated (one prefill
# engine of LM_SLOTS slots, DISAGG_DECODES decode engines of DISAGG_SLOTS,
# in_process).  Then each model at the published size over the other two
# transports (RECURRENT_TRANSPORTS), on those requests whose prompts are at
# least RECURRENT_HANDOFF_PROMPT tokens long, cut to that length (xlstm:
# one admission group of one 256-token chunk, where an odd length costs
# seconds a prompt to admit, ROADMAP A6c), against a plain engine of the
# published model; zamba2 with bf16 parameters against its plain engine;
# and the launcher at --no-reduced
# (LAUNCHER_RUNS: each recurrent model and qwen3-1.7b serves, hubert is
# refused as the reference refuses audio, mistral-large-123b by the fit
# check before a weight is drawn).  hubert-xlarge (48 bidirectional layers,
# d_model 1280, 16 heads of 80) runs through lm.forward on AUDIO_CLIPS
# clips of AUDIO_FRAMES frames of features drawn from seed 0.  The audio
# bar: the kernel forward (flash_attention) and the plain forward (chunked
# attention), both bf16, differ by at most AUDIO_RATIO times what the plain
# bf16 forward differs from the float32 forward, as largest absolute
# difference of the final hidden states over their RMS.
SSM_ARCH = "xlstm-1.3b"
SSM_LAYERS = 8
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_LAYERS = 18
AUDIO_ARCH = "hubert-xlarge"
AUDIO_CLIPS, AUDIO_FRAMES = 8, 1000
AUDIO_RATIO = 2.0
RECURRENT_TRANSPORTS = ("host_staged", "device_to_device")
RECURRENT_HANDOFF_PROMPT = 256
RECURRENT_HANDOFF_NEW = 16
LAUNCHER_ARGS = ("--no-reduced", "--requests", "1", "--max-new", "4",
                 "--decode-kernel", "--attn-impl", "cuda")
# (arch, exit code, what its output must hold)
LAUNCHER_RUNS = (
    (HYBRID_ARCH, 0, "rid=0: "),
    (SSM_ARCH, 0, "rid=0: "),
    (AUDIO_ARCH, 1, "encoder-only arch has no decode path"),
    (QWEN3_ARCH, 0, "rid=0: "),
    # refused by check_fits before a weight is drawn
    ("mistral-large-123b", 1,
     "mistral-large-123b: the parameters and caches need"))

# The families' training path (phase train_family, ROADMAP §C 6): each LM
# family the reference trains, at full width with float32 parameters, bf16
# compute, attn_impl "chunked" (the attention kernels refuse a gradient)
# and its config's remat; TRAIN_FAMILY_STEPS Trainer steps from seed 0,
# AdamW at TRAIN_LM_LR after TRAIN_FAMILY_WARMUP warmup steps (cosine over
# the run), each step bracketed by CUDA events, batch TRAIN_FAMILY_BATCH x
# TRAIN_FAMILY_SEQ (hubert: AUDIO_FRAMES frames of features and 504-way
# labels drawn from RandomState(step)).  Bars: every loss finite, the mean
# of the last three below the mean of the first three.  The dry run counts
# each step on the meta device (arguments, peak temporaries, bound) beside
# the measured peak and step.  Depth is cut only where that count does not
# fit the card: deepseek-moe-16b to MOE_TRAIN_LAYERS of 28, xlstm-1.3b to
# SSM_LAYERS of 48 (as serve_ssm; its count traces the sLSTM time loop
# step by step, so it is not taken here); zamba2-1.2b (remat_group 2) and
# hubert-xlarge train at the published size.
#
# Two paths of one function are held against each other (the moe's one-hot
# and scatter dispatch, chunked and reference attention): loss and
# gradients on a held-out batch within TRAIN_LM_*_TOL, as train_lm's
# attention check, with PAIR_CHECK_DTYPE compute.  The moe's and hubert's
# bf16 readings are recorded beside and not held (pair_checks; the vlm's
# would cost the script 17 s on an H100).  In bf16 the two paths round
# at other places, which is no scale for these checks: the moe's combine
# rounds differently, which flips the next layer's top-k for near-tied
# tokens, and a flipped token moves its whole contribution from one
# expert's gradient to another's; under the near-uniform attention of
# hubert's 1,000 random frames the wq / wk gradients are two orders of
# magnitude below wv's and mostly rounding; the vlm's untied unembedding
# has its gradient on the batch's label columns, so its RMS is no scale for
# its largest difference (embed/tok's case in train_lm).  In float32 the
# paths agree to their summation order.
#
# The moe: aux > 0 at every step; one-hot against scatter, the router's
# gradient finite and non-zero; LAKP over each layer's routed experts
# (MOE_PRUNE_SPARSITY), held-out loss before and after; the pruned model
# served through the kernels against the plain path (serve_against_plain),
# no (token, expert) pair routed to a pruned expert.  xlstm and zamba2: one
# block of each kind (mLSTM, sLSTM; Mamba-2) at full width and float32
# compute, loss <output, a fixed random projection> on a (1, BLOCK_SEQ,
# d_model) input, on the card against the same call on the CPU: the loss
# within BLOCK_TOL of the sum of its terms' magnitudes, each gradient's
# largest difference within BLOCK_TOL of its largest magnitude (float32
# sums in other orders; a lost or wrong gradient moves a leaf by its own
# size).  zamba2 also through the launcher (TRAIN_LAUNCHER_ARGS: the
# published config, on the card).  hubert: chunked against reference
# attention (non-causal) on GRAD_CHECK_CLIPS clips.  llama-3.2-vision-90b
# takes no step: an AdamW step of one unit at full width does not fit one
# card (the count is in its line), so one unit (VLM_GRAD_LAYERS layers: 4
# self + 1 cross) takes loss and gradients only, every cross gate at
# VLM_GATE, chunked against reference, every cross leaf and embed/img_proj
# with a finite, non-zero gradient.
TRAIN_FAMILY_STEPS, TRAIN_FAMILY_WARMUP = 6, 3
TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ = 4, 512
MOE_TRAIN_LAYERS = 2
MOE_PRUNE_SPARSITY = 0.25
PAIR_CHECK_DTYPE = "float32"
GRAD_CHECK_CLIPS = 2
BLOCK_SEQ = 512
BLOCK_TOL = 1e-3
VLM_GRAD_LAYERS = 5
VLM_GRAD_BATCH, VLM_GRAD_SEQ = 2, 256
FAMILY_TRAIN_CUTS = {
    MOE_ARCH: [f"n_layers 28 -> {MOE_TRAIN_LAYERS}"],
    SSM_ARCH: [f"n_layers 48 -> {SSM_LAYERS} (1 unit: 7 mLSTM + 1 sLSTM "
               f"block)"],
    VLM_ARCH: [f"n_layers 100 -> {VLM_GRAD_LAYERS} (1 unit: 4 "
               f"self-attention + 1 cross-attention block)",
               "no AdamW step: loss and gradients only"]}
TRAIN_LAUNCHER_STEPS = 2
TRAIN_LAUNCHER_ARGS = ("--arch", HYBRID_ARCH, "--steps",
                       str(TRAIN_LAUNCHER_STEPS), "--batch", "2", "--seq",
                       "256", "--log-every", "1")

# Valid lengths of the kernel phase's paged and int8 decode cases: 0, 1, a
# page boundary, the full 1024 rows and lengths in between.  (The timing
# rows use the serve_paged tick's own lengths, paged_valid().)
PAGED_VALID = (0, 1, 16, 1024, 700, 17, 512, 300)
PAGED_CASE = {"dims": (LM_SLOTS, LM_MAX_LEN, 32, 8, 64),
              "paged": (N_PAGES, PAGE, LM_MAX_LEN // PAGE), "shuffled": True}

# The kernel table: one row per TPU entry point, with the registry kernel
# that replaces it, where that kernel lives, and the shape the main paths
# give it (serve_pruned at batch 32: 252 capsules after compaction; the
# serve_lm prefill at 8 x 1024 positions and its decode tick over 8 slots;
# the serve_paged decode tick over the 512-page pool; flash_attention_dequant,
# which no model path calls, at a continuation prefill's shape).  The decode
# rows' "valid" lengths are filled in by phase_timings.
KERNELS = {
    "fused_routing": {
        "kernel": "fused_routing",
        "route": "cuda", "source": "src/repro_torch/csrc/routing.cu",
        "replaces": "src/repro/kernels/routing/routing_kernel.py:93",
        "main_case": {"shape": (BATCH, 252, 10, 16), "softmax_mode": "taylor"},
    },
    "taylor_softmax": {
        "kernel": "taylor_softmax",
        "route": "cuda", "source": "src/repro_torch/csrc/softmax.cu",
        "replaces": "src/repro/kernels/softmax/kernel.py:43",
        "main_case": {"shape": (BATCH, 252, 10), "scale": 1.0},
    },
    # the backward of row 2 has no TPU kernel: the reference takes jax.grad
    # of its plain softmax (the function at approx_math.py:65); its main
    # shape is train_capsnet's optimized steps (1152 capsules, batch 32)
    "taylor_softmax_bwd": {
        "kernel": "taylor_softmax_bwd",
        "route": "cuda", "source": "src/repro_torch/csrc/softmax.cu",
        "replaces": "src/repro/core/approx_math.py:65",
        "main_case": {"shape": (BATCH, 1152, 10), "scale": 1.0},
    },
    "flash_attention": {
        "kernel": "flash_attention",
        "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:108",
        "main_case": {"dims": (LM_SLOTS, LM_MAX_LEN, LM_MAX_LEN, 32, 8, 64),
                      "dtype": "bfloat16", "causal": True},
    },
    "flash_attention_dequant": {
        "kernel": "flash_attention_dequant",
        "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:214",
        "main_case": {"dims": (LM_SLOTS, 256, LM_MAX_LEN, 32, 8, 64),
                      "dtype": "bfloat16", "causal": True, "q_offset": 768},
    },
    "decode_attention": {
        "kernel": "decode_attention",
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:387",
        "main_case": {"dims": (LM_SLOTS, LM_MAX_LEN, 32, 8, 64),
                      "dtype": "bfloat16"},
    },
    "decode_attention_dequant": {
        "kernel": "decode_attention",
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:417",
        "main_case": {"dims": (LM_SLOTS, LM_MAX_LEN, 32, 8, 64),
                      "dtype": "bfloat16", "quant": True},
    },
    "decode_attention_paged": {
        "kernel": "decode_attention",
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:450",
        "main_case": {**PAGED_CASE, "dtype": "bfloat16"},
    },
    "decode_attention_paged_dequant": {
        "kernel": "decode_attention",
        "route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:491",
        "main_case": {**PAGED_CASE, "dtype": "bfloat16", "quant": True},
    },
    "fused_sampling": {
        "kernel": "fused_sampling",
        "route": "cuda", "source": "src/repro_torch/csrc/sampling.cu",
        "replaces": "src/repro/kernels/sampling/kernel.py:29",
        "main_case": {"dims": (LM_SLOTS, 128256),
                      "temperature": (0.0,) * LM_SLOTS},
    },
    # no TPU kernel: the reference leaves its projections to XLA's dot (the
    # MLP's output projection, the product of ROADMAP §C Open 1); its main
    # shape is that product in serve_lm's prefill of 8 x 1024 positions
    "fixed_order_matmul": {
        "kernel": "fixed_order_matmul",
        "route": "cuda", "source": "src/repro_torch/csrc/gemm.cu",
        "replaces": "src/repro/models/mlp.py:38",
        "main_case": {"dims": (LM_SLOTS * LM_MAX_LEN, 2048, 8192),
                      "dtype": "bfloat16", "rng": "device"},
    },
}


def table_row(name: str, case) -> str:
    """The kernel-table row a registry kernel's case belongs to."""
    if name != "decode_attention":
        return name
    body = ("paged" if case.get("paged") else "dense") if not case.get(
        "quant") else ("paged_int8" if case.get("paged") else "int8")
    return DECODE_ROWS[body]


# The kernels' plain versions where the registry's reference is an oracle
# of another form (the other kernels' references are their plain versions).
PLAIN = {"flash_attention": flash_attention_plain,
         "flash_attention_dequant": flash_attention_dequant_plain,
         "decode_attention": decode_attention_plain}

# Sampling rows of the serve mix: greedy and (0.8, top-k 50, top-p 0.9).
MIXED = {"temperature": (0.8,) * LM_SLOTS, "top_k": (50,) * LM_SLOTS,
         "top_p": (0.9,) * LM_SLOTS}
# greedy and sampled rows in one call, with and without each restriction
MIXED_ROWS = {"temperature": (0.0, 0.8, 1.0, 0.0, 1.3, 0.7, 0.0, 0.9),
              "top_k": (0, 50, 0, 0, 7, 1, 0, 40000),
              "top_p": (1.0, 0.9, 0.5, 1.0, 1.0, 0.95, 1.0, 0.99)}
# decode_attention's split counts, and its four layouts at the serve
# widths and at qwen3's (D 128, G 2; 128 pages of 16 rows, 32 a slot)
DECODE_SPLITS = (1, 2, 4, 8)
DECODE_LAYOUTS = (
    {"dims": (8, 1024, 32, 8, 64), "dtype": "bfloat16"},
    {"dims": (8, 1024, 32, 8, 64), "dtype": "bfloat16", "quant": True},
    {**PAGED_CASE, "dtype": "bfloat16"},
    {**PAGED_CASE, "dtype": "bfloat16", "quant": True},
)
QWEN_PAGED = {"dims": (4, 512, 16, 8, 128), "paged": (128, 16, 32),
              "shuffled": True}
QWEN_LAYOUTS = (
    {"dims": (4, 512, 16, 8, 128), "dtype": "bfloat16"},
    {"dims": (4, 512, 16, 8, 128), "dtype": "bfloat16", "quant": True},
    {**QWEN_PAGED, "dtype": "bfloat16"},
    {**QWEN_PAGED, "dtype": "bfloat16", "quant": True},
)
def split_threads(case: dict, splits: int) -> int:
    """The most threads (the base 256 down, whole warps) whose decode block
    holds ``splits`` splits' state in shared memory at ``case``'s head dim
    and bf16 or int8 cache."""
    from repro_torch.kernels.limits import MAX_DYNAMIC_SMEM

    kv_bytes = 1 if case.get("quant") else 2
    threads = 256
    while decode_smem_bytes(case["dims"][-1], threads, kv_bytes,
                            splits) > MAX_DYNAMIC_SMEM:
        threads -= 32
    return threads


SPLIT_VALID = ((0, 1, 31, 32, 33, 1024, 100, 200),
               (255, 256, 257, 127, 129, 1023, 511, 513))
# decode_attention at serve_moe's widths (D 128, G 1; its pool of 512 pages
# of 16 rows) and serve_vlm's (D 128, G 8)
MOE_PAGED = {"dims": (LM_SLOTS, LM_MAX_LEN, 16, 16, 128),
             "paged": (N_PAGES, PAGE, LM_MAX_LEN // PAGE), "shuffled": True}
MOE_LAYOUTS = (
    {"dims": (LM_SLOTS, LM_MAX_LEN, 16, 16, 128), "dtype": "bfloat16"},
    {**MOE_PAGED, "dtype": "bfloat16"},
    {**MOE_PAGED, "dtype": "bfloat16", "quant": True},
)
VLM_DECODE = {"dims": (LM_SLOTS, LM_MAX_LEN, 64, 8, 128), "dtype": "bfloat16"}
# encode_audio's flash call, serve_hybrid's prefill (the longest prompt) and
# decode (one of its 6 sites)
AUDIO_FLASH = {"dims": (AUDIO_CLIPS, AUDIO_FRAMES, AUDIO_FRAMES, 16, 16, 80),
               "dtype": "bfloat16", "causal": False, "atol": 1e-2}
HYBRID_FLASH = {"dims": (1, 700, 700, 32, 32, 64), "dtype": "bfloat16",
                "causal": True, "atol": 1e-2}
HYBRID_DECODE = {"dims": (LM_SLOTS, LM_MAX_LEN, 32, 32, 64),
                 "dtype": "bfloat16"}
# serve_large's geometries: mistral-large-123b's prefill and decode (96
# query heads over 8, G 12: flash q_block 4, so 48 of a block's 64 rows
# hold queries; two decode chunks of 6 heads) and dbrx-132b's (48 over 8, G
# 6: q_block 8, 48 rows; one decode block a KV head), D 128 both; the
# decode caches of 8 slots of 1024 rows, paged as serve_paged's pool
LARGE_FLASH = {
    "mistral-large-123b": {"dims": (LM_SLOTS, LM_MAX_LEN, LM_MAX_LEN, 96, 8,
                                    128), "dtype": "bfloat16",
                           "causal": True},
    "dbrx-132b": {"dims": (LM_SLOTS, LM_MAX_LEN, LM_MAX_LEN, 48, 8, 128),
                  "dtype": "bfloat16", "causal": True}}
G12_DIMS = (LM_SLOTS, LM_MAX_LEN, 96, 8, 128)
G12_PAGED = {"dims": G12_DIMS, "paged": (N_PAGES, PAGE, LM_MAX_LEN // PAGE),
             "shuffled": True}
G12_LAYOUTS = (
    {"dims": G12_DIMS, "dtype": "bfloat16"},
    {"dims": G12_DIMS, "dtype": "bfloat16", "quant": True},
    {**G12_PAGED, "dtype": "bfloat16"},
    {**G12_PAGED, "dtype": "bfloat16", "quant": True},
)
G6_DECODE = {"dims": (LM_SLOTS, LM_MAX_LEN, 48, 8, 128), "dtype": "bfloat16"}

# The fixed-order GEMM at llama3.2-1b's projections (d 2048, 32 query and
# 8 KV heads of 64, d_ff 8192, the tied unembed over V 128256 read as the
# (V, d) table's transpose): serve_lm's prefill of 8 x 1024 positions, its
# decode tick's 8 slots and serve_lm's other schedule's 3.  (label, N, K,
# w layout); the inputs are drawn on the card (8192 x 8192 and the
# unembed's table take seconds in numpy).
GEMM_PROJECTIONS = (("q", 2048, 2048, "kn"), ("k, v", 512, 2048, "kn"),
                    ("o", 2048, 2048, "kn"), ("wi, wg", 8192, 2048, "kn"),
                    ("wo", 2048, 8192, "kn"))
GEMM_UNEMBED = ("unembed V 128256", 128256, 2048, "nk")
GEMM_PREFILL_M = LM_SLOTS * LM_MAX_LEN
GEMM_ATOL = 4e-2          # one bf16 step of an output below 8


def gemm_case(m: int, n: int, k: int, layout: str) -> dict:
    return {"dims": (m, n, k), "dtype": "bfloat16", "layout": layout,
            "rng": "device", "atol": GEMM_ATOL}


# (label, case) of each timed GEMM geometry: every projection at the
# prefill's M and the tick's, the unembed at the tick's (a prefill
# unembeds only each prompt's last row: M = its group)
GEMM_TIMINGS = tuple(
    (f"llama3.2-1b {label}, {phase} M {m}", gemm_case(m, n, k, layout))
    for phase, m in (("prefill", GEMM_PREFILL_M), ("decode", LM_SLOTS))
    for label, n, k, layout in GEMM_PROJECTIONS + (
        (GEMM_UNEMBED,) if phase == "decode" else ()))

# Main-path shapes beyond the registry's example cases.  Tolerances: the
# kernels sum in another order than the plain versions and use rsqrtf/expf,
# so float32 agrees to a few ulp of values <= 1 (1e-5 exact routing, 1e-4
# with the polynomial, whose five squarings multiply a rounding difference by
# 32; 1e-6 for the softmax alone; 2e-5 for exact float32 attention over up
# to 1024 rows); bfloat16 outputs round at 2^-8 (1e-2); attention with the
# polynomial exp is held against the exact oracle (5e-2, the approximation's
# own error); sampled tokens are integers and must be equal (0).  The int8
# caches are held against the dequantizing oracle on the same int8 rows, so
# the quantization error cancels and the same tolerances hold.
EXTRA_CASES = {
    "fused_routing": (
        {"shape": (BATCH, 252, 10, 16), "softmax_mode": "exact", "atol": 1e-5},
        {"shape": (BATCH, 252, 10, 16), "softmax_mode": "taylor", "atol": 1e-4},
        {"shape": (BATCH, 1152, 10, 16), "softmax_mode": "exact", "atol": 1e-5},
        {"shape": (BATCH, 1152, 10, 16), "softmax_mode": "taylor", "atol": 1e-4},
        {"shape": (BATCH, 252, 10, 16), "softmax_mode": "taylor",
         "dtype": "bfloat16", "atol": 1e-2},
        # D not a power of two: the agreement step's path without shuffles
        {"shape": (2, 20, 3, 12), "softmax_mode": "taylor", "atol": 1e-4},
        # bf16 at the dense shape; 72-byte bf16 rows (slices staged by 8-byte
        # cp.async) and 30-byte ones (staged element by element)
        *({"shape": (BATCH, 1152, 10, 16), "softmax_mode": mode,
           "dtype": "bfloat16", "atol": 1e-2} for mode in ("exact", "taylor")),
        {"shape": (2, 20, 3, 12), "softmax_mode": "taylor",
         "dtype": "bfloat16", "atol": 1e-2},
        {"shape": (3, 7, 3, 5), "softmax_mode": "exact", "dtype": "bfloat16",
         "atol": 1e-2},
        # small and odd batches (the SLO scheduler's buckets and the last
        # tick of a run): 8 blocks an image, ragged capsule ranges at I = 252
        *({"shape": (b, i, 10, 16), "softmax_mode": mode,
           "atol": 1e-5 if mode == "exact" else 1e-4}
          for b in (1, 3, 17) for i in (252, 1152)
          for mode in ("exact", "taylor")),
        # every cluster size that fits, at both main shapes
        *({"shape": (BATCH, 252, 10, 16), "softmax_mode": "taylor",
           "atol": 1e-4, "config": {"i_splits": n}} for n in (1, 2, 4, 8)),
        *({"shape": (BATCH, 1152, 10, 16), "softmax_mode": "taylor",
           "atol": 1e-4, "config": {"i_splits": n, "threads": t}}
          for n in (4, 8) for t in (256, 1024)),
    ),
    "taylor_softmax": (
        {"shape": (BATCH * 252, 10), "scale": 1.0, "atol": 1e-6},
        {"shape": (BATCH, 252, 10), "scale": 1.0, "atol": 1e-6},
        {"shape": (BATCH, 252, 10), "scale": 1.0, "dtype": "bfloat16",
         "atol": 1e-2},
        {"shape": (1, 1024), "atol": 1e-6},
        # row counts that are no multiple of the tile, an unaligned tail
        # (7 floats a row), and N at both sides of the tile kernel's 32
        {"shape": (1000, 10), "atol": 1e-6},
        {"shape": (999, 7), "atol": 1e-6},
        {"shape": (513, 9), "dtype": "bfloat16", "scale": 3.0, "atol": 1e-2},
        {"shape": (4000, 32), "atol": 1e-6},
        {"shape": (4000, 33), "atol": 1e-6},
        {"shape": (100, 17), "atol": 1e-6},
    ),
    # the optimized routing's training shapes, dense (1152 capsules) and
    # compacted (252), float32 and bf16; rows with entries exactly on the
    # clip edge (x - max = -32) and past it; the tile body's ragged tail,
    # the warp body and the block body
    "taylor_softmax_bwd": (
        *({"shape": (BATCH, caps, 10), "scale": 1.0, "dtype": dt,
           "atol": 1e-6 if dt == "float32" else 1e-2}
          for caps in (1152, 252) for dt in ("float32", "bfloat16")),
        {"shape": (BATCH, 252, 10), "scale": 1.0, "edge": True,
         "atol": 1e-6},
        {"shape": (999, 7), "atol": 1e-6},
        {"shape": (4000, 33), "atol": 1e-6},
        {"shape": (8, 4096), "atol": 1e-6},
    ),
    "flash_attention": (
        # the serve_lm prefill: 8 prompts rounded up to 1024 positions
        {"dims": (LM_SLOTS, LM_MAX_LEN, LM_MAX_LEN, 32, 8, 64),
         "dtype": "bfloat16", "causal": True, "atol": 1e-2},
        {"dims": (8, 512, 512, 32, 8, 64), "dtype": "bfloat16",
         "causal": True, "atol": 1e-2},
        {"dims": (8, 512, 512, 32, 8, 64), "dtype": "bfloat16",
         "causal": True, "softmax_mode": "taylor", "atol": 5e-2},
        {"dims": (2, 1024, 1024, 32, 8, 64), "dtype": "bfloat16",
         "causal": True, "atol": 1e-2},
        # qwen3 widths (D = 128, G = 2), S not a power of two
        {"dims": (1, 192, 192, 16, 8, 128), "dtype": "bfloat16",
         "causal": True, "atol": 1e-2},
        {"dims": (2, 256, 256, 32, 8, 64), "causal": True, "atol": 2e-5},
        # continuation prefill: 100 fresh rows after 412 cached ones
        {"dims": (2, 100, 512, 32, 8, 64), "causal": True, "q_offset": 412,
         "atol": 2e-5},
        # the tensor-core body off the serve shape: non-causal, a ragged
        # continuation (S and T not multiples of the 64-row tiles), G = 1
        # (one position per block row), and D = 16
        {"dims": (2, 64, 256, 8, 2, 32), "dtype": "bfloat16",
         "causal": False, "atol": 1e-2},
        {"dims": (2, 100, 512, 32, 8, 64), "dtype": "bfloat16",
         "causal": True, "q_offset": 412, "atol": 1e-2},
        {"dims": (1, 192, 192, 8, 8, 64), "dtype": "bfloat16",
         "causal": True, "atol": 1e-2},
        {"dims": (2, 128, 128, 8, 4, 16), "dtype": "bfloat16",
         "causal": True, "atol": 1e-2},
        # serve_moe's prefill (G = 1, D = 128) and serve_vlm's: the
        # self-attention (G = 8) and the non-causal cross-attention over
        # 1024 image tokens, at the full bucket and a short prompt's
        *({"dims": dims, "dtype": "bfloat16", "causal": causal, "atol": 1e-2}
          for dims, causal in (((8, 1024, 1024, 16, 16, 128), True),
                               ((8, 1024, 1024, 64, 8, 128), True),
                               ((8, 1024, 1024, 64, 8, 128), False),
                               ((8, 32, 1024, 64, 8, 128), False))),
        # encode_audio's attention (D = 80, padded to 128 in shared memory,
        # non-causal) in both bodies, causal and ragged too; serve_hybrid's
        # shared-block prefill (G = 1, D = 64, one exact-length prompt)
        AUDIO_FLASH,
        # serve_large's prefill at G 12 (q_block 4) and G 6 (q_block 8), and
        # G 12 ragged, float32 and Eq. 2
        *({**case, "atol": 1e-2} for case in LARGE_FLASH.values()),
        {"dims": (2, 300, 300, 96, 8, 128), "dtype": "bfloat16",
         "causal": True, "atol": 1e-2},
        {"dims": (1, 300, 300, 96, 8, 128), "causal": True, "atol": 2e-5},
        {"dims": (2, 256, 256, 96, 8, 128), "dtype": "bfloat16",
         "causal": True, "softmax_mode": "taylor", "atol": 5e-2},
        {"dims": (2, 1000, 1000, 16, 16, 80), "causal": False, "atol": 2e-5},
        {"dims": (2, 300, 300, 16, 16, 80), "dtype": "bfloat16",
         "causal": True, "atol": 1e-2},
        {"dims": (1, 77, 77, 16, 16, 80), "causal": True, "atol": 2e-5},
        {"dims": (1, 77, 77, 16, 16, 80), "dtype": "bfloat16",
         "causal": False, "softmax_mode": "taylor", "atol": 5e-2},
        HYBRID_FLASH,
    ),
    "decode_attention": (
        {"dims": (8, 1024, 32, 8, 64), "dtype": "bfloat16",
         "valid": (0, 1, 1023, 1024, 700, 17, 512, 300), "atol": 1e-2},
        {"dims": (8, 1024, 32, 8, 64), "dtype": "bfloat16",
         "valid": (0, 1, 1023, 1024, 700, 17, 512, 300),
         "softmax_mode": "taylor", "atol": 5e-2},
        {"dims": (8, 1024, 32, 8, 64),
         "valid": (1024, 1, 1023, 33, 700, 17, 512, 300), "atol": 2e-5},
        # a float32 model's query against the bfloat16 cache
        {"dims": (8, 1024, 32, 8, 64), "kv_dtype": "bfloat16",
         "valid": (1024, 1, 1023, 33, 700, 17, 512, 300), "atol": 2e-5},
        {"dims": (4, 512, 16, 8, 128), "dtype": "bfloat16",
         "valid": (512, 100, 0, 333), "atol": 1e-2},
        # serve_paged: 512 pages of 16 rows, 8 slots with shuffled tables
        # and -1 sentinels past each slot's write head
        {**PAGED_CASE, "dtype": "bfloat16", "valid": PAGED_VALID,
         "atol": 1e-2},
        {**PAGED_CASE, "dtype": "bfloat16", "valid": PAGED_VALID,
         "softmax_mode": "taylor", "atol": 5e-2},
        {**PAGED_CASE, "valid": PAGED_VALID, "atol": 2e-5},
        {**PAGED_CASE, "dtype": "bfloat16", "quant": True,
         "valid": PAGED_VALID, "atol": 1e-2},
        {**PAGED_CASE, "quant": True, "valid": PAGED_VALID,
         "softmax_mode": "taylor", "atol": 5e-2},
        {**PAGED_CASE, "quant": True, "valid": PAGED_VALID, "atol": 2e-5},
        # the int8 dense cache of a gathered view of the int8 pool
        {"dims": (8, 1024, 32, 8, 64), "dtype": "bfloat16", "quant": True,
         "valid": PAGED_VALID, "atol": 1e-2},
        {"dims": (8, 1024, 32, 8, 64), "quant": True, "valid": PAGED_VALID,
         "softmax_mode": "taylor", "atol": 5e-2},
        # the split-KV edges at the default split count, all four layouts:
        # lengths at and around one tile, below one split, split
        # boundaries +- 1 (n = 256 splits into 8 whole tiles, 255 and 257
        # into ragged ones), ranges shorter than kv_splits tiles
        *({**lay, "valid": valid, "atol": 1e-2}
          for lay in DECODE_LAYOUTS for valid in SPLIT_VALID),
        # every kv_splits of the space, all four layouts, qwen3 widths
        # (past what the plan gives 512 rows, so each at a block size that
        # holds its splits)
        *({**lay, "valid": (512, 100, 0, 333), "atol": 1e-2,
           "config": {"kv_splits": n, "threads": split_threads(lay, n)}}
          for lay in QWEN_LAYOUTS for n in DECODE_SPLITS),
        # serve_moe's decode (G = 1, D = 128: dense slots, bf16 and int8
        # pages) and serve_vlm's self-attention decode (G = 8, D = 128)
        *({**lay, "valid": valid, "atol": 1e-2}
          for lay in MOE_LAYOUTS + (VLM_DECODE,)
          for valid in (PAGED_VALID,) + SPLIT_VALID),
        # serve_hybrid's decode at each shared-attention site (G = 1, D 64)
        *({**HYBRID_DECODE, "valid": valid, "atol": 1e-2}
          for valid in (PAGED_VALID,) + SPLIT_VALID),
        # serve_large's decode: G 12 (two chunks of 6) in all four
        # layouts and G 6, the served layouts at the split edges too; G 12
        # float32 and Eq. 2; G 20 and 40 (two and three chunks of a KV
        # head's heads)
        *({**lay, "valid": PAGED_VALID, "atol": 1e-2}
          for lay in G12_LAYOUTS + (G6_DECODE,)),
        *({**lay, "valid": valid, "atol": 1e-2}
          for lay in (G12_LAYOUTS[0], G12_LAYOUTS[3], G6_DECODE)
          for valid in SPLIT_VALID),
        {"dims": G12_DIMS, "valid": PAGED_VALID, "atol": 2e-5},
        {**G12_PAGED, "quant": True, "valid": PAGED_VALID, "atol": 2e-5},
        {"dims": G12_DIMS, "dtype": "bfloat16", "valid": PAGED_VALID,
         "softmax_mode": "taylor", "atol": 5e-2},
        *({"dims": (LM_SLOTS, LM_MAX_LEN, 8 * g, 8, d), "dtype": "bfloat16",
           "valid": PAGED_VALID, "atol": 1e-2}
          for g, d in ((20, 128), (40, 64))),
        {"dims": (LM_SLOTS, LM_MAX_LEN, 160, 8, 64), "dtype": "bfloat16",
         "quant": True, "paged": (N_PAGES, PAGE, LM_MAX_LEN // PAGE),
         "shuffled": True, "valid": PAGED_VALID, "atol": 1e-2},
    ),
    "flash_attention_dequant": (
        # a continuation prefill of 256 rows after 768 cached int8 rows
        {"dims": (LM_SLOTS, 256, LM_MAX_LEN, 32, 8, 64), "dtype": "bfloat16",
         "causal": True, "q_offset": 768, "atol": 1e-2},
        {"dims": (2, 256, 1024, 32, 8, 64), "causal": True, "q_offset": 768,
         "atol": 2e-5},
        {"dims": (2, 256, 1024, 32, 8, 64), "dtype": "bfloat16",
         "causal": True, "q_offset": 768, "softmax_mode": "taylor",
         "atol": 5e-2},
        {"dims": (2, 64, 256, 8, 2, 32), "dtype": "bfloat16",
         "causal": False, "atol": 1e-2},
    ),
    # the GEMM against cuBLAS at every timed geometry and, for every BN
    # class, at 3 slots, at 65 rows (the second consumer warpgroup's first
    # row) and at a ragged prefill's 1000 rows (no multiple of the 128-row
    # tile)
    "fixed_order_matmul": tuple(case for _, case in GEMM_TIMINGS) + tuple(
        gemm_case(m, n, k, layout)
        for m in (3, 65, 1000)
        for _, n, k, layout in GEMM_PROJECTIONS + (GEMM_UNEMBED,)),
    "fused_sampling": (
        {"dims": (8, 128256), "temperature": (0.0,) * 8, "atol": 0},
        {"dims": (8, 128256), **MIXED, "atol": 0},
        # each vocabulary (a cluster of 8 blocks a row, the one size that
        # holds it); all greedy, all sampled, and mixed rows
        *({"dims": (8, v), **rows, "atol": 0}
          for v in (128256, 151936)
          for rows in ({"temperature": (0.0,) * 8}, MIXED, MIXED_ROWS,
                       {"temperature": (1.0,) * 8})),
        # V that no cluster size divides (and V % 4 != 0: scalar loads)
        {"dims": (8, 128257), **MIXED_ROWS, "atol": 0},
        {"dims": (4, 100003), "temperature": (0.0, 1.0, 0.7, 0.0),
         "top_k": (0, 0, 20, 0), "top_p": (1.0, 0.5, 1.0, 1.0), "atol": 0},
        # serve_moe's vocabulary, serve_ssm's and serve_hybrid's, and
        # serve_large's: qwen1.5-110b's 152064 (the repo's largest),
        # dbrx-132b's and mistral-large-123b's
        *({"dims": (8, v), **rows, "atol": 0}
          for v in (102400, 50304, 32000, 152064, 100352, 32768)
          for rows in ({"temperature": (0.0,) * 8}, MIXED, MIXED_ROWS)),
    ),
}


def port_env() -> dict:
    """This process's environment with the checkout's ``src`` first on
    PYTHONPATH, for the port's launchers in processes of their own."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def clocks_line() -> str:
    """The card's SM and memory clocks and power draw as ``nvidia-smi``
    reads them now (MHz, MHz, W)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def median_ms(fn, launches: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``launches`` back-to-back
    calls, by CUDA events, after a warm-up.  The inputs stay in L2 between
    calls, as they are on the serve path (u_hat was just written)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


# (I, J, D, element bytes, i_splits) at which the routing wrapper's mirror
# of the kernel's shared memory is held against the library's own sum
SMEM_CHECKS = ((252, 10, 16, 4, 4), (1152, 10, 16, 4, 4),
               (1152, 10, 16, 4, 8), (1152, 10, 16, 2, 4), (20, 3, 12, 2, 8),
               (7, 3, 5, 2, 8))


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = build.load_library()
    for dims in SMEM_CHECKS:
        if lib.fused_routing_smem_bytes(*dims) != routing_smem_bytes(*dims):
            fail(f"build: routing shared memory at {dims}: the library "
                 f"sizes {lib.fused_routing_smem_bytes(*dims)} bytes, the "
                 f"wrapper {routing_smem_bytes(*dims)}")
    emit("build", seconds=time.perf_counter() - t0,
         library=str(build.build_dir()), sources=list(build.SOURCES),
         private_stream_query=hasattr(torch._C, "_cuda_getCurrentRawStream"))


def case_shape(case) -> list:
    return list(case.get("shape") or case.get("dims"))


def case_key(name: str, case) -> tuple:
    """A case's kernel-table row, shape and type: the geometry its errors
    and launches are summed under (valid lengths and sampling rows
    apart)."""
    return (table_row(name, case), tuple(case_shape(case)),
            case.get("dtype", "float32"))


def phase_kernels() -> tuple:
    """Every kernel against its reference on the card (the plain version,
    or for attention the exact float32 oracle, which the exact-mode plain
    version equals), paged and int8 decode cases included; returns the
    largest error per kernel-table row, the launches of
    flash_attention_dequant here (no model path calls it), and the largest
    error and the launches per geometry (case_key)."""
    worst = dict.fromkeys(KERNELS, 0.0)
    by_case = {}
    reset_counts()
    for name in registry.names():
        spec = registry.get(name)
        wrapper = spec.build()
        for case in tuple(spec.example_cases) + EXTRA_CASES[name]:
            launched = wrapper.launches
            atol = case.get("atol", 0)
            args, kwargs = spec.make_example(case, device=DEVICE)
            cfg = {**registry.default_config(name, *args, **kwargs),
                   **case.get("config", {})}
            got = as_tuple(wrapper(*args, **kwargs, **cfg))
            torch.cuda.synchronize()
            want = as_tuple(spec.ref_call(*args, **kwargs))
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            again = as_tuple(wrapper(*args, **kwargs, **cfg))
            identical = all(torch.equal(a, b) for a, b in zip(got, again))
            extra = {}
            if name in PLAIN and kwargs.get("softmax_mode") == "taylor":
                plain = PLAIN[name](*args, **kwargs)
                extra["max_abs_err_vs_plain_taylor"] = float(
                    (got[0].float() - plain.float()).abs().max())
            row = table_row(name, case)
            emit("kernels", kernel=name, row=row, shape=case_shape(case),
                 dtype=case.get("dtype", "float32"),
                 softmax_mode=kwargs.get("softmax_mode"), config=cfg,
                 max_abs_err=err, atol=atol, bit_identical=identical,
                 **extra)
            if not finite:
                fail(f"{name} {case}: non-finite output")
            if err > atol:
                fail(f"{name} {case}: max abs err {err} > {atol}")
            if not identical:
                fail(f"{name} {case}: two runs differ")
            worst[row] = max(worst[row], err)
            seen = by_case.setdefault(case_key(name, case),
                                      {"launches": 0, "max_abs_err": 0.0})
            seen["launches"] += wrapper.launches - launched
            seen["max_abs_err"] = max(seen["max_abs_err"], err)
    counts = launch_counts()
    for name in BODY_COUNTERS:
        by_body = dict(WRAPPERS[name].launches_by_body)
        if min(by_body.values()) < 1:
            fail(f"kernels: a {name} body never ran: {by_body}")
    emit("kernels", bodies={k: v for k, v in counts.items()
                            if k in DECODE_ROWS or "/" in k})
    emit("kernels", part="contracts", alias=alias_invariance(),
         batch=batch_invariance(), sampling=sampling_contract())
    return worst, flash_attention_dequant_cuda.launches, by_case


# The reference's chi-square check of fused_sampling, at the card's
# width: CHI2_DRAWS draws (one per seed) from one fixed row of CHI2_LANES
# logits at temperature 1, against the softmax law; df = 15, and 45 lies
# past its 1e-4 tail.
CHI2_LANES, CHI2_DRAWS, CHI2_BOUND = 16, 4096, 45.0


def alias_invariance() -> dict:
    """Rows 7 and 8 (the paged bodies) on PAGED_CASE's pool, whose tables
    hold -1 sentinels past each slot's valid pages: launched with the
    sentinels clipped to page 0 and again with them re-clipped to page 6
    (the reference's check, tests/test_decode_kernels.py:196-208).  A
    body reads no row at or past the slot's kv_valid_len, so the outputs
    must be bit-identical; each is held against the plain version at the
    case's tolerance."""
    spec = registry.get("decode_attention")
    n_pages = PAGED_CASE["paged"][0]
    out = {}
    for row, quant in (("decode_attention_paged", False),
                       ("decode_attention_paged_dequant", True)):
        case = {**PAGED_CASE, "dtype": "bfloat16", "valid": PAGED_VALID,
                "quant": quant}
        args, kwargs = spec.make_example(case, device=DEVICE)
        tab = kwargs.pop("tables")
        sentinels = int((tab < 0).sum())
        clipped = torch.clamp(tab, 0, n_pages - 1)
        again = torch.where(tab < 0, (tab + 7) % n_pages, tab)
        if sentinels < 1 or torch.equal(clipped, again):
            fail(f"kernels: the {row} alias case has no sentinel to move")
        cfg = registry.default_config("decode_attention", *args,
                                      tables=clipped, **kwargs)
        got = [decode_attention_cuda(*args, tables=t, **kwargs, **cfg)
               for t in (clipped, again)]
        torch.cuda.synchronize()
        errs = [float((g.float() - spec.ref_call(*args, tables=t, **kwargs)
                       .float()).abs().max())
                for g, t in zip(got, (clipped, again))]
        identical = torch.equal(got[0], got[1])
        out[row] = {"sentinels": sentinels, "bit_identical": identical,
                    "max_abs_err": errs, "atol": 1e-2, "config": cfg}
        if not identical:
            fail(f"kernels: {row} output changes with where the sentinels "
                 f"alias")
        if max(errs) > 1e-2:
            fail(f"kernels: {row} alias case off its plain version by "
                 f"{max(errs)} > 1e-2")
    return out


# One slot's decode query launched among 1, 3, 4 and 8 slots: the decode
# batches of serve_lm's schedules (a request alone, OTHER_SLOTS slots, the
# disaggregated decode engines' DISAGG_SLOTS, LM_SLOTS); the slot is
# PAGED_VALID's 700-row one.
BATCH_SIZES = (1, 3, 4, 8)
BATCH_SLOT = 4


def batch_invariance() -> dict:
    """Rows 5 and 7 (bf16 dense cache and bf16 pages, PAGED_CASE's widths):
    slot BATCH_SLOT launched with the default config first among
    BATCH_SIZES slots (the case's other slots after it) must give the same
    bits in every batch, and agree with the plain version at the row's
    tolerance: the split plan (decode_kv_splits) follows the cache and
    the model, never the batch, as the sampling contract's schedule
    invariance needs.  Beside it the 8-slot
    launch at each kv_splits of the tuning space, held bit for bit against
    the default (reported, not failed: the split count sets a row's sums,
    which is why the plan must not follow the batch; ROADMAP §C)."""
    spec = registry.get("decode_attention")
    order = [BATCH_SLOT] + [i for i in range(LM_SLOTS) if i != BATCH_SLOT]
    out = {}
    for row, paged in (("decode_attention", False),
                       ("decode_attention_paged", True)):
        case = {"dims": PAGED_CASE["dims"], "dtype": "bfloat16",
                "valid": PAGED_VALID}
        if paged:
            case.update(paged=PAGED_CASE["paged"], shuffled=True)
        (q, k, v, valid), kwargs = spec.make_example(case, device=DEVICE)
        got, configs = {}, {}
        for b in BATCH_SIZES:
            idx = torch.tensor(order[:b], device=DEVICE)
            args = (q[idx], k if paged else k[idx], v if paged else v[idx],
                    valid[idx])
            kw = {key: t[idx] if key == "tables" else t
                  for key, t in kwargs.items()}
            configs[b] = registry.default_config("decode_attention", *args,
                                                 **kw)
            got[b] = decode_attention_cuda(*args, **kw, **configs[b])[0]
        full = got[BATCH_SIZES[-1]]
        forced = {}
        for splits in spec.space["kv_splits"]:
            again = decode_attention_cuda(
                *args, **kw, threads=configs[BATCH_SIZES[-1]]["threads"],
                kv_splits=splits)[0]
            forced[splits] = {
                "bit_identical_to_default": torch.equal(again, full),
                "max_abs_diff": float((again.float() - full.float())
                                      .abs().max())}
        err = float((full.float() - spec.ref_call(*args, **kw)[0].float())
                    .abs().max())
        torch.cuda.synchronize()
        differ = [b for b in BATCH_SIZES if not torch.equal(got[b], full)]
        out[row] = {"slot_valid": PAGED_VALID[BATCH_SLOT],
                    "configs": configs, "bit_identical_across_batches":
                    not differ, "max_abs_err": err, "atol": 1e-2,
                    "forced_kv_splits": forced}
        if differ:
            fail(f"kernels: {row}: slot {BATCH_SLOT}'s output changes when "
                 f"it is launched among {differ} slots (configs {configs})")
        if err > 1e-2:
            fail(f"kernels: {row} batch case off its plain version by {err} "
                 f"> 1e-2")
    return out


def sampling_contract() -> dict:
    """Row 9's contract on the card (the reference's
    tests/test_decode_kernels.py:381-435): the chi-square of CHI2_DRAWS
    seeded draws from one fixed row under CHI2_BOUND, the same counters
    drawing the same tokens again and equal to the plain version's; and
    T <= 0 the raw argmax's first maximum, on rows with a planted tie and
    top-k / top-p that must be ignored."""
    rng = np.random.RandomState(0)
    row = (rng.standard_normal(CHI2_LANES) * 1.5).astype(np.float32)
    probs = np.exp(row - row.max())
    probs /= probs.sum()
    n = CHI2_DRAWS
    logits = torch.from_numpy(np.tile(row, (n, 1))).to(DEVICE)
    rows = (torch.ones(n, device=DEVICE),
            torch.arange(n, dtype=torch.int32, device=DEVICE),
            torch.zeros(n, dtype=torch.int32, device=DEVICE),
            torch.zeros(n, dtype=torch.int32, device=DEVICE),
            torch.ones(n, device=DEVICE))
    cfg = registry.default_config("fused_sampling", logits, *rows)
    toks = fused_sampling_cuda(logits, *rows, **cfg)
    again = fused_sampling_cuda(logits, *rows, **cfg)
    plain = registry.get("fused_sampling").ref_call(logits, *rows)
    obs = np.bincount(toks.cpu().numpy(), minlength=CHI2_LANES)
    chi2 = float(((obs - probs * n) ** 2 / (probs * n)).sum())
    if not (chi2 < CHI2_BOUND):
        fail(f"kernels: fused_sampling chi-square {chi2} >= {CHI2_BOUND}")
    if not (torch.equal(toks, again) and torch.equal(toks, plain)):
        fail("kernels: fused_sampling's seeded draws are not a function of "
             "their counters (two runs, or the plain version, differ)")
    # T <= 0: a tie planted at two lanes above every other logit
    b, v = LM_SLOTS, 128256
    rng = np.random.RandomState(5)
    x = rng.standard_normal((b, v)).astype(np.float32)
    lanes = np.sort(rng.choice(v, size=(b, 2), replace=False), axis=1)
    for i, (j1, j2) in enumerate(lanes):
        x[i, j1] = x[i, j2] = x[i].max() + 1.0
    greedy = (torch.from_numpy(x).to(DEVICE),
              torch.tensor([0.0, -1.0] * (b // 2), device=DEVICE),
              torch.arange(b, dtype=torch.int32, device=DEVICE),
              torch.full((b,), 7, dtype=torch.int32, device=DEVICE),
              torch.full((b,), 5, dtype=torch.int32, device=DEVICE),
              torch.full((b,), 0.5, device=DEVICE))
    cfg_g = registry.default_config("fused_sampling", *greedy)
    got = fused_sampling_cuda(*greedy, **cfg_g).cpu().numpy()
    first = torch.argmax(greedy[0], -1).cpu().numpy()
    if not (np.array_equal(got, lanes[:, 0])
            and np.array_equal(first, lanes[:, 0])):
        fail(f"kernels: fused_sampling at T <= 0 drew {got.tolist()}, the "
             f"first maxima are {lanes[:, 0].tolist()}")
    return {"chi2": chi2, "chi2_bound": CHI2_BOUND, "lanes": CHI2_LANES,
            "draws": n, "observed": obs.tolist(),
            "expected": (probs * n).tolist(), "config": cfg,
            "greedy_first_max": True, "greedy_config": cfg_g}


def make_requests(n_requests: int, cfg) -> list:
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(n_requests):
        n = int(rng.randint(1, 2 * BATCH))           # 1 .. 63 frames
        reqs.append(ImageRequest(
            images=rng.rand(n, cfg.image_hw, cfg.image_hw,
                            cfg.in_channels).astype(np.float32), rid=i))
    return reqs


# the wrappers that count their launches per body, and their bodies' keys
# in launch_counts(): decode_attention's by DECODE_ROWS' keys, the flash
# wrappers' as "<wrapper>/tensor_core" and "<wrapper>/fma"
BODY_COUNTERS = ("decode_attention", "flash_attention",
                 "flash_attention_dequant", "fixed_order_matmul")


def reset_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0
    for n in fused_routing_cuda.launches_by_splits:
        fused_routing_cuda.launches_by_splits[n] = 0
    for name in BODY_COUNTERS:
        by_body = WRAPPERS[name].launches_by_body
        for body in by_body:
            by_body[body] = 0


def launch_counts() -> dict:
    """Launches since the last reset_counts(), by wrapper, and by body for
    decode_attention (keys of DECODE_ROWS) and the flash wrappers."""
    out = {k: w.launches for k, w in WRAPPERS.items()}
    out.update(decode_attention_cuda.launches_by_body)
    for name in ("flash_attention", "flash_attention_dequant"):
        for body, n in WRAPPERS[name].launches_by_body.items():
            out[f"{name}/{body}"] = n
    return out


def check_prefill_bodies(phase: str, counts: dict) -> None:
    """Every prefill launch of a bf16 serve path took the tensor-core
    body, none the FMA body."""
    tc, fma = (counts["flash_attention/tensor_core"],
               counts["flash_attention/fma"])
    if tc != counts["flash_attention"] or fma:
        fail(f"{phase}: prefill launched the tensor-core body {tc} and the "
             f"FMA body {fma} times of {counts['flash_attention']}")


def serve(deployed, requests):
    """Serve ``requests`` through a fresh CapsuleEngine; the launch counts
    are set to 0 after the warm-up and read right after the run."""
    engine = deployed.serve(batch_size=BATCH)
    engine.warmup()
    reset_counts()
    for r in requests:
        engine.submit(ImageRequest(images=r.images, rid=r.rid))
    completions = engine.run_until_idle()
    counts = {k: w.launches for k, w in WRAPPERS.items()}
    counts["routing_by_i_splits"] = {
        str(n): k for n, k in fused_routing_cuda.launches_by_splits.items()
        if k}
    return completions, engine.stats(), counts


def forward_breakdown(deployed, n_forwards: int = 20) -> dict:
    """Where a full tick's time goes, at the engine's batch size.

    ``step_wall_ms``: host wall-clock of the engine's own step (pinned copy
    in, forward, copy out; median of 20), through the replayed graph, then
    eager (``_eager``), then the graph again.  ``forward_wall_ms``: host
    wall-clock per forward of ``n_forwards`` back-to-back forwards ending in
    a synchronise, graph then eager; ``forward_device_ms_graph`` a replayed
    forward's device span by CUDA events.  ``device_busy_ms``: the sum of the kernels' device times
    per forward from a ``torch.profiler`` trace that holds every launch
    (None when every trace dropped events: profile_ms), with the busiest
    kernels by name; the device's idle share of a forward is what is left
    of the wall-clock."""
    cfg = deployed.cfg
    rng = np.random.RandomState(1)
    batch = rng.rand(BATCH, cfg.image_hw, cfg.image_hw,
                     cfg.in_channels).astype(np.float32)
    engine = deployed.serve(batch_size=BATCH)
    engine.warmup()
    out = {}
    for key, scope in (("step_wall_ms", contextlib.nullcontext),
                       ("step_wall_ms_eager", graphs.eager),
                       ("step_wall_ms_graph_again", contextlib.nullcontext)):
        walls = []
        with scope():
            for _ in range(20):
                t0 = time.perf_counter()
                engine.forward_host(batch)
                walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        out[key] = walls[len(walls) // 2]

    x = torch.from_numpy(batch).to(DEVICE)
    for key, fn in (("forward_wall_ms", deployed.forward),
                    ("forward_wall_ms_eager", deployed._forward_eager)):
        fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_forwards):
            fn(x)
        torch.cuda.synchronize()
        out[key] = (time.perf_counter() - t0) * 1e3 / n_forwards
    # the device's span of one replayed forward (the copy in, the graph,
    # the copy of the lengths out), by CUDA events
    out["forward_device_ms_graph"] = median_ms(lambda: deployed.forward(x))

    kernels, _, info = profile_ms(lambda: deployed.forward(x), n_forwards)
    out.update(busy_numbers(kernels, info, 6, out["forward_wall_ms"],
                            "device_idle_share_of_forward"))
    return out


# M1, the counting rule: the profiler drops kernel events from a trace,
# all of them or some, while the host's launch calls stay in the trace (on
# an H100, minutes into this script: the first trace of a timing row drops
# events and a second one holds them all; a trace of engine ticks lacks 6
# to 36 of its thousands of launches, on a second try too).  A trace counts
# only when it holds every launch the traced calls made: each wrapper's own
# count (its ``launches`` counter) and every kernel at all (the host's
# launch calls in the same trace); otherwise it is taken again, and after
# PROFILE_ATTEMPTS reported as None with ``trace_dropped``.  TRACES tallies
# the traces of a run (the ``done`` line): taken, dropped with no kernel
# event, dropped with some.  A trace of engine ticks is long and costly to
# take and to read: TRACED_TICKS ticks (two, to fit the script's time
# limit), TICK_TRACE_ATTEMPTS times at most.
PROFILE_ATTEMPTS = 3
TRACED_TICKS = 2
TICK_TRACE_ATTEMPTS = 1
TRACED_REDUCED = [f"traced ticks a trace 4 -> {TRACED_TICKS}",
                  f"attempts at a tick trace 2 -> {TICK_TRACE_ATTEMPTS}"]
TRACES = {"taken": 0, "dropped_empty": 0, "dropped_partial": 0}
# the host events of a kernel launch (cudaLaunchKernel*, cuLaunchKernel*)
LAUNCH_CALLS = ("LaunchKernel", "LaunchCooperativeKernel")
# device rows that are copies or fills, not kernels
NOT_KERNELS = ("Memcpy", "Memset")


def trace_rule(rows, expected: dict, n_calls: int) -> tuple:
    """The counting rule over one profiler trace.

    ``rows``: ``(name, count, device_us)`` for each device row of the
    trace (``key_averages()``: the events seen and their summed time).
    ``expected``: ``{fragment: launches}``, the launches the ``n_calls``
    traced calls made of the rows whose names hold ``fragment``; ``""``
    stands for every kernel, which leaves out copies and fills
    (NOT_KERNELS: no kernel launch makes them).  Returns ``(ms, info)``:
    ``ms`` is the device ms per call by row name, or None when the trace
    holds no row or any fragment's events differ from its launches
    (``info["trace_dropped"]``); ``info["ms_per_launch"]`` gives each
    fragment's device time over the events seen."""
    kernels = [r for r in rows if not r[0].startswith(NOT_KERNELS)]

    def matching(f):
        return [r for r in (kernels if f == "" else rows) if f in r[0]]

    seen = {f: sum(c for _, c, _ in matching(f)) for f in expected}
    info = {"events": seen, "launches": dict(expected)}
    if not rows or any(seen[f] != n for f, n in expected.items()):
        return None, dict(info, trace_dropped=True)
    ms = {}
    for n, _, us in rows:
        ms[n] = ms.get(n, 0.0) + us / 1e3 / n_calls
    info["ms_per_launch"] = {
        f: sum(us for _, _, us in matching(f)) / 1e3 / seen[f]
        for f in expected if seen[f]}
    return ms, dict(info, trace_dropped=False)


def wrapper_launches() -> dict:
    return {k: w.launches for k, w in WRAPPERS.items()}


def expected_launches(before: dict, after: dict, host_calls: int) -> dict:
    """trace_rule's ``expected`` for one trace: the host's launch calls
    for every kernel, and each wrapper's launches (its counter's growth)
    under its kernel's name fragment (KERNEL_EVENT); a fragment inside
    another wrapper's (``taylor_softmax`` in ``taylor_softmax_bwd``)
    expects that wrapper's launches too."""
    out = {"": host_calls}
    for frag in set(KERNEL_EVENT.values()):
        n = sum(after[k] - before[k] for k, f in KERNEL_EVENT.items()
                if frag in f)
        if n:
            out[frag] = n
    return out


def profile_ms(fn, n_calls: int, attempts: int = PROFILE_ATTEMPTS,
               expect=None) -> tuple:
    """``(device ms per call by kernel or None, host ms per call by
    operation, trace info)`` from a ``torch.profiler`` trace of ``n_calls``
    calls that holds every launch they made (trace_rule), taken up to
    ``attempts`` times.  Device: kernel, copy and fill events only (an
    operator's entry repeats the device time of the kernels it launched).
    Host: self CPU time of each operator and CUDA runtime call, with the
    profiler's own overhead in it.  ``expect`` adds launches the counters
    cannot see (``{"Memcpy": n}``: a copy a call).  The info says whether
    the last trace was dropped, its events and launches, and the attempts
    taken.  The traced calls run eagerly (``graphs.eager``, ``"eager"`` in
    the info): a graph's replay makes no launch call on the host, so the
    counting rule could not hold a trace of one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            before = wrapper_launches()
            with graphs.eager():
                for _ in range(n_calls):
                    fn()
            torch.cuda.synchronize()
            after = wrapper_launches()
        rows, host, calls = [], {}, 0
        for ev in prof.key_averages():
            name = ev.key[:60]
            if ev.device_type != DeviceType.CUDA:
                host[name] = ev.self_cpu_time_total / 1e3 / n_calls
                if any(c in ev.key for c in LAUNCH_CALLS):
                    calls += ev.count
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            rows.append((name, ev.count, us))
        kernels, info = trace_rule(
            rows, {**expected_launches(before, after, calls),
                   **(expect or {})}, n_calls)
        info["attempts"] = attempt
        info["eager"] = True
        TRACES["taken"] += 1
        if kernels is not None:
            break
        TRACES["dropped_partial" if info["events"].get("") else
               "dropped_empty"] += 1
    return kernels, host, info


def kernel_ms_of(fn, name: str, n_calls: int = 20) -> tuple:
    """``(device ms per launch of kernel-table row name's kernel, trace
    info)`` from profile_ms; the ms is None when every trace dropped
    events."""
    kernels, _, info = profile_ms(fn, n_calls)
    if kernels is None:
        return None, info
    return info["ms_per_launch"].get(KERNEL_EVENT[name]), info


def device_ms_of(kernels, name: str):
    """Device ms per call of kernel-table row ``name``'s kernel in a
    profile_ms breakdown (None for a dropped trace)."""
    if kernels is None:
        return None
    return sum(v for k, v in kernels.items() if KERNEL_EVENT[name] in k)


def busy_numbers(kernels, info, top: int, wall_ms=None,
                 key: str = "device_idle_share") -> dict:
    """A breakdown's device numbers from one profile_ms trace: the busy
    ms (None for a dropped trace), the idle share of ``wall_ms``, the
    ``top`` busiest kernels, and the trace's kernel events against its
    launches (``trace``: whether it was dropped, and after how many
    attempts)."""
    busy = sum(kernels.values()) if kernels else None
    out = {"device_busy_ms": busy, "trace_dropped": info["trace_dropped"],
           "trace": {"kernel_events": info["events"].get(""),
                     "launches": info["launches"].get(""),
                     "attempts": info["attempts"],
                     "eager": info.get("eager", True)},
           "device_ms_by_kernel": dict(sorted(
               (kernels or {}).items(), key=lambda kv: -kv[1])[:top])}
    if wall_ms is not None:
        out[key] = max(0.0, 1.0 - busy / wall_ms) if busy else None
    return out


def phase_serve(phase: str, prune: bool, n_requests: int) -> dict:
    """Full-width capsnet-mnist through FastCapsPipeline and CapsuleEngine,
    once with the fused routing kernel (variant ``cuda``) and once with the
    unfused variant ``optimized``, on the same parameters and requests."""
    cfg = cfg_lib.get_config("capsnet-mnist")
    pipe = FastCapsPipeline(cfg, device=DEVICE).build(seed=0)
    if prune:
        pipe.prune(0.6, 0.9, type_keep=7).compact()
    fused = pipe.compile(routing="cuda")
    unfused = pipe.compile(routing="optimized")
    want_caps = 252 if prune else 1152
    if fused.cfg.n_primary_caps != want_caps:
        fail(f"{phase}: {fused.cfg.n_primary_caps} capsules, "
             f"expected {want_caps}")
    requests = make_requests(n_requests, fused.cfg)

    done, stats, counts = serve(fused, requests)
    done_ref, _, counts_ref = serve(unfused, requests)
    if counts["fused_routing"] != stats.ticks:
        fail(f"{phase}: routing kernel launched {counts['fused_routing']} "
             f"times in {stats.ticks} ticks")
    if counts_ref["taylor_softmax"] != stats.ticks * fused.cfg.routing_iters:
        fail(f"{phase}: softmax kernel launched "
             f"{counts_ref['taylor_softmax']} times by the unfused variant")
    if len(done) != n_requests or len(done_ref) != n_requests:
        fail(f"{phase}: {len(done)} of {n_requests} requests completed")
    by_rid = {c.rid: c for c in done}
    by_rid_ref = {c.rid: c for c in done_ref}
    max_err, ambiguous = 0.0, 0
    for r in requests:
        c, c_ref = by_rid[r.rid], by_rid_ref[r.rid]
        if c.lengths.shape != (len(r.images), fused.cfg.n_classes):
            fail(f"{phase}: rid {r.rid} has lengths {c.lengths.shape}")
        if not np.isfinite(c.lengths).all():
            fail(f"{phase}: rid {r.rid} has non-finite lengths")
        max_err = max(max_err, float(np.abs(c.lengths - c_ref.lengths).max()))
        # classes must agree wherever the winner is clear of the tolerance
        top2 = np.sort(c_ref.lengths, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2e-4
        ambiguous += int((~clear).sum())
        if not np.array_equal(c.classes[clear], c_ref.classes[clear]):
            fail(f"{phase}: rid {r.rid} classes differ between variants")
    if max_err > 1e-4:
        fail(f"{phase}: lengths differ by {max_err} > 1e-4 between variants")
    graph_numbers = {"cuda": capsnet_graphs(phase, fused, requests),
                     "optimized": capsnet_graphs(phase, unfused, requests)}

    lat = stats.latency_summary()
    emit(phase, capsules=fused.cfg.n_primary_caps, params=fused.n_params,
         mflop_per_image=fused.flops_per_image / 1e6,
         requests=stats.completed, frames=stats.frames, ticks=stats.ticks,
         padded_frames=stats.padded_frames, fps=stats.fps,
         ms_per_tick=stats.ms_per_tick,
         latency_ms={k: {"n": n, "p50": p50, "p95": p95}
                     for k, (n, p50, p95) in lat.items()},
         routing_launches=counts["fused_routing"],
         routing_by_i_splits=counts["routing_by_i_splits"],
         routing_config_at_batch=registry.default_config(
             "fused_routing", torch.empty(
                 (BATCH, fused.cfg.n_primary_caps, fused.cfg.n_classes,
                  fused.cfg.digit_dim), device=DEVICE)),
         softmax_launches_unfused=counts_ref["taylor_softmax"],
         max_abs_err_vs_optimized=max_err, ambiguous_frames=ambiguous,
         graphs=graph_numbers, **forward_breakdown(fused))
    return {"fused_routing": counts["fused_routing"],
            "taylor_softmax": counts_ref["taylor_softmax"]}


def capsnet_classes(deployed, x: np.ndarray) -> tuple:
    """Classes and capsule lengths of ``deployed`` on the images ``x``, in
    slices of 256."""
    lengths = []
    for i in range(0, len(x), 256):
        lengths.append(deployed.forward(
            torch.from_numpy(x[i:i + 256]).to(DEVICE)).cpu().numpy())
    lengths = np.concatenate(lengths)
    return lengths.argmax(-1), lengths


def clear_margin(lengths: np.ndarray) -> np.ndarray:
    top2 = np.sort(lengths, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > TRAIN_MARGIN


def timed_steps(trainer, walls: list) -> None:
    """Wrap the trainer's step so each one's host wall-clock, from a
    synchronised start to a synchronised end, is appended to ``walls``."""
    inner = trainer.train_step

    def step(params, opt_state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.train_step = step


def optimized_training(cfg, batches) -> dict:
    """Full-width steps through RoutingSpec.optimized() (see OPT_STEPS)."""
    from repro_torch import kernels as kernels_pkg
    from repro_torch.core import approx_math

    ocfg = dataclasses.replace(cfg, routing=RoutingSpec.optimized())
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    params = capsnet.init(ocfg, gen, DEVICE)
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in next(batches(seed=3)).items()}

    def grads():
        live = {k: {kk: v.detach().clone().requires_grad_(True)
                    for kk, v in sub.items()} for k, sub in params.items()}
        loss, _ = capsnet.loss_fn(live, ocfg, batch["images"],
                                  batch["labels"])
        loss.backward()
        return float(loss.detach()), {f"{k}/{kk}": v.grad
                                      for k, sub in live.items()
                             for kk, v in sub.items()}

    before = taylor_softmax_bwd_cuda.launches
    loss_kernel, g_kernel = grads()
    first_launches = taylor_softmax_bwd_cuda.launches - before
    real = kernels_pkg.taylor_softmax
    kernels_pkg.taylor_softmax = approx_math.taylor_softmax
    try:
        loss_plain, g_plain = grads()
    finally:
        kernels_pkg.taylor_softmax = real
    rel = {k: float((g_kernel[k] - g_plain[k]).abs().max()
                    / g_plain[k].abs().max().clamp(min=1e-30))
           for k in g_plain}
    worst = max(rel, key=rel.get)
    if rel[worst] > OPT_GRAD_TOL or not all(
            bool(torch.isfinite(g).all()) for g in g_kernel.values()):
        fail(f"train_capsnet: the optimized routing's gradient {worst} is "
             f"{rel[worst]} of its largest value off the plain softmax's "
             f"(bar {OPT_GRAD_TOL})")
    if first_launches != 2:
        fail(f"train_capsnet: one optimized loss backward launched the "
             f"softmax backward {first_launches} times, expected 2")

    def loss_fn(p, b):
        return capsnet.loss_fn(p, ocfg, b["images"], b["labels"])

    trainer = Trainer(TrainerConfig(optim=AdamWConfig(
        lr=FT_LR, weight_decay=0.0, warmup_steps=OPT_WARMUP,
        total_steps=OPT_STEPS), log_every=1), loss_fn, lambda g: params,
        device=DEVICE)
    walls = []
    timed_steps(trainer, walls)
    before = taylor_softmax_bwd_cuda.launches
    res = trainer.run(batches(seed=11), OPT_STEPS)
    launched = taylor_softmax_bwd_cuda.launches - before
    losses = [h["loss"] for h in res.history]
    if (len(losses) != OPT_STEPS or not all(np.isfinite(losses))
            or not np.mean(losses[-5:]) < np.mean(losses[:5])):
        fail(f"train_capsnet: the optimized routing's loss went "
             f"{losses[:5]} ... {losses[-5:]}")
    if launched != 2 * OPT_STEPS:
        fail(f"train_capsnet: {OPT_STEPS} optimized steps launched the "
             f"softmax backward {launched} times, expected "
             f"{2 * OPT_STEPS}")
    walls.sort()
    return {"steps": OPT_STEPS, "loss_kernel": loss_kernel,
            "loss_plain": loss_plain, "grad_rel_err_worst": rel[worst],
            "grad_rel_err_worst_leaf": worst, "grad_tol": OPT_GRAD_TOL,
            "loss_first5": float(np.mean(losses[:5])),
            "loss_last5": float(np.mean(losses[-5:])),
            "step_wall_ms_median": walls[len(walls) // 2],
            "bwd_launches": first_launches + launched}


def resume_check(cfg, loss_fn, batches) -> dict:
    """A save -> crash -> resume run against an uninterrupted one, at full
    width on the card, with cuDNN deterministic for this check only (set
    back after).  Also repeats one step from the same state and names the
    leaves whose gradients differ, the op to look at when the two runs
    disagree."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def trainer(d):
            tcfg = TrainerConfig(
                optim=AdamWConfig(lr=TRAIN_LR, weight_decay=0.0,
                                  warmup_steps=2, total_steps=RESUME_STEPS),
                ckpt_dir=d, ckpt_every=RESUME_EVERY, log_every=RESUME_EVERY)
            return Trainer(tcfg, loss_fn,
                           lambda g: capsnet.init(cfg, g, DEVICE),
                           device=DEVICE)

        with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
            ref = trainer(os.path.join(d, "a")).run(batches(), RESUME_STEPS)
            crashed = False
            try:
                trainer(os.path.join(d, "b")).run(batches(), RESUME_STEPS,
                                                  crash_at=RESUME_CRASH)
            except RuntimeError:
                crashed = True
            last = ckpt_lib.list_steps(os.path.join(d, "b"))[-1]
            res = trainer(os.path.join(d, "b")).run(
                itertools.islice(batches(), last, None), RESUME_STEPS)
        gaps = {f"{k}/{kk}": float((a - res.params[k][kk]).abs().max())
                for k, sub in ref.params.items() for kk, a in sub.items()}
        # one step twice from the same state: which gradients differ
        step = make_train_step(loss_fn, TrainerConfig(), donate=False)
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in next(batches()).items()}
        p1, _, _ = step(ref.params, ref.opt_state, batch)
        p2, _, _ = step(ref.params, ref.opt_state, batch)
        repeat = {f"{k}/{kk}": float((a - p2[k][kk]).abs().max())
                  for k, sub in p1.items() for kk, a in sub.items()}
    finally:
        torch.backends.cudnn.deterministic = was
    worst = max(gaps, key=gaps.get)
    return {"crashed": crashed, "resumed_from": last, "steps": res.step,
            "max_abs_gap": gaps[worst], "worst_leaf": worst,
            "repeat_step_differs": {k: v for k, v in repeat.items() if v},
            "cudnn_deterministic_during_check": True,
            "cudnn_deterministic_after": torch.backends.cudnn.deterministic}


def phase_train_capsnet() -> dict:
    """The paper's Fig. 6 pipeline on the card at full width: train ->
    LAKP prune -> masked fine-tune -> compact -> compile (cuda, reference,
    optimized) -> serve the test set through CapsuleEngine; float32 with
    TF32 off.  Returns the routing and softmax launches of the phase."""
    t_phase = time.perf_counter()
    # training runs before any compile(), which is where DeployedCapsNet
    # switches TF32 off: do it here, before the first step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tf32 = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    cfg = cfg_lib.get_config("capsnet-mnist")
    t0 = time.perf_counter()
    data = sd.load(sd.DigitsConfig(n_train=TRAIN_N, n_test=TEST_N, seed=0))
    data_s = time.perf_counter() - t0
    tr_x, tr_y = data["train"]
    te_x, te_y = data["test"]

    def loss_fn(p, b):
        return capsnet.loss_fn(p, cfg, b["images"], b["labels"])

    def batches(seed=0):
        for bx, by in sd.batches(tr_x, tr_y, BATCH, seed, epochs=1000):
            yield {"images": bx, "labels": by}

    reset_counts()
    # 1. dense training, every step timed on the host
    tcfg = TrainerConfig(optim=AdamWConfig(
        lr=TRAIN_LR, weight_decay=0.0, warmup_steps=TRAIN_STEPS // 10,
        total_steps=TRAIN_STEPS), log_every=10)
    trainer = Trainer(tcfg, loss_fn, lambda g: capsnet.init(cfg, g, DEVICE),
                      device=DEVICE)
    walls = []
    timed_steps(trainer, walls)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    res = trainer.run(batches(), TRAIN_STEPS, generator=gen)
    train_s = time.perf_counter() - t0
    losses = [h["loss"] for h in res.history]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train_capsnet: the loss went {losses[0]} -> {losses[-1]}")
    n_dense = capsnet.param_count(res.params)

    # the step's device time, from a trace of a few more steps
    step = make_train_step(loss_fn, tcfg, donate=False)
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in next(batches(seed=1)).items()}
    state = [res.params, res.opt_state]

    def one_step():
        state[0], state[1], _ = step(state[0], state[1], batch)

    one_step()
    kernels, host, trace = profile_ms(one_step, TRAIN_PROFILE_STEPS)
    busy = sum(kernels.values()) if kernels else None
    walls_sorted = sorted(walls)
    step_ms = walls_sorted[len(walls_sorted) // 2]

    acc_dense = accuracy(lambda x: capsnet.forward(res.params, cfg, x)[0]
                         .argmax(-1), te_x, te_y, torch.device(DEVICE))
    if not acc_dense > 0.5:
        fail(f"train_capsnet: dense test accuracy {acc_dense} <= 0.5")

    # 2. LAKP prune (serve_pruned's cut) + masked fine-tuning
    pipe = FastCapsPipeline(cfg, params=res.params, device=DEVICE)
    pipe.prune(0.6, 0.9, type_keep=7)
    m1, m2 = pipe.masks

    def finetune(masked, masks):
        ft = Trainer(
            TrainerConfig(optim=AdamWConfig(
                lr=FT_LR, weight_decay=0.0, warmup_steps=1,
                total_steps=FT_STEPS), log_every=FT_STEPS),
            loss_fn, lambda g: masked,
            mask_fn=lambda g: pruning.mask_gradients(g, masks),
            device=DEVICE)
        return ft.run(batches(seed=7), FT_STEPS).params

    t0 = time.perf_counter()
    pipe.finetune(finetune)
    ft_s = time.perf_counter() - t0
    for name, m in (("conv1", m1), ("conv2", m2)):
        left = int((pipe.params[name]["w"][m == 0] != 0).sum())
        if left:
            fail(f"train_capsnet: {left} masked {name} weights are not 0 "
                 f"after fine-tuning")
    acc_pruned = accuracy(lambda x: capsnet.forward(pipe.params, pipe.cfg, x)
                          [0].argmax(-1), te_x, te_y, torch.device(DEVICE))
    if not acc_pruned >= acc_dense - 0.15:
        fail(f"train_capsnet: pruned + fine-tuned accuracy {acc_pruned} "
             f"below dense {acc_dense} - 0.15")

    # 3. compact and deploy three ways
    pipe.compact()
    want_caps = min(7, cfg.caps_types) * cfg.caps_out_hw ** 2     # 252
    if pipe.cfg.n_primary_caps != want_caps:
        fail(f"train_capsnet: {pipe.cfg.n_primary_caps} capsules after "
             f"compaction, expected {want_caps}")
    deps = {r: pipe.compile(routing=r)
            for r in ("reference", "cuda", "optimized")}
    classes, lengths = {}, {}
    for r, dep in deps.items():
        classes[r], lengths[r] = capsnet_classes(dep, te_x)
    clear = clear_margin(lengths["reference"])
    for r in ("cuda", "optimized"):
        if not np.array_equal(classes[r][clear], classes["reference"][clear]):
            fail(f"train_capsnet: {r} classes differ from the reference's")
    acc_c = {r: float((classes[r] == te_y).mean()) for r in deps}

    # 4. serve the test set through CapsuleEngine with the routing kernel
    rng = np.random.RandomState(0)
    cuts = np.sort(rng.choice(np.arange(1, TEST_N), size=15, replace=False))
    reqs = [ImageRequest(images=chunk, rid=i)
            for i, chunk in enumerate(np.split(te_x, cuts))]
    engine = deps["cuda"].serve(batch_size=BATCH)
    engine.warmup()
    done = engine.serve(reqs)
    stats = engine.stats()
    served = np.concatenate([c.classes for c in sorted(done,
                                                       key=lambda c: c.rid)])
    if len(done) != len(reqs) or served.shape != te_y.shape:
        fail(f"train_capsnet: {len(done)} of {len(reqs)} requests served")
    if not np.array_equal(served[clear], classes["reference"][clear]):
        fail("train_capsnet: served classes differ from the reference's")
    counts = launch_counts()
    if counts["fused_routing"] < 1 or counts["taylor_softmax"] < 1:
        fail(f"train_capsnet: routing {counts['fused_routing']} and softmax "
             f"{counts['taylor_softmax']} kernel launches")

    # 5. DeployedCapsNet.save, loaded back into the compacted specs
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as d:
        deps["cuda"].save(d)
        loaded = ckpt_lib.load(d, 0, capsnet.specs(deps["cuda"].cfg),
                               device=DEVICE)
    again = FastCapsPipeline(dataclasses.replace(deps["cuda"].cfg,
                                                 routing=None),
                             params=loaded, device=DEVICE).compile("cuda")
    if not np.array_equal(capsnet_classes(again, te_x)[0], classes["cuda"]):
        fail("train_capsnet: the saved and reloaded model classifies "
             "differently")

    # 6. the routing kernel refuses a gradient
    live = {k: {kk: v.detach().clone().requires_grad_(True)
                for kk, v in sub.items()} for k, sub in pipe.params.items()}
    cuda_cfg = dataclasses.replace(pipe.cfg, routing=RoutingSpec.cuda())
    xb = torch.from_numpy(te_x[:BATCH]).to(DEVICE)
    yb = torch.from_numpy(te_y[:BATCH]).to(DEVICE)
    try:
        capsnet.loss_fn(live, cuda_cfg, xb, yb)[0].backward()
        fail("train_capsnet: a loss backward through RoutingSpec.cuda ran")
    except RuntimeError as err:
        refused = str(err)

    # 7. train through RoutingSpec.optimized(): the softmax backward kernel
    optimized = optimized_training(cfg, batches)

    # 8. save -> crash -> resume against an uninterrupted run
    resume = resume_check(cfg, loss_fn, batches)
    if not resume["crashed"] or resume["steps"] != RESUME_STEPS:
        fail(f"train_capsnet: the crash/resume run went wrong: {resume}")
    emit("train_capsnet", arch=cfg.arch_id, **tf32, n_train=TRAIN_N,
         n_test=TEST_N, batch=BATCH, steps=res.step, ft_steps=FT_STEPS,
         data_s=data_s, train_s=train_s, finetune_s=ft_s,
         loss_first=losses[0], loss_last=losses[-1],
         step_wall_ms_median=step_ms, step_wall_ms_min=walls_sorted[0],
         step_wall_ms_max=walls_sorted[-1],
         step_device_busy_ms=busy,
         step_device_idle_share=(max(0.0, 1.0 - busy / step_ms)
                                 if busy else None),
         step_device_ms_by_kernel=dict(sorted(
             (kernels or {}).items(), key=lambda kv: -kv[1])[:6]),
         step_trace_dropped=trace["trace_dropped"],
         step_host_self_ms=sum(host.values()),
         step_host_ms_by_op=dict(sorted(
             host.items(), key=lambda kv: -kv[1])[:6]),
         acc_dense=acc_dense, acc_pruned_finetuned=acc_pruned,
         acc_compacted=acc_c, n_params_dense=n_dense,
         n_params_compacted=deps["cuda"].n_params,
         capsules=deps["cuda"].cfg.n_primary_caps,
         compression=pipe.compression,
         index_overhead=pipe.index_overhead_frac,
         ambiguous_test_images=int((~clear).sum()),
         served_fps=stats.fps, served_frames=stats.frames,
         served_ticks=stats.ticks, routing_launches=counts["fused_routing"],
         softmax_launches=counts["taylor_softmax"], grad_refused=refused,
         optimized=optimized, resume=resume,
         seconds=time.perf_counter() - t_phase)
    if resume["max_abs_gap"] > 1e-6:
        fail(f"train_capsnet: the resumed run is {resume['max_abs_gap']} "
             f"off the uninterrupted one at {resume['worst_leaf']}; leaves "
             f"whose step differs when repeated: "
             f"{resume['repeat_step_differs']}")
    return {"fused_routing": counts["fused_routing"],
            "taylor_softmax": counts["taylor_softmax"],
            "taylor_softmax_bwd": optimized["bwd_launches"]}


def lm_requests(vocab: int, n_requests: int = LM_REQUESTS) -> list:
    """16 requests from RandomState(0): prompts of 16-700 tokens with ids in
    [1, vocab / 2), 32 new tokens; every fourth samples at temperature 0.8
    with top-k 50 and top-p 0.9 and a seed of its own, the others are
    greedy.  ``n_requests`` takes the first n of them."""
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(n_requests):
        n = int(rng.randint(16, 701))
        prompt = [int(t) for t in rng.randint(1, vocab // 2, size=n)]
        kw = {}
        if i % 4 == 3:
            kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=1000 + i)
        reqs.append(Request(prompt=prompt, max_new_tokens=LM_MAX_NEW, rid=i,
                            **kw))
    return reqs


def fresh(reqs: list) -> list:
    return [dataclasses.replace(r, prompt=list(r.prompt)) for r in reqs]


def count_calls(engine, method: str) -> list:
    """Count the calls of one of ``engine``'s hooks (prefill groups, decode
    ticks) by wrapping it on the instance."""
    calls = [0]
    inner = getattr(engine, method)

    def wrapped(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    setattr(engine, method, wrapped)
    return calls


def margin_of(logits_row) -> dict:
    """The top-2 margin of one row of logits and the margin rule's
    threshold for it (MARGIN_RULE)."""
    row = np.asarray(logits_row, dtype=np.float32)
    top2 = np.partition(row, -2)[-2:]
    return {"margin": float(abs(top2[1] - top2[0])),
            "threshold": margin_threshold(float(np.abs(row).max()))}


class Margins(dict):
    """(rid, position) -> margin_of the logits row that token was drawn
    from.  A host-sampled row is kept as recorded (``rows``); a decode
    tick's rows leave on the device only their top two logits and largest
    |logit| (``ticks``: one (B, 3) tensor a tick, ``at``: key -> (tick,
    row)), copied to the host when first read.  A margin is computed when
    first read: a comparison reads few."""

    def __init__(self):
        super().__init__()
        self.rows, self.ticks, self.at, self._host = {}, [], {}, {}

    def __missing__(self, key):
        if key in self.rows:
            value = margin_of(self.rows.pop(key))
        else:
            tick, i = self.at.pop(key)
            if tick not in self._host:
                self._host[tick] = self.ticks[tick].cpu().numpy()
            top1, top2, max_abs = (float(x) for x in self._host[tick][i])
            value = {"margin": abs(top1 - top2),
                     "threshold": margin_threshold(max_abs)}
        self[key] = value
        return value

    def __contains__(self, key):
        return (dict.__contains__(self, key) or key in self.rows
                or key in self.at)


def record_margins(engine) -> Margins:
    """Record, for each host-sampled token of ``engine``, the top-2 margin
    of the logits it was drawn from and its threshold (margin_of), keyed
    by (rid, position)."""
    margins = Margins()
    inner = engine._sample_task_row

    def wrapped(logits_row, task, pos):
        margins.rows[(task.rid, pos)] = np.array(logits_row, np.float32)
        return inner(logits_row, task, pos)

    engine._sample_task_row = wrapped
    return margins


def tick_walls(engine, n_ticks: int) -> dict:
    """``n_ticks`` decode-only ticks by the host clock (a tick ends in the
    copy of the tokens to the host) and by the device's span (CUDA
    events), replayed from the engine's graphs (``tick_wall_ms``), then as
    many eager (``_eager``): the medians.  A kernel engine (every family's
    tick is staged) holds the replays' launches against the counters over
    its graph ticks (replay_window: ``replayed_launches``); a plain
    engine's ticks are eager both times."""
    out = {}
    calls = [sh.tick for sh in engine._shards if sh.tick is not None]
    for suffix, scope in (("", contextlib.nullcontext),
                          ("_eager", graphs.eager)):
        walls, spans = [], []

        def ticks():
            for _ in range(n_ticks):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                engine.tick()
                end.record()
                walls.append((time.perf_counter() - t0) * 1e3)
                spans.append((start, end))

        with scope():
            if calls and not suffix:
                out["replayed_launches"] = replay_window(calls, ticks)
            else:
                ticks()
        torch.cuda.synchronize()
        spans = sorted(a.elapsed_time(b) for a, b in spans)
        walls.sort()
        out[f"tick_wall_ms{suffix}"] = walls[len(walls) // 2]
        out[f"tick_device_span_ms{suffix}"] = spans[len(spans) // 2]
    return out


def decode_tick_breakdown(engine, vocab: int, n_ticks: int = 8,
                          admission_trace: bool = True) -> dict:
    """Where a decode tick's time goes with every slot busy: 8 requests of
    512 prompt tokens, every fourth sampled as in the serve mix, are
    admitted in one tick traced by ``torch.profiler`` (``prefill_tick``:
    the device time of the prefill group and the first step), then
    ``n_ticks`` decode-only ticks are timed by the host clock (a tick ends
    in the copy of the tokens to the host) and TRACED_TICKS more are traced
    (profile_ms: up to TICK_TRACE_ATTEMPTS times, each of TRACED_TICKS more
    ticks, until a trace holds every launch; the admission tick is traced
    once, unless not ``admission_trace``: the families' serves, to fit the
    script's time limit); ``decode_ms`` and ``sampling_ms`` are the decode
    attention and sampling kernels' device time per traced tick (traced
    eagerly: profile_ms); the timed ticks run through the engine's graphs,
    then as many eager (tick_walls).  The
    requests ask for
    the tokens those ticks and served_sampling's draw and two more, so no
    slot empties before the last measured tick and few unmeasured ticks
    follow it."""
    rng = np.random.RandomState(2)
    for i in range(LM_SLOTS):
        kw = {}
        if i % 4 == 3:
            kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=3000 + i)
        engine.submit(Request(
            prompt=[int(t) for t in rng.randint(1, vocab // 2, size=512)],
            max_new_tokens=2 * n_ticks + TRACED_TICKS * TICK_TRACE_ATTEMPTS
            + 3, rid=1000 + i, **kw))
    # admission and the first step: one tick, traced once
    if admission_trace:
        kernels, _, trace = profile_ms(engine.tick, 1, attempts=1)
        prefill = dict(busy_numbers(kernels, trace, 6),
                       flash_ms=device_ms_of(kernels, "flash_attention"))
    else:
        engine.tick()
        prefill = {"not_measured": ["the admission tick's profiler trace"]}
    out = {"prefill_tick": prefill, **tick_walls(engine, n_ticks)}
    kernels, host, trace = profile_ms(engine.tick, TRACED_TICKS,
                                      TICK_TRACE_ATTEMPTS)
    out.update(busy_numbers(kernels, trace, 8, out["tick_wall_ms"],
                            "device_idle_share_of_tick"))
    for key, name in (("decode_ms", "decode_attention"),
                      ("sampling_ms", "fused_sampling")):
        out[key] = device_ms_of(kernels, name)
    out["host_self_ms"] = sum(host.values())
    out["host_ms_by_op"] = dict(
        sorted(host.items(), key=lambda kv: -kv[1])[:12])
    out["sampling_on_served_logits"] = served_sampling(engine)
    out["breakdown_reduced"] = TRACED_REDUCED
    engine.run_until_idle()
    return out


# The profiler's kernel_ms of the served logits is taken for the engine's
# own call only: the other two labels' traces (about 35 s of the script's
# time limit on an H100 over the breakdowns) are measurements given up to
# fit the sampling contract's checks across schedules, not cuts of depth.
SERVED_SAMPLING_NOT_MEASURED = ["kernel_ms by profiler of mixed and of the "
                                "seeded normal logits (their ms by CUDA "
                                "events stays)"]


def served_sampling(engine) -> dict:
    """Row 9 on the logits of one served decode tick: the engine's own
    call (``tick_rows``: every fourth row sampled) and the same logits with
    every row sampled as the serve mix samples (``mixed``), timed as
    ``timing_row`` times the kernel (kernel_ms for ``tick_rows`` only:
    SERVED_SAMPLING_NOT_MEASURED), their tokens held against the plain
    version (equal) and over two runs (bit-identical), and the launch with
    its rows permuted giving its tokens permuted bit for bit (the
    reference's tests/test_decode_kernels.py:410); beside them the
    same timings and the logits' spread on the ``mixed`` timing case's
    seeded normal logits.  The lanes each row keeps under top-k 50 and
    top-p 0.9 at T 0.8 set how many lanes a bisection pass visits (it
    skips those below the current lower end: ``pass_lane_visits_mean``)."""
    from repro_torch import kernels as kernels_pkg

    seen = []
    call = kernels_pkg.fused_sampling_rows

    def capture(logits, rows, **kw):
        if not seen:
            host = rows.cpu().numpy()
            seen.append((logits.clone(), host[0].view(np.float32),
                         host[1].view(np.uint32), host[2], host[3],
                         host[4].view(np.float32)))
        return call(logits, rows, **kw)

    # the tick eager (its graph would not call back into Python), its
    # sampling launch's logits and packed rows kept
    kernels_pkg.fused_sampling_rows = capture
    try:
        with graphs.eager():
            engine.tick()
    finally:
        kernels_pkg.fused_sampling_rows = call
    logits, temp, seeds, pos, top_k, top_p = seen[0]
    b = logits.shape[0]

    def on_device(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).astype(dtype))).to(DEVICE)

    tick_rows = (on_device(temp, np.float32),
                 on_device(np.asarray(seeds).astype(np.uint32)
                           .view(np.int32), np.int32),
                 on_device(pos, np.int32), on_device(top_k, np.int32),
                 on_device(top_p, np.float32))
    mixed_rows = (on_device([0.8] * b, np.float32), tick_rows[1],
                  tick_rows[2], on_device([50] * b, np.int32),
                  on_device([0.9] * b, np.float32))
    spec = registry.get("fused_sampling")
    example, _ = spec.make_example(
        {"dims": (b, logits.shape[1]), **MIXED}, device=DEVICE)
    out = {"sampled_rows_of_tick": int((tick_rows[0] > 0).sum())}
    for label, x, rows in (("tick_rows", logits, tick_rows),
                           ("mixed", logits, mixed_rows),
                           ("mixed, seeded normal logits", example[0],
                            example[1:])):
        cfg = registry.default_config("fused_sampling", x, *rows)

        def run():
            return fused_sampling_cuda(x, *rows, **cfg)

        got, again = run(), run()
        perm = torch.from_numpy(
            np.random.RandomState(4).permutation(b)).to(x.device)
        permuted = fused_sampling_cuda(x[perm], *(r[perm] for r in rows),
                                       **cfg)
        torch.cuda.synchronize()
        if not torch.equal(permuted, got[perm]):
            fail(f"fused_sampling on served logits ({label}): permuting the "
                 f"rows of a launch does not permute its tokens")
        want = spec.ref_call(x, *rows)
        if not torch.equal(got, want):
            fail(f"fused_sampling on served logits ({label}): tokens differ "
                 f"from the plain version's")
        if not torch.equal(got, again):
            fail(f"fused_sampling on served logits ({label}): two runs "
                 f"differ")
        z = x.float() / 0.8
        mass = torch.softmax(z, -1).sort(-1, descending=True).values
        top_p_lanes = (mass.cumsum(-1) < 0.9).sum(-1) + 1
        traced = (kernel_ms_of(run, "fused_sampling") if label == "tick_rows"
                  else (None, {"trace_dropped": None, "attempts": 0}))
        out[label] = {
            "ms": median_ms(run), "config": cfg,
            **dict(zip(("kernel_ms", "trace"), traced)),
            "logit_std_mean": float(x.float().std(-1).mean()),
            "logit_range_mean": float((x.max(-1).values
                                       - x.min(-1).values).mean()),
            "top_p_lanes_mean": float(top_p_lanes.float().mean()),
            "top_p_lanes_max": int(top_p_lanes.max()),
            "pass_lane_visits_mean": float(pass_lane_visits(z).mean()),
            "clocks_after": clocks_line()}
    out["not_measured"] = SERVED_SAMPLING_NOT_MEASURED
    return out


def pass_lane_visits(z, top_k: int = 50, top_p: float = 0.9):
    """Per row of scaled logits ``z``, the lanes the sampling kernel's 10
    bisection passes visit: at the start of each pass of 3 steps, the
    lanes at or above the top-k bisection's lower end plus those above the
    top-p one's (the two 30-step bisections of ``sampling/ref.py``, read
    every third step; the kernel skips every other lane)."""
    probs = torch.softmax(z, -1)
    lo_k, hi_k = z.min(-1).values, z.max(-1).values
    lo_p, hi_p = lo_k - 1.0, hi_k.clone()
    visits = torch.zeros_like(lo_k)
    for step in range(30):
        if step % 3 == 0:
            visits += ((z >= lo_k[:, None]).sum(-1)
                       + (z > lo_p[:, None]).sum(-1))
        mid = 0.5 * (lo_k + hi_k)
        ge = (z >= mid[:, None]).sum(-1) >= top_k
        lo_k, hi_k = torch.where(ge, mid, lo_k), torch.where(ge, hi_k, mid)
        mid = 0.5 * (lo_p + hi_p)
        ge = torch.where(z > mid[:, None], probs, 0.0).sum(-1) >= top_p
        lo_p, hi_p = torch.where(ge, mid, lo_p), torch.where(ge, hi_p, mid)
    return visits


def init_lm():
    """llama3.2-1b at full width with prefill attention in the flash kernel,
    random weights from seed 0 drawn on the card: (cfg, params, seconds,
    parameter count)."""
    cfg = dataclasses.replace(cfg_lib.get_config(LM_ARCH), attn_impl="cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, DEVICE)            # drawn on the card
    torch.cuda.synchronize()
    return (cfg, params, time.perf_counter() - t0,
            sum(int(x.numel()) for x in tree_leaves(params)))


def compare_with_plain(phase: str, reqs, tok, tok_plain, tok_again, margins,
                       vocab: int):
    """Every request has its new tokens inside the vocabulary; seeded ones
    are bit-identical across two kernel runs; greedy ones equal the plain
    path's up to the first position whose top-2 margin there is below its
    threshold (MARGIN_RULE).  Returns (tokens compared, ambiguous
    positions, where each such sequence first parts from the plain one,
    with the margin and threshold there)."""
    compared = ambiguous = 0
    first_diff = {}
    for r in reqs:
        a, b = tok[r.rid], tok_plain[r.rid]
        if len(a) != len(r.prompt) + r.max_new_tokens:
            fail(f"{phase}: rid {r.rid} has {len(a) - len(r.prompt)} new "
                 f"tokens")
        if min(a) < 0 or max(a) >= vocab:
            fail(f"{phase}: rid {r.rid} has a token outside the vocabulary")
        if r.temperature > 0:
            if a != tok_again[r.rid]:
                fail(f"{phase}: seeded rid {r.rid} differs between two runs "
                     f"of the kernel engine")
            continue
        for j in range(len(r.prompt), len(a)):
            compared += 1
            if a[j] == b[j]:
                continue
            m = margins[(r.rid, j)]
            if m["margin"] >= m["threshold"]:
                fail(f"{phase}: rid {r.rid} token {j} differs from the plain "
                     f"path at a top-2 margin of {m['margin']} >= "
                     f"{m['threshold']} ({MARGIN_RULE})")
            ambiguous += 1
            first_diff[r.rid] = {"position": j, **m}
            break                         # the sequences part ways here
    return compared, ambiguous, first_diff


def serve_against_plain(phase: str, cfg, params, breakdown: bool,
                        further=None, n_requests: int = LM_REQUESTS) -> tuple:
    """``params`` of full-width llama3.2-1b through ServeEngine: the kernel
    path (flash_attention in prefill, decode_attention and fused_sampling
    in every decode tick) against the plain path (chunked attention, host
    sampling) on lm_requests, held by the margin rule; the kernel engine's
    second run (the seeded requests' bit-identity) records its own margins
    and seeded logits rows (kernel_margins_of);
    ``further(kern, reqs, tok, tok_again, margins, seeded_logits)`` then
    adds checks on the kernel engine; with ``breakdown``,
    decode_tick_breakdown after.  Returns (the phase's numbers, the
    launches of the first kernel run by kernel-table row)."""
    kern = ServeEngine(cfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                       decode_kernel=True, device=DEVICE)
    plain = ServeEngine(dataclasses.replace(cfg, attn_impl="chunked"), params,
                        n_slots=LM_SLOTS, max_len=LM_MAX_LEN, device=DEVICE)
    del params
    reqs = lm_requests(cfg.vocab, n_requests)

    # warm-up outside the engines' stats: a short generate() through each
    # path (cuBLAS handles, the kernels' first launches)
    for eng in (kern, plain):
        eng.generate([[1, 2, 3, 4] * 8], max_new_tokens=2)

    groups = count_calls(kern, "_prefill_group")
    ticks = count_calls(kern, "_step")
    reset_counts()
    done = kern.serve(fresh(reqs))
    counts = launch_counts()
    stats = kern.stats()
    n_groups, n_ticks = groups[0], ticks[0]
    if len(done) != len(reqs):
        fail(f"{phase}: {len(done)} of {len(reqs)} requests completed")
    want = {"flash_attention": cfg.n_layers * n_groups,
            "decode_attention": cfg.n_layers * n_ticks,
            "dense": cfg.n_layers * n_ticks,
            "fused_sampling": n_ticks,
            "fixed_order_matmul": gemm_launches(cfg, n_groups + n_ticks)}
    for name, n in want.items():
        if counts[name] != n or n < 1:
            fail(f"{phase}: {name} launched {counts[name]} times, expected "
                 f"{n} ({n_groups} prefill groups, {n_ticks} decode ticks)")
    check_prefill_bodies(phase, counts)

    margins = record_margins(plain)
    done_plain = plain.serve(fresh(reqs))
    del plain
    together = {}
    tok_again, kmargins = kernel_margins_of(kern, reqs, together)
    tok = {c.rid: c.tokens for c in done}
    tok_plain = {c.rid: c.tokens for c in done_plain}
    compared, ambiguous, first_diff = compare_with_plain(
        phase, reqs, tok, tok_plain, tok_again, margins, cfg.vocab)
    lat = stats.latency_summary()
    greedy = [margins[(r.rid, j)] for r in reqs if r.temperature == 0
              for j in range(len(r.prompt), len(r.prompt) + LM_MAX_NEW)
              if (r.rid, j) in margins]
    thresholds = [m["threshold"] for m in greedy]
    numbers = dict(
        slots=LM_SLOTS, max_len=LM_MAX_LEN, requests=stats.completed,
        new_tokens=stats.items, ticks=stats.ticks, prefill_groups=n_groups,
        decode_ticks=n_ticks, tok_per_s=stats.throughput,
        ms_per_tick=stats.ms_per_tick,
        latency_ms={k: {"n": n, "p50": p50, "p95": p95}
                    for k, (n, p50, p95) in lat.items()},
        launches={k: counts[k] for k in want},
        prefill_launches_by_body={
            b: counts[f"flash_attention/{b}"] for b in ("tensor_core", "fma")},
        greedy_tokens_compared=compared,
        ambiguous_positions=ambiguous, margin_rule=MARGIN_RULE,
        plain_threshold_range=[min(thresholds), max(thresholds)],
        plain_positions_under_threshold=sum(
            1 for m in greedy if m["margin"] < m["threshold"]),
        first_divergence=first_diff,
        greedy_sequences_equal_plain=sum(
            1 for r in reqs if r.temperature == 0
            and tok[r.rid] == tok_plain[r.rid]),
        seeded_bit_identical=True)
    if further is not None:
        numbers.update(further(kern, reqs, tok, tok_again, kmargins,
                               together))
    if breakdown:
        numbers.update(decode_tick_breakdown(kern, cfg.vocab))
    return numbers, {"flash_attention": counts["flash_attention"],
                     "decode_attention": counts["dense"],
                     "fused_sampling": counts["fused_sampling"],
                     "fixed_order_matmul": counts["fixed_order_matmul"]}


def gemm_launches(cfg, passes: int) -> int:
    """The fixed-order GEMM's launches in ``passes`` forward passes of a
    dense model (a prefill group or a decode tick each): q, k, v, o and the
    FFN's two or three products in every layer, and the unembed."""
    return passes * (cfg.n_layers * (4 + (3 if cfg.glu else 2)) + 1)


def first_difference(a: list, b: list) -> int:
    """The first position where two token lists part."""
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def generate_and_schedulers(kern, reqs, tok, tok_fifo, margins) -> tuple:
    """serve_lm's checks of ``generate()`` and the other schedulers on its
    kernel engine (ROADMAP §C 2).  (a) ``generate()`` on each admission
    wave of the FIFO serve: it admits LM_SLOTS requests at a time and all
    take LM_MAX_NEW tokens, so the waves are ``reqs`` in slices of
    LM_SLOTS; called on a whole wave, greedily, generate() prefills the
    same bucket and decodes the same batch as serve(), so each greedy
    request's row must equal serve()'s tokens exactly.  (b) The same
    requests served under InterleavingScheduler and SLOBatchScheduler, each
    on an engine over the kernel engine's parameters: greedy tokens against
    the FIFO engine's (``tok_fifo``, whose margins are ``margins``) by the
    margin rule.  Returns (numbers, launches by counter)."""
    reset_counts()
    exact = 0
    for lo in range(0, len(reqs), LM_SLOTS):
        wave = reqs[lo:lo + LM_SLOTS]
        out = kern.generate([list(r.prompt) for r in wave],
                            max_new_tokens=LM_MAX_NEW)
        for r, got in zip(wave, out):
            if r.temperature > 0:
                continue
            if got != tok[r.rid]:
                fail(f"serve_lm (generate): rid {r.rid} parts from serve()'s "
                     f"tokens at position {first_difference(got, tok[r.rid])}")
            exact += 1
    numbers = {"generate": {"waves": -(-len(reqs) // LM_SLOTS),
                            "greedy_sequences_equal_serve": exact}}
    for label, sched in (
            ("interleave", InterleavingScheduler(decode_ratio=1)),
            ("slo", SLOBatchScheduler(SLO_TARGET_MS,
                                      initial_batch=SLO_INITIAL_BATCH))):
        eng = ServeEngine(kern.cfg, kern.params, n_slots=LM_SLOTS,
                          max_len=LM_MAX_LEN, scheduler=sched,
                          decode_kernel=True, device=DEVICE)
        groups = count_calls(eng, "_prefill_group")
        t0 = time.perf_counter()
        done = eng.serve(fresh(reqs))
        wall = time.perf_counter() - t0
        if len(done) != len(reqs):
            fail(f"serve_lm ({label}): {len(done)} of {len(reqs)} requests "
                 f"completed")
        got = {c.rid: c.tokens for c in done}
        compared, ambiguous, first_diff = compare_with_plain(
            f"serve_lm ({label})", reqs, got, tok_fifo, got, margins,
            kern.cfg.vocab)
        st = eng.stats()
        numbers[label] = {
            "ticks": st.ticks, "prefill_groups": groups[0], "wall_s": wall,
            "tok_per_s": st.items / wall, "depth": {
                k: {"ticks": n, "p50": p50, "peak": peak}
                for k, (n, p50, _, peak) in st.depth_summary().items()},
            "greedy_tokens_compared": compared,
            "ambiguous_positions": ambiguous,
            "first_divergence": first_diff,
            "greedy_sequences_equal_fifo": sum(
                1 for r in reqs if r.temperature == 0
                and got[r.rid] == tok_fifo[r.rid])}
        if label == "slo":
            numbers[label]["effective_batch"] = sched.effective_batch
        del eng
    counts = launch_counts()
    launches = {"flash_attention": counts["flash_attention"],
                "decode_attention": counts["dense"],
                "fused_sampling": counts["fused_sampling"]}
    if min(launches.values()) < 1:
        fail(f"serve_lm: generate() and the schedulers launched {launches}")
    return numbers, launches


def phase_serve_lm() -> dict:
    """Full-width llama3.2-1b, random weights from seed 0, through
    serve_against_plain with generate_and_schedulers and the decode tick's
    breakdown."""
    cfg, params, init_s, n_params = init_lm()
    further = {}

    def checks(kern, reqs, tok, tok_again, margins, together):
        numbers, further["launches"] = generate_and_schedulers(
            kern, reqs, tok, tok_again, margins)
        seeded, further["seeded"] = seeded_schedules(kern, reqs, tok_again,
                                                     together)
        return {**numbers, "seeded_schedules": seeded,
                "graphs": lm_graphs("serve_lm", kern, reqs, tok)}

    numbers, launches = serve_against_plain("serve_lm", cfg, params,
                                            breakdown=True, further=checks)
    emit("serve_lm", arch=LM_ARCH, params=n_params, init_s=init_s,
         **numbers)
    for got in (further["launches"], further["seeded"]):
        for row, n in got.items():
            launches[row] = launches.get(row, 0) + n
    return launches


# ---------------------------------------------------------------------------
# The compiled entry points (repro_torch.graphs): the CapsNet forward and
# every LM family's decode tick and admission replay CUDA graphs, the port's
# counterparts of the reference's jax.jit.  Each is held here against the same staged code
# run eagerly (graphs.eager) on the same card, back to back: the CapsNet's
# lengths and the LM's logits rows bit for bit, classes and tokens equal;
# the launches the replays added (each graph's capture-time counts times
# its replays) against the wrappers' counters; the graphs captured and
# re-captured and the capture seconds; FPS, tok/s and tick wall ms in both
# modes.  The profiler's traces stay eager (profile_ms).
# ---------------------------------------------------------------------------


def graph_totals() -> dict:
    return dict(graphs.TOTALS)


def totals_since(before: dict) -> dict:
    return {k: graphs.TOTALS[k] - before[k] for k in before}


def replay_window(calls, run) -> dict:
    """``run()`` with every graph of ``calls`` (CapturedCalls) already
    captured: the wrappers' counter growth against the launches the
    replays added (each call's capture-time counts times its replays in
    the window), by kernel, for every counter a graph launches (an eager
    prefill in the window launches flash, which no graph does); fails
    where they differ, or where a call captured again."""
    before = graphs.counters()
    stats0 = [dict(c.stats) for c in calls]
    run()
    grown = graphs.count_delta(before, graphs.counters())
    replayed = {}
    for c, st in zip(calls, stats0):
        if c.stats["captures"] != st["captures"]:
            fail(f"{c.name}: captured again inside a replay window")
        n = c.stats["replays"] - st["replays"]
        for key, k in c.delta.items():
            replayed[key] = replayed.get(key, 0) + n * k
    seen = {k: grown.get(k, 0) for k in replayed}
    if seen != replayed or not replayed:
        fail(f"graphs: replayed launches {replayed} differ from the "
             f"counters' growth {seen}")
    return {"/".join(str(x) for x in key if x is not None): n
            for key, n in sorted(replayed.items(), key=str)}


def capsnet_graphs(phase: str, deployed, requests) -> dict:
    """The CapsNet served through replayed graphs against the same engine
    eager, back to back (graph, eager, graph): lengths bit-identical and
    classes equal; the graphs' counts; the replayed launches against the
    counters over a window of replays; FPS each way."""
    engine = deployed.serve(batch_size=BATCH)
    t_before = graph_totals()
    engine.warmup()                        # captures every batch shape
    calls = list(deployed._graphs.values())

    def serve_once():
        for r in requests:
            engine.submit(ImageRequest(images=r.images, rid=r.rid))
        t0 = time.perf_counter()
        done = engine.run_until_idle()
        wall = time.perf_counter() - t0
        frames = sum(len(c.lengths) for c in done)
        return {c.rid: c for c in done}, frames / wall

    runs = {}
    launches = replay_window(calls, lambda: runs.update(graph=serve_once()))
    with graphs.eager():
        runs["eager"] = serve_once()
    runs["graph_again"] = serve_once()
    (g, fps_g), (e, fps_e), (_, fps_g2) = (runs["graph"], runs["eager"],
                                           runs["graph_again"])
    same = sum(1 for r in requests
               if np.array_equal(g[r.rid].lengths.view(np.int32),
                                 e[r.rid].lengths.view(np.int32)))
    for r in requests:
        if not np.array_equal(g[r.rid].classes, e[r.rid].classes):
            fail(f"{phase} (graphs): rid {r.rid} classes differ between the "
                 f"replayed graph and the eager forward")
    diff = max(float(np.abs(g[r.rid].lengths - e[r.rid].lengths).max())
               for r in requests)
    st = engine.graph_stats()
    if st["recaptures"] or st["captures"] != len(
            engine.scheduler.shapes(engine.capacity)):
        fail(f"{phase} (graphs): {st}")
    return {"card": nvidia_smi_line(),
            "requests_bit_identical_lengths": same,
            "requests": len(requests), "classes_identical": True,
            "max_abs_lengths_graph_vs_eager": diff,
            "captures": st["captures"], "recaptures": st["recaptures"],
            "replays": st["replays"], "capture_s": st["capture_s"],
            "totals": totals_since(t_before),
            "replayed_launches": launches,
            "fps_graph": fps_g, "fps_eager": fps_e, "fps_graph_again": fps_g2}


def record_all_logits(engine, rows: dict) -> None:
    """Keep in ``rows``, by (rid, position), every decode tick's logits row
    (a float32 copy on the device) each active slot's token is drawn
    from."""
    inner = engine._observe_logits

    def observe(logits, active, pos_of, lo=0):
        for s, task in active:
            rows[(task.rid, pos_of(s))] = logits[s - lo].to(torch.float32,
                                                           copy=True)
        inner(logits, active, pos_of, lo)

    engine._observe_logits = observe


def staged_calls(engine) -> list:
    """Every staged call of a ServeEngine's blocks: the decode ticks and
    the admission calls (prefill, paged prefill, gather, inject)."""
    return [c for sh in engine._shards
            for c in ([sh.tick] if sh.tick is not None else [])
            + list(sh.calls.values())]


def python_runs(engine, kind: str, before: dict) -> tuple:
    """Of ``engine``'s staged calls of ``kind`` since ``before`` (its
    graph_stats(kind) then): (the runs that executed the Python body, an
    eager run or the one before a capture, all runs).  A replay runs no
    Python, so a watch on a model function sees only the first."""
    st = engine.graph_stats(kind)
    ran = (st["captures"] - before["captures"]
           + st["eager"] - before["eager"])
    return int(ran), int(ran + st["replays"] - before["replays"])


def state_leaves(sh) -> list:
    """A block's caches, or its pool and residual leaves."""
    return tree_leaves(sh.caches if sh.caches is not None
                       else [sh.pool, sh.residual or {}])


def out_leaves(out) -> list:
    return [] if out is None else tree_leaves(out)


def graph_pool_bytes():
    """Bytes the allocator holds in the CUDA graphs' private pools (every
    segment outside the default pool), or None where the snapshot does not
    say."""
    try:
        segments = torch.cuda.memory_snapshot()
    except RuntimeError:
        return None
    ids = [tuple(seg.get("segment_pool_id", (0, 0))) for seg in segments]
    return sum(seg["total_size"] for seg, i in zip(segments, ids)
               if i != (0, 0))


def graph_vs_eager(label: str, engine) -> dict:
    """Each captured admission call of ``engine`` (the reference's jitted
    _prefill, _prefill_paged, _gather, _inject) replayed from its graph and
    then run eagerly (graphs.eager) on its last staged inputs, both from
    one snapshot of its block's caches or pool: the outputs (first-token
    logits, gathered rows) and every cache or pool leaf bit for bit.
    Returns, by kind, the calls held and the graphs' counts; fails where
    one differs, or where a graph was re-captured."""
    out = {}
    for sh in engine._shards:
        state, reads = state_leaves(sh), engine._tick_reads(sh)
        for key, call in sh.calls.items():
            if call._graph is None:
                continue
            snap = [t.clone() for t in state]
            got = call(reads=reads)
            after = [t.clone() for t in state]
            for t, v in zip(state, snap):
                t.copy_(v)
            with graphs.eager():
                want = call(reads=reads)
            same_out = all(torch.equal(a, b) for a, b in zip(
                out_leaves(got), out_leaves(want)))
            same_state = all(torch.equal(a, b) for a, b in zip(after, state))
            if not (same_out and same_state):
                fail(f"{label} (graphs): {key[0]} {key[1]} of block "
                     f"{sh.index}: the replayed graph and the eager body "
                     f"differ (outputs {same_out}, leaves {same_state})")
            out.setdefault(key[0], {"calls_held": 0})["calls_held"] += 1
            del snap, after, got, want
    for kind, numbers in out.items():
        numbers.update(engine.graph_stats(kind))
        if numbers["recaptures"]:
            fail(f"{label} (graphs): {kind}: {numbers['recaptures']} "
                 f"re-captures")
    return out


def replayed_counts(calls, stats0) -> dict:
    """The launches the replays of ``calls`` added since ``stats0`` (each
    call's stats then), by counter: each capture's counts times its
    replays."""
    replayed = {}
    for c, st in zip(calls, stats0):
        n = c.stats["replays"] - st["replays"]
        for key, k in c.delta.items():
            replayed[key] = replayed.get(key, 0) + n * k
    return replayed


# prompts of one token: a prefill bucket (or a paged span) of one row, the
# attention's one-token branch inside a captured prefill
ONE_TOKEN_PROMPTS = ([11], [257], [4099])


def one_token_admission(label: str, engine) -> dict:
    """ONE_TOKEN_PROMPTS served through the graphs twice (the first
    serve captures the one-row prefill, the second replays it) and then
    eagerly (graphs.eager): tokens equal and every first-token logits row
    bit for bit; fails where they part, or where no one-row prefill graph
    was captured."""
    def serve():
        first = {}
        sample = engine._sample_task_row

        def on_host(logits_row, task, pos):
            first[task.rid] = np.array(logits_row, np.float32)
            return sample(logits_row, task, pos)

        engine._sample_task_row = on_host
        try:
            done = engine.serve([
                Request(prompt=list(p), max_new_tokens=2, rid=2 * 10 ** 6 + i,
                        seed=900 + i, temperature=0.8 if i % 2 else 0.0)
                for i, p in enumerate(ONE_TOKEN_PROMPTS)])
        finally:
            engine.__dict__.pop("_sample_task_row", None)
        return {c.rid: list(c.tokens) for c in done}, first

    kind = "paged prefill" if engine.paged else "prefill"
    st0 = engine.graph_stats(kind)
    runs = [serve(), serve()]
    with graphs.eager():
        runs.append(serve())
    st = engine.graph_stats(kind)
    one_row = [k for sh in engine._shards for k, c in sh.calls.items()
               if k[0] == kind and k[1][1] == 1 and c._graph is not None]
    if not one_row:
        fail(f"{label} (one-token prompts): no one-row {kind} graph was "
             f"captured")
    (tok_c, first_c), (tok_r, first_r), (tok_e, first_e) = runs
    same = sum(first_r[r].tobytes() == first_e[r].tobytes()
               and first_c[r].tobytes() == first_e[r].tobytes()
               for r in first_e)
    if (not tok_c == tok_r == tok_e or not first_e
            or same != len(first_e)):
        fail(f"{label} (one-token prompts): the graph runs and the eager "
             f"run part: tokens {tok_c} {tok_r} {tok_e}, {same} of "
             f"{len(first_e)} first-token rows bit-identical")
    return {"requests": len(ONE_TOKEN_PROMPTS), "keys": sorted(
                k[1] for k in one_row),
            "first_token_rows_bit_identical": same,
            "captures": st["captures"] - st0["captures"],
            "replays": st["replays"] - st0["replays"],
            "recaptures": st["recaptures"] - st0["recaptures"]}


def lm_graphs(label: str, engine, reqs, want_tokens=None,
              keep=None) -> dict:
    """A kernel engine's decode ticks and admissions replayed from its
    graphs against the same engine's staged calls run eagerly, back to
    back: every request's tokens equal (and ``want_tokens``'s, an earlier
    run's), every logits row a token is drawn from bit for bit (the first
    token's from the prefill graph, the rest from the tick's; else the
    first (rid, position) that parts and by how much); then each admission
    graph against its eager body from one snapshot (graph_vs_eager).  The
    graph run makes every launch from a replay: the counters' growth must
    equal the replays' counts (a run that captured a new shape is served
    again first).  Reports the graphs' counts by kind and the pool bytes
    they hold, tok/s, ms per tick and ms per admission each way.  Given a
    dict ``keep``, puts the graph run's tokens under ``tokens`` and its
    sampled requests' logits rows under ``rows`` (record_seeded_logits'
    keys: the batch's side of seeded_alone)."""
    t_before = graph_totals()
    if any(sh.tick is None for sh in engine._shards):
        engine.serve([Request(prompt=[1, 2, 3, 4] * 8, max_new_tokens=3,
                              rid=10 ** 6)])
    runs = {}

    def serve(mode):
        rows, first, admits = {}, {}, []
        record_all_logits(engine, rows)
        sample, admit = engine._sample_task_row, engine._admit

        def on_host(logits_row, task, pos):
            first[(task.rid, pos)] = np.array(logits_row, np.float32)
            return sample(logits_row, task, pos)

        def timed_admit(new):
            t0 = time.perf_counter()
            try:
                return admit(new)
            finally:
                admits.append(time.perf_counter() - t0)

        engine._sample_task_row, engine._admit = on_host, timed_admit
        stats0 = engine.stats()
        t0 = time.perf_counter()
        try:
            done = engine.serve(fresh(reqs))
        finally:
            for name in ("_observe_logits", "_sample_task_row", "_admit"):
                engine.__dict__.pop(name, None)
        wall = time.perf_counter() - t0
        st = engine.stats()
        runs[mode] = {"tokens": {c.rid: c.tokens for c in done},
                      "rows": rows, "first": first, "wall_s": wall,
                      "tok_per_s": (st.items - stats0.items) / wall,
                      "ms_per_tick": 1e3 * (st.wall_s - stats0.wall_s)
                      / max(st.ticks - stats0.ticks, 1),
                      "ms_per_admission": 1e3 * sum(admits)
                      / max(len(admits), 1)}

    captured_first = 0
    for attempt in range(2):
        calls = staged_calls(engine)
        stats0 = [dict(c.stats) for c in calls]
        counters0 = graphs.counters()
        serve("graph")
        grown = graphs.count_delta(counters0, graphs.counters())
        captured = (len(staged_calls(engine)) - len(calls)) + sum(
            c.stats["captures"] - st["captures"]
            for c, st in zip(calls, stats0))
        if not captured:
            break
        captured_first += captured        # a new shape: serve again
    if captured:
        fail(f"{label} (graphs): the graph run captured {captured} graphs "
             f"again in a second run of the same requests")
    replayed = replayed_counts(calls, stats0)
    if grown != replayed:
        fail(f"{label} (graphs): replayed launches {replayed} differ from "
             f"the counters' growth {grown}")
    launches = {"/".join(str(x) for x in key if x is not None): n
                for key, n in sorted(replayed.items(), key=str)}
    with graphs.eager():
        serve("eager")
    g, e = runs["graph"], runs["eager"]
    if g["tokens"] != e["tokens"]:
        bad = sorted(r for r in g["tokens"] if g["tokens"][r] != e["tokens"][r])
        fail(f"{label} (graphs): tokens of rids {bad} differ between the "
             f"replayed graph and the eager tick")
    if want_tokens is not None and any(g["tokens"].get(r) != t
                                       for r, t in want_tokens.items()):
        fail(f"{label} (graphs): the graph run's tokens part from the "
             f"first run's")
    keys = sorted(g["rows"])
    if sorted(e["rows"]) != keys or sorted(e["first"]) != sorted(g["first"]):
        fail(f"{label} (graphs): the two runs drew other (rid, position)s")
    a = torch.stack([g["rows"][k] for k in keys])
    b = torch.stack([e["rows"][k] for k in keys])
    differs = (a != b).any(-1).cpu().numpy()
    first = None
    if differs.any():
        i = int(np.argmax(differs))
        first = {"rid": keys[i][0], "position": keys[i][1],
                 "max_abs": float((a[i] - b[i]).abs().max())}
    first_same = sum(g["first"][k].tobytes() == e["first"][k].tobytes()
                     for k in g["first"])
    del a, b
    if keep is not None:
        sampled = {r.rid for r in reqs if r.temperature > 0}
        keep["tokens"] = g["tokens"]
        keep["rows"] = {k: v for part in (g["first"], g["rows"])
                        for k, v in part.items() if k[0] in sampled}
    one_token = one_token_admission(label, engine)
    admission = graph_vs_eager(label, engine)
    st = engine.graph_stats()
    if st["recaptures"]:
        fail(f"{label} (graphs): {st['recaptures']} re-captures")
    numbers = {
        "card": nvidia_smi_line(), "tokens_identical": True,
        "requests": len(reqs),
        "tokens_equal_first_run": want_tokens is not None,
        "logits_rows": len(keys),
        "logits_rows_bit_identical": int((~differs).sum()),
        "first_differing_row": first,
        "first_token_rows": len(g["first"]),
        "first_token_rows_bit_identical": first_same,
        "captures": st["captures"], "recaptures": st["recaptures"],
        "replays_in_graph_run": sum(
            c.stats["replays"] - s0["replays"]
            for c, s0 in zip(calls, stats0)),
        "captured_before_the_graph_run": captured_first,
        "capture_s": st["capture_s"], "admission": admission,
        "one_token_admission": one_token,
        "graph_pool_bytes": graph_pool_bytes(),
        "totals": totals_since(t_before), "replayed_launches": launches,
        "tok_per_s_graph": g["tok_per_s"], "tok_per_s_eager": e["tok_per_s"],
        "ms_per_tick_graph": g["ms_per_tick"],
        "ms_per_tick_eager": e["ms_per_tick"],
        "ms_per_admission_graph": g["ms_per_admission"],
        "ms_per_admission_eager": e["ms_per_admission"]}
    del runs
    if first is not None or first_same != len(g["first"]):
        fail(f"{label} (graphs): logits rows part between the replayed "
             f"graphs and the eager run: {numbers}")
    return numbers


# ---------------------------------------------------------------------------
# The sampling contract across schedules (docs/torch_kernels.md): a seeded
# request's draws are a function of its seed and positions alone, so two
# schedules that hand the sampler the same logits row must draw the same
# token.  Whether the logits rows themselves stay bit-identical across
# schedules is measured here; where they part, tools/trace_seeded.py (on
# demand: the readings repeat bit for bit from run to run) finds the first
# operation whose output for each such request differs, and ROADMAP §C
# records what it found.
# ---------------------------------------------------------------------------

OTHER_SLOTS = 3
# The pressured schedule of serve_lm's requests: they share no prefix, so
# the pool is three quarters of the pages (PRESSURE_PAGES' half would run
# dry in a decode tick with no preempted request left to spill, once the
# eight longest prompts are resident together)
SEEDED_PRESSURE_PAGES = 3 * N_PAGES // 4


def record_seeded_logits(engine, logits: dict) -> None:
    """Keep in ``logits``, by (rid, position), the logits row each token of
    a sampled (temperature > 0) request of ``engine`` is drawn from: the
    host-sampled first token's row (float32, on the host) and each decode
    tick's fused_sampling row (a float32 copy left on the device, so
    nothing crosses to the host while the engine serves; compare_seeded
    brings them over)."""
    def sampled(task) -> bool:
        return float(getattr(task.payload, "temperature", 0.0) or 0.0) > 0

    on_host_inner = engine._sample_task_row

    def on_host(logits_row, task, pos):
        if sampled(task):
            logits[(task.rid, pos)] = np.array(logits_row, np.float32)
        return on_host_inner(logits_row, task, pos)

    on_device_inner = engine._observe_logits

    def on_device(rows, active, pos_of, lo=0):
        for s, task in active:
            if sampled(task):
                logits[(task.rid, pos_of(s))] = rows[s - lo].to(
                    torch.float32, copy=True)
        on_device_inner(rows, active, pos_of, lo)

    engine._sample_task_row = on_host
    engine._observe_logits = on_device


def rows_on_host(rows: dict) -> dict:
    """``rows`` (record_seeded_logits) with the rows left on the device
    brought to the host in one copy."""
    left = [k for k, v in rows.items() if isinstance(v, torch.Tensor)]
    if not left:
        return rows
    host = torch.stack([rows[k] for k in left]).cpu().numpy()
    return {**rows, **dict(zip(left, host))}


def compare_seeded(name: str, reqs, base: tuple, other: tuple) -> tuple:
    """The sampling contract between two schedules of ``reqs``: ``base``
    and ``other`` are (tokens by rid, seeded logits rows by (rid,
    position)).  Fails if a token is drawn from logits rows that are bit
    for bit the same in both and differs.  Reports, per sampled request,
    the first step whose logits rows differ with their largest difference
    there, and the first step whose token differs (the comparison stops
    there: the contexts part), with the rows compared up to it that part
    and their largest difference.  Returns (numbers, every sampled request
    whose logits differ as (rid, first position that differs, prompt
    length))."""
    (tok_a, rows_a), (tok_b, rows_b) = base, other
    rows_a, rows_b = rows_on_host(rows_a), rows_on_host(rows_b)
    per, targets = {}, []
    for r in reqs:
        if r.temperature <= 0:
            continue
        n = len(r.prompt)
        a, b = tok_a[r.rid], tok_b[r.rid]
        if len(a) != n + r.max_new_tokens or len(b) != len(a):
            fail(f"{name}: rid {r.rid} has {len(a) - n} and {len(b) - n} "
                 f"new tokens")
        first_logits = first_token = diff = None
        same_rows = parted = 0
        largest = 0.0
        for p in range(n, n + r.max_new_tokens):
            ra, rb = rows_a.get((r.rid, p)), rows_b.get((r.rid, p))
            if ra is None or rb is None:
                fail(f"{name}: rid {r.rid} position {p}: no logits row "
                     f"captured")
            same = ra.tobytes() == rb.tobytes()
            same_rows += same
            if not same:
                parted += 1
                largest = max(largest, float(np.abs(ra - rb).max()))
            if not same and first_logits is None:
                first_logits, diff = p, float(np.abs(ra - rb).max())
            if a[p] != b[p]:
                if same:
                    fail(f"{name}: rid {r.rid} draws {a[p]} and {b[p]} at "
                         f"position {p} from bit-identical logits rows (the "
                         f"sampling contract)")
                first_token = p
                break
        per[r.rid] = {"tokens_equal": a == b,
                      "logits_rows_bit_identical": same_rows,
                      "logits_rows_parted": parted,
                      "largest_difference": largest,
                      "first_logits_difference": (
                          None if first_logits is None else
                          {"step": first_logits - n, "max_abs": diff}),
                      "first_token_difference": (
                          None if first_token is None
                          else first_token - n)}
        if first_logits is not None:
            targets.append((r.rid, first_logits, n))
    numbers = {"seeded_sequences": len(per),
               "bit_identical_sequences": sum(
                   1 for v in per.values() if v["tokens_equal"]),
               "logits_bit_identical_sequences": sum(
                   1 for v in per.values()
                   if v["first_logits_difference"] is None),
               "logits_rows_parted": sum(
                   v["logits_rows_parted"] for v in per.values()),
               "largest_difference": max(
                   [v["largest_difference"] for v in per.values()],
                   default=0.0),
               "by_rid": per}
    return numbers, targets


def kernel_engine(cfg, params, n_slots: int = LM_SLOTS, **kw):
    return ServeEngine(cfg, params, n_slots=n_slots, max_len=LM_MAX_LEN,
                       decode_kernel=True, device=DEVICE, **kw)


def serve_seeded(engine, reqs, logits=None) -> dict:
    """``reqs`` on ``engine``, its seeded logits rows kept in ``logits``."""
    if logits is not None:
        record_seeded_logits(engine, logits)
    return {c.rid: c.tokens for c in engine.serve(fresh(reqs))}


def seeded_runs(cfg, params, reqs, pressure=None) -> dict:
    """serve_lm's other schedules of ``reqs``, by label, each a function of
    (a dict for the seeded logits rows or None, the rids to serve or None
    for all) returning tokens by rid: each sampled request alone in a fresh
    engine of LM_SLOTS slots (``rids`` picks which), all of ``reqs`` at
    OTHER_SLOTS slots, and all of them through the pressured paged engine
    (pressured_serve, bf16 pages, SEEDED_PRESSURE_PAGES; its preemptions
    and pages go into the dict ``pressure``)."""
    seeded = [r for r in reqs if r.temperature > 0]

    def alone(logits=None, rids=None):
        tok = {}
        for r in seeded:
            if rids is None or r.rid in rids:
                tok.update(serve_seeded(kernel_engine(cfg, params), [r],
                                        logits))
        return tok

    def other_slots(logits=None, rids=None):
        return serve_seeded(kernel_engine(cfg, params, OTHER_SLOTS), reqs,
                            logits)

    def pressured(logits=None, rids=None):
        tok, st, pg, _ = pressured_serve(cfg, params, False, reqs, logits,
                                         SEEDED_PRESSURE_PAGES)
        if pressure is not None:
            pressure.update(preempted=st.preempted, pages=pg)
        return tok

    return {"alone": alone, f"n_slots {OTHER_SLOTS}": other_slots,
            "pressured": pressured}


# The op tools/trace_seeded.py named where a request's prefill parted
# between schedules (ROADMAP §C Open 1): the MLP's output projection on a
# prompt's 75 rows, alone (M 75), inside the 128 rows of its prefill's
# bucket and the 8192 of a group of eight, probed at each M between; the
# Ms off a tile boundary (75, 200, 1000) put the zero-filled ragged edge
# inside the probed rows' tile.  A decode tick's M (its slots) holds the
# first rows the same way, and 64 / 65 are the edge where the second
# consumer warpgroup of a row tile starts to hold a row.  Every BN class
# the rule gives llama3.2-1b's projections (gemm_classes) is probed: one
# weight of each (BN, layout).
GEMM_PROBE_ROWS = 75
GEMM_PROBE_M = (75, 128, 200, 256, 512, 1000, 1024, 2048, 4096, 8192)
GEMM_PROBE_DECODE_M = (1, 3, 8, 16, 17, 64, 65)


def gemm_geometry(case) -> dict:
    """The instruction, BN and stages the GEMM's plan gives a case (its
    (M, N, K) and w's layout), read on meta tensors."""
    m, n, k = case["dims"]
    w = (torch.empty((n, k), dtype=torch.bfloat16, device="meta").T
         if case.get("layout") == "nk"
         else torch.empty((k, n), dtype=torch.bfloat16, device="meta"))
    plan = gemm_plan(torch.empty((m, k), dtype=torch.bfloat16,
                                 device="meta"), w)
    return {"instruction": plan["instruction"], "bn": plan["tile"][1],
            "stages": plan["stages"]}


def gemm_classes() -> list:
    """(label, N, K, layout) of one projection of llama3.2-1b per (BN,
    layout) its GEMM plans give, ``wo``'s first (the product of §C Open 1),
    then the others in GEMM_PROJECTIONS' order and the unembedding."""
    seen, out = set(), []
    projections = GEMM_PROJECTIONS + (GEMM_UNEMBED,)
    for label, n, k, layout in sorted(projections,
                                      key=lambda p: p[0] != "wo"):
        key = (gemm_geometry(gemm_case(1, n, k, layout))["bn"], layout)
        if key not in seen:
            seen.add(key)
            out.append((label, n, k, layout))
    return out


def gemm_probe_one(n: int, k: int, layout: str, seed: int) -> dict:
    """One request's GEMM_PROBE_ROWS rows (bf16, seeded) through a (K, N)
    weight in ``layout`` inside batches of each M of GEMM_PROBE_M rows,
    through the port's fixed-order GEMM (the serving path's) and through
    cuBLAS: whether each gives those rows the same bits as at the smallest
    M, and by how much they differ; the decode Ms hold their rows against
    the same rows at M 75."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(GEMM_PROBE_M[-1], k, device=DEVICE,
                    generator=gen).to(torch.bfloat16)
    w = (torch.randn(k, n, device=DEVICE, generator=gen)
         * k ** -0.5).to(torch.bfloat16)
    if layout == "nk":
        w = w.T.contiguous().T
    cublas = [(x[:m] @ w)[:GEMM_PROBE_ROWS] for m in GEMM_PROBE_M]
    port = [fixed_order_matmul_cuda(x[:m], w)[:GEMM_PROBE_ROWS]
            for m in GEMM_PROBE_M]
    decode = [fixed_order_matmul_cuda(x[:m], w) for m in GEMM_PROBE_DECODE_M]
    torch.cuda.synchronize()

    def by_m(ms, rows, ref):
        return {m: {"bit_identical_to_smallest_m": torch.equal(
                        r, ref[:r.shape[0]]),
                    "max_abs_diff": float((r.float() - ref[:r.shape[0]]
                                           .float()).abs().max())}
                for m, r in zip(ms, rows)}

    return {"rows": GEMM_PROBE_ROWS, "k": k, "n": n, "layout": layout,
            **gemm_geometry(gemm_case(1, n, k, layout)),
            "by_m": by_m(GEMM_PROBE_M, cublas, cublas[0]),
            "port_by_m": by_m(GEMM_PROBE_M, port, port[0]),
            "port_decode_by_m": by_m(GEMM_PROBE_DECODE_M, decode, port[0]),
            "port_vs_cublas_max_abs": max(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(port, cublas))}


def gemm_probe(cfg) -> dict:
    """gemm_probe_one at one weight of each BN class (gemm_classes; the
    first is ``h @ wo`` at the model's (d_ff, d_model), whose numbers stay
    at the top level, the others under ``classes``).  A port row that
    differs at any M in any class fails the run (§C Open 1's repair);
    cuBLAS's are reported."""
    classes = [gemm_probe_one(n, k, layout, seed=6 + i)
               for i, (_, n, k, layout) in enumerate(gemm_classes())]
    assert (classes[0]["k"], classes[0]["n"]) == (cfg.d_ff, cfg.d_model)
    out = {**classes[0], "classes": [
        {key: c[key] for key in ("n", "k", "layout", "instruction", "bn",
                                  "stages", "port_by_m", "port_decode_by_m",
                                  "port_vs_cublas_max_abs")}
        for c in classes]}
    parted = [(c["bn"], c["layout"], m) for c in classes
              for key in ("port_by_m", "port_decode_by_m")
              for m, v in c[key].items()
              if not v["bit_identical_to_smallest_m"]]
    if parted:
        fail(f"gemm_probe: the fixed-order GEMM gives the probed rows other "
             f"bits at (BN, layout, M) {parted}: {out['classes']}")
    return out


def seeded_schedules(kern, reqs, tok_together, together: dict) -> tuple:
    """The sampled requests of ``reqs`` (every fourth) held against their
    run in serve_lm's kernel engine (``tok_together``, ``together``: its
    logits rows) under each of seeded_runs' schedules (compare_seeded):
    since the fixed-order GEMM (§C Open 1) a logits row that parts
    between schedules fails the run; then gemm_probe.  Returns (numbers,
    launches by kernel-table row)."""
    base = (tok_together, rows_on_host(together))
    pressure = {}
    reset_counts()
    out = {}
    for label, run in seeded_runs(kern.cfg, kern.params, reqs,
                                  pressure).items():
        t0 = time.perf_counter()
        rows = {}
        tok = run(rows)
        out[label], parted = compare_seeded(f"serve_lm (seeded, {label})",
                                            reqs, base, (tok, rows))
        out[label]["seconds"] = time.perf_counter() - t0
        del rows
        if parted:
            fail(f"serve_lm (seeded, {label}): logits rows part from the "
                 f"run together, (rid, position, prompt length) "
                 f"{parted}: {out[label]['by_rid']}")
    if pressure.get("preempted", 0) < 1:
        fail(f"serve_lm (seeded, pressured): no request was preempted: "
             f"{pressure}")
    out["pressured"]["pressure"] = pressure
    counts = launch_counts()
    out["gemm_probe"] = gemm_probe(kern.cfg)
    return out, {"flash_attention": counts["flash_attention"],
                 "decode_attention": counts["dense"],
                 "decode_attention_paged": counts["paged"],
                 "fused_sampling": counts["fused_sampling"],
                 "fixed_order_matmul": counts["fixed_order_matmul"]}


def seeded_alone(label: str, kern, reqs, together: dict) -> tuple:
    """The sampling contract across schedules for a family served from
    graphs: each sampled request of ``reqs`` alone in a fresh kernel engine
    of LM_SLOTS slots (seeded_runs' ``alone``) against its run in the
    served batch (``together``: lm_graphs' graph run), by compare_seeded.
    A logits row that parts is reported with the largest difference
    (ROADMAP §C records the product it parts in), not failed; a token
    drawn otherwise from bit-identical rows fails.  Returns (numbers,
    launch counts)."""
    t0 = time.perf_counter()
    reset_counts()
    rows = {}
    tok = seeded_runs(kern.cfg, kern.params, reqs)["alone"](rows)
    counts = launch_counts()
    numbers, parted = compare_seeded(
        f"{label} (seeded, alone)", reqs,
        (together["tokens"], together["rows"]), (tok, rows))
    numbers.update(card=nvidia_smi_line(), schedule="alone",
                   parted=[{"rid": r, "position": p, "prompt_length": n}
                           for r, p, n in parted],
                   seconds=time.perf_counter() - t0)
    del rows
    release()
    return numbers, counts


def flat_paths(tree, path: tuple = ()) -> list:
    """``(path, leaf)`` of a tree of dicts and lists, in tree_leaves'
    order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in flat_paths(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in flat_paths(v, path + (i,))]
    return [(path, tree)]


def event_timed_steps(trainer, events: list) -> None:
    """Wrap the trainer's step so a pair of CUDA events brackets each one
    on the device's timeline (read after the run)."""
    inner = trainer.train_step

    def step(params, opt_state, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(params, opt_state, batch)
        end.record()
        events.append((start, end))
        return out

    trainer.train_step = step


def kernel_class(name: str) -> str:
    """The class of a kernel by its name: GEMMs (cuBLAS / CUTLASS),
    elementwise, reductions, copies and fills, other."""
    n = name.lower()
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas",
                            "sm90_", "splitk")):
        return "gemm"
    if any(t in n for t in ("elementwise", "vectorized", "unrolled")):
        return "elementwise"
    if any(t in n for t in ("reduce", "softmax", "logsumexp", "norm")):
        return "reduction"
    if any(t in n for t in ("copy", "memcpy", "memset", "fill", "cat")):
        return "copy_fill"
    return "other"


def train_lm_components(cfg, params, x_shape) -> dict:
    """Device ms, by the profiler, of the step's parts taken alone at the
    step's shapes: the chunked attention of one layer forward and forward
    plus backward (the step runs every layer's forward twice under remat
    and its backward once), the chunked cross-entropy forward plus backward,
    and one AdamW update of every parameter."""
    b, s, _ = x_shape
    cd = cfg.cdtype()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=cd).requires_grad_(True)

    q = rnd(b, s, cfg.n_heads, cfg.head_dim)
    k = rnd(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = rnd(b, s, cfg.n_kv_heads, cfg.head_dim)

    def attn_fwd():
        with torch.no_grad():
            attn_lib._chunked_attention(q, k, v, cfg, causal=True)

    def attn_fwd_bwd():
        out = attn_lib._chunked_attention(q, k, v, cfg, causal=True)
        torch.autograd.grad(out.float().sum(), (q, k, v))

    x = rnd(b, s, cfg.d_model)
    labels = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device=DEVICE)
    tok = params["embed"]["tok"].detach().requires_grad_(True)

    def ce_fwd_bwd():
        loss = lm.chunked_ce_loss({"embed": {"tok": tok}}, cfg, x, labels)
        torch.autograd.grad(loss, (x, tok))

    grads = [torch.zeros_like(p) for p in tree_leaves(params)]
    state = adamw.init_state(tree_leaves(params))
    ocfg = AdamWConfig(lr=TRAIN_LM_LR)

    def update():
        adamw.apply_updates(tree_leaves(params), grads, state, ocfg)

    out = {}
    for name, fn in (("attention_fwd_ms_per_layer", attn_fwd),
                     ("attention_fwd_bwd_ms_per_layer", attn_fwd_bwd),
                     ("ce_fwd_bwd_ms", ce_fwd_bwd),
                     ("adamw_update_ms", update)):
        fn()
        kernels, _, _ = profile_ms(fn, 3)
        out[name] = sum(kernels.values()) if kernels else None
    del grads, state
    a, ab = (out["attention_fwd_ms_per_layer"],
             out["attention_fwd_bwd_ms_per_layer"])
    out["attention_ms_per_step"] = (cfg.n_layers * (a + ab) if a and ab
                                    else None)
    return out


def grad_pair_check(params, batch, cfgs: dict, host_first: bool = False
                    ) -> dict:
    """Loss and gradients of ``params`` on one batch under each of the two
    configs of ``cfgs`` (name -> config; the first is held against the
    second): each gradient leaf's largest difference over the second's RMS
    and its L2 difference over the second's L2 norm, the loss's difference
    over |loss|, and each leaf's largest |gradient| under the second, also
    over its RMS.  With
    ``host_first`` the first path's gradients wait in host memory while the
    second's are taken (a model whose parameters and two sets of gradients
    would not fit the card)."""
    out = {}
    for name, c in cfgs.items():
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = lm.loss_fn(tree_unflatten(params, live), c, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        if host_first and not out:
            grads = [g.cpu() for g in grads]
        out[name] = (loss.detach(), grads)
        del live, loss, grads
    (na, (la, ga)), (nb, (lb, gb)) = out.items()
    max_rms, l2, max_abs, peak, finite = {}, {}, {}, {}, True
    paths = [p for p, _ in flat_paths(params)]
    for path, a, b in zip(paths, ga, gb):
        key = "/".join(map(str, path))
        a, b = a.to(b.device).float(), b.float()
        finite = (finite and bool(torch.isfinite(a).all())
                  and bool(torch.isfinite(b).all()))
        d = a - b
        rms = b.square().mean().sqrt().clamp(min=1e-30)
        max_rms[key] = float(d.abs().max() / rms)
        l2[key] = float(d.norm() / b.norm().clamp(min=1e-30))
        max_abs[key] = float(b.abs().max())
        peak[key] = max_abs[key] / float(rms)
        del a, b, d
    del out, ga, gb
    dense = {k: v for k, v in max_rms.items() if k not in SPARSE_GRAD_LEAVES}
    return {f"loss_{na}": float(la), f"loss_{nb}": float(lb),
            "loss_rel_diff": abs(float(la - lb)) / abs(float(lb)),
            "grad_max_diff_over_rms": max_rms, "grad_l2_rel_diff": l2,
            "grad_max_abs": max_abs, "grad_peak_over_rms": peak,
            "grad_worst_dense_leaf": max(dense, key=dense.get),
            "grad_worst_dense": max(dense.values()),
            "grad_worst_l2_leaf": max(l2, key=l2.get),
            "grad_worst_l2": max(l2.values()),
            "grads_finite": finite}


def hold_grad_pair(phase: str, pair: str, check: dict) -> None:
    """Fail unless ``check`` (grad_pair_check) is finite and within
    TRAIN_LM_LOSS_TOL / TRAIN_LM_GRAD_TOL."""
    if not check["grads_finite"]:
        fail(f"{phase}: {pair}: the gradients are not finite")
    if check["loss_rel_diff"] > TRAIN_LM_LOSS_TOL:
        fail(f"{phase}: {pair}: the losses differ by "
             f"{check['loss_rel_diff']} relative > {TRAIN_LM_LOSS_TOL}")
    if check["grad_worst_dense"] > TRAIN_LM_GRAD_TOL:
        fail(f"{phase}: {pair}: the gradients of "
             f"{check['grad_worst_dense_leaf']} differ by "
             f"{check['grad_worst_dense']} of its RMS > {TRAIN_LM_GRAD_TOL}")
    if check["grad_worst_l2"] > TRAIN_LM_GRAD_TOL:
        fail(f"{phase}: {pair}: the gradients of "
             f"{check['grad_worst_l2_leaf']} differ by "
             f"{check['grad_worst_l2']} of its L2 norm > {TRAIN_LM_GRAD_TOL}")


def pair_checks(params, batch, cfgs: dict) -> tuple:
    """grad_pair_check of ``cfgs`` with PAIR_CHECK_DTYPE compute, the one
    train_family holds, and with the configs' own bf16 compute, recorded
    beside it: (held, the bf16 reading's summary)."""
    held = grad_pair_check(params, batch, {
        k: dataclasses.replace(c, compute_dtype=PAIR_CHECK_DTYPE)
        for k, c in cfgs.items()})
    bf16 = grad_pair_check(params, batch, cfgs)
    return held, {k: v for k, v in bf16.items()
                  if not isinstance(v, dict) or k == "grad_l2_rel_diff"}


def refusal_cases() -> list:
    """Each attention wrapper on CUDA tensors, one of which needs a
    gradient, with autograd on: each must raise RuntimeError (and launch
    nothing)."""
    def t(*shape, dtype=torch.bfloat16, grad=False):
        x = torch.zeros(shape, dtype=dtype, device=DEVICE)
        return x.requires_grad_(grad) if grad else x

    valid = torch.full((1,), 64, dtype=torch.int32, device=DEVICE)
    cases = (
        ("flash_attention", lambda: flash_attention_cuda(
            t(1, 64, 2, 64, grad=True), t(1, 64, 1, 64), t(1, 64, 1, 64))),
        ("flash_attention_dequant", lambda: flash_attention_dequant_cuda(
            t(1, 64, 2, 64, grad=True), t(1, 64, 1, 64, dtype=torch.int8),
            t(1, 64, dtype=torch.float32), t(1, 64, 1, 64, dtype=torch.int8),
            t(1, 64, dtype=torch.float32))),
        ("decode_attention", lambda: decode_attention_cuda(
            t(1, 1, 2, 64, grad=True), t(1, 64, 1, 64), t(1, 64, 1, 64),
            valid)))
    lines = []
    reset_counts()
    for name, call in cases:
        try:
            call()
        except RuntimeError as err:
            lines.append({"wrapper": name, "raised": "RuntimeError",
                          "message": str(err)})
            emit("train_lm", part="refusal", **lines[-1])
            continue
        fail(f"train_lm: {name} returned for a CUDA q that needs a gradient")
    torch.cuda.synchronize()
    counts = launch_counts()
    if any(counts[n] for n, _ in cases):
        fail(f"train_lm: a refused wrapper launched: {counts}")
    return lines


def prune_lm(cfg, params) -> dict:
    """LAKP in every layer, in place: prune_lm_ffn (PRUNE_FFN_BLOCKS blocks
    at PRUNE_FFN_SPARSITY) and prune_lm_heads (PRUNE_HEAD_SPARSITY of the
    KV groups).  Returns the masks' survivors."""
    block = params["units"]["block"]
    ffn_kept, heads_kept = [], []
    with torch.no_grad():
        for i in range(cfg.n_layers):
            ffn = {k: block["ffn"][k][i] for k in ("wi", "wg", "wo")}
            new, mask = pruning.prune_lm_ffn(ffn, PRUNE_FFN_BLOCKS,
                                             PRUNE_FFN_SPARSITY)
            for k in ffn:
                block["ffn"][k][i].copy_(new[k])
            ffn_kept.append(int(mask.sum()))
            attn = {k: block["attn"][k][i] for k in ("wq", "wk", "wv", "wo")}
            new, mask = pruning.prune_lm_heads(attn, cfg.n_heads,
                                               cfg.n_kv_heads,
                                               PRUNE_HEAD_SPARSITY)
            for k in attn:
                block["attn"][k][i].copy_(new[k])
            heads_kept.append(mask.to(torch.int32).tolist())
    return {"ffn_blocks_kept": ffn_kept, "kv_groups_kept": heads_kept}


def phase_train_lm() -> dict:
    """The LM analogue of train_capsnet: full-width llama3.2-1b trained on
    the card (chunked attention, remat), its chunked attention's backward
    held against the reference attention's, the attention wrappers'
    refusal of a gradient checked on the card, LAKP-pruned in every layer,
    then served through the kernels against the plain path.  Returns the
    launches of the serve by kernel-table row."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg_lib.get_config(LM_ARCH),
                              attn_impl="chunked")
    stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab))
    tokens = TRAIN_LM_BATCH * TRAIN_LM_SEQ

    def loss_fn(p, b):
        return lm.loss_fn(p, cfg, b)

    # 1. train, every step bracketed by CUDA events
    tcfg = TrainerConfig(optim=AdamWConfig(
        lr=TRAIN_LM_LR, warmup_steps=TRAIN_LM_WARMUP,
        total_steps=TRAIN_LM_STEPS), log_every=1)
    trainer = Trainer(tcfg, loss_fn, lambda g: lm.init(cfg, g, DEVICE),
                      device=DEVICE)
    events = []
    event_timed_steps(trainer, events)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = trainer.run(stream.batches(TRAIN_LM_BATCH, TRAIN_LM_SEQ,
                                     TRAIN_LM_STEPS), TRAIN_LM_STEPS,
                      generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    losses = [h["loss"] for h in res.history]
    n_params = sum(int(x.numel()) for x in tree_leaves(res.params))
    if len(losses) != TRAIN_LM_STEPS or not all(np.isfinite(losses)):
        fail(f"train_lm: losses {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last5 < first5:
        fail(f"train_lm: the loss did not fall: mean of the first five "
             f"{first5}, of the last five {last5}")
    card = nvidia_smi_line()
    if "H100" not in card:
        fail(f"train_lm: train_mfu takes the H100's bf16 peak; the card is "
             f"{card}")
    median = step_ms[len(step_ms) // 2]
    flops_per_step = roofline.model_flops(
        LM_ARCH, {"batch": TRAIN_LM_BATCH, "seq": TRAIN_LM_SEQ,
                  "kind": "train"})

    # the step's device time by kernel class, from a trace of a few more
    step = make_train_step(loss_fn, tcfg, donate=False)
    held = {k: torch.as_tensor(v, device=DEVICE) for k, v in stream.sample(
        TRAIN_LM_BATCH, TRAIN_LM_SEQ, TRAIN_LM_HELD_OUT_SEED).items()}
    state = [res.params, res.opt_state]

    def one_step():
        state[0], state[1], _ = step(state[0], state[1], held)

    one_step()
    kernels, host, trace = profile_ms(one_step, TRAIN_LM_PROFILE_STEPS)
    del state, one_step, step
    busy = sum(kernels.values()) if kernels else None
    by_class = {}
    for name, ms in (kernels or {}).items():
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + ms
    components = train_lm_components(cfg, res.params,
                                     (TRAIN_LM_BATCH, TRAIN_LM_SEQ,
                                      cfg.d_model))
    emit("train_lm", part="train", arch=LM_ARCH, params=n_params,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         attn_impl=cfg.attn_impl, remat=cfg.remat, loss_remat=cfg.loss_remat,
         batch=TRAIN_LM_BATCH, seq=TRAIN_LM_SEQ, steps=res.step,
         train_s=train_s, step_ms_median=median, step_ms_min=step_ms[0],
         step_ms_max=step_ms[-1], tokens_per_s=tokens / (median / 1e3),
         model_flops_per_step=flops_per_step,
         train_mfu=flops_per_step / (median / 1e3) / BF16_FLOP_PER_S,
         mfu_peak={"name": BF16_PEAK_NAME, "flop_per_s": BF16_FLOP_PER_S,
                   "card": card},
         losses=losses, loss_first5_mean=first5, loss_last5_mean=last5,
         max_memory_allocated_bytes=peak_bytes,
         step_device_busy_ms=busy,
         step_device_idle_share=(max(0.0, 1.0 - busy / median)
                                 if busy else None),
         step_device_ms_by_class=by_class,
         step_device_ms_by_kernel=dict(sorted(
             (kernels or {}).items(), key=lambda kv: -kv[1])[:10]),
         step_trace_dropped=trace["trace_dropped"],
         step_host_self_ms=sum(host.values()),
         components=components)

    # 2. the chunked attention's backward against the reference attention's
    check = grad_pair_check(res.params, held, {
        impl: dataclasses.replace(cfg, attn_impl=impl)
        for impl in ("chunked", "reference")})
    emit("train_lm", part="attention_backward", loss_tol=TRAIN_LM_LOSS_TOL,
         grad_tol=TRAIN_LM_GRAD_TOL, **check)
    hold_grad_pair("train_lm", "chunked against reference", check)

    # 3. the attention wrappers refuse a gradient on the card
    refused = refusal_cases()

    # 4. LAKP in every layer, held-out loss before and after
    params = res.params
    del res, trainer
    torch.cuda.empty_cache()
    with torch.no_grad():
        held_before = float(lm.loss_fn(params, cfg, held)[0])
        kept = prune_lm(cfg, params)
        held_after = float(lm.loss_fn(params, cfg, held)[0])
    if not (np.isfinite(held_before) and np.isfinite(held_after)):
        fail(f"train_lm: held-out loss {held_before} -> {held_after}")
    emit("train_lm", part="prune", held_out_seed=TRAIN_LM_HELD_OUT_SEED,
         held_out_loss_trained=held_before, held_out_loss_pruned=held_after,
         ffn_sparsity=PRUNE_FFN_SPARSITY, ffn_blocks=PRUNE_FFN_BLOCKS,
         head_sparsity=PRUNE_HEAD_SPARSITY, **kept)

    # 5. serve the pruned, trained model through the kernels
    torch.cuda.empty_cache()
    serve_cfg = dataclasses.replace(cfg, attn_impl="cuda")
    numbers, launches = serve_against_plain("train_lm (serve)", serve_cfg,
                                            params, breakdown=False,
                                            n_requests=TRAIN_LM_SERVE_REQUESTS)
    del params
    torch.cuda.empty_cache()
    # 6. the serve half's path went through rows 3, 5 and 9
    for row in ("flash_attention", "decode_attention", "fused_sampling"):
        if launches.get(row, 0) < 1:
            fail(f"train_lm: {row} was never launched serving the pruned "
                 f"model")
    emit("train_lm", part="serve", refusals=len(refused),
         reduced=[f"requests {LM_REQUESTS} -> {TRAIN_LM_SERVE_REQUESTS}"],
         **numbers,
         seconds=time.perf_counter() - t_phase)
    return launches


def family_train_cfg(arch: str, n_layers: int = 0):
    """``arch`` at full width with float32 parameters and attn_impl
    "chunked"; its depth cut to ``n_layers`` when one is given."""
    cut = {"attn_impl": "chunked"}
    if n_layers:
        cut["n_layers"] = n_layers
    return dataclasses.replace(cfg_lib.get_config(arch), **cut)


def counted_train_step(cfg, batch: int, seq: int) -> dict:
    """The dry run's count of one AdamW step of ``cfg`` (the cut config)
    on the meta device, not donating: argument bytes (parameters and
    AdamW moments), the peak of the step's temporaries, flops, bytes and
    the bound (the larger of bytes over HBM_BW and flops over
    PEAK_FLOPS)."""
    mesh = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    rules = shard_lib.rules_for_arch(cfg.arch_id, kind="train")
    shape = {"seq": seq, "batch": batch, "kind": "train"}
    fn, args, in_sh, out_sh = dryrun.build_cell(cfg.arch_id, shape, rules,
                                                mesh, "opt", cfg=cfg)
    out, cost, trace_s = dryrun.count_cell(fn, args)
    rec = dryrun.record(cfg.arch_id, "train_family", mesh, "1x1", "opt",
                        cost, trace_s, args, in_sh, out, out_sh)
    t_ops = rec["flops_per_dev"] / roofline.PEAK_FLOPS
    t_bytes = rec["bytes_per_dev"] / roofline.HBM_BW
    return {"arg_bytes_counted": rec["arg_bytes_per_dev"],
            "temp_bytes_counted": rec["temp_bytes_per_dev"],
            "args_plus_temp_counted": (rec["arg_bytes_per_dev"]
                                       + rec["temp_bytes_per_dev"]),
            "flops_counted": rec["flops_per_dev"],
            "bytes_counted": rec["bytes_per_dev"],
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "count_s": trace_s}


def train_family_steps(cfg, batches, items: str, n_items: int) -> tuple:
    """TRAIN_FAMILY_STEPS Trainer steps of ``cfg`` from seed 0 on
    ``batches`` (each of ``n_items`` tokens or frames), every step
    bracketed by CUDA events, the peak of allocated memory from the init
    on.  Fails unless every loss is finite and the mean of the last three
    is below the mean of the first three.  Returns (the TrainResult, the
    numbers)."""
    tcfg = TrainerConfig(optim=AdamWConfig(
        lr=TRAIN_LM_LR, warmup_steps=TRAIN_FAMILY_WARMUP,
        total_steps=TRAIN_FAMILY_STEPS), log_every=1)
    trainer = Trainer(tcfg, lambda p, b: lm.loss_fn(p, cfg, b),
                      lambda g: lm.init(cfg, g, DEVICE), device=DEVICE)
    events = []
    event_timed_steps(trainer, events)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    before = settled_allocation()
    t0 = time.perf_counter()
    res = trainer.run(batches, TRAIN_FAMILY_STEPS, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(a.elapsed_time(b) for a, b in events)
    losses = [h["loss"] for h in res.history]
    if len(losses) != TRAIN_FAMILY_STEPS or not all(np.isfinite(losses)):
        fail(f"train_family: {cfg.arch_id}: losses {losses}")
    first3, last3 = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not last3 < first3:
        fail(f"train_family: {cfg.arch_id}: the loss did not fall: mean of "
             f"the first three {first3}, of the last three {last3}")
    median = step_ms[len(step_ms) // 2]
    return res, dict(
        params=sum(int(x.numel()) for x in tree_leaves(res.params)),
        param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
        attn_impl=cfg.attn_impl, remat=cfg.remat, remat_group=cfg.remat_group,
        n_layers=cfg.n_layers, steps=res.step, lr=TRAIN_LM_LR,
        warmup_steps=TRAIN_FAMILY_WARMUP, train_s=train_s,
        step_ms_median=median, step_ms_min=step_ms[0],
        step_ms_max=step_ms[-1],
        **{f"{items}_per_step": n_items,
           f"{items}_per_s": n_items / (median / 1e3)},
        losses=losses, aux_losses=[h["aux"] for h in res.history],
        loss_first3_mean=first3, loss_last3_mean=last3,
        max_memory_allocated_bytes=peak, allocated_before_bytes=before)


def settled_allocation() -> int:
    """Collect what earlier phases left to the garbage collector, reset the
    peak, and return the bytes still allocated: the base a step's measured
    peak is taken above."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def beside_count(numbers: dict, counted: dict) -> dict:
    """The measured step, and the peak above what was allocated before the
    init, beside the dry run's count."""
    return dict(counted=counted,
                bound_over_measured=counted["bound_ms"]
                / numbers["step_ms_median"],
                peak_over_counted=(numbers["max_memory_allocated_bytes"]
                                   - numbers["allocated_before_bytes"])
                / counted["args_plus_temp_counted"])


def token_batches(vocab: int):
    return TokenStream(TokenStreamConfig(vocab=vocab)).batches(
        TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_STEPS)


def audio_batch(cfg, seed: int, clips: int) -> dict:
    """AUDIO_FRAMES frames of features and labels from RandomState(seed),
    as tests/test_torch_lm_train.py draws them."""
    rng = np.random.RandomState(seed)
    return {"labels": rng.randint(0, cfg.vocab, (clips, AUDIO_FRAMES)
                                  ).astype(np.int32),
            "features": rng.standard_normal(
                (clips, AUDIO_FRAMES, cfg.d_model)).astype(np.float32)}


def to_device(batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}


def block_grad_check(label: str, apply_fn, defs, cfg) -> dict:
    """One block (``defs`` of ``cfg`` at full width) with float32 compute:
    loss <output, a fixed random projection> on a (1, BLOCK_SEQ, d_model)
    input from RandomState(2), parameters from a CPU generator seeded 1;
    the loss and the gradients of the input and every parameter on the
    card against the same call on the CPU.  Fails past BLOCK_TOL."""
    bcfg = dataclasses.replace(cfg, compute_dtype="float32")
    host = init_params(defs(bcfg), torch.Generator().manual_seed(1),
                       torch.float32)
    rng = np.random.RandomState(2)
    x = rng.standard_normal((1, BLOCK_SEQ, cfg.d_model)).astype(np.float32)
    proj = rng.standard_normal(x.shape).astype(np.float32)
    runs = {}
    for dev in (DEVICE, "cpu"):
        p = {k: v.detach().clone().to(dev).requires_grad_(True)
             for k, v in host.items()}
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        t0 = time.perf_counter()
        y, _ = apply_fn(p, bcfg, xt, None)
        terms = y.float() * torch.from_numpy(proj).to(dev)
        loss = terms.sum()
        grads = torch.autograd.grad(loss, [xt, *p.values()])
        runs[dev] = (float(loss.detach()), float(terms.detach().abs().sum()),
                     dict(zip(["x", *p], [g.cpu() for g in grads])),
                     time.perf_counter() - t0)
        del p, xt, y, terms, loss, grads
    (lc, mag, gc, sc), (lh, _, gh, sh) = runs[DEVICE], runs["cpu"]
    loss_diff = abs(lc - lh) / mag
    worst = {k: float((gc[k] - gh[k]).abs().max()
                      / gh[k].abs().max().clamp(min=1e-30)) for k in gh}
    if not all(bool(torch.isfinite(g).all()) for g in gc.values()):
        fail(f"train_family: {label} block: the card's gradients are not "
             f"finite")
    if any(float(g.abs().max()) == 0.0 for g in gh.values()):
        fail(f"train_family: {label} block: a gradient is 0 on the CPU")
    if loss_diff > BLOCK_TOL:
        fail(f"train_family: {label} block: the card's loss {lc} and the "
             f"CPU's {lh} differ by {loss_diff} of the terms' magnitude "
             f"> {BLOCK_TOL}")
    leaf = max(worst, key=worst.get)
    if worst[leaf] > BLOCK_TOL:
        fail(f"train_family: {label} block: the gradient of {leaf} differs "
             f"between the card and the CPU by {worst[leaf]} of its largest "
             f"magnitude > {BLOCK_TOL}")
    return {"block": label, "input": [1, BLOCK_SEQ, cfg.d_model],
            "loss_card": lc, "loss_cpu": lh, "loss_diff_over_terms": loss_diff,
            "grad_max_diff_over_max": worst, "grad_worst_leaf": leaf,
            "grad_worst": worst[leaf], "tol": BLOCK_TOL,
            "card_s": sc, "cpu_s": sh}


def start_train_launcher():
    """``python -m repro_torch.launch.train`` with TRAIN_LAUNCHER_ARGS (no
    --device: the card) in its own process."""
    env = port_env()
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *TRAIN_LAUNCHER_ARGS], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def finish_train_launcher(proc) -> dict:
    """Wait for start_train_launcher's process: it must exit 0 on the card
    and print one finite loss a step."""
    log = proc.communicate(timeout=600)[0]
    lines = log.strip().splitlines()
    losses = [float(line.split("'loss': ")[1].split(",")[0])
              for line in lines if "'loss': " in line]
    if (proc.returncode != 0 or len(losses) != TRAIN_LAUNCHER_STEPS
            or not all(np.isfinite(losses)) or " on cuda" not in log):
        fail(f"train_family: launcher {' '.join(TRAIN_LAUNCHER_ARGS)}: exit "
             f"{proc.returncode}, losses {losses}: {log[-2000:]}")
    return {"args": list(TRAIN_LAUNCHER_ARGS), "exit": proc.returncode,
            "losses": losses, "first_line": lines[0][:300]}


def watch_routing(masks: list) -> tuple:
    """Wrap moe_apply so that every call's routed (token, expert) pairs are
    counted by expert (routing_counts) against the experts LAKP pruned in
    its layer (``masks``, one (E,) keep-mask a layer; calls come in layer
    order).  A staged call is watched where it runs its Python (eagerly,
    or before its capture; the capture itself reads nothing back, and a
    replay calls nothing).  Returns (the tallies, a function that removes
    the watch)."""
    from repro_torch.models import moe as moe_lib

    seen = {"calls": 0, "pairs": 0, "pairs_to_pruned": 0,
            "bias_marks_pruned": True}
    inner = moe_lib.moe_apply

    def watched(p, c, x, token_mask=None):
        if graphs.capturing():         # recorded, not run: no host read
            return inner(p, c, x, token_mask=token_mask)
        pruned = ~masks[seen["calls"] % len(masks)].to(torch.bool)
        seen["calls"] += 1
        load = torch.tensor(routing_counts(p, c, x, token_mask)
                            ["load_by_expert"])
        seen["pairs"] += int(load.sum())
        seen["pairs_to_pruned"] += int(load[pruned.cpu()].sum())
        if not torch.equal((p["router_b"] < -1e8).cpu(), pruned.cpu()):
            seen["bias_marks_pruned"] = False
        return inner(p, c, x, token_mask=token_mask)

    moe_lib.moe_apply = watched
    return seen, lambda: setattr(moe_lib, "moe_apply", inner)


def prune_moe(cfg, params) -> list:
    """LAKP over each layer's routed experts, in place
    (``pruning.prune_moe_experts`` at MOE_PRUNE_SPARSITY); returns the
    keep-masks."""
    ffn = params["units"]["block"]["ffn"]
    keys = ("router", "router_b", "wi", "wg", "wo")
    masks = []
    with torch.no_grad():
        for i in range(cfg.n_layers):
            new, mask = pruning.prune_moe_experts(
                {k: ffn[k][i] for k in keys}, MOE_PRUNE_SPARSITY,
                method="lakp")
            for k in keys:
                ffn[k][i].copy_(new[k])
            masks.append(mask)
    return masks


def train_moe(counted: dict) -> dict:
    """deepseek-moe-16b cut to MOE_TRAIN_LAYERS: train (aux > 0 at every
    step), one-hot against scatter on a held-out batch, LAKP, then the
    pruned model served through the kernels against the plain path with
    no pair routed to a pruned expert.  Returns the serve's launches by
    kernel-table row."""
    t0 = time.perf_counter()
    cfg = family_train_cfg(MOE_ARCH, MOE_TRAIN_LAYERS)
    stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab))
    res, numbers = train_family_steps(
        cfg, token_batches(cfg.vocab), "tokens",
        TRAIN_FAMILY_BATCH * TRAIN_FAMILY_SEQ)
    if not all(a > 0 for a in numbers["aux_losses"]):
        fail(f"train_family: moe aux {numbers['aux_losses']}")
    params = res.params
    del res
    held = to_device(stream.sample(TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ,
                                   TRAIN_LM_HELD_OUT_SEED))
    check, bf16 = pair_checks(params, held, {
        d: dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            dispatch=d))
        for d in ("onehot", "scatter")})
    router = {k: v for k, v in check["grad_max_abs"].items()
              if k.endswith("/router")}
    emit("train_family", part="train", arch=MOE_ARCH,
         reduced=FAMILY_TRAIN_CUTS[MOE_ARCH],
         batch=TRAIN_FAMILY_BATCH, seq=TRAIN_FAMILY_SEQ,
         dispatch=cfg.moe.dispatch, **numbers,
         **beside_count(numbers, counted),
         router_grad_max_abs=router, check_compute_dtype=PAIR_CHECK_DTYPE,
         loss_tol=TRAIN_LM_LOSS_TOL, grad_tol=TRAIN_LM_GRAD_TOL,
         onehot_against_scatter={k: v for k, v in check.items()
                                 if k != "grad_max_abs"},
         onehot_against_scatter_bf16_not_held=bf16,
         seconds=time.perf_counter() - t0)
    hold_grad_pair("train_family", "moe onehot against scatter", check)
    if not router or not all(0 < v < math.inf for v in router.values()):
        fail(f"train_family: the router's gradient {router}")

    # LAKP over the routed experts of each layer, then serve
    t0 = time.perf_counter()
    with torch.no_grad():
        held_before = float(lm.loss_fn(params, cfg, held)[0])
        masks = prune_moe(cfg, params)
        held_after = float(lm.loss_fn(params, cfg, held)[0])
    if not (np.isfinite(held_before) and np.isfinite(held_after)):
        fail(f"train_family: moe held-out loss {held_before} -> "
             f"{held_after}")
    torch.cuda.empty_cache()
    seen, unwatch = watch_routing(masks)
    try:
        numbers, launches = serve_against_plain(
            "train_family (moe serve)",
            dataclasses.replace(cfg, attn_impl="cuda"), params,
            breakdown=False)
    finally:
        unwatch()
    del params
    torch.cuda.empty_cache()
    if (seen["calls"] < cfg.n_layers or seen["pairs_to_pruned"]
            or not seen["bias_marks_pruned"]):
        fail(f"train_family: the pruned moe's routing: {seen}")
    for row in ("flash_attention", "decode_attention", "fused_sampling"):
        if launches.get(row, 0) < 1:
            fail(f"train_family: {row} was never launched serving the "
                 f"pruned moe")
    emit("train_family", part="moe_prune_serve", arch=MOE_ARCH,
         sparsity=MOE_PRUNE_SPARSITY, method="lakp",
         held_out_seed=TRAIN_LM_HELD_OUT_SEED,
         held_out_loss_trained=held_before, held_out_loss_pruned=held_after,
         experts_kept=[torch.nonzero(m).flatten().tolist() for m in masks],
         routing=seen, routing_watched=True, **numbers,
         seconds=time.perf_counter() - t0)
    return launches


def train_recurrent(arch: str, n_layers: int, reduced: list, blocks,
                    counted) -> None:
    """xlstm-1.3b or zamba2-1.2b: train, then each of ``blocks`` ((label,
    apply, defs)) card against host."""
    t0 = time.perf_counter()
    cfg = family_train_cfg(arch, n_layers)
    res, numbers = train_family_steps(
        cfg, token_batches(cfg.vocab), "tokens",
        TRAIN_FAMILY_BATCH * TRAIN_FAMILY_SEQ)
    del res
    torch.cuda.empty_cache()
    checks = [block_grad_check(label, apply_fn, defs, cfg)
              for label, apply_fn, defs in blocks]
    emit("train_family", part="train", arch=arch, reduced=reduced,
         batch=TRAIN_FAMILY_BATCH, seq=TRAIN_FAMILY_SEQ, **numbers,
         **(beside_count(numbers, counted) if counted else
            {"counted": "not taken: the sLSTM time loop is counted step "
                        "by step (PERF.md §6 has the count)"}),
         block_backward=checks, seconds=time.perf_counter() - t0)


def train_audio(counted: dict) -> None:
    """hubert-xlarge at the published size: train, then chunked against
    reference attention on GRAD_CHECK_CLIPS held-out clips."""
    t0 = time.perf_counter()
    cfg = family_train_cfg(AUDIO_ARCH)
    batches = (audio_batch(cfg, i, TRAIN_FAMILY_BATCH)
               for i in range(TRAIN_FAMILY_STEPS))
    res, numbers = train_family_steps(cfg, batches, "frames",
                                      TRAIN_FAMILY_BATCH * AUDIO_FRAMES)
    params = res.params
    del res
    torch.cuda.empty_cache()
    check, bf16 = pair_checks(params, to_device(audio_batch(
        cfg, TRAIN_LM_HELD_OUT_SEED, GRAD_CHECK_CLIPS)), {
            impl: dataclasses.replace(cfg, attn_impl=impl)
            for impl in ("chunked", "reference")})
    del params
    emit("train_family", part="train", arch=AUDIO_ARCH, reduced=[],
         batch=TRAIN_FAMILY_BATCH, frames=AUDIO_FRAMES, causal=cfg.causal,
         **numbers, **beside_count(numbers, counted),
         loss_tol=TRAIN_LM_LOSS_TOL, grad_tol=TRAIN_LM_GRAD_TOL,
         grad_check_clips=GRAD_CHECK_CLIPS,
         check_compute_dtype=PAIR_CHECK_DTYPE,
         chunked_against_reference={k: v for k, v in check.items()
                                    if k != "grad_max_abs"},
         chunked_against_reference_bf16_not_held=bf16,
         seconds=time.perf_counter() - t0)
    hold_grad_pair("train_family", "hubert chunked against reference", check)


def vlm_backward(counted: dict) -> None:
    """One unit of llama-3.2-vision-90b at full width, float32 parameters,
    every cross gate at VLM_GATE: loss and gradients of VLM_GRAD_BATCH x
    VLM_GRAD_SEQ tokens with image features, chunked against reference
    (the chunked path's gradients wait in host memory); every cross leaf
    and embed/img_proj has a finite, non-zero gradient.  No AdamW step:
    ``counted`` (one unit's step) does not fit the card."""
    t0 = time.perf_counter()
    cfg = family_train_cfg(VLM_ARCH, VLM_GRAD_LAYERS)
    before = settled_allocation()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, DEVICE)
    cross = params["units"]["cross"]["attn"]
    with torch.no_grad():
        cross["gate"].fill_(VLM_GATE)
    rng = np.random.RandomState(5)
    batch = to_device({
        "tokens": rng.randint(0, cfg.vocab, (VLM_GRAD_BATCH, VLM_GRAD_SEQ)
                              ).astype(np.int32),
        "labels": rng.randint(0, cfg.vocab, (VLM_GRAD_BATCH, VLM_GRAD_SEQ)
                              ).astype(np.int32),
        "image_features": rng.standard_normal(
            (VLM_GRAD_BATCH, cfg.n_image_tokens, cfg.d_model)
        ).astype(np.float32)})
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    check = grad_pair_check(params, batch, {
        impl: dataclasses.replace(cfg, attn_impl=impl,
                                  compute_dtype=PAIR_CHECK_DTYPE)
        for impl in ("chunked", "reference")}, host_first=True)
    del params, batch
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    live = {k: v for k, v in check["grad_max_abs"].items()
            if k.startswith("units/cross/") or k == "embed/img_proj"}
    emit("train_family", part="backward", arch=VLM_ARCH,
         reduced=FAMILY_TRAIN_CUTS[VLM_ARCH],
         no_step_because=dict(counted, capacity_bytes=
                              roofline.HBM_CAPACITY_BYTES),
         params=n_params, param_dtype=cfg.param_dtype,
         compute_dtype=cfg.compute_dtype, batch=VLM_GRAD_BATCH,
         seq=VLM_GRAD_SEQ, image_tokens=cfg.n_image_tokens, gate=VLM_GATE,
         max_memory_allocated_bytes=peak, allocated_before_bytes=before,
         loss_tol=TRAIN_LM_LOSS_TOL,
         grad_tol=TRAIN_LM_GRAD_TOL, cross_grad_max_abs=live,
         check_compute_dtype=PAIR_CHECK_DTYPE,
         chunked_against_reference={k: v for k, v in check.items()
                                    if k != "grad_max_abs"},
         seconds=time.perf_counter() - t0)
    hold_grad_pair("train_family", "vlm chunked against reference", check)
    if (len(live) < 2 or "embed/img_proj" not in live
            or not all(0 < v < math.inf for v in live.values())):
        fail(f"train_family: vlm cross gradients {live}")
    fits = counted["args_plus_temp_counted"] <= roofline.HBM_CAPACITY_BYTES
    if fits:
        fail(f"train_family: the vlm step counts "
             f"{counted['args_plus_temp_counted']} bytes, which fit the "
             f"card: train it")


def phase_train_family() -> dict:
    """ROADMAP §C 6 on the card: the moe (train, one-hot against scatter,
    LAKP over experts, the pruned model served through the kernels), the
    ssm and the hybrid (train, each recurrent block's backward card against
    host, the hybrid through the launcher), the audio encoder (train,
    chunked against reference attention) and the vlm's cross path (loss
    and gradients of one unit).  Returns the moe serve's launches by
    kernel-table row."""
    # the launcher trains on the card in its own process while this one
    # counts the steps on the meta device
    torch.cuda.empty_cache()
    proc = start_train_launcher()
    try:
        counted = {cfg.arch_id: counted_train_step(cfg, batch, seq)
                   for cfg, batch, seq in (
                       (family_train_cfg(MOE_ARCH, MOE_TRAIN_LAYERS),
                        TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ),
                       (family_train_cfg(HYBRID_ARCH), TRAIN_FAMILY_BATCH,
                        TRAIN_FAMILY_SEQ),
                       (family_train_cfg(AUDIO_ARCH), TRAIN_FAMILY_BATCH,
                        AUDIO_FRAMES),
                       (family_train_cfg(VLM_ARCH, VLM_GRAD_LAYERS),
                        VLM_GRAD_BATCH, VLM_GRAD_SEQ))}
        launcher = finish_train_launcher(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    emit("train_family", part="launcher", **launcher)
    launches = train_moe(counted[MOE_ARCH])
    torch.cuda.empty_cache()
    train_recurrent(SSM_ARCH, SSM_LAYERS, FAMILY_TRAIN_CUTS[SSM_ARCH], (
        ("mlstm", xlstm_lib.mlstm_apply, xlstm_lib.mlstm_defs),
        ("slstm", xlstm_lib.slstm_apply, xlstm_lib.slstm_defs)), None)
    train_recurrent(HYBRID_ARCH, 0, [], (
        ("mamba2", mamba_lib.mamba2_apply, mamba_lib.mamba2_defs),),
        counted[HYBRID_ARCH])
    train_audio(counted[AUDIO_ARCH])
    vlm_backward(counted[VLM_ARCH])
    torch.cuda.empty_cache()
    return launches


def paged_requests(vocab: int, n_requests: int = LM_REQUESTS) -> list:
    """16 requests from RandomState(1), 32 new tokens each: the even ones
    begin with one shared 256-token prefix (16 full pages) followed by
    16-300 tokens of their own, the odd ones have prompts of 16-700 tokens
    of their own; ids in [1, vocab / 2).  Every fourth request samples at
    temperature 0.8 with top-k 50 and top-p 0.9 and a seed of its own, the
    others are greedy.  ``n_requests`` takes the first n of them."""
    rng = np.random.RandomState(1)
    shared = [int(t) for t in rng.randint(1, vocab // 2, size=SHARED_PREFIX)]
    reqs = []
    for i in range(n_requests):
        if i % 2 == 0:
            own = rng.randint(1, vocab // 2, size=int(rng.randint(16, 301)))
            prompt = shared + [int(t) for t in own]
        else:
            prompt = [int(t) for t in rng.randint(
                1, vocab // 2, size=int(rng.randint(16, 701)))]
        kw = {}
        if i % 4 == 3:
            kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=2000 + i)
        reqs.append(Request(prompt=prompt, max_new_tokens=LM_MAX_NEW, rid=i,
                            **kw))
    return reqs


def paged_valid(vocab: int) -> tuple:
    """The decode tick's valid lengths of the first 8 paged requests, 16
    tokens into decode (the timing rows of the paged decode bodies)."""
    return tuple(len(r.prompt) + 16 for r in paged_requests(vocab)[:LM_SLOTS])


def pool_nbytes(engine) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in engine._pool.values()))


def b6_cross_check(kern, reqs, cfg) -> dict:
    """The int8 dense-cache decode body (B6) against the paged int8 body on
    the same pool: 8 requests are admitted and decoded for a tick, then on
    copies of the engine's pool one decode tick runs (a) on the gathered
    int8 view (PagePool.build_view, dequant=False) through lm.decode_step
    with the dense int8 body, and (b) on the pool itself through
    paged_tables with the paged int8 body.  The two bodies sum the same rows
    in the same order, so the logits are expected to be equal; they are
    held to 0.25, one bfloat16 step at the logits' magnitude (about 45),
    and the greedy argmax must agree wherever the top-2 margin is at least
    its threshold (MARGIN_RULE)."""
    for r in fresh(reqs[:LM_SLOTS]):
        kern.submit(r)
    kern.tick()                                   # admission + first step
    kern.tick()
    # as the engine's own tick does: map the page under each write head
    kern._ensure_decode_pages([(s, t) for s, t in enumerate(kern._slots)
                               if t is not None])
    pages = kern._pages
    tables = torch.from_numpy(pages.tables_snapshot()).to(DEVICE)
    batch = {"tokens": torch.from_numpy(kern._tok[:, None].copy()).to(DEVICE),
             "pos": torch.from_numpy(kern._pos.copy()).to(DEVICE)}
    pool_a = {k: v.clone() for k, v in kern._pool.items()}
    pool_b = {k: v.clone() for k, v in kern._pool.items()}
    torch.cuda.synchronize()
    reset_counts()
    view = pages.build_view(pool_a, kern._residual, tables)
    logits_a, _ = lm.decode_step(kern.params, kern.cfg, batch, view)
    torch.cuda.synchronize()
    counts_a = launch_counts()
    reset_counts()
    logits_b, _ = lm.decode_step(kern.params, kern.cfg, batch,
                                 pages.pool_tree(pool_b, kern._residual),
                                 paged_tables=tables)
    torch.cuda.synchronize()
    counts_b = launch_counts()
    kern.run_until_idle()
    if counts_a["int8"] != cfg.n_layers or counts_b["paged_int8"] != \
            cfg.n_layers or counts_a["paged_int8"] or counts_b["int8"]:
        fail(f"serve_paged: cross-check launched the int8 body "
             f"{counts_a['int8']} and the paged int8 body "
             f"{counts_b['paged_int8']} times, expected {cfg.n_layers} each")
    a, b = logits_a.float().cpu().numpy(), logits_b.float().cpu().numpy()
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        fail("serve_paged: cross-check logits are not finite")
    err = float(np.abs(a - b).max())
    clear = np.array([m["margin"] >= m["threshold"]
                      for m in map(margin_of, b)])
    if err > 0.25:
        fail(f"serve_paged: int8 and paged int8 decode logits differ by "
             f"{err} > 0.25")
    if not np.array_equal(a.argmax(-1)[clear], b.argmax(-1)[clear]):
        fail("serve_paged: int8 and paged int8 decode disagree on a clear "
             "argmax")
    return {"max_abs_logit_diff": err, "clear_rows": int(clear.sum()),
            "launches_int8": counts_a["int8"],
            "launches_paged_int8": counts_b["paged_int8"]}


def pressured_serve(cfg, params, quantize: bool, reqs, logits=None,
                    n_pages=None) -> tuple:
    """One pressured serve (ROADMAP §C 1): the kernel engine with a
    PriorityScheduler and a pool of ``n_pages`` pages (PRESSURE_PAGES).  The first
    LM_SLOTS of ``reqs`` arrive at priority 1 and are resident after
    PRESSURE_LEAD ticks; the others then arrive at priority 0 and preempt
    them one a tick.  The preempted keep their pages until the pool runs
    dry, when _spill_preempted copies them to the host (resume re-imports
    them into fresh pages), and cached prefix pages are evicted LRU.  With
    a dict ``logits``, the seeded logits rows go there
    (record_seeded_logits).  Returns (tokens by rid, stats, page counters,
    wall seconds)."""
    eng = ServeEngine(cfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      page_size=PAGE, n_pages=n_pages or PRESSURE_PAGES,
                      quantize_pages=quantize, scheduler=PriorityScheduler(),
                      decode_kernel=True, device=DEVICE)
    if logits is not None:
        record_seeded_logits(eng, logits)
    t0 = time.perf_counter()
    for r in reqs[:LM_SLOTS]:
        eng.submit(dataclasses.replace(r, prompt=list(r.prompt), priority=1))
    for _ in range(PRESSURE_LEAD):
        eng.tick()
    for r in reqs[LM_SLOTS:]:
        eng.submit(dataclasses.replace(r, prompt=list(r.prompt), priority=0))
    done = eng.run_until_idle()
    wall = time.perf_counter() - t0
    if len(done) != len(reqs):
        fail(f"pressured serve: {len(done)} of {len(reqs)} requests "
             f"completed")
    st = eng.stats()
    return {c.rid: c.tokens for c in done}, st, dict(st.pages), wall


def paged_pressure(cfg, params, quantize: bool, reqs, unpressured: tuple,
                   margins) -> dict:
    """serve_paged under memory pressure (pressured_serve, twice).  Fails
    unless preemption, spill and eviction each happened, the greedy tokens
    hold against ``unpressured`` (the unpressured kernel run of the same
    mode: tokens and seeded logits rows; its margins are ``margins``) by
    the margin rule, and the second pressured run gives the seeded tokens
    bit for bit.  The seeded requests of the first run are held against
    the unpressured run by the sampling contract (compare_seeded).  The
    numbers carry both runs' launches."""
    mode = "paged_int8" if quantize else "paged"
    name = f"serve_paged ({mode}, pressure)"
    runs = []
    reset_counts()
    for logits in ({}, None):
        body = launch_counts()[mode]
        tok, st, pg, wall = pressured_serve(cfg, params, quantize, reqs,
                                            logits)
        if not (st.preempted > 0 and pg.get("spilled_pages", 0) > 0
                and pg.get("cache_evicted", 0) > 0):
            fail(f"{name}: preempted {st.preempted}, pages {pg}: expected "
                 f"preemption, spill and eviction")
        if launch_counts()[mode] == body:
            fail(f"{name}: the {mode} decode body never ran")
        runs.append((tok, st, pg, wall, logits))
    tok, st, pg, wall, logits = runs[0]
    tok_ref = unpressured[0]
    counts = launch_counts()
    compared, ambiguous, first_diff = compare_with_plain(
        name, reqs, tok, tok_ref, runs[1][0], margins, cfg.vocab)
    seeded, _ = compare_seeded(f"{name} (seeded)", reqs, unpressured,
                               (tok, logits))
    return {"n_pages": PRESSURE_PAGES, "lead_ticks": PRESSURE_LEAD,
            "preempted": st.preempted, "pages": pg, "ticks": st.ticks,
            "wall_s": wall, "tok_per_s": st.items / wall,
            "second_run_pages": runs[1][2],
            "greedy_tokens_compared": compared,
            "ambiguous_positions": ambiguous,
            "first_divergence": first_diff,
            "greedy_sequences_equal_unpressured": sum(
                1 for r in reqs if r.temperature == 0
                and tok[r.rid] == tok_ref[r.rid]),
            "seeded_bit_identical_across_pressured_runs": True,
            "seeded_against_unpressured": seeded,
            "launches": {k: counts[k] for k in ("flash_attention", mode,
                                                "fused_sampling")}}


def serve_paged_mode(cfg, params, quantize: bool, reqs) -> dict:
    """One page mode of phase serve_paged: the kernel engine against the
    plain paged engine of the same mode; returns the phase's numbers and
    the launches of the first kernel run."""
    mode = "paged_int8" if quantize else "paged"
    kw = dict(n_slots=LM_SLOTS, max_len=LM_MAX_LEN, page_size=PAGE,
              quantize_pages=quantize, device=DEVICE)
    kern = ServeEngine(cfg, params, decode_kernel=True, **kw)
    plain = ServeEngine(dataclasses.replace(cfg, attn_impl="chunked"), params,
                        **kw)
    for eng in (kern, plain):
        eng.generate([[1, 2, 3, 4] * 8], max_new_tokens=2)

    groups = count_calls(kern, "_prefill_paged_group")
    ticks = count_calls(kern, "_step")
    reset_counts()
    done = kern.serve(fresh(reqs))
    counts = launch_counts()
    stats = kern.stats()
    n_groups, n_ticks = groups[0], ticks[0]
    if len(done) != LM_REQUESTS:
        fail(f"serve_paged ({mode}): {len(done)} of {LM_REQUESTS} requests "
             f"completed")
    want = {"flash_attention": cfg.n_layers * n_groups,
            mode: cfg.n_layers * n_ticks,
            "decode_attention": cfg.n_layers * n_ticks,
            "fused_sampling": n_ticks,
            "fixed_order_matmul": gemm_launches(cfg, n_groups + n_ticks)}
    for name, n in want.items():
        if counts[name] != n or n < 1:
            fail(f"serve_paged ({mode}): {name} launched {counts[name]} "
                 f"times, expected {n} ({n_groups} prefill groups, {n_ticks} "
                 f"decode ticks)")
    check_prefill_bodies(f"serve_paged ({mode})", counts)
    pg = dict(stats.pages)
    # the prefix cache is warm from here on: the graph and eager runs
    # meet it alike (the first run's prefill groups were other ones)
    graph_numbers = lm_graphs(f"serve_paged ({mode})", kern, reqs)
    if not (pg["prefix_hits"] >= LM_SLOTS - 1 and pg["allocated"] > 0
            and pg["prefix_pages_hit"]
            == SHARED_PREFIX // PAGE * pg["prefix_hits"]):
        fail(f"serve_paged ({mode}): page counters {pg}")

    margins = record_margins(plain)
    done_plain = plain.serve(fresh(reqs))
    del plain
    # a second kernel engine: the same requests meet the same (empty)
    # prefix cache, so every prefill group has the same composition; it
    # records its margins (the pressured runs' rule) and its seeded logits
    unpressured = {}
    tok_again, kmargins = kernel_margins_of(
        ServeEngine(cfg, params, decode_kernel=True, **kw), reqs,
        unpressured)
    compared, ambiguous, first_diff = compare_with_plain(
        f"serve_paged ({mode})", reqs, {c.rid: c.tokens for c in done},
        {c.rid: c.tokens for c in done_plain}, tok_again, margins,
        cfg.vocab)
    out = {"pressure": paged_pressure(cfg, params, quantize, reqs,
                                      (tok_again, unpressured), kmargins)}
    if quantize:
        out["b6_cross_check"] = b6_cross_check(kern, reqs, cfg)
    breakdown = decode_tick_breakdown(kern, cfg.vocab)
    lat = stats.latency_summary()
    dense_bytes = (2 * cfg.n_layers * LM_SLOTS * LM_MAX_LEN * cfg.n_kv_heads
                   * cfg.head_dim * 2)
    out.update(
        mode=mode, pages=pg, requests=stats.completed,
        new_tokens=stats.items, ticks=stats.ticks, prefill_groups=n_groups,
        decode_ticks=n_ticks, tok_per_s=stats.throughput,
        ms_per_tick=stats.ms_per_tick,
        latency_ms={k: {"n": n, "p50": p50, "p95": p95}
                    for k, (n, p50, p95) in lat.items()},
        pool_bytes=pool_nbytes(kern), dense_slot_cache_bytes=dense_bytes,
        launches={k: counts[k] for k in want},
        prefill_launches_by_body={
            b: counts[f"flash_attention/{b}"] for b in ("tensor_core", "fma")},
        greedy_tokens_compared=compared, ambiguous_positions=ambiguous,
        margin_rule=MARGIN_RULE, first_divergence=first_diff,
        seeded_bit_identical=True, graphs=graph_numbers, **breakdown)
    return out, counts


def phase_serve_paged() -> dict:
    """Full-width llama3.2-1b through the paged ServeEngine: bf16 pages,
    then int8 pages, each with the kernel path (flash_attention in prefill
    and continuation prefill, the paged decode_attention body in every
    decode tick, fused_sampling) against the plain paged engine of the
    same mode (chunked attention, gathered view, host sampling), and the
    B6 cross-check in the int8 run."""
    torch.cuda.empty_cache()
    cfg, params, init_s, _ = init_lm()
    params = lm.compute_params(cfg, params)      # one cast for every engine
    torch.cuda.empty_cache()
    reqs = paged_requests(cfg.vocab)
    launches = {}
    for quantize in (False, True):
        out, counts = serve_paged_mode(cfg, params, quantize, reqs)
        emit("serve_paged", arch=LM_ARCH, init_s=init_s, slots=LM_SLOTS,
             max_len=LM_MAX_LEN, page_size=PAGE, n_pages=N_PAGES, **out)
        mode = out["mode"]
        pressure = out["pressure"]["launches"]
        launches[DECODE_ROWS[mode]] = counts[mode] + pressure[mode]
        for k in ("flash_attention", "fused_sampling"):
            launches[k] = launches.get(k, 0) + counts[k] + pressure[k]
        if quantize:
            launches["decode_attention_dequant"] = \
                out["b6_cross_check"]["launches_int8"]
    return launches


# ---------------------------------------------------------------------------
# Disaggregated serving
# ---------------------------------------------------------------------------


def record_kernel_margins(engine) -> Margins:
    """record_margins for a kernel engine: the prefill tokens are sampled on
    the host, the decode tokens by one fused_sampling launch a tick, whose
    logits rows' top two and largest |logit| are kept on the device for
    every active slot (Margins.ticks: nothing crosses to the host while the
    engine serves)."""
    margins = record_margins(engine)
    inner = engine._observe_logits

    def wrapped(logits, active, pos_of, lo=0):
        x = logits.float()
        top2 = x.topk(2, -1).values
        margins.ticks.append(torch.stack(
            (top2[:, 0], top2[:, 1], x.abs().amax(-1)), -1))
        tick = len(margins.ticks) - 1
        for s, task in active:
            margins.at[(task.rid, pos_of(s))] = (tick, s - lo)
        inner(logits, active, pos_of, lo)

    engine._observe_logits = wrapped
    return margins


def kernel_margins_of(engine, reqs, logits=None) -> tuple:
    """``reqs`` served on the kernel engine with record_kernel_margins (and,
    given a dict ``logits``, record_seeded_logits into it), the engine's
    own sampling hooks back in place after: (tokens by rid, margins), the
    margin rule's input for a comparison with this run."""
    if logits is not None:
        record_seeded_logits(engine, logits)
    margins = record_kernel_margins(engine)
    try:
        done = engine.serve(fresh(reqs))
    finally:
        for hook in ("_sample_task_row", "_observe_logits"):
            engine.__dict__.pop(hook, None)
    return {c.rid: c.tokens for c in done}, margins


def unified_reference(cfg, params, reqs, seeded=None, **kw) -> tuple:
    """The unified kernel engine on ``reqs``: one timed run that keeps the
    margin rule's input on the device (record_kernel_margins): (tokens,
    margins, tok/s and ms per tick).  Given a dict ``seeded``, a second,
    untimed run on the same engine puts its tokens under ``tokens`` and
    its seeded logits rows under ``rows`` (record_seeded_logits)."""
    eng = ServeEngine(cfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      decode_kernel=True, device=DEVICE, **kw)
    eng.generate([[1, 2, 3, 4] * 8], max_new_tokens=2)
    margins = record_kernel_margins(eng)
    t0 = time.perf_counter()
    done = eng.serve(fresh(reqs))
    wall = time.perf_counter() - t0
    stats = eng.stats()
    if seeded is not None:
        for hook in ("_sample_task_row", "_observe_logits"):
            eng.__dict__.pop(hook, None)
        seeded["rows"] = {}
        seeded["tokens"] = serve_seeded(eng, reqs, seeded["rows"])
    del eng
    return ({c.rid: c.tokens for c in done}, margins,
            {"tok_per_s": stats.items / wall, "ms_per_tick": stats.ms_per_tick,
             "engine_tok_per_s": stats.throughput, "wall_s": wall})


def warm_disagg(engine) -> None:
    """A short generate() through every member engine, outside the stats."""
    for eng in engine._members():
        eng.generate([[1, 2, 3, 4] * 8], max_new_tokens=2)


def leg_numbers(records) -> dict:
    """Per leg of a transport's records: the median and largest seconds
    over the deliveries (exact, unlike the histograms' power-of-two
    buckets), in ms, and for a leg that times a copy (host staging's d2h
    and h2d; ``pass`` and ``dispatch`` time no copy) the GB/s the payload
    gives at the median."""
    nbytes = sorted(r.nbytes for r in records)[len(records) // 2]
    out = {"bytes_per_handoff": nbytes, "deliveries": len(records)}
    for leg in records[0].legs:
        ts = sorted(r.legs[leg] for r in records)
        med = ts[len(ts) // 2]
        out[leg] = {"p50_ms": med * 1e3, "max_ms": ts[-1] * 1e3}
        if leg in ("d2h", "h2d") and med > 0:
            out[leg]["gb_per_s"] = nbytes / med / 1e9
    return out


def copy_bounds(nbytes: int) -> dict:
    """What the card's links give for one handoff's bytes in this run, by
    CUDA events: a pinned host -> device and device -> host copy (the
    host link, host staging's bound) and a device -> device copy (HBM, the
    device-to-device transport's copy), beside the HBM bound of that copy
    (read and write once at 3.35 TB/s)."""
    n = nbytes // 2
    dev = torch.empty(n, dtype=torch.bfloat16, device=DEVICE)
    dst = torch.empty_like(dev)
    host = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
    out = {}
    for name, fn in (("h2d", lambda: dev.copy_(host, non_blocking=True)),
                     ("d2h", lambda: host.copy_(dev, non_blocking=True)),
                     ("d2d", lambda: dst.copy_(dev))):
        ms = median_ms(fn, launches=5, repeats=5)
        out[name] = {"ms": ms, "gb_per_s": nbytes / ms / 1e6}
    out["d2d_hbm_bound_ms"] = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    return out


def disagg_engine(cfg, params, transport: str):
    """serve_disagg's dense disaggregated engine over ``transport``
    (DisaggScheduler(overlap=True) for device_to_device), warmed up."""
    eng = disaggregated_lm_engine(
        cfg, params, n_slots=DISAGG_SLOTS, max_len=LM_MAX_LEN,
        n_decode=DISAGG_DECODES, prefill_slots=LM_SLOTS,
        transport=make_transport(transport, keep_records=LM_REQUESTS),
        scheduler=DisaggScheduler(
            overlap=transport == "device_to_device"),
        decode_kernel=True, device=DEVICE)
    warm_disagg(eng)
    return eng


def disagg_transport(cfg, params, reqs, transport: str) -> tuple:
    """One transport of phase serve_disagg: the dense disaggregated engine
    on ``reqs``, its seeded logits rows recorded (record_seeded_logits on
    every member); returns (tokens, numbers, launch counts, seeded logits
    rows)."""
    eng = disagg_engine(cfg, params, transport)
    logits = {}
    for member in eng._members():
        record_seeded_logits(member, logits)
    reset_counts()
    window = pool_window(eng)
    t0 = time.perf_counter()
    done = eng.serve(fresh(reqs))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = eng.stats()
    if len(done) != LM_REQUESTS:
        fail(f"serve_disagg ({transport}): {len(done)} of {LM_REQUESTS} "
             f"requests completed")
    recs = eng.transport.records
    if len(recs) != LM_REQUESTS or any(
            r.nbytes != lm.cache_row_nbytes(
                lm.make_caches(cfg, 1, LM_MAX_LEN, device="meta"))
            for r in recs):
        fail(f"serve_disagg ({transport}): {len(recs)} deliveries, bytes "
             f"{sorted({r.nbytes for r in recs})}")
    numbers = {
        "transport": transport, "requests": stats.completed,
        "new_tokens": stats.items, "wall_s": wall,
        "tok_per_s": stats.items / wall, "engine_tok_per_s": stats.throughput,
        "ms_per_tick": stats.ms_per_tick,
        "decode_ticks": sum(e.stats().ticks for e in eng.decodes),
        "prefill_ticks": eng.prefill.stats().ticks,
        "legs": leg_numbers(recs),
        "transfer_histograms_ms": {
            k: {"n": n, "p50": p50, "p95": p95}
            for k, (n, p50, p95) in stats.transfer_summary().items()},
        "depth": {k: {"ticks": n, "p50": p50, "p95": p95, "peak": peak}
                  for k, (n, p50, p95, peak)
                  in stats.depth_summary().items()},
        "launches": {k: counts[k] for k in ("flash_attention", "dense",
                                            "fused_sampling")},
        "graphs": disagg_graphs(f"serve_disagg ({transport})", eng,
                                window)}
    check_prefill_bodies(f"serve_disagg ({transport})", counts)
    return {c.rid: c.tokens for c in done}, numbers, counts, logits


def pool_window(eng) -> tuple:
    """The staged calls of a disaggregated pool's engines, their stats and
    the launch counters now: the start of a window disagg_graphs reads."""
    calls = [c for m in (eng.prefill, *eng.decodes) for c in staged_calls(m)]
    return calls, [dict(c.stats) for c in calls], graphs.counters()


def disagg_graphs(label: str, eng, window: tuple) -> dict:
    """A disaggregated pool's staged calls since ``window``
    (pool_window): the launches their replays added, held against the
    counters' growth where the window captured nothing new (every launch
    of the pool's dense kernel path is then a replay); then the prefill
    engine's prefill and gather graphs and each decode engine's inject
    graphs against their eager bodies (graph_vs_eager)."""
    calls, stats0, counters0 = window
    grown = graphs.count_delta(counters0, graphs.counters())
    now = [c for m in (eng.prefill, *eng.decodes) for c in staged_calls(m)]
    new = [c for c in now if all(c is not d for d in calls)]
    zero = dict.fromkeys(("captures", "replays"), 0)
    captured = len(new) + sum(c.stats["captures"] - st["captures"]
                              for c, st in zip(calls, stats0))
    replayed = replayed_counts(calls + new, stats0 + [zero] * len(new))
    if not captured and grown != replayed:
        fail(f"{label} (graphs): replayed launches {replayed} differ from "
             f"the counters' growth {grown}")

    def named(counts):
        return {"/".join(str(x) for x in key if x is not None): n
                for key, n in sorted(counts.items(), key=str)}

    # a window that captured: each new graph's first run launched
    # eagerly, so the counters grew by those launches beyond the replays'
    return {"card": nvidia_smi_line(), "captured_in_window": captured,
            "replays_counters_held": not captured,
            "replayed_launches": named(replayed),
            "counter_growth": named(grown),
            "prefill_engine": graph_vs_eager(label, eng.prefill),
            "decode_engines": [graph_vs_eager(label, e)
                               for e in eng.decodes],
            "graph_pool_bytes": graph_pool_bytes()}


def disagg_paged(cfg, params, reqs, quantize: bool) -> tuple:
    """One page mode of phase serve_disagg (in_process): the paged
    disaggregated engine against the paged unified engine.  The requests
    arrive in two waves of 8, the second after the first has finished: a
    decode engine registers a handoff's page hashes when it admits it, so
    only handoffs that reach it after that can dedup against its pages
    (within one wave every handoff is delivered before the first
    admission)."""
    mode = "paged_int8" if quantize else "paged"
    kw = dict(page_size=PAGE, quantize_pages=quantize)
    tok_ref, margins, unified = unified_reference(cfg, params, reqs, **kw)
    eng = disaggregated_lm_engine(
        cfg, params, n_slots=DISAGG_SLOTS, max_len=LM_MAX_LEN,
        n_decode=DISAGG_DECODES, prefill_slots=LM_SLOTS,
        transport="in_process", decode_kernel=True, device=DEVICE, **kw)
    warm_disagg(eng)
    reset_counts()
    window = pool_window(eng)
    t0 = time.perf_counter()
    half = LM_REQUESTS // 2
    done = eng.serve(fresh(reqs[:half])) + eng.serve(fresh(reqs[half:]))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = eng.stats()
    if len(done) != LM_REQUESTS:
        fail(f"serve_disagg ({mode}): {len(done)} of {LM_REQUESTS} requests "
             f"completed")
    tok = {c.rid: c.tokens for c in done}
    compared, ambiguous, first_diff = compare_with_plain(
        f"serve_disagg ({mode})", reqs, tok, tok_ref, tok, margins,
        cfg.vocab)
    pg = dict(stats.pages)
    # every handoff's pages either travelled or were pinned on the target,
    # and what was pinned is the shared prefix: whole 16-page prefixes, at
    # most one per second-wave request that carries it
    shared = SHARED_PREFIX // PAGE
    total = sum(len(r.prompt) // PAGE + 1 for r in reqs)
    moved, dedup = pg.get("handoff_pages_moved", 0), pg.get(
        "handoff_pages_dedup", 0)
    n_shared = sum(1 for r in reqs[half:]
                   if r.prompt[:SHARED_PREFIX] == reqs[0].prompt[
                       :SHARED_PREFIX])
    if (moved + dedup != total or dedup < shared or dedup % shared
            or dedup > shared * n_shared):
        fail(f"serve_disagg ({mode}): pages moved {moved} + dedup {dedup}, "
             f"expected {total} in all and a whole number of {shared}-page "
             f"prefixes deduped, 1 to {n_shared}")
    seeded_equal = sum(1 for r in reqs if r.temperature > 0
                       and tok[r.rid] == tok_ref[r.rid])
    numbers = {
        "mode": mode, "requests": stats.completed, "new_tokens": stats.items,
        "wall_s": wall, "tok_per_s": stats.items / wall,
        "engine_tok_per_s": stats.throughput,
        "ms_per_tick": stats.ms_per_tick, "unified": unified,
        "handoff_pages_moved": moved, "handoff_pages_dedup": dedup,
        "handoff_pages_total": total, "pages": pg,
        "greedy_tokens_compared": compared,
        "ambiguous_positions": ambiguous, "first_divergence": first_diff,
        "seeded_rows_equal_unified": seeded_equal,
        "launches": {k: counts[k] for k in ("flash_attention", mode,
                                            "fused_sampling")},
        "graphs": disagg_graphs(f"serve_disagg ({mode})", eng, window)}
    check_prefill_bodies(f"serve_disagg ({mode})", counts)
    return numbers, counts


def disagg_capsnet() -> tuple:
    """The pruned capsnet-mnist (252 capsules, routing in the kernel)
    behind DisaggregatedEngine(None, two CapsuleEngines): serve_pruned's 8
    requests, classes held equal to one engine's."""
    cfg = cfg_lib.get_config("capsnet-mnist")
    deployed = (FastCapsPipeline(cfg, device=DEVICE).build(seed=0)
                .prune(0.6, 0.9, type_keep=7).compact()
                .compile(routing="cuda"))
    requests = make_requests(8, deployed.cfg)
    single, _, _ = serve(deployed, requests)
    pool = DisaggregatedEngine(None, [deployed.serve(batch_size=BATCH)
                                      for _ in range(DISAGG_DECODES)])
    pool.warmup()
    reset_counts()
    t0 = time.perf_counter()
    done = pool.serve([ImageRequest(images=r.images, rid=r.rid)
                       for r in requests])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = pool.stats()
    by_rid = {c.rid: c for c in single}
    if len(done) != len(requests):
        fail(f"serve_disagg (capsnet): {len(done)} of {len(requests)} "
             f"requests completed")
    for c in done:
        if not np.array_equal(c.classes, by_rid[c.rid].classes):
            fail(f"serve_disagg (capsnet): rid {c.rid} classes differ from "
                 f"a single engine's")
    return ({"capsules": deployed.cfg.n_primary_caps, "engines":
             DISAGG_DECODES, "requests": stats.completed,
             "frames": stats.frames, "ticks": stats.ticks,
             "fps": stats.frames / wall, "engine_fps": stats.fps,
             "routing_launches": counts["fused_routing"]}, counts)


def disagg_trace(cfg, params) -> tuple:
    """A 2 s seeded bursty trace replayed live against the dense
    disaggregated pool, autoscaled from one decode engine up to
    TRACE_MAX_ENGINES, a PriorityScheduler on each decode engine; every
    grow's time and device memory are measured."""
    classes = default_classes()
    trace = bursty_trace(classes, rates=[TRACE_RATE / 6, TRACE_RATE],
                         dwell=[0.4, 0.2], horizon=TRACE_HORIZON,
                         seed=TRACE_SEED)
    kw = dict(n_slots=DISAGG_SLOTS, max_len=LM_MAX_LEN, decode_kernel=True,
              device=DEVICE)
    grows = []

    def grow():
        torch.cuda.synchronize()
        mem0, t0 = torch.cuda.memory_allocated(), time.perf_counter()
        eng = DecodeEngine(cfg, params, scheduler=PriorityScheduler(), **kw)
        torch.cuda.synchronize()
        grows.append({"s": time.perf_counter() - t0,
                      "bytes": torch.cuda.memory_allocated() - mem0})
        return eng

    pool = disaggregated_lm_engine(
        cfg, params, n_decode=1, prefill_slots=LM_SLOTS,
        decode_schedulers=[PriorityScheduler()], transport="in_process",
        **kw)
    warm_disagg(pool)
    ctrl = AutoscaleController(grow, min_engines=1,
                               max_engines=TRACE_MAX_ENGINES)
    reset_counts()
    t0 = time.perf_counter()
    rep = replay(pool, trace,
                 factory=default_factory(trace, vocab=cfg.vocab // 2),
                 controller=ctrl)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = rep.stats
    if rep.dropped != 0 or rep.submitted != len(trace) \
            or rep.completed != rep.submitted:
        fail(f"serve_disagg (trace): submitted {rep.submitted} of "
             f"{len(trace)}, completed {rep.completed}, dropped "
             f"{rep.dropped}")
    return ({"arrivals": len(trace), "horizon_s": trace.horizon,
             "trace_rate": trace.rate(), "submitted": rep.submitted,
             "completed": rep.completed, "rejected": rep.rejected,
             "dropped": rep.dropped, "preempted": st.preempted,
             "wall_s": wall, "drain_s": rep.drain_s,
             "new_tokens": st.items, "tok_per_s": st.items / wall,
             "scale_events": [{"t": e.t, "action": e.action,
                               "n_live": e.n_live}
                              for e in rep.scale_events],
             "mean_live_engines": rep.mean_live_engines, "grows": grows,
             "latency_ms": {k: {"n": n, "p50": p50, "p95": p95}
                            for k, (n, p50, p95)
                            in st.latency_summary().items()},
             "launches": {k: counts[k] for k in ("flash_attention", "dense",
                                                 "fused_sampling")}},
            counts)


def phase_serve_disagg() -> dict:
    """Full-width llama3.2-1b served disaggregated: a PrefillEngine (flash
    prefill) handing each request's cache rows to two DecodeEngines
    (decode attention and fused sampling) under each transport, then from
    bf16 and int8 pages, each held against the unified kernel engine by
    serve_lm's margin rule; the pruned CapsNet behind a pool of two
    engines; and a seeded bursty trace against the autoscaled pool."""
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg, params, _, _ = init_lm()
    reqs = lm_requests(cfg.vocab)
    launches = {}

    def add(counts, keys):
        for row, key in keys.items():
            launches[row] = launches.get(row, 0) + counts[key]

    lm_rows = {"flash_attention": "flash_attention",
               "decode_attention": "dense", "fused_sampling": "fused_sampling"}
    together = {}
    tok_ref, margins, unified = unified_reference(cfg, params, reqs,
                                                  seeded=together)
    together = (together["tokens"], rows_on_host(together["rows"]))
    first, results = None, []
    for transport in DISAGG_TRANSPORTS:
        tok, numbers, counts, logits = disagg_transport(cfg, params, reqs,
                                                        transport)
        compared, ambiguous, first_diff = compare_with_plain(
            f"serve_disagg ({transport})", reqs, tok, tok_ref,
            first if first is not None else tok, margins, cfg.vocab)
        first = first if first is not None else tok
        # the sampling contract against the unified engine's run
        seeded, _ = compare_seeded(f"serve_disagg ({transport}, seeded)",
                                   reqs, together, (tok, logits))
        numbers.update(greedy_tokens_compared=compared,
                       ambiguous_positions=ambiguous,
                       first_divergence=first_diff,
                       seeded_bit_identical_across_transports=True,
                       seeded_against_unified=seeded)
        del logits
        results.append(numbers)
        add(counts, lm_rows)
    bounds = copy_bounds(results[0]["legs"]["bytes_per_handoff"])
    emit("serve_disagg", part="dense", arch=LM_ARCH, prefill_slots=LM_SLOTS,
         decode_engines=DISAGG_DECODES, decode_slots=DISAGG_SLOTS,
         max_len=LM_MAX_LEN, margin_rule=MARGIN_RULE, unified=unified,
         copy_bounds=bounds, transports=results)

    preqs = paged_requests(cfg.vocab)
    for quantize in (False, True):
        numbers, counts = disagg_paged(cfg, params, preqs, quantize)
        emit("serve_disagg", part="paged", arch=LM_ARCH, page_size=PAGE,
             margin_rule=MARGIN_RULE, **numbers)
        mode = numbers["mode"]
        add(counts, {"flash_attention": "flash_attention",
                     DECODE_ROWS[mode]: mode,
                     "fused_sampling": "fused_sampling"})

    numbers, counts = disagg_capsnet()
    emit("serve_disagg", part="capsnet", **numbers)
    add(counts, {"fused_routing": "fused_routing"})

    numbers, counts = disagg_trace(cfg, params)
    emit("serve_disagg", part="trace", transport="in_process", **numbers)
    add(counts, lm_rows)

    for row in ("flash_attention", "decode_attention", "decode_attention_paged",
                "decode_attention_paged_dequant", "fused_sampling",
                "fused_routing"):
        if launches.get(row, 0) < 1:
            fail(f"serve_disagg: {row} was never launched on the "
                 f"disaggregated path")
    emit("serve_disagg", part="launches", launches=launches,
         seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------------
# The moe and vlm families
# ---------------------------------------------------------------------------


def family_cfg(arch: str, n_layers: int = 0):
    """``arch`` at full width with bf16 parameters and prefill attention in
    the flash kernel; its depth cut to ``n_layers`` when one is given."""
    cut = {"param_dtype": "bfloat16", "attn_impl": "cuda"}
    if n_layers:
        cut["n_layers"] = n_layers
    return dataclasses.replace(cfg_lib.get_config(arch), **cut)


def release() -> None:
    """Free what dropped engines hold on the card.  A kernel engine is a
    reference cycle (each staged call's body closes over it), so its
    caches, parameter copy and graphs go only at a collection; then the
    allocator's cached blocks, the graphs' pool among them."""
    gc.collect()
    torch.cuda.empty_cache()


def init_family(cfg) -> tuple:
    """Random weights from seed 0 drawn on the card: (params, seconds,
    parameter count, parameter bytes)."""
    release()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, DEVICE)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    return (params, time.perf_counter() - t0,
            sum(int(x.numel()) for x in leaves),
            sum(int(x.numel()) * x.element_size() for x in leaves))


def watch_flash() -> tuple:
    """Count the flash_attention wrapper's calls by its ``causal`` flag
    (vlm prefill: causal self-attention, non-causal cross-attention); the
    launches themselves are the wrapper's own count.  A call inside a
    capture launches nothing and is not counted, and a replayed graph
    makes no call.  Returns (calls, a function that removes the watch)."""
    from repro_torch import kernels as kernels_pkg

    calls = {"causal": 0, "non_causal": 0}
    inner = kernels_pkg.flash_attention

    def watched(q, k, v, **kw):
        if not graphs.capturing():
            calls["causal" if kw.get("causal", True)
                  else "non_causal"] += 1
        return inner(q, k, v, **kw)

    kernels_pkg.flash_attention = watched
    return calls, lambda: setattr(kernels_pkg, "flash_attention", inner)


def serve_family_mode(phase: str, cfg, params, reqs, mode: str) -> tuple:
    """One cache mode (dense slots, bf16 or int8 pages) of a family phase:
    the kernel engine (flash prefill, decode attention, fused sampling)
    against the plain engine of the same mode (chunked attention, host
    sampling) on ``reqs``, by serve_lm's margin rule.  Returns (numbers,
    launch counts of the kernel run, the kernel engine, the tokens and
    margins of its second run: kernel_margins_of)."""
    paged = mode != "dense"
    name = f"{phase} ({mode})"
    kw = dict(n_slots=LM_SLOTS, max_len=LM_MAX_LEN, device=DEVICE)
    if paged:
        kw.update(page_size=PAGE, quantize_pages=mode == "paged_int8")
    kern = ServeEngine(cfg, params, decode_kernel=True, **kw)
    plain = ServeEngine(dataclasses.replace(cfg, attn_impl="chunked"), params,
                        **kw)
    for eng in (kern, plain):
        eng.generate([[1, 2, 3, 4] * 8], max_new_tokens=2)

    groups = count_calls(kern, "_prefill_paged_group" if paged
                         else "_prefill_group")
    ticks = count_calls(kern, "_step")
    kind = "paged prefill" if paged else "prefill"
    staged0 = kern.graph_stats(kind)
    flash, unwatch = watch_flash()
    reset_counts()
    t0 = time.perf_counter()
    try:
        done = kern.serve(fresh(reqs))
    finally:
        unwatch()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = kern.stats()
    n_groups, n_ticks = groups[0], ticks[0]
    ran, staged = python_runs(kern, kind, staged0)
    if len(done) != len(reqs):
        fail(f"{name}: {len(done)} of {len(reqs)} requests completed")
    if staged != n_groups:
        fail(f"{name}: {staged} staged {kind} calls for {n_groups} prefill "
             f"groups")
    # vlm decodes a gathered view of its pages through the dense body
    body = mode if paged and cfg.family != "vlm" else "dense"
    n_self, n_cross = cfg.n_self_layers(), cfg.n_cross_layers()
    want = {"flash_attention": (n_self + n_cross) * n_groups,
            "decode_attention": n_self * n_ticks, body: n_self * n_ticks,
            "fused_sampling": n_ticks}
    for key, n in want.items():
        if counts[key] != n or n < 1:
            fail(f"{name}: {key} launched {counts[key]} times, expected {n} "
                 f"({n_groups} prefill groups, {n_ticks} decode ticks)")
    # a replayed prefill graph calls no Python: the wrapper is called by
    # the prefill groups that ran theirs (the run before each capture)
    if (flash["non_causal"] != n_cross * ran
            or flash["causal"] != n_self * ran):
        fail(f"{name}: flash calls {flash}, expected {n_self * ran} causal "
             f"and {n_cross * ran} non-causal ({ran} of {n_groups} prefill "
             f"groups ran their Python, the others replayed)")
    check_prefill_bodies(name, counts)
    if paged and stats.pages.get("prefix_hits", 0) < 1:
        fail(f"{name}: no prefix hit: {dict(stats.pages)}")

    margins = record_margins(plain)
    done_plain = plain.serve(fresh(reqs))
    del plain
    # a paged engine's second run would meet a warm prefix cache: a fresh
    # engine gives every prefill group the first run's composition; the
    # second run records its margins (the rule of later comparisons)
    again_eng = (ServeEngine(cfg, params, decode_kernel=True, **kw) if paged
                 else kern)
    tok_again, kmargins = kernel_margins_of(again_eng, reqs)
    del again_eng
    tok = {c.rid: c.tokens for c in done}
    tok_plain = {c.rid: c.tokens for c in done_plain}
    compared, ambiguous, first_diff = compare_with_plain(
        name, reqs, tok, tok_plain, tok_again, margins, cfg.vocab)
    lat = stats.latency_summary()
    numbers = dict(
        mode=mode, requests=stats.completed, new_tokens=stats.items,
        ticks=stats.ticks, prefill_groups=n_groups, decode_ticks=n_ticks,
        wall_s=wall, tok_per_s=stats.throughput,
        ms_per_tick=stats.ms_per_tick,
        latency_ms={k: {"n": n, "p50": p50, "p95": p95}
                    for k, (n, p50, p95) in lat.items()},
        launches={k: counts[k] for k in want}, flash_calls=flash,
        prefill_groups_replayed=n_groups - ran,
        prefill_launches_by_body={
            b: counts[f"flash_attention/{b}"] for b in ("tensor_core", "fma")},
        greedy_tokens_compared=compared, ambiguous_positions=ambiguous,
        margin_rule=MARGIN_RULE, first_divergence=first_diff,
        greedy_sequences_equal_plain=sum(
            1 for r in reqs if r.temperature == 0
            and tok[r.rid] == tok_plain[r.rid]),
        seeded_bit_identical=True)
    if paged:
        numbers.update(pages=dict(stats.pages), pool_bytes=pool_nbytes(kern))
    return numbers, counts, kern, tok_again, kmargins


def routing_counts(params, cfg, x, token_mask) -> dict:
    """What one moe layer's dispatch does with the tokens of a prefill:
    the capacity of its buffers and of each row (from the row's real
    tokens), the (token, expert) pairs routed, by expert too, and those
    dropped because their expert's buffer was full (serve_lm's rank rule,
    recomputed with the module's own helpers)."""
    from repro_torch.models import moe as moe_lib

    m = cfg.moe
    b, s, _ = x.shape
    mask = (token_mask.to(torch.bool) if token_mask is not None
            else torch.ones((b, s), dtype=torch.bool, device=x.device))
    cap = moe_lib._capacity(s, m)
    cap_rows = torch.clamp(moe_lib._capacity_dyn(mask.sum(1), m), max=cap)
    logits = x.float() @ params["router"].float() \
        + params["router_b"].float()
    _, ids = moe_lib.top_k(logits, m.top_k)
    ids = torch.where(mask[..., None], ids, torch.full_like(ids, m.n_experts))
    rank = moe_lib._rank_within_expert(ids, m.n_experts)
    kept = int(((rank < cap_rows[:, None, None]) & mask[..., None]).sum())
    routed = int(mask.sum()) * m.top_k
    load = torch.stack([torch.bincount(r[r < m.n_experts],
                                       minlength=m.n_experts)
                        for r in ids.reshape(b, -1)])
    return {"capacity": cap, "row_capacity": cap_rows.tolist(),
            "routed": routed, "dropped": routed - kept,
            "busiest_expert_load": int(load.max()),
            "load_by_expert": load.sum(0).tolist()}


def moe_admission(phase: str, kern, reqs, cfg) -> dict:
    """The admission tick of the first LM_SLOTS requests of ``reqs`` on
    ``kern`` with every moe layer's prefill watched (the staged prefill
    run eagerly, graphs.eager, so that the watch reads each layer): the
    aux loss the forward sums over the layers (the reference's training
    term), the buffer and per-row capacities, and the pairs routed and
    dropped."""
    from repro_torch.models import moe as moe_lib

    layers, aux = [], []
    inner = moe_lib.moe_apply

    def watched(p, c, x, token_mask=None):
        y, a = inner(p, c, x, token_mask=token_mask)
        if x.shape[1] > 1:
            aux.append(float(a))
            layers.append(routing_counts(p, c, x, token_mask))
        return y, a

    moe_lib.moe_apply = watched
    try:
        for r in fresh(reqs[:LM_SLOTS]):
            kern.submit(r)
        with graphs.eager():           # the staged prefill's Python runs
            kern.tick()
    finally:
        moe_lib.moe_apply = inner
    kern.run_until_idle()
    if len(layers) != cfg.n_layers or not all(np.isfinite(aux)):
        fail(f"{phase}: admission watched {len(layers)} moe layers, aux "
             f"{aux}")
    return {"aux_loss": sum(aux), "aux_by_layer": aux,
            "capacity": layers[0]["capacity"],
            "row_capacity": layers[0]["row_capacity"],
            "routed_pairs_per_layer": layers[0]["routed"],
            "dropped_pairs": sum(lay["dropped"] for lay in layers),
            "dropped_by_layer": [lay["dropped"] for lay in layers],
            "busiest_expert_load": max(lay["busiest_expert_load"]
                                       for lay in layers)}


def moe_scatter(cfg, params, reqs, tok_ref, margins) -> tuple:
    """The moe scatter dispatch on the card (ROADMAP §C 4): serve_moe's
    dense-slot requests once more on a kernel engine whose config takes
    dispatch ``scatter`` (per-row sort and ``index_add_``), over the
    phase's parameters, its tick and prefill captured and replayed.  Each
    moe layer's dispatch is counted: the scatter path a layer each prefill
    group and decode tick that ran its Python (the others replayed), the
    one-hot path never.  The greedy tokens hold against the one-hot kernel engine's
    (``tok_ref``, whose margins are ``margins``) by the margin rule;
    ``index_add_`` is not deterministic on CUDA, so the seeded requests
    must complete but are not compared.  Returns (numbers, launch
    counts)."""
    from repro_torch.models import moe as moe_lib

    name = "serve_moe (scatter)"
    scfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch="scatter"))
    eng = ServeEngine(scfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      decode_kernel=True, device=DEVICE)
    groups = count_calls(eng, "_prefill_group")
    ticks = count_calls(eng, "_step")
    calls = {"scatter": 0, "onehot": 0}
    inner = {k: getattr(moe_lib, f"_moe_{k}") for k in calls}
    staged0 = {k: eng.graph_stats(k) for k in ("prefill", "tick")}

    def watched(kind):
        def call(*a, **kw):
            if not graphs.capturing():
                calls[kind] += 1
            return inner[kind](*a, **kw)
        return call

    for kind in calls:
        setattr(moe_lib, f"_moe_{kind}", watched(kind))
    reset_counts()
    t0 = time.perf_counter()
    try:
        done = eng.serve(fresh(reqs))
    finally:
        for kind, fn in inner.items():
            setattr(moe_lib, f"_moe_{kind}", fn)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if len(done) != len(reqs):
        fail(f"{name}: {len(done)} of {len(reqs)} requests completed")
    # the staged calls that ran their Python (each prefill group and tick
    # that was captured), of all of them (the rest replayed)
    runs = [python_runs(eng, k, st) for k, st in staged0.items()]
    ran = sum(r for r, _ in runs)
    want = cfg.n_layers * ran
    if (calls["scatter"] != want or calls["onehot"]
            or sum(n for _, n in runs) != groups[0] + ticks[0]):
        fail(f"{name}: dispatch calls {calls}, expected {want} scatter "
             f"({groups[0]} prefill groups, {ticks[0]} decode ticks, "
             f"{ran} of them ran their Python)")
    tok = {c.rid: c.tokens for c in done}
    compared, ambiguous, first_diff = compare_with_plain(
        name, reqs, tok, tok_ref, tok, margins, cfg.vocab)
    return {"dispatch": "scatter", "requests": len(done), "wall_s": wall,
            "prefill_groups": groups[0], "decode_ticks": ticks[0],
            "dispatch_calls": calls, "staged_calls_replayed":
                groups[0] + ticks[0] - ran,
            "graphs": eng.graph_stats("all"),
            "greedy_tokens_compared": compared,
            "ambiguous_positions": ambiguous,
            "first_divergence": first_diff,
            "greedy_sequences_equal_onehot": sum(
                1 for r in reqs if r.temperature == 0
                and tok[r.rid] == tok_ref[r.rid]),
            "launches": {k: counts[k] for k in ("flash_attention", "dense",
                                                "fused_sampling")}}, counts


def disagg_check(name: str, cfg, params, reqs, tok_ref, margins,
                 transport: str, tok_seeded=None) -> tuple:
    """``reqs`` through a disaggregated engine over ``transport``: a
    PrefillEngine of LM_SLOTS slots handing each request's cache rows (or
    recurrent state) to DISAGG_DECODES DecodeEngines of DISAGG_SLOTS
    (``DisaggScheduler(overlap=True)`` for device_to_device, as
    serve_disagg), over ``params`` (shared: bf16 tensors are not copied).
    Every delivery carries ``lm.cache_nbytes(cfg, 1, LM_MAX_LEN)`` bytes;
    the greedy tokens hold against ``tok_ref`` (whose margins are
    ``margins``) by the margin rule, the seeded ones bit for bit against
    ``tok_seeded`` (another transport's run) when it is given, else within
    the run.  Returns (numbers, launch counts, tokens)."""
    eng = disaggregated_lm_engine(
        cfg, params, n_slots=DISAGG_SLOTS, max_len=LM_MAX_LEN,
        n_decode=DISAGG_DECODES, prefill_slots=LM_SLOTS,
        transport=make_transport(transport, keep_records=len(reqs)),
        scheduler=DisaggScheduler(overlap=transport == "device_to_device"),
        decode_kernel=True, device=DEVICE)
    warm_disagg(eng)
    reset_counts()
    t0 = time.perf_counter()
    done = eng.serve(fresh(reqs))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = eng.stats()
    if len(done) != len(reqs):
        fail(f"{name}: {len(done)} of {len(reqs)} requests completed")
    recs = eng.transport.records
    row_bytes = lm.cache_nbytes(cfg, 1, LM_MAX_LEN)
    if len(recs) != len(reqs) or any(r.nbytes != row_bytes for r in recs):
        fail(f"{name}: {len(recs)} deliveries, bytes "
             f"{sorted({r.nbytes for r in recs})}, expected {row_bytes}")
    check_prefill_bodies(name, counts)
    tok = {c.rid: c.tokens for c in done}
    compared, ambiguous, first_diff = compare_with_plain(
        name, reqs, tok, tok_ref, tok if tok_seeded is None else tok_seeded,
        margins, cfg.vocab)
    del eng
    release()
    return {"transport": transport, "n_layers": cfg.n_layers,
            "prefill_slots": LM_SLOTS, "decode_engines": DISAGG_DECODES,
            "decode_slots": DISAGG_SLOTS, "requests": stats.completed,
            "new_tokens": stats.items, "wall_s": wall,
            "tok_per_s": stats.items / wall,
            "handoff_bytes_per_request": row_bytes, "legs": leg_numbers(recs),
            "greedy_tokens_compared": compared,
            "ambiguous_positions": ambiguous,
            "first_divergence": first_diff,
            "launches": {k: counts[k] for k in ("flash_attention", "dense",
                                                "fused_sampling")}
            }, counts, tok


def over_transports(phase: str, transports, cfg, params, reqs, tok_ref,
                    margins) -> tuple:
    """disagg_check under each of ``transports``, the seeded tokens of
    each held bit for bit against the first's.  Returns (numbers by
    transport, launch counts summed)."""
    runs, total, first = [], {}, None
    for transport in transports:
        numbers, counts, tok = disagg_check(
            f"{phase} (disagg, {transport})", cfg, params, reqs, tok_ref,
            margins, transport, first)
        first = first if first is not None else tok
        runs.append(numbers)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return runs, total


def vlm_cross(cfg, params) -> tuple:
    """The vlm cross path with image features (ROADMAP §C 3), which a serve
    run cannot reach (its prompts carry no image and the gates start at
    0): every cross gate at VLM_GATE over the phase's parameters (as
    tests/test_torch_vlm.py sets them), image features (LM_SLOTS,
    n_image_tokens, d_model) and prompts of VLM_PROMPT tokens from
    RandomState(5); then ``lm.prefill_step`` and VLM_DECODE_STEPS
    ``lm.decode_step`` calls on the kernel path (flash prefill, causal in
    the self blocks and non-causal over the image tokens in the cross
    blocks; the decode kernel in the self blocks) and on the plain path
    (chunked attention), each on caches of its own, both fed the plain
    path's greedy tokens.  At the prefill and each decode step the greedy
    tokens agree wherever the plain path's top-2 margin is at least its
    threshold (MARGIN_RULE); ``rel_max`` is the largest logit difference
    over the plain logits' RMS.  Returns (numbers, launch counts)."""
    name = "serve_vlm (cross)"
    cross = params["units"]["cross"]
    gated = {**cross, "attn": {**cross["attn"], "gate": torch.full_like(
        cross["attn"]["gate"], VLM_GATE)}}
    p = {**params, "units": {**params["units"], "cross": gated}}
    rng = np.random.RandomState(5)
    img = torch.from_numpy(rng.standard_normal(
        (LM_SLOTS, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    ).to(DEVICE)
    tokens = torch.from_numpy(rng.randint(
        1, cfg.vocab // 2, size=(LM_SLOTS, VLM_PROMPT)).astype(np.int32)
    ).to(DEVICE)
    kcfg = dataclasses.replace(cfg, attn_impl="cuda", decode_impl="cuda")
    pcfg = dataclasses.replace(cfg, attn_impl="chunked",
                               decode_impl="chunked")
    batch = {"tokens": tokens, "image_features": img}
    n_self, n_cross = cfg.n_self_layers(), cfg.n_cross_layers()
    steps, ambiguous = [], 0
    flash, unwatch = watch_flash()
    reset_counts()
    with torch.inference_mode():
        try:
            kl, kc = lm.prefill_step(p, kcfg, batch, lm.make_caches(
                kcfg, LM_SLOTS, LM_MAX_LEN, DEVICE))
        finally:
            unwatch()
        pl, pc = lm.prefill_step(p, pcfg, batch, lm.make_caches(
            pcfg, LM_SLOTS, LM_MAX_LEN, DEVICE))
        for t in range(VLM_DECODE_STEPS + 1):
            a, b = kl.float(), pl.float()
            if not (bool(torch.isfinite(a).all())
                    and bool(torch.isfinite(b).all())):
                fail(f"{name}: non-finite logits at step {t}")
            rows = b.cpu().numpy()
            differ = (a.argmax(-1) != b.argmax(-1)).cpu().numpy()
            for i in np.nonzero(differ)[0]:
                m = margin_of(rows[i])
                if m["margin"] >= m["threshold"]:
                    fail(f"{name}: step {t} row {i}: the kernel path's greedy "
                         f"token differs at a top-2 margin of {m['margin']} "
                         f">= {m['threshold']} ({MARGIN_RULE})")
                ambiguous += 1
            steps.append(rel_max(a, b))
            if t == VLM_DECODE_STEPS:
                break
            nxt = b.argmax(-1).to(torch.int32)[:, None]
            pos = torch.full((LM_SLOTS,), VLM_PROMPT + t, dtype=torch.int32,
                             device=DEVICE)
            kl, kc = lm.decode_step(p, kcfg, {"tokens": nxt, "pos": pos}, kc)
            pl, pc = lm.decode_step(p, pcfg, {"tokens": nxt, "pos": pos}, pc)
    torch.cuda.synchronize()
    counts = launch_counts()
    if (flash["causal"] != n_self or flash["non_causal"] != n_cross
            or counts["flash_attention"] != n_self + n_cross
            or counts["dense"] != n_self * VLM_DECODE_STEPS):
        fail(f"{name}: flash calls {flash}, launches {counts['flash_attention']}"
             f", decode launches {counts['dense']}: expected {n_self} causal "
             f"and {n_cross} non-causal, {n_self * VLM_DECODE_STEPS} decode")
    check_prefill_bodies(name, counts)
    return {"gate": VLM_GATE, "image_tokens": cfg.n_image_tokens,
            "prompt": VLM_PROMPT, "decode_steps": VLM_DECODE_STEPS,
            "rel_max": max(steps), "rel_max_by_step": steps,
            "tokens_compared": LM_SLOTS * (VLM_DECODE_STEPS + 1),
            "ambiguous_positions": ambiguous, "margin_rule": MARGIN_RULE,
            "flash_calls": flash,
            "launches": {k: counts[k] for k in ("flash_attention", "dense")}
            }, counts


def phase_serve_family(phase: str, cfg, modes, further: bool = True,
                       n_requests: int = FAMILY_REQUESTS) -> dict:
    """A full-width model through ServeEngine in each cache mode of
    ``modes`` (dense slots on the first FAMILY_REQUESTS of serve_lm's
    requests, pages on serve_paged's), the kernel path against the plain
    path, a moe's admission numbers from its dense slots; with ``further``
    also the dense mode's decode tick breakdown (the paged modes' were cut
    to fit the script's time limit: their ``not_measured`` says so), then on
    the dense-slot requests
    the moe scatter dispatch (moe_scatter) and the model disaggregated
    (over_transports), and for vlm the cross path with image features
    (vlm_cross); with ``further`` each mode's kernel engine is also held
    graph against eager (lm_graphs) and, in dense slots, each sampled
    request alone against the batch (seeded_alone).  Returns the launches
    by kernel-table row."""
    params, init_s, n_params, n_bytes = init_family(cfg)
    params = lm.compute_params(cfg, params)       # bf16: the same tensors
    launches = {}

    def add(counts, body="dense"):
        for row, key in (("flash_attention", "flash_attention"),
                         (DECODE_ROWS[body], body),
                         ("fused_sampling", "fused_sampling")):
            launches[row] = launches.get(row, 0) + counts[key]

    for mode in modes:
        t0 = time.perf_counter()
        reqs = (lm_requests(cfg.vocab, n_requests) if mode == "dense"
                else paged_requests(cfg.vocab, n_requests))
        numbers, counts, kern, tok_k, kmargins = serve_family_mode(
            phase, cfg, params, reqs, mode)
        if mode == "dense":
            dense = (reqs, tok_k, kmargins)
            if cfg.moe is not None:
                numbers["admission"] = moe_admission(phase, kern, reqs, cfg)
        if further and mode == "dense":
            numbers.update(decode_tick_breakdown(kern, cfg.vocab,
                                                 admission_trace=False))
        if further:
            # the same requests from the graphs against the staged calls
            # run eagerly; in dense slots, each sampled request alone
            together = {} if mode == "dense" else None
            numbers["graphs"] = lm_graphs(f"{phase} ({mode})", kern, reqs,
                                          keep=together)
            if mode == "dense":
                numbers["seeded_schedules"], scounts = seeded_alone(
                    phase, kern, reqs, together)
                add(scounts)
                del together
        del kern
        release()
        emit(phase, arch=cfg.arch_id, params=n_params, param_bytes=n_bytes,
             init_s=init_s, reduced=FAMILY_CUTS[cfg.arch_id],
             not_measured=(["the decode tick breakdown (the dense mode's "
                            "stands for the model)"]
                           if further and mode != "dense" else []),
             n_layers=cfg.n_layers, self_layers=cfg.n_self_layers(),
             cross_layers=cfg.n_cross_layers(), slots=LM_SLOTS,
             max_len=LM_MAX_LEN, page_size=PAGE if mode != "dense" else None,
             seconds=time.perf_counter() - t0, **numbers)
        add(counts, mode if mode != "dense" and cfg.family != "vlm"
            else "dense")
    if not further:
        del params
        release()
        emit(phase, arch=cfg.arch_id, part="launches", launches=launches)
        return launches
    reqs, tok_k, kmargins = dense
    if cfg.moe is not None:
        t0 = time.perf_counter()
        numbers, counts = moe_scatter(cfg, params, reqs, tok_k, kmargins)
        emit(phase, part="scatter", seconds=time.perf_counter() - t0,
             margin_rule=MARGIN_RULE, **numbers)
        add(counts)
        release()
    t0 = time.perf_counter()
    runs, counts = over_transports(phase, FAMILY_TRANSPORTS, cfg, params,
                                   reqs, tok_k, kmargins)
    emit(phase, part="disagg", seconds=time.perf_counter() - t0,
         margin_rule=MARGIN_RULE, seeded_bit_identical_across_transports=True,
         transports=runs)
    add(counts)
    if cfg.family == "vlm":
        t0 = time.perf_counter()
        numbers, counts = vlm_cross(cfg, params)
        emit(phase, part="cross", seconds=time.perf_counter() - t0,
             **numbers)
        add(counts)
    del params
    release()
    emit(phase, part="launches", launches=launches)
    return launches


def phase_serve_moe() -> dict:
    """deepseek-moe-16b at full width, its depth cut to MOE_LAYERS (bf16
    parameters): dense slots, bf16 pages (read in place by the paged
    decode body), int8 pages; the admission tick's aux loss and expert
    drops; the scatter dispatch; disaggregated."""
    return phase_serve_family("serve_moe", family_cfg(MOE_ARCH, MOE_LAYERS),
                              ("dense", "paged", "paged_int8"))


def phase_serve_vlm() -> dict:
    """llama-3.2-vision-90b at full width, VLM_LAYERS layers (bf16
    parameters): dense slots and bf16 pages (a gathered view through the
    dense decode body, as the reference); prefill runs the flash kernel
    causal in the self-attention blocks and non-causal over the (zero,
    imageless) cross cache's 1024 rows in the cross-attention block;
    disaggregated; the cross path with image features and open gates."""
    return phase_serve_family("serve_vlm", family_cfg(VLM_ARCH, VLM_LAYERS),
                              ("dense", "paged"))


def phase_serve_qwen3() -> dict:
    """qwen3-1.7b at full width, its depth cut to QWEN3_LAYERS (float32
    parameters, as serve_lm): the first QWEN3_REQUESTS of serve_lm's
    requests from dense slots and of serve_paged's from bf16 and int8
    pages, each through the kernels (qk-norm, D 128 at G 2, sampling over
    151936 logits) against the plain path."""
    cfg = dataclasses.replace(cfg_lib.get_config(QWEN3_ARCH),
                              attn_impl="cuda", n_layers=QWEN3_LAYERS)
    return phase_serve_family("serve_qwen3", cfg, QWEN3_MODES, further=False,
                              n_requests=QWEN3_REQUESTS)


def phase_serve_large() -> dict:
    """qwen1.5-110b (QKV bias, sampling over 152064 logits) from dense
    slots, mistral-large-123b (G 12: two chunks of the decode kernel's)
    from dense slots and int8 pages, dbrx-132b (16 experts, top-4, G 6)
    from dense slots with its moe admission numbers: each at full width,
    LARGE_LAYERS layers, bf16 parameters, through the kernels against the
    plain path.  Returns the launches by model and kernel-table row."""
    out = {}
    for arch, modes in LARGE_MODES:
        gc.collect()
        out[arch] = phase_serve_family(
            "serve_large", family_cfg(arch, LARGE_LAYERS), modes,
            further=False)
    return out


# ---------------------------------------------------------------------------
# The ssm, hybrid and audio families
# ---------------------------------------------------------------------------


def init_full(arch: str) -> tuple:
    """``arch`` at its published size with prefill attention in the flash
    kernel and the config's float32 parameters, random weights from seed 0
    drawn on the card: (cfg, params, seconds, parameter count, parameter
    bytes)."""
    cfg = dataclasses.replace(cfg_lib.get_config(arch), attn_impl="cuda")
    params, init_s, n_params, n_bytes = init_family(cfg)
    return cfg, params, init_s, n_params, n_bytes


def time_groups(engine) -> list:
    """Record each prefill group of a recurrent engine as (prompt length,
    prompts, host ms, graphs captured and their capture seconds); a group
    ends in the copy of its logits to the host, so the host clock holds
    its device work, and a group captured (a length met for the first
    time) its eager run and its capture."""
    groups = []
    inner = engine._prefill_group

    def timed(new, plen):
        st0 = engine.graph_stats("prefill")
        t0 = time.perf_counter()
        out = inner(new, plen)
        ms = (time.perf_counter() - t0) * 1e3
        st = engine.graph_stats("prefill")
        groups.append({"plen": int(plen), "prompts": len(new), "ms": ms,
                       "captured": int(st["captures"] - st0["captures"]),
                       "capture_s": st["capture_s"] - st0["capture_s"]})
        return out

    engine._prefill_group = timed
    return groups


def first_units(cfg, params, n_layers: int) -> tuple:
    """``cfg`` with its depth cut to ``n_layers`` and ``params`` cut to the
    first units it keeps (a family whose layers are all stacked under
    ``units``, as ssm's are): views of the same tensors, no copy."""
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    k = lm.n_units(cut)

    def take(tree):
        if isinstance(tree, dict):
            return {key: take(v) for key, v in tree.items()}
        if isinstance(tree, list):
            return [take(v) for v in tree]
        return tree[:k]

    return cut, {**params, "units": take(params["units"])}


def recurrent_handoffs(phase: str, cfg, params, reqs, tok_plain, margins,
                       own_plain: bool) -> tuple:
    """ROADMAP §C 5's handoffs: the model at its published size
    disaggregated over each of RECURRENT_TRANSPORTS (over_transports), the
    seeded tokens of the second held bit for bit against the first's,
    beside what the card's links give for one handoff's bytes
    (copy_bounds).  With ``own_plain`` (the phase served a cut model) the
    requests are those of ``reqs`` with prompts of at least
    RECURRENT_HANDOFF_PROMPT tokens, cut to that length, asking for
    RECURRENT_HANDOFF_NEW new tokens, held against a plain engine of this
    model on them; otherwise ``reqs`` against
    ``tok_plain``.  A sampled request must be among them (its tokens are
    what the transports are held to bit for bit).  Returns (numbers,
    launch counts summed)."""
    if own_plain:
        reqs = [dataclasses.replace(
                    r, prompt=list(r.prompt[:RECURRENT_HANDOFF_PROMPT]),
                    max_new_tokens=RECURRENT_HANDOFF_NEW)
                for r in reqs if len(r.prompt) >= RECURRENT_HANDOFF_PROMPT]
    if not any(r.temperature > 0 for r in reqs):
        fail(f"{phase}: no sampled request among the handoffs' "
             f"{[r.rid for r in reqs]}")
    if own_plain:
        plain = ServeEngine(dataclasses.replace(cfg, attn_impl="chunked"),
                            params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                            device=DEVICE)
        margins = record_margins(plain)
        tok_plain = {c.rid: c.tokens for c in plain.serve(fresh(reqs))}
        del plain
        release()
    runs, total = over_transports(phase, RECURRENT_TRANSPORTS, cfg, params,
                                  reqs, tok_plain, margins)
    row_bytes = lm.cache_nbytes(cfg, 1, LM_MAX_LEN)
    return {"n_layers": cfg.n_layers, "requests": len(reqs),
            "prompt_lengths": sorted({len(r.prompt) for r in reqs}),
            "handoff_bytes_per_request": row_bytes,
            "copy_bounds": copy_bounds(row_bytes), "transports": runs}, total


def recurrent_bf16(cfg, reqs) -> tuple:
    """The recurrent model with bf16 parameters (ROADMAP §C 5; random
    weights from seed 0 drawn in that type): the kernel engine against the
    plain engine on ``reqs`` by the margin rule, the seeded requests within
    the run; its recurrent state stays float32.  Returns (numbers, launch
    counts)."""
    bcfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    name = f"serve_{cfg.family} (bf16 parameters)"
    params, init_s, n_params, n_bytes = init_family(bcfg)
    kern = ServeEngine(bcfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                       decode_kernel=True, device=DEVICE)
    plain = ServeEngine(dataclasses.replace(bcfg, attn_impl="chunked"),
                        params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                        device=DEVICE)
    del params
    state = {str(x.dtype) for key, tree in kern._caches.items()
             if key != "shared_kv" for x in tree_leaves(tree)}
    if state != {"torch.float32"}:
        fail(f"{name}: recurrent state in {state}")
    reset_counts()
    t0 = time.perf_counter()
    done = kern.serve(fresh(reqs))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    if len(done) != len(reqs) or counts["fused_sampling"] < 1:
        fail(f"{name}: {len(done)} of {len(reqs)} requests, launches "
             f"{counts}")
    margins = record_margins(plain)
    tok_plain = {c.rid: c.tokens for c in plain.serve(fresh(reqs))}
    del plain, kern
    release()
    tok = {c.rid: c.tokens for c in done}
    compared, ambiguous, first_diff = compare_with_plain(
        name, reqs, tok, tok_plain, tok, margins, cfg.vocab)
    return {"param_dtype": bcfg.param_dtype, "param_bytes": n_bytes,
            "init_s": init_s, "state_dtypes": sorted(state),
            "requests": len(done), "wall_s": wall,
            "greedy_tokens_compared": compared,
            "ambiguous_positions": ambiguous, "first_divergence": first_diff,
            "greedy_sequences_equal_plain": sum(
                1 for r in reqs if r.temperature == 0
                and tok[r.rid] == tok_plain[r.rid]),
            "launches": {k: counts[k] for k in ("flash_attention", "dense",
                                                "fused_sampling")}}, counts


def launcher_runs() -> list:
    """``python -m repro_torch.launch.serve --arch A`` with LAUNCHER_ARGS
    (the published size, one request of four new tokens through the
    kernels) for each of LAUNCHER_RUNS, all at once (they load the library
    the build phase made): each recurrent model and qwen3-1.7b exits 0 and
    prints its requests' tokens; hubert exits 1 with the message of the
    reference's refusal of audio, mistral-large-123b with the fit check's
    (its float32 parameters and the engine's bf16 copy: 735.7 GB)."""
    env = port_env()
    torch.cuda.empty_cache()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         *LAUNCHER_ARGS], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, _, _ in LAUNCHER_RUNS]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for (arch, code, needle), p, log in zip(LAUNCHER_RUNS, procs, logs):
        if p.returncode != code or needle not in log:
            fail(f"launcher --arch {arch}: exit {p.returncode} "
                 f"(expected {code}), output without {needle!r}: "
                 f"{log[-2000:]}")
        out.append({"arch": arch, "exit": p.returncode,
                    "last_line": log.strip().splitlines()[-1][:300]})
    return out


def phase_serve_recurrent(phase: str, arch: str, n_layers: int = 0) -> dict:
    """A recurrent model (float32 parameters) through ServeEngine, with its
    depth cut to ``n_layers`` when one is given: the kernel engine (fused
    sampling in every decode tick; for the hybrid, flash prefill and decode
    attention in the shared block at each site) against the plain engine
    on RECURRENT_REQUESTS of serve_lm's requests, admitted in exact-length
    groups, each length's prefill a graph captured at its first group (its
    capture seconds by length, the graph pool's bytes); the engine graph
    against eager (lm_graphs) and the sampled request alone against the
    batch (seeded_alone); then disaggregated (in_process); then at its
    published size over RECURRENT_TRANSPORTS (recurrent_handoffs).
    Returns the launches by kernel-table row."""
    cfg_full, params_full, init_s, n_params, n_bytes = init_full(arch)
    cfg, params = ((cfg_full, params_full) if not n_layers
                   else first_units(cfg_full, params_full, n_layers))
    bf16 = ", the bf16 run" if cfg_full.family == "hybrid" else ""
    reduced = ([f"n_layers {cfg_full.n_layers} -> {n_layers} (the serve "
                f"against the plain path, the in_process handoff{bf16})"]
               if n_layers else [])
    reduced.append(f"requests {FAMILY_REQUESTS} -> {RECURRENT_REQUESTS} "
                   f"(the serve against the plain path, the in_process "
                   f"handoff{bf16}; the handoffs at the published size take "
                   f"those of the {FAMILY_REQUESTS} with prompts of at least "
                   f"{RECURRENT_HANDOFF_PROMPT} tokens, cut to that length, "
                   f"with {RECURRENT_HANDOFF_NEW} new tokens of "
                   f"{LM_MAX_NEW})")
    reqs = lm_requests(cfg.vocab, RECURRENT_REQUESTS)
    kern = ServeEngine(cfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                       decode_kernel=True, device=DEVICE)
    plain = ServeEngine(dataclasses.replace(cfg, attn_impl="chunked"), params,
                        n_slots=LM_SLOTS, max_len=LM_MAX_LEN, device=DEVICE)
    for eng in (kern, plain):
        eng.generate([[1, 2, 3, 4] * 8], max_new_tokens=2)

    groups = time_groups(kern)
    ticks = count_calls(kern, "_step")
    staged0 = kern.graph_stats("prefill")
    flash, unwatch = watch_flash()
    reset_counts()
    t0 = time.perf_counter()
    try:
        done = kern.serve(fresh(reqs))
    finally:
        unwatch()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = kern.stats()
    pool_bytes = graph_pool_bytes()
    admission = sorted(groups, key=lambda g: g["plen"])
    n_groups, n_ticks = len(admission), ticks[0]
    ran, staged = python_runs(kern, "prefill", staged0)
    if len(done) != len(reqs):
        fail(f"{phase}: {len(done)} of {len(reqs)} requests completed")
    if n_groups != len({len(r.prompt) for r in reqs}):
        fail(f"{phase}: {n_groups} prefill groups for "
             f"{len({len(r.prompt) for r in reqs})} prompt lengths")
    n_sites = len(lm.hybrid_sites(cfg)) if cfg.family == "hybrid" else 0
    want = {"flash_attention": n_sites * n_groups,
            "decode_attention": n_sites * n_ticks,
            "dense": n_sites * n_ticks, "fused_sampling": n_ticks}
    for key, n in want.items():
        if counts[key] != n or counts["fused_sampling"] < 1:
            fail(f"{phase}: {key} launched {counts[key]} times, expected {n} "
                 f"({n_groups} prefill groups, {n_ticks} decode ticks)")
    if staged != n_groups:
        fail(f"{phase}: {staged} staged prefill calls for {n_groups} "
             f"prefill groups")
    # a replayed prefill graph calls no Python (see serve_family_mode)
    if flash["non_causal"] or flash["causal"] != n_sites * ran:
        fail(f"{phase}: flash calls {flash}, expected {n_sites * ran} causal "
             f"({ran} of {n_groups} prefill groups ran their Python)")
    if n_sites:
        check_prefill_bodies(phase, counts)

    margins = record_margins(plain)
    done_plain = plain.serve(fresh(reqs))
    del plain
    # the seeded requests once more, for their bit-identity
    again = kern.serve(fresh([r for r in reqs if r.temperature > 0]))
    tok = {c.rid: c.tokens for c in done}
    tok_plain = {c.rid: c.tokens for c in done_plain}
    compared, ambiguous, first_diff = compare_with_plain(
        phase, reqs, tok, tok_plain, {c.rid: c.tokens for c in again},
        margins, cfg.vocab)
    breakdown = decode_tick_breakdown(kern, cfg.vocab, admission_trace=False)
    together = {}
    graph_numbers = lm_graphs(phase, kern, reqs, keep=together)
    seeded, scounts = seeded_alone(phase, kern, reqs, together)
    del together
    state_bytes = lm.cache_nbytes(cfg, LM_SLOTS, LM_MAX_LEN)
    del kern
    release()
    disagg, dcounts, _ = disagg_check(f"{phase} (disagg, in_process)", cfg,
                                      params, reqs, tok_plain, margins,
                                      "in_process")
    leaves = tree_leaves(params)
    del params
    lat = stats.latency_summary()
    emit(phase, arch=arch, params=sum(int(x.numel()) for x in leaves),
         param_bytes=sum(int(x.numel()) * x.element_size() for x in leaves),
         param_dtype=cfg.param_dtype, init_s=init_s, reduced=reduced,
         n_layers=cfg.n_layers, shared_attention_sites=n_sites,
         slots=LM_SLOTS, max_len=LM_MAX_LEN, cache_bytes=state_bytes,
         requests=stats.completed, new_tokens=stats.items,
         ticks=stats.ticks, prefill_groups=n_groups, decode_ticks=n_ticks,
         wall_s=wall, tok_per_s=stats.throughput,
         ms_per_tick=stats.ms_per_tick,
         admission_by_length=admission, graph_pool_bytes=pool_bytes,
         latency_ms={k: {"n": n, "p50": p50, "p95": p95}
                     for k, (n, p50, p95) in lat.items()},
         launches={k: counts[k] for k in want}, flash_calls=flash,
         greedy_tokens_compared=compared, ambiguous_positions=ambiguous,
         margin_rule=MARGIN_RULE, first_divergence=first_diff,
         greedy_sequences_equal_plain=sum(
             1 for r in reqs if r.temperature == 0
             and tok[r.rid] == tok_plain[r.rid]),
         seeded_bit_identical=True, disagg=disagg, graphs=graph_numbers,
         seeded_schedules=seeded, **breakdown)
    del leaves
    t0 = time.perf_counter()
    # the handoffs take the first FAMILY_REQUESTS of serve_lm's requests
    # (those long enough, cut), so that a sampled one is among them
    handoffs, hcounts = recurrent_handoffs(
        phase, cfg_full, params_full,
        lm_requests(cfg.vocab, FAMILY_REQUESTS) if n_layers else reqs,
        tok_plain, margins, own_plain=bool(n_layers))
    emit(phase, part="handoffs", arch=arch, params=n_params,
         param_bytes=n_bytes, margin_rule=MARGIN_RULE,
         seconds=time.perf_counter() - t0, **handoffs)
    del params_full
    release()
    runs = [counts, scounts, dcounts, hcounts]
    if cfg.family == "hybrid":
        t0 = time.perf_counter()
        numbers, bcounts = recurrent_bf16(cfg, reqs)
        emit(phase, part="bf16", arch=arch, margin_rule=MARGIN_RULE,
             seconds=time.perf_counter() - t0, **numbers)
        runs.append(bcounts)
    launches = {"fused_sampling": sum(c["fused_sampling"] for c in runs)}
    if n_sites:
        launches["flash_attention"] = sum(c["flash_attention"] for c in runs)
        launches["decode_attention"] = sum(c["dense"] for c in runs)
    emit(phase, part="launches", launches=launches)
    return launches


def phase_serve_ssm() -> dict:
    """xlstm-1.3b, its depth cut to SSM_LAYERS against the plain path and
    in_process, at its published size over RECURRENT_TRANSPORTS: fused
    sampling in every tick (the mLSTM and sLSTM blocks are plain PyTorch,
    as the reference's are plain jnp)."""
    return phase_serve_recurrent("serve_ssm", SSM_ARCH, SSM_LAYERS)


def phase_serve_hybrid() -> dict:
    """zamba2-1.2b, its depth cut to HYBRID_LAYERS (the shared block's flash
    prefill and decode attention at each of its 3 sites of 6, fused
    sampling) against the plain path and in_process, and with bf16
    parameters; at its published size over RECURRENT_TRANSPORTS; then the
    launcher at --no-reduced (launcher_runs)."""
    launches = phase_serve_recurrent("serve_hybrid", HYBRID_ARCH,
                                     HYBRID_LAYERS)
    emit("serve_hybrid", part="launcher", runs=launcher_runs(),
         reduced=["requests 2 -> 1 a run"])
    return launches


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference of ``a`` and ``b`` over ``b``'s RMS."""
    bf = b.float()
    return float((a.float() - bf).abs().max() / bf.square().mean().sqrt())


def phase_encode_audio() -> dict:
    """hubert-xlarge at its published size (float32 parameters) through
    lm.forward on AUDIO_CLIPS clips of AUDIO_FRAMES frames: the kernel
    forward (non-causal flash_attention at D = 80 in every layer) against
    the plain bf16 forward and the float32 forward; returns the launches
    by kernel-table row."""
    t_phase = time.perf_counter()
    cfg, params, init_s, n_params, n_bytes = init_full(AUDIO_ARCH)
    plain_cfg = dataclasses.replace(cfg, attn_impl="chunked")
    f32_cfg = dataclasses.replace(plain_cfg, compute_dtype="float32")
    feats = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (AUDIO_CLIPS, AUDIO_FRAMES, cfg.d_model)).astype(np.float32)
        ).to(DEVICE)
    batch = {"features": feats}
    cp = lm.compute_params(cfg, params)

    def run(c, p):
        with torch.inference_mode():
            x, caches, _ = lm.forward(p, c, batch)
        torch.cuda.synchronize()
        return x

    run(cfg, cp)                                  # warm-up
    reset_counts()
    flash, unwatch = watch_flash()
    try:
        t0 = time.perf_counter()
        x_kern = run(cfg, cp)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        unwatch()
    counts = launch_counts()
    if (counts["flash_attention"] != cfg.n_layers or flash["causal"]
            or counts["flash_attention/tensor_core"] != cfg.n_layers):
        fail(f"encode_audio: flash launched {counts['flash_attention']} "
             f"times (tensor core {counts['flash_attention/tensor_core']}), "
             f"calls {flash}, expected {cfg.n_layers} non-causal")
    kernels, _, trace = profile_ms(lambda: run(cfg, cp), 1)
    x_plain = run(plain_cfg, cp)
    x_f32 = run(f32_cfg, params)
    shape = (AUDIO_CLIPS, AUDIO_FRAMES, cfg.d_model)
    for name, x in (("kernel", x_kern), ("plain", x_plain),
                    ("float32", x_f32)):
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            fail(f"encode_audio: the {name} forward gave "
                 f"{tuple(x.shape)}, finite {bool(torch.isfinite(x).all())}")
    kern_vs_plain = rel_max(x_kern, x_plain)
    plain_vs_f32 = rel_max(x_plain, x_f32)
    kern_vs_f32 = rel_max(x_kern, x_f32)
    if kern_vs_plain > AUDIO_RATIO * plain_vs_f32:
        fail(f"encode_audio: the kernel forward differs from the plain one "
             f"by {kern_vs_plain} of the RMS, more than {AUDIO_RATIO} x the "
             f"plain bf16 forward's {plain_vs_f32} from float32")
    emit("encode_audio", arch=AUDIO_ARCH, params=n_params,
         param_bytes=n_bytes, param_dtype=cfg.param_dtype, init_s=init_s,
         reduced=[], clips=AUDIO_CLIPS, frames=AUDIO_FRAMES,
         head_dim=cfg.head_dim, forward_wall_ms=wall,
         **busy_numbers(kernels, trace, 8, wall),
         flash_ms=device_ms_of(kernels, "flash_attention"),
         flash_launches=counts["flash_attention"], flash_calls=flash,
         max_diff_over_rms={"kernel_vs_plain": kern_vs_plain,
                            "plain_vs_float32": plain_vs_f32,
                            "kernel_vs_float32": kern_vs_f32},
         ratio_bar=AUDIO_RATIO, seconds=time.perf_counter() - t_phase)
    del params, cp
    torch.cuda.empty_cache()
    return {"flash_attention": counts["flash_attention"]}


# ---------------------------------------------------------------------------
# Data-parallel serving (ROADMAP A5)
# ---------------------------------------------------------------------------

# The data-parallel path (phase serve_sharded): llama3.2-1b at full width
# (bf16 compute, the kernel path: flash prefill, decode attention, fused
# sampling) through ServeEngine under a ShardedScheduler whose 2-way "data"
# mesh names the one card twice — the chip box has one card, so the two
# blocks of LM_SLOTS / 2 slots share it (a degenerate placement, as the
# reference's disjoint_submeshes reuses devices on a small host) — with
# dense caches and with bf16 pages; the same model under
# multihost_disaggregated_lm_engine with DISAGG_DECODES decode engines
# (auto, which stays in_process on one card, and device_to_device forced);
# and the pruned compacted capsnet-mnist (routing in the kernel) through a
# sharded CapsuleEngine with an SLO inner scheduler.  Bars: greedy tokens
# against the unsharded kernel engine's by MARGIN_RULE, seeded tokens
# equal, CapsNet classes equal to one unsharded engine's on every frame
# whose top-two capsule lengths differ by more than TRAIN_MARGIN, each
# block's caches and pool half the whole, each block launching its rows.
SHARD_WAYS = 2
SHARD_REQUESTS = 8
SHARD_SLO_MS = 50.0


def sharded_mesh():
    return make_mesh((SHARD_WAYS,), ("data",), devices=[DEVICE] * SHARD_WAYS)


def launches_by_block(engine) -> list:
    """Per block of a sharded ServeEngine, the launches its per-block calls
    made (the counters' growth across each call, the block read from the
    call's shard or its first slot; a staged tick's replay adds its
    graph's launches; a call inside a counted one is counted there)."""
    by = [{} for _ in engine._shards]
    depth = [0]

    def counted(k, fn, *a, **kw):
        if depth[0]:
            return fn(*a, **kw)
        before = launch_counts()
        depth[0] += 1
        try:
            out = fn(*a, **kw)
        finally:
            depth[0] -= 1
        for name, n in launch_counts().items():
            by[k][name] = by[k].get(name, 0) + n - before[name]
        return out

    for method in ("_prefill_scatter", "_decode", "_decode_paged_impl",
                   "_prefill_paged_impl", "_tick_shard"):
        inner = getattr(engine, method)
        setattr(engine, method,
                lambda sh, *a, _f=inner, **kw: counted(sh.index, _f, sh, *a,
                                                       **kw))
    inner = engine._sample_batch_device
    engine._sample_batch_device = (
        lambda logits, active, pos_of, lo=0: counted(
            engine._shard_of(lo).index, inner, logits, active, pos_of, lo))
    return by


def tick_numbers(engine, vocab: int, n_ticks: int = 8) -> dict:
    """ms per decode tick with every slot busy (LM_SLOTS prompts of
    LM_MAX_LEN / 2 tokens; the host clock over ticks that end in the copy
    of the tokens) and the device's busy time and idle share over
    TRACED_TICKS traced ticks."""
    rng = np.random.RandomState(2)
    for i in range(LM_SLOTS):
        engine.submit(Request(
            prompt=[int(t) for t in rng.randint(1, vocab // 2,
                                                size=LM_MAX_LEN // 2)],
            max_new_tokens=n_ticks + TRACED_TICKS * TICK_TRACE_ATTEMPTS + 2,
            rid=2000 + i))
    engine.tick()                           # admission and the first step
    walls = []
    for _ in range(n_ticks):
        t0 = time.perf_counter()
        engine.tick()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    kernels, _, trace = profile_ms(engine.tick, TRACED_TICKS,
                                   TICK_TRACE_ATTEMPTS)
    engine.run_until_idle()
    wall = walls[len(walls) // 2]
    return {"tick_wall_ms": wall, "reduced": TRACED_REDUCED, **busy_numbers(
        kernels, trace, 0, wall, "device_idle_share_of_tick")}


def sharded_lm_cell(cfg, params, reqs, label: str, **kw) -> tuple:
    """One LM cell of serve_sharded: the unsharded kernel engine's tokens
    and margins, then the sharded engine on the same requests; returns
    (numbers, launch counts of the sharded run)."""
    tok_ref, margins, ref_numbers = unified_reference(cfg, params, reqs,
                                                      **kw)
    eng = ServeEngine(cfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      decode_kernel=True, device=DEVICE,
                      scheduler=ShardedScheduler(sharded_mesh()), **kw)
    eng.generate([[1, 2, 3, 4] * 8], max_new_tokens=2)
    by_block = launches_by_block(eng)
    reset_counts()
    t0 = time.perf_counter()
    done = eng.serve(fresh(reqs))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = eng.stats()
    tok = {c.rid: c.tokens for c in done}
    if len(done) != len(reqs):
        fail(f"serve_sharded ({label}): {len(done)} of {len(reqs)} "
             f"requests completed")
    compared, ambiguous, first_diff = compare_with_plain(
        f"serve_sharded ({label})", reqs, tok, tok_ref, tok_ref, margins,
        cfg.vocab)
    if kw.get("page_size"):
        whole = pool_bytes_whole(cfg, **kw)
        held = [sum(t.numel() * t.element_size() for t in sh.pool.values())
                for sh in eng._shards]
        rows = ("flash_attention", "paged", "fused_sampling")
    else:
        whole = lm.cache_nbytes(cfg, LM_SLOTS, LM_MAX_LEN)
        held = [sum(t.numel() * t.element_size()
                    for t in tree_leaves(sh.caches)) for sh in eng._shards]
        rows = ("flash_attention", "dense", "fused_sampling")
    if any(h * SHARD_WAYS != whole for h in held):
        fail(f"serve_sharded ({label}): blocks hold {held} bytes of "
             f"{whole}, not 1/{SHARD_WAYS} each")
    per_block = [{r: b.get(r, 0) for r in rows} for b in by_block]
    if any(n < 1 for b in per_block for n in b.values()):
        fail(f"serve_sharded ({label}): a block launched no row: "
             f"{per_block}")
    check_prefill_bodies(f"serve_sharded ({label})", counts)
    numbers = {"cell": label, "blocks": SHARD_WAYS,
               "mesh": str(eng.scheduler.mesh),
               "requests": stats.completed, "new_tokens": stats.items,
               "wall_s": wall, "tok_per_s": stats.items / wall,
               "engine_tok_per_s": stats.throughput,
               "ms_per_tick": stats.ms_per_tick,
               "unsharded": ref_numbers,
               "tokens_compared": compared, "ambiguous": ambiguous,
               "first_divergence": first_diff, "margin_rule": MARGIN_RULE,
               "bytes_whole": whole, "bytes_per_block": held,
               "launches_per_block": per_block,
               "ticks": tick_numbers(eng, cfg.vocab)}
    return numbers, counts


def pool_bytes_whole(cfg, page_size: int, **kw) -> int:
    """Bytes of the whole pool an unsharded engine of LM_SLOTS slots
    holds (the meta device allocates nothing)."""
    from repro_torch.serving import PagePool

    pool = PagePool(cfg, LM_SLOTS, LM_MAX_LEN, page_size,
                    quantize=kw.get("quantize_pages", False))
    return int(sum(t.numel() * t.element_size()
                   for t in pool.init_pool_arrays("meta").values()))


def sharded_multihost(cfg, params, reqs, tok_ref, margins,
                      transport: str) -> tuple:
    """multihost_disaggregated_lm_engine with DISAGG_DECODES decode engines
    over every visible card (one: each engine's mesh names it), greedy
    tokens held against the unsharded engine's by MARGIN_RULE."""
    kw = {}
    if transport != "auto":
        kw = dict(transport=make_transport(transport,
                                           keep_records=len(reqs)),
                  scheduler=DisaggScheduler(overlap=True))
    eng = multihost_disaggregated_lm_engine(
        cfg, params, n_slots=DISAGG_SLOTS, max_len=LM_MAX_LEN,
        n_decode=DISAGG_DECODES, prefill_slots=LM_SLOTS, decode_kernel=True,
        **kw)
    chosen = eng.transport.name
    if transport == "auto" and torch.cuda.device_count() == 1 \
            and chosen != "in_process":
        fail(f"serve_sharded (multihost): auto picked {chosen} on one card")
    warm_disagg(eng)
    reset_counts()
    t0 = time.perf_counter()
    done = eng.serve(fresh(reqs))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    stats = eng.stats()
    tok = {c.rid: c.tokens for c in done}
    if len(done) != len(reqs):
        fail(f"serve_sharded (multihost {transport}): {len(done)} of "
             f"{len(reqs)} requests completed")
    compared, ambiguous, first_diff = compare_with_plain(
        f"serve_sharded (multihost {transport})", reqs, tok, tok_ref,
        tok_ref, margins, cfg.vocab)
    meshes = [str(e.scheduler.mesh) for e in [eng.prefill] + eng.decodes]
    return {"cell": f"multihost {transport}", "transport": chosen,
            "meshes": meshes, "requests": stats.completed,
            "new_tokens": stats.items, "wall_s": wall,
            "tok_per_s": stats.items / wall,
            "ms_per_tick": stats.ms_per_tick,
            "deliveries": len(eng.transport.records),
            "tokens_compared": compared, "ambiguous": ambiguous,
            "first_divergence": first_diff}, counts


class BlockForwards:
    """A CapsuleEngine replica whose forwards count the routing kernel's
    launches by block (a tick's blocks are forwarded in order)."""

    def __init__(self, inner, n_blocks: int):
        self.inner, self.n = inner, n_blocks
        self.calls = 0
        self.by_block = [0] * n_blocks

    def forward(self, x):
        before = fused_routing_cuda.launches
        out = self.inner.forward(x)
        self.by_block[self.calls % self.n] += (fused_routing_cuda.launches
                                               - before)
        self.calls += 1
        return out


def sharded_capsnet() -> tuple:
    """The pruned compacted capsnet-mnist (252 capsules, routing in the
    kernel) through a sharded CapsuleEngine with an SLO inner scheduler,
    against one unsharded engine; returns (numbers, launch counts)."""
    cfg = cfg_lib.get_config("capsnet-mnist")
    deployed = (FastCapsPipeline(cfg, device=DEVICE).build(seed=0)
                .prune(0.6, 0.9, type_keep=7).compact()
                .compile(routing="cuda"))
    requests = make_requests(8, deployed.cfg)
    single, _, _ = serve(deployed, requests)
    sched = ShardedScheduler(
        sharded_mesh(), inner=SLOBatchScheduler(target_p95_ms=SHARD_SLO_MS))
    engine = deployed.serve(batch_size=BATCH, scheduler=sched)
    if sched.quantize(3, BATCH) != 4 or sched.quantize(1, BATCH) != 2:
        fail("serve_sharded (capsnet): quantize does not round up to the "
             "blocks")
    engine.warmup()
    replicas = len({id(r) for r in engine._replicas})
    counter = BlockForwards(engine._replicas[0], SHARD_WAYS)
    engine._replicas = [counter] * SHARD_WAYS
    reset_counts()
    t0 = time.perf_counter()
    done = engine.serve([ImageRequest(images=r.images, rid=r.rid)
                         for r in requests])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    per_block = list(counter.by_block)
    stats = engine.stats()
    by_rid = {c.rid: c for c in single}
    differ = 0
    for c in done:
        want = by_rid[c.rid]
        clear = clear_margin(want.lengths)
        if not np.array_equal(c.classes[clear], want.classes[clear]):
            fail(f"serve_sharded (capsnet): rid {c.rid} classes differ from "
                 f"one unsharded engine's")
        differ += int((c.classes != want.classes).sum())
    if len(done) != len(requests) or min(per_block) < 1:
        fail(f"serve_sharded (capsnet): {len(done)} of {len(requests)} "
             f"served, routing launches by block {per_block}")
    batch = np.zeros((BATCH,) + (28, 28, 1), np.float32)
    kernels, _, trace = profile_ms(lambda: engine.forward_host(batch), 10)
    busy = sum(kernels.values()) if kernels else None
    t0 = time.perf_counter()
    for _ in range(10):
        engine.forward_host(batch)
    tick_ms = (time.perf_counter() - t0) * 1e2
    return ({"cell": "capsnet", "capsules": deployed.cfg.n_primary_caps,
             "requests": stats.completed, "frames": stats.frames,
             "ticks": stats.ticks, "fps": stats.frames / wall,
             "engine_fps": stats.fps, "ms_per_tick": stats.ms_per_tick,
             "full_tick_wall_ms": tick_ms,
             "full_tick_device_busy_ms": busy if busy else None,
             "device_idle_share": (max(0.0, 1.0 - busy / tick_ms)
                                   if busy else None),
             "trace_dropped": trace["trace_dropped"],
             "classes_differing_under_margin": differ,
             "routing_launches_per_block": per_block,
             "replicas": replicas}, counts)


def phase_serve_sharded() -> dict:
    """Data-parallel serving on a degenerate 2-way mesh over the card, the
    multi-host disaggregated engine, and the sharded CapsuleEngine (see
    SHARD_WAYS)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, params, init_s, _ = init_lm()
    params = lm.compute_params(cfg, params)      # one cast for every engine
    reqs = lm_requests(cfg.vocab, SHARD_REQUESTS)
    launches = {}

    def add(counts, rows):
        for row, key in rows.items():
            launches[row] = launches.get(row, 0) + counts[key]

    lm_rows = {"flash_attention": "flash_attention",
               "decode_attention": "dense", "fused_sampling": "fused_sampling"}
    numbers, counts = sharded_lm_cell(cfg, params, reqs, "dense")
    emit("serve_sharded", arch=LM_ARCH, init_s=init_s, **numbers)
    add(counts, lm_rows)
    numbers, counts = sharded_lm_cell(cfg, params, reqs, "paged bf16",
                                      page_size=PAGE)
    emit("serve_sharded", arch=LM_ARCH, page_size=PAGE, **numbers)
    add(counts, {"flash_attention": "flash_attention",
                 "decode_attention_paged": "paged",
                 "fused_sampling": "fused_sampling"})
    tok_ref, margins, _ = unified_reference(cfg, params, reqs)
    for transport in ("auto", "device_to_device"):
        numbers, counts = sharded_multihost(cfg, params, reqs, tok_ref,
                                            margins, transport)
        emit("serve_sharded", arch=LM_ARCH, **numbers)
        add(counts, lm_rows)
    del params
    torch.cuda.empty_cache()
    numbers, counts = sharded_capsnet()
    emit("serve_sharded", **numbers)
    add(counts, {"fused_routing": "fused_routing"})
    for row in ("flash_attention", "decode_attention",
                "decode_attention_paged", "fused_sampling", "fused_routing"):
        if launches.get(row, 0) < 1:
            fail(f"serve_sharded: {row} was never launched on the sharded "
                 f"path")
    emit("serve_sharded", part="launches", launches=launches,
         seconds=time.perf_counter() - t_phase)
    return launches


def library_call(name, args, kwargs):
    """One PyTorch call that computes the same function, timed as a
    yardstick (the port never calls it), or None."""
    import torch.nn.functional as F

    if name == "flash_attention":
        q, k, v = (x.transpose(1, 2) for x in args)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kwargs["causal"], enable_gqa=True)
    if name == "decode_attention":
        if kwargs.get("tables") is not None or kwargs.get("ks") is not None:
            return None                # no PyTorch call reads pages or int8
        q, k, v, valid = args
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(k.shape[1], device=k.device)[None, :]
                < valid[:, None].long())[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    if name == "fused_sampling":
        logits = args[0]
        return lambda: torch.argmax(logits, dim=-1)
    if name == "fixed_order_matmul":
        x, w = args
        return lambda: torch.matmul(x, w)          # cuBLAS
    return None


# each kernel's bound at a case: (seconds for its bytes, seconds for its
# operations), from the port's roofline module
BOUNDS = roofline.KERNEL_BOUNDS

# the name of each kernel's CUDA function, for its profiler events
KERNEL_EVENT = {"fused_routing": "fused_routing_kernel",
                "taylor_softmax": "taylor_softmax",
                "taylor_softmax_bwd": "taylor_softmax_bwd",
                "flash_attention": "flash_attention_kernel",
                "flash_attention_dequant": "flash_attention_kernel",
                "decode_attention": "decode_attention_kernel",
                "fused_sampling": "fused_sampling_kernel",
                "fixed_order_matmul": "fixed_order_gemm"}


# The kernels a captured path launches (the CapsNet forward's routing and
# softmax, the decode tick's attention and sampling, the prefill's flash
# attention, every projection's fixed-order GEMM): timing_row also times
# them inside one CUDA graph (graph_ms).
GRAPHED = ("fused_routing", "taylor_softmax", "decode_attention",
           "fused_sampling", "fixed_order_matmul", "flash_attention")
GRAPH_LAUNCHES = 20


def graph_ms(call, launches: int = GRAPH_LAUNCHES, repeats: int = 5) -> float:
    """ms per launch of ``call`` inside one CUDA graph of ``launches``
    back-to-back calls, by CUDA events around a replay (median of
    ``repeats``): the kernel's time without the wrapper's host work.  The
    warm-up and the capture leave the launch counters as they were."""
    before = graphs.counters()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    gc.disable()                # as graphs.CapturedCall: no collection
    try:                        # (of another graph) inside the capture
        with torch.cuda.graph(g, stream=side):
            for _ in range(launches):
                call()
    finally:
        gc.enable()
    graphs.restore_counts(before)
    g.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del g
    times.sort()
    return times[len(times) // 2]


def timing_row(name, case, n_profile: int = 20, config=None,
               plain: bool = True, repeats: int = 5, example=None) -> dict:
    """Kernel time by CUDA events (``ms``, wrapper included), the kernel
    alone by profiler events (``kernel_ms``: device time over the events of
    a trace that holds every launch, else None with ``trace_dropped``; not
    taken when ``n_profile`` is 0), for a kernel of a captured path
    (GRAPHED) the time a launch takes inside a CUDA graph (``graph_ms``,
    with ``n_profile``), the plain version's and the library
    call's time, and the bound, at one case, with the default config or
    ``config`` over it (the plain version's and the library call's times
    only when ``plain``; ``example``, the case's inputs when already made).
    A ``kernel_ms`` below the bound fails: no complete trace can read so."""
    spec = registry.get(name)
    args, kwargs = example or spec.make_example(case, device=DEVICE)
    cfg = {**registry.default_config(name, *args, **kwargs),
           **(config or {})}
    wrapper = spec.build()

    def call():
        return wrapper(*args, **kwargs, **cfg)

    ms = median_ms(call, repeats=repeats)
    kernel_ms, trace = (kernel_ms_of(call, name, n_profile) if n_profile
                        else (None, {"trace_dropped": None, "attempts": 0}))
    t_bytes, t_ops = BOUNDS[name](case)
    row = {"ms": ms, "kernel_ms": kernel_ms,
           "trace_dropped": trace["trace_dropped"],
           "trace_attempts": trace["attempts"],
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "shape": case_shape(case), "config": cfg}
    if kernel_ms is not None and kernel_ms < row["bound_ms"]:
        fail(f"timings: {name} {case_shape(case)} {cfg}: kernel ms "
             f"{kernel_ms} below its bound {row['bound_ms']}")
    if n_profile and name in GRAPHED:
        row["graph_ms"] = graph_ms(call)
    if plain:
        fn = PLAIN.get(name)
        plain_call = ((lambda: fn(*args, **kwargs)) if fn
                      else (lambda: spec.ref_call(*args, **kwargs)))
        lib = library_call(name, args, kwargs)
        row["plain_ms"] = median_ms(plain_call, launches=5, repeats=3)
        row["library_ms"] = median_ms(lib) if lib is not None else None
    return row


# The sweeps take CUDA-event times only: their profiler traces (about 40 s
# of the script's time limit for 108 points on an H100) were cut to pay
# for serve_tuned and the scaled cases, and their repeats from 5 to
# SWEEP_REPEATS to pay for the sampling contract's checks; each sweep line
# says so.
SWEEP_REPEATS = 3
SWEEP_REDUCED = ["sweep points timed by CUDA events only (ms); no profiler "
                 "trace, so kernel_ms is null",
                 f"repeats of 20 back-to-back calls a point 5 -> "
                 f"{SWEEP_REPEATS}"]


def sweep(name, case) -> dict:
    """``timing_row`` (kernel only, CUDA events, no profiler trace:
    SWEEP_REDUCED) at every point of the kernel's tuned space over its
    default config, as the wrapper is called with it (not re-planned: the
    planner would fold the decode splits above one block an SM, and the
    clusters too small for a row, into its own choice); a point the
    wrapper refuses (its shared memory does not fit) is recorded with the
    refusal."""
    spec = registry.get(name)
    args, kwargs = spec.make_example(case, device=DEVICE)
    base = registry.default_config(name, *args, **kwargs)
    out = {}
    for values in itertools.product(*(spec.space[k] for k in spec.tuned)):
        point = dict(zip(spec.tuned, values))
        key = ",".join(f"{k}={v}" for k, v in point.items())
        try:
            out[key] = timing_row(name, case, n_profile=0, plain=False,
                                  config={**base, **point},
                                  repeats=SWEEP_REPEATS,
                                  example=(args, kwargs))
        except ValueError as err:
            out[key] = {"refused": str(err)}
    return out


# Timing rows at serve_moe's and serve_vlm's shapes (the PERF.md table's
# slice lines): (registry kernel, label, case).
SLICE_TIMINGS = (
    ("flash_attention", "deepseek-moe-16b self, G 1",
     {"dims": (LM_SLOTS, LM_MAX_LEN, LM_MAX_LEN, 16, 16, 128),
      "dtype": "bfloat16", "causal": True}),
    ("flash_attention", "llama-3.2-vision self, G 8",
     {"dims": (LM_SLOTS, LM_MAX_LEN, LM_MAX_LEN, 64, 8, 128),
      "dtype": "bfloat16", "causal": True}),
    ("flash_attention", "llama-3.2-vision cross, G 8, non-causal",
     {"dims": (LM_SLOTS, LM_MAX_LEN, 1024, 64, 8, 128),
      "dtype": "bfloat16", "causal": False}),
    ("decode_attention", "deepseek-moe-16b dense, G 1", MOE_LAYOUTS[0]),
    ("decode_attention", "deepseek-moe-16b paged", MOE_LAYOUTS[1]),
    ("decode_attention", "deepseek-moe-16b paged int8", MOE_LAYOUTS[2]),
    ("decode_attention", "llama-3.2-vision dense, G 8", VLM_DECODE),
    ("fused_sampling", "V 102400 greedy",
     {"dims": (LM_SLOTS, 102400), "temperature": (0.0,) * LM_SLOTS}),
    ("fused_sampling", "V 102400 mixed", {"dims": (LM_SLOTS, 102400),
                                          **MIXED}),
    ("flash_attention", "hubert-xlarge, D 80, non-causal",
     {k: v for k, v in AUDIO_FLASH.items() if k != "atol"}),
    ("flash_attention", "zamba2-1.2b shared block, G 1, S 700",
     {k: v for k, v in HYBRID_FLASH.items() if k != "atol"}),
    ("decode_attention", "zamba2-1.2b site, G 1", HYBRID_DECODE),
    *(("fused_sampling", f"V {v} {label}", {"dims": (LM_SLOTS, v), **rows})
      for v in (50304, 32000)
      for label, rows in (("greedy", {"temperature": (0.0,) * LM_SLOTS}),
                          ("mixed", MIXED))),
)


# The kernel-table rows at serve_qwen3's and serve_large's geometries,
# listed in the kernels line under their rows: (row, label, case, the model
# whose phase launches the row at this geometry, or None where only the
# kernels phase does).  The decode cases take their phase's tick lengths,
# the served sampling ticks mix greedy and sampled rows.
GEOMETRY_ROWS = (
    ("flash_attention", "mistral-large-123b prefill, G 12 (q_block 4)",
     LARGE_FLASH["mistral-large-123b"], "mistral-large-123b"),
    ("flash_attention", "dbrx-132b prefill, G 6 (q_block 8)",
     LARGE_FLASH["dbrx-132b"], "dbrx-132b"),
    ("decode_attention", "mistral-large-123b, G 12", G12_LAYOUTS[0],
     "mistral-large-123b"),
    ("decode_attention_dequant", "mistral-large-123b, G 12, int8",
     G12_LAYOUTS[1], None),
    ("decode_attention_paged", "mistral-large-123b, G 12, bf16 pages",
     G12_LAYOUTS[2], None),
    ("decode_attention_paged_dequant", "mistral-large-123b, G 12, int8 pages",
     G12_LAYOUTS[3], "mistral-large-123b"),
    ("decode_attention", "dbrx-132b, G 6", G6_DECODE, "dbrx-132b"),
    *(("fused_sampling", f"{arch}, V {v}, {label}", {"dims": (LM_SLOTS, v),
                                                     **rows}, arch)
      for arch, v in (("qwen1.5-110b", 152064), (QWEN3_ARCH, 151936))
      for label, rows in (("greedy", {"temperature": (0.0,) * LM_SLOTS}),
                          ("mixed", MIXED))),
)


def main_path_cases() -> list:
    """``(row, registry kernel, case)`` of every kernel-table row at its
    main path's shape.  The decode rows take the decode tick's valid
    lengths: serve_lm's first 8 requests for the dense body, serve_paged's
    for the int8 and paged ones, 16 tokens into decode."""
    vocab = cfg_lib.get_config(LM_ARCH).vocab
    valid = tuple(len(r.prompt) + 16 for r in lm_requests(vocab)[:LM_SLOTS])
    out = []
    for row, info in KERNELS.items():
        case = dict(info["main_case"])
        if row == "decode_attention":
            case["valid"] = valid
        elif row in DECODE_ROWS.values():
            case["valid"] = paged_valid(vocab)
        out.append((row, info["kernel"], case))
    return out


def phase_timings(launches: dict, worst: dict, by_case: dict,
                  by_model: dict) -> list:
    """One row per TPU entry point at its main path's shape
    (:func:`main_path_cases`), then one per GEOMETRY_ROWS entry, with the
    launches of its model's phase (``by_model``: model -> row -> count) or
    of the kernels phase, and the largest error of the kernels phase's
    cases at its geometry (``by_case``)."""
    table = []
    vocab = cfg_lib.get_config(LM_ARCH).vocab
    valid = tuple(len(r.prompt) + 16 for r in lm_requests(vocab)[:LM_SLOTS])
    for name, kernel, case in main_path_cases():
        info = KERNELS[name]
        row = {"name": name, "route": info["route"], "source": info["source"],
               "replaces": info["replaces"], "launches": launches[name],
               "max_abs_err": worst[name],
               **(gemm_geometry(case) if kernel == "fixed_order_matmul"
                  else {}),
               **timing_row(kernel, case)}
        table.append(row)
        emit("timings", **row)
    # the moe and vlm phases' shapes, beside the main rows (the decode
    # rows at the same ticks' lengths)
    hybrid_valid = tuple(
        len(r.prompt) + 16
        for r in lm_requests(cfg_lib.get_config(HYBRID_ARCH).vocab,
                             LM_SLOTS))
    for name, label, case in SLICE_TIMINGS:
        if name == "decode_attention":
            case = dict(case, valid=paged_valid(vocab) if case.get("paged")
                        else hybrid_valid if case is HYBRID_DECODE
                        else valid)
        row = timing_row(name, case)
        if "mixed" in label:
            row.pop("library_ms")
        emit("timings", name=name, case=label, **row)
    # serve_qwen3's and serve_large's geometries, listed in the kernels
    # line under their rows
    for row, label, case, model in GEOMETRY_ROWS:
        kernel = KERNELS[row]["kernel"]
        if kernel == "decode_attention":
            case = dict(case, valid=paged_valid(vocab) if case.get("paged")
                        else valid)
        seen = by_case[case_key(kernel, case)]
        info = KERNELS[row]
        entry = {"name": f"{row}: {label}", "route": info["route"],
                 "source": info["source"], "replaces": info["replaces"],
                 "launches": (by_model[model][row] if model
                              else seen["launches"]),
                 "launch_source": f"phase of {model}" if model
                 else "kernels phase",
                 "max_abs_err": seen["max_abs_err"],
                 **timing_row(kernel, case)}
        if "mixed" in label:
            entry["library_ms"] = None      # argmax is not this function
        table.append(entry)
        emit("timings", case=label, **entry)
    # the fixed-order GEMM at llama3.2-1b's projections, prefill and
    # decode, beside cuBLAS (library_ms), listed in the kernels line under
    # its row; their launches are the kernels phase's at each geometry
    info = KERNELS["fixed_order_matmul"]
    for label, case in GEMM_TIMINGS:
        seen = by_case[case_key("fixed_order_matmul", case)]
        entry = {"name": f"fixed_order_matmul: {label}",
                 "route": info["route"], "source": info["source"],
                 "replaces": info["replaces"], "launches": seen["launches"],
                 "launch_source": "kernels phase",
                 "max_abs_err": seen["max_abs_err"], **gemm_geometry(case),
                 **timing_row("fixed_order_matmul", case)}
        table.append(entry)
        emit("timings", case=label, **entry)
    # the serve mix's sampling rows (temperature 0.8, top-k 50, top-p 0.9)
    case = {"dims": (LM_SLOTS, 128256), **MIXED}
    emit("timings", name="fused_sampling", case="mixed",
         **{k: v for k, v in timing_row("fused_sampling", case).items()
            if k != "library_ms"}, clocks_after=clocks_line())
    # the tunables' spaces, so the defaults come from this card's numbers:
    # the decode rows and sampling greedy and mixed at every point
    for name, info in KERNELS.items():
        if info["kernel"] != "decode_attention":
            continue
        case = dict(info["main_case"], valid=(
            valid if name == "decode_attention" else paged_valid(vocab)))
        emit("timings", name=name, case="by config", reduced=SWEEP_REDUCED,
             by_config=sweep("decode_attention", case))
    for label, rows in (("greedy", {"temperature": (0.0,) * LM_SLOTS}),
                        ("mixed", MIXED)):
        case = {"dims": (LM_SLOTS, 128256), **rows}
        emit("timings", name="fused_sampling", case=f"{label} by config",
             reduced=SWEEP_REDUCED,
             by_config=sweep("fused_sampling", case))
    # the flash kernels' FMA body: float32 q at the main shapes
    for name in ("flash_attention", "flash_attention_dequant"):
        case = {**KERNELS[name]["main_case"], "dtype": "float32"}
        emit("timings", name=name, case="fma float32",
             **timing_row(name, case))
    # routing at the dense serve path's shape beside the main one, and
    # both at every point of i_splits x threads; the softmax's threads
    routing_dense = {"shape": (BATCH, 1152, 10, 16), "softmax_mode": "taylor"}
    emit("timings", name="fused_routing", case="dense",
         **timing_row("fused_routing", routing_dense))
    for label, case in (("pruned", KERNELS["fused_routing"]["main_case"]),
                        ("dense", routing_dense)):
        emit("timings", name="fused_routing", case=f"{label} by config",
             reduced=SWEEP_REDUCED,
             by_config=sweep("fused_routing", case))
    emit("timings", name="taylor_softmax", case="by config",
         reduced=SWEEP_REDUCED,
         by_config=sweep("taylor_softmax",
                         KERNELS["taylor_softmax"]["main_case"]))
    # the floors under row 2's time: the shortest kernel the card runs (a
    # one-element fill) and a copy of row 2's own input (one read and one
    # write of the same bytes)
    one = torch.empty(1, device=DEVICE)
    (x,), _ = registry.get("taylor_softmax").make_example(
        KERNELS["taylor_softmax"]["main_case"], device=DEVICE)
    fill, _, fill_trace = profile_ms(lambda: one.fill_(0.0), 20)
    copy, _, copy_trace = profile_ms(lambda: x.clone(), 20,
                                     expect={"Memcpy": 20})
    emit("timings", name="launch_floor",
         fill_kernel_ms=sum(fill.values()) if fill else None,
         copy_kernel_ms=sum(copy.values()) if copy else None,
         trace_dropped=[fill_trace["trace_dropped"],
                        copy_trace["trace_dropped"]],
         kernels=sorted(fill or {}) + sorted(copy or {}))
    return table


# The dryrun phase.  (a) The production-mesh dry run on the host: the
# launcher once per cell, on meta, each cell counted once and recorded on
# each of its meshes (variant "opt", the launcher's default);
# mistral-large-123b's decode exists only across many cards.  (b) Five
# cells sized for one card: counted on meta through the variant named, then
# placed on the card with seeded weights and run there: (label, arch, shape,
# variant, kernel rows the step must launch).
DRYRUN_PRODUCTION = (
    ("llama3.2-1b", "train_4k", (False,)),
    ("llama3.2-1b", "prefill_32k", (False,)),
    ("llama3.2-1b", "decode_32k", (False, True)),
    ("capsnet-mnist", "train_1k", (False,)),
    ("capsnet-mnist", "infer_1k", (False,)),
    ("mistral-large-123b", "decode_32k", (False, True)),
)
DRYRUN_CARD = (
    ("llama3.2-1b decode", LM_ARCH,
     {"seq": LM_MAX_LEN, "batch": LM_SLOTS, "kind": "decode"}, "kernels",
     ("decode_attention",)),
    ("llama3.2-1b prefill", LM_ARCH,
     {"seq": LM_MAX_LEN, "batch": LM_SLOTS, "kind": "prefill"}, "kernels",
     ("flash_attention",)),
    ("llama3.2-1b train", LM_ARCH,
     {"seq": TRAIN_LM_SEQ, "batch": TRAIN_LM_BATCH, "kind": "train"}, "opt",
     ()),
    ("capsnet-mnist infer", "capsnet-mnist", "infer_1k", "kernels",
     ("fused_routing",)),
    ("capsnet-mnist train", "capsnet-mnist", "train_1k", "kernels",
     ("taylor_softmax", "taylor_softmax_bwd")),
)
DRYRUN_STEPS = 5
# The caching allocator rounds a block up to 512 bytes; a block over 1 MiB
# (its large pool) keeps its segment's tail when the tail is at most 1 MiB
# (the segment is rounded up to 2 MiB and not split), so a 501 MiB table
# holds 502 MiB.  The bytes the tensors asked for are its "requested_bytes".
ALLOC_ROUND = 512
LARGE_BLOCK = 1 << 20


def requested_bytes() -> int:
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def dryrun_production() -> list:
    """Part (a): ``python -m repro_torch.launch.dryrun`` once per cell of
    DRYRUN_PRODUCTION, all at once (each is one host process on meta
    tensors), then one line per record."""
    env = port_env()
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for arch, shape, meshes in DRYRUN_PRODUCTION:
            mesh = "both" if len(meshes) == 2 else (
                "multi" if meshes[0] else "single")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh,
                 "--out", tmp], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            if p.returncode:
                fail(f"dryrun: {p.args[4]} {p.args[6]}: exit "
                     f"{p.returncode}: {log[-2000:]}")
        for rec in roofline.load_records(tmp):
            a = roofline.analyze(rec)
            line = {"arch": rec["arch"], "shape": rec["shape"],
                    "mesh": rec["mesh"], "n_chips": rec["n_chips"],
                    "arg_gib_per_dev": rec["arg_bytes_per_dev"] / 2 ** 30,
                    "temp_gib_per_dev": rec["temp_bytes_per_dev"] / 2 ** 30,
                    "flops_per_dev": rec["flops_per_dev"],
                    "bytes_per_dev": rec["bytes_per_dev"],
                    "dominant": a["dominant"], "bound_s": a["bound_s"],
                    "model_over_counted": a["useful_ratio"],
                    "n_ops": rec["n_ops"], "trace_s": rec["trace_s"]}
            emit("dryrun", part="production", **line)
            out.append(line)
    if len(out) != sum(len(m) for _, _, m in DRYRUN_PRODUCTION):
        fail(f"dryrun: {len(out)} production records")
    return out


def finite_leaves(tree) -> bool:
    return all(bool(torch.isfinite(t).all())
               for t, _ in dryrun.leaf_pairs(tree)
               if t.dtype.is_floating_point)


def dryrun_card_cell(label, arch, shape, variant, rows) -> dict:
    """Part (b), one cell: counted on meta, placed on the card, run."""
    kind = dryrun.cell_kind(arch, shape)
    rules = shard_lib.rules_for_arch(
        arch, kind="train" if arch.startswith("capsnet") else kind)
    mesh = make_mesh((1, 1), ("data", "model"), devices=["meta"])
    cfg = dryrun.cell_config(arch, shape, variant)
    fn, args, in_sh, out_sh = dryrun.build_cell(arch, shape, rules, mesh,
                                                variant)
    out, cost, trace_s = dryrun.count_cell(fn, args)
    rec = dryrun.record(arch, label, mesh, "1x1", variant, cost, trace_s,
                        args, in_sh, out, out_sh)
    del out
    sizes = [t.numel() * t.element_size() for t, _ in dryrun.leaf_pairs(args)]
    n_tensors = len(sizes)
    rounding = sum(ALLOC_ROUND + (LARGE_BLOCK if n > LARGE_BLOCK else 0)
                   for n in sizes)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before, asked_before = torch.cuda.memory_allocated(), requested_bytes()
    card = dryrun.place_args(arch, cfg, args, DEVICE, seed=0)
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated() - before
    asked = requested_bytes() - asked_before
    if asked != rec["arg_bytes_per_dev"]:
        fail(f"dryrun: {label}: the placed tensors asked the allocator for "
             f"{asked} bytes against {rec['arg_bytes_per_dev']} counted")
    slack = growth - rec["arg_bytes_per_dev"]
    if not 0 <= slack < rounding:
        fail(f"dryrun: {label}: {growth} bytes allocated on the card "
             f"against {rec['arg_bytes_per_dev']} counted (more than the "
             f"allocator's rounding of {n_tensors} tensors, {rounding} "
             f"bytes, apart)")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    res = fn(*card)
    torch.cuda.synchronize()
    temp_measured = torch.cuda.max_memory_allocated() - base
    launches = launch_counts()
    if not finite_leaves(res):
        fail(f"dryrun: {label}: the step's output is not finite")
    missing = [r for r in rows if launches.get(r, 0) < 1]
    if missing:
        fail(f"dryrun: {label}: {missing} never launched")
    del res
    times = []
    for _ in range(DRYRUN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn(*card)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        del res
    times.sort()
    median = times[len(times) // 2]
    t_ops = rec["flops_per_dev"] / roofline.PEAK_FLOPS
    t_bytes = rec["bytes_per_dev"] / roofline.HBM_BW
    bound_ms = max(t_ops, t_bytes) * 1e3
    model = roofline.model_flops(arch, shape)
    line = {"cell": label, "variant": variant,
            "arg_bytes_counted": rec["arg_bytes_per_dev"],
            "arg_bytes_requested": asked, "arg_bytes_allocated": growth,
            "allocator_rounding_bytes": slack, "tensors": n_tensors,
            "temp_bytes_counted": rec["temp_bytes_per_dev"],
            "temp_bytes_measured": temp_measured,
            "flops_counted": rec["flops_per_dev"],
            "dot_flops_counted": rec["dot_flops_per_dev"],
            "bytes_counted": rec["bytes_per_dev"],
            "kernel_calls_counted": {
                k: v for k, v in cost.op_counts.items()
                if k.startswith("kernel.")},
            "n_ops": rec["n_ops"], "trace_s": trace_s,
            "step_ms_median": median, "step_ms_min": times[0],
            "step_ms_max": times[-1], "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_over_measured": bound_ms / median,
            "model_flops": model,
            "model_over_counted": model / rec["flops_per_dev"],
            "launches": {r: launches[r] for r in rows}}
    emit("dryrun", part="card", **line)
    del card
    torch.cuda.empty_cache()
    return line


def phase_dryrun() -> dict:
    """The dry run checked against the card: (a) the production-mesh
    records on the host, (b) five one-card cells counted on meta and run on
    the card (argument bytes held to the allocator's rounding, the kernel
    rows of each path launched).  Returns the launches of (b) by kernel
    row."""
    t_phase = time.perf_counter()
    production = dryrun_production()
    t_production = time.perf_counter() - t_phase
    launches = {}
    cells = []
    for label, arch, shape, variant, rows in DRYRUN_CARD:
        line = dryrun_card_cell(label, arch, shape, variant, rows)
        cells.append(line)
        for r, n in line["launches"].items():
            launches[r] = launches.get(r, 0) + n
    emit("dryrun", part="summary", production_s=t_production,
         production_cells=len(production), card_cells=len(cells),
         launches=launches, card=nvidia_smi_line(),
         seconds=time.perf_counter() - t_phase)
    return launches


# The tuning phase: the tuner's command line and capslint's kernel-legality
# proof held against the card.  The tolerance of each kernel-table row at its
# main path's shape (the registry's example cases carry their own): float32
# routing with the polynomial 1e-4, the float32 softmax and its backward
# 1e-6, bf16 attention 1e-2 against its plain version (the float32 oracle
# rounded to bf16), sampled tokens equal.
TUNING_ATOL = {"fused_routing": 1e-4, "taylor_softmax": 1e-6,
               "taylor_softmax_bwd": 1e-6, "flash_attention": 1e-2,
               "flash_attention_dequant": 1e-2, "decode_attention": 1e-2,
               "decode_attention_dequant": 1e-2,
               "decode_attention_paged": 1e-2,
               "decode_attention_paged_dequant": 1e-2, "fused_sampling": 0,
               "fixed_order_matmul": 4e-2}
TUNING_BUDGET_S = 90


def launch_proven(checker, name: str, case, counts: dict) -> None:
    """Every tuner candidate of ``name`` at ``case`` that kernel-legality
    passes, launched on the card and held against the plain version at the
    case's tolerance.  A candidate the rule passes and the card refuses is
    a fault of the rule."""
    spec = registry.get(name)
    wrapper = spec.build()
    args, kwargs = spec.make_example(case, device=DEVICE)
    plain = PLAIN.get(name)
    want = as_tuple(plain(*args, **kwargs) if plain
                    else spec.ref_call(*args, **kwargs))
    for config, found in checker.prove(spec, args, kwargs):
        counts["candidates"] += 1
        if found:
            counts["flagged"] += 1
            emit("tuning", kernel=name, shape=case_shape(case),
                 config=config, flagged=[f.render() for f in found])
            continue
        counts["proven"] += 1
        try:
            got = as_tuple(wrapper(*args, **kwargs, **config))
            torch.cuda.synchronize()
        except (ValueError, TypeError, build.KernelLaunchError) as err:
            fail(f"tuning: {name} {config} at {case_shape(case)} passed "
                 f"kernel-legality but the card refused it: {err}")
        counts["launched"] += 1
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        if err > case.get("atol", 0):
            fail(f"tuning: {name} {config} at {case_shape(case)}: max abs "
                 f"err {err} > {case.get('atol', 0)}")
        counts["agreed"] += 1


def past_the_limits() -> list:
    """``(label, wrapper, call)`` of configs built just past a shared-memory,
    cluster or block limit; each wrapper must refuse its own with
    ``ValueError`` before it launches."""
    from repro_torch.kernels.attention.kernel import DECODE_MAX_THREADS
    from repro_torch.kernels.limits import MAX_CLUSTER, MAX_DYNAMIC_SMEM
    from repro_torch.kernels.routing.routing_kernel import max_input_capsules
    from repro_torch.kernels.sampling.kernel import sampling_smem_bytes

    out = []
    # routing: the one capsule past what 8 blocks' shared memory holds
    i_max = max_input_capsules(10, 16, 4)
    u_big = torch.zeros((1, i_max + 1, 10, 16), device=DEVICE)
    u = torch.zeros((BATCH, 252, 10, 16), device=DEVICE)
    out += [
        ("routing shared memory", fused_routing_cuda,
         lambda: fused_routing_cuda(u_big, i_splits=MAX_CLUSTER)),
        ("routing cluster", fused_routing_cuda,
         lambda: fused_routing_cuda(u, i_splits=2 * MAX_CLUSTER)),
        ("routing threads", fused_routing_cuda,
         lambda: fused_routing_cuda(u, threads=1056))]
    # decode: the fewest warps past the limit at D 128, float32 cache
    threads = next(t for t in range(32, DECODE_MAX_THREADS + 1, 32)
                   if decode_smem_bytes(128, t, 4, MAX_CLUSTER)
                   > MAX_DYNAMIC_SMEM)
    (q, k, v, valid), _ = registry.get("decode_attention").make_example(
        {"dims": (4, 512, 16, 8, 128), "valid": (512, 100, 1, 333)},
        device=DEVICE)
    out += [
        (f"decode shared memory ({threads} threads)", decode_attention_cuda,
         lambda: decode_attention_cuda(q, k, v, valid, threads=threads,
                                       kv_splits=MAX_CLUSTER)),
        ("decode cluster", decode_attention_cuda,
         lambda: decode_attention_cuda(q, k, v, valid,
                                       kv_splits=2 * MAX_CLUSTER))]
    # sampling: the one logit past what a cluster of 8 blocks holds
    v_max = next(n for n in range(230000, 240000)
                 if sampling_smem_bytes(n + 1, MAX_CLUSTER)
                 > MAX_DYNAMIC_SMEM)
    rows, _ = registry.get("fused_sampling").make_example(
        {"dims": (2, v_max + 1)}, device=DEVICE)
    small, _ = registry.get("fused_sampling").make_example(
        {"dims": (2, 64)}, device=DEVICE)
    out += [
        ("sampling shared memory", fused_sampling_cuda,
         lambda: fused_sampling_cuda(*rows, cluster=MAX_CLUSTER)),
        ("sampling cluster", fused_sampling_cuda,
         lambda: fused_sampling_cuda(*small, cluster=2 * MAX_CLUSTER)),
        ("sampling threads", fused_sampling_cuda,
         lambda: fused_sampling_cuda(*small, threads=1056))]
    # softmax threads; flash rows (G * q_block past 64)
    (x,), _ = registry.get("taylor_softmax").make_example(
        {"shape": (BATCH, 252, 10)}, device=DEVICE)
    (fq, fk, fv), _ = registry.get("flash_attention").make_example(
        {"dims": (1, 128, 128, 4, 4, 64), "dtype": "bfloat16"},
        device=DEVICE)
    out += [
        ("softmax threads", taylor_softmax_cuda,
         lambda: taylor_softmax_cuda(x, threads=1056)),
        ("flash rows", flash_attention_cuda,
         lambda: flash_attention_cuda(fq, fk, fv, q_block=128))]
    return out


# capslint's scaled cases on the card (ROADMAP §C 10).  kernel-legality
# proves every tuner candidate at each example case's variants scaled to the
# configs.SHAPES buckets, on meta.  Each proven scaled case is sorted:
# "launched" where its arguments take at most SCALED_MAX_BYTES and its bound
# (launch/roofline.py KERNEL_WORK) at most SCALED_MAX_BOUND_MS, every
# candidate launched and held against one plain-version output of the case
# at the example case's tolerance; "witnessed" where a launched case ran
# every one of its candidates' plans (kernel instance, threads, cluster,
# shared memory) and each grid lies within the card's own limits
# (cudaDeviceGetAttribute); "unwitnessed" otherwise.  A scaled case's inputs
# are the registry's example made at the scaled shapes (scaled_case, which
# also gives the rows the bound counts: valid lengths clipped to the rows a
# slot holds, sampling rows cycled), drawn anew on the card.
SCALED_MAX_BYTES = 1 << 30
SCALED_MAX_BOUND_MS = 2.0
SCALED_ROW_KEYS = ("valid", "temperature", "top_k", "top_p")
# a plain flash attention's scores past this many bytes run over slices of
# its query rows (rows the kernel does not mix), q_offset carried
PLAIN_SLICE_BYTES = 2 << 30


def scaled_case(case: dict, value: int, bucket: int) -> dict:
    """The registry case whose tensors are ``case``'s with every axis equal
    to ``value`` made ``bucket`` (as kernel-legality scales them): the
    shape tuples substituted, the per-row tuples cycled to the new batch,
    decode's valid lengths clipped to the rows a slot holds."""
    out = dict(case)
    for key in ("dims", "shape", "paged"):
        if key in case:
            out[key] = tuple(bucket if d == value else d for d in case[key])
    b = (out.get("dims") or out.get("shape"))[0]
    for key in SCALED_ROW_KEYS:
        if key in case:
            row = case[key]
            out[key] = tuple(row[i % len(row)] for i in range(b))
    if "valid" in out:
        paged = out.get("paged")
        rows = paged[1] * paged[2] if paged else out["dims"][1]
        out["valid"] = tuple(min(v, rows) for v in out["valid"])
    return out


def arg_bytes(args: tuple, kwargs: dict) -> int:
    return sum(x.numel() * x.element_size()
               for x in list(args) + list(kwargs.values())
               if isinstance(x, torch.Tensor))


def plan_instance(name: str, args: tuple, kwargs: dict, plan: dict) -> tuple:
    """What a launch asks of the card apart from its grid: the kernel
    instance (the kernel, each tensor's type, the first tensor's last axis,
    which kernel-legality never scales (head dim, capsule dim, row or
    vocabulary length), the tensor keywords given (decode's tables and
    scales), the other arguments, decode's chunked instances (the plan's
    ``chunked``), the routing's J) and the plan's threads, cluster and
    shared memory."""
    tensors = [x for x in list(args) + list(kwargs.values())
               if isinstance(x, torch.Tensor)]
    extra = ()
    if name == "decode_attention":
        extra = (plan["chunked"],)
    elif name == "fused_routing":
        extra = (args[0].shape[-2],)
    return (name, tuple(str(x.dtype) for x in tensors), tensors[0].shape[-1],
            tuple(sorted(k for k, v in kwargs.items()
                         if isinstance(v, torch.Tensor))),
            tuple(sorted((k, v) for k, v in kwargs.items()
                         if not isinstance(v, torch.Tensor))), extra,
            plan["threads"], plan["cluster"], plan.get("smem_bytes", 0))


def sort_scaled_cases(grid_limits) -> dict:
    """kernel name -> the proven scaled cases of its spec, in the checker's
    order, each ``{"case", "value", "bucket", "args", "kwargs" (meta),
    "candidates": [(config, plan)], "bytes", "bound_ms", "class"}`` with
    class "launched", "witnessed" or "unwitnessed" (against ``grid_limits``,
    the card's (x, y, z)); and under "refused" the count of scaled cases
    kernel-legality skips (legalize refuses them)."""
    from repro_torch.analysis.checkers.legality import KernelLegalityChecker
    from repro_torch.kernels.registry import registry as kernel_registry
    from repro_torch.launch.roofline import KERNEL_BOUNDS

    checker = KernelLegalityChecker()
    out = {}
    for name in kernel_registry.names():
        spec = kernel_registry.get(name)
        entries, refused = [], 0
        for case, value, bucket, args, kwargs in checker.case_variants(spec):
            if value is None:
                continue
            proven = checker.prove(spec, args, kwargs, example=False)
            if not proven:
                refused += 1
                continue
            if any(found for _, found in proven):
                fail(f"tuning: kernel-legality flags {name} at a scaled "
                     f"case")
            scaled = scaled_case(case, value, bucket)
            t_bytes, t_ops = KERNEL_BOUNDS[name](scaled)
            entries.append({
                "case": case, "value": value, "bucket": bucket,
                "args": args, "kwargs": kwargs,
                "candidates": [(config, spec.launch_plan(dict(config), *args,
                                                         **kwargs))
                               for config, _ in proven],
                "bytes": arg_bytes(args, kwargs),
                "bound_ms": max(t_bytes, t_ops) * 1e3})
        launched = set()
        for e in entries:
            if (e["bytes"] <= SCALED_MAX_BYTES
                    and e["bound_ms"] <= SCALED_MAX_BOUND_MS):
                e["class"] = "launched"
                launched.update(plan_instance(name, e["args"], e["kwargs"],
                                              plan)
                                for _, plan in e["candidates"])
        for e in entries:
            if "class" in e:
                continue
            ok = all(plan_instance(name, e["args"], e["kwargs"], plan)
                     in launched
                     and all(1 <= n <= cap for n, cap in zip(plan["grid"],
                                                             grid_limits))
                     for _, plan in e["candidates"])
            e["class"] = "witnessed" if ok else "unwitnessed"
        out[name] = {"entries": entries, "refused": refused}
    return out


def scaled_inputs(name: str, entry: dict) -> tuple:
    """A scaled case's arguments: the registry's example at the scaled
    shapes (scaled_case), drawn from the case's seed by the generator of the
    device they are made on, so that no axis repeats the example's data.
    Made on meta they are the shapes kernel-legality proved, or the run
    fails."""
    spec = registry.get(name)
    case = dict(scaled_case(entry["case"], entry["value"], entry["bucket"]),
                rng="device")
    args, kwargs = spec.make_example(case, device=DEVICE)
    meta = list(entry["args"]) + [entry["kwargs"][k] for k in sorted(kwargs)]
    made = list(args) + [kwargs[k] for k in sorted(kwargs)]
    if [(tuple(x.shape), x.dtype) for x in made if isinstance(x, torch.Tensor)
        ] != [(tuple(x.shape), x.dtype) for x in meta
              if isinstance(x, torch.Tensor)]:
        fail(f"tuning: {name} scaled case {case_shape(entry['case'])} "
             f"{entry['value']}->{entry['bucket']}: its inputs differ from "
             f"the shapes kernel-legality proved")
    return args, kwargs


def plain_decode(args: tuple, kwargs: dict) -> torch.Tensor:
    """decode_attention_plain with the cache cut to the longest valid
    length (the rows past it are masked in every slot, so the output is
    the same), over slices of its slots where its scores (4 bytes a slot,
    query head and row) would take PLAIN_SLICE_BYTES."""
    q, k, v, valid = args
    tables, ks, vs = (kwargs.get(n) for n in ("tables", "ks", "vs"))
    n = max(1, int(valid.max()))
    if tables is None:
        k, v = k[:, :n], v[:, :n]
        if ks is not None:
            ks, vs = ks[:, :n].contiguous(), vs[:, :n].contiguous()
        rows = k.shape[1]
    else:
        tables = tables[:, :-(-n // k.shape[1])].contiguous()
        rows = tables.shape[1] * k.shape[1]
    step = max(1, PLAIN_SLICE_BYTES // (4 * q.shape[2] * rows))
    outs = []
    for i in range(0, q.shape[0], step):
        j = slice(i, i + step)
        dense = tables is None
        outs.append(decode_attention_plain(
            q[j], k[j] if dense else k, v[j] if dense else v, valid[j],
            tables=None if dense else tables[j],
            ks=None if ks is None else (ks[j] if dense else ks),
            vs=None if vs is None else (vs[j] if dense else vs),
            softmax_mode=kwargs.get("softmax_mode", "exact")))
    return torch.cat(outs, dim=0)


def plain_output(name: str, args: tuple, kwargs: dict) -> tuple:
    """The plain version of ``name`` on a case; flash attention over slices
    of its query rows where its scores would take PLAIN_SLICE_BYTES, decode
    attention through plain_decode."""
    spec = registry.get(name)
    plain = PLAIN.get(name)
    call = ((lambda a: plain(*a, **kwargs)) if plain
            else (lambda a: spec.ref_call(*a, **kwargs)))
    if name == "decode_attention":
        return (plain_decode(args, kwargs),)
    if name not in ("flash_attention", "flash_attention_dequant"):
        return as_tuple(call(args))
    q, k = args[0], args[1]
    b, s, h = q.shape[0], q.shape[1], q.shape[2]
    step = max(1, PLAIN_SLICE_BYTES // (4 * b * h * k.shape[1]))
    if step >= s:
        return as_tuple(call(args))
    off = kwargs.get("q_offset", 0)
    outs = []
    for i in range(0, s, step):
        kw = dict(kwargs, q_offset=off + i)
        a = (q[:, i:i + step].contiguous(),) + tuple(args[1:])
        outs.append(plain(*a, **kw) if plain else spec.ref_call(*a, **kw))
    return (torch.cat(outs, dim=1),)


def oracle64(name: str, args: tuple):
    """A float64 evaluation of the float32 Eq. 2 softmax or its backward on
    a case (their plain versions' formula in float64, rounded once to
    float32), else None.  The formula raises its polynomial to the 32nd
    (31st) power, so float32's own rounding of it grows with the rows a
    case draws, and past the example case's tolerance on fresh data at the
    scaled shapes (the plain version's own error is reported)."""
    from repro_torch.kernels.softmax.ref import (taylor_softmax_bwd_ref,
                                                 taylor_softmax_ref)

    if args[0].dtype != torch.float32:
        return None
    if name == "taylor_softmax":
        return taylor_softmax_ref(*args, dtype=torch.float64)
    if name == "taylor_softmax_bwd":
        return taylor_softmax_bwd_ref(*args, dtype=torch.float64)
    return None


def launch_scaled(name: str, entry: dict, counts: dict) -> None:
    """Every candidate of a "launched" scaled case on the card, each output
    held against one plain-version output of the case at the example
    case's tolerance.  Where a float32 softmax's output lies further off
    its plain version, it must lie within that tolerance of the plain
    version's own error against a float64 evaluation (oracle64): as
    accurate as the plain version, plus the tolerance.  A candidate the
    card refuses fails the run."""
    from repro_torch.analysis.checkers.legality import KernelLegalityChecker

    spec = registry.get(name)
    wrapper = spec.build()
    args, kwargs = scaled_inputs(name, entry)
    proven = KernelLegalityChecker().prove(spec, args, kwargs, example=False)
    if [c for c, _ in proven] != [c for c, _ in entry["candidates"]]:
        fail(f"tuning: {name} scaled case {case_shape(entry['case'])} "
             f"{entry['value']}->{entry['bucket']}: the card's candidates "
             f"differ from those proven on meta")
    want = plain_output(name, args, kwargs)
    atol = entry["case"].get("atol", 0)
    oracle = oracle64(name, args)
    plain_err = (None if oracle is None else
                 float((want[0].double() - oracle).abs().max()))
    if plain_err is not None:
        counts["plain_vs_oracle"] = max(counts["plain_vs_oracle"], plain_err)
    for config, _ in entry["candidates"]:
        try:
            got = as_tuple(wrapper(*args, **kwargs, **config))
            torch.cuda.synchronize()
        except (ValueError, TypeError, build.KernelLaunchError) as err:
            fail(f"tuning: {name} {config} scaled "
                 f"{entry['value']}->{entry['bucket']} "
                 f"({[tuple(a.shape) for a in entry['args']]}) passed "
                 f"kernel-legality but the card refused it: {err}")
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        if not err <= atol:
            got_err = (None if oracle is None else
                       float((got[0].double() - oracle).abs().max()))
            if got_err is None or not got_err <= plain_err + atol:
                fail(f"tuning: {name} {config} scaled "
                     f"{entry['value']}->{entry['bucket']} "
                     f"({[tuple(a.shape) for a in entry['args']]}): max abs "
                     f"err {err} > {atol}; against float64 {got_err}, the "
                     f"plain version's {plain_err}")
            counts["by_oracle"] += 1
            counts["oracle_worst"] = max(counts["oracle_worst"],
                                         got_err - plain_err)
        counts["worst_err"] = max(counts["worst_err"], err)
        counts["launches"] += 1
    del args, kwargs, want, oracle


# Cases at the grid edges that the flattened flash grid moved: the
# tensor-core body at 524288 query positions and q_block 8 (65536 q tiles:
# the old grid's y axis held 65535), non-causal over a short cache; the FMA
# body with B * K = 131072 (the old grid's y axis).
GRID_EDGE_CASES = (
    ("flash_attention", {"dims": (1, 524288, 64, 8, 1, 64),
                         "dtype": "bfloat16", "causal": False,
                         "atol": 1e-2}, {"q_block": 8}),
    ("flash_attention", {"dims": (512, 16, 16, 256, 256, 16),
                         "causal": True, "atol": 2e-5}, {}),
)
# Flash groups of more than 64 query heads a KV head, dealt to chunks
# (flash_head_chunks): 96 heads in two blocks of 48 (tensor cores), 67 (a
# prime) in 67 blocks of one (FMA, with a q_offset), 128 over an int8 cache
# in two blocks of 64.
FLASH_GROUP_CASES = (
    ("flash_attention", {"dims": (2, 100, 160, 96, 1, 64),
                         "dtype": "bfloat16", "atol": 1e-2}, {}),
    ("flash_attention", {"dims": (1, 70, 90, 134, 2, 32), "q_offset": 20,
                         "atol": 2e-5}, {}),
    ("flash_attention_dequant", {"dims": (1, 33, 64, 128, 1, 32),
                                 "dtype": "bfloat16", "atol": 1e-2}, {}),
)


def grid_edges(grid_limits) -> list:
    """GRID_EDGE_CASES and FLASH_GROUP_CASES launched (bf16 against its
    plain version rounded to bf16) with each grid beside the card's
    limits."""
    out = []
    for name, case, over in GRID_EDGE_CASES + FLASH_GROUP_CASES:
        spec = registry.get(name)
        args, kwargs = spec.make_example(case, device=DEVICE)
        config = {**registry.default_config(name, *args, **kwargs), **over}
        plan = spec.launch_plan(dict(config), *args, **kwargs)
        n = spec.build().launches
        try:
            got = spec.build()(*args, **kwargs, **config)
            torch.cuda.synchronize()
        except (ValueError, build.KernelLaunchError) as err:
            fail(f"tuning: grid edge {case_shape(case)} {config} refused: "
                 f"{err}")
        (want,) = plain_output(name, args, kwargs)
        err = float((got.float() - want.float()).abs().max())
        if spec.build().launches != n + 1:
            fail(f"tuning: grid edge {case_shape(case)} {config}: "
                 f"{spec.build().launches - n} launches, not 1")
        if not err <= case["atol"]:
            fail(f"tuning: grid edge {case_shape(case)} {config}: max abs "
                 f"err {err} > {case['atol']}")
        out.append({"kernel": name, "shape": case_shape(case),
                    "dtype": case.get("dtype", "float32"), "config": config,
                    "grid": plan["grid"],
                    "card_grid_limits": list(grid_limits),
                    "max_abs_err": err})
        emit("tuning", part="grid_edge", **out[-1])
        del args, got, want
    return out


def scaled_on_the_card() -> dict:
    """Every proven scaled case sorted (sort_scaled_cases) and each
    "launched" one run (launch_scaled); per spec the counts of launched,
    witnessed, unwitnessed and refused cases; each unwitnessed case printed
    with its plans."""
    limits = build.device_grid_limits(torch.cuda.current_device())
    t0 = time.perf_counter()
    sorted_cases = sort_scaled_cases(limits)
    t_sort = time.perf_counter() - t0
    summary = {}
    for name, got in sorted_cases.items():
        counts = {"launches": 0, "worst_err": 0.0, "by_oracle": 0,
                  "oracle_worst": 0.0, "plain_vs_oracle": 0.0}
        classes = dict.fromkeys(("launched", "witnessed", "unwitnessed"), 0)
        for e in got["entries"]:
            classes[e["class"]] += 1
            if e["class"] == "launched":
                launch_scaled(name, e, counts)
            elif e["class"] == "unwitnessed":
                emit("tuning", part="unwitnessed", kernel=name,
                     shapes=[list(a.shape) for a in e["args"]
                             if isinstance(a, torch.Tensor)],
                     scaled=[e["value"], e["bucket"]], gib=e["bytes"] / 2**30,
                     bound_ms=e["bound_ms"],
                     plans=[{"config": c, **p} for c, p in e["candidates"]])
        torch.cuda.empty_cache()
        summary[name] = {**classes, "refused": got["refused"],
                         "candidate_launches": counts["launches"],
                         "worst_err": counts["worst_err"],
                         "held_by_oracle": counts["by_oracle"],
                         "oracle_worst_over_plain": counts["oracle_worst"],
                         "plain_worst_vs_oracle": counts["plain_vs_oracle"]}
        emit("tuning", part="scaled", kernel=name, **summary[name])
    return {"card_grid_limits": list(limits), "sort_seconds": t_sort,
            "max_bytes": SCALED_MAX_BYTES,
            "max_bound_ms": SCALED_MAX_BOUND_MS, "by_spec": summary}


def spec_cases(name: str, main_cases: list) -> list:
    """The registry's example cases of ``name`` and the main-path cases of
    the kernel-table rows it serves."""
    spec = registry.get(name)
    return (list(spec.example_cases)
            + [case for _, kernel, case in main_cases if kernel == name])


def phase_tuning() -> dict:
    """The tuner's command line and capslint's static proof on the card,
    with the tuning cache in a temporary directory (serve_tuned keeps its
    own): (1) ``--selfcheck``: every spec's example cases through
    ``tune=False`` dispatch agree with their plain versions; (2) every
    candidate kernel-legality proves legal, at the example cases and each
    row's main-path shape, launches and agrees with its plain version;
    configs built just past each limit are refused before launch; (2b) the
    scaled cases (scaled_on_the_card) and the flash grid's edges
    (grid_edges); (3) ``--pretune all``, then each row at its main-path
    shape autotuned, its default and winning configs timed as
    phase_timings times (CUDA events, back to back)."""
    from repro_torch.kernels import tuning

    t_phase = time.perf_counter()
    before = os.environ.get(tuning.CACHE_ENV)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as cache_dir:
        os.environ[tuning.CACHE_ENV] = cache_dir
        try:
            counts, refused, rows, t_selfcheck, scaled = _tune_on_the_card(
                t_phase)
        finally:
            if before is None:
                os.environ.pop(tuning.CACHE_ENV, None)
            else:
                os.environ[tuning.CACHE_ENV] = before
    seconds = time.perf_counter() - t_phase
    emit("tuning", selfcheck_seconds=t_selfcheck, card=nvidia_smi_line(),
         clocks=clocks_line(), seconds=seconds)
    if seconds > TUNING_BUDGET_S:
        fail(f"tuning: {seconds:.1f} s, over its {TUNING_BUDGET_S} s budget")
    moved = [r for r in rows if r["tuned"] != r["default"]]
    m2 = {"rows": len(rows), "winner_not_default": len(moved),
          "separated": sum(r["tuner_separated"] for r in moved),
          "tuner_spread_max": max(r["tuner_spread_max"] for r in rows),
          "retimed_over_default": [min(r["tuned_over_default"] for r in rows),
                                   max(r["tuned_over_default"] for r in rows)]}
    emit("tuning", part="m2", **m2)
    return {"counts": counts, "refused": len(refused), "rows": rows,
            "scaled": scaled, "m2": m2}


def _tune_on_the_card(t_phase: float):
    """The three steps of :func:`phase_tuning`, in its cache directory;
    returns the legality counts, the refusals, the autotune rows and the
    selfcheck's seconds."""
    from repro_torch.analysis.checkers.legality import KernelLegalityChecker
    from repro_torch.kernels import tuning

    # (1) the selfcheck, in-process through the command line
    if tuning.main(["--selfcheck", "--device", DEVICE]) != 0:
        fail("tuning: --selfcheck failed on the card")
    t_selfcheck = time.perf_counter() - t_phase
    # (2) the static proof held against the card
    checker = KernelLegalityChecker()
    counts = dict.fromkeys(("candidates", "proven", "flagged", "launched",
                            "agreed"), 0)
    main_cases = [(row, kernel, dict(case, atol=TUNING_ATOL[row]))
                  for row, kernel, case in main_path_cases()]
    for name in registry.names():
        for case in spec_cases(name, main_cases):
            launch_proven(checker, name, case, counts)
    refused = {}
    for label, wrapper, call in past_the_limits():
        n = wrapper.launches
        try:
            call()
        except ValueError as err:
            refused[label] = str(err)
        else:
            fail(f"tuning: {label}: a config past the limit launched")
        if wrapper.launches != n:
            fail(f"tuning: {label}: launched before it was refused")
    emit("tuning", part="legality", **counts, refused=len(refused),
         refusals=refused)
    if counts["flagged"] or counts["agreed"] != counts["candidates"]:
        fail(f"tuning: kernel-legality flagged a registry candidate on "
             f"the card: {counts}")
    # (2b) the scaled cases (ROADMAP §C 10) and the grid edges
    scaled = scaled_on_the_card()
    scaled["grid_edges"] = grid_edges(scaled["card_grid_limits"])
    # (3) the first measured autotune
    if tuning.main(["--pretune", "all", "--device", DEVICE]) != 0:
        fail("tuning: --pretune all failed on the card")
    rows = []
    for row, name, case in main_cases:
        spec = registry.get(name)
        if not spec.tuned:
            continue                    # nothing to tune (the GEMM)
        wrapper = spec.build()
        args, kwargs = spec.make_example(case, device=DEVICE)
        default = registry.default_config(name, *args, **kwargs)
        repeats = []
        best, timings = tuning.autotune(spec, args, kwargs,
                                        timer=recording_timer(repeats))
        default_ms = median_ms(lambda: wrapper(*args, **kwargs, **default))
        tuned_ms = median_ms(lambda: wrapper(*args, **kwargs, **best))
        rows.append({"row": row, "shape": case_shape(case),
                     "default": default, "default_ms": default_ms,
                     "tuned": best, "tuned_ms": tuned_ms,
                     "tuned_over_default": tuned_ms / default_ms,
                     "tuner_ms": {k: t * 1e3 for k, t in timings.items()},
                     **tuner_spread(timings, repeats, default, best)})
        emit("tuning", part="autotune", **rows[-1])
    return counts, refused, rows, t_selfcheck, scaled


def recording_timer(record: list):
    """An autotune ``timer`` that times as the tuner does
    (``tuning.repeat_times``) and appends each candidate's repeats, in the
    tuner's order, to ``record``."""
    from repro_torch.kernels import tuning

    def timer(fn, warmup, iters):
        times = tuning.repeat_times(fn, warmup=warmup, iters=iters)
        record.append(times)
        return times[len(times) // 2]

    return timer


def tuner_spread(timings: dict, repeats: list, default: dict,
                 best: dict) -> dict:
    """The tuner's own noise beside the gaps it picks by: each candidate's
    repeat-to-repeat spread ((slowest - fastest) / median of its repeats),
    the largest of them, the default's time over the winner's in the
    tuner's medians, and whether the two are separated (the winner's
    slowest repeat faster than the default's fastest)."""
    from repro_torch.kernels import tuning

    by_label = dict(zip(timings, repeats))
    spread = {k: (t[-1] - t[0]) / t[len(t) // 2] for k, t in by_label.items()}
    d, w = (by_label.get(tuning.config_label(c)) for c in (default, best))
    if d is None or w is None:
        fail(f"tuning: the default {default} or the winner {best} is not "
             f"among the tuner's candidates {list(timings)}")
    return {"tuner_spread": spread, "tuner_spread_max": max(spread.values()),
            "tuner_default_over_winner": d[len(d) // 2] / w[len(w) // 2],
            "tuner_separated": best != default and w[-1] < d[0]}


# serve_tuned (ROADMAP §C 9): both engines served through tuned kernel
# configs, each in a fresh REPRO_TORCH_KERNEL_CACHE_DIR of its own.  The
# pruned CapsNet through CapsuleEngine(kernel_tune=True) (its warm-up tunes
# fused_routing for every batch shape the scheduler emits) against the
# untuned engine on the same images; full-width llama3.2-1b through
# ServeEngine(kernel_tune=True, decode_kernel=True, attn_impl "cuda"):
# prefill tunes flash attention per admission bucket
# (_maybe_tune_prefill, outside the tick wall), decode tunes on the spot
# inside the tick that first meets a shape (the registry's cache miss, as
# in the reference); sampling dispatches with tune=False, as the
# reference's engine does.  Then a planted cache: every key those serves
# tuned maps to the first proven candidate that is not the default, both
# models served through it (every resolved config must equal the planted
# one, and nothing is tuned); then the launcher twice on one cache.
SERVE_TUNED_IMAGE_REQUESTS = 8
SERVE_TUNED_LM_REQUESTS = 4
TUNED_LAUNCHER_ARGS = ("--arch", "capsnet-mnist", "--no-reduced",
                       "--routing", "cuda", "--kernel-tune")


class TuneWatch:
    """Within its scope, every measured autotune (kernel, cache key,
    arguments, winner, timings, seconds) and every config the registry
    resolves with tuning on for arguments on the card (kernel, cache key,
    config; kernels with tunables) are recorded."""

    def __init__(self):
        self.autotunes, self.resolved = [], []

    def __enter__(self):
        from repro_torch.kernels import tuning

        inner_tune, inner_resolve = tuning.autotune, registry.resolve_config

        def autotune(spec, args, kwargs=None, cache=None, **kw):
            t0 = time.perf_counter()
            best, timings = inner_tune(spec, args, kwargs, cache=cache, **kw)
            self.autotunes.append({
                "name": spec.name, "key": tuning.cache_key_for(spec, args),
                "args": args, "kwargs": dict(kwargs or {}), "best": best,
                "timings": timings, "seconds": time.perf_counter() - t0})
            return best, timings

        def resolve(name, *args, overrides=None, tune=None, **kwargs):
            config = inner_resolve(name, *args, overrides=overrides,
                                   tune=tune, **kwargs)
            # a kernel without tunables (the GEMM) is never looked up
            if ((tune if tune is not None else tuning.tune_enabled())
                    and registry.get(name).tuned
                    and tuning.backend_of(args) == "cuda"):
                self.resolved.append((name, tuning.cache_key_for(
                    registry.get(name), args), dict(config)))
            return config

        self._inner = inner_tune
        tuning.autotune, registry.resolve_config = autotune, resolve
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import tuning

        tuning.autotune = self._inner
        del registry.resolve_config           # the class's method again


def use_cache_dir(path: str) -> None:
    from repro_torch.kernels import tuning

    os.environ[tuning.CACHE_ENV] = path
    tuning.default_cache().clear_memory()


def serve_images(deployed, requests, kernel_tune=None) -> tuple:
    """``requests`` through a fresh CapsuleEngine (warm-up first: with
    kernel_tune its _pretune); (completions by rid, routing launches)."""
    engine = deployed.serve(batch_size=BATCH, kernel_tune=kernel_tune)
    engine.warmup()
    reset_counts()
    done = engine.serve([ImageRequest(images=r.images, rid=r.rid)
                         for r in requests])
    if len(done) != len(requests):
        fail(f"serve_tuned: {len(done)} of {len(requests)} image requests "
             f"completed")
    return {c.rid: c for c in done}, fused_routing_cuda.launches


def hold_images(label: str, got: dict, want: dict) -> float:
    """Classes identical, lengths (|v| of each class capsule) within
    TUNING_ATOL["fused_routing"]; returns the largest difference."""
    err = 0.0
    for rid, c in want.items():
        if not np.array_equal(got[rid].classes, c.classes):
            fail(f"serve_tuned ({label}): rid {rid} classes differ from "
                 f"the untuned engine's")
        err = max(err, float(np.abs(got[rid].lengths - c.lengths).max()))
    if not err <= TUNING_ATOL["fused_routing"]:
        fail(f"serve_tuned ({label}): lengths differ by {err} > "
             f"{TUNING_ATOL['fused_routing']} from the untuned engine's")
    return err


def tuned_schedules(cfg, params, reqs) -> dict:
    """ROADMAP §C Open 2: serve_tuned's requests, every one sampled (seed
    2000 + rid), through kernel_tune=True engines of LM_SLOTS and of
    OTHER_SLOTS slots on the phase's tune cache: the sampling contract
    between the two schedules (compare_seeded: tokens and logits rows)
    and the decode configs each engine resolved (TuneWatch), which must
    be the same launch plans (the tuned config is keyed without the
    batch)."""
    seeded = [dataclasses.replace(r, prompt=list(r.prompt), temperature=0.8,
                                  top_k=50, top_p=0.9, seed=2000 + r.rid)
              for r in reqs]
    runs, plans = {}, {}
    for n in (LM_SLOTS, OTHER_SLOTS):
        eng = ServeEngine(cfg, params, n_slots=n, max_len=LM_MAX_LEN,
                          decode_kernel=True, kernel_tune=True, device=DEVICE)
        rows = {}
        with TuneWatch() as watch:
            tok = serve_seeded(eng, seeded, rows)
        runs[n] = (tok, rows)
        plans[n] = sorted({(key, json.dumps(c, sort_keys=True))
                           for name, key, c in watch.resolved
                           if name == "decode_attention"})
        del eng
    numbers, _ = compare_seeded(
        f"serve_tuned ({OTHER_SLOTS} slots against {LM_SLOTS})", seeded,
        runs[LM_SLOTS], runs[OTHER_SLOTS])
    configs = {n: sorted({c for _, c in p}) for n, p in plans.items()}
    if configs[LM_SLOTS] != configs[OTHER_SLOTS]:
        fail(f"serve_tuned: the tuned decode plans follow the batch: "
             f"{configs}")
    numbers["decode_keys"] = {str(n): [k for k, _ in p]
                              for n, p in plans.items()}
    numbers["decode_configs"] = {str(n): [json.loads(c) for c in cs]
                                 for n, cs in configs.items()}
    return numbers


def serve_lm_tuned(label: str, cfg, params, reqs, tok_ref, margins) -> tuple:
    """``reqs`` twice through a fresh ServeEngine(kernel_tune=True) with the
    kernels: greedy tokens held against the untuned engine's (``tok_ref``,
    whose margins are ``margins``) by MARGIN_RULE, seeded ones bit-identical
    between the two serves.  Returns (numbers, launches of the first
    serve)."""
    eng = ServeEngine(cfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      decode_kernel=True, kernel_tune=True, device=DEVICE)
    reset_counts()
    done = eng.serve(fresh(reqs))
    counts = launch_counts()
    first = eng.stats()
    again = eng.serve(fresh(reqs))
    both = eng.stats()
    if len(done) != len(reqs) or len(again) != len(reqs):
        fail(f"serve_tuned ({label}): {len(done)}, {len(again)} of "
             f"{len(reqs)} requests completed")
    check_prefill_bodies(f"serve_tuned ({label})", counts)
    tok = {c.rid: c.tokens for c in done}
    compared, ambiguous, first_diff = compare_with_plain(
        f"serve_tuned ({label})", reqs, tok, tok_ref,
        {c.rid: c.tokens for c in again}, margins, cfg.vocab)
    second_wall = both.wall_s - first.wall_s
    numbers = {
        "greedy_tokens_compared": compared, "ambiguous_positions": ambiguous,
        "first_divergence": first_diff, "seeded_bit_identical": True,
        "seeded_equal_untuned": sum(
            1 for r in reqs if r.temperature > 0
            and tok[r.rid] == tok_ref[r.rid]),
        "greedy_sequences_equal_untuned": sum(
            1 for r in reqs if r.temperature == 0
            and tok[r.rid] == tok_ref[r.rid]),
        "ticks": first.ticks, "new_tokens": first.items,
        "tick_wall_s": first.wall_s,
        "second_serve_tok_per_s": (both.items - first.items) / second_wall}
    launches = {"flash_attention": counts["flash_attention"],
                "decode_attention": counts["dense"],
                "fused_sampling": counts["fused_sampling"]}
    if min(launches.values()) < 1:
        fail(f"serve_tuned ({label}): launches {launches}")
    return numbers, launches


def planted_configs(autotunes: list) -> dict:
    """Cache key -> the first candidate of its autotune's arguments, in the
    tuner's order, that kernel-legality proves and that is not the default
    (the default where no other candidate exists)."""
    from repro_torch.analysis.checkers.legality import KernelLegalityChecker

    checker = KernelLegalityChecker()
    planted = {}
    for a in autotunes:
        spec = registry.get(a["name"])
        default = registry.default_config(a["name"], *a["args"], **a["kwargs"])
        proven = [c for c, found in checker.prove(spec, a["args"],
                                                  a["kwargs"]) if not found]
        planted[a["key"]] = next((c for c in proven if c != default),
                                 default)
    return planted


def run_tuned_launcher(cache_dir: str) -> dict:
    """The launcher with TUNED_LAUNCHER_ARGS on ``cache_dir``: its exit, the
    cache file's bytes and modification time after it."""
    env = dict(port_env(), **{"REPRO_TORCH_KERNEL_CACHE_DIR": cache_dir})
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve",
         *TUNED_LAUNCHER_ARGS], env=env, capture_output=True, text=True,
        timeout=600)
    if res.returncode != 0 or "rid=0:" not in res.stdout:
        fail(f"serve_tuned: launcher {' '.join(TUNED_LAUNCHER_ARGS)} exit "
             f"{res.returncode}: {(res.stdout + res.stderr)[-2000:]}")
    path = os.path.join(cache_dir, "autotune.json")
    if not os.path.exists(path):
        fail(f"serve_tuned: the tuned launcher wrote no cache at {path}")
    with open(path, "rb") as f:
        blob = f.read()
    return {"seconds": time.perf_counter() - t0, "bytes": blob,
            "mtime_ns": os.stat(path).st_mtime_ns,
            "keys": sorted(json.loads(blob)["entries"]),
            "last_line": res.stdout.strip().splitlines()[-1][:200]}


def phase_serve_tuned() -> dict:
    """ROADMAP §C 9 on the card (see the comment above
    SERVE_TUNED_IMAGE_REQUESTS)."""
    from repro_torch.kernels import tuning

    t_phase = time.perf_counter()
    before = os.environ.get(tuning.CACHE_ENV)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_tuned_")
    try:
        out = _serve_tuned(root)
    finally:
        if before is None:
            os.environ.pop(tuning.CACHE_ENV, None)
        else:
            os.environ[tuning.CACHE_ENV] = before
        tuning.default_cache().clear_memory()
        shutil.rmtree(root, ignore_errors=True)
    emit("serve_tuned", card=nvidia_smi_line(), clocks=clocks_line(),
         seconds=time.perf_counter() - t_phase)
    return out


def _serve_tuned(root: str) -> dict:
    from repro_torch.kernels import tuning

    launches = {}

    def add(got: dict) -> None:
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    use_cache_dir(os.path.join(root, "tuned"))
    # the CapsNet, untuned then tuned
    cfg = cfg_lib.get_config("capsnet-mnist")
    pipe = FastCapsPipeline(cfg, device=DEVICE).build(seed=0)
    pipe.prune(0.6, 0.9, type_keep=7).compact()
    deployed = pipe.compile(routing="cuda")
    images = make_requests(SERVE_TUNED_IMAGE_REQUESTS, deployed.cfg)
    want, _ = serve_images(deployed, images)
    with TuneWatch() as caps:
        got, n_routing = serve_images(deployed, images, kernel_tune=True)
    caps_err = hold_images("tuned", got, want)
    if not caps.autotunes or n_routing < 1:
        fail(f"serve_tuned: the tuned CapsuleEngine tuned "
             f"{len(caps.autotunes)} shapes and launched routing "
             f"{n_routing} times")
    add({"fused_routing": n_routing})
    # llama3.2-1b: the untuned kernel engine's tokens and margins, then tuned
    lm_cfg, params, _, n_params = init_lm()
    reqs = lm_requests(lm_cfg.vocab, SERVE_TUNED_LM_REQUESTS)
    untuned = ServeEngine(lm_cfg, params, n_slots=LM_SLOTS,
                          max_len=LM_MAX_LEN, decode_kernel=True,
                          device=DEVICE)
    tok_ref, margins = kernel_margins_of(untuned, reqs)
    del untuned
    with TuneWatch() as lm_watch:
        lm_numbers, got_launches = serve_lm_tuned(
            "tuned", lm_cfg, params, reqs, tok_ref, margins)
    add(got_launches)
    tuned_kernels = {a["name"] for a in lm_watch.autotunes}
    if not {"flash_attention", "decode_attention"} <= tuned_kernels:
        fail(f"serve_tuned: the tuned LM serve tuned {tuned_kernels}")
    decode_s = sum(a["seconds"] for a in lm_watch.autotunes
                   if a["name"] == "decode_attention")
    lm_numbers["decode_autotune_s_in_tick_wall"] = decode_s
    lm_numbers["prefill_autotune_s_outside_tick_wall"] = sum(
        a["seconds"] for a in lm_watch.autotunes
        if a["name"] == "flash_attention")
    lm_numbers["tok_per_s_without_autotune"] = lm_numbers["new_tokens"] / (
        lm_numbers["tick_wall_s"] - decode_s)
    lm_numbers["schedules"] = tuned_schedules(lm_cfg, params, reqs)
    # each tuned key's default and winner, back to back (M2)
    record = []
    for a in caps.autotunes + lm_watch.autotunes:
        wrapper = registry.get(a["name"]).build()
        default = registry.default_config(a["name"], *a["args"], **a["kwargs"])
        default_ms = median_ms(lambda: wrapper(*a["args"], **a["kwargs"],
                                               **default))
        best_ms = median_ms(lambda: wrapper(*a["args"], **a["kwargs"],
                                            **a["best"]))
        record.append({"kernel": a["name"], "key": a["key"],
                       "default": default, "default_ms": default_ms,
                       "winner": a["best"], "winner_ms": best_ms,
                       "winner_over_default": best_ms / default_ms,
                       "autotune_s": a["seconds"]})
    emit("serve_tuned", part="tuned",
         reduced=[f"LM requests 8 -> {SERVE_TUNED_LM_REQUESTS}"], capsnet={
        "requests": len(images), "frames": sum(len(r.images) for r in images),
        "max_abs_err_lengths": caps_err, "classes_identical": True,
        "tuned_keys": [a["key"] for a in caps.autotunes]},
        lm={"arch": LM_ARCH, "params": n_params, "requests": len(reqs),
            **lm_numbers}, record=record)
    # the planted cache
    planted = planted_configs(caps.autotunes + lm_watch.autotunes)
    planted_dir = os.path.join(root, "planted")
    cache = tuning.TuneCache(os.path.join(planted_dir, "autotune.json"))
    for key, config in planted.items():
        cache.put(key, config, {})
    use_cache_dir(planted_dir)
    with TuneWatch() as watch:
        got, n_routing = serve_images(deployed, images, kernel_tune=True)
        planted_lm, got_launches = serve_lm_tuned(
            "planted", lm_cfg, params, reqs, tok_ref, margins)
    planted_err = hold_images("planted", got, want)
    add({"fused_routing": n_routing})
    add(got_launches)
    if watch.autotunes:
        fail(f"serve_tuned: the planted cache's serves tuned "
             f"{[a['key'] for a in watch.autotunes]}")
    seen = {}
    for name, key, config in watch.resolved:
        if planted.get(key) != config:
            fail(f"serve_tuned: {name} resolved {config} at {key}, planted "
                 f"{planted.get(key)}")
        seen[key] = seen.get(key, 0) + 1
    if set(seen) != set(planted):
        fail(f"serve_tuned: planted keys never resolved: "
             f"{sorted(set(planted) - set(seen))}")
    emit("serve_tuned", part="planted", planted={
        k: {"config": c, "resolutions": seen[k]} for k, c in planted.items()},
        non_default=sum(1 for a in caps.autotunes + lm_watch.autotunes
                        if planted[a["key"]] != registry.default_config(
                            a["name"], *a["args"], **a["kwargs"])),
        capsnet_max_abs_err_lengths=planted_err, lm=planted_lm)
    del params, caps, lm_watch, watch
    torch.cuda.empty_cache()
    # the launcher twice on one fresh cache directory
    launcher_dir = os.path.join(root, "launcher")
    first = run_tuned_launcher(launcher_dir)
    second = run_tuned_launcher(launcher_dir)
    if (second["bytes"] != first["bytes"]
            or second["mtime_ns"] != first["mtime_ns"]):
        fail("serve_tuned: the launcher's second --kernel-tune run changed "
             "the cache its first wrote (it tuned again)")
    emit("serve_tuned", part="launcher", args=list(TUNED_LAUNCHER_ARGS),
         keys=first["keys"], first_s=first["seconds"],
         second_s=second["seconds"], cache_unchanged=True,
         last_line=second["last_line"])
    return launches


def timed(phase: str, fn, *args):
    """``fn(*args)``, then the phase's own line of seconds, with the CUDA
    graphs the phase captured, re-captured and replayed, its eager runs of
    graph call sites and its capture seconds."""
    t0 = time.perf_counter()
    before = graph_totals()
    out = fn(*args)
    emit(phase, part="seconds", seconds=time.perf_counter() - t0,
         graphs=totals_since(before), card=nvidia_smi_line())
    return out


def main() -> None:
    if len(sys.argv) > 1:
        sys.exit("chip_smoke takes no arguments")
    t0 = time.perf_counter()
    smi = timed("device", phase_device)
    timed("build", phase_build)
    worst, dequant_launches, by_case = timed("kernels", phase_kernels)
    launches = timed("serve_pruned", phase_serve, "serve_pruned", True, 8)
    launches_dense = timed("serve_dense", phase_serve, "serve_dense", False,
                           4)
    launches_train = timed("train_capsnet", phase_train_capsnet)
    launches_train_lm = timed("train_lm", phase_train_lm)
    launches_train_family = timed("train_family", phase_train_family)
    launches_lm = timed("serve_lm", phase_serve_lm)
    launches_paged = timed("serve_paged", phase_serve_paged)
    launches_disagg = timed("serve_disagg", phase_serve_disagg)
    launches_moe = timed("serve_moe", phase_serve_moe)
    launches_vlm = timed("serve_vlm", phase_serve_vlm)
    launches_qwen3 = timed("serve_qwen3", phase_serve_qwen3)
    launches_large = timed("serve_large", phase_serve_large)
    launches_ssm = timed("serve_ssm", phase_serve_ssm)
    launches_hybrid = timed("serve_hybrid", phase_serve_hybrid)
    launches_audio = timed("encode_audio", phase_encode_audio)
    launches_sharded = timed("serve_sharded", phase_serve_sharded)
    launches_dryrun = timed("dryrun", phase_dryrun)
    timed("tuning", phase_tuning)
    launches_tuned = timed("serve_tuned", phase_serve_tuned)
    # the rows each new phase must launch: ssm samples, the hybrid also runs
    # flash and decode attention in its shared block, audio runs flash;
    # qwen3 and each large model prefill, decode in each of their cache
    # modes' bodies and sample
    served = ("flash_attention", "decode_attention", "fused_sampling")
    for phase, got, rows in (
            ("ssm", launches_ssm, ("fused_sampling",)),
            ("hybrid", launches_hybrid, served),
            ("audio", launches_audio, ("flash_attention",)),
            ("qwen3", launches_qwen3, served + (
                "decode_attention_paged", "decode_attention_paged_dequant")),
            *((f"large ({arch})", launches_large[arch], served + tuple(
                DECODE_ROWS[m] for m in modes if m != "dense"))
              for arch, modes in LARGE_MODES)):
        missing = [r for r in rows if got.get(r, 0) < 1]
        if missing:
            fail(f"serve_{phase}: {missing} never launched on its path")
    later = {"train": launches_train, "train_lm": launches_train_lm,
             "train_family": launches_train_family,
             "paged": launches_paged,
             "disagg": launches_disagg, "moe": launches_moe,
             "vlm": launches_vlm, "qwen3": launches_qwen3,
             **{f"large {arch}": got for arch, got in launches_large.items()},
             "ssm": launches_ssm,
             "hybrid": launches_hybrid, "audio": launches_audio,
             "sharded": launches_sharded, "dryrun": launches_dryrun,
             "serve_tuned": launches_tuned}
    for name, n in {**launches, **{f"{k} (dense)": v
                                   for k, v in launches_dense.items()},
                    **launches_lm,
                    **{f"{k} ({tag})": v for tag, got in later.items()
                       for k, v in got.items()}}.items():
        if n < 1:
            fail(f"{name} was never launched on its path")
    for k, n in (list(launches_lm.items())
                 + [kv for got in later.values() for kv in got.items()]):
        launches[k] = launches.get(k, 0) + n
    # no model path calls flash_attention_dequant: its row counts the
    # kernel phase's launches
    launches["flash_attention_dequant"] = dequant_launches
    missing = [k for k in KERNELS if launches.get(k, 0) < 1]
    if missing:
        fail(f"no launches counted for {missing}")
    table = timed("timings", phase_timings, launches, worst, by_case,
                  {QWEN3_ARCH: launches_qwen3, **launches_large})
    emit("done", seconds=time.perf_counter() - t0, traces=TRACES,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
