#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA GPU (written for an H100, ``sm_90a``) and the CUDA toolkit;
takes no arguments.  It builds the port's CUDA kernels from
``src/repro_torch/csrc``, holds every kernel against its plain PyTorch
version on the card, serves a LAKP-pruned and a dense full-width
``capsnet-mnist`` through ``CapsuleEngine`` with the routing in the
hand-written kernel, trains a full-width ``capsnet-mnist`` on the card and
carries it through the paper's Fig. 6 pipeline (LAKP prune, masked
fine-tune, compact, deploy through the routing and softmax kernels, serve
the test set; with a save / crash / resume check and a save / reload of the
deployed model), serves a full-width ``llama3.2-1b`` (random weights,
seed 0) through ``ServeEngine`` with prefill attention, decode attention and
sampling in the hand-written kernels, serves it again from the paged KV
cache (bf16 pages, then int8 pages, with a shared prompt prefix) with
decode reading the pages in place through the paged decode kernels, holds
the int8 dense-cache decode kernel against the paged one on the same pool,
and times the nine kernels (routing also at the dense shape; routing,
softmax, decode and sampling at every point of their tunables' spaces:
``i_splits`` and threads, threads, ``kv_splits`` and threads, the cluster
size and threads; and sampling on a served decode tick's logits).  One JSON
object per phase goes to standard output; the last three lines are the
kernel table, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.  Any failed phase ends
the script with a non-zero exit code and no result line.  With no CUDA
device it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
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
from repro_torch.checkpointing import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.core import capsnet, pruning  # noqa: E402
from repro_torch.data import synthetic_digits as sd  # noqa: E402
from repro_torch.deploy import FastCapsPipeline, RoutingSpec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.attention.kernel import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain, flash_attention_cuda,
    flash_attention_dequant_cuda, flash_attention_dequant_plain,
    flash_attention_plain)
from repro_torch.kernels.registry import registry  # noqa: E402
from repro_torch.kernels.routing.routing_kernel import (  # noqa: E402
    fused_routing_cuda, routing_smem_bytes)
from repro_torch.kernels.sampling.kernel import fused_sampling_cuda  # noqa: E402
from repro_torch.kernels.softmax.kernel import taylor_softmax_cuda  # noqa: E402
from repro_torch.launch.train import accuracy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serving import ImageRequest, Request, ServeEngine  # noqa: E402
from repro_torch.training import Trainer, TrainerConfig  # noqa: E402
from repro_torch.training.trainer import make_train_step  # noqa: E402

DEVICE = "cuda"
BATCH = 32
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM, bf16 tensor cores, dense

WRAPPERS = {"fused_routing": fused_routing_cuda,
            "taylor_softmax": taylor_softmax_cuda,
            "flash_attention": flash_attention_cuda,
            "flash_attention_dequant": flash_attention_dequant_cuda,
            "decode_attention": decode_attention_cuda,
            "fused_sampling": fused_sampling_cuda}

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
# first position whose top-2 logit margin (on the plain path) is below this:
# logits are bf16 products (about |45| at this width, where a bf16 step is
# 0.25) after 16 layers whose attention sums run in another order on the two
# paths, so margins under four steps may flip.
LM_MARGIN = 1.0

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

# The paged serving path (phase serve_paged): the same model, engine width
# and cache length, pages of 16 rows in the default pool of 8 x 1024 / 16 =
# 512 pages; 16 requests of which 8 share a 256-token (16-page) prefix.
PAGE = 16
N_PAGES = LM_SLOTS * LM_MAX_LEN // PAGE
SHARED_PREFIX = 256
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
SPLIT_VALID = ((0, 1, 31, 32, 33, 1024, 100, 200),
               (255, 256, 257, 127, 129, 1023, 511, 513))

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
        *({**lay, "valid": (512, 100, 0, 333), "atol": 1e-2,
           "config": {"kv_splits": n}}
          for lay in QWEN_LAYOUTS for n in DECODE_SPLITS),
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
    ),
}


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


def phase_kernels() -> tuple:
    """Every kernel against its reference on the card (the plain version,
    or for attention the exact float32 oracle, which the exact-mode plain
    version equals), paged and int8 decode cases included; returns the
    largest error per kernel-table row and the launches of
    flash_attention_dequant here (no model path calls it)."""
    worst = dict.fromkeys(KERNELS, 0.0)
    reset_counts()
    for name in registry.names():
        spec = registry.get(name)
        wrapper = spec.build()
        for case in tuple(spec.example_cases) + EXTRA_CASES[name]:
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
    counts = launch_counts()
    for name in BODY_COUNTERS:
        by_body = dict(WRAPPERS[name].launches_by_body)
        if min(by_body.values()) < 1:
            fail(f"kernels: a {name} body never ran: {by_body}")
    emit("kernels", bodies={k: v for k, v in counts.items()
                            if k in DECODE_ROWS or "/" in k})
    return worst, flash_attention_dequant_cuda.launches


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
                 "flash_attention_dequant")


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
    in, forward, copy out; median of 20).  ``forward_wall_ms``: host
    wall-clock per forward of ``n_forwards`` back-to-back forwards ending in
    a synchronise.  ``device_busy_ms``: the sum of the kernels' device times
    per forward from ``torch.profiler`` (None when the profiler reports no
    device time), with the busiest kernels by name; the device's idle share
    of a forward is what is left of the wall-clock."""
    cfg = deployed.cfg
    rng = np.random.RandomState(1)
    batch = rng.rand(BATCH, cfg.image_hw, cfg.image_hw,
                     cfg.in_channels).astype(np.float32)
    engine = deployed.serve(batch_size=BATCH)
    engine.warmup()
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine.forward_host(batch)
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    out = {"step_wall_ms": walls[len(walls) // 2]}

    x = torch.from_numpy(batch).to(DEVICE)
    deployed.forward(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_forwards):
        deployed.forward(x)
    torch.cuda.synchronize()
    out["forward_wall_ms"] = (time.perf_counter() - t0) * 1e3 / n_forwards

    kernels = kernel_device_ms(lambda: deployed.forward(x), n_forwards)
    busy = sum(kernels.values())
    out["device_busy_ms"] = busy if busy > 0 else None
    out["device_idle_share_of_forward"] = (
        max(0.0, 1.0 - busy / out["forward_wall_ms"]) if busy > 0 else None)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out["device_ms_by_kernel"] = dict(top)
    return out


def kernel_device_ms(fn, n_calls: int) -> dict:
    """Device time per call of every kernel ``fn`` launches, by name, from
    ``torch.profiler`` kernel events over ``n_calls`` calls (empty when the
    profiler reports no device time)."""
    return profile_ms(fn, n_calls)[0]


def kernel_ms_of(fn, name: str, n_calls: int = 20):
    """Device ms per call of the kernel-table row ``name``'s kernel, or
    None; a trace that holds none of its events (the profiler now and then
    drops a trace's kernel events) is taken once more."""
    for _ in range(2):
        ms = sum(v for k, v in kernel_device_ms(fn, n_calls).items()
                 if KERNEL_EVENT[name] in k)
        if ms > 0:
            return ms
    return None


def profile_ms(fn, n_calls: int):
    """``(device ms per call by kernel, host ms per call by operation)``
    from one ``torch.profiler`` trace of ``n_calls`` calls.  Device: kernel
    events only (an operator's entry repeats the device time of the
    kernels it launched).  Host: self CPU time of each operator and CUDA
    runtime call, with the profiler's own overhead in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    kernels, host = {}, {}
    for ev in prof.key_averages():
        name = ev.key[:60]
        if ev.device_type != DeviceType.CUDA:
            host[name] = ev.self_cpu_time_total / 1e3 / n_calls
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels[name] = kernels.get(name, 0.0) + us / 1e3 / n_calls
    return kernels, host


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
         **forward_breakdown(fused))
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
    kernels, host = profile_ms(one_step, TRAIN_PROFILE_STEPS)
    busy = sum(kernels.values())
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

    # 6. the kernels refuse a gradient
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

    # 7. save -> crash -> resume against an uninterrupted run
    resume = resume_check(cfg, loss_fn, batches)
    if not resume["crashed"] or resume["steps"] != RESUME_STEPS:
        fail(f"train_capsnet: the crash/resume run went wrong: {resume}")
    emit("train_capsnet", arch=cfg.arch_id, **tf32, n_train=TRAIN_N,
         n_test=TEST_N, batch=BATCH, steps=res.step, ft_steps=FT_STEPS,
         data_s=data_s, train_s=train_s, finetune_s=ft_s,
         loss_first=losses[0], loss_last=losses[-1],
         step_wall_ms_median=step_ms, step_wall_ms_min=walls_sorted[0],
         step_wall_ms_max=walls_sorted[-1],
         step_device_busy_ms=busy if busy > 0 else None,
         step_device_idle_share=(max(0.0, 1.0 - busy / step_ms)
                                 if busy > 0 else None),
         step_device_ms_by_kernel=dict(sorted(
             kernels.items(), key=lambda kv: -kv[1])[:6]),
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
         resume=resume, seconds=time.perf_counter() - t_phase)
    if resume["max_abs_gap"] > 1e-6:
        fail(f"train_capsnet: the resumed run is {resume['max_abs_gap']} "
             f"off the uninterrupted one at {resume['worst_leaf']}; leaves "
             f"whose step differs when repeated: "
             f"{resume['repeat_step_differs']}")
    return {"fused_routing": counts["fused_routing"],
            "taylor_softmax": counts["taylor_softmax"]}


def lm_requests(vocab: int) -> list:
    """16 requests from RandomState(0): prompts of 16-700 tokens with ids in
    [1, vocab / 2), 32 new tokens; every fourth samples at temperature 0.8
    with top-k 50 and top-p 0.9 and a seed of its own, the others are
    greedy."""
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(LM_REQUESTS):
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


def record_margins(engine) -> dict:
    """Record, for each host-sampled token of ``engine``, the top-2 margin
    of the logits it was drawn from, keyed by (rid, position)."""
    margins = {}
    inner = engine._sample_task_row

    def wrapped(logits_row, task, pos):
        top2 = np.partition(logits_row, -2)[-2:]
        margins[(task.rid, pos)] = float(abs(top2[1] - top2[0]))
        return inner(logits_row, task, pos)

    engine._sample_task_row = wrapped
    return margins


def decode_tick_breakdown(engine, vocab: int, n_ticks: int = 8) -> dict:
    """Where a decode tick's time goes with every slot busy: 8 requests of
    512 prompt tokens, every fourth sampled as in the serve mix, are
    admitted in one tick traced by ``torch.profiler`` (``prefill_tick``:
    the device time of the prefill group and the first step), then
    ``n_ticks`` decode-only ticks are timed by the host clock (a tick ends
    in the copy of the tokens to the host) and ``n_ticks`` more are traced;
    ``decode_ms`` and ``sampling_ms`` are the decode attention and sampling
    kernels' device time per traced tick."""
    rng = np.random.RandomState(2)
    for i in range(LM_SLOTS):
        kw = {}
        if i % 4 == 3:
            kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=3000 + i)
        engine.submit(Request(
            prompt=[int(t) for t in rng.randint(1, vocab // 2, size=512)],
            max_new_tokens=4 * n_ticks + 4, rid=1000 + i, **kw))
    kernels, _ = profile_ms(engine.tick, 1)       # admission + first step
    busy = sum(kernels.values())
    prefill = {"device_busy_ms": busy if busy > 0 else None,
               "flash_ms": sum(v for k, v in kernels.items()
                               if KERNEL_EVENT["flash_attention"] in k),
               "device_ms_by_kernel": dict(
                   sorted(kernels.items(), key=lambda kv: -kv[1])[:6])}
    walls = []
    for _ in range(n_ticks):
        t0 = time.perf_counter()
        engine.tick()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    out = {"prefill_tick": prefill, "tick_wall_ms": walls[len(walls) // 2]}
    kernels, host = profile_ms(engine.tick, n_ticks)
    busy = sum(kernels.values())
    out["device_busy_ms"] = busy if busy > 0 else None
    for key, name in (("decode_ms", "decode_attention"),
                      ("sampling_ms", "fused_sampling")):
        out[key] = sum(v for k, v in kernels.items()
                       if KERNEL_EVENT[name] in k)
    out["device_idle_share_of_tick"] = (
        max(0.0, 1.0 - busy / out["tick_wall_ms"]) if busy > 0 else None)
    out["device_ms_by_kernel"] = dict(
        sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    out["host_self_ms"] = sum(host.values())
    out["host_ms_by_op"] = dict(
        sorted(host.items(), key=lambda kv: -kv[1])[:12])
    out["sampling_on_served_logits"] = served_sampling(engine)
    engine.run_until_idle()
    return out


def served_sampling(engine) -> dict:
    """Row 9 on the logits of one served decode tick: the engine's own
    call (``tick_rows``: every fourth row sampled) and the same logits with
    every row sampled as the serve mix samples (``mixed``), timed as
    ``timing_row`` times the kernel, their tokens held against the plain
    version (equal) and over two runs (bit-identical); beside them the
    same timings and the logits' spread on the ``mixed`` timing case's
    seeded normal logits.  The lanes each row keeps under top-k 50 and
    top-p 0.9 at T 0.8 set how many lanes a bisection pass visits (it
    skips those below the current lower end: ``pass_lane_visits_mean``)."""
    from repro_torch import kernels as kernels_pkg

    seen = []
    call = kernels_pkg.fused_sampling

    def capture(logits, temp, seeds, pos, top_k=None, top_p=None, **kw):
        if not seen:
            seen.append((logits.clone(), temp, seeds, pos, top_k, top_p))
        return call(logits, temp, seeds, pos, top_k=top_k, top_p=top_p,
                    **kw)

    kernels_pkg.fused_sampling = capture
    try:
        engine.tick()
    finally:
        kernels_pkg.fused_sampling = call
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
        torch.cuda.synchronize()
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
        out[label] = {
            "ms": median_ms(run), "config": cfg,
            "kernel_ms": kernel_ms_of(run, "fused_sampling"),
            "logit_std_mean": float(x.float().std(-1).mean()),
            "logit_range_mean": float((x.max(-1).values
                                       - x.min(-1).values).mean()),
            "top_p_lanes_mean": float(top_p_lanes.float().mean()),
            "top_p_lanes_max": int(top_p_lanes.max()),
            "pass_lane_visits_mean": float(pass_lane_visits(z).mean()),
            "clocks_after": clocks_line()}
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
    path's up to the first position whose top-2 margin there is below
    LM_MARGIN.  Returns (tokens compared, ambiguous positions, where each
    such sequence first parts from the plain one)."""
    compared = ambiguous = 0
    first_diff = {}
    for r in reqs:
        a, b = tok[r.rid], tok_plain[r.rid]
        if len(a) != len(r.prompt) + LM_MAX_NEW:
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
            if m >= LM_MARGIN:
                fail(f"{phase}: rid {r.rid} token {j} differs from the plain "
                     f"path at a top-2 margin of {m} >= {LM_MARGIN}")
            ambiguous += 1
            first_diff[r.rid] = {"position": j, "margin": m}
            break                         # the sequences part ways here
    return compared, ambiguous, first_diff


def phase_serve_lm() -> dict:
    """Full-width llama3.2-1b through ServeEngine: the kernel path
    (flash_attention in prefill, decode_attention and fused_sampling in
    every decode tick) against the plain path (chunked attention, host
    sampling) on the same parameters and requests."""
    cfg, params, init_s, n_params = init_lm()
    kern = ServeEngine(cfg, params, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                       decode_kernel=True, device=DEVICE)
    plain = ServeEngine(dataclasses.replace(cfg, attn_impl="chunked"), params,
                        n_slots=LM_SLOTS, max_len=LM_MAX_LEN, device=DEVICE)
    del params
    reqs = lm_requests(cfg.vocab)

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
    if len(done) != LM_REQUESTS:
        fail(f"serve_lm: {len(done)} of {LM_REQUESTS} requests completed")
    want = {"flash_attention": cfg.n_layers * n_groups,
            "decode_attention": cfg.n_layers * n_ticks,
            "dense": cfg.n_layers * n_ticks,
            "fused_sampling": n_ticks}
    for name, n in want.items():
        if counts[name] != n or n < 1:
            fail(f"serve_lm: {name} launched {counts[name]} times, expected "
                 f"{n} ({n_groups} prefill groups, {n_ticks} decode ticks)")
    check_prefill_bodies("serve_lm", counts)

    margins = record_margins(plain)
    done_plain = plain.serve(fresh(reqs))
    again = kern.serve(fresh(reqs))
    compared, ambiguous, first_diff = compare_with_plain(
        "serve_lm", reqs, {c.rid: c.tokens for c in done},
        {c.rid: c.tokens for c in done_plain},
        {c.rid: c.tokens for c in again}, margins, cfg.vocab)

    breakdown = decode_tick_breakdown(kern, cfg.vocab)
    lat = stats.latency_summary()
    emit("serve_lm", arch=LM_ARCH, params=n_params, init_s=init_s,
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
         ambiguous_positions=ambiguous, margin=LM_MARGIN,
         first_divergence=first_diff,
         seeded_bit_identical=True, **breakdown)
    return {"flash_attention": counts["flash_attention"],
            "decode_attention": counts["dense"],
            "fused_sampling": counts["fused_sampling"]}


def paged_requests(vocab: int) -> list:
    """16 requests from RandomState(1), 32 new tokens each: the even ones
    begin with one shared 256-token prefix (16 full pages) followed by
    16-300 tokens of their own, the odd ones have prompts of 16-700 tokens
    of their own; ids in [1, vocab / 2).  Every fourth request samples at
    temperature 0.8 with top-k 50 and top-p 0.9 and a seed of its own, the
    others are greedy."""
    rng = np.random.RandomState(1)
    shared = [int(t) for t in rng.randint(1, vocab // 2, size=SHARED_PREFIX)]
    reqs = []
    for i in range(LM_REQUESTS):
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
    LM_MARGIN."""
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
    top2 = np.sort(b, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) >= LM_MARGIN
    if err > 0.25:
        fail(f"serve_paged: int8 and paged int8 decode logits differ by "
             f"{err} > 0.25")
    if not np.array_equal(a.argmax(-1)[clear], b.argmax(-1)[clear]):
        fail("serve_paged: int8 and paged int8 decode disagree on a clear "
             "argmax")
    return {"max_abs_logit_diff": err, "clear_rows": int(clear.sum()),
            "launches_int8": counts_a["int8"],
            "launches_paged_int8": counts_b["paged_int8"]}


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
            "fused_sampling": n_ticks}
    for name, n in want.items():
        if counts[name] != n or n < 1:
            fail(f"serve_paged ({mode}): {name} launched {counts[name]} "
                 f"times, expected {n} ({n_groups} prefill groups, {n_ticks} "
                 f"decode ticks)")
    check_prefill_bodies(f"serve_paged ({mode})", counts)
    pg = dict(stats.pages)
    if not (pg["prefix_hits"] >= LM_SLOTS - 1 and pg["allocated"] > 0
            and pg["prefix_pages_hit"]
            == SHARED_PREFIX // PAGE * pg["prefix_hits"]):
        fail(f"serve_paged ({mode}): page counters {pg}")

    margins = record_margins(plain)
    done_plain = plain.serve(fresh(reqs))
    del plain
    # a second kernel engine: the same requests meet the same (empty)
    # prefix cache, so every prefill group has the same composition
    again = ServeEngine(cfg, params, decode_kernel=True, **kw).serve(
        fresh(reqs))
    compared, ambiguous, first_diff = compare_with_plain(
        f"serve_paged ({mode})", reqs, {c.rid: c.tokens for c in done},
        {c.rid: c.tokens for c in done_plain},
        {c.rid: c.tokens for c in again}, margins, cfg.vocab)
    out = {}
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
        margin=LM_MARGIN, first_divergence=first_diff,
        seeded_bit_identical=True, **breakdown)
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
        launches[DECODE_ROWS[mode]] = counts[mode]
        for k in ("flash_attention", "fused_sampling"):
            launches[k] = launches.get(k, 0) + counts[k]
        if quantize:
            launches["decode_attention_dequant"] = \
                out["b6_cross_check"]["launches_int8"]
    return launches


def flash_bound(case, int8: bool = False):
    """Causal attention: 4 * B * H * D operations per unmasked (i, t) pair
    (QK and PV, a multiply and an add each; query i at position q_offset + i
    sees min(T, q_offset + i + 1) keys) at the peak of the case's type (the
    bf16 tensor cores, or float32 outside them); q, k, v read and the
    output written once (2 or 4 bytes an element; int8 K/V at one byte per
    element plus a float32 scale per row of each)."""
    b, s, t, h, k, d = case["dims"]
    width = 2 if case.get("dtype", "float32") == "bfloat16" else 4
    off = case.get("q_offset", 0)
    pairs = (sum(min(t, off + i + 1) for i in range(s))
             if case.get("causal", True) else s * t)
    kv_bytes = (2 * b * t * k * d + 2 * 4 * b * t) if int8 \
        else 2 * width * b * t * k * d
    nbytes = 2 * width * b * s * h * d + kv_bytes
    peak = BF16_FLOP_PER_S if width == 2 else FP32_FLOP_PER_S
    return nbytes / HBM_BYTES_PER_S, 4 * b * h * d * pairs / peak


def decode_bound(case):
    """The valid cache rows of K and V read once (2 B per element for bf16;
    1 B per element plus a 4 B scale per row of each for int8), the used
    table entries of a paged cache (4 B each), q and the lengths read and
    the output written once; 4 * H * D operations per valid row."""
    b, t, h, k, d = case["dims"]
    paged = case.get("paged")
    page = paged[1] if paged else t
    lens = [min(max(v, 0), t) for v in case["valid"]]
    rows = sum(lens)
    qbytes = 2 if case.get("dtype") == "bfloat16" else 4
    if case.get("quant"):
        kv_bytes = 2 * rows * (k * d + 4)
    else:
        kv_bytes = 2 * rows * k * d * (2 if case.get("dtype", "float32")
                                       == "bfloat16" else 4)
    table_bytes = 4 * sum(-(-n // page) for n in lens) if paged else 0
    nbytes = kv_bytes + table_bytes + 2 * b * h * d * qbytes + 4 * b
    return nbytes / HBM_BYTES_PER_S, 4 * rows * h * d / BF16_FLOP_PER_S


def sampling_bound(case):
    """One read of the logits.  Operations per element, as this case's rows
    need them: the argmax (1); for a row with temperature > 0 also the
    division and the range (3), the hash, the two logarithms and the keep
    test of the draw (about 25), a compare and an add per top-k bisection
    step (60) when 0 < top_k < V, and the exponential, division and sum
    (3) plus a compare and an add per top-p step (60) when top_p < 1."""
    b, v = case["dims"]
    ops = 0
    for i in range(b):
        ops += 1
        if case.get("temperature", (1.0,) * b)[i] > 0:
            ops += 3 + 25
            if 0 < case.get("top_k", (0,) * b)[i] < v:
                ops += 60
            if case.get("top_p", (1.0,) * b)[i] < 1.0:
                ops += 63
    return 4 * b * v / HBM_BYTES_PER_S, ops * v / FP32_FLOP_PER_S


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
    return None


def elem_bytes(case) -> int:
    """Bytes an element of the case's type."""
    return 2 if case.get("dtype", "float32") == "bfloat16" else 4


def routing_bound(shape, elem: int = 4, n_iters: int = 3):
    """u_hat read and v written once in the case's type, c written once in
    float32; the routing's float32 operations at the float32 peak."""
    b, i, j, d = shape
    nbytes = elem * (b * i * j * d + b * j * d) + 4 * b * i * j
    flops = (n_iters * 2 * b * i * j * d            # FC
             + (n_iters - 1) * 2 * b * i * j * d    # agreement
             + n_iters * 6 * b * i * j              # softmax
             + n_iters * 6 * b * j * d)             # squash
    return nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S


def softmax_bound(shape, elem: int = 4):
    n = int(np.prod(shape))
    # per element: subtract, clamp (2), scale, Horner (10), e^a, 5 squarings,
    # the sum, the division, and the maximum
    return 2 * elem * n / HBM_BYTES_PER_S, 23 * n / FP32_FLOP_PER_S


BOUNDS = {"fused_routing":
          lambda c: routing_bound(c["shape"], elem_bytes(c)),
          "taylor_softmax":
          lambda c: softmax_bound(c["shape"], elem_bytes(c)),
          "flash_attention": flash_bound,
          "flash_attention_dequant": lambda c: flash_bound(c, int8=True),
          "decode_attention": decode_bound,
          "fused_sampling": sampling_bound}

# the name of each kernel's CUDA function, for its profiler events
KERNEL_EVENT = {"fused_routing": "fused_routing_kernel",
                "taylor_softmax": "taylor_softmax",
                "flash_attention": "flash_attention_kernel",
                "flash_attention_dequant": "flash_attention_kernel",
                "decode_attention": "decode_attention_kernel",
                "fused_sampling": "fused_sampling_kernel"}


def timing_row(name, case, n_profile: int = 20, config=None,
               plain: bool = True) -> dict:
    """Kernel time by CUDA events (``ms``, wrapper included), the kernel
    alone by profiler events (``kernel_ms``), the plain version's and the
    library call's time, and the bound, at one case, with the default
    config or ``config`` over it (the plain version's and the library
    call's times only when ``plain``)."""
    spec = registry.get(name)
    args, kwargs = spec.make_example(case, device=DEVICE)
    cfg = {**registry.default_config(name, *args, **kwargs),
           **(config or {})}
    wrapper = spec.build()

    def call():
        return wrapper(*args, **kwargs, **cfg)

    ms = median_ms(call)
    kernel_ms = kernel_ms_of(call, name, n_profile)
    t_bytes, t_ops = BOUNDS[name](case)
    row = {"ms": ms, "kernel_ms": kernel_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "shape": case_shape(case), "config": cfg}
    if plain:
        fn = PLAIN.get(name)
        plain_call = ((lambda: fn(*args, **kwargs)) if fn
                      else (lambda: spec.ref_call(*args, **kwargs)))
        lib = library_call(name, args, kwargs)
        row["plain_ms"] = median_ms(plain_call, launches=5, repeats=3)
        row["library_ms"] = median_ms(lib) if lib is not None else None
    return row


def sweep(name, case) -> dict:
    """``timing_row`` (kernel only) at every point of the kernel's tuned
    space over its default config, as the wrapper is called with it (not
    re-planned: the planner would fold the decode splits above one block
    an SM, and the clusters too small for a row, into its own choice); a
    point the wrapper refuses (its shared memory does not fit) is recorded
    with the refusal."""
    spec = registry.get(name)
    args, kwargs = spec.make_example(case, device=DEVICE)
    base = registry.default_config(name, *args, **kwargs)
    out = {}
    for values in itertools.product(*(spec.space[k] for k in spec.tuned)):
        point = dict(zip(spec.tuned, values))
        key = ",".join(f"{k}={v}" for k, v in point.items())
        try:
            out[key] = timing_row(name, case, plain=False,
                                  config={**base, **point})
        except ValueError as err:
            out[key] = {"refused": str(err)}
    return out


def phase_timings(launches: dict, worst: dict) -> list:
    """One row per TPU entry point at its main path's shape.  The decode
    rows take the decode tick's valid lengths: serve_lm's first 8 requests
    for the dense body, serve_paged's for the int8 and paged ones, 16
    tokens into decode."""
    table = []
    vocab = cfg_lib.get_config(LM_ARCH).vocab
    valid = tuple(len(r.prompt) + 16 for r in lm_requests(vocab)[:LM_SLOTS])
    for name, info in KERNELS.items():
        case = dict(info["main_case"])
        if name == "decode_attention":
            case["valid"] = valid
        elif name in DECODE_ROWS.values():
            case["valid"] = paged_valid(vocab)
        row = {"name": name, "route": info["route"], "source": info["source"],
               "replaces": info["replaces"], "launches": launches[name],
               "max_abs_err": worst[name],
               **timing_row(info["kernel"], case)}
        table.append(row)
        emit("timings", **row)
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
        emit("timings", name=name, case="by config",
             by_config=sweep("decode_attention", case))
    for label, rows in (("greedy", {"temperature": (0.0,) * LM_SLOTS}),
                        ("mixed", MIXED)):
        case = {"dims": (LM_SLOTS, 128256), **rows}
        emit("timings", name="fused_sampling", case=f"{label} by config",
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
             by_config=sweep("fused_routing", case))
    emit("timings", name="taylor_softmax", case="by config",
         by_config=sweep("taylor_softmax",
                         KERNELS["taylor_softmax"]["main_case"]))
    # the floors under row 2's time: the shortest kernel the card runs (a
    # one-element fill) and a copy of row 2's own input (one read and one
    # write of the same bytes)
    one = torch.empty(1, device=DEVICE)
    (x,), _ = registry.get("taylor_softmax").make_example(
        KERNELS["taylor_softmax"]["main_case"], device=DEVICE)
    fill = kernel_device_ms(lambda: one.fill_(0.0), 20)
    copy = kernel_device_ms(lambda: x.clone(), 20)
    emit("timings", name="launch_floor",
         fill_kernel_ms=sum(fill.values()) or None,
         copy_kernel_ms=sum(copy.values()) or None,
         kernels=sorted(fill) + sorted(copy))
    return table


def main() -> None:
    if len(sys.argv) > 1:
        sys.exit("chip_smoke takes no arguments")
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    worst, dequant_launches = phase_kernels()
    launches = phase_serve("serve_pruned", prune=True, n_requests=8)
    launches_dense = phase_serve("serve_dense", prune=False, n_requests=4)
    launches_train = phase_train_capsnet()
    launches_lm = phase_serve_lm()
    launches_paged = phase_serve_paged()
    for name, n in {**launches, **{f"{k} (dense)": v
                                   for k, v in launches_dense.items()},
                    **{f"{k} (train)": v for k, v in launches_train.items()},
                    **launches_lm, **{f"{k} (paged)": v
                                      for k, v in launches_paged.items()}
                    }.items():
        if n < 1:
            fail(f"{name} was never launched on its path")
    for k, n in (list(launches_train.items()) + list(launches_lm.items())
                 + list(launches_paged.items())):
        launches[k] = launches.get(k, 0) + n
    # no model path calls flash_attention_dequant: its row counts the
    # kernel phase's launches
    launches["flash_attention_dequant"] = dequant_launches
    missing = [k for k in KERNELS if launches.get(k, 0) < 1]
    if missing:
        fail(f"no launches counted for {missing}")
    table = phase_timings(launches, worst)
    emit("done", seconds=time.perf_counter() - t0,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
