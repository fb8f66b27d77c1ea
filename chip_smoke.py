"""GPU smoke test of the PyTorch/CUDA port: builds the kernels, holds each
against its plain PyTorch version on the card, then drives the port's
paths at full size and checks that every kernel of each path ran there:

- serving, two Poisson traces at full width (continuous batching,
  chunked prefill, paged posit16 KV written by the fused quantize-and-
  write kernel ``posit_paged_write.cu`` and read back by the chunked
  prefill through the fused read ``posit_paged_read.cu``, fused paged
  decode attention):
  phi3-medium-14b (dense GQA lane, ``paged_attn.cu``; all 40 layers)
  and minicpm3-4b (MLA lane, ``paged_attn_mla.cu``) with prefix
  caching and deadlines on a shared-prefix trace, on an arena small
  enough that deadlines preempt (minicpm3 at 16 of its 62 layers); then on the same trace the
  rest of the transformer family:
  granite-moe-3b-a800m (the MoE feed-forward on every chunk and decode
  step, full width, 4 of 32 layers), gemma-7b (head_dim 256, full width,
  8 of 28 layers), granite-34b (MQA, 48 query heads on one KV head, full width,
  12 of 88 layers) and dbrx-132b (16 experts top 4, posit8 KV, full
  width, 4 of 40 layers), each with exact launch counts, and on gemma
  and granite-34b the fused decode kernel against the gather path on
  the served weights;
- the one-shot engine and the two unchunked schedulers at full width
  (``LINEAR_PATHS``): the one-shot engine on phi3-medium-14b (all
  40 layers; a ragged batch on a linear posit16 cache: the codec's quantize at
  every prefill, its dequantize of the whole cache at every decode
  step, a layer's two leaves in one launch, the fused write for the
  decode token; ``generate`` ==
  ``generate_stepwise`` and two ragged rows against their singleton
  generations on the card), the dense-cache scheduler on minicpm3-4b
  (the MLA linear lane, compaction; 16 of 62 layers) and the unchunked paged scheduler
  on phi3-medium-14b (40 layers), each with exact launch counts per prefill and
  decode step and the schedule pinned on the CPU; the one-shot
  engine on internvl2-1b with its visual prefix (full width and depth);
  and the other three families through the one-shot engine at full
  width: hymba-1.5b (16 of 32 layers: ring caches on its window layers,
  full ones on its global layers 0 and 15, SSM state; its prefill a decode step
  a prompt token, so one fused write and one dequantize a layer and a
  prompt token), rwkv6-7b (15 GB of bf16 weights, the recurrent state,
  no posit kernel) and whisper-tiny (1 500 encoder frames from the seed
  that must reach the logits, the codec's quantize four times a decoder
  layer at prefill, a fused write and two dequantizes, self and cross
  leaves, a layer and a decode step), ``generate`` ==
  ``generate_stepwise`` on each; then hymba-1.5b's ring past its wrap
  at full width and depth, its window replaced by 64 so that it wraps
  in the smoke's time (every decode step writes ring slot ``pos % 64``
  of every window layer and nothing else);
- the paged sliding-window lane: phi3-medium-14b at full width and 10
  of its 40 layers on the chunked trace with ``sliding_window`` replaced by 128
  (``WINDOW_PATH``; the published config has none), exact launch counts,
  every decode read exactly the window, fused == gather on the served
  weights;
- (j) tensor-parallel serving (``TP_PATHS``): ``serve --model-parallel
  2`` with two ranks sharing the one card over gloo, phi3-medium-14b
  (its KV heads split, the arena head-sharded) and minicpm3-4b (its
  query heads split, the latent arena whole) at full width, 10 of phi3's
  40 layers and 16 of minicpm3's 62, on a shortened trace, each against
  a single-rank run of the same trace
  on the same weights: the schedule equal, each rank's launches exactly
  the single run's, the cache's bytes per device, and greedy tokens
  equal up to flips at near-ties (teacher-forced through both);
- (l) tensor-parallel serving on linear caches and the other families
  (``TPL_PATHS``, ``--phase tp-linear``): ``serve --model-parallel``
  with its ranks sharing the card over gloo, the one-shot engine on
  phi3-medium-14b (KV heads split), rwkv6-7b (heads and the wkv state
  split), whisper-tiny (self and cross K/V split) at mp 2 and hymba-1.5b
  at mp 5 (five ranks: attention, KV and SSM heads split), and the
  dense-cache scheduler on minicpm3-4b at mp 2 (compactions), full width
  on shortened prompts, generations and depth (``TPL_CUTS``), each
  against a single-rank run of the same argv held as (j) holds its paths
  (the teacher-forced check in f32 on rwkv6 and hymba);
- training, each phase in a process of its own (``--phase train``,
  ``--phase train-families``): (T) ``launch/train.py`` on gemma-7b at
  full width, 2 of its 28 layers, ``--posit-moments`` (the codec's
  quantize and dequantize once a leaf a step, exactly; the supervisor's
  final checkpoint restored bit for bit; one AdamW update on the real
  leaves on the kernels against the plain codec, bit for bit; rows 1 and
  2 timed at the optimizer's leaves), and (T2), beside (j), two steps of
  minicpm3-4b (16 of 62 layers), granite-moe-3b-a800m (16 of 32),
  hymba-1.5b (8 of 32), rwkv6-7b (4 of 32) and whisper-tiny
  (``TRAIN_FAMILIES``);
- (k) training across ranks, a process of its own (``--phase
  train-ranks``, beside the linear paths after (a) and (c), hymba's ring
  and the window lane), two ranks sharing the card over gloo (so no wall is a
  multi-card speed): (k1) (T)'s gemma-7b, seed, data and schedule
  through ``make_train_step`` on a ``(1, 2)`` mesh, every group split,
  three steps held to (T)'s losses and gradient norms, rows 1 and 2
  once a leaf a step on each rank; then (o3) on the same two ranks:
  the same model, seed and data through ``make_train_step`` with the
  config's ``fsdp`` kept on, on a ``(2, 1)`` mesh (``O3_STEPS`` steps:
  each rank holds half of every leaf and of its posit16 ``m`` and f32
  ``v``, gathers a layer's leaves inside the layer and reduce-scatters
  their gradients), held to (T) as (k1) is, its bytes a rank against
  (T)'s and its peak memory printed; (k2) internvl2-1b at full width (4
  of its 24 layers) through the pod-compressed step on two pods of 4 x 512 (only
  posit16 patterns on the pod wire, two bytes an element, from the
  collectives' counter; non-zero error feedback; step 0's loss equal to
  an uncompressed data-parallel step's; exact codec launches; rows 1 and
  2 at the wire's leaves against their plain versions, timed); (k3) its
  state after two steps restored on one rank bit for bit, the third
  step from it giving the ranks' loss;
- (m) training of the other families across ranks, a process of its own
  (``--phase train-model``, ``TM_LAUNCHES``): rwkv6-7b (2 of 32 layers)
  and whisper-tiny (all layers) at "model" 2 in one launch of two ranks,
  hymba-1.5b (2 of 32 layers) at "model" 5 in one of five, all sharing
  the card over gloo, full width, 3 steps of 8 x 512 with posit16
  moments, each held to a one-device run of the same config in the
  phase: losses, global gradient norms and the gradient norms of every
  partial leaf (those a rank holds whole but slices to its heads, summed
  over "model" once a step, in calls and bytes on the wire) and of
  ``TM_LEAVES``; rwkv6 and hymba in f32 (``TM_F32``: their bf16 drift is
  the split sums' rounding), rows 1 and 2 once a leaf a step per rank
  and timed at a rank's embedding moment;
- (n) the sequence layout across ranks, a process of its own (``--phase
  train-seq``, the configs' ``seq_shard_activations`` kept on): (n1)
  (T)'s gemma-7b at "model" 2, every group split (Megatron-SP with the
  vocabulary-parallel head), held to (T) as (k1) is; (n2) internvl2-1b
  at "model" 4 in f32 (``TN_LAUNCHES``: 4 of 24 layers), its 14 heads
  context-parallel, its visual prefix, its loss on each rank's positions
  (the 151 655-row vocabulary whole); (n3) hymba-1.5b at "model" 2 in
  f32 (2 of 32 layers), its 25 heads context-parallel; (n2) and (n3)
  held to one-device runs as (m) holds its families; each lane's
  sequence collectives by kind, its peak memory per rank and rows 1
  and 2 once a leaf a step.  (m) and (n) run side by side, two processes
  on the one card (their walls are each other's neighbours);
- (o) context-parallel prefill in sharded serving, a process of its own
  (``--phase cp``, ``O_PATHS``) beside (l): ``serve --model-parallel 4``,
  four ranks sharing the card over gloo, phi3-medium-14b (10 of its 40
  layers; its 40 heads and 10 KV heads do not split at 4) on the chunked
  and the unchunked paged schedulers and internvl2-1b (all 24 layers,
  14 heads) one-shot with its visual prefix: every prefill's and chunk's
  attention runs a rank's quarter of the query rows against the whole
  K/V and gathers the rows, once a layer; each path held to a
  single-rank run as (l) holds its paths, the gathers and a rank's rows
  counted, no gather in a decode step;
- (o4) the pod-compressed step under FSDP, a process of its own
  (``--phase pod-fsdp``) beside (T): granite-moe-3b-a800m (its
  published config sets both ``fsdp`` and ``grad_compress``) at full
  width, 1 of its 32 layers, pod 2 x data 2, four ranks sharing the
  card over gloo, run deterministic:
  one step without FSDP and one with it on the same batch; every rank's
  pieces, residuals and pod patterns under FSDP equal the first step's
  cut to them bit for bit, its parameter and residual bytes and its pod
  wire half, rows 1 and 2 launched exactly;
- (p) the dry run on the card, a process of its own (``--phase
  dryrun``) beside the kernel checks, the ISA phases and the main
  paths: (p1) (T)'s own step predicted on fake tensors of a ``1x1``
  fake mesh (``launch/dryrun.trace_step``) and then run: FLOPs, argument
  bytes and launches equal, the counted peak within ``P1_PEAK_RTOL`` of
  ``max_memory_allocated``; (p2) ``P2_CELLS`` traced on fake CUDA
  tensors at their production meshes (counted, not measured);
- (q) the six examples (``repro_torch.examples``: quickstart,
  posit_convolution, serve_posit_kv, gradient_compression, train_lm,
  elastic_restart) at the reference's settings: train_lm in a process
  of its own (``--phase examples-train``) beside (j), (T2), (l) and
  (o), the other five in the main process beside (m) and (n)
  (``--phase examples``: all six alone); each self-check held and each
  example's kernels (``Q_KERNELS``) launched on the card;
- the PVU ISA (``posit_ew.cu``, ``posit_dot.cu``, ``posit_qgemm.cu``,
  ``posit_gemm.cu``): the paper's verification workload
  (``configs/pvu_resnet_conv.py``, the ResNet-18 first conv on 8 images
  in posit32, pgemm == dot on every output, the per-op exact-match table
  against the golden model on the conv data and on every posit8 pair),
  a posit-exact linear layer at phi3-medium-14b width, and cache
  maintenance (scale, merge) on the arena the phi3 path served from.

    python3 chip_smoke.py          # needs one NVIDIA GPU and nvcc
    python3 chip_smoke.py --phase train            # (T) alone (kernels built)
    python3 chip_smoke.py --phase train-families   # (T2) alone
    python3 chip_smoke.py --phase tp               # (j) alone
    python3 chip_smoke.py --phase tp-linear        # (l) alone
    python3 chip_smoke.py --phase train-ranks      # (k) alone
    python3 chip_smoke.py --phase train-model      # (m) alone
    python3 chip_smoke.py --phase train-seq        # (n) alone
    python3 chip_smoke.py --phase cp               # (o1), (o2) alone
    python3 chip_smoke.py --phase pod-fsdp         # (o4) alone
    python3 chip_smoke.py --phase dryrun           # (p) alone
    python3 chip_smoke.py --phase examples         # (q) alone
    python3 chip_smoke.py --phase examples-train   # (q)'s train_lm alone
    python3 chip_smoke.py --ptxas  # only: -Xptxas -v (registers, shared
                                   # memory, spills) of paged_attn.cu,
                                   # paged_attn_mla.cu, posit_gemm.cu,
                                   # posit_paged_write.cu,
                                   # posit_paged_read.cu, posit_qgemm.cu,
                                   # posit_ew.cu, posit_dot.cu and
                                   # posit_codec.cu

Before the paths it checks paged attention at every served
architecture's head shape (``ATTN_SHAPES``), a rank's heads at mp 2
included, the MLA kernel at a rank's 20 heads, and the fused write and
read on every served lane's leaves (``LANES``, a rank's arena at mp 2
included) against their plain versions,
and checks and times the codec's quantize and dequantize at the shapes
the ISA phases and the linear lanes of every family give them, a rank's
shapes in (l) included (the
dequantize in its job form, a layer's two leaves a launch, beside the
launches PR 19's linear read made for the same values), the fused write
as the paged and the linear decode lanes launch it (hymba's ring and
whisper's self leaves included), and its decode launch on the card's
own clock (``torch.profiler``) beside its launch floor (an empty kernel
through the same C call).

Prints the card's name and power limit, per-kernel checks and timings,
the serving reports, the accuracy table, a JSON line with every
kernel's numbers and, last, ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before that line; without a GPU it exits
non-zero at once.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_START = time.perf_counter()

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
# 32-bit integer operations a second: the card's issue rate, one warp
# instruction a clock on each of an SM's four partitions (SMs x 128
# lanes x the maximum SM clock; set by run() from the card).  That is a
# least time for any instruction mix; pure INT32 ALU work caps at half
# of it (16 INT32 lanes a partition), so a bound from it is a least time
INT_OPS = None
CARD = None                    # the nvidia-smi line: name, power limit
ATTN_TOL = 1e-5                # atol and rtol, kernel vs plain, both f32
PAPER_DIV_ACC = 0.9584         # the paper's nr3 division exact-match rate
# the fewest 32-bit integer operations per element the PVU datapath
# needs: a decode, an encode, each op's core, and a quire product
# (32x32 multiply, 128-bit placement, conditional negate, 128-bit add)
OPS_DECODE, OPS_ENCODE, OPS_QUIRE = 12, 25, 14
OPS_EW = {("add", "nr3"): 20, ("sub", "nr3"): 20, ("mul", "nr3"): 8,
          ("div", "nr3"): 40, ("div", "exact"): 132}
EW_OPS = (("add", "nr3"), ("sub", "nr3"), ("mul", "nr3"), ("div", "nr3"),
          ("div", "exact"))
# ISA check and workload sizes: the elementwise check block, the gemm
# check (phi3-medium-14b's MLP down projection at 128 tokens), the
# images of the conv workload, the dot lengths, the pgemm shapes
EW_BLOCK = (1024, 1024)
GEMM_SHAPE = (128, 5120, 17920)
CONV_IMAGES = 8
DOT_LENGTHS = (1, 16, 147, 4095, 4096, 4097, 17920)
PGEMM_SHAPES = ((5, 37, 7), (33, 129, 19), (16, 4097, 16), (16, 17920, 64))

_TRACE = [
    "--continuous", "--paged", "--chunked-prefill", "--batch", "8", "--n-requests", "16", "--arrival-rate", "0.5",
    "--prompt-len", "512", "--gen", "32", "--max-len", "1024",
    "--chunk-size", "16", "--block-size", "16", "--kv-posit", "posit16",
    "--decode-kernel", "fused", "--temperature", "0", "--seed", "0",
    "--device", "cuda",
]
# the main path, two lanes at full width, bf16 weights, the reference's
# command line for the chunked paged scheduler: phi3 at its full 40
# layers, minicpm3 at 16 of its 62 (cut so that the smoke fits its time).  The
# minicpm3 trace shares half of every prompt; a quarter of its requests
# carry a 5 s deadline (500 decode steps) and the rest are best-effort,
# and its 200-block arena (of a worst case 512) makes deadline requests
# preempt best-effort rows: 9 prefix hits and 3 preemptions in 47 rounds.
# The schedule does not depend on width or tokens;
# tests/test_torch_prefix.py pins it on the CPU with the model stubbed.
MAIN_PATHS = {
    "phi3-medium-14b": (["--arch", "phi3-medium-14b"] + _TRACE,
                        ("posit_paged_write", "posit_paged_read",
                         "paged_decode_attention")),
    "minicpm3-4b": (["--arch", "minicpm3-4b", "--n-layers", "16", "--prefix-cache",
                     "--prefix-share", "0.5", "--deadline-ms", "5000",
                     "--deadline-share", "0.25", "--n-blocks", "200"] + _TRACE,
                    ("posit_paged_write", "posit_paged_read",
                     "paged_decode_attention_mla")),
}
# The rest of the transformer family on the same trace and kernels (the
# MoE feed-forward launches no posit kernel).  granite-moe-3b-a800m at
# full width with 4 of its 32 layers (its 40 experts top 8 in every
# layer) and gemma-7b at full width with 8 of its 28 layers (both cut so
# that the smoke fits its time);
# granite-34b at full width with 12 of its 88 layers (all 88 in bf16,
# some 93 GB with the port's three-matrix MLP, leave no room on an
# 80 GB card; 12 so that the smoke fits its time); dbrx-132b at full width with 4 of its 40 layers (6.3 GB of
# bf16 experts a layer) and posit8 KV, as its serving config asks.
_DENSE_KERNELS = ("posit_paged_write", "posit_paged_read", "paged_decode_attention")
_TRACE8 = ["posit8" if a == "posit16" else a for a in _TRACE]
MAIN_PATHS.update({
    "granite-moe-3b-a800m": (["--arch", "granite-moe-3b-a800m", "--n-layers", "4"] + _TRACE,
                             _DENSE_KERNELS),
    "gemma-7b": (["--arch", "gemma-7b", "--n-layers", "8"] + _TRACE, _DENSE_KERNELS),
    "granite-34b": (["--arch", "granite-34b", "--n-layers", "12"] + _TRACE, _DENSE_KERNELS),
    "dbrx-132b": (["--arch", "dbrx-132b", "--n-layers", "4"] + _TRACE8, _DENSE_KERNELS),
})
# paths whose fused decode kernel is held to the gather path on the
# served weights at full width (head_dim 256; 48 heads in 6 head groups)
FUSED_GATHER_PATHS = ("gemma-7b", "granite-34b")


# The one-shot engine and the two unchunked schedulers, full width and
# depth, through the reference's command line: (a) the one-shot engine on
# phi3-medium-14b (a ragged batch of 8 prompts, a linear posit16 cache;
# all 40 layers); (b) the dense-cache scheduler on minicpm3-4b (the
# MLA linear lane, with compaction; 16 of its 62 layers); (c) the
# unchunked paged scheduler on phi3-medium-14b (all 40 layers), on the
# trace flags of (b); minicpm3's depth cut so that the smoke fits its time.  Each kernel's launches must be exactly L (the
# model's layers) times the per-prefill and per-decode-step counts given
# here, and every other kernel must stay unlaunched.
_LINEAR_ARGS = ["--batch", "8", "--prompt-len", "512", "--gen", "32", "--max-len", "1024",
           "--kv-posit", "posit16", "--temperature", "0", "--seed", "0",
           "--device", "cuda"]
_UNCHUNKED = ["--continuous", "--n-requests", "16", "--arrival-rate", "0.5",
              "--chunk-size", "16"] + _LINEAR_ARGS
_LINEAR_KERNELS = {"posit_quantize": (2, 0), "posit_paged_write": (0, 1),
                   "posit_dequantize": (0, 1)}
# the linear paths that run alone on the card (the rest beside (k))
ALONE_LINEAR = ("phi3-medium-14b-oneshot", "phi3-medium-14b-unchunked")
LINEAR_PATHS = {
    "phi3-medium-14b-oneshot": (["--arch", "phi3-medium-14b", "--ragged"]
                                + _LINEAR_ARGS, _LINEAR_KERNELS),
    "minicpm3-4b-dense": (["--arch", "minicpm3-4b", "--n-layers", "16"] + _UNCHUNKED,
                          _LINEAR_KERNELS),
    "phi3-medium-14b-unchunked": (
        ["--arch", "phi3-medium-14b", "--paged", "--block-size", "16",
         "--decode-kernel", "fused"] + _UNCHUNKED,
        {"posit_quantize": (2, 0), "posit_paged_write": (0, 1),
         "paged_decode_attention": (0, 1)}),
    # internvl2-1b with its 256 visual tokens: prompts of equal length
    # (a ragged batch cannot carry a visual prefix)
    "internvl2-1b-oneshot": (["--arch", "internvl2-1b"] + _LINEAR_ARGS, _LINEAR_KERNELS),
}
# The other three families through the one-shot engine, full width and
# depth (hymba: 16 of its 32 layers, its global layers 0 and 15, cut so
# that the smoke fits its time), posit16 KV, prompts of equal length (the
# reference refuses ragged batches outside the transformer family).  A count's third entry is per
# prompt token: hymba-1.5b's prefill is a decode step a prompt token, one
# fused write and one dequantize a layer each (ring layers of 1 024
# slots and global ones); rwkv6-7b (15 GB of bf16 weights, a
# 512-token prompt: a multiple of its WKV chunk, 16) launches no posit
# kernel; whisper-tiny (448 is its decoder context, 1 500 encoder frames
# from the seed) quantizes each decoder layer's K, V and cross K, V at
# prefill, and a decode step writes once and dequantizes twice (self and
# cross leaves) a layer.
_FAMILY_ARGS = ["--batch", "8", "--gen", "32", "--kv-posit", "posit16", "--temperature", "0",
                "--seed", "0", "--device", "cuda"]
LINEAR_PATHS.update({
    "hymba-1.5b-oneshot": (
        ["--arch", "hymba-1.5b", "--n-layers", "16", "--prompt-len", "128", "--max-len", "1024"]
        + _FAMILY_ARGS,
        {"posit_paged_write": (0, 1, 1), "posit_dequantize": (0, 1, 1)}),
    "rwkv6-7b-oneshot": (
        ["--arch", "rwkv6-7b", "--prompt-len", "512", "--max-len", "1024"] + _FAMILY_ARGS, {}),
    "whisper-tiny-oneshot": (
        ["--arch", "whisper-tiny", "--prompt-len", "384", "--max-len", "448"] + _FAMILY_ARGS,
        {"posit_quantize": (4, 0), "posit_paged_write": (0, 1), "posit_dequantize": (0, 2)}),
})
# hymba-1.5b's ring at full width and depth: its published window of
# 1 024 cannot wrap inside the smoke's time, so the check replaces it with
# RING_WINDOW and writes past the wrap
RING_WINDOW, RING_BATCH, RING_PROMPT, RING_STEPS = 64, 2, 48, 48
# The two schedulers' schedules on their traces (no EOS, so they do not
# depend on the model): rounds, decode steps, compactions of the shared
# frontier (moves to fit a longer prompt included), each request's
# admission step.  tests/test_torch_scheduler_unchunked.py pins them on
# the CPU with the model stubbed out.
_ADMITTED = [2, 18, 18, 18, 18, 18, 18, 18, 34, 34, 50, 50, 50, 50, 50, 50]
SCHEDULES = {
    "minicpm3-4b-dense": dict(rounds=5, steps=82, compactions=3, admitted=_ADMITTED),
    "phi3-medium-14b-unchunked": dict(rounds=5, steps=82, compactions=0,
                                      admitted=_ADMITTED),
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _launch_dicts():
    from repro_torch.kernels import (posit_codec, posit_dot, posit_ew,
                                     posit_gemm, posit_paged_attn, posit_qgemm)
    return [m.launches for m in (posit_codec, posit_paged_attn, posit_ew,
                                 posit_dot, posit_qgemm, posit_gemm)]


def reset_counts():
    for d in _launch_dicts():
        for name in d:
            d[name] = 0


def read_counts():
    return {k: v for d in _launch_dicts() for k, v in d.items()}


def time_ms(fn, iters=20, warmup=3):
    """Median of per-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_alone_ms(call, n=100):
    """Time of one launch alone (``repro_torch.launch.timing``): ``n``
    back-to-back calls of the loaded library function on preallocated
    outputs, one event pair, divided by ``n``."""
    from repro_torch.launch.timing import kernel_alone_ms as alone
    return alone(call, n)


def check_codec(dev):
    """Every posit16 and posit8 pattern decoded; a seeded f32 sweep with
    specials encoded in all five configs, whole and as a view at an odd
    element offset (a ragged head, a source off the output's vectors):
    bit-exact against the plain versions."""
    from repro_torch.core.types import CONFIGS, POSIT8, POSIT16, signed_view
    from repro_torch.kernels import posit_codec as C

    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                         1.1754942e-38, 3.4028235e38, 1.0, -1.0, 1e-30,
                         1e30], np.float32)
    x = torch.from_numpy(np.concatenate([bits.view(np.float32), specials]))
    for cfg in (POSIT16, POSIT8):
        pats = torch.arange(1 << cfg.nbits, dtype=torch.int64).to(cfg.storage_dtype)
        got = C.dequantize(pats.to(dev), cfg).cpu()
        ref = C.dequantize_plain(pats, cfg)
        bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        print(f"codec {cfg.name}: decode all {pats.numel()} patterns, "
              f"{bad} mismatches")
        if bad:
            fail(f"posit_dequantize {cfg.name} not bit-exact")
    for cfg in CONFIGS:
        bad = 0
        for off in (0, 3):
            got = C.quantize(x.to(dev)[off:], cfg).cpu()
            bad += int((signed_view(got) != signed_view(C.quantize_plain(x[off:], cfg))).sum())
        print(f"codec {cfg.name}: encode {x.numel()} f32 values (and the view at "
              f"element 3), {bad} mismatches")
        if bad:
            fail(f"posit_quantize {cfg.name} not bit-exact")


def codec_shapes(dev):
    """The shapes the phases give the codec, with phase-like data from
    seeds.  Quantize, name -> (cfg, tensor): P3's weight (17 920 x 5 120
    posit16, ``randn`` / sqrt(17 920)), P2's images (8 x 3 x 224^2
    posit32, integers 0-127 x 0.02) and bias (64 posit32, integers x
    0.005); the linear prefill's KV of one layer, phi3's (8, 512, 10, 128)
    and an admission's minicpm3 latent (1, 512, 256) and RoPE key
    (1, 512, 32), posit16.  Dequantize, name -> (cfg, leaves of one
    launch, round_to): P2's conv output (95 048 x 64 posit32) and P3's
    output (16 x 5 120 posit16) to f32; the linear decode's whole cache of
    one layer, phi3's K and V (2 x (8, 1 024, 10, 128)) rounded through
    bf16 and minicpm3's latent (8, 1 024, 256) and RoPE key (8, 1 024, 32)
    to f32, posit16, one NaR pattern at the head of each leaf.  The other
    families: whisper-tiny's cross K (8, 1 500, 6, 64) quantized at
    prefill; a layer's K and V read at decode in both output forms,
    hymba-1.5b's ring (8, 1 024, 5, 64), whisper-tiny's self leaves
    (8, 448, 6, 64) and cross leaves (8, 1 500, 6, 64).  A rank's linear
    shapes in (l): phi3's prefill KV at 5 of 10 KV heads (8, 256, 5, 128)
    and whisper's cross K at 3 of 6 (8, 1 500, 3, 64) quantized; a
    layer's read, bf16-rounded, of phi3's K+V (8, 1 024, 5, 128),
    whisper's cross leaves (8, 1 500, 3, 64) and hymba's ring at mp 5,
    one KV head (8, 1 024, 1, 64)."""
    from repro_torch.core.types import POSIT16, POSIT32, signed_view
    from repro_torch.kernels import posit_codec as C

    gen = torch.Generator(device=dev).manual_seed(1)
    quant = {
        "p3_weight": (POSIT16, torch.randn((17920, 5120), generator=gen, device=dev)
                      * 17920 ** -0.5),
        "p2_images": (POSIT32, torch.randint(0, 128, (8, 3, 224, 224), generator=gen,
                                             device=dev).float() * 0.02),
        "p2_bias": (POSIT32, torch.randint(-127, 128, (64,), generator=gen,
                                           device=dev).float() * 0.005)}
    for key, shape in (("phi3_linear_prefill", (8, 512, 10, 128)),
                       ("mla_prefill_latent", (1, 512, 256)),
                       ("mla_prefill_rope", (1, 512, 32)),
                       ("whisper_cross_k", (8, 1500, 6, 64)),
                       ("phi3_linear_prefill_mp2", (8, 256, 5, 128)),
                       ("whisper_cross_k_mp2", (8, 1500, 3, 64))):
        quant[key] = (POSIT16, torch.randn(shape, generator=gen, device=dev))

    def leaf(cfg, shape):
        p = C.quantize_plain(torch.randn(shape, generator=gen, device=dev), cfg)
        signed_view(p).view(-1)[0] = -(1 << (cfg.nbits - 1))       # NaR
        return p

    dequant = {
        "phi3_linear_decode_kv": (POSIT16, [leaf(POSIT16, (8, 1024, 10, 128))
                                            for _ in range(2)], torch.bfloat16),
        "mla_linear_decode_cr": (POSIT16, [leaf(POSIT16, (8, 1024, 256)),
                                           leaf(POSIT16, (8, 1024, 32))], None),
        "p2_conv_out": (POSIT32, [leaf(POSIT32, (95048, 64))], None),
        "p3_out": (POSIT16, [leaf(POSIT16, (16, 5120))], None)}
    # the other families' linear reads, a layer's two leaves a launch, in
    # both output forms: hymba's ring, whisper's self and cross leaves
    for key, shape in (("hymba_ring_kv", (8, 1024, 5, 64)),
                       ("whisper_self_kv", (8, 448, 6, 64)),
                       ("whisper_cross_kv", (8, 1500, 6, 64))):
        leaves = [leaf(POSIT16, shape) for _ in range(2)]
        dequant[key + "_bf16"] = (POSIT16, leaves, torch.bfloat16)
        dequant[key + "_f32"] = (POSIT16, leaves, None)
    # a rank's linear read in (l), bf16-rounded as the card serves it
    for key, shape in (("phi3_linear_decode_kv_mp2", (8, 1024, 5, 128)),
                       ("whisper_cross_kv_mp2", (8, 1500, 3, 64)),
                       ("hymba_ring_kv_mp5", (8, 1024, 1, 64))):
        dequant[key] = (POSIT16, [leaf(POSIT16, shape) for _ in range(2)], torch.bfloat16)
    return quant, dequant


# the bf16 rounding's operations an element (a shift-and for the lsb, an
# add, a mask): added to the decode's in the rounding mode
OPS_ROUND_BF16 = 3
_SAME_BYTES = {1: torch.uint8, 2: torch.bfloat16, 4: torch.float32}


def _same_bytes_cast(src, out_elem, dev):
    """A PyTorch cast reading ``src``'s bytes and writing ``out_elem``
    bytes an element (the memory's pace in practice): ``call`` for
    ``kernel_alone_ms``."""
    from repro_torch.core.types import signed_view

    s = src if src.dtype == torch.float32 else signed_view(src).view(
        _SAME_BYTES[src.element_size()])
    out = torch.empty(src.shape, dtype=_SAME_BYTES[out_elem], device=dev)
    return lambda: (out.copy_(s), 0)[1]


def time_quantize(dev, quant):
    """Row 1 at the shapes the phases launch: wrapper time, alone (the
    ``*_call`` helper), plain, and both bounds, bytes (each input read
    once, each output written once) and operations (the encode's fewest,
    at the integer issue rate); each output checked bit for bit against
    the plain version.  The row's main numbers are P3's weight's."""
    from repro_torch.core.types import signed_view
    from repro_torch.kernels import posit_codec as C

    by_shape = {}
    for key, (cfg, x) in quant.items():
        if not torch.equal(signed_view(C.quantize(x, cfg)),
                           signed_view(C.quantize_plain(x, cfg))):
            fail(f"posit_quantize differs from its plain version at {key} "
                 f"{tuple(x.shape)}")
        n = x.numel()
        nbytes = n * (4 + cfg.nbits // 8)
        call, out = C.quantize_call(x, cfg)
        r = dict(shape=list(x.shape), cfg=cfg.name,
                 ms=time_ms(lambda: C.quantize(x, cfg)), kernel_ms=kernel_alone_ms(call),
                 same_bytes_cast_alone_ms=kernel_alone_ms(
                     _same_bytes_cast(x, cfg.nbits // 8, dev)),
                 plain_ms=time_ms(lambda: C.quantize_plain(x, cfg), iters=3),
                 bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                 ops_bound_ms=n * OPS_ENCODE / INT_OPS * 1e3,
                 **_bound(nbytes, n * OPS_ENCODE, INT_OPS))
        by_shape[key] = r
        del out
        print(f"posit_quantize {key} {r['shape']} {cfg.name}: {r['ms']:.4f} ms, alone "
              f"{r['kernel_ms']:.4f} ms (bounds: bytes {r['bytes_bound_ms']:.4f} ms, "
              f"operations {r['ops_bound_ms']:.4f} ms; a cast of the same bytes alone "
              f"{r['same_bytes_cast_alone_ms']:.4f} ms; plain {r['plain_ms']:.3f} ms)")
    main = by_shape["p3_weight"]
    return dict(name="posit_quantize", route="cuda",
                source="src/repro_torch/csrc/posit_codec.cu",
                replaces="src/repro/kernels/posit_codec.py:46", launches=0,
                max_abs_err=0.0, library_ms=None,
                **{k: main[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms",
                                        "bound_by", "bytes_bound_ms", "ops_bound_ms",
                                        "shape")}, shapes=by_shape)


def time_dequantize(dev, dequant):
    """Row 2 in its job form at the shapes the phases launch: one
    ``dequantize_many`` launch for a case's leaves, wrapper-timed and
    alone, beside PR 19's form of the same read alone on this build's
    kernel (a one-leaf f32 launch a leaf, and on the rounded case the cast
    of each to bf16 and back: the linear read's chain before the job
    table; ``launch/ew_dot_ab.py --dequantize`` times it on PR 19's
    kernel) and beside PyTorch
    casts that move the same bytes; bounds as ``time_quantize``'s
    (the decode's operations, and the rounding's in bf16 mode).  Each
    output checked bit for bit (``int32`` views, NaR included) against
    ``dequantize_many_plain`` on the card.  The row's main numbers are
    phi3's K and V."""
    from repro_torch.kernels import posit_codec as C

    nan_bits = int(torch.tensor([float("nan")], device=dev).to(torch.bfloat16)
                   .view(torch.int16)[0]) & 0xFFFF
    print(f"torch's cast of a NaN to bf16 on this card: 0x{nan_bits:04x} (the "
          "reference's astype keeps NaR's 0x7fc0; the kernel's rounding does too)")
    by_shape = {}
    for key, (cfg, leaves, round_to) in dequant.items():
        got = C.dequantize_many(leaves, cfg, round_to)
        want = C.dequantize_many_plain(leaves, cfg, round_to)
        if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want)):
            fail(f"posit_dequantize differs from its plain version at {key}")
        del got, want
        n = sum(p.numel() for p in leaves)
        nbytes = n * (cfg.nbits // 8 + 4)
        ops = n * (OPS_DECODE + (OPS_ROUND_BF16 if round_to is not None else 0))
        call, outs = C.dequantize_many_call(leaves, cfg, round_to)
        one = [C.dequantize_call(p, cfg) for p in leaves]
        casts = []
        if round_to is not None:
            for _, f in one:
                b = torch.empty(f.shape, dtype=torch.bfloat16, device=dev)
                back = torch.empty_like(f)
                casts += [(b, f), (back, b)]

        def chain():
            for c, _ in one:
                c()
            for dst, src in casts:
                dst.copy_(src)
            return 0

        same = [_same_bytes_cast(p, 4, dev) for p in leaves]
        r = dict(shape=[list(p.shape) for p in leaves], cfg=cfg.name,
                 round_to=None if round_to is None else str(round_to),
                 ms=time_ms(lambda: C.dequantize_many(leaves, cfg, round_to)),
                 kernel_ms=kernel_alone_ms(call),
                 pr19_chain_alone_ms=kernel_alone_ms(chain),
                 pr19_chain_launches=len(one) + len(casts),
                 same_bytes_cast_alone_ms=kernel_alone_ms(
                     lambda: sum(c() for c in same)),
                 plain_ms=time_ms(lambda: C.dequantize_many_plain(leaves, cfg, round_to),
                                  iters=3),
                 bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                 ops_bound_ms=ops / INT_OPS * 1e3, **_bound(nbytes, ops, INT_OPS))
        r["share_of_bound"] = r["bound_ms"] / r["kernel_ms"]
        by_shape[key] = r
        del outs, one, casts, same
        print(f"posit_dequantize {key} {r['shape']} {cfg.name} round_to={r['round_to']}: "
              f"{r['ms']:.4f} ms, alone {r['kernel_ms']:.4f} ms, {r['share_of_bound']:.0%} "
              f"of its bound (bytes {r['bytes_bound_ms']:.4f} ms, operations "
              f"{r['ops_bound_ms']:.4f} ms); PR 19's form alone ({r['pr19_chain_launches']} "
              f"launches) {r['pr19_chain_alone_ms']:.4f} ms; casts of the same bytes alone "
              f"{r['same_bytes_cast_alone_ms']:.4f} ms; plain {r['plain_ms']:.3f} ms")
    main = by_shape["phi3_linear_decode_kv"]
    return dict(name="posit_dequantize", route="cuda",
                source="src/repro_torch/csrc/posit_codec.cu",
                replaces="src/repro/kernels/posit_codec.py:61", launches=0,
                max_abs_err=0.0, library_ms=None,
                **{k: main[k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms",
                                        "bound_by", "bytes_bound_ms", "ops_bound_ms",
                                        "shape", "pr19_chain_alone_ms")}, shapes=by_shape)


def time_codec(dev):
    """Rows 1 and 2 at the shapes the phases launch (``codec_shapes``)."""
    quant, dequant = codec_shapes(dev)
    rows = [time_quantize(dev, quant), time_dequantize(dev, dequant)]
    del quant, dequant
    return rows


# the other served architectures' decode attention: (KV heads G, query
# heads a KV head R, head_dim D, KV format) of the paths in MAIN_PATHS
ATTN_SHAPES = {"granite-moe-3b-a800m": (8, 3, 64, "posit16"),
               "gemma-7b": (16, 1, 256, "posit16"),
               "granite-34b": (1, 48, 128, "posit16"),
               "dbrx-132b": (8, 6, 128, "posit8"),
               # a rank's heads under tensor parallelism at mp 2 (phase (j)):
               # phi3's 5 of 10 KV heads; granite-34b's 24 of 48 query heads
               # on its one replicated KV head
               "phi3-medium-14b-mp2": (5, 4, 128, "posit16"),
               "granite-34b-mp2": (1, 24, 128, "posit16")}


def attn_case(dev, kv, window, seed, g=10, r=4, d=128):
    """Full-width decode attention, by default phi3's: B=8 rows, G=10 KV
    heads, R=4, D=128, block 16, W=64 table slots; ragged lens, sentinel
    tails, one all-masked row (its table is all sentinels)."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.models import layers as L

    b, bs, w = 8, 16, 64
    lens = [1000, 700, 512, 300, 900, 64, 1020, 0]
    if window:
        lens = [1500, 2047, 512, 300, 1800, 64, 1020, 0]
    nb = b * w
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = torch.full((b, w), nb, dtype=torch.int32)
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(seed))
    for i, n in enumerate(lens[:-1]):
        live = w if window else -(-(n + 1) // bs)
        tables[i, :live] = perm[i * w:i * w + live].to(torch.int32)
    tables = tables.to(dev)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    apos = L.paged_apos(tables, lens, bs, nb, window=window)
    pcfg = L.pcfg(kv)
    k = C.quantize_plain(torch.randn((nb, bs, g, d), generator=gen, device=dev), pcfg)
    v = C.quantize_plain(torch.randn((nb, bs, g, d), generator=gen, device=dev), pcfg)
    q = torch.randn((b, g, r, d), generator=gen, device=dev) * d ** -0.5
    return (q, k, v, tables, apos, lens), pcfg


def check_attention(dev):
    from repro_torch.kernels import posit_paged_attn as K
    from repro_torch.models import layers as L

    row = None
    for window in (0, 1008):
        for kv in ("posit16", "posit8"):
            args, pcfg = attn_case(dev, kv, window, seed=2)
            got = K.paged_decode_attention(*args, pcfg=pcfg, window=window)
            ref = K.paged_decode_attention_plain(*args, pcfg=pcfg, window=window)
            err = float((got - ref).abs().max())
            ok = torch.allclose(got, ref, atol=ATTN_TOL, rtol=ATTN_TOL)
            zero = bool((got[-1] == 0).all())
            lane = f"window={window}" if window else "dense"
            print(f"paged attention {lane} {kv}: max abs err {err:.3e} "
                  f"(tolerance atol=rtol={ATTN_TOL}), all-masked row exact "
                  f"zeros: {zero}")
            if not ok or not zero:
                fail(f"paged_decode_attention {lane} {kv} disagrees with plain")
            if window == 0 and kv == "posit16":
                row = time_attention(args, pcfg, err)
    row["arch_shapes"] = {}
    for name, (g, r, d, kv) in ATTN_SHAPES.items():
        args, pcfg = attn_case(dev, kv, 0, seed=2, g=g, r=r, d=d)
        got = K.paged_decode_attention(*args, pcfg=pcfg)
        ref = K.paged_decode_attention_plain(*args, pcfg=pcfg)
        err = float((got - ref).abs().max())
        print(f"paged attention {name} (G {g}, R {r}, D {d}) {kv}: max abs err {err:.3e} "
              f"(tolerance atol=rtol={ATTN_TOL}), all-masked row exact zeros: "
              f"{bool((got[-1] == 0).all())}")
        if not torch.allclose(got, ref, atol=ATTN_TOL, rtol=ATTN_TOL) or \
                not bool((got[-1] == 0).all()):
            fail(f"paged_decode_attention at {name}'s shape disagrees with plain")
        t = time_attention(args, pcfg, err)
        row["arch_shapes"][name] = {key: t[key] for key in (
            "shape", "max_abs_err", "ms", "kernel_ms", "bound_ms", "bound_by", "plain_ms",
            "library_ms", "library_alone_ms")}
    return row


def time_attention(args, pcfg, err):
    """Kernel, plain and SDPA-yardstick times on the dense posit16 case;
    the bound counts the live blocks this case's tables name."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.kernels import posit_paged_attn as K
    from repro_torch.models import layers as L

    q, k, v, tables, apos, lens = args
    b, g, r, d = q.shape
    nb, bs = k.shape[0], k.shape[1]
    live_slots = int((tables < nb).sum()) * bs
    kv_bytes = live_slots * g * 2 * d * k.element_size()
    io_bytes = (q.numel() * 4 * 2 + tables.numel() * 4 + apos.numel() * 4
                + lens.numel() * 4)
    flops = live_slots * g * r * 2 * (d + d)
    bound_ms = max((kv_bytes + io_bytes) / HBM_BYTES_PER_S,
                   flops / FP32_FLOPS) * 1e3
    bound_by = "bytes" if (kv_bytes + io_bytes) / HBM_BYTES_PER_S >= \
        flops / FP32_FLOPS else "operations"

    # yardstick: one SDPA call on the gathered, dequantized KV (timed
    # here only; the port never calls it)
    kk = C.dequantize_plain(L.paged_gather(k, tables), pcfg)      # (B,T,G,D)
    vv = C.dequantize_plain(L.paged_gather(v, tables), pcfg)
    cl = (lens + 1)[:, None]
    mask = ((apos >= 0) & (apos < cl))[:, None, None, :]          # (B,1,1,T)
    qh = q.reshape(b, g * r, 1, d) * d ** 0.5
    kh, vh = kk.permute(0, 2, 1, 3), vv.permute(0, 2, 1, 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib():
        return sdpa(qh, kh, vh, attn_mask=mask, enable_gqa=True)

    lib()
    call, _ = K.paged_decode_attention_call(*args, pcfg=pcfg)
    # the kernel alone and the library call, timed the same way
    kernel_ms = kernel_alone_ms(call)
    library_alone_ms = kernel_alone_ms(lambda: (lib(), 0)[1])
    return dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/csrc/paged_attn.cu",
        replaces="src/repro/kernels/posit_paged_attn.py:216", launches=0,
        max_abs_err=err,
        ms=time_ms(lambda: K.paged_decode_attention(*args, pcfg=pcfg)),
        kernel_ms=kernel_ms, library_alone_ms=library_alone_ms,
        plain_ms=time_ms(lambda: K.paged_decode_attention_plain(*args, pcfg=pcfg),
                         iters=5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=time_ms(lib),
        shape=[b, g, r, d, int(tables.shape[1]), bs])


def mla_case(dev, kv, seed, h=40):
    """Full-width minicpm3-4b latent decode attention (the case of
    ``repro_torch.launch.mla_split_sweep``); ``h`` 20 is a rank's heads
    at mp 2 (phase (j))."""
    from repro_torch.launch.mla_split_sweep import minicpm3_case
    return minicpm3_case(dev, kv, seed, h=h)


def check_attention_mla(dev):
    """The wrapper's own split and forced ones (a split per table entry,
    and the policy's) against the plain version, posit16 and posit8."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import posit_paged_attn as K

    scale = (64 + 32) ** -0.5
    row = None
    for kv in ("posit16", "posit8"):
        args, pcfg = mla_case(dev, kv, seed=4)
        ref = K.paged_decode_attention_mla_plain(*args, pcfg=pcfg, scale=scale)
        policy = K.split_chunk_mla(args[4].shape[1], args[0].shape[0],
                                   _build.sm_count(dev))
        errs = []
        for chunk in (None, 1, policy):
            if chunk is None:
                got = K.paged_decode_attention_mla(*args, pcfg=pcfg, scale=scale)
            else:
                call, got = K.paged_decode_attention_mla_call(
                    *args, pcfg=pcfg, scale=scale, chunk=chunk)
                if call() != 0:
                    fail(f"paged_decode_attention_mla chunk={chunk} launch failed")
            err = float((got - ref).abs().max())
            ok = torch.allclose(got, ref, atol=ATTN_TOL, rtol=ATTN_TOL)
            zero = bool((got[-1] == 0).all())
            print(f"paged attention MLA {kv} chunk={chunk or 'wrapper'}: max "
                  f"abs err {err:.3e} (tolerance atol=rtol={ATTN_TOL}), "
                  f"all-masked row exact zeros: {zero}")
            if not ok or not zero:
                fail(f"paged_decode_attention_mla {kv} chunk={chunk} "
                     "disagrees with plain")
            errs.append(err)
        if kv == "posit16":
            row = time_attention_mla(args, pcfg, scale, max(errs))
    # a rank's 20 heads at mp 2 (phase (j)), against the plain version
    args, pcfg = mla_case(dev, "posit16", seed=4, h=20)
    got = K.paged_decode_attention_mla(*args, pcfg=pcfg, scale=scale)
    ref = K.paged_decode_attention_mla_plain(*args, pcfg=pcfg, scale=scale)
    err = float((got - ref).abs().max())
    print(f"paged attention MLA posit16 at H 20 (a rank's heads at mp 2): max abs err "
          f"{err:.3e} (tolerance atol=rtol={ATTN_TOL}), all-masked row exact zeros: "
          f"{bool((got[-1] == 0).all())}")
    if not torch.allclose(got, ref, atol=ATTN_TOL, rtol=ATTN_TOL) or \
            not bool((got[-1] == 0).all()):
        fail("paged_decode_attention_mla at H 20 disagrees with plain")
    t = time_attention_mla(args, pcfg, scale, err)
    row["tp_mp2"] = {key: t[key] for key in (
        "shape", "max_abs_err", "ms", "kernel_ms", "bound_ms", "bound_by", "plain_ms",
        "library_ms", "library_alone_ms")}
    return row


def time_attention_mla(args, pcfg, scale, err):
    """Kernel, plain and SDPA-yardstick times on the posit16 case; the
    bound counts the live blocks this case's tables name."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.kernels import posit_paged_attn as K
    from repro_torch.models import layers as L

    q_lat, q_rope, c, r, tables, apos, lens = args
    b, h, rank = q_lat.shape
    rope = q_rope.shape[-1]
    nb, bs = c.shape[0], c.shape[1]
    live_slots = int((tables < nb).sum()) * bs
    kv_bytes = live_slots * (rank + rope) * c.element_size()
    io_bytes = (q_lat.numel() * 4 * 2 + q_rope.numel() * 4
                + tables.numel() * 4 + apos.numel() * 4 + lens.numel() * 4)
    flops = live_slots * h * (2 * (rank + rope) + 2 * rank)
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    # yardstick: one SDPA call on the gathered, dequantized latents, K
    # the latent and RoPE parts concatenated, V the latent (timed here
    # only; the port never calls it)
    cc = C.dequantize_plain(L.paged_gather(c, tables), pcfg)      # (B,T,rank)
    rr = C.dequantize_plain(L.paged_gather(r, tables), pcfg)
    kk = torch.cat([cc, rr], -1)[:, None]                          # (B,1,T,288)
    vv = cc[:, None]
    qq = torch.cat([q_lat, q_rope], -1)[:, :, None]                # (B,H,1,288)
    mask = ((apos >= 0) & (apos < (lens + 1)[:, None]))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib():
        return sdpa(qq, kk, vv, attn_mask=mask, scale=scale, enable_gqa=True)

    lib()
    # the kernel alone and the library call, timed the same way
    kernel_ms = kernel_alone_ms(K.paged_decode_attention_mla_call(
        *args, pcfg=pcfg, scale=scale)[0])
    library_alone_ms = kernel_alone_ms(lambda: (lib(), 0)[1])
    return dict(
        name="paged_decode_attention_mla", route="cuda",
        source="src/repro_torch/csrc/paged_attn_mla.cu",
        replaces="src/repro/kernels/posit_paged_attn.py:262", launches=0,
        max_abs_err=err,
        ms=time_ms(lambda: K.paged_decode_attention_mla(*args, pcfg=pcfg,
                                                        scale=scale)),
        kernel_ms=kernel_ms, library_alone_ms=library_alone_ms,
        plain_ms=time_ms(lambda: K.paged_decode_attention_mla_plain(
            *args, pcfg=pcfg, scale=scale), iters=5),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=time_ms(lib), shape=[b, h, rank, rope, int(tables.shape[1]), bs])


# each served lane's arena leaves at its model's depth: (layers, the two
# leaves' per-slot widths, window).  phi3-medium-14b dense and on a
# 48-token window ring, minicpm3-4b's latent and RoPE key, and the paths
# of MAIN_PATHS that follow (granite-34b and dbrx-132b at their cut depth)
LANES = {"dense": (40, ((10, 128), (10, 128)), 0),
         "window": (40, ((10, 128), (10, 128)), 48),
         "mla": (62, ((256,), (32,)), 0),
         "granite-moe": (32, ((8, 64), (8, 64)), 0),
         "gemma": (28, ((16, 256), (16, 256)), 0),
         "granite-34b": (24, ((1, 128), (1, 128)), 0),
         "dbrx": (4, ((8, 128), (8, 128)), 0),
         # phi3's arena on one rank at mp 2 (phase (j)): 5 of its 10 KV heads
         "dense-mp2": (40, ((5, 128), (5, 128)), 0)}


def write_case(dev, cfg, lane, seed):
    """Full-width arena leaves of one of ``LANES`` at its model's depth
    (e.g. phi3's 40 layers of K and V, dense or on a 48-token window
    ring; minicpm3's 62 layers of latent and RoPE key), 512 blocks of 16 slots of random
    patterns; 8 rows whose tables name live blocks but for a sentinel
    entry that row 1 writes through; row 3 inactive.  Returns the
    leaves, bf16 sources for one decode token and for a 16-token prefill
    chunk of every layer, and the destinations."""
    from repro_torch.models import layers as L

    b, bs, nb, c = 8, 16, 512, 16
    n_layers, feats, window = LANES[lane]
    w = L.paged_window_blocks(window, bs) if window else 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(seed))
    tables = perm[:b * w].reshape(b, w).to(torch.int32)
    pos = torch.tensor([1000, 83, 200, 64, 900, 15, 1008, 7])
    tables[1, (83 // bs) % w] = nb               # row 1 writes through a sentinel
    tables, pos = tables.to(dev), pos.to(dev)
    ok = torch.ones(b, dtype=torch.bool, device=dev)
    ok[3] = False
    n_valid = torch.tensor([16, 16, 3, 0, 16, 8, 16, 16], device=dev)
    signed = {16: torch.int16, 8: torch.int8}[cfg.nbits]
    half = 1 << (cfg.nbits - 1)
    leaves = [torch.randint(-half, half, (n_layers, nb, bs) + f, generator=gen, device=dev,
                            dtype=signed).view(cfg.storage_dtype) for f in feats]
    one = [torch.randn((b,) + f, generator=gen, device=dev).to(torch.bfloat16)
           for f in feats]
    chunk = [torch.randn((n_layers, b, c) + f, generator=gen, device=dev).to(torch.bfloat16)
             for f in feats]
    geo = dict(n_blocks=nb, block_size=bs, window=window)
    return dict(leaves=leaves, one=one, chunk=chunk, tables=tables, pos=pos, ok=ok,
                stop=pos + n_valid, window=window, geo=geo,
                slots=L.paged_write_slots(tables, pos, ok, **geo),
                index=L.paged_write_index(tables, pos, ok, **geo),
                pslots=L.paged_pack_slots(tables, pos, pos + n_valid, c, **geo).reshape(-1))


# the linear decode lanes' fused write: (leaf slots T, frontier, ring,
# per-slot feature shape); phi3's K and V of one layer (and past a wrap of
# a 48-slot ring, and past the capacity: every write dropped), hymba-1.5b's
# ring past its wrap, whisper-tiny's self leaves; and a rank's in (l):
# phi3's at 5 KV heads, hymba's ring at mp 5 (one KV head), whisper's self
# leaves at 3 heads
LINEAR_WRITES = {"phi3": (1024, 700, False, (10, 128)),
                 "phi3_ring48": (48, 1000, True, (10, 128)),
                 "phi3_past_capacity": (1024, 1024, False, (10, 128)),
                 "hymba_ring": (1024, 1500, True, (5, 64)),
                 "whisper_self": (448, 300, False, (6, 64)),
                 "phi3_mp2": (1024, 700, False, (5, 128)),
                 "hymba_ring_mp5": (1024, 1500, True, (1, 64)),
                 "whisper_self_mp2": (448, 300, False, (3, 64))}
LINEAR_WRITES_TIMED = ("phi3", "hymba_ring", "whisper_self", "phi3_mp2", "hymba_ring_mp5",
                       "whisper_self_mp2")


def check_linear_write(dev):
    """The fused write as the linear decode lanes launch it
    (``LINEAR_WRITES``): one layer's two leaves (8, T, G, D) posit16,
    each seen as an arena of 8 blocks of T slots, and bf16 rows written
    at the shared frontier (``pos % T`` on a ring); against its plain
    version bit for bit, every row written at that slot and nowhere
    else, and a write past the capacity dropped (the leaves unchanged).
    Returns its times on phi3's case beside the byte bound, and
    (``shapes``) on the other families' leaves."""
    from repro_torch.core.types import POSIT16, signed_view
    from repro_torch.kernels import posit_codec as C
    from repro_torch.models import layers as L

    cfg, b = POSIT16, 8
    gen = torch.Generator(device=dev).manual_seed(9)
    ok, timed = True, {}
    for key, (t, pos, ring, feat) in LINEAR_WRITES.items():
        leaves = [torch.randint(-32768, 32768, (b, t) + feat, generator=gen, device=dev,
                                dtype=torch.int16).view(torch.uint16) for _ in range(2)]
        rows = [torch.randn((b,) + feat, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2)]
        slots = L.linear_write_slots(b, t, pos, ring=ring, device=dev)
        got, want = [a.clone() for a in leaves], [a.clone() for a in leaves]
        C.paged_write(list(zip(got, rows)), slots, cfg)
        C.paged_write_plain(list(zip(want, rows)), slots, cfg)
        same = all(torch.equal(signed_view(g), signed_view(w)) for g, w in zip(got, want))
        slot = pos % t if ring or pos < t else None
        expect = torch.arange(t, device=dev) == (-1 if slot is None else slot)
        for g, a in zip(got, leaves):
            written = (signed_view(g) != signed_view(a)).flatten(2).any(-1)     # (B, T)
            same = same and bool((written == expect[None, :]).all())
        print(f"fused paged write, linear decode lane {key} (K and V (8, {t}) + {feat}, "
              f"frontier {pos}{', a ring' if ring else ''}): equal to quantize_plain + "
              f"scatter, every row written at slot {slot} alone: {same}")
        ok = ok and same
        if key in LINEAR_WRITES_TIMED:
            timed[key] = (list(zip(leaves, rows)), slots)
        del got, want
    if not ok:
        fail("posit_paged_write differs from its plain version on a linear decode lane")
    out = {}
    for key, (jobs, slots) in timed.items():
        width = jobs[0][1][0].numel()
        r = dict(ms=time_ms(lambda: C.paged_write(jobs, slots, cfg)),
                 kernel_ms=kernel_alone_ms(C.paged_write_call(jobs, slots, cfg)),
                 plain_ms=time_ms(lambda: C.paged_write_plain(jobs, slots, cfg), iters=5),
                 **_bound(2 * b * width * (2 + 2) + slots.numel() * 8, 0, FP32_FLOPS),
                 shape=[2, b, LINEAR_WRITES[key][0]] + list(LINEAR_WRITES[key][3]))
        out[key] = r
        print(f"posit_paged_write linear decode {key} (K and V, 8 rows x {width} into "
              f"{r['shape'][1:]} leaves): {r['ms']:.4f} ms, alone {r['kernel_ms']:.4f} ms "
              f"(bound {r['bound_ms']:.6f} ms by {r['bound_by']}; plain "
              f"{r['plain_ms']:.4f} ms)")
    r = out.pop("phi3")
    r["shapes"] = out
    return r


def decode_jobs(arenas, one):
    """The main path's decode write: layer 0 of both leaves, one launch."""
    return [(a[0], x) for a, x in zip(arenas, one)]


def prefill_jobs(arena, chunk):
    """The main path's prefill write of one leaf: every layer, one launch."""
    return [(arena[li], x.reshape((-1,) + x.shape[2:])) for li, x in enumerate(chunk)]


def check_paged_write(dev):
    """The fused quantize-and-write against ``quantize_plain`` and the
    masked scatter it replaces (``layers.paged_write`` for a decode
    token, ``layers.paged_pack_range`` for a prefill chunk), arena bit
    for bit, on every lane's leaves (``LANES``) in posit16 and posit8,
    at the main paths' launches: a decode token's two leaves, and a
    prefill chunk's leaf of all the model's layers; dropped
    rows and sentinel entries leave their slots untouched.  Returns the
    kernel row, timed on the posit16 dense case's arenas and jobs, and
    the function that adds its profiler readings (``time_paged_write``)."""
    from repro_torch.core.types import POSIT8, POSIT16, signed_view
    from repro_torch.kernels import posit_codec as C
    from repro_torch.models import layers as L

    def same(x, y):
        return torch.equal(signed_view(x), signed_view(y))

    row = None
    for cfg in (POSIT16, POSIT8):
        for lane in LANES:
            k = write_case(dev, cfg, lane, seed=6)
            n_layers, index = LANES[lane][0], k["index"]
            # decode: one token per row into layer 0 of each leaf
            got = [a.clone() for a in k["leaves"]]
            want = [a.clone() for a in k["leaves"]]
            C.paged_write(decode_jobs(got, k["one"]), k["slots"], cfg)
            for a, x in zip(want, k["one"]):
                L.paged_write(a[0], C.quantize_plain(x.float(), cfg), index)
            changed = sum(int((signed_view(g[0]) != signed_view(a[0])).flatten(2)
                              .any(-1).sum()) for g, a in zip(got, k["leaves"]))
            ok = all(same(g, x) for g, x in zip(got, want)) and \
                changed <= 2 * len(index[0]) and len(index[0]) == 6
            # prefill chunk: positions [pos, stop) of every layer, a launch per leaf
            got = [a.clone() for a in k["leaves"]]
            want = [a.clone() for a in k["leaves"]]
            for a, x in zip(got, k["chunk"]):
                C.paged_write(prefill_jobs(a, x), k["pslots"], cfg)
            for a, x in zip(want, k["chunk"]):
                L.paged_pack_range(a, C.quantize_plain(x.float(), cfg), k["tables"],
                                   k["pos"], k["stop"], window=k["window"])
            layers_written = min(int((signed_view(w) != signed_view(a)).flatten(1)
                                     .any(-1).sum()) for w, a in zip(want, k["leaves"]))
            ok = ok and layers_written == n_layers and \
                all(same(g, x) for g, x in zip(got, want))
            print(f"fused paged write {lane} {cfg.name}: decode (2 jobs) and prefill "
                  f"chunk ({n_layers} jobs a leaf, {int(k['pslots'].numel())} rows) "
                  f"arenas equal to quantize_plain + scatter: {ok} ({changed} slots "
                  f"written by the decode token, {layers_written} layers by the chunk)")
            if not ok:
                fail(f"posit_paged_write {lane} {cfg.name} differs from "
                     "quantize_plain + the masked scatter")
            del got, want
            if cfg is POSIT16 and lane == "dense":
                row, profile = time_paged_write(k, cfg)
            if cfg is POSIT16 and lane == "dense-mp2":
                tp_row = time_paged_write(k, cfg)[0]
            del k
    row["tp_mp2"] = {key: tp_row[key] for key in (
        "shape", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "prefill")}
    return row, profile


def time_paged_write(k, cfg):
    """Times of the fused write on a checked case's arenas: phi3's decode
    token (K and V of one layer) and one leaf of a prefill chunk (40
    layers x 8 rows x 16 tokens), wrapper-timed and alone, beside the old
    pair timed the same ways; the byte bound counts the kept rows' bf16
    sources read and posit16 patterns written, and the destinations.
    Returns the row and a function that adds both launches' device times
    from ``torch.profiler``: called after the serving paths, so that no
    profiler session precedes their walls."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.launch.timing import device_ms
    from repro_torch.models import layers as L

    slots, index, pslots = k["slots"], k["index"], k["pslots"]
    jobs = decode_jobs(k["leaves"], k["one"])

    def old():
        for a, x in jobs:
            L.paged_write(a, C.quantize(x.to(torch.float32).contiguous(), cfg), index)

    kept = int((slots >= 0).sum())
    width = jobs[0][1][0].numel()
    arena, src = k["leaves"][0], k["chunk"][0]
    n_layers = src.shape[0]
    pjobs = prefill_jobs(arena, src)

    def old_prefill():
        stacked = torch.stack([C.quantize(x.to(torch.float32).contiguous(), cfg)
                               for x in src])
        L.paged_pack_range(arena, stacked, k["tables"], k["pos"], k["stop"],
                           window=k["window"])

    pkept = int((pslots >= 0).sum())
    prefill = dict(
        ms=time_ms(lambda: C.paged_write(pjobs, pslots, cfg)),
        kernel_ms=kernel_alone_ms(C.paged_write_call(pjobs, pslots, cfg)),
        old_pair_ms=time_ms(old_prefill),
        old_pair_alone_ms=kernel_alone_ms(lambda: (old_prefill(), 0)[1]),
        **_bound(n_layers * pkept * width * (2 + 2) + pslots.numel() * 8, 0, FP32_FLOPS),
        shape=[n_layers, int(pslots.numel())] + list(src.shape[3:]))
    row = dict(
        name="posit_paged_write", route="cuda",
        source="src/repro_torch/csrc/posit_paged_write.cu",
        replaces="src/repro/kernels/posit_codec.py:46", launches=0, max_abs_err=0.0,
        ms=time_ms(lambda: C.paged_write(jobs, slots, cfg)),
        kernel_ms=kernel_alone_ms(C.paged_write_call(jobs, slots, cfg)),
        # an empty kernel through the same C call: with the 2-job table of
        # this launch, and (a third job) with the 128-job table
        floor_ms=kernel_alone_ms(C.paged_write_call(jobs, slots, cfg, floor=True)),
        floor_128_ms=kernel_alone_ms(C.paged_write_call(jobs + jobs[:1], slots, cfg,
                                                        floor=True)),
        old_pair_ms=time_ms(old),
        old_pair_alone_ms=kernel_alone_ms(lambda: (old(), 0)[1]),
        plain_ms=time_ms(lambda: C.paged_write_plain(jobs, slots, cfg), iters=5),
        **_bound(2 * kept * width * (2 + 2) + slots.numel() * 8, 0, FP32_FLOPS),
        library_ms=None, shape=[2, int(slots.numel())] + list(k["one"][0].shape[1:]),
        prefill=prefill)

    print(f"posit_paged_write decode: launch floor {row['floor_ms']:.4f} ms alone (an empty "
          f"kernel through the same call; {row['floor_128_ms']:.4f} ms with the 128-job "
          f"table)")
    print(f"posit_paged_write decode (K and V, 8 rows x {width:,}): {row['ms']:.4f} ms, "
          f"alone {row['kernel_ms']:.4f} ms; old quantize + scatter pair "
          f"{row['old_pair_ms']:.4f} ms, alone {row['old_pair_alone_ms']:.4f} ms. "
          f"Prefill chunk ({n_layers} layers x 128 rows x {width:,}): {prefill['ms']:.4f} ms, "
          f"alone {prefill['kernel_ms']:.4f} ms; old {prefill['old_pair_ms']:.4f} "
          f"ms, alone {prefill['old_pair_alone_ms']:.4f} ms (bound "
          f"{prefill['bound_ms']:.5f} ms)")

    def profile():
        row["device_ms"] = device_ms(C.paged_write_call(jobs, slots, cfg), "paged_write_kernel")
        prefill["device_ms"] = device_ms(C.paged_write_call(pjobs, pslots, cfg),
                                         "paged_write_kernel")

        def ms4(t):
            return "not measured" if t is None else f"{t:.4f} ms"

        print(f"posit_paged_write device time (torch.profiler, after the serving paths): "
              f"decode {ms4(row['device_ms'])}, prefill leaf {ms4(prefill['device_ms'])}")

    return row, profile


def read_case(dev, cfg, lane, seed):
    """The arena leaves of one of ``LANES`` at its model's depth and width
    (e.g. phi3's 40 layers of K and V, dense or on a 48-token window ring;
    minicpm3's 62 layers of latent and RoPE key), 512 blocks of 16 slots of random
    patterns, read as a prefill chunk of the main path reads them: 8 rows
    of a 64-entry virtual table (max_len 1024) at ragged lens, sentinel
    entries past each dense row's blocks, one all-masked row; the window
    ring's read starts past position 0."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    b, bs, nb, vw = 8, 16, 512, 64
    n_layers, feats, window = LANES[lane]
    lens = torch.tensor([1000, 700, 512, 300, 900, 64, 1020, 0])
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(seed))
    w = L.paged_window_blocks(window, bs) if window else vw
    tables = perm[:b * w].reshape(b, w).to(torch.int32)
    if not window:
        for i, n in enumerate(lens.tolist()):
            tables[i, -(-n // bs):] = nb
    vtables, low_pos = T._chunk_virtual_tables(tables.to(dev), lens.to(dev), bs, window,
                                               vw, nb)
    gen = torch.Generator(device=dev).manual_seed(seed)
    signed = {16: torch.int16, 8: torch.int8}[cfg.nbits]
    half = 1 << (cfg.nbits - 1)
    leaves = [torch.randint(-half, half, (n_layers, nb, bs) + f, generator=gen, device=dev,
                            dtype=signed).view(cfg.storage_dtype) for f in feats]
    return dict(leaves=leaves, vtables=vtables.contiguous(),
                lens=lens.to(dev, torch.int64), low_pos=low_pos.to(torch.int64).contiguous())


def check_paged_read(dev):
    """The fused chunked-prefill read against its plain version (gather,
    ``dequantize_plain``, the cast, the mask), bf16 out as the main path
    reads, bit for bit through an integer view (NaN patterns count), on
    every lane's leaves (``LANES``) in posit16 and posit8, every layer
    of the model's depth read as the main path reads it (one launch a
    layer, both leaves); f32 out on layer 0 too.  Returns the kernel row,
    timed on the posit16 dense case."""
    from repro_torch.core.types import POSIT8, POSIT16
    from repro_torch.kernels import posit_codec as C

    row = None
    for cfg in (POSIT16, POSIT8):
        for lane in LANES:
            k = read_case(dev, cfg, lane, seed=8)
            geo = (k["vtables"], k["lens"], k["low_pos"])
            ok, n_layers = True, k["leaves"][0].shape[0]
            for li in range(n_layers):
                arenas = [leaf[li] for leaf in k["leaves"]]
                for out, iv in ((torch.bfloat16, torch.int16), (torch.float32, torch.int32)):
                    if out is torch.float32 and li:
                        continue
                    got = C.paged_read(arenas, *geo, cfg, out)
                    want = C.paged_read_plain(arenas, *geo, cfg, out)
                    ok = ok and all(torch.equal(g.view(iv), x.view(iv))
                                    for g, x in zip(got, want))
            print(f"fused paged read {lane} {cfg.name}: {n_layers} layers (both leaves a "
                  f"launch) equal to gather + dequantize_plain + cast + mask: {ok}")
            if not ok:
                fail(f"posit_paged_read {lane} {cfg.name} differs from its plain version")
            if cfg is POSIT16 and lane == "dense":
                row = time_paged_read(k, cfg)
            if cfg is POSIT16 and lane == "dense-mp2":
                tp_row = time_paged_read(k, cfg)
            del k
    row["tp_mp2"] = {key: tp_row[key] for key in (
        "shape", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")}
    return row


def time_paged_read(k, cfg):
    """Times of one layer's read (K and V) on a checked case, bf16 out:
    wrapper-timed and alone, beside the chain it replaced (per leaf
    ``paged_gather``, the ``posit_dequantize`` kernel, the cast and the
    mask) timed the same ways.  The byte bound counts each resident
    pattern read once and every output written once; the operation
    bound a decode per resident pattern."""
    from repro_torch.kernels import posit_codec as C
    from repro_torch.models import layers as L

    vt, lens, low = k["vtables"], k["lens"], k["low_pos"]
    arenas = [leaf[0] for leaf in k["leaves"]]
    b, vw = vt.shape
    bs = arenas[0].shape[1]
    t_len = vw * bs
    apos = torch.arange(t_len, device=vt.device)[None, :]
    resident = (apos < lens[:, None]) & (apos >= low[:, None])
    n_res = int(resident.sum())
    width = sum(a[0, 0].numel() for a in arenas)

    def old():
        for a in arenas:
            g = C.dequantize(L.paged_gather(a, vt), cfg)
            C.zero_invalid(g.to(torch.bfloat16), resident)

    args = (arenas, vt, lens, low, cfg, torch.bfloat16)
    row = dict(
        name="posit_paged_read", route="cuda",
        source="src/repro_torch/csrc/posit_paged_read.cu",
        replaces="src/repro/kernels/posit_codec.py:61", launches=0, max_abs_err=0.0,
        ms=time_ms(lambda: C.paged_read(*args)),
        kernel_ms=kernel_alone_ms(C.paged_read_call(*args)[0]),
        old_chain_ms=time_ms(old),
        old_chain_alone_ms=kernel_alone_ms(lambda: (old(), 0)[1]),
        plain_ms=time_ms(lambda: C.paged_read_plain(*args), iters=5),
        **_bound(n_res * width * cfg.nbits // 8 + b * t_len * width * 2 + vt.numel() * 4
                 + 2 * b * 8, n_res * width * OPS_DECODE, INT_OPS),
        library_ms=None, shape=[2, b, vw, bs] + list(arenas[0].shape[2:]))
    print(f"posit_paged_read one layer (K and V, 8 rows x 1 024 slots x {width // 2:,}, {n_res} "
          f"resident slots, bf16 out): {row['ms']:.4f} ms, alone {row['kernel_ms']:.4f} "
          f"ms; old gather + dequantize + cast + mask {row['old_chain_ms']:.4f} ms, alone "
          f"{row['old_chain_alone_ms']:.4f} ms (bound {row['bound_ms']:.5f} ms by "
          f"{row['bound_by']})")
    return row


def serve_main_path(argv):
    """The user entry point at full width; returns the serving result,
    the launch counts of exactly this run, its wall time and the numbers
    of decode steps and prefill chunks it ran."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    decode_step, prefill_chunk = T._decode_step_paged, T.prefill_chunk
    steps, chunks = [0], [0]

    def counted(*a, **kw):
        steps[0] += 1
        return decode_step(*a, **kw)

    def counted_chunk(*a, **kw):
        chunks[0] += 1
        return prefill_chunk(*a, **kw)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    T._decode_step_paged, T.prefill_chunk = counted, counted_chunk
    try:
        t0 = time.perf_counter()
        res = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        T._decode_step_paged, T.prefill_chunk = decode_step, prefill_chunk
    return res, read_counts(), wall, steps[0], chunks[0]


def check_served(res, n_requests=16):
    """Every request completed, every token in the vocabulary; on a paged
    pool no block leaked and the pool drained (under prefix caching, down
    to the blocks the prefix index holds)."""
    sched = res.sched
    vocab = sched.engine.cfg.vocab
    if len(res.done) != n_requests:
        fail(f"served {len(res.done)} of {n_requests} requests")
    for c in res.done.values():
        if c.tokens.size == 0 or c.tokens.min() < 0 or c.tokens.max() >= vocab:
            fail(f"request {c.rid} produced out-of-vocabulary tokens")
    if not sched.paged:
        return
    if sched.leak_report():
        fail(f"{len(sched.leak_report())} blocks leaked")
    held = len(sched.index) if sched.prefix_cache else 0
    if sched.pool.in_use != held:
        fail(f"{sched.pool.in_use - held} blocks still in use after the trace")


def report_served(name, res, counts, wall, steps, chunks):
    from repro_torch.compress import kvcache as kvc

    sched = res.sched
    st = sched.stats
    useful = sum(len(c.tokens) for c in res.done.values())
    arena = sum(sched.cache[k].numel() * sched.cache[k].element_size()
                for k in kvc.arena_leaves(sched.cache))
    peak_arena = arena * sched.pool.peak_in_use // sched.n_blocks
    print(f"main path {name}: full width, {len(res.done)} requests, "
          f"{useful} tokens in {res.seconds:.2f} s ({wall:.2f} s with init); "
          f"goodput {useful / max(sched.steps_run, 1):.3f} tok/step, "
          f"{useful / res.seconds:.2f} tok/s; step wall p50 "
          f"{st['step_wall_p50_ms']:.1f} ms p99 {st['step_wall_p99_ms']:.1f} ms "
          f"over {sched.n_chunks} rounds, {steps} decode steps, {chunks} prefill "
          f"chunks; peak arena "
          f"bytes {peak_arena:,} of {arena:,}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if sched.prefix_cache:
        met, timed = res.deadlines_met or (0, 0)
        print(f"main path {name}: {sched.prefix_hits} prefix hits "
              f"({sched.prefix_matched_tokens} prompt tokens from cache), "
              f"{sched.n_cow} COW copies, {sched.n_evicted} evictions, "
              f"{sched.n_preempted} preemptions, deadlines met {met}/{timed}")
    print(f"main path {name} kernel launches: {counts}")


def check_fused_equals_gather(dev):
    """The repo's own invariant on a small input, on the card: the fused
    decode kernels and the gather path give the same greedy tokens, on
    the dense and MLA lanes."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import drive_trace, poisson_trace
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import Scheduler

    for arch in ("phi3-medium-14b", "minicpm3-4b"):
        cfg = dataclasses.replace(
            configs.get_config(arch).reduced(compute_dtype="float32"),
            kv_posit="posit16")
        params = T.init_params(cfg, seed=3, device=dev)
        trace = poisson_trace(np.random.default_rng(3), 6, 0.5, cfg.vocab,
                              24, 12)
        streams = []
        for kernel in ("fused", "gather"):
            eng = Engine(cfg, params, max_len=48, paged=True, block_size=4,
                         decode_kernel=kernel, device=dev)
            done, order = drive_trace(Scheduler(eng, n_slots=3, chunk_size=4,
                                                chunked_prefill=True), trace)
            streams.append({order[r]: c.tokens.tolist() for r, c in done.items()})
        same = streams[0] == streams[1]
        print(f"small input (reduced {arch}, posit16 KV): fused == gather "
              f"tokens: {same}")
        if not same:
            fail(f"fused decode kernel and gather path disagree on the card "
                 f"({arch})")


def check_fused_equals_gather_full(name, served):
    """The fused decode kernel against the gather path on a main path's
    own weights at full width: 8 ragged prompts of 64-128 tokens through
    a paged engine, 16 greedy tokens with each decode attention.  Both
    attend in f32 over the same posit KV in other orders, and the model
    rounds to bf16, so a near-tie may flip a token: the gather stream is
    then fed to both engines (teacher-forced) and the fused logits must
    lie within ``FORCED_TOL`` of the gather logits' spread, every argmax
    flip at a near-tie (the rule of ``check_ragged_rows``)."""
    from repro_torch.runtime.engine import Engine

    cfg, params = served.cfg, served.params
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab, int(n)).tolist()
               for n in rng.integers(64, 129, size=8)]
    engines = {k: Engine(cfg, params, max_len=256, paged=True, block_size=16,
                         decode_kernel=k, device=served.device) for k in ("fused", "gather")}
    toks = {k: eng.generate(prompts, 16).tokens for k, eng in engines.items()}
    same = int((toks["fused"] == toks["gather"]).sum())
    want = forced_logits(engines["gather"], prompts, toks["gather"])
    got = forced_logits(engines["fused"], prompts, toks["gather"])
    if not torch.equal(want.argmax(-1).cpu(), torch.as_tensor(toks["gather"], dtype=torch.int64)):
        fail(f"the {name} gather engine's teacher-forced run does not reproduce its tokens")
    diff = (got - want).abs().amax(-1)
    rel = float((diff / want.std(-1)).max())
    top2 = want.topk(2, dim=-1).values
    flips = got.argmax(-1) != want.argmax(-1)
    near_tie = bool(((top2[..., 0] - top2[..., 1]) <= 2 * diff)[flips].all())
    print(f"main path {name}: fused == gather on the served weights: {same} of "
          f"{toks['gather'].size} greedy tokens equal; teacher-forced logits max |diff| "
          f"{float(diff.max()):.5f}, {rel:.5f} of the spread (limit {FORCED_TOL}), "
          f"{int(flips.sum())} argmax flips, all at near-ties: {near_tie}")
    if rel > FORCED_TOL or not near_tie:
        fail(f"the fused decode kernel and the gather path disagree on the {name} path")


def check_prefix_identity(dev):
    """On the card, reduced minicpm3 with f32 KV under the sanitizer:
    prefix caching changes no greedy token.  Exact duplicate prompts
    make admission copy blocks; freed blocks are poisoned."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import Scheduler

    cfg = dataclasses.replace(
        configs.get_config("minicpm3-4b").reduced(compute_dtype="float32"))
    params = T.init_params(cfg, seed=5, device=dev)
    rng = np.random.default_rng(5)
    shared = rng.integers(1, cfg.vocab, 24).tolist()
    prompts = [shared, list(shared), list(shared) + [7, 9, 11],
               shared[:16] + rng.integers(1, cfg.vocab, 6).tolist()]
    streams, scheds = [], []
    for prefix in (False, True):
        eng = Engine(cfg, params, max_len=64, paged=True, block_size=4, n_blocks=48,
                     sanitize=True, decode_kernel="fused", device=dev)
        sched = Scheduler(eng, n_slots=2, chunk_size=4, prefix_cache=prefix,
                          chunked_prefill=True)
        rids = [sched.submit(prompts[0], 8)]
        done = sched.run(max_rounds=200)
        rids += [sched.submit(p, 8) for p in prompts[1:]]
        done.update(sched.run(max_rounds=200))
        streams.append([done[r].tokens.tolist() for r in rids])
        scheds.append(sched)
    s = scheds[1]
    same = streams[0] == streams[1]
    print(f"small input (reduced minicpm3-4b, f32 KV, sanitizer): prefix "
          f"cache == no prefix cache tokens: {same}; {s.prefix_hits} hits, "
          f"{s.n_cow} COW copies, {len(s.leak_report())} leaked blocks")
    if not same or s.prefix_hits == 0 or s.n_cow == 0 or s.leak_report():
        fail("prefix caching changed tokens or did not share on the card")


def schedule_of(res, compactions):
    """A scheduler run's schedule: rounds, decode steps, compactions and
    each request's admission step, in request order."""
    sched = res.sched
    return dict(rounds=sched.n_chunks, steps=sched.steps_run, compactions=compactions,
                admitted=[res.done[r].admitted_step for r in sorted(res.done)])


def serve_linear_path(argv):
    """One of ``LINEAR_PATHS`` through the user entry point: returns what
    ``serve.main`` returns, the launch counts of exactly this run, its
    wall time, the numbers of whole-prompt prefills (the engine's), the
    prompt tokens they ran (padded), the decode steps (the engine's, for
    every family) and compactions, and (one-shot) the run's
    ``OneShotResult``."""
    from repro_torch.compress import kvcache as kvc
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import Engine

    real = dict(prefill=Engine.prefill, step=Engine._step, compact=kvc.compact,
                oneshot=serve.run_oneshot)
    n = dict(prefill=0, prompt_tokens=0, step=0, compact=0)
    captured = []

    def prefill(self, prompts, **kw):
        n["prefill"] += 1
        n["prompt_tokens"] += self.pack_prompts(prompts)[0].shape[1]
        return real["prefill"](self, prompts, **kw)

    def step(self, *a, **kw):
        n["step"] += 1
        return real["step"](self, *a, **kw)

    def compact(*a, **kw):
        n["compact"] += 1
        return real["compact"](*a, **kw)

    def oneshot(*a, **kw):
        captured.append(real["oneshot"](*a, **kw))
        return captured[-1]

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    Engine.prefill, Engine._step, kvc.compact = prefill, step, compact
    serve.run_oneshot = oneshot
    try:
        t0 = time.perf_counter()
        res = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Engine.prefill, Engine._step = real["prefill"], real["step"]
        kvc.compact, serve.run_oneshot = real["compact"], real["oneshot"]
    return res, read_counts(), wall, n, captured[0] if captured else None


def check_linear_counts(name, counts, expect, n_layers, n):
    """Every kernel of the path launched exactly ``n_layers`` x (its
    per-prefill count x prefills + its per-step count x decode steps +
    its per-prompt-token count, if it has one, x prompt tokens) times,
    every other kernel never."""
    for kernel, got in counts.items():
        per_prefill, per_step, per_token = (tuple(expect.get(kernel, ())) + (0, 0, 0))[:3]
        want = n_layers * (per_prefill * n["prefill"] + per_step * n["step"]
                           + per_token * n["prompt_tokens"])
        if got != want:
            fail(f"{kernel} ran {got} times on the {name} path, {want} expected "
                 f"({n['prefill']} prefills of {n['prompt_tokens']} prompt tokens, "
                 f"{n['step']} decode steps, {n_layers} layers)")
        if kernel in expect and got <= 0:
            fail(f"kernel {kernel} was not launched on the {name} path")


# Ragged rows against their singleton generations on the card: the
# singleton is fed the batched row's tokens (teacher-forced) and its logits
# at each of the 32 positions must lie within this share of the batched
# row's logit spread (std over the vocabulary).  bf16 logits carry 8 bits
# and the batch-8 and batch-1 GEMMs round differently in every layer, so
# greedy streams of a random-weight model part at near-ties (on an H100,
# 9 and 11 of 32 tokens equal); a mask or position fault moves
# logits by the whole spread.  Where the argmax differs, the batched
# row's top-2 gap must be within twice that position's max difference.
# The exact token identity is held on the CPU in f32
# (tests/test_torch_engine.py).
FORCED_TOL = 0.25


def forced_logits(eng, prompts, tokens, **inputs):
    """(B, n, V) logits of a prefill (with whisper's ``frames`` or a
    visual prefix in ``inputs``) and n - 1 decode steps fed ``tokens``
    (B, n) in place of their own samples."""
    n = tokens.shape[1]
    cache, logits, _ = eng.prefill(prompts, reserve_tokens=n - 1, **inputs)
    tok = torch.as_tensor(tokens, dtype=torch.int64, device=eng.device)
    out = [logits]
    for j in range(n - 1):
        logits, cache = eng._step(cache, tok[:, j])
        out.append(logits)
    return torch.stack(out, 1)


def check_ragged_rows(name, eng, prompts, tokens, lens):
    """The shortest and the longest ragged row against their singleton
    generations: greedy tokens compared (reported), and the singleton's
    teacher-forced logits held to the batched row's within
    ``FORCED_TOL`` of its spread."""
    batched = forced_logits(eng, prompts, tokens)
    if not torch.equal(batched.argmax(-1).cpu(), torch.as_tensor(tokens, dtype=torch.int64)):
        fail(f"the {name} path's teacher-forced batch does not reproduce its own tokens")
    for i in (int(np.argmin(lens)), int(np.argmax(lens))):
        solo = eng.generate([prompts[i]], tokens.shape[1]).tokens[0]
        single = forced_logits(eng, [prompts[i]], tokens[i:i + 1])[0]
        want = batched[i]
        diff = (single - want).abs().amax(-1)
        rel = float((diff / want.std(-1)).max())
        top2 = want.topk(2, dim=-1).values
        flips = single.argmax(-1).cpu() != torch.as_tensor(tokens[i], dtype=torch.int64)
        near_tie = bool(((top2[:, 0] - top2[:, 1]) <= 2 * diff).cpu()[flips].all())
        print(f"linear path {name}: ragged row {i} (len {int(lens[i])}) against its "
              f"singleton: {int((solo == tokens[i]).sum())} of {tokens.shape[1]} greedy "
              f"tokens equal; teacher-forced logits max |diff| {float(diff.max()):.4f}, "
              f"{rel:.4f} of the spread (limit {FORCED_TOL}), {int(flips.sum())} argmax "
              f"flips, all at near-ties: {near_tie}")
        if rel > FORCED_TOL or not near_tie:
            fail(f"ragged row {i} of the {name} path differs from its singleton "
                 "generation beyond bf16 rounding")


def run_linear_paths(dev, names):
    """The paths ``names`` of ``LINEAR_PATHS``: launch counts, outputs,
    the pinned schedules, and on the one-shot path ``generate`` ==
    ``generate_stepwise`` and two ragged rows against their singleton
    generations, on the card.  Returns each path's launch counts."""
    by_path = {}
    for name in names:
        argv, expect = LINEAR_PATHS[name]
        res, counts, wall, n, oneshot = serve_linear_path(argv)
        cfg_layers = (oneshot.engine if oneshot else res.sched.engine).cfg.n_layers
        check_linear_counts(name, counts, expect, cfg_layers, n)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if oneshot is not None:
            tokens, eng, prompts = res, oneshot.engine, oneshot.prompts
            vocab = eng.cfg.vocab
            if tokens.shape != (len(prompts), 32) or tokens.min() < 0 \
                    or tokens.max() >= vocab \
                    or not np.isfinite(oneshot.result.prefill_logits).all():
                fail(f"the {name} path gave {tokens.shape} tokens outside the vocabulary "
                     "or non-finite prefill logits")
            print(f"linear path {name}: full width, {len(prompts)} prompts "
                  f"(lens {oneshot.result.prompt_lens.tolist()}), prefill (the report) "
                  f"{oneshot.prefill_seconds:.2f} s, generate {oneshot.seconds:.2f} s for "
                  f"{tokens.size} tokens ({tokens.size / oneshot.seconds:.2f} tok/s, prefill "
                  f"included); {wall:.2f} s with init; {n['prefill']} prefills, "
                  f"{n['step']} decode steps; peak device memory {peak:.2f} GiB; {CARD}")
            inputs = oneshot.inputs
            same = bool((eng.generate_stepwise(prompts, 32, **inputs).tokens == tokens).all())
            print(f"linear path {name}: generate == generate_stepwise tokens: {same}"
                  f"{' (with its ' + ', '.join(inputs) + ')' if inputs else ''}")
            if not same:
                fail(f"generate and generate_stepwise disagree on the {name} path")
            for key in ("visual", "frames"):
                if key not in inputs:
                    continue
                # the input must reach the logits: without the visual
                # prefix, or with zero frames, they move
                other = {"frames": torch.zeros_like(inputs["frames"])} if key == "frames" \
                    else {}
                plain = eng.prefill(prompts, **other)[1]
                moved = float((plain - torch.as_tensor(
                    oneshot.result.prefill_logits, device=plain.device)).abs().max())
                print(f"linear path {name}: prefill logits "
                      f"{'with zero frames' if other else 'without the visual prefix'} "
                      f"differ by up to {moved:.4f}")
                if not moved > 0:
                    fail(f"the {key} input did not reach the {name} path's logits")
            lens = oneshot.result.prompt_lens
            if len(set(lens.tolist())) > 1:
                check_ragged_rows(name, eng, prompts, tokens, lens)
            del eng, oneshot
        else:
            sched = res.sched
            check_served(res)
            got = schedule_of(res, n["compact"])
            useful = sum(len(c.tokens) for c in res.done.values())
            st = sched.stats
            print(f"linear path {name}: full width, {len(res.done)} requests, {useful} "
                  f"tokens in {res.seconds:.2f} s ({wall:.2f} s with init), "
                  f"{useful / res.seconds:.2f} tok/s; step wall p50 "
                  f"{st['step_wall_p50_ms']:.1f} ms p99 {st['step_wall_p99_ms']:.1f} ms; "
                  f"{got['rounds']} rounds, {n['step']} decode steps, {n['prefill']} "
                  f"prefills, {got['compactions']} compactions; peak device memory "
                  f"{peak:.2f} GiB")
            if got != SCHEDULES[name]:
                fail(f"the {name} schedule {got} differs from the one pinned on the "
                     f"CPU {SCHEDULES[name]}")
            if not sched.paged and bool((sched.cache["lens"] != 0).any()):
                fail(f"the {name} path left live rows in its cache")
            del sched          # its engine holds the weights: free them for the next path
        for kernel, per in expect.items():
            if per[1]:
                # a prompt token of a prefill that steps the decoder counts as a step
                stepped = n["step"] + (n["prompt_tokens"] if per[2:] else 0)
                print(f"linear path {name}: {kernel} launches per decode step"
                      f"{' and prompt token' if per[2:] else ''} "
                      f"{counts[kernel] / max(stepped, 1):.2f} ({cfg_layers} layers)")
        print(f"linear path {name} kernel launches: {counts}")
        by_path[name] = counts
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return by_path


def check_hymba_ring(dev):
    """hymba-1.5b at full width and depth on posit16 KV, its window
    replaced by ``RING_WINDOW`` so that the ring wraps inside the smoke's
    time: ``RING_BATCH`` rows, a ``RING_PROMPT``-token prompt, then
    ``RING_STEPS`` decode steps.  At every decode step every SWA layer's
    ring K and V change at slot ``pos % RING_WINDOW`` of every row and
    nowhere else (the global layers' ring leaves not at all), and the
    global layers' prompt slots stay as the prefill left them while their
    decode writes land in the headroom."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.types import signed_view
    from repro_torch.models import hymba

    published = configs.get_config("hymba-1.5b")
    cfg = dataclasses.replace(published, sliding_window=RING_WINDOW, kv_posit="posit16")
    params = hymba.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(1, cfg.vocab, (RING_BATCH, RING_PROMPT), generator=gen, device=dev)
    t0 = time.perf_counter()
    cache, logits = hymba.prefill(params, tokens, cfg, max_len=RING_PROMPT + RING_STEPS)
    glb = [signed_view(cache[k][:, :, :RING_PROMPT]).clone() for k in ("k_glb", "v_glb")]
    t_ring = cache["k_swa"].shape[2]
    swa = [li for li in range(cfg.n_layers) if li not in cfg.global_layers]
    wrapped = 0
    for _ in range(RING_STEPS):
        pos = cache["len"]
        before = [signed_view(cache[k]).clone() for k in ("k_swa", "v_swa")]
        logits, cache = hymba.decode_step(params, cache, logits.argmax(-1), cfg)
        expect = torch.zeros((cfg.n_layers, RING_BATCH, t_ring), dtype=torch.bool, device=dev)
        expect[swa, :, pos % t_ring] = True
        for key, old in zip(("k_swa", "v_swa"), before):
            written = (signed_view(cache[key]) != old).flatten(3).any(-1)     # (L, B, T)
            if not torch.equal(written, expect):
                fail(f"hymba ring: decode at position {pos} wrote {key} slots "
                     f"{torch.nonzero(written != expect)[:4].tolist()} against slot "
                     f"{pos % t_ring} of the {len(swa)} SWA layers")
        wrapped += pos >= t_ring
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kept = all(torch.equal(signed_view(cache[k][:, :, :RING_PROMPT]), g)
               for k, g in zip(("k_glb", "v_glb"), glb))
    landed = bool(signed_view(cache["k_glb"][:, :, RING_PROMPT:]).ne(0)
                  .flatten(2).any(-1).all())
    finite = bool(torch.isfinite(logits).all())
    print(f"hymba ring check (hymba-1.5b, full width and depth, sliding_window replaced: "
          f"{RING_WINDOW} in place of the published {published.sliding_window}, which "
          f"cannot wrap in the smoke's time): {RING_BATCH} rows, a {RING_PROMPT}-token "
          f"prompt and {RING_STEPS} decode steps ({wrapped} past the wrap) in {wall:.2f} s; "
          f"each step wrote slot pos % {t_ring} of the {len(swa)} SWA layers alone; the "
          f"{len(cfg.global_layers)} global layers' prompt slots untouched: {kept}, their "
          f"decode writes in the headroom: {landed}; logits finite: {finite}")
    if not (kept and landed and finite and wrapped):
        fail("hymba ring: the global layers' prompt slots moved, their decode writes "
             "did not land, the logits are not finite or the ring did not wrap")


# ---------------------------------------------------------------------------
# The paged sliding-window lane: phi3-medium-14b with its window replaced
# ---------------------------------------------------------------------------

# phi3-medium-14b's published config has no window, and the command line
# no window flag: the lane replaces it by WINDOW (dataclasses.replace, as
# check_hymba_ring does), so that every prompt of _TRACE (256-512 tokens)
# outgrows the window; full width, 10 of its 40 layers (the smoke's time:
# the lane's reads are per layer, so a quarter of the depth checks the
# same ring)
WINDOW = 128
WINDOW_PATH = ("phi3-medium-14b-window",
               ["--arch", "phi3-medium-14b", "--n-layers", "10"] + _TRACE)


def check_main_counts(name, res, counts, steps, chunks, kernels):
    """A chunked main path's exact launch counts: its decode attention L
    a decode step, the fused read L a prefill chunk, the fused write L a
    decode step and one a leaf (all layers) a chunk; no other quantize
    or dequantize."""
    for kernel in kernels:
        if counts[kernel] <= 0:
            fail(f"kernel {kernel} was not launched on the {name} path")
    if counts["posit_quantize"]:
        fail(f"the {name} path quantized outside the fused paged write "
             f"({counts['posit_quantize']} posit_quantize launches)")
    if counts["posit_dequantize"]:
        fail(f"the {name} path dequantized outside the fused paged read "
             f"({counts['posit_dequantize']} posit_dequantize launches)")
    n_layers = res.sched.engine.cfg.n_layers
    attn = kernels[-1]
    print(f"main path {name}: {attn} launches per decode step "
          f"{counts[attn] / max(steps, 1):.2f} ({n_layers} layers)")
    if counts[attn] != n_layers * steps:
        fail(f"{attn} ran {counts[attn]} times in {steps} decode steps "
             f"of {n_layers} layers")
    if counts["posit_paged_read"] != n_layers * chunks:
        fail(f"posit_paged_read ran {counts['posit_paged_read']} times in "
             f"{chunks} prefill chunks of {n_layers} layers")
    if counts["posit_paged_write"] != n_layers * steps + 2 * chunks:
        fail(f"posit_paged_write ran {counts['posit_paged_write']} times in "
             f"{steps} decode steps and {chunks} prefill chunks of {n_layers} layers")


def run_window_lane(dev):
    """The paged window lane served end to end (``WINDOW_PATH``): exact
    launch counts; at every decode attention launch the block table is
    the window ring's width and the slots the kernel counts for each
    served row are exactly its last ``min(lens + 1, WINDOW)`` positions,
    each once (their number, range and sum; a free slot's row none);
    then the fused decode kernel against
    the gather path on the served weights.  Returns the launch counts."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import posit_paged_attn as K
    from repro_torch.models import layers as L

    name, argv = WINDOW_PATH
    published, fused = configs.get_config, K.paged_decode_attention
    seen = {"calls": 0, "off_ring": 0, "width": 0}
    bad = torch.zeros((), dtype=torch.bool, device=dev)

    def windowed(arch):
        cfg = published(arch)
        return dataclasses.replace(cfg, sliding_window=WINDOW) \
            if arch == "phi3-medium-14b" else cfg

    def checked(q, k_arena, v_arena, tables, apos, lens, *, pcfg=None, window=0):
        nonlocal bad
        seen["calls"] += 1
        seen["width"] = tables.shape[1]
        if window != WINDOW or tables.shape[1] != L.paged_window_blocks(
                WINDOW, k_arena.shape[1]):
            seen["off_ring"] += 1
        front = lens.to(torch.int64)[:, None] + 1            # positions < front
        a = apos.to(torch.int64)
        counted = (a >= 0) & (a < front) & (a >= front - WINDOW)
        lo = torch.clamp(front[:, 0] - WINDOW, min=0)
        n = counted.sum(1)
        series = (lo + front[:, 0] - 1) * (front[:, 0] - lo) // 2
        live = (tables < k_arena.shape[0]).any(1)          # a free slot's row reads nothing
        want_n = torch.where(live, front[:, 0] - lo, 0)
        want_sum = torch.where(live, series, 0)
        bad = bad | (n != want_n).any() \
            | (torch.where(counted, a, 0).sum(1) != want_sum).any()
        return fused(q, k_arena, v_arena, tables, apos, lens, pcfg=pcfg, window=window)

    configs.get_config, K.paged_decode_attention = windowed, checked
    try:
        res, counts, wall, steps, chunks = serve_main_path(argv)
    finally:
        configs.get_config, K.paged_decode_attention = published, fused
    check_served(res)
    report_served(name, res, counts, wall, steps, chunks)
    if res.sched.engine.cfg.sliding_window != WINDOW or not res.sched.engine.window_lane:
        fail(f"the {name} path did not serve the window lane")
    check_main_counts(name, res, counts, steps, chunks, _DENSE_KERNELS)
    in_window = not bool(bad) and not seen["off_ring"]
    print(f"main path {name}: sliding_window replaced ({WINDOW}; the published config "
          f"has none), tables {seen['width']} blocks wide; at each of {seen['calls']} decode "
          f"attention launches every row counted exactly its last min(len, {WINDOW}) "
          f"positions: {in_window}")
    if not in_window or seen["calls"] != counts["paged_decode_attention"]:
        fail(f"the {name} path read outside its window ({seen['off_ring']} launches off "
             f"the ring's width, counted slots wrong: {bool(bad)})")
    check_fused_equals_gather_full(name, res.sched.engine)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# (j) Tensor-parallel serving: two ranks sharing the one card
# ---------------------------------------------------------------------------

# The main path's flags with --model-parallel 2 on a shortened seeded
# trace (8 requests, prompts 96-192 tokens, generations 2-8), full width
# (depth cut so that the smoke fits its time: 10 of phi3's 40 layers, 16
# of minicpm3's 62): phi3-medium-14b (its KV heads split, 5 a rank: the arena
# head-sharded) and minicpm3-4b (its query heads split, 20 a rank; the
# latent arena whole on each rank), each against a single-rank run of
# the same trace on the same weights, run before it.
# The smoke needs one card, so the two ranks share it and talk over
# gloo (NCCL refuses two ranks on one device): no number here is a
# tensor-parallel speed.
_TP_TRACE = ["--continuous", "--paged", "--chunked-prefill", "--batch", "8",
             "--n-requests", "8", "--arrival-rate", "0.5", "--prompt-len", "192",
             "--gen", "8", "--max-len", "384", "--chunk-size", "16", "--block-size", "16",
             "--kv-posit", "posit16", "--decode-kernel", "fused", "--temperature", "0",
             "--seed", "0", "--device", "cuda"]
TP_DEVICES = ["cuda:0", "cuda:0"]
TP_RANKS = ["--model-parallel", "2", "--rank-devices", ",".join(TP_DEVICES)]
TP_PATHS = {   # argv, the path's kernels, whether the KV heads split
    "phi3-medium-14b": (["--arch", "phi3-medium-14b", "--n-layers", "10"] + _TP_TRACE,
                        _DENSE_KERNELS, True),
    "minicpm3-4b": (["--arch", "minicpm3-4b", "--n-layers", "16"] + _TP_TRACE,
                    MAIN_PATHS["minicpm3-4b"][1], False),
}
TP_FORCED = 8      # greedy tokens of the teacher-forced check


def tp_forced_rank(argv, devices, prompts, tokens):
    """One rank of the teacher-forced check (``launch/mesh.spawn``): this
    rank's shard of the served weights (``serve.rank_model``, as
    ``serve --model-parallel`` draws it), ``tokens`` fed after
    ``prompts``; returns its (B, n, V) logits as a host array."""
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import Engine

    args, mesh, cfg, params = serve.rank_model(argv, devices)
    eng = Engine(cfg, params, max_len=256, paged=True, block_size=16,
                 decode_kernel="fused", device=args.device, mesh=mesh)
    return forced_logits(eng, prompts, tokens).cpu().numpy()


def tp_single(argv, kernels, label):
    """The single-rank run of a (j) trace through the user entry point:
    exact launch counts; returns the result and what the ranks are held
    to (tokens, admission and finish steps, schedule counters, launches,
    cache report, arena bytes)."""
    from repro_torch.compress import kvcache as kvc

    res, counts, wall, steps, chunks = serve_main_path(argv)
    check_served(res, 8)
    report_served(label, res, counts, wall, steps, chunks)
    check_main_counts(label, res, counts, steps, chunks, kernels)
    sched = res.sched
    ref = dict(done={r: (c.tokens.tolist(), c.admitted_step, c.finished_step)
                     for r, c in res.done.items()},
               stats={k: sched.stats[k] for k in TP_STATS}, counts=counts,
               report=kvc.cache_report(sched.cache, sched.pool),
               arena=sum(sched.cache[k].numel() * sched.cache[k].element_size()
                         for k in kvc.arena_leaves(sched.cache)),
               seconds=res.seconds, tokens=sum(len(c.tokens) for c in res.done.values()))
    return res, ref


TP_STATS = ("prefix_hits", "n_preempted", "n_cow", "n_chunks", "steps_run", "n_leaked")


def tp_check_ranks(label, tp, ref, split, wall):
    """Every rank of a sharded run (``serve.ShardedServeResult``) held to
    the single rank's ``ref``: the schedule and its counters equal, no
    leak, every rank's tokens identical, each rank's launches exactly the
    single run's, the cache's bytes equal and, per device, the arena's
    share plus the metadata where the KV heads split (the whole cache
    where they do not).  Prints the run and returns its numbers."""
    mp = len(tp.ranks)
    r0 = tp.ranks[0]
    single = ref["done"]
    for rank, r in enumerate(tp.ranks):
        got = {i: (c.tokens.tolist(), c.admitted_step, c.finished_step)
               for i, c in r.done.items()}
        if set(got) != set(single) or any(got[i][1:] != single[i][1:] for i in single) \
                or any(r.stats[k] != ref["stats"][k] for k in TP_STATS):
            fail(f"{label} rank {rank}'s schedule differs from the single rank's")
        if any(got[i][0] != r0.done[i].tokens.tolist() for i in got):
            fail(f"{label} rank {rank}'s tokens differ from rank 0's")
        if any(r.launches[k] != ref["counts"][k] for k in r.launches):
            fail(f"{label} rank {rank} launched {r.launches}, the single rank "
                 f"{ {k: ref['counts'][k] for k in r.launches} }")
        rep = ref["report"]
        per_device = ref["arena"] // mp + rep["bytes"] - ref["arena"] if split \
            else rep["bytes"]
        if r.report["bytes"] != rep["bytes"] or r.report["per_device_bytes"] != per_device:
            fail(f"{label} rank {rank}: cache bytes {r.report['bytes']:,}, per device "
                 f"{r.report['per_device_bytes']:,}; want {rep['bytes']:,} and {per_device:,}")
    useful = sum(len(c.tokens) for c in r0.done.values())
    st = r0.stats
    equal = sum(int(np.sum(np.asarray(r0.done[i].tokens) == np.asarray(single[i][0])))
                for i in single)
    whole = sum(r0.done[i].tokens.tolist() == single[i][0] for i in single)
    print(f"{label} at --model-parallel {mp}, {mp} ranks sharing one card over "
          f"{tp.backend}: not a tensor-parallel speed: "
          f"{len(r0.done)} requests, {useful} tokens in {r0.seconds:.2f} s ({wall:.2f} s with "
          f"the ranks' start), {useful / r0.seconds:.2f} tok/s; step wall p50 "
          f"{st['step_wall_p50_ms']:.1f} ms p99 {st['step_wall_p99_ms']:.1f} ms over "
          f"{st['n_chunks']} rounds; the single rank {ref['tokens']} tokens in "
          f"{ref['seconds']:.2f} s")
    print(f"{label} at --model-parallel {mp}: schedule equal on every rank ({ref['stats']}); "
          f"tokens {equal} of {ref['tokens']} equal to the single rank's, {whole} of "
          f"{len(single)} requests identical; every rank's streams identical; launches per "
          f"rank {r0.launches} = the single rank's; KV per device "
          f"{r0.report['per_device_bytes']:,} of {r0.report['bytes']:,} bytes (arena "
          f"{ref['arena']:,}, {'head-sharded' if split else 'replicated'})")
    return dict(mp=mp, backend=tp.backend, seconds=r0.seconds, wall=wall, tokens=useful,
                p50=st["step_wall_p50_ms"], p99=st["step_wall_p99_ms"],
                single_seconds=ref["seconds"], equal=equal, of=ref["tokens"],
                per_device=r0.report["per_device_bytes"], bytes=r0.report["bytes"])


def run_tp_path(dev, name):
    """Phase (j) on one of ``TP_PATHS``: the single-rank run
    (``tp_single``), then the same argv with ``TP_RANKS``, each rank held
    to it (``tp_check_ranks``); and greedy tokens equal to the single
    run's up to a flip at a near-tie, by the rule of
    ``check_fused_equals_gather_full`` (8 ragged prompts, ``TP_FORCED``
    greedy tokens of the single rank teacher-forced through both).
    Returns ``(by_path launch counts, report)``."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import Engine

    argv, kernels, split = TP_PATHS[name]
    res, ref = tp_single(argv, kernels, f"(j) {name} single rank")
    eng = Engine(res.sched.engine.cfg, res.sched.engine.params, max_len=256, paged=True,
                 block_size=16, decode_kernel="fused", device=dev)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, eng.cfg.vocab, int(n)).tolist()
               for n in rng.integers(64, 129, size=8)]
    toks = eng.generate(prompts, TP_FORCED).tokens
    want = forced_logits(eng, prompts, toks)
    if not torch.equal(want.argmax(-1).cpu(), torch.as_tensor(toks, dtype=torch.int64)):
        fail(f"the (j) {name} single rank's teacher-forced run does not reproduce its tokens")
    want = want.cpu()
    del res, eng
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tp = serve.main(argv + TP_RANKS)
    report = tp_check_ranks(f"(j) {name}", tp, ref, split, time.perf_counter() - t0)
    t0 = time.perf_counter()
    forced = M.spawn(tp_forced_rank, TP_DEVICES, (argv + TP_RANKS, TP_DEVICES, prompts, toks),
                     timeout=600)
    forced_wall = time.perf_counter() - t0
    if not np.array_equal(forced[0], forced[1]):
        fail(f"(j) {name}: the two ranks' teacher-forced logits differ")
    got = torch.from_numpy(forced[0])
    diff = (got - want).abs().amax(-1)
    rel = float((diff / want.std(-1)).max())
    top2 = want.topk(2, dim=-1).values
    flips = got.argmax(-1) != want.argmax(-1)
    margin = top2[..., 0] - top2[..., 1]
    near_tie = bool((margin <= 2 * diff)[flips].all())
    print(f"(j) {name}: mp 2 against the single rank, teacher-forced on 8 ragged prompts x "
          f"{TP_FORCED} greedy tokens ({forced_wall:.1f} s with the ranks' start): logits max "
          f"|diff| {float(diff.max()):.5f}, {rel:.5f} of the spread (limit {FORCED_TOL}), "
          f"{int(flips.sum())} argmax flips, all at near-ties: {near_tie} (flip margins "
          f"{[round(float(m), 5) for m in margin[flips]]})")
    if rel > FORCED_TOL or not near_tie:
        fail(f"(j) {name}: the sharded model disagrees with the single rank beyond bf16 "
             "rounding")
    by_path = {f"tp-{name}-rank{k}": {**{c: 0 for c in ref["counts"]}, **r.launches}
               for k, r in enumerate(tp.ranks)}
    return by_path, dict(report, rel=rel, flips=int(flips.sum()))


# (l) tensor-parallel serving on linear caches and on the other families
# (``--phase tp-linear``, a process of its own): ``serve --model-parallel``'s
# ranks sharing the one card over gloo, so no wall here is a multi-card
# speed.  Full width, depth cut (``TPL_CUTS``); each path against a single-rank run of
# the same argv on the same weights, run before it: the one-shot engine
# on phi3-medium-14b (8 ragged prompts, its KV heads split, 5 a rank),
# the dense-cache scheduler on minicpm3-4b (its query heads split, the
# latents whole; compactions), the one-shot engine on rwkv6-7b (its 64
# heads split: the time mix and the wkv state), whisper-tiny (its 6
# heads split, self and cross K/V) and hymba-1.5b at mp 5, five ranks
# (25 heads, 5 KV heads and 25 SSM heads split; its MLP and vocabulary
# do not divide).  Prompts and generations are shorter than paths
# (a)-(g)'s so that the phase fits the smoke's time: each cut is
# printed (``TPL_CUTS``).  The teacher-forced check runs in the path's
# dtype: bf16 on the transformer and whisper; f32 on rwkv6 and hymba,
# whose bf16 logits drift from the single rank's with depth by the
# rounding of the split's sums alone (one device that rounds its
# row-parallel partial sums and sums its split norms' statistics as the
# ranks do gives their logits bit for bit:
# ``tests/test_torch_tp_families.py::test_bf16_drift_is_the_split_sums_rounding``),
# past ``FORCED_TOL`` at full depth.
_TPL_ARGS = ["--batch", "8", "--kv-posit", "posit16", "--temperature", "0", "--seed", "0",
             "--device", "cuda"]
TPL_PATHS = {   # argv, the ranks, the cache leaves that split, the forced check's dtype
    "phi3-medium-14b-oneshot": (["--arch", "phi3-medium-14b", "--n-layers", "10", "--ragged",
                                 "--prompt-len", "128", "--gen", "8", "--max-len", "1024"]
                                + _TPL_ARGS, 2, ("k", "v"), "bfloat16"),
    "minicpm3-4b-dense": (["--arch", "minicpm3-4b", "--n-layers", "16", "--continuous",
                           "--n-requests", "6", "--arrival-rate", "0.5", "--chunk-size", "8",
                           "--prompt-len", "128", "--gen", "8"] + _TPL_ARGS, 2, (),
                          "bfloat16"),
    "rwkv6-7b-oneshot": (["--arch", "rwkv6-7b", "--n-layers", "8", "--prompt-len", "64",
                          "--gen", "8"] + _TPL_ARGS, 2, ("wkv",), "float32"),
    "whisper-tiny-oneshot": (["--arch", "whisper-tiny", "--prompt-len", "64", "--gen", "8",
                              "--max-len", "448"] + _TPL_ARGS, 2, ("k", "v", "ck", "cv"),
                             "bfloat16"),
    "hymba-1.5b-oneshot": (["--arch", "hymba-1.5b", "--n-layers", "16", "--prompt-len", "4",
                            "--gen", "2", "--max-len", "1024"] + _TPL_ARGS, 5,
                           ("k_swa", "v_swa", "k_glb", "v_glb", "ssm"), "float32"),
}
TPL_CUTS = ("paths (a), (b), (f), (g) and (e) run prompts of 512, 512, 512, 384 and 128 "
            "tokens and 32 generated, (b) 16 requests, every layer; (l) runs 128, 128 (6 "
            "requests, chunk 8), 64, 64 and 4, 8 generated (hymba's 2), and phi3 10 of its 40 "
            "layers, minicpm3 16 of 62, rwkv6 8 of 32, hymba 16 of 32 (global layers 0 and "
            "15), whisper all")
TPL_DEVICE = "cuda:0"   # every rank's device


def tpl_ranks(name):
    """The argv of an (l) path's ranks and their devices."""
    argv, mp = TPL_PATHS[name][:2]
    devices = [TPL_DEVICE] * mp
    return argv + ["--model-parallel", str(mp), "--rank-devices", ",".join(devices)], devices


def tpl_forced_model(argv, dtype, devices=None):
    """The (l) path's config and weights for the teacher-forced check:
    ``serve.rank_model``'s draw (the whole model with ``devices`` None),
    in f32 weights and compute when ``dtype`` is ``"float32"``; returns
    ``(args, mesh, cfg, params)``."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import get_family
    from repro_torch.runtime import sharding

    args = serve.build_parser().parse_args(argv)
    mesh = None
    if devices is not None:
        import torch.distributed as dist
        args.device = devices[dist.get_rank()]
        mesh = make_host_mesh(args.model_parallel, torch.device(args.device).type)
    cfg = dataclasses.replace(serve.model_config(args), compute_dtype=dtype)
    params = get_family(cfg).init_params(
        cfg, seed=args.seed, device=args.device,
        dtype=torch.float32 if dtype == "float32" else None,
        shard=None if mesh is None else
        (lambda t, prefix: sharding.shard_params(t, mesh, cfg, prefix)))
    return args, mesh, cfg, params


def tpl_rank(paths, devices):
    """One rank of the (l) paths at one mesh size (``launch/mesh.spawn``),
    for each ``(argv, job)`` of ``paths`` in turn: what ``serve
    --model-parallel``'s ranks run, ``serve.rank_model`` then
    ``serve.serve_on_rank``; then, on the same weights (on f32 weights
    drawn the same way where ``job`` asks for f32), a linear engine of
    the job's ``max_len`` fed the job's tokens after its prompts.
    Returns, for each path, the rank's ``RankResult``, its (B, n, V)
    logits as a host array and its wall."""
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import Engine

    out = []
    for argv, (prompts, tokens, inputs, max_len, dtype) in paths:
        t0 = time.perf_counter()
        args, mesh, cfg, params = serve.rank_model(argv, devices)
        res = serve.serve_on_rank(args, mesh, cfg, params)
        if dtype != cfg.compute_dtype:
            del params
            gc.collect()
            torch.cuda.empty_cache()
            args, mesh, cfg, params = tpl_forced_model(argv, dtype, devices)
        eng = Engine(cfg, params, max_len=max_len, device=args.device, mesh=mesh)
        kw = {k: torch.as_tensor(v, device=args.device) for k, v in inputs.items()}
        out.append((res, forced_logits(eng, prompts, tokens, **kw).cpu().numpy(),
                    time.perf_counter() - t0))
        del eng, params, kw
        gc.collect()
        torch.cuda.empty_cache()
    return out


TPL_STATS = ("n_chunks", "steps_run", "n_admitted", "n_compactions", "n_leaked")



def tpl_single(name):
    """The single-rank run of an (l) path through the user entry point
    (``serve_linear_path``): exact launch counts; returns what the ranks
    are held to (tokens, the schedule, launches, the cache's bytes and
    its split leaves' bytes, walls), the teacher-forced job of the path
    (its prompts: the one-shot batch, or 8 ragged prompts from a seed on
    the dense path; the single rank's greedy tokens; the inputs; the
    engine's length; the dtype) and the single rank's forced logits."""
    from repro_torch.compress import kvcache as kvc
    from repro_torch.runtime.engine import Engine

    argv, mp, split, dtype = TPL_PATHS[name]
    res, counts, wall, n, oneshot = serve_linear_path(argv)
    engine = oneshot.engine if oneshot else res.sched.engine
    check_linear_counts(name, counts, LINEAR_PATHS[name][1], engine.cfg.n_layers, n)
    if oneshot is not None:
        prompts, inputs = oneshot.prompts, oneshot.inputs
        cache, tokens, max_len = oneshot.result.cache, res, engine.max_len
        ref = dict(tokens=res.tolist(), seconds=oneshot.seconds,
                   prefill_seconds=oneshot.prefill_seconds, report=oneshot.report)
    else:
        check_served(res, int(argv[argv.index("--n-requests") + 1]))
        if res.sched.n_compactions < 1:
            fail(f"the (l) {name} path reached no compaction")
        cache, max_len = res.sched.cache, 256
        ref = dict(done={r: (c.tokens.tolist(), c.admitted_step, c.finished_step)
                         for r, c in res.done.items()},
                   stats={k: res.sched.stats[k] for k in TPL_STATS}, seconds=res.seconds,
                   report=kvc.cache_report(cache))
        rng = np.random.default_rng(11)
        prompts = [rng.integers(1, engine.cfg.vocab, int(k)).tolist()
                   for k in rng.integers(64, 129, size=8)]
        inputs = {}
        tokens = Engine(engine.cfg, engine.params, max_len=max_len,
                        device=engine.device).generate(prompts, 8).tokens
    ref.update(counts=counts, wall=wall, split_bytes=sum(
        cache[k].numel() * cache[k].element_size() for k in split))
    toks = np.asarray(tokens)
    cfg, params = engine.cfg, engine.params
    del res, oneshot, cache, engine
    if dtype != cfg.compute_dtype:
        del params
        gc.collect()
        torch.cuda.empty_cache()
        _, _, cfg, params = tpl_forced_model(argv, dtype)
    eng = Engine(cfg, params, max_len=max_len, device=params["tok_embed"].device)
    want = forced_logits(eng, prompts, toks, **inputs)
    if dtype == "bfloat16" and not torch.equal(want.argmax(-1).cpu(),
                                               torch.as_tensor(toks, dtype=torch.int64)):
        fail(f"the (l) {name} single rank's teacher-forced run does not reproduce its tokens")
    job = (prompts, toks, {k: v.cpu().numpy() for k, v in inputs.items()}, max_len, dtype)
    return ref, job, want.cpu()


def tpl_check_ranks(name, ref, ranks, backend, wall):
    """Each rank of an (l) path held to the single rank's ``ref``: its
    tokens (one-shot; every rank's identical) or its schedule (the
    dense-cache scheduler: admissions, finishes, rounds, compactions;
    every rank's tokens identical), launches exactly the single run's,
    the cache's bytes equal and per device the split leaves' share.
    Returns the ranks' launches and the path's numbers."""
    _, mp, split, _ = TPL_PATHS[name]
    label = f"(l) {name}"
    if "done" in ref:
        single = ref["done"]
        for rank, r in enumerate(ranks):
            got = {i: (c.tokens.tolist(), c.admitted_step, c.finished_step)
                   for i, c in r.done.items()}
            if set(got) != set(single) or any(got[i][1:] != single[i][1:] for i in single) \
                    or any(r.stats[k] != ref["stats"][k] for k in TPL_STATS):
                fail(f"{label} rank {rank}'s schedule differs from the single rank's")
            if any(got[i][0] != ranks[0].done[i].tokens.tolist() for i in got):
                fail(f"{label} rank {rank}'s tokens differ from rank 0's")
        streams = [ranks[0].done[i].tokens.tolist() for i in sorted(single)]
        want = [single[i][0] for i in sorted(single)]
    else:
        if any(not np.array_equal(r.tokens, ranks[0].tokens) for r in ranks):
            fail(f"{label}: the ranks' tokens differ")
        streams, want = ranks[0].tokens.tolist(), ref["tokens"]
    equal = sum(int(np.sum(np.asarray(a) == np.asarray(b))) for a, b in zip(streams, want))
    total = sum(len(b) for b in want)
    rep = ref["report"]
    per_device = rep["bytes"] - ref["split_bytes"] + ref["split_bytes"] // mp
    for rank, r in enumerate(ranks):
        if any(r.launches[k] != ref["counts"][k] for k in r.launches):
            fail(f"{label} rank {rank} launched {r.launches}, the single rank "
                 f"{ {k: ref['counts'][k] for k in r.launches} }")
        if r.report["bytes"] != rep["bytes"] or r.report["per_device_bytes"] != per_device:
            fail(f"{label} rank {rank}: cache bytes {r.report['bytes']:,}, per device "
                 f"{r.report['per_device_bytes']:,}; want {rep['bytes']:,} and {per_device:,}")
    r0 = ranks[0]
    oneshot = "tokens" in ref
    what = f"generate, prefill report {r0.prefill_seconds:.2f} s" if oneshot else "the trace"
    schedule = "" if oneshot else f"; schedule equal on every rank {ref['stats']}"
    print(f"{label} at --model-parallel {mp}, {mp} ranks sharing one card over {backend}: "
          f"not a tensor-parallel speed: {total} tokens, {r0.seconds:.2f} s ({what}; "
          f"{wall:.2f} s with the weights' draw and the forced check); the single rank "
          f"{ref['seconds']:.2f} s ({ref['wall']:.2f} s with init)")
    print(f"{label}: greedy tokens {equal} of {total} equal to the single rank's; every "
          f"rank's identical{schedule}; launches per rank {r0.launches} = the single "
          f"rank's; KV per device "
          f"{r0.report['per_device_bytes']:,} of {r0.report['bytes']:,} bytes (split leaves "
          f"{', '.join(split) or 'none'}: {ref['split_bytes']:,} bytes over {mp})")
    by_path = {f"tpl-{name}-rank{k}": {**{c: 0 for c in ref["counts"]}, **r.launches}
               for k, r in enumerate(ranks)}
    return by_path, dict(mp=mp, backend=backend, seconds=r0.seconds, wall=wall,
                         single_seconds=ref["seconds"], single_wall=ref["wall"], equal=equal,
                         of=total, per_device=r0.report["per_device_bytes"],
                         bytes=r0.report["bytes"])


def tpl_check_forced(name, want, got_ranks):
    """Every rank's teacher-forced logits identical, and within
    ``FORCED_TOL`` of the single rank's spread, flips only at near-ties
    (:func:`_check_forced`), in the path's dtype."""
    return _check_forced(f"(l) {name}", TPL_PATHS[name][3], want, got_ranks)


def tp_linear_phase(dev):
    """(l): for each mesh size of ``TPL_PATHS``, the single rank of each
    of its paths, then one launch of the ranks for all of them
    (``tpl_rank``: each path's serve run and teacher-forced check).
    Returns the ranks' launch counts and each path's numbers."""
    from repro_torch.launch import mesh as M

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"(l) cuts: {TPL_CUTS}")
    t_phase = time.perf_counter()
    counts, report = {}, {}
    for mp in sorted({p[1] for p in TPL_PATHS.values()}):
        names = [n for n, p in TPL_PATHS.items() if p[1] == mp]
        singles = {}
        for name in names:
            singles[name] = tpl_single(name)
            gc.collect()
            torch.cuda.empty_cache()
        devices = tpl_ranks(names[0])[1]
        t0 = time.perf_counter()
        out = M.spawn(tpl_rank, devices, ([(tpl_ranks(n)[0], singles[n][1]) for n in names],
                                          devices), timeout=900)
        print(f"(l) the ranks at mp {mp}: {time.perf_counter() - t0:.1f} s for "
              f"{', '.join(names)}, their start included")
        for i, name in enumerate(names):
            ref, _, want = singles[name]
            by_path, report[name] = tpl_check_ranks(
                name, ref, [r[i][0] for r in out], M.backend_for(devices), out[0][i][2])
            counts.update(by_path)
            report[name].update(tpl_check_forced(name, want, [r[i][1] for r in out]))
        del out, singles
        gc.collect()
    print(f"(l) took {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "report": report}


# (o) context-parallel prefill in sharded serving (``--phase cp``, a
# process of its own, run beside (l)): ``serve --model-parallel 4``'s ranks
# sharing the one card over gloo, so no wall here is a tensor-parallel
# speed.  At "model" 4 neither phi3-medium-14b's 40 heads and 10 KV heads
# nor internvl2-1b's 14 heads split, and both configs set
# ``seq_shard_activations``: each rank attends its quarter of every
# prompt's (or chunk's) query rows against the whole K/V and the rows are
# gathered, once a layer a prefill.  (o1) phi3 at full width, 10 of its
# 40 layers (as (j)), on (j)'s chunked trace and on the unchunked paged
# scheduler with the same requests; (o2) internvl2-1b at full width and
# depth, one-shot, its 256 visual tokens, 8 prompts of 512 and 8 tokens
# generated (the linear path (d) generates 32).  Each path is held to a
# single-rank run of the same argv, run before it: the schedule, every
# rank's tokens identical, launches per rank exactly the single rank's
# (K/V and the caches whole on every rank), the gathers counted, and a
# teacher-forced check in bf16 through the whole-prompt prefill.
_O_TRACE = ["--batch", "8", "--n-requests", "8", "--arrival-rate", "0.5", "--prompt-len",
            "192", "--gen", "8", "--max-len", "384", "--chunk-size", "16", "--block-size", "16",
            "--kv-posit", "posit16", "--decode-kernel", "fused", "--temperature", "0",
            "--seed", "0", "--device", "cuda"]
O_PATHS = {   # argv, the single run's launch check
    "phi3-medium-14b-chunked": (TP_PATHS["phi3-medium-14b"][0], "main"),
    "phi3-medium-14b-unchunked": (["--arch", "phi3-medium-14b", "--n-layers", "10",
                                   "--continuous", "--paged"] + _O_TRACE,
                                  LINEAR_PATHS["phi3-medium-14b-unchunked"][1]),
    "internvl2-1b-oneshot": (["--arch", "internvl2-1b", "--batch", "8", "--prompt-len", "512",
                              "--gen", "8", "--max-len", "1024", "--kv-posit", "posit16",
                              "--temperature", "0", "--seed", "0", "--device", "cuda"],
                             _LINEAR_KERNELS),
}
O_DEVICES = ["cuda:0"] * 4
O_RANKS = ["--model-parallel", "4", "--rank-devices", ",".join(O_DEVICES)]
O_CUTS = ("(o1) phi3 10 of its 40 layers, 8 requests of 96-192 tokens, 8 generated; (o2) "
          "internvl2-1b every layer, 8 prompts of 512, 8 generated")
_CP_KEY = ("model", "all_reduce", "cp_prefill", "float32")
_CP_CALLS = ("prefill", "prefill_chunk", "_decode_step_paged", "_decode_step_linear")


@contextlib.contextmanager
def cp_counted():
    """``{name: [gathers]}`` for each call of the transformer's prefills
    and decode steps under the block (the ``cp_prefill`` all-reduces it
    made), and ``"rows"``: each context-parallel call's ``(rows of the
    prompt or chunk, this rank's query rows)``."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime import collectives as C

    calls = {name: [] for name in _CP_CALLS + ("rows",)}
    saved = {name: getattr(T, name) for name in _CP_CALLS}
    rows_of = C.TensorParallel.cp_rows

    def counted(name, fn):
        def call(*args, **kw):
            before = C.wire.get(_CP_KEY, [0, 0])[0]
            out = fn(*args, **kw)
            calls[name].append(C.wire.get(_CP_KEY, [0, 0])[0] - before)
            return out
        return call

    def rows(self, s, device):
        out = rows_of(self, s, device)
        calls["rows"].append((int(s), int(out[1])))
        return out

    for name, fn in saved.items():
        setattr(T, name, counted(name, fn))
    C.TensorParallel.cp_rows = rows
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(T, name, fn)
        C.TensorParallel.cp_rows = rows_of


def o_single(name):
    """The single-rank run of an (o) path through the user entry point,
    its exact launch counts, and the teacher-forced job of the ranks
    (prompts, the single rank's greedy tokens, inputs, the engine's
    length) with the single rank's forced logits."""
    from repro_torch.compress import kvcache as kvc
    from repro_torch.runtime.engine import Engine

    argv, check = O_PATHS[name]
    if check == "main":
        res, counts, wall, steps, chunks = serve_main_path(argv)
        check_main_counts(f"(o) {name}", res, counts, steps, chunks, _DENSE_KERNELS)
        oneshot = None
    else:
        res, counts, wall, n, oneshot = serve_linear_path(argv)
        engine = oneshot.engine if oneshot else res.sched.engine
        check_linear_counts(f"(o) {name}", counts, check, engine.cfg.n_layers, n)
    if oneshot is not None:
        engine = oneshot.engine
        prompts, inputs, toks = oneshot.prompts, oneshot.inputs, np.asarray(res)
        ref = dict(tokens=res.tolist(), seconds=oneshot.seconds)
    else:
        check_served(res, 8)
        engine = res.sched.engine
        ref = dict(done={r: (c.tokens.tolist(), c.admitted_step, c.finished_step)
                         for r, c in res.done.items()},
                   stats={k: res.sched.stats[k] for k in TPL_STATS if k in res.sched.stats},
                   seconds=res.seconds, report=kvc.cache_report(res.sched.cache,
                                                                res.sched.pool))
        rng = np.random.default_rng(11)
        prompts = [rng.integers(1, engine.cfg.vocab, int(k)).tolist()
                   for k in rng.integers(64, 129, size=8)]
        inputs = {}
        toks = np.asarray(Engine(engine.cfg, engine.params, max_len=256,
                                 device=engine.device).generate(prompts, 8).tokens)
    ref.update(counts=counts, wall=wall, n_layers=engine.cfg.n_layers,
               heads=(engine.cfg.n_heads, engine.cfg.n_kv_heads))
    eng = Engine(engine.cfg, engine.params, max_len=engine.max_len if oneshot else 256,
                 device=engine.device)
    want = forced_logits(eng, prompts, toks, **inputs)
    if not torch.equal(want.argmax(-1).cpu(), torch.as_tensor(toks, dtype=torch.int64)):
        fail(f"the (o) {name} single rank's teacher-forced run does not reproduce its tokens")
    job = (prompts, toks, {k: v.cpu().numpy() for k, v in inputs.items()}, eng.max_len)
    del res, oneshot, engine, eng
    return ref, job, want.cpu()


def o_rank(paths, devices):
    """One rank of the (o) paths (``launch/mesh.spawn``): for each ``(argv,
    job)`` what ``serve --model-parallel``'s ranks run, its context-parallel
    gathers counted (:func:`cp_counted`), then the job's teacher-forced
    logits through a linear engine on the same weights.  Returns, for
    each path, the ``RankResult``, the counts, the logits and the wall."""
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import Engine

    out = []
    for argv, (prompts, tokens, inputs, max_len) in paths:
        t0 = time.perf_counter()
        args, mesh, cfg, params = serve.rank_model(argv, devices)
        with cp_counted() as calls:
            res = serve.serve_on_rank(args, mesh, cfg, params)
        eng = Engine(cfg, params, max_len=max_len, device=args.device, mesh=mesh)
        kw = {k: torch.as_tensor(v, device=args.device) for k, v in inputs.items()}
        with cp_counted() as forced_calls:
            logits = forced_logits(eng, prompts, tokens, **kw).cpu().numpy()
        out.append((res, dict(serve=calls, forced=forced_calls, cp=bool(eng.tp.cp),
                              heads=(eng.cfg.n_heads, eng.cfg.n_kv_heads)),
                    logits, time.perf_counter() - t0))
        del eng, params, kw
        gc.collect()
        torch.cuda.empty_cache()
    return out


def o_check_cp(label, calls, n_layers, mp):
    """Every prefill and prefill chunk gathered its rows once a layer,
    every decode step none, each rank's rows a ``1/mp`` share (rounded
    up) of the prompt's or chunk's; returns the distinct ``(rows, the
    rank's)`` pairs."""
    prefills = calls["prefill"] + calls["prefill_chunk"]
    decodes = calls["_decode_step_paged"] + calls["_decode_step_linear"]
    if not prefills or set(prefills) != {n_layers} or set(decodes) - {0}:
        fail(f"{label}: context-parallel gathers per call {calls}, want {n_layers} a "
             f"prefill or chunk and none a decode step")
    rows = sorted(set(map(tuple, calls["rows"])))
    # a whole-prompt prefill picks its rows in each layer, a chunk once
    if len(calls["rows"]) != n_layers * len(calls["prefill"]) + len(calls["prefill_chunk"]) \
            or any(n != -(-s // mp) for s, n in rows):
        fail(f"{label}: a rank's query rows {rows}, want a {mp}th of each prefill's")
    return rows


def _check_forced(label, dtype, want, got_ranks):
    """Every rank's teacher-forced logits identical, and within
    ``FORCED_TOL`` of the single rank's spread, flips only at near-ties
    (the rule of ``run_tp_path``)."""
    if not all(np.array_equal(got_ranks[0], g) for g in got_ranks[1:]):
        fail(f"{label}: the ranks' teacher-forced logits differ")
    got = torch.from_numpy(got_ranks[0])
    diff = (got - want).abs().amax(-1)
    rel = float((diff / want.std(-1)).max())
    top2 = want.topk(2, dim=-1).values
    flips = got.argmax(-1) != want.argmax(-1)
    margin = top2[..., 0] - top2[..., 1]
    near_tie = bool((margin <= 2 * diff)[flips].all())
    print(f"{label}: against the single rank, teacher-forced in {dtype} on "
          f"{want.shape[0]} prompts x {want.shape[1]} greedy tokens: logits max |diff| "
          f"{float(diff.max()):.6f}, {rel:.6f} of the spread (limit {FORCED_TOL}), "
          f"{int(flips.sum())} argmax flips, all at near-ties: {near_tie}")
    if rel > FORCED_TOL or not near_tie:
        fail(f"{label}: the sharded model disagrees with the single rank beyond "
             f"{dtype} rounding")
    return dict(rel=rel, flips=int(flips.sum()), forced_dtype=dtype)


def o_check_ranks(name, ref, ranks, wall):
    """An (o) path's ranks held to the single rank's ``ref``: the schedule
    (or the one-shot tokens) on every rank, every rank's tokens identical,
    launches exactly the single rank's, the whole cache on every rank
    (the KV heads do not split), the gathers and rows of every call.
    Returns the ranks' launches and the path's numbers."""
    label = f"(o) {name}"
    mp = len(ranks)
    results = [r[0] for r in ranks]
    r0 = results[0]
    if "done" in ref:
        single = ref["done"]
        for rank, r in enumerate(results):
            got = {i: (c.tokens.tolist(), c.admitted_step, c.finished_step)
                   for i, c in r.done.items()}
            if set(got) != set(single) or any(got[i][1:] != single[i][1:] for i in single) \
                    or any(r.stats[k] != v for k, v in ref["stats"].items()):
                fail(f"{label} rank {rank}'s schedule differs from the single rank's")
            if any(got[i][0] != r0.done[i].tokens.tolist() for i in got):
                fail(f"{label} rank {rank}'s tokens differ from rank 0's")
            if r.report["per_device_bytes"] != ref["report"]["bytes"]:
                fail(f"{label} rank {rank}: cache per device {r.report['per_device_bytes']:,}"
                     f", want the whole {ref['report']['bytes']:,}")
        streams = [r0.done[i].tokens.tolist() for i in sorted(single)]
        want = [single[i][0] for i in sorted(single)]
    else:
        if any(not np.array_equal(r.tokens, r0.tokens) for r in results):
            fail(f"{label}: the ranks' tokens differ")
        streams, want = r0.tokens.tolist(), ref["tokens"]
    equal = sum(int(np.sum(np.asarray(a) == np.asarray(b))) for a, b in zip(streams, want))
    total = sum(len(b) for b in want)
    rows = None
    for rank, (r, info, _, _) in enumerate(ranks):
        if any(r.launches[k] != ref["counts"][k] for k in r.launches):
            fail(f"{label} rank {rank} launched {r.launches}, the single rank "
                 f"{ {k: ref['counts'][k] for k in r.launches} }")
        if not info["cp"] or tuple(info["heads"]) != ref["heads"]:
            fail(f"{label} rank {rank}: no context-parallel prefill, or heads "
                 f"{info['heads']} split (the whole model's {ref['heads']})")
        rows = o_check_cp(label, info["serve"], ref["n_layers"], mp)
        o_check_cp(f"{label} (teacher-forced)", info["forced"], ref["n_layers"], mp)
    info = ranks[0][1]
    n_calls = {k: len(v) for k, v in info["serve"].items() if v and k != "rows"}
    print(f"{label} at --model-parallel {mp}, {mp} ranks sharing one card over gloo: not a "
          f"tensor-parallel speed: {total} tokens in {r0.seconds:.2f} s ({ranks[0][3]:.2f} s "
          f"with the weights' draw and the forced check; {wall:.2f} s the launch); the single "
          f"rank {ref['seconds']:.2f} s ({ref['wall']:.2f} s with init); {CARD}")
    print(f"{label}: greedy tokens {equal} of {total} equal to the single rank's; every "
          f"rank's identical; launches per rank {r0.launches} = the single rank's; heads "
          f"per rank {info['heads']} (whole); calls {n_calls}, each prefill or chunk "
          f"{ref['n_layers']} 'cp_prefill' gathers, each decode step none; a rank's query "
          f"rows (of the prompt or chunk, the rank's): {rows}")
    by_path = {f"o-{name}-rank{k}": {**{c: 0 for c in ref["counts"]}, **r.launches}
               for k, r in enumerate(results)}
    return by_path, dict(mp=mp, seconds=r0.seconds, wall=ranks[0][3],
                         single_seconds=ref["seconds"], equal=equal, of=total,
                         rows=rows, calls=n_calls)


def cp_phase(dev):
    """(o): the single rank of each ``O_PATHS`` path, then one launch of
    four ranks for all of them (``o_rank``).  Returns the ranks' launch
    counts and each path's numbers."""
    from repro_torch.launch import mesh as M

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"(o) cuts: {O_CUTS}")
    t_phase = time.perf_counter()
    singles = {}
    for name in O_PATHS:
        singles[name] = o_single(name)
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = M.spawn(o_rank, O_DEVICES, ([(O_PATHS[n][0] + O_RANKS, singles[n][1])
                                       for n in O_PATHS], O_DEVICES), timeout=900)
    wall = time.perf_counter() - t0
    print(f"(o) the four ranks: {wall:.1f} s for {', '.join(O_PATHS)}, their start included")
    counts, report = {}, {}
    for i, name in enumerate(O_PATHS):
        ref, _, want = singles[name]
        by_path, report[name] = o_check_ranks(name, ref, [r[i] for r in out], wall)
        counts.update(by_path)
        report[name].update(_check_forced(f"(o) {name}", "bfloat16", want,
                                          [r[i][2] for r in out]))
    print(f"(o) took {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "report": report}


# ---------------------------------------------------------------------------
# Training, each phase in a process of its own (its memory freed at exit)
# ---------------------------------------------------------------------------

# (T) the main training path through the user entry point: gemma-7b at
# full width, 2 of its 28 layers (1.3 B parameters, the tied embedding's
# 0.79 B among them: f32 weights, gradients and v, posit16 m: some 19 GB;
# cut from 8 layers so that the smoke, phase (l) included, fits its
# time; (k1) follows it), grad_accum 4 from its config (microbatches of
# 2 x 512), synthetic data, the supervisor's checkpoint of the final step
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 512
TRAIN_ARGV = ["--arch", "gemma-7b", "--n-layers", "2", "--batch", str(TRAIN_BATCH),
              "--seq", str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--posit-moments",
              "--log-every", "1", "--device", "cuda"]
BF16_DENSE_FLOPS = 989.4e12    # H100 SXM data sheet: bf16 dense tensor-core peak
PLAIN_CHUNK = 1 << 25          # elements a chunk of the plain codec on the card
# (T2) one family a process-local run of two train steps at full width:
# arch -> (layers, 0 = all; batch; sequence).  rwkv6-7b's 32 layers are
# 7.6 B parameters, 106 GB of f32 training state: 4 layers; minicpm3-4b
# at 16 of 62, hymba-1.5b at 8 of 32, granite-moe-3b-a800m at 16 of 32 (so
# that the smoke fits its time); the others whole.  hymba's sequence is a multiple of its
# SSD chunk (64) beyond its 128 meta tokens, rwkv6's of its WKV chunk
# (16); whisper's is its decoder context, 448, with 1 500 seeded frames
TRAIN_FAMILIES = {
    "minicpm3-4b": (16, 8, 512),
    "granite-moe-3b-a800m": (16, 8, 512),
    "hymba-1.5b": (8, 8, 512),
    "rwkv6-7b": (4, 8, 512),
    "whisper-tiny": (0, 8, 448),
}
PHASE_TAG = "PHASE_RESULT "


def start_phase_process(phase):
    """Start ``chip_smoke.py --phase <phase>`` in a child process, its
    output into a temporary file; returns the handle
    :func:`finish_phase_process` takes."""
    gc.collect()
    torch.cuda.empty_cache()
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase", phase],
                            stdout=out, text=True)
    # the child's exit time, for its wall when this process joins it later
    ended = []
    threading.Thread(target=lambda: ended.append((proc.wait(), time.perf_counter())[1]),
                     daemon=True).start()
    return phase, proc, out, time.perf_counter(), ended


def finish_phase_process(handle, timeout=900):
    """Wait for a started phase: its lines echoed, its result (the line
    tagged ``PHASE_TAG``) returned; a non-zero exit or no result fails
    the smoke."""
    phase, proc, out, t0, ended = handle
    try:
        rc = proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"the {phase} phase ran past {timeout} s")
    out.seek(0)
    result = None
    for line in out.read().splitlines():
        if line.startswith(PHASE_TAG):
            result = json.loads(line[len(PHASE_TAG):])
        else:
            print(line)
    out.close()
    took = (ended[0] if ended else time.perf_counter()) - t0
    print(f"phase {phase}: its process took {took:.1f} s", flush=True)
    if rc != 0 or result is None:
        fail(f"the {phase} phase exited {rc}")
    return result


def run_phase_process(phase, timeout=900):
    """``chip_smoke.py --phase <phase>`` in a child process, waited for
    (:func:`start_phase_process`, :func:`finish_phase_process`)."""
    return finish_phase_process(start_phase_process(phase), timeout)


def _roomiest_dir():
    """The temporary directory or the checkout's ``build/``, whichever
    file system has more free bytes."""
    cands = [tempfile.gettempdir(), os.path.join(ROOT, "build")]
    os.makedirs(cands[1], exist_ok=True)
    return max(cands, key=lambda d: shutil.disk_usage(d).free)


def _plain_codec(fn, out_dtype):
    """A codec's plain version run ``PLAIN_CHUNK`` elements at a time (it
    is elementwise; its int64 temporaries of a whole 786 M leaf would
    not fit beside the training state)."""
    from repro_torch.core.types import signed_view

    def run(x):
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
        src, dst = x.reshape(-1), signed_view(out).view(-1)
        for i in range(0, src.numel(), PLAIN_CHUNK):
            dst[i:i + PLAIN_CHUNK] = signed_view(fn(src[i:i + PLAIN_CHUNK]))
        return out
    return run


def _bits(t):
    """A tensor's bits as a signed integer tensor of its width."""
    from repro_torch.core.types import signed_view
    return t.view(torch.int32) if t.dtype == torch.float32 else signed_view(t)


def _clone(t):
    from repro_torch.core.types import signed_view
    return signed_view(t).clone().view(t.dtype)


def _codec_at(x, m, plain_q, plain_dq):
    """Rows 1 and 2 at an optimizer leaf's shape: the quantize of its
    f32 moment and the dequantize of its patterns, wrapper-timed and
    alone, the plain versions (run by chunks), the bytes bound; each
    output bit for bit against the plain version's."""
    from repro_torch.core.types import POSIT16, signed_view
    from repro_torch.kernels import posit_codec as C

    q, d = C.quantize(x, POSIT16), C.dequantize(m, POSIT16)
    if not torch.equal(signed_view(q), signed_view(plain_q(x))) \
            or not torch.equal(d.view(torch.int32), plain_dq(m).view(torch.int32)):
        fail(f"the codec differs from its plain version at {tuple(x.shape)}")
    del q, d
    out = {}
    for kind, t, fn, call, plain in (
            ("quantize", x, lambda: C.quantize(x, POSIT16), C.quantize_call(x, POSIT16)[0],
             lambda: plain_q(x)),
            ("dequantize", m, lambda: C.dequantize(m, POSIT16),
             C.dequantize_call(m, POSIT16)[0], lambda: plain_dq(m))):
        out[kind] = dict(shape=list(t.shape), ms=time_ms(fn, iters=5),
                         kernel_ms=kernel_alone_ms(call, n=10),
                         plain_ms=time_ms(plain, iters=1, warmup=1),
                         bound_ms=t.numel() * 6 / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return out


def train_phase(dev):
    """(T): ``launch/train.py`` at ``TRAIN_ARGV`` with exact launch
    counts (row 1 a leaf at init and a step, row 2 a leaf a step, no
    other kernel); finite losses and gradient norms; the final step's
    checkpoint restored equal to the live state leaf for leaf, bit for
    bit; one AdamW update on the real leaves and a fresh gradient, on
    the kernels and on the plain codec, bit-identical; rows 1 and 2 at
    the optimizer's leaf shapes.  Prints its numbers; returns them."""
    from repro_torch import tree as TT
    from repro_torch.core.convert import f32_to_posit, posit_to_f32
    from repro_torch.core.types import POSIT16, signed_view
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop

    base = _roomiest_dir()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=base)
    print(f"(T) checkpoints in {base} ({shutil.disk_usage(base).free / 1e9:.1f} GB free)")
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        leaf_sq, update = [], adamw.update
        adamw.update = _recording_update(leaf_sq)      # (k1)'s per-leaf norms
        try:
            t0 = time.perf_counter()
            res = train.main(TRAIN_ARGV + ["--ckpt-dir", ckdir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            adamw.update = update
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        params, opt_state = res.state
        cfg = res.cfg
        leaves = TT.leaves(params)
        n_leaves = len(leaves)
        n_params = sum(p.numel() for p in leaves)
        n_mult = sum(p.numel() for p in leaves if p.dim() >= 2)   # the tied head included
        if res.supervisor.events:
            fail(f"(T) the supervisor recovered from failures: {res.supervisor.events}")
        if res.executed != TRAIN_STEPS or len(res.losses) != TRAIN_STEPS \
                or not np.isfinite(res.losses).all() or not np.isfinite(res.grad_norms).all():
            fail(f"(T) ran {res.executed} steps, losses {res.losses}, grad norms "
                 f"{res.grad_norms}")
        expect = {k: 0 for k in counts}
        expect.update(posit_quantize=n_leaves * (1 + TRAIN_STEPS),
                      posit_dequantize=n_leaves * TRAIN_STEPS)
        print(f"(T) kernel launches: {counts} ({n_leaves} leaves, {TRAIN_STEPS} steps)")
        if counts != expect:
            fail(f"(T) launches {counts}, expected {expect}")
        walls = np.array(res.step_walls)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        p50 = float(np.median(walls))
        mfu = 6 * n_mult * tokens / p50 / BF16_DENSE_FLOPS
        save = dict(res.ckpt.last_save, wait_s=res.ckpt.last_wait_s)
        print(f"(T) gemma-7b, full width, {cfg.n_layers} of 28 layers, {n_params:,} "
              f"parameters ({n_mult:,} multiplied, the tied head included), {n_leaves} "
              f"leaves, grad_accum {cfg.grad_accum} x {TRAIN_BATCH // cfg.grad_accum} x "
              f"{TRAIN_SEQ}: "
              f"{TRAIN_STEPS} steps in {wall:.2f} s with init and the save; step wall p50 "
              f"{p50:.4f} s, max {walls.max():.4f} s (step 0 {walls[0]:.4f} s); "
              f"{tokens / p50:.1f} tokens/s; 6 N tokens / p50 = "
              f"{6 * n_mult * tokens / p50 / 1e12:.1f} TFLOP/s, {100 * mfu:.1f} % of the "
              f"bf16 dense peak ({BF16_DENSE_FLOPS / 1e12:.1f} TFLOP/s); peak device memory "
              f"{peak:.2f} GiB; {CARD}")
        print(f"(T) losses {[round(x, 4) for x in res.losses]}, grad norms "
              f"{[round(x, 4) for x in res.grad_norms]}")
        print(f"(T) the final checkpoint: {save['bytes']:,} bytes, host copy "
              f"{save['host_copy_s']:.2f} s, write {save.get('write_s', float('nan')):.2f} s, "
              f"wait() {save['wait_s']:.2f} s")

        # the checkpoint restored equals the live state, leaf for leaf, bit for bit
        if res.ckpt.latest_step() != TRAIN_STEPS:
            fail(f"(T) the supervisor's latest checkpoint is {res.ckpt.latest_step()}")
        t0 = time.perf_counter()
        restored, step = res.ckpt.restore(TRAIN_STEPS, res.state, device="cpu")
        t_restore = time.perf_counter() - t0
        live, back = TT.leaves(res.state), TT.leaves(restored)
        same = step == TRAIN_STEPS and len(live) == len(back) and all(
            a.dtype == b.dtype and torch.equal(_bits(a).cpu(), _bits(b))
            for a, b in zip(live, back))
        print(f"(T) restore of step {step} onto the host: {t_restore:.2f} s; equal to the "
              f"live state leaf for leaf ({len(back)} leaves), bit for bit: {same}")
        if not same:
            fail("(T) the restored checkpoint differs from the live state")
        del restored, back, live
        gc.collect()

        # one update on the real leaves: kernels against the plain codec
        opt_cfg = adamw.AdamWConfig(posit_moments=True)
        pipe = Pipeline(DataConfig(), cfg, TRAIN_BATCH, TRAIN_SEQ, device=dev)
        loss, grads = train_loop.make_grad_fn(cfg)(params, pipe.batch_at(TRAIN_STEPS))
        c = adamw.coefficients(grads, opt_state, opt_cfg, adamw.cosine_schedule(
            TRAIN_STEPS, total=TRAIN_STEPS + 1, device=dev))
        plain_q = _plain_codec(lambda x: f32_to_posit(x, POSIT16), POSIT16.storage_dtype)
        plain_dq = _plain_codec(lambda p: posit_to_f32(p, POSIT16), torch.float32)
        upd_s, differ = 0.0, []
        for i, (p, g, m, v) in enumerate(zip(leaves, TT.leaves(grads),
                                             TT.leaves(opt_state["m"]),
                                             TT.leaves(opt_state["v"]))):
            pa, ma, va = _clone(p), _clone(m), _clone(v)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ma = adamw.update_leaf(pa, g, ma, va, c, opt_cfg)
            torch.cuda.synchronize()
            upd_s += time.perf_counter() - t0
            pb, mb, vb = _clone(p), _clone(m), _clone(v)
            kernels = adamw.quantize_m, adamw.dequantize_m
            adamw.quantize_m, adamw.dequantize_m = plain_q, plain_dq
            try:
                mb = adamw.update_leaf(pb, g, mb, vb, c, opt_cfg)
            finally:
                adamw.quantize_m, adamw.dequantize_m = kernels
            if not (torch.equal(pa.view(torch.int32), pb.view(torch.int32))
                    and torch.equal(va.view(torch.int32), vb.view(torch.int32))
                    and torch.equal(signed_view(ma), signed_view(mb))):
                differ.append(i)
            del pa, ma, va, pb, mb, vb
        print(f"(T) one AdamW update on the real leaves (a fresh gradient, loss "
              f"{float(loss):.4f}): {n_leaves} leaves on the kernels in {upd_s:.4f} s "
              f"(leaf by leaf, synchronized); parameters, m and v bit-identical to the "
              f"update on the plain codec: {not differ}")
        if differ:
            fail(f"(T) the update on the kernels differs from the plain codec's at leaves "
                 f"{differ[:8]}")
        del grads, c
        for p in leaves:
            p.grad = None
        gc.collect()
        torch.cuda.empty_cache()

        # rows 1 and 2 at the optimizer's shapes: the tied embedding's
        # moment (786 M) and one MLP weight's
        emb = params["tok_embed"]
        layer_w = params["layers"][0]["mlp"]["wi"]["w"]
        codec = {}
        for key, p, m in (("embedding", emb, opt_state["m"]["tok_embed"]),
                          ("mlp_wi", layer_w, opt_state["m"]["layers"][0]["mlp"]["wi"]["w"])):
            x = (p * 1e-3).contiguous()
            codec[key] = _codec_at(x, m, plain_q, plain_dq)
            del x
            for kind, r in codec[key].items():
                print(f"(T) posit_{kind} at the optimizer's {key} leaf {r['shape']}: "
                      f"{r['ms']:.4f} ms, alone {r['kernel_ms']:.4f} ms (bound "
                      f"{r['bound_ms']:.4f} ms by bytes, plain by chunks {r['plain_ms']:.2f} ms)")
        return dict(counts=counts, codec=codec, n_leaves=n_leaves, n_params=n_params,
                    n_mult=n_mult, step_p50_s=p50, step_max_s=float(walls.max()),
                    tokens_per_s=tokens / p50, mfu=mfu, peak_gib=peak, update_s=upd_s,
                    save=save, restore_s=t_restore, losses=res.losses,
                    grad_norms=res.grad_norms, walls=res.step_walls,
                    leaf_sq=[r.tolist() for r in leaf_sq])
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def train_families_phase(dev):
    """(T2): two train steps of each of ``TRAIN_FAMILIES`` at full width
    (posit16 moments): finite losses, the second unlike the first, exact
    codec launches (a quantize a leaf at init and a step, a dequantize
    a leaf a step)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import tree as TT
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import get_family
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop

    out = {"counts": None}
    for arch, (layers, batch, seq) in TRAIN_FAMILIES.items():
        published = configs.get_config(arch)
        cfg = dataclasses.replace(published, n_layers=layers or published.n_layers,
                                  fsdp=False, seq_shard_activations=False)
        opt_cfg = adamw.AdamWConfig(posit_moments=True)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = get_family(cfg).init_params(cfg, seed=0, device=dev, dtype=torch.float32)
        opt = adamw.init(params, opt_cfg)
        step = train_loop.make_train_step(cfg, opt_cfg, total_steps=2)
        pipe = Pipeline(DataConfig(), cfg, batch, seq, device=dev)
        losses, walls = [], []
        for i in range(2):
            t1 = time.perf_counter()
            params, opt, metrics = step(params, opt, pipe.batch_at(i), i)
            losses.append(float(metrics["loss"]))
            walls.append(time.perf_counter() - t1)
        counts = read_counts()
        n_leaves = len(TT.leaves(params))
        n_params = sum(p.numel() for p in TT.leaves(params))
        expect = {k: 0 for k in counts}
        expect.update(posit_quantize=3 * n_leaves, posit_dequantize=2 * n_leaves)
        cut = (f"{cfg.n_layers} of {published.n_layers} layers" if layers
               else f"all {cfg.n_layers} layers")
        print(f"(T2) {arch}: full width, {cut}, {n_params:,} parameters, batch {batch} x "
              f"{seq} (grad_accum {max(1, cfg.grad_accum)}): losses "
              f"{losses[0]:.4f}, {losses[1]:.4f}; step walls {walls[0]:.3f} s, "
              f"{walls[1]:.3f} s; {time.perf_counter() - t0:.1f} s with init; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {counts['posit_quantize']} quantize, "
              f"{counts['posit_dequantize']} dequantize ({n_leaves} leaves)")
        if not np.isfinite(losses).all() or losses[1] == losses[0]:
            fail(f"(T2) {arch}: losses {losses}")
        if counts != expect:
            fail(f"(T2) {arch}: launches {counts}, expected {expect}")
        out["counts"] = {k: (out["counts"] or {}).get(k, 0) + v for k, v in counts.items()}
        out[arch] = dict(losses=losses, walls=walls, n_params=n_params)
        del params, opt, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
    return out


def tp_phase(dev):
    """(j): every path of ``TP_PATHS``; returns the ranks' launch counts
    and each path's numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    counts, report = {}, {}
    for name in TP_PATHS:
        by_path, report[name] = run_tp_path(dev, name)
        counts.update(by_path)
        gc.collect()
        torch.cuda.empty_cache()
    return {"counts": counts, "report": report}


# ---------------------------------------------------------------------------
# (k) training across ranks: two ranks sharing the one card over gloo
# (NCCL refuses two ranks on one device), so no wall here is a
# multi-card speed
# ---------------------------------------------------------------------------

RANK_DEVICES = ["cuda:0", "cuda:0"]
RANK_STEPS = 3
# (k1) against (T): bf16 compute, the row-parallel partials rounded to
# bf16 before their f32 all-reduce, one rounding more than one device's
# product.  The loss is a mean over 16 352 token losses and the norms
# sum millions of squares, so those roundings average out: the sound
# runs read at most 1.3e-5 (loss) and 2.9e-5 (global norm) relative,
# and the limits are a few times that.  Steps 1-2 hardly move the
# weights (the warm-up gives step i a rate of i/100 of 3e-4), so the
# gradient norms carry the check of the backward: besides the global
# one, those of the leaves below, each of its own group (a replicated
# norm scale, the vocabulary-split tied embedding, the column-split
# wq and wk, the row-split wo, an MLP weight, the final norm); a sound
# run reads at most 1.7e-4 on them.  A gradient doubled, halved or left
# partial moves its leaf's norm by a large fraction, far past the limit
K1_LOSS_RTOL, K1_GNORM_RTOL, K1_LEAF_RTOL = 1e-4, 2e-4, 1e-3
_LAST = int(TRAIN_ARGV[TRAIN_ARGV.index("--n-layers") + 1]) - 1    # (T)'s last layer
K1_LEAVES = ("tok_embed", "layers/0/ln1/scale", "layers/0/attn/wq/w", "layers/0/attn/wk/w",
             "layers/0/attn/wo/w", f"layers/{_LAST}/mlp/wg/w", "final_norm/scale")
# (k2) internvl2-1b at full width, 4 of its 24 layers (cut so that the
# smoke fits its time), the compressed gate's configuration: visual
# tokens off, posit16 on the pod wire, 2 pods of 4 x 512 rows; (k3)
# restores its state after two steps on one rank
POD_ARCH, POD_SEED, POD_BATCH, POD_SEQ, N_PODS = "internvl2-1b", 9, 8, 512, 2
POD_LAYERS = 4
POD_REDUCED = False            # a CPU rehearsal shrinks (k2) to the reduced config
# the same loss on other row groupings (pods of 4 rows, microbatches of
# 2), each a mean over thousands of bf16 token losses: a sound run
# reads 7.9e-8 relative, the limit leaves room for another GEMM tiling
POD_LOSS_RTOL = 1e-5


def _recording_update(record):
    """``adamw.update`` that first appends, to ``record``, the f32 sum
    of squares of each ``K1_LEAVES`` leaf's gradient (this rank's piece
    of a split one), as one device tensor: no host sync in the step."""
    from repro_torch import tree as TT
    from repro_torch.optim import adamw
    update = adamw.update

    def recording(grads, *args, **kw):
        named = dict(TT.leaves_with_paths(grads))
        record.append(torch.stack([torch.sum(torch.square(named[p].float()))
                                   for p in K1_LEAVES]))
        return update(grads, *args, **kw)
    return recording


def _rank_device(devices):
    import torch.distributed as dist
    return torch.device(devices[dist.get_rank()])


def _sync_peak(dev, reset=False):
    """Peak device memory in GiB (0 on the CPU); ``reset`` starts anew."""
    if dev.type != "cuda":
        return 0.0
    torch.cuda.synchronize(dev)
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev) / 2**30


def k1_rank(argv, devices, steps, seq=False, fsdp=False):
    """(k1) one rank: (T)'s model, seed, data, schedule and moments
    (``argv``, (T)'s command line) through ``make_train_step`` on a
    ``(1, 2)`` mesh, every group split at 2.  Returns its losses,
    gradient norms, step walls, launches, leaves and peak memory.
    ``seq`` ((n1)): the config's ``seq_shard_activations`` kept on, the
    sequence layout.  ``fsdp`` ((o3)): the config's ``fsdp`` kept on, on
    a ``(2, 1)`` mesh: each rank holds its pieces of the parameters and
    moments (their bytes returned beside the whole model's)."""
    import dataclasses

    from repro_torch import tree as TT
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_family
    from repro_torch.optim import adamw
    from repro_torch.runtime import collectives, sharding, train_loop

    dev = _rank_device(devices)
    args = train.build_parser().parse_args(argv)
    cfg = dataclasses.replace(train.model_config(args), seq_shard_activations=seq, fsdp=fsdp)
    mesh = make_mesh((2, 1) if fsdp else (1, 2), ("data", "model"), dev.type)
    tp = sharding.tensor_parallel(cfg, mesh, seq=seq)
    if not fsdp and (not all((tp.attn, tp.kv, tp.mlp, tp.vocab)) or tp.seq != seq):
        fail(f"(k1) a group of gemma-7b does not split at 2: {tp}")
    reset_counts()
    _sync_peak(dev, reset=True)
    t0 = time.perf_counter()
    params = get_family(cfg).init_params(
        cfg, seed=0, device=dev, dtype=torch.float32,
        shard=lambda t, prefix: sharding.shard_params(t, mesh, cfg, prefix, fsdp=fsdp))
    params = sharding.shard_params(params, mesh, cfg, fsdp=fsdp)   # the leaves drawn whole
    opt_cfg = adamw.AdamWConfig(lr=args.lr, posit_moments=args.posit_moments)
    opt = adamw.init(params, opt_cfg)
    step = train_loop.make_train_step(cfg, opt_cfg, total_steps=args.steps, mesh=mesh)
    pipe = Pipeline(DataConfig(source=args.data, path=args.corpus), cfg, args.batch,
                    args.seq, device=dev)
    collectives.wire.clear()
    losses, gnorms, walls, leaf_sq, update = [], [], [], [], adamw.update
    adamw.update = _recording_update(leaf_sq)
    try:
        for i in range(steps):
            t1 = time.perf_counter()
            params, opt, m = step(params, opt, pipe.batch_at(i), i)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            walls.append(time.perf_counter() - t1)
    finally:
        adamw.update = update
    peak = _sync_peak(dev)
    leaves = TT.leaves(params)
    marks = [d is not None for d in sharding.fsdp_dims(params, mesh, cfg)] if fsdp \
        else sharding.split_leaves(params, cfg, mesh)
    split = dict(zip((p for p, _ in TT.leaves_with_paths(params)), marks))
    state = None
    if fsdp:
        def nbytes(tree):
            return sum(x.numel() * x.element_size() for x in TT.leaves(tree))
        n_whole = sum(math.prod(s) for s in sharding.whole_shapes(cfg).values())
        embed = params["tok_embed"]
        state = dict(params=nbytes(params), m=nbytes(opt["m"]), v=nbytes(opt["v"]),
                     whole=dict(params=4 * n_whole, m=(2 if opt_cfg.posit_moments else 4)
                                * n_whole, v=4 * n_whole),
                     split=sum(marks), embed=list(embed.shape))
    return dict(losses=losses, grad_norms=gnorms, walls=walls, counts=read_counts(), state=state,
                leaf_sq=[r.tolist() for r in leaf_sq], leaf_split=[split[p] for p in K1_LEAVES],
                n_leaves=len(leaves), n_params=sum(p.numel() for p in leaves),
                wall=time.perf_counter() - t0, wire={"/".join(k): list(v) for k, v in
                                                     collectives.wire.items()},
                peak_gib=peak)


# (o3): (T)'s gemma-7b under FSDP at "data" 2, one step: its leaves cross
# gloo whole once a use, the 256 000-row embedding's 3.1 GB twice a step,
# so a step takes 20-30 s on the shared card.  One step holds the loss,
# the gradient norms and the launches of an update on the pieces to (T)'s;
# the update's values against the reference's are held on the CPU
# (tests/test_torch_train_dp.py, tests/test_torch_train_ranks.py)
O3_STEPS = 1


def k1_o3_rank(argv, devices, steps):
    """(k1), then (o3) in the same two ranks: (T)'s model under FSDP on a
    ``(2, 1)`` mesh of the same process group (``k1_rank(fsdp=True)``,
    ``O3_STEPS`` steps)."""
    k1 = k1_rank(argv, devices, steps)
    gc.collect()
    torch.cuda.empty_cache()
    return k1, k1_rank(argv, devices, O3_STEPS, fsdp=True)


def check_o3(o3):
    """(o3)'s ranks: launches exactly a quantize a leaf at init and a
    quantize and a dequantize a leaf a step (rows 1 and 2 on the pieces),
    the same losses and norms on both ranks, and each rank's parameter,
    ``m`` and ``v`` bytes half the whole model's on the leaves that split
    (every leaf of gemma-7b splits at data 2).  Prints the bytes."""
    n = o3[0]["n_leaves"]
    for rank, r in enumerate(o3):
        expect = {k: 0 for k in r["counts"]}
        expect.update(posit_quantize=n * (1 + O3_STEPS), posit_dequantize=n * O3_STEPS)
        if r["counts"] != expect:
            fail(f"(o3) rank {rank} launched {r['counts']}, expected {expect}")
        if r["losses"] != o3[0]["losses"] or r["grad_norms"] != o3[0]["grad_norms"]:
            fail(f"(o3) rank {rank}'s losses or norms differ from rank 0's")
        st = r["state"]
        if st["split"] != n or any(2 * st[k] != st["whole"][k] for k in ("params", "m", "v")):
            fail(f"(o3) rank {rank} holds {st}: not half of every leaf")
    r0 = o3[0]
    st = r0["state"]
    print(f"(o3) gemma-7b at (T)'s shape under FSDP on a (2, 1) mesh, (k)'s two ranks "
          f"sharing one card over gloo, not a multi-card speed: {O3_STEPS} "
          f"step{'s' * (O3_STEPS != 1)}, losses "
          f"{[round(x, 4) for x in r0['losses']]}, grad norms "
          f"{[round(x, 4) for x in r0['grad_norms']]}; step walls "
          f"{[round(x, 3) for x in r0['walls']]} s; {r0['wall']:.1f} s with the draw; "
          f"{st['split']} of {n} leaves split over 'data' (tok_embed's piece {st['embed']}); "
          f"bytes a rank: parameters {st['params']:,}, m {st['m']:,}, v {st['v']:,} against "
          f"(T)'s {st['whole']['params']:,}, {st['whole']['m']:,}, {st['whole']['v']:,}; peak "
          f"device memory per rank {[round(r['peak_gib'], 2) for r in o3]} GiB; launches per "
          f"rank {r0['counts']}; 'data' wire (calls, bytes) "
          f"{ {k: v for k, v in r0['wire'].items() if k.startswith('data/')} }; {CARD}")


def _pod_config(reduced=False):
    import dataclasses

    from repro_torch import configs
    cfg = configs.get_config(POD_ARCH)
    cfg = cfg.reduced(compute_dtype="float32") if reduced else dataclasses.replace(
        cfg, n_layers=POD_LAYERS)
    return dataclasses.replace(cfg, n_visual_tokens=0, fsdp=False,
                               seq_shard_activations=False, grad_compress="posit16")


def _state_bits_equal(a, b):
    from repro_torch import tree as TT
    la, lb = TT.leaves(a), TT.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x).to(y.device), _bits(y)) for x, y in zip(la, lb))


def k2_rank(ckdir, devices, steps, reduced=False):
    """(k2) and (k3), one rank of pod 2: an uncompressed data-parallel
    step 0's loss; ``steps`` pod-compressed steps (a rank a pod), the
    state saved after two; rank 0 restores it, checks it bit for bit,
    and after the ranks' last step runs that step on one device from
    the restored state.  Returns the losses, walls, launches (init
    and the steps; the save and restore launch nothing), the wire, the
    error feedback's state and, on rank 0, rows 1 and 2 at the wire's
    leaves and the restore's numbers."""
    import torch.distributed as dist

    from repro_torch import tree as TT
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.compress import gradient
    from repro_torch.core.convert import f32_to_posit, posit_to_f32
    from repro_torch.core.types import POSIT16
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_family
    from repro_torch.optim import adamw
    from repro_torch.runtime import collectives, train_loop

    dev = _rank_device(devices)
    rank = dist.get_rank()
    cfg = _pod_config(reduced)
    _sync_peak(dev, reset=True)
    params = get_family(cfg).init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    pipe = Pipeline(DataConfig(seed=POD_SEED), cfg, POD_BATCH, POD_SEQ, device=dev)

    # the loss of an uncompressed data-parallel step 0 (data 2)
    dp = make_mesh((2, 1), ("data", "model"), dev.type)
    dp_loss, _ = train_loop.make_grad_fn(cfg, dp)(params, pipe.batch_at(0))
    dp_loss = float(dp_loss)
    for p in TT.leaves(params):
        p.grad = None

    mesh = make_mesh((N_PODS, 1, 1), ("pod", "data", "model"), dev.type)
    opt_cfg = adamw.AdamWConfig(posit_moments=True)
    reset_counts()
    opt = adamw.init(params, opt_cfg)
    ef = gradient.init_error_state(params)
    step = train_loop.make_train_step(cfg, opt_cfg, n_pods=N_PODS, compressed=True,
                                      mesh=mesh)
    ckpt = Checkpointer(ckdir, keep=1, mesh=mesh)
    collectives.wire.clear()
    losses, gnorms, walls, out = [], [], [], {}
    for i in range(steps):
        if i == steps - 1:                     # (k3): the state after two steps
            state = {"params": params, "opt": opt}
            t1 = time.perf_counter()
            ckpt.save(i, state)
            out["save_s"] = time.perf_counter() - t1
            if rank == 0:
                t1 = time.perf_counter()
                restored, at = Checkpointer(ckdir, keep=1).restore(i, state, device=dev)
                out["restore_s"] = time.perf_counter() - t1
                out["restored_equal"] = at == i and _state_bits_equal(restored, state)
                out["save_bytes"] = ckpt.last_save.get("bytes")
            dist.barrier()
        batch = pipe.batch_at(i)
        tiled = {k: v.reshape((N_PODS, POD_BATCH // N_PODS) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        t1 = time.perf_counter()
        params, opt, ef, m = step(params, opt, ef, tiled, i)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        walls.append(time.perf_counter() - t1)
    peak = _sync_peak(dev)
    out.update(losses=losses, grad_norms=gnorms, walls=walls, counts=read_counts(),
               dp_loss=dp_loss, n_leaves=len(TT.leaves(params)),
               n_elems=sum(p.numel() for p in TT.leaves(params)),
               wire={"/".join(k): v for k, v in collectives.wire.items()},
               ef_nonzero=any(bool(torch.any(e != 0)) for e in TT.leaves(ef)),
               peak_gib=peak)
    if rank == 0:
        # rows 1 and 2 at the wire's leaves: the embedding's and an MLP
        # weight's residual-fed gradient, and their gathered patterns
        plain_q = _plain_codec(lambda x: f32_to_posit(x, POSIT16), POSIT16.storage_dtype)
        plain_dq = _plain_codec(lambda p: posit_to_f32(p, POSIT16), torch.float32)
        from repro_torch.kernels import posit_codec as C
        codec = {}
        for key, e, p in (("embedding", ef["tok_embed"], params["tok_embed"]),
                          ("mlp_wi", ef["layers"][0]["mlp"]["wi"]["w"],
                           params["layers"][0]["mlp"]["wi"]["w"])):
            x = (e + p * 1e-3).contiguous()
            q = C.quantize(x, POSIT16)
            g = torch.stack([q, C.quantize((x * 0.5).contiguous(), POSIT16)])
            codec[key] = _codec_at(x, g, plain_q, plain_dq)
            del x, q, g
        out["codec"] = codec
        # (k3): the ranks' last step, on one device from the restored state
        del params, opt, ef, state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        one = train_loop.make_train_step(cfg, opt_cfg)
        before = read_counts()
        _, _, m = one(restored["params"], restored["opt"], pipe.batch_at(steps - 1),
                      steps - 1)
        out["restored_loss"] = float(m["loss"])
        out["restored_counts"] = {k: v - before[k] for k, v in read_counts().items()}
        del restored
    dist.barrier()
    return out


def train_ranks_phase(dev):
    """(k): (k1) tensor-parallel training of gemma-7b at (T)'s shape on
    two ranks, then (k2) the pod-compressed step of internvl2-1b at full
    width and depth on two pods and (k3) its elastic restore on one
    rank.  Checks the ranks' launches, the wire and the restore; the
    parent holds (k1) to (T) (``check_train_ranks``)."""
    from repro_torch.launch import mesh as M

    base = _roomiest_dir()
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_pods_", dir=base)
    try:
        t0 = time.perf_counter()
        pairs = M.spawn(k1_o3_rank, RANK_DEVICES, (TRAIN_ARGV, RANK_DEVICES, RANK_STEPS),
                        timeout=900)
        k1, o3 = [p[0] for p in pairs], [p[1] for p in pairs]
        k1_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        k2 = M.spawn(k2_rank, RANK_DEVICES, (ckdir, RANK_DEVICES, RANK_STEPS, POD_REDUCED),
                     timeout=900)
        k2_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    counts = {k: 0 for k in read_counts()}
    n = k1[0]["n_leaves"]
    for rank, r in enumerate(k1):
        expect = {k: 0 for k in r["counts"]}
        expect.update(posit_quantize=n * (1 + RANK_STEPS), posit_dequantize=n * RANK_STEPS)
        if r["counts"] != expect:
            fail(f"(k1) rank {rank} launched {r['counts']}, expected {expect}")
        if r["losses"] != k1[0]["losses"] or r["grad_norms"] != k1[0]["grad_norms"]:
            fail(f"(k1) rank {rank}'s losses or norms differ from rank 0's")
        counts = {k: counts[k] + v for k, v in r["counts"].items()}
    check_o3(o3)
    for r in o3:
        counts = {k: counts[k] + v for k, v in r["counts"].items()}
    r0 = k1[0]
    ar = {k: v for k, v in r0["wire"].items() if k.startswith("model/")}
    print(f"(k1) gemma-7b at (T)'s shape on a (1, 2) mesh, two ranks sharing one card over "
          f"gloo, not a multi-card speed: {RANK_STEPS} steps, losses "
          f"{[round(x, 4) for x in r0['losses']]}, grad norms "
          f"{[round(x, 4) for x in r0['grad_norms']]}; step walls "
          f"{[round(x, 3) for x in r0['walls']]} s; {r0['n_params']:,} parameters a rank in "
          f"{n} leaves; peak device memory per rank "
          f"{[round(r['peak_gib'], 2) for r in k1]} GiB; {k1_wall:.1f} s with the ranks' "
          f"start and (o3); launches per rank {r0['counts']}; collectives on 'model' (calls, bytes): "
          f"{ar}; {CARD}")

    n = k2[0]["n_leaves"]
    for rank, r in enumerate(k2):
        expect = {k: 0 for k in r["counts"]}
        expect.update(posit_quantize=n * (1 + 2 * RANK_STEPS),
                      posit_dequantize=n * 3 * RANK_STEPS)
        if r["counts"] != expect:
            fail(f"(k2) rank {rank} launched {r['counts']}, expected {expect} (a quantize "
                 f"and a dequantize a leaf for the feedback, a dequantize a leaf of the "
                 f"gathered patterns, the moments' pair)")
        pod = {k: v for k, v in r["wire"].items() if k.startswith("pod/")}
        want_bytes = RANK_STEPS * N_PODS * 2 * r["n_elems"]
        if pod.get("pod/broadcast/grad/uint16", [0, 0])[1] != want_bytes \
                or set(pod) != {"pod/broadcast/grad/uint16", "pod/all_reduce/loss/float32"}:
            fail(f"(k2) rank {rank}: the pod wire carried {pod}, want only posit16 patterns "
                 f"({want_bytes:,} bytes) and the loss")
        if not r["ef_nonzero"] or not np.isfinite(r["losses"]).all():
            fail(f"(k2) rank {rank}: error feedback zero or losses {r['losses']}")
        if r["losses"] != k2[0]["losses"]:
            fail(f"(k2) rank {rank}'s losses differ from rank 0's")
        counts = {k: counts[k] + v for k, v in r["counts"].items()}
    r0 = k2[0]
    if abs(r0["losses"][0] - r0["dp_loss"]) > POD_LOSS_RTOL * r0["dp_loss"]:
        fail(f"(k2) step 0's loss {r0['losses'][0]} against the data-parallel step's "
             f"{r0['dp_loss']}")
    per_step = r0["wire"]["pod/broadcast/grad/uint16"][1] / RANK_STEPS
    print(f"(k2) {POD_ARCH} at full width, {_pod_config(POD_REDUCED).n_layers} layers, "
          f"{r0['n_elems']:,} parameters in {n} leaves, 2 pods of {POD_BATCH // N_PODS} x "
          f"{POD_SEQ}, posit16 wire, posit16 moments: losses "
          f"{[round(x, 6) for x in r0['losses']]} (an uncompressed data-parallel step 0: "
          f"{r0['dp_loss']:.6f}, {abs(r0['losses'][0] - r0['dp_loss']) / r0['dp_loss']:.2e} "
          f"relative, limit {POD_LOSS_RTOL}), grad norms "
          f"{[round(x, 4) for x in r0['grad_norms']]}; step walls "
          f"{[round(x, 3) for x in r0['walls']]} s; peak device memory per rank "
          f"{[round(r['peak_gib'], 2) for r in k2]} GiB; {k2_wall:.1f} s with the ranks' "
          f"start and (k3); the pod wire a step and a rank: {per_step:,.0f} bytes of "
          f"posit16 patterns, 2 bytes an element (an f32 all-reduce would carry "
          f"{2 * per_step:,.0f}); launches per rank {r0['counts']}; {CARD}")
    for key, rr in r0["codec"].items():
        for kind, t in rr.items():
            print(f"(k2) posit_{kind} at the wire's {key} leaf {t['shape']}: "
                  f"{t['ms']:.4f} ms, alone {t['kernel_ms']:.4f} ms (bound "
                  f"{t['bound_ms']:.4f} ms by bytes, plain by chunks {t['plain_ms']:.2f} ms)")

    # (k3)
    if not r0["restored_equal"]:
        fail("(k3) the restored state differs from the saved one")
    want = {k: 0 for k in r0["restored_counts"]}
    want.update(posit_quantize=n, posit_dequantize=n)
    if r0["restored_counts"] != want:
        fail(f"(k3) the one-device step launched {r0['restored_counts']}, expected {want}")
    last = r0["losses"][-1]
    print(f"(k3) the state after two steps ({r0['save_bytes']:,} bytes, saved in "
          f"{r0['save_s']:.2f} s) restored on one rank in {r0['restore_s']:.2f} s, equal to "
          f"the saved state bit for bit; the third step on one device from it: loss "
          f"{r0['restored_loss']:.6f} against the ranks' {last:.6f} "
          f"({abs(r0['restored_loss'] - last) / last:.2e} relative, limit {POD_LOSS_RTOL})")
    if abs(r0["restored_loss"] - last) > POD_LOSS_RTOL * last:
        fail(f"(k3) the restored step's loss {r0['restored_loss']} against {last}")
    counts = {k: counts[k] + v for k, v in r0["restored_counts"].items()}
    return dict(counts=counts, codec=r0["codec"], k1=[{k: v for k, v in r.items()}
                                                      for r in k1], o3=o3,
                k2={k: r0[k] for k in ("losses", "grad_norms", "walls", "dp_loss",
                                       "restored_loss", "peak_gib", "n_elems")},
                k1_wall=k1_wall, k2_wall=k2_wall, wire_bytes_per_step=per_step)


def check_train_ranks(trained, ranked, label="(k1)"):
    """(k1) against (T): each step's loss, gradient norm and the norms of
    the ``K1_LEAVES`` gradients (a split leaf's squares summed over the
    ranks, a replicated one's from rank 0) within ``K1_LOSS_RTOL``,
    ``K1_GNORM_RTOL`` and ``K1_LEAF_RTOL``; the step walls and peak
    memory beside (T)'s.  ``label``: the lane held ((n1) under the
    sequence layout, its ranks ``ranked["k1"]`` too)."""
    ranks = ranked["k1"]
    r0 = ranks[0]
    for i in range(len(r0["losses"])):
        dl = abs(r0["losses"][i] - trained["losses"][i]) / trained["losses"][i]
        dg = abs(r0["grad_norms"][i] - trained["grad_norms"][i]) / trained["grad_norms"][i]
        print(f"{label} step {i}: loss {r0['losses'][i]:.6f} against (T)'s "
              f"{trained['losses'][i]:.6f} ({dl:.2e} relative, limit {K1_LOSS_RTOL}); grad "
              f"norm {r0['grad_norms'][i]:.6f} against {trained['grad_norms'][i]:.6f} "
              f"({dg:.2e}, limit {K1_GNORM_RTOL}); step wall {r0['walls'][i]:.3f} s "
              f"against {trained['walls'][i]:.3f} s")
        if dl > K1_LOSS_RTOL or dg > K1_GNORM_RTOL:
            fail(f"{label} step {i} differs from (T)'s beyond bf16 rounding")
        worst = []
        for j, path in enumerate(K1_LEAVES):
            sq = sum(r["leaf_sq"][i][j] for r in ranks) if r0["leaf_split"][j] \
                else r0["leaf_sq"][i][j]
            got, want = math.sqrt(sq), math.sqrt(trained["leaf_sq"][i][j])
            worst.append((abs(got - want) / want, path, got, want))
        print(f"{label} step {i}, gradient norms of single leaves against (T)'s (relative, "
              f"limit {K1_LEAF_RTOL}): " + ", ".join(
                  f"{p}{' (split)' if r0['leaf_split'][j] else ''} {g:.6g} vs {w:.6g} "
                  f"({d:.2e})" for j, (d, p, g, w) in enumerate(worst)))
        bad = [p for d, p, _, _ in worst if not d <= K1_LEAF_RTOL]
        if bad:
            fail(f"{label} step {i}: the gradients of {bad} differ from (T)'s")
    print(f"{label} peak device memory per rank {[round(r['peak_gib'], 2) for r in ranks]}"
          f" GiB against (T)'s {trained['peak_gib']:.2f} GiB on one rank")


# ---------------------------------------------------------------------------
# (m) training of hymba, rwkv6 and whisper across ranks at "model" > 1
# (the partial gradients of the leaves a rank holds whole but slices),
# ranks sharing the one card over gloo, so no wall here is a multi-card
# speed
# ---------------------------------------------------------------------------

TM_STEPS, TM_BATCH, TM_SEQ = 3, 8, 512
# one spawn a "model" size: size -> {arch: layers, 0 = all}.  rwkv6-7b at
# 2: 32 of 64 heads and half of d_ff a rank, the vocabulary split, 2 of
# 32 layers; whisper-tiny at 2: 3 of 6 heads, all 4 + 4 layers, the tied
# head whole (51 865 is odd); hymba-1.5b at 5: 5 of 25 attention and SSM
# heads and 1 of 5 KV heads a rank, layers 0 (global) and 1 (a window
# layer), its MLP and vocabulary whole (5 504 and 32 001 are not
# multiples of 5)
TM_LAUNCHES = {2: {"rwkv6-7b": 2, "whisper-tiny": 0}, 5: {"hymba-1.5b": 2}}
TM_DEVICE = "cuda:0"           # every rank's device
TM_REDUCED = False             # a CPU rehearsal shrinks every config to the reduced f32 one
# the archs held in f32 compute, whisper in its bf16.  In bf16 rwkv6's and
# hymba's ranks drift from one device past (k1)'s limits (global norm
# 4.8e-4 and 3.6e-4, the per-head leaves u, A_log and dt_bias 2.9e-3 to
# 6.5e-3, loss 2.3e-5 at most): rounding, no more than bf16 itself moves
# one device's gradients from f32 (tests/test_torch_train_ranks.py::
# test_bf16_gradient_drift_is_rounding); in f32 they agree within 3e-6
TM_F32 = ("rwkv6-7b", "hymba-1.5b")
# (m) against one device on the same config, depth, seed and data: loss,
# global gradient norm and leaf gradient norms, relative.  bf16 (whisper)
# keeps (k1)'s limits: it read 6.7e-6, 1.1e-4 and 6.4e-4 on the held
# leaves (margins 15x, 1.8x, 1.6x).  f32 read at most 8.3e-8, 2.7e-7 and
# 2.7e-6 on all three families: limits 1e-5, 1e-5 and 1e-4 (margins 120x,
# 37x, 37x), where a leaf summed once too often or left partial is off by
# a large fraction of itself
TM_LIMITS = {"bfloat16": (1e-4, 2e-4, 1e-3), "float32": (1e-5, 1e-5, 1e-4)}
# the gradient norms held to one device's: every partial leaf
# (``sharding.partial_grad_leaves``) and these, of their own groups (a
# replicated leaf that must not be summed, rwkv6's cm_wr among them; split
# leaves, their squares summed over the ranks; the residual's norms)
TM_LEAVES = {
    "rwkv6-7b": ("tok_embed", "layers/0/cm_wr/w", "layers/0/wl_a", "layers/0/tm_w1",
                 "layers/0/maa_wkvrg", "layers/0/wr/w", "layers/0/wo/w", "layers/1/cm_wv/w",
                 "layers/1/ln1/scale"),
    "whisper-tiny": ("tok_embed", "pos_embed", "enc_layers/0/attn/wq/w",
                     "enc_layers/0/attn/wq/b", "enc_layers/0/attn/wo/b",
                     "dec_layers/0/cross/wk/w", "dec_layers/0/cross/wv/b",
                     "dec_layers/3/mlp/wi/w", "dec_layers/0/ln_x/scale"),
    "hymba-1.5b": ("tok_embed", "meta_tokens", "layers/0/wq/w", "layers/0/wk/w",
                   "layers/1/wo/w", "layers/1/mlp/wi/w", "layers/0/ln1/scale"),
    "internvl2-1b": ("tok_embed", "layers/0/attn/wq/w", "layers/0/mlp/wi/w",
                     "layers/1/mlp/wo/w", "layers/0/ln1/scale", "final_norm/scale"),
}
# rows 1 and 2 at a rank's shape of each family's largest leaf (its m)
TM_CODEC_LEAF = "tok_embed"


def _tm_config(arch, f32=(), seq=False):
    """(m)'s config of ``arch`` (``TM_LAUNCHES``' depth); ``seq``: (n)'s
    (``TN_LAUNCHES``' depth, the sequence layout's flag kept on)."""
    import dataclasses

    from repro_torch import configs
    launches = TN_LAUNCHES if seq else TM_LAUNCHES
    layers = next(launch[arch] for launch in launches.values() if arch in launch)
    cfg = configs.get_config(arch)
    if TM_REDUCED:
        cfg = cfg.reduced(compute_dtype="float32")
    if arch in f32:
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, fsdp=False,
                               seq_shard_activations=seq)


def _tm_squares(grads, split, n):
    """(leaves, 2) f32 on the device: each gradient leaf's sum of squares
    over the part this rank holds a slice of (``sharding.split_leaves``;
    a ``Segments`` leaf's split segments) and over the part it holds
    whole."""
    from repro_torch import tree as TT
    rows = []
    for g, s in zip(TT.leaves(grads), split):
        sq = [torch.zeros((), dtype=torch.float32, device=g.device)] * 2
        for piece, sp in (s[1].pieces(g, s[0], n) if isinstance(s, tuple) else [(g, s)]):
            sq[bool(sp)] = sq[bool(sp)] + torch.sum(torch.square(piece.float()))
        rows.append(torch.stack([sq[1], sq[0]]))
    return torch.stack(rows)


def tm_train(arch, dev, steps, mesh=None, f32=(), seq=False):
    """(m) one run of ``arch``: ``steps`` steps of ``make_train_step`` on
    one device or, with ``mesh``, on this rank of it (its shard drawn as
    the weights are, posit16 moments).  Returns the losses, norms, walls,
    launches, every gradient leaf's squares (``_tm_squares``) a step, the
    partial leaves and their bytes, the wire and the peak memory; on
    rank 0 of a mesh, rows 1 and 2 at ``TM_CODEC_LEAF``'s m.  ``f32``:
    the archs run in f32 compute; ``seq``: (n)'s config
    (``_tm_config``)."""
    import torch.distributed as dist

    from repro_torch import tree as TT
    from repro_torch.core.convert import f32_to_posit, posit_to_f32
    from repro_torch.core.types import POSIT16
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import get_family
    from repro_torch.optim import adamw
    from repro_torch.runtime import collectives, sharding, train_loop

    cfg = _tm_config(arch, f32, seq)
    tp = None if mesh is None else sharding.tensor_parallel(cfg, mesh, seq=seq)
    reset_counts()
    _sync_peak(dev, reset=True)
    collectives.wire.clear()
    t0 = time.perf_counter()
    shard = None if mesh is None else (
        lambda t, prefix: sharding.shard_params(t, mesh, cfg, prefix))
    params = get_family(cfg).init_params(cfg, seed=0, device=dev, dtype=torch.float32,
                                         shard=shard)
    opt_cfg = adamw.AdamWConfig(posit_moments=True)
    opt = adamw.init(params, opt_cfg)
    step = train_loop.make_train_step(cfg, opt_cfg, total_steps=steps, mesh=mesh)
    pipe = Pipeline(DataConfig(), cfg, TM_BATCH, TM_SEQ, device=dev)
    named = TT.leaves_with_paths(params)
    split = [False] * len(named) if mesh is None else sharding.split_leaves(params, cfg, mesh)
    partial = sharding.partial_grad_leaves(params, cfg, tp)
    n = 1 if tp is None else tp.size
    partial_bytes = 0                  # f32 gradients: a whole leaf, or its whole segments
    for (_, p), part in zip(named, partial):
        if part is True:
            partial_bytes += p.numel() * 4
        elif part:
            partial_bytes += sum(x.numel() * 4 for x, sp in part[1].pieces(p, part[0], n)
                                 if not sp)
    record, update = [], adamw.update

    def recording(grads, *args, **kw):
        record.append(_tm_squares(grads, split, n))
        return update(grads, *args, **kw)

    adamw.update = recording
    losses, gnorms, walls = [], [], []
    try:
        for i in range(steps):
            t1 = time.perf_counter()
            params, opt, m = step(params, opt, pipe.batch_at(i), i)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            walls.append(time.perf_counter() - t1)
    finally:
        adamw.update = update
    peak = _sync_peak(dev)
    out = dict(losses=losses, grad_norms=gnorms, walls=walls, counts=read_counts(),
               n_leaves=len(named), n_params=sum(p.numel() for _, p in named),
               squares=[r.tolist() for r in record], paths=[p for p, _ in named],
               partial=[p for (p, _), part in zip(named, partial) if part],
               partial_bytes=partial_bytes, peak_gib=peak, wall=time.perf_counter() - t0,
               wire={"/".join(k): list(v) for k, v in collectives.wire.items()})
    if mesh is not None and dist.get_rank() == 0:
        x = dict(TT.leaves_with_paths(opt["v"]))[TM_CODEC_LEAF].contiguous()
        pats = dict(TT.leaves_with_paths(opt["m"]))[TM_CODEC_LEAF].contiguous()
        out["codec"] = {f"{arch} {TM_CODEC_LEAF}": _codec_at(
            x, pats, _plain_codec(lambda t: f32_to_posit(t, POSIT16), POSIT16.storage_dtype),
            _plain_codec(lambda t: posit_to_f32(t, POSIT16), torch.float32))}
        del x, pats
    del params, opt, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if mesh is not None:
        dist.barrier()
    return out


def tm_rank(archs, devices, steps, f32=(), seq=False):
    """(m) one rank: each of ``archs`` on a ``(1, ranks)`` mesh
    (``tm_train``)."""
    from repro_torch.launch.mesh import make_mesh

    dev = _rank_device(devices)
    mesh = make_mesh((1, len(devices)), ("data", "model"), dev.type)
    return {arch: tm_train(arch, dev, steps, mesh, f32, seq) for arch in archs}


def _tm_leaf_norms(run, ranks=None):
    """``{path: [norm a step]}`` from ``tm_train``'s squares: one
    device's, or the ranks' (a split part's squares summed over them, a
    whole part's from rank 0)."""
    rows = run["squares"] if ranks is None else [
        [[sum(r["squares"][i][j][0] for r in ranks), run["squares"][i][j][1]]
         for j in range(len(run["paths"]))] for i in range(len(run["squares"]))]
    return {p: [math.sqrt(rows[i][j][0] + rows[i][j][1]) for i in range(len(rows))]
            for j, p in enumerate(run["paths"])}


def check_train_model(arch, one, ranks, wall, seq=False):
    """(m) one arch: the ranks' launches exact (a quantize a leaf at init
    and a step, a dequantize a leaf a step) and losses equal; the
    ``"model"`` all-reduces of the gradient one a partial leaf a step,
    of its bytes; each step's loss, global gradient norm and the norms
    of the partial leaves and ``TM_LEAVES`` against one device's.
    ``seq``: an arch of (n), its config ``_tm_config``'s with ``seq``."""
    label = "(n)" if seq else "(m)"
    r0, mp = ranks[0], len(ranks)
    for rank, r in enumerate(ranks):
        expect = {k: 0 for k in r["counts"]}
        expect.update(posit_quantize=r["n_leaves"] * (1 + TM_STEPS),
                      posit_dequantize=r["n_leaves"] * TM_STEPS)
        if r["counts"] != expect:
            fail(f"{label} {arch} rank {rank} launched {r['counts']}, expected {expect}")
        if r["losses"] != r0["losses"] or r["grad_norms"] != r0["grad_norms"]:
            fail(f"{label} {arch} rank {rank}'s losses or norms differ from rank 0's")
        grad = r["wire"].get("model/all_reduce/grad/float32", [0, 0])
        want = [len(r["partial"]) * TM_STEPS, r["partial_bytes"] * TM_STEPS]
        if grad != want:
            fail(f"{label} {arch} rank {rank}: the partial gradients' all-reduces {grad}, want "
                 f"{want} ({len(r['partial'])} leaves of {r['partial_bytes']:,} bytes a step)")
    if one["paths"] != r0["paths"]:
        fail(f"{label} {arch}: the ranks' leaves are not one device's")
    ar = {k: v for k, v in r0["wire"].items() if k.startswith("model/")}
    cfg = _tm_config(arch, TN_F32 if seq else TM_F32, seq)
    print(f"{label} {arch} at full width, {cfg.n_layers} layers, {cfg.compute_dtype}, 'model' {mp} "
          f"({mp} ranks sharing one card over gloo, not a multi-card speed), batch "
          f"{TM_BATCH} x {TM_SEQ}, posit16 moments: losses "
          f"{[round(x, 4) for x in r0['losses']]}, grad norms "
          f"{[round(x, 4) for x in r0['grad_norms']]}; step walls "
          f"{[round(x, 3) for x in r0['walls']]} s against one device's "
          f"{[round(x, 3) for x in one['walls']]} s; {r0['n_params']:,} parameters a rank "
          f"({one['n_params']:,} on one device) in {r0['n_leaves']} leaves; peak device "
          f"memory per rank {[round(r['peak_gib'], 2) for r in ranks]} GiB (one device "
          f"{one['peak_gib']:.2f}); {wall:.1f} s with the ranks' start; launches per rank "
          f"{ {k: v for k, v in r0['counts'].items() if v} }; partial leaves "
          f"{len(r0['partial'])} ({r0['partial_bytes']:,} bytes a step); collectives on "
          f"'model' (calls, bytes): {ar}; {CARD}")
    got_l, want_l = _tm_leaf_norms(r0, ranks), _tm_leaf_norms(one)
    held = list(r0["partial"]) + [p for p in TM_LEAVES[arch] if p not in r0["partial"]]
    loss_tol, gnorm_tol, leaf_tol = TM_LIMITS[cfg.compute_dtype]
    for i in range(TM_STEPS):
        dl = abs(r0["losses"][i] - one["losses"][i]) / one["losses"][i]
        dg = abs(r0["grad_norms"][i] - one["grad_norms"][i]) / one["grad_norms"][i]
        worst = sorted(((abs(got_l[p][i] - want_l[p][i]) / want_l[p][i], p)
                        for p in got_l if want_l[p][i] > 0), reverse=True)
        leaf = {p: abs(got_l[p][i] - want_l[p][i]) / want_l[p][i] for p in held}
        print(f"{label} {arch} step {i}: loss {r0['losses'][i]:.6f} against one device's "
              f"{one['losses'][i]:.6f} ({dl:.2e} relative, limit {loss_tol}); grad norm "
              f"{r0['grad_norms'][i]:.6f} against {one['grad_norms'][i]:.6f} ({dg:.2e}, limit "
              f"{gnorm_tol}); leaf gradient norms (limit {leaf_tol}): partial "
              f"{max((leaf[p] for p in r0['partial']), default=0.0):.2e} at most, "
              + ", ".join(f"{p} {leaf[p]:.2e}" for p in TM_LEAVES[arch])
              + f"; of all {len(worst)} leaves the worst {worst[0][1]} {worst[0][0]:.2e}")
        if dl > loss_tol or dg > gnorm_tol:
            fail(f"{label} {arch} step {i} differs from one device's beyond rounding")
        bad = [p for p in held if not leaf[p] <= leaf_tol]
        if bad:
            fail(f"{label} {arch} step {i}: the gradients of {bad} differ from one device's")


def train_model_phase(dev):
    """(m): each arch of ``TM_LAUNCHES`` on one device, then each launch's
    ranks (one spawn a launch), held to the one-device runs
    (``check_train_model``).  Returns the launches (the one-device runs'
    and the ranks'), rows 1 and 2 at ``TM_CODEC_LEAF`` and the walls."""
    from repro_torch.launch import mesh as M

    t_phase = time.perf_counter()
    counts = {k: 0 for k in read_counts()}
    one, codec, out = {}, {}, {}
    for launch in TM_LAUNCHES.values():
        for arch in launch:
            one[arch] = tm_train(arch, dev, TM_STEPS, f32=TM_F32)
            counts = {k: counts[k] + v for k, v in one[arch]["counts"].items()}
    for mp, launch in TM_LAUNCHES.items():
        devices = [TM_DEVICE] * mp
        t0 = time.perf_counter()
        res = M.spawn(tm_rank, devices, (list(launch), devices, TM_STEPS, TM_F32),
                      timeout=900)
        wall = time.perf_counter() - t0
        for arch in launch:
            ranks = [r[arch] for r in res]
            check_train_model(arch, one[arch], ranks, wall)
            codec.update(ranks[0]["codec"])
            for r in ranks:
                counts = {k: counts[k] + v for k, v in r["counts"].items()}
            out[arch] = dict(one={k: one[arch][k] for k in ("losses", "grad_norms", "walls",
                                                            "peak_gib")},
                             ranks={k: ranks[0][k] for k in ("losses", "grad_norms", "walls")},
                             peak_gib=[r["peak_gib"] for r in ranks], wall=wall)
    for key, rr in codec.items():
        for kind, t in rr.items():
            print(f"(m) posit_{kind} at {key}'s m on a rank {t['shape']}: {t['ms']:.4f} ms, "
                  f"alone {t['kernel_ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by bytes, "
                  f"plain by chunks {t['plain_ms']:.2f} ms)")
    wall = time.perf_counter() - t_phase
    print(f"(m) phase wall {wall:.1f} s, the one-device runs and the ranks' start included")
    return dict(counts=counts, codec=codec, archs=out, wall=wall)


# ---------------------------------------------------------------------------
# (n) the sequence layout across ranks: the configs' seq_shard_activations
# (Megatron-SP residuals, context-parallel attention) as explicit
# collectives, ranks sharing the one card over gloo, so no wall here is a
# multi-card speed
# ---------------------------------------------------------------------------

# one spawn a "model" size: size -> {arch: layers}.  At 2, (n1) runs
# first in the same ranks (gemma-7b as (T), every group split); hymba-1.5b
# at 2: 25 heads do not split, so its attention branch is context-parallel,
# its MLP splits (5 504) and its vocabulary (32 001) does not; layers 0
# (global) and 1 (a window layer), as (m).  internvl2-1b at 4: 14 heads
# and 2 KV heads do not split (context-parallel attention), d_ff 4 864
# does, the 151 655-row tied vocabulary does not (each rank's loss on its
# own positions); 4 of 24 layers, cut so that the phase fits its time,
# its 256 visual tokens the whole of rank 0's 128 positions and half of
# rank 1's
TN_LAUNCHES = {2: {"hymba-1.5b": 2}, 4: {"internvl2-1b": 4}}
TN_F32 = ("hymba-1.5b", "internvl2-1b")    # (m)'s f32 limits
# the sequence collectives each lane must show on the wire
TN_KINDS = {"gemma-7b": ("seq_gather", "seq_scatter"), "internvl2-1b": ("seq_gather",
                                                                       "seq_scatter"),
            "hymba-1.5b": ("seq_gather_replicated",)}


def _seq_wire(arch, wire):
    """A run's ``"model"`` sequence collectives and their backward
    all-reduces, ``{what: [calls, bytes]}``; fails where a kind of
    ``TN_KINDS`` is missing (the layout did not run)."""
    got = {k.split("/")[2]: v for k, v in wire.items()
           if k.startswith("model/all_reduce/seq_") or k == "model/all_reduce/backward/float32"}
    missing = [k for k in TN_KINDS[arch] if k not in got]
    if missing:
        fail(f"(n) {arch}: no {missing} on the wire {wire}: the sequence layout did not run")
    return got


def tn_rank(devices, steps):
    """(n) one rank: at "model" 2, (n1) (``k1_rank`` under the sequence
    layout) then hymba-1.5b; at 4, internvl2-1b (``tm_rank``)."""
    out = tm_rank(list(TN_LAUNCHES[len(devices)]), devices, steps, TN_F32, seq=True)
    if len(devices) == 2:
        out["n1"] = k1_rank(TRAIN_ARGV, devices, steps, seq=True)
    return out


def train_seq_phase(dev):
    """(n): (n2) and (n3) on one device, then each launch's ranks (one
    spawn a "model" size), held to the one-device runs
    (``check_train_model``); (n1)'s ranks are returned for the parent to
    hold to (T) (``check_train_ranks``).  Checks each lane's launches
    and that its sequence collectives ran."""
    from repro_torch.launch import mesh as M

    t_phase = time.perf_counter()
    counts = {k: 0 for k in read_counts()}
    one, codec, out = {}, {}, {}
    for launch in TN_LAUNCHES.values():
        for arch in launch:
            one[arch] = tm_train(arch, dev, TM_STEPS, f32=TN_F32, seq=True)
            counts = {k: counts[k] + v for k, v in one[arch]["counts"].items()}
    for mp, launch in TN_LAUNCHES.items():
        devices = [TM_DEVICE] * mp
        t0 = time.perf_counter()
        res = M.spawn(tn_rank, devices, (devices, TM_STEPS), timeout=900)
        wall = time.perf_counter() - t0
        for arch in launch:
            ranks = [r[arch] for r in res]
            check_train_model(arch, one[arch], ranks, wall, seq=True)
            codec.update(ranks[0]["codec"])
            for r in ranks:
                counts = {k: counts[k] + v for k, v in r["counts"].items()}
            out[arch] = dict(one={k: one[arch][k] for k in ("losses", "grad_norms", "walls",
                                                            "peak_gib")},
                             ranks={k: ranks[0][k] for k in ("losses", "grad_norms", "walls")},
                             peak_gib=[r["peak_gib"] for r in ranks], wall=wall,
                             wire=_seq_wire(arch, ranks[0]["wire"]))
            print(f"(n) {arch}: sequence collectives on 'model' of rank 0 over {TM_STEPS} "
                  f"steps (calls, bytes): {out[arch]['wire']}")
        if mp == 2:
            n1 = [r["n1"] for r in res]
            n = n1[0]["n_leaves"]
            for rank, r in enumerate(n1):
                expect = {k: 0 for k in r["counts"]}
                expect.update(posit_quantize=n * (1 + TM_STEPS), posit_dequantize=n * TM_STEPS)
                if r["counts"] != expect:
                    fail(f"(n1) rank {rank} launched {r['counts']}, expected {expect}")
                if r["losses"] != n1[0]["losses"] or r["grad_norms"] != n1[0]["grad_norms"]:
                    fail(f"(n1) rank {rank}'s losses or norms differ from rank 0's")
                counts = {k: counts[k] + v for k, v in r["counts"].items()}
            out["n1"] = dict(ranks=n1, wall=wall, wire=_seq_wire("gemma-7b", n1[0]["wire"]))
            print(f"(n1) gemma-7b at (T)'s shape, 'model' 2 under the sequence layout, two "
                  f"ranks sharing one card over gloo, not a multi-card speed: losses "
                  f"{[round(x, 4) for x in n1[0]['losses']]}, grad norms "
                  f"{[round(x, 4) for x in n1[0]['grad_norms']]}; step walls "
                  f"{[round(x, 3) for x in n1[0]['walls']]} s; peak device memory per rank "
                  f"{[round(r['peak_gib'], 2) for r in n1]} GiB; launches per rank "
                  f"{ {k: v for k, v in n1[0]['counts'].items() if v} }; sequence "
                  f"collectives on 'model' of rank 0 over {TM_STEPS} steps (calls, bytes): "
                  f"{out['n1']['wire']}; {CARD}")
    for key, rr in codec.items():
        for kind, t in rr.items():
            print(f"(n) posit_{kind} at {key}'s m on a rank {t['shape']}: {t['ms']:.4f} ms, "
                  f"alone {t['kernel_ms']:.4f} ms (bound {t['bound_ms']:.4f} ms by bytes, "
                  f"plain by chunks {t['plain_ms']:.2f} ms)")
    wall = time.perf_counter() - t_phase
    print(f"(n) phase wall {wall:.1f} s, the one-device runs and the ranks' start included")
    return dict(counts=counts, codec=codec, archs=out, wall=wall)


# ---------------------------------------------------------------------------
# (o4) the pod-compressed train step under FSDP, four ranks sharing the one
# card over gloo (so no wall here is a multi-card speed)
# ---------------------------------------------------------------------------

# granite-moe-3b-a800m sets both fsdp and grad_compress in its published
# config: full width, 1 of its 32 layers (0.17 B parameters; each rank
# holds f32 weights, gradients, v and residuals and posit16 m, some 6 GB
# at its peak without FSDP, so that four ranks fit beside (T)'s 29 GB:
# minicpm3-4b at 2 layers peaked 15.3 GiB a rank and ran the card out of
# memory there); pod 2 x data 2, one step of 2 pods of 4 x 512 rows with
# fsdp off, then one with it on.  The ranks run with
# ``torch.use_deterministic_algorithms`` (and cuBLAS's fixed workspace):
# two runs compared bit for bit must not differ by the card's atomics.
# Without it a run on the card found the pieces and the pod patterns
# equal but the residuals differing in their last bits: the MoE dispatch
# gathers each token's 8 choices, and that gather's backward scatter-adds
# them with atomics in no fixed order
O4_ARCH, O4_LAYERS, O4_SEED, O4_BATCH, O4_SEQ = "granite-moe-3b-a800m", 1, 9, 8, 512
O4_MESH = (2, 2, 1)
O4_DEVICES = ["cuda:0"] * 4
O4_REDUCED = False             # a CPU rehearsal shrinks (o4) to the reduced config


def _o4_config(fsdp, reduced=False):
    import dataclasses

    from repro_torch import configs
    cfg = configs.get_config(O4_ARCH)
    if not (cfg.fsdp and cfg.grad_compress):
        fail(f"(o4) {O4_ARCH}'s published config does not set fsdp and grad_compress")
    cfg = cfg.reduced(compute_dtype="float32") if reduced else dataclasses.replace(
        cfg, n_layers=O4_LAYERS)
    return dataclasses.replace(cfg, fsdp=fsdp, seq_shard_activations=False)


def _o4_step(cfg, mesh, dev, batch):
    """One pod-compressed step of ``cfg`` on this rank: its parameters,
    residuals and the patterns it put on the pod wire after the step,
    with its launches, wall, peak memory and wire."""
    from repro_torch.compress import gradient
    from repro_torch.models import get_family
    from repro_torch.optim import adamw
    from repro_torch.runtime import collectives, sharding, train_loop

    _sync_peak(dev, reset=True)
    reset_counts()
    params = sharding.shard_params(
        get_family(cfg).init_params(cfg, seed=0, device=dev, dtype=torch.float32), mesh, cfg,
        fsdp=cfg.fsdp)
    opt_cfg = adamw.AdamWConfig(posit_moments=True)
    opt = adamw.init(params, opt_cfg)
    ef = gradient.init_error_state(params)
    step = train_loop.make_train_step(cfg, opt_cfg, n_pods=O4_MESH[0], compressed=True,
                                      mesh=mesh)
    tiled = {k: v.reshape((O4_MESH[0], O4_BATCH // O4_MESH[0]) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    sent, gather = [], collectives.gather_axis

    def recording(t, mesh, axis, what="grad"):
        out = gather(t, mesh, axis, what)
        if axis == "pod":
            sent.append(_clone(out))
        return out
    collectives.wire.clear()
    train_loop.C.gather_axis = recording
    t0 = time.perf_counter()
    try:
        params, opt, ef, m = step(params, opt, ef, tiled, 0)
        loss = float(m["loss"])
    finally:
        train_loop.C.gather_axis = gather
    wall = time.perf_counter() - t0
    return dict(params=params, ef=ef, sent=sent, loss=loss, wall=wall, counts=read_counts(),
                peak_gib=_sync_peak(dev), wire={"/".join(k): list(v)
                                                for k, v in collectives.wire.items()})


def o4_rank(devices, reduced=False):
    """(o4) one rank of pod 2 x data 2: the pod-compressed step without
    FSDP, its results cut to the pieces this rank holds under FSDP, then
    the same step under FSDP; returns whether the pieces, the residuals
    and the pod wire's patterns are the cut ones bit for bit, their
    bytes, the launches, walls, peaks and wires of both."""
    from repro_torch import tree as TT
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import sharding

    dev = _rank_device(devices)
    torch.use_deterministic_algorithms(True, warn_only=True)
    mesh = make_mesh(O4_MESH, ("pod", "data", "model"), dev.type)
    cfg, fcfg = _o4_config(False, reduced), _o4_config(True, reduced)
    batch = Pipeline(DataConfig(seed=O4_SEED), cfg, O4_BATCH, O4_SEQ, device=dev).batch_at(0)
    rank, n = mesh.get_local_rank("data"), O4_MESH[1]

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in TT.leaves(tree))
    base = _o4_step(cfg, mesh, dev, batch)
    dims = [sh.spec.index("data") if "data" in sh.spec else None for sh in TT.leaves(
        sharding.param_shardings(base["params"], mesh, cfg=fcfg, fsdp=True))]

    def cut(x, d, lead=0):
        if d is None:
            return _clone(x)
        k = x.shape[d + lead] // n
        return _clone(x.narrow(d + lead, rank * k, k))
    want = dict(params=[cut(x, d) for x, d in zip(TT.leaves(base["params"]), dims)],
                ef=[cut(x, d) for x, d in zip(TT.leaves(base["ef"]), dims)],
                sent=[cut(x, d, 1) for x, d in zip(base["sent"], dims)])
    whole_bytes = dict(params=nbytes(base["params"]), ef=nbytes(base["ef"]))
    for k in ("params", "ef", "sent"):
        base.pop(k)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    got = _o4_step(fcfg, mesh, dev, batch)
    differ = []
    for k in ("params", "ef", "sent"):
        for i, (a, b) in enumerate(zip(TT.leaves(got[k]) if k != "sent" else got[k], want[k])):
            if a.shape != b.shape or not torch.equal(_bits(a), _bits(b)):
                rel = float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(
                    min=1e-30)) if a.shape == b.shape and a.is_floating_point() else None
                differ.append(f"{k}:{i} (relative {rel})")
    out = dict(base=base, fsdp={k: got[k] for k in ("loss", "wall", "counts", "peak_gib",
                                                     "wire")},
               differ=differ, n_leaves=len(dims), n_split=sum(d is not None for d in dims),
               bytes=dict(whole=whole_bytes, fsdp=dict(params=nbytes(got["params"]),
                                                       ef=nbytes(got["ef"]))))
    return out


def pod_fsdp_phase(dev):
    """(o4): four ranks of ``o4_rank``; fails unless every rank's pieces,
    residuals and pod patterns under FSDP are the step's without FSDP
    cut to them, bit for bit, its parameter and residual bytes half,
    its pod wire half and posit16 alone, and rows 1 and 2 launched
    exactly (a quantize a leaf for the moments' init, then a quantize
    and a dequantize a leaf for the feedback, a dequantize a leaf of the
    gathered patterns and the moments' pair, in each step)."""
    from repro_torch.launch import mesh as M

    t0 = time.perf_counter()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ranks = M.spawn(o4_rank, O4_DEVICES, (O4_DEVICES, O4_REDUCED), timeout=900)
    wall = time.perf_counter() - t0
    counts = {k: 0 for k in read_counts()}
    for r_i, r in enumerate(ranks):
        n = r["n_leaves"]
        if r["differ"]:
            fail(f"(o4) rank {r_i}: under FSDP {r['differ'][:8]} differ from the step "
                 f"without FSDP cut to the rank's pieces")
        if r["n_split"] != n or any(2 * r["bytes"]["fsdp"][k] != r["bytes"]["whole"][k]
                                    for k in ("params", "ef")):
            fail(f"(o4) rank {r_i}: bytes {r['bytes']}, {r['n_split']} of {n} leaves split")
        for run in (r["base"], r["fsdp"]):
            expect = {k: 0 for k in run["counts"]}
            expect.update(posit_quantize=3 * n, posit_dequantize=3 * n)
            if run["counts"] != expect:
                fail(f"(o4) rank {r_i} launched {run['counts']}, expected {expect}")
            counts = {k: counts[k] + v for k, v in run["counts"].items()}
            pod = {k for k in run["wire"] if k.startswith("pod/")}
            if pod != {"pod/broadcast/grad/uint16", "pod/all_reduce/loss/float32"}:
                fail(f"(o4) rank {r_i}: the pod wire carried {pod}")
        half = r["fsdp"]["wire"]["pod/broadcast/grad/uint16"][1]
        if 2 * half != r["base"]["wire"]["pod/broadcast/grad/uint16"][1]:
            fail(f"(o4) rank {r_i}: the FSDP pod wire {half:,} bytes is not half of "
                 f"{r['base']['wire']['pod/broadcast/grad/uint16'][1]:,}")
        if r["fsdp"]["loss"] != r["base"]["loss"] or not math.isfinite(r["fsdp"]["loss"]):
            fail(f"(o4) rank {r_i}: loss {r['fsdp']['loss']} against {r['base']['loss']}")
    r0 = ranks[0]
    print(f"(o4) {O4_ARCH} at full width, {_o4_config(True, O4_REDUCED).n_layers} layers, pod "
          f"2 x data 2, four ranks sharing one card over gloo, not a multi-card speed: one "
          f"pod-compressed step without and with FSDP, loss {r0['fsdp']['loss']:.6f} both; the "
          f"FSDP pieces, residuals and pod patterns equal the other step's cut to them bit for "
          f"bit on every rank; bytes a rank: parameters {r0['bytes']['fsdp']['params']:,} and "
          f"residuals {r0['bytes']['fsdp']['ef']:,} against {r0['bytes']['whole']['params']:,} "
          f"and {r0['bytes']['whole']['ef']:,}; the pod wire a rank "
          f"{r0['fsdp']['wire']['pod/broadcast/grad/uint16'][1]:,} bytes of posit16 patterns "
          f"against {r0['base']['wire']['pod/broadcast/grad/uint16'][1]:,}; step walls per "
          f"rank without / with FSDP {[round(r['base']['wall'], 3) for r in ranks]} / "
          f"{[round(r['fsdp']['wall'], 3) for r in ranks]} s; peak device memory per rank "
          f"{[round(r['base']['peak_gib'], 2) for r in ranks]} / "
          f"{[round(r['fsdp']['peak_gib'], 2) for r in ranks]} GiB; launches per rank and step "
          f"{r0['fsdp']['counts']['posit_quantize']} quantize, "
          f"{r0['fsdp']['counts']['posit_dequantize']} dequantize; {wall:.1f} s with the "
          f"ranks' start; {CARD}")
    return dict(counts=counts, wall=wall, ranks=[{k: r[k] for k in ("bytes", "n_leaves")}
                                                 | {"walls": [r["base"]["wall"],
                                                              r["fsdp"]["wall"]],
                                                    "peaks": [r["base"]["peak_gib"],
                                                              r["fsdp"]["peak_gib"]]}
                                                 for r in ranks])


# ---------------------------------------------------------------------------
# (p) the dry run on the card: (p1) (T)'s step predicted on fake tensors and
# then run; (p2) production cells traced on the card's own build
# ---------------------------------------------------------------------------

# (p1)'s predicted peak against torch.cuda.max_memory_allocated(): the
# prediction (the rank's argument bytes and the live fake storages' peak)
# leaves out the caching allocator's 512-byte rounding and the cuBLAS
# workspaces it hands out; fixed before the first call on the card
P1_PEAK_RTOL = 0.10
P2_CELLS = (("phi3-medium-14b", "train_4k", True), ("minicpm3-4b", "decode_32k", False),
            ("dbrx-132b", "decode_32k", False), ("hymba-1.5b", "long_500k", False))


def _p1_config():
    import dataclasses

    from repro_torch import configs
    n = int(TRAIN_ARGV[TRAIN_ARGV.index("--n-layers") + 1])
    return dataclasses.replace(configs.get_config("gemma-7b"), n_layers=n)


def p1_check(dev):
    """(p1): (T)'s step (gemma-7b at (T)'s depth, ``TRAIN_BATCH`` x
    ``TRAIN_SEQ``, its ``grad_accum``, posit16 moments) predicted on fake
    tensors of a ``1x1`` fake mesh, then run for real on the card: the
    FLOPs (``FlopCounterMode``), the argument bytes and the launches must
    equal the prediction's, and the peak lie within ``P1_PEAK_RTOL`` of
    ``torch.cuda.max_memory_allocated()``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch import mesh as M
    from repro_torch.models import get_family
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding, train_loop

    cfg = _p1_config()
    opt_cfg = adamw.AdamWConfig(posit_moments=True)
    sharding.whole_shapes(cfg)
    t0 = time.perf_counter()
    mesh = M.fake_mesh((1, 1), ("data", "model"), dev.type)
    try:
        with specs.fake_mode():
            fp = specs.params_shape(cfg, device=dev.type)
            fopt = adamw.init(fp, opt_cfg)
            fb = specs.materialize({"tokens": specs.TensorSpec((TRAIN_BATCH, TRAIN_SEQ),
                                                               torch.int32)}, dev.type)
            args = (fp, fopt, fb, 0)
            pred, _ = dryrun.trace_step(train_loop.make_train_step(cfg, opt_cfg, mesh=mesh),
                                        args)
            pred_args = dryrun._nbytes(args)
    finally:
        torch.distributed.destroy_process_group()
    trace_s = time.perf_counter() - t0
    pred_peak = pred_args + pred["temp_bytes"]

    params = get_family(cfg).init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    opt = adamw.init(params, opt_cfg)
    batch = Pipeline(DataConfig(), cfg, TRAIN_BATCH, TRAIN_SEQ, device=dev).batch_at(0)
    real_args = dryrun._nbytes((params, opt, batch))
    step = train_loop.make_train_step(cfg, opt_cfg)
    reset_counts()
    _sync_peak(dev, reset=True)
    t1 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        params, opt, m = step(params, opt, batch, 0)
        loss = float(m["loss"])
    wall = time.perf_counter() - t1
    real_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counts = read_counts()
    launches = {k: v for k, v in counts.items() if v}
    gap = (real_peak - pred_peak) / real_peak if real_peak else 0.0
    print(f"(p1) (T)'s step, gemma-7b {cfg.n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"grad_accum {cfg.grad_accum}, posit16 moments: counted on a fake trace "
          f"({trace_s:.1f} s) against the real step ({wall:.2f} s, loss {loss:.4f}): FLOPs "
          f"{pred['flops']:,} counted vs {int(fc.get_total_flops()):,} by FlopCounterMode; "
          f"argument bytes {pred_args:,} counted vs {real_args:,}; launches {pred['launches']} "
          f"counted vs {launches}; peak {pred_peak:,} bytes counted vs {real_peak:,} "
          f"max_memory_allocated ({gap:+.4f} of it, limit {P1_PEAK_RTOL}); {CARD}")
    if pred["flops"] != int(fc.get_total_flops()) or pred_args != real_args \
            or pred["launches"] != launches:
        fail("(p1) the fake trace's FLOPs, argument bytes or launches differ from the step's")
    if not math.isfinite(loss) or abs(gap) > P1_PEAK_RTOL:
        fail(f"(p1) the predicted peak is {gap:+.4f} of the measured one")
    del params, opt, batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(counts=counts, flops=pred["flops"], args=pred_args, pred_peak=pred_peak,
                real_peak=real_peak, gap=gap, trace_s=trace_s, wall=wall)


def dryrun_phase(dev):
    """(p): (p1), then (p2) the ``P2_CELLS`` at their production meshes
    traced on fake tensors of the card's own build (``launch/dryrun``):
    each cell's counted peak against the card's 80 GB, FLOPs, collective
    bytes a chip and dominant term."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    p1 = p1_check(dev)
    cells = {}
    for arch, shape, multi in P2_CELLS:
        rec = dryrun.run_cell(arch, shape, multi, out_dir=None)
        if not rec["ok"] or rec["fake_device"] != dev.type:
            fail(f"(p2) {arch} {shape} was not traced on fake {dev.type} tensors")
        colls = sum(rec["collectives_per_chip"].values())
        print(f"(p2) {arch} x {shape} x {rec['mesh']}, counted on a fake trace "
              f"({rec['trace_s']} s): peak {rec['memory']['peak_bytes_per_device'] / 1e9:.2f} GB"
              f" a device against the card's 80 GB (fits {rec['fits']}), "
              f"{rec['cost']['flops_per_chip']:.4e} FLOPs and {colls:,} collective bytes a "
              f"chip, dominant {rec['roofline']['dominant']}, launches {rec['launches']}"
              f"{', compressed' if rec.get('compressed') else ''}; {CARD}")
        cells[f"{arch}|{shape}|{rec['mesh']}"] = {k: rec[k] for k in (
            "memory", "cost", "collectives_per_chip", "roofline", "launches", "fits",
            "trace_s")}
    wall = time.perf_counter() - t0
    print(f"(p) phase wall {wall:.1f} s")
    return dict(counts=p1.pop("counts"), p1=p1, cells=cells, wall=wall)


# ---------------------------------------------------------------------------
# (q) the six examples on the card (``--phase examples``; in the whole
# smoke, in the main process beside (m) and (n))
# ---------------------------------------------------------------------------

Q_KERNELS = {   # example: the kernels its run launches on the card
    "quickstart": ("posit_quantize", "posit_dequantize", "posit_ew"),
    "posit_convolution": ("posit_quantize", "posit_dequantize", "posit_dot", "posit_ew"),
    # the one-shot engine's posit16 cache: quantize at prefill, the fused
    # write and the cache's dequantize at each decode step; the paged half
    # takes the engine's default decode kernel, gather, as the reference's
    "serve_posit_kv": ("posit_quantize", "posit_dequantize", "posit_paged_write"),
    "gradient_compression": ("posit_quantize", "posit_dequantize"),
    "train_lm": ("posit_quantize", "posit_dequantize"),
    # f32 moments and checkpoint: no posit kernel, as in the reference
    "elastic_restart": (),
}


# the whole smoke runs these in a process of their own (``--phase
# examples-train``) beside (j), (T2), (l) and (o)
Q_CHILD = ("train_lm",)


def examples_phase(dev, names=None):
    """(q): each example of ``names``, its ``run("cuda")`` at the
    reference's settings, its self-check (``check``) held and its kernels
    (``Q_KERNELS``) launched on the card; elastic_restart's two ranks are
    this process's children (gloo, sharing the card).  ``names``: all six
    by default.  Returns the launches and walls."""
    import importlib

    names = tuple(Q_KERNELS) if names is None else names
    counts, walls = {}, {}
    t_phase = time.perf_counter()
    for name in names:
        kernels = Q_KERNELS[name]
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = mod.run(str(dev))
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        got = read_counts()
        try:
            mod.check(res)
        except AssertionError as e:
            fail(f"(q) {name}: the example's self-check failed: {e}")
        missing = [k for k in kernels if got[k] <= 0]
        if missing:
            fail(f"(q) {name}: {missing} not launched on the card ({got})")
        counts[name] = got
        print(f"(q) {name}: self-check held in {walls[name]:.1f} s; launches "
              f"{ {k: v for k, v in got.items() if v} }; {CARD}", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"(q) phase wall {wall:.1f} s ({', '.join(names)})")
    total = {k: sum(c[k] for c in counts.values()) for k in read_counts()}
    return dict(counts=total, by_example=counts, walls=walls, wall=wall)


PHASES = {"train": train_phase, "train-families": train_families_phase, "tp": tp_phase,
          "tp-linear": tp_linear_phase, "train-ranks": train_ranks_phase,
          "train-model": train_model_phase, "train-seq": train_seq_phase, "cp": cp_phase,
          "pod-fsdp": pod_fsdp_phase, "dryrun": dryrun_phase, "examples": examples_phase,
          "examples-train": lambda dev: examples_phase(dev, Q_CHILD)}


def run_phase(name):
    """The body of a ``--phase`` child: the card line, the kernels built
    (the parent built them), the phase; its result on the tagged line."""
    global CARD, INT_OPS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    CARD = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi failed"
    from repro_torch.kernels import _build
    _build.build_all()
    result = PHASES[name](torch.device("cuda"))
    print(PHASE_TAG + json.dumps(result), flush=True)


# ---------------------------------------------------------------------------
# The PVU ISA: kernel checks (P1), the paper's conv workload (P2), a
# posit-exact linear at phi3 width (P3), cache maintenance (P4), times (P5)
# ---------------------------------------------------------------------------

def _pats(cfg, shape, seed, dev):
    """Seeded random patterns (any bits, NaR and zero included)."""
    from repro_torch.core.types import to_storage
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** cfg.nbits, size=shape, dtype=np.uint64)
    return to_storage(torch.from_numpy(x.astype(np.int64)), cfg.storage_dtype).to(dev)


def _edges(cfg):
    """Zero, NaR, +-minpos and +-maxpos."""
    return [0, cfg.nar_pattern, 1, cfg.mask, cfg.maxpos_pattern,
            (-cfg.maxpos_pattern) & cfg.mask]


def _same(got, want):
    from repro_torch.core.types import signed_view
    return torch.equal(signed_view(got), signed_view(want))


def _host(t):
    """Pattern tensor -> numpy int64 of its low bits."""
    from repro_torch.core.types import signed_view
    bits = 8 * t.element_size()
    return signed_view(t).cpu().to(torch.int64).numpy() & ((1 << bits) - 1)


def _all_pairs8():
    p = np.arange(256)
    a, b = np.meshgrid(p, p, indexing="ij")
    return a.ravel(), b.ravel()


def _golden_chunk(job):
    """Golden-model answers for one chunk of pairs or dot windows (runs in
    a worker process: pure Python Fraction arithmetic)."""
    from repro_torch.core import softposit_ref as G
    from repro_torch.core.types import PositConfig
    kind, nbits, es, xs, ys = job
    cfg = PositConfig(nbits, es)
    if kind == "dot":
        return [G.dot(x, y, cfg) for x, y in zip(xs, ys)]
    out = {name: [fn(int(x), int(y), cfg) for x, y in zip(xs, ys)]
           for name, fn in (("add", G.add), ("sub", G.sub), ("mul", G.mul),
                            ("div", G.div))}
    out["dot"] = [G.dot([int(x)], [int(y)], cfg) for x, y in zip(xs, ys)]
    return out


def golden_async(pool, kind, cfg, xs, ys, n_chunks=64):
    step = -(-len(xs) // n_chunks)
    jobs = [(kind, cfg.nbits, cfg.es, xs[i:i + step], ys[i:i + step])
            for i in range(0, len(xs), step)]
    return pool.map_async(_golden_chunk, jobs)


def golden_result(handle, kind):
    parts = handle.get(timeout=900)
    if kind == "dot":
        return np.array([v for p in parts for v in p], np.int64)
    return {k: np.array([v for p in parts for v in p[k]], np.int64)
            for k in parts[0]}


def check_isa_kernels(dev):
    """P1: every ISA kernel against its plain version on the card, and the
    codec at posit32 and the es variants; returns the gemm case's error."""
    from repro_torch.core.types import CONFIGS, POSIT16, POSIT32, signed_view, to_storage
    from repro_torch.kernels import posit_codec as C
    from repro_torch.kernels import posit_dot as D
    from repro_torch.kernels import posit_ew as E
    from repro_torch.kernels import posit_gemm as G
    from repro_torch.kernels import posit_qgemm as Q

    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                         1.1754942e-38, 3.4028235e38, 1.0, -1.0, 0.02], np.float32)
    x = torch.from_numpy(np.concatenate([bits.view(np.float32), specials])).to(dev)
    for cfg in CONFIGS:
        if not _same(C.quantize(x, cfg), C.quantize_plain(x, cfg)):
            fail(f"posit_quantize {cfg.name} not bit-exact")
        p = np.random.default_rng(11).integers(0, 2**32, 1 << 20) \
            if cfg.nbits == 32 else np.arange(1 << cfg.nbits)
        p = to_storage(torch.from_numpy(np.concatenate([p, _edges(cfg)])),
                       cfg.storage_dtype).to(dev)
        got, want = C.dequantize(p, cfg), C.dequantize_plain(p, cfg)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"posit_dequantize {cfg.name} not bit-exact")
    print(f"codec at {', '.join(c.name for c in CONFIGS)}: encode "
          f"{x.numel()} f32 values and decode 2^20 posit32 patterns (every "
          f"pattern of the narrower configs) bit-exact")

    for cfg in CONFIGS:
        if cfg.nbits == 8:
            a, b = (torch.from_numpy(v).to(dev).to(torch.uint8) for v in _all_pairs8())
        else:
            a, b = _pats(cfg, EW_BLOCK, 12, dev), _pats(cfg, EW_BLOCK, 13, dev)
            e = torch.tensor(_edges(cfg), dtype=torch.int64)
            ea, eb = torch.meshgrid(e, e, indexing="ij")
            signed_view(a).view(-1)[:36] = signed_view(to_storage(ea.reshape(-1), cfg.storage_dtype)).to(dev)
            signed_view(b).view(-1)[:36] = signed_view(to_storage(eb.reshape(-1), cfg.storage_dtype)).to(dev)
        # full operands, then a scalar and a suffix row on either side (the
        # kernel's other operand modes), the row from an odd element offset
        a2, b2 = a.reshape(-1, 256), b.reshape(-1, 256)
        s, row = b2[1, 7:8], b2[2, 1:]
        cases = ((a, b), (s, a2), (a2, s), (row, a2[:, 1:]), (a2[:, 1:], row))
        for op, mode in EW_OPS:
            for x, y in cases:
                if not _same(E.elementwise(x, y, cfg, op, mode),
                             E.elementwise_plain(x, y, cfg, op, mode)):
                    fail(f"posit_ew {op} {mode} {cfg.name} differs from plain "
                         f"at operands {tuple(x.shape)}, {tuple(y.shape)}")
        print(f"posit_ew {cfg.name}: add, sub, mul, div nr3, div exact on "
              f"{a.numel()} pairs (edge patterns crossed), and with a scalar and "
              f"a 255-pattern row on either side: equal to plain")

    for cfg in (POSIT16, POSIT32):
        for length in DOT_LENGTHS:
            a, b = _pats(cfg, (32, length), length, dev), _pats(cfg, (32, length), length + 1, dev)
            if not _same(D.vpdot_rows(a, b, cfg), D.vpdot_rows_plain(a, b, cfg)):
                fail(f"posit_dot {cfg.name} L={length} differs from plain")
        for m, k, n in PGEMM_SHAPES:
            a, w = _pats(cfg, (m, k), m, dev), _pats(cfg, (k, n), n, dev)
            if not _same(Q.posit_qgemm(a, w, cfg), Q.posit_qgemm_plain(a, w, cfg)):
                fail(f"posit_qgemm {cfg.name} {(m, k, n)} differs from plain")
    print(f"posit_dot posit16/posit32 at L in {DOT_LENGTHS}, posit_qgemm at "
          f"{PGEMM_SHAPES}: equal to plain")

    # (128, 5120) f32 @ (5120, 17920) posit16: f32 sums in another order
    # than the plain version's, so each output may differ by the
    # forward-error bound of both orders, 2 K 2^-24 sum_k |a_ik w_kj|
    gen = torch.Generator(device=dev).manual_seed(14)
    m, k, n = GEMM_SHAPE
    a = torch.randn((m, k), generator=gen, device=dev)
    w = C.quantize(torch.randn((k, n), generator=gen, device=dev) * k ** -0.5,
                   POSIT16)
    got, want = G.posit_gemm(a, w, POSIT16), G.posit_gemm_plain(a, w, POSIT16)
    wd = C.dequantize(w, POSIT16)
    bound = 2 * k * 2.0 ** -24 * (a.abs().double() @ wd.abs().double())
    err = (got.double() - want.double()).abs()
    print(f"posit_gemm ({m}, {k}) @ ({k}, {n}) posit16: max abs err "
          f"{float(err.max()):.3e} vs plain, worst share of the f32 "
          f"order bound 2K*2^-24*sum|a||w|: {float((err / bound).max()):.3f}")
    if not bool((err <= bound).all()):
        fail("posit_gemm differs from plain beyond the f32 summation bound")
    again = G.posit_gemm(a, w, POSIT16)
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    print(f"posit_gemm two calls bit-identical: {same}")
    if not same:
        fail("posit_gemm gave different bits on two calls")
    return dict(a=a, w=w, err=float(err.max()))


def _im2col(x, k, stride):
    """(B, C, H, W) -> (B * OH * OW, C * k * k), column order (c, kh, kw)."""
    cols = x.unfold(2, k, stride).unfold(3, k, stride)      # B,C,OH,OW,k,k
    return cols.permute(0, 2, 3, 1, 4, 5).reshape(-1, x.shape[1] * k * k)


def conv_workload(dev, pool):
    """P2: the paper's verification workload at its config's full size,
    8 images, posit32 (``configs/pvu_resnet_conv.py``; the int8-style
    data recipe of ``benchmarks/bench_accuracy.py``)."""
    from repro_torch.configs.pvu_resnet_conv import CONFIG as cw
    from repro_torch.core.types import POSIT32, signed_view
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_ew as E
    from repro_torch.kernels import posit_qgemm as Q

    cfg, n_img = POSIT32, CONV_IMAGES
    rng = np.random.default_rng(0)
    acts = rng.integers(0, 128, (n_img, cw.in_channels, cw.image, cw.image)) * cw.quant_scale
    wts = rng.integers(-127, 128, (cw.out_channels, cw.in_channels, cw.kernel, cw.kernel)) * 0.005
    wts[wts == 0] = 0.005
    bias = rng.integers(-127, 128, cw.out_channels) * 0.005
    x = torch.from_numpy(acts.astype(np.float32)).to(dev)
    wf = torch.from_numpy(wts.astype(np.float32)).to(dev)
    bf = torch.from_numpy(bias.astype(np.float32)).to(dev)
    kk = cw.in_channels * cw.kernel * cw.kernel

    reset_counts()
    t0 = time.perf_counter()
    xq, wq, bq = ops.quantize(x, cfg), ops.quantize(wf, cfg), ops.quantize(bf, cfg)
    a = _im2col(signed_view(xq), cw.kernel, cw.stride).contiguous().view(cfg.storage_dtype)
    w = signed_view(wq).reshape(cw.out_channels, kk).T.contiguous().view(cfg.storage_dtype)
    y = ops.pgemm(a, w, cfg)                                   # (M, 64)
    yb = ops.vadd(y, bq, cfg)                                  # bias per channel
    af = _im2col(x, cw.kernel, cw.stride).contiguous()
    yf = ops.gemm(af, w, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = a.shape[0]
    print(f"conv workload: {n_img} x {cw.in_channels} x {cw.image}^2 -> "
          f"{cw.out_channels} channels, {cw.kernel}x{cw.kernel} stride "
          f"{cw.stride}: im2col ({m}, {kk}) @ ({kk}, {cw.out_channels}) = "
          f"{m * kk * cw.out_channels:,} quire products in posit32; quantize, "
          f"pgemm, bias vadd and the f32 gemm took {wall:.3f} s")

    # pgemm == dot on every output, windows in chunks of rows
    wt = signed_view(w).T.contiguous().view(cfg.storage_dtype)  # (64, K)
    for i in range(0, m, 8192):
        d = ops.dot(a[i:i + 8192, None, :], wt[None], cfg)
        if not _same(d, y[i:i + 8192]):
            fail(f"pgemm != dot on conv rows {i}..{i + 8192}")
    print(f"pgemm == dot over the same windows on all {m * cw.out_channels:,} outputs")
    if not _same(yb, E.elementwise_plain(y, bq, cfg, "add")):
        fail("conv bias vadd differs from plain")
    # the f32 path agrees with the posit one within the f32 sums' bound
    # plus the posit32 rounding of the quire result (the operands are
    # exact in both)
    yd = ops.dequantize(y, cfg).double()
    mag = af.double().abs() @ ops.dequantize(w, cfg).double().abs()
    tol = kk * 2.0 ** -24 * mag + 2.0 ** -26 * yd.abs()
    if not bool(((yf.double() - yd).abs() <= tol).all()):
        fail("f32 gemm conv and posit32 pgemm conv disagree beyond their rounding")
    print(f"f32 gemm conv vs posit32 pgemm conv: max abs diff "
          f"{float((yf.double() - yd).abs().max()):.3e} (inside the rounding bound)")

    # the per-op table: 2000 seeded (activation, weight) pairs and 2000
    # seeded windows of the conv, through the kernels, against the golden
    srng = np.random.default_rng(42)
    i = torch.from_numpy(srng.integers(0, m, 2000)).to(dev)
    k = torch.from_numpy(srng.integers(0, kk, 2000)).to(dev)
    j = torch.from_numpy(srng.integers(0, cw.out_channels, 2000)).to(dev)
    pa = signed_view(a)[i, k].view(cfg.storage_dtype)
    pb = signed_view(w)[k, j].view(cfg.storage_dtype)
    got = {op if op != "div" else f"div_{mode}":
           _host(getattr(ops, {"add": "vadd", "sub": "vsub", "mul": "vmul",
                               "div": "vdiv"}[op])(pa, pb, cfg,
                                                   **({"mode": mode} if op == "div" else {})))
           for op, mode in EW_OPS}
    wi, wj = srng.integers(0, m, 2000), srng.integers(0, cw.out_channels, 2000)
    win_a = _host(signed_view(a)[torch.from_numpy(wi).to(dev)].view(cfg.storage_dtype))
    win_b = _host(signed_view(wt)[torch.from_numpy(wj).to(dev)].view(cfg.storage_dtype))
    got["dot"] = _host(signed_view(y)[torch.from_numpy(wi).to(dev),
                                      torch.from_numpy(wj).to(dev)].view(cfg.storage_dtype))
    golden = (golden_async(pool, "ew", cfg, _host(pa).tolist(), _host(pb).tolist()),
              golden_async(pool, "dot", cfg, win_a.tolist(), win_b.tolist()))
    counts = read_counts()

    # kernel == plain on the whole conv (chunked lattice), timed once
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    yp = Q.posit_qgemm_plain(a, w, cfg, max_entries=1 << 24)
    ev1.record()
    ev1.synchronize()
    if not _same(y, yp):
        fail("posit_qgemm differs from its plain version on the conv")
    print(f"posit_qgemm == plain on all {m * cw.out_channels:,} conv outputs")
    return dict(counts=counts, a=a, w=w, wt=wt, y=y, bq=bq, af=af, cfg=cfg, golden=golden,
                got=got, plain_ms=ev0.elapsed_time(ev1))


def accuracy_table(conv, golden8, got8):
    """The paper's per-op exact-match table on the conv data and on every
    posit8 pair, against the golden model; fails below the paper."""
    ew, dots = (golden_result(conv["golden"][0], "ew"),
                golden_result(conv["golden"][1], "dot"))
    want_conv = {"add": ew["add"], "sub": ew["sub"], "mul": ew["mul"],
                 "div_nr3": ew["div"], "div_exact": ew["div"], "dot": dots}
    g8 = golden_result(golden8, "ew")
    want8 = {"add": g8["add"], "sub": g8["sub"], "mul": g8["mul"],
             "div_nr3": g8["div"], "div_exact": g8["div"], "dot": g8["dot"]}
    table = {}
    for data, got, want in (("conv posit32", conv["got"], want_conv),
                            ("all posit8 pairs", got8, want8)):
        for op in ("add", "sub", "mul", "div_nr3", "div_exact", "dot"):
            rate = float((got[op] == want[op]).mean())
            table[f"{data} {op}"] = rate
            print(f"accuracy {data} {op}: {100 * rate:.2f} % exact "
                  f"({int((got[op] == want[op]).sum())}/{want[op].size})")
            need = PAPER_DIV_ACC if op == "div_nr3" else 1.0
            if rate < need:
                fail(f"{data} {op} exact-match {rate:.4f} below {need}")
    return table


def posit8_through_kernels(dev):
    """Every posit8 pair through the kernels (the five ops and dot as a
    length-1 reduction)."""
    from repro_torch.core.types import POSIT8
    from repro_torch.kernels import ops
    a, b = (torch.from_numpy(v).to(dev).to(torch.uint8) for v in _all_pairs8())
    got = {"add": ops.vadd(a, b, POSIT8), "sub": ops.vsub(a, b, POSIT8),
           "mul": ops.vmul(a, b, POSIT8),
           "div_nr3": ops.vdiv(a, b, POSIT8, mode="nr3"),
           "div_exact": ops.vdiv(a, b, POSIT8, mode="exact"),
           "dot": ops.dot(a[:, None], b[:, None], POSIT8)}
    return {k: _host(v) for k, v in got.items()}


def posit_exact_linear(dev):
    """P3: ``layers.dense`` with ``posit_exact_linear`` at phi3-medium-14b
    width, the MLP down projection on one prefill chunk: 16 tokens x
    17 920 -> 5 120 in posit16 (K = 4 x 4096 + 1536: five quire tiles, the
    last ragged), with bias."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.types import POSIT16
    from repro_torch.kernels import ops
    from repro_torch.kernels import posit_codec as C
    from repro_torch.kernels import posit_ew as E
    from repro_torch.kernels import posit_qgemm as Q
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(configs.get_config("phi3-medium-14b"),
                              posit_exact_linear=True, weight_posit="posit16",
                              compute_dtype="float32")
    d_in, d_out = cfg.d_ff, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(7)
    w = torch.randn((d_in, d_out), generator=gen, device=dev) * d_in ** -0.5
    b = torch.randn((d_out,), generator=gen, device=dev) * 0.02
    x = torch.randn((16, d_in), generator=gen, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    y = L.dense({"w": w, "b": b}, x, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    # the plain chain (quantize, pgemm, vadd, dequantize) on 64 seeded
    # output columns must give the same f32 bits
    cols = torch.from_numpy(np.random.default_rng(7).choice(d_out, 64, replace=False)).to(dev)
    xq = C.quantize_plain(x, POSIT16)
    yq = Q.posit_qgemm_plain(xq, C.quantize_plain(w[:, cols].contiguous(), POSIT16),
                             POSIT16, max_entries=1 << 24)
    yq = E.elementwise_plain(yq, C.quantize_plain(b[cols], POSIT16), POSIT16, "add")
    ref = C.dequantize_plain(yq, POSIT16)
    if not torch.equal(y[:, cols].contiguous().view(torch.int32), ref.view(torch.int32)):
        fail("posit-exact dense differs from the plain chain on the checked columns")
    wq = ops.quantize(w, POSIT16)
    xq = ops.quantize(x, POSIT16)
    m, n = xq.shape[0], wq.shape[1]
    p3 = dict(ms=time_ms(lambda: ops.pgemm(xq, wq, POSIT16), iters=5, warmup=1),
              kernel_ms=kernel_alone_ms(Q.posit_qgemm_call(xq, wq, POSIT16)[0], n=20),
              **_bound((m * d_in + d_in * n + m * n) * 2,
                       m * d_in * n * OPS_QUIRE + (m * d_in + d_in * n) * OPS_DECODE
                       + m * n * OPS_ENCODE, INT_OPS),
              shape=[m, d_in, n])
    print(f"posit-exact dense 16 x {d_in} -> {d_out} (posit16, phi3-medium-14b "
          f"MLP down): {wall:.3f} s with quantize and build; equal to the plain "
          f"chain on 64 seeded columns; pgemm {p3['ms']:.3f} ms, kernel alone "
          f"{p3['kernel_ms']:.3f} ms for {m * d_in * n:,} quire products (bound "
          f"{p3['bound_ms']:.4f} ms by {p3['bound_by']})")
    return dict(counts=counts, p3=p3)


def cache_maintenance(cache):
    """P4: ``scale_cache`` and ``merge_caches`` on the arena the phi3 path
    served from; block tables and lengths come back unchanged, and the
    posit_ew output equals the plain version on layer 0 (in chunks).
    Returns the phase's counts and the ew timing row."""
    from repro_torch.compress import kvcache as kvc
    from repro_torch.core.types import POSIT16, signed_view
    from repro_torch.compress.gradient import scalar_pattern
    from repro_torch.kernels import posit_ew as E

    keys = kvc.arena_leaves(cache)
    n = sum(cache[k].numel() for k in keys)
    tables, lens = cache["block_tables"].clone(), cache["lens"].clone()
    reset_counts()
    t0 = time.perf_counter()
    scaled = kvc.scale_cache(cache, 0.5, "posit16")
    merged = kvc.merge_caches(cache, scaled, "posit16", weight_a=0.25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for out in (scaled, merged):
        if not (torch.equal(out["block_tables"], tables) and torch.equal(out["lens"], lens)):
            fail("cache maintenance changed the block tables or lengths")
    dev = cache[keys[0]].device
    half = scalar_pattern(0.5, POSIT16, dev)
    wa, wb = scalar_pattern(0.25, POSIT16, dev), scalar_pattern(0.75, POSIT16, dev)
    a0, s0, m0 = (signed_view(t[keys[0]][0]).reshape(-1).view(POSIT16.storage_dtype)
                  for t in (cache, scaled, merged))
    step = 1 << 21
    for i in range(0, a0.numel(), step):
        a, sc = a0[i:i + step], s0[i:i + step]
        if not _same(sc, E.elementwise_plain(a, half, POSIT16, "mul")):
            fail(f"scale_cache layer 0 differs from plain at {i}")
        want = E.elementwise_plain(E.elementwise_plain(a, wa, POSIT16, "mul"),
                                   E.elementwise_plain(sc, wb, POSIT16, "mul"),
                                   POSIT16, "add")
        if not _same(m0[i:i + step], want):
            fail(f"merge_caches layer 0 differs from plain at {i}")
    leaf = cache[keys[0]]
    x0, x1 = leaf[0], leaf[1]
    # the ew timing row: vmul by a scalar on layer 0 of the leaf, and
    # beside it the whole leaf and an exact division of two layers
    row = dict(
        name="posit_ew", route="cuda", source="src/repro_torch/csrc/posit_ew.cu",
        replaces="src/repro/kernels/posit_ew.py:81", launches=0, max_abs_err=0.0,
        **ew_times(x0, half, POSIT16, "mul"),
        plain_ms=time_ms(lambda: E.elementwise_plain(x0, half, POSIT16, "mul"), iters=3),
        library_ms=None,
        leaf=ew_times(leaf, half, POSIT16, "mul", iters=5, n=10),
        vdiv_exact=ew_times(x0, x1, POSIT16, "div", "exact", n=20))
    if not _same(E.elementwise(x0, x1, POSIT16, "div", "exact")[:64],
                 E.elementwise_plain(x0[:64], x1[:64], POSIT16, "div", "exact")):
        fail("vdiv exact on arena layers differs from plain")
    print(f"cache maintenance on the served phi3 arena ({len(keys)} leaves, "
          f"{n:,} posit16 patterns): scale_cache + merge_caches {wall:.3f} s; "
          f"tables and lens unchanged; layer 0 equal to plain; one vmul over "
          f"a whole leaf ({leaf.numel():,} patterns) {row['leaf']['ms']:.3f} ms, "
          f"kernel alone {row['leaf']['kernel_ms']:.4f} ms (bound "
          f"{row['leaf']['bound_ms']:.4f} ms by {row['leaf']['bound_by']})")
    return dict(counts=counts, row=row)


def ew_times(a, b, cfg, op, div_mode="nr3", iters=20, n=100):
    """A posit_ew call's wrapper time, kernel-alone time and bound (each
    full operand read once, the output written once; the fewest
    operations of the op's datapath on every element)."""
    from repro_torch.kernels import posit_ew as E

    call, out = E.elementwise_call(a, b, cfg, op, div_mode)
    m, nbytes = out.numel(), out.element_size()
    return dict(ms=time_ms(lambda: E.elementwise(a, b, cfg, op, div_mode), iters=iters),
                kernel_ms=kernel_alone_ms(call, n=n),
                **_bound((a.numel() + b.numel() + m) * nbytes,
                         m * (2 * OPS_DECODE + OPS_EW[(op, div_mode)] + OPS_ENCODE), INT_OPS),
                shape=list(out.shape), operands=[list(a.shape), list(b.shape)])


def int_issue_rate():
    """SMs x 128 lanes x the maximum SM clock (``nvidia-smi``), and the
    line that states it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60)
    try:
        mhz = float(res.stdout.strip().splitlines()[0])
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no maximum SM clock: {res.stdout!r} {res.stderr!r}")
    rate = sms * 128 * mhz * 1e6
    return rate, (f"integer issue rate: {sms} SMs x 128 lanes x {mhz:g} MHz = "
                  f"{rate:.4e} instructions/s")


def _bound(nbytes, ops, rate):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations")


def time_isa(dev, p1, conv):
    """P5: kernel, plain and library times of dot, pgemm and gemm at the
    conv workload's shapes (gemm also at the P1 check's), with their
    bounds."""
    from repro_torch.core.types import POSIT16, signed_view
    from repro_torch.kernels import posit_codec as C
    from repro_torch.kernels import posit_dot as D
    from repro_torch.kernels import posit_gemm as G
    from repro_torch.kernels import posit_qgemm as Q

    cfg, a, w, wt = conv["cfg"], conv["a"], conv["w"], conv["wt"]
    m, kk = a.shape
    n = w.shape[1]
    rows = []
    # dot: the cross-check's windows of 1024 conv rows (65 536 dots of 147)
    r = min(1024, m)
    sa = signed_view(a[:r, None, :]).expand(r, n, kk).reshape(-1, kk)
    sb = signed_view(wt[None]).expand(r, n, kk).reshape(-1, kk)
    da, db = sa.contiguous().view(cfg.storage_dtype), sb.contiguous().view(cfg.storage_dtype)
    nd = da.shape[0]
    rows.append(dict(
        name="posit_dot", route="cuda", source="src/repro_torch/csrc/posit_dot.cu",
        replaces="src/repro/kernels/posit_dot.py:109", launches=0, max_abs_err=0.0,
        ms=time_ms(lambda: D.vpdot_rows(da, db, cfg)),
        kernel_ms=kernel_alone_ms(D.vpdot_rows_call(da, db, cfg)[0]),
        plain_ms=time_ms(lambda: D.vpdot_rows_plain(da, db, cfg, max_entries=1 << 24), iters=3),
        **_bound(nd * kk * 4 * 2 + nd * 4,
                 nd * kk * (2 * OPS_DECODE + OPS_QUIRE) + nd * OPS_ENCODE, INT_OPS),
        library_ms=None, shape=[nd, kk]))
    # pgemm: the whole conv
    rows.append(dict(
        name="posit_qgemm", route="cuda", source="src/repro_torch/csrc/posit_qgemm.cu",
        replaces="src/repro/kernels/posit_qgemm.py:105", launches=0, max_abs_err=0.0,
        ms=time_ms(lambda: Q.posit_qgemm(a, w, cfg), iters=5, warmup=1),
        kernel_ms=kernel_alone_ms(Q.posit_qgemm_call(a, w, cfg)[0], n=20),
        plain_ms=conv["plain_ms"],
        **_bound((m * kk + kk * n + m * n) * 4,
                 m * kk * n * OPS_QUIRE + (m * kk + kk * n) * OPS_DECODE + m * n * OPS_ENCODE,
                 INT_OPS),
        library_ms=None, shape=[m, kk, n]))
    # gemm: where the workload ran it (the conv's f32 path, posit32
    # weights), and at the check's phi3 MLP shape; the library call is
    # one fp32 matmul on the decoded weights (TF32 off)
    def gemm_times(ga, gw, gcfg):
        wd = C.dequantize(gw, gcfg)
        gm, gk = ga.shape
        gn = gw.shape[1]
        res = torch.empty((gm, gn), dtype=torch.float32, device=ga.device)
        return dict(
            ms=time_ms(lambda: G.posit_gemm(ga, gw, gcfg), iters=10),
            kernel_ms=kernel_alone_ms(G.posit_gemm_call(ga, gw, gcfg)[0]),
            plain_ms=time_ms(lambda: G.posit_gemm_plain(ga, gw, gcfg), iters=5),
            **_bound(gm * gk * 4 + gk * gn * gw.element_size() + gm * gn * 4,
                     2 * gm * gn * gk, FP32_FLOPS),
            library_ms=time_ms(lambda: torch.matmul(ga, wd), iters=10),
            library_alone_ms=kernel_alone_ms(
                lambda: (torch.matmul(ga, wd, out=res), 0)[1]),
            shape=[gm, gk, gn])

    af = conv["af"]
    diff = (G.posit_gemm(af, w, cfg).double() - G.posit_gemm_plain(af, w, cfg).double()).abs()
    if not bool((diff <= 2 * kk * 2.0 ** -24 * (af.double().abs() @ C.dequantize(
            w, cfg).double().abs())).all()):
        fail("posit_gemm differs from plain on the conv beyond the f32 summation bound")
    err = float(diff.max())
    mlp = dict(gemm_times(p1["a"], p1["w"], POSIT16), max_abs_err=p1["err"])
    print(f"posit_gemm at the phi3 MLP shape {mlp['shape']} posit16: "
          f"{mlp['ms']:.4f} ms, kernel alone {mlp['kernel_ms']:.4f} ms "
          f"(bound {mlp['bound_ms']:.4f} ms by {mlp['bound_by']}, plain {mlp['plain_ms']:.4f} ms, library "
          f"{mlp['library_ms']:.4f} ms, library alone {mlp['library_alone_ms']:.4f} ms)")
    rows.append(dict(
        name="posit_gemm", route="cuda", source="src/repro_torch/csrc/posit_gemm.cu",
        replaces="src/repro/kernels/posit_gemm.py:53", launches=0, max_abs_err=err,
        **gemm_times(af, w, cfg), mlp_down=mlp))
    return rows


def ptxas_report():
    """Registers, shared memory and spills of the redesigned kernels:
    one ``nvcc -Xptxas -v`` compile of each source, with the build's
    flags."""
    import tempfile

    from repro_torch.kernels import _build
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("paged_attn", "paged_attn_mla", "posit_gemm", "posit_paged_write",
                    "posit_paged_read", "posit_qgemm", "posit_ew", "posit_dot", "posit_codec"):
            res = subprocess.run(
                [_build.nvcc_path(), *flags, "-Xptxas", "-v", "-c", "-I", str(_build.CSRC),
                 "-o", os.path.join(tmp, f"{src}.o"), str(_build.CSRC / f"{src}.cu")],
                capture_output=True, text=True, timeout=600)
            print(f"ptxas {src}.cu (rc {res.returncode}):")
            for line in (res.stdout + res.stderr).splitlines():
                if any(w in line for w in ("Compiling entry", "registers", "spill", "error")):
                    print("   ", line.strip())
            if res.returncode != 0:
                fail(f"nvcc -Xptxas -v failed on {src}.cu")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    if sys.argv[1:] == ["--ptxas"]:
        # resource report only: no checks of the main path
        ptxas_report()
        return
    if sys.argv[1:2] == ["--phase"]:
        # a child of the smoke: one phase in a process of its own
        run_phase(sys.argv[2])
        return
    # the golden model is pure Python: its answers are computed on the
    # host's cores, in worker processes, while the card works
    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        run(pool)


def run(pool):
    from repro_torch.core.types import POSIT8
    golden8 = golden_async(pool, "ew", POSIT8, *(v.tolist() for v in _all_pairs8()))
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    global CARD, INT_OPS
    CARD = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(CARD)
    INT_OPS, rate_line = int_issue_rate()
    print(rate_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(_build.SOURCES)})")
    # (p) the dry run, in a process of its own beside the kernel checks, the
    # ISA phases and the main paths: (p1)'s real step holds some 29 GB for
    # a few seconds, (p2) traces on the host's cores alone
    dry_handle = start_phase_process("dryrun")

    check_codec(dev)
    rows = time_codec(dev)
    rows.append(check_attention(dev))
    rows.append(check_attention_mla(dev))
    write_row, profile_write = check_paged_write(dev)
    write_row["linear_decode"] = check_linear_write(dev)
    rows.append(write_row)
    gc.collect()
    torch.cuda.empty_cache()
    rows.append(check_paged_read(dev))
    gc.collect()
    torch.cuda.empty_cache()

    # the PVU ISA: P1 kernel checks, P2 the paper's conv, P3 the
    # posit-exact linear at phi3 width
    t_isa = time.perf_counter()
    p1 = check_isa_kernels(dev)
    conv = conv_workload(dev, pool)
    by_path = {"conv": conv["counts"]}
    got8 = posit8_through_kernels(dev)
    rows += time_isa(dev, p1, conv)
    # the conv's bias vadd, (95 048, 64) + (64,): a row operand
    ew_bias = ew_times(conv["y"], conv["bq"], conv["cfg"], "add")
    del p1
    p3 = posit_exact_linear(dev)
    by_path["dense"] = p3["counts"]
    next(r for r in rows if r["name"] == "posit_qgemm")["p3"] = p3["p3"]
    gc.collect()
    torch.cuda.empty_cache()
    isa_s = time.perf_counter() - t_isa

    ew_row = None
    for name, (argv, kernels) in MAIN_PATHS.items():
        res, counts, wall, steps, chunks = serve_main_path(argv)
        check_served(res)
        report_served(name, res, counts, wall, steps, chunks)
        check_main_counts(name, res, counts, steps, chunks, kernels)
        if res.sched.prefix_cache and (res.sched.prefix_hits <= 0
                                       or res.sched.n_preempted <= 0):
            fail(f"the {name} path had no prefix hit or no preemption")
        if name in FUSED_GATHER_PATHS:
            check_fused_equals_gather_full(name, res.sched.engine)
        by_path[name] = counts
        if name == "phi3-medium-14b":
            # P4: cache maintenance on the arena this path served from
            t_p4 = time.perf_counter()
            p4 = cache_maintenance(res.sched.cache)
            by_path["cache"] = p4["counts"]
            ew_row = p4["row"]
            isa_s += time.perf_counter() - t_p4
        del res
        gc.collect()
        torch.cuda.empty_cache()
    ew_row["bias_vadd"] = ew_bias
    rows.append(ew_row)
    by_path["dryrun_p1"] = finish_phase_process(dry_handle)["counts"]
    # (a) and (c), phi3 at 40 layers, alone on the card; then (k) training
    # across ranks, (o3) included, in a process of its own beside the other
    # linear paths, hymba's ring and the window lane (their walls carry its
    # load; the main process holds 18 GiB at most there, (o3)'s ranks 44)
    by_path.update(run_linear_paths(dev, ALONE_LINEAR))
    ranks_handle = start_phase_process("train-ranks")
    by_path.update(run_linear_paths(dev, [n for n in LINEAR_PATHS if n not in ALONE_LINEAR]))
    check_hymba_ring(dev)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["window"] = run_window_lane(dev)
    ranked = finish_phase_process(ranks_handle)
    profile_write()
    del profile_write
    # (j) tensor-parallel serving, two ranks on the card, in a process of
    # its own as the training phases; beside it (T2) a step of each family
    # (two processes on the one card: their walls carry each other's load;
    # (k) would not fit beside (j), its (o3) holding some 44 GB)
    # (q)'s train_lm (300 host-bound steps) in a process of its own beside
    # (j), (T2), (l) and (o)
    q_handle = start_phase_process("examples-train")
    families_handle = start_phase_process("train-families")
    by_path.update(run_phase_process("tp")["counts"])
    by_path["train_families"] = finish_phase_process(families_handle)["counts"]
    # (l) tensor-parallel serving on linear caches and the other families,
    # beside (o) context-parallel prefill at "model" 4: two processes on
    # the one card, whose ranks already share it over gloo
    cp_handle = start_phase_process("cp")
    by_path.update(run_phase_process("tp-linear")["counts"])
    by_path.update(finish_phase_process(cp_handle)["counts"])
    q_counts = finish_phase_process(q_handle)["counts"]
    # training, each phase in its own process: (T) the main training
    # path alone; (k) training across ranks and (o3) FSDP on the same two
    # ranks (run above), held to (T)
    # beside it, (o4) the pod-compressed step under FSDP (four ranks, some
    # 25 GB together beside (T)'s 29)
    o4_handle = start_phase_process("pod-fsdp")
    trained = run_phase_process("train")
    by_path["train"] = trained["counts"]
    by_path["pod_fsdp"] = finish_phase_process(o4_handle)["counts"]
    check_train_ranks(trained, ranked)
    check_train_ranks(trained, {"k1": ranked["o3"]}, label="(o3)")
    by_path["train_ranks"] = ranked["counts"]
    # (m) hymba, rwkv6 and whisper trained across ranks at "model" > 1,
    # and (n) the sequence layout across ranks, side by side: two
    # processes on the one card, whose ranks already share it over gloo
    # (no wall of theirs is a speed); (n1) held to (T) as (k1) is
    # (q)'s other five examples run in this process meanwhile (their walls
    # carry the two phases' load)
    seq_handle = start_phase_process("train-seq")
    model_handle = start_phase_process("train-model")
    q_rest = examples_phase(dev, tuple(n for n in Q_KERNELS if n not in Q_CHILD))
    by_path["examples"] = {k: v + q_rest["counts"][k] for k, v in q_counts.items()}
    modeled = finish_phase_process(model_handle)
    by_path["train_model"] = modeled["counts"]
    seqd = finish_phase_process(seq_handle)
    n1 = seqd["archs"]["n1"]["ranks"]
    check_train_ranks(trained, {"k1": n1}, label="(n1)")
    print(f"(n1) peak device memory per rank {[round(r['peak_gib'], 2) for r in n1]} GiB "
          f"against (k1)'s {[round(r['peak_gib'], 2) for r in ranked['k1']]} GiB under the "
          f"head layout; 'model' wire a rank over {RANK_STEPS} steps, (n1) "
          f"{sum(v[1] for k, v in n1[0]['wire'].items() if k.startswith('model/')):,} bytes "
          f"against (k1)'s "
          f"{sum(v[1] for k, v in ranked['k1'][0]['wire'].items() if k.startswith('model/')):,}"
          f"; {CARD}")
    by_path["train_seq"] = seqd["counts"]
    for kernel in ("posit_ew", "posit_dot", "posit_qgemm", "posit_gemm"):
        if not any(c[kernel] > 0 for p, c in by_path.items()
                   if p in ("conv", "dense", "cache")):
            fail(f"kernel {kernel} was not launched on the ISA phases")
    print(f"ISA phase launches: " + json.dumps(
        {p: {k: v for k, v in by_path[p].items() if v}
         for p in ("conv", "dense", "cache")}))
    for row in rows:
        if row["name"] in ("posit_quantize", "posit_dequantize"):
            kind = row["name"].split("_")[1]
            row["train"] = {leaf: r[kind] for leaf, r in trained["codec"].items()}
            row["wire"] = {leaf: r[kind] for leaf, r in ranked["codec"].items()}
            row["train_model"] = {leaf: r[kind] for leaf, r in modeled["codec"].items()}
            row["train_seq"] = {leaf: r[kind] for leaf, r in seqd["codec"].items()}
        row["launches_by_path"] = {p: c[row["name"]] for p, c in by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    for row in rows:
        alone = (f", kernel alone {row['kernel_ms']:.4f} ms vs library alone "
                 f"{row['library_alone_ms']:.4f} ms" if "library_alone_ms" in row
                 else f", kernel alone {row['kernel_ms']:.4f} ms" if "kernel_ms" in row
                 else "")
        print(f"{row['name']} at {row['shape']}: {row['ms']:.4f} ms{alone} "
              f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
              f"plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} ms)")
    for name, t in next(r for r in rows if r["name"] == "paged_decode_attention")[
            "arch_shapes"].items():
        print(f"paged_decode_attention at {name}'s shape {t['shape']}: {t['ms']:.4f} ms, "
              f"kernel alone {t['kernel_ms']:.4f} ms vs library alone "
              f"{t['library_alone_ms']:.4f} ms (bound {t['bound_ms']:.5f} ms by "
              f"{t['bound_by']}, plain {t['plain_ms']:.4f} ms)")
    for key in ("leaf", "bias_vadd", "vdiv_exact"):
        r = ew_row[key]
        print(f"posit_ew {key} at {r['shape']}: {r['ms']:.4f} ms, kernel alone "
              f"{r['kernel_ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']})")

    check_fused_equals_gather(dev)
    check_prefix_identity(dev)

    t0 = time.perf_counter()
    accuracy_table(conv, golden8, got8)
    isa_s += time.perf_counter() - t0
    print(f"ISA phases (P1-P5 and the accuracy table) took {isa_s:.1f} s")
    print(f"smoke wall {time.perf_counter() - T_START:.1f} s, the kernels' build included")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
