#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, runs and agrees with its
oracles on the card.

    python3 chip_smoke.py

Phases, one printed line (or block) each; any failure raises and exits
non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build every CUDA source of the port with ``nvcc`` for ``sm_90a``;
3. the synchronization compiler's main path, ``plan → compile("torch",
   device="cuda") → run``, its level loop run eagerly on a case's first
   run and replayed as one captured CUDA graph per prepared case from its
   second (captured then), on the program corpus under every elimination
   method (``deps="inspect"``/``"speculate"`` for the non-affine ones) and
   at the benchmark sizes — Alg. 6 at 1025, the 64×16 chunked recurrence,
   the 96×192 skew that runs the width ladder — every store bit-equal to
   ``run_sequential``; at the benchmark sizes the first runs of fresh
   artifacts with and without the capture policy in turns, the second run
   and the capture's one-time cost in it, and the captured replay and the eager sweep in
   turns (warm ms, device busy and idle share of each); then each
   division-family operator and
   ``**`` with a Python-number operand, every cell checked bit-equal
   (``**`` stays eager by rule, counted as eager sweeps);
3b. the plan service (``PlanService``, four workers) over one mix — the
   reference soak's three structures and the three benchmark sizes: a cold
   epoch of two rounds (each case eager, then captured), then a warm epoch
   of at least ``SERVICE_WARM_S`` seconds and ``SERVICE_MIN_ROUNDS``
   rounds (no capture; requests/s, latency p50 / p99 per tenant and over
   all requests, with their sample counts); then four epochs of one-off
   bounds (no bounds seen twice), with and without the capture policy in
   turns (no capture either way); every store bit-equal, and a planted
   fault (a replay that skips loading its store) read as diverged;
3c. calibration on the card: ``repro_torch.calibrate.measure(device=
   "cuda")`` into a temporary directory (the units, the per-level µs per
   width, the time it took), then a fresh ``warm()`` and a
   ``PlanService(warm_profile=True)`` that reload it with no measurement;
   for the wide 40×96 and 96×192 recurrences and the 64×16 one, the
   unforced auction under the hand-set and the measured units (structural
   key and offer set unchanged) beside each forced strategy's warm
   captured time, in turns, every store bit-equal, and whether the
   measured profile picked the faster one;
3d. ``"torch_spmd"``: (a) in a world-size-1 NCCL group on the card, Alg. 6
   at 1025 and both wide recurrences bit-equal, one shard, no collective,
   the same captures and launch list as ``"torch"`` (device events under
   the profiler printed beside), warm ms beside it in turns; (b) 2 and 4 gloo processes on the host CPU
   running phase 3's small corpus and the 64×16 recurrence, bit-equal on
   every rank, one all-gather per read-bearing group step; (c) the auction
   at a forced 8 devices: the wide recurrence skews, the narrow one
   chunks;
3e. the pipeline runner (``repro_torch.runtime.pipeline.PipelineRunner``,
   one thread a stage) with 4 stages of ``tanh(x @ W)`` at yi-6b's width on
   the card, without and with skips, bit-equal to ``run_reference`` with
   (S-1) x M hand-offs; then the pipeline step
   (``repro_torch.runtime.pp_lowering.build_pipeline_step``, one rank a
   stage) in 2 and 4 gloo processes on the host CPU, with no skip and with
   every forward pair of stages as a skip: the last rank's outputs against
   the plain stage chain, one hand-off a microbatch step on every rank;
4. the pipelined matmul's K-loop plan at ring depths 1 and 2, and the
   K-loop compiled on the card (bit-equal, structural hit across ``steps``);
   the Hopper K-loop plan (a producer warpgroup issues and loads, consumer
   warpgroups compute) and the TMA kernels' mbarriers at the depths phase 5
   runs;
5. the pipelined matmul at yi-6b's full widths (d_model 4096, d_ff 11008)
   as a 2048-token prefill, a ragged shape TMA can describe, an unaligned
   one and granite-3-2b's LM head (2048 x 2048 x 49155: B's rows are
   98310 bytes), in bf16 and f32 at depths 1, 2 and the routes' defaults
   (4 in bf16, 3 in 3xTF32): launch counts per route from the main run
   (every bf16 call on the TMA / wgmma kernel, every f32 call on the
   3xTF32 one, a split pre-pass that pads the rows to 16 bytes and TF32
   wgmma products), the split kernel's launches and the bf16 stage's (one
   launch restages the operands TMA cannot describe), the exact identity
   probes I @ B and A @ I on both routes at yi-6b's widths and at the LM
   head (f32 with operands of 21 significant bits), the error against the
   plain PyTorch version and, in f32, against an f64 product, a planted
   one-TF32 product and a planted stage that shifts one row by one element,
   which must read above their limits, the stage and the split bit-equal
   to their plain versions; the kernel's time beside its bound, the plain
   version's and ``torch.matmul``'s in turns; at the unaligned shapes also
   the device time alone and the host's enqueue time beside
   ``torch.matmul``'s, and the stage, the splits and the product each
   alone, back to back (so at yi-6b's for the split and the product);
6. the flash-attention kernels against their plain version at yi-6b's
   prefill shape (4 x 2048 tokens, 32 heads, GQA 4, hd 128, causal) in
   bf16 and f32, the same with gemma3's 1024-token window, an unaligned
   193 / 201 non-causal shape at hd 32, the same lengths at hd 128 (causal
   and not), granite's hd 64, all-MiniLM-L6-v2's attention at hd 32 (64 x
   512 tokens, 12 heads) and the smoke configs' hd 16 at granite's prefill
   geometry, each in bf16 and f32: launch counts per route from the main
   run (every bf16 call on the TMA / wgmma kernel, every f32 call on the
   3xTF32 one, a K/V split pre-pass and TF32 wgmma products, at hd 16, 32,
   64 and 128 alike), the split's launches, the largest row-relative
   error, the same check's reading of two planted faults (a key edge off
   by one, a 64-key tile dropped), which must exceed its limit; on the
   3xTF32 route also the error against an f64 plain version as a share of
   the limit, and a 1xTF32 emulation that must read above it; the one-hot
   probes on both TMA routes at every hd (exact); the split bit-equal to
   its plain version at every hd; every route at a query offset (prefill
   continuation) against the plain version, with the offset off by one as
   a planted fault; time, bound (bytes, products, or one exp2 a live pair
   on the special-function units), plain and
   ``scaled_dot_product_attention`` times; at the yi-6b prefill the bf16
   TMA kernel at ring depths 1, 2 and its default and SDPA are timed in
   turns, and so are the 3xTF32 route at every depth and SDPA; at hd 16
   and 32 the route, SDPA and the hd-64 route on zero-padded operands in
   the same rounds, each's device time alone (L2 flushed), host enqueue
   time and single launch;
   then the few-row route
   ``flash_decode`` (``DECODE_CASES``: whisper's cross shapes, yi-6b's
   and granite's decode positions at 1, 4 and 16 rows, with and without a
   window), one clustered launch a call: the kernel against ``flash_decode_ref``'s steps at its key
   ranges, a peer's state left out of the merge and the last live key
   dropped as planted faults, the probes on the last range's edges, its
   ring depth and resident clusters, its single-launch time in turns with
   ``tma_wgmma`` forced and SDPA, the device time alone (a sleep kernel
   holds the device, the L2 flushed before each launch) and the host's
   enqueue time of each, the plain version and the bound; the crossover
   against ``tma_wgmma`` at Sq 1, 4, 16, 32 and 64 over 1500 keys that
   sets the route's threshold; at whisper's decode cross shape the
   kernel's time split into its loads, its products and its merge (timing
   probes) and its kernels a call under the profiler; and
   ``decode_attention`` over a partly filled cache at yi-6b's and
   granite's decode steps (``DECODE_CACHE_CASES``, the slots outside the
   live keys NaN) against the plain version, with the last live key
   dropped as a planted fault, and its device time against the bound;
7. yi-6b at full width (32 layers, bf16, random weights from a seed)
   serving 8 requests of 2048 prompt tokens in waves of 4 slots, 32 new
   tokens each, through ``repro_torch.launch``'s step functions: one flash
   launch per layer per prefill on the TMA route and one per layer per
   decode step on flash_decode; the first wave's logits against a rerun
   whose prefill and decode attention is the plain version, and against
   one whose causal edge is off by one; every layer's kernel output against
   the plain version on the wave's own activations, with the same planted
   fault, and every layer's decode attention at a decode step; prefill and
   decode times, tokens/s, peak memory and the idle share of one decode
   wave;
7b. granite-3-2b trained at full width and depth (40 layers, 2.636 B
   parameters, bf16, remat "full", random weights from a seed) for 8
   steps of 4 x 2048 tokens through ``repro_torch.runtime.train_loop``:
   each loss, step ms (median of steps 3-8), tokens/s, model TFLOP/s
   beside the bf16 peak, peak memory, the AdamW update alone, the idle
   share of one profiled step; train-mode attention is the plain version
   under autograd (``attention.train_plain_calls``), so no flash launch;
   losses finite and falling, peak memory above 30e9 bytes (the state
   alone is 31.6e9).  Then one ``make_train_step`` at full width with 2
   layers in f32 on the card against the same step on the CPU, with two
   planted faults that must read above the limits (one leaf's grad x
   1.01, the causal mask dropped); and at 1 layer, 6 straight steps
   against 3 + restore + 3, and a ``WorkerFailure`` at step 4 with
   ``ckpt_every=2``, under deterministic algorithms;
7c. deepseek-moe-16b at full size (28 layers, 16.88 B parameters, 64
   experts top 6 + 2 shared, bf16, random weights from a seed) with phase
   7's traffic: one flash launch per layer per prefill, all on the TMA
   route, no matmul launch; the first wave's logits against a rerun whose
   attention is the plain version and whose routing replays the kernel
   run's, and against the same with a planted attention fault; every
   layer's kernel output against the plain version; the share of (token, k)
   pairs capacity drops; layer 0's ``moe_apply`` with nothing dropped
   against ``moe_reference``, and with one expert's output lost; prefill and
   decode times, tokens/s, peak memory, the idle share of profiled decode
   steps;
7d. mamba2-2.7b at full size (64 layers) with the same traffic: no kernel
   launch; decode steps 1 and 16 against a fresh prefill over the same
   tokens, in f32 at full size and in bf16 (against the f32 prefill), each
   with the state dropped as a planted fault; ``ssd_chunked`` against
   ``ssd_reference`` at one layer's heads and state; then jamba-v0.1 at full
   width cut to one block of 8 layers (4 requests, 16 new tokens): one
   launch a prefill, both cache kinds filled, the logits and layer checks;
7e. whisper-medium at full size (24 + 24 layers, 1500 random frame
   embeddings a request, a 4-token decoder prompt, 32 new tokens, 8
   requests in waves of 4): 72 launches a prefill and 24 a decode step,
   the encoder's on the TMA route, the decoder's (its prompt's 4 x 4 self
   and 4 x 1500 cross attention, each step's 1 x 1500) on flash_decode,
   one launch a call; the logits check; the encoder's 1500 x 1500, the prefill self
   attention's 4 x 4, the prefill cross-attention's 4 x 1500 and the
   decode step's 1 x 1500 calls on the wave's own activations against the
   plain version, each timed with SDPA and the plain version (and, on
   flash_decode, tma_wgmma forced) beside its bound; at the two cross shapes the one-hot probes (and with V = I)
   on both routes, their first rows on the last ragged tile's 28 keys or
   on the last key range's edges, exact, and the plain version with the
   last key dropped must miss them; the decode step with flash_decode and
   with tma_wgmma forced in alternating waves, with each one's idle
   share;
7f. the continuous-batching server (``repro_torch.launch.serve``)
   at yi-6b's full size: 16 requests of 2048 prompt tokens in 4 slots (4
   waves), 32 new tokens, each wave's four sync plans through the default
   plan service on the card; every request's tokens equal ``generate``'s
   on the same batch, one flash launch a layer a prefill on the TMA route,
   no structural miss and no capture from the third wave on; tokens/s, the
   per-wave plan / compile / run p50 and p99, each wave's cache and
   capture counts; then one more wave with the int8 KV cache;
7g. whisper-medium (24 + 24 layers, 4 x 448 tokens, 1500 frames a row),
   mamba2-2.7b (64 layers, 4 x 2048) and deepseek-moe-16b (cut to 4 of 28
   layers, 4 x 2048, 16 steps) trained at full width as phase 7b trains
   granite (8 steps): losses finite and falling, step ms, tokens/s, peak
   memory, the idle share of a profiled step; deepseek's aux-loss gradient at every
   router; each with phase 7b's parity step at 2 layers in f32 and its two
   planted faults (in an attention-free stack the mask fault moves the
   SSD's causal edge one step forward);
7h. the launch layer on ``DeviceMesh`` and DTensor
   (``repro_torch.launch.{mesh,sharding,input_specs,steps,dryrun}``):
   (a) yi-6b at full width served on a world-1 NCCL mesh under
   ``cell_shardings``' placements with phase 7's first wave: greedy tokens
   equal phase 7's, every flash launch through ``local_map`` on the TMA
   route, the decode step beside the plain one in turns; (b) inside phase
   7b, on its state cut to 10 of 40 layers, two microbatch-2 train steps
   on that mesh with FSDP gradient shardings, each against the unsharded
   step leaf by leaf (7b's parity limits where a leaf differs), the
   gradient reductions counted; (c) 2 and 4 gloo
   processes on the host CPU, meshes (2, 1), (1, 2) and (2, 2): the dense,
   MoE, Mamba-2 and encoder-decoder smoke configs in f32, the sharded
   train step (microbatches 1 and 4, and ``seq_shard``) within 1e-5 of the
   unsharded one, as many gradient reductions at 4 microbatches as at 1,
   sharded prefill and decode with the unsharded greedy tokens; (d) the
   dry runs of mamba2-2.7b x decode_32k and granite-3-2b x train_4k on the
   16 x 16 mesh (a fake group of 512 ranks; granite at 2 microbatches)
   and ``pp_lowering.main``; (c) and (d) run on the host beside phase
   7g's device-bound cells (mamba2, deepseek) and are read before (a);
   (e) internlm2's
   smoke config (hd 8, on the zero-padded hd-16 kernels) in f32 against
   the CPU and in bf16 against a plain-attention rerun with a planted
   causal-edge fault, and transposed matmul operands against the plain
   version;
8. one JSON line listing every kernel with its numbers;
9. ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# a sleep kernel of this many clocks (~2 ms; in _held_times, this many a
# call timed) holds the device while the host enqueues the launches whose
# device times are read
HOLD_CYCLES = 4_000_000
# f32: CUDA cores (FFMA); tf32: the tensor cores, one TF32 product
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}
# ex2 on the special-function units: 16 a clock an SM (4 a sub-partition),
# 132 SMs, at the 1830 MHz that the 989 TFLOP/s bf16 figure assumes (4096
# dense bf16 FLOP a clock an SM)
EX2_PER_S = 16 * 132 * 1830e6
TOL = {"bf16": 3e-2, "f32": 2e-5}  # matmul: tests/test_kernels.py; atol x sqrt(K)
# flash attention: the largest relative L2 error of one output row (one
# query position of one head) against the plain version in f32.  A row's
# norm falls from |v| (one live key) to about |v| / sqrt(2048) (a 2048-key
# row), so an absolute limit loose enough for the first rows would pass a
# dropped key on the last; a row-relative limit holds every row alike
ROW_TOL = {"bf16": 1e-2, "f32": 2e-5}

TMA_KERNEL_SOURCE = "src/repro_torch/kernels/pipelined_matmul/csrc/tma_wgmma_matmul.cu"
TF32X3_SOURCE = "src/repro_torch/kernels/pipelined_matmul/csrc/tma_wgmma_tf32x3.cu"
TPU_KERNEL = "src/repro/kernels/pipelined_matmul/kernel.py:24"
TMA_FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/tma_wgmma_flash.cu"
TF32X3_FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/tma_wgmma_flash_tf32x3.cu"
DECODE_FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_decode.cu"
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention/kernel.py:31"

# (label, B, Sq, Sk, H, KV, hd, causal, window, dtype): yi-6b's prefill
# (src/repro/configs/yi_6b.py: 32 heads, GQA 4, hd 128) at 4 x 2048
# tokens, gemma3's local window (src/repro/configs/gemma3_27b.py: 1024),
# tests/test_kernels.py's unaligned 193 / 201 (at hd 32, and at hd 128
# with GQA, where the TMA kernel zero-fills the ragged ends and masks the
# stores), and granite-3-2b's hd 64 (32 heads, GQA 8); the first is the
# shape the serving phase gives it.  Below hd 64, two real-width shapes
# (no full-size config of the repo has hd 16 or 32): all-MiniLM-L6-v2's
# attention (hidden 384, 12 heads of 32, 512 positions) at 64 x 512
# tokens, and the smoke configs' hd 16 at granite-3-2b's prefill geometry.
# Every bf16 case takes the TMA / wgmma kernel, every f32 case the 3xTF32
# one
FLASH_CASES = [
    ("yi-6b prefill", 4, 2048, 2048, 32, 4, 128, True, None, "bf16"),
    ("yi-6b prefill", 4, 2048, 2048, 32, 4, 128, True, None, "f32"),
    ("yi-6b prefill, window 1024", 4, 2048, 2048, 32, 4, 128, True, 1024, "bf16"),
    ("yi-6b prefill, window 1024", 4, 2048, 2048, 32, 4, 128, True, 1024, "f32"),
    ("unaligned 193/201", 1, 193, 201, 4, 4, 32, False, None, "bf16"),
    ("unaligned 193/201", 1, 193, 201, 4, 4, 32, False, None, "f32"),
    ("ragged 193/201 hd 128", 1, 193, 201, 4, 2, 128, True, None, "bf16"),
    ("ragged 193/201 hd 128", 1, 193, 201, 4, 2, 128, False, None, "bf16"),
    ("ragged 193/201 hd 128", 1, 193, 201, 4, 2, 128, True, None, "f32"),
    ("ragged 193/201 hd 128", 1, 193, 201, 4, 2, 128, False, None, "f32"),
    ("granite-3-2b hd 64", 4, 2048, 2048, 32, 8, 64, True, None, "bf16"),
    ("granite-3-2b hd 64", 4, 2048, 2048, 32, 8, 64, True, None, "f32"),
    ("minilm_hd32", 64, 512, 512, 12, 12, 32, False, None, "bf16"),
    ("minilm_hd32", 64, 512, 512, 12, 12, 32, False, None, "f32"),
    ("hd16_prefill", 4, 2048, 2048, 32, 8, 16, True, None, "bf16"),
    ("hd16_prefill", 4, 2048, 2048, 32, 8, 16, True, None, "f32"),
]
# (B, Sq, Sk, H, KV, hd, causal, window, q_offset, dtype): every route at a
# query offset, the prefill continuation of the reference's
# chunked_attention: the last 256 of yi-6b's 2048 positions (causal, and
# with gemma3's window), and 193 rows after 208 at hd 32 (on the TMA
# routes, as at every hd)
FLASH_Q_OFFSET_CASES = [
    (1, 256, 2048, 32, 4, 128, True, None, 1792, "bf16"),
    (1, 256, 2048, 32, 4, 128, True, None, 1792, "f32"),
    (1, 256, 2048, 32, 4, 128, True, 1024, 1792, "f32"),
    (1, 193, 401, 4, 4, 32, True, None, 208, "bf16"),
    (1, 193, 401, 4, 4, 32, True, 100, 208, "f32"),
    (1, 4, 2048, 32, 4, 128, True, 256, 2044, "bf16"),  # flash_decode
]
# (B, Sq, Sk, H, KV, hd, keyword arguments): the one-hot probes on both TMA
# routes, bf16 and f32 (repro_torch.kernels.flash_attention.probe), several
# tiles, ragged ends, a window and V = I, at hd 128, 64, 32 and 16
FLASH_PROBES = [
    (2, 1024, 1024, 8, 2, 128, dict(causal=True)),
    (1, 193, 201, 4, 2, 128, dict(causal=False)),
    (2, 1024, 1024, 8, 2, 128, dict(causal=True, window=300, identity_v=True)),
    (2, 1024, 1024, 8, 2, 64, dict(causal=True)),
    (1, 193, 201, 4, 4, 64, dict(causal=False, identity_v=True)),
    (2, 1024, 1024, 8, 2, 32, dict(causal=True)),
    (1, 193, 201, 4, 4, 32, dict(causal=False, identity_v=True)),
    (2, 520, 520, 4, 2, 16, dict(causal=True, window=130)),
    (1, 193, 201, 4, 2, 16, dict(causal=False, identity_v=True)),
]

# (label, B, Sq, Sk, H, KV, hd, causal, window, q_offset): the flash_decode
# route (bf16, at most DECODE_MAX_SQ query rows): whisper-medium's cross
# attention (16 heads of 64, 1500 frames; decode 1 row, prompt 4) and 16
# rows there; yi-6b's decode position (32 heads, GQA 4, hd 128, 2048 cache
# positions) at 1, 4 and 8 rows (8 to 64 rows a KV head), and with gemma3's
# 1024 window; granite's
# hd 64 with GQA 4 (32 heads, 8 KV heads), causal and windowed; hd 128
# without GQA over 1500 keys
DECODE_CASES = [
    ("whisper decode cross", 4, 1, 1500, 16, 16, 64, False, None, 0),
    ("whisper prompt cross", 4, 4, 1500, 16, 16, 64, False, None, 0),
    ("whisper 16 rows", 4, 16, 1500, 16, 16, 64, False, None, 0),
    ("yi-6b decode", 4, 1, 2048, 32, 4, 128, True, None, 2047),
    ("yi-6b 4 rows", 4, 4, 2048, 32, 4, 128, True, None, 2044),
    ("yi-6b 8 rows", 4, 8, 2048, 32, 4, 128, True, None, 2040),
    ("yi-6b decode, window 1024", 4, 1, 2048, 32, 4, 128, True, 1024, 2047),
    ("granite decode", 4, 1, 2048, 32, 8, 64, True, None, 2047),
    ("granite 16 rows, window 1024", 4, 16, 2048, 32, 8, 64, True, 1024, 2032),
    ("hd 128 MHA 4 rows", 4, 4, 1500, 16, 16, 128, False, None, 0),
]
# (label, B, Smax, H, KV, hd, window, cache_len): decode_attention, the
# model's entry, over a partly filled cache at the main path's decode
# shapes (yi-6b's decode pool, granite's with gemma3's 1024 window): the
# live keys end one key into a tile, well before Smax
DECODE_CACHE_CASES = [
    ("yi-6b decode step", 4, 3072, 32, 4, 128, None, 2049),
    ("granite decode step, window 1024", 4, 3072, 32, 8, 64, 1024, 2049),
]
# the query rows at which flash_decode and tma_wgmma are timed at
# whisper's cross shape (Sk 1500, 16 heads of 64) and at yi-6b's decode
# position (GQA 4: 8 query rows a KV head a row): where the route rule's
# limits come from
DECODE_CROSSOVER_SQ = (1, 4, 16, 32, 64)
DECODE_CROSSOVER_GQA_SQ = (1, 4, 8)
# the route rule's limits, written out independently of ops.route
DECODE_MAX_SQ = 16
DECODE_MAX_ROWS = 64
DECODE_REPS = 50
# phase 7e's decode waves, each route in turn (A B B A A B)
DECODE_AB_ORDER = ("flash_decode", "tma_wgmma", "tma_wgmma", "flash_decode", "flash_decode",
                   "tma_wgmma")
# read between timed launches, so that each reads K and V from HBM as each
# decoder layer's call does: twice the H100's 50 MB L2.  Read, not written:
# a written buffer leaves 50 MB of dirty lines whose write-back the timed
# launch would pay for
L2_FLUSH_BYTES = 100 * 2**20

# the serving phase: yi-6b at full width, 8 requests in waves of 4 slots
SERVE_ARCH = "yi_6b"
SERVE_REQUESTS = 8
SERVE_SLOTS = 4
SERVE_PROMPT = 2048
SERVE_NEW_TOKENS = 32
SERVE_LOGIT_RTOL = 5e-2  # relative L2 error of the kernel's logits vs plain
# the other families at full size, bf16, random weights from SEED:
# deepseek-moe-16b (src/repro/configs/deepseek_moe_16b.py: 28 layers, 64
# experts top 6 + 2 shared) and mamba2-2.7b (64 layers, 80 SSD heads of 64,
# state 128) with phase 7's traffic; jamba-v0.1 at full width cut to one
# block of 8 layers (its 102.9 GB of weights do not fit one card), 4
# requests of 2048 tokens, 16 new; whisper-medium (24 + 24 layers, 1500
# frames) with a 4-token decoder prompt and phase 7's requests
MOE_ARCH = "deepseek_moe_16b"
MAMBA_ARCH = "mamba2_2_7b"
HYBRID_ARCH = "jamba_v01_52b"
HYBRID_REQUESTS = 4
HYBRID_NEW_TOKENS = 16
ENCDEC_ARCH = "whisper_medium"
ENCDEC_PROMPT = 4
# mamba2's decode steps against a fresh prefill over the same tokens,
# relative L2 of the logits.  In f32 at full size (TF32 off; the bf16
# weights upcast, exactly) within MAMBA_F32_RTOL.  In bf16 each path rounds
# apart by an ulp a layer (cuBLAS takes other kernels for 4 rows than for
# 8192) and 64 random-init layers amplify it (0.058 at step 1, 0.24 at step
# 16 on an H100 80GB HBM3 at 700 W), so the bf16 decode is held against the f32 prefill:
# no further from it than MAMBA_BF16_FACTOR times the bf16 prefill is.  The
# chunked SSD against its sequential oracle at one layer's heads and
# state, f32, within tests/test_models.py's 1e-4
MAMBA_CONTINUATION_STEPS = (1, 16)
PROFILED_STEPS = 8  # decode steps traced for 7c-7e's idle share
MAMBA_F32_RTOL = 1e-3
MAMBA_BF16_FACTOR = 2.0
SSD_CHECK = (1, 512, 80, 64, 128)  # (B, S, H, P, N)
SSD_TOL = 1e-4

# (M, K, N). yi-6b (src/repro/configs/yi_6b.py): d_model 4096, d_ff
# 11008; a 2048-token prefill through the MLP's up and down projections.
# (300, 264, 136): ragged M, N below one tile, K not a multiple of the
# K-step, but TMA-aligned; (300, 257, 130): strides TMA cannot describe;
# granite-3-2b's LM head (src/repro/configs/granite_3_2b.py: d_model 2048,
# vocab 49155) over one 2048-token sequence: an odd N, B restaged
MATMUL_SHAPES = [(2048, 4096, 11008), (2048, 11008, 4096), (300, 264, 136), (300, 257, 130),
                 (2048, 2048, 49155)]
LM_HEAD = (2048, 2048, 49155)
MATMUL_DEPTHS = (1, 2, 4)  # 4: the bf16 TMA route's default, ops.HOPPER_STAGES
TF32X3_DEPTHS = (1, 2, 3)  # 3: the 3xTF32 route's default and deepest
# the training phase: granite-3-2b (src/repro/configs/granite_3_2b.py: 40
# layers, d_model 2048, 32 heads GQA 8, hd 64, d_ff 8192, vocab 49155) at
# full width and depth, bf16, remat "full", 4 x 2048 tokens a step, AdamW
# at the reference's default learning rate with a 2-step warmup
TRAIN_ARCH = "granite_3_2b"
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 8
TRAIN_LR = 3e-4
TRAIN_WARMUP = 2
# device parity: full width, 2 layers, f32 (TF32 off), one sequence of 128
# tokens.  Limits: loss and grad norm relative; the largest relative L2
# error of a leaf's mu / nu; and, as tests/test_torch_train.py holds a
# train step, the largest change of a param's update in units of the
# step's lr: 1e-3 where the reference's gradient is at least CLEAR_GRAD
# (100 eps), 2 anywhere.  A first Adam step moves an element by
# lr * g / (|g| + eps): where |g| is near eps (1e-8) the devices' rounding
# of g moves it by up to 2 lr, so one such element decides a relative L2
# reading over the update of a small leaf; the moments, linear in g, hold
# those elements instead
PARITY_LAYERS = 2
PARITY_SEQ = 128
CLEAR_GRAD = 1e-6
TRAIN_PARITY_TOL = {
    "loss": 1e-5, "grad_norm": 1e-4, "update": 1e-3, "update_any": 2.0, "mu": 1e-4, "nu": 1e-4,
}
# resume and recovery: full width, 1 layer, bf16, 2 x 512 tokens a step,
# deterministic algorithms: the losses after a restore as the straight run's
RESUME_LAYERS = 1
RESUME_BATCH = 2
RESUME_SEQ = 512
RESUME_RTOL = 1e-6

# phase 7f: the continuous-batching server (repro_torch.launch.serve) at
# yi-6b's full size with phase 7's prompts, slots and new tokens: 16
# requests (4 waves), then one more wave with the int8 KV cache
BATCHING_REQUESTS = 16
# phase 7g: the three new families trained at full width, bf16, remat
# "full", random weights from SEED, phase 7b's optimizer, each with phase
# 7b's parity step at PARITY_LAYERS layers (an encoder-decoder's encoder
# cut alike): (cell, arch, layers or None for the config's, rows, tokens
# a row, steps).
# whisper-medium (src/repro/configs/whisper_medium.py: 24 + 24 layers) with
# 1500 frame embeddings a row and 448 decoder tokens, its published
# maximum target length; mamba2-2.7b at its 64 layers; deepseek-moe-16b cut
# from 28 layers to FAMILY_MOE_LAYERS, the most whose peak stays under
# FAMILY_PEAK_LIMIT bytes (the phase holds it): at the update a layer's
# 588 M parameters hold 24 bytes each, 14.1e9 a layer (bf16 weights and
# grads, and the f32 AdamW moments twice while the eager update replaces
# them), so a fifth layer would pass the card's 80 GB.  Its 4-layer loss
# moves by less in 8 steps than step-to-step noise, so it takes 16 (~0.45 s
# a step); the others take phase 7b's 8
FAMILY_MOE_LAYERS = 4
FAMILY_PEAK_LIMIT = 70e9
# whisper-medium's step is host-bound (idle share 0.51-0.67): it trains
# alone; phase 7h's host-side runs start after it, beside the device-bound
# cells (mamba2 and deepseek, idle 0.02-0.06)
FAMILY_TRAIN_ALONE = 1
FAMILY_TRAIN = [
    ("whisper_medium_train_4x448_1500f", ENCDEC_ARCH, None, 4, 448, 8),
    ("mamba2_2p7b_train_4x2048", MAMBA_ARCH, None, 4, 2048, 8),
    (f"deepseek_moe16b_{FAMILY_MOE_LAYERS}l_train_4x2048", MOE_ARCH, FAMILY_MOE_LAYERS, 4, 2048, 16),
]

SEED = 0
WARM_RUNS = 11
SERVICE_WARM_S = 10.0  # the warm epoch's least length in seconds ...
SERVICE_MIN_ROUNDS = 300  # ... and least number of rounds of the mix
SERVICE_IN_FLIGHT = 32  # requests outstanding at once (8 per worker)
SERVICE_ONE_OFF = 20  # one-off bounds per soak structure an epoch


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(line: str) -> None:
    print(line, flush=True)


# ---------------------------------------------------------------------- #
# Phase 3 corpus, from the port's own classes
# ---------------------------------------------------------------------- #

def _wide(ni, nj):
    """The {(0,1),(1,-1)} recurrence of phase 3 (benchmarks/run.py's)."""

    from repro_torch.core import ArrayRef, LoopProgram, Statement

    return LoopProgram(
        statements=(
            Statement(
                "S1",
                ArrayRef("a", (0, 0)),
                (ArrayRef("a", (0, -1)), ArrayRef("a", (-1, 1))),
            ),
        ),
        bounds=((0, ni), (0, nj)),
    )


def _skew(ni, nj):
    """Phase 3's {(1,-1)} recurrence."""

    from repro_torch.core import ArrayRef, LoopProgram, Statement

    return LoopProgram(
        statements=(
            Statement("S1", ArrayRef("a", (0, 0)), (ArrayRef("a", (-1, 1)),)),
        ),
        bounds=((0, ni), (0, nj)),
    )


def _narrow(n):
    """{(0,-32),(-1,1)}: tests/test_spmd.py's narrow blocked recurrence."""

    from repro_torch.core import ArrayRef, LoopProgram, Statement

    return LoopProgram(
        statements=(
            Statement(
                "S1",
                ArrayRef("a", (0, 0)),
                (ArrayRef("a", (0, -32)), ArrayRef("a", (-1, 1))),
            ),
        ),
        bounds=((0, n), (0, n)),
    )


def corpus():
    from repro_torch.core import (
        ArrayRef,
        LoopProgram,
        Statement,
        gather_scatter,
        paper_alg1,
        paper_alg4,
        paper_alg6,
        sparse_matvec,
    )

    mixed_cycle_pm1 = LoopProgram(
        statements=(
            Statement("S1", ArrayRef("a", (0, 0)), (ArrayRef("b", (-1, 1)),)),
            Statement("S2", ArrayRef("b", (0, 0)), (ArrayRef("a", (0, -1)),)),
        ),
        bounds=((0, 4), (0, 4)),
    )
    guarded = LoopProgram(
        statements=(
            Statement("S1", ArrayRef("p", 0), (ArrayRef("p", -1),)),
            Statement(
                "S2", ArrayRef("a", 0), (ArrayRef("a", -1),),
                guard=ArrayRef("p", -1),
            ),
        ),
        bounds=((1, 7),),
    )
    small = [
        ("alg1", paper_alg1(8), (None,)),
        ("alg4", paper_alg4(8), (None,)),
        ("alg6", paper_alg6(8), (None,)),
        ("skew_recurrence", _skew(5, 5), (None,)),
        ("mixed_cycle_pm1", mixed_cycle_pm1, (None,)),
        ("guarded", guarded, (None,)),
        ("gather_scatter", gather_scatter(8), ("inspect", "speculate")),
        ("sparse_matvec", sparse_matvec(8), ("inspect", "speculate")),
    ]
    sized = [
        ("paper_alg6_1025", paper_alg6(1025), {}),
        ("skew_recurrence_64x16_chunk", _skew(64, 16), {"scc_policy": "chunk"}),
        ("wide_skew_96x192_skew", _wide(96, 192), {"scc_policy": "skew"}),
    ]
    return small, sized


def _profiled_run(torch, fn):
    """Device busy time (the summed durations of the device events: kernels
    and copies, on one stream) and wall time of one call under
    ``torch.profiler``, in ms, and the number of device events; busy is
    None when the trace holds no device time."""

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [
        e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.device_time_total for e in device)
    return (busy_us / 1e3 if busy_us > 0 else None), wall_ms, len(device)


def graph_counts():
    """(captures, replays, eager sweeps) of the level loop on the card."""

    from repro_torch.obs import metrics

    return tuple(
        metrics.counter(f"torch.{name}").value
        for name in ("graph_captures", "graph_replays", "eager_sweeps")
    )


def count_delta(before):
    return dict(zip(("captures", "replays", "eager_sweeps"),
                    (b - a for a, b in zip(before, graph_counts()))))


def _timed_run(torch, exe, init):
    """Host ms and CUDA-event ms of one ``Executable.run`` (the events bound
    the enqueue and the sweep; the host clock also holds the read-back)."""

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = exe.run(store=init)
    end.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def level_loop_phase(torch):
    from repro_torch.compile import clear_compile_cache
    from repro_torch.core import get_backend, plan, run_sequential
    from repro_torch.obs import trace

    small, sized = corpus()
    runs = 0
    before = graph_counts()
    for name, prog, modes in small:
        init = prog.initial_store()
        expect = run_sequential(prog, init)
        for deps in modes:
            for method in ("none", "isd", "pattern", "both"):
                p = plan(prog, method=method, deps=deps)
                exe = p.compile("torch", device="cuda")
                label = f"{name}/{method}/deps={deps}"
                # twice each: a case's first run is eager, its second is
                # captured and replayed
                for _ in range(2):
                    out = exe.run(store=init)
                    naive = get_backend("torch").differential(
                        p.naive_sync, store=init, device="cuda"
                    )
                    check(out == expect, f"level loop: {label} optimized diverged")
                    check(naive == expect, f"level loop: {label} naive diverged")
                    runs += 2
    counts = count_delta(before)
    check(counts["captures"] > 0, "level loop corpus: nothing was captured")
    check(
        counts["replays"] + counts["eager_sweeps"] >= runs,
        f"level loop corpus: {counts} for {runs} runs",
    )
    emit(
        f"level loop corpus: {runs} runs on cuda, each case eager then "
        f"captured ({json.dumps(counts)}), all bit-equal to run_sequential"
    )

    for name, prog, knobs in sized:
        init = prog.initial_store()
        expect = run_sequential(prog, init)
        # first runs of fresh artifacts (tables and one eager sweep), under
        # the capture policy (A) and held eager by ``_capture = False`` (B),
        # in turns A B B A; then the last A's second run, which captures
        # and replays once
        before = graph_counts()
        cold = {"cold_ms": [], "cold_eager_ms": []}
        for policy in (True, False, False, True):
            clear_compile_cache()
            exe = plan(prog, method="isd").compile("torch", device="cuda", **knobs)
            exe.compiled._capture = policy
            out, ms, _ = _timed_run(torch, exe, init)
            del exe.compiled._capture
            check(out == expect, f"level loop: {name} first run diverged")
            cold["cold_ms" if policy else "cold_eager_ms"].append(ms)
        check(count_delta(before) == {"captures": 0, "replays": 0, "eager_sweeps": 4},
              f"level loop: {name}'s first runs were not eager sweeps")
        trace.clear()
        trace.enable()
        try:
            out, cold["second_ms"], _ = _timed_run(torch, exe, init)
        finally:
            trace.disable()
        check(out == expect, f"level loop: {name} second run diverged")
        capture_ms = [
            e["dur"] / 1e3 for e in trace.events() if e["name"] == "torch.capture"
        ]
        check(count_delta(before)["captures"] == 1 and len(capture_ms) == 1,
              f"level loop: {name} was not captured once, on its second run")
        case = next(reversed(exe.compiled._cases.values()))  # this run's
        # the captured replay and the eager sweep (``_capture = False``) of
        # the same case, in turns
        timings = {"captured": ([], []), "eager": ([], [])}
        for _ in range(WARM_RUNS):
            for sweep in ("captured", "eager"):
                exe.compiled._capture = sweep == "captured"
                out, host_ms, event_ms = _timed_run(torch, exe, init)
                check(out == expect, f"level loop: {name} {sweep} warm run diverged")
                timings[sweep][0].append(host_ms)
                timings[sweep][1].append(event_ms)
        row = {
            "name": name,
            "levels": case.n_levels,
            "group_steps": len(case._steps),
            "segments": [s[0] for s in case.static.segments or ()],
            **cold,
            "capture_ms": capture_ms[0],
            "warm_runs": WARM_RUNS,
        }
        for sweep, (host, device) in timings.items():
            exe.compiled._capture = sweep == "captured"
            busy_ms, wall_ms, events = _profiled_run(
                torch, lambda: exe.run(store=init)
            )
            row[sweep] = {
                "warm_ms_median_host": statistics.median(host),
                "warm_ms_min_host": min(host),
                "warm_ms_max_host": max(host),
                "warm_ms_median_events": statistics.median(device),
                "profiled_wall_ms": wall_ms,
                "profiled_device_busy_ms": busy_ms,
                "profiled_device_events": events,
                "device_idle_share": (
                    1.0 - busy_ms / wall_ms if busy_ms is not None else None
                ),
            }
        del exe.compiled._capture
        counts = count_delta(before)
        check(
            counts == {"captures": 1, "replays": 2 + WARM_RUNS,
                       "eager_sweeps": 5 + WARM_RUNS},
            f"level loop: {name} sweeps {counts}",
        )
        row["sweeps"] = counts
        row["bit_equal"] = True
        emit("level loop: " + json.dumps(row))


def operator_phase():
    """Each division-family operator and ``**`` with a Python-number
    operand, on 4096 lanes of one statement, bit-equal to
    ``run_sequential`` on the card (``**`` through the port's host ``pow``,
    counted by ``torch.host_pow_lanes``).  A ``**`` statement keeps its
    case eager by rule (an eager sweep each run, no capture); every other
    operator's case runs eagerly once, then is captured and replayed."""

    from repro_torch.core import ArrayRef, LoopProgram, Statement, plan, run_sequential
    from repro_torch.obs import metrics

    ops = {
        "x/7": (lambda x: x / 7, True),
        "7/x": (lambda x: 7.0 / (x + 100.0), True),
        "x//3": (lambda x: x // 3, True),
        "x%3": (lambda x: x % 3, True),
        "x**2": (lambda x: x ** 2, True),
        "x**0.5": (lambda x: abs(x) ** 0.5, True),
        "1.3**x": (lambda x: 1.3 ** x, True),
    }
    report, warm_ms, sweeps = {}, {}, {}
    for name, (fn, exact) in ops.items():
        prog = LoopProgram(
            statements=(
                Statement("S1", ArrayRef("a", 0), (ArrayRef("b", 0),), compute=fn),
            ),
            bounds=((0, 4096),),
        )
        init = prog.initial_store()
        init["b"] = {
            cell: (i * 0.7137) % 11.3 - 5.1
            for i, cell in enumerate(sorted(init["b"]))
        }
        expect = run_sequential(prog, init)["a"]
        exe = plan(prog).compile("torch", device="cuda")
        before = graph_counts()
        lanes = metrics.counter("torch.host_pow_lanes").value
        out = exe.run(store=init)["a"]
        differ = sum(1 for cell, v in expect.items() if out[cell] != v)
        check(not exact or differ == 0, f"operator {name}: {differ} cells differ on cuda")
        report[name] = differ
        lanes = metrics.counter("torch.host_pow_lanes").value - lanes
        want = 4096 if "**" in name else 0
        check(lanes == want, f"operator {name}: {lanes} host pow lanes, expected {want}")
        host = []
        for _ in range(WARM_RUNS):  # warm: the same tables
            t0 = time.perf_counter()
            exe.run(store=init)
            host.append((time.perf_counter() - t0) * 1e3)
        warm_ms[name] = statistics.median(host)
        sweeps[name] = count_delta(before)
        want = (
            {"captures": 0, "replays": 0, "eager_sweeps": 1 + WARM_RUNS}
            if "**" in name
            else {"captures": 1, "replays": WARM_RUNS, "eager_sweeps": 1}
        )
        check(sweeps[name] == want, f"operator {name}: sweeps {sweeps[name]}, expected {want}")
    emit(
        "operators on cuda, cells differing from run_sequential of "
        f"{len(expect)} (every op checked): {json.dumps(report)}"
    )
    emit(
        "operators on cuda, warm run ms (median of 11, host clock; each ** "
        f"runs Python's pow on 4096 lanes on the host): {json.dumps(warm_ms)}"
    )
    emit(f"operators on cuda, sweeps (** stays eager by rule): {json.dumps(sweeps)}")


# ---------------------------------------------------------------------- #
# Phase 3b: the plan service
# ---------------------------------------------------------------------- #

def _doall(n):
    """The reference soak's dependence-free chain (tests/test_serve.py)."""

    from repro_torch.core import ArrayRef, LoopProgram, Statement

    return LoopProgram(
        statements=(
            Statement("A", ArrayRef("a", 0), (ArrayRef("b", 0),)),
            Statement("B", ArrayRef("c", 0), (ArrayRef("a", 0),)),
        ),
        bounds=((0, n),),
    )


def service_mix():
    """(tenant, program, PlanOptions) of one service round: the reference
    soak's three structures at its bounds (tests/test_serve.py: decode
    12 / 13, scan 3 x 4 / 5, the doall chain 16 / 17) and the three
    benchmark-size programs of phase 3 under their knobs."""

    from repro_torch.core import PlanOptions
    from repro_torch.serve import decode_program, scan_program

    mix = [
        ("decode", decode_program(12), None),
        ("decode", decode_program(13), None),
        ("scan", scan_program(3, 4), None),
        ("scan", scan_program(3, 5), None),
        ("doall", _doall(16), None),
        ("doall", _doall(17), None),
    ]
    _, sized = corpus()
    for name, prog, knobs in sized:
        mix.append((name, prog, PlanOptions(method="isd", **knobs)))
    return mix


def one_off_mix(turn):
    """The soak's three structures at ``SERVICE_ONE_OFF`` bounds each that
    no other turn (nor the mix) uses: traffic whose bounds never repeat."""

    from repro_torch.serve import decode_program, scan_program

    mix = []
    for k in range(SERVICE_ONE_OFF):
        n = 24 + 4 * k + turn
        mix += [("decode", decode_program(n), None),
                ("scan", scan_program(3, n), None),
                ("doall", _doall(n), None)]
    return mix


def _percentile(values, q):
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, max(0, math.ceil(q * len(ordered)) - 1))]


def _service_epoch(svc, mix, expect, label, *, rounds, least_s=0.0):
    """Submit the mix round after round, at most ``SERVICE_IN_FLIGHT``
    requests outstanding, until ``rounds`` rounds and ``least_s`` seconds
    have passed; every store is held against ``expect``.  Returns the
    epoch's row: requests/s over its window, and the latency p50 / p99 of
    each tenant and of all requests (``serve.latency_ms``: from dequeue to
    result), each with its sample count."""

    import collections

    pending = collections.deque()
    latency = collections.defaultdict(list)

    def settle():
        i, fut = pending.popleft()
        res = fut.result(timeout=600)
        check(res.store == expect[i],
              f"service {label}: {mix[i][0]} diverged from run_sequential")
        latency[res.tenant].append(res.latency_ms)

    before = graph_counts()
    t0 = time.perf_counter()
    done = 0
    while done < rounds or time.perf_counter() - t0 < least_s:
        for i, (tenant, prog, options) in enumerate(mix):
            if len(pending) >= SERVICE_IN_FLIGHT:
                settle()
            pending.append((i, svc.submit(prog, options, tenant=tenant, run=True)))
        done += 1
    while pending:
        settle()
    svc.drain(timeout=600)
    wall_s = time.perf_counter() - t0
    every = [ms for v in latency.values() for ms in v]

    def spread(v):
        return {"n": len(v), "p50": _percentile(v, 0.5), "p99": _percentile(v, 0.99)}

    return {
        "epoch": label,
        "rounds": done,
        "requests": len(every),
        "requests_per_s": len(every) / wall_s,
        "wall_s": wall_s,
        "latency_ms": {"all": spread(every),
                       **{t: spread(v) for t, v in sorted(latency.items())}},
        "sweeps": count_delta(before),
        "bit_equal": True,
    }


def service_phase(torch):
    """``PlanService`` on the card with four workers.  A cold epoch of two
    rounds (each case's first run eager, its second captured); a warm epoch
    of at least ``SERVICE_WARM_S`` seconds and ``SERVICE_MIN_ROUNDS``
    rounds, which captures nothing; four epochs of one-off bounds, the
    capture policy and the eager sweep in turns, which capture nothing.
    Every store bit-equal to ``run_sequential``.  A planted fault (one
    replay that skips loading its store) must read as diverged."""

    from repro_torch import obs
    from repro_torch.compile.lowering import CompiledProgram
    from repro_torch.core import run_sequential
    from repro_torch.serve import PlanService, ServiceOptions

    mix = service_mix()
    expect = [run_sequential(prog, prog.initial_store()) for _, prog, _ in mix]
    obs.reset_all()  # a cold service: the first epoch plans and captures
    with PlanService(ServiceOptions(backend="torch", device="cuda", workers=4)) as svc:
        torch.cuda.synchronize()
        cold = _service_epoch(svc, mix, expect, "cold", rounds=2)
        emit("service: " + json.dumps(cold))
        check(cold["sweeps"] == {"captures": len(mix), "replays": len(mix),
                                 "eager_sweeps": len(mix)},
              f"service: cold epoch sweeps {cold['sweeps']}")
        warm = _service_epoch(svc, mix, expect, "warm",
                              rounds=SERVICE_MIN_ROUNDS, least_s=SERVICE_WARM_S)
        emit("service: " + json.dumps(warm))
        check(warm["sweeps"] == {"captures": 0, "replays": warm["requests"],
                                 "eager_sweeps": 0},
              f"service: warm epoch sweeps {warm['sweeps']}")

        # one-off bounds: no case runs twice, so nothing is captured; the
        # capture policy (A) and an eager sweep held by the class switch
        # (B) in turns A B B A, each on bounds of its own
        rates = {"policy": [], "eager": []}
        for turn, policy in enumerate(("policy", "eager", "eager", "policy")):
            once = one_off_mix(turn)
            want = [run_sequential(p, p.initial_store()) for _, p, _ in once]
            CompiledProgram._capture = policy == "policy"
            try:
                row = _service_epoch(svc, once, want, f"one-off {policy}", rounds=1)
            finally:
                CompiledProgram._capture = True
            check(row["sweeps"] == {"captures": 0, "replays": 0,
                                    "eager_sweeps": len(once)},
                  f"service: one-off bounds swept {row['sweeps']}")
            rates[policy].append(row["requests_per_s"])
            emit("service: " + json.dumps(row))
        emit("service one-off bounds, requests/s in turns A B B A: "
             + json.dumps(rates))

        # planted fault: replay one captured case without loading this run's
        # store — it must come out diverged from this store's oracle
        tenant, prog, options = mix[0]
        other = {
            a: {c: v * 1.5 - 0.25 for c, v in cells.items()}
            for a, cells in prog.initial_store().items()
        }
        want = run_sequential(prog, other)
        # twice, so the case is captured even if the one-off bounds evicted
        # it from its artifact's case LRU
        for _ in range(2):
            res = svc.submit(prog, options, tenant=tenant, run=True).result()
            check(res.store == expect[0], "service: decode diverged before the fault")
        compiled = res.executable.compiled
        compiled._refill = False
        try:
            stale = svc.submit(prog, options, tenant=tenant, store=other).result().store
        finally:
            del compiled._refill
        check(stale != want, "service: a replay without its store read as bit-equal")
        fresh = svc.submit(prog, options, tenant=tenant, store=other).result().store
        check(fresh == want, "service: the replay after the planted fault diverged")
        stats = svc.stats()
    emit(
        "service planted fault (replay without loading the store): diverged, "
        "caught; " + json.dumps(
            {k: stats[k] for k in ("captures", "replays", "eager_sweeps",
                                   "bucket_hits", "bucket_misses", "completed")}
        )
    )


# ---------------------------------------------------------------------- #
# Phase 3c: calibration on the card
# ---------------------------------------------------------------------- #

CALIBRATION_WARM_RUNS = 5  # warm runs a forced strategy, in turns


def _auction(prog, backend="torch"):
    """The unforced auction of a fresh artifact on the card: (strategy,
    offers, structural key) of the program's one recurrence."""

    from repro_torch.compile import clear_compile_cache
    from repro_torch.core import plan

    clear_compile_cache()
    exe = plan(prog, method="isd").compile(backend, device="cuda")
    (rec,) = exe.report().summary()["scc"]["recurrences"]
    return rec["strategy"], rec["offers"], exe.compiled.key


def calibration_phase(torch, smi):
    """``repro_torch.calibrate.measure(device="cuda")`` into a temporary
    directory; a fresh ``warm()`` reloads it with no measurement, and so
    does a ``PlanService(warm_profile=True)``.  For the wide 40×96 and
    96×192 recurrences and the 64×16 one: the unforced auction under the
    hand-set and the measured units (the structural key and the offer set
    must not change), and each forced strategy captured and timed warm, in
    turns, every store bit-equal."""

    import tempfile

    import repro_torch.calibrate as calibrate
    from repro_torch import obs
    from repro_torch.core import plan, run_sequential
    from repro_torch.obs import metrics
    from repro_torch.serve import PlanService, ServiceOptions

    saved = {k: os.environ.get(k) for k in ("REPRO_CALIBRATE_DIR", "REPRO_CALIBRATE")}
    with tempfile.TemporaryDirectory() as profile_dir:
        os.environ["REPRO_CALIBRATE_DIR"] = profile_dir
        os.environ.pop("REPRO_CALIBRATE", None)
        try:
            obs.reset_all()
            t0 = time.perf_counter()
            prof = calibrate.measure(device="cuda")
            measure_s = time.perf_counter() - t0
            meta = prof.meta
            check(prof.source == "measured" and calibrate.profile_path().exists(),
                  "calibration: measure() persisted no profile")
            check(meta["device"] == torch.cuda.get_device_name(0),
                  f"calibration: the profile names {meta['device']!r}, not the card")
            check(all(v > 0 for v in prof.units.values()), f"calibration: units {prof.units}")
            emit("calibration: " + json.dumps({
                "units_us": prof.units,
                "step_over_lane": prof.units["xla_step"] / prof.units["xla_lane"],
                "per_level_us": meta["xla_per_level_us"],
                "lane_slope_us": meta["xla_lane_slope_us"],
                "lane_slope_resolved": meta["lane_slope_resolved"],
                "wavefront_per_group_us": meta["wavefront_per_group_us"],
                "spmd": meta["spmd_delta_us"],
                "n": meta["n"], "widths": meta["widths"], "repeats": meta["repeats"],
                "timed": meta["timed"],
                "measurements": metrics.counter("calibrate.measurements").value,
                "measure_s": measure_s,
                "card": smi,
            }))

            # a fresh process state: warm() reloads, nothing is measured
            obs.reset_all()
            again = calibrate.warm()
            loads = metrics.counter("calibrate.loads").value
            check(again.source == "persisted" and again.units == prof.units,
                  f"calibration: warm() gave a {again.source} profile")
            check(metrics.counter("calibrate.measurements").value == 0 and loads == 1,
                  f"calibration: warm() measured or loaded {loads} times")
            calibrate.reset()
            with PlanService(ServiceOptions(warm_profile=True, device="cuda", workers=1)):
                check(calibrate.active_profile().source == "persisted"
                      and metrics.counter("calibrate.measurements").value == 0,
                      "calibration: PlanService(warm_profile=True) measured again")
            emit("calibration: warm() and PlanService(warm_profile=True) reloaded "
                 f"the profile, 0 measurements, {metrics.counter('calibrate.loads').value} loads")

            cells = [
                ("wide_40x96", _wide(40, 96)),
                ("wide_96x192", _wide(96, 192)),
                ("skew_recurrence_64x16", _skew(64, 16)),
            ]
            for name, prog in cells:
                os.environ["REPRO_CALIBRATE"] = "off"
                hand, hand_offers, hand_key = _auction(prog)
                del os.environ["REPRO_CALIBRATE"]
                picked, offers, key = _auction(prog)
                check(key == hand_key, f"calibration: {name}'s structural key moved with the profile")
                check(set(offers) == set(hand_offers),
                      f"calibration: {name}'s offer set moved with the profile")
                init = prog.initial_store()
                expect = run_sequential(prog, init)
                exes = {
                    s: plan(prog, method="isd").compile("torch", device="cuda", scc_policy=s)
                    for s in ("chunk", "skew")
                }
                levels = {}
                for s, exe in exes.items():
                    for _ in range(2):  # eager, then captured
                        check(exe.run(store=init) == expect, f"calibration: {name} {s} diverged")
                    levels[s] = next(reversed(exe.compiled._cases.values())).n_levels
                host = {s: [] for s in exes}
                events = {s: [] for s in exes}
                for turn in range(CALIBRATION_WARM_RUNS):
                    order = ("chunk", "skew") if turn % 2 == 0 else ("skew", "chunk")
                    for s in order:
                        out, host_ms, event_ms = _timed_run(torch, exes[s], init)
                        check(out == expect, f"calibration: {name} {s} warm run diverged")
                        host[s].append(host_ms)
                        events[s].append(event_ms)
                warm = {s: statistics.median(v) for s, v in host.items()}
                faster = min(warm, key=warm.get)
                profiled = {}
                for s, exe in exes.items():
                    busy_ms, wall_ms, n_events = _profiled_run(
                        torch, lambda exe=exe: exe.run(store=init)
                    )
                    profiled[s] = {"busy_ms": busy_ms, "wall_ms": wall_ms,
                                   "device_events": n_events}
                emit("calibration auction: " + json.dumps({
                    "cell": name,
                    "hand_set": {"strategy": hand, "offers": hand_offers},
                    "measured": {"strategy": picked, "offers": offers},
                    "levels": levels,
                    "warm_ms_median_host": warm,
                    "warm_ms_median_events": {s: statistics.median(v) for s, v in events.items()},
                    "warm_runs": CALIBRATION_WARM_RUNS,
                    "profiled_run": profiled,
                    "faster": faster,
                    "measured_picked_faster": picked == faster,
                    "hand_set_picked_faster": hand == faster,
                    "bit_equal": True,
                    "card": smi,
                }))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            obs.reset_all()


# ---------------------------------------------------------------------- #
# Phase 3d: the SPMD level loop ("torch_spmd")
# ---------------------------------------------------------------------- #

SPMD_WORLDS = (2, 4)  # gloo processes on the host CPU
SPMD_TIMEOUT_S = 300  # per spawn; its children are killed on it
# phase 3e: PipelineRunner on the card, 4 stages of tanh(x @ W) at yi-6b's
# width (d_model 4096), 8 microbatches of 2048 rows in bf16, without skips
# and with PP_SKIPS; then build_pipeline_step in gloo worlds on the host CPU
# (f32, 8 rows a microbatch), without skips and with every forward pair of
# stages as a skip (1 in a world of 2, 6 in a world of 4).  The last rank's
# outputs against the plain stage chain in the parent within PP_GLOO_TOL
# (the ranks run one CPU thread, the parent several)
PP_STAGES = 4
PP_MICROBATCHES = 8
PP_ROWS = 2048
PP_D = 4096
PP_SKIPS = ((0, 2), (0, 3), (1, 3))
PP_GLOO_ROWS = 8
PP_WORLDS = {
    2: ((), ((0, 1),)),
    4: ((), ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))),
}
PP_GLOO_TOL = 1e-5


def _spmd_runs():
    """(label, program, plan knobs, compile knobs) of phase 3d's gloo runs:
    phase 3's small corpus under every method (``inspect`` and
    ``speculate`` for the non-affine ones) and the 64×16 recurrence."""

    small, _ = corpus()
    runs = []
    for name, prog, modes in small:
        for deps in modes:
            for method in ("none", "isd", "pattern", "both"):
                runs.append((f"{name}/{method}/deps={deps}", prog,
                             {"method": method, "deps": deps}, {}))
    runs.append(("skew_recurrence_64x16_chunk", _skew(64, 16), {"method": "isd"},
                 {"scc_policy": "chunk"}))
    runs.append(("skew_recurrence_64x16", _skew(64, 16), {"method": "isd"}, {}))
    return runs


def _spmd_worker(rank, world, init_file, stores, results):
    """One gloo rank of phase 3d (b): every run of ``_spmd_runs`` on the
    CPU, on the stores the parent built (``initial_store()`` hashes
    differently in each process, and every rank must hold the same one)."""

    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        import torch
        import torch.distributed as dist

        from repro_torch.compile import device_scope
        from repro_torch.core import plan
        from repro_torch.core.wavefront import _DenseStore
        from repro_torch.obs import metrics

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            rows = []
            t0 = time.perf_counter()
            for (label, prog, plan_knobs, knobs), init in zip(_spmd_runs(), stores):
                before = metrics.counter("spmd.collectives").value
                exe = plan(prog, **plan_knobs).compile("torch_spmd", device="cpu", **knobs)
                t_run = time.perf_counter()
                store = exe.run(store=init)
                run_ms = (time.perf_counter() - t_run) * 1e3
                with device_scope("cpu"):
                    case, _ = exe.compiled.prepare(prog, _DenseStore(init))
                stmts = case.static.stmts
                rows.append({
                    "label": label, "store": store, "shards": case.static.n_shards,
                    "issued": metrics.counter("spmd.collectives").value - before,
                    "expected": (None if plan_knobs.get("deps") == "speculate"
                                 else sum(1 for k, _, _ in case._steps if stmts[k].reads)),
                    "run_ms": run_ms,
                })
            results.put((rank, "ok", {"rows": rows, "wall_s": time.perf_counter() - t0}))
        finally:
            dist.destroy_process_group()
    except BaseException:
        import traceback

        results.put((rank, "error", traceback.format_exc()))


def _start_gloo(world, payload, workdir, worker=None, timeout=None):
    """Start ``worker`` (``_spmd_worker`` by default) on ``world`` spawned
    processes, each given ``payload``; :func:`_collect_gloo` waits for
    them, until ``timeout`` seconds (``SPMD_TIMEOUT_S``) from now."""

    import multiprocessing

    worker = worker or _spmd_worker
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = str(Path(workdir) / f"store_{worker.__name__}_{world}")
    procs = [
        ctx.Process(target=worker, daemon=True, args=(r, world, store, payload, results))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    return world, procs, results, time.monotonic() + (timeout or SPMD_TIMEOUT_S)


def _collect_gloo(started, label):
    """Each rank's result of a :func:`_start_gloo` run; every wait is
    bounded by the run's deadline, and the children are killed on it."""

    import queue

    world, procs, results, deadline = started
    got = {}
    try:
        while len(got) < world:
            remaining = deadline - time.monotonic()
            try:  # past the deadline, only what has already come
                rank, status, result = results.get(timeout=min(max(remaining, 0.1), 5.0))
            except queue.Empty:
                if remaining <= 0 or not any(p.is_alive() for p in procs):
                    break
                continue
            check(status == "ok", f"{label} gloo rank {rank} of {world} failed:\n{result}")
            got[rank] = result
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        _stop(procs)
    check(sorted(got) == list(range(world)),
          f"{label} gloo: ranks {sorted(set(range(world)) - set(got))} of {world} "
          f"gave no result in time (killed)")
    return got


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


def _spawn_gloo(world, payload, workdir, worker=None, label="torch_spmd"):
    """Run ``worker`` (``_spmd_worker`` by default) on ``world`` spawned
    processes, each given ``payload``; every wait is bounded by
    ``SPMD_TIMEOUT_S`` and the children are killed on it."""

    return _collect_gloo(_start_gloo(world, payload, workdir, worker), label)


def spmd_phase(torch, smi):
    """(a) ``"torch_spmd"`` in a world-size-1 NCCL group on the card: Alg. 6
    at 1025 and both wide cells bit-equal, one shard, no collective, the
    same captures and launch list as ``"torch"`` (the profiler's device
    events printed beside), warm ms beside ``"torch"``'s in turns.  (b) 2
    and 4 gloo processes on the host's CPU: phase 3's small corpus and the
    64×16 recurrence bit-equal
    on every rank, one all-gather per read-bearing group step.  (c) The
    auction at a forced 8 devices: the wide recurrence skews, the narrow
    one chunks."""

    import tempfile

    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.compile import spmd
    from repro_torch.core import paper_alg6, plan, run_sequential
    from repro_torch.obs import metrics

    obs.reset_all()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            for name, prog in (("paper_alg6_1025", paper_alg6(1025)),
                               ("wide_40x96", _wide(40, 96)),
                               ("wide_96x192", _wide(96, 192))):
                init = prog.initial_store()
                expect = run_sequential(prog, init)
                exes = {b: plan(prog, method="isd").compile(b, device="cuda")
                        for b in ("torch", "torch_spmd")}
                sweeps, cases, events = {}, {}, {}
                for b, exe in exes.items():
                    before = graph_counts()
                    for _ in range(3):  # eager, captured, replayed
                        check(exe.run(store=init) == expect, f"torch_spmd (a): {name} {b} diverged")
                    sweeps[b] = count_delta(before)
                    cases[b] = next(reversed(exe.compiled._cases.values()))
                    _, _, events[b] = _profiled_run(torch, lambda: exe.run(store=init))
                check(sweeps["torch_spmd"] == sweeps["torch"]
                      == {"captures": 1, "replays": 2, "eager_sweeps": 1},
                      f"torch_spmd (a): {name} sweeps {sweeps}")
                check(cases["torch_spmd"].static.n_shards == 1, f"torch_spmd (a): {name} sharded")
                check(cases["torch_spmd"]._steps == cases["torch"]._steps,
                      f"torch_spmd (a): {name}'s launch list differs from torch's")
                host = {b: [] for b in exes}
                for turn in range(WARM_RUNS):
                    for b in (("torch", "torch_spmd") if turn % 2 == 0 else ("torch_spmd", "torch")):
                        out, host_ms, _ = _timed_run(torch, exes[b], init)
                        check(out == expect, f"torch_spmd (a): {name} {b} warm run diverged")
                        host[b].append(host_ms)
                emit("torch_spmd (a) nccl world 1: " + json.dumps({
                    "cell": name, "n_shards": 1, "sweeps": sweeps["torch_spmd"],
                    "group_steps": len(cases["torch"]._steps),
                    # printed, not held equal: the same graph read 147460 /
                    # 147458 events at 96×192 (the profiler's loss, PERF.md)
                    "device_events_profiled": events,
                    "warm_ms_median_host": {b: statistics.median(v) for b, v in host.items()},
                    "warm_runs": WARM_RUNS, "bit_equal": True, "card": smi,
                }))
            check(metrics.counter("spmd.collectives").value == 0,
                  "torch_spmd (a): a world of one issued a collective")
        finally:
            dist.destroy_process_group()
        _spmd_gloo(d)
    _spmd_auction()
    obs.reset_all()


def _spmd_gloo(workdir):
    """Phase 3d (b): the gloo worlds on the host CPU."""

    from repro_torch.core import run_sequential

    runs = _spmd_runs()
    stores = [prog.initial_store() for _, prog, _, _ in runs]
    expect = [run_sequential(prog, s) for (_, prog, _, _), s in zip(runs, stores)]
    for world in SPMD_WORLDS:
        t0 = time.perf_counter()
        got = _spawn_gloo(world, stores, workdir)
        spawn_s = time.perf_counter() - t0
        issued = None
        for rank, payload in sorted(got.items()):
            rows = payload["rows"]
            check([r["label"] for r in rows] == [r[0] for r in runs],
                  f"torch_spmd (b): rank {rank} ran other runs")
            for row, want in zip(rows, expect):
                check(row["store"] == want,
                      f"torch_spmd (b): {row['label']} diverged on rank {rank} of {world}")
                check(row["shards"] == world, f"torch_spmd (b): {row['label']} shards")
                check(row["expected"] is None or row["issued"] == row["expected"],
                      f"torch_spmd (b): {row['label']} issued {row['issued']} "
                      f"all-gathers, expected {row['expected']}")
            counts = [r["issued"] for r in rows]
            check(issued is None or counts == issued,
                  "torch_spmd (b): ranks issued different collectives")
            issued = counts
        rows0 = got[0]["rows"]
        emit(f"torch_spmd (b) gloo world {world}, host CPU: " + json.dumps({
            "runs": len(rows0), "bit_equal_on_every_rank": True,
            "all_gathers_rank0": sum(issued),
            "skew_recurrence_64x16_run_ms_host_cpu": {
                r["label"]: r["run_ms"] for r in rows0 if r["label"].startswith("skew_recurrence")
            },
            "rank_wall_s_host_cpu": {r: p["wall_s"] for r, p in sorted(got.items())},
            "spawn_s_host_cpu": spawn_s,
        }))


def _spmd_auction():
    """Phase 3d (c): the auction at a forced 8 devices."""

    from repro_torch.compile import spmd

    spmd.force_device_count(8)
    try:
        wide, wide_offers, _ = _auction(_wide(40, 96), "torch_spmd")
        narrow_prog = _narrow(32)
        narrow, narrow_offers, _ = _auction(narrow_prog, "torch_spmd")
    finally:
        spmd.force_device_count(None)
    check(wide == "skew" and narrow == "chunk",
          f"torch_spmd (c): at 8 devices the wide recurrence took {wide}, the narrow {narrow}")
    emit("torch_spmd (c) auction at a forced 8 devices: " + json.dumps({
        "wide_40x96": {"strategy": wide, "offers": wide_offers},
        "narrow_32": {"strategy": narrow, "offers": narrow_offers},
    }))


# ---------------------------------------------------------------------- #
# Phase 3e: the pipeline runner and the pipeline-parallel step
# ---------------------------------------------------------------------- #

def _pp_stage(torch, w):
    """One stage of ``tanh(x @ W)``; a stage that takes skip inputs adds
    them to its chain input first, in the order they come."""

    def fn(x):
        if isinstance(x, tuple):
            x, *skip_in = x
            extra = torch.zeros_like(x)
            for v in skip_in:
                extra = extra + v
            x = x + extra
        return torch.tanh(x @ w)

    return fn


def _pp_weight(torch, s):
    """Stage ``s``'s (d, d) f32 weights of the gloo pipeline step, drawn on
    the CPU from its own seed: each rank builds its own, the parent all."""

    gen = torch.Generator().manual_seed(SEED + 1 + s)
    return torch.randn((PP_D, PP_D), generator=gen) / math.sqrt(PP_D)


def _pp_inputs(torch):
    gen = torch.Generator().manual_seed(SEED)
    return torch.randn((PP_MICROBATCHES, PP_GLOO_ROWS, PP_D), generator=gen)


def _pp_worker(rank, world, init_file, skip_sets, results):
    """One gloo rank of phase 3e: one stage of ``build_pipeline_step`` for
    each skip set, its accumulator (the last rank's, as NumPy: a tensor
    would cross by a shared-memory handle that dies with this process),
    the hand-offs it counted and its plan's eliminated edges."""

    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        import torch
        import torch.distributed as dist

        from repro_torch.obs import metrics
        from repro_torch.runtime.pp_lowering import HANDOFFS, build_pipeline_step

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            w, xs = _pp_weight(torch, rank), _pp_inputs(torch)
            rows = []
            for skips in skip_sets:
                before = metrics.counter(HANDOFFS).value
                step, plan = build_pipeline_step(PP_MICROBATCHES, PP_D, skips, device="cpu")
                t0 = time.perf_counter()
                acc = step(w, xs)
                rows.append({
                    "skips": skips,
                    "acc": acc.numpy() if rank == world - 1 else None,
                    "acc_nonzero": bool(acc.any()),
                    "handoffs": metrics.counter(HANDOFFS).value - before,
                    "eliminated": sorted((d.source, d.sink) for d in plan.elimination.eliminated),
                    "naive_sync": plan.summary()["naive_sync_instructions"],
                    "optimized_sync": plan.summary()["optimized_sync_instructions"],
                    "step_ms": (time.perf_counter() - t0) * 1e3,
                })
            results.put((rank, "ok", rows))
        finally:
            dist.destroy_process_group()
    except BaseException:
        import traceback

        results.put((rank, "error", traceback.format_exc()))


def pipeline_phase(torch, smi):
    """Phase 3e: (a) ``PipelineRunner`` (one thread a stage) with 4 stages
    of ``tanh(x @ W)`` at yi-6b's width on CUDA tensors, without and with
    skips, bit-equal to ``run_reference`` with (S-1) x M hand-offs; (b) the
    pipeline step (``build_pipeline_step``, one rank a stage) in gloo worlds
    of 2 and 4 on the host CPU, with no skip and with every forward pair of
    stages as a skip: the last rank's accumulator against the plain stage
    chain, one hand-off a microbatch step on every rank."""

    import tempfile

    from repro_torch.runtime.pipeline import PipelineRunner

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    weights = [draw(PP_D, PP_D) / math.sqrt(PP_D) for _ in range(PP_STAGES)]
    inputs = [draw(PP_ROWS, PP_D) for _ in range(PP_MICROBATCHES)]
    stages = [_pp_stage(torch, w) for w in weights]
    for skips in ((), PP_SKIPS):
        runner = PipelineRunner(stages, skips=skips, num_microbatches=PP_MICROBATCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, stats = runner.run(inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = runner.run_reference(inputs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        differ = sum(int((a != b).sum()) for a, b in zip(outs, ref))
        check(differ == 0, f"pipeline runner (cuda, skips {skips}): {differ} values differ "
                           "from run_reference")
        expect = (PP_STAGES - 1) * PP_MICROBATCHES
        check(stats.handoffs == expect,
              f"pipeline runner (cuda, skips {skips}): {stats.handoffs} hand-offs, expected {expect}")
        emit("pipeline runner (cuda): " + json.dumps({
            "stages": PP_STAGES, "microbatches": PP_MICROBATCHES, "rows": PP_ROWS, "d": PP_D,
            "dtype": "bf16", "skips": skips, "handoffs": stats.handoffs,
            "naive_handoffs_per_microbatch": runner.naive_handoffs_per_microbatch(),
            "eliminated": sorted((d.source, d.sink) for d in runner.plan.elimination.eliminated),
            "bit_equal_to_run_reference": True,
            "runner_ms_host": (t1 - t0) * 1e3, "run_reference_ms_host": (t2 - t1) * 1e3,
            "card": smi,
        }))

    xs = _pp_inputs(torch)
    with tempfile.TemporaryDirectory() as d:
        for world, skip_sets in PP_WORLDS.items():
            w = [_pp_weight(torch, s) for s in range(world)]
            t0 = time.perf_counter()
            got = _spawn_gloo(world, skip_sets, d, worker=_pp_worker, label="pipeline step")
            spawn_s = time.perf_counter() - t0
            for i, skips in enumerate(skip_sets):
                rows = [got[r][i] for r in range(world)]
                plain = PipelineRunner([_pp_stage(torch, ws) for ws in w], skips=skips,
                                       num_microbatches=1)
                want = torch.zeros_like(xs)
                # one thread, as each rank runs: a CPU product on several
                # threads sums K in another order, which moved this check by
                # 8e-5 to 9e-5 on some hosts
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                try:
                    for m in range(world - 1, PP_MICROBATCHES):
                        (want[m],) = plain.run_reference([xs[m - (world - 1)]])
                finally:
                    torch.set_num_threads(threads)
                err = (torch.from_numpy(rows[-1]["acc"]) - want).abs().max().item()
                check(err <= PP_GLOO_TOL, f"pipeline step (gloo {world}, skips {skips}): the last "
                                          f"stage's outputs differ from the plain chain by {err}")
                check(all(r["handoffs"] == PP_MICROBATCHES for r in rows),
                      f"pipeline step (gloo {world}, skips {skips}): hand-offs "
                      f"{[r['handoffs'] for r in rows]}, expected {PP_MICROBATCHES} on every rank")
                check(not any(r["acc_nonzero"] for r in rows[:-1]),
                      f"pipeline step (gloo {world}): a stage before the last wrote its outputs")
                skipped = {(f"F{a}", f"F{b}") for a, b in skips if b > a + 1}
                check(skipped <= set(map(tuple, rows[0]["eliminated"])),
                      f"pipeline step (gloo {world}): skips {skipped} not all eliminated")
                emit(f"pipeline step gloo world {world}, host CPU: " + json.dumps({
                    "microbatches": PP_MICROBATCHES, "rows": PP_GLOO_ROWS, "d": PP_D,
                    "dtype": "f32", "skips": skips,
                    "handoffs_per_rank": [r["handoffs"] for r in rows],
                    "payload_slabs_per_handoff": 1 + len(skips),
                    "naive_sync": rows[0]["naive_sync"],
                    "optimized_sync": rows[0]["optimized_sync"],
                    "eliminated": rows[0]["eliminated"],
                    "last_stage_max_abs_err": err, "tol": PP_GLOO_TOL,
                    "step_ms_host_cpu": [r["step_ms"] for r in rows],
                    "spawn_s_host_cpu": spawn_s,
                }))
    emit(f"pipeline phase: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------- #
# Phase 4: the K-loop plan
# ---------------------------------------------------------------------- #

def kloop_phase():
    from repro_torch.core import PlanOptions, plan, run_sequential
    from repro_torch.kernels.pipelined_matmul import schedule
    from repro_torch.kernels.pipelined_matmul.ops import (
        HOPPER_PROCESSORS,
        hopper_plan,
        hopper_schedule,
    )

    for depth in (1, 2):
        p = schedule.plan_pipeline(depth)
        emit(
            "kloop plan: "
            + json.dumps(
                {
                    "depth": depth,
                    "retained": [d.pretty() for d in p.retained],
                    "waits_per_step": p.waits_per_step,
                    "credit_wait_needed": p.credit_wait_needed,
                    "overlapped_levels": schedule.overlapped_levels(p.wavefront),
                }
            )
        )
        first, _ = schedule.compile_kloop(depth, 16, device="cuda")
        again, hit = schedule.compile_kloop(depth, 128, device="cuda")
        check(hit and again is first, f"kloop depth {depth}: no structural hit across steps")
        for steps in (16, 128):
            prog = schedule.make_kloop_program(steps)
            sp = plan(
                prog,
                PlanOptions(
                    method="isd",
                    deps=tuple(schedule.kloop_dependences(depth)),
                    model="procmap",
                    processors=schedule.PROCESSORS,
                ),
            )
            init = prog.initial_store()
            out = sp.compile("torch", device="cuda").run(store=init)
            check(
                out == run_sequential(prog, init),
                f"kloop depth {depth} steps {steps}: diverged on cuda",
            )
    emit("kloop compile: bit-equal on cuda at steps 16 and 128, structural hit across steps")

    # the TMA kernels' plan: ISSUE and LOAD on the producer warpgroup,
    # COMPUTE on the consumers; its retained dependences are their mbarriers
    for depth in sorted(set(MATMUL_DEPTHS) | set(TF32X3_DEPTHS)):
        res = hopper_plan(depth)
        hs = hopper_schedule(depth)
        check(
            hs.full and hs.empty,
            f"hopper plan depth {depth}: waits {hs.waits}, expected full and empty",
        )
        emit(
            "hopper kloop plan: "
            + json.dumps(
                {
                    "depth": depth,
                    "processors": HOPPER_PROCESSORS,
                    "retained": [d.pretty() for d in res.retained],
                    "eliminated": [d.pretty() for d in res.eliminated],
                    "kernel_mbarriers": list(hs.waits),
                }
            )
        )


# ---------------------------------------------------------------------- #
# Phase 5: the matmul kernel
# ---------------------------------------------------------------------- #

def _time_ms(torch, fn, reps):
    """Median of ``reps`` launches, each between its own CUDA events, after
    two warm-up calls."""

    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _time_back_to_back_ms(torch, fn, reps):
    """Device time of one launch in a run of ``reps`` launches between one
    pair of CUDA events, after two warm-up calls: the host's launch path
    overlaps the device's work, so a short kernel is not timed as its
    launch overhead."""

    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _time_turns_ms(torch, fns, reps):
    """Median of ``reps`` launches of each of ``fns``, taken in turns (one
    launch of each per round, each between its own CUDA events), after two
    warm-up rounds: two kernels compared within one call, on one card."""

    for _ in range(2):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, t in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def expected_route(dt, K, N):
    """The route rule, written out independently of ``ops.route``: every
    bf16 call on the TMA / wgmma product, every f32 call on the 3xTF32
    one, whatever K and N are."""

    return "tma_wgmma_tf32x3" if dt == "f32" else "tma_wgmma"


def expected_stage(dt, K, N):
    """bf16 stage launches of a call, written out independently of
    ``ops.staging``: one where K or N is not a multiple of 8 (the operands
    here are fresh allocations, so 16-byte aligned)."""

    return int(dt == "bf16" and (K % 8 != 0 or N % 8 != 0))


def limit_ratio(out, ref, K, tol=TOL["f32"]):
    """The largest error of ``out`` as a share of the limit ``tol sqrt(K) +
    tol |ref|`` (above 1: outside it)."""

    err = (out.double() - ref.double()).abs()
    return (err / (tol * math.sqrt(K) + tol * ref.double().abs())).max().item()


def bits21(x):
    """x with 21 significant bits: its 3xTF32 split is exact."""

    import torch

    return (x.view(torch.int32) & ~0x7).view(torch.float32)


def tf32_accumulator_rounding(torch, ops):
    """How the tensor core rounds its f32 accumulator between two TF32
    wgmma of one run, read through the 3xTF32 product with lo = 0: row i
    holds s_i at k = 0 and t_i ulp(1) at k = 8 (two hi.hi wgmma, both
    exact products), so the output is s_i + t_i ulp(1) rounded once.  The
    rows where rounding to nearest and toward zero differ say which it
    is."""

    import numpy as np

    cases = [(s, t) for s in (1.0, -1.0)
             for t in (0.0625, 0.25, 0.75, 1.25, 1.75, -0.0625, -0.375, -0.875)]
    M, N, K = 64, 128, 16
    a = torch.zeros(M, K)
    for i, (s_i, t_i) in enumerate(cases):
        a[i, 0], a[i, 8] = s_i, t_i * 2.0**-11
    bt = torch.zeros(N, K)
    bt[:, 0], bt[:, 8] = 1.0, 2.0**-12
    a, bt = a.cuda(), bt.cuda()
    zero_a, zero_b = torch.zeros_like(a), torch.zeros_like(bt)
    out = torch.empty(M, N, device="cuda")
    ops._launch_tf32x3(a, zero_a, bt, zero_b, out, ops.tf32x3_schedule())
    got = out[: len(cases)].cpu().numpy()
    exact = np.array([s_i + t_i * 2.0**-23 for s_i, t_i in cases])
    nearest = exact.astype(np.float32)
    zero = nearest.copy()
    over = np.abs(zero.astype(np.float64)) > np.abs(exact)
    zero[over] = np.nextafter(zero[over], np.float32(0))
    tells = nearest != zero
    rows_same = bool((got == got[:, :1]).all())
    as_nearest = int((got[tells, 0] == nearest[tells]).sum())
    as_zero = int((got[tells, 0] == zero[tells]).sum())
    n = int(tells.sum())
    ulp = 2.0**-23
    return {
        # (s, t, the output's offset from s in ulp(1), nearest's, zero's)
        "rows": [(s_i, t_i, float((g - s_i) / ulp), float((r - s_i) / ulp),
                  float((z - s_i) / ulp))
                 for (s_i, t_i), g, r, z, tell
                 in zip(cases, got[:, 0].astype(np.float64), nearest, zero, tells) if tell],
        "rows_telling": n,
        "as_round_to_nearest": as_nearest,
        "as_round_toward_zero": as_zero,
        "reading": ("round to nearest" if as_nearest == n else
                    "round toward zero" if as_zero == n else "neither"),
        "columns_agree": rows_same,
    }


def matmul_configs():
    """(M, K, N, dtype, depth) of the main run: every shape in both types at
    the depths of the route the rule gives it."""

    return [
        (M, K, N, dt, depth)
        for (M, K, N) in MATMUL_SHAPES
        for dt in ("bf16", "f32")
        for depth in (
            TF32X3_DEPTHS if expected_route(dt, K, N) == "tma_wgmma_tf32x3"
            else MATMUL_DEPTHS
        )
    ]


def default_depth(route):
    """The ring depth a matmul route takes when none is asked for."""

    from repro_torch.kernels.pipelined_matmul import ops

    return ops._schedule(route, None).depth


def _identity_probes(torch, ops, operands):
    """I @ B == B and A @ I == A exactly, on both routes: at yi-6b's widths
    (aligned) and at the LM head, where B is restaged (bf16) and N is odd;
    there A @ I takes the (K, N) identity, ones on the diagonal, so the
    product is A beside zero columns.  A descriptor, swizzle, stage, split,
    promotion or epilogue mistake shows position by position; the f32
    operands have 21 significant bits, so hi + lo is exact."""

    for dt, tdt, route, cast in (("bf16", torch.bfloat16, "tma_wgmma", lambda x: x),
                                 ("f32", torch.float32, "tma_wgmma_tf32x3", bits21)):
        for M, K, N in ((2048, 4096, 11008), LM_HEAD):
            a, b = (cast(t) for t in operands[(M, K, N, dt)])
            eye = torch.eye(K, device="cuda", dtype=tdt)
            wide = torch.eye(K, N, device="cuda", dtype=tdt)
            check(ops.route(tdt, K, N, eye.data_ptr(), b.data_ptr()) == route, f"{dt} probe off {route}")
            before = dict(ops.matmul.routes)
            check(torch.equal(ops.matmul(eye, b), b), f"matmul: I @ B differs from B on {route} at {N}")
            got = ops.matmul(a, wide)
            check(torch.equal(got[:, :K], a) and not bool(got[:, K:].any()),
                  f"matmul: A @ I differs from A on {route} at {N}")
            check(ops.matmul.routes[route] == before[route] + 2, f"{dt} probes at {N}: not on {route}")
            del eye, wide, got
            emit(f"matmul identity probes ({dt}, {route} route, K {K}, N {N}): "
                 "I @ B == B and A @ I == A exactly")
        del a, b


def _planted_stage(torch, ops, a, b):
    """The bf16 route with its stage at fault: one row of the restaged B
    shifted left by one element.  Its error as a share of the bf16 limit
    against the plain version, which must read above 1."""

    from repro_torch.kernels.pipelined_matmul.ref import matmul_ref

    M, K = a.shape
    N = b.shape[1]
    st = ops.staging(a.dtype, M, K, N, a.data_ptr(), b.data_ptr())
    check(st.b, "planted stage: B is not restaged")
    sa, sb = ops.stage_bf16(a, b, st)
    row = K // 2
    sb[row, :N - 1] = sb[row, 1:N].clone()
    out = torch.empty(M, N, dtype=a.dtype, device="cuda")
    ops._launch_tma(sa, sb, out, ops.hopper_schedule(ops.HOPPER_STAGES))
    ratio = limit_ratio(out, matmul_ref(a, b), K, TOL["bf16"])
    check(ratio > 1, f"planted stage (row {row} of B shifted by one): {ratio} of the limit: "
          "the check cannot see it")
    return ratio


def _parts_ms(torch, ops, a, b, depth, reps):
    """The route's launches each alone, back to back on its own operands:
    the bf16 stage (where the call restages) and product, or the two
    splits and the product."""

    M, K = a.shape
    N = b.shape[1]
    out = torch.empty(M, N, dtype=a.dtype, device="cuda")
    st = ops.staging(a.dtype, M, K, N, a.data_ptr(), b.data_ptr())
    if a.dtype == torch.bfloat16:
        staged = ops.stage_bf16(a, b, st)
        sched = ops.hopper_schedule(depth)
        parts = {"product_ms": _time_back_to_back_ms(
            torch, lambda: ops._launch_tma(*staged, out, sched), reps)}
        if st.launches:
            parts["stage_ms"] = _time_back_to_back_ms(torch, lambda: ops.stage_bf16(a, b, st), reps)
        return parts
    halves = (*ops.split_tf32(a), *ops.split_tf32(b, transpose=True))
    sched = ops.tf32x3_schedule(depth)
    return {
        "product_ms": _time_back_to_back_ms(
            torch, lambda: ops._launch_tf32x3(*halves, out, sched, K), reps),
        "split_a_ms": _time_back_to_back_ms(torch, lambda: ops.split_tf32(a), reps),
        "split_bt_ms": _time_back_to_back_ms(
            torch, lambda: ops.split_tf32(b, transpose=True), reps),
    }


def _staging_bytes(dt, M, K, N):
    """Bytes the route's staging must move (each restaged element read once,
    each padded element written once): the bf16 stage's, or the splits'
    (4 read, 2 x 4 written at the padded width)."""

    if dt == "bf16":
        st_a, st_b = K % 8 != 0, N % 8 != 0
        kp, np_ = -(-K // 8) * 8, -(-N // 8) * 8
        return 2 * (st_a * M * (K + kp) + st_b * K * (N + np_))
    kp = -(-K // 4) * 4
    return 4 * (M * K + K * N) + 8 * (M + N) * kp


def matmul_phase(torch):
    from repro_torch.kernels import _build
    from repro_torch.kernels.pipelined_matmul import ops
    from repro_torch.kernels.pipelined_matmul.ref import matmul_ref, split_tf32_ref, stage_ref

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    operands = {}
    for M, K, N in MATMUL_SHAPES:
        a = torch.randn(M, K, device="cuda", generator=gen)
        b = torch.randn(K, N, device="cuda", generator=gen)
        for dt, tdt in dtypes.items():
            operands[(M, K, N, dt)] = (a.to(tdt), b.to(tdt))
    configs = matmul_configs()

    # the main path: every count set to 0 just before, read just after
    ops.matmul.launches = 0
    ops.matmul.routes = dict.fromkeys(ops.matmul.routes, 0)
    ops.split_tf32.launches = 0
    ops.stage_bf16.launches = 0
    launches, routes, errors, outs = {}, {}, {}, {}
    for cfg in configs:
        M, K, N, dt, depth = cfg
        a, b = operands[(M, K, N, dt)]
        before, before_routes = ops.matmul.launches, dict(ops.matmul.routes)
        out = ops.matmul(a, b, depth=depth)
        launches[cfg] = ops.matmul.launches - before
        took = [r for r, n in ops.matmul.routes.items() if n != before_routes[r]]
        routes[cfg] = took[0] if len(took) == 1 else took
        torch.cuda.synchronize()
        ref = matmul_ref(a, b)
        errors[cfg] = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(
            out.float(), ref.float(), atol=TOL[dt] * math.sqrt(K), rtol=TOL[dt]
        )
        check(ok and out.shape == (M, N), f"matmul {cfg}: outside tolerance (max err {errors[cfg]})")
        check(bool(torch.isfinite(out.float()).all()), f"matmul {cfg}: non-finite output")
        if dt == "f32" and depth == default_depth(routes[cfg]):
            outs[(M, K, N)] = out  # for the f64 check
        del out, ref
    total = ops.matmul.launches
    by_route = dict(ops.matmul.routes)
    splits = ops.split_tf32.launches
    stages = ops.stage_bf16.launches
    check(total == len(configs), f"matmul: {total} launches in the main run, expected {len(configs)}")
    check(all(n == 1 for n in launches.values()), "matmul: a configuration did not launch the kernel")
    for cfg in configs:
        want = expected_route(cfg[3], cfg[1], cfg[2])
        check(routes[cfg] == want, f"matmul {cfg}: took route {routes[cfg]}, expected {want}")
    check(sum(by_route.values()) == total, f"matmul: routes {by_route} do not sum to {total}")
    check(
        splits == 2 * by_route["tma_wgmma_tf32x3"],
        f"matmul: {splits} split launches for {by_route['tma_wgmma_tf32x3']} 3xTF32 products",
    )
    want_stages = sum(expected_stage(dt, K, N) for (M, K, N, dt, depth) in configs)
    check(stages == want_stages, f"matmul: {stages} stage launches, expected {want_stages}")
    emit("matmul routes in the main run: " + json.dumps(by_route)
         + f", split_tf32 launches {splits}, stage_bf16 launches {stages}")

    # f32 against an f64 product: each shape at the default depth, beside
    # torch.matmul (TF32 off) and a planted product of one TF32 term (hi @
    # hi, exact products summed in f32), which must read above the limit
    f64 = {}
    for (M, K, N), out in outs.items():
        a, b = operands[(M, K, N, "f32")]
        ref64 = a.double() @ b.double()
        row = {"route": expected_route("f32", K, N),
               "kernel": limit_ratio(out, ref64, K),
               "kernel_max_abs_err": (out.double() - ref64).abs().max().item(),
               "kernel_vs_plain": limit_ratio(out, matmul_ref(a, b), K)}
        check(row["kernel"] <= 1, f"matmul f32 {(M, K, N)}: {row['kernel']} of the limit against f64")
        lib = torch.matmul(a, b)
        a_hi, _ = split_tf32_ref(a)
        b_hi, _ = split_tf32_ref(b)
        one = torch.matmul(a_hi, b_hi)
        row.update(
            library=limit_ratio(lib, ref64, K),
            library_max_abs_err=(lib.double() - ref64).abs().max().item(),
            planted_one_tf32=limit_ratio(one, ref64, K),
        )
        check(
            row["planted_one_tf32"] > 1,
            f"matmul f32 {(M, K, N)}: the planted one-TF32 product reads "
            f"{row['planted_one_tf32']} of the limit: the check cannot see it",
        )
        del lib, a_hi, b_hi, one, ref64
        f64[(M, K, N)] = row
        emit(f"matmul f32 {M}x{K}x{N} error as a share of the limit 2e-5 sqrt(K) + "
             f"2e-5 |ref| against an f64 product: " + json.dumps(row))
    del outs
    torch.cuda.empty_cache()

    _identity_probes(torch, ops, operands)
    planted = _planted_stage(torch, ops, *operands[(*LM_HEAD, "bf16")])
    emit(f"matmul planted stage (one row of B shifted by one element): {planted} of the bf16 limit")
    torch.cuda.empty_cache()

    ptxas = ptxas_lines(_build.BUILD_LOG.get(Path(TF32X3_SOURCE).name, ""),
                        r"matmul_tf32x3_kernelILi(\d+)ELb(\d)E", "D{} pairs{}")
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    entries = []
    for cfg in configs:
        M, K, N, dt, depth = cfg
        a, b = operands[(M, K, N, dt)]
        flops = 2.0 * M * N * K
        reps = 21 if flops > 1e10 else 101
        kernel = lambda: ops.matmul(a, b, depth=depth)  # noqa: E731
        library = lambda: torch.matmul(a, b)  # noqa: E731
        unaligned = K % 8 != 0 or N % 8 != 0  # operands TMA cannot describe as they lie
        extra = {}
        if flops > 1e10 or unaligned:
            # the route and torch.matmul, single launches in turns
            ms, library_ms = _time_turns_ms(torch, [kernel, library], reps)
            extra["timed_in_turns"] = ["ms", "library_ms"]
            if unaligned or routes[cfg] == "tma_wgmma_tf32x3":
                extra.update(_parts_ms(torch, ops, a, b, depth, reps))
                extra["timed_back_to_back"] = sorted(k for k in extra if k.endswith("_ms"))
        else:
            ms = _time_ms(torch, kernel, reps)
            library_ms = _time_ms(torch, library, reps)
        if unaligned and depth == default_depth(routes[cfg]):
            # the device time alone (L2 flushed) and the host's enqueue time
            # of a call, beside torch.matmul's, in the same rounds
            held = _held_times(torch, {"route": kernel, "library": library},
                               11 if flops > 1e10 else 50, flush)
            extra.update({"device_ms": held["route"]["device_ms"], "host_ms": held["route"]["host_ms"],
                          "library_device_ms": held["library"]["device_ms"],
                          "library_host_ms": held["library"]["host_ms"],
                          "timed_held_cold_l2": ["device_ms", "library_device_ms"]})
        plain_ms = _time_ms(torch, lambda: matmul_ref(a, b), reps)
        nbytes = (M * K + K * N + M * N) * a.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        if routes[cfg] == "tma_wgmma_tf32x3":
            # three TF32 products on the tensor cores; the split excluded
            t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
            extra["bound_rate"] = "3xTF32: 3 x 2MNK at 495 TFLOP/s"
            extra["ptxas"] = ptxas.get(f"D{depth} pairs{int(N % 2 == 0)}")
        else:
            t_ops = flops / PEAK_FLOPS[dt] * 1e3
        if "product_ms" in extra:
            extra["staging_bound_ms"] = _staging_bytes(dt, M, K, N) / HBM_BYTES_PER_S * 1e3
        if dt == "f32" and depth == default_depth(routes[cfg]):
            extra["f64_limit_share"] = f64[(M, K, N)]
        entry = {
            "name": f"pipelined_matmul[{dt},D={depth},{M}x{K}x{N}]",
            "route": "cuda",
            "kernel_route": routes[cfg],
            "source": {"tma_wgmma": TMA_KERNEL_SOURCE, "tma_wgmma_tf32x3": TF32X3_SOURCE}[routes[cfg]],
            "replaces": TPU_KERNEL,
            "launches": launches[cfg],
            "max_abs_err": errors[cfg],
            "atol": TOL[dt] * math.sqrt(K),
            "rtol": TOL[dt],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "reps": reps,
            "tflops": flops / ms / 1e9,
            **extra,
        }
        entries.append(entry)
        emit("matmul: " + json.dumps(entry))

    # the stage at the LM head (B, 2048 x 49155 into 2048 x 49160) and at
    # (300, 257, 130) (both operands): bit-equal to its plain version; its
    # time at the LM head against its byte bound and one torch copy_ into
    # the padded buffer
    for M, K, N in ((300, 257, 130), LM_HEAD):
        a, b = operands[(M, K, N, "bf16")]
        st = ops.staging(a.dtype, M, K, N, a.data_ptr(), b.data_ptr())
        got = ops.stage_bf16(a, b, st)
        torch.cuda.synchronize()
        for g, x, restaged, ld in zip(got, (a, b), (st.a, st.b), (st.lda, st.ldb)):
            if restaged:
                check(torch.equal(g.view(torch.int16), stage_ref(x, ld).view(torch.int16)),
                      f"stage_bf16 {M}x{K}x{N}: not bit-equal to its plain version")
        del got
    a, b = operands[(*LM_HEAD, "bf16")]
    st = ops.staging(b.dtype, *LM_HEAD, a.data_ptr(), b.data_ptr())
    check(not st.a and st.b and st.launches == 1, f"stage at the LM head: {st}")
    buf = torch.empty(b.shape[0], st.ldb, dtype=b.dtype, device="cuda")
    stage_ms, stage_plain_ms, stage_library_ms = _time_turns_ms(
        torch, [lambda: ops.stage_bf16(a, b, st), lambda: stage_ref(b, st.ldb),
                lambda: buf[:, :b.shape[1]].copy_(b)], 21)
    entry = {
        "name": "stage_bf16[granite-3-2b LM head: B 2048x49155 into 2048x49160]",
        "route": "cuda",
        "kernel_route": "tma_wgmma (stage)",
        "source": TMA_KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": stages,
        "max_abs_err": 0.0,
        "bit_equal": True,
        "ms": stage_ms,
        "plain_ms": stage_plain_ms,
        "bound_ms": _staging_bytes("bf16", 1, 2048, 49155) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": stage_library_ms,
        "library": "Tensor.copy_ into the padded buffer's live columns",
        "reps": 21,
        "timed_in_turns": ["ms", "plain_ms", "library_ms"],
    }
    del buf
    entries.append(entry)
    emit("matmul stage: " + json.dumps(entry))

    # the split pre-pass: bit-equal to its plain version at the padded
    # layout at yi-6b's up projection, (300, 257, 130) and the LM head (A,
    # and B transposed); its time at yi-6b's up projection against its byte
    # bound
    for M, K, N in ((2048, 4096, 11008), (300, 257, 130), LM_HEAD):
        a, b = operands[(M, K, N, "f32")]
        got = (*ops.split_tf32(a), *ops.split_tf32(b, transpose=True))
        ld = -(-K // 4) * 4
        want = (*split_tf32_ref(a, ld=ld), *split_tf32_ref(b, transpose=True, ld=ld))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(g.shape == w.shape and torch.equal(g.view(torch.int32), w.view(torch.int32)),
                  f"split_tf32 {M}x{K}x{N}: not bit-equal to its plain version")
        del got, want
    a, b = operands[(2048, 4096, 11008, "f32")]
    split_ms = _time_back_to_back_ms(
        torch, lambda: (ops.split_tf32(a), ops.split_tf32(b, transpose=True)), 21)
    split_plain_ms = _time_back_to_back_ms(
        torch, lambda: (split_tf32_ref(a), split_tf32_ref(b, transpose=True)), 21)
    elems = a.numel() + b.numel()
    entry = {
        "name": "split_tf32[yi-6b up: A 2048x4096, B^T 4096x11008]",
        "route": "cuda",
        "kernel_route": "tma_wgmma_tf32x3 (split pre-pass)",
        "source": TF32X3_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": splits,
        "max_abs_err": 0.0,
        "bit_equal": True,
        "ms": split_ms,
        "plain_ms": split_plain_ms,
        "bound_ms": elems * 12 / HBM_BYTES_PER_S * 1e3,  # 4 B read, 8 written
        "bound_by": "bytes",
        "library_ms": None,
        "reps": 21,
        "timed_back_to_back": ["ms", "plain_ms"],
    }
    entries.append(entry)
    emit("matmul split: " + json.dumps(entry))
    emit("tf32 accumulator rounding (a reading, not a check): "
         + json.dumps(tf32_accumulator_rounding(torch, ops)))
    del operands, a, b, flush
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------- #
# Phase 6: the flash-attention kernel
# ---------------------------------------------------------------------- #

def live_pairs(Sq, Sk, causal, window, q_offset=0):
    """The (query, key) pairs the mask keeps: the work the kernel must do."""

    import numpy as np

    q = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q + 1, Sk) if causal else np.full(Sq, Sk, np.int64)
    lo = np.maximum(q - window + 1, 0) if window is not None else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(B, Sq, Sk, H, KV, hd, causal, window, dt, elt, route=None,
                q_offset=0, live_keys=None):
    """(bound ms, what bounds it, FLOP): the largest of three times.  Each
    input read once and the output written once over the memory rate
    (``"bytes"``; K and V: the ``live_keys`` some row keeps, by default all
    Sk); QK^T and PV on the live pairs (2 FLOP per multiply-add each) over
    the peak rate of the type, and on the 3xTF32 route three TF32 products
    of each at the TF32 rate (``"operations"``); one exp2 a live pair over
    the special-function units' rate (``"exp"``: below hd 64 it bounds the
    bf16 route)."""

    kv_rows = Sk if live_keys is None else live_keys
    nbytes = (2 * B * Sq * H * hd + 2 * B * kv_rows * KV * hd) * elt
    pairs = B * H * live_pairs(Sq, Sk, causal, window, q_offset)
    flops = 4.0 * hd * pairs
    if route == "tma_wgmma_tf32x3":
        t_ops = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
    else:
        t_ops = flops / PEAK_FLOPS[dt] * 1e3
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": t_ops,
             "exp": pairs / EX2_PER_S * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by, flops


def row_rel_err(out, ref) -> float:
    """The largest relative L2 error of one output row (the last axis)."""

    d = (out.float() - ref.float()).norm(dim=-1)
    return (d / ref.float().norm(dim=-1).clamp_min(1e-30)).max().item()


def keep_mask(torch, Sq, Sk, causal, window, device, *, edge=0, drop=None):
    """The (Sq, Sk) keys each query attends to; ``edge`` moves the causal
    edge (or, with a window, the window's far edge; or, with neither, the
    end of the keys) by that many keys, and ``drop`` removes a key range:
    the planted faults."""

    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    keep = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        keep &= kp <= qp + (edge if window is None else 0)
    if window is not None:
        keep &= kp > qp - window - edge
    if not causal and window is None and edge:
        keep &= kp < Sk + edge
    if drop is not None:
        keep &= (kp < drop[0]) | (kp >= drop[1])
    return keep


def masked_attention(torch, q, k, v, keep):
    """Plain f32 attention over q (B, Sq, H, hd), k / v (B, Sk, KV, hd) and
    a (Sq, Sk) keep mask: the reference with a planted fault."""

    H, hd = q.shape[2], q.shape[3]
    k = k.float().repeat_interleave(H // k.shape[2], dim=2)
    v = v.float().repeat_interleave(H // v.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * hd**-0.5
    p = torch.softmax(s.masked_fill_(~keep, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def planted_faults(torch, q, k, v, out, causal, window):
    """The check's reading of the kernel's output against a reference with
    each planted fault: a key edge off by one, and one 64-key tile dropped
    from the middle of the keys.  Each must read above the limit."""

    Sq, Sk = q.shape[1], k.shape[1]
    t0 = (Sk // 2) // 64 * 64
    faults = {
        "causal edge +1" if causal and window is None
        else "window +1" if window is not None else "last key dropped":
            dict(edge=1 if (causal or window is not None) else -1),
        f"keys {t0}:{t0 + 64} dropped": dict(drop=(t0, t0 + 64)),
    }
    return {
        name: row_rel_err(
            out,
            masked_attention(
                torch, q, k, v,
                keep_mask(torch, Sq, Sk, causal, window, q.device, **kw),
            ),
        )
        for name, kw in faults.items()
    }


def _sdpa(torch, q, k, v, causal, window):
    """One PyTorch call computing the same function, for comparison only."""

    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True
        )
    qp = torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kp > qp - window
    if causal:
        mask &= qp >= kp
    return F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True
    )


def expected_flash_route(dt, hd, sq=None, group=1):
    """The flash route rule, written out independently of ``ops.route``:
    the operands here are fresh allocations, so 16-byte aligned.  Every f32
    call on the 3xTF32 kernel; bf16 on flash_decode at hd 64 / 128 with few
    rows, else on the TMA / wgmma kernel."""

    if dt == "f32":
        return "tma_wgmma_tf32x3"
    if hd in (64, 128) and sq is not None and sq <= DECODE_MAX_SQ and sq * group <= DECODE_MAX_ROWS:
        return "flash_decode"
    return "tma_wgmma"


def attention_f64(torch, q, k, v, causal, window):
    """Plain attention in f64 over q (B, Sq, H, hd), k / v (B, Sk, KV, hd):
    the yardstick the f32 routes' error is read against."""

    keep = keep_mask(torch, q.shape[1], k.shape[1], causal, window, q.device)
    H, hd = q.shape[2], q.shape[3]
    k = k.double().repeat_interleave(H // k.shape[2], dim=2)
    v = v.double().repeat_interleave(H // v.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) * hd**-0.5
    p = torch.softmax(s.masked_fill_(~keep, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def row_share_f64(out, ref64, limit=ROW_TOL["f32"]) -> float:
    """The largest relative L2 error of one output row against an f64
    reference, as a share of the f32 row limit (above 1: outside it)."""

    d = (out.double() - ref64).norm(dim=-1)
    return (d / ref64.norm(dim=-1).clamp_min(1e-300)).max().item() / limit


def ptxas_lines(log, pattern=r"flash_bf16_tma_kernelILi(\d+)ELi(\d+)E", key="hd{} D{}"):
    """ptxas's summary (registers, barriers, stack, spills) of each
    instantiation of a kernel in a build log: the entry functions whose
    mangled name matches ``pattern``, keyed by ``key`` filled with its
    groups (by default the TMA flash kernel's ``"hd{HD} D{STAGES}"``)."""

    import re

    lines, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(pattern, line)
            kernel = key.format(*found.groups()) if found else None
        elif kernel and ("registers" in line or "spill" in line):
            lines.setdefault(kernel, []).append(line.replace("ptxas info    :", "").strip())
    return {k: "; ".join(v) for k, v in lines.items()}


def _tf32x3_checks(torch, q, k, v, out, causal, window):
    """The 3xTF32 route's error against an f64 plain version as a share of
    the f32 row limit, beside the 3xTF32 emulation's and a 1xTF32
    emulation's (which must read above the limit)."""

    from repro_torch.kernels.flash_attention.ref import flash_attention_tf32x3_ref

    kw = dict(causal=causal, window=window)
    ref64 = attention_f64(torch, q, k, v, causal, window)
    shares = {"kernel": row_share_f64(out, ref64)}
    for terms, name in ((3, "emulated_3xtf32"), (1, "emulated_1xtf32")):
        emu = flash_attention_tf32x3_ref(q, k, v, terms=terms, **kw)
        shares[name] = row_share_f64(emu, ref64)
        del emu
    del ref64
    torch.cuda.empty_cache()
    check(shares["kernel"] <= 1, f"flash 3xTF32: {shares['kernel']} of the limit against f64")
    check(
        shares["emulated_1xtf32"] > 1,
        f"flash: the 1xTF32 emulation reads {shares['emulated_1xtf32']} of the "
        "limit against f64: the check cannot see one TF32 product",
    )
    return shares


def _split_entry(torch, ops, k, v, launches):
    """The K/V split pre-pass at the yi-6b f32 prefill's k and v, at
    KV-cache slices with a ragged Sk at hd 128, 64, 32 and 16, and at a
    broadcast batch (a zero stride): bit-equal to its plain version; its
    time against its byte bound."""

    from repro_torch.kernels.flash_attention.ref import split_kv_tf32_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cache = torch.randn(2, 640, 8, 128, device="cuda", generator=gen)
    err = 0.0
    for kk, vv in ((k, v), (cache[:, :201, :4], cache[:, :201, 4:]),
                   (cache[:, :333, :2, :64], cache[:, :333, 2:4, 64:]),
                   (cache[:, :201, :2, :32], cache[:, :201, 2:4, 32:64]),
                   (cache[:, :77, :4, :16], cache[:, :77, 4:, 16:32]),
                   (cache[:1, :100, :2, :32].expand(2, -1, -1, -1),
                    cache[:1, :100, 2:4, 32:64].expand(2, -1, -1, -1))):
        got, want = ops.split_kv_tf32(kk, vv), split_kv_tf32_ref(kk, vv)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.equal(g.view(torch.int32), w.view(torch.int32)),
                  f"split_kv_tf32 {tuple(kk.shape)}: not bit-equal to its plain version")
            err = max(err, (g - w).abs().max().item())
        del got, want
    del cache
    B, Sk, KV, hd = k.shape
    sk8 = -(-Sk // 8) * 8
    nbytes = (2 * B * Sk * KV * hd + 2 * B * KV * Sk * hd + 2 * B * KV * hd * sk8) * 4
    return {
        "name": f"split_kv_tf32[yi-6b prefill f32: k, v {B}x{Sk}x{KV}x{hd}]",
        "route": "cuda",
        "kernel_route": "tma_wgmma_tf32x3 (K/V split pre-pass)",
        "source": TF32X3_FLASH_SOURCE,
        "replaces": FLASH_TPU_KERNEL,
        "launches": launches,
        "max_abs_err": err,
        "bit_equal": True,
        "ms": _time_back_to_back_ms(torch, lambda: ops.split_kv_tf32(k, v), 101),
        "plain_ms": _time_back_to_back_ms(torch, lambda: split_kv_tf32_ref(k, v), 21),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,  # k, v read; four outputs written
        "bound_by": "bytes",
        "library_ms": None,
        "reps": 101,
        "timed_back_to_back": ["ms", "plain_ms"],
    }


def _q_offset_checks(torch, ops):
    """Every route at a query offset against the plain version, with the
    offset off by one as a planted fault that must read above the limit."""

    from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    readings = []
    for B, Sq, Sk, H, KV, hd, causal, window, q_offset, dt in FLASH_Q_OFFSET_CASES:
        q, k, v = (
            torch.randn(shape, device="cuda", generator=gen).to(dtypes[dt])
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))
        )
        kw = dict(causal=causal, window=window)
        out = ops.flash_attention(q, k, v, q_offset=q_offset, **kw)
        ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), q_offset=q_offset, **kw)
        fault = flash_attention_bshd_ref(q.float(), k.float(), v.float(), q_offset=q_offset + 1, **kw)
        row = {"route": ops._route_of(q, k, v), "dtype": dt, "q_offset": q_offset,
               "shape": (B, Sq, Sk, H, KV, hd, causal, window),
               "max_row_rel_err": row_rel_err(out, ref),
               "planted_offset_plus_one": row_rel_err(out, fault)}
        check(row["max_row_rel_err"] <= ROW_TOL[dt], f"flash q_offset {row}: outside the limit")
        check(row["planted_offset_plus_one"] > ROW_TOL[dt], f"flash q_offset {row}: the fault reads inside the limit")
        readings.append(row)
    routes = {r["route"] for r in readings}
    check(routes == set(ops.flash_attention.routes), f"flash q_offset: routes {routes} checked")
    return readings


def flash_phase(torch):
    """The kernels against their plain version at every listed shape, then
    the flash_decode rows (:func:`_decode_rows`); returns the numbers of
    each shape keyed by case, the launches of each route in the main run
    and the split pre-pass's kernels-line entry."""

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.probe import one_hot_probe
    from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    inputs = {}
    for case in FLASH_CASES:
        label, B, Sq, Sk, H, KV, hd, causal, window, dt = case
        inputs[case] = tuple(
            torch.randn(shape, device="cuda", generator=gen).to(dtypes[dt])
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))
        )
    for case in DECODE_CASES:
        label, B, Sq, Sk, H, KV, hd, causal, window, q_offset = case
        inputs[case] = tuple(
            torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))
        )

    # the main path: every count set to 0 just before, read just after
    ops.flash_attention.launches = 0
    ops.flash_attention.routes = dict.fromkeys(ops.flash_attention.routes, 0)
    ops.split_kv_tf32.launches = 0
    outs, routes = {}, {}
    for case in FLASH_CASES + DECODE_CASES:
        q, k, v = inputs[case]
        kw = dict(causal=case[7], window=case[8])
        if case in DECODE_CASES:
            kw["q_offset"] = case[9]
        before = dict(ops.flash_attention.routes)
        outs[case] = ops.flash_attention(q, k, v, **kw)
        took = [r for r, n in ops.flash_attention.routes.items() if n != before[r]]
        routes[case] = took[0] if len(took) == 1 else took
    torch.cuda.synchronize()
    total, by_route = ops.flash_attention.launches, dict(ops.flash_attention.routes)
    splits = ops.split_kv_tf32.launches
    n_cases = len(FLASH_CASES) + len(DECODE_CASES)
    check(total == n_cases, f"flash: {total} launches in the main run, expected {n_cases}")
    for case in FLASH_CASES:
        want = expected_flash_route(case[9], case[6], case[2], case[4] // case[5])
        check(routes[case] == want, f"flash {case}: took route {routes[case]}, expected {want}")
    for case in DECODE_CASES:
        want = expected_flash_route("bf16", case[6], case[2], case[4] // case[5])
        check(routes[case] == want == "flash_decode",
              f"flash {case}: took route {routes[case]}, expected {want}")
    check(sum(by_route.values()) == total, f"flash: routes {by_route} do not sum to {total}")
    check(all(n > 0 for n in by_route.values()), f"flash: a route took no launch: {by_route}")
    check(
        splits == by_route["tma_wgmma_tf32x3"],
        f"flash: {splits} split launches for {by_route['tma_wgmma_tf32x3']} 3xTF32 launches",
    )
    emit("flash routes in the main run: " + json.dumps(by_route)
         + f", split_kv_tf32 launches {splits}")
    _decode_rows(torch, ops, inputs, outs)

    checks = {}
    for case in FLASH_CASES:
        label, B, Sq, Sk, H, KV, hd, causal, window, dt = case
        q, k, v = inputs[case]
        out = outs.pop(case)
        kw = dict(causal=causal, window=window)
        ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), **kw)
        err = (out.float() - ref).abs().max().item()
        rel = row_rel_err(out, ref)
        del ref
        check(out.shape == q.shape, f"flash {case}: output of shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out.float()).all()), f"flash {case}: non-finite output")
        check(rel <= ROW_TOL[dt], f"flash {case}: row relative error {rel} > {ROW_TOL[dt]}")
        faults = planted_faults(torch, q, k, v, out, causal, window)
        for name, reading in faults.items():
            check(
                reading > ROW_TOL[dt],
                f"flash {case}: planted fault {name!r} reads {reading}, inside "
                f"the limit {ROW_TOL[dt]}: the check cannot see it",
            )
        shares = None
        if routes[case] == "tma_wgmma_tf32x3":
            shares = _tf32x3_checks(torch, q, k, v, out, causal, window)
        checks[case] = (err, rel, faults, shares)
        del out
    torch.cuda.empty_cache()

    # the one-hot probes on both TMA routes: each row's output is one v row
    # (or, with V = I, the one-hot P) bit for bit
    for dt, route in (("bf16", "tma_wgmma"), ("f32", "tma_wgmma_tf32x3")):
        for B, Sq, Sk, H, KV, hd, kw in FLASH_PROBES:
            q, k, v, expected = one_hot_probe(B, Sq, Sk, H, KV, hd, seed=SEED, **kw)
            q, k, v = (torch.from_numpy(a).to("cuda", dtypes[dt]) for a in (q, k, v))
            mask = {n: x for n, x in kw.items() if n != "identity_v"}
            check(ops._route_of(q, k, v) == route, f"flash probe {kw}: not on the {route} route")
            out = ops.flash_attention(q, k, v, **mask).float().cpu()
            differ = int((out != torch.from_numpy(expected)).sum())
            check(differ == 0, f"flash probe {(B, Sq, Sk, H, KV, hd, kw)} ({route}): {differ} values differ")
        emit(f"flash one-hot probes ({dt}, {route} route): {len(FLASH_PROBES)} exact")

    yi_f32 = next(c for c in FLASH_CASES if c[0] == "yi-6b prefill" and c[9] == "f32")
    split_entry = _split_entry(torch, ops, inputs[yi_f32][1], inputs[yi_f32][2], splits)
    emit("flash split: " + json.dumps(split_entry))
    emit("flash q_offset: " + json.dumps(_q_offset_checks(torch, ops)))

    ptxas = ptxas_lines(_build.BUILD_LOG.get(Path(TMA_FLASH_SOURCE).name, ""))
    ptxas_tf32 = ptxas_lines(_build.BUILD_LOG.get(Path(TF32X3_FLASH_SOURCE).name, ""),
                             r"flash_tf32x3_kernelILi(\d+)ELi(\d+)ELi(\d+)E", "hd{} BK{} D{}")
    rows = {}
    for case in FLASH_CASES:
        label, B, Sq, Sk, H, KV, hd, causal, window, dt = case
        q, k, v = inputs[case]
        kw = dict(causal=causal, window=window)
        err, rel, faults, shares = checks[case]
        bound_ms, bound_by, flops = flash_bound(
            B, Sq, Sk, H, KV, hd, causal, window, dt, q.element_size(), routes[case]
        )
        reps = 21 if flops > 1e10 else 101
        library = lambda: _sdpa(torch, q, k, v, causal, window)  # noqa: E731
        # the TMA kernel at each ring depth and SDPA, in turns (one launch
        # each a round)
        tf32 = routes[case] == "tma_wgmma_tf32x3"
        default = (ops.tf32x3_default_depth if tf32 else ops.default_depth)(hd)
        if label != "yi-6b prefill":
            depths = (default,)
        else:
            depths = range(1, default + 1) if tf32 else (1, 2, default)
        tile = ops.TF32X3_BK[hd] if tf32 else ops.TMA_BK
        by_depth = {}
        for d in depths:
            kernel = lambda d=d: ops.flash_attention(q, k, v, depth=d, **kw)  # noqa: E731
            ms_d, lib_ms = _time_turns_ms(torch, [kernel, library], reps)
            by_depth[d] = {"ms": ms_d, "library_ms": lib_ms, "tflops": flops / ms_d / 1e9,
                           "ptxas": ptxas_tf32.get(f"hd{hd} BK{tile} D{d}") if tf32
                           else ptxas.get(f"hd{hd} D{d}")}
        ms, library_ms = by_depth[default]["ms"], by_depth[default]["library_ms"]
        # the kernel alone, back to back: what the turns' neighbours
        # (a 1.4 ms masked SDPA in the window case) do to its clock
        ms_alone = _time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), reps)
        extra = {"depth": default, "key_tile": tile, "ms_alone": ms_alone,
                 "by_depth": by_depth, "timed_in_turns": ["ms", "library_ms"]}
        if hd < 64:
            extra["small_hd"] = _small_hd_times(torch, ops, q, k, v, causal, window, reps)
        if tf32:
            extra["bound_rate"] = "3xTF32: 3 x 4 hd FLOP a live pair at 495 TFLOP/s"
            extra["f64_limit_share"] = shares
            extra["host_path"] = _host_path(torch, ops, q, k, v, causal, window, reps)
        elif bound_by == "exp":
            extra["bound_rate"] = f"exp: one ex2 a live pair at {EX2_PER_S:.4g} a second"
        plain_ms = _time_ms(torch, lambda: flash_attention_bshd_ref(q, k, v, **kw), 5)
        row = {
            "case": f"{label}, {dt}",
            "kernel_route": routes[case],
            "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KV": KV, "hd": hd,
                      "causal": causal, "window": window},
            "max_abs_err": err,
            "max_row_rel_err": rel,
            "row_rel_limit": ROW_TOL[dt],
            "planted_faults": faults,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "reps": reps,
            "tflops": flops / ms / 1e9,
            **extra,
        }
        rows[case] = row
        emit("flash: " + json.dumps(row))
    del inputs, q, k, v
    torch.cuda.empty_cache()
    return rows, by_route, split_entry


def _host_path(torch, ops, q, k, v, causal, window, reps):
    """Where one call of the 3xTF32 route spends its time: the host's time
    to enqueue the call (``perf_counter``, the device idle before it;
    ``launch``: the route's one ctypes call alone) and the device time of
    the split alone and of the route's two launches (CUDA events around
    each, enqueued while a sleep kernel holds the device, so the host's
    gaps do not show in them).  Medians of ``reps`` rounds, after two."""

    kw = dict(causal=causal, window=window)
    sched = ops._tma_schedule(q.shape[-1], None, "tma_wgmma_tf32x3")
    o = torch.empty_like(q)
    host = {"route_call": [], "launch": []}
    device = {"split": [], "split_and_product": [], "held": []}
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.flash_attention(q, k, v, **kw)
        host["route_call"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        torch.cuda._sleep(HOLD_CYCLES)
        ev[1].record()
        ops.split_kv_tf32(k, v)
        ev[2].record()
        t0 = time.perf_counter()
        ops._launch_tf32x3(q, k, v, o, causal, window, 0, sched)
        host["launch"].append((time.perf_counter() - t0) * 1e3)
        ev[3].record()
        ev[3].synchronize()
        for i, name in enumerate(("held", "split", "split_and_product")):
            device[name].append(ev[i].elapsed_time(ev[i + 1]))
    med = {f"host_{n}_ms": statistics.median(t[2:]) for n, t in host.items()}
    med |= {f"device_{n}_ms": statistics.median(t[2:]) for n, t in device.items()}
    # the sleep must outlast the host's enqueue of the launches behind it,
    # or a host gap shows in the device times
    check(
        med["device_held_ms"] > 2 * med["host_route_call_ms"],
        f"flash host path: the sleep ({med['device_held_ms']} ms) does not hold the device "
        "while the host enqueues",
    )
    return med


def padded_64(ops, q, k, v, **kw):
    """The call at hd 16 or 32 on the hd-64 route instead: q, k and v
    zero-padded to 64 (``ref.pad_head_dim``), the true hd's scale, the
    output sliced back; the yardstick of whether a native small-hd kernel
    is worth more than padding."""

    from repro_torch.kernels.flash_attention.ref import pad_head_dim

    hd = q.shape[-1]
    o = ops.flash_attention(*(pad_head_dim(t, 64) for t in (q, k, v)), _scale=hd**-0.5, **kw)
    return o[..., :hd].contiguous()


def _small_hd_times(torch, ops, q, k, v, causal, window, reps):
    """At hd 16 or 32: the route's call, SDPA and the padded-64 call
    (:func:`padded_64`), in the same rounds: the device time alone (L2
    flushed) and the host's enqueue time (:func:`_held_times`), and the
    single launch between events (:func:`_time_turns_ms`); and the padded
    call's error against the plain version."""

    from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref

    kw = dict(causal=causal, window=window)
    ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), **kw)
    padded_err = row_rel_err(padded_64(ops, q, k, v, **kw), ref)
    del ref
    dt = "f32" if q.dtype == torch.float32 else "bf16"
    check(padded_err <= ROW_TOL[dt], f"flash padded-64 at hd {q.shape[-1]}: row error {padded_err}")
    fns = {"route": lambda: ops.flash_attention(q, k, v, **kw),
           "sdpa": lambda: _sdpa(torch, q, k, v, causal, window),
           "padded_64": lambda: padded_64(ops, q, k, v, **kw)}
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    n = min(reps, 31)
    held = _held_times(torch, fns, n, flush)
    del flush
    single = dict(zip(fns, _time_turns_ms(torch, list(fns.values()), n)))
    return {"padded_64_max_row_rel_err": padded_err, "reps": n,
            **{f"{f}_{m}": held[f][m] for f in fns for m in ("device_ms", "host_ms")},
            **{f"{f}_single_ms": single[f] for f in fns}}


def _tma_call(ops, q, k, v, **kw):
    """``ops.flash_attention`` with flash_decode's rule switched off, so
    that a few-row call takes ``tma_wgmma`` (the wrapper's private switch,
    set here and nowhere else)."""

    ops._decode_route = False
    try:
        return ops.flash_attention(q, k, v, **kw)
    finally:
        ops._decode_route = True


def _sdpa_at(torch, q, k, v, causal, window, q_offset):
    """A call of SDPA computing the same function as the kernel at a query
    offset: an explicit mask where some key is masked, none where every key
    is live (a decode step); the mask is built here, outside the call."""

    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import _keep

    keep = _keep(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    mask = None if bool(keep.all()) else keep
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _held_times(torch, fns, reps, flush, host_calls=5):
    """For each of ``fns`` (name -> call), in turns a round: the host's
    time to enqueue one call (``host_calls`` calls back to back, while a
    sleep kernel holds the device, so that none waits on the device: what
    a host-bound decode step pays a call) and the device time of one call
    alone (CUDA events around it, enqueued while another sleep holds the
    device, each after ``flush`` is read, so that the host's gaps do not
    show and K and V come from HBM as each decoder layer's do).  Each sleep
    is ``HOLD_CYCLES`` a call of the round.  Medians of ``reps`` rounds,
    after two."""

    Event = torch.cuda.Event
    hold = HOLD_CYCLES * len(fns)
    host = {n: [] for n in fns}
    dev = {n: [] for n in fns}
    held = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        torch.cuda._sleep(hold)
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(host_calls):
                fn()
            host[name].append((time.perf_counter() - t0) * 1e3 / host_calls)
        torch.cuda.synchronize()
        h0, h1 = Event(enable_timing=True), Event(enable_timing=True)
        h0.record()
        torch.cuda._sleep(hold)
        h1.record()
        marks = []
        for name, fn in fns.items():
            flush.amax()
            a, b = Event(enable_timing=True), Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            marks.append((name, a, b))
        marks[-1][2].synchronize()
        held.append(h0.elapsed_time(h1))
        for name, a, b in marks:
            dev[name].append(a.elapsed_time(b))
    out = {n: {"device_ms": statistics.median(dev[n][2:]),
               "host_ms": statistics.median(host[n][2:])} for n in fns}
    held_ms = statistics.median(held[2:])
    check(held_ms > 2 * sum(t["host_ms"] for t in out.values()),
          f"held times: the sleep ({held_ms} ms) does not hold the device while the host enqueues")
    return out


def _kernel_spans(torch, fn, flush, reps, names):
    """Each launch of ``fn`` under ``torch.profiler``, ``reps`` calls
    enqueued while a sleep kernel holds the device, the L2 flushed before
    each: the medians of each kernel's own span (ms, by the first of
    ``names`` its name holds) and, for each later name, of the gap from the
    end of the kernel before it in the call to its own start, over the
    calls whose kernels the trace holds in full (``calls``: how many)."""

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(HOLD_CYCLES)
        for _ in range(reps):
            flush.amax()
            fn()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, next(n for n in names if n in e.name))
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.name for n in names)
    )
    calls, i = [], 0
    while i + len(names) <= len(spans):
        window = spans[i:i + len(names)]
        if [w[2] for w in window] == list(names):
            calls.append(window)
            i += len(names)
        else:
            i += 1
    check(len(calls) >= reps // 2, f"kernel spans: {len(spans)} launches of {names}, "
          f"{len(calls)} whole calls of {reps}")
    out = {"calls": len(calls)}
    for j, name in enumerate(names):
        out[f"{name}_ms"] = statistics.median((c[j][1] - c[j][0]) / 1e3 for c in calls)
        if j:
            out[f"gap_before_{name}_ms"] = statistics.median(
                (c[j][0] - c[j - 1][1]) / 1e3 for c in calls)
    return out


def _decode_split(torch, ops, case, q, k, v, flush):
    """Where the few-row route's time goes at one call shape: device times
    alone in the same rounds (:func:`_held_times`) of the route's launch
    and of its two timing probes (``ops._decode_probe``: the K-loop without
    the cluster merge, the loads without the products), then each one's
    kernel span under the profiler (:func:`_kernel_spans`), against which
    the events' times also hold what a launch between events costs; and the
    kernels on the device of ``DECODE_REPS`` route calls under the
    profiler, which must be one a call."""

    from torch.profiler import ProfilerActivity, profile

    label, B, Sq, Sk, H, KV, hd, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o = torch.empty_like(q)
    fns = {
        "route": lambda: ops.flash_attention(q, k, v, **kw),
        "loop_alone": lambda: ops._decode_probe(q, k, v, o, causal, window, q_offset, 1),
        "loads_alone": lambda: ops._decode_probe(q, k, v, o, causal, window, q_offset, 2),
    }
    held = _held_times(torch, fns, DECODE_REPS, flush)
    out = {"case": label, "splits": ops.decode_splits(B, KV, Sk, _sm_count()),
           **{f"{n}_{t}": held[n][t] for n in fns for t in ("device_ms", "host_ms")}}
    out["profiled_ms"] = {
        n: _kernel_spans(torch, fn, flush, 20, ("flash_decode_kernel",))["flash_decode_kernel_ms"]
        for n, fn in fns.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(DECODE_REPS):
            fns["route"]()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out["kernels_a_call"] = len(kernels) / DECODE_REPS
    check(len(kernels) == DECODE_REPS and all("flash_decode_kernel" in n for n in kernels),
          f"flash_decode {label}: {len(kernels)} kernels for {DECODE_REPS} calls: "
          f"{sorted(set(kernels))}")
    return out


def _sm_count():
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def _decode_crossover(torch, ops, flush):
    """flash_decode (forced where the rule would not send the call) and
    tma_wgmma (forced) at whisper's cross shape (non-causal over 1500
    keys) for each of ``DECODE_CROSSOVER_SQ`` query rows and at yi-6b's
    decode position (GQA 4, hd 128, 2048 keys) for each of
    ``DECODE_CROSSOVER_GQA_SQ``: device and host times in the same rounds,
    SDPA's beside them, each kernel's output against the plain version;
    the rule's route at each."""

    from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    table = []
    for label, (B, Sk, H, KV, hd, causal), rows in (
        ("whisper cross", (4, 1500, 16, 16, 64, False), DECODE_CROSSOVER_SQ),
        ("yi-6b decode", (4, 2048, 32, 4, 128, True), DECODE_CROSSOVER_GQA_SQ),
    ):
        k, v = (torch.randn(B, Sk, KV, hd, device="cuda", generator=gen).bfloat16()
                for _ in range(2))
        for Sq in rows:
            q = torch.randn(B, Sq, H, hd, device="cuda", generator=gen).bfloat16()
            kw = dict(causal=causal, q_offset=Sk - Sq if causal else 0)
            ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), **kw)
            dec, tma = ops._flash_decode(q, k, v, **kw), _tma_call(ops, q, k, v, **kw)
            errs = {"flash_decode": row_rel_err(dec, ref), "tma_wgmma": row_rel_err(tma, ref)}
            del ref, dec, tma
            check(max(errs.values()) <= ROW_TOL["bf16"], f"flash crossover {label} {Sq}: {errs}")
            times = _held_times(torch, {
                "flash_decode": lambda: ops._flash_decode(q, k, v, **kw),
                "tma_wgmma": lambda: _tma_call(ops, q, k, v, **kw),
                "library": _sdpa_at(torch, q, k, v, causal, None, kw["q_offset"]),
            }, DECODE_REPS, flush)
            table.append({
                "case": label, "Sq": Sq, "rows_a_kv_head": Sq * H // KV,
                "rule": ops._route_of(q, k, v),
                "expected_rule": expected_flash_route("bf16", hd, Sq, H // KV),
                "faster": min(("flash_decode", "tma_wgmma"), key=lambda n: times[n]["device_ms"]),
                **{f"{n}_{m}": t[m] for n, t in times.items() for m in ("device_ms", "host_ms")},
                "max_row_rel_err": errs,
            })
            check(table[-1]["rule"] == table[-1]["expected_rule"], f"flash crossover: {table[-1]}")
    return table


def _decode_rows(torch, ops, inputs, outs):
    """The flash_decode route at every ``DECODE_CASES`` row, on the main
    run's outputs: the kernel against the plain version
    (``flash_decode_ref``'s steps at the kernel's key ranges, f32 out,
    largest row-relative error within ``ROW_TOL["bf16"]``), two planted
    faults that must read above it (a peer's state left out of the
    cluster's merge, the last live key dropped), the one-hot probes (and V
    = I) at the row's shape non-causal with their first picks on the last
    range's edges (rows of at most 4 query rows), the launch's ring depth
    and resident clusters, and the single-launch time (in turns with
    tma_wgmma forced and SDPA), the device time alone and the host's
    enqueue time (:func:`_held_times`), the plain version's time and the
    bound; then the crossover table (:func:`_decode_crossover`) and where
    the time goes at whisper's decode cross shape
    (:func:`_decode_split`)."""

    import numpy as np

    from repro_torch.kernels.flash_attention.probe import one_hot_probe, split_edge_picks
    from repro_torch.kernels.flash_attention.ref import (
        combine_splits_ref,
        decode_partials_ref,
        flash_decode_ref,
        live_span,
    )

    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for case in DECODE_CASES:
        label, B, Sq, Sk, H, KV, hd, causal, window, q_offset = case
        q, k, v = inputs[case]
        out = outs.pop(case)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        lo, hi = live_span(Sq, Sk, causal, window, q_offset)
        splits = ops.decode_splits(B, KV, hi - lo, sms)
        m, l, acc = decode_partials_ref(q, k, v, splits=splits, **kw)
        ref = combine_splits_ref(m, l, acc, torch.float32)
        err = (out.float() - ref).abs().max().item()
        rel = row_rel_err(out, ref)
        check(out.shape == q.shape and bool(torch.isfinite(out.float()).all()),
              f"flash_decode {case}: output {tuple(out.shape)}, finite {bool(torch.isfinite(out.float()).all())}")
        check(rel <= ROW_TOL["bf16"], f"flash_decode {case}: row relative error {rel} > {ROW_TOL['bf16']}")
        tma_rel = row_rel_err(_tma_call(ops, q, k, v, **kw), ref)
        check(tma_rel <= ROW_TOL["bf16"], f"flash_decode {case}: tma_wgmma reads {tma_rel}")
        del ref
        faults = {}
        if splits > 1:
            # a peer's state left out of the cluster's merge
            s, m2, l2 = splits // 2, m.clone(), l.clone()
            m2[s], l2[s] = -math.inf, 0.0
            faults[f"peer {s} of {splits} left out of the merge"] = row_rel_err(
                out, combine_splits_ref(m2, l2, acc, torch.float32))
            del m2, l2
        faults["last live key dropped"] = row_rel_err(out, combine_splits_ref(
            *decode_partials_ref(q, k[:, :hi - 1], v[:, :hi - 1], splits=splits, **kw),
            torch.float32))
        del m, l, acc
        for name, reading in faults.items():
            check(reading > ROW_TOL["bf16"],
                  f"flash_decode {case}: planted fault {name!r} reads {reading}, inside the "
                  f"limit {ROW_TOL['bf16']}: the check cannot see it")
        probes = None
        if Sq <= 4:
            probes = 0
            nc_splits = ops.decode_splits(B, KV, Sk, sms)
            for identity_v in (False, True):
                pq, pk, pv, expected = one_hot_probe(
                    B, Sq, Sk, H, KV, hd, causal=False, identity_v=identity_v, seed=SEED,
                    first_picks=(split_edge_picks(Sk, nc_splits, B * H * Sq)
                                 if nc_splits > 1 else Sk - 1 - np.arange(2)),
                )
                pq, pk, pv = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in (pq, pk, pv))
                check(ops._route_of(pq, pk, pv) == "flash_decode", f"flash_decode probe {case}: route")
                got = ops.flash_attention(pq, pk, pv, causal=False).float().cpu()
                differ = int((got != torch.from_numpy(expected)).sum())
                check(differ == 0, f"flash_decode probe {case} (V = I: {identity_v}): {differ} values differ")
                probes += 1
        bound_ms, bound_by, flops = flash_bound(
            B, Sq, Sk, H, KV, hd, causal, window, "bf16", 2, q_offset=q_offset, live_keys=hi - lo)
        kernel = lambda: ops.flash_attention(q, k, v, **kw)  # noqa: E731
        tma = lambda: _tma_call(ops, q, k, v, **kw)  # noqa: E731
        library = _sdpa_at(torch, q, k, v, causal, window, q_offset)
        ms, tma_ms, library_ms = _time_turns_ms(torch, [kernel, tma, library], DECODE_REPS)
        held = _held_times(torch, {"flash_decode": kernel, "tma_wgmma": tma, "library": library},
                           DECODE_REPS, flush)
        plan = ops._plan_of(q, k, v, out, causal, window, q_offset)
        plain_ms = _time_ms(torch, lambda: flash_decode_ref(q, k, v, splits=splits, **kw), 5)
        row = {
            "case": f"{label} {Sq}x{Sk}, bf16",
            "kernel_route": "flash_decode",
            "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KV": KV, "hd": hd,
                      "causal": causal, "window": window, "q_offset": q_offset},
            "splits": splits,
            "depth": plan.sched.depth,
            "clusters_resident": plan.clusters,
            "clusters": B * KV,
            "live_keys": hi - lo,
            "max_abs_err": err,
            "max_row_rel_err": rel,
            "row_rel_limit": ROW_TOL["bf16"],
            "tma_wgmma_max_row_rel_err": tma_rel,
            "planted_faults": faults,
            "one_hot_probes_exact": probes,
            "ms": ms,
            "tma_wgmma_ms": tma_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "device_ms": held["flash_decode"]["device_ms"],
            "host_ms": held["flash_decode"]["host_ms"],
            "tma_wgmma_device_ms": held["tma_wgmma"]["device_ms"],
            "tma_wgmma_host_ms": held["tma_wgmma"]["host_ms"],
            "library_device_ms": held["library"]["device_ms"],
            "library_host_ms": held["library"]["host_ms"],
            "reps": DECODE_REPS,
            "tflops": flops / ms / 1e9,
            "timed_in_turns": ["ms", "tma_wgmma_ms", "library_ms"],
            "timed_held_cold_l2": ["device_ms", "tma_wgmma_device_ms", "library_device_ms"],
        }
        rows[case] = row
        emit("flash_decode: " + json.dumps(row))
    crossover = _decode_crossover(torch, ops, flush)
    emit("flash_decode crossover: " + json.dumps(crossover))
    split = _decode_split(torch, ops, DECODE_CASES[0], *inputs[DECODE_CASES[0]], flush)
    emit("flash_decode split: " + json.dumps(split))
    cache_rows = _decode_cache_rows(torch, ops, flush)
    del flush
    torch.cuda.empty_cache()
    return {"rows": rows, "crossover": crossover, "split": split, "cache_rows": cache_rows}


def _decode_cache_rows(torch, ops, flush):
    """``decode_attention`` at every ``DECODE_CACHE_CASES`` row: one
    flash_decode launch over the whole cache, whose slots outside the live
    keys hold NaN, against the plain version (``decode_attention_plain`` in
    f32 on the same cache without the NaN; largest row-relative error
    within ``ROW_TOL["bf16"]``), a planted fault (the last live key
    dropped) that must read above it, and the launch's device time alone
    (:func:`_held_times`) against its byte bound over the live keys."""

    from repro_torch.kernels.flash_attention.ref import live_span
    from repro_torch.models import attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = []
    for label, B, Smax, H, KV, hd, window, cache_len in DECODE_CACHE_CASES:
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                   for shape in ((B, 1, H, hd), (B, Smax, KV, hd), (B, Smax, KV, hd)))
        lo, hi = live_span(1, Smax, True, window, cache_len - 1)
        kn, vn = k.clone(), v.clone()
        for t in (kn, vn):
            t[:, :lo] = float("nan")
            t[:, hi:] = float("nan")
        call = lambda: attention.decode_attention(q, kn, vn, cache_len, window=window)  # noqa: E731
        before = dict(ops.flash_attention.routes)
        out = call()
        took = {r: n - before[r] for r, n in ops.flash_attention.routes.items() if n != before[r]}
        check(took == {"flash_decode": 1}, f"flash_decode cache {label}: launches {took}")
        finite = bool(torch.isfinite(out.float()).all())
        rel = row_rel_err(out, attention.decode_attention_plain(
            q.float(), k.float(), v.float(), cache_len=cache_len, window=window))
        check(finite and rel <= ROW_TOL["bf16"],
              f"flash_decode cache {label}: finite {finite}, row relative error {rel} > "
              f"{ROW_TOL['bf16']}")
        keys = torch.arange(Smax, device="cuda")
        dropped = row_rel_err(out, masked_attention(
            torch, q, k, v, ((keys >= lo) & (keys < hi - 1))[None]))
        check(dropped > ROW_TOL["bf16"],
              f"flash_decode cache {label}: planted fault 'last live key dropped' reads "
              f"{dropped}, inside the limit {ROW_TOL['bf16']}: the check cannot see it")
        held = _held_times(torch, {"flash_decode": call}, DECODE_REPS, flush)["flash_decode"]
        bound_ms, bound_by, _ = flash_bound(B, 1, Smax, H, KV, hd, True, window, "bf16", 2,
                                            q_offset=cache_len - 1, live_keys=hi - lo)
        row = {
            "case": f"{label}, cache_len {cache_len} of {Smax}, bf16",
            "kernel_route": "flash_decode",
            "shape": {"B": B, "Smax": Smax, "H": H, "KV": KV, "hd": hd, "window": window,
                      "cache_len": cache_len},
            "live_keys": [lo, hi],
            "outside_live_keys": "NaN",
            "max_row_rel_err": rel,
            "row_rel_limit": ROW_TOL["bf16"],
            "planted_faults": {"last live key dropped": dropped},
            "device_ms": held["device_ms"],
            "host_ms": held["host_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_share": bound_ms / held["device_ms"],
            "reps": DECODE_REPS,
        }
        rows.append(row)
        emit("flash_decode cache: " + json.dumps(row))
        del q, k, v, kn, vn, out
    return rows


# ---------------------------------------------------------------------- #
# Phase 7: yi-6b serving, the LM slice's main path
# ---------------------------------------------------------------------- #

def _attention_replaced(fn, plain_decode=False):
    """Route the model's prefill attention to ``fn``, and with
    ``plain_decode`` its decode attention to the plain version, for one
    rerun (a comparison, not the served path)."""

    import contextlib
    from unittest import mock

    from repro_torch.models import attention

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(attention, "chunked_attention", fn))
    if plain_decode:
        stack.enter_context(mock.patch.object(attention, "decode_takes_kernel",
                                              lambda *args: False))
    return stack


def _decode_checked(torch, readings):
    """Decode attention on its served path, each call's output held
    against the plain version in f32 on the same q and cache (the largest
    row-relative error, appended to ``readings``)."""

    from unittest import mock

    from repro_torch.models import attention

    served = attention.decode_attention

    def checked(q, k, v, cache_len, *, window=None):
        out = served(q, k, v, cache_len, window=window)
        ref = attention.decode_attention_plain(
            q.float(), k.float(), v.float(), cache_len=cache_len, window=window)
        readings.append(row_rel_err(out, ref))
        return out

    return mock.patch.object(attention, "decode_attention", checked)


def _causal_edge_off_by_one(q, k, v, *, causal=True, window=None, chunk=1024, q_offset=0):
    """The plain version with a planted fault: each query also sees the
    next key (its position moved one key on)."""

    from repro_torch.models.attention import chunked_attention_plain

    return chunked_attention_plain(
        q, k, v, causal=causal, window=window, chunk=chunk, q_offset=q_offset + 1
    )


def _layer_check(torch, readings):
    """Prefill attention that launches the kernel and holds each layer's
    output against the plain version in f32, and against the same with the
    causal edge off by one, on the activations the layer is given."""

    from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref
    from repro_torch.models.attention import chunked_attention

    def checked(q, k, v, *, causal=True, window=None, **kw):
        out = chunked_attention(q, k, v, causal=causal, window=window, **kw)
        ref = flash_attention_bshd_ref(
            q.float(), k.float(), v.float(), causal=causal, window=window
        )
        sound = row_rel_err(out, ref)
        del ref
        fault = row_rel_err(
            out,
            masked_attention(
                torch, q, k, v,
                keep_mask(torch, q.shape[1], k.shape[1], causal, window, q.device, edge=1),
            ),
        )
        readings.append((sound, fault))
        return out

    return checked


def serve_phase(torch):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_lm import generate, make_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import model_zoo

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = model_zoo.init(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model_zoo.param_count(params)
    waves = [
        make_batch(cfg, SERVE_SLOTS, SERVE_PROMPT, device="cuda", seed=SEED + 1 + w)
        for w in range(SERVE_REQUESTS // SERVE_SLOTS)
    ]
    cache = model_zoo.init_cache(
        cfg, SERVE_SLOTS, SERVE_PROMPT + SERVE_NEW_TOKENS, device="cuda"
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: every count set to 0 just before, read just after
    _reset_counts()
    t0 = time.perf_counter()
    results = [generate(params, cfg, batch, SERVE_NEW_TOKENS, cache=cache) for batch in waves]
    wall_s = time.perf_counter() - t0
    launches, flash_routes, matmul_launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    prefills = len(waves)
    steps = prefills * (SERVE_NEW_TOKENS - 1)
    check(
        launches == cfg.num_layers * (prefills + steps),
        f"serve: {launches} flash launches, expected {cfg.num_layers} x ({prefills} + {steps})",
    )
    check(  # the prefills on tma_wgmma, the decode steps' attention on flash_decode
        flash_routes["tma_wgmma"] == cfg.num_layers * prefills
        and flash_routes["flash_decode"] == cfg.num_layers * steps,
        f"serve: flash routes {flash_routes}, expected {cfg.num_layers * prefills} on "
        f"tma_wgmma and {cfg.num_layers * steps} on flash_decode",
    )
    check(  # the projections are torch.matmul, as the reference leaves them to XLA
        matmul_launches == 0,
        f"serve: {matmul_launches} pipelined-matmul launches, expected none",
    )
    for r in results:
        check(
            tuple(r.tokens.shape) == (SERVE_SLOTS, SERVE_NEW_TOKENS),
            f"serve: tokens of shape {tuple(r.tokens.shape)}",
        )
        check(bool(torch.isfinite(r.prefill_logits.float()).all()), "serve: non-finite logits")
        check(
            int(r.tokens.min()) >= 0 and int(r.tokens.max()) < cfg.vocab_size,
            "serve: a token outside the vocabulary",
        )

    # the first wave again, its prefill and decode attention the plain
    # version; then its prefill with the plain version's causal edge off by
    # one, which the same check must fail
    from repro_torch.models.attention import chunked_attention_plain

    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    with _attention_replaced(chunked_attention_plain, plain_decode=True):
        plain = generate(params, cfg, waves[0], SERVE_NEW_TOKENS, cache=cache)
    with _attention_replaced(_causal_edge_off_by_one):
        faulty, cache = prefill_step(params, waves[0], cache)
    a = results[0].prefill_logits.float()[..., : cfg.vocab_size]
    b = plain.prefill_logits.float()[..., : cfg.vocab_size]
    c = faulty.float()[..., : cfg.vocab_size]
    rel = ((a - b).norm() / b.norm()).item()
    max_err = (a - b).abs().max().item()
    fault_rel = ((c - b).norm() / b.norm()).item()
    check(rel <= SERVE_LOGIT_RTOL, f"serve: logits differ from the plain rerun by {rel} (relative L2)")
    check(
        fault_rel > SERVE_LOGIT_RTOL,
        f"serve: the planted causal-edge fault moves the logits by {fault_rel}, "
        f"inside the limit {SERVE_LOGIT_RTOL}: the check cannot see it",
    )
    agree = int((results[0].tokens == plain.tokens).sum())
    del faulty

    # every layer's kernel output against the plain version, on the first
    # wave's own activations
    layers = []
    with _attention_replaced(_layer_check(torch, layers)):
        prefill_step(params, waves[0], cache)
    layer_err = max(r[0] for r in layers)
    layer_fault = min(r[1] for r in layers)
    check(len(layers) == cfg.num_layers, f"serve: {len(layers)} attention layers checked")
    check(layer_err <= ROW_TOL["bf16"], f"serve: a layer's attention reads {layer_err} > {ROW_TOL['bf16']}")
    check(
        layer_fault > ROW_TOL["bf16"],
        f"serve: a layer's planted causal-edge fault reads {layer_fault}, "
        f"inside the limit {ROW_TOL['bf16']}: the check cannot see it",
    )

    # one decode wave timed, then again under the profiler for the busy
    # time: the idle share is taken against the unprofiled wall time
    logits, cache = prefill_step(params, waves[0], cache)
    first = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)

    # every layer's decode attention at the wave's first step against the
    # plain version, on the layer's own q and cache (its slots past the
    # live keys hold the earlier waves' keys)
    decode_layers = []
    before = _read_counts()[1]["flash_decode"]
    with _decode_checked(torch, decode_layers):
        serve_step(params, first, cache, SERVE_PROMPT)
    took = _read_counts()[1]["flash_decode"] - before
    decode_layer_err = max(decode_layers)
    check(len(decode_layers) == cfg.num_layers == took,
          f"serve: {len(decode_layers)} decode attention layers checked, {took} on flash_decode")
    check(decode_layer_err <= ROW_TOL["bf16"],
          f"serve: a layer's decode attention reads {decode_layer_err} > {ROW_TOL['bf16']}")

    def decode_wave():
        nonlocal cache
        cur = first
        for i in range(SERVE_NEW_TOKENS - 1):
            cur, cache = serve_step(params, cur, cache, SERVE_PROMPT + i)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_wave()
    torch.cuda.synchronize()
    wave_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, prof_wall_ms, n_events = _profiled_run(torch, decode_wave)

    prefill_ms = [r.prefill_ms for r in results]
    decode_ms = [t for r in results for t in r.decode_ms]
    tokens = SERVE_REQUESTS * SERVE_NEW_TOKENS
    row = {
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "dtype": cfg.dtype,
        "params": n_params,
        "init_s": init_s,
        "requests": SERVE_REQUESTS,
        "slots": SERVE_SLOTS,
        "prompt_tokens": SERVE_PROMPT,
        "new_tokens": SERVE_NEW_TOKENS,
        "flash_launches": launches,
        "flash_routes": flash_routes,
        "pipelined_matmul_launches": matmul_launches,
        "prefill_ms": prefill_ms,
        "decode_ms_per_step_median": statistics.median(decode_ms),
        "decode_ms_per_step_min": min(decode_ms),
        "decode_ms_per_step_max": max(decode_ms),
        "decode_tokens_per_s": SERVE_SLOTS * len(decode_ms) / (sum(decode_ms) / 1e3),
        "tokens_per_s_end_to_end": tokens / wall_s,
        "prefill_tokens_per_s": SERVE_SLOTS * SERVE_PROMPT / (statistics.median(prefill_ms) / 1e3),
        "wall_s": wall_s,
        "peak_memory_bytes": peak,
        "logits_vs_plain_rel_l2": rel,
        "logits_vs_plain_max_abs": max_err,
        "logits_rel_l2_limit": SERVE_LOGIT_RTOL,
        "logits_planted_fault_rel_l2": fault_rel,
        "layers_max_row_rel_err": layer_err,
        "layers_min_planted_fault": layer_fault,
        "layers_row_rel_limit": ROW_TOL["bf16"],
        "decode_layers_max_row_rel_err": decode_layer_err,
        "greedy_tokens_agreeing_with_plain": agree,
        "greedy_tokens_compared": plain.tokens.numel(),
        "decode_wave_wall_ms": wave_ms,
        "decode_wave_profiled_wall_ms": prof_wall_ms,
        "decode_wave_device_busy_ms": busy_ms,
        "decode_wave_idle_share": (
            1.0 - busy_ms / wave_ms if busy_ms is not None else None
        ),
        "decode_device_events_per_step": n_events / (SERVE_NEW_TOKENS - 1),
    }
    emit("serve: " + json.dumps(row))
    PHASE7.update(tokens=results[0].tokens.cpu(), decode_ms_median=statistics.median(decode_ms))
    del params, cache, results, plain
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------- #
# Phase 7b: granite-3-2b training, the training slice's main path
# ---------------------------------------------------------------------- #

def _flash_count():
    from repro_torch.kernels.flash_attention import ops

    return ops.flash_attention.launches


def _plain_count():
    from repro_torch.obs import metrics

    return metrics.counter("attention.train_plain_calls").value


def _clock(torch, marks):
    """A failure injector that fails nothing: it stamps the host clock at
    the start of each step (the loop reads each step's loss, so a step
    starts after the device finished the last one)."""

    def stamp(step):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    return stamp


def _step_readings(p0, got, ref, b1):
    """Parity readings of one train step's result ``got`` against ``ref``,
    both (params, opt state, metrics) from the params ``p0``: relative
    errors of the loss and grad norm; the largest change of an element's
    update (params after minus ``p0``) in units of the reference's lr,
    where the reference's gradient (``mu / (1 - b1)`` after one step) is at
    least ``CLEAR_GRAD`` and anywhere; and the largest relative L2 error of
    a leaf's mu and nu.  Beside them, unchecked: the largest relative L2
    error of a leaf's whole update, the leaf each reading comes from, and
    the elements whose gradient is below ``CLEAR_GRAD``."""

    from repro_torch import tree as tree_lib

    import torch

    (pa, sa, ma), (pb, sb, mb) = got, ref
    dev = tree_lib.leaves(pa)[0].device
    lr = float(mb["lr"])

    def rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)

    def f64(t):
        # on the device of ``got`` (the card), where either side lies: moved
        # in its own dtype, widened there (exact either way; a host-side
        # widening of a whole-model leaf is the slow part)
        return t.to(dev).to(torch.float64)

    worst, where = {}, {}

    def note(key, value, path):
        value = math.inf if math.isnan(value) else value  # NaN reads as off the limit
        if value >= worst.get(key, 0.0):
            worst[key], where[key] = value, "/".join(map(str, path))

    unclear = 0
    for (path, a), b, x, g in zip(
        tree_lib.flatten_with_paths(pa), tree_lib.leaves(pb), tree_lib.leaves(p0),
        tree_lib.leaves(sb.mu),
    ):
        x = f64(x)
        da, db = f64(a) - x, f64(b) - x
        err = (da - db).abs() / lr
        clear = f64(g).abs() / (1 - b1) >= CLEAR_GRAD
        unclear += int((~clear).sum())
        note("update_any", err.max().item(), path)
        note("update", err[clear].max().item() if clear.any() else 0.0, path)
        note("update_rel_l2", ((da - db).norm() / max(db.norm().item(), 1e-30)).item(), path)
    for key in ("mu", "nu"):
        for (path, a), b in zip(
            tree_lib.flatten_with_paths(getattr(sa, key)), tree_lib.leaves(getattr(sb, key))
        ):
            b = f64(b)
            note(key, ((f64(a) - b).norm() / max(b.norm().item(), 1e-30)).item(), path)
    readings = {"loss": rel(ma["loss"], mb["loss"]), "grad_norm": rel(ma["grad_norm"], mb["grad_norm"])}
    readings.update({k: worst[k] for k in ("update", "update_any", "mu", "nu")})
    readings["unchecked"] = {
        "update_rel_l2": worst["update_rel_l2"],
        "elements_below_clear_grad": unclear,
        "worst_leaf": where,
    }
    return readings


def _parity(torch, cfg):
    """One ``make_train_step`` on the card against the same step on the CPU
    from the same params and batch (f32, TF32 off), within
    ``TRAIN_PARITY_TOL``; then the step on the card with a planted fault,
    which must read above it: the output projection's grad scaled by 1.01
    (through the ``grad_compressor`` hook), and, apart, the causal mask
    broken: train-mode attention's dropped, or in an attention-free stack
    the SSD's moved one step forward within a chunk."""

    from unittest import mock

    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import DataConfig, DataState, make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import attention, mamba, model_zoo
    from repro_torch.optim.optimizer import AdamW

    opt = AdamW(learning_rate=TRAIN_LR, warmup_steps=0, total_steps=10)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # TF32 off, on both sides
    try:
        params = model_zoo.init(cfg, device="cuda", seed=SEED)
        host = tree_lib.tree_map(lambda t: t.cpu(), params)
        batch = make_batch(DataConfig(1, PARITY_SEQ, seed=SEED), cfg, DataState(SEED, 0))
        cuda_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        cpu_batch = {k: torch.from_numpy(v) for k, v in batch.items()}

        def on_cuda(**kw):
            return make_train_step(cfg, opt, **kw)(params, opt.init(params), cuda_batch)

        t0 = time.perf_counter()
        ref = make_train_step(cfg, opt)(host, opt.init(host), cpu_batch)
        cpu_s = time.perf_counter() - t0
        sound = _step_readings(host, on_cuda(), ref, opt.b1)

        head = "head" if "head" in params["embed"] else "tok"  # tied: the embedding

        def scaled_head(grads, opt_state):
            grads["embed"][head] = grads["embed"][head] * 1.01
            return grads, opt_state

        plain = attention.chunked_attention_plain

        def no_causal(q, k, v, *, causal=True, **kw):
            return plain(q, k, v, causal=False, **kw)

        def leaky_segsum(a):  # the SSD's causal edge one step forward
            Q = a.shape[-1]
            cum = torch.cumsum(a, dim=-1)
            keep = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device), diagonal=1)
            return (cum[..., :, None] - cum[..., None, :]).masked_fill(~keep, mamba.NEG_INF)

        grad_fault = _step_readings(host, on_cuda(grad_compressor=scaled_head), ref, opt.b1)
        if _attention_calls(cfg):
            masked = mock.patch.object(attention, "chunked_attention_plain", no_causal)
        else:
            masked = mock.patch.object(mamba, "_segsum", leaky_segsum)
        with masked:
            mask_fault = _step_readings(host, on_cuda(), ref, opt.b1)
    finally:
        torch.set_float32_matmul_precision(precision)
    del params
    row = {
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "dtype": cfg.dtype,
        "tokens": PARITY_SEQ,
        "float32_matmul_precision": "highest",
        "cpu_threads": torch.get_num_threads(),
        "cpu_step_s": cpu_s,
        "readings": sound,
        "limits": TRAIN_PARITY_TOL,
        "clear_grad": CLEAR_GRAD,
        "planted_head_grad_x1_01": grad_fault,
        "planted_head_leaf": f"embed/{head}",
        "planted_causal_mask_dropped": mask_fault,
        "planted_mask": "attention" if _attention_calls(cfg) else "ssd causal edge +1",
    }
    # the row first, so that a failed check leaves its readings behind
    emit("train parity: " + json.dumps(row))
    over = {k: sound[k] for k in TRAIN_PARITY_TOL if sound[k] > TRAIN_PARITY_TOL[k]}
    check(not over, f"train parity: {over} above the limits {TRAIN_PARITY_TOL}")
    for name, fault in (("head grad x 1.01", grad_fault), ("causal mask dropped", mask_fault)):
        check(
            any(fault[k] > TRAIN_PARITY_TOL[k] for k in TRAIN_PARITY_TOL),
            f"train parity: the planted fault ({name}) reads {fault}, inside "
            f"the limits {TRAIN_PARITY_TOL}: the check cannot see it",
        )
    return row


def _resume_and_recovery(torch, cfg):
    """At a cut depth: 6 straight steps against 3 steps, a restore and 3
    more, and a ``WorkerFailure`` at step 4 with ``ckpt_every=2``, under
    deterministic algorithms (the embedding's backward otherwise adds with
    atomics), the losses after the restore within ``RESUME_RTOL``."""

    import os
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.optimizer import AdamW
    from repro_torch.runtime.fault_tolerance import WorkerFailure
    from repro_torch.runtime.trainer import train_loop

    dc = DataConfig(global_batch=RESUME_BATCH, seq_len=RESUME_SEQ, seed=SEED)
    opt = AdamW(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=6)
    kw = dict(opt=opt, seed=SEED, device="cuda")
    fired = []

    def fail_at_4(step):
        if step == 4 and not fired:
            fired.append(step)
            raise WorkerFailure("w0")

    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            straight = train_loop(cfg, dc, total_steps=6, **kw)
            t1 = time.perf_counter()
            mgr = CheckpointManager(Path(d) / "resume", keep=1)
            first = train_loop(cfg, dc, total_steps=3, ckpt=mgr, ckpt_every=3, **kw)
            second = train_loop(cfg, dc, total_steps=6, ckpt=mgr, ckpt_every=3, **kw)
            mgr.close()
            t2 = time.perf_counter()
            mgr = CheckpointManager(Path(d) / "recover", keep=1)
            recovered = train_loop(cfg, dc, total_steps=6, ckpt=mgr, ckpt_every=2,
                                   failure_injector=fail_at_4, **kw)
            mgr.close()
            t3 = time.perf_counter()
    finally:
        torch.use_deterministic_algorithms(False)
    resumed = first.losses + second.losses

    def err(xs):
        return max(abs(a - b) / abs(b) for a, b in zip(xs, straight.losses))

    check(len(resumed) == 6 and second.final_step == 6, f"resume: {len(resumed)} steps")
    # steps 0-3, the failure, then steps 4-5 from the step-4 snapshot
    check(recovered.restarts == 1 and recovered.final_step == 6 and len(recovered.losses) == 6,
          f"recovery: restarts {recovered.restarts}, final step {recovered.final_step}")
    check(err(resumed) <= RESUME_RTOL, f"resume: losses differ by {err(resumed)}")
    check(err(recovered.losses) <= RESUME_RTOL,
          f"recovery: losses differ by {err(recovered.losses)}")
    return {
        "layers": cfg.num_layers,
        "dtype": cfg.dtype,
        "tokens_per_step": RESUME_BATCH * RESUME_SEQ,
        "straight_losses": straight.losses,
        "resumed_losses": resumed,
        "recovered_losses": recovered.losses,
        "restarts": recovered.restarts,
        "final_step": recovered.final_step,
        "resume_max_rel_err": err(resumed),
        "recovery_max_rel_err": err(recovered.losses),
        "rtol": RESUME_RTOL,
        "straight_s": t1 - t0,
        "resume_s (2 checkpoints)": t2 - t1,
        "recovery_s (3 checkpoints)": t3 - t2,
    }


def _train_attention_ms(torch, cfg):
    """One layer's train-mode attention at the phase's shape, alone: the
    plain version's forward under autograd and its backward, each the
    median of 3 between CUDA events after a warm-up."""

    from repro_torch.models.attention import chunked_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def make(heads):
        x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, heads, hd), generator=gen, device="cuda")
        return x.to(torch.bfloat16).requires_grad_(True)

    q, k, v = make(H), make(KV), make(KV)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    fwd, bwd = [], []
    for _ in range(4):
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        out = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
        mid.record()
        torch.autograd.grad(out, (q, k, v), dout)
        end.record()
        end.synchronize()
        fwd.append(start.elapsed_time(mid))
        bwd.append(mid.elapsed_time(end))
        del out
    return statistics.median(fwd[1:]), statistics.median(bwd[1:])


def train_phase(torch):
    """granite-3-2b trained at full width and depth for ``TRAIN_STEPS``
    steps through ``train_loop``; then the device parity check and the
    resume / recovery checks at cut depths."""

    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, DataState, make_batch
    from repro_torch.kernels.pipelined_matmul import ops as matmul_ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo
    from repro_torch.optim.optimizer import AdamW
    from repro_torch.runtime.trainer import train_loop

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16", f"train: {cfg.remat} / {cfg.dtype}")
    opt = AdamW(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    dc = DataConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the main path: the counts read just before and just after
    flash0, plain0, matmul0 = _flash_count(), _plain_count(), matmul_ops.matmul.launches
    marks = []
    res = train_loop(cfg, dc, total_steps=TRAIN_STEPS, opt=opt, seed=SEED,
                     failure_injector=_clock(torch, marks), device="cuda")
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    flash = _flash_count() - flash0
    plain_calls = _plain_count() - plain0
    matmul_launches = matmul_ops.matmul.launches - matmul0
    peak = torch.cuda.max_memory_allocated()
    losses = res.losses
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    params, opt_state = res.state["params"], res.state["opt"]
    n_params = model_zoo.param_count(params)
    flops_per_token = model_zoo.model_flops_per_token(params, cfg)
    check(res.final_step == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
          f"train: {res.final_step} steps, {len(losses)} losses")
    check(all(math.isfinite(l) for l in losses), f"train: a loss is not finite: {losses}")
    check(statistics.mean(losses[-3:]) < statistics.mean(losses[:3]),
          f"train: the loss did not fall: {losses}")
    check(peak > 30e9, f"train: peak memory {peak} bytes: the 31.6e9-byte state was not held")
    check(flash == 0, f"train: {flash} flash launches in training (the kernel has no backward)")
    check(matmul_launches == 0, f"train: {matmul_launches} pipelined-matmul launches")
    # remat "full": each layer's attention once forward, once recomputed
    check(plain_calls == 2 * cfg.num_layers * TRAIN_STEPS,
          f"train: {plain_calls} plain attention calls, expected "
          f"{2 * cfg.num_layers * TRAIN_STEPS}")

    # the update alone, on the trained state (grads of the params' dtypes)
    grads = tree_lib.tree_map(lambda p: torch.full_like(p, 1e-4), params)
    update_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = opt.update(grads, opt_state, params)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        del out
    del grads

    # one more step under the profiler for the device's idle share
    batch = {
        k: torch.from_numpy(v).cuda()
        for k, v in make_batch(dc, cfg, DataState(SEED, TRAIN_STEPS)).items()
    }
    step_fn = make_train_step(cfg, opt)

    def one_step():
        nonlocal params, opt_state
        params, opt_state, _ = step_fn(params, opt_state, batch)

    busy_ms, prof_wall_ms, n_events = _profiled_run(torch, one_step)
    state = {"params": params, "opt": opt_state}
    del params, opt_state, res
    _launch_train_check(torch, cfg, opt, state, batch)  # phase 7h (b)
    del state, batch
    torch.cuda.empty_cache()

    attn_fwd_ms, attn_bwd_ms = _train_attention_ms(torch, cfg)
    torch.cuda.empty_cache()

    timed = step_ms[2:]
    step_s = statistics.median(timed) / 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row = {
        "cell": "granite3_2b_train_4x2048",
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "dtype": cfg.dtype,
        "remat": cfg.remat,
        "params": n_params,
        "global_batch": TRAIN_BATCH,
        "seq_len": TRAIN_SEQ,
        "lr": TRAIN_LR,
        "warmup_steps": TRAIN_WARMUP,
        "steps": TRAIN_STEPS,
        "losses": losses,
        "step_ms": step_ms,
        "step_ms_median_steps_3_to_8": statistics.median(timed),
        "tokens_per_s": tokens / step_s,
        "model_flops_per_token": flops_per_token,
        "model_tflops": flops_per_token * tokens / step_s / 1e12,
        "bf16_peak_tflops": PEAK_FLOPS["bf16"] / 1e12,
        "model_flops_share_of_bf16_peak": flops_per_token * tokens / step_s / PEAK_FLOPS["bf16"],
        "peak_memory_bytes": peak,
        "adamw_update_ms": update_ms,
        "profiled_step_wall_ms": prof_wall_ms,
        "profiled_step_device_busy_ms": busy_ms,
        "step_idle_share": (
            1.0 - busy_ms / statistics.median(timed) if busy_ms is not None else None
        ),
        "profiled_step_device_events": n_events,
        "attention_layer_forward_ms": attn_fwd_ms,
        "attention_layer_backward_ms": attn_bwd_ms,
        # remat "full": each layer's attention runs forward twice a step
        "attention_ms_per_step_estimate": cfg.num_layers * (2 * attn_fwd_ms + attn_bwd_ms),
        "attention_train_plain_calls": plain_calls,
        "flash_launches": flash,
        "pipelined_matmul_launches": matmul_launches,
    }
    emit("train: " + json.dumps(row))
    _parity(torch, cfg.scaled(num_layers=PARITY_LAYERS, dtype="float32"))
    resume = _resume_and_recovery(torch, cfg.scaled(num_layers=RESUME_LAYERS))
    emit("train resume: " + json.dumps(resume))
    emit(f"train phase: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------- #
# Phases 7c-7e: the MoE, Mamba-2 and encoder-decoder families
# ---------------------------------------------------------------------- #

def _reset_counts():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.pipelined_matmul import ops as matmul_ops

    flash_ops.flash_attention.launches = 0
    flash_ops.flash_attention.routes = dict.fromkeys(flash_ops.flash_attention.routes, 0)
    matmul_ops.matmul.launches = 0


def _read_counts():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.pipelined_matmul import ops as matmul_ops

    return (flash_ops.flash_attention.launches, dict(flash_ops.flash_attention.routes),
            matmul_ops.matmul.launches)


def _zeroed(cache):
    """``cache`` with every entry zeroed, as ``generate`` starts a reused
    cache: a Mamba layer's prefill starts from the state the cache holds."""

    from repro_torch import tree as tree_lib

    for t in tree_lib.leaves(cache):
        t.zero_()
    return cache


def _attention_fault(q, k, v, *, causal=True, window=None, chunk=1024, q_offset=0):
    """The plain version with a planted fault that the last position's
    logits see: a causal call's edge one key back (each query loses its
    own key), a non-causal call's last key dropped."""

    from repro_torch.models.attention import chunked_attention_plain

    if causal:
        return chunked_attention_plain(
            q, k, v, causal=True, window=window, chunk=chunk, q_offset=q_offset - 1
        )
    return chunked_attention_plain(
        q, k[:, :-1], v[:, :-1], causal=False, window=window, chunk=chunk, q_offset=q_offset
    )


def _routes_recorded(recorded):
    """``moe._route`` passing through, each call's (one-hot experts, slots,
    kept) appended to ``recorded`` in call order."""

    from repro_torch.models import moe

    route = moe._route

    def recording(params, xg, mc, C):
        out = route(params, xg, mc, C)
        recorded.append(out[2:])
        return out

    return recording


def _routes_pinned(torch, recorded):
    """``moe._route`` taking each call's experts, slots and drops from
    ``recorded`` (a run's, in call order) and the weights from its own
    router probabilities at those experts: a rerun whose attention differs
    routes every (token, k) pair as the recorded run did."""

    calls = iter(recorded)

    def pinned(params, xg, mc, C):
        onehot, pos, keep = next(calls)
        probs = torch.softmax(torch.matmul(xg.float(), params["router"]), dim=-1)
        top_p = (probs[:, :, None, :] * onehot).sum(-1)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        return probs, top_p, onehot, pos, keep

    return pinned


def _logit_rel(a, b, vocab) -> float:
    a, b = a.float()[..., :vocab], b.float()[..., :vocab]
    return ((a - b).norm() / b.norm()).item()


def _family_serve(torch, label, cfg, *, requests, slots, prompt, new_tokens,
                  flash_per_prefill, flash_per_step, tally=None, logits_fault_held=True,
                  flash_routes=None):
    """Phase 7's serving run for one configuration at full width: random
    bf16 weights from ``SEED``, ``requests`` prompts in waves of ``slots``
    through ``generate`` (the main path: every count set to 0 just before,
    read just after), the flash launches it must make (``flash_per_prefill``
    a prefill on ``tma_wgmma``, ``flash_per_step`` a decode step on
    ``flash_decode``, unless ``flash_routes`` gives the launches of each
    route) and no
    pipelined-matmul launch; where it launches the kernel, the first
    wave's prefill logits against a rerun whose attention is the plain
    version and one with a planted fault (:func:`_attention_fault`); one
    decode wave timed, and its first ``PROFILED_STEPS`` steps profiled for
    the idle share.  ``tally``, a
    chunked_attention wrapper, observes the main path's calls.  With
    ``logits_fault_held`` false the planted fault's logits reading is
    printed, not held (a model whose attention carries too little of the
    residual for any attention fault to move its logits past the limit; its
    per-layer check holds the fault instead).  Returns (row, params, waves,
    cache, results)."""

    from repro_torch.launch.serve_lm import generate, make_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import model_zoo
    from repro_torch.models.attention import chunked_attention_plain

    t0 = time.perf_counter()
    params = model_zoo.init(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    waves = [
        make_batch(cfg, slots, prompt, device="cuda", seed=SEED + 1 + w)
        for w in range(requests // slots)
    ]
    cache = model_zoo.init_cache(cfg, slots, prompt + new_tokens, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: every count set to 0 just before, read just after
    _reset_counts()
    t0 = time.perf_counter()
    if tally is None:
        results = [generate(params, cfg, b, new_tokens, cache=cache) for b in waves]
    else:
        with _attention_replaced(tally):
            results = [generate(params, cfg, b, new_tokens, cache=cache) for b in waves]
    wall_s = time.perf_counter() - t0
    launches, routes, matmul_launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect = len(waves) * (flash_per_prefill + (new_tokens - 1) * flash_per_step)
    check(launches == expect, f"{label}: {launches} flash launches, expected {expect}")
    want_routes = flash_routes or {
        "tma_wgmma": len(waves) * flash_per_prefill,
        "flash_decode": len(waves) * (new_tokens - 1) * flash_per_step,
    }
    check({r: n for r, n in routes.items() if n} == {r: n for r, n in want_routes.items() if n},
          f"{label}: flash routes {routes}, expected {want_routes}")
    check(matmul_launches == 0, f"{label}: {matmul_launches} pipelined-matmul launches, expected none")
    for r in results:
        check(tuple(r.tokens.shape) == (slots, new_tokens), f"{label}: tokens of shape {tuple(r.tokens.shape)}")
        check(bool(torch.isfinite(r.prefill_logits.float()).all()), f"{label}: non-finite logits")
        check(int(r.tokens.min()) >= 0 and int(r.tokens.max()) < cfg.vocab_size,
              f"{label}: a token outside the vocabulary")

    prefill_ms = [r.prefill_ms for r in results]
    decode_ms = [t for r in results for t in r.decode_ms]
    row = {
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "dtype": cfg.dtype,
        "params": model_zoo.param_count(params),
        "init_s": init_s,
        "requests": requests,
        "slots": slots,
        "prompt_tokens": prompt,
        "new_tokens": new_tokens,
        "flash_launches": launches,
        "flash_routes": routes,
        "pipelined_matmul_launches": matmul_launches,
        "prefill_ms": prefill_ms,
        "decode_ms_per_step_median": statistics.median(decode_ms),
        "decode_ms_per_step_min": min(decode_ms),
        "decode_ms_per_step_max": max(decode_ms),
        "decode_tokens_per_s": slots * len(decode_ms) / (sum(decode_ms) / 1e3),
        "tokens_per_s_end_to_end": requests * new_tokens / wall_s,
        "prefill_tokens_per_s": slots * prompt / (statistics.median(prefill_ms) / 1e3),
        "wall_s": wall_s,
        "peak_memory_bytes": peak,
    }

    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    t_checks = time.perf_counter()
    if launches:
        # the first wave's prefill again, its attention the plain version;
        # then with the planted fault, which the same check must fail.  A
        # MoE layer's top-k choice jumps where a router near-tie flips, and
        # the kernel and the plain version round apart in bf16: so the
        # reruns of a MoE configuration route every (token, k) pair as a
        # rerun with the kernel did (_routes_pinned), and only attention
        # differs between them
        from unittest import mock

        from repro_torch.models import moe

        kernel = results[0].prefill_logits
        route = mock.patch.object(moe, "_route", moe._route)
        if cfg.has_moe:
            recorded = []
            with mock.patch.object(moe, "_route", _routes_recorded(recorded)):
                again, cache = prefill_step(params, waves[0], _zeroed(cache))
            row["kernel_rerun_logits_bit_equal"] = bool(torch.equal(again, kernel))
            kernel = again
            route = mock.patch.object(moe, "_route", _routes_pinned(torch, recorded))
        with _attention_replaced(chunked_attention_plain), route:
            plain, cache = prefill_step(params, waves[0], _zeroed(cache))
        if cfg.has_moe:
            route = mock.patch.object(moe, "_route", _routes_pinned(torch, recorded))
        with _attention_replaced(_attention_fault), route:
            faulty, cache = prefill_step(params, waves[0], _zeroed(cache))
        rel = _logit_rel(kernel, plain, cfg.vocab_size)
        fault_rel = _logit_rel(faulty, plain, cfg.vocab_size)
        row.update(logits_vs_plain_rel_l2=rel, logits_rel_l2_limit=SERVE_LOGIT_RTOL,
                   logits_planted_fault_rel_l2=fault_rel,
                   logits_planted_fault_held=logits_fault_held)
        check(rel <= SERVE_LOGIT_RTOL, f"{label}: logits differ from the plain rerun by {rel} (relative L2)")
        check(not logits_fault_held or fault_rel > SERVE_LOGIT_RTOL,
              f"{label}: the planted attention fault moves the logits by {fault_rel}, "
              f"inside the limit {SERVE_LOGIT_RTOL}: the check cannot see it")
        del plain, faulty, kernel
        recorded = None
    if launches and cfg.family == "decoder":
        # every attention layer's kernel output against the plain version
        # on the first wave's own activations, and against the same with
        # the causal edge off by one (phase 7's per-layer check)
        layers = []
        with _attention_replaced(_layer_check(torch, layers)):
            prefill_step(params, waves[0], _zeroed(cache))
        n_attn = sum(p.mixer != "mamba" for p in cfg.block) * cfg.num_blocks
        layer_err = max(r[0] for r in layers)
        layer_fault = min(r[1] for r in layers)
        row.update(layers_max_row_rel_err=layer_err, layers_min_planted_fault=layer_fault,
                   layers_row_rel_limit=ROW_TOL["bf16"])
        check(len(layers) == n_attn, f"{label}: {len(layers)} attention layers checked of {n_attn}")
        check(layer_err <= ROW_TOL["bf16"], f"{label}: a layer's attention reads {layer_err} > {ROW_TOL['bf16']}")
        check(layer_fault > ROW_TOL["bf16"],
              f"{label}: a layer's planted causal-edge fault reads {layer_fault}, "
              f"inside the limit {ROW_TOL['bf16']}: the check cannot see it")

    row["attention_checks_s"] = time.perf_counter() - t_checks

    # one decode wave timed, then again under the profiler for the busy
    # time: the idle share is taken against the unprofiled wall time
    logits, cache = prefill_step(params, waves[0], _zeroed(cache))
    first = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    state = {}

    def decode_wave(steps=new_tokens - 1):
        c = state.get("cache", cache)
        cur = first
        for i in range(steps):
            cur, c = serve_step(params, cur, c, prompt + i)
        state["cache"] = c

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # the profiler's cost grows with its events (2000-4000 a step here), so
    # it traces the wave's first PROFILED_STEPS steps, read against the
    # same steps unprofiled
    wave_ms = timed(decode_wave)
    part = lambda: decode_wave(PROFILED_STEPS)  # noqa: E731
    part_ms = timed(part)
    t0 = time.perf_counter()
    busy_ms, prof_wall_ms, n_events = _profiled_run(torch, part)
    row.update(
        profile_s=time.perf_counter() - t0,
        decode_wave_wall_ms=wave_ms,
        profiled_steps=PROFILED_STEPS,
        profiled_steps_wall_ms=part_ms,
        profiled_steps_profiled_wall_ms=prof_wall_ms,
        profiled_steps_device_busy_ms=busy_ms,
        decode_idle_share=(1.0 - busy_ms / part_ms if busy_ms is not None else None),
        decode_device_events_per_step=n_events / PROFILED_STEPS,
    )
    return row, params, waves, cache, results


def _moe_checks(torch, cfg, params, batch, cache):
    """7c's MoE readings on the first wave's own activations: the share of
    (token, k) pairs each layer's capacity drops at the configured
    ``capacity_factor``, and layer 0's ``moe_apply`` with the capacity
    raised so that nothing drops against ``moe_reference``: the largest
    row-relative L2 error within ``ROW_TOL["bf16"]``, and with one expert's
    output lost (the most loaded expert's ``w_down`` zeroed), which must
    read above it."""

    import dataclasses
    from unittest import mock

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe

    mc = cfg.moe
    apply = moe.moe_apply
    drops, inputs = [], []

    def observed(p, x, c):
        tokens = x.shape[0] * x.shape[1]
        G = min(mc.group_size, tokens)
        *_, keep = moe._route(p, x.reshape(tokens // G, G, -1), mc, moe._capacity(mc, G))
        drops.append(1.0 - keep.float().mean().item())
        if not inputs:
            inputs.append(x.clone())
        return apply(p, x, c)

    with mock.patch.object(moe, "moe_apply", observed):
        make_prefill_step(cfg)(params, batch, _zeroed(cache))
    x = inputs[0]
    lp = params["blocks"][0]["pos0"]["moe"]
    tokens = x.shape[0] * x.shape[1]
    G = min(mc.group_size, tokens)
    _, _, onehot, _, _ = moe._route(lp, x.reshape(tokens // G, G, -1), mc, 1)
    load = onehot.sum(dim=(1, 2))  # (n, E): the pairs each expert takes in each group
    factor = (float(load.max()) + 1) * mc.num_experts / (G * mc.top_k)
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(mc, capacity_factor=factor))
    check(moe._capacity(roomy.moe, G) >= float(load.max()), "moe: the raised capacity still drops")
    with torch.inference_mode():
        y, _ = moe.moe_apply(lp, x, roomy)
        ref = moe.moe_reference(lp, x, roomy)
        err = row_rel_err(y, ref)
        busiest = int(onehot.sum(dim=(0, 1, 2)).argmax())
        w_down = lp["w_down"].clone()
        w_down[busiest] = 0
        fault = row_rel_err(moe.moe_apply(dict(lp, w_down=w_down), x, roomy)[0], ref)
    del y, ref, w_down
    check(err <= ROW_TOL["bf16"], f"moe: moe_apply reads {err} against moe_reference > {ROW_TOL['bf16']}")
    check(fault > ROW_TOL["bf16"],
          f"moe: expert {busiest}'s lost output reads {fault}, inside the limit {ROW_TOL['bf16']}: "
          "the check cannot see it")
    return {
        "dropped_pair_share_per_layer": drops,
        "dropped_pair_share": statistics.fmean(drops),
        "capacity_factor": mc.capacity_factor,
        "layer0_no_drop_capacity_factor": factor,
        "layer0_moe_vs_reference_max_row_rel_err": err,
        "layer0_row_rel_limit": ROW_TOL["bf16"],
        "layer0_planted_fault": f"expert {busiest} w_down zeroed",
        "layer0_planted_fault_row_rel_err": fault,
    }


def moe_serve_phase(torch):
    """Phase 7c: deepseek-moe-16b at full size with phase 7's traffic."""

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    row, params, waves, cache, results = _family_serve(
        torch, "moe", cfg, requests=SERVE_REQUESTS, slots=SERVE_SLOTS, prompt=SERVE_PROMPT,
        new_tokens=SERVE_NEW_TOKENS, flash_per_prefill=cfg.num_layers,
        flash_per_step=cfg.num_layers,
    )
    t0 = time.perf_counter()
    row.update(_moe_checks(torch, cfg, params, waves[0], cache))
    row["moe_checks_s"] = time.perf_counter() - t0
    row["phase_s"] = time.perf_counter() - t_phase
    emit("serve moe: " + json.dumps(row))
    del params, cache, results, waves
    torch.cuda.empty_cache()
    return row["flash_launches"]


def _ssd_check(torch):
    """``ssd_chunked`` against ``ssd_reference`` at one mamba2-2.7b layer's
    heads and state, f32 (TF32 off), as the layer draws its inputs at
    initialisation (A = -exp(A_log), dt = softplus(N(0, 1) + dt_bias)):
    held within ``SSD_TOL``.  Beside it, printed and not held, the same at
    tests/test_models.py's draw (dt = softplus(N(0, 1)), A = -exp(0.3 N)):
    over a 256-step chunk its decay sums fall to about -400, and the
    segment sums, differences of those cumulative sums as the reference's
    ``_segsum`` takes them, lose f32 digits."""

    from repro_torch.models import mamba

    B, S, H, P, N = SSD_CHECK
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def excess(a, b):  # the largest |a - b| / (atol + rtol |b|): above 1 fails
        return ((a - b).abs() / (SSD_TOL + SSD_TOL * b.abs())).max().item()

    dt0 = torch.exp(
        torch.rand(H, device="cuda", generator=gen) * (math.log(0.1) - math.log(0.001))
        + math.log(0.001)
    )
    draws = {
        "layer_init": (mamba.softplus(randn(B, S, H) + torch.log(torch.expm1(dt0))),
                       -torch.linspace(1.0, 16.0, H, device="cuda")),
        "test_models": (mamba.softplus(randn(B, S, H)), -torch.exp(randn(H) * 0.3)),
    }
    out = {"ssd_shape": dict(zip("BSHPN", SSD_CHECK)), "ssd_tol": SSD_TOL}
    for name, (dt, A) in draws.items():
        x, Bm, Cm = randn(B, S, H, P), randn(B, S, N), randn(B, S, N)
        with torch.inference_mode():
            y, h = mamba.ssd_chunked(x, dt, A, Bm, Cm, 256)
            y_ref, h_ref = mamba.ssd_reference(x, dt, A, Bm, Cm)
        out[f"ssd_{name}_limit_share"] = {"y": excess(y, y_ref), "state": excess(h, h_ref)}
    held = out["ssd_layer_init_limit_share"]
    check(held["y"] <= 1 and held["state"] <= 1,
          f"mamba: ssd_chunked against ssd_reference reads {held} of the limit")
    return out


def _continuation(torch, cfg, params, batch, cache, f32_params):
    """Decode step t's logits against the last-position logits of a fresh
    prefill over the prompt and the t greedy tokens so far, for each t of
    ``MAMBA_CONTINUATION_STEPS``.  In f32 within ``MAMBA_F32_RTOL``; in
    bf16 against the f32 prefill (``f32_params``, the same weights) of the
    same tokens, within ``MAMBA_BF16_FACTOR`` times the bf16 prefill's
    distance from it.  The planted fault is step t with every layer's SSM
    state zeroed before it (the state not carried), on a copy of the cache,
    and must read above the limit."""

    from repro_torch import tree as tree_lib
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model_zoo

    prefill_step = make_prefill_step(cfg)
    f32_cfg = cfg.scaled(dtype="float32")
    f32_prefill = make_prefill_step(f32_cfg)
    fresh = model_zoo.init_cache(cfg, batch["tokens"].shape[0], 1, device="cuda")
    f32_fresh = model_zoo.init_cache(f32_cfg, batch["tokens"].shape[0], 1, device="cuda")
    out = {}
    with torch.inference_mode():
        logits, cache = prefill_step(params, batch, _zeroed(cache))
        tokens, n = batch["tokens"], batch["tokens"].shape[1]
        for t in range(1, max(MAMBA_CONTINUATION_STEPS) + 1):
            cur = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
            tokens = torch.cat([tokens, cur], dim=1)
            if t in MAMBA_CONTINUATION_STEPS:
                stateless = tree_lib.tree_map(lambda a: a.clone(), cache)
                for b in stateless["blocks"]:
                    b["pos0"]["ssm"].zero_()
                faulty, _ = model_zoo.decode_step(params, cur, cfg, stateless, n)
                del stateless
            logits, cache = model_zoo.decode_step(params, cur, cfg, cache, n)
            n += 1
            if t not in MAMBA_CONTINUATION_STEPS:
                continue
            ref, _ = prefill_step(params, {"tokens": tokens}, _zeroed(fresh))
            reading = {"vs_prefill_rel_l2": _logit_rel(logits, ref, cfg.vocab_size)}
            if cfg.dtype == "float32":
                limit = MAMBA_F32_RTOL
                err = reading["vs_prefill_rel_l2"]
                fault = _logit_rel(faulty, ref, cfg.vocab_size)
            else:
                ref32, _ = f32_prefill(f32_params, {"tokens": tokens}, _zeroed(f32_fresh))
                noise = _logit_rel(ref, ref32, cfg.vocab_size)
                limit = MAMBA_BF16_FACTOR * noise
                err = _logit_rel(logits, ref32, cfg.vocab_size)
                fault = _logit_rel(faulty, ref32, cfg.vocab_size)
                reading.update(prefill_vs_f32_rel_l2=noise, decode_vs_f32_rel_l2=err)
            reading.update(limit=limit, planted_fault_rel_l2=fault)
            out[t] = reading
            check(err <= limit, f"mamba {cfg.dtype}: decode step {t} reads {err} > {limit}")
            check(fault > limit,
                  f"mamba {cfg.dtype}: step {t} without its state reads {fault}, inside the "
                  f"limit {limit}: the check cannot see it")
    return {f"continuation_{cfg.dtype}": out}


def mamba_serve_phase(torch):
    """Phase 7d: mamba2-2.7b at full size with phase 7's traffic, then
    jamba-v0.1 at full width cut to one block of 8 layers."""

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo

    t_phase = time.perf_counter()
    cfg = get_config(MAMBA_ARCH)
    row, params, waves, cache, results = _family_serve(
        torch, "mamba", cfg, requests=SERVE_REQUESTS, slots=SERVE_SLOTS, prompt=SERVE_PROMPT,
        new_tokens=SERVE_NEW_TOKENS, flash_per_prefill=0, flash_per_step=0,
    )
    del results
    # the same weights in f32 (exact; 10.8 GB): the bf16 decode's yardstick,
    # then the continuation itself in f32
    from repro_torch import tree as tree_lib

    t0 = time.perf_counter()
    f32 = cfg.scaled(dtype="float32")
    f32_params = tree_lib.tree_map(lambda a: a.float(), params)
    row.update(_continuation(torch, cfg, params, waves[0], cache, f32_params))
    del params, cache
    torch.cuda.empty_cache()
    cache = model_zoo.init_cache(f32, SERVE_SLOTS, 1, device="cuda")
    row.update(_continuation(torch, f32, f32_params, waves[0], cache, f32_params))
    del f32_params, cache, waves
    torch.cuda.empty_cache()
    row["continuation_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    row.update(_ssd_check(torch))
    row["ssd_check_s"] = time.perf_counter() - t0
    row["phase_s"] = time.perf_counter() - t_phase
    emit("serve mamba: " + json.dumps(row))

    t_phase = time.perf_counter()
    full = get_config(HYBRID_ARCH)
    cfg = full.scaled(num_layers=len(full.block))
    # one attention layer of 8, behind four Mamba layers whose outputs are
    # O(1) a component at random init where a near-uniform attention over
    # 2048 keys gives O(1/45): its planted fault is held at the layer
    row, params, waves, cache, results = _family_serve(
        torch, "hybrid", cfg, requests=HYBRID_REQUESTS, slots=SERVE_SLOTS, prompt=SERVE_PROMPT,
        new_tokens=HYBRID_NEW_TOKENS, flash_per_prefill=1, flash_per_step=1,
        logits_fault_held=False,
    )
    # after the profiled decode wave the cache holds both kinds of state
    block = cache["blocks"][0]
    kinds = {
        f"pos{i}": ("kv" if "k" in c else "ssm",
                    float(c["k"].float().abs().amax()) if "k" in c else float(c["ssm"].abs().amax()))
        for i, c in ((i, block[f"pos{i}"]) for i in range(len(cfg.block)))
    }
    check(all(v > 0 for _, v in kinds.values()), f"hybrid: an empty cache entry: {kinds}")
    check({k for k, _ in kinds.values()} == {"kv", "ssm"}, f"hybrid: cache kinds {kinds}")
    row.update(cut=f"{full.num_layers} layers to one block of {cfg.num_layers}",
               cache_kinds_abs_max=kinds, phase_s=time.perf_counter() - t_phase)
    emit("serve hybrid: " + json.dumps(row))
    del params, cache, results, waves
    torch.cuda.empty_cache()
    return row["flash_launches"]


def _whisper_shapes(torch, cfg, params, batch, cache):
    """Whisper's four call shapes on the first wave's own activations (the
    first encoder call, the first prefill self- and cross-attention calls
    and the first decode step's cross attention): the kernel of each one's
    route against the plain version (largest row-relative error within
    ``ROW_TOL["bf16"]``, with phase 6's planted 64-key tile drop above
    it), the edge probes on both routes at the two cross shapes, then the
    kernel, SDPA, the plain version and, where the route is flash_decode,
    tma_wgmma forced timed in turns beside the kernel's bound, and their device and host times
    (:func:`_held_times`)."""

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bshd_ref
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.attention import chunked_attention

    seen = {}

    def record(q, k, v, *, causal=True, **kw):
        key = (q.shape[1], k.shape[1], causal)
        if key not in seen:
            seen[key] = (q.clone(), k.clone(), v.clone())
        return chunked_attention(q, k, v, causal=causal, **kw)

    with _attention_replaced(record), torch.inference_mode():
        logits, cache = make_prefill_step(cfg)(params, batch, _zeroed(cache))
        first = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        make_serve_step(cfg)(params, first, cache, ENCDEC_PROMPT)
    F, P = cfg.encoder.num_frames, ENCDEC_PROMPT
    names = {(F, F, False): "encoder", (P, P, True): "decoder self prefill",
             (P, F, False): "cross prefill", (1, F, False): "cross decode"}
    check(sorted(seen) == sorted(names), f"encdec: calls of {sorted(seen)} (Sq, Sk, causal)")
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    rows = {}
    for key, name in names.items():
        q, k, v = seen[key]
        causal = key[2]
        B, Sq, H, hd = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        route = ops._route_of(q, k, v)
        out = ops.flash_attention(q, k, v, causal=causal)
        ref = flash_attention_bshd_ref(q.float(), k.float(), v.float(), causal=causal)
        err = (out.float() - ref).abs().max().item()
        rel = row_rel_err(out, ref)
        del ref
        faults = planted_faults(torch, q, k, v, out, causal, None)
        check(rel <= ROW_TOL["bf16"], f"encdec {name}: row relative error {rel} > {ROW_TOL['bf16']}")
        # the dropped 64-key tile is held here; one dropped key of 1500 is
        # printed (a decoder query's weight on one key is near 1/1500 at
        # random init) and held by the exact probes at the cross shapes
        tile = next(f for f in faults if f.startswith("keys "))
        check(faults[tile] > ROW_TOL["bf16"],
              f"encdec {name}: planted fault {tile!r} reads {faults[tile]}, inside the limit "
              f"{ROW_TOL['bf16']}: the check cannot see it")
        probes = _edge_probes(torch, ops, B, Sq, Sk, H, KV, hd) if Sq < 64 and not causal else None
        bound_ms, bound_by, flops = flash_bound(B, Sq, Sk, H, KV, hd, causal, None, "bf16", 2)
        reps = 20 if Sq > 64 else 100
        fns = {
            route: lambda: ops.flash_attention(q, k, v, causal=causal),
            "library": lambda: _sdpa(torch, q, k, v, causal, None),
        }
        if route == "flash_decode":
            fns["tma_wgmma"] = lambda: _tma_call(ops, q, k, v, causal=causal)
        turns = _time_turns_ms(
            torch, [*fns.values(), lambda: flash_attention_bshd_ref(q, k, v, causal=causal)], reps)
        ms, library_ms, plain_ms = turns[0], turns[1], turns[-1]
        held = _held_times(torch, fns, DECODE_REPS, flush)
        rows[name] = {
            "case": f"whisper-medium {name} {Sq}x{Sk}{' causal' if causal else ''}, bf16",
            "kernel_route": route,
            "shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "KV": KV, "hd": hd,
                      "causal": causal, "window": None},
            "max_abs_err": err,
            "max_row_rel_err": rel,
            "row_rel_limit": ROW_TOL["bf16"],
            "planted_faults": faults,
            "one_hot_probes": probes,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "device_ms": held[route]["device_ms"],
            "host_ms": held[route]["host_ms"],
            "library_device_ms": held["library"]["device_ms"],
            "reps": reps,
            "tflops": flops / ms / 1e9,
            "timed_in_turns": ["ms", "library_ms", "plain_ms"],
            "timed_held_cold_l2": ["device_ms", "library_device_ms"],
        }
        if route == "flash_decode":
            rows[name].update(
                tma_wgmma_ms=turns[2],
                timed_in_turns=["ms", "library_ms", "tma_wgmma_ms", "plain_ms"],
                tma_wgmma_device_ms=held["tma_wgmma"]["device_ms"],
                tma_wgmma_host_ms=held["tma_wgmma"]["host_ms"],
                timed_held_cold_l2=["device_ms", "library_device_ms", "tma_wgmma_device_ms"])
        emit("flash: " + json.dumps(rows[name]))
    del flush
    torch.cuda.empty_cache()
    return rows


def _edge_probes(torch, ops, B, Sq, Sk, H, KV, hd):
    """Phase 6's one-hot probes (and with V = I) at a whisper cross shape,
    non-causal, on both routes: on flash_decode their first rows on the
    key before the last key range, its first key and its last tile's keys
    (:func:`probe.split_edge_picks`); on tma_wgmma (forced) on the last
    ragged tile's keys (Sk % 64 of them) and the key before it.  Exact; and
    the plain version with the last key dropped, a planted one-key edge,
    must miss on at least the row that picked it."""

    import numpy as np

    from repro_torch.kernels.flash_attention.probe import one_hot_probe, split_edge_picks

    splits = ops.decode_splits(B, KV, Sk, torch.cuda.get_device_properties(0).multi_processor_count)
    picks = {
        "flash_decode": split_edge_picks(Sk, splits, B * H * Sq),
        "tma_wgmma": Sk - 1 - np.arange(Sk % 64 + 1),
    }
    out = {"ragged_tile_keys": Sk % 64, "splits": splits, "rows": B * H * Sq}
    for route, first_picks in picks.items():
        call = ops.flash_attention if route == "flash_decode" else functools.partial(_tma_call, ops)
        for identity_v in (False, True):
            q, k, v, expected = one_hot_probe(
                B, Sq, Sk, H, KV, hd, causal=False, identity_v=identity_v, seed=SEED,
                first_picks=first_picks,
            )
            q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in (q, k, v))
            expected = torch.from_numpy(expected)
            label = f"{Sq}x{Sk}{', V = I' if identity_v else ''} on {route}"
            before = dict(ops.flash_attention.routes)
            got = call(q, k, v, causal=False).float().cpu()
            took = [r for r, n in ops.flash_attention.routes.items() if n != before[r]]
            check(took == [route], f"edge probe {label}: took {took}")
            differ = int((got != expected).sum())
            check(differ == 0, f"edge probe {label}: {differ} values differ")
            dropped = masked_attention(
                torch, q, k, v, keep_mask(torch, Sq, Sk, False, None, q.device, edge=-1)
            ).cpu()
            missed = int((dropped != expected).any(-1).sum())
            check(missed >= 1, f"edge probe {label}: the last key dropped passes the probe")
            out[f"{route}, {'V = I' if identity_v else 'one-hot'}"] = {
                "exact": True, "planted_last_key_dropped_rows_missed": missed,
            }
    return out


def _decode_ab(torch, cfg, params, batch, cache):
    """Whisper's decode step with flash_decode and, in alternating waves
    in the same process, with tma_wgmma forced (the wrapper's private
    switch): ms a step (a wave's wall time over its steps) in waves in the
    order ``DECODE_AB_ORDER``, each wave's launches on its route; then
    ``PROFILED_STEPS`` steps of each under the profiler for the idle
    share."""

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    logits, cache = prefill_step(params, batch, _zeroed(cache))
    first = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    steps = SERVE_NEW_TOKENS - 1

    def wave(n=steps):
        cur, c = first, cache
        for i in range(n):
            cur, c = serve_step(params, cur, c, ENCDEC_PROMPT + i)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {"flash_decode": {"ms_per_step": []}, "tma_wgmma": {"ms_per_step": []}}
    try:
        for route in DECODE_AB_ORDER:
            ops._decode_route = route == "flash_decode"
            before = dict(ops.flash_attention.routes)
            out[route]["ms_per_step"].append(timed(wave) / steps)
            took = {r: n - before[r] for r, n in ops.flash_attention.routes.items() if n != before[r]}
            # each layer's self (decode_attention) and cross attention
            check(took == {route: 2 * steps * cfg.num_layers},
                  f"decode A/B on {route}: launches {took}")
        for route in out:
            ops._decode_route = route == "flash_decode"
            part_ms = timed(lambda: wave(PROFILED_STEPS))
            busy_ms, prof_wall_ms, n_events = _profiled_run(torch, lambda: wave(PROFILED_STEPS))
            out[route].update(
                profiled_steps_wall_ms=part_ms, profiled_steps_device_busy_ms=busy_ms,
                idle_share=(1.0 - busy_ms / part_ms if busy_ms is not None else None),
                device_events_per_step=n_events / PROFILED_STEPS,
                ms_per_step_median=statistics.median(out[route]["ms_per_step"]),
            )
    finally:
        ops._decode_route = True
    out["ratio_flash_decode_over_tma_wgmma"] = (
        out["flash_decode"]["ms_per_step_median"] / out["tma_wgmma"]["ms_per_step_median"])
    return out


def encdec_serve_phase(torch):
    """Phase 7e: whisper-medium at full size (24 + 24 layers, 1500 random
    frame embeddings a request), a 4-token decoder prompt, 32 new tokens,
    8 requests in waves of 4: the encoder's calls on tma_wgmma, the
    decoder's (the prompt's self attention, its cross attention and the
    decode steps' cross attention) on flash_decode, one launch a call.
    Returns the tma_wgmma launches and the shapes' rows."""

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import chunked_attention

    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    calls = {}

    def tally(q, k, v, *, causal=True, **kw):
        key = (q.shape[1], k.shape[1], causal, ops._route_of(q, k, v))
        calls[key] = calls.get(key, 0) + 1
        return chunked_attention(q, k, v, causal=causal, **kw)

    waves, L, F = SERVE_REQUESTS // SERVE_SLOTS, cfg.num_layers, cfg.encoder.num_frames
    row, params, waves_, cache, results = _family_serve(
        torch, "encdec", cfg, requests=SERVE_REQUESTS, slots=SERVE_SLOTS, prompt=ENCDEC_PROMPT,
        new_tokens=SERVE_NEW_TOKENS, flash_per_prefill=3 * L, flash_per_step=2 * L,
        tally=tally,
        flash_routes={"tma_wgmma": waves * L,
                      "flash_decode": waves * (2 * L + (SERVE_NEW_TOKENS - 1) * 2 * L)},
    )
    # the decode steps' self attention is decode_attention's (flash_decode),
    # which the chunked_attention tally does not see
    self_decode = waves * (SERVE_NEW_TOKENS - 1) * L
    check(sum(calls.values()) + self_decode == row["flash_launches"],
          f"encdec: {sum(calls.values())} attention calls and {self_decode} decode self "
          f"attention calls for {row['flash_launches']} launches")
    launches = {
        "encoder": (F, F, False, "tma_wgmma"),
        "decoder self prefill": (ENCDEC_PROMPT, ENCDEC_PROMPT, True, "flash_decode"),
        "cross prefill": (ENCDEC_PROMPT, F, False, "flash_decode"),
        "cross decode": (1, F, False, "flash_decode"),
    }
    want = {"encoder": waves * L, "decoder self prefill": waves * L, "cross prefill": waves * L,
            "cross decode": waves * (SERVE_NEW_TOKENS - 1) * L}
    check(sorted(calls) == sorted(launches.values())
          and all(calls[launches[n]] == want[n] for n in want),
          f"encdec: calls {calls}, expected {want} on {launches}")
    shapes = _whisper_shapes(torch, cfg, params, waves_[0], cache)
    for name in shapes:
        shapes[name]["launches"] = calls[launches[name]]
    row.update(attention_calls={f"{sq}x{sk}{' causal' if c else ''} {r}": n
                                for (sq, sk, c, r), n in calls.items()})
    row["decode_ab"] = _decode_ab(torch, cfg, params, waves_[0], cache)
    row["phase_s"] = time.perf_counter() - t_phase
    emit("serve encdec: " + json.dumps(row))
    del params, cache, results, waves_
    torch.cuda.empty_cache()
    return row["flash_routes"]["tma_wgmma"], shapes


# ---------------------------------------------------------------------- #
# Phase 7f: the continuous-batching server
# ---------------------------------------------------------------------- #

def _wave_counts():
    """The structural cache's and the level loop's counters."""

    from repro_torch.compile import compile_cache_stats

    cc = compile_cache_stats()
    captures, replays, eager = graph_counts()
    return {"compile_cache_misses": cc["misses"], "compile_cache_hits": cc["hits"],
            "graph_captures": captures, "graph_replays": replays, "eager_sweeps": eager}


def _served(torch, server, params, cfg, prompts):
    """``server.serve_requests`` over ``prompts`` in ``SERVE_SLOTS`` slots,
    with the counters read at the start of each wave's planning and after
    the last wave: (the run, each wave's counter deltas)."""

    from unittest import mock

    marks = []
    plan_wave = server.plan_wave

    def marked(*args, **kw):
        marks.append(_wave_counts())
        return plan_wave(*args, **kw)

    requests = [server.Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    with mock.patch.object(server, "plan_wave", marked):
        run = server.serve_requests(params, cfg, requests, slots=SERVE_SLOTS,
                                    max_new=SERVE_NEW_TOKENS, device="cuda")
    torch.cuda.synchronize()
    marks.append(_wave_counts())
    deltas = [{k: b[k] - a[k] for k in a} for a, b in zip(marks, marks[1:])]
    return run, deltas


def _generated_as_generate(torch, params, cfg, run, prompts):
    """Each request's tokens against ``serve_lm.generate`` on the same
    prompts in the same batch: the number of requests that differ."""

    from repro_torch.launch.serve_lm import generate

    differ = 0
    for w in range(0, len(prompts), SERVE_SLOTS):
        batch = {"tokens": torch.stack(prompts[w:w + SERVE_SLOTS])}
        got = generate(params, cfg, batch, SERVE_NEW_TOKENS).tokens.tolist()
        for r, tokens in zip(run.done[w:w + SERVE_SLOTS], got):
            differ += int(r.generated != tokens)
    return differ


def batching_phase(torch, smi):
    """Phase 7f: ``repro_torch.launch.serve.serve_requests`` at yi-6b's full
    size, ``BATCHING_REQUESTS`` requests of 2048 prompt tokens in 4 slots:
    each wave's four sync plans through the default plan service on the
    card, the prefill on the bf16 TMA flash kernel, 31 greedy decode steps
    and the wave's non-affine workloads (asserted bit-equal to
    ``run_sequential`` by ``run_nonaffine_wave``); then one more wave with
    the int8 KV cache.  Held: one flash launch a layer a prefill, all on
    ``tma_wgmma``; every request's tokens those of ``generate`` on the same
    batch; no structural miss and no capture from the third wave on."""

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as server
    from repro_torch.models import model_zoo
    from repro_torch.obs import metrics

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    params = model_zoo.init(cfg, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 100)
    prompts = [
        torch.randint(0, cfg.vocab_size, (SERVE_PROMPT,), generator=gen, device="cuda",
                      dtype=torch.int32)
        for _ in range(BATCHING_REQUESTS)
    ]
    obs.reset_all()  # a cold default service, structural cache and histograms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: every count set to 0 just before, read just after
    _reset_counts()
    run, waves = _served(torch, server, params, cfg, prompts)
    launches, flash_routes, matmul_launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    server.print_summary(run)
    latency = {}
    for name in ("serve.plan_ms", "serve.compile_ms", "serve.run_ms"):
        h = metrics.histogram(name)
        latency[name] = {"n": h.count, "p50": h.percentile(50), "p99": h.percentile(99)}
    n_waves = BATCHING_REQUESTS // SERVE_SLOTS
    check(run.waves == n_waves and len(run.done) == BATCHING_REQUESTS,
          f"batching: {run.waves} waves served {len(run.done)} requests")
    check(all(len(r.generated) == SERVE_NEW_TOKENS for r in run.done),
          "batching: a request holds other than SERVE_NEW_TOKENS tokens")
    steps = n_waves * (SERVE_NEW_TOKENS - 1)
    check(launches == cfg.num_layers * (n_waves + steps),
          f"batching: {launches} flash launches, expected {cfg.num_layers} x ({n_waves} + {steps})")
    check(flash_routes["tma_wgmma"] == cfg.num_layers * n_waves
          and flash_routes["flash_decode"] == cfg.num_layers * steps,
          f"batching: flash routes {flash_routes}, expected the prefills on tma_wgmma and the "
          "decode steps on flash_decode")
    check(matmul_launches == 0, f"batching: {matmul_launches} pipelined-matmul launches")
    check(latency["serve.run_ms"]["n"] == n_waves, f"batching: serve.run_ms {latency['serve.run_ms']}")
    for i, wave in enumerate(waves[2:], start=3):
        check(wave["compile_cache_misses"] == 0 and wave["graph_captures"] == 0,
              f"batching: wave {i} missed the structural cache or captured: {wave}")
    differ = _generated_as_generate(torch, params, cfg, run, prompts)
    check(differ == 0, f"batching: {differ} requests' tokens differ from generate's on the same batch")

    # one more wave with the int8 KV cache, its latencies alone
    qcfg = cfg.scaled(kv_quant=True)
    for name in latency:
        metrics.histogram(name).reset()
    _reset_counts()
    qrun, qwaves = _served(torch, server, params, qcfg, prompts[:SERVE_SLOTS])
    qlaunches, qroutes, _ = _read_counts()
    server.print_summary(qrun)
    check(qrun.kv_quant and qlaunches == cfg.num_layers and qroutes["tma_wgmma"] == qlaunches,
          f"batching kv_quant: {qlaunches} launches, routes {qroutes}")
    check(qwaves[0]["compile_cache_misses"] == 0,
          f"batching kv_quant: the wave missed the structural cache: {qwaves[0]}")
    qdiffer = _generated_as_generate(torch, params, qcfg, qrun, prompts[:SERVE_SLOTS])
    check(qdiffer == 0, f"batching kv_quant: {qdiffer} requests' tokens differ from generate's")
    same = sum(a.generated == b.generated for a, b in zip(qrun.done, run.done))

    row = {
        "cell": "yi6b_batching_16x2048_32",
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "dtype": cfg.dtype,
        "requests": BATCHING_REQUESTS,
        "slots": SERVE_SLOTS,
        "prompt_tokens": SERVE_PROMPT,
        "new_tokens": SERVE_NEW_TOKENS,
        "waves": run.waves,
        "decoded_tokens": run.decoded_tokens,
        "seconds": run.seconds,
        "tokens_per_s_batched": run.decoded_tokens / run.seconds,
        "latency_ms": latency,
        "per_wave_counts": waves,
        "flash_launches": launches,
        "flash_routes": flash_routes,
        "pipelined_matmul_launches": matmul_launches,
        "peak_memory_bytes": peak,
        "speculation_rollbacks": metrics.counter("speculation.rollbacks").value,
        "tokens_equal_generate": True,
        "nonaffine_bit_equal_to_run_sequential": True,
        "scan_strategy": run.scan_plan.summary()["scc"]["recurrences"][0]["strategy"],
        "kv_quant": {
            "seconds": qrun.seconds,
            "tokens_per_s_batched": qrun.decoded_tokens / qrun.seconds,
            "wave_counts": qwaves,
            "flash_launches": qlaunches,
            "tokens_equal_generate": True,
            "requests_with_the_bf16_cache_tokens": same,
        },
        "card": smi,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit("serve batching: " + json.dumps(row))
    del params
    torch.cuda.empty_cache()
    obs.reset_all()
    return launches + qlaunches


# ---------------------------------------------------------------------- #
# Phase 7g: the MoE, Mamba-2 and encoder-decoder families trained
# ---------------------------------------------------------------------- #

def _cut(cfg, layers):
    """``cfg`` at ``layers`` layers, an encoder-decoder's encoder too."""

    import dataclasses

    if cfg.encoder is not None:
        cfg = cfg.scaled(encoder=dataclasses.replace(cfg.encoder, num_layers=layers))
    return cfg.scaled(num_layers=layers)


def _attention_calls(cfg):
    """Train-mode attention calls of one forward: each attention layer's,
    an encoder-decoder's encoder layers and its decoder's cross-attention
    too."""

    from repro_torch.configs.base import ATTN, ATTN_LOCAL

    layers = sum(cfg.block[i % len(cfg.block)].mixer in (ATTN, ATTN_LOCAL)
                 for i in range(cfg.num_layers))
    if cfg.encoder is not None:
        return cfg.encoder.num_layers + 2 * layers
    return layers


def _router_aux_check(torch, cfg, params, batch):
    """The MoE aux loss's gradient reaches every router on the card: each
    router leaf's gradient with the aux weight on and off (the aux term
    alone is their difference), at the phase's config and batch."""

    from unittest import mock

    from repro_torch import tree as tree_lib
    from repro_torch.models import model_zoo

    def router_grads():
        # the loss's gradient with respect to the router leaves alone
        flat, routers = [], []
        for path, p in tree_lib.flatten_with_paths(params):
            flat.append(p.detach().requires_grad_(path[-1] == "router"))
            if path[-1] == "router":
                routers.append(flat[-1])
        loss, m = model_zoo.loss_fn(tree_lib.unflatten(params, flat), batch, cfg)
        grads = torch.autograd.grad(loss, routers)
        return float(m["aux"]), [g.float() for g in grads]

    aux, on = router_grads()
    with mock.patch.object(model_zoo, "AUX_LOSS_WEIGHT", 0.0):
        _, off = router_grads()
    norms = [g.norm().item() for g in on]
    diffs = [(a - b).norm().item() / max(a.norm().item(), 1e-30) for a, b in zip(on, off)]
    check(len(on) == cfg.num_layers, f"train moe: {len(on)} router leaves")
    check(min(norms) > 0.0, f"train moe: a router's gradient is zero: {norms}")
    check(min(diffs) > 0.0, f"train moe: the aux weight does not move a router's gradient: {diffs}")
    return {"aux": aux, "aux_weight": model_zoo.AUX_LOSS_WEIGHT, "routers": len(on),
            "router_grad_norm_min": min(norms),
            "router_grad_rel_change_without_aux_min": min(diffs),
            "router_grad_rel_change_without_aux_max": max(diffs)}


def _train_family(torch, smi, cell, arch, layers, rows, seq, steps):
    """One family trained at full width (depth cut to ``layers`` when
    given) for ``steps`` steps of ``rows`` x ``seq`` tokens through
    ``train_loop``; its row.  Then the router check (MoE) and the
    parity step against the CPU at ``PARITY_LAYERS`` layers in f32."""

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, DataState, make_batch
    from repro_torch.kernels.pipelined_matmul import ops as matmul_ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_zoo
    from repro_torch.optim.optimizer import AdamW
    from repro_torch.runtime.trainer import train_loop

    t_phase = time.perf_counter()
    full = get_config(arch)
    cfg = full if layers is None else _cut(full, layers)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16", f"train {arch}: {cfg.remat} / {cfg.dtype}")
    opt = AdamW(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=steps)
    dc = DataConfig(global_batch=rows, seq_len=seq, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the main path: the counts read just before and just after
    flash0, plain0, matmul0 = _flash_count(), _plain_count(), matmul_ops.matmul.launches
    marks = []
    res = train_loop(cfg, dc, total_steps=steps, opt=opt, seed=SEED,
                     failure_injector=_clock(torch, marks), device="cuda")
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    flash = _flash_count() - flash0
    plain_calls = _plain_count() - plain0
    matmul_launches = matmul_ops.matmul.launches - matmul0
    peak = torch.cuda.max_memory_allocated()
    losses = res.losses
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    params, opt_state = res.state["params"], res.state["opt"]
    check(res.final_step == steps and len(losses) == steps,
          f"train {arch}: {res.final_step} steps, {len(losses)} losses")
    check(all(math.isfinite(l) for l in losses), f"train {arch}: a loss is not finite: {losses}")
    check(statistics.mean(losses[-3:]) < statistics.mean(losses[:3]),
          f"train {arch}: the loss did not fall: {losses}")
    check(flash == 0, f"train {arch}: {flash} flash launches in training (no backward kernel)")
    check(matmul_launches == 0, f"train {arch}: {matmul_launches} pipelined-matmul launches")
    # remat "full": each attention call once forward, once recomputed
    expect_plain = 2 * _attention_calls(cfg) * steps
    check(plain_calls == expect_plain,
          f"train {arch}: {plain_calls} plain attention calls, expected {expect_plain}")

    # one more step under the profiler for the device's idle share
    batch = {
        k: torch.from_numpy(v).cuda()
        for k, v in make_batch(dc, cfg, DataState(SEED, steps)).items()
    }
    step_fn = make_train_step(cfg, opt)

    def one_step():
        nonlocal params, opt_state
        params, opt_state, _ = step_fn(params, opt_state, batch)

    busy_ms, prof_wall_ms, n_events = _profiled_run(torch, one_step)
    n_params = model_zoo.param_count(params)
    flops_per_token = model_zoo.model_flops_per_token(params, cfg)
    del opt_state, res
    torch.cuda.empty_cache()
    router = _router_aux_check(torch, cfg, params, batch) if cfg.has_moe else None
    del params, batch
    torch.cuda.empty_cache()

    timed = step_ms[2:]
    step_s = statistics.median(timed) / 1e3
    tokens = rows * seq
    row = {
        "cell": cell,
        "arch": cfg.name,
        "layers": cfg.num_layers,
        "full_layers": full.num_layers,
        "encoder_layers": cfg.encoder.num_layers if cfg.encoder is not None else None,
        "frames_per_row": cfg.encoder.num_frames if cfg.encoder is not None else None,
        "dtype": cfg.dtype,
        "remat": cfg.remat,
        "params": n_params,
        "global_batch": rows,
        "seq_len": seq,
        "lr": TRAIN_LR,
        "warmup_steps": TRAIN_WARMUP,
        "steps": steps,
        "losses": losses,
        "step_ms": step_ms,
        "step_ms_median_steps_3_on": statistics.median(timed),
        "tokens_per_s": tokens / step_s,
        "model_flops_per_token": flops_per_token,
        "model_tflops": flops_per_token * tokens / step_s / 1e12,
        "peak_memory_bytes": peak,
        "profiled_step_wall_ms": prof_wall_ms,
        "profiled_step_device_busy_ms": busy_ms,
        "step_idle_share": (
            1.0 - busy_ms / statistics.median(timed) if busy_ms is not None else None
        ),
        "profiled_step_device_events": n_events,
        "attention_train_plain_calls": plain_calls,
        "flash_launches": flash,
        "pipelined_matmul_launches": matmul_launches,
        "router_aux_gradient": router,
        "card": smi,
    }
    emit("train family: " + json.dumps(row))
    if layers is not None:  # the depth was cut to the largest under the limit
        check(peak < FAMILY_PEAK_LIMIT,
              f"train {arch}: peak memory {peak} bytes above {FAMILY_PEAK_LIMIT}")
    _parity(torch, _cut(full, PARITY_LAYERS).scaled(dtype="float32"))
    emit(f"train family {arch}: {time.perf_counter() - t_phase:.1f} s")


def family_train_phase(torch, smi, cells):
    """Phase 7g: whisper-medium, mamba2-2.7b and deepseek-moe-16b (depth
    cut) trained on the card."""

    for cell, arch, layers, rows, seq, steps in cells:
        _train_family(torch, smi, cell, arch, layers, rows, seq, steps)


# ---------------------------------------------------------------------- #
# Phase 7h: the launch layer on DeviceMesh and DTensor
# ---------------------------------------------------------------------- #

LAUNCH_FAMILIES = ("yi_6b", "deepseek_moe_16b", "mamba2_2_7b", "whisper_medium")
# (b) runs on phase 7b's trained state cut to its first 10 of 40 layers:
# each layer runs the same sharded code, and DTensor's host dispatch makes
# a full-depth sharded step ~10 s on one rank
LAUNCH_TRAIN_LAYERS = 10
LAUNCH_TOL = 1e-5  # the sharded f32 step against the unsharded one
# (arch, shape, multi-pod): the 16 x 16 mesh, and the (2, 16, 16) one once
LAUNCH_DRYRUNS = (
    ("mamba2_2_7b", "decode_32k", False),
    ("granite_3_2b", "train_4k", False),
    ("mamba2_2_7b", "decode_32k", True),
)
# the smoke lowers granite's train cell at 2 microbatches: a quarter of the
# deployment's 8's DTensor dispatch on fake tensors (~0.8 s a layer and
# microbatch on the host); the reduction count is the same at any count
LAUNCH_DRYRUN_MICROBATCHES = 2
LAUNCH_BG_TIMEOUT_S = 600  # the host-side runs', from their start
LAUNCH_TURNS = 2  # decode turns (plain, sharded, then sharded, plain)
LAUNCH_TURN_STEPS = 8
PHASE7 = {}  # phase 7's first wave, for phase 7h (a)


class _world1_nccl:
    """A world-size-1 NCCL default group (``file://`` store in a temp
    dir) for the duration of a ``with``."""

    def __enter__(self):
        import tempfile

        import torch.distributed as dist

        self._dir = tempfile.TemporaryDirectory()
        dist.init_process_group(
            "nccl", init_method=f"file://{self._dir.name}/store", rank=0, world_size=1
        )
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        self._dir.cleanup()
        return False


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _launch_worker(rank, world, init_file, meshes, results):
    """One gloo rank of phase 7h (c): on each (data, model) mesh, every
    family's smoke config in f32 — the sharded train step (microbatches 1
    and 4 with FSDP gradient shardings, and 4 with ``seq_shard``) against
    the unsharded one, the gradient reductions over the data axis, the
    collectives by kind, and prefill + greedy decode."""

    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        import dataclasses

        import torch
        import torch.distributed as dist

        from repro_torch import tree as tree_lib
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import hlo_analysis, sharding, steps
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import model_zoo
        from repro_torch.optim.optimizer import AdamW, AdamWState

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            # Adam's first step is g / (|g| + eps): eps 1e-3 bounds how far a
            # rounding difference in a near-zero gradient moves the update
            opt = AdamW(warmup_steps=1, eps=1e-3)
            out = {}
            t0 = time.perf_counter()
            for shape in meshes:
                mesh = make_debug_mesh(*shape, device_type="cpu")
                data = hlo_analysis.group_names(mesh, ["data"])
                for arch in LAUNCH_FAMILIES:
                    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
                    params = model_zoo.init(cfg, device="cpu", seed=SEED)
                    ost = opt.init(params)
                    g = torch.Generator().manual_seed(SEED + 1)
                    tokens = torch.randint(0, cfg.vocab_size, (16, 16), generator=g)
                    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
                    if cfg.family == "encdec":
                        batch["frame_embeds"] = torch.randn(
                            16, cfg.encoder.num_frames, cfg.d_model, generator=g)
                    zs = sharding.named(mesh, sharding.zero1_pspecs(cfg, mesh, params))
                    dp = sharding.distribute(
                        params, sharding.named(mesh, sharding.params_pspecs(cfg, mesh, params)))
                    do = AdamWState(ost.step, sharding.distribute(ost.mu, zs),
                                    sharding.distribute(ost.nu, zs))
                    db = sharding.distribute(
                        batch, sharding.named(mesh, sharding.batch_pspecs(cfg, mesh, batch)))
                    row = {}
                    for k, seq in ((1, False), (4, False), (4, True)):
                        ref_p, _, ref_m = steps.make_train_step(cfg, opt, microbatches=k)(
                            params, ost, batch)
                        fn = steps.make_train_step(cfg, opt, microbatches=k, mesh=mesh,
                                                   grad_shardings=zs, seq_shard=seq)
                        with _sited(hlo_analysis.CollectiveMode()) as mode:
                            new_p, _, m = fn(dp, do, db)
                        on_data = hlo_analysis.collective_stats(mode, data).counts
                        row[f"k{k}" + ("_seq" if seq else "")] = {
                            "loss": abs(float(_whole(m["loss"])) - float(ref_m["loss"])),
                            "grad_norm": abs(float(_whole(m["grad_norm"])) - float(ref_m["grad_norm"])),
                            "params": max(float((_whole(a) - b).abs().max()) for a, b in
                                          zip(tree_lib.leaves(new_p), tree_lib.leaves(ref_p))),
                            "grad_reductions": on_data.get("all-reduce", 0)
                            + on_data.get("reduce-scatter", 0),
                            "collectives": hlo_analysis.collective_stats(mode).counts,
                            "data_sites": {f"{kind} {site}": n for (kind, group, site), n
                                           in mode.sites.items() if group in data},
                        }
                    row["greedy_equal"] = _launch_greedy(torch, cfg, params, dp, mesh)
                    out[f"{arch} {shape}"] = row
            out["pod_split"] = _launch_pod_split(torch, world)
            out["seconds"] = time.perf_counter() - t0
            results.put((rank, "ok", out))
        finally:
            dist.destroy_process_group()
    except BaseException:
        import traceback

        results.put((rank, "error", traceback.format_exc()))


def _sited(mode):
    """``mode`` (a ``CollectiveMode``) also counting each collective by
    (kind, group, the innermost ``repro_torch`` line that issued it), in
    ``mode.sites``: where the data axis's reductions come from."""

    import collections
    import traceback

    mode.sites = collections.Counter()
    seen = mode.records
    dispatch = type(mode).__torch_dispatch__

    def sited(self, func, types, args=(), kwargs=None):
        n = len(seen)
        out = dispatch(self, func, types, args, kwargs)
        if len(seen) > n:
            frames = [f for f in traceback.extract_stack() if "repro_torch" in f.filename]
            site = f"{Path(frames[-1].filename).name}:{frames[-1].lineno}" if frames else "?"
            self.sites[(seen[-1][0], seen[-1][3], site)] += 1
        return out

    mode.__class__ = type("SitedCollectiveMode", (type(mode),), {"__torch_dispatch__": sited})
    return mode


def _launch_pod_split(torch, world):
    """Whether the microbatch split over two data axes ("pod", "data")
    gives the reference's reshape, each microbatch split over both."""

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import sharding
    from repro_torch.launch.steps import _microbatched

    mesh = init_device_mesh("cpu", (2, world // 2, 1), mesh_dim_names=("pod", "data", "model"))
    x = torch.arange(48, dtype=torch.int32).reshape(16, 3)
    dx = sharding.distribute(x, sharding.NamedSharding(mesh, sharding.P(("pod", "data"), None)))
    return all(torch.equal(_microbatched(dx, k, mesh).full_tensor(), x.reshape(k, 16 // k, 3))
               for k in (2, 4))


def _launch_greedy(torch, cfg, params, dp, mesh, B=4, S=8, N=4):
    """Whether the sharded prefill and N-1 greedy decode steps give the
    unsharded tokens."""

    from repro_torch.launch import sharding, steps
    from repro_torch.models import model_zoo

    g = torch.Generator().manual_seed(SEED + 2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.randn(B, cfg.encoder.num_frames, cfg.d_model, generator=g)
    pre, dec = steps.make_prefill_step(cfg), steps.make_serve_step(cfg)
    tok = sharding.named(mesh, sharding.batch_pspecs(cfg, mesh, {"t": torch.zeros(B, 1)}))["t"]

    def gen(p, b, c, place):
        logits, c = pre(p, b, c)
        cur = torch.argmax(_whole(logits)[:, -1, :], -1).to(torch.int32)[:, None]
        out = [cur]
        for t in range(N - 1):
            cur, c = dec(p, place(cur), c, S + t)
            out.append(_whole(cur))
        return torch.cat(out, 1)

    ref = gen(params, batch, model_zoo.init_cache(cfg, B, S + N, device="cpu"), lambda t: t)
    cache = model_zoo.init_cache(cfg, B, S + N, device="cpu")
    dc = sharding.distribute(cache, sharding.named(mesh, sharding.cache_pspecs(cfg, mesh, cache)))
    db = sharding.distribute(batch, sharding.named(mesh, sharding.batch_pspecs(cfg, mesh, batch)))
    got = gen(dp, db, dc, lambda t: sharding.distribute(_whole(t), tok))
    return bool(torch.equal(ref, got))


class LaunchBackground:
    """Phase 7h's host-only parts, side by side: (c) the gloo worlds of 2
    and 4 and (d) the dry runs and ``pp_lowering.main`` as subprocesses.
    They start after phase 7g's host-bound cell and run beside its
    device-bound ones; phase 7h reads them before it times anything.
    ``stop()`` ends whatever is still running."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_launch_")
        self.gloo = [
            (2, _start_gloo(2, [(2, 1), (1, 2)], self.dir, _launch_worker,
                            timeout=LAUNCH_BG_TIMEOUT_S)),
            (4, _start_gloo(4, [(2, 2)], self.dir, _launch_worker,
                            timeout=LAUNCH_BG_TIMEOUT_S)),
        ]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        self.t0 = time.monotonic()
        self.procs = {}
        for arch, shape, multi_pod in LAUNCH_DRYRUNS:
            self.procs[f"{arch}__{shape}__{multi_pod}"] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--out", self.dir,
                 "--microbatches", str(LAUNCH_DRYRUN_MICROBATCHES)]
                + (["--multi-pod"] if multi_pod else []),
                cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
        self.procs["pp_lowering"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.runtime.pp_lowering"],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )

    def stop(self):
        import shutil

        for _, started in self.gloo:
            _stop(started[1])
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        shutil.rmtree(self.dir, ignore_errors=True)


def _launch_gloo_checks(bg):
    """Phase 7h (c): the gloo worlds' readings, printed, then checked."""

    failures = []
    for world, started in bg.gloo:
        got = _collect_gloo(started, f"phase 7h world {world}")
        for rank, res in got.items():
            secs = res.pop("seconds")
            if not res.pop("pod_split"):
                failures.append(f"world {world} rank {rank}: the (pod, data) split is not the reshape")
            for key, row in res.items():
                for name in ("k1", "k4", "k4_seq"):
                    r = row[name]
                    worst = max(r["loss"], r["grad_norm"], r["params"])
                    if worst > LAUNCH_TOL:
                        failures.append(f"{key} {name} rank {rank}: {worst} above {LAUNCH_TOL}")
                n1, n4 = row["k1"]["grad_reductions"], row["k4"]["grad_reductions"]
                if n1 != n4:
                    diff = {s: (row["k1"]["data_sites"].get(s, 0), row["k4"]["data_sites"].get(s, 0))
                            for s in set(row["k1"]["data_sites"]) | set(row["k4"]["data_sites"])
                            if row["k1"]["data_sites"].get(s) != row["k4"]["data_sites"].get(s)}
                    failures.append(f"{key} rank {rank}: {n1} gradient reductions at "
                                    f"microbatches 1, {n4} at 4; by site {diff}")
                if not row["greedy_equal"]:
                    failures.append(f"{key} rank {rank}: greedy tokens differ")
        emit("launch gloo: " + json.dumps({
            "world": world, "seconds_rank0": secs,
            "rows": {k: {n: {"max_err": max(v[n]["loss"], v[n]["grad_norm"], v[n]["params"]),
                             "grad_reductions": v[n]["grad_reductions"],
                             "collectives": v[n]["collectives"]}
                         for n in ("k1", "k4", "k4_seq")} | {"greedy_equal": v["greedy_equal"]}
                     for k, v in got[0].items()},
        }))
    check(not failures, "launch gloo:\n" + "\n".join(failures))


def _launch_dryrun_checks(bg):
    """Phase 7h (d): the dry-run records and ``pp_lowering.main``'s line."""

    for name, p in bg.procs.items():
        left = max(1.0, LAUNCH_BG_TIMEOUT_S - (time.monotonic() - bg.t0))
        try:
            out, err = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            check(False, f"launch {name}: no result in {LAUNCH_BG_TIMEOUT_S} s (killed)")
        check(p.returncode == 0, f"launch {name}: exit {p.returncode}\n{err[-3000:]}")
        if name == "pp_lowering":
            line = next((l for l in out.splitlines() if l.startswith("hand-offs")), "")
            check("pp lowering: OK" in out and line.startswith("hand-offs per microbatch step: 1 "),
                  f"pp_lowering: {out[-2000:]}")
            emit("launch pp_lowering: " + line)
    for arch, shape, multi_pod in LAUNCH_DRYRUNS:
        from repro_torch.configs import get_config

        mesh = "pod2x16x16" if multi_pod else "pod16x16"
        rec_file = Path(bg.dir) / f"{get_config(arch).name}__{shape}__{mesh}.json"
        r = json.loads(rec_file.read_text())
        check(r["memory"]["peak_bytes"] < 80e9,
              f"dry run {arch} {shape}: peak {r['memory']['peak_bytes']} bytes a card")
        emit("launch dryrun: " + json.dumps({
            k: r[k] for k in ("arch", "shape", "mesh", "chips", "microbatches", "lower_s",
                              "memory", "collectives", "roofline", "roofline_analytic",
                              "hardware", "n_total_params", "n_active_params",
                              "tokens_per_step")
        }))


def _launch_serve(torch, smi):
    """Phase 7h (a): yi-6b at full width served on a world-1 NCCL mesh
    under ``cell_shardings``' placements, phase 7's first wave: greedy
    tokens equal phase 7's, every flash launch through ``local_map``, the
    decode step timed beside the plain one in turns.  Returns the flash
    launches."""

    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import hlo_analysis, input_specs, sharding
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve_lm import make_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import model_zoo, sharded
    from repro_torch.optim.optimizer import AdamW

    cfg = get_config(SERVE_ARCH)
    params = model_zoo.init(cfg, device="cuda", seed=SEED)
    batch = make_batch(cfg, SERVE_SLOTS, SERVE_PROMPT, device="cuda", seed=SEED + 1)
    total = SERVE_PROMPT + SERVE_NEW_TOKENS
    prefill, step = make_prefill_step(cfg), make_serve_step(cfg)
    with _world1_nccl():
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        cell = input_specs.cell_shardings(
            cfg, ShapeConfig("phase7_wave", SERVE_PROMPT, SERVE_SLOTS, "prefill"), mesh, AdamW())
        dp = sharding.distribute(params, cell["params"])
        db = sharding.distribute(batch, cell["batch"])
        cache = model_zoo.init_cache(cfg, SERVE_SLOTS, total, device="cuda")
        dc = sharding.distribute(cache, sharding.named(mesh, sharding.cache_pspecs(cfg, mesh, cache)))
        tok = sharding.named(mesh, sharding.batch_pspecs(cfg, mesh, {"t": batch["tokens"][:, :1]}))["t"]

        def place(t):
            return sharding.distribute(_whole(t), tok)

        calls = [0]
        through = sharded.attention

        def counted(fn, q, *kvs):
            calls[0] += sharded.is_dtensor(q)
            return through(fn, q, *kvs)

        _reset_counts()
        with mock.patch.object(sharded, "attention", counted):
            logits, dc = prefill(dp, db, dc)
            launches, routes, matmul_launches = _read_counts()
            prefill_calls = calls[0]
            cur = torch.argmax(_whole(logits)[:, -1, :], dim=-1)[:, None].to(torch.int32)
            out = [cur]
            for i in range(SERVE_NEW_TOKENS - 1):
                cur, dc = step(dp, place(cur), dc, SERVE_PROMPT + i)
                out.append(_whole(cur))
        tokens = torch.cat(out, 1).cpu()
        check(launches == cfg.num_layers and routes["tma_wgmma"] == launches,
              f"launch serve: {launches} flash launches {routes}, expected {cfg.num_layers} tma_wgmma")
        check(prefill_calls == launches,
              f"launch serve: {prefill_calls} attention calls through local_map for {launches} launches")
        check(torch.equal(tokens, PHASE7["tokens"]),
              f"launch serve: greedy tokens differ from phase 7's in "
              f"{int((tokens != PHASE7['tokens']).sum())} places")
        with hlo_analysis.CollectiveMode() as mode:
            step(dp, place(cur), dc, total - 1)
        step_collectives = hlo_analysis.collective_stats(mode).counts

        # the decode step, plain and sharded in turns, each from its cache
        cur_plain = _whole(cur).clone()
        times = {"plain": [], "sharded": []}
        for turn in range(LAUNCH_TURNS):
            for name in (("plain", "sharded") if turn % 2 == 0 else ("sharded", "plain")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(LAUNCH_TURN_STEPS):
                    if name == "plain":
                        step(params, cur_plain, cache, SERVE_PROMPT + i)
                    else:
                        step(dp, place(cur), dc, SERVE_PROMPT + i)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3 / LAUNCH_TURN_STEPS)
    row = {
        "arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
        "mesh": "world-1 NCCL (data 1, model 1)",
        "slots": SERVE_SLOTS, "prompt_tokens": SERVE_PROMPT, "new_tokens": SERVE_NEW_TOKENS,
        "flash_launches": launches, "flash_routes": routes,
        "attention_calls_through_local_map_in_prefill": prefill_calls,
        "attention_calls_through_local_map": calls[0],
        "pipelined_matmul_launches": matmul_launches,
        "greedy_tokens_equal_phase7": True,
        "decode_step_collectives": step_collectives,
        "decode_ms_per_step_plain": times["plain"],
        "decode_ms_per_step_sharded": times["sharded"],
        "decode_ms_per_step_phase7_median": PHASE7["decode_ms_median"],
        "card": smi,
    }
    emit("launch serve: " + json.dumps(row))
    del params, dp, cache, dc
    torch.cuda.empty_cache()
    return launches


def _launch_train_check(torch, cfg, opt, state, batch):
    """Phase 7h (b), run inside phase 7b on its resident state, cut to its
    first ``LAUNCH_TRAIN_LAYERS`` layers: two ``make_train_step(...,
    mesh=, grad_shardings=, microbatches=2)`` steps (7b's AdamW) on a
    world-1 NCCL mesh, each against the unsharded microbatch-2 step from
    the same state, within phase 7b's parity limits; the gradient
    reductions per step.  One rank shards nothing, so the steps should
    agree bit for bit: each leaf is compared with ``torch.equal``, and 7b's
    f64 readings are taken only where a leaf or a metric differs."""

    from repro_torch import tree as tree_lib
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import hlo_analysis, input_specs, sharding
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.optimizer import AdamWState

    import dataclasses

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, num_layers=LAUNCH_TRAIN_LAYERS)

    def cut(tree):
        return dict(tree, blocks=tree["blocks"][:LAUNCH_TRAIN_LAYERS])

    def leaves(p, o):
        return tree_lib.leaves(p) + tree_lib.leaves(o.mu) + tree_lib.leaves(o.nu)

    params = cut(state["params"])
    opt_state = AdamWState(state["opt"].step, cut(state["opt"].mu), cut(state["opt"].nu))
    plain_fn = make_train_step(cfg, opt, microbatches=2)
    rows = []
    with _world1_nccl():
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        cell = input_specs.cell_shardings(
            cfg, ShapeConfig("phase7b", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh, opt)
        fn = make_train_step(cfg, opt, microbatches=2, mesh=mesh,
                             grad_shardings=cell["grad_shardings"])
        db = sharding.distribute(batch, cell["batch"])
        data = hlo_analysis.group_names(mesh, ["data"])
        dp = sharding.distribute(params, cell["params"])
        do = AdamWState(opt_state.step, sharding.distribute(opt_state.mu, cell["opt_state"].mu),
                        sharding.distribute(opt_state.nu, cell["opt_state"].nu))
        for k in range(2):
            ref = plain_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with hlo_analysis.CollectiveMode() as mode:
                dp, do, m = fn(dp, do, db)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            got_p = tree_lib.tree_map(lambda t: t.to_local(), dp)
            got_o = AdamWState(_whole(do.step), *(tree_lib.tree_map(lambda t: t.to_local(), x)
                                                 for x in (do.mu, do.nu)))
            got_m = {n: _whole(v) for n, v in m.items()}
            pairs = list(zip(leaves(got_p, got_o), leaves(ref[0], ref[1])))
            unequal = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
            metrics_equal = all(float(got_m[n]) == float(ref[2][n]) for n in ref[2])
            if unequal or not metrics_equal:
                readings = _step_readings(params, (got_p, got_o, got_m), ref, opt.b1)
            else:
                readings = {n: 0.0 for n in TRAIN_PARITY_TOL}
            n_params = len(tree_lib.leaves(got_p))
            diff = max([float((pairs[i][0].float() - pairs[i][1].float()).abs().max())
                        for i in unequal if i < n_params], default=0.0)
            on_data = hlo_analysis.collective_stats(mode, data).counts
            rows.append({
                "step": k + 1, "readings": readings, "params_max_abs_diff": diff,
                "bit_equal": not unequal and metrics_equal,
                "unequal_leaves": len(unequal), "leaves": len(pairs), "step_ms": step_ms,
                "grad_reductions": on_data.get("all-reduce", 0) + on_data.get("reduce-scatter", 0),
                "collectives": hlo_analysis.collective_stats(mode).counts,
                "loss": float(got_m["loss"]),
            })
            over = {n: readings[n] for n in TRAIN_PARITY_TOL if readings[n] > TRAIN_PARITY_TOL[n]}
            check(not over, f"launch train step {k + 1}: {over} above {TRAIN_PARITY_TOL}")
            del ref, pairs
            params, opt_state = got_p, got_o
    del dp, do, params, opt_state
    torch.cuda.empty_cache()
    emit("launch train: " + json.dumps({
        "arch": cfg.name, "layers": cfg.num_layers, "of_layers": len(state["params"]["blocks"]),
        "microbatches": 2, "mesh": "world-1 NCCL (data 1, model 1)",
        "grad_shardings": "zero1 specs", "limits": TRAIN_PARITY_TOL, "steps": rows,
        "seconds": time.perf_counter() - t_phase,
    }))


def _launch_repairs(torch):
    """Phase 7h (e): internlm2's smoke config (hd 8) served on the card
    through the flash kernel (zero-padded to hd 16): in f32 on the 3xTF32
    route against the same weights on the CPU, in bf16 on the TMA / wgmma
    route against a plain-attention rerun on the card, with a planted
    causal-edge fault; and transposed operands through the matmul kernel
    against its plain version."""

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.pipelined_matmul import ops as matmul_ops
    from repro_torch.kernels.pipelined_matmul.ref import matmul_ref
    from repro_torch.launch import serve_lm
    from repro_torch.models import model_zoo
    from repro_torch.models.attention import chunked_attention_plain

    cfg = get_smoke_config("internlm2_20b").scaled(dtype="float32")
    check(cfg.head_dim == 8, f"internlm2 smoke: hd {cfg.head_dim}")
    params = model_zoo.init(cfg, device="cpu", seed=SEED)
    batch = serve_lm.make_batch(cfg, 2, 24, device="cpu", seed=SEED + 1)
    on_cpu = serve_lm.generate(params, cfg, batch, 6)
    _reset_counts()
    on_cuda = serve_lm.generate(tree_to(params, "cuda"), cfg, tree_to(batch, "cuda"), 6)
    launches, routes, _ = _read_counts()
    err = (on_cuda.prefill_logits.cpu() - on_cpu.prefill_logits).abs().max().item()
    check(launches == routes["tma_wgmma_tf32x3"] == cfg.num_layers,
          f"internlm2 smoke f32: {launches} flash launches, routes {routes}")
    check(err <= 1e-4, f"internlm2 smoke: logits {err} off the CPU's")
    rows = {"internlm2_smoke_hd8": {"flash_launches": launches, "flash_routes": routes,
                                    "prefill_logits_max_abs_err": err, "limit": 1e-4,
                                    "tokens_equal": bool(torch.equal(on_cuda.tokens.cpu(),
                                                                     on_cpu.tokens))}}
    # bf16: the kernel's logits against a plain-attention rerun on the card
    # (phase 7's limit), and a rerun with the causal edge off by one, which
    # the same check must fail
    cfg = get_smoke_config("internlm2_20b").scaled(dtype="bfloat16")
    params = model_zoo.init(cfg, device="cuda", seed=SEED)
    batch = serve_lm.make_batch(cfg, 2, 24, device="cuda", seed=SEED + 1)
    _reset_counts()
    run = serve_lm.generate(params, cfg, batch, 6)
    launches, routes, _ = _read_counts()
    with _attention_replaced(chunked_attention_plain):
        plain = serve_lm.generate(params, cfg, batch, 6)
    with _attention_replaced(_causal_edge_off_by_one):
        faulty = serve_lm.generate(params, cfg, batch, 6)
    rel = _logit_rel(run.prefill_logits, plain.prefill_logits, cfg.vocab_size)
    fault_rel = _logit_rel(faulty.prefill_logits, plain.prefill_logits, cfg.vocab_size)
    check(launches == routes["tma_wgmma"] == cfg.num_layers,
          f"internlm2 smoke bf16: {launches} flash launches, routes {routes}")
    check(rel <= SERVE_LOGIT_RTOL, f"internlm2 smoke bf16: logits {rel} off the plain rerun's")
    check(fault_rel > SERVE_LOGIT_RTOL,
          f"internlm2 smoke bf16: the planted causal-edge fault reads {fault_rel}, inside "
          f"the limit {SERVE_LOGIT_RTOL}: the check cannot see it")
    rows["internlm2_smoke_hd8_bf16"] = {
        "flash_launches": launches, "flash_routes": routes, "logits_vs_plain_rel_l2": rel,
        "logits_rel_l2_limit": SERVE_LOGIT_RTOL, "logits_planted_fault_rel_l2": fault_rel,
        "tokens_equal_plain": bool(torch.equal(run.tokens, plain.tokens))}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        a = torch.randn(264, 192, device="cuda").to(dt).t()
        b = torch.randn(136, 264, device="cuda").to(dt).t()
        before = matmul_ops.matmul.launches
        out = matmul_ops.matmul(a, b)
        torch.cuda.synchronize()
        ref = matmul_ref(a.contiguous(), b.contiguous())
        ratio = limit_ratio(out, ref, a.shape[1], TOL[name])
        check(matmul_ops.matmul.launches == before + 1, "transposed matmul: no launch")
        check(ratio <= 1, f"transposed matmul {name}: {ratio} of the limit")
        rows[f"transposed_matmul_{name}"] = {"shape": [192, 264, 136], "limit_share": ratio}
    emit("launch repairs: " + json.dumps(rows))


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def launch_phase(torch, smi, bg):
    """Phase 7h: first (c) the gloo worlds and (d) the dry runs and
    ``pp_lowering.main``, read from ``bg`` (waited for, so that nothing
    runs beside what follows), then (a) sharded serving and (e) the two
    repairs on the card; (b) runs inside phase 7b.  Returns (a)'s flash
    launches."""

    t0 = time.perf_counter()
    _launch_gloo_checks(bg)
    _launch_dryrun_checks(bg)
    t_wait = time.perf_counter() - t0
    t_host = time.monotonic() - bg.t0
    t1 = time.perf_counter()
    launches = _launch_serve(torch, smi)
    t_serve = time.perf_counter() - t1
    _launch_repairs(torch)
    emit(f"launch_phase: {time.perf_counter() - t0:.1f} s (host-side runs {t_host:.1f} s "
         f"from their start, {t_wait:.1f} s of it waited for here; serving {t_serve:.1f} s)")
    return launches


def whisper_entries(shapes):
    """The kernels-line entries of the flash kernels at whisper's four call
    shapes, with the main path's launches at each: the encoder's on
    tma_wgmma, the decoder's prompt self attention and the two cross
    shapes on flash_decode."""

    sources = {"tma_wgmma": TMA_FLASH_SOURCE, "flash_decode": DECODE_FLASH_SOURCE}
    want = {"encoder": "tma_wgmma", "decoder self prefill": "flash_decode",
            "cross prefill": "flash_decode", "cross decode": "flash_decode"}
    entries = []
    for name, row in shapes.items():
        check(row["kernel_route"] == want[name], f"{row['case']}: took {row['kernel_route']}")
        check(row["launches"] > 0, f"{row['case']}: no launch on the main path")
        entries.append({
            "name": f"flash_attention[{row['case']}]",
            "route": "cuda",
            "kernel_route": row["kernel_route"],
            "source": sources[row["kernel_route"]],
            "replaces": FLASH_TPU_KERNEL,
            **{k: row[k] for k in ("launches", "max_abs_err", "max_row_rel_err", "row_rel_limit",
                                   "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "device_ms", "host_ms", "library_device_ms", "reps", "tflops",
                                   "timed_in_turns", "timed_held_cold_l2")},
            **{k: row[k] for k in ("tma_wgmma_ms", "tma_wgmma_device_ms", "tma_wgmma_host_ms")
               if k in row},
            **contract_bound(row["bound_by"]),
        })
    return entries


def contract_bound(term):
    """The kernels line's ``bound_by`` (``"bytes"`` or ``"operations"``)
    for a bound term of :func:`flash_bound`, beside the term itself: the
    exp term is operations of the special-function units."""

    return {"bound_by": "bytes" if term == "bytes" else "operations", "bound_term": term}


def flash_entries(rows, serve_launches, phase_launches):
    """The kernels-line entries of the flash kernels, one per route and
    shape picked: ``tma_wgmma`` at the shape the serving phase gives it
    (its launches are the serving runs' of phases 7, 7c-7f and 7h) and at
    the hd-32 and hd-16 shapes, ``tma_wgmma_tf32x3`` at the f32 prefill
    and at the hd-32 and hd-16 shapes (their launches are phase 6's main
    run's).  A bound set by the exp term is ``"operations"`` (ex2 on the
    special-function units), named in ``bound_term``."""

    picks = [
        ("tma_wgmma", ("yi-6b prefill", "bf16"), serve_launches, TMA_FLASH_SOURCE),
        ("tma_wgmma", ("minilm_hd32", "bf16"), phase_launches["tma_wgmma"], TMA_FLASH_SOURCE),
        ("tma_wgmma", ("hd16_prefill", "bf16"), phase_launches["tma_wgmma"], TMA_FLASH_SOURCE),
        ("tma_wgmma_tf32x3", ("yi-6b prefill", "f32"), phase_launches["tma_wgmma_tf32x3"],
         TF32X3_FLASH_SOURCE),
        ("tma_wgmma_tf32x3", ("minilm_hd32", "f32"), phase_launches["tma_wgmma_tf32x3"],
         TF32X3_FLASH_SOURCE),
        ("tma_wgmma_tf32x3", ("hd16_prefill", "f32"), phase_launches["tma_wgmma_tf32x3"],
         TF32X3_FLASH_SOURCE),
    ]
    entries = []
    for route, (label, dt), launches, source in picks:
        row = next(r for c, r in rows.items() if c[0] == label and c[9] == dt)
        check(row["kernel_route"] == route, f"flash entry {route}: the case took {row['kernel_route']}")
        check(launches > 0, f"flash entry {route}: no launch on the main path")
        entry = {
            "name": f"flash_attention[{row['case']}]",
            "route": "cuda",
            "kernel_route": route,
            "source": source,
            "replaces": FLASH_TPU_KERNEL,
            "launches": launches,
            "max_abs_err": row["max_abs_err"],
            "max_row_rel_err": row["max_row_rel_err"],
            "row_rel_limit": row["row_rel_limit"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            **contract_bound(row["bound_by"]),
            "library_ms": row["library_ms"],
            "reps": row["reps"],
            "tflops": row["tflops"],
        }
        for key in ("depth", "key_tile", "timed_in_turns", "bound_rate", "f64_limit_share",
                    "small_hd"):
            if key in row:
                entry[key] = row[key]
        entries.append(entry)
    return entries


def report_build(build_log):
    """Each kernel's ptxas lines (registers, spills, warnings) from the
    build's log per source; fails on a spill in the flash_decode and TMA
    sources (the matmul's stage kernel among them), and on an ignored
    setmaxnreg in the TMA ones."""

    for name, log in build_log.items():
        kernel = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]  # the mangled kernel name
            elif "registers" in line or "warning" in line.lower() or (
                "spill" in line and " 0 bytes spill" not in line
            ):
                emit(f"  ptxas {kernel}: {line.strip()}")
        if name == Path(DECODE_FLASH_SOURCE).name:
            check(
                all(" 0 bytes spill stores, 0 bytes spill loads" in line
                    for line in log.splitlines() if "spill" in line),
                f"{name}: ptxas reports spills",
            )
        if name == Path(TMA_KERNEL_SOURCE).name:
            check("stage_bf16_kernel" in log, f"{name}: ptxas compiled no stage kernel")
        if name in (Path(TMA_KERNEL_SOURCE).name, Path(TMA_FLASH_SOURCE).name,
                    Path(TF32X3_SOURCE).name, Path(TF32X3_FLASH_SOURCE).name):
            # setmaxnreg must be honoured and the accumulators a consumer
            # thread holds must stay in registers
            check("C7508" not in log, f"{name}: ptxas ignored setmaxnreg (C7508)")
            check(
                all(" 0 bytes spill stores, 0 bytes spill loads" in line
                    for line in log.splitlines() if "spill" in line),
                f"{name}: ptxas reports spills",
            )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # deterministic cuBLAS for phase 7b's resume check; on Hopper PyTorch's
    # default workspace is this size already, so no earlier phase changes
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit(smi)
    emit(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} tf32 off"
    )

    # phase 2: build every kernel source, all at once
    from repro_torch.kernels import _build, sources

    t0 = time.perf_counter()
    built = _build.build(sources())
    emit(f"build: {len(built)} source(s) in {time.perf_counter() - t0:.2f} s")
    report_build(_build.BUILD_LOG)

    level_loop_phase(torch)  # phase 3
    operator_phase()
    service_phase(torch)  # phase 3b
    calibration_phase(torch, smi)  # phase 3c
    spmd_phase(torch, smi)  # phase 3d
    pipeline_phase(torch, smi)  # phase 3e
    kloop_phase()  # phase 4
    entries = matmul_phase(torch)  # phase 5
    flash_rows, flash_phase_launches, split_entry = flash_phase(torch)  # phase 6
    t0 = time.perf_counter()
    flash_launches = serve_phase(torch)  # phase 7
    emit(f"serve_phase: {time.perf_counter() - t0:.1f} s")
    train_phase(torch)  # phase 7b, and 7h (b) on its state
    for phase in (moe_serve_phase, mamba_serve_phase):  # phases 7c, 7d
        t0 = time.perf_counter()
        flash_launches += phase(torch)
        emit(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    encdec_launches, whisper_rows = encdec_serve_phase(torch)  # phase 7e
    emit(f"encdec_serve_phase: {time.perf_counter() - t0:.1f} s")
    flash_launches += encdec_launches
    t0 = time.perf_counter()
    flash_launches += batching_phase(torch, smi)  # phase 7f
    emit(f"batching_phase: {time.perf_counter() - t0:.1f} s")
    bg = None
    try:
        t0 = time.perf_counter()
        family_train_phase(torch, smi, FAMILY_TRAIN[:FAMILY_TRAIN_ALONE])  # phase 7g
        bg = LaunchBackground()  # phase 7h (c) and (d)
        family_train_phase(torch, smi, FAMILY_TRAIN[FAMILY_TRAIN_ALONE:])
        emit(f"family_train_phase: {time.perf_counter() - t0:.1f} s")
        flash_launches += launch_phase(torch, smi, bg)  # phase 7h
    finally:
        if bg is not None:
            bg.stop()
    entries.extend(flash_entries(flash_rows, flash_launches, flash_phase_launches))
    entries.extend(whisper_entries(whisper_rows))
    entries.append(split_entry)

    emit(json.dumps({"kernels": entries}))  # phase 8
    emit(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    emit(smi)
    emit(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
