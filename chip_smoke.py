#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port: build, kernel-vs-plain, serve, train,
LM serving, online serving.

    python3 chip_smoke.py            # one CUDA card; a few minutes

Drives the port (``src/repro_torch``, never JAX nor the reference package)
on one CUDA card, in phases, for the registry's models (RGAT, RGCN, HGT,
rgcn_cat) and the dense LMs (gemma2-2b, qwen3-4b; the reduced variants of
all four dense configs); any failure exits non-zero. Each phase prints
``[phase N] start`` first. Phases 3-5, 9, 11 and 13-16 run the
drivers' default: the executors capture one CUDA graph per signature at its
second call and replay it (``core.executor``); phases 6 and 10 train op
by op and then at that default. A kernel wrapper counts the launches it
makes, op by op or into a graph being captured, not the kernels a replay
runs: so the launch counts that are held exactly, and those of the
``kernels`` line, come from op-by-op runs (phases 6 and 10 first, 11's
tuned runs, 12), and the captured runs' kernels are counted from
``torch.profiler`` traces (phases 5 and 14). The phases that record,
time or profile single kernel calls (2, 7, 8; phase 12's LM path has no
executor) run op by op (``compiled=False``), so their numbers stay
comparable across versions:

1. card and build: the card's name and power limit, TF32 off, every kernel
   in ``src/repro_torch/csrc`` built from source (one ``nvcc`` per file,
   all at once), with the build seconds and ptxas's register report, the
   registers and spills of each of K1's and K4's 14 kernels (both routes,
   every register tile; the phase fails on a spill), and the fp64
   tensor-core (DMMA) instructions in K5's SASS (``cuobjdump -sass``: the
   phase fails if there are none);
2. kernels against their plain PyTorch versions on the card, at the shapes
   real runs give them (all captured): one served mini-batch of each serve
   phase (RGAT aifb-b32 and bgs-b1024: K1-K3; RGCN aifb-b32 and bgs-b1024:
   K1, K7; HGT aifb-b32: K1-K4, K4 on the node-type segments), the device
   sampling and forward of the first device-sampled batch of RGAT at
   aifb-b32 and bgs-b1024 and RGCN at aifb-b32 (K9 at every window, K1-K3
   and K7 on the device-built layouts) and one sampled training step of
   RGAT, RGCN and HGT (aifb-b64: K1-K5, K7 (at d = 1 too: the softmax
   VJP's sum), K11); the slot-split kernels, K2
   and K3 at every captured K2 / K3 call, K6 (on K3's messages padded into
   the slots) at every captured K3 call, K7 and K8 (K8 on K7's messages
   padded into the slots) at every captured K7 call, each at unit sizes
   ``chunk_tiles`` 1 / 2 / 8 / 64 and bitwise against a second launch,
   after the slot order they rely on is checked on the card; K1, K4, K5
   and K11 bitwise against a second launch at every call;
   plus edge cases (gather index -1, groups and node blocks without tiles,
   pow2 pad tiles, the scale epilogue, k = 1 and n = 1, a transposed W, a
   group long enough for many K5 chunks, the CUDA ``edge_softmax``, K7
   with ``scale=None``, compact rows with -1, d = 1, empty layouts that
   must not launch; K7 and K8 over a 40,000-slot destination across many
   units, unit edges at changes of destination, all-pad units and a
   pure-pad tail, node blocks without tiles, d = 1 / 8 / 16 / 64 / 96, and
   K2, K3 and K6 on the same layouts, one destination's scores spanning
   [-80, 80]; K5 with single- and multi-chunk groups at
   chunk sizes 1, 2 and the fitted one, k and n of 1 / 8 / 64, surplus
   chunks and a launch without real tiles; K1 and K4 where their work
   split (``segment_mm.gemm_plan``) has its edges: group changes inside a
   piece and a persistent span at tile 8, 16 and 32 on a small and a
   large layout, a K1 tile of -1 next to a real one, a pure-pad tail, k =
   7, 30 and 300, n = 1, 3, 8, 16, 17, 64 and 96, a transposed W at k = 1,
   8 and 64, the scale on both routes, every route and register tile
   taken; K9 with counts 0 and C, C = 1,
   odd row counts and high-bit base keys; K5 with the static chunk bound
   of device-built layouts; K11 with every target -1, one row taking
   40,000 entries, runs of 1 to 769 entries and empty rows laid across its
   256-entry unit edges, with and without leading -1s, and a hub among
   5,000 rows, each at d = 1 / 7 / 64 / 96 / 300). K9 is held bit for bit, decoded, to its plain
   version and to numpy's ``edge_sample_keys``. Tolerances: K1 and K4
   rtol = atol = 1e-5 (fp32 sums of at most 64 terms); K2 ``mx`` exact,
   ``den`` rtol 1e-5; K3 rtol = atol = 2e-5 (the reference's own
   fused-vs-oracle bound); K5
   rtol = atol = 1e-6 and K7 rtol = atol = 1e-5 (the reference's
   ``test_weighted_agg`` bound; kernel and plain version both sum in fp64,
   so they agree to the final fp32 rounding); K11 rtol = atol = 1e-6
   (both sum in fp64). At the RGAT aifb served
   batch (K1-K3), the RGAT training step (K4, K5), the RGCN aifb served
   batch (K7), RGAT's first device-sampled aifb batch (K9) and the RGAT
   training step (K11, beside ``index_add_``, the atomic scatter it
   replaced): each
   kernel's device time (mean of 20 calls under ``torch.profiler``), the
   wrapper's time per call (CUDA events, median of 25 runs of 10 calls:
   host cost included), its plain version's time, its bound and, for K1
   and K4, ``torch.bmm`` on the same tiles, for K5 ``torch.bmm`` over the
   groups' row runs zero-padded to the longest, for K7 ``torch.sparse.mm``
   of the scales as a CSR matrix and for K3 of the softmax weights; K7
   and K8 also at the RGCN bgs-b1024 batch's hop-0 call, K2, K3 and K6
   at RGAT's
   (and in phase 7 at the bgs full-graph forward's calls, K5 at a bgs
   full-graph step's calls);
3. serving at the driver's defaults (2 layers, 64 wide, aifb at scale 1.0,
   fanout 5, 32 seeds x 8 batches) through
   ``repro_torch.launch.serve_rgnn.serve``, for RGAT, RGCN, HGT and
   rgcn_cat: each model's kernels (RGAT K1-K3, RGCN and rgcn_cat K1 + K7,
   HGT K1-K4) must launch and no other, every batch's logits be finite
   and match the same mini-batch run through the port on the CPU
   (rtol = atol = 1e-4);
4. the same at a larger size (bgs at scale 1.0, 1024 seeds x 4 batches),
   for RGAT and RGCN;
5. every serve run again under ``torch.profiler``: the kernels the card
   ran (replayed graphs included) equal each model's per-forward counts
   (``FORWARD_LAUNCHES``) times the batches, each kernel's device time per
   launch and per batch, and the device's busy share of the loop;
6. sampled training through ``repro_torch.launch.train_rgnn.train`` (aifb
   at scale 1.0, 2 layers, 64 wide, 8 classes, fanout 5, batch 64, 1
   epoch, HGT 2, lr 1e-2) of RGAT, RGCN and HGT, op by op: the kernels
   launch at each model's per-step counts (``STEP_LAUNCHES``, plus the
   full-graph forwards' ``FORWARD_LAUNCHES``), the loss is finite and
   falls (mean of the last 10 steps below the mean of the first 10); the
   same captured (the default): the first loss bit for bit, finite and
   falling, every repeated key replayed; then one
   ``grad_and_update`` on the card and on the CPU from one state (after 5
   card steps; see ``TrainTask``) on one mini-batch: loss rtol 1e-5,
   params and ``mu`` rtol 1e-4 / atol 1e-6 (the reference's own
   step-parity bounds);
7. full-graph training (``FullGraphTrainer``) of each: aifb, one step on
   the card against the CPU from phase 6's state, at its bounds; bgs at
   scale 1.0, 3 steps with a finite loss, timed; K1, K4, K5 and K11 held
   (each bitwise against a second launch too) and timed at every call of one bgs
   full-graph step (device ms, wrapper ms, plain ms, ``torch.bmm`` ms,
   bound, and K1's / K4's work split); for RGCN,
   K7 and K8 held and timed (as phase 2 times them) at the K7 calls of
   one bgs full-graph forward, for RGAT and HGT K2 and K3 at their calls
   and K6 at K3's;
8. one sampled step and one bgs full-graph step of each under
   ``torch.profiler``: device time per kernel and per step, the device's
   busy share, the split between the ``forward`` / ``backward`` /
   ``optimizer`` ranges, and the device ops that take the most time; then
   each step once more under ``torch.use_deterministic_algorithms(True,
   warn_only=True)`` (a diagnostic: the ops that warn are listed);
9. device-sampled serving (``sampler="device"``) of RGAT and RGCN at
   aifb-b32 (8 batches) and RGAT at bgs-b1024 (4 batches), the seeds of
   phases 3 and 4: every batch's logits equal the host-sampled ones
   within rtol = atol = 2e-4 (the reference's own device-vs-host bound),
   no host build, no count sync after warmup, every batch that outgrew a
   shrunken bucket rebuilt, every sampling call after the first under
   ``torch.cuda.set_sync_debug_mode("error")``, K9 launched; latency,
   wait, compute, seeds/s, peak memory and bucket shrinks beside the
   host-sampled run's;
10. phase 6's RGAT training with ``sampler="device"``, op by op: the
   first loss equal to the host-sampled run's (rtol 1e-4), a falling
   loss, the kernels at their per-step counts (K5 with its static chunk
   bound), K9 twice a sampled batch; then captured, as phase 6;
11. tuning (``--tune``): (a) K6 and K8, the materialized-gather
   aggregations the tuner selects with ``fuse_gather=False``, against
   their plain versions at the calls of one RGAT and one RGCN served
   aifb-b32 batch and one RGAT training step under decisions that force
   ``fuse_gather=False`` on every key (K6 rtol = atol = 2e-5, K3's; K8
   1e-5, K7's; each at every unit size, as phase 2 holds the slot-split
   kernels), plus edge cases (node blocks without tiles, pure-pad
   tiles, pad rows that must add nothing, d = 1, compact rows through the
   ops, empty layouts that must not launch), timed at the served batches
   as phase 2 times the others (K8's library call: ``torch.sparse.mm``);
   (b) ``{fuse_gather: False}``, ``{tile_rows: 16}`` and ``{tile_rows: 8,
   fuse_gather: False}`` on every key of an RGAT and an RGCN layer over
   the aifb graph against the defaults, outputs rtol = atol = 2e-4 and
   normalized gradients 5e-4 (the reference's ``tests/test_tune.py``
   bounds), a decision naming another backend refused, and RGAT at layout
   128/128 against 32/32; (c)
   ``train_rgnn.train(tune="full")`` at phase 6's RGAT configuration (both
   layout candidates timed, the loss falls), then ``tune="cached"``: zero
   measurements, every decision replayed, the same table; (d)
   ``serve_rgnn.serve(model="rgcn", tune="full")`` at aifb-b32, each
   batch against the CPU run within 2e-4; (e) ``Tuner.tune_stack`` of a
   2-layer RGAT over bgs at scale 1.0, each layout candidate's plan time;
12. LM serving with K10, the flash attention of prefill and decode: first
   K10's kernels as built (ptxas's registers and spills for each, and the
   HMMA / HGMMA count of each kernel's SASS from ``cuobjdump -sass``: the
   tensor-core prefill kernel must have some); (b)
   ``repro_torch.launch.serve`` at full width in bf16 (the port's own
   init): gemma2-2b at batch 4, prompt 4096, gen 32 (26 layers; decode
   positions past 4096 reach the local layers' window; softcap 50) and
   qwen3-4b at batch 8, prompt 2048, gen 32 (qk-norm, hd 128, g = 4): K10
   launched exactly ``num_layers x gen`` times and no other kernel, every
   logit finite, prefill ms, decode ms per token, tok/s, peak memory; (a)
   K10 against its plain version at the calls kept from (b) (the first
   local-window and global layer's prefill call and their calls at the
   last decode step) and at edge cases (ragged lengths, decode at the
   first, a middle and the last slot, window 1 and wider than the keys,
   softcap without causal masking, MQA, g = 5, hd 8 / 16 / 64 / 128 /
   256, batch 1, rows whose first tiles are all before the window, rows
   that see no key (they average every value, as the reference's do), a
   split decode, a cache layer read in place, non-contiguous K / V, an
   empty query that launches nothing), each in its own dtype and in bf16,
   and bf16 cases across the tensor-core and decode kernels' tile edges
   (rows and keys off the tile, chunked prefill, window edges inside a
   tile, a cache layer read in place with Sk > Sq), so that every route of
   ``flash_attention.plan`` is held: rtol = atol = 2e-5 in fp32 (the
   reference's ``tests/test_flash.py`` bound); in bf16 rtol = 2^-7 (one
   bf16 ulp) and atol = 2e-5, inside the reference's 3e-2; each kept call
   is held again upcast to fp32 at 2e-5; (d) at the
   kept calls K10's device time, the wrapper's, the plain version's,
   ``scaled_dot_product_attention(enable_gqa=True)``'s (the window as an
   explicit mask; it has no softcap) and the bound (bytes over 3.35 TB/s
   or the unmasked pairs' FLOPs over the bf16 tensor or fp32 peak); (c)
   the card against the CPU through the port in fp32 on the same
   parameters: the four dense configs' reduced variants (prefill + 4
   decode steps) and gemma2-2b / qwen3-4b at full width with one repeat
   per stage (batch 2, prompt 256, gen 8): logits within 1e-4, greedy
   tokens equal wherever the CPU's top-2 margin exceeds 1e-3; then each
   serve run's prefill and decode loop under ``torch.profiler``;
13. telemetry (``repro_torch.obs``): (a) RGAT aifb-b32 served at phase 3's
   settings three times, ``obs_mode="off"``, ``"on"`` and ``"on"`` with
   ``trace_out`` (and ``profile``): every batch's logits bitwise equal,
   the same ``executor_traces`` and ``retraces_after_warmup``, the
   registry's ``executor_traces`` counter equal to the stats', one
   ``serve_batch_ms`` observation a batch, the Chrome trace valid under
   the port's schema with ``wait`` / ``execute`` / ``sample`` / ``layout``
   spans (the loader's on another thread track than ``execute``), and as
   many ``torch.cuda.synchronize`` calls with metrics on as with obs off
   and one per batch (counted by wrapping it), the captures'
   synchronizes (the executor makes one before each) counted
   apart, one per graph; each run's p50 printed with the card; (b) the
   same with ``sampler="device"`` (``sample_device`` / ``layout_device``
   spans, the ``sampler_traces`` counter equal to
   ``DeviceSampler.trace_count``); (c) ``CompiledRGNN.profile`` of the last
   batch (through ``serve(profile=True)``) at aifb-b32 and RGAT
   bgs-b1024: one row per plan op and one glue row per hop, categories
   within gemm / traversal / wprod / glue, coverage within [0.8, 1.25] at
   bgs, the rows and the categories in ms printed; (d) and (e)
   ``train_rgnn.train`` of phase 6's RGAT with obs off, on, and on with
   ``trace_out`` and ``profile``: every loss bitwise equal across the
   three (the backward runs in a fixed order: K11, K7; no float atomics),
   as many synchronizes on as off and one per step (the captures' apart,
   one per graph), each run's step p50; a ``train_step``
   span and a ``train_step_ms`` observation per step,
   ``profile_train_step``'s forward / backward / optimizer / total (all
   >= 0, total >= forward) beside phase 8's profiler split;
   phase 11's tuned runs (obs on) have ``tune_*`` counters equal to the
   tuner's counts. Each run counts its launches from 0 and must launch
   the kernels of its path;
14. loader caches and captured executors: (a) RGAT, RGCN and HGT
   aifb-b32 served with repeating traffic (``repeat_after=4``, 12
   batches) and both loader caches on, captured against ``compiled=False``
   and captured again under ``torch.profiler``: every batch's logits
   bitwise equal, the kernels the card ran captured (from the trace,
   replays included) equal to the op-by-op launches, no new key after
   warmup, one graph per key, a replay per repeated key, 8 block-cache
   hits, the registry's ``loader_cache_*`` counters equal to
   ``cache_stats``; (b) RGAT aifb-b32 over 16 fresh batches:
   ``executor_compiled`` equals the distinct shape signatures among the
   batches, the graphs captured those that come again; (c)
   (a) with ``sampler="device"``; (d) RGAT aifb-b64 for one epoch through
   ``SampledTrainer`` captured against op by op (every loss and the final
   params and moments bit for bit), and step by step each captured step
   against an op-by-op step from the same state (the loss, params and
   moments bit for bit), and RGAT bgs full-graph for 5 such paired steps,
   the captured step returning its state buffers; (e) K5 captured at its
   counter buffer's size, replayed
   before and after the buffer is outgrown, against its plain version and
   a launch outside the graph; (f) a stress run, twice: 200 captures of
   the aifb-b64 step and 200 of the bgs-b1024 forward, each by a new
   executor held in a reference cycle, beside a host loader building and
   copying bgs-b1024 batches the whole time, a collection forced before
   every capture, every replay bitwise equal to its first call and no
   collection while a stream captures; (g) two identical runs bit for
   bit (every loss, the final params and moments): an RGAT and an HGT
   aifb-b64 epoch, 5 bgs full-graph steps of RGAT, RGCN and HGT. Times are
   printed, never gated;
15. tiered feature storage (``--feature-store``, ``repro_torch.feats``),
   through the drivers at their defaults (captured, the host loader's
   producer thread on): (a) RGAT and RGCN bgs-b1024 (6 batches of a
   Zipf-1.2 stream) served once per tier, ``device``, ``host`` and
   ``cached`` (table/4 rows, the split measured on the stream): every
   batch's logits bit for bit across the tiers, the first batch within
   1e-4 of the CPU run, the kernels launched (counted from 0) the device
   tier's, each store's own device allocation its ``device_bytes()`` (the
   bytes its build requested from the caching allocator, exactly: the
   table's, 0, the slab's; ``memory_allocated`` within the allocator's
   rounding), and, from the allocator's trace of the whole run, no
   allocation of the table's size with ``host`` or ``cached`` (one with
   ``device``); per tier p50 / p95, wait and compute, seeds/s, bytes
   moved, host gathers, peak memory, and the cache's hits, misses,
   evictions, overflows, hit rate and slot split; (b) RGAT with a
   512-row cache: overflow, the logits still the device tier's; (c)
   device-sampled RGAT aifb-b32, ``host`` against ``device``, bit for
   bit; (d) RGAT aifb-b64 trained for an epoch with ``cached`` against
   ``device``: every loss bit for bit;
16. the online serving runtime (``serve_rgnn --runtime online``,
   ``repro_torch.serve``, calibrated as ``serve_online`` does: floors at
   the probed maxima) at full width (2 layers, 64 wide, fanout 5,
   tile and node block 32, bucketed, aifb at scale 1.0, the fine ladder
   up to 32, max wait 5 ms, request sizes 1 / 2 / 4 / 8), with the
   runtime's ``coalescer.plan`` and the engine's ``forward_minibatch``
   wrapped by the script to record the planned and served batches: (a)
   RGAT, Poisson 200 req/s, 256 requests, SLO 1000 ms; (b) RGCN, bursts
   of 8 at 200 req/s, the ``cached`` feature tier; (d) RGAT with
   ``sampler="device"``; each: every request terminal and ``OK``, no new
   key and no capture after warm-up, every response's rows bit for bit
   those of an op-by-op forward of its batch, no thread left after
   ``close()`` ((d) at 100 req/s: the device sampler's launches saturate
   the execute thread at 200); (c) RGAT and RGCN as two tenants, 128
   requests each at 100 req/s in all,
   RGCN calibrated with one warm round and no floor probes (its execute
   thread captures during traffic): no crash, every response bit for bit
   its op-by-op forward, RGAT without a new key or a capture after
   warm-up; (e) SLO 0.5 ms: every request rejected at admission or late,
   none ``OK`` past its SLO. p50, p99, SLO attainment, batch fill, rung
   counts and the mean queue and execute ms of each run are printed.

The line before the last is ``{"kernels": [...]}`` (``launches``: phase
6's op-by-op runs of all three models for K1-K5, K7 and K11, phases 9 and 10
for K9 (the sampler launches K9 outside the executors),
phase 11's tuned training and serving for K6 and K8, phase 12's serve runs
for K10, each counted from 0 just before the run); the last line is
``{"ok": true, "device": {...}}``.
``--out PATH`` also writes every number as JSON, ``--trace-dir DIR`` the
phase-8 Chrome traces.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s (no tensor
# cores: the kernels compute in IEEE fp32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# the kernel wrappers, as ``ops.launch_counts()`` names them
K1, K2, K3 = ("segment_mm_gather_padded", "seg_stats_padded",
              "seg_softmax_agg_gather_padded")
K4, K5, K7 = ("segment_mm_padded", "segment_outer_padded",
              "seg_weighted_agg_gather_padded")
K6, K8 = "seg_softmax_agg_padded", "seg_weighted_agg_padded"
K9, K10 = "candidate_keys", "flash_attention"
K11 = "seg_sum_sorted"

SERVE_DEFAULTS = dict(model="rgat", dataset="aifb", scale=1.0, layers=2,
                      dim=64, hidden=64, classes=16, fanouts=[5, 5],
                      batch_size=32, num_batches=8, tile=32, node_block=32,
                      seed=0)
SERVE_LARGE = dict(SERVE_DEFAULTS, dataset="bgs", batch_size=1024,
                   num_batches=4)
# phases 3-5: (tag, config) of every serve run, in order
SERVE_RUNS = (
    ("rgat aifb", SERVE_DEFAULTS), ("rgat bgs", SERVE_LARGE),
    ("rgcn aifb", dict(SERVE_DEFAULTS, model="rgcn")),
    ("hgt aifb", dict(SERVE_DEFAULTS, model="hgt")),
    ("rgcn_cat aifb", dict(SERVE_DEFAULTS, model="rgcn_cat")),
    ("rgcn bgs", dict(SERVE_LARGE, model="rgcn")))
TRAIN = dict(model="rgat", dataset="aifb", scale=1.0, layers=2, dim=64,
             hidden=64, classes=8, fanouts=[5, 5], batch_size=64, epochs=1,
             lr=1e-2, tile=32, node_block=32, seed=0)
# the trained models and their epochs: HGT's sampled loss rises over its
# first epoch at these settings (the same arithmetic on the CPU) and falls
# in the second, so it trains for two
TRAIN_EPOCHS = {"rgat": 1, "rgcn": 1, "hgt": 2}
# launches per sampled training step (2 layers; layer 0's input needs no
# dX). RGAT: 3 gathered GEMMs (K1) and one fused softmax + aggregation
# (K2 + K3) per layer; dX by K4 of the 3 GEMMs of layer 1, summed into the
# source rows by K11, dW by K5 of all 6; each layer's compact message
# gradient by K11 and its softmax VJP's per-destination sum by K7 at width
# 1. RGCN: one gathered GEMM (K1) and one mean aggregation (K7) per layer
# (W_self is untyped: a plain matmul); layer 1's dX by K4 + K11, each
# layer's compact message gradient by K11. HGT: 3 node-typed GEMMs (K4)
# and 2 gathered ones (K1) and the fused softmax tail (K2 + K3) per layer;
# dX by K4 of the 4 gathered GEMMs (layer 1's two summed by K11) and of
# layer 1's 3 node-typed ones, dW by K5 of all 10; per layer the compact
# message gradient by K11 and the softmax VJP by K7 at width 1.
STEP_LAUNCHES = {
    "rgat": {K1: 6, K2: 2, K3: 2, K4: 3, K5: 6, K7: 2, K11: 5},
    "rgcn": {K1: 2, K7: 2, K4: 1, K5: 2, K11: 3},
    "hgt": {K1: 4, K2: 2, K3: 2, K4: 13, K5: 10, K7: 2, K11: 6},
}
# launches per 2-layer forward (a full-graph forward; every served batch)
FORWARD_LAUNCHES = {
    "rgat": {K1: 6, K2: 2, K3: 2},
    "rgcn": {K1: 2, K7: 2},
    "rgcn_cat": {K1: 2, K7: 2},
    "hgt": {K1: 4, K2: 2, K3: 2, K4: 6},
}

# each ported kernel: its source, the TPU kernel it replaces, a part of the
# name of each of its ``__global__`` functions as the profiler reports them
# (K3, K6, K7, K8: the unit kernel and the combine instantiated for it;
# K2: the max and sum passes' unit kernels and combines), and how many
# kernels one call launches
KERNELS = {
    K1: dict(source="src/repro_torch/csrc/segment_mm.cu",
             replaces="src/repro/kernels/segment_mm.py:120",
             symbol="segment_mm_gather_"),      # wide and narrow routes
    K2: dict(source="src/repro_torch/csrc/traversal.cu",
             replaces="src/repro/kernels/traversal.py:75",
             symbol="stats_", per_call=4),   # two passes, unit + combine
    K3: dict(source="src/repro_torch/csrc/traversal.cu",
             replaces="src/repro/kernels/traversal.py:224",
             symbol="softmax_agg_gather_", per_call=2),   # unit + combine
    K4: dict(source="src/repro_torch/csrc/segment_mm.cu",
             replaces="src/repro/kernels/segment_mm.py:44",
             symbol="segment_mm_padded_"),      # wide and narrow routes
    K5: dict(source="src/repro_torch/csrc/segment_mm.cu",
             replaces="src/repro/kernels/segment_mm.py:194",
             symbol="segment_outer_kernel"),
    K6: dict(source="src/repro_torch/csrc/traversal.cu",
             replaces="src/repro/kernels/traversal.py:142",
             symbol="softmax_agg_padded_", per_call=2),   # unit + combine
    K7: dict(source="src/repro_torch/csrc/traversal.cu",
             replaces="src/repro/kernels/traversal.py:294",
             symbol="weighted_agg_gather_", per_call=2),   # unit + combine
    K8: dict(source="src/repro_torch/csrc/traversal.cu",
             replaces="src/repro/kernels/traversal.py:356",
             symbol="weighted_agg_padded_", per_call=2),
    K9: dict(source="src/repro_torch/csrc/sampling.cu",
             replaces="src/repro/kernels/sampling_ops.py:77",
             symbol="candidate_keys_kernel"),
    K10: dict(source="src/repro_torch/csrc/flash_attention.cu",
              replaces="src/repro/kernels/flash_attention.py:75",
              symbol="flash_"),       # the kernel and its split combine
    # no TPU kernel: the backward's scatter-adds, which the reference
    # leaves to XLA and the port ran as atomic ``index_add_``
    K11: dict(source="src/repro_torch/csrc/scatter.cu",
              replaces="none (no TPU kernel): the backward's scatter-add, "
                       "src/repro/kernels/ops.py:301, :477, :617",
              symbol="seg_sum_sorted_", per_call=2),   # unit + combine
}
# where each kernel is timed in phase 2 (phase 11 for K6 and K8): the
# captured calls of one served batch ("<model> aifb"), one training step
# ("<model> step"), the device sampling of one served batch ("<model> aifb
# device") or one served batch under decisions that force
# ``fuse_gather=False`` ("<model> aifb unfused"); phase 12 times K10 at
# the calls it keeps from the LM serve runs ("lm serve")
TIMED_AT = {K1: "rgat aifb", K2: "rgat aifb", K3: "rgat aifb",
            K4: "rgat step", K5: "rgat step", K7: "rgcn aifb",
            K11: "rgat step",
            K9: "rgat aifb device", K6: "rgat aifb unfused",
            K8: "rgcn aifb unfused", K10: "lm serve"}
# the kernels phase 11 holds to their plain versions (the materialized-
# gather variants the tuner selects) and the one phase 12 holds (the LM's
# attention); phase 2 holds the others
TUNING_KERNELS = (K6, K8)
LM_KERNELS = (K10,)
# phase 9: the serve runs repeated with ``sampler="device"``; phase 2
# captures the first device-sampled batch of each (K7 on RGCN's
# device-built layouts)
DEVICE_SERVE_RUNS = (
    ("rgat aifb", SERVE_DEFAULTS), ("rgcn aifb", dict(SERVE_DEFAULTS,
                                                      model="rgcn")),
    ("rgat bgs", SERVE_LARGE))
CAPTURED_DEVICE = ("rgat aifb", "rgat bgs", "rgcn aifb")
# the bound of device-sampled logits against host-sampled ones (the
# reference's test_device_minibatch_forward_matches_host in
# tests/test_sampling.py)
DEVICE_TOL = 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` of the per-launch time of ``inner`` back-to-back
    calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _device_us(event) -> float:
    t = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if t is None else t


def device_ms(torch, fn, symbol: str, reps: int = 20,
              per_call: int = 1) -> float:
    """Mean device time of one call of ``fn`` (``per_call`` kernels named
    ``symbol``...) over ``reps`` calls under ``torch.profiler`` (the host's
    share excluded).

    Back-to-back profiler sessions sometimes drop kernel records (seen: 3
    of 20 delivered, their mean about 4x a full session's, and up to three
    sessions in a row that delivered none). A session that recorded fewer
    than half the launches is run again after a one-second pause (at most
    three sessions); the mean is over the launches of the session that
    recorded the most, and the run fails if none recorded a launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = reps * per_call
    count, total_us = 0, 0.0
    for session in range(3):
        if session:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got, got_us = 0, 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    symbol in e.key:
                got_us += _device_us(e)
                got += e.count
        if got > count:
            count, total_us = got, got_us
        if 2 * got >= want:
            break
        log(f"[profiler] {symbol}: session {session + 1} recorded {got} "
            f"of {want} launches")
    check(count > 0, f"{symbol}: the profiler recorded none of {want} "
          f"launches in three sessions")
    if count != want:
        log(f"[profiler] {symbol}: recorded {count} of {want} launches; "
            f"timing the recorded ones")
    return total_us / count * per_call / 1e3


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_work(torch, args, kw):
    """Bytes and FLOPs K1 must move/do on these inputs: each distinct
    gathered row of X and each W slice used read once, indices read once,
    Y written once; 2*k*n FLOPs per gathered row."""
    x, w, gidx, t2g = args[:4]
    scale = args[4] if len(args) > 4 else kw.get("row_scale_p")
    tile = kw["tile"]
    rp, k, n = gidx.shape[0], w.shape[1], w.shape[2]
    valid = gidx[gidx >= 0]
    rows = int(torch.unique(valid).numel())
    groups = int(torch.unique(t2g[: rp // tile]).numel())
    nbytes = (rows * k + groups * k * n + rp * n) * 4 + rp * 4 \
        + (rp // tile) * 4 + (rp * 4 if scale is not None else 0)
    return nbytes, 2.0 * valid.numel() * k * n


def k2_work(torch, args, kw):
    scores_p, local_dst = args[0], args[1]
    slots = scores_p.numel()
    nodes = kw["num_node_blocks"] * kw["node_block"]
    valid = int((local_dst < kw["node_block"]).sum())
    nbytes = slots * 8 + (kw["num_node_blocks"] + 1) * 4 + nodes * 8
    return nbytes, 4.0 * valid


def k3_work(torch, args, kw):
    scores_p, msg, mmap, local_dst = args[:4]
    d = msg.shape[-1]
    slots = scores_p.numel()
    nodes = kw["num_node_blocks"] * kw["node_block"]
    keep = (local_dst.reshape(-1) < kw["node_block"]) & (mmap >= 0)
    rows = int(torch.unique(mmap[keep]).numel())
    nbytes = slots * 12 + rows * d * 4 + nodes * 8 \
        + (kw["num_node_blocks"] + 1) * 4 + nodes * d * 4
    return nbytes, float(keep.sum()) * (2.0 * d + 4)


def k4_work(torch, args, kw):
    """K4: each nonzero row of X_p and each W slice used read once, Y
    written once; 2*k*n FLOPs per nonzero row (pad rows are zero)."""
    x_p, w, t2g = args[:3]
    scale = args[3] if len(args) > 3 else kw.get("row_scale_p")
    rp, kd = x_p.shape
    n = w.shape[1] if kw.get("transpose_w") else w.shape[2]
    tile = kw["tile"]
    rows = int((x_p != 0).any(dim=1).sum())
    groups = int(torch.unique(t2g[: rp // tile]).numel())
    nbytes = (rows * kd + groups * kd * n + rp * n) * 4 + (rp // tile) * 4 \
        + (rp * 4 if scale is not None else 0)
    return nbytes, 2.0 * rows * kd * n


def k5_work(torch, args, kw):
    """K5: the rows of the real tiles of X_p and dY_p read once, dW written
    once; 2*k*n FLOPs per row (fp32 inputs; the sums run in fp64)."""
    x_p, dy_p, gtp, gcp = args[:4]
    k, n = x_p.shape[1], dy_p.shape[1]
    rows = int(gtp[-1]) * kw["tile"]
    nbytes = rows * (k + n) * 4 + kw["num_groups"] * k * n * 4 \
        + 2 * (kw["num_groups"] + 1) * 4
    return nbytes, 2.0 * rows * k * n


def k1_library(torch, args, kw):
    """One ``torch.bmm`` over the same tiles, the rows gathered (gather
    index -1: zero rows) and W's slices gathered beforehand: the yardstick
    of K1, used nowhere in the port (without the scale epilogue)."""
    x, w, gidx, t2g = args[:4]
    tile = kw["tile"]
    t = gidx.shape[0] // tile
    xg = torch.where((gidx >= 0)[:, None], x.detach()[gidx.clamp(min=0)
                                                      .long()], 0.0)
    xt = xg.reshape(t, tile, x.shape[1]).contiguous()
    wt = w.detach()[t2g[:t].long()].contiguous()
    return lambda: torch.bmm(xt, wt)


def k4_library(torch, args, kw):
    """One ``torch.bmm`` over the same tiles, W's slices gathered (and
    transposed) beforehand: the yardstick of K4, used nowhere in the port."""
    x_p, w, t2g = args[:3]
    tile = kw["tile"]
    t = x_p.shape[0] // tile
    wt = w.detach()[t2g[:t].long()]
    if kw.get("transpose_w"):
        wt = wt.transpose(1, 2)
    wt = wt.contiguous()
    xt = x_p.detach().reshape(t, tile, x_p.shape[1])
    return lambda: torch.bmm(xt, wt)


def k7_work(torch, args, kw):
    """K7: each slot's scale, destination and message index read once, each
    distinct message row used read once, the output written once; 2*d
    FLOPs per slot that adds a row."""
    scale_p, msg, mmap, local_dst = args[:4]
    d = msg.shape[-1]
    slots = scale_p.numel()
    nodes = kw["num_node_blocks"] * kw["node_block"]
    keep = (local_dst.reshape(-1) < kw["node_block"]) & (mmap >= 0)
    rows = int(torch.unique(mmap[keep]).numel())
    nbytes = slots * 12 + rows * d * 4 + (kw["num_node_blocks"] + 1) * 4 \
        + nodes * d * 4
    return nbytes, float(keep.sum()) * 2.0 * d


def k7_library(torch, args, kw):
    """One ``torch.sparse.mm`` of the slots' scales as a CSR
    [nodes, Em] matrix (built beforehand, duplicates summed, not timed)
    times the messages: the yardstick of K7, used nowhere in the port."""
    scale_p, msg, mmap, local_dst, t2b = args[:5]
    nb = kw["node_block"]
    tile = local_dst.shape[-1]
    ld = local_dst.reshape(-1).long()
    keep = (ld < nb) & (mmap >= 0)
    node = t2b[:local_dst.shape[0]].long().repeat_interleave(tile) * nb + ld
    a = torch.sparse_coo_tensor(
        torch.stack([node[keep], mmap[keep].long()]),
        scale_p.detach().reshape(-1)[keep],
        (kw["num_node_blocks"] * nb, msg.shape[0])).coalesce()
    a = a.to_sparse_csr()
    m = msg.detach()
    return lambda: torch.sparse.mm(a, m)


def _softmax_weights(torch, scores_p, local_dst, t2b, mx, den, keep, nb):
    """Each slot's attention from K2's statistics (0 where ``keep`` is
    false), as [T, tile]: what K3 and K6 weight the messages by."""
    tile = local_dst.shape[-1]
    ld = local_dst.reshape(-1).long()
    node = (t2b[:local_dst.shape[0]].long().repeat_interleave(tile) * nb
            + torch.where(ld < nb, ld, 0))
    s = scores_p.detach().reshape(-1)
    att = torch.exp(s - mx.reshape(-1)[node]) / torch.clamp(
        den.reshape(-1)[node], min=1e-38)
    return torch.where(keep, att, 0.0).reshape(local_dst.shape)


def k3_library(torch, args, kw):
    """K7's yardstick with the softmax weights (computed from K2's ``mx`` /
    ``den`` beforehand, not timed) in place of the scales:
    ``torch.sparse.mm`` of a CSR [nodes, Em] matrix times the messages."""
    scores_p, msg, mmap, local_dst, t2b, _, mx, den = args[:8]
    keep = (local_dst.reshape(-1) < kw["node_block"]) & (mmap >= 0)
    att = _softmax_weights(torch, scores_p, local_dst, t2b, mx, den, keep,
                           kw["node_block"])
    return k7_library(torch, (att, msg, mmap, local_dst, t2b), kw)


def k5_library(torch, args, kw):
    """One ``torch.bmm`` over the groups' runs of real rows, each
    zero-padded to the longest run (laid out beforehand, not timed):
    ``X_gᵀ @ dY_g`` for every group, the yardstick of K5, used nowhere in
    the port."""
    x_p, dy_p, gtp = args[:3]
    tile = kw["tile"]
    ptr = gtp.long() * tile
    runs = ptr[1:] - ptr[:-1]
    longest = max(1, int(runs.max()))
    idx = ptr[:-1, None] + torch.arange(longest, device=x_p.device)
    valid = torch.arange(longest, device=x_p.device) < runs[:, None]
    idx = torch.where(valid, idx, 0)
    xg = torch.where(valid[..., None], x_p.detach()[idx], 0.0)
    dg = torch.where(valid[..., None], dy_p.detach()[idx], 0.0)
    xt = xg.transpose(1, 2).contiguous()
    return lambda: torch.bmm(xt, dg)


def k6_work(torch, args, kw):
    """K6: each slot's score and destination read once, the message row of
    each slot that adds one read once (pad slots' rows are never read), the
    node stats read and the output written once; 2*d + 4 FLOPs per such
    slot."""
    scores_p, msg_p, local_dst = args[:3]
    d = msg_p.shape[-1]
    nodes = kw["num_node_blocks"] * kw["node_block"]
    valid = int((local_dst < kw["node_block"]).sum())
    nbytes = scores_p.numel() * 8 + valid * d * 4 + nodes * 8 \
        + (kw["num_node_blocks"] + 1) * 4 + nodes * d * 4
    return nbytes, valid * (2.0 * d + 4)


def k8_work(torch, args, kw):
    """K8: as K6 with a scale in place of the score and no stats; 2*d
    FLOPs per slot that adds a row."""
    scale_p, msg_p, local_dst = args[:3]
    d = msg_p.shape[-1]
    nodes = kw["num_node_blocks"] * kw["node_block"]
    valid = int((local_dst < kw["node_block"]).sum())
    nbytes = scale_p.numel() * 8 + valid * d * 4 \
        + (kw["num_node_blocks"] + 1) * 4 + nodes * d * 4
    return nbytes, valid * 2.0 * d


def k8_library(torch, args, kw):
    """K7's yardstick for K8: ``torch.sparse.mm`` of the slots' scales as a
    CSR [nodes, slots] matrix times the padded messages."""
    scale_p, msg_p, local_dst, t2b = args[:4]
    slots = torch.arange(local_dst.numel(), dtype=torch.int32,
                         device=local_dst.device)
    return k7_library(torch, (scale_p, msg_p, slots, local_dst, t2b), kw)


def k9_work(torch, args, kw):
    """K9: each row's start and count read once, each candidate's key
    written once (int32); no floating-point work."""
    starts, width = args[0], args[3]
    rows = starts.numel()
    return rows * 8 + rows * width * 4, 0.0


def k6_library(torch, args, kw):
    """K3's yardstick for K6: ``torch.sparse.mm`` of the slots' softmax
    weights as a CSR [nodes, slots] matrix times the padded messages."""
    scores_p, msg_p, local_dst, t2b, _, mx, den = args[:7]
    keep = local_dst.reshape(-1) < kw["node_block"]
    att = _softmax_weights(torch, scores_p, local_dst, t2b, mx, den, keep,
                           kw["node_block"])
    slots = torch.arange(local_dst.numel(), dtype=torch.int32,
                         device=local_dst.device)
    return k7_library(torch, (att, msg_p, slots, local_dst, t2b), kw)


def k11_work(torch, args, kw):
    """K11: each sorted entry's index and value row read once, the row
    offsets read once, each row written once; one add a column an entry
    (the entries before ``ptr[0]``, target -1, are never read)."""
    values, perm, ptr, num_rows = args[:4]
    d = values.shape[1]
    entries = int(ptr[-1] - ptr[0])
    nbytes = entries * (4 + d * 4) + (num_rows + 1) * 4 + num_rows * d * 4
    return nbytes, float(entries * d)


def k11_library(torch, args, kw):
    """One ``index_add_`` of the same value rows into the same rows, in
    their original order (the targets built beforehand, not timed): the
    atomic scatter-add K11 took the place of, the yardstick, used nowhere
    in the port."""
    values, perm, ptr, num_rows = args[:4]
    counts = (ptr[1:] - ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(num_rows, device=values.device), counts)
    lo = int(ptr[0])
    target = torch.full((values.shape[0],), -1, dtype=torch.long,
                        device=values.device)
    target[perm[lo:lo + rows.numel()].long()] = rows
    keep = target >= 0
    index, vals = target[keep], values.detach()[keep].contiguous()
    out = torch.zeros((num_rows, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    return lambda: out.index_add_(0, index, vals)


LIBRARY = {K1: ("torch.bmm", k1_library), K3: ("torch.sparse.mm", k3_library),
           K4: ("torch.bmm", k4_library), K5: ("torch.bmm", k5_library),
           K6: ("torch.sparse.mm", k6_library),
           K7: ("torch.sparse.mm", k7_library),
           K8: ("torch.sparse.mm", k8_library),
           K11: ("index_add_", k11_library)}

# K9 is held to its plain version in slices of at most this many
# candidates (the int64 plain version needs several temporaries of 8 bytes
# a candidate), and to numpy's ``edge_sample_keys`` on at most this many
# rows of each call
K9_SLICE = 1 << 26
K9_NUMPY_ROWS = 4096


def k9_compare(torch, SO, args, kw):
    """K9 against its plain version, bit for bit, over row slices; then the
    decoded keys of a sample of rows against numpy's ``edge_sample_keys``
    (the reference's oracle). Returns the max abs error (0)."""
    import numpy as np

    from repro_torch.sampling.sampler import edge_sample_keys

    starts, cnts, base, width = args
    starts, cnts = starts.reshape(-1), cnts.reshape(-1)
    rows = starts.numel()
    step = max(1, K9_SLICE // width)
    for lo in range(0, rows, step):
        got = SO.candidate_keys(starts[lo:lo + step], cnts[lo:lo + step],
                                base, width)
        want = SO.candidate_keys_plain(starts[lo:lo + step],
                                       cnts[lo:lo + step], base, width)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, want)), f"{K9}: kernel disagrees with "
              f"its plain version (rows {lo}..{lo + step} of {rows}, width "
              f"{width})")
    pick = np.random.default_rng(rows).choice(
        rows, min(rows, K9_NUMPY_ROWS), replace=False)
    pick_t = torch.from_numpy(pick).to(starts.device)
    got = SO.decode_keys(SO.candidate_keys(starts[pick_t], cnts[pick_t],
                                           base, width)).cpu().numpy()
    s_np, c_np = starts[pick_t].cpu().numpy(), cnts[pick_t].cpu().numpy()
    col = np.arange(width)
    keys = edge_sample_keys(np.uint32(base), s_np[:, None] + col)
    want = np.where(col < c_np[:, None], keys.astype(np.int64), 0xFFFFFFFF)
    check(bool(np.array_equal(got, want)), f"{K9}: decoded keys differ from "
          f"numpy's edge_sample_keys")
    return 0.0


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions on the card
# ---------------------------------------------------------------------------
def _recording(module, names, calls):
    """Wrap ``module``'s functions ``names`` so that every call's inputs
    are appended to ``calls[name]``; returns the originals."""
    originals = {name: getattr(module, name) for name in names}

    def recorder(name, fn):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return rec

    for name, fn in originals.items():
        setattr(module, name, recorder(name, fn))
    return originals


@contextlib.contextmanager
def recorded_kernel_calls():
    """Record the inputs of every kernel wrapper call inside the block:
    ``{name: [(args, kw), ...]}``. The ops call K1-K3 and K7 through their
    own module's names, which are wrapped for the block; they call K4 and
    K5 through ``ops.SK``, which a stand-in namespace with recording
    wrappers replaces for the block (the modules' own functions stay as
    they are). Stage A calls K9 through ``sampling_ops``'s own name, which
    is wrapped for the block; the wrapper carries its own ``launches``,
    which K9 counts on while it is in place, so the recorded launches
    stay out of the main path's count."""
    from repro_torch.kernels import ops, segment_mm
    from repro_torch.kernels import sampling_ops as SO
    calls = {name: [] for name in KERNELS}
    originals = _recording(ops, (K1, K2, K3, K6, K7, K8, K11), calls)
    ops.SK = types.SimpleNamespace(**vars(segment_mm))
    _recording(ops.SK, (K4, K5), calls)
    k9 = _recording(SO, (K9,), calls)[K9]
    SO.candidate_keys.launches = 0
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)
        ops.SK = segment_mm
        SO.candidate_keys = k9


def forced(torch, plans, params, mb, feats, activation="relu", **variant):
    """A decision table that sets ``variant`` (``GemmVariant`` keywords;
    the traversals take its ``fuse_gather``) on every key the forward of
    ``mb`` queries, recorded by one pass under the tuner's recorder."""
    from repro_torch.core import codegen
    from repro_torch.tune import GemmVariant, TravVariant, TuningDecisions
    from repro_torch.tune.tuner import _KeyRecorder

    rec = _KeyRecorder()
    with torch.no_grad():
        codegen.execute_block_sequence(
            plans, list(params), list(mb.tensors), list(mb.layouts),
            list(mb.dst_locals), mb.seed_perm, feats, activation, rec)
    d = TuningDecisions()
    for key in rec.keys:
        d.set_op(key, GemmVariant(**variant) if key.startswith("gemm") else
                 TravVariant(fuse_gather=variant.get("fuse_gather")))
    return d


def capture_main_path_calls(torch, hector_torch, cfg, unfused=False):
    """Run the first mini-batch that ``serve(**cfg)`` serves (same graph,
    seeds, weights and features) on the card and record every kernel
    call's inputs; with ``unfused``, under decisions that force
    ``fuse_gather=False`` on every key (K4, K6 and K8 in place of K1, K3
    and K7)."""
    import numpy as np

    from repro_torch.core.graph import table3_graph
    from repro_torch.sampling import SeedStream

    graph = table3_graph(cfg["dataset"], cfg["scale"], cfg["seed"])
    engine = hector_torch.compile(
        cfg["model"], graph, layers=cfg["layers"], dim=cfg["dim"],
        hidden=cfg["hidden"], classes=cfg["classes"], sample=cfg["fanouts"],
        tile=cfg["tile"], node_block=cfg["node_block"], seed=cfg["seed"],
        device="cuda")
    params = engine.init(cfg["seed"])
    feats = torch.from_numpy(np.random.default_rng(cfg["seed"]).normal(
        size=(graph.num_nodes, cfg["dim"])).astype(np.float32)).cuda()
    loader = engine.make_loader(
        SeedStream(graph.num_nodes, cfg["batch_size"], seed=cfg["seed"]),
        num_batches=1)
    try:
        mb = next(loader)
    finally:
        loader.close()
    if unfused:
        engine.block_executor.set_decisions(forced(
            torch, engine.plans, params, mb,
            {"feature": feats[mb.input_ids.long()]}, fuse_gather=False))
    with recorded_kernel_calls() as calls:
        out = engine.apply_blocks(params, mb, feats, compiled=False)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "captured batch has non-finite "
          "logits")
    return calls


def capture_device_calls(torch, hector_torch, cfg):
    """Sample the first mini-batch that ``serve(**cfg, sampler="device")``
    serves on the card and run its forward, recording every kernel call's
    inputs (K9 in the sampling, the model's kernels on the device-built
    layouts)."""
    import numpy as np

    from repro_torch.core.graph import table3_graph
    from repro_torch.sampling import SeedStream

    graph = table3_graph(cfg["dataset"], cfg["scale"], cfg["seed"])
    engine = hector_torch.compile(
        cfg["model"], graph, layers=cfg["layers"], dim=cfg["dim"],
        hidden=cfg["hidden"], classes=cfg["classes"], sample=cfg["fanouts"],
        tile=cfg["tile"], node_block=cfg["node_block"], seed=cfg["seed"],
        device="cuda", sampler="device")
    params = engine.init(cfg["seed"])
    feats = torch.from_numpy(np.random.default_rng(cfg["seed"]).normal(
        size=(graph.num_nodes, cfg["dim"])).astype(np.float32)).cuda()
    seeds = SeedStream(graph.num_nodes, cfg["batch_size"],
                       seed=cfg["seed"]).batch(0)
    with recorded_kernel_calls() as calls:
        mb = engine.device_sampler.sample_minibatch(seeds, batch_index=0)
        out = engine.apply_blocks(params, mb, feats, compiled=False)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), "captured device-sampled batch "
          "has non-finite logits")
    return calls


class TrainTask:
    """Phase 6's task on the card (the driver's ``build_task``: graph,
    features, teacher labels, split), a CPU engine over the same graph, and
    one mid-training state: 5 sampled steps on the card over the first
    batches of the epoch stream, copied to the CPU as well. The card-vs-CPU
    steps start from it on the next batch. (From the initial state, Adam's
    first update divides each gradient entry by its own magnitude plus
    1e-8, so entries near 1e-9 turn fp32 rounding noise into parameter
    changes of 1e-5: the CPU port and the JAX reference already differ by
    that much there.)"""

    WARM_STEPS = 5

    def __init__(self, torch, hector_torch, cfg):
        import dataclasses

        from repro_torch.launch import train_rgnn
        from repro_torch.optim import AdamW, cosine_schedule
        from repro_torch.optim.adamw import tree_map
        from repro_torch.sampling import EpochSeedStream, build_minibatch
        from repro_torch.train import EngineConfig

        ecfg = EngineConfig(model=cfg["model"], layers=cfg["layers"],
                            dim=cfg["dim"], hidden=cfg["hidden"],
                            classes=cfg["classes"], fanouts=cfg["fanouts"],
                            tile=cfg["tile"], node_block=cfg["node_block"],
                            seed=cfg["seed"], device="cuda")
        (self.engine, self.feats, self.labels, self.train_ids,
         self.val_ids) = train_rgnn.build_task(cfg["dataset"], cfg["scale"],
                                               ecfg, cfg["seed"])
        self.cpu = hector_torch.compile(
            None, self.engine.graph,
            config=dataclasses.replace(ecfg, device="cpu"))
        stream = EpochSeedStream(self.train_ids, cfg["batch_size"],
                                 seed=cfg["seed"])
        # the driver's optimizer for this many steps
        self.opt = AdamW(learning_rate=cosine_schedule(
            cfg["lr"], 5, cfg["epochs"] * stream.batches_per_epoch),
            weight_decay=0.0)
        self.x_cpu = torch.from_numpy(self.feats)
        self.x = self.x_cpu.cuda()
        mbkw = dict(tile=cfg["tile"], node_block=cfg["node_block"],
                    bucket=True)

        def batch(step, device):
            seq = self.engine.sampler.sample(stream.batch(step),
                                             batch_index=step, epoch=0)
            return (build_minibatch(seq, step=step, device=device, **mbkw),
                    torch.from_numpy(seq.slice_labels(self.labels)))

        ex = self.engine.train_executor(self.opt)
        state = self.opt.init(self.engine.init(cfg["seed"]))
        for step in range(self.WARM_STEPS):
            mb, labels = batch(step, "cuda")
            state, _ = ex.grad_and_update(
                state, mb, labels.cuda(),
                {"feature": self.x[mb.input_ids.long()]}, compiled=False)
        self.state = state
        self.state_cpu = tree_map(lambda t: t.cpu(), state)
        self.mb, self.batch_labels_cpu = batch(self.WARM_STEPS, "cuda")
        self.mb_cpu, _ = batch(self.WARM_STEPS, "cpu")

    def step(self, torch):
        """One sampled ``grad_and_update`` on the card from the state, op by
        op (phases 2, 6, 8 and 11 record and time its kernel calls)."""
        return self.engine.train_executor(self.opt).grad_and_update(
            self.state, self.mb, self.batch_labels_cpu.cuda(),
            {"feature": self.x[self.mb.input_ids.long()]}, compiled=False)

    def cpu_step(self, torch):
        return self.cpu.train_executor(self.opt).grad_and_update(
            self.state_cpu, self.mb_cpu, self.batch_labels_cpu,
            {"feature": self.x_cpu[self.mb_cpu.input_ids.long()]})


def capture_train_calls(torch, task, model):
    """Record every kernel call of one sampled training step of phase 6's
    configuration on the card; one step calls each kernel as many times
    as ``STEP_LAUNCHES`` says."""
    with recorded_kernel_calls() as calls:
        _, metrics = task.step(torch)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(metrics["loss"])), f"{model}: captured "
          f"training step has a non-finite loss")
    for name in KERNELS:
        want = STEP_LAUNCHES[model].get(name, 0)
        check(len(calls[name]) == want, f"{model}: {name}: "
              f"{len(calls[name])} calls in one training step, expected "
              f"{want}")
    return calls


def compare(torch, name, got, want, rtol, atol, exact=False):
    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if exact:
        ok = bool(torch.equal(got, want))
    else:
        ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
    check(ok, f"{name}: kernel disagrees with its plain version "
          f"(max abs err {err:.3g}, rtol {rtol}, atol {atol})")
    return err


# tolerance of each kernel against its plain version (see the docstring)
TOLERANCE = {K1: 1e-5, K4: 1e-5, K3: 2e-5, K5: 1e-6, K7: 1e-5,
             K6: 2e-5, K8: 1e-5, K11: 1e-6}


def _shape(name, args, kw) -> str:
    if name == K9:
        return (f"rows={args[0].numel()} width={args[3]} "
                f"candidates={args[0].numel() * args[3]}")
    if name == K1:
        return (f"Rp={args[2].shape[0]} real={int((args[2] >= 0).sum())} "
                f"k={args[1].shape[1]} n={args[1].shape[2]} "
                f"R={args[1].shape[0]}")
    if name == K2:
        return f"slots={args[0].numel()} blocks={kw['num_node_blocks']}"
    if name == K11:
        return (f"entries={int(args[2][-1] - args[2][0])} of "
                f"{args[1].numel()} values={args[0].shape[0]} "
                f"d={args[0].shape[1]} rows={args[3]}")
    if name in (K3, K6, K7, K8):
        return (f"slots={args[0].numel()} d={args[1].shape[1]} "
                f"Em={args[1].shape[0]} blocks={kw['num_node_blocks']}")
    if name == K4:
        return (f"Rp={args[0].shape[0]} k={args[0].shape[1]} "
                f"w={tuple(args[1].shape)} "
                f"transposed={bool(kw.get('transpose_w'))}")
    return (f"Rp={args[0].shape[0]} real tiles={int(args[2][-1])} "
            f"k={args[0].shape[1]} n={args[1].shape[1]} "
            f"R={kw['num_groups']} chunks={kw['num_chunks']}")


# the serve runs whose first batch phase 2 captures (RGAT's and RGCN's at
# both sizes, HGT's at aifb), then the training step of each model
CAPTURED_SERVE = ("rgat aifb", "rgat bgs", "rgcn aifb", "rgcn bgs",
                  "hgt aifb")


def new_results(names):
    return {name: dict(calls=[], max_abs_err=0.0, max_abs_err_by={})
            for name in names}


def kernel_tables(torch, SK, TK, SO):
    """Each kernel's wrapper, its plain version (both without autograd:
    the training captures hold parameter leaves) and its work count."""
    plain = {K1: SK.segment_mm_gather_padded_plain,
             K2: TK.seg_stats_padded_plain,
             K3: TK.seg_softmax_agg_gather_padded_plain,
             K4: SK.segment_mm_padded_plain,
             K5: SK.segment_outer_padded_plain,
             K6: TK.seg_softmax_agg_padded_plain,
             K7: TK.seg_weighted_agg_gather_padded_plain,
             K8: TK.seg_weighted_agg_padded_plain,
             K9: SO.candidate_keys_plain,
             K11: TK.seg_sum_sorted_plain}
    kernel = {K1: SK.segment_mm_gather_padded, K2: TK.seg_stats_padded,
              K3: TK.seg_softmax_agg_gather_padded,
              K4: SK.segment_mm_padded, K5: SK.segment_outer_padded,
              K6: TK.seg_softmax_agg_padded,
              K7: TK.seg_weighted_agg_gather_padded,
              K8: TK.seg_weighted_agg_padded, K9: SO.candidate_keys,
              K11: TK.seg_sum_sorted}
    work = {K1: k1_work, K2: k2_work, K3: k3_work, K4: k4_work,
            K5: k5_work, K6: k6_work, K7: k7_work, K8: k8_work,
            K9: k9_work, K11: k11_work}
    plain = {k: torch.no_grad()(f) for k, f in plain.items()}
    kernel = {k: torch.no_grad()(f) for k, f in kernel.items()}
    return plain, kernel, work


def compare_runner(torch, SO, plain, kernel):
    """``run_compare(name, args, kw)``: the kernel against its plain
    version on the same inputs, at the kernel's tolerance; returns the max
    abs error. K2, K3, K6, K7 and K8 run at every unit size
    (``split_compare``); K1, K4, K5 and K11 are held bit for bit against a
    second launch too."""
    def run_compare(name, args, kw):
        if name == K9:
            return k9_compare(torch, SO, args, kw)
        if name in SLOT_SPLIT:
            return split_compare(torch, name, kernel[name], plain[name],
                                 args, kw)
        got = kernel[name](*args, **kw)
        want = plain[name](*args, **kw)
        if name in (K1, K4, K5, K11):
            again = kernel[name](*args, **kw)
            torch.cuda.synchronize()
            check(bool(torch.equal(got.view(torch.int32),
                                   again.view(torch.int32))),
                  f"{name}: two launches differ")
        torch.cuda.synchronize()
        tol = TOLERANCE[name]
        return compare(torch, name, got, want, tol, tol)
    return run_compare


# the kernels that split the slots into units (K2, K3, K6, K7, K8) and the
# unit sizes (``chunk_tiles``) at which every call of theirs is held; the
# wrappers' defaults are ``traversal.K2_CHUNK_TILES`` ... ``K7_CHUNK_TILES``
SLOT_SPLIT = (K2, K3, K6, K7, K8)
UNIT_CHUNKS = (1, 2, 8, 64)
# where ``local_dst_p`` and ``t2b`` sit in each slot-split kernel's inputs
SPLIT_LAYOUT_ARG = {K2: 1, K3: 3, K6: 2, K7: 3, K8: 2}


def compare_k2(torch, what, got, want):
    """K2's outputs against its plain version's: ``mx`` exact, ``den``
    within rtol 1e-5 (both sum in fp64 from the same fp32 terms)."""
    return max(compare(torch, what + ".mx", got[0], want[0], 0, 0,
                       exact=True),
               compare(torch, what + ".den", got[1], want[1], 1e-5, 0))


def split_compare(torch, name, fn, plain, args, kw):
    """K2, K3, K6, K7 or K8 at one call: first the slot order the kernels
    rely on, checked on the card (``traversal.slot_keys`` never
    decreases), then the kernel at every unit size of ``UNIT_CHUNKS``
    against its plain version, each launch bit for bit against a second
    one. Returns the max abs error."""
    from repro_torch.kernels import traversal as TK

    i = SPLIT_LAYOUT_ARG[name]
    local_dst, t2b = args[i:i + 2]
    keys = TK.slot_keys(local_dst, t2b, kw["node_block"])
    check(bool((keys[1:] >= keys[:-1]).all()), f"{name}: the slot keys "
          f"decrease: the layout breaks the order the kernel relies on")
    want = plain(*args, **kw)
    err = 0.0
    for chunk in UNIT_CHUNKS:
        got = fn(*args, **kw, chunk_tiles=chunk)
        again = fn(*args, **kw, chunk_tiles=chunk)
        torch.cuda.synchronize()
        same = (all(torch.equal(g, a) for g, a in zip(got, again))
                if name == K2 else torch.equal(got, again))
        check(bool(same), f"{name}: two launches differ (chunk_tiles="
              f"{chunk})")
        what = f"{name} (chunk_tiles={chunk})"
        err = max(err, compare_k2(torch, what, got, want) if name == K2
                  else compare(torch, what, got, want, TOLERANCE[name],
                               TOLERANCE[name]))
    return err


def k6_args(args):
    """K6's inputs at a K3 call: its messages padded into the slots
    (``msg_p = pad_rows(msg, mmap)``, as the unfused op builds them)."""
    from repro_torch.kernels import ops

    scores_p, msg, mmap = args[:3]
    return (scores_p, ops.pad_rows(msg, mmap)) + tuple(args[3:8])


def k8_args(args):
    """K8's inputs at a K7 call: its messages padded into the slots
    (``msg_p = pad_rows(msg, mmap)``, as the unfused op builds them)."""
    from repro_torch.kernels import ops

    scale_p, msg, mmap = args[:3]
    return (scale_p, ops.pad_rows(msg, mmap)) + tuple(args[3:6])


def time_split(torch, tables, run_compare, name, args, kw, at, phase,
               split):
    """A slot-split kernel (K2, K3, K6, K7, K8) at one captured call: held
    to its plain version (``run_compare``), then its device ms, wrapper ms,
    plain ms, library ms (None for K2, which no one PyTorch call computes)
    and bound, appended to ``split["timed"]``."""
    plain, kernel, work = tables
    err = run_compare(name, args, kw)
    split[name] = max(split[name], err)
    fn = lambda: kernel[name](*args, **kw)                    # noqa: E731
    ms = device_ms(torch, fn, KERNELS[name]["symbol"],
                   per_call=KERNELS[name]["per_call"])
    wrapper_ms = time_ms(torch, fn)
    plain_ms = time_ms(torch, lambda: plain[name](*args, **kw), reps=5,
                       inner=2)
    library_ms = (time_ms(torch, LIBRARY[name][1](torch, args, kw))
                  if name in LIBRARY else None)
    nbytes, flops = work[name](torch, args, kw)
    b_ms, b_by = bound(nbytes, flops)
    shape = _shape(name, args, kw)
    split["timed"].append(dict(
        kernel=name, at=at, shape=shape, ms=ms, wrapper_ms=wrapper_ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
        bound_by=b_by, bytes=nbytes, flops=flops, max_abs_err=err))
    log(f"[{phase}] {name} at {at} ({shape}): max abs err {err:.3g}; "
        f"kernel {ms:.5f} ms on the device, wrapper {wrapper_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms"
        + (f", {LIBRARY[name][0]} {library_ms:.4f} ms"
           if library_ms is not None else "")
        + f", bound {b_ms:.5f} ms ({b_by}, {nbytes} B)")


def time_weighted(torch, tables, run_compare, args, kw, at, phase, split):
    """K7 at one captured call, and K8 at the same call (``k8_args``), each
    as ``time_split`` times it."""
    for name, a in ((K7, args), (K8, k8_args(args))):
        time_split(torch, tables, run_compare, name, a, kw, at, phase, split)


def time_softmax(torch, tables, run_compare, k2_call, k3_call, at, phase,
                 split):
    """K2 at one captured call and K3 at the call that consumes its
    statistics, and K6 at the same call (``k6_args``), each as
    ``time_split`` times it."""
    args, kw = k2_call
    time_split(torch, tables, run_compare, K2, args, kw, at, phase, split)
    args, kw = k3_call
    for name, a in ((K3, args), (K6, k6_args(args))):
        time_split(torch, tables, run_compare, name, a, kw, at, phase, split)


def time_call(torch, tables, name, args, kw, err):
    """K1, K4, K5 or K11 at one captured call, already held to its plain
    version (max abs error ``err``): its device ms, wrapper ms, plain ms,
    library ms (``torch.bmm``; K11: ``index_add_``) and bound."""
    plain, kernel, work = tables
    fn = lambda: kernel[name](*args, **kw)                    # noqa: E731
    nbytes, flops = work[name](torch, args, kw)
    b_ms, b_by = bound(nbytes, flops)
    entry = dict(
        shape=_shape(name, args, kw), max_abs_err=err,
        ms=device_ms(torch, fn, KERNELS[name]["symbol"],
                     per_call=KERNELS[name].get("per_call", 1)),
        wrapper_ms=time_ms(torch, fn),
        plain_ms=time_ms(torch, lambda: plain[name](*args, **kw), reps=5,
                         inner=2),
        library_ms=time_ms(torch, LIBRARY[name][1](torch, args, kw)),
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
    split = (f" chunk_tiles={kw['chunk_tiles']}" if name == K5 else
             f" {_plan(name, args, kw)}" if name in (K1, K4) else "")
    log(f"[{name}] {entry['shape']}{split}: kernel "
        f"{entry['ms']:.5f} ms on the device, wrapper "
        f"{entry['wrapper_ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
        f"{LIBRARY[name][0]} {entry['library_ms']:.4f} ms, bound "
        f"{entry['bound_ms']:.5f} ms ({entry['bound_by']})")
    return entry


def _plan(name, args, kw) -> str:
    """K1's or K4's work split at a call (``segment_mm.gemm_plan``)."""
    from repro_torch.kernels import segment_mm as SK

    if name == K1:
        rows, n = args[2].shape[0], args[1].shape[2]
    else:
        rows = args[0].shape[0]
        n = args[1].shape[1] if kw.get("transpose_w") else args[1].shape[2]
    p = SK.gemm_plan(int(rows), int(n))
    return (f"{p.route} x{p.per_thread}, {p.row_blocks} x {p.col_blocks} "
            f"blocks of {p.block_rows} rows")


def hold_captured(torch, captured, results, tables, run_compare, phase):
    """Every captured call of the kernels in ``results`` against its plain
    version; the calls of ``TIMED_AT`` are timed too (device time under
    the profiler, wrapper and plain time by CUDA events, the library call,
    the bound)."""
    plain, kernel, work = tables
    for tag, calls in captured.items():
        for name, lst in calls.items():
            if not lst or name not in results:
                continue
            r = results[name]
            timed = TIMED_AT[name] == tag
            errs = []
            for i, (args, kw) in enumerate(lst):
                err = run_compare(name, args, kw)
                errs.append(err)
                if not timed:
                    continue
                if name == K5:
                    r["calls"].append(time_call(torch, tables, K5, args, kw,
                                                err))
                    continue
                fn = lambda: kernel[name](*args, **kw)       # noqa: E731
                ms = device_ms(torch, fn, KERNELS[name]["symbol"],
                               per_call=KERNELS[name].get("per_call", 1))
                wrapper_ms = time_ms(torch, fn)
                plain_ms = time_ms(torch, lambda: plain[name](*args, **kw))
                library_ms = None
                if name in LIBRARY:
                    lib_name, make = LIBRARY[name]
                    library_ms = time_ms(torch, make(torch, args, kw))
                nbytes, flops = work[name](torch, args, kw)
                b_ms, b_by = bound(nbytes, flops)
                shape = _shape(name, args, kw)
                r["calls"].append(dict(shape=shape, ms=ms,
                                       wrapper_ms=wrapper_ms,
                                       plain_ms=plain_ms,
                                       library_ms=library_ms,
                                       bound_ms=b_ms, bound_by=b_by,
                                       bytes=nbytes, flops=flops,
                                       max_abs_err=err))
                log(f"[{phase}] {name}[{i}] ({tag}) {shape}: max abs err "
                    f"{err:.3g}; kernel {ms:.5f} ms on the device, wrapper "
                    f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms"
                    + (f", {LIBRARY[name][0]} {library_ms:.4f} ms"
                       if library_ms is not None else "")
                    + f", bound {b_ms:.5f} ms ({b_by}, {nbytes} B, "
                    f"{flops:.0f} FLOP)")
            r["max_abs_err_by"][tag] = max(errs)
            r["max_abs_err"] = max(r["max_abs_err"], max(errs))
            if not timed:
                log(f"[{phase}] {name}: {len(lst)} {tag} calls match the "
                    f"plain version (max abs err {max(errs):.3g})")


def summarize(results, phase):
    """Each kernel's timed calls summed into its row's numbers."""
    for name, r in results.items():
        check(bool(r["calls"]), f"{name}: no timed call")
        for key in ("ms", "wrapper_ms", "plain_ms", "bound_ms"):
            r[key] = sum(c[key] for c in r["calls"])
        r["calls_per_unit"] = len(r["calls"])
        r["ms_per_call"] = r["ms"] / len(r["calls"])
        r["library_ms"] = (sum(c["library_ms"] for c in r["calls"])
                           if name in LIBRARY else None)
        by_bytes = sum(c["bound_ms"] for c in r["calls"]
                       if c["bound_by"] == "bytes")
        r["bound_by"] = "bytes" if by_bytes >= r["bound_ms"] / 2 \
            else "operations"
        r["timed_at"] = TIMED_AT[name]
        model, unit = TIMED_AT[name].split(maxsplit=1)
        unit = {"step": "aifb-b64 training step",
                "aifb device": "device-sampled aifb batch",
                "aifb unfused": "served aifb batch (fuse_gather=False)"}.get(
                    unit, "served aifb batch")
        log(f"[{phase}] {name}: {len(r['calls'])} calls per {model} {unit}"
            f", kernel {r['ms']:.5f} ms on the device ({r['ms_per_call']:.5f}"
            f" a call), wrapper "
            f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
            + (f", {LIBRARY[name][0]} {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
            + f", bound {r['bound_ms']:.5f} ms ({r['bound_by']}), max abs "
            f"err {r['max_abs_err']:.3g}")


def phase_kernels(torch, hector_torch, SK, TK, SO, L, R, ops, tasks, split):
    results = new_results([n for n in KERNELS
                           if n not in TUNING_KERNELS + LM_KERNELS])
    captured = {}
    runs = dict(SERVE_RUNS)
    for tag in CAPTURED_SERVE:
        cfg = runs[tag]
        captured[tag] = capture_main_path_calls(torch, hector_torch, cfg)
        for name in KERNELS:
            n = len(captured[tag][name])
            if FORWARD_LAUNCHES[cfg["model"]].get(name, 0):
                check(n > 0, f"{name}: not reached on the {tag} path")
            else:
                check(n == 0, f"{name}: {n} calls on the {tag} path")
        log(f"[phase 2] captured {tag} batch 0: "
            + ", ".join(f"{k} x{len(v)}" for k, v in captured[tag].items()
                        if v))
    for tag in CAPTURED_DEVICE:
        cfg = runs[tag]
        calls = capture_device_calls(torch, hector_torch, cfg)
        captured[f"{tag} device"] = calls
        for name in KERNELS:
            n = len(calls[name])
            if name == K9 or FORWARD_LAUNCHES[cfg["model"]].get(name, 0):
                check(n > 0, f"{name}: not reached on the device-sampled "
                      f"{tag} path")
            else:
                check(n == 0, f"{name}: {n} calls on the device-sampled "
                      f"{tag} path")
        log(f"[phase 2] captured {tag} device-sampled batch 0: "
            + ", ".join(f"{k} x{len(v)}" for k, v in calls.items() if v))
    for model, task in tasks.items():
        captured[f"{model} step"] = capture_train_calls(torch, task, model)
        log(f"[phase 2] captured one {model} aifb-b64 training step: "
            + ", ".join(f"{k} x{len(v)}"
                        for k, v in captured[f"{model} step"].items() if v))

    tables = kernel_tables(torch, SK, TK, SO)
    run_compare = compare_runner(torch, SO, *tables[:2])
    hold_captured(torch, captured, results, tables, run_compare, "phase 2")
    # K8 at every captured K7 call and K6 at every captured K3 call, their
    # messages padded into the slots
    for name, src, pad in ((K8, K7, k8_args), (K6, K3, k6_args)):
        n = 0
        for calls in captured.values():
            for args, kw in calls[src]:
                split[name] = max(split[name],
                                  run_compare(name, pad(args), kw))
                n += 1
        log(f"[phase 2] {name}: {n} captured {src} calls with padded "
            f"messages match the plain version (max abs err "
            f"{split[name]:.3g})")
    args, kw = max(captured["rgcn bgs"][K7],
                   key=lambda call: call[0][0].numel())
    time_weighted(torch, tables, run_compare, args, kw,
                  "rgcn bgs-b1024 hop 0", "phase 2", split)
    calls = captured["rgat bgs"]
    i = max(range(len(calls[K3])), key=lambda j: calls[K3][j][0][0].numel())
    time_softmax(torch, tables, run_compare, calls[K2][i], calls[K3][i],
                 "rgat bgs-b1024 hop 0", "phase 2", split)
    edge_cases(torch, SK, TK, L, ops, R, run_compare, results)
    gemm_edge_cases(torch, SK, L, run_compare, results)
    split_edge_cases(torch, L, ops, TK, run_compare, split)
    k5_edge_cases(torch, SK, L, ops, run_compare, results)
    k9_edge_cases(torch, ops, run_compare, results)
    k11_edge_cases(torch, TK, run_compare, results)
    # the softmax VJP's per-destination sum: K7 at width 1 (its scalar
    # path), held above at every unit size with the other captured calls
    d1 = sum(1 for tag, calls in captured.items() if tag.endswith("step")
             for args, _ in calls[K7] if args[1].shape[-1] == 1)
    check(d1 > 0, f"{K7}: no call at d = 1 among the training steps")
    log(f"[phase 2] {K7} at d = 1 (the softmax VJP's sum): {d1} captured "
        f"calls match the plain version")
    summarize(results, "phase 2")
    return results


# K11's unit of sorted entries (``csrc/scatter.cu``: kUnitEntries) and the
# widths its edge cases run at (one column, a ragged warp, the models', a
# block's 256 columns exceeded)
K11_UNIT = 256
K11_EDGE_D = (1, 7, 64, 96, 300)


def k11_edge_cases(torch, TK, run_compare, results):
    """K11 where its unit split has its edges, each case at every width of
    ``K11_EDGE_D``, against its plain version (rtol = atol = 1e-6) and bit
    for bit against a second launch: every entry's target -1 (zero rows),
    one row taking all 40,000 entries (a combine over 157 units), runs of
    1, 255, 256, 257, 511, 769 entries and rows without entries laid
    across unit edges, with and without 300 leading -1s (which move every
    edge), and a 30,000-entry hub among 5,000 random rows. Returns the
    number of calls."""
    import numpy as np

    rng = np.random.default_rng(11)
    u = K11_UNIT
    runs = np.array([u - 1, 1, u, u + 1, 2 * u - 1, 0, 1, 1, 3 * u + 1, 0,
                     0, 17, u])
    laid = np.repeat(np.arange(runs.size), runs)
    hub = np.concatenate([rng.integers(0, 5000, 20000),
                          np.full(30000, 2500)])
    cases = {
        "all -1": (np.full(4 * u + 37, -1), 50),
        "one row, 40000 entries": (np.full(40000, 3), 8),
        "runs across unit edges": (laid, runs.size),
        "runs after 300 -1s": (np.concatenate([laid, np.full(300, -1)]),
                               runs.size),
        "hub of 30000 among 5000 rows": (hub, 5000),
    }
    n = 0
    for what, (target, num_rows) in cases.items():
        target = rng.permutation(target).astype(np.int32)
        t = torch.from_numpy(target).cuda()
        perm, ptr = TK.sorted_segments(t, num_rows)
        for d in K11_EDGE_D:
            values = torch.from_numpy(rng.normal(
                size=(target.size, d)).astype(np.float32)).cuda()
            args = (values, perm, ptr, num_rows)
            err = run_compare(K11, args, {})
            results[K11]["max_abs_err"] = max(results[K11]["max_abs_err"],
                                              err)
            if what == "all -1":
                check(bool((TK.seg_sum_sorted(*args) == 0).all()),
                      f"{K11}: rows of an all -1 target are not zero")
            n += 1
    log(f"[phase 2] {K11} edge cases: {n} calls ({', '.join(cases)}; d "
        f"{'/'.join(map(str, K11_EDGE_D))}) match the plain version "
        f"(rtol = atol = {TOLERANCE[K11]}) and a second launch bit for bit")
    return n


def edge_cases(torch, SK, TK, L, ops, R, run_compare, results):
    """Inputs the served batches may not produce, held to the same
    tolerances: -1 gathers in real slots, groups and node blocks without
    tiles, pow2 pad tiles, the scale epilogue, ``ops.edge_softmax`` (K2
    and its epilogue) and ``ops.weighted_agg`` (K7) on the card against
    the oracles, K7 with ``scale=None`` and d = 1, and empty layouts."""
    import numpy as np

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n_err = 0
    # K1: 10 groups, 3 of them empty, pow2-grown, scale on and off, n=1/16/64
    sizes = rng.integers(1, 90, 10)
    sizes[[1, 4, 7]] = 0
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    for grow in (False, True):
        ps = L.pad_segments(ptr, 32)
        if grow:
            ps = L.pad_segments_rows(ps, L.pow2ceil(ps.padded_rows) * 2)
        gidx = L.compose_gather_rows(ps, rng.integers(0, 500,
                                                      int(sizes.sum())))
        gidx[np.flatnonzero(gidx >= 0)[::7]] = -1
        for n in (64, 16, 1):
            for with_scale in (False, True):
                args = [t(rng.normal(size=(500, 64)).astype(np.float32)),
                        t(rng.normal(size=(10, 64, n)).astype(np.float32)),
                        t(gidx), t(ps.tile_to_group)]
                if with_scale:
                    args.append(t(rng.normal(size=(ps.padded_rows, 1))
                                  .astype(np.float32)))
                err = run_compare("segment_mm_gather_padded", args,
                                  dict(tile=32))
                results["segment_mm_gather_padded"]["max_abs_err"] = max(
                    results["segment_mm_gather_padded"]["max_abs_err"], err)
                n_err += 1
    # K2/K3: node blocks 2-5 own no tile; pow2-grown pad tiles; d=64/16
    n_nodes = 300
    pool = np.concatenate([np.arange(64), np.arange(192, n_nodes)])
    for grow in (False, True):
        dst = rng.choice(pool, 2000).astype(np.int32)
        perm = np.argsort(dst, kind="stable").astype(np.int32)
        dptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=n_nodes), out=dptr[1:])
        bc = L.block_csr(dptr, 32, 32)
        if grow:
            bc = L.pad_blocked_csr(bc, L.pow2ceil(bc.padded_edges) * 2)
        bcd = ops.blocked_csr_dev(bc, perm).to(dev)
        scores = t(rng.normal(size=2000).astype(np.float32) * 3)
        scores_p = ops._padded_scores(scores, bcd)
        kw = dict(node_block=32, num_node_blocks=bc.num_node_blocks)
        att = ops.edge_softmax(scores, t(dst), n_nodes, bc=bcd)
        err = compare(torch, "edge_softmax", att,
                      R.edge_softmax_ref(scores, t(dst).long(), n_nodes),
                      2e-5, 2e-5)
        results["seg_stats_padded"]["max_abs_err"] = max(
            results["seg_stats_padded"]["max_abs_err"], err)
        sargs = (scores_p, bcd.local_dst, bcd.t2b, bcd.block_tile_ptr)
        err = run_compare("seg_stats_padded", sargs, kw)
        results["seg_stats_padded"]["max_abs_err"] = max(
            results["seg_stats_padded"]["max_abs_err"], err)
        mx, den = TK.seg_stats_padded(*sargs, **kw)
        empty = slice(2 * 32, 6 * 32)
        check(bool((mx.reshape(-1)[empty] == -1e30).all()
                   and (den.reshape(-1)[empty] == 0).all()),
              "seg_stats_padded: blocks without tiles not written as "
              "(-1e30, 0)")
        for d in (64, 16):
            msg = t(rng.normal(size=(700, d)).astype(np.float32))
            rows = t(rng.integers(0, 700, 2000).astype(np.int32))
            mmap = ops._msg_slot_map(bcd, rows)
            kargs = (scores_p, msg, mmap, bcd.local_dst, bcd.t2b,
                     bcd.block_tile_ptr, mx, den)
            err = run_compare("seg_softmax_agg_gather_padded", kargs, kw)
            results["seg_softmax_agg_gather_padded"]["max_abs_err"] = max(
                results["seg_softmax_agg_gather_padded"]["max_abs_err"], err)
            out = TK.seg_softmax_agg_gather_padded(*kargs, **kw)
            check(bool((out[empty] == 0).all()),
                  "seg_softmax_agg_gather_padded: blocks without tiles not "
                  "zero")
            n_err += 2
        # K7: scale=None (ones) and a scale, identity and compact rows, a
        # real slot in nine without a message row, d = 64 / 16 / 1
        for d, compact, with_scale in ((64, False, False), (64, True, True),
                                       (16, False, True), (1, True, False)):
            em = 700 if compact else 2000
            msg = t(rng.normal(size=(em, d)).astype(np.float32))
            rows = (t(rng.integers(0, em, 2000).astype(np.int32))
                    if compact else None)
            mmap = ops._msg_slot_map(bcd, rows).clone()
            mmap[::9] = -1
            scale = (t(rng.normal(size=2000).astype(np.float32))
                     if with_scale else None)
            kargs = (ops._padded_scale(scale, bcd, msg), msg, mmap,
                     bcd.local_dst, bcd.t2b, bcd.block_tile_ptr)
            err = run_compare(K7, kargs, kw)
            results[K7]["max_abs_err"] = max(results[K7]["max_abs_err"], err)
            out = TK.seg_weighted_agg_gather_padded(*kargs, **kw)
            check(bool((out[empty] == 0).all()),
                  "seg_weighted_agg_gather_padded: blocks without tiles not "
                  "zero")
            # the op on the card (K7 and the slot maps) against the oracle
            agg = ops.weighted_agg(scale, msg, t(dst), n_nodes, bc=bcd,
                                   msg_rows=rows)
            err = compare(torch, "weighted_agg", agg, R.weighted_agg_ref(
                scale, msg if rows is None else msg[rows.long()],
                t(dst).long(), n_nodes), 1e-5, 1e-5)
            results[K7]["max_abs_err"] = max(results[K7]["max_abs_err"], err)
            n_err += 2
        n_err += 1
    # launch shapes the main path does not use: K1's scalar gather (k not a
    # multiple of 4), 8-row tiles and node blocks, K3 rows narrower than a
    # warp and wider than a thread block
    ps = L.pad_segments(ptr, 8)
    gidx = L.compose_gather_rows(ps, rng.integers(0, 300, int(sizes.sum())))
    for k, n in ((30, 16), (7, 70)):
        err = run_compare(
            "segment_mm_gather_padded",
            [t(rng.normal(size=(300, k)).astype(np.float32)),
             t(rng.normal(size=(10, k, n)).astype(np.float32)), t(gidx),
             t(ps.tile_to_group)], dict(tile=8))
        results["segment_mm_gather_padded"]["max_abs_err"] = max(
            results["segment_mm_gather_padded"]["max_abs_err"], err)
        n_err += 1
    bc = L.pad_blocked_csr(L.block_csr(dptr, 8, 8),
                           L.pow2ceil(L.block_csr(dptr, 8, 8).padded_edges))
    bcd = ops.blocked_csr_dev(bc, perm).to(dev)
    scores_p = ops._padded_scores(
        t(rng.normal(size=2000).astype(np.float32)), bcd)
    kw = dict(node_block=8, num_node_blocks=bc.num_node_blocks)
    sargs = (scores_p, bcd.local_dst, bcd.t2b, bcd.block_tile_ptr)
    err = run_compare("seg_stats_padded", sargs, kw)
    results["seg_stats_padded"]["max_abs_err"] = max(
        results["seg_stats_padded"]["max_abs_err"], err)
    mx, den = TK.seg_stats_padded(*sargs, **kw)
    for d in (5, 300):
        msg = t(rng.normal(size=(2000, d)).astype(np.float32))
        kargs = (scores_p, msg, bcd.edge_map, bcd.local_dst, bcd.t2b,
                 bcd.block_tile_ptr, mx, den)
        err = run_compare("seg_softmax_agg_gather_padded", kargs, kw)
        results["seg_softmax_agg_gather_padded"]["max_abs_err"] = max(
            results["seg_softmax_agg_gather_padded"]["max_abs_err"], err)
        kargs = (ops._padded_scale(None, bcd, msg), msg, bcd.edge_map,
                 bcd.local_dst, bcd.t2b, bcd.block_tile_ptr)
        err = run_compare(K7, kargs, kw)
        results[K7]["max_abs_err"] = max(results[K7]["max_abs_err"], err)
    n_err += 5
    # K4: k = 1 (the transposed dX of an n = 1 GEMM) and n = 1, W as
    # stored and transposed, groups without tiles, pow2 pad tiles, scale
    # on and off; K5 on the same layouts, plus one group of 40,000 rows
    # (1,250 tiles, many chunks at the fitted chunk size)
    for grow in (False, True):
        ps = L.pad_segments(ptr, 32)
        if grow:
            ps = L.pad_segments_rows(ps, L.pow2ceil(ps.padded_rows) * 2)
        lay = ops.padded_segments_dev(ps).to(dev)
        pad = t(ps.row_map < 0)
        for kd, n, transpose in ((64, 64, False), (64, 1, False),
                                 (1, 64, True), (64, 64, True),
                                 (30, 70, True)):
            x_p = t(rng.normal(size=(ps.padded_rows, kd)).astype(np.float32))
            x_p[pad] = 0.0
            w = t(rng.normal(size=(10, n, kd) if transpose else (10, kd, n))
                  .astype(np.float32))
            for with_scale in (False, True):
                args = [x_p, w, lay.t2g]
                if with_scale:
                    args.append(t(rng.normal(size=(ps.padded_rows, 1))
                                  .astype(np.float32)))
                err = run_compare("segment_mm_padded", args,
                                  dict(tile=32, transpose_w=transpose))
                results["segment_mm_padded"]["max_abs_err"] = max(
                    results["segment_mm_padded"]["max_abs_err"], err)
                n_err += 1
            dy = t(rng.normal(size=(ps.padded_rows, n)).astype(np.float32))
            kw5 = dict(num_groups=10, num_chunks=lay.num_chunks, tile=32,
                       chunk_tiles=lay.chunk_tiles)
            kargs = (x_p, dy, lay.group_tile_ptr, lay.group_chunk_ptr)
            err = run_compare("segment_outer_padded", kargs, kw5)
            dw = SK.segment_outer_padded(*kargs, **kw5)
            check(bool((dw[[1, 4, 7]] == 0).all()), "segment_outer_padded: "
                  "groups without tiles not zero")
            results["segment_outer_padded"]["max_abs_err"] = max(
                results["segment_outer_padded"]["max_abs_err"], err)
            n_err += 1
    long_ps = L.pad_segments(np.array([0, 5, 40005, 40100]), 32)
    long_lay = ops.padded_segments_dev(long_ps).to(dev)
    check(int(long_lay.group_chunk_ptr[-1]) == 1 + -(
        -1250 // long_lay.chunk_tiles) + 1 and long_lay.num_chunks ==
        long_ps.padded_rows // 32 // long_lay.chunk_tiles + 3,
        "long group: chunk count")
    x_p = t(rng.normal(size=(long_ps.padded_rows, 64)).astype(np.float32))
    x_p[t(long_ps.row_map < 0)] = 0.0
    err = run_compare(
        "segment_outer_padded",
        (x_p, t(rng.normal(size=(long_ps.padded_rows, 64))
                .astype(np.float32)),
         long_lay.group_tile_ptr, long_lay.group_chunk_ptr),
        dict(num_groups=3, num_chunks=long_lay.num_chunks, tile=32,
             chunk_tiles=long_lay.chunk_tiles))
    results["segment_outer_padded"]["max_abs_err"] = max(
        results["segment_outer_padded"]["max_abs_err"], err)
    n_err += 1
    # empty layouts: the ops return without launching a grid of 0
    before = ops.launch_counts()
    ps = L.pad_segments(np.zeros(5, np.int64), 32)
    y = ops.segment_mm_gather(torch.ones(4, 64, device=dev),
                              torch.ones(4, 64, 8, device=dev),
                              ops.padded_segments_dev(ps).to(dev),
                              t(L.compose_gather_rows(ps, np.zeros(0))))
    bce = ops.blocked_csr_dev(L.block_csr(np.zeros(9, np.int64), 32, 32),
                              np.zeros(0, np.int32)).to(dev)
    z = ops.edge_softmax_agg(torch.zeros(0, device=dev),
                             torch.ones(0, 16, device=dev),
                             torch.zeros(0, dtype=torch.int32, device=dev),
                             8, bc=bce)
    z7 = ops.weighted_agg(None, torch.ones(0, 16, device=dev),
                          torch.zeros(0, dtype=torch.int32, device=dev), 8,
                          bc=bce)
    i32 = dict(dtype=torch.int32, device=dev)
    z7k = TK.seg_weighted_agg_gather_padded(
        torch.zeros(0, 32, device=dev), torch.ones(4, 16, device=dev),
        torch.zeros(0, **i32), torch.zeros(0, 32, **i32),
        torch.zeros(1, **i32), torch.zeros(1, **i32), node_block=32,
        num_node_blocks=0)
    yk = SK.segment_mm_gather_padded(
        torch.ones(4, 64, device=dev), torch.ones(4, 64, 8, device=dev),
        torch.zeros(0, dtype=torch.int32, device=dev),
        torch.zeros(1, dtype=torch.int32, device=dev), tile=32)
    y4 = ops.segment_mm(torch.ones(0, 64, device=dev),
                        torch.ones(4, 64, 8, device=dev),
                        ops.padded_segments_dev(ps).to(dev))
    y4k = SK.segment_mm_padded(torch.ones(0, 64, device=dev),
                               torch.ones(4, 8, 64, device=dev),
                               torch.zeros(1, dtype=torch.int32, device=dev),
                               tile=32, transpose_w=True)
    lay0 = ops.padded_segments_dev(ps).to(dev)
    dw0 = SK.segment_outer_padded(
        torch.ones(0, 64, device=dev), torch.ones(0, 8, device=dev),
        lay0.group_tile_ptr, lay0.group_chunk_ptr, num_groups=4,
        num_chunks=lay0.num_chunks, tile=32, chunk_tiles=lay0.chunk_tiles)
    torch.cuda.synchronize()
    check(z7.shape == (8, 16) and not z7.any() and z7k.shape == (0, 16),
          "empty layouts: wrong K7 outputs")
    check(y.shape == (0, 8) and z.shape == (8, 16) and not z.any()
          and yk.shape == (0, 8) and y4.shape == (0, 8)
          and y4k.shape == (0, 8) and dw0.shape == (4, 64, 8)
          and not dw0.any(), "empty layouts: wrong outputs")
    check(ops.launch_counts() == before, "an empty layout launched a kernel")
    log(f"[phase 2] edge cases: {n_err + 4} kernel-vs-plain checks passed "
        f"(-1 gathers, empty groups and node blocks, pow2 pad tiles, scale "
        f"on/off, CUDA edge_softmax, k = 30 and 7, 8-row tiles and node "
        f"blocks, d = 5 and 300, K4 k = 1 / n = 1 / transposed W, a K5 "
        f"group of 40,000 rows, K7 scale=None, compact rows with -1, d = 1,"
        f" the CUDA weighted_agg); empty layouts launched nothing")


def gemm_edge_cases(torch, SK, L, run_compare, results):
    """K1 and K4 where their work split (``segment_mm.gemm_plan``) has its
    edges, each held to its plain version (1e-5) and bitwise against a
    second launch: group changes inside one piece and one persistent span
    at tile 8, 16 and 32, on a small layout (about 1,500 rows: TM = 2, a
    span a piece) and a large one (about 100,000 rows: TM = 8, spans of
    several pieces); a K1 tile whose gather indices are all -1 next to a
    real one, and -1 rows inside real tiles; a pure-pad tail; k not a
    multiple of 4 and wider than one 32-column chunk (7, 30, 300); n = 1,
    3, 8, 16, 17, 64, 96 (both routes, every narrow width); a transposed W
    at k = 1, 8 and 64; the scale on both routes. Fails unless every route
    and width of the plan was taken. Where k > 64 the inputs are small
    integers (and the scales powers of two), so every product and partial
    sum is exact in fp32 and the kernel's FMA chain and the plain version's
    batched product agree exactly: with normal inputs, 300-term sums taken
    in two orders differ by up to about 1e-4 where they cancel, beyond the
    1e-5 that holds for the main path's k <= 64."""
    import numpy as np

    rng = np.random.default_rng(21)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def normal(shape, k):
        if k <= 64:
            return rng.normal(size=shape).astype(np.float32)
        return rng.integers(-4, 5, size=shape).astype(np.float32)

    def scales(rows, k):
        if k <= 64:
            return rng.normal(size=(rows, 1)).astype(np.float32)
        return np.exp2(rng.integers(-2, 3, size=(rows, 1))).astype(
            np.float32)

    def layout(sizes, tile):
        ps = L.pad_segments(np.concatenate([[0], np.cumsum(sizes)]), tile)
        return L.pad_segments_rows(ps, ps.padded_rows + 5 * tile)

    taken, n_calls = set(), 0

    def hold(name, args, kw):
        nonlocal n_calls
        rows = args[2].shape[0] if name == K1 else args[0].shape[0]
        n = (args[1].shape[1] if kw.get("transpose_w")
             else args[1].shape[2])
        plan = SK.gemm_plan(int(rows), int(n))
        taken.add((plan.route, plan.per_thread))
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           run_compare(name, args, kw))
        n_calls += 1

    for size, groups, top in (("small", 40, 70), ("large", 1500, 120)):
        sizes = rng.integers(1, top, groups)
        sizes[::7] = 0                          # groups without tiles
        m = int(sizes.sum())
        k1_cases = ((64, 64, True), (300, 96, False), (64, 1, True),
                    (7, 8, False), (30, 17, True), (64, 16, False),
                    (64, 3, True))
        k4_cases = ((64, 64, False, True), (1, 64, True, False),
                    (8, 64, True, True), (64, 64, True, False),
                    (300, 17, False, True), (64, 96, False, False),
                    (64, 1, False, True), (64, 8, True, False),
                    (30, 16, False, False))
        if size == "large":                     # a few, each at every tile
            k1_cases, k4_cases = k1_cases[:4], k4_cases[:4]
        for tile in (8, 16, 32):
            ps = layout(sizes, tile)
            gidx = L.compose_gather_rows(ps, rng.integers(0, 5000, m))
            gidx[2 * tile:3 * tile] = -1        # a tile of -1 before a real
            gidx[np.flatnonzero(gidx >= 0)[::9]] = -1
            t2g = t(ps.tile_to_group)
            for k, n, scaled in k1_cases:
                args = [t(normal((5000, k), k)), t(normal((groups, k, n), k)),
                        t(gidx), t2g]
                if scaled:
                    args.append(t(scales(ps.padded_rows, k)))
                hold(K1, args, dict(tile=tile))
            for kd, n, transpose, scaled in k4_cases:
                x_p = normal((ps.padded_rows, kd), kd)
                x_p[ps.row_map < 0] = 0.0
                w = normal((groups, n, kd) if transpose else (groups, kd, n),
                           kd)
                args = [t(x_p), t(w), t2g]
                if scaled:
                    args.append(t(scales(ps.padded_rows, kd)))
                hold(K4, args, dict(tile=tile, transpose_w=transpose))
    want = {("wide", 2), ("wide", 8)} | {
        ("narrow", c) for c in SK.GEMM_NARROW_WIDTHS}
    check(taken >= want, f"K1 / K4 edge cases took {sorted(taken)}, not "
          f"every route of gemm_plan ({sorted(want)})")
    log(f"[phase 2] K1 / K4 split edge cases: {n_calls} calls (routes "
        f"{sorted(taken)}) match their plain versions and repeat bit for "
        f"bit")


def split_edge_cases(torch, L, ops, TK, run_compare, split):
    """The slot-split kernels where the split has its edges: one
    destination of 40,000 slots across many units, unit edges exactly at a
    change of destination, all-pad units and the pure-pad tail, node blocks
    without tiles and slot-less nodes between units; d = 1 / 8 / 16 / 64 /
    96, compact rows with -1; K7 and K8 with and without ``scale=None``;
    K2 on scores in [-9, 9], the layout's largest destination's spanning
    [-80, 80] (so the max decides which terms underflow); K3 on K2's
    statistics, and K6 on K3's messages padded into the slots.
    ``run_compare`` holds each call at every unit size of ``UNIT_CHUNKS``,
    bit for bit against a second launch."""
    import numpy as np

    rng = np.random.default_rng(18)
    dev = torch.device("cuda")

    def layout(deg, grow=0):
        ptr = np.zeros(len(deg) + 1, np.int64)
        np.cumsum(deg, out=ptr[1:])
        bc = L.block_csr(ptr, 32, 32)
        if grow:                       # pure-pad tiles on the last block
            bc = L.pad_blocked_csr(bc, bc.padded_edges + grow * 32)
        dst = np.repeat(np.arange(len(deg), dtype=np.int32), deg)
        bcd = ops.blocked_csr_dev(bc, np.arange(len(dst), dtype=np.int32))
        return bcd.to(dev), torch.from_numpy(dst).to(dev), len(deg)

    hub = rng.integers(0, 4, 300)
    hub[40] = 40000                    # 157 units at 256 slots
    hub[64:192] = 0                    # node blocks 2-5 own no tile
    hub[250] = 257
    # node 0 fills unit 0, node 1 unit 1, nodes 2-3 unit 2, nodes 4-5 have
    # no slot, node 6 fills units 3-4 (at 256 slots a unit)
    exact = np.array([256, 256, 100, 156, 0, 0, 512] + [1] * 25 + [256] * 3)
    tailed = rng.integers(0, 3, 200)
    layouts = (("a 40,000-slot hub", layout(hub, grow=3)),
               ("unit edges at changes of destination", layout(exact)),
               ("a pure-pad tail of 70 tiles", layout(tailed, grow=70)))
    n = 0
    for what, (bcd, dst, n_nodes) in layouts:
        kw = dict(node_block=32, num_node_blocks=bcd.num_node_blocks)
        e = dst.numel()
        scores = rng.uniform(-9, 9, e).astype(np.float32)
        wide = (dst == torch.bincount(dst).argmax()).cpu().numpy()
        scores[wide] = rng.permutation(np.linspace(-80, 80, int(wide.sum()),
                                                   dtype=np.float32))
        scores_p = ops._padded_scores(torch.from_numpy(scores).to(dev), bcd)
        sargs = (scores_p, bcd.local_dst, bcd.t2b, bcd.block_tile_ptr)
        split[K2] = max(split[K2], run_compare(K2, sargs, kw))
        mx, den = TK.seg_stats_padded(*sargs, **kw)
        btp = bcd.block_tile_ptr
        empty = torch.repeat_interleave(btp[1:] == btp[:-1], 32)
        check(bool((mx.reshape(-1)[empty] == -1e30).all()
                   and (den.reshape(-1)[empty] == 0).all()),
              f"{K2}: node blocks without tiles not (-1e30, 0) ({what})")
        n += 1
        for d in (1, 8, 16, 64, 96):
            for with_scale in (False, True):
                msg = torch.from_numpy(rng.normal(size=(700, d)).astype(
                    np.float32)).to(dev)
                rows = torch.from_numpy(rng.integers(0, 700, e).astype(
                    np.int32)).to(dev)
                mmap = ops._msg_slot_map(bcd, rows).clone()
                mmap[::7] = -1
                scale = (torch.from_numpy(rng.normal(size=e).astype(
                    np.float32)).to(dev) if with_scale else None)
                args = (ops._padded_scale(scale, bcd, msg), msg, mmap,
                        bcd.local_dst, bcd.t2b, bcd.block_tile_ptr)
                split[K7] = max(split[K7], run_compare(K7, args, kw))
                split[K8] = max(split[K8], run_compare(K8, k8_args(args),
                                                       kw))
                n += 2
                if with_scale:
                    continue
                args = (scores_p, msg, mmap, bcd.local_dst, bcd.t2b,
                        bcd.block_tile_ptr, mx, den)
                split[K3] = max(split[K3], run_compare(K3, args, kw))
                split[K6] = max(split[K6], run_compare(K6, k6_args(args),
                                                       kw))
                for name, a in ((K3, args), (K6, k6_args(args))):
                    out = getattr(TK, name)(*a, **kw)
                    check(bool((out[empty] == 0).all()), f"{name}: node "
                          f"blocks without tiles not zero ({what})")
                n += 2
    log(f"[phase 2] slot-split edge cases: {n} calls, each at "
        f"chunk_tiles {UNIT_CHUNKS} and bitwise repeatable ("
        + ", ".join(w for w, _ in layouts)
        + f"; d = 1 / 8 / 16 / 64 / 96, compact rows with -1, scale=None, "
        f"scores over [-80, 80]); max abs err "
        + ", ".join(f"{k} {split[k]:.3g}" for k in SLOT_SPLIT))


# K5's kernel stages the group offsets in shared memory below this many
# groups and reads them from global memory at or above it (kOuterPtrCap in
# csrc/segment_mm.cu)
K5_STAGED_GROUPS = 1024


def k5_edge_cases(torch, SK, L, ops, run_compare, results):
    """K5 where its work split has its edges, each held to its plain version
    (1e-6) and bit for bit against a second launch: groups that are one
    chunk each (written directly) and groups of many chunks (added by the
    last block to arrive) at chunk sizes 1 / 2 / the fitted one, k and n of
    1 / 8 / 64, surplus chunks past ``group_chunk_ptr[G]`` (host layout),
    and a launch whose groups own no real tile at all; each with 12 groups
    (offsets staged in shared memory) and with 1,500 (offsets read from
    global memory)."""
    import numpy as np

    rng = np.random.default_rng(5)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    few = rng.integers(1, 300, 12)
    few[[2, 9]] = 0
    few[0] = 20                        # one tile: one chunk at any size
    few[5] = 3000                      # 94 tiles: many chunks at any size
    many = rng.integers(0, 80, 1500)
    many[[7, 700, 1499]] = 3000
    many[0] = 20
    check(len(few) < K5_STAGED_GROUPS <= len(many),
          "K5 edge cases: the group counts do not straddle the staging cap")
    slices = {12: ((64, 64), (64, 8), (8, 64), (64, 1), (1, 64), (8, 8),
                   (1, 1)),
              1500: ((64, 64), (8, 8))}
    n = 0
    worst = 0.0
    fitted = []
    for sizes in (few, many):
        groups = len(sizes)
        ps = L.pad_segments(np.concatenate([[0], np.cumsum(sizes)]), 32)
        lay = ops.padded_segments_dev(ps).to(dev)
        fitted.append(lay.chunk_tiles)
        for ct in (1, 2, lay.chunk_tiles):
            gcp = SK.outer_chunk_ptr(SK.outer_tile_ptr(ps.seg_sizes, 32), ct)
            counts = np.diff(gcp)
            check(bool((counts == 1).any() and (counts > 1).any()),
                  f"K5 edge case: {groups} groups at chunk_tiles={ct} give "
                  f"no mix of single- and multi-chunk groups")
            for k, nn in slices[groups]:
                x_p = t(rng.normal(size=(ps.padded_rows, k)).astype(
                    np.float32))
                x_p[t(ps.row_map < 0)] = 0.0
                dy = t(rng.normal(size=(ps.padded_rows, nn)).astype(
                    np.float32))
                for extra in (0, 7):   # surplus chunks return at once
                    kw = dict(num_groups=groups,
                              num_chunks=int(gcp[-1]) + extra, tile=32,
                              chunk_tiles=ct)
                    worst = max(worst, run_compare(
                        K5, (x_p, dy, lay.group_tile_ptr, t(gcp)), kw))
                    n += 1
        # no group owns a real tile, yet chunks are launched (a device-
        # built layout's static bound): dW is zero
        zero = torch.zeros(groups + 1, dtype=torch.int32, device=dev)
        dw = SK.segment_outer_padded(
            torch.ones(64, 64, device=dev), torch.ones(64, 8, device=dev),
            zero, zero, num_groups=groups, num_chunks=3, tile=32,
            chunk_tiles=4)
        torch.cuda.synchronize()
        check(dw.shape == (groups, 64, 8) and not bool(dw.any()),
              f"K5: {groups} groups without real tiles not zero")
    results[K5]["max_abs_err"] = max(results[K5]["max_abs_err"], worst)
    log(f"[phase 2] K5 edge cases: {n} calls (12 and 1,500 groups, single- "
        f"and multi-chunk, at chunk_tiles 1 / 2 / fitted {fitted}, k, n in "
        f"1 / 8 / 64, 7 surplus chunks) match the plain version and a "
        f"second launch (max abs err {worst:.3g}); launches without real "
        f"tiles wrote zeros")


def k9_edge_cases(torch, ops, run_compare, results):
    """K9 at shapes the captured calls may not give it: rows with count 0
    and with count C, row and candidate counts that are not multiples of a
    thread block or of the four keys a thread stores, C = 1, base keys
    with the high bit set, starts near 2^31. Then K5 on a layout built on
    the card as device sampling builds it, whose static chunk count
    exceeds ``group_chunk_ptr[R]``: the surplus chunks must not change
    dW."""
    import numpy as np

    rng = np.random.default_rng(9)
    dev = torch.device("cuda")
    n = 0
    for rows, width, base in ((1, 1, 0x80000000), (3, 1, 0xFFFFFFFF),
                              (1001, 7, 0x9E3779B9), (4099, 222, 0xC0FFEE01),
                              (65537, 31, 0), (257, 3, 0x7FFFFFFF)):
        starts = rng.integers(0, 2**31 - width, rows).astype(np.int32)
        cnts = rng.integers(0, width + 1, rows).astype(np.int32)
        cnts[0], cnts[-1] = width, 0
        if rows > 2:
            cnts[1] = width
        args = (torch.from_numpy(starts).to(dev),
                torch.from_numpy(cnts).to(dev), base, width)
        results[K9]["max_abs_err"] = max(results[K9]["max_abs_err"],
                                         run_compare(K9, args, {}))
        n += 1
    from repro_torch.kernels import sampling_ops as SO
    before = ops.launch_counts()[K9]
    out = SO.candidate_keys(torch.zeros(0, 5, dtype=torch.int32, device=dev),
                            torch.zeros(0, 5, dtype=torch.int32, device=dev),
                            1, 7)
    check(out.shape == (0, 5, 7) and ops.launch_counts()[K9] == before,
          f"{K9}: an empty window launched a kernel")
    sizes = rng.integers(1, 400, 10)
    sizes[[2, 6]] = 0
    ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    group = np.repeat(np.arange(10, dtype=np.int32), sizes)
    cap = 1 << (int(sizes.sum()) + 10 * 32 - 1).bit_length()
    lay = ops.device_padded_segments(torch.from_numpy(ptr).to(dev),
                                     torch.from_numpy(group).to(dev), 32,
                                     cap)
    check(lay.num_chunks > int(lay.group_chunk_ptr[-1]),
          "K5 edge case: the static chunk bound is not above the exact "
          "count")
    x_p = torch.from_numpy(rng.normal(size=(cap, 64)).astype(np.float32)
                           ).to(dev)
    x_p[lay.row_map < 0] = 0.0
    dy = torch.from_numpy(rng.normal(size=(cap, 48)).astype(np.float32)
                          ).to(dev)
    err = run_compare(K5, (x_p, dy, lay.group_tile_ptr, lay.group_chunk_ptr),
                      dict(num_groups=10, num_chunks=lay.num_chunks,
                           tile=32, chunk_tiles=lay.chunk_tiles))
    results[K5]["max_abs_err"] = max(results[K5]["max_abs_err"], err)
    log(f"[phase 2] K9 edge cases: {n} windows bit-equal to the plain "
        f"version and to numpy (count 0 and C, C = 1 and 3, odd row "
        f"counts, high-bit bases), an empty window launched nothing; K5 "
        f"with {lay.num_chunks} chunks for "
        f"{int(lay.group_chunk_ptr[-1])} needed equals its plain version "
        f"(max abs err {err:.3g})")


# ---------------------------------------------------------------------------
# phases 3 and 4: serving through the driver
# ---------------------------------------------------------------------------
def compare_with_cpu(torch, hector_torch, cfg, batches, tol, tag):
    """The served ``(seq, step, logits)`` batches of ``serve(**cfg)``
    against the same mini-batches through the port on the CPU (default
    decisions), at rtol = atol = ``tol``; returns the max abs error."""
    import numpy as np

    from repro_torch.core.graph import table3_graph
    from repro_torch.sampling import build_minibatch

    graph = table3_graph(cfg["dataset"], cfg["scale"], cfg["seed"])
    cpu = hector_torch.compile(
        cfg["model"], graph, layers=cfg["layers"], dim=cfg["dim"],
        hidden=cfg["hidden"], classes=cfg["classes"], sample=cfg["fanouts"],
        tile=cfg["tile"], node_block=cfg["node_block"], seed=cfg["seed"],
        device="cpu")
    params = cpu.init(cfg["seed"])
    feats = torch.from_numpy(np.random.default_rng(cfg["seed"]).normal(
        size=(graph.num_nodes, cfg["dim"])).astype(np.float32))
    worst = 0.0
    for seq, step, logits in batches:
        mb = build_minibatch(seq, step=step, tile=cfg["tile"],
                             node_block=cfg["node_block"], bucket=True)
        want = cpu.apply_blocks(params, mb, feats)
        err = float((logits - want).abs().max())
        worst = max(worst, err)
        check(bool(torch.allclose(logits, want, rtol=tol, atol=tol)),
              f"{tag}: batch {step} logits differ from the CPU run "
              f"(max abs err {err:.3g})")
    return worst


def phase_serve(torch, hector_torch, ops, serve_rgnn, cfg, tag):
    batches = []

    def keep(mb, logits):
        batches.append((mb.seq, mb.step, logits.detach().cpu()))

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = serve_rgnn.serve(**cfg, device="cuda", on_batch=keep,
                             log=lambda m: log(f"[{tag}] {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = ops.launch_counts()
    log(f"[{tag}] launches on the served path: {json.dumps(launches)}")
    for name in KERNELS:
        if FORWARD_LAUNCHES[cfg["model"]].get(name, 0):
            check(launches[name] > 0,
                  f"{tag}: {name} never launched on the served path")
        else:
            check(launches[name] == 0, f"{tag}: {name} launched "
                  f"{launches[name]} times on the served path")
    check(len(batches) == cfg["num_batches"], f"{tag}: batches missing")
    for _, step, logits in batches:
        check(logits.shape == (cfg["batch_size"], cfg["classes"]),
              f"{tag}: batch {step} logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()),
              f"{tag}: batch {step} has non-finite logits")

    worst = compare_with_cpu(torch, hector_torch, cfg, batches, 1e-4, tag)
    log(f"[{tag}] all {len(batches)} batches match the CPU run "
        f"(max abs err {worst:.3g}); latency p50 "
        f"{stats['latency_ms_p50']:.3f} ms, p95 "
        f"{stats['latency_ms_p95']:.3f} ms, {stats['seeds_per_s']:.1f} "
        f"seeds/s, {stats['edges_per_batch']:.0f} edges/batch, peak "
        f"{peak:.3f} GiB (phase wall {wall:.2f} s)")
    keys = ("latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
            "latency_ms_mean", "wait_ms_mean", "compute_ms_mean",
            "seeds_per_s", "edges_per_batch")
    return (dict({k: stats[k] for k in keys}, launches=launches,
                 max_abs_err_vs_cpu=worst, batches=len(batches),
                 peak_mem_gib=peak),
            {step: logits for _, step, logits in batches})


# ---------------------------------------------------------------------------
# phases 9 and 10: device sampling (``--sampler device``)
# ---------------------------------------------------------------------------
def phase_device_serve(torch, ops, serve_rgnn, cfg, tag, host, host_logits):
    """Serve ``cfg`` again with ``sampler="device"``: every batch's logits
    against the host-sampled run's (phases 3 and 4, same seeds), no host
    build, no count sync after warmup, every batch that outgrew a shrunken
    bucket rebuilt before it was served, every sampling call after the
    first under ``torch.cuda.set_sync_debug_mode("error")``
    (any device-to-host synchronization inside it raises), K9 launched;
    the peak device memory of each sampling call (allocations are made
    when the work is dispatched, so no synchronization is needed to read
    them) and of the whole run."""
    from repro_torch.sampling import DeviceSampler

    batches = []
    guarded = []
    mem = dict(overall=0, sampling=[])
    orig = DeviceSampler.sample_minibatch

    def sample(self, seeds, batch_index=0, **kw):
        mem["overall"] = max(mem["overall"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        if batch_index >= 1:
            torch.cuda.set_sync_debug_mode("error")
            guarded.append(batch_index)
        try:
            return orig(self, seeds, batch_index=batch_index, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            mem["sampling"].append(torch.cuda.max_memory_allocated())

    def keep(mb, logits):
        batches.append((mb.step, logits.detach().cpu()))

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DeviceSampler.sample_minibatch = sample
    t0 = time.perf_counter()
    try:
        stats = serve_rgnn.serve(**cfg, device="cuda", sampler="device",
                                 on_batch=keep,
                                 log=lambda m: log(f"[{tag}] {m}"))
        torch.cuda.synchronize()
    finally:
        DeviceSampler.sample_minibatch = orig
    wall = time.perf_counter() - t0
    peak = max(mem["overall"], torch.cuda.max_memory_allocated()) / 2**30
    launches = ops.launch_counts()
    log(f"[{tag}] launches on the device-sampled path: "
        f"{json.dumps(launches)}")
    for name in KERNELS:
        if name == K9 or FORWARD_LAUNCHES[cfg["model"]].get(name, 0):
            check(launches[name] > 0, f"{tag}: {name} never launched")
        else:
            check(launches[name] == 0, f"{tag}: {name} launched "
                  f"{launches[name]} times")
    nb = cfg["num_batches"]
    check(len(batches) == nb, f"{tag}: batches missing")
    check(sorted(set(guarded)) == list(range(1, nb)), f"{tag}: sampling "
          f"calls under the sync check: {guarded}")
    check(stats["sampler"] == "device" and stats["host_builds"] == 0
          and stats["device_builds"] == nb,
          f"{tag}: builds host {stats['host_builds']} / device "
          f"{stats['device_builds']}")
    check(stats["sampler_count_syncs_after_warmup"] == 0,
          f"{tag}: {stats['sampler_count_syncs_after_warmup']} count syncs "
          f"after warmup")
    # a batch that outgrew its buckets is rebuilt before it is served
    # (``DeviceSampler.settle``; the drain counts each hop that overflowed)
    check(stats["sampler_bucket_overflows"] == 0
          or stats["sampler_overflow_rebuilds"] > 0,
          f"{tag}: {stats['sampler_bucket_overflows']} bucket overflows but "
          f"no batch rebuilt")
    worst = 0.0
    for step, logits in batches:
        want = host_logits[step]
        check(logits.shape == want.shape and
              bool(torch.isfinite(logits).all()),
              f"{tag}: batch {step} logits shape or values")
        err = float((logits - want).abs().max())
        worst = max(worst, err)
        check(bool(torch.allclose(logits, want, rtol=DEVICE_TOL,
                                  atol=DEVICE_TOL)),
              f"{tag}: batch {step} device-sampled logits differ from the "
              f"host-sampled ones (max abs err {err:.3g})")
    sampling_gib = [m / 2**30 for m in mem["sampling"]]
    log(f"[{tag}] all {nb} batches match the host-sampled run (max abs "
        f"err {worst:.3g}); every sampling call after the first ran under "
        f"the sync check; {stats['sampler_bucket_shrinks']} bucket shrinks, "
        f"{stats['sampler_bucket_overflows']} overflows "
        f"({stats['sampler_overflow_rebuilds']} batches rebuilt), 0 count "
        f"syncs after warmup, K9 x{launches[K9]}")
    log(f"[{tag}] device vs host sampling: latency p50 "
        f"{stats['latency_ms_p50']:.3f} vs {host['latency_ms_p50']:.3f} ms, "
        f"p95 {stats['latency_ms_p95']:.3f} vs "
        f"{host['latency_ms_p95']:.3f} ms, wait "
        f"{stats['wait_ms_mean']:.3f} vs {host['wait_ms_mean']:.3f} ms, "
        f"compute {stats['compute_ms_mean']:.3f} vs "
        f"{host['compute_ms_mean']:.3f} ms, {stats['seeds_per_s']:.1f} vs "
        f"{host['seeds_per_s']:.1f} seeds/s, peak {peak:.3f} vs "
        f"{host['peak_mem_gib']:.3f} GiB (phase wall {wall:.2f} s)")
    log(f"[{tag}] peak device memory while sampling each batch (GiB): "
        + ", ".join(f"{g:.3f}" for g in sampling_gib))
    keys = ("latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
            "latency_ms_mean", "wait_ms_mean", "compute_ms_mean",
            "seeds_per_s", "edges_per_batch", "sampler_traces",
            "sampler_bucket_shrinks", "sampler_bucket_overflows",
            "sampler_overflow_rebuilds", "sampler_count_syncs")
    return dict({k: stats[k] for k in keys}, launches=launches,
                max_abs_err_vs_host=worst, batches=nb, peak_mem_gib=peak,
                sampling_peak_gib=sampling_gib, host=host)


def phase_device_train(torch, ops, train_rgnn, cfg, host):
    """Phase 10: the sampled training of phase 6 (RGAT) with
    ``sampler="device"``, op by op as phase 6 counts it: the kernels of
    each step on the device-built layouts (K5 with its static chunk
    bound), K9 twice a sampled batch (one window a hop), the first step's
    loss equal to the host-sampled run's (the same batch, the same initial
    weights), a falling loss, every batch that outgrew its buckets
    rebuilt; then again captured (``captured_train_run``)."""
    import numpy as np

    model = cfg["model"]
    tag = f"phase 10 {model}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = train_rgnn.train(**cfg, eval_every_epochs=0, device="cuda",
                             sampler="device", compiled=False,
                             log=lambda m: log(f"[{tag}] {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = stats["steps"]
    want = {name: STEP_LAUNCHES[model].get(name, 0) * steps
            + FORWARD_LAUNCHES[model].get(name, 0) * 3 for name in KERNELS}
    # one window a hop, for every batch sampled (a rebuilt batch twice)
    want[K9] = 2 * stats["sampler_batches_sampled"]
    log(f"[{tag}] launches: {json.dumps(launches)} over {steps} steps")
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    losses = np.asarray(stats["losses"])
    check(bool(np.isfinite(losses).all()), f"{tag}: non-finite loss")
    rel = abs(losses[0] - host["loss_first"]) / abs(host["loss_first"])
    check(rel <= 1e-4, f"{tag}: first loss {losses[0]:.6f} vs host-sampled "
          f"{host['loss_first']:.6f} (rel {rel:.3g})")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < first, f"{tag}: loss did not fall (first 10 steps "
          f"{first:.4f}, last 10 {last:.4f})")
    check(stats["sampler_bucket_overflows"] == 0
          or stats["sampler_overflow_rebuilds"] > 0,
          f"{tag}: {stats['sampler_bucket_overflows']} bucket overflows but "
          f"no batch rebuilt")
    log(f"[{tag}] first loss {losses[0]:.6f} vs host-sampled "
        f"{host['loss_first']:.6f} (rel {rel:.3g}); loss {first:.4f} -> "
        f"{last:.4f}; step p50 {stats['step_ms_p50']:.3f} vs "
        f"{host['step_ms_p50']:.3f} ms, p99 {stats['step_ms_p99']:.3f} vs "
        f"{host['step_ms_p99']:.3f} ms, {stats['seeds_per_s']:.1f} vs "
        f"{host['seeds_per_s']:.1f} seeds/s; "
        f"{stats['sampler_bucket_shrinks']} bucket shrinks, "
        f"{stats['sampler_bucket_overflows']} overflows "
        f"({stats['sampler_overflow_rebuilds']} batches rebuilt) (phase "
        f"wall {wall:.2f} s)")
    captured = captured_train_run(torch, train_rgnn, cfg, tag, losses,
                                  sampler="device")
    keys = ("steps", "step_ms_p50", "step_ms_p99", "seeds_per_s",
            "sampler_bucket_shrinks", "sampler_bucket_overflows",
            "sampler_overflow_rebuilds", "sampler_trace_count")
    return dict({k: stats[k] for k in keys}, launches=launches,
                loss_first=float(losses[0]), loss_first10=first,
                loss_last10=last, wall_s=wall, captured=captured)


# ---------------------------------------------------------------------------
# phase 5: where the device time goes (torch.profiler over a serve run)
# ---------------------------------------------------------------------------
def phase_profile(torch, serve_rgnn, cfg, tag):
    """Serve ``cfg`` again (captured, ``serve``'s default) under
    ``torch.profiler``: the kernels the card ran, counted from the trace
    (replayed graphs included, which no wrapper counts) and held to the
    model's per-forward counts times the batches; each kernel's device
    time per launch and per served batch, and the device's busy share of
    the serving loop (the profiler's host overhead inflates the loop, so
    the busy share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = serve_rgnn.serve(**cfg, device="cuda", log=lambda m: None)
        torch.cuda.synchronize()
    loop_s = stats["batches"] * stats["batch_size"] / stats["seeds_per_s"]
    served = [name for name in KERNELS
              if FORWARD_LAUNCHES[cfg["model"]].get(name, 0)]
    busy_us, per_kernel, top = 0.0, {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = _device_us(e)
        busy_us += t
        top[e.key[:60]] = (t, e.count)
        for name in served:
            if KERNELS[name]["symbol"] in e.key:
                n0, t0 = per_kernel.get(name, (0, 0.0))
                per_kernel[name] = (n0 + e.count, t0 + t)
    check(busy_us > 0, f"{tag}: the profiler recorded no device time")
    out = {}
    for name in served:
        count, t_us = per_kernel.get(name, (0, 0.0))
        check(count > 0, f"{tag}: profiler saw no {name} launch")
        want = (FORWARD_LAUNCHES[cfg["model"]][name] * stats["batches"]
                * KERNELS[name].get("per_call", 1))
        check(count == want, f"{tag}: the profiler saw {count} {name} "
              f"kernels, {want} expected over {stats['batches']} batches")
        count //= KERNELS[name].get("per_call", 1)     # calls, not kernels
        out[name] = dict(launches=count, device_ms_per_launch=t_us / count
                         / 1e3, device_ms_per_batch=t_us / stats["batches"]
                         / 1e3)
        log(f"[{tag}] {name}: {count} launches run (profiler), "
            f"{out[name]['device_ms_per_launch']:.5f} ms device time per "
            f"launch, {out[name]['device_ms_per_batch']:.5f} ms per batch")
    busy_share = busy_us / 1e6 / loop_s
    log(f"[{tag}] device busy {busy_us / 1e3:.3f} ms of a "
        f"{loop_s * 1e3:.3f} ms serving loop under the profiler: busy "
        f"share {busy_share:.4f}, idle share {1 - busy_share:.4f}")
    for key, (t, count) in sorted(top.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[{tag}]   {t / 1e3:9.3f} ms  x{count:<5d} {key}")
    return dict(kernels=out, device_busy_ms=busy_us / 1e3,
                loop_ms=loop_s * 1e3, busy_share=busy_share)


# ---------------------------------------------------------------------------
# phases 6-8: training
# ---------------------------------------------------------------------------
def compare_states(torch, tag, state, state_cpu, metrics, metrics_cpu):
    """Card against CPU after one step: loss rtol 1e-5, params and mu rtol
    1e-4 / atol 1e-6; returns the largest differences."""
    from repro_torch.optim.adamw import tree_leaves

    loss, loss_cpu = float(metrics["loss"]), float(metrics_cpu["loss"])
    check(abs(loss - loss_cpu) <= 1e-5 * abs(loss_cpu),
          f"{tag}: loss {loss!r} on the card vs {loss_cpu!r} on the CPU")
    worst = {}
    for part in ("params", "mu"):
        err = 0.0
        for a, b in zip(tree_leaves(getattr(state, part)),
                        tree_leaves(getattr(state_cpu, part))):
            a = a.cpu()
            err = max(err, float((a - b).abs().max()))
            check(bool(torch.allclose(a, b, rtol=1e-4, atol=1e-6)),
                  f"{tag}: {part} differ from the CPU step (max abs err "
                  f"{float((a - b).abs().max()):.3g})")
        worst[part] = err
    worst["loss"] = abs(loss - loss_cpu)
    log(f"[{tag}] one step on the card equals the CPU step: loss "
        f"{loss:.6f} vs {loss_cpu:.6f}, max abs err params "
        f"{worst['params']:.3g}, mu {worst['mu']:.3g}")
    return worst


def captured_train_run(torch, train_rgnn, cfg, tag, eager, **kw):
    """``cfg`` trained again at ``train``'s default (captured): the
    first loss bit for bit the op-by-op run's (both run their first step
    op by op), every loss finite, the loss falling, every repeated key
    served by a replay; returns the run's step times."""
    import numpy as np

    st = train_rgnn.train(**cfg, eval_every_epochs=0, device="cuda",
                          log=lambda m: None, **kw)
    torch.cuda.synchronize()
    losses = np.asarray(st["losses"])
    check(len(losses) == len(eager) and losses[0] == eager[0],
          f"{tag}: captured first loss {losses[0]!r}, op by op "
          f"{eager[0]!r}")
    check(bool(np.isfinite(losses).all()), f"{tag}: captured run has a "
          f"non-finite loss")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < first, f"{tag}: captured loss did not fall ({first:.4f} "
          f"-> {last:.4f})")
    check(st["executor_replays"] == st["executor_cache_hits"]
          and 0 < st["executor_captures"] <= st["executor_compiled"],
          f"{tag}: {st['executor_captures']} graphs, "
          f"{st['executor_replays']} replays for "
          f"{st['executor_cache_hits']} repeated keys")
    log(f"[{tag}] captured (the default): first loss equal, loss "
        f"{first:.4f} -> {last:.4f}; {st['executor_compiled']} keys, "
        f"{st['executor_captures']} graphs, {st['executor_replays']} "
        f"replays; step p50 {st['step_ms_p50']:.3f} ms, p99 "
        f"{st['step_ms_p99']:.3f} ms, {st['seeds_per_s']:.1f} seeds/s")
    keys = ("step_ms_p50", "step_ms_p99", "seeds_per_s",
            "executor_compiled", "executor_captures", "executor_replays")
    return {k: st[k] for k in keys}


def phase_train(torch, ops, train_rgnn, task, cfg):
    """Phase 6: sampled training of ``cfg["model"]`` through the driver op
    by op (``compiled=False``: every kernel the card runs goes through
    its wrapper, so the counts are exact), then at ``train``'s captured
    default (``captured_train_run``), then one step on the card against
    the CPU."""
    import numpy as np

    model = cfg["model"]
    tag = f"phase 6 {model}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = train_rgnn.train(**cfg, eval_every_epochs=0, device="cuda",
                             compiled=False,
                             log=lambda m: log(f"[{tag}] {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = stats["steps"]
    # full-graph forwards in train(): the teacher's labels and the final
    # train and validation evaluations
    full = 3
    want = {name: STEP_LAUNCHES[model].get(name, 0) * steps
            + FORWARD_LAUNCHES[model].get(name, 0) * full
            for name in KERNELS}
    log(f"[{tag}] launches: {json.dumps(launches)} over {steps} steps and "
        f"{full} full-graph forwards")
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    losses = np.asarray(stats["losses"])
    check(bool(np.isfinite(losses).all()), f"{tag}: non-finite loss")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < first, f"{tag}: loss did not fall (first 10 steps "
          f"{first:.4f}, last 10 {last:.4f})")
    log(f"[{tag}] {steps} steps op by op: loss {first:.4f} (mean of the "
        f"first 10) -> {last:.4f} (last 10); step p50 "
        f"{stats['step_ms_p50']:.3f} ms, "
        f"p99 {stats['step_ms_p99']:.3f} ms, {stats['seeds_per_s']:.1f} "
        f"seeds/s; full-graph eval: val loss {stats['full_val_loss']:.4f} "
        f"acc {stats['full_val_acc']:.4f}, train loss "
        f"{stats['full_train_loss']:.4f} acc {stats['full_train_acc']:.4f} "
        f"(phase wall {wall:.2f} s)")
    captured = captured_train_run(torch, train_rgnn, cfg, tag, losses)
    state, metrics = task.step(torch)
    state_cpu, metrics_cpu = task.cpu_step(torch)
    worst = compare_states(torch, tag, state, state_cpu, metrics,
                           metrics_cpu)
    keys = ("steps", "step_ms_p50", "step_ms_p99", "seeds_per_s",
            "full_val_loss", "full_val_acc", "full_train_loss",
            "full_train_acc", "executor_compiled")
    return dict({k: stats[k] for k in keys}, launches=launches,
                loss_first=float(losses[0]), loss_first10=first,
                loss_last10=last, wall_s=wall, step_parity=worst,
                captured=captured)


def phase_full_graph(torch, task, train_rgnn, cfg, split):
    """Phase 7: full-graph steps of the task's model — aifb on the card
    against the CPU, then bgs at scale 1.0 for 3 timed steps. Then K1, K4,
    K5 and K11 are held (each bitwise against a second launch too) and
    timed (``time_call``) at every call of one bgs full-graph step; for RGCN,
    K7 and K8 at the K7 calls of one
    bgs full-graph forward (``time_weighted``), for RGAT and HGT, K2 and
    K3 at their calls and K6 at K3's (``time_softmax``)."""
    import dataclasses

    from repro_torch.train import FullGraphTrainer

    tag = f"phase 7 {task.engine.cfg.model}"
    out = {}
    fg = FullGraphTrainer(task.engine, task.feats, task.labels,
                          task.train_ids, opt=task.opt, compiled=False,
                          log=None)
    fg_cpu = FullGraphTrainer(task.cpu, task.feats, task.labels,
                              task.train_ids, opt=task.opt, log=None)
    t0 = time.perf_counter()
    state, metrics = fg.step(task.state)
    torch.cuda.synchronize()
    out["aifb_first_step_ms"] = (time.perf_counter() - t0) * 1e3
    state_cpu, metrics_cpu = fg_cpu.step(task.state_cpu)
    out["aifb_step_parity"] = compare_states(
        torch, f"{tag} aifb", state, state_cpu, metrics, metrics_cpu)

    bcfg = dataclasses.replace(task.engine.cfg, device="cuda")
    t0 = time.perf_counter()
    engine, feats, labels, train_ids, _ = train_rgnn.build_task(
        "bgs", 1.0, bcfg, cfg["seed"])
    torch.cuda.synchronize()
    out["bgs_build_s"] = time.perf_counter() - t0
    fg = FullGraphTrainer(engine, feats, labels, train_ids, opt=task.opt,
                          compiled=False, log=None)
    state = fg.init_state(engine.init(cfg["seed"]))
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = fg.step(state)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    check(all(math.isfinite(x) for x in losses),
          f"{tag} bgs: non-finite loss {losses}")
    out.update(bgs_step_ms=step_ms, bgs_losses=losses,
               bgs_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               bgs_nodes=engine.graph.num_nodes,
               bgs_edges=engine.graph.num_edges,
               bgs_train_nodes=len(train_ids))
    log(f"[{tag} bgs] {engine.graph.num_nodes} nodes, "
        f"{engine.graph.num_edges} edges, loss over {len(train_ids)} train "
        f"nodes {losses}; step ms {[round(x, 3) for x in step_ms]} (the "
        f"first builds the full-graph layouts); peak device memory "
        f"{out['bgs_peak_gib']:.2f} GiB; task build {out['bgs_build_s']:.2f}"
        f" s")
    from repro_torch.kernels import sampling_ops as SO
    from repro_torch.kernels import segment_mm as SK
    from repro_torch.kernels import traversal as TK

    model = task.engine.cfg.model
    tables = kernel_tables(torch, SK, TK, SO)
    run_compare = compare_runner(torch, SO, *tables[:2])
    with recorded_kernel_calls() as calls:
        fg.step(state)
        torch.cuda.synchronize()
    for name, key in ((K1, "k1_bgs"), (K4, "k4_bgs"), (K5, "k5_bgs"),
                      (K11, "k11_bgs")):
        check(len(calls[name]) == STEP_LAUNCHES[model][name], f"{tag} bgs: "
              f"{len(calls[name])} {name} calls in a full-graph step")
        timed = [time_call(torch, tables, name, args, kw,
                           run_compare(name, args, kw))
                 for args, kw in calls[name]]
        out[key] = dict(calls=timed, **{k: sum(c[k] for c in timed) for k in
                                        ("ms", "wrapper_ms", "plain_ms",
                                         "library_ms", "bound_ms")})
        log(f"[{tag} bgs] {name}: {len(timed)} calls in a full-graph step, "
            f"kernel {out[key]['ms']:.5f} ms on the device, wrapper "
            f"{out[key]['wrapper_ms']:.4f} ms, plain "
            f"{out[key]['plain_ms']:.4f} ms, {LIBRARY[name][0]} "
            f"{out[key]['library_ms']:.4f} ms, bound "
            f"{out[key]['bound_ms']:.5f} ms")
    agg = K7 if model == "rgcn" else K3
    with recorded_kernel_calls() as calls:
        fg.evaluate(state.params)
    for name in (agg, K2) if agg == K3 else (agg,):
        check(len(calls[name]) == FORWARD_LAUNCHES[model][name],
              f"{tag} bgs: {len(calls[name])} {name} calls in a forward")
    for i, (args, kw) in enumerate(calls[agg]):
        at = f"{model} bgs full-graph forward, layer {i}"
        if agg == K7:
            time_weighted(torch, tables, run_compare, args, kw, at, tag,
                          split)
        else:
            time_softmax(torch, tables, run_compare, calls[K2][i],
                         (args, kw), at, tag, split)
    out["bgs_trainer"], out["bgs_state"] = fg, state
    return out


RANGES = ("forward", "backward", "optimizer")


def deterministic_probe(torch, fn):
    """The ops of one op-by-op call of ``fn`` that have no deterministic
    implementation on the card: the warnings
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` raises
    over it (first lines, deduplicated). A diagnostic, not a setting of
    the program: the mode is switched off again after the call (and the
    filling of uninitialized memory it brings stays off, so the call
    computes what it always does)."""
    import warnings

    from torch.utils import deterministic

    fill = deterministic.fill_uninitialized_memory
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        deterministic.fill_uninitialized_memory = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
            deterministic.fill_uninitialized_memory = fill
    return sorted({str(w.message).strip().splitlines()[0][:240]
                   for w in caught})


def phase_train_profile(torch, task, full, trace_dir):
    """Phase 8: one sampled step (aifb-b64) and one bgs full-graph step
    under ``torch.profiler``: device time per kernel and per step (kernels
    and copies; the profiler's GPU-side range annotations are not device
    work), the device's busy share of the step, the device time of the
    kernels of the ``forward`` range, of the backward and of the
    ``optimizer`` range, and the 8 device ops that take the most time,
    with their range. Each step runs once more under
    ``deterministic_probe``: the ops that warn are listed."""
    from torch.profiler import ProfilerActivity, profile

    fg, state = full.pop("bgs_trainer"), full.pop("bgs_state")
    model = task.engine.cfg.model
    # the probe's positive control: a weighted bincount has no
    # deterministic CUDA implementation, so it must warn
    control = deterministic_probe(torch, lambda: torch.bincount(
        torch.zeros(4, dtype=torch.long, device="cuda"),
        weights=torch.ones(4, device="cuda")))
    log(f"[phase 8 {model}] deterministic probe control (weighted "
        f"bincount): {control or 'no warning'}")
    runs = {f"{model} sampled aifb-b64": lambda: task.step(torch),
            f"{model} full-graph bgs": lambda: fg.step(state)}
    out = {"deterministic_probe_control": control}
    for tag, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device events: kernels, copies, and one span per record_function
        # range that launched work (the profiler's GPU-side annotations,
        # which cover the range's kernels and the gaps between them)
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = {e.name: (e.time_range.start, e.time_range.end)
                 for e in dev_events if e.name in RANGES}
        busy_us, per_kernel, top = 0.0, {}, {}
        ranges = dict.fromkeys(RANGES, 0.0)
        for e in dev_events:
            if e.name in RANGES:
                continue
            t = e.time_range.elapsed_us()
            busy_us += t
            for name, meta in KERNELS.items():
                if meta["symbol"] in e.name:
                    c0, d0 = per_kernel.get(name, (0, 0.0))
                    per_kernel[name] = (c0 + 1, d0 + t)
            # one stream: forward's kernels, then the backward's (launched
            # by the autograd engine's thread, outside the "backward" range
            # of the calling thread), then the optimizer's
            where = "backward"
            for rng in ("forward", "optimizer"):
                lo, hi = spans.get(rng, (1, 0))
                if lo <= e.time_range.start <= hi:
                    where = rng
            ranges[where] += t
            c0, d0 = top.get((where, e.name[:60]), (0, 0.0))
            top[(where, e.name[:60])] = (c0 + 1, d0 + t)
        check(busy_us > 0, f"phase 8 {tag}: no device time recorded")
        host = dict.fromkeys(RANGES, 0.0)
        for e in prof.events():
            if e.name in RANGES and \
                    e.device_type == torch.autograd.DeviceType.CPU:
                host[e.name] += e.cpu_time_total
        res = dict(step_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                   busy_share=busy_us / wall_us,
                   kernels={k: dict(launches=c, device_ms=t / 1e3)
                            for k, (c, t) in per_kernel.items()},
                   range_device_ms={k: v / 1e3 for k, v in ranges.items()},
                   top=[dict(range=w, name=n, launches=c, device_ms=t / 1e3)
                        for (w, n), (c, t) in sorted(
                            top.items(), key=lambda kv: -kv[1][1])[:8]],
                   range_host_ms={k: v / 1e3 for k, v in host.items()})
        out[tag] = res
        log(f"[phase 8 {tag}] step {res['step_ms']:.3f} ms under the "
            f"profiler, device busy {res['device_busy_ms']:.3f} ms (busy "
            f"share {res['busy_share']:.4f})")
        for k, v in res["kernels"].items():
            log(f"[phase 8 {tag}]   {k}: {v['launches']} launches, "
                f"{v['device_ms']:.5f} ms")
        log(f"[phase 8 {tag}]   device ms by range "
            + json.dumps({k: round(v, 5)
                          for k, v in res["range_device_ms"].items()})
            + ", host ms by range "
            + json.dumps({k: round(v, 3)
                          for k, v in res["range_host_ms"].items()}))
        for op in res["top"]:
            log(f"[phase 8 {tag}]   {op['device_ms']:9.3f} ms  "
                f"x{op['launches']:<5d} {op['range']:9s} {op['name']}")
        if trace_dir:
            path = pathlib.Path(trace_dir)
            path.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(
                str(path / (tag.replace(" ", "_") + ".json")))
        res["deterministic_warnings"] = deterministic_probe(torch, fn)
        log(f"[phase 8 {tag}] under use_deterministic_algorithms(True, "
            f"warn_only=True): {len(res['deterministic_warnings'])} ops "
            f"warn" + "".join(f"\n[phase 8 {tag}]   warns: {w}"
                              for w in res["deterministic_warnings"]))
    return out


# ---------------------------------------------------------------------------
# phase 11: the autotuner (``--tune``) and the kernels only it selects
# ---------------------------------------------------------------------------
# the reference's bounds for a forced variant against the defaults
# (tests/test_tune.py: outputs, and gradients normalized by their max)
VARIANT_TOL, VARIANT_GRAD_TOL = 2e-4, 5e-4
# the variants phase 11 forces onto every key of an RGAT and an RGCN plan
FORCED_VARIANTS = ({"fuse_gather": False}, {"tile_rows": 16},
                   {"tile_rows": 8, "fuse_gather": False})


def capture_unfused_train_calls(torch, task):
    """One RGAT training step of phase 6's task under decisions forcing
    ``fuse_gather=False`` on every key, its kernel calls recorded: K2 + K6
    in place of K2 + K3, K4 in place of K1. The train executor's table is
    restored afterwards."""
    ex = task.engine.train_executor(task.opt)
    feats = {"feature": task.x[task.mb.input_ids.long()]}
    ex.set_decisions(forced(torch, task.engine.plans, task.state.params,
                            task.mb, feats, fuse_gather=False))
    try:
        with recorded_kernel_calls() as calls:
            _, metrics = task.step(torch)
            torch.cuda.synchronize()
    finally:
        ex.set_decisions(None)
    check(bool(torch.isfinite(metrics["loss"])), "unfused RGAT step: "
          "non-finite loss")
    check(len(calls[K6]) == 2 and not calls[K1] and not calls[K3],
          f"unfused RGAT step: {len(calls[K6])} K6, {len(calls[K1])} K1, "
          f"{len(calls[K3])} K3 calls (expected 2, 0, 0)")
    return calls


def tuning_edge_cases(torch, TK, L, ops, R, run_compare, results):
    """K6 and K8 at inputs the captured calls may not give them: node
    blocks without tiles (written as zero rows), pure-pad tiles, pad slots
    whose padded message rows are not zero (they must add nothing), a
    scale and ``scale=None``, d = 64 / 16 / 1; the ops with
    ``fuse_gather=False`` over compact rows (materialized, pads -1) against
    the oracles; empty layouts, which must not launch."""
    import numpy as np

    rng = np.random.default_rng(11)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n, n_nodes = 0, 300
    pool = np.concatenate([np.arange(64), np.arange(192, n_nodes)])
    empty = slice(2 * 32, 6 * 32)        # node blocks 2-5 own no tile
    for grow in (False, True):
        dst = rng.choice(pool, 2000).astype(np.int32)
        perm = np.argsort(dst, kind="stable").astype(np.int32)
        dptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=n_nodes), out=dptr[1:])
        bc = L.block_csr(dptr, 32, 32)
        if grow:                          # pure-pad tiles at the end
            bc = L.pad_blocked_csr(bc, L.pow2ceil(bc.padded_edges) * 2)
        rows_u = rng.integers(0, 700, 2000).astype(np.int32)
        bcd = ops.blocked_csr_dev(bc, perm, rows_u).to(dev)
        kw = dict(node_block=32, num_node_blocks=bc.num_node_blocks)
        scores = t(rng.normal(size=2000).astype(np.float32) * 3)
        scores_p = ops._padded_scores(scores, bcd)
        mx, den = TK.seg_stats_padded(scores_p, bcd.local_dst, bcd.t2b,
                                      bcd.block_tile_ptr, **kw)
        pad = bcd.local_dst.reshape(-1) >= 32
        for d in (64, 16, 1):
            msg = t(rng.normal(size=(2000, d)).astype(np.float32))
            msg_p = ops.pad_rows(msg, bcd.edge_map)
            noisy = msg_p.clone()
            noisy[pad] = 1e3
            args6 = (scores_p, noisy, bcd.local_dst, bcd.t2b,
                     bcd.block_tile_ptr, mx, den)
            results[K6]["max_abs_err"] = max(results[K6]["max_abs_err"],
                                             run_compare(K6, args6, kw))
            out6 = TK.seg_softmax_agg_padded(*args6, **kw)
            check(compare(torch, "K6 pad slots", out6,
                          TK.seg_softmax_agg_padded(scores_p, msg_p,
                                                    *args6[2:], **kw),
                          0, 0, exact=True) == 0.0,
                  "K6: pad slots changed the output")
            for scale in (None, t(rng.normal(size=2000).astype(np.float32))):
                args8 = (ops._padded_scale(scale, bcd, msg), noisy,
                         bcd.local_dst, bcd.t2b, bcd.block_tile_ptr)
                results[K8]["max_abs_err"] = max(
                    results[K8]["max_abs_err"], run_compare(K8, args8, kw))
                out8 = TK.seg_weighted_agg_padded(*args8, **kw)
                check(bool((out8[empty] == 0).all()),
                      "K8: blocks without tiles not zero")
                n += 1
            check(bool((out6[empty] == 0).all()),
                  "K6: blocks without tiles not zero")
            n += 1
        # the ops with fuse_gather=False over compact rows, on the card
        msg_u = t(rng.normal(size=(700, 16)).astype(np.float32))
        scale = t(rng.normal(size=2000).astype(np.float32))
        rows = t(rows_u)
        msg_e = msg_u[rows.long()]
        got = ops.edge_softmax_agg(scores, msg_u, t(dst), n_nodes, bc=bcd,
                                   msg_rows=rows, fuse_gather=False)
        results[K6]["max_abs_err"] = max(
            results[K6]["max_abs_err"], compare(
                torch, "edge_softmax_agg(fuse_gather=False)", got,
                R.softmax_agg_ref(scores, msg_e, t(dst).long(), n_nodes),
                TOLERANCE[K6], TOLERANCE[K6]))
        got = ops.weighted_agg(scale, msg_u, t(dst), n_nodes, bc=bcd,
                               msg_rows=rows, fuse_gather=False)
        results[K8]["max_abs_err"] = max(
            results[K8]["max_abs_err"], compare(
                torch, "weighted_agg(fuse_gather=False)", got,
                R.weighted_agg_ref(scale, msg_e, t(dst).long(), n_nodes),
                TOLERANCE[K8], TOLERANCE[K8]))
        n += 2
    # empty layouts: nothing launches
    before = ops.launch_counts()
    bce = ops.blocked_csr_dev(L.block_csr(np.zeros(9, np.int64), 32, 32),
                              np.zeros(0, np.int32)).to(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    outs = [fn(torch.zeros(0, device=dev), torch.ones(0, 16, device=dev),
               torch.zeros(0, **i32), 8, bc=bce, fuse_gather=False)
            for fn in (ops.edge_softmax_agg, ops.weighted_agg)]
    outs.append(TK.seg_weighted_agg_padded(
        torch.zeros(0, 32, device=dev), torch.ones(0, 16, device=dev),
        torch.zeros(0, 32, **i32), torch.zeros(1, **i32),
        torch.zeros(1, **i32), node_block=32, num_node_blocks=0))
    outs.append(TK.seg_softmax_agg_padded(
        torch.zeros(0, 32, device=dev), torch.ones(0, 16, device=dev),
        torch.zeros(0, 32, **i32), torch.zeros(1, **i32),
        torch.zeros(1, **i32), torch.zeros(0, 32, device=dev),
        torch.zeros(0, 32, device=dev), node_block=32, num_node_blocks=0))
    torch.cuda.synchronize()
    check([tuple(o.shape) for o in outs] == [(8, 16), (8, 16), (0, 16),
                                             (0, 16)]
          and not outs[0].any() and not outs[1].any(),
          "empty layouts: wrong K6 / K8 outputs")
    check(ops.launch_counts() == before, "an empty layout launched K6 or K8")
    log(f"[phase 11] K6 / K8 edge cases: {n} checks passed (node blocks "
        f"without tiles, pure-pad tiles, noisy pad rows, scale on and off, "
        f"d = 64 / 16 / 1, the ops over compact rows); empty layouts "
        f"launched nothing")


def phase_forced_variants(torch, ops):
    """Phase 11 (b): every variant of ``FORCED_VARIANTS`` on every key of
    one RGAT and one RGCN layer (64 -> 64) over the whole aifb graph, on
    the card, against the default decisions: outputs and the gradients of
    ``sum(out ** 2)`` (normalized by their max) at the reference's bounds;
    the variant's kernels must be the ones that ran; a decision naming the
    reference's ``xla`` backend must raise. Then RGAT's forward at the
    layout tile 128 / node block 128 (the tuner's other layout candidate)
    against 32 / 32."""
    import numpy as np

    from repro_torch.core import codegen
    from repro_torch.core.graph import table3_graph
    from repro_torch.core.module import HectorModule
    from repro_torch.train import MODEL_PROGRAMS
    from repro_torch.tune import GemmVariant, TravVariant, TuningDecisions
    from repro_torch.tune.tuner import _KeyRecorder

    graph = table3_graph("aifb", 1.0, 0)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(graph.num_nodes, 64)).astype(np.float32)).cuda()
    out = {}
    for model, agg in (("rgat", K6), ("rgcn", K8)):
        def module(tile):
            return HectorModule(MODEL_PROGRAMS[model](64, 64), graph,
                                tile=tile, node_block=tile, device="cuda")
        mod = module(32)
        params = mod.init(torch.Generator().manual_seed(0))
        name = mod.plan.outputs[0]

        def run(m, decisions):
            m.executor.set_decisions(decisions)
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            ops.reset_launch_counts()
            y = m.apply(leaves, {"feature": x})[name]
            torch.sum(y ** 2).backward()
            torch.cuda.synchronize()
            return (y.detach(), {k: v.grad for k, v in leaves.items()},
                    ops.launch_counts())

        base, base_g, _ = run(mod, None)
        rec = _KeyRecorder()
        with torch.no_grad():
            codegen.execute_plan(mod.plan, params, mod.gt, {"feature": x},
                                 mod.layouts, rec)
        res = {}
        for variant in FORCED_VARIANTS:
            d = TuningDecisions()
            for key in rec.keys:
                d.set_op(key, GemmVariant(**variant)
                         if key.startswith("gemm") else
                         TravVariant(fuse_gather=variant.get("fuse_gather")))
            y, g, launched = run(mod, d)
            tag = f"{model} {json.dumps(variant)}"
            err = compare(torch, tag, y, base, VARIANT_TOL, VARIANT_TOL)
            gerr = 0.0
            for k, want in base_g.items():
                denom = float(want.abs().max()) + 1e-9
                gerr = max(gerr, compare(torch, f"{tag} d{k}", g[k] / denom,
                                         want / denom, VARIANT_GRAD_TOL,
                                         VARIANT_GRAD_TOL))
            if variant.get("fuse_gather") is False:
                check(launched[agg] > 0 and launched[K1] == 0,
                      f"{tag}: launches {launched}")
            else:
                check(launched[agg] == 0 and launched[K1] > 0,
                      f"{tag}: launches {launched}")
            res[json.dumps(variant)] = dict(max_abs_err=err,
                                            grad_max_rel_err=gerr,
                                            keys=len(rec.keys))
            log(f"[phase 11] forced {tag} on {len(rec.keys)} keys equals "
                f"the defaults: max abs err {err:.3g}, gradients "
                f"{gerr:.3g} (normalized)")
        # a cached decision naming a backend the card lacks raises
        bad = TuningDecisions()
        bad.set_op(rec.keys[0], GemmVariant(backend="xla")
                   if rec.keys[0].startswith("gemm") else
                   TravVariant(backend="xla"))
        mod.executor.set_decisions(bad)
        try:
            with torch.no_grad():
                mod.apply(params, {"feature": x})
        except ValueError as e:
            check("names backend 'xla'" in str(e), f"{model}: {e}")
        else:
            raise Failed(f"{model}: a decision naming backend 'xla' ran")
        log(f"[phase 11] {model}: a decision naming backend 'xla' raises")
        if model == "rgat":
            with torch.no_grad():
                y128 = module(128).apply(params, {"feature": x})[name]
            res["layout 128"] = compare(torch, "rgat layout 128/128", y128,
                                        base, VARIANT_TOL, VARIANT_TOL)
            log(f"[phase 11] rgat at layout tile 128 / node block 128 "
                f"equals 32 / 32: max abs err {res['layout 128']:.3g}")
        out[model] = res
    return out


def _tuned_entries(path):
    """The op decisions of a tuning cache file: how many keys chose
    ``fuse_gather=False``, and the ``tile_rows`` the GEMM keys chose."""
    import collections

    entries = json.loads(pathlib.Path(path).read_text())["entries"]
    ops_ = {k: v for k, v in entries.items()
            if k.startswith(("gemm|", "trav|"))}
    return dict(
        entries=len(entries), op_keys=len(ops_),
        unfused=sum(v.get("fuse_gather") is False for v in ops_.values()),
        unfused_trav=sum(v.get("fuse_gather") is False
                         for k, v in ops_.items() if k.startswith("trav|")),
        tile_rows=dict(collections.Counter(
            str(v.get("tile_rows")) for k, v in ops_.items()
            if k.startswith("gemm|"))),
        layout=[v for k, v in entries.items() if k.startswith("lay|")])


def phase_tune_train(torch, ops, train_rgnn, cache_dir):
    """Phase 11 (c): RGAT training at aifb-b64 (phase 6's configuration, 1
    epoch) with ``tune="full"`` on a fresh cache, op by op (its launches
    are the ``kernels`` line's for K6): the full-graph layout (both
    candidates timed), materialization and op variants, then the
    block-scale variants; then the same run with ``tune="cached"`` at the
    captured default: zero measurements, every decision replayed, the
    same decision table, the same first loss bit for bit."""
    import numpy as np

    cfg = dict(TRAIN, model="rgat")
    cache = str(cache_dir / "train.json")
    lines = []

    def tlog(m):
        lines.append(m)
        if not m.startswith("[tune]   ") or "layout" in m:
            log(f"[phase 11 train] {m}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    full = train_rgnn.train(**cfg, eval_every_epochs=0, device="cuda",
                            tune="full", tune_cache=cache, compiled=False,
                            log=tlog)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(full["tune_measurements"] > 0, "tune=full measured nothing")
    mirror = dict(full=tune_mirror(full, "phase 11 train tune=full"))
    layouts = [m for m in lines if "layout tile=" in m]
    check(len(layouts) == 2, f"layout candidates timed: {layouts}")
    check(launches[K6] > 0, "K6 never launched by tune=full")
    losses = np.asarray(full["losses"])
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(bool(np.isfinite(losses).all()) and last < first,
          f"tuned training: loss {first:.4f} -> {last:.4f}")
    tuned = _tuned_entries(cache)
    log(f"[phase 11 train] tune=full: {full['tune_measurements']} "
        f"measurements, {full['tune_tuned_ops']} tuned, "
        f"{full['tune_cache_hits']} replayed; {tuned['op_keys']} op keys, "
        f"{tuned['unfused']} chose fuse_gather=False ({tuned['unfused_trav']}"
        f" of them traversals), tile_rows {tuned['tile_rows']}, layout "
        f"{tuned['layout']}; loss {first:.4f} -> {last:.4f}; step p50 "
        f"{full['step_ms_p50']:.3f} ms; launches {json.dumps(launches)}; "
        f"wall {wall:.2f} s")

    t0 = time.perf_counter()
    cached = train_rgnn.train(**cfg, eval_every_epochs=0, device="cuda",
                              tune="cached", tune_cache=cache,
                              log=lambda m: None)
    torch.cuda.synchronize()
    wall_cached = time.perf_counter() - t0
    want_hits = full["tune_tuned_ops"] + full["tune_cache_hits"] + 1
    check(cached["tune_measurements"] == 0,
          f"tune=cached measured {cached['tune_measurements']} times")
    check(cached["tune_cache_hits"] == want_hits,
          f"tune=cached replayed {cached['tune_cache_hits']} decisions, "
          f"the first run made {want_hits}")
    check(cached["tune_decisions"] == full["tune_decisions"],
          "tune=cached built another decision table")
    check(cached["losses"][0] == full["losses"][0], f"tune=cached first "
          f"loss {cached['losses'][0]!r} captured, "
          f"{full['losses'][0]!r} op by op")
    mirror["cached"] = tune_mirror(cached, "phase 11 train tune=cached")
    log(f"[phase 11 train] tune=cached: 0 measurements, "
        f"{cached['tune_cache_hits']} replayed, decisions "
        f"{cached['tune_decisions']} (the same); captured, first loss "
        f"equal to the op-by-op run's; step p50 "
        f"{cached['step_ms_p50']:.3f} ms; wall {wall_cached:.2f} s")
    keys = ("tune_measurements", "tune_tuned_ops", "tune_cache_hits",
            "tune_decisions", "step_ms_p50", "step_ms_p99", "seeds_per_s")
    return dict(full={k: full[k] for k in keys}, wall_s=wall,
                cached={k: cached[k] for k in keys}, wall_cached_s=wall_cached,
                decisions=tuned, layout_lines=layouts, tuner_lines=lines,
                loss_first10=first, loss_last10=last, launches=launches,
                obs_mirror=mirror)


def phase_tune_serve(torch, hector_torch, ops, serve_rgnn, cache_dir):
    """Phase 11 (d): RGCN served at aifb-b32 with ``tune="full"``
    (materialization at engine build, block-scale variants on a warm
    batch), op by op (its launches are the ``kernels`` line's for K8):
    every batch's logits equal the same mini-batch on the CPU (default
    decisions) within rtol = atol = 2e-4; then served again with
    ``tune="cached"`` at the captured default: zero measurements, every
    batch's logits bitwise equal to the op-by-op run's."""
    cfg = dict(SERVE_DEFAULTS, model="rgcn")
    batches = []
    lines = []

    def keep(mb, logits):
        batches.append((mb.seq, mb.step, logits.detach().cpu()))

    ops.reset_launch_counts()
    stats = serve_rgnn.serve(**cfg, device="cuda", tune="full",
                             tune_cache=str(cache_dir / "serve.json"),
                             compiled=False, on_batch=keep,
                             log=lines.append)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    replayed = []
    cached = serve_rgnn.serve(
        **cfg, device="cuda", tune="cached",
        tune_cache=str(cache_dir / "serve.json"), log=lambda m: None,
        on_batch=lambda mb, y: replayed.append(y.detach().cpu()))
    check(cached["tune_measurements"] == 0 and cached["tune_decisions"]
          == stats["tune_decisions"], "serve tune=cached measured or built "
          "another decision table")
    check(len(replayed) == len(batches) and all(
        torch.equal(a, b[2]) for a, b in zip(replayed, batches)),
        "serve tune=cached (captured): logits differ from the op-by-op "
        "tune=full run's")
    check(stats["tune_measurements"] > 0, "serve tune=full measured nothing")
    mirror = tune_mirror(stats, "phase 11 serve tune=full")
    check(launches[K8] > 0, "K8 never launched by serve tune=full")
    check(len(batches) == cfg["num_batches"], "tuned serve: batches missing")
    worst = compare_with_cpu(torch, hector_torch, cfg, batches, 2e-4,
                             "phase 11 serve")
    tuned = _tuned_entries(cache_dir / "serve.json")
    log(f"[phase 11 serve] rgcn aifb-b32 tune=full: "
        f"{stats['tune_measurements']} measurements, {tuned['op_keys']} op "
        f"keys, {tuned['unfused']} chose fuse_gather=False, tile_rows "
        f"{tuned['tile_rows']}; all {len(batches)} batches match the CPU "
        f"run (max abs err {worst:.3g}); latency p50 "
        f"{stats['latency_ms_p50']:.3f} ms; launches {json.dumps(launches)}; "
        f"tune=cached captured: logits bitwise equal, "
        f"{cached['executor_captures']} graphs, latency p50 "
        f"{cached['latency_ms_p50']:.3f} ms")
    return dict(latency_ms_p50=stats["latency_ms_p50"],
                latency_ms_p95=stats["latency_ms_p95"],
                seeds_per_s=stats["seeds_per_s"],
                tune_measurements=stats["tune_measurements"],
                max_abs_err_vs_cpu=worst, decisions=tuned,
                launches=launches, tuner_lines=lines, obs_mirror=mirror)


def phase_tune_bgs(torch, cache_dir):
    """Phase 11 (e): the full-graph ``tune_stack`` of a 2-layer RGAT (64 ->
    64 -> 16) over bgs at scale 1.0: both layout candidates' plan times,
    materialization and op variants, on the card."""
    from repro_torch.core.graph import table3_graph
    from repro_torch.models import rgat_program
    from repro_torch.tune import Tuner

    graph = table3_graph("bgs", 1.0, 0)
    lines = []
    tuner = Tuner(mode="full", cache_path=str(cache_dir / "bgs.json"),
                  log=lines.append, device="cuda")
    t0 = time.perf_counter()
    report = tuner.tune_stack([rgat_program(64, 64), rgat_program(64, 16)],
                              graph, tile=32, node_block=32,
                              feat_dims=[64, 64], seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    layouts = [m for m in lines if "layout tile=" in m]
    check(len(layouts) == 2 and tuner.stats["measurements"] > 0,
          f"bgs tune_stack: layouts {layouts}, stats {tuner.stats}")
    tuned = _tuned_entries(cache_dir / "bgs.json")
    for m in layouts + [m for m in lines if "mat " in m]:
        log(f"[phase 11 bgs] {m}")
    csets = [None if c is None else sorted(c) for c in report.compact_vars]
    log(f"[phase 11 bgs] tune_stack over {graph.num_nodes} nodes / "
        f"{graph.num_edges} edges: {tuner.stats}, layout "
        f"{report.tile}/{report.node_block}, compact vars {csets}"
        f", {tuned['op_keys']} op keys, {tuned['unfused']} chose "
        f"fuse_gather=False, tile_rows {tuned['tile_rows']}; {wall:.2f} s")
    return dict(stats=dict(tuner.stats), tile=report.tile,
                node_block=report.node_block, decisions=tuned, wall_s=wall,
                layout_lines=layouts, tuner_lines=lines)


def phase_tuning(torch, hector_torch, SK, TK, SO, L, R, ops, serve_rgnn,
                 train_rgnn, task):
    """Phase 11: (a) K6 and K8 against their plain versions at the calls of
    one RGAT and one RGCN served aifb-b32 batch and one RGAT training step
    under decisions forcing ``fuse_gather=False``, plus edge cases, timed
    at the served batches; (b) forced variants against the defaults; (c)
    tuned training, full then cached; (d) tuned serving against the CPU;
    (e) the bgs full-graph tuning. K6's and K8's launches are those of (c)
    and (d), each counted from 0."""
    import tempfile

    results = new_results(TUNING_KERNELS)
    runs = dict(SERVE_RUNS)
    captured = {}
    for tag in ("rgat aifb", "rgcn aifb"):
        calls = capture_main_path_calls(torch, hector_torch, runs[tag],
                                        unfused=True)
        agg = K6 if tag.startswith("rgat") else K8
        check(len(calls[agg]) > 0 and not calls[K1],
              f"unfused {tag}: {len(calls[agg])} {agg}, {len(calls[K1])} "
              f"K1 calls")
        captured[f"{tag} unfused"] = calls
        log(f"[phase 11] captured {tag} batch 0 under fuse_gather=False: "
            + ", ".join(f"{k} x{len(v)}" for k, v in calls.items() if v))
    captured["rgat step unfused"] = capture_unfused_train_calls(torch, task)
    tables = kernel_tables(torch, SK, TK, SO)
    run_compare = compare_runner(torch, SO, *tables[:2])
    hold_captured(torch, captured, results, tables, run_compare,
                  "phase 11")
    tuning_edge_cases(torch, TK, L, ops, R, run_compare, results)
    summarize(results, "phase 11")

    out = dict(kernels=results, forced=phase_forced_variants(torch, ops))
    with tempfile.TemporaryDirectory() as tmp:
        cache_dir = pathlib.Path(tmp)
        out["train"] = phase_tune_train(torch, ops, train_rgnn, cache_dir)
        out["serve"] = phase_tune_serve(torch, hector_torch, ops, serve_rgnn,
                                        cache_dir)
        out["bgs"] = phase_tune_bgs(torch, cache_dir)
    out["launches"] = {name: out["train"]["launches"][name]
                       + out["serve"]["launches"][name]
                       for name in TUNING_KERNELS}
    return out


# ---------------------------------------------------------------------------
# phase 12: LM serving (prefill + KV-cache decode), K10 as the attention core
# ---------------------------------------------------------------------------
# (b)'s full-width serve runs through ``repro_torch.launch.serve``
LM_SERVE_RUNS = (
    ("gemma2-2b", dict(arch="gemma2-2b", batch=4, prompt_len=4096, gen=32)),
    ("qwen3-4b", dict(arch="qwen3-4b", batch=8, prompt_len=2048, gen=32)))
LM_DENSE = ("qwen3-4b", "gemma2-2b", "gemma3-4b", "qwen3-14b")
# K10 against its plain version, (rtol, atol): fp32 at the reference's
# tests/test_flash.py bound (test_flash_matches_ref_sweep); bf16 at one
# bf16 ulp of each value (2^-7 of it) plus 2e-5, since both sides compute
# in fp32 from the same bf16 inputs and round once. That is far inside the
# reference's test_flash_bf16 bound, 3e-2, which is about a 4096-key
# average's typical value and so could not see a wrong late row.
K10_TOL = {"torch.float32": (2e-5, 2e-5),
           "torch.bfloat16": (2 ** -7, 2e-5)}
# the card's logits against the CPU port's, fp32 (phase 3's bound)
LM_CPU_TOL = 1e-4
# greedy tokens must agree where the CPU's top-2 margin exceeds this
LM_MARGIN = 1e-3
# the dense bf16 tensor-core peak of the H100 SXM: the operations bound of
# bf16 K10 calls (fp32 calls use FP32_FLOPS)
BF16_FLOPS = 989e12
# (b, sq, sk, h, kv, hd, dtype, options) of (a)'s edge cases; each runs in
# its own dtype and again in bf16, so the tensor-core and decode kernels
# see every mask shape (bf16 at hd 8 / 12 takes the CUDA-core kernel)
K10_EDGE = (
    (2, 37, 101, 10, 2, 64, "float32", dict(q_offset=20)),      # ragged, g=5
    (3, 1, 333, 8, 1, 128, "float32", dict(q_offset=0)),        # MQA decode
    (3, 1, 333, 8, 1, 128, "float32", dict(q_offset=170)),      # mid-cache
    (3, 1, 333, 8, 1, 128, "float32", dict(q_offset=332)),      # last slot
    (1, 70, 90, 4, 4, 256, "float32", dict(window=1, q_offset=20)),
    (1, 70, 90, 4, 4, 256, "float32", dict(window=500, q_offset=20)),
    (2, 45, 77, 6, 3, 64, "float32", dict(causal=False, softcap=3.0)),
    # every row's first tiles lie wholly before its window
    (1, 130, 4200, 4, 2, 256, "float32", dict(window=64, q_offset=4000)),
    (1, 200, 300, 10, 2, 128, "float32", dict(window=40, q_offset=100)),
    (2, 12, 16, 4, 2, 16, "float32", dict(q_offset=0)),         # reduced hd
    (1, 33, 33, 2, 2, 8, "float32", dict(softcap=5.0)),
    (2, 1, 4128, 8, 4, 256, "float32",
     dict(window=4096, q_offset=4126, softcap=50.0)),           # split decode
    # rows that see no key (the window starts past the last key) average
    # every value: without causal masking, and in a split decode
    (2, 70, 90, 4, 2, 64, "float32",
     dict(causal=False, window=16, q_offset=60)),
    (1, 1, 4128, 8, 4, 256, "float32", dict(window=8, q_offset=4200)),
    (2, 300, 300, 8, 4, 256, "bfloat16", dict(window=128, softcap=50.0)),
    (8, 1, 2080, 40, 8, 128, "bfloat16", dict(q_offset=2079)),  # g=5 decode
)
# bf16 cases across the tensor-core and decode kernels' tile edges: rows
# not a multiple of the row block (Sq 37 x g 5), keys not a multiple of the
# 64-key tile, chunked prefill (q_offset > 0, Sq > 1), window edges inside
# a tile, hd 16 / 64 / 128 / 256, one exact tile, split prefill without
# causal masking, and decode-sized row counts up to 63
K10_TILE_EDGE = (
    (2, 37, 300, 10, 2, 64, dict(q_offset=263)),
    (1, 100, 1000, 8, 4, 128, dict(window=100, q_offset=900)),
    (2, 65, 65, 4, 2, 16, dict()),
    (1, 200, 333, 4, 1, 256, dict(window=77, softcap=30.0, q_offset=133)),
    (3, 64, 64, 2, 2, 128, dict()),
    (2, 96, 150, 6, 3, 64, dict(q_offset=54, window=33)),
    (1, 64, 2000, 2, 2, 128, dict(causal=False)),
    (2, 7, 500, 8, 1, 128, dict(q_offset=493)),
    (4, 3, 1000, 12, 4, 64, dict(window=300, q_offset=997)),
    (1, 21, 190, 12, 4, 256, dict(q_offset=169, softcap=50.0)),
)


def lm_capture_points(cfg, gen):
    """``{call index: tag}`` of the K10 calls (b) keeps from one serve run:
    the prefill call of the first local-window and of the first global
    layer, and those layers' calls at the last decode step (one call per
    layer per step, layers in stage, repeat, pattern order)."""
    layers = [spec for st in cfg.stages for _ in range(st.repeats)
              for spec in st.pattern]
    n, keep = len(layers), {}
    for kind, pick in (("local", lambda s: s.window is not None),
                       ("global", lambda s: s.window is None)):
        i = next((j for j, s in enumerate(layers) if pick(s)), None)
        if i is not None:
            keep[i] = f"{cfg.name} prefill {kind}"
            keep[(gen - 1) * n + i] = f"{cfg.name} decode {kind}"
    return keep


@contextlib.contextmanager
def recorded_k10_calls(keep):
    """Wrap the K10 name ``nn.attention`` calls for the block; the inputs of
    the calls at the indices of ``keep`` are cloned into the yielded dict
    under their tags (the wrapper, and so the launch count, runs as
    before)."""
    from repro_torch.nn import attention as A
    original, captured, n = A.flash_attention, {}, [0]

    def rec(q, k, v, **kw):
        if n[0] in keep:
            captured[keep[n[0]]] = ((q.clone(), k.clone(), v.clone()),
                                    dict(kw))
        n[0] += 1
        return original(q, k, v, **kw)

    A.flash_attention = rec
    try:
        yield captured
    finally:
        A.flash_attention = original


def phase_lm_serve(torch, ops, serve, C, tag, run):
    """(b): one full-width serve run, bf16, the port's own init: K10 at
    exactly ``num_layers x gen`` launches and no other kernel, every
    step's logits finite; returns its numbers and the kept K10 calls."""
    cfg = C.get_config(run["arch"])
    keep = lm_capture_points(cfg, run["gen"])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_k10_calls(keep) as captured:
        out = serve.serve(**run, device="cuda", keep_logits=True,
                          log=lambda m: log(f"[{tag}] {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    want = {name: 0 for name in KERNELS}
    want[K10] = cfg.num_layers * run["gen"]
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    check(sorted(captured) == sorted(keep.values()),
          f"{tag}: captured {sorted(captured)}")
    check(out["tokens"].shape == (run["batch"], run["gen"]),
          f"{tag}: tokens {out['tokens'].shape}")
    for i, lg in enumerate(out["logits"]):
        check(bool(torch.isfinite(lg).all()),
              f"{tag}: step {i} has non-finite logits")
    res = {k: out[k] for k in ("prefill_ms", "decode_ms",
                               "decode_ms_per_token", "tok_s",
                               "peak_mem_gib", "num_layers")}
    res.update(launches=launches[K10], wall_s=wall, **run)
    log(f"[{tag}] {cfg.num_layers} layers, batch {run['batch']}, prompt "
        f"{run['prompt_len']}, gen {run['gen']}: prefill "
        f"{res['prefill_ms']:.3f} ms, decode {res['decode_ms_per_token']:.3f}"
        f" ms per token ({res['tok_s']:.1f} tok/s), peak "
        f"{res['peak_mem_gib']:.3f} GiB; K10 launched {launches[K10]} times "
        f"(= {cfg.num_layers} layers x {run['gen']}), logits finite (phase "
        f"wall {wall:.2f} s)")
    return res, captured


def k10_work(torch, args, kw):
    """Bytes and FLOPs K10 must move/do on these inputs: q read and out
    written once, each key a row can see read once from k and v; 4 * hd
    FLOPs per unmasked (query, key) pair and head."""
    import numpy as np

    q, k, _ = args
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qpos = kw.get("q_offset", 0) + np.arange(sq)
    hi = (np.minimum(sk - 1, qpos) if kw.get("causal", True)
          else np.full(sq, sk - 1))
    window = kw.get("window")
    lo = (np.maximum(0, qpos - window + 1) if window is not None
          else np.zeros(sq, dtype=np.int64))
    pairs = int(np.maximum(0, hi - lo + 1).sum())
    keys = max(0, int(hi.max()) - int(lo.min()) + 1)
    nbytes = q.element_size() * (2 * b * sq * h * hd + 2 * b * keys * kv * hd)
    return nbytes, 4 * b * h * hd * pairs


def k10_bound(torch, args, kw):
    nbytes, flops = k10_work(torch, args, kw)
    peak = BF16_FLOPS if args[0].dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def k10_library(torch, F, args, kw):
    """One ``scaled_dot_product_attention(enable_gqa=True)`` call over the
    same inputs: ``is_causal`` over the keys a causal prefill sees, else the
    mask (window, causal bound at ``q_offset``) as an explicit boolean
    ``attn_mask``. SDPA has no softcap: at gemma2's calls it is the same
    shapes and masks without the cap."""
    import torch.nn.functional as Fn

    q, k, v = args
    sq, sk = q.shape[1], k.shape[1]
    off, causal = kw.get("q_offset", 0), kw.get("causal", True)
    window = kw.get("window")
    if window is not None and window >= off + sq:
        window = None                                   # masks nothing
    qt = q.transpose(1, 2)
    if causal and window is None and off == 0 and sq <= sk:
        kt, vt = k[:, :sq].transpose(1, 2), v[:, :sq].transpose(1, 2)
        return lambda: Fn.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    mask = F.attention_mask(off + torch.arange(sq, device=q.device),
                            torch.arange(sk, device=q.device), window, causal)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    return lambda: Fn.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _k10_shape(args, kw) -> str:
    q, k, _ = args
    opts = ", ".join(f"{key}={val}" for key, val in sorted(kw.items())
                     if val is not None)
    return (f"q={tuple(q.shape)} k={tuple(k.shape)} {str(q.dtype)[6:]}"
            + (f" {opts}" if opts else ""))


def hold_k10(torch, F, captured, results):
    """(a) and (d) at the kept calls: K10 against its plain version, in the
    calls' bf16 and again on the same inputs upcast to fp32 (at fp32's
    bound, so a wrong late row of a long sequence shows), then its device
    time (profiler; with the split-combine kernel where the call splits its
    keys), the wrapper's time (CUDA events), the plain version's, SDPA's
    and the bound."""
    r = results[K10]
    for tag, (args, kw) in captured.items():
        fn = lambda: F.flash_attention(*args, **kw)          # noqa: E731
        plain = lambda: F.flash_attention_plain(*args, **kw)  # noqa: E731
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = compare(torch, f"{K10} ({tag})", got, want,
                      *K10_TOL[str(args[0].dtype)])
        wide = tuple(a.float() for a in args)
        err32 = compare(torch, f"{K10} ({tag}, fp32)",
                        F.flash_attention(*wide, **kw),
                        F.flash_attention_plain(*wide, **kw),
                        *K10_TOL["torch.float32"])
        del wide
        plan = F.plan(args[0], args[1])
        splits = plan.splits
        ms = device_ms(torch, fn, "flash_", reps=10, per_call=plan.kernels)
        wrapper_ms = time_ms(torch, fn, reps=10, inner=2)
        plain_ms = time_ms(torch, plain, reps=5, inner=2)
        lib = k10_library(torch, F, args, kw)
        library_ms = time_ms(torch, lib, reps=10, inner=2)
        lib_err = float((lib().transpose(1, 2).float() - want.float()).abs()
                        .max())
        b_ms, b_by, nbytes, flops = k10_bound(torch, args, kw)
        shape = _k10_shape(args, kw)
        r["calls"].append(dict(tag=tag, shape=shape, ms=ms,
                               wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=b_ms,
                               bound_by=b_by, bytes=nbytes, flops=flops,
                               route=plan.route, splits=splits,
                               max_abs_err=err,
                               fp32_max_abs_err=err32,
                               library_max_abs_diff=lib_err))
        r["max_abs_err_by"][tag] = err
        r["max_abs_err"] = max(r["max_abs_err"], err)
        log(f"[phase 12] {K10} ({tag}) {shape}: max abs err {err:.3g} "
            f"(upcast to fp32: {err32:.3g}); "
            f"kernel {ms:.5f} ms on the device ({plan.route}, {splits} key "
            f"split{'s' if splits > 1 else ''}), wrapper {wrapper_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{library_ms:.4f} ms (max abs diff from the plain version "
            f"{lib_err:.3g}), bound {b_ms:.5f} ms ({b_by}, {nbytes} B, "
            f"{flops:.0f} FLOP)")


def k10_edge_cases(torch, F, ops, results):
    """(a)'s edge cases (``K10_EDGE`` in their own dtype and in bf16,
    ``K10_TILE_EDGE`` in bf16), a KV cache's layer read in place (fp32 and
    bf16, prefill chunk and decode), a non-contiguous k / v (copied by the
    wrapper), and an empty query that launches nothing. Every route of
    ``F.plan`` must be taken."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    routes = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def hold(name, q, k, v, kw):
        route = F.plan(q, k).route
        got = F.flash_attention(q, k, v, **kw)
        want = F.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = compare(torch, f"{K10} edge {name} ({route})", got, want,
                      *K10_TOL[str(q.dtype)])
        results[K10]["max_abs_err"] = max(results[K10]["max_abs_err"], err)
        routes[route] = routes.get(route, 0) + 1
        return err

    cases = [(c, dt) for c in K10_EDGE for dt in sorted({c[6], "bfloat16"})]
    cases += [(c[:6] + ("bfloat16", c[6]), "bfloat16")
              for c in K10_TILE_EDGE]
    errs = []
    for (b, sq, sk, h, kv, hd, _, kw), dt in cases:
        dtype = getattr(torch, dt)
        q = randn(b, sq, h, hd, dtype=dtype)
        k, v = (randn(b, sk, kv, hd, dtype=dtype) for _ in range(2))
        errs.append(hold(_k10_shape((q, k, v), kw), q, k, v, kw))
    for dtype in (torch.float32, torch.bfloat16):
        cache = randn(2, 3, 2, 300, 2, 128, dtype=dtype)  # [k|v, R, ...]
        k, v = cache[0, 1], cache[1, 1]
        check(F._operand(k, 128, 4 if dtype == torch.float32 else 8) is k,
              "a KV cache layer was copied, not read in place")
        for sq, off in ((70, 200), (1, 299)):
            q = randn(2, sq, 4, 128, dtype=dtype)
            errs.append(hold(f"cache layer in place, {sq} queries at {off} "
                             f"({str(dtype)[6:]})", q, k, v,
                             dict(q_offset=off)))
    q = randn(2, 1, 4, 64, dtype=torch.float32)
    kt = randn(2, 2, 40, 64, dtype=torch.float32).transpose(1, 2)
    errs.append(hold("non-contiguous k, v", q, kt, kt, dict(q_offset=39)))
    check(sorted(routes) == sorted(F.ROUTES),
          f"K10 edge cases took routes {routes}, not all of {F.ROUTES}")
    before = ops.launch_counts()[K10]
    out = F.flash_attention(randn(2, 0, 4, 64, dtype=torch.float32),
                            kt, kt)
    check(out.shape == (2, 0, 4, 64) and ops.launch_counts()[K10] == before,
          "an empty query launched K10")
    log(f"[phase 12] K10 edge cases: {len(errs)} kernel-vs-plain checks "
        f"passed (max abs err {max(errs):.3g}; routes {routes}); an empty "
        f"query launches nothing")


def k5_build_report(SK):
    """K5's kernel as built: ptxas's registers and spills (from this
    process's build) and the fp64 tensor-core instructions (DMMA) in its
    SASS (``cuobjdump -sass`` of the library, counted as phase 12 counts
    HMMA); fails if it has none. Returns the count."""
    import re

    from repro_torch.kernels import build

    name = None
    for line in build.build_log.get("segment_mm", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "segment_outer_kernel" in name and (
                "registers" in line or "spill" in line):
            log(f"[phase 1] ptxas segment_outer_kernel: "
                f"{line.split(':', 1)[-1].strip()}")
    lib = SK._library()
    cuobjdump = pathlib.Path(build.nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(cuobjdump), "-sass", lib._name],
                          capture_output=True, text=True, timeout=300)
    check(dump.returncode == 0, f"cuobjdump -sass failed: {dump.stderr}")
    count, inside = 0, False
    for line in dump.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = "segment_outer_kernel" in m.group(1)
        elif inside and re.search(r"\bDMMA\b", line):
            count += 1
    log(f"[phase 1] SASS segment_outer_kernel: {count} DMMA (fp64 "
        f"tensor-core) instructions")
    check(count > 0, "K5's kernel issues no DMMA")
    return count


def gemm_build_report():
    """K1's and K4's kernels as built (``segment_mm_gather_*`` /
    ``segment_mm_padded_*``, every route and register tile): ptxas's
    registers and spills, from this process's build; fails on a spill or
    when the build reported none of them. Returns {kernel: report}."""
    import re

    from repro_torch.kernels import build

    log_text = build.build_log.get("segment_mm")
    if log_text is None:
        log("[phase 1] ptxas K1 / K4: segment_mm was built before this run; "
            "no report")
        return {}
    reports, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(segment_mm_(?:gather|padded)_(?:wide|narrow))"
                          r"(I.*?E)E", m.group(1))
            name = None
            if k:                     # ILb1ELi8E -> <true, 8>
                targs = [("true" if v == "1" else "false") if t == "b" else v
                         for t, v in re.findall(r"L([bi])(\d+)E",
                                                k.group(2))]
                name = f"{k.group(1)}<{', '.join(targs)}>"
            if name:
                reports[name] = {}
        elif name and "spill" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            reports[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "registers" in line:
            reports[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    for name, rep in sorted(reports.items()):
        log(f"[phase 1] ptxas {name}: {rep.get('registers')} registers, "
            f"{rep.get('spill_stores')} / {rep.get('spill_loads')} bytes "
            f"spilled (stores / loads)")
        check(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
              f"{name} spills registers: {rep}")
    check(len(reports) == 14, f"ptxas reported {len(reports)} K1 / K4 "
          f"kernels, expected 14 (2 routes: wide TM 2 / 8, W as stored or "
          f"transposed; narrow NC 1 / 4 / 8 / 16; K1 and K4)")
    return reports


def k10_build_report(F):
    """K10's kernels as built: ptxas's registers and spills for each (from
    this process's build), and the tensor-core instructions (HMMA / HGMMA)
    in each kernel's SASS (``cuobjdump -sass`` of the library); fails if
    the tensor-core prefill kernel has none. Returns the SASS counts."""
    import re

    from repro_torch.kernels import build

    def short(mangled):
        m = re.search(r"\d+(flash_\w+?)(?:EvNS|ENS)_6ParamsE", mangled)
        return m.group(1) if m else mangled

    name, report = None, build.build_log.get("flash_attention")
    for line in (report or "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = short(m.group(1))
        elif name and ("registers" in line or "spill" in line):
            log(f"[phase 12] ptxas {name}: "
                f"{line.split(':', 1)[-1].strip()}")
    if report is None:
        log("[phase 12] ptxas: flash_attention was built before this run; "
            "no report")
    lib = F._library()
    cuobjdump = pathlib.Path(build.nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(cuobjdump), "-sass", lib._name],
                          capture_output=True, text=True, timeout=300)
    check(dump.returncode == 0, f"cuobjdump -sass failed: {dump.stderr}")
    counts, name = {}, None
    for line in dump.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short(m.group(1))
            counts[name] = 0
        elif name and re.search(r"\bH(G)?MMA\.", line):
            counts[name] += 1
    for name, n in sorted(counts.items()):
        log(f"[phase 12] SASS {name}: {n} tensor-core instructions")
    mma = {n: c for n, c in counts.items()
           if n.startswith("flash_attention_mma_kernel")}
    check(bool(mma) and all(c > 0 for c in mma.values()),
          f"the tensor-core prefill kernel issues no HMMA / HGMMA: {mma}")
    return counts


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_to(v, device) for v in tree]
    return tree.to(device)


def phase_lm_cpu(torch, C, serve, TransformerLM):
    """(c): the card against the CPU through the port, fp32, the same
    parameters moved across: each dense config's reduced variant (prefill
    + 4 decode steps) and gemma2-2b / qwen3-4b at full width with every
    stage's repeats cut to 1 (batch 2, prompt 256, gen 8). The card decodes
    the CPU's tokens; every step's logits within ``LM_CPU_TOL``, and the
    card's greedy token equal to the CPU's wherever the CPU's top-2 margin
    exceeds ``LM_MARGIN``."""
    import dataclasses

    import numpy as np

    runs = [(f"{a} reduced", C.get_reduced(a), 2, 12, 5) for a in LM_DENSE]
    for a in ("gemma2-2b", "qwen3-4b"):
        full = C.get_config(a)
        cut = dataclasses.replace(
            full, dtype="float32",
            stages=tuple(dataclasses.replace(st, repeats=1)
                         for st in full.stages))
        runs.append((f"{a} full width, 1 repeat", cut, 2, 256, 8))
    out = {}
    for tag, cfg, b, plen, gen in runs:
        t0 = time.perf_counter()
        cpu = TransformerLM(cfg, device="cpu")
        params = cpu.init()
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, plen)))
        ref = serve.generate(cpu, params, prompts, gen, keep_logits=True)
        card = TransformerLM(cfg, device="cuda")
        pc = _params_to(params, "cuda")
        lg, caches = card.prefill(pc, prompts.cuda(), cache_len=plen + gen)
        got = [lg[:, -1]]
        for i in range(gen - 1):
            tok = torch.as_tensor(ref["tokens"][:, i:i + 1], device="cuda")
            lg, caches = card.decode_step(pc, tok, plen + i, caches)
            got.append(lg[:, -1])
        worst, decided, agree = 0.0, 0, 0
        for i, (g, w) in enumerate(zip(got, ref["logits"])):
            g = g.cpu()
            err = float((g - w).abs().max())
            check(bool(torch.allclose(g, w, rtol=LM_CPU_TOL,
                                      atol=LM_CPU_TOL)),
                  f"phase 12 {tag} step {i}: card logits differ from the "
                  f"CPU's (max abs err {err:.3g})")
            worst = max(worst, err)
            top2 = w.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > LM_MARGIN
            same = g.argmax(-1) == w.argmax(-1)
            decided += int(sure.sum())
            agree += int((same & sure).sum())
        check(agree == decided, f"phase 12 {tag}: the card's greedy token "
              f"differs at {decided - agree} of {decided} positions with a "
              f"top-2 margin over {LM_MARGIN}")
        out[tag] = dict(max_abs_err=worst, steps=gen, tokens_decided=decided,
                        seconds=time.perf_counter() - t0)
        log(f"[phase 12] {tag}: {cfg.num_layers} layers, {gen} steps, card "
            f"logits = CPU logits (max abs err {worst:.3g}), greedy tokens "
            f"equal at all {decided} positions with a top-2 margin over "
            f"{LM_MARGIN} ({out[tag]['seconds']:.1f} s)")
        del card, pc, caches
    return out


def phase_lm_profile(torch, C, TransformerLM, tag, run):
    """Where a serve run's time goes: its prefill and its decode loop (the
    run of (b), fresh weights of the same seed) each under
    ``torch.profiler``: wall ms, device busy ms, K10's device ms, and the
    top device ops (the profiler's host overhead inflates the walls, so the
    busy shares are lower bounds)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    cfg = C.get_config(run["arch"])
    model = TransformerLM(cfg, device="cuda")
    params = model.init()
    b, plen, gen = run["batch"], run["prompt_len"], run["gen"]
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, plen)), device="cuda")
    state = {}

    def prefill():
        lg, state["caches"] = model.prefill(params, prompts,
                                            cache_len=plen + gen)
        state["tok"] = lg[:, -1].argmax(-1, keepdim=True)

    def decode():
        for i in range(gen - 1):
            lg, state["caches"] = model.decode_step(
                params, state["tok"], plen + i, state["caches"])
            state["tok"] = lg[:, -1].argmax(-1, keepdim=True)

    out = {}
    for part, fn in (("prefill", prefill), ("decode", decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy_us, k10_us, top = 0.0, 0.0, {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = _device_us(e)
            busy_us += us
            if "flash_" in e.key:
                k10_us += us
            top[e.key[:60]] = (us, e.count)
        check(busy_us > 0, f"{tag} {part}: no device time recorded")
        out[part] = dict(wall_ms=wall, device_busy_ms=busy_us / 1e3,
                         k10_ms=k10_us / 1e3, busy_share=busy_us / 1e3 / wall,
                         k10_share=k10_us / busy_us)
        log(f"[{tag}] {part}: wall {wall:.3f} ms under the profiler, device "
            f"busy {busy_us / 1e3:.3f} ms (share {out[part]['busy_share']:.4f}"
            f"), K10 {k10_us / 1e3:.3f} ms ({out[part]['k10_share']:.4f} of "
            f"the device time)")
        for key, (us, count) in sorted(top.items(),
                                       key=lambda kv: -kv[1][0])[:6]:
            log(f"[{tag}]   {us / 1e3:9.3f} ms  x{count:<6d} {key}")
    return out


def phase_lm(torch, ops, C, F, serve, TransformerLM):
    """Phase 12: (b) the full-width serve runs, their K10 calls kept;
    (a) K10 against its plain version there and at the edge cases; (d) its
    times; (c) the card against the CPU; then where each serve run's time
    goes. K10's launches are (b)'s, each run counted from 0."""
    results = new_results([K10])
    results[K10]["sass_tensor_instructions"] = k10_build_report(F)
    serve_runs, captured = {}, {}
    for tag, run in LM_SERVE_RUNS:
        serve_runs[tag], calls = phase_lm_serve(torch, ops, serve, C,
                                                f"phase 12 {tag}", run)
        captured.update(calls)
    hold_k10(torch, F, captured, results)
    k10_edge_cases(torch, F, ops, results)
    r = results[K10]
    for key in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "library_ms"):
        r[key] = sum(c[key] for c in r["calls"])
    by_bytes = sum(c["bound_ms"] for c in r["calls"]
                   if c["bound_by"] == "bytes")
    r["bound_by"] = "bytes" if by_bytes >= r["bound_ms"] / 2 else \
        "operations"
    r["timed_at"] = TIMED_AT[K10]
    log(f"[phase 12] {K10}: {len(r['calls'])} calls ({', '.join(captured)})"
        f": kernel {r['ms']:.5f} ms on the device, wrapper "
        f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention {r['library_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.5f} ms ({r['bound_by']}), max abs err "
        f"{r['max_abs_err']:.3g}")
    del captured
    cpu = phase_lm_cpu(torch, C, serve, TransformerLM)
    prof = {tag: phase_lm_profile(torch, C, TransformerLM,
                                  f"phase 12 profile {tag}", run)
            for tag, run in LM_SERVE_RUNS}
    return dict(kernels=results, serve=serve_runs, cpu=cpu, profile=prof,
                launches=sum(s["launches"] for s in serve_runs.values()))


# ---------------------------------------------------------------------------
# phase 13: telemetry (``repro_torch.obs``) on the card
# ---------------------------------------------------------------------------
# the phases each traced serve run must hold, by sampler
OBS_PHASES = {"host": ("wait", "execute", "sample", "layout"),
              "device": ("wait", "execute", "sample_device",
                         "layout_device")}
# the profile's coverage band at bgs-b1024 (device-bound enough that the
# prefix differences telescope within noise)
COVERAGE_BAND = (0.8, 1.25)
PROFILE_CATEGORIES = {"gemm", "traversal", "wprod", "glue"}
# the tuner's counts the obs registry mirrors as ``tune_<key>``
TUNE_STATS = ("measurements", "cache_hits", "tuned_ops")


@contextlib.contextmanager
def counted_syncs(torch):
    """Count the calls to ``torch.cuda.synchronize`` inside the block
    (every module of the port looks it up at call time): ``count[0]``
    the steady state's, ``count[1]`` those made while an executor
    captures a graph (the executor synchronizes once before each
    capture)."""
    from repro_torch.core import executor

    count = [0, 0]
    orig = torch.cuda.synchronize

    def counted(*args, **kwargs):
        count[1 if executor.capturing() else 0] += 1
        return orig(*args, **kwargs)

    torch.cuda.synchronize = counted
    try:
        yield count
    finally:
        torch.cuda.synchronize = orig


@contextlib.contextmanager
def compiled_engines(hector_torch):
    """The ``CompiledRGNN`` of every ``hector_torch.compile`` call inside
    the block (the drivers call it through the module)."""
    engines = []
    orig = hector_torch.compile

    def keep(*args, **kwargs):
        engines.append(orig(*args, **kwargs))
        return engines[-1]

    hector_torch.compile = keep
    try:
        yield engines
    finally:
        hector_torch.compile = orig


def tune_mirror(stats, what):
    """The ``tune_*`` counters of a driver's metrics snapshot (obs on, the
    default), which must equal the tuner's own counts in its stats."""
    from repro_torch.obs.registry import snapshot_counter_total

    got = {k: snapshot_counter_total(stats["metrics"], f"tune_{k}")
           for k in TUNE_STATS}
    want = {k: stats[f"tune_{k}"] for k in TUNE_STATS}
    check(got == want, f"{what}: the tune_* counters {got} differ from "
          f"the tuner's counts {want}")
    return got


def check_profile(prof, plans, tag):
    """One row per plan op (in order, with its label's category) plus one
    glue row per hop, categories in ``PROFILE_CATEGORIES``; returns
    {category: ms}."""
    from repro_torch.obs import profile as P

    want = []
    for hop, plan in enumerate(plans):
        want += [(hop, i, P._op_category(op), P._op_label(op))
                 for i, op in enumerate(plan.ops)]
        want.append((hop, len(plan.ops), "glue", None))
    got = [(o["hop"], o["index"], o["category"],
            None if o["category"] == "glue" else o["label"])
           for o in prof["ops"]]
    check(got == want, f"{tag}: profile rows {got} are not the plans' ops "
          f"plus a glue row per hop {want}")
    cats = {o["category"] for o in prof["ops"]}
    check(cats <= PROFILE_CATEGORIES, f"{tag}: categories {cats}")
    check(prof["backend"] == "cuda", f"{tag}: profiled on "
          f"{prof['backend']}")
    check(all(o["seconds"] >= 0 for o in prof["ops"]),
          f"{tag}: a negative row")
    by_cat = {k: v / 1e3 for k, v in prof["by_category_us"].items()}
    log(f"[{tag}] per-op profile: {len(prof['ops'])} rows ({len(plans)} "
        f"glue), whole {prof['total_us'] / 1e3:.4f} ms, attributed "
        f"{prof['sum_op_us'] / 1e3:.4f} ms (coverage "
        f"{prof['coverage']:.4f}); ms by category "
        + json.dumps({k: round(v, 5) for k, v in sorted(by_cat.items())}))
    for o in prof["ops"]:
        log(f"[{tag}]   hop {o['hop']} {o['label']:<40} "
            f"{o['seconds'] * 1e3:9.5f} ms")
    return by_cat


def obs_serve(torch, hector_torch, ops, serve_rgnn, cfg, tag, trace_dir,
              card):
    """Phase 13 (a) / (b), and (c) at aifb: ``cfg`` served three times,
    ``obs_mode="off"``, ``"on"`` and ``"on"`` with ``trace_out`` (and
    ``profile``), each counting its ``torch.cuda.synchronize`` calls and
    its launches from 0: logits bitwise equal, the same signature counts,
    the registry's counters equal to the stats', a ``serve_batch_ms``
    count per batch, a valid trace with the required phases (host: the
    loader's spans on another thread than ``execute``; device:
    ``sampler_traces`` equal to the sampler's own count), as many
    synchronizes with metrics on as off."""
    from repro_torch.obs import schema
    from repro_torch.obs.registry import (snapshot_counter_total,
                                          snapshot_histogram)

    sampler = cfg.get("sampler", "host")
    trace = trace_dir / (tag.replace(" ", "_") + ".json")
    runs = {}
    for mode in ("off", "on", "traced"):
        logits = []
        kw = dict(obs_mode="off" if mode == "off" else "on")
        if mode == "traced":
            kw.update(trace_out=str(trace), profile=True)
        ops.reset_launch_counts()
        with compiled_engines(hector_torch) as engines, \
                counted_syncs(torch) as syncs:
            stats = serve_rgnn.serve(
                **cfg, device="cuda", log=lambda m: None,
                on_batch=lambda mb, y: logits.append(y.detach().clone()),
                **kw)
        torch.cuda.synchronize()
        runs[mode] = dict(stats=stats, logits=logits, syncs=syncs[0],
                          capture_syncs=syncs[1],
                          launches=ops.launch_counts(), engine=engines[-1])
    off, on, traced = runs["off"], runs["on"], runs["traced"]
    n = cfg["num_batches"]
    check(len(off["logits"]) == len(on["logits"]) == len(traced["logits"])
          == n, f"{tag}: batches missing")
    for i, (a, b, c) in enumerate(zip(off["logits"], on["logits"],
                                      traced["logits"])):
        check(bool(torch.equal(a, b) and torch.equal(a, c)),
              f"{tag}: batch {i} logits differ between obs off / on / "
              f"traced")
    for key in ("executor_traces", "retraces_after_warmup"):
        vals = [r["stats"][key] for r in runs.values()]
        check(len(set(vals)) == 1, f"{tag}: {key} off / on / traced {vals}")
    check("metrics" not in off["stats"], f"{tag}: obs off recorded metrics")
    for mode in ("on", "traced"):
        st = runs[mode]["stats"]
        snap = st["metrics"]
        check(schema.validate_metrics(snap) == [],
              f"{tag} {mode}: {schema.validate_metrics(snap)}")
        check(snapshot_counter_total(snap, "executor_traces")
              == st["executor_traces"], f"{tag} {mode}: executor_traces "
              f"counter {snapshot_counter_total(snap, 'executor_traces')}"
              f", stats {st['executor_traces']}")
        check(snapshot_histogram(snap, "serve_batch_ms")["count"] == n,
              f"{tag} {mode}: serve_batch_ms count")
        if sampler == "device":
            check(snapshot_counter_total(snap, "sampler_traces")
                  == st["sampler_traces"] > 0, f"{tag} {mode}: "
                  f"sampler_traces counter "
                  f"{snapshot_counter_total(snap, 'sampler_traces')}, "
                  f"DeviceSampler.trace_count {st['sampler_traces']}")
    check(on["syncs"] == off["syncs"] == n, f"{tag}: {on['syncs']} "
          f"torch.cuda.synchronize calls with metrics on, {off['syncs']} "
          f"with obs off, outside captures, for {n} batches")
    for mode, r in runs.items():
        caps = r["stats"]["executor_captures"]
        check(r["capture_syncs"] == caps > 0, f"{tag} {mode}: "
              f"{r['capture_syncs']} synchronizes inside {caps} captures")
    doc = json.loads(trace.read_text())
    errs = schema.validate_trace(doc) + schema.require_phases(
        doc, OBS_PHASES[sampler])
    check(errs == [], f"{tag}: trace {errs}")
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    tids = {}
    for e in spans:
        tids.setdefault(e["name"], set()).add(e["tid"])
    if sampler == "host":
        check(not (tids["sample"] | tids["layout"]) & tids["execute"],
              f"{tag}: sample / layout share a thread track with execute "
              f"{tids}")
    launched = {k: v for k, v in off["launches"].items() if v}
    want = FORWARD_LAUNCHES[cfg["model"]]
    for name in list(want) + ([K9] if sampler == "device" else []):
        for mode, r in runs.items():
            check(r["launches"][name] > 0,
                  f"{tag} {mode}: {name} never launched")
    p50 = {m: r["stats"]["latency_ms_p50"] for m, r in runs.items()}
    log(f"[{tag}] {card}: logits of all {n} batches bitwise equal with obs "
        f"off / on / traced; executor_traces "
        f"{on['stats']['executor_traces']} (counter = stats), "
        f"{on['syncs']} torch.cuda.synchronize calls with metrics on = "
        f"{off['syncs']} off = one per batch, besides "
        f"{on['capture_syncs']} in the {on['stats']['executor_captures']} "
        f"captures ({traced['syncs']} traced, with the profile); trace "
        f"valid, {len(spans)} spans, phases "
        f"{sorted(tids)}; launches (off) {json.dumps(launched)}; latency "
        f"p50 ms off {p50['off']:.3f} / on {p50['on']:.3f} / traced "
        f"{p50['traced']:.3f}")
    log(f"[{tag}] phase totals (traced, ms): " + json.dumps(
        {k: round(v["total_s"] * 1e3, 3)
         for k, v in traced["stats"]["phases"].items()}))
    by_cat = check_profile(traced["stats"]["profile"],
                           traced["engine"].plans, tag)
    return dict(
        p50_ms=p50, p95_ms={m: r["stats"]["latency_ms_p95"]
                            for m, r in runs.items()},
        syncs={m: r["syncs"] for m, r in runs.items()},
        capture_syncs={m: r["capture_syncs"] for m, r in runs.items()},
        executor_traces=on["stats"]["executor_traces"],
        sampler_traces=on["stats"].get("sampler_traces"),
        phases=traced["stats"]["phases"], spans=len(spans),
        launches={m: r["launches"] for m, r in runs.items()},
        profile=traced["stats"]["profile"], profile_ms_by_category=by_cat)


def obs_profile_bgs(torch, hector_torch, ops, serve_rgnn, card):
    """Phase 13 (c) at bgs: RGAT bgs-b1024 served with ``profile=True``
    (obs on): the last batch's per-op profile, its rows and categories,
    its coverage inside ``COVERAGE_BAND``."""
    tag = "phase 13 c rgat bgs"
    ops.reset_launch_counts()
    with compiled_engines(hector_torch) as engines:
        stats = serve_rgnn.serve(**SERVE_LARGE, device="cuda", profile=True,
                                 log=lambda m: None)
    torch.cuda.synchronize()
    prof = stats["profile"]
    by_cat = check_profile(prof, engines[-1].plans, tag)
    lo, hi = COVERAGE_BAND
    check(lo <= prof["coverage"] <= hi, f"{tag}: coverage "
          f"{prof['coverage']:.4f} outside [{lo}, {hi}]")
    log(f"[{tag}] {card}: coverage {prof['coverage']:.4f} in [{lo}, {hi}]; "
        f"latency p50 {stats['latency_ms_p50']:.3f} ms (registry)")
    return dict(profile=prof, profile_ms_by_category=by_cat,
                coverage=prof["coverage"],
                latency_ms_p50=stats["latency_ms_p50"],
                launches=ops.launch_counts())


def obs_train(torch, ops, train_rgnn, trace_dir, phase8, card):
    """Phase 13 (d) and (e): RGAT aifb-b64 training (phase 6's
    configuration, 1 epoch) with obs off, on, and on with ``trace_out``
    and ``profile=True``: every loss bit for bit across the three (the
    backward runs in a fixed order on the card: K11 and K7, no float
    atomics), as many ``torch.cuda.synchronize`` calls on as off, the
    step p50 of each; in
    the traced run a ``train_step`` span and a ``train_step_ms``
    observation per step, a valid trace, and ``profile_train_step``'s
    attribution (all four keys >= 0, the step no shorter than its
    forward), printed beside phase 8's profiler split of the same
    model's step."""
    from repro_torch.obs import schema
    from repro_torch.obs.registry import snapshot_histogram

    tag = "phase 13 e rgat train"
    trace = trace_dir / "train.json"
    runs = {}
    for mode in ("off", "on"):
        with counted_syncs(torch) as syncs:
            st = train_rgnn.train(**dict(TRAIN, model="rgat"),
                                  eval_every_epochs=0, device="cuda",
                                  obs_mode=mode, log=lambda m: None)
        runs[mode] = dict(losses=st["losses"], syncs=syncs[0],
                          capture_syncs=syncs[1], steps=st["steps"],
                          graphs=st["executor_captures"],
                          step_ms_p50=st["step_ms_p50"],
                          retraces=st["retraces_after_warmup"])
    check(runs["on"]["syncs"] == runs["off"]["syncs"]
          == runs["off"]["steps"], f"{tag}: {runs['on']['syncs']} "
          f"torch.cuda.synchronize calls with metrics on, "
          f"{runs['off']['syncs']} with obs off, outside captures, for "
          f"{runs['off']['steps']} steps")
    for mode in ("off", "on"):
        r = runs[mode]
        check(r["capture_syncs"] == r["graphs"] > 0, f"{tag} {mode}: "
              f"{r['capture_syncs']} synchronizes inside {r['graphs']} "
              f"captures")
    ops.reset_launch_counts()
    stats = train_rgnn.train(**dict(TRAIN, model="rgat"),
                             eval_every_epochs=0, device="cuda",
                             trace_out=str(trace), profile=True,
                             log=lambda m: None)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for name in STEP_LAUNCHES["rgat"]:
        check(launches[name] > 0, f"{tag}: {name} never launched")
    doc = json.loads(trace.read_text())
    errs = schema.validate_trace(doc) + schema.require_phases(
        doc, ["train_step", "sample", "layout", "execute"])
    check(errs == [], f"{tag}: trace {errs}")
    steps = sum(e["ph"] == "X" and e["name"] == "train_step"
                for e in doc["traceEvents"])
    hist = snapshot_histogram(stats["metrics"], "train_step_ms")
    check(steps == stats["steps"] == hist["count"], f"{tag}: {steps} "
          f"train_step spans, {hist['count']} train_step_ms observations, "
          f"{stats['steps']} steps")
    runs["traced"] = dict(losses=stats["losses"],
                          step_ms_p50=stats["step_ms_p50"],
                          retraces=stats["retraces_after_warmup"])
    firsts = {m: r["losses"][0] for m, r in runs.items()}
    for m in ("on", "traced"):
        diff = [i for i, (a, b) in enumerate(zip(runs[m]["losses"],
                                                 runs["off"]["losses"]))
                if a != b]
        check(len(runs[m]["losses"]) == len(runs["off"]["losses"])
              and not diff, f"{tag}: losses with obs {m} differ from obs "
              f"off at steps {diff[:5]}")
    check(len({r["retraces"] for r in runs.values()}) == 1,
          f"{tag}: new signatures after warmup differ off / on / traced")
    spread = max(abs(a - b) for a, b in zip(runs["off"]["losses"],
                                            runs["on"]["losses"]))
    ph = stats["profile"]
    check(set(ph) == {"forward", "backward", "optimizer", "total"}
          and all(v >= 0 for v in ph.values())
          and ph["total"] >= ph["forward"],
          f"phase 13 d: step attribution {ph}")
    p8 = phase8["rgat sampled aifb-b64"]
    log(f"[{tag}] {card}: {steps} train_step spans = {hist['count']} "
        f"train_step_ms observations = {stats['steps']} steps; all "
        f"{stats['steps']} losses bit for bit off = on = traced (first "
        f"{firsts['off']!r}, max abs difference {spread:.3g}); "
        f"{runs['on']['syncs']} torch.cuda.synchronize calls on = off "
        f"outside captures ({runs['on']['steps']} steps), besides "
        f"{runs['on']['capture_syncs']} in the {runs['on']['graphs']} "
        f"captures; "
        f"step p50 ms off {runs['off']['step_ms_p50']:.3f} / on "
        f"{runs['on']['step_ms_p50']:.3f} / traced "
        f"{runs['traced']['step_ms_p50']:.3f}; launches (traced) "
        f"{json.dumps(launches)}")
    log(f"[phase 13 d rgat aifb-b64] {card}: profile_train_step (host "
        f"clock, ms) " + json.dumps({k: round(v, 4) for k, v in ph.items()})
        + "; phase 8 (torch.profiler, device ms by range) "
        + json.dumps({k: round(v, 4)
                      for k, v in p8["range_device_ms"].items()})
        + ", host ms by range " + json.dumps(
            {k: round(v, 4) for k, v in p8["range_host_ms"].items()})
        + f", step {p8['step_ms']:.3f} ms under the profiler")
    return dict(steps=stats["steps"], spans=steps,
                step_ms_p50={m: r["step_ms_p50"] for m, r in runs.items()},
                syncs={m: r.get("syncs") for m, r in runs.items()},
                capture_syncs={m: r.get("capture_syncs")
                               for m, r in runs.items()},
                first_loss=firsts["off"], loss_max_abs_diff=spread,
                profile_ms=ph,
                phase8_range_device_ms=p8["range_device_ms"],
                phase8_range_host_ms=p8["range_host_ms"],
                phases=stats["phases"], launches=launches)


def phase_obs(torch, hector_torch, ops, serve_rgnn, train_rgnn, phase8,
              tuning, card):
    """Phase 13: (a) RGAT aifb-b32 served with obs off / on / traced, (b)
    the same with ``sampler="device"``, (c) the per-op profile of the last
    batch at aifb-b32 (the traced run of (a)) and bgs-b1024, (d) and (e)
    traced training with the step attribution; (e) also reads phase 11's
    tuned runs (obs on): their ``tune_*`` counters equal the tuner's
    counts (``tune_mirror`` checked them there)."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = pathlib.Path(tmp)
        out["serve"] = obs_serve(torch, hector_torch, ops, serve_rgnn,
                                 SERVE_DEFAULTS, "phase 13 a rgat aifb",
                                 trace_dir, card)
        out["device_serve"] = obs_serve(
            torch, hector_torch, ops, serve_rgnn,
            dict(SERVE_DEFAULTS, sampler="device"),
            "phase 13 b rgat aifb device", trace_dir, card)
        out["bgs_profile"] = obs_profile_bgs(torch, hector_torch, ops,
                                             serve_rgnn, card)
        out["train"] = obs_train(torch, ops, train_rgnn, trace_dir, phase8,
                                 card)
    out["tune_mirror"] = {k: tuning[k]["obs_mirror"]
                          for k in ("train", "serve")}
    log(f"[phase 13 e tune] tune_* counters = the tuner's counts in phase "
        f"11's runs: " + json.dumps(out["tune_mirror"]))
    return out


# ---------------------------------------------------------------------------
# phase 14: loader caches and captured executors
# ---------------------------------------------------------------------------
# repeating traffic with both loader caches on (the reference driver's
# --repeat-after 4 --cache-blocks 64 --cache-layouts 256)
REPEAT = dict(repeat_after=4, cache_blocks=64, cache_layouts=256,
              num_batches=12)
CAPTURE_MODELS = ("rgat", "rgcn", "hgt")
FRESH_BATCHES = 16
STRESS_CAPTURES = 200
BGS_STEPS = 5


def cache_counters(snap, name):
    """``(hits, misses)`` of the loader cache ``name`` in a metrics
    snapshot."""
    def total(counter):
        return sum(it["value"] for it in snap.get("counters", ())
                   if it["name"] == counter
                   and it["labels"].get("cache") == name)
    return total("loader_cache_hits"), total("loader_cache_misses")


def kernels_run(torch, prof):
    """``{wrapper name: calls}`` of every ported kernel the card ran in a
    ``torch.profiler`` session, counted from the trace (the kernels of
    replayed graphs included); fails if a count is not a whole number of
    calls."""
    raw = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, meta in KERNELS.items():
            if meta["symbol"] in e.key:
                raw[name] = raw.get(name, 0) + e.count
    out = {}
    for name, n in raw.items():
        per_call = KERNELS[name].get("per_call", 1)
        check(n % per_call == 0, f"{name}: {n} kernels traced, not a "
              f"multiple of {per_call} a call")
        out[name] = n // per_call
    return out


def captured_against_eager(torch, ops, serve_rgnn, cfg, tag, card):
    """Phase 14 (a) / (c): ``cfg`` served with the drivers' default
    (captured), with ``compiled=False`` (its launches counted by the
    wrappers from 0: every kernel it runs goes through one) and captured
    again under ``torch.profiler``: every batch's logits bitwise equal
    across the three, the kernels the card ran in the profiled captured
    run (replays included) equal to the op-by-op run's launches, no new
    key after warmup, one graph per key (every key repeats), every
    repeated key served by a replay, and the registry's loader-cache
    counters equal to ``cache_stats``. Prints the latency p50 over every
    batch and over the third pass on (the steady state: replays, and
    block-cache hits both ways)."""
    from torch.profiler import ProfilerActivity, profile

    runs = {}
    for mode in ("captured", "eager", "profiled"):
        logits = []
        ops.reset_launch_counts()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if mode == "profiled" else contextlib.nullcontext()) as prof:
            stats = serve_rgnn.serve(
                **cfg, device="cuda", compiled=mode != "eager",
                log=lambda m: None,
                on_batch=lambda mb, y: logits.append(y.detach().clone()))
            torch.cuda.synchronize()
        runs[mode] = dict(stats=stats, logits=logits,
                          launches=ops.launch_counts())
        if prof is not None:
            runs[mode]["ran"] = kernels_run(torch, prof)
    cap, eag, prof_run = runs["captured"], runs["eager"], runs["profiled"]
    n = cfg["num_batches"]
    check(len(cap["logits"]) == len(eag["logits"])
          == len(prof_run["logits"]) == n, f"{tag}: batches missing")
    for i, (a, b, c) in enumerate(zip(cap["logits"], eag["logits"],
                                      prof_run["logits"])):
        check(bool(torch.equal(a, b) and torch.equal(c, b)),
              f"{tag}: batch {i} logits differ captured / op by op / "
              f"profiled (max abs {float((a - b).abs().max()):.3g})")
    launched = {k: v for k, v in eag["launches"].items() if v}
    check(prof_run["ran"] == launched, f"{tag}: kernels run captured "
          f"(profiler) {prof_run['ran']} / launched op by op {launched}")
    for name in FORWARD_LAUNCHES[cfg["model"]]:
        check(launched.get(name, 0) > 0, f"{tag}: {name} never launched")
    for mode, r in runs.items():
        st = r["stats"]
        check(st["retraces_after_warmup"] == 0, f"{tag} {mode}: "
              f"{st['retraces_after_warmup']} new keys after warmup")
        for name in ("block_cache", "layout_cache"):
            if f"{name}_hits" not in st:
                continue
            got = cache_counters(st["metrics"], name)
            want = (st[f"{name}_hits"], st[f"{name}_misses"])
            check(got == want, f"{tag} {mode}: {name} counters {got}, "
                  f"cache_stats {want}")
        if mode != "eager":
            check(st["executor_captures"] == st["executor_compiled"] > 0
                  and st["executor_replays"] == st["executor_cache_hits"],
                  f"{tag} {mode}: {st['executor_captures']} graphs, "
                  f"{st['executor_replays']} replays for "
                  f"{st['executor_compiled']} keys, "
                  f"{st['executor_cache_hits']} repeats")
    st = cap["stats"]
    check(st["block_cache_hits"] == n - cfg["repeat_after"],
          f"{tag}: {st['block_cache_hits']} block-cache hits")
    p50 = {m: r["stats"]["latency_ms_p50"] for m, r in runs.items()}
    # from the third pass on: replays captured, cache hits both ways
    steady = {m: statistics.median(r["stats"]["batch_latency_ms"][
        2 * cfg["repeat_after"]:]) for m, r in runs.items()}
    log(f"[{tag}] {card}: logits of all {n} batches bitwise equal "
        f"captured / op by op / captured under the profiler; kernels run "
        f"captured (profiler, replays included) = launched op by op "
        f"{json.dumps(launched)}; "
        f"{st['executor_compiled']} keys = {st['executor_captures']} "
        f"graphs, {st['executor_replays']} replays, 0 new after warmup; "
        f"block cache {st['block_cache_hits']} hits / "
        f"{st['block_cache_misses']} misses"
        + (f", layout cache {st['layout_cache_hits']} / "
           f"{st['layout_cache_misses']}" if "layout_cache_hits" in st
           else "")
        + f" (counters = cache_stats); latency p50 ms captured "
        f"{p50['captured']:.3f} / op by op {p50['eager']:.3f}, from batch "
        f"{2 * cfg['repeat_after']} on {steady['captured']:.3f} / "
        f"{steady['eager']:.3f}; compute mean ms "
        f"{st['compute_ms_mean']:.3f} / "
        f"{eag['stats']['compute_ms_mean']:.3f} (the captures included)")
    keys = ("latency_ms_p50", "latency_ms_p95", "compute_ms_mean",
            "wait_ms_mean", "seeds_per_s", "executor_compiled",
            "executor_captures", "executor_replays", "block_cache_hits",
            "block_cache_misses", "layout_cache_hits", "layout_cache_misses")
    out = {m: {k: r["stats"].get(k) for k in keys}
           | {"launches": r["launches"], "steady_latency_ms_p50": steady[m]}
           for m, r in runs.items()}
    out["profiled"]["kernels_run"] = prof_run["ran"]
    return out


def fresh_signatures(torch, serve_rgnn, card):
    """Phase 14 (b): RGAT aifb-b32 over 16 fresh batches: the executor
    counts exactly one key per distinct shape signature and captures one
    graph per signature that comes again."""
    from repro_torch.core import executor

    sigs = []

    def keep(mb, _):
        sigs.append(executor.signature(
            (mb.tensors, mb.layouts, mb.dst_locals, mb.seed_perm,
             mb.input_ids)))

    stats = serve_rgnn.serve(**dict(SERVE_DEFAULTS,
                                    num_batches=FRESH_BATCHES),
                             device="cuda", on_batch=keep,
                             log=lambda m: None)
    torch.cuda.synchronize()
    seen = {}
    for sig in sigs:
        seen[sig] = seen.get(sig, 0) + 1
    distinct = len(seen)
    repeated = sum(1 for c in seen.values() if c > 1)
    check(stats["executor_compiled"] == distinct
          and stats["executor_captures"] == repeated,
          f"phase 14 b: {stats['executor_compiled']} keys, "
          f"{stats['executor_captures']} graphs for {distinct} distinct "
          f"shape signatures, {repeated} of them repeated")
    log(f"[phase 14 b rgat aifb] {card}: {FRESH_BATCHES} fresh batches, "
        f"{distinct} distinct shape signatures ({repeated} repeated), "
        f"executor_compiled {stats['executor_compiled']}, graphs captured "
        f"{stats['executor_captures']}; latency p50 "
        f"{stats['latency_ms_p50']:.3f} ms")
    return dict(batches=FRESH_BATCHES, distinct_signatures=distinct,
                repeated_signatures=repeated,
                executor_compiled=stats["executor_compiled"],
                captures=stats["executor_captures"],
                latency_ms_p50=stats["latency_ms_p50"])


def states_equal(torch, tag, a, b, what="captured / op by op"):
    """Params and moments of two train states bit for bit (the backward
    runs in a fixed order on the card: K11 and K7, no float atomics)."""
    from repro_torch.optim.adamw import tree_leaves

    for part in ("params", "mu", "nu"):
        for x, y in zip(tree_leaves(getattr(a, part)),
                        tree_leaves(getattr(b, part)), strict=True):
            check(bool(torch.equal(x, y)), f"{tag}: {part} {what} differ "
                  f"(max abs {float((x - y).abs().max()):.3g})")


def losses_equal(tag, a, b, what="captured / op by op"):
    """Every loss of two runs bit for bit."""
    check(len(a) == len(b), f"{tag}: {len(a)} / {len(b)} steps")
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    check(not diff, f"{tag}: losses {what} differ at steps {diff[:5]} "
          f"(first: {a[diff[0]]!r} / {b[diff[0]]!r})" if diff else "")


def paired_steps(torch, tag, step, batches, state):
    """Run ``step(state, batch, compiled)`` over ``batches``, captured,
    and beside every step an op-by-op step from a copy of the same input
    state: each loss, the new params and the moments bit for bit. Returns
    the captured state, the losses, both step times and the state
    buffers' pointers per step."""
    from repro_torch.optim.adamw import tree_leaves, tree_map

    losses, ptrs = [], []
    ms = {"captured": [], "eager": []}
    for i, batch in enumerate(batches):
        before = tree_map(torch.clone, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m_c = step(state, batch, True)
        loss = float(m_c["loss"])
        ms["captured"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        want, m_e = step(before, batch, False)
        loss_e = float(m_e["loss"])
        ms["eager"].append((time.perf_counter() - t0) * 1e3)
        check(loss == loss_e, f"{tag}: step {i} loss {loss!r} captured, "
              f"{loss_e!r} op by op from the same state")
        states_equal(torch, f"{tag} step {i}", state, want)
        losses.append(loss)
        ptrs.append([t.data_ptr() for t in tree_leaves(state)])
    return state, losses, ms, ptrs


def captured_training(torch, train_rgnn, card):
    """Phase 14 (d): captured training against op by op. RGAT aifb-b64 for
    one epoch, twice: through ``SampledTrainer`` (captured and
    ``compiled=False`` from the same initial state: every loss and the
    final params and moments bit for bit, zero new keys after warmup,
    every repeated key served by a replay), and step by step
    (``paired_steps``: every captured step against an op-by-op step from
    the same state, bit for bit). RGAT bgs full-graph
    (``FullGraphTrainer``) for 5 steps with ``paired_steps``; the captured
    step returns the same state buffers from its first replay on."""
    import dataclasses

    import numpy as np

    from repro_torch.core import executor
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.sampling import EpochSeedStream
    from repro_torch.train import (EngineConfig, FullGraphTrainer,
                                   SampledTrainer)

    out = {}
    cfg = TRAIN
    ecfg = EngineConfig(model="rgat", layers=cfg["layers"], dim=cfg["dim"],
                        hidden=cfg["hidden"], classes=cfg["classes"],
                        fanouts=cfg["fanouts"], tile=cfg["tile"],
                        node_block=cfg["node_block"], seed=cfg["seed"],
                        device="cuda")
    engine, feats, labels, train_ids, val_ids = train_rgnn.build_task(
        cfg["dataset"], cfg["scale"], ecfg, cfg["seed"])
    bpe = EpochSeedStream(train_ids, cfg["batch_size"]).batches_per_epoch

    def opt():
        return AdamW(learning_rate=cosine_schedule(cfg["lr"], 5, bpe),
                     weight_decay=0.0)

    runs = {}
    for mode in ("captured", "eager"):
        tr = SampledTrainer(engine, feats, labels, train_ids, val_ids,
                            opt=opt(), compiled=mode == "captured",
                            log=None)
        state = tr.init_state(engine.init(cfg["seed"]))
        state, st = tr.train(state, epochs=1, batch_size=cfg["batch_size"])
        torch.cuda.synchronize()
        runs[mode] = dict(state=state, stats=st,
                          captures=tr.step_exec.captures,
                          replays=tr.step_exec.replays)
    cap, eag = runs["captured"], runs["eager"]
    tag = "phase 14 d rgat aifb-b64"
    losses_equal(tag, cap["stats"]["losses"], eag["stats"]["losses"])
    states_equal(torch, tag, cap["state"], eag["state"],
                 "of the captured and the op-by-op epoch")
    st = cap["stats"]
    check(st["retraces_after_warmup"] == 0
          and cap["replays"] == st["executor_cache_hits"]
          and 0 < cap["captures"] <= st["executor_compiled"],
          f"{tag}: {cap['captures']} graphs, {cap['replays']} replays, "
          f"{st['executor_compiled']} keys, {st['executor_cache_hits']} "
          f"repeats")
    p50 = {m: r["stats"]["step_ms_p50"] for m, r in runs.items()}
    log(f"[{tag}] {card}: SampledTrainer, captured = op by op: all "
        f"{st['steps']} losses (first {st['losses'][0]!r}, last "
        f"{st['losses'][-1]!r}) and the final params, mu and nu bit for bit;"
        f" step p50 ms op by op {p50['eager']:.3f} / captured "
        f"{p50['captured']:.3f}, p99 {eag['stats']['step_ms_p99']:.3f} / "
        f"{st['step_ms_p99']:.3f}; {st['executor_compiled']} keys, "
        f"{cap['captures']} graphs, {cap['replays']} replays, 0 new after "
        f"warmup")
    out["aifb_b64"] = {m: dict(
        step_ms_p50=r["stats"]["step_ms_p50"],
        step_ms_p99=r["stats"]["step_ms_p99"],
        seeds_per_s=r["stats"]["seeds_per_s"],
        executor_compiled=r["stats"]["executor_compiled"],
        captures=r["captures"]) for m, r in runs.items()}
    out["aifb_b64"].update(bitwise=True)

    loader = engine.make_loader(EpochSeedStream(
        train_ids, cfg["batch_size"], seed=cfg["seed"]), num_batches=bpe)
    try:
        batches = [(mb, torch.from_numpy(mb.seq.slice_labels(labels))
                    .cuda()) for mb in loader]
    finally:
        loader.close()
    x = torch.from_numpy(feats).cuda()
    ex_c = executor.BlockTrainExecutor(engine.plans, opt(),
                                       decisions=engine.decisions)
    ex_e = executor.BlockTrainExecutor(engine.plans, ex_c.opt,
                                       decisions=engine.decisions)

    def sampled_step(state, batch, compiled):
        mb, lab = batch
        ex = ex_c if compiled else ex_e
        return ex.grad_and_update(state, mb, lab,
                                  {"feature": x[mb.input_ids.long()]},
                                  compiled=compiled)

    _, losses, ms, _ = paired_steps(
        torch, tag, sampled_step, batches,
        ex_c.opt.init(engine.init(cfg["seed"])))
    log(f"[{tag}] {card}: step by step, each of {len(losses)} captured "
        f"steps against an op-by-op step from the same state: losses, "
        f"params, mu and nu bit for bit; {ex_c.captures} graphs; step p50 "
        f"ms captured "
        f"{np.median(ms['captured']):.3f} / op by op "
        f"{np.median(ms['eager']):.3f}")
    out["aifb_b64"]["paired"] = dict(
        steps=len(losses),
        step_ms_p50={k: float(np.median(v)) for k, v in ms.items()})

    tag = "phase 14 d rgat bgs full-graph"
    bcfg = dataclasses.replace(ecfg, device="cuda")
    engine, feats, labels, train_ids, _ = train_rgnn.build_task(
        "bgs", 1.0, bcfg, cfg["seed"])
    fg = {c: FullGraphTrainer(engine, feats, labels, train_ids, opt=opt(),
                              compiled=c, log=None) for c in (True, False)}

    def full_step(state, _, compiled):
        return fg[compiled].step(state)

    state, losses, ms, ptrs = paired_steps(
        torch, tag, full_step, range(BGS_STEPS),
        fg[True].init_state(engine.init(cfg["seed"])))
    check(fg[True].step_exec.captures == 1
          and all(p == ptrs[1] for p in ptrs[1:]),
          f"{tag}: the captured step does not return its state buffers")
    after = {k: float(np.median(v[2:])) for k, v in ms.items()}
    log(f"[{tag}] {card}: {BGS_STEPS} captured steps, each against an "
        f"op-by-op step from the same state: losses {losses}, params, mu "
        f"and nu bit for bit; one graph, the same state buffers from its "
        f"first replay on; "
        f"step ms op by op {[round(v, 3) for v in ms['eager']]}, captured "
        f"{[round(v, 3) for v in ms['captured']]} (the first runs op by "
        f"op, the second captures); median after the second "
        f"{after['eager']:.3f} / {after['captured']:.3f}")
    out["bgs_full_graph"] = dict(losses=losses, step_ms=ms,
                                 step_ms_median_after_second=after)
    return out


REPEAT_EPOCH_MODELS = ("rgat", "hgt")
REPEAT_BGS_MODELS = ("rgat", "rgcn", "hgt")


def repeatability(torch, train_rgnn, card):
    """Phase 14 (g): two identical runs give bit-equal final params (and
    moments, and every loss): an RGAT and an HGT aifb-b64 epoch through
    ``SampledTrainer`` at its captured default, and ``BGS_STEPS``
    full-graph steps of RGAT, RGCN and HGT over bgs, each run twice from
    the same initial weights with a fresh optimizer and trainer."""
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.optim.adamw import tree_map
    from repro_torch.sampling import EpochSeedStream
    from repro_torch.train import (EngineConfig, FullGraphTrainer,
                                   SampledTrainer)

    cfg = TRAIN
    out = {}

    def ecfg(model):
        return EngineConfig(model=model, layers=cfg["layers"],
                            dim=cfg["dim"], hidden=cfg["hidden"],
                            classes=cfg["classes"], fanouts=cfg["fanouts"],
                            tile=cfg["tile"], node_block=cfg["node_block"],
                            seed=cfg["seed"], device="cuda")

    for model in REPEAT_EPOCH_MODELS:
        engine, feats, labels, train_ids, val_ids = train_rgnn.build_task(
            cfg["dataset"], cfg["scale"], ecfg(model), cfg["seed"])
        bpe = EpochSeedStream(train_ids, cfg["batch_size"]).batches_per_epoch
        runs = []
        for _ in range(2):
            tr = SampledTrainer(engine, feats, labels, train_ids, val_ids,
                                opt=AdamW(learning_rate=cosine_schedule(
                                    cfg["lr"], 5, bpe), weight_decay=0.0),
                                log=None)
            state, st = tr.train(tr.init_state(engine.init(cfg["seed"])),
                                 epochs=1, batch_size=cfg["batch_size"])
            torch.cuda.synchronize()
            runs.append((tree_map(torch.clone, state), st["losses"]))
        tag = f"phase 14 g {model} aifb-b64"
        losses_equal(tag, runs[0][1], runs[1][1], "of two runs")
        states_equal(torch, tag, runs[0][0], runs[1][0], "of two runs")
        log(f"[{tag}] {card}: two captured epochs from the same weights: "
            f"all {len(runs[0][1])} losses (last {runs[0][1][-1]!r}) and "
            f"the final params, mu and nu bit for bit")
        out[f"{model} aifb-b64"] = dict(steps=len(runs[0][1]),
                                        final_loss=runs[0][1][-1])
    for model in REPEAT_BGS_MODELS:
        engine, feats, labels, train_ids, _ = train_rgnn.build_task(
            "bgs", 1.0, ecfg(model), cfg["seed"])
        runs = []
        for _ in range(2):
            fg = FullGraphTrainer(engine, feats, labels, train_ids,
                                  opt=AdamW(learning_rate=cosine_schedule(
                                      cfg["lr"], 5, BGS_STEPS),
                                      weight_decay=0.0), log=None)
            state = fg.init_state(engine.init(cfg["seed"]))
            losses = []
            for _ in range(BGS_STEPS):
                state, m = fg.step(state)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            runs.append((tree_map(torch.clone, state), losses))
        tag = f"phase 14 g {model} bgs full-graph"
        losses_equal(tag, runs[0][1], runs[1][1], "of two runs")
        states_equal(torch, tag, runs[0][0], runs[1][0], "of two runs")
        log(f"[{tag}] {card}: two runs of {BGS_STEPS} captured steps from "
            f"the same weights: losses {runs[0][1]} and the final params, "
            f"mu and nu bit for bit")
        out[f"{model} bgs"] = dict(losses=runs[0][1])
    return out


def k5_counter_growth(torch, SK, L, ops, card):
    """Phase 14 (e): K5 captured in a graph at the counter buffer's size,
    replayed, then launched op by op with one more group (the buffer
    grows into a new one), then replayed again: both replays equal the
    plain version and a launch outside the graph bit for bit, and the
    captured (outgrown) buffer reads zero after each."""
    import gc

    import numpy as np

    # the wrappers key the buffers by the tensors' device, index included
    dev = torch.device("cuda", torch.cuda.current_device())
    SK._outer_counters(dev, 1)
    have = SK._counters[dev].numel()
    rng = np.random.default_rng(14)

    def inputs(groups):
        sizes = rng.integers(1, 40, groups)
        ps = L.pad_segments(np.concatenate([[0], np.cumsum(sizes)]), 32)
        lay = ops.padded_segments_dev(ps).to(dev)
        x = torch.from_numpy(rng.normal(size=(ps.padded_rows, 64))
                             .astype(np.float32)).to(dev)
        x[torch.from_numpy(ps.row_map < 0).to(dev)] = 0.0
        dy = torch.from_numpy(rng.normal(size=(ps.padded_rows, 64))
                              .astype(np.float32)).to(dev)
        kw = dict(num_groups=groups, num_chunks=lay.num_chunks, tile=32,
                  chunk_tiles=lay.chunk_tiles)
        return (x, dy, lay.group_tile_ptr, lay.group_chunk_ptr), kw

    args, kw = inputs(have)           # 64 x 64: one counter per group
    want = SK.segment_outer_padded(*args, **kw)
    plain = SK.segment_outer_padded_plain(*(a.cpu() for a in args), **kw)
    captured_buf = SK._counters[dev]
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = SK.segment_outer_padded(*args, **kw)
    finally:
        gc.enable()

    def replay(when):
        graph.replay()
        torch.cuda.synchronize()
        check(bool(torch.equal(out, want)), f"phase 14 e: K5 replayed "
              f"{when} differs from a launch outside the graph")
        err = float((out.cpu() - plain).abs().max())
        check(bool(torch.allclose(out.cpu(), plain, rtol=TOLERANCE[K5],
                                  atol=TOLERANCE[K5])),
              f"phase 14 e: K5 replayed {when} differs from its plain "
              f"version (max abs err {err:.3g})")
        check(not bool(captured_buf.any()), f"phase 14 e: the captured "
              f"counters are not zero after the replay {when}")
        return err

    err = replay("before the growth")
    bigger, kw2 = inputs(have + 1)
    SK.segment_outer_padded(*bigger, **kw2)
    grown = SK._counters[dev].numel()
    check(grown > have and SK._counters[dev] is not captured_buf,
          f"phase 14 e: the counter buffer did not grow ({have} -> "
          f"{grown})")
    # reuse the freed sizes: a freed buffer would now hold these values
    junk = [torch.full((have,), 7, dtype=torch.int32, device=dev)
            for _ in range(4)]
    err = max(err, replay("after the growth"))
    del junk
    log(f"[phase 14 e] {card}: K5 replayed before and after its counters "
        f"grew from {have} to {grown} ({have + 1} groups op by op in "
        f"between): equal to the plain version (max abs err {err:.3g}) and "
        f"to a launch outside the graph bit for bit; the captured counters "
        f"stay zero")
    return dict(counters_before=have, counters_after=grown,
                max_abs_err=err)


class Drain:
    """A host loader whose producer thread builds and copies bgs-b1024
    batches the whole time: a thread takes every batch and drops it."""

    def __init__(self, engine, seed):
        import threading

        from repro_torch.sampling import SeedStream

        self.loader = engine.make_loader(SeedStream(
            engine.graph.num_nodes, SERVE_LARGE["batch_size"], seed=seed))
        self.batches = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for _ in self.loader:
            self.batches += 1
            if self._stop.is_set():
                return

    def close(self):
        self._stop.set()
        self._thread.join(timeout=60)
        self.loader.close()


class Cycle:
    """Holds an executor in a reference cycle: once dropped, only the
    cyclic collector frees it (and its graphs)."""

    def __init__(self, ex):
        self.ex = ex
        self.me = self


def stress(torch, hector_torch, ops, card):
    """Phase 14 (f): 200 captures of the aifb-b64 train step (over an
    epoch's batches) and 200 of the bgs-b1024 served forward (over 8
    batches), each by a new executor — a fresh key, called twice: op by
    op, then captured and replayed — held in a reference cycle and
    dropped after, beside a host loader (``Drain``) whose producer builds
    and copies bgs-b1024 batches the whole time. Every capture starts
    with the last executors' graphs unreachable in cycles. A collection
    is forced before every capture (``gc.collect(1)``, the young
    generations the last executors sit in, and a full ``gc.collect()``
    before every 50th), and the collector's own collections run as they
    come; all are counted. Every replay equals its first (op-by-op) call
    bit for bit; no collection runs while a stream captures. Run twice in
    this process."""
    import gc

    import numpy as np

    from repro_torch.core import executor
    from repro_torch.core.graph import table3_graph
    from repro_torch.launch import train_rgnn
    from repro_torch.optim import AdamW
    from repro_torch.sampling import EpochSeedStream, SeedStream
    from repro_torch.train import EngineConfig

    cfg = TRAIN
    ecfg = EngineConfig(model="rgat", layers=cfg["layers"], dim=cfg["dim"],
                        hidden=cfg["hidden"], classes=cfg["classes"],
                        fanouts=cfg["fanouts"], tile=cfg["tile"],
                        node_block=cfg["node_block"], seed=cfg["seed"],
                        device="cuda")
    engine, feats_np, labels, train_ids, _ = train_rgnn.build_task(
        cfg["dataset"], cfg["scale"], ecfg, cfg["seed"])
    x = torch.from_numpy(feats_np).cuda()
    opt = AdamW(learning_rate=cfg["lr"], weight_decay=0.0)
    state0 = opt.init(engine.init(cfg["seed"]))
    loader = engine.make_loader(EpochSeedStream(
        train_ids, cfg["batch_size"], seed=1), num_batches=None)
    try:
        steps = [next(loader) for _ in range(64)]
    finally:
        loader.close()
    steps = [(mb, torch.from_numpy(mb.seq.slice_labels(labels)).cuda(),
              {"feature": x[mb.input_ids.long()]}) for mb in steps]

    scfg = SERVE_LARGE
    sgraph = table3_graph(scfg["dataset"], scfg["scale"], scfg["seed"])
    serve_engine = hector_torch.compile(
        scfg["model"], sgraph, layers=scfg["layers"], dim=scfg["dim"],
        hidden=scfg["hidden"], classes=scfg["classes"],
        sample=scfg["fanouts"], tile=scfg["tile"],
        node_block=scfg["node_block"], seed=scfg["seed"], device="cuda")
    sparams = serve_engine.init(scfg["seed"])
    sx = torch.from_numpy(np.random.default_rng(scfg["seed"]).normal(
        size=(sgraph.num_nodes, scfg["dim"])).astype(np.float32)).cuda()
    loader = serve_engine.make_loader(SeedStream(
        sgraph.num_nodes, scfg["batch_size"], seed=100), num_batches=8)
    try:
        served = list(loader)
    finally:
        loader.close()

    collections = dict(all=0, capturing=0)

    def counted(phase, info):
        if phase == "start":
            collections["all"] += 1
            collections["capturing"] += \
                torch.cuda.is_current_stream_capturing()

    def collect(i):
        gc.collect(2 if i % 50 == 0 else 1)

    def train_capture(i):
        mb, lab, f = steps[i % len(steps)]
        held = Cycle(executor.BlockTrainExecutor(
            engine.plans, opt, decisions=engine.decisions))
        _, m1 = held.ex.grad_and_update(state0, mb, lab, f)
        collect(i)
        _, m2 = held.ex.grad_and_update(state0, mb, lab, f)
        return held, m1["loss"], m2["loss"]

    def serve_capture(i):
        mb = served[i % len(served)]
        held = Cycle(executor.BlockExecutor(
            serve_engine.plans, decisions=serve_engine.decisions))
        y1 = held.ex.run_minibatch(sparams, mb, sx)
        collect(i)
        y2 = held.ex.run_minibatch(sparams, mb, sx)
        return held, y1, y2

    out = []
    gc.callbacks.append(counted)
    try:
        for run in (1, 2):
            drain = Drain(serve_engine, 200 + run)
            before = dict(collections)
            secs = {}
            try:
                for what, fn in (("aifb-b64 step", train_capture),
                                 ("bgs-b1024 serve", serve_capture)):
                    t0 = time.perf_counter()
                    for i in range(STRESS_CAPTURES):
                        held, a, b = fn(i)
                        check(held.ex.captures == 1
                              and held.ex.replays == 1,
                              f"phase 14 f: {what} was not captured")
                        check(bool(torch.equal(a, b)), f"phase 14 f run "
                              f"{run}: {what} capture {i}: the replay "
                              f"differs from the first call")
                        del held, a, b
                    torch.cuda.synchronize()
                    secs[what] = time.perf_counter() - t0
            finally:
                drain.close()
            n_all = collections["all"] - before["all"]
            n_cap = collections["capturing"] - before["capturing"]
            check(n_cap == 0, f"phase 14 f run {run}: {n_cap} collections "
                  f"while a stream captured")
            check(drain.batches > 0, f"phase 14 f run {run}: the drained "
                  f"loader built no batch")
            log(f"[phase 14 f run {run}] {card}: {STRESS_CAPTURES} captures "
                f"each of the aifb-b64 step and the bgs-b1024 forward, each "
                f"by a new executor in a reference cycle, a collection "
                f"forced before each, every replay equal to its first "
                f"call bit for bit; "
                f"{drain.batches} bgs-b1024 batches built and copied by a "
                f"host loader meanwhile; {n_all} collections ({n_cap} "
                f"while a stream captured); seconds "
                + json.dumps({k: round(v, 2) for k, v in secs.items()}))
            out.append(dict(captures=2 * STRESS_CAPTURES, seconds=secs,
                            collections=n_all,
                            collections_in_capture=n_cap,
                            drained_batches=drain.batches))
    finally:
        gc.callbacks.remove(counted)
    return out


def phase_capture(torch, hector_torch, SK, L, ops, serve_rgnn, train_rgnn,
                  card):
    """Phase 14: (a) RGAT, RGCN, HGT aifb-b32 served with repeating
    traffic and both loader caches, captured against op by op; (b) RGAT
    aifb-b32 over fresh batches, one graph per distinct signature; (c) (a)
    device-sampled; (d) captured training against op by op; (e) K5's
    counters outgrown under a captured graph; (f) the capture stress run,
    twice; (g) two identical training runs bit for bit."""
    out = {"serve": {}, "device_serve": {}}
    for model in CAPTURE_MODELS:
        cfg = dict(SERVE_DEFAULTS, model=model, **REPEAT)
        out["serve"][model] = captured_against_eager(
            torch, ops, serve_rgnn, cfg, f"phase 14 a {model} aifb", card)
    out["fresh"] = fresh_signatures(torch, serve_rgnn, card)
    for model in CAPTURE_MODELS:
        cfg = dict(SERVE_DEFAULTS, model=model, sampler="device", **REPEAT)
        out["device_serve"][model] = captured_against_eager(
            torch, ops, serve_rgnn, cfg, f"phase 14 c {model} aifb device",
            card)
    out["train"] = captured_training(torch, train_rgnn, card)
    out["k5"] = k5_counter_growth(torch, SK, L, ops, card)
    out["stress"] = stress(torch, hector_torch, ops, card)
    out["repeat"] = repeatability(torch, train_rgnn, card)
    return out


# ---------------------------------------------------------------------------
# phase 15: the feature store (``--feature-store``)
# ---------------------------------------------------------------------------
# bgs-b1024 over a Zipf stream (the cached tier sees reuse), 6 batches
FEATURE_SERVE = dict(SERVE_LARGE, num_batches=6, skew=1.2)
FEATURE_TIERS = ("device", "host", "cached")
# a cache of 512 rows overflows: a bgs-b1024 batch reads tens of thousands
FEATURE_OVERFLOW_BUDGET = 512
# the caching allocator rounds a block up to 512 bytes, and a block it does
# not split off a larger segment up to the segment's size: a multiple of 2
# MiB above 10 MiB (``memory_allocated`` counts the rounded blocks)
ALLOC_ROUND = 2 << 20


def _requested(torch) -> int:
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


@contextlib.contextmanager
def store_builds(torch, builds):
    """While active, ``RGNNEngine.make_feature_store`` appends ``(store,
    requested, allocated)`` to ``builds``: the device bytes the store's
    build asked the caching allocator for (``requested_bytes``) and the
    bytes it allocated (``torch.cuda.memory_allocated()``, its rounded
    blocks), each after minus before, read after a synchronize."""
    from repro_torch.train.engine import RGNNEngine

    orig = RGNNEngine.make_feature_store

    def build(self, feats, **kw):
        torch.cuda.synchronize()
        req, alloc = _requested(torch), torch.cuda.memory_allocated()
        store = orig(self, feats, **kw)
        torch.cuda.synchronize()
        builds.append((store, _requested(torch) - req,
                       torch.cuda.memory_allocated() - alloc))
        return store

    RGNNEngine.make_feature_store = build
    try:
        yield builds
    finally:
        RGNNEngine.make_feature_store = orig


@contextlib.contextmanager
def allocation_sizes(torch, sizes):
    """While active, the caching allocator records every allocation
    (``torch.cuda.memory._record_memory_history``, no stacks); on exit
    ``sizes`` gets each one's size in bytes."""
    torch.cuda.memory._record_memory_history(
        enabled="all", context=None, stacks="python", max_entries=4_000_000)
    try:
        yield sizes
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
        sizes.extend(e["size"] for trace in snap["device_traces"]
                     for e in trace if e["action"] == "alloc")
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)


def check_store_alloc(tag, store, req, alloc, want):
    """The store's own device allocation is its ``device_bytes()``,
    ``want``: the bytes its build requested equal it exactly, and the
    bytes allocated are those rounded up by the caching allocator."""
    check(store.device_bytes() == want, f"{tag}: a {store.kind} store "
          f"reports {store.device_bytes()} device bytes, not {want}")
    check(req == want and want <= alloc < want + ALLOC_ROUND
          and (want or not alloc),
          f"{tag}: the store requested {req} and allocated {alloc} device "
          f"bytes; its device_bytes() is {want}")


def feature_serve(torch, ops, serve_rgnn, cfg, tier, tag, budget=None):
    """``serve(**cfg, feature_store=tier)`` on the card, its launches
    counted from 0: the store's own allocation equals its
    ``device_bytes()`` (the table's bytes, 0, or the slab's;
    ``check_store_alloc``), no allocation of the whole table's size is
    made unless the tier is ``device`` (then at least one: the probe sees
    it), every batch's logits finite and of their shape. Returns the
    run."""
    import numpy as np

    batches, builds, sizes = [], [], []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with store_builds(torch, builds), allocation_sizes(torch, sizes):
        stats = serve_rgnn.serve(
            **cfg, device="cuda", feature_store=tier, feature_budget=budget,
            on_batch=lambda mb, y: batches.append(
                (mb.seq, mb.step, y.detach().cpu())),
            log=lambda m: None)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = ops.launch_counts()
    check(len(builds) == 1 and builds[0][0].kind == tier,
          f"{tag}: {len(builds)} feature stores built")
    store, own, alloc = builds[0]
    want = {"device": store.table_bytes, "host": 0,
            "cached": max(getattr(store, "capacity", 0), 1) * store.dim
            * store.itemsize}[tier]
    check_store_alloc(tag, store, own, alloc, want)
    # the allocator's trace records each allocation's requested size
    full = sum(1 for s in sizes if s == store.table_bytes)
    check(full > 0 if tier == "device" else full == 0,
          f"{tag}: {full} allocations of the whole table's size "
          f"({store.table_bytes} bytes) with feature_store={tier}")
    check(len(batches) == cfg["num_batches"], f"{tag}: batches missing")
    for _, step, y in batches:
        check(y.shape == (cfg["batch_size"], cfg["classes"])
              and bool(torch.isfinite(y).all()),
              f"{tag}: batch {step} logits {tuple(y.shape)}, or not finite")
    n = len(batches)
    fs = {k.removeprefix("feature_"): v for k, v in stats.items()
          if k.startswith("feature_")}
    # the device tier's bytes moved are its one upload of the table
    per_batch = (fs["bytes_moved"] - (store.table_bytes if tier == "device"
                                      else 0)) / n
    line = (f"[{tag}] p50 {stats['latency_ms_p50']:.3f} ms, p95 "
            f"{stats['latency_ms_p95']:.3f} ms, wait "
            f"{stats['wait_ms_mean']:.3f} + compute "
            f"{stats['compute_ms_mean']:.3f} ms, "
            f"{stats['seeds_per_s']:.1f} seeds/s; store requested {own} "
            f"device bytes = device_bytes() (allocated {alloc}), {full} "
            f"allocations of the "
            f"table's size in {len(sizes)}; bytes moved "
            f"{fs['bytes_moved']} ({per_batch:.0f} a batch, the table's "
            f"upload apart), "
            f"host gathers {fs['host_gathers']}, peak {peak:.3f} GiB")
    if tier == "cached":
        line += (f"; hits {fs['hits']}, misses {fs['misses']}, evictions "
                 f"{fs['evictions']}, overflows {fs['overflows']}, hit rate "
                 f"{fs['hit_rate']:.4f}, slots per ntype "
                 f"{np.diff(fs['slot_ptr']).tolist()}")
    log(line)
    keys = ("latency_ms_p50", "latency_ms_p95", "wait_ms_mean",
            "compute_ms_mean", "seeds_per_s", "executor_compiled",
            "executor_captures", "executor_replays")
    return dict(stats={k: stats[k] for k in keys}, feature=fs,
                launches=launches, store_requested_bytes=own,
                store_allocated_bytes=alloc,
                table_size_allocs=full, allocs=len(sizes),
                peak_mem_gib=peak, batches=batches)


def same_logits(torch, tag, runs, base):
    """Every batch's logits of every run bit for bit ``base``'s."""
    for name, r in runs.items():
        for (_, step, a), (_, _, b) in zip(r["batches"], base["batches"]):
            check(torch.equal(a, b), f"{tag}: batch {step} logits of "
                  f"{name} differ from the device tier's (max abs "
                  f"{float((a - b).abs().max()):.3g})")


def phase_features(torch, hector_torch, ops, serve_rgnn, train_rgnn, card):
    """Phase 15: the three feature tiers through the drivers at their
    defaults (captured executors, the host loader's producer thread on).
    (a) RGAT and RGCN bgs-b1024 on a Zipf stream, once per tier: every
    batch's logits bit for bit across the tiers and the first batch within
    1e-4 of the CPU run, the kernels launched the device tier's, each
    store's allocation its ``device_bytes()``, no whole-table allocation
    with ``host`` / ``cached``; (b) RGAT with a 512-row cache: overflow,
    logits still the device tier's; (c) device-sampled RGAT aifb-b32 with
    the ``host`` tier against the ``device`` tier, bit for bit; (d) RGAT
    aifb-b64 training for an epoch with the ``cached`` tier against the
    ``device`` tier: every loss bit for bit."""
    out = {}
    for model in ("rgat", "rgcn"):
        cfg = dict(FEATURE_SERVE, model=model)
        runs = {}
        for tier in FEATURE_TIERS:
            runs[tier] = feature_serve(
                torch, ops, serve_rgnn, cfg, tier,
                f"phase 15 a {model} bgs-b1024 {tier}")
        if model == "rgat":
            runs["cached 512"] = feature_serve(
                torch, ops, serve_rgnn, cfg, "cached",
                f"phase 15 b {model} bgs-b1024 cached "
                f"{FEATURE_OVERFLOW_BUDGET} rows",
                budget=FEATURE_OVERFLOW_BUDGET)
            check(runs["cached 512"]["feature"]["overflows"] > 0,
                  f"phase 15 b: no overflow at {FEATURE_OVERFLOW_BUDGET} "
                  f"rows")
        tag = f"phase 15 a {model} bgs-b1024"
        base = runs["device"]
        same_logits(torch, tag, runs, base)
        for name, r in runs.items():
            check(r["launches"] == base["launches"],
                  f"{tag}: {name} launched {r['launches']}, the device "
                  f"tier {base['launches']}")
        for name in FORWARD_LAUNCHES[model]:
            check(base["launches"][name] > 0, f"{tag}: {name} never "
                  f"launched")
        err = compare_with_cpu(torch, hector_torch, cfg,
                               base["batches"][:1], 1e-4, tag)
        log(f"[{tag}] {card}: every batch's logits bit for bit across "
            f"{', '.join(runs)}; kernels launched equal "
            f"{json.dumps({k: v for k, v in base['launches'].items() if v})}"
            f"; batch 0 within {err:.3g} of the CPU run")
        out[model] = {name: {k: v for k, v in r.items() if k != "batches"}
                      | {"cpu_max_abs_err": err} for name, r in runs.items()}

    cfg = dict(SERVE_DEFAULTS, sampler="device")
    runs = {tier: feature_serve(torch, ops, serve_rgnn, cfg, tier,
                                f"phase 15 c rgat aifb-b32 device-sampled "
                                f"{tier}")
            for tier in ("device", "host")}
    same_logits(torch, "phase 15 c rgat aifb-b32 device-sampled", runs,
                runs["device"])
    log(f"[phase 15 c] {card}: device-sampled logits of the host tier bit "
        f"for bit the device tier's over {cfg['num_batches']} batches")
    out["device_sampled"] = {name: {k: v for k, v in r.items()
                                    if k != "batches"}
                             for name, r in runs.items()}
    out["train"] = feature_training(torch, train_rgnn, card)
    return out


def feature_training(torch, train_rgnn, card):
    """Phase 15 (d): RGAT aifb-b64 for one epoch through
    ``train_rgnn.train`` at its default (captured), with the ``device``
    and the ``cached`` tier."""
    runs = {}
    for tier in ("device", "cached"):
        builds = []
        with store_builds(torch, builds):
            st = train_rgnn.train(**TRAIN, device="cuda", feature_store=tier,
                                  log=lambda m: None)
        torch.cuda.synchronize()
        store, req, alloc = builds[0]
        check_store_alloc(f"phase 15 d {tier}", store, req, alloc,
                          store.table_bytes if tier == "device"
                          else store.capacity * store.dim * store.itemsize)
        runs[tier] = st
    tag = "phase 15 d rgat aifb-b64"
    cached, dev = runs["cached"], runs["device"]
    losses_equal(tag, cached["losses"], dev["losses"], "of the cached and "
                 "the device tier")
    check(cached["retraces_after_warmup"] == 0, f"{tag}: "
          f"{cached['retraces_after_warmup']} new keys after warmup")
    log(f"[{tag}] {card}: cached tier against the device tier, "
        f"{len(dev['losses'])} steps: every loss bit for bit (first "
        f"{dev['losses'][0]!r}, last {dev['losses'][-1]!r}); "
        f"step p50 ms {dev['step_ms_p50']:.3f} / {cached['step_ms_p50']:.3f}"
        f", {dev['seeds_per_s']:.1f} / {cached['seeds_per_s']:.1f} seeds/s;"
        f" cache hit rate {cached['feature_hit_rate']:.4f}, "
        f"{cached['feature_bytes_moved']} bytes moved in "
        f"{cached['feature_host_gathers']} host gathers")
    keys = ("step_ms_p50", "step_ms_p99", "seeds_per_s", "final_loss")
    return {t: {k: r[k] for k in keys} | {
        k: v for k, v in r.items() if k.startswith("feature_")}
        for t, r in runs.items()} | {"losses_bitwise": True}


# ---------------------------------------------------------------------------
# phase 16: the online serving runtime (``serve_rgnn --runtime online``)
# ---------------------------------------------------------------------------
# full width, as the driver's defaults: 2 layers, 64 wide, fanout 5, tile
# and node block 32, bucketed, aifb at scale 1.0, the fine ladder up to 32
ONLINE = dict(dataset="aifb", scale=1.0, layers=2, dim=64, hidden=64,
              classes=16, fanouts=[5, 5], tile=32, node_block=32, seed=0,
              max_batch=32, ladder_kind="fine", max_wait_ms=5.0,
              size_choices=(1, 2, 4, 8))
ONLINE_RUNS = (
    ("a rgat poisson", dict(model="rgat", rate_rps=200.0, num_requests=256,
                            process="poisson", slo_ms=1000.0)),
    ("b rgcn burst cached", dict(model="rgcn", rate_rps=200.0,
                                 num_requests=256, process="burst",
                                 burst_size=8, slo_ms=1000.0,
                                 feature_store="cached")),
    # the device sampler's launches (two hops of sampling and layouts, on
    # the execute thread) cost about the same at every rung, so at 200
    # req/s its small batches saturate that thread and admission then
    # shrinks the rungs further: run at half the rate
    ("d rgat device-sampled", dict(model="rgat", rate_rps=100.0,
                                   num_requests=256, process="poisson",
                                   slo_ms=1000.0, sampler="device")),
    ("e rgat slo 0.5 ms", dict(model="rgat", rate_rps=200.0,
                               num_requests=64, process="poisson",
                               slo_ms=0.5)),
)
TENANT_REQUESTS = 128
# req/s over both tenants: one process, so both loaders' host builds and
# the capturing tenant's op-by-op calls share one interpreter lock
TENANT_RATE = 100.0


class OnlineRecorder:
    """Hooks a runtime from the smoke script (the runtime itself is left
    as it is): ``coalescer.plan`` is wrapped to keep every admitted
    ``PlannedBatch``, and the engine's ``forward_minibatch`` (an attribute
    of the compiled instance) to keep, from ``start()`` on, every served
    mini-batch with a copy of its input rows, on the execute thread."""

    def __init__(self, torch, rt):
        from repro_torch.feats import gather_input

        self.rt, self.batches, self.served = rt, [], {}
        self.traffic = False
        plan = rt.coalescer.plan

        def recording_plan(*a, **kw):
            d = plan(*a, **kw)
            if d.batch is not None:
                self.batches.append(d.batch)
            return d

        rt.coalescer.plan = recording_plan
        engine = rt.engine
        self.forward = engine.forward_minibatch

        def recording_forward(params, mb, store, compiled=True):
            if self.traffic:
                feats = gather_input(store, mb)
                self.served[mb.step] = (mb, {k: v.clone()
                                             for k, v in feats.items()})
            return self.forward(params, mb, store, compiled=compiled)

        engine.forward_minibatch = recording_forward
        start = rt.start

        def recording_start():
            self.traffic = True
            return start()

        rt.start = recording_start

    def check_responses(self, torch, tag):
        """Every OK response's rows bit for bit the rows of an op-by-op
        forward of the mini-batch served for its ``PlannedBatch`` (the
        same seeds and step, the same input rows); returns the count."""
        import dataclasses

        import numpy as np

        from repro_torch.serve import OK

        rt = self.rt
        by_rid = {}
        for pb in self.batches:
            for req, sl in zip(pb.requests, pb.slices):
                by_rid[req.rid] = (pb, sl)
        eager, n = {}, 0
        for resp in rt.responses:
            if resp.status != OK:
                continue
            pb, (lo, hi) = by_rid[resp.rid]
            check(pb.step in self.served, f"{tag}: batch {pb.step} of "
                  f"request {resp.rid} was not served")
            mb, feats = self.served[pb.step]
            check(np.array_equal(np.asarray(mb.seq.seeds), pb.seeds),
                  f"{tag}: batch {pb.step} served other seeds than planned")
            if pb.step not in eager:
                out = self.forward(rt.params,
                                   dataclasses.replace(mb, feats=feats),
                                   rt.store, compiled=False)
                eager[pb.step] = out.cpu().numpy()
            check(np.array_equal(resp.logits, eager[pb.step][lo:hi]),
                  f"{tag}: request {resp.rid}'s rows differ from an "
                  f"op-by-op forward of its batch {pb.step}")
            n += 1
        return n


def online_summary(tag, st, card):
    log(f"[phase 16 {tag}] {card}: {st['requests']} requests "
        f"{json.dumps(st['by_status'])}; latency p50 "
        f"{st['latency_ms_p50']:.3f} ms, p99 {st['latency_ms_p99']:.3f} ms, "
        f"SLO attainment {st['slo_attainment']:.4f}, batch fill "
        f"{st['batch_fill']:.4f}, rungs {json.dumps(st['rung_counts'])}, "
        f"queue {st['queue_ms_mean']:.3f} ms + execute "
        f"{st['execute_ms_mean']:.3f} ms (means), ladder {st['ladder']} "
        f"(calibrated ms {json.dumps({k: round(v, 3) for k, v in st['ladder_ms'].items()})}), "
        f"{st['shape_floor_growths']} floor growths; "
        f"{st['executor_traces']} keys, {st['executor_captures']} graphs, "
        f"{st['retraces_after_warmup']} new keys and "
        f"{st['captures_after_warmup']} graphs after warm-up")
    keys = ("requests", "by_status", "latency_ms_p50", "latency_ms_p99",
            "slo_attainment", "batch_fill", "rung_counts", "queue_ms_mean",
            "execute_ms_mean", "ladder", "ladder_ms", "executor_traces",
            "executor_captures", "retraces_after_warmup",
            "captures_after_warmup", "shape_floor_growths", "batches",
            "queue_depth_max")
    return {k: st.get(k) for k in keys}


def online_run(torch, serve_rgnn, tag, kw, card):
    """One ``serve_rgnn.serve_online`` run on the card with its runtime
    recorded: every request terminal; with the 1000 ms SLO every one OK,
    no new key and no capture after warm-up, every OK response equal to an
    op-by-op forward bit for bit; with the 0.5 ms SLO every request
    rejected at admission or late and none OK past its SLO; no worker
    thread left after ``close()``."""
    from repro_torch.serve import LATE, OK, REJECTED_DEADLINE

    rec = {}
    st = serve_rgnn.serve_online(
        **ONLINE, **kw, device="cuda",
        on_runtime=lambda rt: rec.update(r=OnlineRecorder(torch, rt)),
        log=lambda m: None)
    r = rec["r"]
    rt = r.rt
    n = kw["num_requests"]
    out = online_summary(tag, st, card)
    if rt.shape_floors is not None:
        top = max(rt.coalescer.rungs)
        out["floors_top_rung"] = {
            hop: rt.shape_floors._graph.get((top, hop))
            for hop in range(len(ONLINE["fanouts"]))}
        log(f"[phase 16 {tag}] padded (nodes, edges, unique pairs) of a "
            f"rung-{top} batch by hop after calibration: "
            f"{json.dumps(out['floors_top_rung'])}")
    missed = sorted((x for x in rt.responses if x.status != OK),
                    key=lambda x: x.rid)
    if missed and kw["slo_ms"] >= 1000.0:
        log(f"[phase 16 {tag}] not OK (rid status latency queue rung): "
            + "; ".join(f"{x.rid} {x.status} {x.latency_ms:.1f} "
                        f"{x.queue_ms:.1f} {x.rung}" for x in missed[:40]))
        slow = sorted(enumerate(rt._exec_ms), key=lambda t: -t[1])[:8]
        log(f"[phase 16 {tag}] slowest executes (batch, ms): "
            + ", ".join(f"{i} {ms:.1f}" for i, ms in slow))
    check(st["submitted"] == st["requests"] == len(rt.responses) == n,
          f"phase 16 {tag}: {st['requests']} terminal responses for {n} "
          f"requests")
    check(all(not t.is_alive() for t in rt.worker_threads()),
          f"phase 16 {tag}: a worker thread outlived close()")
    if kw["slo_ms"] >= 1000.0:
        check(st["by_status"] == {OK: n}, f"phase 16 {tag}: statuses "
              f"{st['by_status']}, expected all {n} OK")
        check(st["retraces_after_warmup"] == 0
              and st["captures_after_warmup"] == 0,
              f"phase 16 {tag}: {st['retraces_after_warmup']} new keys and "
              f"{st['captures_after_warmup']} captures after warm-up")
        eager = r.check_responses(torch, f"phase 16 {tag}")
        check(eager == n, f"phase 16 {tag}: {eager} of {n} responses "
              f"held to the op-by-op forward")
    else:
        bad = [x.rid for x in rt.responses
               if not (x.status in (REJECTED_DEADLINE, LATE) or (
                   x.status == OK and x.latency_ms <= kw["slo_ms"]))]
        check(not bad, f"phase 16 {tag}: requests {bad[:5]} neither "
              f"rejected, late nor OK within {kw['slo_ms']} ms")
        eager = r.check_responses(torch, f"phase 16 {tag}")
    out["held_to_eager"] = eager
    return out


def online_tenants(torch, hector_torch, card):
    """Phase 16 (c): RGAT and RGCN as two tenants of one process, 256
    requests at ``TENANT_RATE`` routed by model. RGAT is calibrated as
    ``serve_online`` calibrates; RGCN with one
    warm round and no floor probes, so its keys keep growing and its
    execute thread captures during traffic, beside RGAT's. Every request
    OK, no new key or capture after warm-up for RGAT (the other tenant's
    traffic and captures cross nothing), every OK response equal to an
    op-by-op forward bit for bit, no thread left."""
    import numpy as np

    from repro_torch.core.graph import table3_graph
    from repro_torch.serve import (OK, MultiTenantRuntime, OpenLoopLoad,
                                   ServingRuntime, ladder)

    cfg = ONLINE
    graph = table3_graph(cfg["dataset"], scale=cfg["scale"],
                         seed=cfg["seed"])
    feats = np.random.default_rng(cfg["seed"]).normal(
        size=(graph.num_nodes, cfg["dim"])).astype(np.float32)
    mt = MultiTenantRuntime()
    recs = {}
    for model in ("rgat", "rgcn"):
        engine = hector_torch.compile(
            model, graph, layers=cfg["layers"], dim=cfg["dim"],
            hidden=cfg["hidden"], classes=cfg["classes"],
            sample=cfg["fanouts"], tile=cfg["tile"],
            node_block=cfg["node_block"], bucket=True, seed=cfg["seed"],
            device="cuda")
        rt = mt.add(ServingRuntime(
            engine, engine.init(cfg["seed"]), engine.make_feature_store(feats),
            name=model, rungs=ladder(cfg["max_batch"], cfg["ladder_kind"]),
            max_wait_ms=cfg["max_wait_ms"]))
        recs[model] = OnlineRecorder(torch, rt)
    try:
        mt["rgat"].calibrate(floor_margin=0)       # as serve_online does
        mt["rgcn"].calibrate(warm_rounds=1, probe_batches=0, floor_margin=0,
                             batches_per_rung=1, iters=1, validate=False)
        load = OpenLoopLoad(graph.num_nodes, rate_rps=TENANT_RATE,
                            num_requests=2 * TENANT_REQUESTS,
                            size_choices=cfg["size_choices"], slo_ms=1000.0,
                            models=("rgat", "rgcn"), seed=cfg["seed"])
        load.replay(mt.submit)
        mt.drain(timeout=120.0)
    finally:
        mt.close()
    st = mt.stats()
    tag = "phase 16 c tenants"
    check(all(not t.is_alive() for t in mt.worker_threads()),
          f"{tag}: a worker thread outlived close()")
    out = {}
    for model, rec in recs.items():
        s = st["tenants"][model]
        check(s["by_status"] == {OK: TENANT_REQUESTS}, f"{tag} {model}: "
              f"statuses {s['by_status']}")
        held = rec.check_responses(torch, f"{tag} {model}")
        check(held == TENANT_REQUESTS, f"{tag} {model}: {held} responses "
              f"held to the op-by-op forward")
        out[model] = online_summary(f"c tenant {model}", s, card)
    a = st["tenants"]["rgat"]
    check(a["retraces_after_warmup"] == 0 and a["captures_after_warmup"] == 0,
          f"{tag}: rgat made {a['retraces_after_warmup']} keys and "
          f"{a['captures_after_warmup']} captures after warm-up beside the "
          f"rgcn tenant")
    b = st["tenants"]["rgcn"]
    log(f"[{tag}] {card}: rgcn captured {b['captures_after_warmup']} graphs "
        f"during traffic on its execute thread ({b['retraces_after_warmup']}"
        f" new keys) beside rgat's warm replays; no crash, every response "
        f"bit for bit its op-by-op forward")
    return out


def phase_online(torch, hector_torch, serve_rgnn, card):
    """Phase 16: the online runtime (``ServingRuntime`` through
    ``serve_rgnn.serve_online``, and two tenants), at full width."""
    out = {}
    for tag, kw in ONLINE_RUNS[:2]:
        out[tag] = online_run(torch, serve_rgnn, tag, kw, card)
    out["c tenants"] = online_tenants(torch, hector_torch, card)
    for tag, kw in ONLINE_RUNS[2:]:
        out[tag] = online_run(torch, serve_rgnn, tag, kw, card)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every number as JSON to this path")
    ap.add_argument("--trace-dir", default=None,
                    help="write phase 8's Chrome traces into this directory")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import hector_torch
        from repro_torch.kernels import build, ops
        from repro_torch.kernels import layout as L
        from repro_torch.kernels import ref as R
        from repro_torch.kernels import sampling_ops as SO
        from repro_torch.kernels import segment_mm as SK
        from repro_torch.kernels import traversal as TK
        from repro_torch import configs as C
        from repro_torch.kernels import flash_attention as F
        from repro_torch.launch import serve as lm_serve
        from repro_torch.launch import serve_rgnn, train_rgnn
        from repro_torch.lm.model import TransformerLM
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}",
              file=sys.stderr)
        return 2

    # phase 1: card and build
    log("[phase 1] start")
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "unknown"
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[phase 1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    build_s = build.build_all()
    log(f"[phase 1] built {', '.join(build.sources())} in {build_s:.2f} s")
    for stem, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[phase 1] ptxas {stem}: {line.strip()}")

    seconds = {}
    try:
        log("[phase 2] start")
        t0 = time.perf_counter()
        train_cfg = {m: dict(TRAIN, model=m, epochs=e)
                     for m, e in TRAIN_EPOCHS.items()}
        tasks = {m: TrainTask(torch, hector_torch, cfg)
                 for m, cfg in train_cfg.items()}
        k5_sass = k5_build_report(SK)
        gemm_ptxas = gemm_build_report()
        # the slot-split kernels beyond their rows' calls: the errors of K8
        # at K7's calls, of K6 at K3's and of all five at the slot split's
        # edge cases, and their timings at the bgs calls (phases 2 and 7)
        split = {name: 0.0 for name in SLOT_SPLIT}
        split["timed"] = []
        kernels = phase_kernels(torch, hector_torch, SK, TK, SO, L, R, ops,
                                tasks, split)
        seconds["phase 2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve, serve_logits = {}, {}
        for tag, cfg in SERVE_RUNS:
            phase = "phase 4" if cfg["dataset"] == "bgs" else "phase 3"
            log(f"[{phase} {tag}] start")
            serve[tag], serve_logits[tag] = phase_serve(
                torch, hector_torch, ops, serve_rgnn, cfg, f"{phase} {tag}")
        log("[phase 5] start")
        prof = {tag: phase_profile(torch, serve_rgnn, cfg, "phase 5 " + tag)
                for tag, cfg in SERVE_RUNS}
        seconds["phases 3-5"] = time.perf_counter() - t0
        train, full, train_prof = {}, {}, {}
        for model, task in tasks.items():
            log(f"[phase 6 {model}] start")
            t0 = time.perf_counter()
            train[model] = phase_train(torch, ops, train_rgnn, task,
                                       train_cfg[model])
            seconds[f"phase 6 {model}"] = time.perf_counter() - t0
            log(f"[phase 7 {model}] start")
            t0 = time.perf_counter()
            full[model] = phase_full_graph(torch, task, train_rgnn, TRAIN,
                                           split)
            seconds[f"phase 7 {model}"] = time.perf_counter() - t0
            log(f"[phase 8 {model}] start")
            t0 = time.perf_counter()
            train_prof[model] = phase_train_profile(torch, task, full[model],
                                                    args.trace_dir)
            seconds[f"phase 8 {model}"] = time.perf_counter() - t0
        log("[phase 9] start")
        t0 = time.perf_counter()
        device_serve = {
            tag: phase_device_serve(torch, ops, serve_rgnn, cfg,
                                    f"phase 9 {tag}", serve[tag],
                                    serve_logits[tag])
            for tag, cfg in DEVICE_SERVE_RUNS}
        seconds["phase 9"] = time.perf_counter() - t0
        log("[phase 10] start")
        t0 = time.perf_counter()
        device_train = phase_device_train(torch, ops, train_rgnn,
                                          train_cfg["rgat"], train["rgat"])
        seconds["phase 10"] = time.perf_counter() - t0
        log("[phase 11] start")
        t0 = time.perf_counter()
        tuning = phase_tuning(torch, hector_torch, SK, TK, SO, L, R, ops,
                              serve_rgnn, train_rgnn, tasks["rgat"])
        kernels.update(tuning.pop("kernels"))
        for name in SLOT_SPLIT:
            kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                               split[name])
        seconds["phase 11"] = time.perf_counter() - t0
        log("[phase 12] start")
        t0 = time.perf_counter()
        lm = phase_lm(torch, ops, C, F, lm_serve, TransformerLM)
        kernels.update(lm.pop("kernels"))
        seconds["phase 12"] = time.perf_counter() - t0
        log("[phase 13] start")
        t0 = time.perf_counter()
        obs_out = phase_obs(torch, hector_torch, ops, serve_rgnn,
                            train_rgnn, train_prof["rgat"], tuning, card)
        seconds["phase 13"] = time.perf_counter() - t0
        log("[phase 14] start")
        t0 = time.perf_counter()
        capture = phase_capture(torch, hector_torch, SK, L, ops,
                                serve_rgnn, train_rgnn, card)
        seconds["phase 14"] = time.perf_counter() - t0
        log("[phase 15] start")
        t0 = time.perf_counter()
        features = phase_features(torch, hector_torch, ops, serve_rgnn,
                                  train_rgnn, card)
        seconds["phase 15"] = time.perf_counter() - t0
        log(f"[phase 15] {seconds['phase 15']:.2f} s")
        log("[phase 16] start")
        t0 = time.perf_counter()
        online = phase_online(torch, hector_torch, serve_rgnn, card)
        seconds["phase 16"] = time.perf_counter() - t0
        log(f"[phase 16] {seconds['phase 16']:.2f} s")
        # the main path's launches, each run from counts set to 0 just
        # before it, each run op by op so that every kernel the card runs
        # goes through its wrapper: phase 6 of every model (K1-K5, K7),
        # phases 9 and 10 (K9, the device-sampling path; the sampler
        # launches K9 outside the executors), phase 11's tuned training
        # and serving (K6, K8: the tuner's path), phase 12's LM serve runs
        # (K10)
        launches = {name: sum(t["launches"][name] for t in train.values())
                    for name in KERNELS}
        launches[K9] = (sum(r["launches"][K9] for r in device_serve.values())
                        + device_train["launches"][K9])
        launches.update(tuning["launches"])
        launches[K10] = lm["launches"]
        for name, n in launches.items():
            check(n > 0, f"{name} never launched on the main path")
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    seconds["total"] = time.perf_counter() - t_start
    log(f"[timing] seconds per phase: "
        + json.dumps({k: round(v, 2) for k, v in seconds.items()}))

    rows = []
    for name, meta in KERNELS.items():
        r = kernels[name]
        served = next((p["kernels"][name] for p in prof.values()
                       if name in p["kernels"]), None)
        rows.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            wrapper_ms=r["wrapper_ms"], timed_at=r["timed_at"],
            ms_per_call=r.get("ms_per_call"),
            calls_per_unit=r.get("calls_per_unit"),
            # run on the card while serving (phase 5's profiler; the
            # replayed graphs' kernels included)
            served_launches=sum(p["kernels"][name]["launches"]
                                for p in prof.values()
                                if name in p["kernels"]),
            served_device_ms=(served["device_ms_per_batch"]
                              if served is not None else None)))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(
            card=card, build_s=build_s, seconds=seconds, kernels=kernels,
            serve=serve, profile=prof, train=train, full_graph=full,
            train_profile=train_prof, device_serve=device_serve,
            device_train=device_train, tuning=tuning, lm=lm, obs=obs_out,
            capture=capture, features=features, online=online,
            split_timed=split["timed"], k5_sass=k5_sass,
            gemm_ptxas=gemm_ptxas,
            torch=torch.__version__,
            cuda=torch.version.cuda), indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
