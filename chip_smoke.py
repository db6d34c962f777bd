#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port: build, kernel-vs-plain, serve, train.

    python3 chip_smoke.py            # one CUDA card; a few minutes

Drives the port (``src/repro_torch``, never JAX nor the reference package)
on one CUDA card, in phases, for the registry's models (RGAT, RGCN, HGT,
rgcn_cat); any failure exits non-zero:

1. card and build: the card's name and power limit, TF32 off, every kernel
   in ``src/repro_torch/csrc`` built from source (one ``nvcc`` per file,
   all at once), with the build seconds and ptxas's register report;
2. kernels against their plain PyTorch versions on the card, at the shapes
   real runs give them (all captured): one served mini-batch of each serve
   phase (RGAT aifb-b32 and bgs-b1024: K1-K3; RGCN aifb-b32 and bgs-b1024:
   K1, K7; HGT aifb-b32: K1-K4, K4 on the node-type segments), the device
   sampling and forward of RGAT's first device-sampled batch at aifb-b32
   and bgs-b1024 (K9 at every window, K1-K3 on the device-built layouts)
   and one sampled training step of RGAT, RGCN and HGT (aifb-b64: K1-K5,
   K7),
   plus edge cases (gather index -1, groups and node blocks without tiles,
   pow2 pad tiles, the scale epilogue, k = 1 and n = 1, a transposed W, a
   group long enough for many K5 chunks, the CUDA ``edge_softmax``, K7
   with ``scale=None``, compact rows with -1, d = 1, empty layouts that
   must not launch; K9 with counts 0 and C, C = 1, odd row counts and
   high-bit base keys; K5 with the static chunk bound of device-built
   layouts). K9 is held bit for bit, decoded, to its plain version and to
   numpy's ``edge_sample_keys``. Tolerances: K1 and K4 rtol = atol = 1e-5
   (fp32 sums of at most 64 terms); K2 ``mx`` exact, ``den`` rtol 1e-5;
   K3 rtol = atol = 2e-5 (the reference's own fused-vs-oracle bound); K5
   rtol = atol = 1e-6 and K7 rtol = atol = 1e-5 (the reference's
   ``test_weighted_agg`` bound; kernel and plain version both sum in fp64,
   so they agree to the final fp32 rounding). At the RGAT aifb served
   batch (K1-K3), the RGAT training step (K4, K5), the RGCN aifb served
   batch (K7) and RGAT's first device-sampled aifb batch (K9): each
   kernel's device time (mean of 20 calls under ``torch.profiler``), the
   wrapper's time per call (CUDA events, median of 25 runs of 10 calls:
   host cost included), its plain version's time, its bound and, for K4,
   ``torch.bmm`` on the same tiles, for K7 ``torch.sparse.mm`` of the
   scales as a CSR matrix;
3. serving at the driver's defaults (2 layers, 64 wide, aifb at scale 1.0,
   fanout 5, 32 seeds x 8 batches) through
   ``repro_torch.launch.serve_rgnn.serve``, for RGAT, RGCN, HGT and
   rgcn_cat: each model's kernels (RGAT K1-K3, RGCN and rgcn_cat K1 + K7,
   HGT K1-K4) must launch and no other, every batch's logits be finite
   and match the same mini-batch run through the port on the CPU
   (rtol = atol = 1e-4);
4. the same at a larger size (bgs at scale 1.0, 1024 seeds x 4 batches),
   for RGAT and RGCN;
5. every serve run again under ``torch.profiler``: each kernel's device
   time per launch and per batch, and the device's busy share of the loop;
6. sampled training through ``repro_torch.launch.train_rgnn.train`` (aifb
   at scale 1.0, 2 layers, 64 wide, 8 classes, fanout 5, batch 64, 1
   epoch, HGT 2, lr 1e-2) of RGAT, RGCN and HGT: the kernels launch at each
   model's per-step counts (``STEP_LAUNCHES``, plus the full-graph
   forwards' ``FORWARD_LAUNCHES``), the loss is finite and falls (mean of
   the last 10 steps below the mean of the first 10); then one
   ``grad_and_update`` on the card and on the CPU from one state (after 5
   card steps; see ``TrainTask``) on one mini-batch: loss rtol 1e-5,
   params and ``mu`` rtol 1e-4 / atol 1e-6 (the reference's own
   step-parity bounds);
7. full-graph training (``FullGraphTrainer``) of each: aifb, one step on
   the card against the CPU from phase 6's state, at its bounds; bgs at
   scale 1.0, 3 steps with a finite loss, timed;
8. one sampled step and one bgs full-graph step of each under
   ``torch.profiler``: device time per kernel and per step, the device's
   busy share, the split between the ``forward`` / ``backward`` /
   ``optimizer`` ranges, and the device ops that take the most time;
9. device-sampled serving (``sampler="device"``) of RGAT and RGCN at
   aifb-b32 (8 batches) and RGAT at bgs-b1024 (4 batches), the seeds of
   phases 3 and 4: every batch's logits equal the host-sampled ones
   within rtol = atol = 2e-4 (the reference's own device-vs-host bound),
   no host build, no count sync after warmup, every batch that outgrew a
   shrunken bucket rebuilt, every sampling call after the first under
   ``torch.cuda.set_sync_debug_mode("error")``, K9 launched; latency,
   wait, compute, seeds/s, peak memory and bucket shrinks beside the
   host-sampled run's;
10. phase 6's RGAT training with ``sampler="device"``: the first loss
   equal to the host-sampled run's (rtol 1e-4), a falling loss, the
   kernels at their per-step counts (K5 with its static chunk bound), K9
   twice a sampled batch.

The line before the last is ``{"kernels": [...]}`` (``launches``: phase
6's runs of all three models for K1-K7, phases 9 and 10 for K9); the last
line is ``{"ok": true, "device": {...}}``. ``--out PATH`` also writes
every number as JSON, ``--trace-dir DIR`` the phase-8 Chrome traces.
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
K9 = "candidate_keys"

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
# (K2 + K3) per layer; dX by K4 of the 3 GEMMs of layer 1, dW by K5 of
# all 6. RGCN: one gathered GEMM (K1) and one mean aggregation (K7) per
# layer (W_self is untyped: a plain matmul). HGT: 3 node-typed GEMMs (K4)
# and 2 gathered ones (K1) and the fused softmax tail (K2 + K3) per layer;
# dX by K4 of the 4 gathered GEMMs and of layer 1's 3 node-typed ones,
# dW by K5 of all 10.
STEP_LAUNCHES = {
    "rgat": {K1: 6, K2: 2, K3: 2, K4: 3, K5: 6},
    "rgcn": {K1: 2, K7: 2, K4: 1, K5: 2},
    "hgt": {K1: 4, K2: 2, K3: 2, K4: 13, K5: 10},
}
# launches per 2-layer forward (a full-graph forward; every served batch)
FORWARD_LAUNCHES = {
    "rgat": {K1: 6, K2: 2, K3: 2},
    "rgcn": {K1: 2, K7: 2},
    "rgcn_cat": {K1: 2, K7: 2},
    "hgt": {K1: 4, K2: 2, K3: 2, K4: 6},
}

# each ported kernel: its source, the TPU kernel it replaces, the name of
# its ``__global__`` function(s) as the profiler reports them, and how many
# kernels one call launches
KERNELS = {
    K1: dict(source="src/repro_torch/csrc/segment_mm.cu",
             replaces="src/repro/kernels/segment_mm.py:120",
             symbol="segment_mm_gather_kernel"),
    K2: dict(source="src/repro_torch/csrc/traversal.cu",
             replaces="src/repro/kernels/traversal.py:75",
             symbol="seg_stats_kernel"),
    K3: dict(source="src/repro_torch/csrc/traversal.cu",
             replaces="src/repro/kernels/traversal.py:224",
             symbol="seg_softmax_agg_gather_kernel"),
    K4: dict(source="src/repro_torch/csrc/segment_mm.cu",
             replaces="src/repro/kernels/segment_mm.py:44",
             symbol="segment_mm_padded_kernel"),
    K5: dict(source="src/repro_torch/csrc/segment_mm.cu",
             replaces="src/repro/kernels/segment_mm.py:194",
             symbol="segment_outer_", per_call=2),     # partial + combine
    K7: dict(source="src/repro_torch/csrc/traversal.cu",
             replaces="src/repro/kernels/traversal.py:294",
             symbol="seg_weighted_agg_gather_kernel"),
    K9: dict(source="src/repro_torch/csrc/sampling.cu",
             replaces="src/repro/kernels/sampling_ops.py:77",
             symbol="candidate_keys_kernel"),
}
# where each kernel is timed in phase 2: the captured calls of one served
# batch ("<model> aifb"), one training step ("<model> step") or the device
# sampling of one served batch ("<model> aifb device")
TIMED_AT = {K1: "rgat aifb", K2: "rgat aifb", K3: "rgat aifb",
            K4: "rgat step", K5: "rgat step", K7: "rgcn aifb",
            K9: "rgat aifb device"}
# phase 9: the serve runs repeated with ``sampler="device"``; phase 2
# captures the first device-sampled batch of the RGAT ones
DEVICE_SERVE_RUNS = (
    ("rgat aifb", SERVE_DEFAULTS), ("rgcn aifb", dict(SERVE_DEFAULTS,
                                                      model="rgcn")),
    ("rgat bgs", SERVE_LARGE))
CAPTURED_DEVICE = ("rgat aifb", "rgat bgs")
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

    Back-to-back profiler sessions sometimes drop kernel records (seen: 7
    of 20 delivered, and once none), so the mean is over the launches it
    recorded, and a session that recorded none is run again (at most
    three sessions)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    symbol in e.key:
                total_us += _device_us(e)
                count += e.count
        if count:
            break
        log(f"[phase 2] {symbol}: profiler session {session + 1} recorded "
            f"none of {reps} launches")
    check(count > 0, f"{symbol}: the profiler recorded none of {reps} "
          f"launches in three sessions")
    if count != reps * per_call:
        log(f"[phase 2] {symbol}: the profiler recorded {count} of "
            f"{reps * per_call} launches; timing the recorded ones")
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


def k9_work(torch, args, kw):
    """K9: each row's start and count read once, each candidate's key
    written once (int32); no floating-point work."""
    starts, width = args[0], args[3]
    rows = starts.numel()
    return rows * 8 + rows * width * 4, 0.0


LIBRARY = {K4: ("torch.bmm", k4_library), K7: ("torch.sparse.mm", k7_library)}

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
    originals = _recording(ops, (K1, K2, K3, K7), calls)
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


def capture_main_path_calls(torch, hector_torch, cfg):
    """Run the first mini-batch that ``serve(**cfg)`` serves (same graph,
    seeds, weights and features) on the card and record every kernel
    call's inputs."""
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
    with recorded_kernel_calls() as calls:
        out = engine.apply_blocks(params, mb, feats)
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
        out = engine.apply_blocks(params, mb, feats)
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
                {"feature": self.x[mb.input_ids.long()]})
        self.state = state
        self.state_cpu = tree_map(lambda t: t.cpu(), state)
        self.mb, self.batch_labels_cpu = batch(self.WARM_STEPS, "cuda")
        self.mb_cpu, _ = batch(self.WARM_STEPS, "cpu")

    def step(self, torch):
        """One sampled ``grad_and_update`` on the card from the state."""
        return self.engine.train_executor(self.opt).grad_and_update(
            self.state, self.mb, self.batch_labels_cpu.cuda(),
            {"feature": self.x[self.mb.input_ids.long()]})

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
TOLERANCE = {K1: 1e-5, K4: 1e-5, K3: 2e-5, K5: 1e-6, K7: 1e-5}


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
    if name in (K3, K7):
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


def phase_kernels(torch, hector_torch, SK, TK, SO, L, R, ops, tasks):
    results = {name: dict(calls=[], max_abs_err=0.0, max_abs_err_by={})
               for name in KERNELS}
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

    plain = {K1: SK.segment_mm_gather_padded_plain,
             K2: TK.seg_stats_padded_plain,
             K3: TK.seg_softmax_agg_gather_padded_plain,
             K4: SK.segment_mm_padded_plain,
             K5: SK.segment_outer_padded_plain,
             K7: TK.seg_weighted_agg_gather_padded_plain,
             K9: SO.candidate_keys_plain}
    kernel = {K1: SK.segment_mm_gather_padded, K2: TK.seg_stats_padded,
              K3: TK.seg_softmax_agg_gather_padded,
              K4: SK.segment_mm_padded, K5: SK.segment_outer_padded,
              K7: TK.seg_weighted_agg_gather_padded,
              K9: SO.candidate_keys}
    work = {K1: k1_work, K2: k2_work, K3: k3_work, K4: k4_work,
            K5: k5_work, K7: k7_work, K9: k9_work}
    # the training captures hold parameter leaves: compare and time without
    # recording gradients
    plain = {k: torch.no_grad()(f) for k, f in plain.items()}
    kernel = {k: torch.no_grad()(f) for k, f in kernel.items()}

    def run_compare(name, args, kw):
        if name == K9:
            return k9_compare(torch, SO, args, kw)
        got = kernel[name](*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        if name == K2:
            e1 = compare(torch, name + ".mx", got[0], want[0], 0, 0,
                         exact=True)
            e2 = compare(torch, name + ".den", got[1], want[1], 1e-5, 0)
            return max(e1, e2)
        tol = TOLERANCE[name]
        return compare(torch, name, got, want, tol, tol)

    # every captured call against the plain version; the calls of TIMED_AT
    # are timed too
    for tag, calls in captured.items():
        for name, lst in calls.items():
            if not lst:
                continue
            r = results[name]
            timed = TIMED_AT[name] == tag
            errs = []
            for i, (args, kw) in enumerate(lst):
                err = run_compare(name, args, kw)
                errs.append(err)
                if not timed:
                    continue
                fn = lambda: kernel[name](*args, **kw)       # noqa: E731
                per_call = KERNELS[name].get("per_call", 1)
                if name == K5 and kw["num_chunks"] == 0:
                    per_call = 1
                ms = device_ms(torch, fn, KERNELS[name]["symbol"],
                               per_call=per_call)
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
                log(f"[phase 2] {name}[{i}] ({tag}) {shape}: max abs err "
                    f"{err:.3g}; kernel {ms:.5f} ms on the device, wrapper "
                    f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms"
                    + (f", {LIBRARY[name][0]} {library_ms:.4f} ms"
                       if library_ms is not None else "")
                    + f", bound {b_ms:.5f} ms ({b_by}, {nbytes} B, "
                    f"{flops:.0f} FLOP)")
            r["max_abs_err_by"][tag] = max(errs)
            r["max_abs_err"] = max(r["max_abs_err"], max(errs))
            if not timed:
                log(f"[phase 2] {name}: {len(lst)} {tag} calls match the "
                    f"plain version (max abs err {max(errs):.3g})")
    edge_cases(torch, SK, TK, L, ops, R, run_compare, results)
    k9_edge_cases(torch, ops, run_compare, results)
    for name, r in results.items():
        check(bool(r["calls"]), f"{name}: no timed call")
        for key in ("ms", "wrapper_ms", "plain_ms", "bound_ms"):
            r[key] = sum(c[key] for c in r["calls"])
        r["library_ms"] = (sum(c["library_ms"] for c in r["calls"])
                           if name in LIBRARY else None)
        by_bytes = sum(c["bound_ms"] for c in r["calls"]
                       if c["bound_by"] == "bytes")
        r["bound_by"] = "bytes" if by_bytes >= r["bound_ms"] / 2 \
            else "operations"
        r["timed_at"] = TIMED_AT[name]
        model, unit = TIMED_AT[name].split(maxsplit=1)
        unit = {"step": "aifb-b64 training step",
                "aifb device": "device-sampled aifb batch"}.get(
                    unit, "served aifb batch")
        log(f"[phase 2] {name}: {len(r['calls'])} calls per {model} {unit}"
            f", kernel {r['ms']:.5f} ms on the device, wrapper "
            f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
            + (f", {LIBRARY[name][0]} {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "")
            + f", bound {r['bound_ms']:.5f} ms ({r['bound_by']}), max abs "
            f"err {r['max_abs_err']:.3g}")
    return results


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
    # (79 chunks of 16 tiles, summed in fp64)
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
            kw5 = dict(num_groups=10, num_chunks=lay.num_chunks, tile=32)
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
    check(long_lay.num_chunks == 1 + 79 + 1, "long group: chunk count")
    x_p = t(rng.normal(size=(long_ps.padded_rows, 64)).astype(np.float32))
    x_p[t(long_ps.row_map < 0)] = 0.0
    err = run_compare(
        "segment_outer_padded",
        (x_p, t(rng.normal(size=(long_ps.padded_rows, 64))
                .astype(np.float32)),
         long_lay.group_tile_ptr, long_lay.group_chunk_ptr),
        dict(num_groups=3, num_chunks=long_lay.num_chunks, tile=32))
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
        num_chunks=lay0.num_chunks, tile=32)
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
                           tile=32))
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
def phase_serve(torch, hector_torch, ops, serve_rgnn, cfg, tag):
    import numpy as np

    from repro_torch.core.graph import table3_graph
    from repro_torch.sampling import build_minibatch

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

    # the same mini-batches through the port on the CPU
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
        check(bool(torch.allclose(logits, want, rtol=1e-4, atol=1e-4)),
              f"{tag}: batch {step} logits differ from the CPU run "
              f"(max abs err {err:.3g})")
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
    ``sampler="device"``: the kernels of each step on the device-built
    layouts (K5 with its static chunk bound), K9 twice a sampled batch
    (one window a hop), the first step's loss equal to the host-sampled
    run's (the same batch, the same initial weights), a falling loss, every
    batch that outgrew its buckets rebuilt."""
    import numpy as np

    model = cfg["model"]
    tag = f"phase 10 {model}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = train_rgnn.train(**cfg, eval_every_epochs=0, device="cuda",
                             sampler="device",
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
    keys = ("steps", "step_ms_p50", "step_ms_p99", "seeds_per_s",
            "sampler_bucket_shrinks", "sampler_bucket_overflows",
            "sampler_overflow_rebuilds", "sampler_trace_count")
    return dict({k: stats[k] for k in keys}, launches=launches,
                loss_first=float(losses[0]), loss_first10=first,
                loss_last10=last, wall_s=wall)


# ---------------------------------------------------------------------------
# phase 5: where the device time goes (torch.profiler over a serve run)
# ---------------------------------------------------------------------------
def phase_profile(torch, serve_rgnn, cfg, tag):
    """Serve ``cfg`` again under ``torch.profiler``: each kernel's device
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
        out[name] = dict(launches=count, device_ms_per_launch=t_us / count
                         / 1e3, device_ms_per_batch=t_us / stats["batches"]
                         / 1e3)
        log(f"[{tag}] {name}: {count} launches, "
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


def phase_train(torch, ops, train_rgnn, task, cfg):
    """Phase 6: sampled training of ``cfg["model"]`` through the driver,
    then one step on the card against the CPU."""
    import numpy as np

    model = cfg["model"]
    tag = f"phase 6 {model}"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = train_rgnn.train(**cfg, eval_every_epochs=0, device="cuda",
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
    log(f"[{tag}] {steps} steps: loss {first:.4f} (mean of the first 10) "
        f"-> {last:.4f} (last 10); step p50 {stats['step_ms_p50']:.3f} ms, "
        f"p99 {stats['step_ms_p99']:.3f} ms, {stats['seeds_per_s']:.1f} "
        f"seeds/s; full-graph eval: val loss {stats['full_val_loss']:.4f} "
        f"acc {stats['full_val_acc']:.4f}, train loss "
        f"{stats['full_train_loss']:.4f} acc {stats['full_train_acc']:.4f} "
        f"(phase wall {wall:.2f} s)")
    state, metrics = task.step(torch)
    state_cpu, metrics_cpu = task.cpu_step(torch)
    worst = compare_states(torch, tag, state, state_cpu, metrics,
                           metrics_cpu)
    keys = ("steps", "step_ms_p50", "step_ms_p99", "seeds_per_s",
            "full_val_loss", "full_val_acc", "full_train_loss",
            "full_train_acc", "executor_compiled")
    return dict({k: stats[k] for k in keys}, launches=launches,
                loss_first=float(losses[0]), loss_first10=first,
                loss_last10=last, wall_s=wall, step_parity=worst)


def phase_full_graph(torch, task, train_rgnn, cfg):
    """Phase 7: full-graph steps of the task's model — aifb on the card
    against the CPU, then bgs at scale 1.0 for 3 timed steps."""
    import dataclasses

    from repro_torch.train import FullGraphTrainer

    tag = f"phase 7 {task.engine.cfg.model}"
    out = {}
    fg = FullGraphTrainer(task.engine, task.feats, task.labels,
                          task.train_ids, opt=task.opt, log=None)
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
                          log=None)
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
    out["bgs_trainer"], out["bgs_state"] = fg, state
    return out


RANGES = ("forward", "backward", "optimizer")


def phase_train_profile(torch, task, full, trace_dir):
    """Phase 8: one sampled step (aifb-b64) and one bgs full-graph step
    under ``torch.profiler``: device time per kernel and per step (kernels
    and copies; the profiler's GPU-side range annotations are not device
    work), the device's busy share of the step, the device time of the
    kernels of the ``forward`` range, of the backward and of the
    ``optimizer`` range, and the 8 device ops that take the most time,
    with their range."""
    from torch.profiler import ProfilerActivity, profile

    fg, state = full.pop("bgs_trainer"), full.pop("bgs_state")
    model = task.engine.cfg.model
    runs = {f"{model} sampled aifb-b64": lambda: task.step(torch),
            f"{model} full-graph bgs": lambda: fg.step(state)}
    out = {}
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
        from repro_torch.launch import serve_rgnn, train_rgnn
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}",
              file=sys.stderr)
        return 2

    # phase 1: card and build
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
        t0 = time.perf_counter()
        train_cfg = {m: dict(TRAIN, model=m, epochs=e)
                     for m, e in TRAIN_EPOCHS.items()}
        tasks = {m: TrainTask(torch, hector_torch, cfg)
                 for m, cfg in train_cfg.items()}
        kernels = phase_kernels(torch, hector_torch, SK, TK, SO, L, R, ops,
                                tasks)
        seconds["phase 2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve, serve_logits = {}, {}
        for tag, cfg in SERVE_RUNS:
            phase = "phase 4" if cfg["dataset"] == "bgs" else "phase 3"
            serve[tag], serve_logits[tag] = phase_serve(
                torch, hector_torch, ops, serve_rgnn, cfg, f"{phase} {tag}")
        prof = {tag: phase_profile(torch, serve_rgnn, cfg, "phase 5 " + tag)
                for tag, cfg in SERVE_RUNS}
        seconds["phases 3-5"] = time.perf_counter() - t0
        train, full, train_prof = {}, {}, {}
        for model, task in tasks.items():
            t0 = time.perf_counter()
            train[model] = phase_train(torch, ops, train_rgnn, task,
                                       train_cfg[model])
            seconds[f"phase 6 {model}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            full[model] = phase_full_graph(torch, task, train_rgnn, TRAIN)
            seconds[f"phase 7 {model}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            train_prof[model] = phase_train_profile(torch, task, full[model],
                                                    args.trace_dir)
            seconds[f"phase 8 {model}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        device_serve = {
            tag: phase_device_serve(torch, ops, serve_rgnn, cfg,
                                    f"phase 9 {tag}", serve[tag],
                                    serve_logits[tag])
            for tag, cfg in DEVICE_SERVE_RUNS}
        seconds["phase 9"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        device_train = phase_device_train(torch, ops, train_rgnn,
                                          train_cfg["rgat"], train["rgat"])
        seconds["phase 10"] = time.perf_counter() - t0
        # the main path's launches, each run from counts set to 0 just
        # before it: phase 6 of every model (K1-K7), phases 9 and 10 (K9,
        # the device-sampling path)
        launches = {name: sum(t["launches"][name] for t in train.values())
                    for name in KERNELS}
        launches[K9] = (sum(r["launches"][K9] for r in device_serve.values())
                        + device_train["launches"][K9])
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
            served_launches=sum(v["launches"][name]
                                for v in serve.values()),
            served_device_ms=(served["device_ms_per_batch"]
                              if served is not None else None)))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(
            card=card, build_s=build_s, seconds=seconds, kernels=kernels,
            serve=serve, profile=prof, train=train, full_graph=full,
            train_profile=train_prof, device_serve=device_serve,
            device_train=device_train, torch=torch.__version__,
            cuda=torch.version.cuda), indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
