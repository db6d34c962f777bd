#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port: build, kernel-vs-plain, serve.

    python3 chip_smoke.py            # one CUDA card; ~1-2 minutes

Drives the port (``src/repro_torch``, never JAX nor the reference package)
on one CUDA card, in phases; any failure exits non-zero:

1. card and build: the card's name and power limit, TF32 off, every kernel
   in ``src/repro_torch/csrc`` built from source (one ``nvcc`` per file,
   all at once), with the build seconds and ptxas's register report;
2. kernels against their plain PyTorch versions on the card, at the shapes
   one served mini-batch of phase 3 and one of phase 4 give them (captured
   from real forwards), plus edge cases (gather index -1, groups and node
   blocks without tiles, pow2 pad tiles, the scale epilogue, the CUDA
   ``edge_softmax``, empty layouts that must not launch). Tolerances: K1
   rtol = atol = 1e-5 (fp32 sums of 64 terms); K2 ``mx`` exact, ``den``
   rtol 1e-5; K3 rtol = atol = 2e-5 (the reference's own fused-vs-oracle
   bound). At the phase-3 shapes, each kernel's device time (mean of 20
   launches under ``torch.profiler``), the wrapper's time per call (CUDA
   events, median of 25 runs of 10 calls: host cost included), its plain
   version's time and its bound;
3. serving at the driver's defaults (RGAT, 2 layers, 64 wide, aifb at
   scale 1.0, fanout 5, 32 seeds x 8 batches) through
   ``repro_torch.launch.serve_rgnn.serve``: every kernel must launch, every
   batch's logits be finite and match the same mini-batch run through the
   port on the CPU (rtol = atol = 1e-4);
4. the same at a larger size (bgs at scale 1.0, 1024 seeds x 4 batches);
5. both serve runs again under ``torch.profiler``: each kernel's device
   time per launch and per batch, and the device's busy share of the loop.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``--out PATH`` also writes every number
as JSON.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s (no tensor
# cores: the kernels compute in IEEE fp32)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

SERVE_DEFAULTS = dict(model="rgat", dataset="aifb", scale=1.0, layers=2,
                      dim=64, hidden=64, classes=16, fanouts=[5, 5],
                      batch_size=32, num_batches=8, tile=32, node_block=32,
                      seed=0)
SERVE_LARGE = dict(SERVE_DEFAULTS, dataset="bgs", batch_size=1024,
                   num_batches=4)

# each ported kernel: its source, the TPU kernel it replaces, and the
# name of its ``__global__`` function as the profiler reports it
KERNELS = {
    "segment_mm_gather_padded": dict(
        source="src/repro_torch/csrc/segment_mm.cu",
        replaces="src/repro/kernels/segment_mm.py:120",
        symbol="segment_mm_gather_kernel"),
    "seg_stats_padded": dict(
        source="src/repro_torch/csrc/traversal.cu",
        replaces="src/repro/kernels/traversal.py:75",
        symbol="seg_stats_kernel"),
    "seg_softmax_agg_gather_padded": dict(
        source="src/repro_torch/csrc/traversal.cu",
        replaces="src/repro/kernels/traversal.py:224",
        symbol="seg_softmax_agg_gather_kernel"),
}


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


def device_ms(torch, fn, symbol: str, reps: int = 20) -> float:
    """Mean device time of one launch of the kernel ``symbol`` over ``reps``
    calls of ``fn`` under ``torch.profiler`` (the host's share excluded).

    Back-to-back profiler sessions sometimes drop kernel records (seen: 7
    of 20 delivered), so the mean is over the launches it recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
    check(count > 0, f"{symbol}: the profiler recorded none of {reps} "
          f"launches")
    if count != reps:
        log(f"[phase 2] {symbol}: the profiler recorded {count} of {reps} "
            f"launches; timing the recorded ones")
    return total_us / count / 1e3


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


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions on the card
# ---------------------------------------------------------------------------
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
    # the ops call the kernel wrappers through their own module names:
    # wrap those for one forward to record every call's inputs
    from repro_torch.kernels import ops
    calls = {name: [] for name in KERNELS}
    originals = {name: getattr(ops, name) for name in KERNELS}

    def recorder(name, fn):
        def rec(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return rec

    for name, fn in originals.items():
        setattr(ops, name, recorder(name, fn))
    try:
        out = engine.apply_blocks(params, mb, feats)
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)
    check(bool(torch.isfinite(out).all()), "captured batch has non-finite "
          "logits")
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


def phase_kernels(torch, hector_torch, SK, TK, L, R, ops):
    results = {name: dict(calls=[], max_abs_err=0.0) for name in KERNELS}
    captured = {}
    for tag, cfg in (("aifb", SERVE_DEFAULTS), ("bgs", SERVE_LARGE)):
        captured[tag] = capture_main_path_calls(torch, hector_torch, cfg)
        for name in KERNELS:
            check(len(captured[tag][name]) > 0,
                  f"{name}: not reached on the {tag} path")
        log(f"[phase 2] captured {tag} batch 0: "
            + ", ".join(f"{k} x{len(v)}"
                        for k, v in captured[tag].items()))
    calls = captured["aifb"]

    plain = {
        "segment_mm_gather_padded": SK.segment_mm_gather_padded_plain,
        "seg_stats_padded": TK.seg_stats_padded_plain,
        "seg_softmax_agg_gather_padded":
            TK.seg_softmax_agg_gather_padded_plain,
    }
    kernel = {
        "segment_mm_gather_padded": SK.segment_mm_gather_padded,
        "seg_stats_padded": TK.seg_stats_padded,
        "seg_softmax_agg_gather_padded": TK.seg_softmax_agg_gather_padded,
    }
    work = {"segment_mm_gather_padded": k1_work, "seg_stats_padded": k2_work,
            "seg_softmax_agg_gather_padded": k3_work}

    def run_compare(name, args, kw):
        got = kernel[name](*args, **kw)
        want = plain[name](*args, **kw)
        torch.cuda.synchronize()
        if name == "seg_stats_padded":
            e1 = compare(torch, name + ".mx", got[0], want[0], 0, 0,
                         exact=True)
            e2 = compare(torch, name + ".den", got[1], want[1], 1e-5, 0)
            return max(e1, e2)
        tol = 1e-5 if name == "segment_mm_gather_padded" else 2e-5
        return compare(torch, name, got, want, tol, tol)

    for name, lst in calls.items():
        r = results[name]
        for i, (args, kw) in enumerate(lst):
            err = run_compare(name, args, kw)
            ms = device_ms(torch, lambda: kernel[name](*args, **kw),
                           KERNELS[name]["symbol"])
            wrapper_ms = time_ms(torch, lambda: kernel[name](*args, **kw))
            plain_ms = time_ms(torch, lambda: plain[name](*args, **kw))
            nbytes, flops = work[name](torch, args, kw)
            b_ms, b_by = bound(nbytes, flops)
            shape = {
                "segment_mm_gather_padded":
                    lambda: f"Rp={args[2].shape[0]} "
                            f"real={int((args[2] >= 0).sum())} "
                            f"k={args[1].shape[1]} n={args[1].shape[2]} "
                            f"R={args[1].shape[0]}",
                "seg_stats_padded":
                    lambda: f"slots={args[0].numel()} "
                            f"blocks={kw['num_node_blocks']}",
                "seg_softmax_agg_gather_padded":
                    lambda: f"slots={args[0].numel()} d={args[1].shape[1]} "
                            f"Em={args[1].shape[0]} "
                            f"blocks={kw['num_node_blocks']}",
            }[name]()
            r["calls"].append(dict(shape=shape, ms=ms,
                                   wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   bytes=nbytes, flops=flops,
                                   max_abs_err=err))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            log(f"[phase 2] {name}[{i}] {shape}: max abs err {err:.3g}; "
                f"kernel {ms:.5f} ms on the device, wrapper {wrapper_ms:.4f}"
                f" ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
                f"({b_by}, {nbytes} B, {flops:.0f} FLOP)")
    # the bgs batch's calls, at the same tolerances (not timed)
    for name, lst in captured["bgs"].items():
        r = results[name]
        r["max_abs_err_bgs"] = max(run_compare(name, args, kw)
                                   for args, kw in lst)
        r["max_abs_err"] = max(r["max_abs_err"], r["max_abs_err_bgs"])
        log(f"[phase 2] {name}: {len(lst)} bgs calls match the plain "
            f"version (max abs err {r['max_abs_err_bgs']:.3g})")
    edge_cases(torch, SK, TK, L, ops, R, run_compare, results)
    for name, r in results.items():
        r["ms"] = sum(c["ms"] for c in r["calls"])
        r["wrapper_ms"] = sum(c["wrapper_ms"] for c in r["calls"])
        r["plain_ms"] = sum(c["plain_ms"] for c in r["calls"])
        r["bound_ms"] = sum(c["bound_ms"] for c in r["calls"])
        by_bytes = sum(c["bound_ms"] for c in r["calls"]
                       if c["bound_by"] == "bytes")
        r["bound_by"] = "bytes" if by_bytes >= r["bound_ms"] / 2 \
            else "operations"
        log(f"[phase 2] {name}: {len(r['calls'])} calls per served aifb "
            f"batch, kernel {r['ms']:.5f} ms on the device, wrapper "
            f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}), max abs err "
            f"{r['max_abs_err']:.3g}")
    return results


def edge_cases(torch, SK, TK, L, ops, R, run_compare, results):
    """Inputs the served batches may not produce, held to the same
    tolerances: -1 gathers in real slots, groups and node blocks without
    tiles, pow2 pad tiles, the scale epilogue, ``ops.edge_softmax`` on the
    card (K2 and its epilogue) against the oracle, and empty layouts."""
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
    n_err += 3
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
    yk = SK.segment_mm_gather_padded(
        torch.ones(4, 64, device=dev), torch.ones(4, 64, 8, device=dev),
        torch.zeros(0, dtype=torch.int32, device=dev),
        torch.zeros(1, dtype=torch.int32, device=dev), tile=32)
    torch.cuda.synchronize()
    check(y.shape == (0, 8) and z.shape == (8, 16) and not z.any()
          and yk.shape == (0, 8), "empty layouts: wrong outputs")
    check(ops.launch_counts() == before, "an empty layout launched a kernel")
    log(f"[phase 2] edge cases: {n_err + 4} kernel-vs-plain checks passed "
        f"(-1 gathers, empty groups and node blocks, pow2 pad tiles, scale "
        f"on/off, CUDA edge_softmax, k = 30 and 7, 8-row tiles and node "
        f"blocks, d = 5 and 300); empty layouts launched nothing")


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
    t0 = time.perf_counter()
    stats = serve_rgnn.serve(**cfg, device="cuda", on_batch=keep,
                             log=lambda m: log(f"[{tag}] {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    log(f"[{tag}] launches on the served path: {json.dumps(launches)}")
    for name, count in launches.items():
        check(count > 0, f"{tag}: {name} never launched on the served path")
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
        f"seeds/s, {stats['edges_per_batch']:.0f} edges/batch "
        f"(phase wall {wall:.2f} s)")
    keys = ("latency_ms_p50", "latency_ms_p95", "latency_ms_p99",
            "latency_ms_mean", "wait_ms_mean", "compute_ms_mean",
            "seeds_per_s", "edges_per_batch")
    return dict({k: stats[k] for k in keys}, launches=launches,
                max_abs_err_vs_cpu=worst, batches=len(batches))


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
    busy_us, per_kernel, top = 0.0, {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = _device_us(e)
        busy_us += t
        top[e.key[:60]] = (t, e.count)
        for name, meta in KERNELS.items():
            if meta["symbol"] in e.key:
                n0, t0 = per_kernel.get(name, (0, 0.0))
                per_kernel[name] = (n0 + e.count, t0 + t)
    check(busy_us > 0, f"{tag}: the profiler recorded no device time")
    out = {}
    for name in KERNELS:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every number as JSON to this path")
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
        from repro_torch.kernels import segment_mm as SK
        from repro_torch.kernels import traversal as TK
        from repro_torch.launch import serve_rgnn
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}",
              file=sys.stderr)
        return 2

    # phase 1: card and build
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

    try:
        kernels = phase_kernels(torch, hector_torch, SK, TK, L, R, ops)
        serve = phase_serve(torch, hector_torch, ops, serve_rgnn,
                            SERVE_DEFAULTS, "phase 3")
        large = phase_serve(torch, hector_torch, ops, serve_rgnn,
                            SERVE_LARGE, "phase 4")
        prof = {tag: phase_profile(torch, serve_rgnn, cfg, "phase 5 " + tag)
                for tag, cfg in (("aifb", SERVE_DEFAULTS),
                                 ("bgs", SERVE_LARGE))}
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    rows = []
    for name, meta in KERNELS.items():
        r = kernels[name]
        rows.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=serve["launches"][name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            wrapper_ms=r["wrapper_ms"],
            served_device_ms=prof["aifb"]["kernels"][name]
            ["device_ms_per_batch"]))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(
            card=card, build_s=build_s, kernels=kernels, serve=serve,
            serve_large=large, profile=prof, torch=torch.__version__,
            cuda=torch.version.cuda), indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
