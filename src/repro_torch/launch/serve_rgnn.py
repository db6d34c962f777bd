"""Batched RGNN inference serving driver of the PyTorch/CUDA port.

Request batches of seed nodes stream through the fanout sampler (with
``--sampler host``, prefetched on a background thread, kernel layouts
built on the host and copied to the card without blocking; with
``--sampler device``, selected and laid out on the card by the
``DeviceSampler``, dispatched one batch ahead with no thread and no
device-to-host synchronization), and a multi-layer Hector stack runs one
generated layer per sampled hop, returning per-seed logits. The
node-feature table lives on the device; each batch gathers its input rows by
``mb.input_ids``. Reports per-batch latency split into queue-wait
(sampling + layout, when not hidden by prefetch) and model compute, and
end-to-end seed throughput — the same lines and stats keys as
``repro.launch.serve_rgnn`` where they apply.

    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn --device cpu \\
        --dataset aifb --scale 0.05 --dim 16 --hidden 16 --classes 4
    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn --sampler device

The online runtime, autotuning, feature-store tiers, telemetry and
data-parallel serving are later slices.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import hector_torch
from repro_torch.core.graph import CPU_REDUCED_SCALES as REDUCED_SCALES
from repro_torch.core.graph import table3_graph
from repro_torch.sampling import SeedStream
from repro_torch.train.engine import (MODEL_PROGRAMS, parse_fanout,
                                      resolve_device)

# batches served before ``retraces_after_warmup`` starts counting
WARMUP_BATCHES = 2


def serve(
    model: str = "rgat",
    dataset: str = "aifb",
    scale: float = 1.0,
    layers: int = 2,
    dim: int = 64,
    hidden: int = 64,
    classes: int = 16,
    fanouts=None,
    batch_size: int = 32,
    num_batches: int = 8,
    tile: int = 32,
    node_block: int = 32,
    seed: int = 0,
    device=None,
    sampler: str = "host",
    params=None,
    on_batch=None,
    log=print,
):
    """Run the serving loop on ``device`` (``None``: the CUDA card); returns
    a stats dict.

    ``params`` overrides the seeded initialization with the reference's
    per-layer params as numpy arrays (checked against the plans).
    ``on_batch(mb, logits)`` is called after every batch. Every batch
    draws fresh seeds.
    """
    warmup_batches = min(WARMUP_BATCHES, num_batches)
    dev = resolve_device(device)

    t0 = time.perf_counter()
    graph = table3_graph(dataset, scale=scale, seed=seed)
    rng = np.random.default_rng(seed)
    feats_np = rng.normal(size=(graph.num_nodes, dim)).astype(np.float32)
    t_graph = time.perf_counter() - t0

    engine = hector_torch.compile(
        model, graph, layers=layers, dim=dim, hidden=hidden,
        classes=classes, sample=fanouts, tile=tile, node_block=node_block,
        seed=seed, device=dev, sampler=sampler)
    fanouts = engine.cfg.fanouts
    log(f"[serve_rgnn] {model} on {dataset} (scale {scale}): "
        f"{graph.num_nodes} nodes, {graph.num_edges} edges, "
        f"{graph.num_etypes} etypes; fanouts={fanouts} device={dev} "
        f"sampler={sampler} (graph build {t_graph:.2f}s)")
    params = engine.init(seed) if params is None else \
        engine.params_from_reference(params)
    feats = torch.from_numpy(feats_np).to(dev)   # the device feature table

    stream = SeedStream(graph.num_nodes, batch_size, seed=seed)
    loader = engine.make_loader(stream, num_batches=num_batches)
    executor = engine.block_executor
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    lat, waits, computes, preds = [], [], [], None
    edges_seen = 0
    traces_at_warmup = None
    dev_sampler = engine.device_sampler
    sampler_traces_at_warmup = sampler_syncs_at_warmup = None
    t_serve0 = time.perf_counter()
    try:
        while True:
            t0 = time.perf_counter()
            try:
                mb = next(loader)
            except StopIteration:
                break
            t_wait = time.perf_counter() - t0
            if len(lat) == warmup_batches:
                traces_at_warmup = executor.trace_count
                if dev_sampler is not None:
                    sampler_traces_at_warmup = dev_sampler.trace_count
                    sampler_syncs_at_warmup = dev_sampler.count_syncs
            t0 = time.perf_counter()
            logits = engine.apply_blocks(params, mb, feats)
            sync()
            t_fwd = time.perf_counter() - t0
            lat.append(t_wait + t_fwd)
            waits.append(t_wait)
            computes.append(t_fwd)
            edges_seen += sum(gt.num_edges for gt in mb.tensors)
            preds = torch.argmax(logits, dim=-1).cpu().numpy()
            if on_batch is not None:
                on_batch(mb, logits)
            hops = "+".join(str(b.num_src) for b in mb.seq.blocks)
            log(f"[serve_rgnn] batch {mb.step}: wait {t_wait*1e3:6.1f} ms, "
                f"forward {t_fwd*1e3:6.1f} ms  (block nodes {hops})")
    finally:
        loader.close()
    t_total = time.perf_counter() - t_serve0
    retraces_after_warmup = 0
    if traces_at_warmup is not None:
        retraces_after_warmup = executor.trace_count - traces_at_warmup

    n = len(lat)
    if n == 0:
        raise RuntimeError("no batches served")
    lat_arr = np.asarray(lat)
    stats = {
        "batches": n,
        "batch_size": batch_size,
        "latency_ms_p50": float(np.percentile(lat_arr, 50) * 1e3),
        "latency_ms_p95": float(np.percentile(lat_arr, 95) * 1e3),
        "latency_ms_p99": float(np.percentile(lat_arr, 99) * 1e3),
        "latency_ms_mean": float(lat_arr.mean() * 1e3),
        "wait_ms_mean": float(np.mean(waits) * 1e3),
        "compute_ms_mean": float(np.mean(computes) * 1e3),
        "seeds_per_s": batch_size * n / max(t_total, 1e-9),
        "edges_per_batch": edges_seen / n,
        "last_preds": preds,
        "warmup_batches": warmup_batches,
        "executor_traces": executor.trace_count,
        "executor_cache_hits": executor.cache_hits,
        "executor_compiled": executor.num_compiled,
        "retraces_after_warmup": retraces_after_warmup,
        "sampler": loader.mode,
        "host_builds": loader.host_builds,
        "device_builds": loader.device_builds,
        "device": str(dev),
    }
    if dev_sampler is not None:
        stats["sampler_traces"] = dev_sampler.trace_count
        stats["sampler_retraces_after_warmup"] = (
            dev_sampler.trace_count - sampler_traces_at_warmup
            if sampler_traces_at_warmup is not None else 0)
        stats["sampler_count_syncs"] = dev_sampler.count_syncs
        stats["sampler_count_syncs_after_warmup"] = (
            dev_sampler.count_syncs - sampler_syncs_at_warmup
            if sampler_syncs_at_warmup is not None
            else dev_sampler.count_syncs)
        stats["sampler_bucket_overflows"] = dev_sampler.bucket_overflows
        stats["sampler_bucket_shrinks"] = dev_sampler.bucket_shrinks
        stats["sampler_overflow_rebuilds"] = dev_sampler.overflow_rebuilds
    log(f"[serve_rgnn] served {n} batches x {batch_size} seeds: "
        f"latency p50 {stats['latency_ms_p50']:.1f} ms / "
        f"p95 {stats['latency_ms_p95']:.1f} ms / "
        f"p99 {stats['latency_ms_p99']:.1f} ms "
        f"(wait {stats['wait_ms_mean']:.1f} + "
        f"compute {stats['compute_ms_mean']:.1f} ms avg), "
        f"throughput {stats['seeds_per_s']:.1f} seeds/s, "
        f"avg {stats['edges_per_batch']:.0f} sampled edges/batch")
    log(f"[serve_rgnn] executor: {executor.trace_count} new signatures / "
        f"{executor.cache_hits} repeats "
        f"({retraces_after_warmup} new after warmup)")
    if dev_sampler is not None:
        log(f"[serve_rgnn] device sampler: {dev_sampler.trace_count} new "
            f"programs / {dev_sampler.cache_hits} program-cache hits "
            f"({stats['sampler_retraces_after_warmup']} new after "
            f"warmup); {dev_sampler.count_syncs} count syncs, "
            f"{dev_sampler.bucket_shrinks} bucket shrinks, "
            f"{dev_sampler.bucket_overflows} overflows "
            f"({dev_sampler.overflow_rebuilds} batches rebuilt); builds host "
            f"{loader.host_builds} / device {loader.device_builds}")
    log(f"[serve_rgnn] sample predictions: {preds[:12].tolist()}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="rgat", choices=sorted(MODEL_PROGRAMS))
    ap.add_argument("--dataset", default="aifb",
                    choices=sorted(REDUCED_SCALES))
    ap.add_argument("--scale", type=float, default=1.0,
                    help="dataset scale factor")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--fanout", default="5",
                    help="per-hop fanout, e.g. '5' or '5,10'; -1 = full")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-batches", type=int, default=8)
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--node-block", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; fails without a card) or "
                         "'cpu'")
    ap.add_argument("--sampler", default="host", choices=["host", "device"],
                    help="'host': NumPy sampling and layouts on a loader "
                         "thread; 'device': the DeviceSampler on --device")
    args = ap.parse_args(argv)
    return serve(
        model=args.model, dataset=args.dataset, scale=args.scale,
        layers=args.layers, dim=args.dim, hidden=args.hidden,
        classes=args.classes,
        fanouts=parse_fanout(args.fanout, args.layers),
        batch_size=args.batch_size, num_batches=args.num_batches,
        tile=args.tile, node_block=args.node_block, seed=args.seed,
        device=args.device, sampler=args.sampler,
    )


if __name__ == "__main__":
    main()
