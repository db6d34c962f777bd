"""Batched RGNN inference serving driver of the PyTorch/CUDA port.

Request batches of seed nodes stream through the fanout sampler (with
``--sampler host``, prefetched on a background thread, kernel layouts
built on the host and copied to the card without blocking; with
``--sampler device``, selected and laid out on the card by the
``DeviceSampler``, dispatched one batch ahead with no thread and no
device-to-host synchronization), and a multi-layer Hector stack runs one
generated layer per sampled hop, returning per-seed logits.
``--feature-store`` picks where the node-feature table lives
(``repro_torch.feats``): ``device`` (the whole table on the card, the
default), ``host`` (per-ntype pinned host tables; only each batch's input
rows are copied, on the loader's producer) or ``cached`` (the host tier
behind a hot-row cache on the card of ``--feature-budget`` rows, default
table/4, its per-ntype split measured on the serving stream). With
``host`` or ``cached`` the whole table is never put on the card; the
logits are the same bit for bit across the three. Reports per-batch latency split into queue-wait
(sampling + layout, when not hidden by prefetch) and model compute, and
end-to-end seed throughput — the same lines and stats keys as
``repro.launch.serve_rgnn`` where they apply.

    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn --device cpu \\
        --dataset aifb --scale 0.05 --dim 16 --hidden 16 --classes 4
    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn --sampler device
    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn --tune full
    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn \
        --feature-store cached --feature-budget 4096 --skew 1.2

The batch loop runs the block executor's captured CUDA graphs on the
card, one per bucketed signature, captured at the signature's second
batch and replayed from then on (``--eager``: op by op). ``--repeat-after N`` wraps the seed stream onto N
distinct batches (the reference's repeating traffic; 0: fresh seeds every
batch), ``--skew ALPHA`` draws the seeds from a Zipf law, and
``--cache-blocks`` / ``--cache-layouts`` size the loader's sampled-block
and kernel-layout LRU caches, whose hit rates the stats report.
``warmup_batches`` (default ``repeat_after`` or 2) splits the key counts:
new keys after it are ``retraces_after_warmup``.

    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn --device cpu \
        --scale 0.05 --repeat-after 4 --cache-blocks 64 --cache-layouts 256

``--tune full|cached`` runs the autotuner on the serving device: the
materialization decisions at engine build (no full-graph layout or op
measurements: serving never runs the full graph), then the block-scale op
variants on one warm mini-batch off the serving stream; ``--tune-cache``
names its persistent cache.

Telemetry (``repro_torch.obs``), as the reference's: ``--obs on`` (the
default) serves inside a metrics scope — the ``serve_batch_ms`` /
``serve_wait_ms`` / ``serve_compute_ms`` histograms, whose p50 / p95 / p99
become the reported latencies, and the executor, sampler and tuner
counters, returned as ``stats["metrics"]`` and written to
``--metrics-out``; ``--trace-out PATH`` adds the ``wait`` / ``sample`` /
``layout`` / ``execute`` (``sample_device`` / ``layout_device``) phase
spans as a Chrome trace; ``--profile`` attributes the last batch op by op
(``stats["profile"]``); ``--obs off`` records nothing. Metrics add no
device synchronize; tracing adds one per ``execute`` span.

    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn --device cpu \\
        --scale 0.05 --trace-out trace.json --metrics-out metrics.json \\
        --profile

``--runtime online`` serves open-loop request traffic through the async
``repro_torch.serve.ServingRuntime`` instead of the batch loop (the
reference's online mode): seeded ``--arrivals poisson|burst|uniform`` at
``--rate`` req/s, ``--requests`` of ``--sizes`` seeds each under a
``--slo-ms`` budget, coalesced by deadline into the rungs of a measured
``--ladder fine|pow2`` up to ``--batch-size``, holding a partial batch at
most ``--max-wait-ms``; ``--speedup`` compresses the schedule. It reports
per-request latency percentiles, SLO attainment, queue depth, rung
occupancy and the zero-retrace counters (and, on a card, the graphs
captured after warm-up).

    PYTHONPATH=src python -m repro_torch.launch.serve_rgnn --runtime online \\
        --device cpu --scale 0.05 --fanout 3 --dim 8 --hidden 8 \\
        --classes 4 --tile 8 --node-block 8 --rate 200 --requests 24 \\
        --slo-ms 3000 --sizes 1,2,4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import hector_torch
from repro_torch import obs
from repro_torch.core.graph import CPU_REDUCED_SCALES as REDUCED_SCALES
from repro_torch.core.graph import table3_graph
from repro_torch.launch import obs_report, obs_scope
from repro_torch.sampling import SeedStream
from repro_torch.train.engine import (MODEL_PROGRAMS, parse_fanout,
                                      resolve_device)

# batches served before ``retraces_after_warmup`` starts counting, when
# the stream does not repeat
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
    feature_store: str = "device",
    feature_budget=None,
    tune: str = "off",
    tune_cache=None,
    skew=None,
    cache_blocks: int = 0,
    cache_layouts: int = 0,
    repeat_after=None,
    compiled: bool = True,
    warmup_batches=None,
    obs_mode: str = "on",
    trace_out=None,
    metrics_out=None,
    profile: bool = False,
    params=None,
    on_batch=None,
    log=print,
):
    """Run the serving loop on ``device`` (``None``: the CUDA card); returns
    a stats dict.

    ``params`` overrides the seeded initialization with the reference's
    per-layer params as numpy arrays (checked against the plans).
    ``on_batch(mb, logits)`` is called after every batch. ``tune`` /
    ``tune_cache`` as ``--tune`` / ``--tune-cache``; the tuner's counts
    land in the stats as ``tune_*``. ``feature_store`` /
    ``feature_budget`` as ``--feature-store`` / ``--feature-budget``; the
    store's stats land as ``feature_*``.

    ``repeat_after`` wraps the seed stream onto that many distinct batches
    (``None``: fresh seeds every batch), ``skew`` draws Zipf-skewed seeds,
    ``cache_blocks`` / ``cache_layouts`` size the loader's LRU caches (0:
    off), as the reference's. ``warmup_batches`` (default
    ``repeat_after`` or 2) splits the key counts: new keys after it count
    as ``retraces_after_warmup``. ``compiled=False`` runs every batch op
    by op instead of replaying the captured graphs.

    Observability: with ``obs_mode="on"`` the call runs inside an
    ``obs.scope`` — latency histograms and executor / sampler / tuner
    counters land in a metrics registry whose snapshot is returned as
    ``stats["metrics"]`` (and written to ``metrics_out`` if given), and
    its percentiles replace the array-side ones. ``trace_out``
    additionally enables phase tracing (``wait`` / ``sample`` / ``layout``
    / ``execute`` spans; the phase totals as ``stats["phases"]``) and
    writes a Chrome-trace JSON there. ``profile=True`` runs the per-op
    plan profiler on the last served mini-batch and attaches the breakdown
    as ``stats["profile"]``. ``obs_mode="off"`` serves with observability
    fully disabled. Logits and signature counts are the same in every
    mode.
    """
    if warmup_batches is None:
        warmup_batches = repeat_after if repeat_after else WARMUP_BATCHES
    warmup_batches = min(warmup_batches, num_batches)
    with obs_scope(obs_mode, trace_out) as sc:
        dev = resolve_device(device)

        t0 = time.perf_counter()
        graph = table3_graph(dataset, scale=scale, seed=seed)
        rng = np.random.default_rng(seed)
        feats_np = rng.normal(size=(graph.num_nodes, dim)).astype(
            np.float32)
        t_graph = time.perf_counter() - t0

        engine = hector_torch.compile(
            model, graph, layers=layers, dim=dim, hidden=hidden,
            classes=classes, sample=fanouts, tile=tile,
            node_block=node_block, seed=seed, device=dev, sampler=sampler,
            feature_store=feature_store, feature_budget=feature_budget,
            tune=tune, tune_cache=tune_cache, tune_full_graph=False, log=log)
        fanouts = engine.cfg.fanouts
        log(f"[serve_rgnn] {model} on {dataset} (scale {scale}): "
            f"{graph.num_nodes} nodes, {graph.num_edges} edges, "
            f"{graph.num_etypes} etypes; fanouts={fanouts} device={dev} "
            f"sampler={sampler} feature_store={feature_store}"
            + (f" skew={skew}" if skew else "")
            + f" (graph build {t_graph:.2f}s)")
        params = engine.init(seed) if params is None else \
            engine.params_from_reference(params)

        stream = SeedStream(graph.num_nodes, batch_size, seed=seed,
                            num_distinct=repeat_after, zipf_alpha=skew)
        # the feature store (the device tier holds the whole table on the
        # device, the others never do); the cached tier's per-ntype split
        # is measured on this stream
        store = engine.make_feature_store(feats_np, seed_source=stream)
        if feature_store == "cached":
            log(f"[serve_rgnn] feature cache: {store.capacity} device rows "
                f"({store.device_bytes() / 1e6:.2f} MB vs full table "
                f"{store.table_bytes / 1e6:.2f} MB), per-ntype slots "
                f"{store.slot_ptr.tolist()}")

        if tune != "off":
            # block-scale tuning on one representative (bucketed)
            # mini-batch, off the serving stream so traffic is untouched;
            # with a warm persistent cache this replays decisions with zero
            # measurements
            warm_seeds = np.random.default_rng(seed + 1).integers(
                0, graph.num_nodes, batch_size).astype(np.int32)
            tl = engine.make_loader(lambda step: warm_seeds, num_batches=1)
            try:
                # the store is read without changing its state
                engine.tune_minibatch(params, next(tl), store)
            finally:
                tl.close()
            ts = engine.tuner_stats
            log(f"[serve_rgnn] tune={tune}: {ts['measurements']} "
                f"measurements, {ts['cache_hits']} cache replays, "
                f"{ts['tuned_ops']} tuned")

        loader = engine.make_loader(stream, num_batches=num_batches,
                                    cache_blocks=cache_blocks,
                                    cache_layouts=cache_layouts,
                                    feature_store=store)
        executor = engine.block_executor
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
            else (lambda: None)
        metrics = obs.metrics()
        h_lat = metrics.histogram("serve_batch_ms")
        h_wait = metrics.histogram("serve_wait_ms")
        h_compute = metrics.histogram("serve_compute_ms")
        lat, waits, computes, preds = [], [], [], None
        last_mb = None
        edges_seen = 0
        traces_at_warmup = None
        dev_sampler = engine.device_sampler
        sampler_traces_at_warmup = sampler_syncs_at_warmup = None
        t_serve0 = time.perf_counter()
        try:
            while True:
                t0 = time.perf_counter()
                with obs.span("wait", batch=len(lat)):
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
                # engine.apply_blocks opens the "execute" span (with a
                # device sync inside it when tracing is on); the batch's
                # rows came with it (mb.feats, gathered by the producer)
                logits = engine.apply_blocks(params, mb, store,
                                             compiled=compiled)
                sync()
                t_fwd = time.perf_counter() - t0
                lat.append(t_wait + t_fwd)
                waits.append(t_wait)
                computes.append(t_fwd)
                h_lat.observe((t_wait + t_fwd) * 1e3)
                h_wait.observe(t_wait * 1e3)
                h_compute.observe(t_fwd * 1e3)
                last_mb = mb
                edges_seen += sum(gt.num_edges for gt in mb.tensors)
                preds = torch.argmax(logits, dim=-1).cpu().numpy()
                if on_batch is not None:
                    on_batch(mb, logits)
                hops = "+".join(str(b.num_src) for b in mb.seq.blocks)
                log(f"[serve_rgnn] batch {mb.step}: wait "
                    f"{t_wait*1e3:6.1f} ms, forward {t_fwd*1e3:6.1f} ms  "
                    f"(block nodes {hops})")
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
            "batch_latency_ms": [float(x * 1e3) for x in lat],
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
            "executor_captures": executor.captures,
            "executor_replays": executor.replays,
            "device": str(dev),
        }
        for name, cs in loader.cache_stats().items():
            stats[f"{name}_hits"] = cs["hits"]
            stats[f"{name}_misses"] = cs["misses"]
            stats[f"{name}_hit_rate"] = cs["hit_rate"]
        for k, v in engine.tuner_stats.items():
            stats[f"tune_{k}"] = v
        if engine.decisions is not None:
            stats["tune_decisions"] = engine.decisions.fingerprint()
        for k, v in store.stats().items():
            stats[f"feature_{k}"] = v
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
            stats["sampler_overflow_rebuilds"] = \
                dev_sampler.overflow_rebuilds
        if obs.metrics_enabled():
            # registry-sourced latency percentiles (the reservoir keeps every
            # sample at this scale, so these match the array-side numbers)
            hs = metrics.histogram_summary("serve_batch_ms")
            stats["latency_ms_p50"] = hs["p50"]
            stats["latency_ms_p95"] = hs["p95"]
            stats["latency_ms_p99"] = hs["p99"]
        if feature_store != "device":
            log(f"[serve_rgnn] feature store ({feature_store}): "
                f"{store.host_gathers} host gathers, "
                f"{store.bytes_moved / 1e6:.2f} MB moved"
                + (f", hit rate {store.hit_rate:.0%} "
                   f"({store.evictions} evictions, {store.overflows} "
                   f"overflows)" if feature_store == "cached" else ""))
        log(f"[serve_rgnn] served {n} batches x {batch_size} seeds: "
            f"latency p50 {stats['latency_ms_p50']:.1f} ms / "
            f"p95 {stats['latency_ms_p95']:.1f} ms / "
            f"p99 {stats['latency_ms_p99']:.1f} ms "
            f"(wait {stats['wait_ms_mean']:.1f} + "
            f"compute {stats['compute_ms_mean']:.1f} ms avg), "
            f"throughput {stats['seeds_per_s']:.1f} seeds/s, "
            f"avg {stats['edges_per_batch']:.0f} sampled edges/batch")
        log(f"[serve_rgnn] executor: {executor.trace_count} new signatures "
            f"/ {executor.cache_hits} repeats "
            f"({retraces_after_warmup} new after warmup), "
            f"{executor.captures} graphs captured"
            + "".join(f", {k.removesuffix('_hit_rate')} hit rate {v:.0%}"
                      for k, v in stats.items()
                      if k.endswith("_cache_hit_rate")))
        if dev_sampler is not None:
            log(f"[serve_rgnn] device sampler: {dev_sampler.trace_count} new "
                f"programs / {dev_sampler.cache_hits} program-cache hits "
                f"({stats['sampler_retraces_after_warmup']} new after "
                f"warmup); {dev_sampler.count_syncs} count syncs, "
                f"{dev_sampler.bucket_shrinks} bucket shrinks, "
                f"{dev_sampler.bucket_overflows} overflows "
                f"({dev_sampler.overflow_rebuilds} batches rebuilt); builds "
                f"host {loader.host_builds} / device {loader.device_builds}")
        log(f"[serve_rgnn] sample predictions: {preds[:12].tolist()}")

        if profile and last_mb is not None:
            p = engine.profile(params, last_mb, store, warmup=1, iters=5)
            log("[serve_rgnn] per-op kernel breakdown (last batch):\n"
                + p.table())
            stats["profile"] = p.to_json()
        obs_report(sc, stats, trace_out, metrics_out, log, "serve_rgnn")
        return stats


def serve_online(
    model: str = "rgat",
    dataset: str = "aifb",
    scale: float = 1.0,
    layers: int = 2,
    dim: int = 64,
    hidden: int = 64,
    classes: int = 16,
    fanouts=None,
    tile: int = 32,
    node_block: int = 32,
    seed: int = 0,
    device=None,
    sampler: str = "host",
    feature_store: str = "device",
    feature_budget=None,
    skew=None,
    prefetch_depth: int = 2,
    cache_layouts: int = 64,
    rate_rps: float = 100.0,
    num_requests: int = 64,
    process: str = "poisson",
    burst_size: int = 4,
    slo_ms=1000.0,
    size_choices=(1, 2, 4, 8),
    max_batch: int = 32,
    max_wait_ms: float = 5.0,
    ladder_kind: str = "fine",
    speedup: float = 1.0,
    obs_mode: str = "on",
    trace_out=None,
    metrics_out=None,
    on_runtime=None,
    log=print,
):
    """Online serving on ``device`` (``None``: the CUDA card): open-loop
    request traffic through the async ``ServingRuntime`` (deadline-aware
    coalescing, prefetch-overlapped execution on the runtime's execute
    thread) instead of the batch loop. Returns the runtime's stats dict —
    per-request latency percentiles, SLO attainment, queue depth, rung
    occupancy, the zero-retrace counters — with ``submitted`` and
    ``requests_per_s``. ``on_runtime(runtime)`` is called once the runtime
    is built, before its calibration."""
    from repro_torch.serve import OpenLoopLoad, ServingRuntime, ladder

    with obs_scope(obs_mode, trace_out) as sc:
        dev = resolve_device(device)
        t0 = time.perf_counter()
        graph = table3_graph(dataset, scale=scale, seed=seed)
        rng = np.random.default_rng(seed)
        feats = rng.normal(size=(graph.num_nodes, dim)).astype(np.float32)
        engine = hector_torch.compile(
            model, graph, layers=layers, dim=dim, hidden=hidden,
            classes=classes, sample=fanouts, tile=tile,
            node_block=node_block, bucket=True, seed=seed, device=dev,
            sampler=sampler, feature_store=feature_store,
            feature_budget=feature_budget, tune_full_graph=False, log=log)
        params = engine.init(seed)
        store = engine.make_feature_store(feats)
        rungs = ladder(max_batch, ladder_kind)
        log(f"[serve_rgnn] online: {model} on {dataset} (scale {scale}), "
            f"ladder {rungs}, {rate_rps:g} req/s x {num_requests} "
            f"({process}), SLO {slo_ms} ms, device={dev} sampler={sampler} "
            f"feature_store={feature_store} "
            f"(setup {time.perf_counter() - t0:.2f}s)")

        rt = ServingRuntime(
            engine, params, store, name=model, rungs=rungs,
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            depth=prefetch_depth, cache_layouts=cache_layouts)
        if on_runtime is not None:
            on_runtime(rt)
        try:
            # floors at the probed maxima (hub probes included), without
            # the reference's extra pow2 level: every block is padded to
            # them on the host, so that level doubles the loader's work
            # for each batch, which bounds the request rate the runtime
            # sustains (PERF.md, phase 16)
            rt.calibrate(floor_margin=0, log=log)
            load = OpenLoopLoad(
                graph.num_nodes, rate_rps=rate_rps,
                num_requests=num_requests, process=process,
                burst_size=burst_size, size_choices=size_choices,
                slo_ms=slo_ms, zipf_alpha=skew, seed=seed)
            t_load0 = time.perf_counter()
            submitted = load.replay(rt.submit, speedup=speedup)
            rt.drain()
            t_load = time.perf_counter() - t_load0
        finally:
            rt.close()

        stats = rt.stats()
        stats["submitted"] = submitted
        stats["requests_per_s"] = submitted / max(t_load, 1e-9)
        stats["device"] = str(dev)
        log(f"[serve_rgnn] online: {submitted} requests in {t_load:.2f}s "
            f"({stats['requests_per_s']:.1f} req/s): "
            f"latency p50 {stats['latency_ms_p50']:.1f} ms / "
            f"p99 {stats['latency_ms_p99']:.1f} ms, "
            f"SLO attainment {stats['slo_attainment']:.1%}, "
            f"queue depth max {stats['queue_depth_max']}, "
            f"{stats['batches']} batches "
            f"(fill {stats['batch_fill']:.0%}, rungs {stats['rung_counts']})")
        log(f"[serve_rgnn] online executor: {stats['executor_traces']} "
            f"keys, {stats['retraces_after_warmup']} new after warmup, "
            f"{stats['executor_captures']} graphs captured "
            f"({stats['captures_after_warmup']} after warmup), "
            f"{stats['shape_floor_growths']} shape-floor growths")
        obs_report(sc, stats, trace_out, metrics_out, log, "serve_rgnn")
        return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runtime", default="loop", choices=["loop", "online"],
                    help="'loop': the batch loop over a seed stream; "
                         "'online': open-loop request traffic through the "
                         "async serving runtime (deadline-aware coalescing, "
                         "per-request SLOs)")
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
    ap.add_argument("--feature-store", default="device",
                    choices=["device", "host", "cached"],
                    help="where the node-feature table lives: 'device' = "
                         "the whole table on --device; 'host' = pinned "
                         "per-ntype host tables, only sampled rows copied "
                         "(on the loader's producer); 'cached' = host tier "
                         "+ a fixed-budget hot-row cache on --device. "
                         "Logits are the same bit for bit across the three")
    ap.add_argument("--feature-budget", type=int, default=None,
                    help="device hot-row count for --feature-store cached "
                         "(default: num_nodes / 4); the per-ntype split is "
                         "measured on the serving stream")
    ap.add_argument("--skew", type=float, default=None, metavar="ALPHA",
                    help="Zipf exponent for the seed stream (power-law "
                         "traffic; popularity rank r drawn with p ~ "
                         "(r+1)^-ALPHA). Default: uniform")
    ap.add_argument("--cache-blocks", type=int, default=0,
                    help="LRU capacity of the sampled-block cache keyed by "
                         "(seeds, fanout); 0 disables")
    ap.add_argument("--cache-layouts", type=int, default=0,
                    help="LRU capacity of the KernelLayouts cache keyed by "
                         "block signature; 0 disables")
    ap.add_argument("--repeat-after", type=int, default=4,
                    help="wrap the seed stream onto N distinct batches "
                         "(repeating traffic; every distinct batch is "
                         "seen during warmup, so steady state adds no "
                         "key). 0 = fresh random seeds every batch")
    ap.add_argument("--eager", action="store_true",
                    help="run every batch op by op instead of replaying "
                         "the block executor's captured CUDA graphs")
    ap.add_argument("--tune", default="off", choices=["off", "cached", "full"],
                    help="autotune on --device: 'full' measures what the "
                         "cache lacks, 'cached' replays it, 'off' keeps the "
                         "defaults")
    ap.add_argument("--tune-cache", default=None,
                    help="tuning cache path (default "
                         "$REPRO_TORCH_TUNE_CACHE or "
                         "~/.cache/repro_torch-tune.json)")
    ap.add_argument("--obs", default="on", choices=["on", "off"],
                    help="observability: 'on' runs inside an obs scope "
                         "(metrics registry + stats['metrics']); 'off' "
                         "records nothing")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable phase tracing and write a Chrome-trace "
                         "JSON (load in chrome://tracing or Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="per-op kernel-time breakdown of the last served "
                         "batch")
    online = ap.add_argument_group("online runtime (--runtime online)")
    online.add_argument("--rate", type=float, default=100.0,
                        help="average request arrival rate (req/s)")
    online.add_argument("--requests", type=int, default=64,
                        help="number of requests to replay")
    online.add_argument("--arrivals", default="poisson",
                        choices=["poisson", "burst", "uniform"],
                        help="arrival process (open loop: arrivals never "
                             "wait on completions)")
    online.add_argument("--burst-size", type=int, default=4,
                        help="requests per burst for --arrivals burst")
    online.add_argument("--slo-ms", type=float, default=1000.0,
                        help="per-request latency budget; admission "
                             "rejects requests that cannot make it")
    online.add_argument("--sizes", default="1,2,4,8",
                        help="comma-separated request sizes (seeds per "
                             "request)")
    online.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="coalescer hold time before dispatching a "
                             "partial batch")
    online.add_argument("--ladder", default="fine", choices=["fine", "pow2"],
                        help="batch-size rung ladder up to --batch-size: "
                             "'fine' = {2^k, 3*2^k} validated against "
                             "measured latency, 'pow2' = powers of two only")
    online.add_argument("--speedup", type=float, default=1.0,
                        help="compress the arrival schedule by this factor")
    args = ap.parse_args(argv)
    if args.runtime == "online":
        return serve_online(
            model=args.model, dataset=args.dataset, scale=args.scale,
            layers=args.layers, dim=args.dim, hidden=args.hidden,
            classes=args.classes,
            fanouts=parse_fanout(args.fanout, args.layers),
            tile=args.tile, node_block=args.node_block, seed=args.seed,
            device=args.device, sampler=args.sampler,
            feature_store=args.feature_store,
            feature_budget=args.feature_budget, skew=args.skew,
            cache_layouts=args.cache_layouts or 64, rate_rps=args.rate,
            num_requests=args.requests, process=args.arrivals,
            burst_size=args.burst_size, slo_ms=args.slo_ms,
            size_choices=tuple(int(x) for x in args.sizes.split(",")),
            max_batch=args.batch_size, max_wait_ms=args.max_wait_ms,
            ladder_kind=args.ladder, speedup=args.speedup,
            obs_mode=args.obs, trace_out=args.trace_out,
            metrics_out=args.metrics_out)
    return serve(
        model=args.model, dataset=args.dataset, scale=args.scale,
        layers=args.layers, dim=args.dim, hidden=args.hidden,
        classes=args.classes,
        fanouts=parse_fanout(args.fanout, args.layers),
        batch_size=args.batch_size, num_batches=args.num_batches,
        tile=args.tile, node_block=args.node_block, seed=args.seed,
        device=args.device, sampler=args.sampler,
        feature_store=args.feature_store,
        feature_budget=args.feature_budget, tune=args.tune,
        tune_cache=args.tune_cache, skew=args.skew,
        cache_blocks=args.cache_blocks, cache_layouts=args.cache_layouts,
        repeat_after=args.repeat_after or None, compiled=not args.eager,
        obs_mode=args.obs,
        trace_out=args.trace_out, metrics_out=args.metrics_out,
        profile=args.profile,
    )


if __name__ == "__main__":
    main()
