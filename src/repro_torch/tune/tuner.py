"""The measurement-driven autotuner of the port (``repro.tune.tuner``'s
counterpart).

Per lowered op instance the tuner searches a small variant space
(``tile_rows`` / ``tile_n``, in-kernel gather on or off), per edge variable
COMPACT vs VANILLA materialization, and per graph the kernel-layout tile,
pruning with the ``tune/cost.py`` prior and deciding by timing the whole
lowered plan on the device (coordinate descent: one op's variant changes
at a time, so fusion interactions are measured, not modeled). Decisions
land in a ``TuningDecisions`` table and in the persistent ``TuneCache``; a
warm cache replays every decision with **zero** measurements.

Keys are never constructed here: one eager pass of the plan under
``torch.no_grad()`` with a recording decision table captures the exact key
strings codegen queries (the reference uses ``jax.eval_shape``; the CUDA
kernels cannot run on PyTorch's meta device), so a tuned decision cannot
miss its op through key drift.

Times are host wall clock around a call that ends in
``torch.cuda.synchronize()`` on a card (the reference's
``block_until_ready``): what a caller of the plan waits, host dispatch
included.

Modes:
  * ``off``    — the tuner is never built; the defaults everywhere.
  * ``cached`` — replay persisted decisions; never measure. Ops without a
                 cache entry keep the defaults.
  * ``full``   — replay persisted decisions; measure (and persist) the rest.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import codegen
from repro_torch.core.ir import passes
from repro_torch.feats import gather_input
from repro_torch.tune import cost
from repro_torch.tune import device as D
from repro_torch.tune import space as S
from repro_torch.tune.cache import TuneCache
from repro_torch.tune.decisions import TuningDecisions

MODES = ("off", "cached", "full")

# layout-tile candidates measured per graph (deduped against the caller's)
_LAYOUT_CANDIDATES = ((128, 128), (32, 32))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(fn, *args, device="cpu", warmup: int = 1, iters: int = 3,
            reduce: str = "median") -> float:
    """Wall clock of one candidate on ``device``: a first call and
    ``warmup`` untimed calls, then ``reduce`` ("median" or "min") over
    ``iters`` calls, each ended by a device synchronize."""
    for _ in range(1 + warmup):
        fn(*args)
        _sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts) if reduce == "min" else np.median(ts))


def measure_group(calls, device="cpu", warmup: int = 1,
                  iters: int = 3) -> List[float]:
    """Interleaved ``measure`` over a group of candidates whose timings
    will be compared: ``calls`` is a list of ``(fn, args_tuple)``. Every
    candidate is warmed first, then the timed iterations round-robin across
    the group, so slow clock drift lands on every candidate alike. Returns
    the per-candidate minimum."""
    for fn, args in calls:
        for _ in range(1 + warmup):
            fn(*args)
            _sync(device)
    ts: List[List[float]] = [[] for _ in calls]
    for _ in range(iters):
        for rec, (fn, args) in zip(ts, calls):
            t0 = time.perf_counter()
            fn(*args)
            _sync(device)
            rec.append(time.perf_counter() - t0)
    return [float(np.min(t)) for t in ts]


class _KeyRecorder:
    """Decision-table stand-in that records every key codegen queries."""

    def __init__(self):
        self.keys: List[str] = []

    def lookup(self, key: str):
        if key not in self.keys:
            self.keys.append(key)
        return None


@dataclasses.dataclass
class TuneReport:
    """What a tuned stack needs at build time."""

    decisions: TuningDecisions
    compact_vars: Optional[List[Optional[frozenset]]]  # per layer
    tile: int
    node_block: int
    graph_key: str


def graph_key(graph) -> str:
    """Graph identity for layout/materialization decisions."""
    return (f"g{graph.num_nodes}n{graph.num_edges}e{graph.num_etypes}"
            f"t{graph.num_ntypes}r{graph.entity_compaction_ratio:.3f}")


class Tuner:
    """Tunes the plans of one device. ``stats`` counts ``measurements``
    (timed candidates), ``cache_hits`` (decisions replayed from the cache)
    and ``tuned_ops`` (decisions measured and persisted)."""

    def __init__(self, mode: str = "cached", cache_path: Optional[str] = None,
                 warmup: int = 1, iters: int = 3, max_candidates: int = 4,
                 log=None, device="cpu"):
        if mode not in MODES:
            raise ValueError(f"tune mode {mode!r}; pick one of {MODES}")
        self.mode = mode
        self.device = torch.device(device)
        # the plan-wide backend of the keys: the device's kernels
        self.backend = self.device.type
        self.cache = TuneCache(cache_path)
        self.decisions = TuningDecisions()
        self.warmup = warmup
        self.iters = iters
        self.max_candidates = max_candidates
        self.log = log or (lambda *a, **k: None)
        self.stats: Dict[str, int] = {
            "measurements": 0, "cache_hits": 0, "tuned_ops": 0,
        }

    def _bump(self, key: str, n: int = 1) -> None:
        """Increment a tuner stat, mirrored into the obs metrics registry
        as ``tune_<key>``."""
        self.stats[key] += n
        obs.metrics().counter(f"tune_{key}").inc(n)

    # ------------------------------------------------------------------
    # measurement
    # ------------------------------------------------------------------
    def _time(self, fn) -> float:
        """Median wall clock of one candidate (a forward without autograd)."""
        self._bump("measurements")
        with torch.no_grad():
            return measure(fn, device=self.device, warmup=self.warmup,
                           iters=self.iters)

    def _plan_time(self, plan, params, gt, kl, feats, decisions) -> float:
        return self._time(lambda: codegen.execute_plan(
            plan, params, gt, feats, kl, decisions))

    # ------------------------------------------------------------------
    # the per-key decision loop (shared by plan- and block-scale tuning)
    # ------------------------------------------------------------------
    def _trial(self, key: str, variant) -> TuningDecisions:
        t = TuningDecisions(self.decisions.ops, self.decisions.materialization,
                            self.decisions.layout)
        t.set_op(key, variant)
        return t

    def _tune_keys(self, keys: Sequence[str], measure) -> None:
        """Decide every recorded key: cache replay first, measurement (in
        ``full`` mode) for the rest. ``measure(decisions) -> seconds``."""
        for key in keys:
            if self.decisions.lookup(key) is not None:
                continue                         # decided earlier this run
            cached = self.cache.get(key)
            if cached is not None:
                self._bump("cache_hits")
                self.decisions.set_op(key, S.variant_from_json(cached))
                continue
            if self.mode != "full":
                continue                         # cached mode: keep defaults
            cands = cost.prune(key, S.candidates_for_key(key, self.backend),
                               self.backend, self.max_candidates)
            best, best_t = cands[0], float("inf")
            if len(cands) > 1:
                for c in cands:
                    t = measure(self._trial(key, c))
                    self.log(f"[tune]   {key.split('|')[0]} {c} "
                             f"{t * 1e6:.0f}us")
                    if t < best_t:
                        best, best_t = c, t
            self.decisions.set_op(key, best)
            self.cache.put(key, best.to_json())
            self._bump("tuned_ops")

    def _record_keys(self, run) -> List[str]:
        """The keys codegen queries in ``run(recorder)``: one eager pass
        without autograd under a recording table."""
        rec = _KeyRecorder()
        with torch.no_grad():
            run(rec)
        _sync(self.device)
        return rec.keys

    # ------------------------------------------------------------------
    # full-graph stack tuning (layout tile -> materialization -> op variants)
    # ------------------------------------------------------------------
    def _params(self, plan, graph, seed: int):
        return codegen.init_params(
            plan, graph.num_etypes, graph.num_ntypes,
            torch.Generator().manual_seed(seed), device=self.device)

    def _layouts(self, graph, tile: int, node_block: int):
        return codegen.build_kernel_layouts(
            graph, tile=tile, node_block=node_block).to(self.device)

    def tune_stack(self, programs: Sequence, graph, *, tile: int = 128,
                   node_block: int = 128,
                   feat_dims: Optional[Sequence[int]] = None,
                   reorder: bool = True, compact: bool = True,
                   seed: int = 0, tune_layout: bool = True,
                   tune_ops: bool = True) -> TuneReport:
        """Tune a multi-layer stack over one graph on the tuner's device.
        ``feat_dims`` is each layer's input feature dimension.

        ``tune_layout`` / ``tune_ops`` gate the full-graph-only decision
        families: a caller that will only ever run the sampled block path
        (serving) keeps just the materialization decisions, which shape
        the lowered plans shared by both paths, and skips the full-graph
        layout and op measurements its traffic would never query."""
        if feat_dims is None:
            raise ValueError("tune_stack needs feat_dims (input dim per "
                             "layer)")
        if len(feat_dims) != len(programs):
            raise ValueError("one feat dim per layer program")
        gkey = graph_key(graph)
        gt = graph.to_tensors().to(self.device)
        rng = np.random.default_rng(seed)

        def feats_for(dim: int):
            return {"feature": torch.from_numpy(rng.normal(
                size=(graph.num_nodes, dim)).astype(np.float32)).to(
                    self.device)}

        # -- layout tile (per graph; all layers share the kernel layouts)
        if tune_layout:
            tile, node_block = self._tune_layout(
                programs[0], graph, gt, gkey, tile, node_block,
                feats_for(feat_dims[0]), reorder, compact, seed)
        kl = self._layouts(graph, tile, node_block)

        # -- per layer: materialization, then per-op variants
        compact_sets: List[Optional[frozenset]] = []
        for li, prog in enumerate(programs):
            feats = feats_for(feat_dims[li])
            cset = self._tune_materialization(
                prog, graph, gt, kl, gkey, feat_dims[li], feats, reorder,
                compact, seed)
            compact_sets.append(cset)
            if not tune_ops:
                continue
            plan = passes.lower_program(prog, reorder=reorder,
                                        compact=compact, compact_vars=cset)
            params = self._params(plan, graph, seed)
            keys = self._record_keys(lambda rec: codegen.execute_plan(
                plan, params, gt, feats, kl, rec))

            def measure(trial, pl=plan, pa=params, fe=feats):
                return self._plan_time(pl, pa, gt, kl, fe, trial)

            self._tune_keys(keys, measure)
        self.cache.save()
        self.log(f"[tune] stack tuned: {self.stats['tuned_ops']} measured "
                 f"ops, {self.stats['cache_hits']} cache replays, "
                 f"{self.stats['measurements']} measurements on "
                 f"{D.device_kind(self.device)} "
                 f"({D.device_limits(self.device)})")
        return TuneReport(decisions=self.decisions,
                          compact_vars=compact_sets, tile=tile,
                          node_block=node_block, graph_key=gkey)

    # ------------------------------------------------------------------
    def _tune_layout(self, prog, graph, gt, gkey, tile, node_block, feats,
                     reorder, compact, seed):
        key = f"lay|{gkey}|{self.backend}|{D.device_kind(self.device)}"
        cached = self.cache.get(key)
        if cached is not None:
            self._bump("cache_hits")
            self.decisions.set_layout(key, cached["tile"],
                                      cached["node_block"])
            return cached["tile"], cached["node_block"]
        if self.mode != "full":
            return tile, node_block
        plan = passes.lower_program(prog, reorder=reorder, compact=compact)
        params = self._params(plan, graph, seed)
        cands = [(tile, node_block)]
        cands += [c for c in _LAYOUT_CANDIDATES if c not in cands]
        best, best_t = cands[0], float("inf")
        for t, nb in cands:
            kl = self._layouts(graph, t, nb)
            dt = self._plan_time(plan, params, gt, kl, feats, None)
            self.log(f"[tune]   layout tile={t} node_block={nb} "
                     f"{dt * 1e6:.0f}us")
            if dt < best_t:
                best, best_t = (t, nb), dt
        self.decisions.set_layout(key, *best)
        self.cache.put(key, {"tile": best[0], "node_block": best[1]})
        return best

    # ------------------------------------------------------------------
    def _tune_materialization(self, prog, graph, gt, kl, gkey, feat_dim,
                              feats, reorder, compact, seed):
        """Per-edge-var COMPACT vs VANILLA, gated by the graph's
        entity-compaction ratio and decided by measurement (greedy one-var
        flips off the static default)."""
        cands = passes.compactable_edge_vars(prog, reorder=reorder)
        if not cands:
            return None
        key = (f"mat|{prog.name}|d{feat_dim}|{gkey}|{self.backend}|"
               f"{D.device_kind(self.device)}")
        cached = self.cache.get(key)
        if cached is not None and set(cached) == set(cands):
            self._bump("cache_hits")
            self.decisions.set_materialization(key, cached)
            return frozenset(v for v, m in cached.items() if m == "compact")
        if self.mode != "full":
            return None                          # keep the static policy
        ratio = gt.num_unique / max(1, gt.num_edges)
        # compaction dedups (src, etype) work; with no dedup available
        # (ratio ~1) the indirection can only cost — skip the measurements
        if ratio >= 0.999:
            current = {v: "vanilla" for v in cands}
            self.decisions.set_materialization(key, current)
            self.cache.put(key, current)
            return frozenset()
        current = {v: ("compact" if compact else "vanilla") for v in cands}
        base_t = self._mat_time(prog, graph, current, gt, kl, feats, reorder,
                                compact, seed)
        for v in cands:
            flipped = dict(current)
            flipped[v] = "vanilla" if current[v] == "compact" else "compact"
            t = self._mat_time(prog, graph, flipped, gt, kl, feats, reorder,
                               compact, seed)
            self.log(f"[tune]   mat {v}={flipped[v]} {t * 1e6:.0f}us "
                     f"(base {base_t * 1e6:.0f}us)")
            if t < base_t:
                current, base_t = flipped, t
        self.decisions.set_materialization(key, current)
        self.cache.put(key, current)
        self._bump("tuned_ops")
        return frozenset(v for v, m in current.items() if m == "compact")

    def _mat_time(self, prog, graph, per_var, gt, kl, feats, reorder,
                  compact, seed) -> float:
        cset = frozenset(v for v, m in per_var.items() if m == "compact")
        plan = passes.lower_program(prog, reorder=reorder, compact=compact,
                                    compact_vars=cset)
        params = self._params(plan, graph, seed)
        return self._plan_time(plan, params, gt, kl, feats, None)

    # ------------------------------------------------------------------
    # block-scale tuning (sampled serving / training mini-batches)
    # ------------------------------------------------------------------
    def tune_block_sequence(self, plans: Sequence, params, mb, global_feats,
                            *, activation: str = "relu") -> TuningDecisions:
        """Tune the op variants of a sampled block sequence on a
        representative ``MiniBatch`` (bucketed shapes make the decisions
        reusable across steady-state traffic). ``global_feats`` is the
        device table or a feature store (read without changing its
        state). Adds to ``self.decisions`` and persists; returns the
        table."""
        feats = gather_input(global_feats, mb, read_only=True)
        plans, params = list(plans), list(params)
        gts, kls = list(mb.tensors), list(mb.layouts)
        dst_locals = list(mb.dst_locals)

        def run(decisions):
            return codegen.execute_block_sequence(
                plans, params, gts, kls, dst_locals, mb.seed_perm, feats,
                activation, decisions)

        keys = self._record_keys(run)
        self._tune_keys(keys, lambda trial: self._time(lambda: run(trial)))
        self.cache.save()
        return self.decisions
