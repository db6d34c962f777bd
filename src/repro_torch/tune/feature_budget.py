"""Measured per-ntype split of the device feature-cache budget, as
``repro.tune.feature_budget``.

``CachedFeatureStore`` partitions its slot slab per ntype. The default
split (proportional to ntype populations) is wrong whenever traffic is
skewed: a small ntype can dominate the sampled input rows, and
population-proportional slots then thrash. ``measured_split`` probes a few
seed batches of the actual stream through the host ``FanoutSampler``
(host work only; no sampler state changes: selection keys are pure
functions of (seed, batch index)), counts each ntype's share of the
blocks' input rows and splits the budget by that traffic through
``feats.split_budget`` (capped at table sizes, remainder redistributed).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.graph import HeteroGraph
from repro_torch.feats.store import split_budget


def measured_split(graph: HeteroGraph, sampler, seed_source, budget: int,
                   probe_batches: int = 4,
                   start_step: int = 0) -> Tuple[np.ndarray, dict]:
    """Probe ``probe_batches`` seed batches and split ``budget`` cache
    rows across ntypes by observed input-row traffic.

    ``sampler`` is a host ``FanoutSampler``; ``seed_source`` is anything
    with ``batch(step)`` (or a ``step -> ids`` callable). Returns
    ``(per_ntype_slots [T], report)``, the report with the raw row counts
    so drivers can log the decision."""
    seeds_for = (seed_source.batch if hasattr(seed_source, "batch")
                 else seed_source)
    ptr = graph.ntype_ptr.astype(np.int64)
    counts = np.zeros(graph.num_ntypes, dtype=np.int64)
    for k in range(max(1, probe_batches)):
        seeds = np.asarray(seeds_for(start_step + k))
        seq = sampler.sample(seeds, batch_index=start_step + k)
        ids = np.asarray(seq.input_node_ids, dtype=np.int64)
        t = np.searchsorted(ptr, ids, side="right") - 1
        counts += np.bincount(t, minlength=graph.num_ntypes)
    weights: Optional[np.ndarray] = counts if counts.sum() else None
    slots = split_budget(graph, budget, weights=weights)
    report = {
        "probe_batches": int(max(1, probe_batches)),
        "row_counts": counts.tolist(),
        "populations": np.diff(graph.ntype_ptr).tolist(),
        "slots": slots.tolist(),
        "budget": int(budget),
    }
    return slots, report
