"""The port's own copy of ``repro.sampling.bucketing``.

Shape bucketing for sampled blocks (the serving fast path).

Every sampled block has fresh (node, edge, unique-pair) counts, so each
mini-batch would otherwise trigger fresh XLA compilations — multi-second
stalls that dwarf the actual forward pass on every request. Bucketing pads
each block graph to power-of-two sizes with *inert* pad structure, so the
set of compiled shapes is logarithmic in graph size and serving hits warm
caches after the first few batches.

Pad structure is numerically invisible to real outputs:

* pad nodes carry the max node type (keeps the presorted-by-type invariant)
  and only appear as endpoints of pad edges;
* pad edges connect pad sources to the first pad node, so they aggregate
  into pad destination rows only;
* pad (src, etype) pairs are chosen distinct until the unique-pair table
  reaches its bucket, then one pair is repeated — giving exact control of
  the compact-materialization table size.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import HeteroGraph
from repro_torch.kernels.layout import pow2ceil


def pad_block_graph(bg: HeteroGraph, n_target: int = 0, e_target: int = 0,
                    u_target: int = 0) -> HeteroGraph:
    """Return ``bg`` padded so nodes/edges/unique-pairs hit power-of-two
    buckets. The first ``bg.num_nodes`` node IDs and all real edges keep
    their meaning; everything is rebuilt via ``from_edges`` so every derived
    product (CSR, compact map, segment pointers) stays consistent.

    ``n_target``/``e_target``/``u_target`` raise the buckets to explicit
    power-of-two sizes (the cross-shard stacking path pads every shard's
    block to the max bucket over shards so the per-hop pytrees stack into
    one ``[P, ...]`` array set); 0 keeps the block's own bucket."""
    n, e, u = bg.num_nodes, bg.num_edges, bg.num_unique
    num_r, num_t = bg.num_etypes, bg.num_ntypes

    u_pad = max(pow2ceil(u + 1), u_target)  # +1: >= 1 pad pair to spend
    k_u = u_pad - u                  # distinct pad (src, etype) pairs needed
    e_pad = max(pow2ceil(e + k_u), e_target)
    k_e = e_pad - e
    n_extra = max(1, -(-k_u // num_r))   # pad sources to host k_u pairs
    n_pad = max(pow2ceil(n + n_extra), n_target)

    # distinct pad pairs first, then repeats of pair 0 up to the edge bucket
    pair_src = (n + np.arange(k_u, dtype=np.int64) // num_r).astype(np.int32)
    pair_et = (np.arange(k_u, dtype=np.int64) % num_r).astype(np.int32)
    pick = np.concatenate([np.arange(k_u, dtype=np.int64),
                           np.zeros(k_e - k_u, dtype=np.int64)])
    pad_src = pair_src[pick]
    pad_et = pair_et[pick]
    pad_dst = np.full(k_e, n, dtype=np.int32)  # all into the first pad node

    node_type = np.concatenate([
        bg.node_type,
        np.full(n_pad - n, num_t - 1, dtype=np.int32),
    ])
    hg = HeteroGraph.from_edges(
        np.concatenate([bg.src, pad_src]),
        np.concatenate([bg.dst, pad_dst]),
        np.concatenate([bg.etype, pad_et]),
        num_nodes=n_pad,
        num_etypes=num_r,
        node_type=node_type,
        num_ntypes=num_t,
    )
    assert hg.num_edges == e_pad and hg.num_unique == u_pad, (
        hg.num_edges, e_pad, hg.num_unique, u_pad)
    return hg


class LayoutRowFloors(dict):
    """Grow-only floors for layout-internal row buckets.

    ``build_kernel_layouts`` pads segment layouts to
    ``pow2ceil(sum_seg ceil(count / tile) * tile)`` — a quantity that moves
    with the *distribution* of edges across segments, not just the padded
    totals, so two blocks with identical (n, e, u) buckets can still land
    in different layout row buckets and retrace. This maps a layout field
    name to the largest row bucket seen; ``raise_to`` is the grow-only
    clamp the layout builder calls per field."""

    def __init__(self, owner=None):
        super().__init__()
        self._owner = owner

    def raise_to(self, name: str, rows: int) -> int:
        cur = self.get(name, 0)
        if rows <= cur:
            return cur
        if name in self and self._owner is not None:
            self._owner.growths += 1
        self[name] = rows
        return rows


class ShapeFloors:
    """Grow-only bucket floors, keyed by (batch key, hop).

    Open-loop serving pads every admitted batch to a ladder rung, but the
    *sampled* block shapes at one rung still jitter across pow2 buckets
    (per-hop node/edge counts land on either side of a bucket boundary),
    so every new bucket combination is a fresh XLA compile — a
    multi-hundred-ms latency spike in the middle of traffic. A
    ``ShapeFloors`` remembers, per key and hop, the largest bucket seen so
    far and pads every later block *up* to it: shapes converge to one
    compiled set per key, and since a floor only ever grows (by whole
    pow2 buckets, so log-many times at most), steady-state retraces reach
    zero instead of recurring forever.

    Single-writer: owned by one loader's producer thread (the serving
    runtime passes a fresh instance per tenant). Callers using a
    sampled-block cache should key it off the same floors epoch or leave
    it disabled — a cached batch replays the shapes it was built under.
    """

    def __init__(self):
        self._graph = {}    # (key, hop) -> [n, e, u] floors
        self._layout = {}   # (key, hop) -> LayoutRowFloors
        self._tail = {}     # key -> final dst_local bucket floor
        self.growths = 0    # floor raises after the first sighting of a key

    def pad_graph(self, key, hop: int, g: HeteroGraph) -> HeteroGraph:
        f = self._graph.get((key, hop))
        hg = pad_block_graph(g, *(f if f is not None else (0, 0, 0)))
        grown = (hg.num_nodes, hg.num_edges, hg.num_unique)
        if f is None:
            self._graph[(key, hop)] = list(grown)
        elif grown != tuple(f):
            self._graph[(key, hop)] = list(grown)
            self.growths += 1
        return hg

    def layout_floors(self, key, hop: int) -> LayoutRowFloors:
        lf = self._layout.get((key, hop))
        if lf is None:
            lf = LayoutRowFloors(self)
            self._layout[(key, hop)] = lf
        return lf

    def pad_tail(self, key, n: int) -> int:
        t = max(self._tail.get(key, 0), pow2ceil(max(1, n)))
        if key in self._tail and t > self._tail[key]:
            self.growths += 1
        self._tail[key] = t
        return t

    def bump(self, levels: int = 1) -> None:
        """Raise every floor by ``levels`` pow2 buckets — headroom so the
        probed maximum is not the compiled ceiling. A serving calibration
        pass probes floors on sampled traffic, bumps once, and thereafter
        a floor growth (i.e. a retrace) needs a batch beyond *double* the
        largest probed bucket."""
        if levels <= 0:
            return
        for f in self._graph.values():
            f[0] <<= levels
            f[1] <<= levels
            f[2] <<= levels
        for lf in self._layout.values():
            for k in lf:
                lf[k] <<= levels
        for k in self._tail:
            self._tail[k] <<= levels


def pad_index(idx: np.ndarray, target: int, fill: int = 0) -> np.ndarray:
    """Pad a gather-index vector to ``target`` entries with a benign index.

    The padded entries gather arbitrary-but-finite rows that only ever feed
    pad positions downstream."""
    extra = target - idx.shape[0]
    if extra < 0:
        raise ValueError("index longer than bucket target")
    if extra == 0:
        return idx
    return np.concatenate([idx, np.full(extra, fill, dtype=idx.dtype)])
