"""The port's own copy of ``repro.sampling.sampler`` (host sampling; the
blocks are array-identical, ``tests/test_torch_sampling.py``).

Deterministic per-etype fanout neighbor sampling over ``HeteroGraph``.

Message-flow-graph ("block") semantics follow the DGL/GraphBolt shape: seed
nodes are the destination frontier of the last hop; each hop samples up to
``fanout[etype]`` incoming edges per (destination node, edge type) from the
*full* graph, and the union of the frontier with the sampled sources becomes
the next (inner) frontier. The block for hop ``l`` is a standalone
``HeteroGraph`` over that union, so all Hector preprocessing — etype-sorted
edges, destination CSR, and the compact-materialization map (unique
(src, etype) pairs, the data-reuse structure HiHGNN motivates preserving) —
is recomputed per block and the existing kernels/layouts apply unchanged.

Node-ID bookkeeping exploits a seed-graph invariant: ``HeteroGraph`` nodes
are presorted by node type, so sorting global IDs also sorts by
(ntype, id) and every frontier is represented as a sorted unique ID array.
Local IDs are then ``searchsorted`` positions, and each block's destination
frontier ordering matches the next block's node ordering by construction.

Sampling is seeded per (sampler seed, batch index) — the same determinism
contract as ``data/pipeline.py`` — so restarts and replicas replay the
exact same mini-batch stream.

The per-candidate randomness is a **counter-based stateless hash** over the
candidate edge's destination-sorted position (``mix32`` of position XOR a
per-(seed, epoch, batch, hop) base key), not a stateful generator: the host
sampler and ``sampling/device_sampler.py`` evaluate the identical function
over the identical positions, so both select the same edges — the
host/device parity contract, and the reason sampling carries no per-host
nondeterminism.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.graph import HeteroGraph

FanoutSpec = Union[int, Dict[int, int], Sequence[int], np.ndarray]

FULL_NEIGHBORHOOD = -1  # fanout value meaning "keep every in-edge"


# ---------------------------------------------------------------------------
# counter-based randomness (shared host/device)
# ---------------------------------------------------------------------------
_MIX_M1 = np.uint32(0x85EBCA6B)
_MIX_M2 = np.uint32(0xC2B2AE35)


def mix32(x):
    """murmur3 finalizer over uint32 values; elementwise, wraparound.

    The constants are ``np.uint32`` scalars, which NumPy uint32 arrays
    combine without upcasting, so the products wrap as uint32.
    """
    x = x ^ (x >> 16)
    x = x * _MIX_M1
    x = x ^ (x >> 13)
    x = x * _MIX_M2
    x = x ^ (x >> 16)
    return x


def fold_key(*parts: int) -> np.uint32:
    """Fold integer key parts into one uint32 base key (pure Python ints
    internally, so no overflow warnings; order-sensitive)."""
    k = 0x9E3779B9
    for p in parts:
        k ^= int(p) & 0xFFFFFFFF
        # inline scalar mix32 on python ints (exact uint32 semantics)
        k ^= k >> 16
        k = (k * 0x85EBCA6B) & 0xFFFFFFFF
        k ^= k >> 13
        k = (k * 0xC2B2AE35) & 0xFFFFFFFF
        k ^= k >> 16
    return np.uint32(k)


def hop_base_key(seed: int, batch_index: int, hop: int,
                 epoch: Optional[int] = None) -> np.uint32:
    """Base key for one sampling hop — the determinism contract: a pure
    function of (sampler seed, epoch, batch index, hop), with ``epoch=None``
    distinct from every integer epoch."""
    etag = 0 if epoch is None else int(epoch) + 1
    return fold_key(seed, etag, batch_index, hop)


def edge_sample_keys(base_key, pos):
    """Per-candidate uint32 sort key: candidates with the k smallest keys in
    their (destination, etype) bin are the sampled edges. ``pos`` is the
    candidate's destination-sorted edge position — the shared host/device
    candidate enumeration — and the full re-hash of (position XOR base key)
    decorrelates the per-batch orderings."""
    return mix32(np.asarray(pos).astype(np.uint32) ^ base_key)


def _mul32(x, m: int):
    """``x * m`` modulo 2^32 for int64 tensors ``x`` in [0, 2^32): the
    product is split at bit 16 of ``m`` so no partial product reaches
    2^63 (a full 32 x 32-bit product would overflow int64)."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def mix32_torch(x):
    """``mix32`` over an int64 tensor of uint32 values (torch has no full
    uint32 arithmetic): the same bits, held in int64, each product masked
    back to 32 bits."""
    x = x ^ (x >> 16)
    x = _mul32(x, int(_MIX_M1))
    x = x ^ (x >> 13)
    x = _mul32(x, int(_MIX_M2))
    return x ^ (x >> 16)


def edge_sample_keys_torch(base_key, pos):
    """``edge_sample_keys`` on a tensor of candidate positions: the same
    uint32 keys as int64 values (``pos`` wraps to uint32 as in numpy)."""
    return mix32_torch((pos.long() & 0xFFFFFFFF) ^ (int(base_key)
                                                     & 0xFFFFFFFF))


def normalize_fanout(fanout: FanoutSpec, num_etypes: int) -> np.ndarray:
    """Per-etype fanout vector [R]; -1 means the full neighborhood."""
    if isinstance(fanout, (int, np.integer)):
        return np.full(num_etypes, int(fanout), dtype=np.int64)
    if isinstance(fanout, dict):
        arr = np.zeros(num_etypes, dtype=np.int64)
        unlisted = sorted(set(range(num_etypes)) - {int(e) for e in fanout})
        if unlisted:
            warnings.warn(
                f"dict fanout leaves {len(unlisted)} of {num_etypes} etypes "
                f"unlisted (e.g. {unlisted[:5]}); they default to fanout 0 "
                f"(drop all edges of that type). Pass an explicit 0 to "
                f"silence this.", UserWarning, stacklevel=2)
        for et, k in fanout.items():
            arr[int(et)] = int(k)
        return arr
    arr = np.asarray(fanout, dtype=np.int64)
    if arr.shape != (num_etypes,):
        raise ValueError(
            f"per-etype fanout must have shape ({num_etypes},), got {arr.shape}"
        )
    return arr


@dataclasses.dataclass
class Block:
    """One hop of a sampled message-flow graph.

    ``graph`` is a valid standalone ``HeteroGraph`` over the block's local
    node set (the input frontier of this hop). Only the rows selected by
    ``dst_local`` — the output frontier — carry meaningful aggregations.
    """

    graph: HeteroGraph
    node_ids: np.ndarray   # [n_local] global node IDs (sorted ascending)
    dst_local: np.ndarray  # [n_dst] local indices of the output frontier

    @property
    def num_src(self) -> int:
        return int(self.node_ids.shape[0])

    @property
    def num_dst(self) -> int:
        return int(self.dst_local.shape[0])

    @property
    def dst_ids(self) -> np.ndarray:
        return self.node_ids[self.dst_local]


@dataclasses.dataclass
class BlockSequence:
    """Per-hop blocks in execution order (``blocks[0]`` is the innermost
    hop; ``blocks[-1]``'s output frontier covers the seeds)."""

    blocks: List[Block]
    seeds: np.ndarray      # the requested seed IDs, order and dupes preserved
    seed_perm: np.ndarray  # [len(seeds)] row of each seed in the final output

    @property
    def num_hops(self) -> int:
        return len(self.blocks)

    @property
    def input_node_ids(self) -> np.ndarray:
        """Global IDs whose input features the first hop consumes."""
        return self.blocks[0].node_ids

    def slice_labels(self, labels: np.ndarray) -> np.ndarray:
        """Per-batch label slice aligned with the block forward's output.

        The block forward returns the final frontier's rows re-permuted by
        ``seed_perm`` — i.e. one row per requested seed, in request order
        (duplicates included) — so the aligned labels are simply
        ``labels[self.seeds]``.
        """
        return np.asarray(labels)[self.seeds]

    def describe(self) -> str:
        lines = [f"BlockSequence(seeds={len(self.seeds)})"]
        for i, b in enumerate(self.blocks):
            lines.append(
                f"  hop {i}: {b.num_src} nodes -> {b.num_dst} dst, "
                f"{b.graph.num_edges} edges, "
                f"compaction {b.graph.entity_compaction_ratio:.2f}"
            )
        return "\n".join(lines)


class FanoutSampler:
    """Seeded per-etype fanout neighbor sampler emitting ``BlockSequence``s.

    ``fanouts`` is one spec per hop, listed input-to-output (hop 0 is the
    innermost layer, matching execution order); sampling itself proceeds
    from the seeds backwards.
    """

    def __init__(self, hg: HeteroGraph, fanouts: Sequence[FanoutSpec],
                 seed: int = 0):
        if not fanouts:
            raise ValueError("need at least one hop fanout")
        self.hg = hg
        self.fanouts = [normalize_fanout(f, hg.num_etypes) for f in fanouts]
        self.seed = seed
        # dst-sorted companions of the dst CSR, so a frontier's in-edges are
        # contiguous ranges with O(1) lookup of (src, etype) per edge.
        self._src_d = hg.src[hg.perm_dst]
        self._etype_d = hg.etype[hg.perm_dst]

    @property
    def num_hops(self) -> int:
        return len(self.fanouts)

    # ------------------------------------------------------------------
    def sample(self, seeds: np.ndarray, batch_index: int = 0,
               epoch: Optional[int] = None) -> BlockSequence:
        """Sample a ``BlockSequence`` for ``seeds``.

        Randomness is keyed by ``(sampler seed, batch_index, hop)`` — or
        ``(sampler seed, epoch, batch_index, hop)`` when ``epoch`` is given,
        the epoch-aware training contract: replaying a step reproduces its
        blocks exactly, while the same seed batch in a different epoch
        draws a fresh neighborhood. The keying is counter-based
        (``hop_base_key``/``edge_sample_keys``), the exact scheme the device
        sampler evaluates — identical inputs select identical edges on both.
        """
        seeds = np.asarray(seeds, dtype=np.int32)
        if seeds.ndim != 1 or seeds.size == 0:
            raise ValueError("seeds must be a non-empty 1-D int array")
        if seeds.min() < 0 or seeds.max() >= self.hg.num_nodes:
            raise ValueError("seed node id out of range")

        frontier = np.unique(seeds)
        seed_perm = np.searchsorted(frontier, seeds).astype(np.int32)

        blocks: List[Block] = []
        for hop, fanout in enumerate(reversed(self.fanouts)):
            base = hop_base_key(self.seed, int(batch_index), hop, epoch)
            src, dst, et = self._sample_in_edges(frontier, fanout, base)
            node_ids = np.unique(np.concatenate([frontier, src]))
            bg = HeteroGraph.from_edges(
                np.searchsorted(node_ids, src).astype(np.int32),
                np.searchsorted(node_ids, dst).astype(np.int32),
                et,
                num_nodes=int(node_ids.shape[0]),
                num_etypes=self.hg.num_etypes,
                node_type=self.hg.node_type[node_ids],
                num_ntypes=self.hg.num_ntypes,
            )
            dst_local = np.searchsorted(node_ids, frontier).astype(np.int32)
            blocks.append(Block(graph=bg, node_ids=node_ids.astype(np.int32),
                                dst_local=dst_local))
            frontier = node_ids
        blocks.reverse()
        return BlockSequence(blocks=blocks, seeds=seeds, seed_perm=seed_perm)

    # ------------------------------------------------------------------
    def _sample_in_edges(self, frontier: np.ndarray, fanout: np.ndarray,
                         base_key: np.uint32):
        """Sample ≤ fanout[etype] in-edges per (frontier node, etype),
        without replacement. Returns global (src, dst, etype) arrays."""
        hg = self.hg
        starts = hg.dst_ptr[frontier].astype(np.int64)
        counts = (hg.dst_ptr[frontier + 1] - hg.dst_ptr[frontier]).astype(np.int64)
        pos, owner = candidate_positions(starts, counts)
        if pos.size == 0:
            empty = np.zeros(0, dtype=np.int32)
            return empty, empty, empty
        et = self._etype_d[pos].astype(np.int64)
        sel, sel_owner = select_by_keys(pos, owner, et, fanout, base_key,
                                        hg.num_etypes)
        src = self._src_d[sel]
        dst = frontier[sel_owner].astype(np.int32)
        return src.astype(np.int32), dst, self._etype_d[sel].astype(np.int32)


# ---------------------------------------------------------------------------
# the shared selection core (single-box and sharded samplers)
# ---------------------------------------------------------------------------
def candidate_positions(starts: np.ndarray, counts: np.ndarray):
    """Expand per-frontier-node CSR runs ``[start, start+count)`` into the
    flat candidate position array plus each candidate's frontier index.

    ``starts`` are *global* dst-sorted offsets — shards pass their owned
    nodes' global ``dst_ptr`` values here, which is how per-shard candidate
    enumeration lands on the same key domain as the single-box sampler."""
    starts = np.asarray(starts, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, dtype=np.int64),) * 2
    offs = np.concatenate([[0], np.cumsum(counts)])
    pos = (np.arange(total, dtype=np.int64)
           - np.repeat(offs[:-1], counts) + np.repeat(starts, counts))
    owner = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    return pos, owner


def select_by_keys(pos: np.ndarray, owner: np.ndarray, et: np.ndarray,
                   fanout: np.ndarray, base_key: np.uint32,
                   num_etypes: int):
    """Rank candidates within each (owner, etype) bin by their counter-based
    key and keep ranks < fanout[etype] — uniform sampling w/o replacement.

    The bin ranking depends only on the candidates *inside* the bin (the
    keys are pure functions of global position), so any evaluator holding a
    destination's complete in-edge list — the single-box sampler, the device
    sampler, or the destination's owner shard — selects the same edges.
    lexsort is stable, so equal keys tie-break by ascending position, the
    same total order the device sampler's stable argsort produces.

    Returns ``(sel_pos, sel_owner)``: the kept candidates' positions and
    frontier indices, in (bin, key) order.
    """
    total = int(pos.shape[0])
    group = owner * num_etypes + et
    order = np.lexsort((edge_sample_keys(base_key, pos), group))
    g_sorted = group[order]
    boundary = np.concatenate([[True], g_sorted[1:] != g_sorted[:-1]])
    group_start = np.flatnonzero(boundary)
    group_len = np.diff(np.concatenate([group_start, [total]]))
    rank = np.arange(total, dtype=np.int64) - np.repeat(group_start, group_len)
    cap = fanout[et[order]]
    keep = (cap == FULL_NEIGHBORHOOD) | (rank < cap)
    return pos[order][keep], owner[order][keep]
