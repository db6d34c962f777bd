"""Per-shard fanout sampling over the partitioned graph: the port's copy of
``repro.dist.sampler`` (host NumPy).

``ShardedSampler.sample_for_shard(p, seeds, ...)`` produces the exact
``BlockSequence`` the single-box ``FanoutSampler`` would produce for the
same seed slice, evaluated from the partition's per-shard tables:

* candidates of a frontier node are enumerated from its **owner's** CSR
  slice, but as *global* dst-sorted positions (each shard keeps the global
  ``dst_ptr`` values of its owned nodes), so the counter-based keys — and
  therefore the k-smallest-key selection per (dst, etype) bin — are
  bit-identical to the single-box stream;
* hop-0 frontiers are shard-local by construction (seeds are routed to
  their owner). Deeper hops contain halo nodes whose in-edges live on other
  shards; those lookups go through the owner's tables and are counted in
  ``halo_lookups`` — in-process they are array reads, in a multi-host
  deployment they become the sampling-service RPC, with identical results
  either way because the key stream is position-based.

The sampling key stream is shared with the single-box path:
``hop_base_key(seed, batch_index, hop, epoch)`` with the *same* batch index
on every shard, so shard-local selections compose to exactly the union
block's edge multiset.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.graph import HeteroGraph
from repro_torch.dist.partition import GraphPartition
from repro_torch.sampling.sampler import (Block, BlockSequence, FanoutSpec,
                                    candidate_positions, hop_base_key,
                                    normalize_fanout, select_by_keys)


class ShardedSampler:
    """Fanout sampling from per-shard partition tables (one instance serves
    every shard: shard state is an argument, not object identity)."""

    def __init__(self, part: GraphPartition, fanouts: Sequence[FanoutSpec],
                 seed: int = 0):
        if not fanouts:
            raise ValueError("need at least one hop fanout")
        self.part = part
        self.hg = part.hg
        self.fanouts = [normalize_fanout(f, self.hg.num_etypes)
                        for f in fanouts]
        self.seed = seed
        # global dst-sorted edge boundary of each shard's slice: position ->
        # owning shard is a searchsorted over this
        self.edge_bounds = self.hg.dst_ptr[part.bounds].astype(np.int64)
        self.local_lookups = 0
        self.halo_lookups = 0

    @property
    def num_hops(self) -> int:
        return len(self.fanouts)

    # ------------------------------------------------------------------
    def _csr_runs(self, p: int, frontier: np.ndarray):
        """(global start, count) of each frontier node's in-edge run, read
        from the node's owner shard tables."""
        owners = self.part.owner_of(frontier)
        starts = np.zeros(len(frontier), dtype=np.int64)
        counts = np.zeros(len(frontier), dtype=np.int64)
        for t in np.unique(owners):
            sh = self.part.shards[int(t)]
            m = owners == t
            local = frontier[m] - sh.lo
            starts[m] = sh.dst_ptr[local]
            counts[m] = sh.dst_ptr[local + 1] - sh.dst_ptr[local]
            n = int(m.sum())
            if int(t) == p:
                self.local_lookups += n
            else:
                self.halo_lookups += n
        return starts, counts

    def _edge_fields(self, pos: np.ndarray):
        """(src, etype) of global dst-sorted positions, read from the edge
        slice of whichever shard owns each position."""
        owners = (np.searchsorted(self.edge_bounds, pos, side="right") - 1)
        src = np.zeros(len(pos), dtype=np.int32)
        et = np.zeros(len(pos), dtype=np.int32)
        for t in np.unique(owners):
            sh = self.part.shards[int(t)]
            m = owners == t
            rel = pos[m] - sh.edge_base
            src[m] = sh.src_d[rel]
            et[m] = sh.etype_d[rel]
        return src, et

    # ------------------------------------------------------------------
    def sample_for_shard(self, p: int, seeds: np.ndarray,
                         batch_index: int = 0,
                         epoch: Optional[int] = None) -> BlockSequence:
        """Sample shard ``p``'s ``BlockSequence`` for its seed slice.

        Bit-identical to ``FanoutSampler(hg, fanouts, seed).sample(seeds,
        batch_index, epoch)`` — the shared key-stream contract.
        """
        seeds = np.asarray(seeds, dtype=np.int32)
        if seeds.ndim != 1 or seeds.size == 0:
            raise ValueError("seeds must be a non-empty 1-D int array")
        if np.any(self.part.owner_of(seeds) != p):
            raise ValueError(f"shard {p} was routed seeds it does not own")

        frontier = np.unique(seeds)
        seed_perm = np.searchsorted(frontier, seeds).astype(np.int32)
        blocks: List[Block] = []
        for hop, fanout in enumerate(reversed(self.fanouts)):
            base = hop_base_key(self.seed, int(batch_index), hop, epoch)
            starts, counts = self._csr_runs(p, frontier)
            pos, owner = candidate_positions(starts, counts)
            if pos.size:
                _, et_all = self._edge_fields(pos)
                sel, sel_owner = select_by_keys(
                    pos, owner, et_all.astype(np.int64), fanout, base,
                    self.hg.num_etypes)
                src, et = self._edge_fields(sel)
                dst = frontier[sel_owner].astype(np.int32)
            else:
                src = dst = et = np.zeros(0, dtype=np.int32)
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

    def stats(self) -> dict:
        return {"local_lookups": self.local_lookups,
                "halo_lookups": self.halo_lookups}
