"""Edge-cut-by-destination partitioning of a ``HeteroGraph``: the port's
copy of ``repro.dist.partition`` (host NumPy; its arrays equal the
reference's).

Every node gets exactly one owner shard; every edge lives with its
*destination's* owner. Because the canonical graph keeps a destination-sorted
edge view (``perm_dst``/``dst_ptr``) and ownership is assigned as contiguous
node ranges, each shard's edge set is one contiguous slice of the dst-sorted
order — so a shard can enumerate the in-edges of any node it owns as
*full-graph dst-sorted positions*. Those positions are the counter-based
sampling keys' domain (``sampling.sampler.edge_sample_keys``), which is what
makes sharded sampling draw bit-identical selections to the single-box
sampler: the keys never depend on who evaluates them.

Sources of cut edges (src owned elsewhere) appear in the shard's **halo
table**: the remote node ids plus their owner shard, i.e. exactly the rows
whose features must be fetched from other shards before the shard's blocks
can execute (``dist/executor.py`` implements that fetch as an all-gather of
the per-owner feature tables at the start of every step).

Ownership is balanced by *edge count* (each shard owns a contiguous node
range covering ~E/P dst-sorted edges), the right balance target for both
sampling and aggregation work.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.graph import HeteroGraph


@dataclasses.dataclass(frozen=True)
class ShardTables:
    """One shard's slice of the partitioned graph (host arrays)."""

    part: int
    lo: int                  # owned node range [lo, hi)
    hi: int
    dst_ptr: np.ndarray      # [hi-lo+1] GLOBAL dst_ptr values at owned nodes
    src_d: np.ndarray        # [E_s] src of the shard's dst-sorted edge slice
    etype_d: np.ndarray      # [E_s] etype of that slice
    halo_nodes: np.ndarray   # [H_s] remote src node ids (sorted, unique)
    halo_owner: np.ndarray   # [H_s] owner shard of each halo node

    @property
    def num_owned(self) -> int:
        return self.hi - self.lo

    @property
    def num_edges(self) -> int:
        return int(self.src_d.shape[0])

    @property
    def edge_base(self) -> int:
        """Global dst-sorted position of this shard's first edge."""
        return int(self.dst_ptr[0])


class GraphPartition:
    """P-way edge-cut partition of one ``HeteroGraph``."""

    def __init__(self, hg: HeteroGraph, bounds: np.ndarray):
        self.hg = hg
        self.num_parts = len(bounds) - 1
        self.bounds = bounds                      # [P+1] node range bounds
        src_d = hg.src[hg.perm_dst]
        etype_d = hg.etype[hg.perm_dst]
        self.shards: List[ShardTables] = []
        for p in range(self.num_parts):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            e_lo, e_hi = int(hg.dst_ptr[lo]), int(hg.dst_ptr[hi])
            s_src = src_d[e_lo:e_hi]
            owners = self.owner_of(s_src)
            halo = np.unique(s_src[owners != p]).astype(np.int32)
            self.shards.append(ShardTables(
                part=p, lo=lo, hi=hi,
                dst_ptr=hg.dst_ptr[lo:hi + 1].copy(),
                src_d=s_src.copy(), etype_d=etype_d[e_lo:e_hi].copy(),
                halo_nodes=halo, halo_owner=self.owner_of(halo)))

    # ------------------------------------------------------------------
    def owner_of(self, nodes: np.ndarray) -> np.ndarray:
        """Owner shard of each (global) node id."""
        return (np.searchsorted(self.bounds, np.asarray(nodes), side="right")
                - 1).astype(np.int32)

    def owned_count(self, p: int) -> int:
        return int(self.bounds[p + 1] - self.bounds[p])

    @property
    def max_owned(self) -> int:
        return int(np.max(np.diff(self.bounds)))

    def local_row(self, nodes: np.ndarray) -> np.ndarray:
        """Row of each node inside its owner's feature table."""
        nodes = np.asarray(nodes)
        return (nodes - self.bounds[self.owner_of(nodes)]).astype(np.int32)

    # ------------------------------------------------------------------
    def shard_subgraph(self, p: int) -> tuple:
        """Standalone per-shard ``HeteroGraph`` over (owned + halo) nodes.

        Returns ``(graph, node_ids)`` where ``node_ids`` maps local node
        index -> global id (owned range first, halo nodes after). The
        subgraph holds exactly the shard's edges, so calling
        ``.to_device_graph()`` on it gives the shard's device-resident CSC.
        """
        sh = self.shards[p]
        node_ids = np.concatenate([
            np.arange(sh.lo, sh.hi, dtype=np.int32), sh.halo_nodes])
        order = np.argsort(node_ids, kind="stable")
        sorted_ids = node_ids[order]
        dst_g = np.repeat(np.arange(sh.lo, sh.hi, dtype=np.int32),
                          np.diff(sh.dst_ptr))
        g = HeteroGraph.from_edges(
            np.searchsorted(sorted_ids, sh.src_d).astype(np.int32),
            np.searchsorted(sorted_ids, dst_g).astype(np.int32),
            sh.etype_d.astype(np.int32),
            num_nodes=int(sorted_ids.shape[0]),
            num_etypes=self.hg.num_etypes,
            node_type=self.hg.node_type[sorted_ids],
            num_ntypes=self.hg.num_ntypes,
        )
        return g, sorted_ids

    def shard_features(self, feats: np.ndarray) -> np.ndarray:
        """Stack features into the per-owner tables: ``[P, n_own_max, d]``
        (row r of slab p is global node ``bounds[p] + r``; pad rows zero).
        Split over the data group's ranks, this is the resident feature
        layout every step all-gathers for halo access."""
        feats = np.asarray(feats)
        n_max = self.max_owned
        out = np.zeros((self.num_parts, n_max) + feats.shape[1:],
                       dtype=feats.dtype)
        for p in range(self.num_parts):
            lo, hi = int(self.bounds[p]), int(self.bounds[p + 1])
            out[p, : hi - lo] = feats[lo:hi]
        return out

    def describe(self) -> str:
        lines = [f"GraphPartition({self.num_parts} shards, "
                 f"{self.hg.num_nodes} nodes, {self.hg.num_edges} edges)"]
        for sh in self.shards:
            lines.append(
                f"  shard {sh.part}: nodes [{sh.lo}, {sh.hi}) "
                f"({sh.num_owned}), {sh.num_edges} edges, "
                f"{len(sh.halo_nodes)} halo nodes")
        return "\n".join(lines)


def partition_graph(hg: HeteroGraph, num_parts: int,
                    bounds: Optional[np.ndarray] = None) -> GraphPartition:
    """Partition ``hg`` into ``num_parts`` shards, balanced by edge count.

    ``bounds`` overrides the automatic split with explicit node-range
    boundaries (``[P+1]``, monotone, ``bounds[0]=0``, ``bounds[-1]=N``).
    """
    if num_parts <= 0:
        raise ValueError("num_parts must be positive")
    if num_parts > hg.num_nodes:
        raise ValueError(
            f"cannot cut {hg.num_nodes} nodes into {num_parts} shards")
    if bounds is None:
        # split node ids where the dst-sorted edge array splits into P
        # equal-ish slices; fall back to node balance for edgeless prefixes
        targets = (np.arange(1, num_parts) * hg.num_edges) // num_parts
        cuts = np.searchsorted(hg.dst_ptr, targets, side="left")
        bounds = np.concatenate([[0], cuts, [hg.num_nodes]]).astype(np.int64)
        # enforce strictly increasing bounds (degenerate distributions can
        # collapse neighboring cuts; every shard must own >= 1 node)
        for p in range(1, num_parts + 1):
            lo = int(bounds[p - 1]) + 1
            hi = hg.num_nodes - (num_parts - p)
            bounds[p] = min(max(int(bounds[p]), lo), hi)
        bounds[num_parts] = hg.num_nodes
    else:
        bounds = np.asarray(bounds, dtype=np.int64)
        if (len(bounds) != num_parts + 1 or bounds[0] != 0
                or bounds[-1] != hg.num_nodes
                or np.any(np.diff(bounds) <= 0)):
            raise ValueError("bounds must be [P+1] strictly increasing "
                             "from 0 to num_nodes")
    return GraphPartition(hg, bounds)


def check_partition(part: GraphPartition) -> dict:
    """Partitioner invariants (raises ``AssertionError`` on violation).

    * every node has exactly one owner; owned ranges tile [0, N);
    * every edge is assigned to exactly one shard (the slices tile the
      dst-sorted edge order) and lives with its destination's owner;
    * halo tables are complete: every remote source of a shard's edges is
      in its halo table, with the correct owner, and no owned node is.
    """
    hg = part.hg
    counts = {"nodes": 0, "edges": 0, "halo": 0}
    assert part.bounds[0] == 0 and part.bounds[-1] == hg.num_nodes
    src_d = hg.src[hg.perm_dst]
    for sh in part.shards:
        counts["nodes"] += sh.num_owned
        counts["edges"] += sh.num_edges
        counts["halo"] += len(sh.halo_nodes)
        # the shard's edge slice is exactly its owned nodes' dst-CSR run
        assert sh.dst_ptr[0] == hg.dst_ptr[sh.lo]
        assert sh.dst_ptr[-1] == hg.dst_ptr[sh.hi]
        np.testing.assert_array_equal(
            sh.src_d, src_d[hg.dst_ptr[sh.lo]:hg.dst_ptr[sh.hi]])
        # halo completeness: remote sources == halo table, owners correct
        owners = part.owner_of(sh.src_d)
        remote = np.unique(sh.src_d[owners != sh.part])
        np.testing.assert_array_equal(sh.halo_nodes, remote)
        np.testing.assert_array_equal(sh.halo_owner,
                                      part.owner_of(sh.halo_nodes))
        assert not np.any((sh.halo_nodes >= sh.lo) & (sh.halo_nodes < sh.hi))
    assert counts["nodes"] == hg.num_nodes
    assert counts["edges"] == hg.num_edges
    return counts
