"""Cross-shard batch assembly for data-parallel execution: the port's
``repro.dist.data``.

``ShardedBatcher`` turns one request batch of seed nodes into a
``ShardedMiniBatch``. Three problems are solved on the host, once per
batch, exactly as in the reference:

1. **Seed routing** — each seed goes to its owner shard, in request order;
   each shard's slice is padded to a common power-of-two ``b_max`` with a
   valid owned node (selection per (dst, etype) bin is independent of the
   rest of the batch, so pad seeds never disturb real selections). A
   ``route`` gather index maps request position -> (shard, slot), which the
   executor uses to restore request order from the gathered outputs.

2. **Common buckets** — shards sample different block sizes, but the
   executor's key must not depend on which shard drew what. Per hop, every
   shard's block is padded to the max bucket over shards
   (``common_block_targets``, two-pass because raising the unique-pair
   bucket spends extra pad edges and nodes).

3. **Fixed-capacity layouts** — ``codegen.build_kernel_layouts`` composes
   gather rows *before* bucket growth, so its row counts depend on block
   content. ``build_fixed_layouts`` grows every tile layout to the
   worst-case capacity implied by the (already common) graph buckets —
   ``sum_r ceil(seg_r/tile)*tile <= roundup(total) + groups*tile`` — and
   only then composes the gather rows, so every layout shape and every
   static field is a function of the bucket sizes alone.

Where the reference stacks each hop's pytrees into ``[P, ...]`` arrays for
``shard_map``, the port keeps one ``ShardBlocks`` per shard (the same
arrays, unstacked): each shard runs ``codegen``'s block sequence on its
own tensors. Every rank builds the whole batch on its host (the same bytes
everywhere; the common buckets and the route need every shard's sampled
sizes) and copies only the shards it runs (``shards=``) to its device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import codegen
from repro_torch.core.graph import GraphTensors, HeteroGraph, to_device
from repro_torch.dist.partition import GraphPartition
from repro_torch.dist.sampler import ShardedSampler
from repro_torch.kernels import layout as L
from repro_torch.kernels import ops as K
from repro_torch.kernels.layout import pow2ceil
from repro_torch.sampling.bucketing import pad_block_graph, pad_index
from repro_torch.sampling.loader import (LRUCache, _partition_token,
                                        block_signature)
from repro_torch.sampling.sampler import FanoutSpec


def common_block_targets(graphs: Sequence[HeteroGraph]) -> tuple:
    """Smallest common ``(n, e, u)`` power-of-two buckets that every graph
    in ``graphs`` can be padded to *exactly* by ``pad_block_graph``.

    Two-pass: the unique-pair target is fixed first because raising it
    costs each graph ``u_t - u_s`` extra pad edges (one per distinct pad
    pair) and ``ceil((u_t - u_s)/R)`` extra pad source nodes, which feed
    into the edge/node targets."""
    num_r = graphs[0].num_etypes
    u_t = max(pow2ceil(g.num_unique + 1) for g in graphs)
    e_t = max(pow2ceil(g.num_edges + (u_t - g.num_unique)) for g in graphs)
    n_t = max(
        pow2ceil(g.num_nodes + max(1, -(-(u_t - g.num_unique) // num_r)))
        for g in graphs)
    return n_t, e_t, u_t


def build_fixed_layouts(hg: HeteroGraph, tile: int = 128,
                        node_block: int = 128) -> codegen.KernelLayouts:
    """``KernelLayouts`` (CPU tensors) whose every shape and static field
    depends only on the graph's bucket sizes ``(num_nodes, num_edges,
    num_unique)`` plus the static type/tile counts — not on how edges
    distribute over segments/blocks.

    Each tile layout is grown to its worst case *before* the gather rows
    are composed (``codegen.build_kernel_layouts`` composes first, so its
    shapes are content-dependent and would differ across shards)."""
    if tile & (tile - 1):
        raise ValueError("fixed layouts need a power-of-two tile")

    def up(x: int) -> int:
        return -(-x // tile) * tile

    num_r, num_t = hg.num_etypes, hg.num_ntypes
    edge_ps = L.pad_segments_rows(
        L.pad_segments(hg.etype_ptr, tile), up(hg.num_edges) + num_r * tile)
    unique_ps = L.pad_segments_rows(
        L.pad_segments(hg.unique_etype_ptr, tile),
        up(hg.num_unique) + num_r * tile)
    node_ps = L.pad_segments_rows(
        L.pad_segments(hg.ntype_ptr, tile), up(hg.num_nodes) + num_t * tile)
    nb = -(-hg.num_nodes // node_block)
    bc = L.pad_blocked_csr(
        L.block_csr(hg.dst_ptr, edge_tile=tile, node_block=node_block),
        up(hg.num_edges) + nb * tile)
    return codegen.KernelLayouts(
        edge_seg=K.padded_segments_dev(edge_ps),
        unique_seg=K.padded_segments_dev(unique_ps),
        node_seg=K.padded_segments_dev(node_ps),
        blocked=K.blocked_csr_dev(bc, hg.perm_dst, hg.edge_to_unique),
        edge_src_rows=K._tensor(L.compose_gather_rows(edge_ps, hg.src)),
        edge_dst_rows=K._tensor(L.compose_gather_rows(edge_ps, hg.dst)),
        unique_src_rows=K._tensor(
            L.compose_gather_rows(unique_ps, hg.unique_src)),
        dst_deg=torch.from_numpy(np.diff(hg.dst_ptr).astype(np.float32)),
    )


@dataclasses.dataclass
class ShardBlocks:
    """One shard's blocks, on the device that runs the shard: what
    ``codegen.execute_block_sequence`` takes, plus the hop-0 input rows as
    ``(owner shard, row in the owner's slab)``."""

    tensors: List[GraphTensors]              # per hop
    layouts: List[codegen.KernelLayouts]     # per hop
    dst_locals: List[torch.Tensor]           # per hop [rows]
    seed_perm: torch.Tensor                  # [b_max] final-frontier row
    owner_rows: torch.Tensor                 # [n_in] owner of each input
    local_rows: torch.Tensor                 # [n_in] row in its slab


@dataclasses.dataclass
class ShardedMiniBatch:
    """One request batch across all ``P`` shards.

    ``blocks`` holds a ``ShardBlocks`` for each shard in ``shards`` (the
    shards this process runs, in shard order); their shapes are common
    across shards by construction. ``mask`` and ``route`` live on the same
    device; ``shard_seeds`` and ``seeds`` stay on the host."""

    step: int
    seeds: np.ndarray               # [B] requested seed nodes (global ids)
    shard_seeds: np.ndarray         # [P, b_max] routed + padded seed slices
    shards: tuple                   # shard index of each entry of blocks
    blocks: List[ShardBlocks]
    mask: torch.Tensor              # [P, b_max] 1.0 for real request slots
    route: torch.Tensor             # [B] request pos -> shard*b_max + slot

    @property
    def num_hops(self) -> int:
        return len(self.blocks[0].tensors)

    @property
    def num_shards(self) -> int:
        return int(self.shard_seeds.shape[0])

    @property
    def b_max(self) -> int:
        return int(self.shard_seeds.shape[1])

    def slice_labels(self, labels: np.ndarray) -> torch.Tensor:
        """Per-shard label slabs ``[P, b_max]`` on the batch's device (pad
        slots carry the pad seed's label; masked out of every loss
        term)."""
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(labels)[self.shard_seeds].astype(np.int32))).to(
                self.mask.device)


def route_seeds(part: GraphPartition, seeds: np.ndarray):
    """Split a request batch by owner shard, preserving request order.

    Returns ``(shard_seeds [P, b_max], mask [P, b_max], route [B])`` where
    ``b_max`` is the power-of-two bucket of the largest per-shard count and
    pad slots hold the shard's first owned node."""
    seeds = np.asarray(seeds, dtype=np.int32)
    if seeds.ndim != 1 or seeds.size == 0:
        raise ValueError("seeds must be a non-empty 1-D int array")
    num_parts = part.num_parts
    owners = part.owner_of(seeds).astype(np.int64)
    counts = np.bincount(owners, minlength=num_parts)
    b_max = pow2ceil(int(counts.max()))
    # rank of each request within its owner, in request order
    order = np.argsort(owners, kind="stable")
    starts = np.zeros(num_parts + 1, dtype=np.int64)
    starts[1:] = np.cumsum(counts)
    slots = np.empty(len(seeds), dtype=np.int64)
    slots[order] = np.arange(len(seeds)) - starts[owners[order]]
    shard_seeds = np.repeat(
        part.bounds[:num_parts].astype(np.int32)[:, None], b_max, axis=1)
    shard_seeds[owners, slots] = seeds
    mask = (np.arange(b_max)[None, :] < counts[:, None]).astype(np.float32)
    route = (owners * b_max + slots).astype(np.int32)
    return shard_seeds, mask, route


class ShardedBatcher:
    """Samples + assembles ``ShardedMiniBatch``es for a partitioned graph.

    ``shards`` (default: all) are the shards whose blocks go to ``device``;
    the others are sampled and padded (their sizes set the common buckets)
    but never laid out. Caching: batches are memoized by seed bytes + epoch
    + *partition identity* (two partitionings of the same graph must never
    share entries), layouts (on ``device``) by padded-block content
    signature."""

    def __init__(self, part: GraphPartition, fanouts: Sequence[FanoutSpec],
                 *, seed: int = 0, tile: int = 128, node_block: int = 128,
                 cache_batches: int = 64, cache_layouts: int = 256,
                 shards: Optional[Sequence[int]] = None, device="cpu"):
        self.part = part
        self.sampler = ShardedSampler(part, fanouts, seed=seed)
        self.tile = tile
        self.node_block = node_block
        self.shards = tuple(range(part.num_parts)) if shards is None \
            else tuple(int(p) for p in shards)
        self.device = torch.device(device)
        self._fanout_key = tuple(
            tuple(int(x) for x in f) for f in self.sampler.fanouts)
        self._part_key = _partition_token(part)
        self._batch_cache = LRUCache(cache_batches, "dist-batches")
        self._layout_cache = LRUCache(cache_layouts, "dist-layouts")
        self.host_builds = 0

    # ------------------------------------------------------------------
    def _layouts_for(self, g: HeteroGraph) -> codegen.KernelLayouts:
        key = ("fixed", block_signature(g, self.tile, self.node_block, True))
        kl = self._layout_cache.get(key)
        if kl is None:
            kl = build_fixed_layouts(g, tile=self.tile,
                                     node_block=self.node_block).to(
                                         self.device, non_blocking=True)
            self._layout_cache.put(key, kl)
        return kl

    def build(self, seeds: np.ndarray, step: int = 0,
              epoch: Optional[int] = None) -> ShardedMiniBatch:
        seeds = np.asarray(seeds, dtype=np.int32)
        key = (seeds.tobytes(), epoch, self._fanout_key, self.tile,
               self.node_block, self._part_key)
        hit = self._batch_cache.get(key)
        if hit is not None:
            return dataclasses.replace(hit, step=step)
        mb = self._build(seeds, step, epoch)
        self._batch_cache.put(key, mb)
        return mb

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return to_device(torch.from_numpy(np.ascontiguousarray(a)),
                         self.device, non_blocking=True)

    def _build(self, seeds: np.ndarray, step: int,
               epoch: Optional[int]) -> ShardedMiniBatch:
        self.host_builds += 1
        num_parts = self.part.num_parts
        shard_seeds, mask, route = route_seeds(self.part, seeds)
        seqs = [self.sampler.sample_for_shard(
                    p, shard_seeds[p], batch_index=step, epoch=epoch)
                for p in range(num_parts)]
        num_hops = len(seqs[0].blocks)

        # pad every shard's hop-h block to the common cross-shard buckets
        padded = []
        for h in range(num_hops):
            n_t, e_t, u_t = common_block_targets(
                [s.blocks[h].graph for s in seqs])
            row = [pad_block_graph(s.blocks[h].graph, n_t, e_t, u_t)
                   for s in seqs]
            assert all(g.num_nodes == n_t for g in row)
            padded.append(row)

        # hop-chaining gathers, padded to the (common) downstream buckets
        n_in = padded[0][0].num_nodes
        last_rows = max(pow2ceil(s.blocks[-1].dst_local.shape[0])
                        for s in seqs)
        blocks = []
        for p in self.shards:
            s = seqs[p]
            input_ids = pad_index(s.input_node_ids, n_in)
            blocks.append(ShardBlocks(
                tensors=[padded[h][p].to_tensors().to(
                    self.device, non_blocking=True)
                    for h in range(num_hops)],
                layouts=[self._layouts_for(padded[h][p])
                         for h in range(num_hops)],
                dst_locals=[self._dev(pad_index(
                    s.blocks[h].dst_local,
                    padded[h + 1][p].num_nodes if h + 1 < num_hops
                    else last_rows)) for h in range(num_hops)],
                seed_perm=self._dev(s.seed_perm),
                owner_rows=self._dev(self.part.owner_of(input_ids)),
                local_rows=self._dev(self.part.local_row(input_ids))))
        return ShardedMiniBatch(
            step=step, seeds=seeds, shard_seeds=shard_seeds,
            shards=self.shards, blocks=blocks, mask=self._dev(mask),
            route=self._dev(route))

    def stats(self) -> dict:
        return {
            "host_builds": self.host_builds,
            "batch_cache": self._batch_cache.stats(),
            "layout_cache": self._layout_cache.stats(),
            **self.sampler.stats(),
        }
