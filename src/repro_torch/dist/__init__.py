"""Data-parallel execution over a partitioned hetero graph: the port's
``repro.dist``.

* ``partition``  — edge-cut-by-destination partitioner over the canonical
  etype-sorted COO: per-shard CSR slices, halo tables, shard subgraphs.
* ``sampler``    — ``ShardedSampler``: per-shard fanout sampling that draws
  the *same* counter-based key stream as the single-box ``FanoutSampler``
  (selection per (dst, etype) bin is keyed by full-graph dst-sorted edge
  positions, so it is independent of which shard evaluates it).
* ``data``       — ``ShardedBatcher``: routes each seed batch to its owner
  shards, samples per shard, pads every shard's blocks to common
  cross-shard buckets with fixed-capacity layouts, and copies the shards
  this rank runs to its device.
* ``executor``   — ``ShardedServeExecutor`` / ``ShardedTrainExecutor``: each
  rank runs its shards' block forwards (and backward + AdamW update) over
  the data group of ``launch/mesh.py``, with the halo-feature all-gather
  and the gradient sum over the gathered shard axis in every step.
* ``trainer``    — ``DistTrainer``.
"""
from repro_torch.dist.partition import (GraphPartition, partition_graph,
                                        check_partition)
from repro_torch.dist.sampler import ShardedSampler
from repro_torch.dist.data import ShardedBatcher, ShardedMiniBatch
from repro_torch.dist.executor import (ShardedServeExecutor,
                                       ShardedTrainExecutor)
from repro_torch.dist.trainer import DistTrainer

__all__ = [
    "GraphPartition", "partition_graph", "check_partition",
    "ShardedSampler", "ShardedBatcher", "ShardedMiniBatch",
    "ShardedServeExecutor", "ShardedTrainExecutor", "DistTrainer",
]
