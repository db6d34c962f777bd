"""Heterogeneous graph substrate for Hector.

The paper's layout story (§3.2.2) needs, per graph, a small set of host-side
preprocessing products:

  * edges presorted by edge type  -> ``etype_ptr`` segment offsets (enables
    segment-MM typed linear layers, exactly as the paper presorts);
  * edges sorted by destination   -> CSR ``dst_ptr`` (enables deterministic
    segment aggregation on TPU, replacing GPU atomics);
  * the compact-materialization map: unique (source node, edge type) pairs,
    the per-edge index into the unique table, and the unique table's own
    etype segmentation (``unique_etype_ptr``) — Fig. 7(b) of the paper.

Everything here is NumPy (host preprocessing); ``GraphTensors`` holds the
same arrays as torch tensors for the generated code.

The port's own copy of ``repro.core.graph``: ``HeteroGraph``,
``synthetic_heterograph`` and ``table3_graph`` make the same NumPy draws, so
one seed gives one graph in both packages. ``DeviceGraph`` (device-side
sampling) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _segment_ptr(sorted_types: np.ndarray, num_types: int) -> np.ndarray:
    """Offsets of each type segment in a type-sorted array (len num_types+1)."""
    counts = np.bincount(sorted_types, minlength=num_types)
    ptr = np.zeros(num_types + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    return ptr


@dataclasses.dataclass
class HeteroGraph:
    """Host-side heterograph with all Hector preprocessing applied.

    Edge arrays are stored in *etype-sorted* order (the canonical layout for
    GEMM-template instances). ``perm_dst`` re-sorts edges by destination for
    traversal-template aggregation.
    """

    num_nodes: int
    num_ntypes: int
    num_etypes: int
    # canonical (etype-sorted) edge arrays
    src: np.ndarray          # [E] int32
    dst: np.ndarray          # [E] int32
    etype: np.ndarray        # [E] int32, non-decreasing
    etype_ptr: np.ndarray    # [R+1] int32 segment offsets
    node_type: np.ndarray    # [N] int32, non-decreasing (nodes presorted)
    ntype_ptr: np.ndarray    # [T+1] int32
    # destination-sorted view (for aggregation)
    perm_dst: np.ndarray     # [E] int32: canonical index of i-th dst-sorted edge
    dst_sorted: np.ndarray   # [E] int32 non-decreasing
    dst_ptr: np.ndarray      # [N+1] int32 CSR by destination
    # compact materialization map (Fig. 7b)
    unique_src: np.ndarray        # [U] int32 gather list: source node of unique pair
    unique_etype: np.ndarray      # [U] int32 non-decreasing
    unique_etype_ptr: np.ndarray  # [R+1] int32
    edge_to_unique: np.ndarray    # [E] int32: canonical edge -> unique row

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_unique(self) -> int:
        return int(self.unique_src.shape[0])

    @property
    def entity_compaction_ratio(self) -> float:
        """#unique (src, etype) pairs / #edges — the paper's Fig. 10 metric."""
        return self.num_unique / max(1, self.num_edges)

    # ------------------------------------------------------------------
    @staticmethod
    def from_edges(
        src: np.ndarray,
        dst: np.ndarray,
        etype: np.ndarray,
        num_nodes: int,
        num_etypes: int,
        node_type: Optional[np.ndarray] = None,
        num_ntypes: int = 1,
    ) -> "HeteroGraph":
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        etype = np.asarray(etype, dtype=np.int32)
        if node_type is None:
            node_type = np.zeros(num_nodes, dtype=np.int32)
        node_type = np.asarray(node_type, dtype=np.int32)
        if not np.all(np.diff(node_type) >= 0):
            raise ValueError("nodes must be presorted by type (paper §4.1)")

        # canonical order: sort edges by etype (stable keeps locality)
        order = np.argsort(etype, kind="stable").astype(np.int32)
        src, dst, etype = src[order], dst[order], etype[order]
        etype_ptr = _segment_ptr(etype, num_etypes)
        ntype_ptr = _segment_ptr(node_type, num_ntypes)

        # destination-sorted view
        perm_dst = np.argsort(dst, kind="stable").astype(np.int32)
        dst_sorted = dst[perm_dst]
        dst_ptr = np.zeros(num_nodes + 1, dtype=np.int32)
        np.cumsum(np.bincount(dst_sorted, minlength=num_nodes), out=dst_ptr[1:])

        # compact materialization: unique (src, etype), etype-major keyed so
        # the unique table is itself etype-sorted (=> segment MM applies).
        key = etype.astype(np.int64) * np.int64(num_nodes) + src.astype(np.int64)
        uniq_key, edge_to_unique = np.unique(key, return_inverse=True)
        unique_etype = (uniq_key // num_nodes).astype(np.int32)
        unique_src = (uniq_key % num_nodes).astype(np.int32)
        unique_etype_ptr = _segment_ptr(unique_etype, num_etypes)

        return HeteroGraph(
            num_nodes=num_nodes,
            num_ntypes=num_ntypes,
            num_etypes=num_etypes,
            src=src,
            dst=dst,
            etype=etype,
            etype_ptr=etype_ptr,
            node_type=node_type,
            ntype_ptr=ntype_ptr,
            perm_dst=perm_dst.astype(np.int32),
            dst_sorted=dst_sorted,
            dst_ptr=dst_ptr,
            unique_src=unique_src,
            unique_etype=unique_etype,
            unique_etype_ptr=unique_etype_ptr,
            edge_to_unique=edge_to_unique.astype(np.int32),
        )

    # ------------------------------------------------------------------
    def to_tensors(self) -> "GraphTensors":
        """The graph's index arrays as int32 CPU tensors (sharing the NumPy
        buffers); ``GraphTensors.to`` moves them."""
        arrays = {f: torch.from_numpy(np.ascontiguousarray(getattr(self, f)))
                  for f in _ARRAY_FIELDS}
        return GraphTensors(**arrays, num_nodes=self.num_nodes,
                            num_ntypes=self.num_ntypes,
                            num_etypes=self.num_etypes)


def to_device(t: torch.Tensor, device, non_blocking: bool = False):
    """``t`` on ``device``; a host tensor bound for a card is pinned first,
    so a ``non_blocking`` copy is truly asynchronous."""
    if (non_blocking and t.device.type == "cpu"
            and torch.device(device).type == "cuda"):
        t = t.pin_memory()
    return t.to(device, non_blocking=non_blocking)


_ARRAY_FIELDS = (
    "src", "dst", "etype", "etype_ptr", "node_type", "ntype_ptr",
    "perm_dst", "dst_sorted", "dst_ptr",
    "unique_src", "unique_etype", "unique_etype_ptr", "edge_to_unique",
)


@dataclasses.dataclass(frozen=True)
class GraphTensors:
    """A graph's index arrays as torch tensors (counts as plain ints).

    The reference's pytree becomes a frozen dataclass: ``to(device)`` moves
    every tensor and keeps the counts."""

    src: torch.Tensor
    dst: torch.Tensor
    etype: torch.Tensor
    etype_ptr: torch.Tensor
    node_type: torch.Tensor
    ntype_ptr: torch.Tensor
    perm_dst: torch.Tensor
    dst_sorted: torch.Tensor
    dst_ptr: torch.Tensor
    unique_src: torch.Tensor
    unique_etype: torch.Tensor
    unique_etype_ptr: torch.Tensor
    edge_to_unique: torch.Tensor
    num_nodes: int
    num_ntypes: int
    num_etypes: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_unique(self) -> int:
        return int(self.unique_src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device, non_blocking: bool = False) -> "GraphTensors":
        return dataclasses.replace(self, **{
            f: to_device(getattr(self, f), device, non_blocking)
            for f in _ARRAY_FIELDS})


# ----------------------------------------------------------------------
# synthetic heterograph generator (Table 3 stand-ins; see DESIGN.md §8.2)
# ----------------------------------------------------------------------
def synthetic_heterograph(
    num_nodes: int,
    num_edges: int,
    num_ntypes: int,
    num_etypes: int,
    seed: int = 0,
    degree_alpha: float = 1.2,
    target_compaction: Optional[float] = None,
) -> HeteroGraph:
    """Power-law-ish heterograph matching (N, E, #ntypes, #etypes) statistics.

    ``target_compaction`` controls the entity-compaction ratio
    (#unique (src,etype) pairs / #edges, the paper's Fig. 10 metric): edges
    draw their (src, etype) from a pool of ~ratio*E unique pairs, replicating
    the source-reuse structure of the real datasets."""
    rng = np.random.default_rng(seed)
    # node types: dirichlet split, presorted
    props = rng.dirichlet(np.full(num_ntypes, 2.0))
    counts = np.maximum(1, (props * num_nodes).astype(np.int64))
    counts[-1] = max(1, num_nodes - int(counts[:-1].sum()))
    node_type = np.repeat(np.arange(num_ntypes, dtype=np.int32), counts)[:num_nodes]
    node_type = np.sort(node_type)
    # power-law destination popularity
    pop = rng.pareto(degree_alpha, size=num_nodes) + 1.0
    pop /= pop.sum()
    dst = rng.choice(num_nodes, size=num_edges, p=pop).astype(np.int32)
    if target_compaction is None:
        src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int32)
        etype = rng.integers(0, num_etypes, size=num_edges, dtype=np.int32)
    else:
        u = max(1, int(num_edges * target_compaction))
        pool_src = rng.integers(0, num_nodes, size=u, dtype=np.int32)
        pool_et = rng.integers(0, num_etypes, size=u, dtype=np.int32)
        pick = np.concatenate([
            np.arange(u, dtype=np.int64),          # each pair used >= once
            rng.integers(0, u, size=max(0, num_edges - u)),
        ])[:num_edges]
        src, etype = pool_src[pick], pool_et[pick]
    return HeteroGraph.from_edges(
        src, dst, etype,
        num_nodes=num_nodes, num_etypes=num_etypes,
        node_type=node_type, num_ntypes=num_ntypes,
    )


# Published statistics of the paper's Table 3 datasets (post DGL/OGB
# preprocessing). Used by benchmarks with a scale factor for CPU tractability.
TABLE3_DATASETS = {
    # name: (num_nodes, num_ntypes, num_edges, num_etypes)
    "aifb":    (7_300,     7,  49_000,   104),
    "am":      (1_900_000, 7,  5_700_000, 108),
    "bgs":     (95_000,    27, 673_000,  122),
    "biokg":   (94_000,    5,  4_800_000, 51),
    "fb15k":   (15_000,    1,  620_000,  474),
    "mag":     (1_900_000, 4,  21_000_000, 4),
    "mutag":   (27_000,    5,  148_000,  50),
    "wikikg2": (2_500_000, 1,  16_000_000, 535),
}


# Entity-compaction ratios (Fig. 10): AM 57% and FB15k 26% are published in
# the paper text; the rest are estimates consistent with its Fig. 10 chart.
TABLE3_COMPACTION = {
    "aifb": 0.80, "am": 0.57, "bgs": 0.75, "biokg": 0.45,
    "fb15k": 0.26, "mag": 0.34, "mutag": 0.70, "wikikg2": 0.55,
}


# CPU-tractable scale factors (statistics proportional) shared by the
# benchmarks and the --reduced serving mode, so both run the same graphs.
CPU_REDUCED_SCALES = {
    "aifb": 0.5, "mutag": 0.2, "bgs": 0.03, "fb15k": 0.03,
    "biokg": 0.005, "am": 0.004, "mag": 0.001, "wikikg2": 0.001,
}


def table3_graph(name: str, scale: float = 1.0, seed: int = 0) -> HeteroGraph:
    n, nt, e, et = TABLE3_DATASETS[name]
    return synthetic_heterograph(
        max(8, int(n * scale)), max(8, int(e * scale)), nt, et, seed=seed,
        target_compaction=TABLE3_COMPACTION.get(name),
    )
