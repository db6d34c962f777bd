"""The port's own copy of ``repro.core.ir.intra_op`` (plan fingerprints are
held equal to the reference's by ``tests/test_torch_ir.py``).

Hector intra-operator level IR (paper §3.3).

Every kernel the code generator emits derives from one of two templates:

* ``GemmSpec`` — the GEMM template ``Y[S] = X[G] × W[T]`` (Algorithm 1):
  tiled matmul with pluggable gather scheme on X, type-indexed weight
  selection, scatter scheme on Y, optional fused per-row scalar (the paper's
  "per-row scalar applied to the tiles of matrix A", §3.4.1), transpose
  flags, and an operator-specific schedule (tile sizes, coarsening factor).

* ``TraversalSpec`` — the traversal template (Algorithm 2): fused edgewise /
  nodewise statements executed inside a canonical loop nest, with an
  adjacency access scheme (COO row-index vs CSR binary search on GPU; on TPU
  the scheme selects between dst-sorted segment accumulation and gather-based
  access — see DESIGN.md §3).

Specs carry *all* information needed to emit code; lowering from the
inter-operator IR fills them in (passes.py) and codegen.py materializes JAX
callables / Pallas kernel instantiations from them.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import List, Optional, Tuple

from repro_torch.core.ir import inter_op as iop


class Preference(enum.IntEnum):
    """Operator-instance preference levels for selection (§3.4.2)."""

    FALLBACK = 0      # plain jnp op-by-op (the "PyTorch fallback")
    TRAVERSAL = 1     # traversal-template instance
    GEMM = 2          # GEMM-template instance


class GatherScheme(enum.Enum):
    IDENTITY = "identity"          # X rows already in canonical order
    BY_EDGE_SRC = "edge_src"       # gather node rows via edge src list
    BY_EDGE_DST = "edge_dst"       # gather node rows via edge dst list
    BY_UNIQUE_SRC = "unique_src"   # gather node rows via compact map
    BY_NODE = "node"               # nodewise op: identity over nodes


class ScatterScheme(enum.Enum):
    IDENTITY = "identity"          # contiguous segment output
    BY_EDGE = "edge"               # scatter to canonical edge order
    BY_UNIQUE = "unique"           # scatter to compact rows


class TypeIndex(enum.Enum):
    NONE = "none"          # untyped (single-relation degenerate GEMM)
    ETYPE = "etype"        # weight indexed by edge type
    NTYPE = "ntype"        # weight indexed by node type


@dataclasses.dataclass
class GemmSchedule:
    """Operator-specific schedule knobs (§3.4.1).

    TPU adaptation: ``tile_rows``/``tile_cols`` are VMEM block shapes (MXU
    wants multiples of 128 on the minor dim); ``coarsening`` multiplies the
    rows each grid step processes, trading VMEM for fewer grid iterations
    (the analogue of the paper's thread coarsening factor in {2, 4}).
    """

    tile_rows: int = 128
    tile_cols: int = 128
    tile_k: int = 128
    coarsening: int = 1            # in {1, 2, 4}

    @property
    def block_rows(self) -> int:
        return self.tile_rows * self.coarsening


@dataclasses.dataclass
class GemmSpec:
    """One GEMM-template instance. Y[S] = act( scale ⊙ (X[G] @ W[T]) )."""

    kid: str                               # unique kernel id (FuncName<kid>)
    x_source: str                          # tensor name: node feature / edge var
    gather: GatherScheme
    weight: str                            # weight param name
    type_index: TypeIndex
    seg_ptr: str                           # which segment ptr: 'etype_ptr' | 'unique_etype_ptr' | 'ntype_ptr'
    out: str                               # output var name
    scatter: ScatterScheme
    per_row_scale: Optional[str] = None    # fused epilogue scalar (edge var)
    transpose_w: bool = False
    out_cols: int = 0                      # N dim of the GEMM
    schedule: GemmSchedule = dataclasses.field(default_factory=GemmSchedule)
    preference: Preference = Preference.GEMM

    def can_fuse_epilogue_scale(self) -> bool:
        """§3.4.2: GEMM instances fuse a consumer that multiplies output rows
        by scalars, provided both live in the same (edge) loop."""
        return self.per_row_scale is None


# ---------------------------------------------------------------------------
# traversal template
# ---------------------------------------------------------------------------
class LoopDomain(enum.Enum):
    EDGES = "edges"
    NODES = "nodes"


@dataclasses.dataclass
class TraversalStmt:
    """A statement placed in the traversal loop nest.

    ``kind`` in:
      'elementwise'  out[i] = f(ins[i]...)          (innermost, hoistable)
      'segment_max'  out[dst] = max over incoming    (partial-result agg)
      'segment_sum'  out[dst] = sum over incoming
      'gather_dst'   out[i] = in[dst[i]]             (dst-indexed read)
      'gather_unique' out[i] = in[edge_to_unique[i]] (compact-layout read)
    """

    kind: str
    out: str
    ins: Tuple[str, ...]
    op: Optional[str] = None          # for elementwise: exp/div/mul/leaky_relu/...
    alpha: float = 0.01
    scale: Optional[str] = None       # for segment_sum: per-edge scalar
    hoist_level: int = 0              # loop level after hoisting (§3.4.1)


@dataclasses.dataclass
class TraversalSpec:
    """One traversal-template instance: a fused region of statements."""

    kid: str
    domain: LoopDomain
    stmts: List[TraversalStmt]
    adjacency: str = "dst_csr"        # access scheme: 'dst_csr' | 'coo'
    preference: Preference = Preference.TRAVERSAL
    partial_aggregation: bool = True  # warp/VMEM partial sums before global


@dataclasses.dataclass
class FallbackSpec:
    """Ops the lowering leaves to the framework (lowest preference)."""

    kid: str
    stmt: object                       # the original inter-op Stmt
    preference: Preference = Preference.FALLBACK


@dataclasses.dataclass
class WeightProductSpec:
    """Hoisted weight-by-weight product from linear-operator reordering
    (§3.2.3): computed once per relation via BMM, outside edge loops."""

    kid: str
    out: str                           # derived weight name
    w_matrix: str                      # [R, d, f]
    w_vector: str                      # [R, f] (or [R, f, g])
    transpose: bool = True             # W_r @ w_r^T


@dataclasses.dataclass
class Plan:
    """Fully lowered layer: ordered op instances + bookkeeping."""

    name: str
    ops: List[object]                  # GemmSpec | TraversalSpec | FallbackSpec | WeightProductSpec
    outputs: List[str]
    layouts: dict                      # var -> iop.Layout
    weights: dict                      # name -> iop.Weight

    def gemm_count(self) -> int:
        return sum(isinstance(o, GemmSpec) for o in self.ops)

    def traversal_count(self) -> int:
        return sum(isinstance(o, TraversalSpec) for o in self.ops)

    def fallback_count(self) -> int:
        return sum(isinstance(o, FallbackSpec) for o in self.ops)

    def describe(self) -> str:
        lines = [f"Plan<{self.name}>"]
        for o in self.ops:
            if isinstance(o, GemmSpec):
                lines.append(
                    f"  GEMM<{o.kid}> {o.out} = {o.x_source}[{o.gather.value}]"
                    f" @ {o.weight}[{o.type_index.value}]"
                    + (f" * {o.per_row_scale}" if o.per_row_scale else "")
                    + f" -> scatter:{o.scatter.value} tile={o.schedule.tile_rows}x"
                    f"{o.schedule.tile_cols} coarsen={o.schedule.coarsening}"
                )
            elif isinstance(o, TraversalSpec):
                ops = ",".join(s.kind + (f"({s.op})" if s.op else "") for s in o.stmts)
                lines.append(f"  TRAV<{o.kid}> [{o.domain.value}/{o.adjacency}] {ops}")
            elif isinstance(o, WeightProductSpec):
                lines.append(f"  WPROD<{o.kid}> {o.out} = {o.w_matrix} @ {o.w_vector}^T")
            else:
                lines.append(f"  FALLBACK<{o.kid}> {type(o.stmt).__name__}")
        return "\n".join(lines)

    def fingerprint(self) -> str:
        """Structural-identity hash of the lowered plan: the rendered op
        sequence plus the layout and weight tables. Plans lowered from
        structurally identical programs (DSL-traced or hand-built)
        fingerprint identically; the compiled executors fold this into
        their compile-cache keys."""
        parts = [
            self.describe(),
            repr(self.ops),   # full spec dataclass reprs (describe elides some fields)
            repr(sorted((k, v.value) for k, v in self.layouts.items())),
            repr(sorted((k, (tuple(w.shape), w.indexed_by))
                        for k, w in self.weights.items())),
        ]
        return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]
