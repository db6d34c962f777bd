"""The port's own copy of ``repro.core.ir.inter_op``; behaviour and
rendering are unchanged, and ``tests/test_torch_ir.py`` holds the two
copies to equal ``describe()`` output and fingerprints.

Hector inter-operator level IR (paper §3.2).

The IR expresses RGNN model semantics as for-each-edge / for-each-node loops
over typed graph elements, **without** dictating data layout. Constructs map
1:1 onto Table 2 of the paper:

  node/edge iterators        -> ``ForEachEdge`` / ``ForEachNode`` statements
  ``e.src``, ``e.dst``       -> ``SrcFeature`` / ``DstFeature`` accessors
  ``W[e.etype]``             -> ``Weight(name, indexed_by="etype")``
  input data ``n.feature``   -> ``NodeFeature``
  produced data ``e["att"]`` -> ``EdgeVar`` / ``NodeVar`` (layout decided later)
  GEMM-eligible ops          -> ``TypedLinear``, ``Linear``
  GEMM-ineligible ops        -> ``DotProduct``, elementwise ``Unary``/``Binary``
  manipulation               -> ``Concat``, reshape is implicit

A model is a ``Program``: an ordered list of statements. Layout choices
(vanilla vs compact materialization per edge variable) are annotations kept
*next to* the program (``Program.layouts``), never inside expressions —
that decoupling is the paper's central design point.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SourceLoc:
    """Where a statement was authored (filled in by the tracing frontend)."""

    file: str
    line: int
    text: str = ""

    def __str__(self) -> str:
        tail = f": {self.text}" if self.text else ""
        return f"{self.file}:{self.line}{tail}"


class Layout(enum.Enum):
    """Materialization choice for an edge-associated variable (§3.2.2)."""

    VANILLA = "vanilla"     # one row per edge (etype-sorted canonical order)
    COMPACT = "compact"     # one row per unique (src node, etype) pair


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Expr:
    def free_inputs(self) -> Tuple["Expr", ...]:
        return ()

    def children(self) -> Tuple["Expr", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class NodeFeature(Expr):
    """Input node feature tensor [N, d]."""
    name: str = "feature"


@dataclasses.dataclass(frozen=True)
class SrcFeature(Expr):
    """``e.src.<name>`` — gather of node data by edge source."""
    name: str = "feature"


@dataclasses.dataclass(frozen=True)
class DstFeature(Expr):
    """``e.dst.<name>`` — gather of node data by edge destination."""
    name: str = "feature"


@dataclasses.dataclass(frozen=True)
class EdgeVar(Expr):
    """``e["name"]`` — produced edgewise data."""
    name: str


@dataclasses.dataclass(frozen=True)
class NodeVar(Expr):
    """``n["name"]`` — produced nodewise data."""
    name: str


@dataclasses.dataclass(frozen=True)
class Weight(Expr):
    """Model weight, optionally indexed by a type dimension.

    ``indexed_by`` in {None, "etype", "ntype_src", "ntype_dst"}; shape is the
    *per-type* shape (e.g. (d_in, d_out) for a typed linear).
    """
    name: str
    shape: Tuple[int, ...]
    indexed_by: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TypedLinear(Expr):
    """``x @ W[type]`` — the edgewise/nodewise typed linear layer (§2.3)."""
    x: Expr
    weight: Weight

    def children(self):
        return (self.x, self.weight)


@dataclasses.dataclass(frozen=True)
class Linear(Expr):
    """Untyped linear ``x @ W`` (single relation degenerate case, §3.7)."""
    x: Expr
    weight: Weight

    def children(self):
        return (self.x, self.weight)


@dataclasses.dataclass(frozen=True)
class DotProduct(Expr):
    """Edgewise dot product -> scalar per edge (GEMM-ineligible, §3.3.1)."""
    a: Expr
    b: Expr

    def children(self):
        return (self.a, self.b)


@dataclasses.dataclass(frozen=True)
class Binary(Expr):
    op: str  # add | sub | mul | div
    a: Expr
    b: Expr

    def children(self):
        return (self.a, self.b)


@dataclasses.dataclass(frozen=True)
class Unary(Expr):
    op: str  # exp | leaky_relu | relu | sigmoid | neg | tanh
    a: Expr
    alpha: float = 0.01  # leaky_relu slope

    def children(self):
        return (self.a,)


@dataclasses.dataclass(frozen=True)
class Concat(Expr):
    parts: Tuple[Expr, ...]

    def children(self):
        return tuple(self.parts)


@dataclasses.dataclass(frozen=True)
class Scalar(Expr):
    value: float


# ---------------------------------------------------------------------------
# statements
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Stmt:
    pass


@dataclasses.dataclass(frozen=True)
class EdgeCompute(Stmt):
    """``for e in g.edges(): e[out] = expr``"""
    out: str
    expr: Expr


@dataclasses.dataclass(frozen=True)
class EdgeSoftmax(Stmt):
    """``e[out] = softmax_{edges sharing e.dst}(e[src])`` (Listing 1 lines 1-9).

    Kept as a composite statement; canonicalization may expand it into the
    exp / per-dst-sum / divide loop nest, and the traversal template re-fuses
    it (§3.2.4 loop transformation round-trips this).
    """
    out: str
    src: str


@dataclasses.dataclass(frozen=True)
class NodeAggregate(Stmt):
    """``for n: n[out] = reduce_{e in n.incoming_edges()} scale * e[msg]``.

    ``scale`` (optional edge scalar variable, e.g. attention) multiplies each
    message row; reduce is 'sum' or 'mean' (mean divides by in-degree, the
    RGCN 1/c_{v,r} normalizer folded per destination).
    """
    out: str
    msg: str
    scale: Optional[str] = None
    reduce: str = "sum"


@dataclasses.dataclass(frozen=True)
class NodeCompute(Stmt):
    """``for n in g.nodes(): n[out] = expr`` (expr over node data)."""
    out: str
    expr: Expr


# ---------------------------------------------------------------------------
# rendering (stable textual form; the basis of the structural fingerprint)
# ---------------------------------------------------------------------------
_BINOP_SYMBOL = {"add": "+", "sub": "-", "mul": "*", "div": "/"}


def render_expr(e: Expr) -> str:
    """Deterministic, fully-semantic rendering of an expression tree."""
    if isinstance(e, NodeFeature):
        return f"n.{e.name}"
    if isinstance(e, SrcFeature):
        return f"e.src.{e.name}"
    if isinstance(e, DstFeature):
        return f"e.dst.{e.name}"
    if isinstance(e, EdgeVar):
        return f"e[{e.name}]"
    if isinstance(e, NodeVar):
        return f"n[{e.name}]"
    if isinstance(e, Weight):
        dims = "x".join(str(d) for d in e.shape)
        return f"{e.name}[{e.indexed_by or 'shared'}:{dims}]"
    if isinstance(e, (TypedLinear, Linear)):
        return f"({render_expr(e.x)} @ {render_expr(e.weight)})"
    if isinstance(e, DotProduct):
        return f"dot({render_expr(e.a)}, {render_expr(e.b)})"
    if isinstance(e, Binary):
        sym = _BINOP_SYMBOL.get(e.op, e.op)
        return f"({render_expr(e.a)} {sym} {render_expr(e.b)})"
    if isinstance(e, Unary):
        if e.op == "leaky_relu":
            # repr: full float precision — the fingerprint must distinguish
            # constants closer than %g's 6 significant digits
            return f"leaky_relu({render_expr(e.a)}, {e.alpha!r})"
        return f"{e.op}({render_expr(e.a)})"
    if isinstance(e, Concat):
        return "concat(" + ", ".join(render_expr(p) for p in e.parts) + ")"
    if isinstance(e, Scalar):
        return repr(e.value)
    return repr(e)


def render_stmt(s: Stmt) -> str:
    if isinstance(s, EdgeCompute):
        return f"for e: e[{s.out}] = {render_expr(s.expr)}"
    if isinstance(s, EdgeSoftmax):
        return f"for e: e[{s.out}] = edge_softmax(e[{s.src}])"
    if isinstance(s, NodeAggregate):
        scale = f" * e[{s.scale}]" if s.scale else ""
        return (f"for n: n[{s.out}] = {s.reduce}_incoming(e[{s.msg}]"
                f"{scale})")
    if isinstance(s, NodeCompute):
        return f"for n: n[{s.out}] = {render_expr(s.expr)}"
    return repr(s)


# ---------------------------------------------------------------------------
# program
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Program:
    """An RGNN layer as inter-operator IR + decoupled layout annotations.

    ``source`` (optional, filled by the tracing frontend) maps statement
    index -> ``SourceLoc`` of the authoring model line; it is excluded from
    structural equality and from the fingerprint, so a DSL-traced program
    compares equal to its hand-built twin.
    """

    stmts: List[Stmt]
    outputs: List[str]                       # node/edge vars returned
    layouts: Dict[str, Layout] = dataclasses.field(default_factory=dict)
    name: str = "rgnn_layer"
    source: Optional[Dict[int, SourceLoc]] = dataclasses.field(
        default=None, compare=False, repr=False)

    def layout_of(self, var: str) -> Layout:
        return self.layouts.get(var, Layout.VANILLA)

    def clone(self) -> "Program":
        return Program(list(self.stmts), list(self.outputs),
                       dict(self.layouts), self.name,
                       dict(self.source) if self.source else None)

    def describe(self) -> str:
        """Stable textual rendering: every statement, the outputs, and the
        layout annotations. Two programs with identical semantics (and
        identical var names) render identically."""
        lines = [f"Program<{self.name}>"]
        lines += ["  " + render_stmt(s) for s in self.stmts]
        lines.append("  outputs: " + ", ".join(self.outputs))
        if self.layouts:
            lines.append("  layouts: " + ", ".join(
                f"{k}={v.value}" for k, v in sorted(self.layouts.items())))
        return "\n".join(lines)

    def fingerprint(self) -> str:
        """Structural-identity hash (hex). DSL-traced and hand-built
        programs with the same statements/outputs/layouts/name fingerprint
        identically; executor/tuning caches may key on it."""
        return hashlib.sha256(self.describe().encode()).hexdigest()[:16]

    def weights(self) -> Dict[str, Weight]:
        out: Dict[str, Weight] = {}

        def visit(e: Expr):
            if isinstance(e, Weight):
                out[e.name] = e
            for c in e.children():
                visit(c)

        for s in self.stmts:
            if isinstance(s, (EdgeCompute, NodeCompute)):
                visit(s.expr)
        return out


# ---------------------------------------------------------------------------
# expression analysis helpers used by the passes
# ---------------------------------------------------------------------------
def expr_deps(e: Expr) -> set:
    """Set of dependency tags: 'src', 'dst', 'etype', 'ntype', edge/node vars."""
    deps: set = set()

    def visit(x: Expr):
        if isinstance(x, SrcFeature):
            deps.add("src")
        elif isinstance(x, DstFeature):
            deps.add("dst")
        elif isinstance(x, EdgeVar):
            deps.add(("evar", x.name))
        elif isinstance(x, NodeVar):
            deps.add(("nvar", x.name))
        elif isinstance(x, Weight) and x.indexed_by == "etype":
            deps.add("etype")
        elif isinstance(x, Weight) and x.indexed_by in ("ntype_src", "ntype_dst"):
            deps.add("ntype")
            deps.add("src" if x.indexed_by == "ntype_src" else "dst")
        for c in x.children():
            visit(c)

    visit(e)
    return deps


def compactable(e: Expr, compact_vars: set) -> bool:
    """True if an edgewise expression depends only on (src, etype) — the
    compact-materialization applicability condition (§3.2.2). Reading another
    edge var is fine iff that var is itself compact."""
    deps = expr_deps(e)
    if "dst" in deps:
        return False
    for d in deps:
        if isinstance(d, tuple) and d[0] == "evar" and d[1] not in compact_vars:
            return False
    return True
