"""The port's own copy of ``repro.core.ir.passes``; lowered plans
fingerprint identically to the reference's.

Inter-operator level transformation passes (paper §3.2.3–§3.2.5).

Implemented passes:

* ``reorder_linear_ops``   — linear-operator reordering (§3.2.3). Rewrites
  ``dot(typed_linear(x, W), w_vec[etype])`` into
  ``typed_linear(x, (W @ w_vec^T)[etype])``: the weight-by-weight product is
  hoisted out of the edge loop and computed once per relation (BMM), shrinking
  the edgewise GEMM factor from #edges×d×f to #edges×d×1.

* ``apply_compact_materialization`` — compact materialization (§3.2.2).
  Marks every edgewise assignment whose RHS depends only on (source node,
  edge type) with the COMPACT layout; the lowering then materializes one row
  per unique (src, etype) pair and readers go through ``edge_to_unique``.

* ``lower_program``        — the 3-pass greedy lowering (§3.2.5): GEMM
  instances first, traversal instances next (after loop canonicalization and
  fusion), framework fallback last; plus the fusion legality rules of §3.4.2
  (GEMM + per-row-scalar epilogue; traversal regions in the same loop nest).
"""
from __future__ import annotations

import dataclasses
from typing import Collection, Dict, List, Optional, Tuple

from repro_torch.core.ir import inter_op as I
from repro_torch.core.ir import intra_op as O
from repro_torch.core.ir.validate import ProgramValidationError, check_var_refs  # noqa: F401 (re-exported)


# ---------------------------------------------------------------------------
# linear operator reordering (§3.2.3)
# ---------------------------------------------------------------------------
def _resolve(expr: I.Expr, defs: Dict[str, I.Expr]) -> I.Expr:
    """Look through EdgeVar references to the defining expression."""
    seen = set()
    while isinstance(expr, I.EdgeVar) and expr.name in defs:
        if expr.name in seen:  # cycle guard
            break
        seen.add(expr.name)
        expr = defs[expr.name]
    return expr


def reorder_linear_ops(prog: I.Program) -> Tuple[I.Program, List[O.WeightProductSpec]]:
    """Apply the reordering rewrite wherever it creates a weight×weight op.

    Profitability (paper): the rewrite reduces one GEMM factor from the
    number of edges to the hidden dimension, so it is applied whenever the
    pattern matches (the paper implements exactly this policy).
    """
    prog = prog.clone()
    defs: Dict[str, I.Expr] = {}
    for s in prog.stmts:
        if isinstance(s, I.EdgeCompute):
            defs[s.out] = s.expr

    wprods: List[O.WeightProductSpec] = []
    new_stmts: List[I.Stmt] = []
    counter = 0
    for s in prog.stmts:
        if isinstance(s, I.EdgeCompute) and isinstance(s.expr, I.DotProduct):
            dot = s.expr
            lhs = _resolve(dot.a, defs)
            rhs = dot.b
            if (
                isinstance(lhs, I.TypedLinear)
                and isinstance(lhs.x, (I.SrcFeature, I.DstFeature))
                and isinstance(rhs, I.Weight)
                and rhs.indexed_by == "etype"
                and lhs.weight.indexed_by == "etype"
                and len(rhs.shape) == 1
            ):
                counter += 1
                composed_name = f"_wprod{counter}__{lhs.weight.name}__{rhs.name}"
                wprods.append(
                    O.WeightProductSpec(
                        kid=f"wprod_{counter}",
                        out=composed_name,
                        w_matrix=lhs.weight.name,
                        w_vector=rhs.name,
                        transpose=True,
                    )
                )
                composed = I.Weight(
                    name=composed_name,
                    shape=(lhs.weight.shape[0], 1),
                    indexed_by="etype",
                )
                # (x W_r) · w_r  ->  x (W_r w_r^T): a typed linear with f=1
                new_stmts.append(
                    I.EdgeCompute(out=s.out, expr=I.TypedLinear(lhs.x, composed))
                )
                continue
        new_stmts.append(s)
    prog.stmts = new_stmts
    return prog, wprods


# ---------------------------------------------------------------------------
# compact materialization (§3.2.2)
# ---------------------------------------------------------------------------
def apply_compact_materialization(
    prog: I.Program, only: Optional[Collection[str]] = None
) -> I.Program:
    """Mark compactable edgewise variables with the COMPACT layout.

    Paper applicability condition (§3.2.2): the edgewise operator depends
    only on (source node, edge type) AND its output has shape
    (num_edges, hidden) — i.e. it is a materialized GEMM-template output
    (typed linear), not a scalar traversal product.

    ``only`` restricts the marking to a chosen subset of the eligible vars
    — the per-variable materialization decision of the autotuner (the paper
    applies compaction all-or-nothing per model; Table 5 shows the best
    choice varies, so the tuner decides per variable). Vars outside
    ``only`` stay VANILLA, and a var whose compactable *inputs* were left
    VANILLA is itself no longer eligible (its reads go through per-edge
    rows).
    """
    prog = prog.clone()
    compact_vars: set = set()
    for s in prog.stmts:
        if (
            isinstance(s, I.EdgeCompute)
            and isinstance(s.expr, I.TypedLinear)
            and I.compactable(s.expr, compact_vars)
            and (only is None or s.out in only)
        ):
            prog.layouts[s.out] = I.Layout.COMPACT
            compact_vars.add(s.out)
    return prog


def compactable_edge_vars(prog: I.Program, reorder: bool = True) -> List[str]:
    """Names of the edge vars ``lower_program`` *could* mark COMPACT, after
    the same pre-passes it would run (so the names line up with the plan the
    autotuner will lower). The tuner enumerates its per-var materialization
    space from this list."""
    if reorder:
        prog, _ = reorder_linear_ops(prog)
    prog = flatten_gemms(prog)
    names: List[str] = []
    compact_vars: set = set()
    for s in prog.stmts:
        if (
            isinstance(s, I.EdgeCompute)
            and isinstance(s.expr, I.TypedLinear)
            and I.compactable(s.expr, compact_vars)
        ):
            names.append(s.out)
            compact_vars.add(s.out)
    return names


# ---------------------------------------------------------------------------
# flattening: hoist nested GEMM-eligible subexpressions into statements so
# pass 1 of the lowering can claim them (part of loop canonicalization)
# ---------------------------------------------------------------------------
def flatten_gemms(prog: I.Program) -> I.Program:
    prog = prog.clone()
    new_stmts: List[I.Stmt] = []
    counter = [0]

    def hoist(e: I.Expr, acc: List[I.Stmt], top: bool) -> I.Expr:
        if isinstance(e, (I.TypedLinear, I.Linear)) and not top:
            x = hoist(e.x, acc, top=False)
            counter[0] += 1
            tmp = f"_flat{counter[0]}"
            acc.append(I.EdgeCompute(tmp, dataclasses.replace(e, x=x)))
            return I.EdgeVar(tmp)
        if isinstance(e, I.TypedLinear):
            return dataclasses.replace(e, x=hoist(e.x, acc, top=False))
        if isinstance(e, I.Linear):
            return dataclasses.replace(e, x=hoist(e.x, acc, top=False))
        if isinstance(e, I.DotProduct):
            return I.DotProduct(hoist(e.a, acc, False), hoist(e.b, acc, False))
        if isinstance(e, I.Binary):
            return I.Binary(e.op, hoist(e.a, acc, False), hoist(e.b, acc, False))
        if isinstance(e, I.Unary):
            return I.Unary(e.op, hoist(e.a, acc, False), e.alpha)
        if isinstance(e, I.Concat):
            return I.Concat(tuple(hoist(p, acc, False) for p in e.parts))
        return e

    for s in prog.stmts:
        if isinstance(s, I.EdgeCompute):
            acc: List[I.Stmt] = []
            expr = hoist(s.expr, acc, top=True)
            new_stmts.extend(acc)
            new_stmts.append(I.EdgeCompute(s.out, expr))
        else:
            new_stmts.append(s)
    prog.stmts = new_stmts
    return prog


# ---------------------------------------------------------------------------
# loop canonicalization (§3.2.4) — expand composites so fusion sees loops
# ---------------------------------------------------------------------------
def canonicalize(prog: I.Program) -> I.Program:
    """Expand EdgeSoftmax into its loop form (exp / per-dst reduce / divide).

    Graph-semantic-aware rule: a for-each-edge loop is equivalent to the
    nest over destination nodes × incoming edges, so the expansion stays
    fusable with a following NodeAggregate into one traversal region.

    TPU adaptation note: we emit the max-stabilized softmax (segment-max
    before exp); DGL's edge_softmax — the paper's comparison target — is
    also stabilized.
    """
    prog = prog.clone()
    new_stmts: List[I.Stmt] = []
    for s in prog.stmts:
        if isinstance(s, I.EdgeSoftmax):
            new_stmts.append(_ExpandedSoftmax(out=s.out, src=s.src))
        else:
            new_stmts.append(s)
    prog.stmts = new_stmts
    return prog


@dataclasses.dataclass(frozen=True)
class _ExpandedSoftmax(I.Stmt):
    """Internal canonical form of EdgeSoftmax (a fused traversal region)."""

    out: str
    src: str


# ---------------------------------------------------------------------------
# lowering (§3.2.5): three greedy passes + fusion
# ---------------------------------------------------------------------------
def _gemm_eligible(stmt: I.Stmt, layouts: Dict[str, I.Layout]) -> Optional[O.GemmSpec]:
    """Pass-1 eligibility: typed/untyped linear over node or edge data."""
    if isinstance(stmt, I.EdgeCompute):
        e = stmt.expr
        scale = None
        # fused epilogue: expr = typed_linear(...) * e[scalar]  (§3.4.2 rule 1)
        if (
            isinstance(e, I.Binary)
            and e.op == "mul"
            and isinstance(e.a, I.TypedLinear)
            and isinstance(e.b, I.EdgeVar)
        ):
            scale = e.b.name
            e = e.a
        if isinstance(e, I.TypedLinear) and isinstance(
            e.x, (I.SrcFeature, I.DstFeature, I.EdgeVar)
        ):
            w = e.weight
            compact = layouts.get(stmt.out) == I.Layout.COMPACT
            if isinstance(e.x, I.SrcFeature):
                gather = (
                    O.GatherScheme.BY_UNIQUE_SRC if compact else O.GatherScheme.BY_EDGE_SRC
                )
                xsrc = "node:" + e.x.name
            elif isinstance(e.x, I.DstFeature):
                gather = O.GatherScheme.BY_EDGE_DST
                xsrc = "node:" + e.x.name
            else:
                gather = O.GatherScheme.IDENTITY
                xsrc = "edge:" + e.x.name
            if w.indexed_by == "etype":
                seg = "unique_etype_ptr" if compact else "etype_ptr"
                tindex = O.TypeIndex.ETYPE
            elif w.indexed_by is None:
                seg, tindex = "none", O.TypeIndex.NONE
            else:
                return None
            return O.GemmSpec(
                kid="", x_source=xsrc, gather=gather, weight=w.name,
                type_index=tindex, seg_ptr=seg, out=stmt.out,
                scatter=O.ScatterScheme.IDENTITY, per_row_scale=scale,
                out_cols=w.shape[-1],
            )
        if isinstance(e, I.Linear):
            return O.GemmSpec(
                kid="", x_source=_xsrc_of(e.x), gather=_gather_of(e.x, layouts),
                weight=e.weight.name, type_index=O.TypeIndex.NONE, seg_ptr="none",
                out=stmt.out, scatter=O.ScatterScheme.IDENTITY,
                out_cols=e.weight.shape[-1],
            )
    if isinstance(stmt, I.NodeCompute):
        e = stmt.expr
        if isinstance(e, I.TypedLinear) and isinstance(e.x, (I.NodeFeature, I.NodeVar)):
            w = e.weight
            if w.indexed_by in ("ntype_src", "ntype_dst", "ntype"):
                return O.GemmSpec(
                    kid="", x_source="node:" + e.x.name, gather=O.GatherScheme.BY_NODE,
                    weight=w.name, type_index=O.TypeIndex.NTYPE, seg_ptr="ntype_ptr",
                    out=stmt.out, scatter=O.ScatterScheme.IDENTITY,
                    out_cols=w.shape[-1],
                )
        if isinstance(e, I.Linear) and isinstance(e.x, (I.NodeFeature, I.NodeVar)):
            return O.GemmSpec(
                kid="", x_source="node:" + _name_of(e.x), gather=O.GatherScheme.BY_NODE,
                weight=e.weight.name, type_index=O.TypeIndex.NONE, seg_ptr="none",
                out=stmt.out, scatter=O.ScatterScheme.IDENTITY,
                out_cols=e.weight.shape[-1],
            )
    return None


def _name_of(x: I.Expr) -> str:
    if isinstance(x, (I.NodeFeature, I.SrcFeature, I.DstFeature)):
        return x.name
    if isinstance(x, (I.EdgeVar, I.NodeVar)):
        return x.name
    raise ValueError(f"unnamed expr {x}")


def _xsrc_of(x: I.Expr) -> str:
    if isinstance(x, (I.NodeFeature, I.NodeVar)):
        return "node:" + _name_of(x)
    if isinstance(x, I.SrcFeature):
        return "node:" + x.name
    return "edge:" + _name_of(x)


def _gather_of(x: I.Expr, layouts) -> O.GatherScheme:
    if isinstance(x, I.SrcFeature):
        return O.GatherScheme.BY_EDGE_SRC
    if isinstance(x, (I.NodeFeature, I.NodeVar)):
        return O.GatherScheme.BY_NODE
    return O.GatherScheme.IDENTITY


# elementwise expression -> traversal statements -------------------------------
def _expr_to_traversal(
    out: str, e: I.Expr, layouts: Dict[str, I.Layout], tmp_prefix: str
) -> Optional[List[O.TraversalStmt]]:
    """Flatten an edgewise elementwise expression tree into traversal stmts.

    Returns None if the expression contains anything non-elementwise."""
    stmts: List[O.TraversalStmt] = []
    counter = [0]

    def emit(e: I.Expr) -> Optional[str]:
        if isinstance(e, I.EdgeVar):
            if layouts.get(e.name) == I.Layout.COMPACT:
                # compact-layout read: indirection through edge_to_unique
                counter[0] += 1
                t = f"{tmp_prefix}_g{counter[0]}"
                stmts.append(O.TraversalStmt("gather_unique", t, (e.name,)))
                return t
            return e.name
        if isinstance(e, I.SrcFeature):
            counter[0] += 1
            t = f"{tmp_prefix}_s{counter[0]}"
            stmts.append(O.TraversalStmt("gather_src", t, ("node:" + e.name,)))
            return t
        if isinstance(e, I.DstFeature):
            counter[0] += 1
            t = f"{tmp_prefix}_d{counter[0]}"
            stmts.append(O.TraversalStmt("gather_dst", t, ("node:" + e.name,)))
            return t
        if isinstance(e, I.NodeVar):
            return "node:" + e.name
        if isinstance(e, I.Scalar):
            return f"scalar:{e.value}"
        if isinstance(e, I.Unary):
            a = emit(e.a)
            if a is None:
                return None
            counter[0] += 1
            t = f"{tmp_prefix}_u{counter[0]}"
            stmts.append(O.TraversalStmt("elementwise", t, (a,), op=e.op, alpha=e.alpha))
            return t
        if isinstance(e, I.Binary):
            a, b = emit(e.a), emit(e.b)
            if a is None or b is None:
                return None
            counter[0] += 1
            t = f"{tmp_prefix}_b{counter[0]}"
            stmts.append(O.TraversalStmt("elementwise", t, (a, b), op=e.op))
            return t
        if isinstance(e, I.DotProduct):
            a, b = emit(e.a), emit(e.b)
            if a is None or b is None:
                return None
            counter[0] += 1
            t = f"{tmp_prefix}_dp{counter[0]}"
            stmts.append(O.TraversalStmt("rowdot", t, (a, b)))
            return t
        if isinstance(e, I.Concat):
            parts = [emit(p) for p in e.parts]
            if any(p is None for p in parts):
                return None
            counter[0] += 1
            t = f"{tmp_prefix}_c{counter[0]}"
            stmts.append(O.TraversalStmt("concat", t, tuple(parts)))
            return t
        if isinstance(e, I.Weight) and e.indexed_by == "etype" and len(e.shape) == 1:
            # per-edge-type vector broadcast onto edges
            counter[0] += 1
            t = f"{tmp_prefix}_w{counter[0]}"
            stmts.append(O.TraversalStmt("gather_etype_weight", t, (e.name,)))
            return t
        return None

    res = emit(e)
    if res is None:
        return None
    # rename the final temp to the real output
    last = stmts[-1]
    stmts[-1] = dataclasses.replace(last, out=out)
    return stmts


def lower_program(
    prog: I.Program,
    reorder: bool = True,
    compact: bool = True,
    compact_vars: Optional[Collection[str]] = None,
) -> O.Plan:
    """Full §3.2.5 pipeline: optimize, canonicalize, 3-pass greedy lowering.

    ``compact_vars`` (from the autotuner's materialization decisions)
    overrides the all-or-nothing ``compact`` flag with an explicit per-var
    COMPACT set; names must come from ``compactable_edge_vars``.

    Malformed programs (e.g. an ``EdgeSoftmax``/``NodeAggregate`` reading
    an edge var nobody wrote) raise ``ProgramValidationError`` naming the
    missing var and the statement index, instead of a bare ``KeyError``
    deep inside the lowering or the generated code.
    """
    check_var_refs(prog)
    weights = dict(prog.weights())
    wprods: List[O.WeightProductSpec] = []
    if reorder:
        prog, wprods = reorder_linear_ops(prog)
        weights.update(prog.weights())
    prog = flatten_gemms(prog)
    if compact_vars is not None:
        prog = apply_compact_materialization(prog, only=compact_vars)
    elif compact:
        prog = apply_compact_materialization(prog)
    prog = canonicalize(prog)
    layouts = dict(prog.layouts)

    ops: List[object] = list(wprods)
    kid = [0]

    def next_kid(prefix: str) -> str:
        kid[0] += 1
        return f"{prefix}_{kid[0]}"

    # --- pass 1: GEMM-template instances (highest preference) -------------
    lowered: List[Optional[object]] = [None] * len(prog.stmts)
    for i, s in enumerate(prog.stmts):
        g = _gemm_eligible(s, layouts)
        if g is not None:
            g.kid = next_kid("gemm")
            lowered[i] = g

    # --- pass 2: traversal-template instances, fused greedily -------------
    pending: List[O.TraversalStmt] = []

    def flush(acc: List[object]):
        if pending:
            acc.append(
                O.TraversalSpec(kid=next_kid("trav"), domain=O.LoopDomain.EDGES,
                                stmts=list(pending))
            )
            pending.clear()

    seq: List[object] = []
    for i, s in enumerate(prog.stmts):
        if lowered[i] is not None:
            flush(seq)
            seq.append(lowered[i])
            continue
        if isinstance(s, _ExpandedSoftmax):
            pending.extend([
                O.TraversalStmt("segment_max", f"_{s.out}_max", (s.src,)),
                O.TraversalStmt("gather_dst_var", f"_{s.out}_maxe", (f"_{s.out}_max",)),
                O.TraversalStmt("elementwise", f"_{s.out}_sh", (s.src, f"_{s.out}_maxe"), op="sub"),
                O.TraversalStmt("elementwise", f"_{s.out}_exp", (f"_{s.out}_sh",), op="exp"),
                O.TraversalStmt("segment_sum", f"_{s.out}_den", (f"_{s.out}_exp",)),
                O.TraversalStmt("gather_dst_var", f"_{s.out}_dene", (f"_{s.out}_den",)),
                O.TraversalStmt("elementwise", s.out, (f"_{s.out}_exp", f"_{s.out}_dene"), op="div"),
            ])
            continue
        if isinstance(s, I.NodeAggregate):
            pending.append(
                O.TraversalStmt("segment_sum" if s.reduce in ("sum", "mean") else s.reduce,
                                s.out, (s.msg,), scale=s.scale,
                                op="mean" if s.reduce == "mean" else None)
            )
            continue
        if isinstance(s, I.EdgeCompute):
            tstmts = _expr_to_traversal(s.out, s.expr, layouts, f"_t{i}")
            if tstmts is not None:
                pending.extend(tstmts)
                continue
        if isinstance(s, I.NodeCompute):
            tstmts = _expr_to_traversal(s.out, s.expr, layouts, f"_t{i}")
            if tstmts is not None:
                flush(seq)
                seq.append(O.TraversalSpec(kid=next_kid("trav"),
                                           domain=O.LoopDomain.NODES,
                                           stmts=tstmts))
                continue
        # --- pass 3: framework fallback -----------------------------------
        flush(seq)
        seq.append(O.FallbackSpec(kid=next_kid("fb"), stmt=s))
    flush(seq)
    ops.extend(seq)

    return O.Plan(name=prog.name, ops=ops, outputs=list(prog.outputs),
                  layouts=layouts, weights=weights)
