"""The port's own copy of ``repro.core.ir.validate``.

Inter-operator IR validation (shared by the authoring DSL and the
lowering entry point).

Historically a malformed program — an ``EdgeSoftmax`` reading a variable
nobody wrote, an etype-indexed weight inside a for-each-node loop, a dim
mismatch between two chained typed linears — surfaced as a bare ``KeyError``
deep inside ``passes.lower_program`` or a shape error under ``jit``. This
module rejects such programs *at construction time* with a named
``ProgramValidationError`` carrying the statement index and (when the
program was traced by the frontend) the authoring source line.

Two entry points:

* ``check_var_refs`` — the cheap referential subset (undefined edge/node
  vars, including the ``EdgeSoftmax``/``NodeAggregate`` operands).
  ``lower_program`` runs it on every input program.
* ``validate_program`` — the full pass: referential checks plus loop-domain
  rules (edge data in node loops and vice versa), weight-index legality,
  and best-effort dim inference across ``@`` / ``dot`` / elementwise ops.
  The tracing frontend runs it on every traced model.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.ir import inter_op as I


class ProgramValidationError(ValueError):
    """A Program is malformed. Message carries the program name, the
    statement index, and — for DSL-traced programs — the authoring model
    line (``file:line: code``)."""

    def __init__(self, message: str, *, program: Optional[str] = None,
                 stmt_index: Optional[int] = None,
                 source: Optional[I.SourceLoc] = None):
        where = []
        if program:
            where.append(f"model '{program}'")
        if stmt_index is not None:
            where.append(f"statement {stmt_index}")
        if source is not None:
            where.append(f"[{source}]")
        prefix = " ".join(where)
        super().__init__(f"{prefix}: {message}" if prefix else message)
        self.program = program
        self.stmt_index = stmt_index
        self.source = source


_ALLOWED_INDEXED_BY = (None, "etype", "ntype", "ntype_src", "ntype_dst")
_EDGE_STMT_INDEXED_BY = (None, "etype")


class _Validator:
    def __init__(self, prog: I.Program, shapes: bool, domains: bool):
        self.prog = prog
        self.shapes = shapes
        self.domains = domains
        self.edge_vars: Dict[str, Optional[int]] = {}
        self.node_vars: Dict[str, Optional[int]] = {}
        self.inputs: Dict[str, int] = {}    # named input feature -> dim
        self.i = 0

    # ------------------------------------------------------------------
    def fail(self, message: str) -> None:
        src = self.prog.source or {}
        raise ProgramValidationError(
            message, program=self.prog.name, stmt_index=self.i,
            source=src.get(self.i))

    def need_edge_var(self, name: str, what: str) -> Optional[int]:
        if name in self.node_vars:
            self.fail(f"{what} requires an edge var, but n[{name}] is a "
                      f"node var (produced by a for-each-node statement)")
        if name not in self.edge_vars:
            have = sorted(self.edge_vars) or ["<none>"]
            self.fail(f"{what} reads undefined edge var '{name}'; "
                      f"edge vars defined so far: {', '.join(have)}")
        return self.edge_vars[name]

    # ------------------------------------------------------------------
    def run(self) -> None:
        for i, s in enumerate(self.prog.stmts):
            self.i = i
            if isinstance(s, I.EdgeCompute):
                self.check_expr(s.expr, domain="edge")
                self.edge_vars[s.out] = (
                    self.infer(s.expr) if self.shapes else None)
            elif isinstance(s, I.NodeCompute):
                self.check_expr(s.expr, domain="node")
                self.node_vars[s.out] = (
                    self.infer(s.expr) if self.shapes else None)
            elif isinstance(s, I.EdgeSoftmax):
                self.need_edge_var(s.src, "edge_softmax")
                self.edge_vars[s.out] = 1
            elif isinstance(s, I.NodeAggregate):
                d = self.need_edge_var(s.msg, "aggregate message")
                if s.scale is not None:
                    self.need_edge_var(s.scale, "aggregate scale")
                if s.reduce not in ("sum", "mean"):
                    self.fail(f"unknown aggregate reduce {s.reduce!r}; "
                              f"pick 'sum' or 'mean'")
                self.node_vars[s.out] = d
        for out in self.prog.outputs:
            if out not in self.edge_vars and out not in self.node_vars:
                raise ProgramValidationError(
                    f"output '{out}' is never assigned",
                    program=self.prog.name)

    # ------------------------------------------------------------------
    def check_expr(self, e: I.Expr, domain: str,
                   linear_x: bool = False) -> None:
        if isinstance(e, I.EdgeVar):
            if domain == "node" and self.domains:
                self.fail(f"edge var e[{e.name}] read in a for-each-node"
                          f" statement; aggregate it first")
            else:
                # referential check runs in both modes (and in both
                # domains): an undefined edge var must never reach codegen
                self.need_edge_var(e.name, "expression")
        elif isinstance(e, I.NodeVar):
            if domain == "edge" and self.domains:
                self.fail(f"node var n[{e.name}] read in a for-each-edge "
                          f"statement; use e.src[...] / e.dst[...]")
            if domain == "node" and e.name not in self.node_vars:
                have = sorted(self.node_vars) or ["<none>"]
                self.fail(f"undefined node var '{e.name}'; node vars "
                          f"defined so far: {', '.join(have)}")
        elif isinstance(e, I.NodeFeature):
            if domain == "edge" and self.domains:
                self.fail(f"node data n.{e.name} read in a for-each-edge "
                          f"statement; use e.src[{e.name!r}] or "
                          f"e.dst[{e.name!r}]")
            if domain == "node" and self.domains and not linear_x:
                # the lowering has no elementwise read of a raw input
                # feature (it would fall back past the executor), and this
                # shape is almost always a typo'd produced-var name
                have = sorted(self.node_vars) or ["<none>"]
                self.fail(f"input n.{e.name} can only feed a linear ('@') "
                          f"in a for-each-node statement; if you meant a "
                          f"produced node var, check the name (node vars "
                          f"defined so far: {', '.join(have)})")
        elif isinstance(e, (I.SrcFeature, I.DstFeature)):
            if domain == "node" and self.domains:
                end = "src" if isinstance(e, I.SrcFeature) else "dst"
                self.fail(f"edge endpoint data e.{end}.{e.name} read in a "
                          f"for-each-node statement")
        elif isinstance(e, I.Weight) and self.domains:
            if e.indexed_by not in _ALLOWED_INDEXED_BY:
                self.fail(f"weight '{e.name}' has unknown "
                          f"indexed_by={e.indexed_by!r}; pick one of "
                          f"{_ALLOWED_INDEXED_BY}")
            if domain == "edge" and e.indexed_by not in _EDGE_STMT_INDEXED_BY:
                self.fail(
                    f"weight '{e.name}' indexed_by={e.indexed_by!r} cannot "
                    f"be used in a for-each-edge statement (the lowering "
                    f"has no edgewise {e.indexed_by}-segmented GEMM); "
                    f"index it by 'etype', or apply it in a for-each-node "
                    f"statement and read the result via e.src/e.dst")
            if domain == "node" and e.indexed_by == "etype":
                self.fail(f"etype-indexed weight '{e.name}' used in a "
                          f"for-each-node statement (no edge type is in "
                          f"scope); move the computation onto the edges")
        if isinstance(e, (I.TypedLinear, I.Linear)):
            # only the *direct* GEMM input may be a raw node feature
            self.check_expr(e.x, domain, linear_x=True)
            self.check_expr(e.weight, domain)
        else:
            for c in e.children():
                self.check_expr(c, domain)

    # ------------------------------------------------------------------
    # best-effort dim inference (None = unknown; errors only on known-known
    # conflicts, so partially-annotated programs never false-positive)
    # ------------------------------------------------------------------
    def named_dim(self, name: str) -> Optional[int]:
        if name in self.node_vars:
            return self.node_vars[name]
        return self.inputs.get(name)

    def bind_named(self, e: I.Expr, d: int) -> None:
        if isinstance(e, (I.NodeFeature, I.SrcFeature, I.DstFeature)):
            if e.name in self.node_vars:
                return
            prev = self.inputs.get(e.name)
            if prev is not None and prev != d:
                self.fail(f"input feature '{e.name}' used with inconsistent"
                          f" dims: {prev} vs {d}")
            self.inputs[e.name] = d

    def infer(self, e: I.Expr) -> Optional[int]:
        if isinstance(e, (I.NodeFeature, I.SrcFeature, I.DstFeature)):
            return self.named_dim(e.name)
        if isinstance(e, I.EdgeVar):
            return self.edge_vars.get(e.name)
        if isinstance(e, I.NodeVar):
            return self.node_vars.get(e.name)
        if isinstance(e, I.Weight):
            return e.shape[0] if len(e.shape) == 1 else None
        if isinstance(e, I.Scalar):
            return 1
        if isinstance(e, (I.TypedLinear, I.Linear)):
            xd = self.infer(e.x)
            w = e.weight
            if len(w.shape) >= 2:
                if xd is None:
                    self.bind_named(e.x, w.shape[0])
                elif xd != w.shape[0]:
                    self.fail(f"dim mismatch in '@': left operand "
                              f"({I.render_expr(e.x)}) has dim {xd} but "
                              f"weight '{w.name}' expects {w.shape[0]}")
                return w.shape[-1]
            return None
        if isinstance(e, I.DotProduct):
            ad, bd = self.infer(e.a), self.infer(e.b)
            if ad is None and bd is not None:
                self.bind_named(e.a, bd)
            if bd is None and ad is not None:
                self.bind_named(e.b, ad)
            if ad is not None and bd is not None and ad != bd:
                self.fail(f"dot() operand dim mismatch: "
                          f"{I.render_expr(e.a)} has dim {ad} but "
                          f"{I.render_expr(e.b)} has dim {bd}")
            return 1
        if isinstance(e, I.Binary):
            ad, bd = self.infer(e.a), self.infer(e.b)
            if (ad is not None and bd is not None and ad != bd
                    and 1 not in (ad, bd)):
                self.fail(f"'{e.op}' operand dim mismatch: "
                          f"{I.render_expr(e.a)} has dim {ad} but "
                          f"{I.render_expr(e.b)} has dim {bd}")
            for d in (ad, bd):
                if d is not None and d != 1:
                    return d
            # an unknown operand broadcast against a scalar stays unknown
            # (x * 2.0 must not collapse to dim 1)
            if ad is None or bd is None:
                return None
            return 1
        if isinstance(e, I.Unary):
            return self.infer(e.a)
        if isinstance(e, I.Concat):
            dims = [self.infer(p) for p in e.parts]
            if any(d is None for d in dims):
                return None
            return sum(dims)
        return None


def validate_program(prog: I.Program) -> I.Program:
    """Full validation: referential + loop-domain + weight-index + dim
    checks. Raises ``ProgramValidationError``; returns ``prog`` unchanged
    so it can be used inline."""
    _Validator(prog, shapes=True, domains=True).run()
    return prog


def check_var_refs(prog: I.Program) -> I.Program:
    """Referential subset only (undefined edge/node vars, incl. the
    ``EdgeSoftmax``/``NodeAggregate`` operands). Run by ``lower_program``
    on every input, replacing the opaque downstream ``KeyError``s."""
    _Validator(prog, shapes=False, domains=False).run()
    return prog
