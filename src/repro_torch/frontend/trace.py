"""The port's own copy of ``repro.frontend.trace``.

Tracing-based Python-embedded authoring DSL (paper §3.1 / Fig. 5).

A model is a plain Python function over three proxy objects::

    @hector.model
    def rgat(g, e, n, in_dim, out_dim, slope=0.01):
        W   = g.weight("W_rel", (in_dim, out_dim), indexed_by="etype")
        w_s = g.weight("w_att_src", (out_dim,), indexed_by="etype")
        w_t = g.weight("w_att_dst", (out_dim,), indexed_by="etype")
        e["hs"]      = e.src["feature"] @ W
        e["atts"]    = hector.dot(e["hs"], w_s)
        e["attt"]    = hector.dot(e.dst["feature"] @ W, w_t)
        e["att_raw"] = hector.leaky_relu(e["atts"] + e["attt"], slope)
        e["att"]     = hector.edge_softmax(e["att_raw"])
        n["h_out"]   = hector.aggregate(e["hs"], scale=e["att"])
        return n["h_out"]

Calling the decorated model (``rgat(64, 64)``) *traces* it: every
``e[...] = ...`` / ``n[...] = ...`` assignment appends one statement to an
``ir.inter_op.Program`` — the same for-each-edge / for-each-node IR the
hand-built model modules used to assemble from dataclasses — and the traced
program is validated at construction time (``ir.validate``) with
source-located diagnostics pointing at the offending model line. No new IR
is introduced: the tracer is purely a front end over ``inter_op``.

Semantics of the proxies:

* ``g.weight(name, shape, indexed_by=None)`` declares a model weight
  (per-type shape; ``indexed_by`` in {None, 'etype', 'ntype'}).
* ``e.src[name]`` / ``e.dst[name]`` read node data through the edge
  endpoints; ``e[name]`` reads a previously produced edge var; ``n[name]``
  reads a produced node var, or — if no statement wrote it — an input node
  feature.
* ``x @ W`` is the typed (or untyped) linear; ``+ - * /`` are elementwise
  with float->scalar promotion; ``hector.dot`` is the edgewise row dot.
* ``hector.edge_softmax`` / ``hector.aggregate`` build the composite
  statements (assign the former to ``e[...]``, the latter to ``n[...]``).
* ``return n[...]`` (or a tuple of reads) names the program outputs.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import linecache
import os
import sys
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.ir import inter_op as I
from repro_torch.core.ir.validate import ProgramValidationError, validate_program

__all__ = [
    "model", "ModelSpec", "dot", "concat", "edge_softmax", "aggregate",
    "unary", "relu", "leaky_relu", "sigmoid", "tanh", "exp", "neg",
]


def _user_loc(depth: int = 1) -> I.SourceLoc:
    """Source location of the model line currently executing: the caller
    ``depth`` frames above the DSL helper that asked."""
    fr = sys._getframe(depth + 1)
    fname, lineno = fr.f_code.co_filename, fr.f_lineno
    text = linecache.getline(fname, lineno).strip()
    return I.SourceLoc(os.path.basename(fname), lineno, text)


class _Trace:
    """Mutable per-trace state shared by the three proxies."""

    def __init__(self, name: str):
        self.name = name
        self.stmts: List[I.Stmt] = []
        self.source: Dict[int, I.SourceLoc] = {}
        self.edge_vars: Set[str] = set()
        self.node_vars: Set[str] = set()
        self.weights: Dict[str, I.Weight] = {}

    def fail(self, message: str, loc: Optional[I.SourceLoc]) -> None:
        raise ProgramValidationError(message, program=self.name, source=loc)

    def emit(self, stmt: I.Stmt, loc: I.SourceLoc) -> None:
        self.source[len(self.stmts)] = loc
        self.stmts.append(stmt)


# ---------------------------------------------------------------------------
# expression proxies
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Ex:
    """A traced expression; operator overloads build ``inter_op`` trees."""

    expr: I.Expr
    trace: _Trace = dataclasses.field(compare=False, repr=False)

    def _bin(self, op: str, other, swap: bool = False) -> "Ex":
        o = _as_expr(other, self.trace, _user_loc(2))
        a, b = (o, self.expr) if swap else (self.expr, o)
        return Ex(I.Binary(op, a, b), self.trace)

    def __add__(self, other):
        return self._bin("add", other)

    def __radd__(self, other):
        return self._bin("add", other, swap=True)

    def __sub__(self, other):
        return self._bin("sub", other)

    def __rsub__(self, other):
        return self._bin("sub", other, swap=True)

    def __mul__(self, other):
        return self._bin("mul", other)

    def __rmul__(self, other):
        return self._bin("mul", other, swap=True)

    def __truediv__(self, other):
        return self._bin("div", other)

    def __rtruediv__(self, other):
        return self._bin("div", other, swap=True)

    def __neg__(self):
        return Ex(I.Unary("neg", self.expr), self.trace)

    def __matmul__(self, w) -> "Ex":
        loc = _user_loc()
        if not isinstance(w, Wt):
            self.trace.fail(
                "the right operand of '@' must be a weight declared with "
                f"g.weight(...); got {type(w).__name__}", loc)
        if w.weight.indexed_by is None:
            return Ex(I.Linear(self.expr, w.weight), self.trace)
        return Ex(I.TypedLinear(self.expr, w.weight), self.trace)

    def dot(self, other) -> "Ex":
        return dot(self, other)


@dataclasses.dataclass(frozen=True)
class Wt:
    """A declared weight (wrapper so ``x @ W`` can pick Typed/untyped)."""

    weight: I.Weight
    trace: _Trace = dataclasses.field(compare=False, repr=False)


def _as_expr(v, trace: _Trace, loc: Optional[I.SourceLoc]) -> I.Expr:
    if isinstance(v, Ex):
        return v.expr
    if isinstance(v, Wt):
        return v.weight
    if isinstance(v, (int, float)):
        return I.Scalar(float(v))
    if isinstance(v, (_EdgeSoftmaxMarker, _AggregateMarker)):
        trace.fail(f"{v.what} is a statement, not an expression; assign it "
                   f"directly ({v.hint})", loc)
    trace.fail(f"cannot use {type(v).__name__} in a traced expression", loc)
    raise AssertionError  # unreachable


# ---------------------------------------------------------------------------
# composite-statement markers (consumed by e[...]= / n[...]= )
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _EdgeSoftmaxMarker:
    src: Ex
    what: str = "edge_softmax(...)"
    hint: str = 'e["att"] = hector.edge_softmax(...)'


@dataclasses.dataclass(frozen=True)
class _AggregateMarker:
    msg: Ex
    scale: Optional[Ex]
    reduce: str
    what: str = "aggregate(...)"
    hint: str = 'n["h"] = hector.aggregate(...)'


def _edge_var_name(trace: _Trace, v, what: str, out: str,
                   loc: I.SourceLoc, tag: str = "in") -> str:
    """Resolve an argument that must name an edge var; non-var edge
    expressions are materialized into a derived statement first (``tag``
    keeps the temps of one consuming statement distinct)."""
    if isinstance(v, Ex) and isinstance(v.expr, I.NodeVar):
        trace.fail(f"{what} requires an edge var, but n[{v.expr.name}] is "
                   f"a node var (produced by a for-each-node statement)",
                   loc)
    if isinstance(v, Ex) and isinstance(v.expr, I.EdgeVar):
        return v.expr.name
    if isinstance(v, Ex):
        tmp = f"_{out}_{tag}"
        trace.emit(I.EdgeCompute(tmp, v.expr), loc)
        trace.edge_vars.add(tmp)
        return tmp
    trace.fail(f"{what} requires an edge expression; got "
               f"{type(v).__name__}", loc)
    raise AssertionError  # unreachable


# ---------------------------------------------------------------------------
# the three model-function proxies
# ---------------------------------------------------------------------------
class GraphProxy:
    """``g`` — the typed graph: weight declarations live here."""

    def __init__(self, trace: _Trace):
        self._trace = trace

    def weight(self, name: str, shape: Tuple[int, ...],
               indexed_by: Optional[str] = None) -> Wt:
        loc = _user_loc()
        tr = self._trace
        if indexed_by not in (None, "etype", "ntype", "ntype_src",
                              "ntype_dst"):
            tr.fail(f"weight '{name}': unknown indexed_by={indexed_by!r} "
                    f"(pick None, 'etype', 'ntype', 'ntype_src' or "
                    f"'ntype_dst')", loc)
        w = I.Weight(name, tuple(int(d) for d in shape), indexed_by)
        prev = tr.weights.get(name)
        if prev is not None and prev != w:
            tr.fail(f"weight '{name}' redeclared with a different "
                    f"shape/index: {prev} vs {w}", loc)
        tr.weights[name] = w
        return Wt(w, tr)


class _Endpoint:
    """``e.src`` / ``e.dst`` — node data read through an edge endpoint."""

    def __init__(self, trace: _Trace, cls):
        self._trace = trace
        self._cls = cls

    def __getitem__(self, name: str) -> Ex:
        return Ex(self._cls(str(name)), self._trace)


class EdgeProxy:
    """``e`` — the for-each-edge iteration variable."""

    def __init__(self, trace: _Trace):
        self._trace = trace
        self.src = _Endpoint(trace, I.SrcFeature)
        self.dst = _Endpoint(trace, I.DstFeature)

    def __getitem__(self, name: str) -> Ex:
        name = str(name)
        tr = self._trace
        if name not in tr.edge_vars:
            loc = _user_loc()
            if name in tr.node_vars:
                tr.fail(f"'{name}' is a node var; read it with n[{name!r}]"
                        f" (or via e.src/e.dst)", loc)
            have = sorted(tr.edge_vars) or ["<none>"]
            tr.fail(f"undefined edge var '{name}'; edge vars defined so "
                    f"far: {', '.join(have)}", loc)
        return Ex(I.EdgeVar(name), tr)

    def __setitem__(self, name: str, value) -> None:
        name, loc, tr = str(name), _user_loc(), self._trace
        if isinstance(value, _AggregateMarker):
            tr.fail("aggregate(...) reduces edges into nodes; assign it to "
                    f"n[{name!r}], not e[{name!r}]", loc)
        if isinstance(value, _EdgeSoftmaxMarker):
            src = _edge_var_name(tr, value.src, "edge_softmax", name, loc)
            tr.emit(I.EdgeSoftmax(name, src), loc)
        else:
            tr.emit(I.EdgeCompute(name, _as_expr(value, tr, loc)), loc)
        tr.edge_vars.add(name)


class NodeProxy:
    """``n`` — the for-each-node iteration variable. Reads of names no
    statement wrote resolve to *input* node features."""

    def __init__(self, trace: _Trace):
        self._trace = trace

    def __getitem__(self, name: str) -> Ex:
        name, tr = str(name), self._trace
        if name in tr.node_vars:
            return Ex(I.NodeVar(name), tr)
        if name in tr.edge_vars:
            tr.fail(f"'{name}' is an edge var; read it with e[{name!r}]",
                    _user_loc())
        return Ex(I.NodeFeature(name), tr)

    def __setitem__(self, name: str, value) -> None:
        name, loc, tr = str(name), _user_loc(), self._trace
        if isinstance(value, _EdgeSoftmaxMarker):
            tr.fail("edge_softmax(...) produces edge data; assign it to "
                    f"e[{name!r}], not n[{name!r}]", loc)
        if isinstance(value, _AggregateMarker):
            msg = _edge_var_name(tr, value.msg, "aggregate message", name,
                                 loc, tag="msg")
            scale = None
            if value.scale is not None:
                scale = _edge_var_name(tr, value.scale, "aggregate scale",
                                       name, loc, tag="scale")
            tr.emit(I.NodeAggregate(name, msg=msg, scale=scale,
                                    reduce=value.reduce), loc)
        else:
            tr.emit(I.NodeCompute(name, _as_expr(value, tr, loc)), loc)
        tr.node_vars.add(name)


# ---------------------------------------------------------------------------
# DSL operations
# ---------------------------------------------------------------------------
def dot(a, b) -> Ex:
    """Edgewise row dot product -> one scalar per edge (§3.3.1)."""
    loc = _user_loc()
    tr = a.trace if isinstance(a, Ex) else (
        b.trace if isinstance(b, (Ex, Wt)) else None)
    if tr is None:
        raise ProgramValidationError(
            "dot() needs traced operands", source=loc)
    return Ex(I.DotProduct(_as_expr(a, tr, loc), _as_expr(b, tr, loc)), tr)


def concat(*parts) -> Ex:
    loc = _user_loc()
    tr = next((p.trace for p in parts if isinstance(p, Ex)), None)
    if tr is None:
        raise ProgramValidationError(
            "concat() needs traced operands", source=loc)
    return Ex(I.Concat(tuple(_as_expr(p, tr, loc) for p in parts)), tr)


_UNARY_OPS = ("exp", "leaky_relu", "relu", "sigmoid", "neg", "tanh")


def _unary(op: str, x, alpha: float, loc: I.SourceLoc) -> Ex:
    if not isinstance(x, Ex):
        raise ProgramValidationError(
            f"{op}() needs a traced operand, got {type(x).__name__}",
            source=loc)
    if op not in _UNARY_OPS:
        x.trace.fail(f"unknown elementwise op {op!r}; pick one of "
                     f"{_UNARY_OPS}", loc)
    return Ex(I.Unary(op, x.expr, alpha), x.trace)


def unary(op: str, x, alpha: float = 0.01) -> Ex:
    """Generic elementwise unary (``op`` may be a model parameter)."""
    return _unary(op, x, alpha, _user_loc())


def relu(x) -> Ex:
    return _unary("relu", x, 0.01, _user_loc())


def leaky_relu(x, alpha: float = 0.01) -> Ex:
    return _unary("leaky_relu", x, alpha, _user_loc())


def sigmoid(x) -> Ex:
    return _unary("sigmoid", x, 0.01, _user_loc())


def tanh(x) -> Ex:
    return _unary("tanh", x, 0.01, _user_loc())


def exp(x) -> Ex:
    return _unary("exp", x, 0.01, _user_loc())


def neg(x) -> Ex:
    return _unary("neg", x, 0.01, _user_loc())


def edge_softmax(score) -> _EdgeSoftmaxMarker:
    """Softmax over the edges sharing a destination (paper Listing 1);
    assign the result to an edge var: ``e["att"] = edge_softmax(...)``."""
    loc = _user_loc()
    if isinstance(score, Ex) and isinstance(score.expr, I.NodeVar):
        score.trace.fail(
            f"edge_softmax requires an edge var, but n[{score.expr.name}] "
            f"is a node var (produced by a for-each-node statement)", loc)
    if not isinstance(score, Ex):
        raise ProgramValidationError(
            "edge_softmax() needs a traced edge expression", source=loc)
    return _EdgeSoftmaxMarker(score)


def aggregate(msg, scale=None, reduce: str = "sum") -> _AggregateMarker:
    """Per-destination reduction of edge messages (optionally scaled by an
    edge scalar, e.g. attention); assign to a node var:
    ``n["h"] = aggregate(e["msg"], scale=e["att"])``."""
    loc = _user_loc()
    if reduce not in ("sum", "mean"):
        raise ProgramValidationError(
            f"aggregate: unknown reduce {reduce!r}; pick 'sum' or 'mean'",
            source=loc)
    for v, what in ((msg, "aggregate message"), (scale, "aggregate scale")):
        if isinstance(v, Ex) and isinstance(v.expr, I.NodeVar):
            v.trace.fail(
                f"{what} requires an edge var, but n[{v.expr.name}] is a "
                f"node var (produced by a for-each-node statement)", loc)
    if not isinstance(msg, Ex):
        raise ProgramValidationError(
            "aggregate() needs a traced edge expression", source=loc)
    return _AggregateMarker(msg, scale, reduce)


# ---------------------------------------------------------------------------
# the @model decorator
# ---------------------------------------------------------------------------
class ModelSpec:
    """A DSL-authored model: calling it traces the function into a
    validated ``ir.inter_op.Program`` (so a ``ModelSpec`` is a drop-in
    ``prog_fn`` for ``EngineConfig``/``RGNNEngine``/``hector.compile``)."""

    def __init__(self, fn):
        self.fn = fn
        self.name = fn.__name__
        functools.update_wrapper(self, fn)

    def trace(self, *args, **kwargs) -> I.Program:
        tr = _Trace(self.name)
        g, e, n = GraphProxy(tr), EdgeProxy(tr), NodeProxy(tr)
        ret = self.fn(g, e, n, *args, **kwargs)
        outputs = self._outputs_of(ret, tr)
        prog = I.Program(stmts=tr.stmts, outputs=outputs, name=self.name,
                         source=dict(tr.source))
        return validate_program(prog)

    __call__ = trace

    @staticmethod
    def _outputs_of(ret, tr: _Trace) -> List[str]:
        items = ret if isinstance(ret, (tuple, list)) else (ret,)
        names: List[str] = []
        for it in items:
            if isinstance(it, Ex) and isinstance(it.expr,
                                                 (I.NodeVar, I.EdgeVar)):
                names.append(it.expr.name)
            else:
                tr.fail("a model must return produced vars (n[...] or "
                        f"e[...] reads); got {type(it).__name__}", None)
        if not names:
            tr.fail("a model must return at least one produced var", None)
        return names

    @property
    def definition_loc(self) -> int:
        """Non-blank, non-comment source lines of the model definition
        (decorator line excluded) — the paper's §4.1 programming-effort
        metric, reported by ``benchmarks/loc_report.py``."""
        src = inspect.getsource(self.fn)
        return sum(1 for line in src.splitlines()
                   if line.strip() and not line.strip().startswith(("#", "@")))

    def __repr__(self) -> str:
        return f"ModelSpec<{self.name}>"


def model(fn) -> ModelSpec:
    """Decorator: a plain function over ``(g, e, n, *dims, **hparams)``
    proxies becomes a traceable Hector model."""
    return ModelSpec(fn)
