"""Executors of the port: one CUDA graph per bucketed shape signature.

The counterpart of ``repro.core.executor``'s jit cache. Every executor
keys a call on the plans' fingerprints, the tuning decisions' fingerprint
and the call's signature — the structure of the arguments, every tensor's
shape and dtype and every static field (``signature``); no value computed
from a batch's contents is part of it. Bucketed mini-batches therefore
share a small set of keys.

On a CUDA card with ``compiled=True`` (the default) the first call of a
key runs op by op. Its second call captures the same function into a
``torch.cuda.CUDAGraph`` over static input buffers and replays it for its
result; every later call copies its tensors into those buffers (skipping a
tensor that already is its buffer) and replays. A key seen once never pays
a capture. Tensors the caller owns for the executor's lifetime (the
engine's full-graph tensors, layouts, features, split and labels) are
captured in place, not copied: their addresses join the graph's key.
``compiled=False`` runs op by op every time
(``codegen.execute_plan`` / ``execute_block_sequence``), the reference's
``compiled=False``; so does every call on the CPU, where nothing is
captured.

Capture is safe by construction, not by timing:

* it runs in ``capture_error_mode="thread_local"``, so another thread's
  allocations and copies (the host loader's producer allocates device and
  pinned memory and copies without blocking the whole time) cannot
  invalidate it;
* it is ``torch.cuda.graph``'s capture (a synchronize, then
  ``CUDAGraph.capture_begin`` / ``capture_end`` on a side stream) without
  its ``empty_cache()`` and pinned host-cache release: those would hand
  the caching allocators' memory back to the driver at every capture, and
  every later op-by-op call and the loader's staging would allocate it
  again;
* the cyclic collector stays disabled while any capture runs: an
  unreachable ``CUDAGraph`` freed mid-capture would reset inside the
  capture. Captures are serialized across the process by one lock (the
  serving runtime's tenants capture on their own execute threads), and
  the collector is turned back on only by the last capture to finish, if
  it was on before the first began (``_collector_off``);
* an executor captures on one thread only (the consumer's; the loader
  never runs a model);
* the executor holds every graph with its static inputs, outputs and
  scratch for its own lifetime (no eviction, as the reference's cache has
  none), and K5's counter buffers are never freed
  (``segment_mm._outer_counters``);
* the captured code has no host synchronize, ``.item()`` or
  data-dependent shape (plans, kernels and AdamW only enqueue device work).

A failed capture or replay raises; nothing falls back to the op-by-op
path. ``capturing()`` is true while a capture (its synchronize included)
is under way.

Counters, as the reference's: ``trace_count`` / ``cache_misses`` /
``num_compiled`` count keys seen for the first time, ``cache_hits`` the
calls whose key was seen before, on both devices. On the card
``captures`` counts the graphs and ``replays`` the calls they served
(every hit). The obs registry mirrors the first three as
``executor_traces`` / ``executor_cache_misses`` / ``executor_cache_hits``,
labelled ``executor=<class name>``. A kernel wrapper counts the launches
it makes, op by op or into a graph being captured; a replay runs the
graph's kernels without calling the wrappers, so ``ops.launch_counts()``
does not see them (``torch.profiler`` does).

Outputs of a replay live in the graph's buffers: the serving forward
returns a copy of the logits; a train step returns the new state *in its
static state buffers* (the reference's donated state), valid until the
executor's next call — callers copy what they keep — and copies of the
metrics.

* ``PlanExecutor`` — one full-graph layer, in the caller's grad mode
  (captured only without grad);
* ``BlockExecutor`` — the sampled forward, under ``torch.no_grad()``;
* ``BlockTrainExecutor`` / ``StackTrainExecutor`` — one SGD step each:
  forward, mean cross-entropy, ``backward()``, ``opt.update``, inside
  ``record_function`` ranges named ``forward`` / ``backward`` /
  ``optimizer`` (visible to ``torch.profiler``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
from typing import Dict, List, Sequence

import torch
from torch.profiler import record_function

from repro_torch import obs
from repro_torch.core import codegen
from repro_torch.feats import gather_input
from repro_torch.optim.adamw import tree_leaves

_capturing = 0
_collector_was_on = False
_capture_lock = threading.Lock()     # one capture at a time in the process
_count_lock = threading.Lock()       # guards the two globals above
_streams: Dict[torch.device, torch.cuda.Stream] = {}


def capturing() -> bool:
    """True while an executor captures a graph (setup included)."""
    return _capturing > 0


@contextlib.contextmanager
def _collector_off():
    """The cyclic collector off while any capture runs: the first capture
    to begin turns it off (remembering whether it was on), and only the
    last to finish turns it back on."""
    global _capturing, _collector_was_on
    with _count_lock:
        if _capturing == 0:
            _collector_was_on = gc.isenabled()
            gc.disable()
        _capturing += 1
    try:
        yield
    finally:
        with _count_lock:
            _capturing -= 1
            if _capturing == 0 and _collector_was_on:
                gc.enable()


def _capture_stream(dev) -> torch.cuda.Stream:
    """The side stream captures on ``dev`` run on (the legacy default
    stream cannot capture)."""
    if dev not in _streams:
        _streams[dev] = torch.cuda.Stream(device=dev)
    return _streams[dev]


def _flatten(args, ends=None):
    """``(signature, tensors)``: the hashable key of a call — the structure
    of the arguments plus every tensor's shape and dtype (every static
    count rides along as itself) — and its tensors in visiting order.
    With ``ends``, a list, ``args`` is a tuple and the tensor count after
    each of its items is appended to ``ends``."""
    out, tensors = [], []

    def visit(x):
        if isinstance(x, torch.Tensor):
            out.append(("T", tuple(x.shape), str(x.dtype)))
            tensors.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                out.append(("K", k))
                visit(x[k])
        elif isinstance(x, (list, tuple)):
            out.append(("L", len(x)))
            for v in x:
                visit(v)
        elif hasattr(x, "__dataclass_fields__"):
            out.append(("D", type(x).__name__))
            for f in x.__dataclass_fields__:
                visit(getattr(x, f))
        else:
            out.append(("V", x))

    if ends is None:
        visit(args)
    else:
        out.append(("L", len(args)))
        for a in args:
            visit(a)
            ends.append(len(tensors))
    return tuple(out), tensors


def signature(args) -> tuple:
    """Hashable key of a call (``_flatten``'s first half)."""
    return _flatten(args)[0]


def _rebuild(x, it):
    """``x`` with its tensors replaced, in ``_flatten``'s order, by
    ``it``'s."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if isinstance(x, dict):
        vals = {k: _rebuild(x[k], it) for k in sorted(x)}
        return {k: vals[k] for k in x}
    if isinstance(x, (list, tuple)):
        return type(x)(_rebuild(v, it) for v in x)
    if hasattr(x, "__dataclass_fields__"):
        return dataclasses.replace(x, **{
            f: _rebuild(getattr(x, f), it) for f in x.__dataclass_fields__})
    return x


@dataclasses.dataclass
class _Graph:
    """One captured call: the graph, its static inputs (in ``_flatten``
    order; an owned tensor is the caller's own) and outputs."""
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    outputs: object


class _Executor:
    """Keys calls, counts them, and captures / replays one CUDA graph per
    key; holds the tuning decisions its calls run under."""

    def __init__(self, plans: Sequence, decisions=None):
        self._static_key = tuple(p.fingerprint() for p in plans)
        self._seen: set = set()
        self._graphs: Dict[tuple, _Graph] = {}
        self._ran_once: set = set()
        self._capture_thread = None
        self.cache_hits = 0
        self.cache_misses = 0
        self.trace_count = 0
        self.captures = 0
        self.replays = 0
        self.decisions = decisions

    def set_decisions(self, decisions) -> None:
        """Install a (new) tuning-decision table: its fingerprint joins the
        key, so the next calls make new entries."""
        self.decisions = decisions

    @property
    def num_compiled(self) -> int:
        return len(self._seen)

    def cache_stats(self) -> Dict[str, int]:
        return {"compile_cache_hits": self.cache_hits,
                "compile_cache_misses": self.cache_misses,
                "trace_count": self.trace_count,
                "num_compiled": self.num_compiled,
                "captures": self.captures, "replays": self.replays}

    def _count(self, key) -> None:
        """Count the call's key, mirrored into the obs metrics registry
        (``executor_traces`` and ``executor_cache_misses`` for a new one,
        ``executor_cache_hits`` for a repeat; host-side only)."""
        name = type(self).__name__
        if key in self._seen:
            self.cache_hits += 1
            obs.metrics().counter("executor_cache_hits", executor=name).inc()
        else:
            self._seen.add(key)
            self.cache_misses += 1
            self.trace_count += 1
            obs.metrics().counter("executor_traces", executor=name).inc()
            obs.metrics().counter("executor_cache_misses",
                                  executor=name).inc()

    def _run(self, eager, captured, args, compiled: bool, finish,
             owned=()):
        """Count the call's key, then run ``eager(*args)``; on a card, the
        second call of a key captures ``captured`` (the same computation,
        written for static buffers) and every call from then on replays
        it, returning ``finish(graph outputs)``. ``owned`` are the
        positions in ``args`` of the caller's tensors that live as long
        as the executor: captured in place, never copied into."""
        ends = []
        sig, tensors = _flatten(args, ends)
        fp = self.decisions.fingerprint() if self.decisions is not None \
            else None
        key = (self._static_key, fp, sig)
        self._count(key)
        if not compiled or not tensors or not self._capturable(tensors):
            return eager(*args)
        own = [j for i in owned
               for j in range(ends[i - 1] if i else 0, ends[i])]
        gkey = (key, tuple(tensors[j].data_ptr() for j in own))
        entry = self._graphs.get(gkey)
        if entry is None:
            if gkey not in self._ran_once:
                self._ran_once.add(gkey)
                return eager(*args)
            entry = self._graphs[gkey] = self._capture(
                captured, args, tensors, set(own))
        return finish(self._replay(entry, tensors))

    @staticmethod
    def _capturable(tensors) -> bool:
        return tensors[0].device.type == "cuda"

    def _capture(self, fn, args, tensors, own) -> _Graph:
        me = threading.get_ident()
        if self._capture_thread is None:
            self._capture_thread = me
        elif self._capture_thread != me:
            raise RuntimeError(f"{type(self).__name__}: captures of one "
                               f"executor run on one thread")
        dev = tensors[0].device
        for t in tensors:
            if t.device != dev:
                raise ValueError(f"{type(self).__name__}: a captured call "
                                 f"takes tensors on {dev} only, got one on "
                                 f"{t.device}")
        # the replay that follows fills the buffers
        inputs = [t if j in own else torch.empty_like(t)
                  for j, t in enumerate(tensors)]
        static_args = _rebuild(args, iter(inputs))
        graph = torch.cuda.CUDAGraph()
        with _capture_lock, _collector_off(), torch.cuda.device(dev):
            torch.cuda.synchronize()
            with torch.cuda.stream(_capture_stream(dev)):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outputs = fn(*static_args)
                finally:
                    graph.capture_end()
        self.captures += 1
        return _Graph(graph, inputs, outputs)

    def _replay(self, entry: _Graph, tensors):
        dst, src = [], []
        for d, s in zip(entry.inputs, tensors):
            if d.data_ptr() != s.data_ptr():
                dst.append(d)
                src.append(s)
        if dst:
            torch._foreach_copy_(dst, src)
        entry.graph.replay()
        self.replays += 1
        return entry.outputs


class PlanExecutor(_Executor):
    """Full-graph forward of one lowered plan; runs in the caller's grad
    mode, so a train step can differentiate through it (with grad enabled
    it runs op by op: a captured forward could not be differentiated).
    ``gt`` and ``kl`` are the engine's, captured in place."""

    def __init__(self, plan, decisions=None):
        super().__init__([plan], decisions)
        self.plan = plan

    def _forward(self, params, gt, kl, feats):
        return codegen.execute_plan(self.plan, params, gt, feats, kl,
                                    self.decisions)

    def __call__(self, params, gt, kl, feats,
                 compiled: bool = True) -> Dict[str, torch.Tensor]:
        return self._run(self._forward, self._forward,
                         (params, gt, kl, feats),
                         compiled and not torch.is_grad_enabled(),
                         lambda out: {k: v.clone() for k, v in out.items()},
                         owned=(1, 2))


class BlockExecutor(_Executor):
    """Sampled-minibatch forward for a stack of per-hop plans."""

    def __init__(self, plans: Sequence, activation: str = "relu",
                 decisions=None):
        super().__init__(plans, decisions)
        self.plans = list(plans)
        self.activation = activation

    def _forward(self, params, gts, kls, dst_locals, seed_perm, feats):
        with torch.no_grad():
            return codegen.execute_block_sequence(
                self.plans, params, gts, kls, dst_locals, seed_perm, feats,
                activation=self.activation, decisions=self.decisions)

    def __call__(self, params: Sequence[Dict[str, torch.Tensor]],
                 gts: List, kls: List, dst_locals: List,
                 seed_perm, feats: Dict[str, torch.Tensor],
                 compiled: bool = True) -> torch.Tensor:
        return self._run(self._forward, self._forward,
                         (list(params), list(gts), list(kls),
                          list(dst_locals), seed_perm, feats),
                         compiled, torch.clone)

    def run_minibatch(self, params, mb, global_feats=None, *, feats=None,
                      compiled: bool = True) -> torch.Tensor:
        """Forward over a ``sampling.MiniBatch``. Input features, as the
        reference's: an explicit ``feats`` dict, then the loader-attached
        ``mb.feats``, then the rows of the device table ``global_feats``
        at ``mb.input_ids``."""
        if feats is None:
            feats = gather_input(global_feats, mb)
        return self(params, mb.tensors, mb.layouts, mb.dst_locals,
                    mb.seed_perm, feats, compiled=compiled)


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy and accuracy over [rows, classes] logits and int
    labels; the per-seed training objective (one row per seed/node)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels.long())
                     .to(torch.float32))
    return torch.mean(nll), acc


def _sgd_step(opt, state, loss_fn):
    """forward -> mean cross-entropy -> backward() -> ``opt.update``. The
    state's params are not touched: the step differentiates fresh leaves
    that share their storage."""
    params = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
              for p in state.params]
    with torch.enable_grad():
        with record_function("forward"):
            loss, acc = loss_fn(params)
        with record_function("backward"):
            loss.backward()
    with record_function("optimizer"):
        grads = [{k: (v.grad if v.grad is not None else torch.zeros_like(v))
                  for k, v in p.items()} for p in params]
        new_state = opt.update(grads, state)
    return new_state, {"loss": loss.detach(), "accuracy": acc}


class _TrainExecutor(_Executor):
    """A captured SGD step writes the new state into its static state
    buffers (the update is applied once per call, as op by op) and returns
    them: the reference's donated state."""

    def _step(self, state, *rest):
        raise NotImplementedError

    def _step_in_place(self, state, *rest):
        new_state, metrics = self._step(state, *rest)
        with torch.no_grad():
            for d, s in zip(tree_leaves(state), tree_leaves(new_state)):
                d.copy_(s)
        return state, metrics

    def _train(self, args, compiled: bool, owned=()):
        return self._run(
            self._step, self._step_in_place, args, compiled,
            lambda out: (out[0], {k: v.clone() for k, v in out[1].items()}),
            owned)


class BlockTrainExecutor(_TrainExecutor):
    """Neighbor-sampled SGD step over a stack of per-hop plans: the block
    sequence forward (every hop's kernels), per-seed cross-entropy on the
    gathered seed rows, the backward through the kernels' autograd
    Functions, and the optimizer update."""

    def __init__(self, plans: Sequence, opt, activation: str = "relu",
                 decisions=None):
        super().__init__(plans, decisions)
        self.plans = list(plans)
        self.opt = opt
        self.activation = activation

    def _step(self, state, gts, kls, dst_locals, seed_perm, labels, feats):
        def loss_fn(params):
            logits = codegen.execute_block_sequence(
                self.plans, params, gts, kls, dst_locals, seed_perm, feats,
                activation=self.activation, decisions=self.decisions)
            return softmax_xent(logits, labels)

        return _sgd_step(self.opt, state, loss_fn)

    def grad_and_update(self, state, mb, labels, feats,
                        compiled: bool = True):
        """One optimizer step over a ``sampling.MiniBatch``. ``labels`` are
        aligned with the requested seed order (``seq.slice_labels``);
        ``feats`` is the batch's input-feature dict. Returns
        ``(new_state, {"loss", "accuracy"})``."""
        return self._train((state, list(mb.tensors), list(mb.layouts),
                            list(mb.dst_locals), mb.seed_perm, labels,
                            feats), compiled)


class StackTrainExecutor(_TrainExecutor):
    """Full-graph SGD step over a multi-layer stack: layer-by-layer forward
    over the shared graph tensors/layouts, cross-entropy on the ``idx``
    node rows, backward and optimizer update. The parity baseline of the
    sampled trainer (a full-fanout sampled step reproduces its loss and
    gradients) and the full-graph evaluator."""

    def __init__(self, plans: Sequence, opt, activation: str = "relu",
                 decisions=None):
        super().__init__(plans, decisions)
        self.plans = list(plans)
        self.opt = opt
        self.activation = activation

    def _forward(self, params, gt, kl, feats):
        act = codegen._ACTIVATIONS[self.activation]
        cur = dict(feats)
        h = None
        last = len(self.plans) - 1
        for i, (plan, p) in enumerate(zip(self.plans, params)):
            h = codegen.execute_plan(plan, p, gt, cur, kl,
                                     self.decisions)[plan.outputs[0]]
            if i < last:
                cur = {"feature": act(h)}
        return h

    def _step(self, state, gt, kl, idx, labels, feats):
        def loss_fn(params):
            h = self._forward(params, gt, kl, feats)
            return softmax_xent(h[idx.long()], labels)

        return _sgd_step(self.opt, state, loss_fn)

    def grad_and_update(self, state, gt, kl, idx, labels, feats,
                        compiled: bool = True):
        """One full-graph optimizer step; the loss is taken over the
        ``idx`` node rows (the training split). Every argument but the
        state must live as long as the executor: a captured step reads
        them in place."""
        return self._train((state, gt, kl, idx, labels, feats), compiled,
                           owned=(1, 2, 3, 4, 5))

    def evaluate(self, params, gt, kl, idx, labels, feats):
        """Full-graph loss and accuracy on the ``idx`` rows, without
        gradients (op by op; not counted)."""
        with torch.no_grad():
            h = self._forward(params, gt, kl, feats)
            loss, acc = softmax_xent(h[idx.long()], labels)
        return {"loss": loss, "accuracy": acc}
