"""Executors of the port: the reference's compiled-executor surface, run
eagerly.

``repro.core.executor`` jits whole plans (and whole SGD steps) per argument
signature. PyTorch runs eagerly, so here every call executes
``codegen.execute_plan`` / ``execute_block_sequence`` op by op. The
signature-keyed counters stay, so the drivers report the same fields:
``trace_count`` / ``num_compiled`` count signatures seen for the first time,
``cache_hits`` the calls whose signature was seen before. Capturing one CUDA
graph per signature is the later step that makes those counters mean
compiled programs again. The obs metrics registry mirrors them as
``executor_traces`` / ``executor_cache_misses`` / ``executor_cache_hits``,
labelled ``executor=<class name>``, with the same meaning.

Every executor carries the autotuner's ``decisions`` table (or ``None``)
and passes it to codegen at every call; ``set_decisions`` swaps it. The
reference keys its compile cache on the table's fingerprint; running
eagerly, the port has no compiled entry a changed table could leave stale,
so a new table takes effect at the next call.

* ``PlanExecutor`` — one full-graph layer, in the caller's grad mode;
* ``BlockExecutor`` — the sampled forward, under ``torch.no_grad()``;
* ``BlockTrainExecutor`` / ``StackTrainExecutor`` — one SGD step each:
  forward, mean cross-entropy, ``backward()``, ``opt.update``, inside
  ``record_function`` ranges named ``forward`` / ``backward`` /
  ``optimizer`` (visible to ``torch.profiler``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch.profiler import record_function

from repro_torch import obs
from repro_torch.core import codegen


def signature(args) -> tuple:
    """Hashable key of a call: the structure of the arguments plus every
    tensor's shape and dtype (every static count rides along as itself)."""
    out = []

    def visit(x):
        if isinstance(x, torch.Tensor):
            out.append(("T", tuple(x.shape), str(x.dtype)))
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

    visit(args)
    return tuple(out)


class _SignatureCounter:
    """Counts first-seen and repeated argument signatures per executor, and
    holds the tuning decisions its calls run under."""

    def __init__(self, plans: Sequence, decisions=None):
        self._static_key = tuple(p.fingerprint() for p in plans)
        self._seen: set = set()
        self.cache_hits = 0
        self.trace_count = 0
        self.decisions = decisions

    def set_decisions(self, decisions) -> None:
        """Install a (new) tuning-decision table for the next calls."""
        self.decisions = decisions

    @property
    def num_compiled(self) -> int:
        return len(self._seen)

    def _count(self, args) -> None:
        """Count the call's signature, mirrored into the obs metrics
        registry (``executor_traces`` and ``executor_cache_misses`` for a
        new one, ``executor_cache_hits`` for a repeat; host-side only)."""
        key = (self._static_key, signature(args))
        name = type(self).__name__
        if key in self._seen:
            self.cache_hits += 1
            obs.metrics().counter("executor_cache_hits", executor=name).inc()
        else:
            self._seen.add(key)
            self.trace_count += 1
            obs.metrics().counter("executor_traces", executor=name).inc()
            obs.metrics().counter("executor_cache_misses",
                                  executor=name).inc()


class PlanExecutor(_SignatureCounter):
    """Full-graph forward of one lowered plan; runs in the caller's grad
    mode, so a train step can differentiate through it."""

    def __init__(self, plan, decisions=None):
        super().__init__([plan], decisions)
        self.plan = plan

    def __call__(self, params, gt, kl, feats) -> Dict[str, torch.Tensor]:
        self._count((params, gt, kl, feats))
        return codegen.execute_plan(self.plan, params, gt, feats, kl,
                                    self.decisions)


class BlockExecutor(_SignatureCounter):
    """Sampled-minibatch forward for a stack of per-hop plans."""

    def __init__(self, plans: Sequence, activation: str = "relu",
                 decisions=None):
        super().__init__(plans, decisions)
        self.plans = list(plans)
        self.activation = activation

    def __call__(self, params: Sequence[Dict[str, torch.Tensor]],
                 gts: List, kls: List, dst_locals: List,
                 seed_perm, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        self._count((list(params), list(gts), list(kls), list(dst_locals),
                     seed_perm, feats))
        with torch.no_grad():
            return codegen.execute_block_sequence(
                self.plans, list(params), list(gts), list(kls),
                list(dst_locals), seed_perm, feats,
                activation=self.activation, decisions=self.decisions)

    def run_minibatch(self, params, mb, global_feats) -> torch.Tensor:
        """Forward over a ``sampling.MiniBatch``: the input features are the
        rows of the device table ``global_feats`` at ``mb.input_ids``."""
        feats = {"feature": global_feats[mb.input_ids.long()]}
        return self(params, mb.tensors, mb.layouts, mb.dst_locals,
                    mb.seed_perm, feats)


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


class BlockTrainExecutor(_SignatureCounter):
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

    def grad_and_update(self, state, mb, labels, feats):
        """One optimizer step over a ``sampling.MiniBatch``. ``labels`` are
        aligned with the requested seed order (``seq.slice_labels``);
        ``feats`` is the batch's input-feature dict. Returns
        ``(new_state, {"loss", "accuracy"})``."""
        gts, kls = list(mb.tensors), list(mb.layouts)
        self._count((state.params, gts, kls, list(mb.dst_locals),
                     mb.seed_perm, labels, feats))

        def loss_fn(params):
            logits = codegen.execute_block_sequence(
                self.plans, params, gts, kls, list(mb.dst_locals),
                mb.seed_perm, feats, activation=self.activation,
                decisions=self.decisions)
            return softmax_xent(logits, labels)

        return _sgd_step(self.opt, state, loss_fn)


class StackTrainExecutor(_SignatureCounter):
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

    def grad_and_update(self, state, gt, kl, idx, labels, feats):
        """One full-graph optimizer step; the loss is taken over the
        ``idx`` node rows (the training split)."""
        self._count((state.params, gt, kl, idx, labels, feats))

        def loss_fn(params):
            h = self._forward(params, gt, kl, feats)
            return softmax_xent(h[idx.long()], labels)

        return _sgd_step(self.opt, state, loss_fn)

    def evaluate(self, params, gt, kl, idx, labels, feats):
        """Full-graph loss and accuracy on the ``idx`` rows, without
        gradients."""
        with torch.no_grad():
            h = self._forward(params, gt, kl, feats)
            loss, acc = softmax_xent(h[idx.long()], labels)
        return {"loss": loss, "accuracy": acc}
