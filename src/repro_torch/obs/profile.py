"""Per-op plan profiler: a Fig.-9-style kernel-time breakdown.

The port's counterpart of ``repro.obs.profile``, with the same rows,
labels, categories, hops, ``coverage`` and ``to_json()``. The paper's
headline evidence is a per-kernel time attribution (Fig. 9). This module
reproduces that view for any lowered plan by **prefix differencing**: the
prefix of ops ``0..i`` is timed on the tuner's measurement harness
(``tune.tuner.measure_group`` — a first call and warmup, then iterations
interleaved round-robin across every prefix so clock drift cancels out of
the differences, each call ended by a device synchronize on a card), the
prefix times are fitted isotonically, and op *i* is charged the fitted
``t(prefix_i) - t(prefix_{i-1})``.

Why prefixes and not isolated per-op timing: a prefix pays the same
dispatch, launches and memory traffic the whole plan pays up to that
point, so prefix differences telescope — their sum IS the whole-plan time
(up to measurement noise) — and the attribution is consistent with the
end-to-end number by construction. The reference also makes each jitted
prefix return its live frontier (the values later ops read), because XLA
would otherwise dead-code-eliminate the intermediates no output reads.
PyTorch runs every op of a prefix eagerly and eliminates nothing, so the
port drops that liveness bookkeeping (the reference's ``_frontiers``): a
prefix here simply runs its ops.

Every prefix runs under ``torch.no_grad()``, as the serving executor does.
``PlanProfile.backend`` holds the device type the plan ran on (``"cuda"``
or ``"cpu"``); on the CPU the kernels' plain versions run.

Entry points:

* ``profile_plan``           — one lowered plan on one graph
* ``profile_block_sequence`` — a sampled mini-batch through all hops (the
  serving hot path; what ``CompiledRGNN.profile(...)`` and
  ``launch/serve_rgnn.py --profile`` render)
* ``profile_minibatch``      — convenience entry over an engine + MiniBatch
* ``profile_train_step``     — forward / backward / optimizer attribution
  of the sampled SGD step (``launch/train_rgnn.py --profile``)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from repro_torch.core import codegen
from repro_torch.core.ir import intra_op as O
from repro_torch.feats import gather_input, is_feature_store
from repro_torch.tune.tuner import measure_group


def _op_label(op) -> str:
    if isinstance(op, O.GemmSpec):
        return f"gemm:{op.out}[{op.gather.name.lower()}]"
    if isinstance(op, O.TraversalSpec):
        kinds = {s.kind for s in op.stmts}
        tag = "softmax" if "segment_max" in kinds else \
            "agg" if "segment_sum" in kinds else "ew"
        return f"traversal:{op.stmts[-1].out}[{tag}]"
    if isinstance(op, O.WeightProductSpec):
        return f"wprod:{op.out}"
    return type(op).__name__


def _op_category(op) -> str:
    if isinstance(op, O.GemmSpec):
        return "gemm"
    if isinstance(op, O.TraversalSpec):
        return "traversal"
    if isinstance(op, O.WeightProductSpec):
        return "wprod"
    return "other"


@dataclasses.dataclass
class OpTime:
    """One attributed op instance. ``seconds`` is the fitted prefix
    difference (clamped at 0); ``prefix_seconds`` the measured time of the
    plan up to and including this op."""

    index: int
    category: str         # gemm | traversal | wprod | glue
    label: str
    seconds: float
    prefix_seconds: float
    hop: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PlanProfile:
    """Per-op breakdown of one plan (or a block sequence of plans — then
    ``ops`` carries entries from every hop, tagged by ``hop``)."""

    ops: List[OpTime]
    total_seconds: float          # whole plan/sequence, same harness
    backend: str                  # the device type: "cuda" or "cpu"

    @property
    def sum_op_seconds(self) -> float:
        return sum(o.seconds for o in self.ops)

    @property
    def coverage(self) -> float:
        """sum(per-op) / whole-plan. Telescoping makes this ~1.0; drift
        beyond noise means the attribution disagrees with the end-to-end
        measurement."""
        return self.sum_op_seconds / self.total_seconds \
            if self.total_seconds > 0 else float("nan")

    def by_category(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self.ops:
            out[o.category] = out.get(o.category, 0.0) + o.seconds
        return out

    def table(self) -> str:
        """The Fig.-9-style breakdown: one row per op instance, fraction
        of the attributed total, then category subtotals and the coverage
        ratio against the whole-plan measurement."""
        tot = max(self.sum_op_seconds, 1e-12)
        lines = [f"{'op':<40} {'hop':>3} {'time us':>10} {'frac':>6}"]
        for o in self.ops:
            lines.append(f"{o.label:<40} {o.hop:>3} "
                         f"{o.seconds * 1e6:>10.1f} "
                         f"{o.seconds / tot:>6.1%}")
        lines.append("-" * 62)
        for cat, t in sorted(self.by_category().items(),
                             key=lambda kv: -kv[1]):
            lines.append(f"{cat:<44} {t * 1e6:>10.1f} {t / tot:>6.1%}")
        lines.append(
            f"{'sum(ops)':<44} {self.sum_op_seconds * 1e6:>10.1f}")
        lines.append(
            f"{'whole plan':<44} {self.total_seconds * 1e6:>10.1f}   "
            f"(coverage {self.coverage:.0%})")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "backend": self.backend,
            "total_us": self.total_seconds * 1e6,
            "sum_op_us": self.sum_op_seconds * 1e6,
            "coverage": self.coverage,
            "by_category_us": {k: v * 1e6
                               for k, v in self.by_category().items()},
            "ops": [o.to_json() for o in self.ops],
        }


def _isotonic(xs: Sequence[float]) -> List[float]:
    """Monotone non-decreasing fit (pool adjacent violators). True prefix
    times are non-decreasing by construction; a measured dip is noise.
    Clamping each negative difference at 0 would one-sidedly inflate the
    sum — pooling averages the dip with its neighbours instead, so the
    fitted differences still telescope to (roughly) the final prefix."""
    pools: List[List[float]] = []   # [sum, count]
    for x in xs:
        cur = [float(x), 1]
        while pools and pools[-1][0] * cur[1] > cur[0] * pools[-1][1]:
            prev = pools.pop()
            cur = [prev[0] + cur[0], prev[1] + cur[1]]
        pools.append(cur)
    out: List[float] = []
    for s, c in pools:
        out.extend([s / c] * c)
    return out


def _no_grad(fn):
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def _attribute(steps, times, fit, row) -> List[OpTime]:
    """One ``OpTime`` per step from the measured and fitted prefix times;
    ``row(step)`` gives the step's (index, category, label, hop)."""
    ops: List[OpTime] = []
    prev = 0.0
    for step, t, ft in zip(steps, times, fit):
        idx, cat, label, hop = row(step)
        ops.append(OpTime(index=idx, category=cat, label=label,
                          seconds=max(ft - prev, 0.0), prefix_seconds=t,
                          hop=hop))
        prev = ft
    return ops


# ---------------------------------------------------------------------------
# single-plan profiling
# ---------------------------------------------------------------------------
def profile_plan(plan, params, gt, kl, feats, *, decisions=None,
                 warmup: int = 1, iters: int = 3) -> PlanProfile:
    """Per-op breakdown of one lowered plan on one graph, on the device of
    ``gt``."""
    device = gt.device

    def prefix_fn(upto):
        def run(params_, gt_, kl_, feats_):
            env = codegen._Env(plan, gt_, params_, feats_)
            derived: Dict[str, torch.Tensor] = {}
            for op in plan.ops[:upto + 1]:
                codegen.execute_op(op, env, derived, gt_, kl_, decisions)
        return run

    args = (params, gt, kl, feats)
    n = len(plan.ops)
    calls = [(_no_grad(prefix_fn(i)), args) for i in range(n)]
    calls.append((_no_grad(lambda p, g, k, f: codegen.execute_plan(
        plan, p, g, f, k, decisions)), args))
    times = measure_group(calls, device=device, warmup=warmup, iters=iters)
    whole = times.pop()
    ops = _attribute(
        range(n), times, _isotonic(times),
        lambda i: (i, _op_category(plan.ops[i]), _op_label(plan.ops[i]), 0))
    return PlanProfile(ops=ops, total_seconds=whole,
                       backend=torch.device(device).type)


# ---------------------------------------------------------------------------
# sampled block sequence (the serving hot path)
# ---------------------------------------------------------------------------
def profile_block_sequence(plans: Sequence, params: Sequence, gts, kls,
                           dst_locals, seed_perm, feats, *,
                           activation: str = "relu", decisions=None,
                           warmup: int = 1, iters: int = 3) -> PlanProfile:
    """Per-op breakdown of one sampled mini-batch through every hop's
    block — the computation ``BlockExecutor`` runs, attributed op instance
    by op instance via prefix differencing. The inter-hop frontier
    narrowing + activation and the final seed gather appear as ``glue``
    rows."""
    act = codegen._ACTIVATIONS[activation]
    last = len(plans) - 1
    device = gts[0].device

    # step list: every (hop, op) plus one glue step per hop
    steps = []   # (hop, op_index | None for the hop's glue)
    for i, plan in enumerate(plans):
        steps += [(i, j) for j in range(len(plan.ops))]
        steps.append((i, None))

    def prefix_fn(upto):
        cut_hop, cut_op = steps[upto]

        def run(params_, gts_, kls_, dst_locals_, seed_perm_, feats_):
            cur_ = dict(feats_)
            for i in range(cut_hop + 1):
                plan = plans[i]
                env = codegen._Env(plan, gts_[i], params_[i], cur_)
                derived: Dict[str, torch.Tensor] = {}
                n_ops = (len(plan.ops) if i < cut_hop or cut_op is None
                         else cut_op + 1)
                for op in plan.ops[:n_ops]:
                    codegen.execute_op(op, env, derived, gts_[i], kls_[i],
                                       decisions)
                if i == cut_hop and cut_op is not None:
                    return
                h = env.get(plan.outputs[0])[dst_locals_[i].long()]
                if i == last:
                    return h[seed_perm_.long()]
                cur_ = {"feature": act(h)}
            return cur_["feature"]
        return run

    args = (list(params), list(gts), list(kls), list(dst_locals),
            seed_perm, feats)
    calls = [(_no_grad(prefix_fn(s)), args) for s in range(len(steps))]
    calls.append((_no_grad(
        lambda p, g, k, d, s_, f: codegen.execute_block_sequence(
            plans, p, g, k, d, s_, f, activation=activation,
            decisions=decisions)), args))
    times = measure_group(calls, device=device, warmup=warmup, iters=iters)
    whole = times.pop()

    def row(step):
        hop, op_idx = step
        if op_idx is None:
            label = ("glue:narrow+seed_gather" if hop == last
                     else f"glue:narrow+{activation}")
            return len(plans[hop].ops), "glue", label, hop
        op = plans[hop].ops[op_idx]
        return op_idx, _op_category(op), _op_label(op), hop

    ops = _attribute(steps, times, _isotonic(times), row)
    return PlanProfile(ops=ops, total_seconds=whole,
                       backend=torch.device(device).type)


def profile_minibatch(engine, params, mb, global_feats, *,
                      warmup: int = 1, iters: int = 3) -> PlanProfile:
    """Convenience entry over an ``RGNNEngine``/``CompiledRGNN`` and a
    ``sampling.MiniBatch``. The input features: the loader-attached
    ``mb.feats``, else ``global_feats``, a feature store (read without
    changing its state) or the [N, dim] table (a tensor or a numpy array,
    moved to the engine's device)."""
    if getattr(mb, "feats", None) is None \
            and not is_feature_store(global_feats):
        global_feats = torch.as_tensor(global_feats).to(engine.device)
    feats = gather_input(global_feats, mb, read_only=True)
    return profile_block_sequence(
        engine.plans, list(params), list(mb.tensors), list(mb.layouts),
        list(mb.dst_locals), mb.seed_perm, feats,
        activation=engine.cfg.activation, decisions=engine.decisions,
        warmup=warmup, iters=iters)


# ---------------------------------------------------------------------------
# train-step phase attribution
# ---------------------------------------------------------------------------
def profile_train_step(plans: Sequence, opt, state, mb, labels, feats, *,
                       activation: str = "relu", decisions=None,
                       warmup: int = 1, iters: int = 3) -> Dict[str, float]:
    """Forward / backward / optimizer attribution for the sampled SGD step.
    Three nested computations are timed with the same harness and
    differenced:

        forward   = t(forward, under grad mode)
        backward  = t(forward + loss + backward()) - forward
        optimizer = t(full step)                   - t(forward + backward)

    The full step is ``BlockTrainExecutor.grad_and_update``'s body
    (``executor._sgd_step`` over the same loss), without its signature
    count, so no executor counter moves; ``AdamW.update`` is functional,
    so ``state`` is never changed. Returns seconds per phase plus
    ``total``, the full step's time.
    """
    from repro_torch.core.executor import _sgd_step, softmax_xent

    gts, kls = list(mb.tensors), list(mb.layouts)
    dst_locals, seed_perm = list(mb.dst_locals), mb.seed_perm
    device = gts[0].device
    labels = torch.as_tensor(labels).to(device)

    def forward(params, f):
        return codegen.execute_block_sequence(
            plans, params, gts, kls, dst_locals, seed_perm, f,
            activation=activation, decisions=decisions)

    def leaves(params):
        return [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                for p in params]

    def fwd(params, f):
        with torch.enable_grad():
            return forward(leaves(params), f)

    def grad_fn(params, f):
        with torch.enable_grad():
            loss, _ = softmax_xent(forward(leaves(params), f), labels)
            loss.backward()
        return loss

    def step_fn(state_, f):
        return _sgd_step(opt, state_,
                         lambda p: softmax_xent(forward(p, f), labels))

    t_fwd, t_grad, t_step = measure_group(
        [(fwd, (state.params, feats)),
         (grad_fn, (state.params, feats)),
         (step_fn, (state, feats))],
        device=device, warmup=warmup, iters=iters)
    return {
        "forward": t_fwd,
        "backward": max(t_grad - t_fwd, 0.0),
        "optimizer": max(t_step - t_grad, 0.0),
        "total": t_step,
    }
