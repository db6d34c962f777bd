"""Multi-shard executors over the data group: the port's
``repro.dist.executor``.

Each rank runs its ``L = P / dp`` shards (``launch.mesh.DataGroup``), one
after the other, through ``codegen``'s block sequence, the path the plain
``BlockExecutor`` runs (so every shard launches the same hand-written
kernels); the Python loop stands in for the reference's ``lax.map``.

* **halo features** — each rank holds its shards' resident feature slabs
  ``[L, n_own, d]``; the step opens with one ``all_gather`` over the
  group, giving every rank the full ``[P, n_own, d]`` table from which
  each shard reads its hop-0 input rows (owned + halo) as
  ``full[owner_rows, local_rows]``.

* **gradient sum** — each shard's *partial* loss is ``sum(nll * mask) /
  B_total`` (the partials sum to the global mean loss), and its gradients
  come from ``torch.autograd.grad`` on that loss alone. The rank flattens
  its shards' gradients into one ``[L, n_params]`` buffer, all-gathers it
  to ``[P, n_params]`` in shard order and sums over dim 0. That is the
  determinism-safe spelling of an all-reduce: the gathered operands and
  the reduction depend only on ``P``, not on ``dp``, so dp=1 and dp=N give
  bit-identical gradients, and the port's AdamW step then gives
  bit-identical states.

* **request-order outputs** — per-slot nll / logits are gathered to
  ``[P * b_max, ...]`` and indexed by the batcher's ``route``: the loss is
  ``mean(nll[route])``, the same values in the same order as the plain
  step's.

At ``dp = 1`` on a card the whole step is captured as the plain executors
capture it (``core.executor``: a key's first call runs op by op, its
second captures, later calls replay; thread-local capture, the capture
lock, the collector off, the train state written back into its static
buffers). At ``dp > 1`` every call runs op by op: the collectives are
outside any graph. ``trace_count`` / ``cache_hits`` / ``num_compiled``
count keys as the reference's do (a key's first sight is a "trace").
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import codegen
from repro_torch.core.executor import _Executor, _TrainExecutor
from repro_torch.optim.adamw import tree_leaves, tree_like


class _ShardedExecutor(_Executor):
    """Shared plumbing: plans + data group + the per-shard forward."""

    def __init__(self, plans: Sequence, group, activation: str = "relu",
                 decisions=None, tag: str = ""):
        super().__init__(plans, decisions)
        self._static_key = (tag, group.key) + self._static_key
        self.plans = list(plans)
        self.group = group
        self.activation = activation

    def _check(self, smb) -> None:
        want = self.group.shards(smb.num_shards)
        if tuple(smb.shards) != want:
            raise ValueError(f"rank {self.group.rank} runs shards {want}; "
                             f"the batch holds {tuple(smb.shards)}")

    def _forward_one(self, params, full_feats, sh):
        """One shard's block forward from the gathered feature table."""
        x = full_feats[sh.owner_rows.long(), sh.local_rows.long()]
        return codegen.execute_block_sequence(
            self.plans, params, sh.tensors, sh.layouts, sh.dst_locals,
            sh.seed_perm, {"feature": x}, activation=self.activation,
            decisions=self.decisions)

    @property
    def _compiled(self) -> bool:
        return self.group.dp == 1


class ShardedServeExecutor(_ShardedExecutor):
    """Multi-shard inference: ``[B, C]`` seed logits in request order.
    Feature slabs are persistent (captured in place, never copied)."""

    def __init__(self, plans: Sequence, group, activation: str = "relu",
                 decisions=None):
        super().__init__(plans, group, activation, decisions, tag="serve")

    def _forward(self, params, own_feats, blocks, route):
        with torch.no_grad():
            full = self.group.all_gather(own_feats)
            logits_l = torch.stack([self._forward_one(params, full, sh)
                                    for sh in blocks])
            logits = self.group.all_gather(logits_l)
            num_parts, b_max = logits.shape[0], logits.shape[1]
            return logits.reshape(num_parts * b_max, -1)[route.long()]

    def run_minibatch(self, params, smb, own_feats,
                      compiled: bool = True) -> torch.Tensor:
        """Logits for ``smb.seeds`` (request order) from this rank's
        feature slabs ``own_feats [L, n_own, d]``."""
        self._check(smb)
        return self._run(self._forward, self._forward,
                         (list(params), own_feats, list(smb.blocks),
                          smb.route),
                         compiled and self._compiled, torch.clone,
                         owned=(1,))


class ShardedTrainExecutor(_ShardedExecutor, _TrainExecutor):
    """Multi-shard SGD step: per-shard partial backward, the gradient sum
    over the gathered ``[P, n_params]`` buffer, the optimizer update and
    request-order loss / accuracy."""

    def __init__(self, plans: Sequence, opt, group,
                 activation: str = "relu", decisions=None):
        super().__init__(plans, group, activation, decisions, tag="train")
        self.opt = opt

    def _step(self, state, own_feats, blocks, labels, mask, route, inv_b):
        group = self.group
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(state.params)]
        params = tree_like(state.params, leaves)
        lo = group.rank * len(blocks)
        full = group.all_gather(own_feats)
        g_l, nll_l, logits_l = [], [], []
        with torch.enable_grad():
            for i, sh in enumerate(blocks):
                logits = self._forward_one(params, full, sh)
                logp = torch.log_softmax(logits, dim=-1)
                nll = -torch.gather(logp, 1,
                                    labels[lo + i].long()[:, None])[:, 0]
                loss = torch.sum(nll * mask[lo + i]) * inv_b
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                g_l.append(torch.cat([
                    (g if g is not None else torch.zeros_like(p)).reshape(-1)
                    for g, p in zip(grads, leaves)]))
                nll_l.append(nll.detach())
                logits_l.append(logits.detach())
        # the operands and the reduction depend on P only, never on dp
        g_sum = torch.sum(group.all_gather(torch.stack(g_l)), dim=0)
        nll_all = group.all_gather(torch.stack(nll_l))
        logits_all = group.all_gather(torch.stack(logits_l))
        sizes = [p.numel() for p in leaves]
        grads = tree_like(state.params, [
            g.view_as(p) for g, p in zip(torch.split(g_sum, sizes), leaves)])

        num_parts, b_max = nll_all.shape
        r = route.long()
        loss = torch.mean(nll_all.reshape(num_parts * b_max)[r])
        logits_req = logits_all.reshape(num_parts * b_max, -1)[r]
        labels_req = labels.reshape(num_parts * b_max)[r].long()
        acc = torch.mean((torch.argmax(logits_req, dim=-1) == labels_req)
                         .to(torch.float32))
        new_state = self.opt.update(grads, state)
        return new_state, {"loss": loss, "accuracy": acc}

    def grad_and_update(self, state, smb, labels, own_feats,
                        compiled: bool = True):
        """One optimizer step over a ``ShardedMiniBatch``.

        ``labels`` is the *global* per-node label array (the batcher routed
        the seeds, so labels are sliced per shard here); ``own_feats`` is
        this rank's persistent ``[L, n_own, d]`` slab stack. Returns
        ``(new_state, {"loss", "accuracy"})`` like the plain step; a
        captured step's state lives in its static buffers until the next
        call."""
        self._check(smb)
        inv_b = torch.full((), 1.0 / len(smb.seeds), dtype=torch.float32,
                           device=smb.mask.device)
        return self._train((state, own_feats, list(smb.blocks),
                            smb.slice_labels(labels), smb.mask, smb.route,
                            inv_b), compiled and self._compiled, owned=(1,))
