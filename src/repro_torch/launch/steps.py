"""Step builders of the port: ``train`` / ``prefill`` / ``decode`` for one
(arch x cell) on one device or a mesh of ranks (the port's counterpart of
``repro.launch.steps``).

``input_specs`` gives the data inputs' shapes and dtypes as meta tensors
(the reference's ``ShapeDtypeStruct`` stand-ins); ``build_step`` returns a
``StepBundle`` whose ``fn`` runs the step eagerly and whose
``abstract_args`` are meta tensors matching ``fn``'s signature.

* ``train``: ``fn(state, batch) -> (new_state, {"loss", "nll",
  "moe_aux"})``: ``TransformerLM.loss``, ``torch.autograd.grad`` over the
  parameter leaves, then ``AdamW.update`` with the reference's optimizer,
  ``AdamW(cosine_schedule(3e-4, 200, 20_000))``.
* ``prefill``: ``fn(params, tokens, frontend=None) -> (logits, caches)``
  into a cache of ``seq_len`` positions (``frontend``: the stubbed frontend
  embeddings of a config with cross-attention); ``decode``: ``fn(params,
  token, index, caches, frontend=None)`` (``index`` a Python int) against
  that cache, written in place (the frontend is ignored: the memory's K/V
  are cached). The train step passes ``batch["frontend"]`` to the loss.

With ``mesh`` (a ``launch.mesh.RankMesh``) the step runs on this rank's
shards: ``build_step`` builds the reference's ``Partitioner(mesh, cfg,
mode=cell.mode)`` (on the bundle as ``partitioner``) and runs each step
under ``sharding_context`` of its resolver, as the reference's steps do.
The arguments are the global batch (every rank the same; the step takes
its rows per ``batch_dims``) and the state, params and caches as each
rank stores them (``init_state``, ``init_params``, the prefill's caches).
Each leaf is gathered where its plan gathers (``launch/partitioning.py``),
and its gradient summed over ``model`` where partial, summed over the
batch's axes and divided by their size (a mean of equal local means), and
sliced back to the stored shard. The gradients are clipped by their global
norm, then ``AdamW.update`` (clipping off) runs unchanged on the ZeRO-1
slices of parameter, gradient and moments; a parameter's updated slices
are all-gathered over ``data`` where its moments are sharded further. The
outputs (loss, logits) are replicated, as the reference's
``out_shardings`` make them; the caches come back sharded per
``cache_spec``. ``mesh=None`` is the one-device step, unchanged.

The perf variants' flags (``part_kwargs``: ``moe_ep``, v-B;
``seq_shard_kv_decode``, v-C; ``bf16_reduce``, v-D;
``seq_shard_activations``, v-E) reach the ``Partitioner`` of every mode.
Each step call asks it which variants its shapes take
(``Partitioner.run_for``: the global batch, the token length, a
decode's cache length), installs the resolver of that ``Run`` and uses
the parameters and caches under the plans of that ``Run``: the gradients
are reduced and sliced by the same plans. A v-C decode's caches are
stored split on the sequence, the prefill's on heads: ``launch.serve.
generate`` re-lays them once in between.

Differences by design: nothing is donated: ``AdamW.update`` stays functional
(it is shared with the RGNN trainers and their bitwise invariants), so the
old state lives until the caller drops it; an in-place update waits in
``ROADMAP.md`` §2.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.launch import partitioning as PT
from repro_torch.launch.partitioning import Partitioner
from repro_torch.lm.config import LMConfig, ShapeCell
from repro_torch.lm.model import TransformerLM
from repro_torch.nn.common import sharding_context
from repro_torch.optim import AdamW, TrainState, cosine_schedule
from repro_torch.optim.adamw import tree_leaves, tree_like


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: LMConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Abstract data inputs for this (arch, cell), as meta tensors:
    tokens / targets (train), tokens (prefill) or the decode token and
    index; configs with an encoder or a frontend add stubbed frontend
    embeddings, as in the reference."""
    b, s = cell.global_batch, cell.seq_len
    dt = getattr(torch, cfg.dtype)
    specs: Dict[str, torch.Tensor] = {}
    if cell.mode == "train":
        specs["tokens"] = _meta((b, s), torch.int32)
        specs["targets"] = _meta((b, s), torch.int32)
    elif cell.mode == "prefill":
        specs["tokens"] = _meta((b, s), torch.int32)
    else:  # decode: one new token against a seq_len cache
        specs["token"] = _meta((b, 1), torch.int32)
        specs["index"] = _meta((), torch.int32)
    if cfg.encoder_layers:
        specs["frontend"] = _meta((b, cfg.encoder_seq, cfg.d_model), dt)
    elif cfg.frontend_tokens:
        specs["frontend"] = _meta((b, cfg.frontend_tokens, cfg.frontend_dim),
                                  dt)
    return specs


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run one (arch x cell) step."""

    name: str
    fn: Callable
    abstract_args: Tuple         # meta tensors matching fn's signature
    model: TransformerLM
    mode: str
    partitioner: Optional[Partitioner] = None    # None without a mesh
    # on a mesh, train: ``grad_fn(params, batch) -> (metrics, grads)``, the
    # step's replicated metrics and reduced (unclipped) gradient shards
    grad_fn: Optional[Callable] = None


def build_step(cfg: LMConfig, cell: ShapeCell, device=None, *,
               mesh=None, remat: bool = True,
               part_kwargs: Optional[dict] = None) -> StepBundle:
    """The step of ``cell.mode`` for ``cfg`` on ``device`` (``None``: the
    CUDA card), for every config of the registry; with ``mesh`` (a
    ``RankMesh``) on this rank's shards and device (``part_kwargs``: the
    ``Partitioner``'s thresholds and flags). ``abstract_args`` holds the
    global shapes as meta tensors, with the frontend's where the prefill
    takes one."""
    if mesh is not None:
        return _build_mesh_step(cfg, cell, mesh, device, remat,
                                part_kwargs or {})
    model = TransformerLM(cfg, device=device, remat=remat)
    meta = TransformerLM(cfg, device="meta")
    data = input_specs(cfg, cell)
    b, s = cell.global_batch, cell.seq_len
    a_params = meta._build(None)

    if cell.mode == "train":
        opt = AdamW(learning_rate=cosine_schedule(3e-4, 200, 20_000))

        def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(True)
                          for p in tree_leaves(state.params)]
                loss, metrics = model.loss(tree_like(state.params, leaves),
                                           batch)
                grads = torch.autograd.grad(loss, leaves)
            new_state = opt.update(tree_like(state.params, list(grads)),
                                   state)
            out = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in metrics.items()}}
            return new_state, out

        return StepBundle(f"{cfg.name}:{cell.name}:train", train_step,
                          (opt.init(a_params), data), model, "train")

    if cell.mode == "prefill":
        @torch.no_grad()
        def serve_prefill(params, tokens, frontend=None):
            return model.prefill(params, tokens, frontend=frontend,
                                 cache_len=s)

        args = (a_params, data["tokens"])
        if "frontend" in data:
            args += (data["frontend"],)
        return StepBundle(f"{cfg.name}:{cell.name}:prefill", serve_prefill,
                          args, model, "prefill")

    @torch.no_grad()
    def serve_step(params, token, index: int, caches: Any, frontend=None):
        return model.decode_step(params, token, index, caches)

    return StepBundle(f"{cfg.name}:{cell.name}:decode", serve_step,
                      (a_params, data["token"], data["index"],
                       meta.init_cache(b, s)), model, "decode")


# ---------------------------------------------------------------------------
# on a mesh of ranks
# ---------------------------------------------------------------------------
def init_params(model: TransformerLM, part: Partitioner,
                generator: torch.Generator) -> Dict:
    """Parameters drawn whole from ``generator`` one leaf at a time, each
    rank keeping its shard under ``part.param_spec``: the one device's
    values, bit for bit."""
    return model.init(generator, keep=lambda path, t: PT.local_shard(
        t, part.param_spec(path, t), part.mesh))


def init_state(opt: AdamW, model: TransformerLM, part: Partitioner,
               generator: Optional[torch.Generator], *,
               params: Optional[Dict] = None) -> TrainState:
    """``opt.init`` of ``init_params`` (or of ``params``, this rank's
    shards), the moments zeros of their ZeRO-1 shards
    (``part.opt_spec``)."""
    if params is None:
        params = init_params(model, part, generator)
    meta = TransformerLM(model.cfg, device="meta")._build(None)
    moments = [torch.zeros(PT.shard_shape(part.mesh, part.opt_spec(
        PT._path_str(kp), leaf), leaf.shape), dtype=torch.float32,
        device=model.device) for kp, leaf in PT.tree_paths(meta)]
    return TrainState(params=params, mu=tree_like(params, moments),
                      nu=tree_like(params, [m.clone() for m in moments]),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def state_specs(part: Partitioner, model: TransformerLM) -> list:
    """The spec of every leaf of a ``TrainState`` (``tree_leaves`` order)."""
    meta = TransformerLM(model.cfg, device="meta")._build(None)
    return [s.spec for s in PT.flat_leaves(part.state_shardings(
        AdamW().init(meta)))]


def param_specs(part: Partitioner, model: TransformerLM) -> list:
    """The spec of every parameter leaf (``tree_leaves`` order)."""
    meta = TransformerLM(model.cfg, device="meta")._build(None)
    return [s.spec for s in PT.flat_leaves(part.param_shardings(meta))]


def cache_specs(part: Partitioner, a_cache) -> list:
    """The spec of every leaf of the cache tree ``a_cache`` (meta tensors;
    ``tree_leaves`` order)."""
    return [s.spec for s in PT.flat_leaves(part.cache_shardings(a_cache))]


def resident(state: TrainState, part: Partitioner,
             model: TransformerLM) -> list:
    """Every rank's resident parameter and moment bytes beside the sum of
    its shard shapes from the rules, and whether each leaf is exactly its
    shard (its shape, and storage of its own: no rank holds a sharded leaf
    whole). A collective: every rank calls it; each gets every rank's."""
    mesh = part.mesh
    meta = AdamW().init(TransformerLM(model.cfg, device="meta")._build(None))
    n_p = len(tree_leaves(state.params))
    row = []
    for lo, hi in ((0, n_p), (n_p, 3 * n_p)):
        have = want = 0
        exact = True
        for t, spec, m in list(zip(tree_leaves(state), state_specs(
                part, model), tree_leaves(meta)))[lo:hi]:
            local = PT.shard_shape(mesh, spec, m.shape)
            have += t.numel() * t.element_size()
            want += PT._prod(local) * t.element_size()
            exact &= (tuple(t.shape) == local and t.untyped_storage().nbytes()
                      == t.numel() * t.element_size())
        row += [have, want, int(exact)]
    rows = mesh.all_gather(torch.tensor([row], dtype=torch.int64),
                           mesh.axis_names, 0).tolist()
    return [{k: dict(zip(("bytes", "expected", "exact"), r[3 * i:3 * i + 3]))
             for i, k in enumerate(("params", "moments"))} for r in rows]


def gather_state(state: TrainState, specs: list, mesh) -> TrainState:
    """Every leaf of a sharded state gathered whole, on the host (a
    collective)."""
    return tree_like(state, [PT.gather_whole(t, s, mesh).cpu() for t, s in
                             zip(tree_leaves(state), specs)])


def reshard(tree, src: list, dst: list, mesh):
    """A tree stored under the specs ``src`` restored under ``dst`` (leaf
    by leaf: gathered whole, then sliced; a leaf whose specs agree is kept
    as it is)."""
    out = []
    for t, a, b in zip(tree_leaves(tree), src, dst):
        if a == b:
            out.append(t)
            continue
        whole = PT.gather_whole(t, a, mesh)
        out.append(PT.owned(PT.local_shard(whole, b, mesh), whole))
    return tree_like(tree, out)


def _rows(mesh, axes, t: torch.Tensor) -> torch.Tensor:
    return mesh.local(t, axes, 0) if axes else t


def _build_mesh_step(cfg, cell, mesh, device, remat, part_kwargs):
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    part = Partitioner(mesh, cfg, mode=cell.mode, **part_kwargs)
    model = TransformerLM(cfg, device=mesh.device, remat=remat)
    meta = TransformerLM(cfg, device="meta")
    data = input_specs(cfg, cell)
    b, s = cell.global_batch, cell.seq_len
    a_params = meta._build(None)
    a_cache = meta.init_cache(b, s) if cell.mode != "train" else None
    known: Dict[Any, list] = {}

    def plans_for(run: PT.Run, cache: bool = False) -> list:
        """Every parameter's (or cache leaf's) plan in a step taking
        ``run``."""
        if (run, cache) not in known:
            plan = part.cache_plan if cache else part.plan
            known[run, cache] = [plan(PT._path_str(kp), leaf, run) for kp, leaf
                                 in PT.tree_paths(a_cache if cache
                                                  else a_params)]
        return known[run, cache]

    plans = plans_for(PT.Run())     # the stored specs: the same in any run

    def use_params(params, run):
        return tree_like(params, [PT.to_use(p, pl, mesh) for p, pl in
                                  zip(tree_leaves(params), plans_for(run))])

    def batch_axes(batch_size):
        axes = part.batch_dims(batch_size)
        return tuple(axes or ()), mesh.group_size(tuple(axes or ()))

    if cell.mode == "train":
        opt = AdamW(learning_rate=cosine_schedule(3e-4, 200, 20_000))
        noclip = dataclasses.replace(opt, clip_norm=None)
        ospecs = [part.opt_spec(PT._path_str(kp), leaf)
                  for kp, leaf in PT.tree_paths(a_params)]
        # the dimensions ZeRO-1 shards beyond the parameter's own spec
        extra = [[d for d in range(len(o))
                  if o.axes(d) and not pl.spec.axes(d)]
                 for o, pl in zip(ospecs, plans)]
        replicas = [mesh.size // PT._prod(mesh.shape[a]
                                          for a in pl.spec.all_axes())
                    for pl in plans]

        def reduce_grad(g, pl, axes, n):
            dt = g.dtype
            if pl.model == "partial":
                g = mesh.all_reduce(g.float(), ("model",)).to(dt)
            if n > 1:
                g = (mesh.all_reduce(g.float(), axes) / n).to(dt)
            return PT.owned(PT.from_use(g, pl, mesh), g)

        def grad_fn(params, batch: Dict[str, torch.Tensor]):
            axes, n = batch_axes(batch["tokens"].shape[0])
            resolver = part.logical_resolver(*batch["tokens"].shape)
            local = {k: _rows(mesh, axes, v) for k, v in batch.items()}
            with torch.enable_grad():
                leaves = [u.detach().requires_grad_(True) for u in
                          tree_leaves(use_params(params, resolver.run))]
                with sharding_context(resolver):
                    loss, metrics = model.loss(tree_like(params, leaves),
                                               local)
                grads = torch.autograd.grad(loss, leaves)
            del leaves
            grads = [reduce_grad(g, pl, axes, n)
                     for g, pl in zip(grads, plans_for(resolver.run))]
            out = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in metrics.items()}}
            if n > 1:
                out = {k: mesh.all_reduce(v, axes) / n
                       for k, v in out.items()}
            return out, grads

        def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
            out, grads = grad_fn(state.params, batch)
            with torch.no_grad():
                # the global norm: each shard's squares once over the mesh
                gsq = torch.zeros((), dtype=torch.float32, device=mesh.device)
                for g, k in zip(grads, replicas):
                    gsq = gsq + torch.sum(torch.square(g.float())) / k
                gnorm = torch.sqrt(mesh.all_reduce(gsq, mesh.axis_names))
                scale = torch.clamp(
                    opt.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
                grads = [g * scale.to(g.dtype) for g in grads]
                params = tree_leaves(state.params)

                def zero(t, dims):
                    for d in dims:
                        t = mesh.local(t, ("data",), d)
                    return t
                new = noclip.update(
                    tree_like(state.params, [zero(g, e) for g, e in
                                             zip(grads, extra)]),
                    TrainState(params=tree_like(state.params, [
                        zero(p, e) for p, e in zip(params, extra)]),
                        mu=state.mu, nu=state.nu, step=state.step))
                new_params = []
                for p, e in zip(tree_leaves(new.params), extra):
                    for d in e:
                        p = mesh.all_gather(p, ("data",), d)
                    new_params.append(p)
            return TrainState(params=tree_like(state.params, new_params),
                              mu=new.mu, nu=new.nu, step=new.step), out

        return StepBundle(f"{cfg.name}:{cell.name}:train", train_step,
                          (opt.init(a_params), data), model, "train", part,
                          grad_fn)

    def replicated(logits, axes):
        return mesh.all_gather(logits, axes, 0) if axes else logits

    if cell.mode == "prefill":
        @torch.no_grad()
        def serve_prefill(params, tokens, frontend=None):
            axes, _ = batch_axes(tokens.shape[0])
            resolver = part.logical_resolver(*tokens.shape)
            cplans = plans_for(resolver.run, cache=True)
            cache = tree_like(a_cache, [torch.zeros(
                PT.shard_shape(mesh, pl.use, leaf.shape), dtype=leaf.dtype,
                device=mesh.device) for leaf, pl in
                zip(tree_leaves(a_cache), cplans)])
            up = use_params(params, resolver.run)
            with sharding_context(resolver):
                hidden = model.backbone(
                    up, _rows(mesh, axes, tokens),
                    frontend=(None if frontend is None
                              else _rows(mesh, axes, frontend)),
                    mode="prefill", caches=cache)
                logits = model.logits(up, hidden[:, -1:])
            stored = [PT.owned(PT.from_use(c, pl, mesh), c)
                      for c, pl in zip(tree_leaves(cache), cplans)]
            return replicated(logits, axes), tree_like(cache, stored)

        args = (a_params, data["tokens"])
        if "frontend" in data:
            args += (data["frontend"],)
        return StepBundle(f"{cfg.name}:{cell.name}:prefill", serve_prefill,
                          args, model, "prefill", part)

    @torch.no_grad()
    def serve_step(params, token, index: int, caches: Any, frontend=None):
        axes, _ = batch_axes(token.shape[0])
        resolver = part.logical_resolver(*token.shape, cache_len=s)
        cplans = plans_for(resolver.run, cache=True)
        stored = tree_leaves(caches)
        use = [PT.to_use(c, pl, mesh) for c, pl in zip(stored, cplans)]
        with sharding_context(resolver):
            logits, _ = model.decode_step(use_params(params, resolver.run),
                                          _rows(mesh, axes, token), index,
                                          tree_like(caches, use))
        for c, u, pl in zip(stored, use, cplans):
            if u is not c:
                c.copy_(PT.from_use(u, pl, mesh))
        return replicated(logits, axes), caches

    return StepBundle(f"{cfg.name}:{cell.name}:decode", serve_step,
                      (a_params, data["token"], data["index"], a_cache),
                      model, "decode", part)
