"""One LM train step and one served prompt batch on a mesh of ranks, every
result gathered whole, to hold a mesh against one device (the tests'
and ``chip_smoke.py`` phase 21's comparisons).

``mesh_probe(cfg, shape, ...)`` runs on the ranks that
``launch.mesh.launch_ranks(mesh_probe, prod(shape), device, kwargs)``
starts (a mesh of one rank runs in the calling process). Each rank draws
the parameters from ``seed`` (``launch.steps.init_params``), or shards
``params_np`` (whole parameters as numpy in the reference's layout: the
reference's ``init`` tree, or the port's drawn on another device,
through ``lm.model.params_from_reference``); runs ``grad_fn`` and the
train step of ``launch.steps.build_step`` on the global ``batch``; then
prefills ``prompts`` (with the ``frontend`` of a cross-attention config)
and decodes ``gen - 1`` greedy steps (``launch.serve.generate``).
Rank 0 returns, as numpy: the initial parameters, every gradient leaf,
the new state and the caches after the last decode, each gathered whole;
the metrics; the step's logits; and, before and after the step, every
rank's resident parameter and moment bytes beside the sum of its shard
shapes from the rules (``launch.steps.resident``). ``part_kwargs`` go to
every step's ``Partitioner`` (the tests lower its thresholds so that FSDP
and ZeRO-1 shard the reduced configs). ``one_device(...)`` returns the
same keys from the one-device step (``mesh=None``); ``mesh_steps(...)``
runs a few train steps on a mesh or one device. ``variant_probe(...)``
is ``mesh_probe`` with every rank counting what the perf variants ran
(``counting``); ``moe_probe(...)`` runs the MoE layer alone on the ranks
(v-B's EP branch from whole numpy parameters, outputs and gradients
gathered whole). For the pod axis: ``psum_emulate(...)``, the numpy
yardstick of ``compressed_psum``; ``psum_probe(...)`` and
``pipeline_probe(...)``, ``compressed_psum`` and ``pipeline_forward`` on
the ranks; ``dryrun_probe(...)``, the dry run's step on real ranks.

A helper of the ``tests/test_torch_*`` mesh tests and of
``chip_smoke.py`` phases 21-23, which import it with ``tests/`` on
``sys.path``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch import partitioning as PT
from repro_torch.launch import serve as SV
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_mesh
from repro_torch.lm.config import LMConfig, ShapeCell
from repro_torch.lm.model import TransformerLM, params_from_reference
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves, tree_like
from repro_torch.optim.compression import compressed_psum
from repro_torch.runtime.pipeline import pipeline_forward


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _tensors(batch: Dict, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in batch.items()}


def mesh_probe(cfg: LMConfig, shape: Sequence[int],
               axes: Sequence[str] = ("data", "model"), *, batch: Dict,
               prompts: np.ndarray, gen: int = 4, seed: int = 0,
               frontend: Optional[np.ndarray] = None, device=None,
               part_kwargs: Optional[Dict] = None, params_np=None,
               log: Callable[[str], None] = print) -> Optional[Dict]:
    mesh = make_mesh(shape, axes, device)
    dev = mesh.device
    b, s = np.asarray(batch["tokens"]).shape
    train = ST.build_step(cfg, ShapeCell("t", s, b, "train"), mesh=mesh,
                          remat=False, part_kwargs=part_kwargs)
    part, model = train.partitioner, train.model
    opt = AdamW()

    def init(part):
        if params_np is None:
            return ST.init_params(
                model, part, torch.Generator(device=dev).manual_seed(seed))
        whole = params_from_reference(params_np, cfg, dev)
        return tree_like(whole, [
            PT.owned(PT.local_shard(t, sp, mesh), t) for t, sp in zip(
                tree_leaves(whole), ST.param_specs(part, model))])
    state = ST.init_state(opt, model, part, None, params=init(part))
    specs = ST.state_specs(part, model)
    whole = lambda ts, sp: [_np(PT.gather_whole(t, s_, mesh))  # noqa: E731
                            for t, s_ in zip(ts, sp)]
    n_p = len(tree_leaves(state.params))
    out = {"params": whole(tree_leaves(state.params), specs[:n_p]),
           "resident": ST.resident(state, part, model)}
    data = _tensors(batch, dev)
    metrics, grads = train.grad_fn(state.params, data)
    out["grads"] = whole(grads, specs[:n_p])
    new, metrics = train.fn(state, data)
    del state
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["state"] = whole(tree_leaves(new), specs)
    out["resident_after"] = ST.resident(new, part, model)
    del new
    # serving: the same parameters under the prefill's rules
    pre, dec = SV.serve_steps(cfg, prompts.shape[0], prompts.shape[1] + gen,
                              mesh=mesh, part_kwargs=part_kwargs)
    params = init(pre.partitioner)
    got = SV.generate(
        pre, dec, params, torch.as_tensor(prompts, device=dev), gen,
        frontend=(None if frontend is None
                  else torch.as_tensor(frontend, device=dev)),
        keep_logits=True)
    a_cache = TransformerLM(cfg, device="meta").init_cache(
        prompts.shape[0], prompts.shape[1] + gen)
    cspecs = [dec.partitioner.cache_spec(PT._path_str(kp), leaf)
              for kp, leaf in PT.tree_paths(a_cache)]
    out["caches"] = whole(tree_leaves(got["caches"]), cspecs)
    out["logits"] = [_np(t) for t in got["logits"]]
    out["tokens"] = got["tokens"]
    out["mesh"] = tuple(shape)
    return out if mesh.rank == 0 else None


def one_device(cfg: LMConfig, *, batch: Dict, prompts: np.ndarray,
               gen: int = 4, seed: int = 0,
               frontend: Optional[np.ndarray] = None, device="cpu",
               params_np=None) -> Dict:
    """``mesh_probe``'s keys (without ``resident``) from the one-device
    step and ``launch.serve.generate``, on the parameters drawn from
    ``seed`` or given as ``params_np``."""
    b, s = np.asarray(batch["tokens"]).shape
    train = ST.build_step(cfg, ShapeCell("t", s, b, "train"), device,
                          remat=False)
    model = train.model
    params = (params_from_reference(params_np, cfg, model.device)
              if params_np is not None else model.init(
                  torch.Generator(device=model.device).manual_seed(seed)))
    state = AdamW().init(params)
    data = _tensors(batch, model.device)
    out = {"params": [_np(t) for t in tree_leaves(params)]}
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = model.loss(tree_like(params, leaves), data)
        out["grads"] = [_np(g) for g in torch.autograd.grad(loss, leaves)]
    new, metrics = train.fn(state, data)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["state"] = [_np(t) for t in tree_leaves(new)]
    got = SV.generate(*SV.serve_steps(cfg, prompts.shape[0],
                                      prompts.shape[1] + gen,
                                      device=model.device), params,
                      torch.as_tensor(prompts, device=model.device), gen,
                      frontend=(None if frontend is None else
                                torch.as_tensor(frontend,
                                                device=model.device)),
                      keep_logits=True)
    out["caches"] = [_np(t) for t in tree_leaves(got["caches"])]
    out["logits"] = [_np(t) for t in got["logits"]]
    out["tokens"] = got["tokens"]
    return out


def mesh_steps(cfg: LMConfig, shape: Sequence[int], batches: Sequence[Dict],
               axes: Sequence[str] = ("data", "model"), *, seed: int = 0,
               device=None, part_kwargs: Optional[Dict] = None,
               log: Callable[[str], None] = print) -> Optional[Dict]:
    """``len(batches)`` train steps of ``build_step`` on the mesh (one
    device with ``shape`` of one rank and ``device`` given: ``mesh=None``);
    rank 0 returns the losses and the final state, gathered whole."""
    b, s = np.asarray(batches[0]["tokens"]).shape
    cell = ShapeCell("t", s, b, "train")
    if int(np.prod(shape)) == 1:
        bundle = ST.build_step(cfg, cell, device, remat=False)
        model = bundle.model
        state = AdamW().init(model.init(
            torch.Generator(device=model.device).manual_seed(seed)))
        mesh = specs = None
    else:
        mesh = make_mesh(shape, axes, device)
        bundle = ST.build_step(cfg, cell, mesh=mesh, remat=False,
                               part_kwargs=part_kwargs)
        model = bundle.model
        state = ST.init_state(AdamW(), model, bundle.partitioner,
                              torch.Generator(device=mesh.device)
                              .manual_seed(seed))
        specs = ST.state_specs(bundle.partitioner, model)
    losses = []
    for batch in batches:
        state, m = bundle.fn(state, _tensors(batch, model.device))
        losses.append(float(m["loss"]))
    final = (tree_leaves(state) if mesh is None else
             tree_leaves(ST.gather_state(state, specs, mesh)))
    if mesh is not None and mesh.rank != 0:
        return None
    return {"losses": losses, "state": [_np(t) for t in final]}


@contextlib.contextmanager
def counting():
    """Within the block, count on this rank what the perf variants run:
    v-B's all-to-alls (``exchange``) and the experts each EP call holds
    (``ep_experts``: the largest expert count of a ``w_gate`` it read),
    v-C's decodes (``kv_seq``), v-E's sequence slices (``seq_slice``), and
    the dtypes of every all-reduce's operand (``all_reduce``)."""
    import torch.distributed as tdist
    from repro_torch.nn import attention as A
    from repro_torch.nn import moe as MOE
    counts = {"exchange": 0, "ep_calls": 0, "ep_experts": 0, "kv_seq": 0,
              "seq_slice": 0, "all_reduce": {}}
    saved = [(PT.LogicalResolver, "exchange"), (PT.LogicalResolver,
             "seq_slice"), (A, "_seqshard_decode"), (MOE, "_moe_ffn_ep"),
             (tdist, "all_reduce")]
    old = {(o, n): getattr(o, n) for o, n in saved}

    def wrap(obj, name, note):
        fn = old[obj, name]

        def wrapped(*a, **k):
            note(*a, **k)
            return fn(*a, **k)
        setattr(obj, name, wrapped)

    def bump(key):
        def note(*a, **k):
            counts[key] += 1
        return note

    def ep(params, *a, **k):
        counts["ep_calls"] += 1
        counts["ep_experts"] = max(counts["ep_experts"],
                                   params["w_gate"].shape[0])

    def reduce(t, *a, **k):
        key = str(t.dtype).replace("torch.", "")
        counts["all_reduce"][key] = counts["all_reduce"].get(key, 0) + 1

    wrap(PT.LogicalResolver, "exchange", bump("exchange"))
    wrap(PT.LogicalResolver, "seq_slice", bump("seq_slice"))
    wrap(A, "_seqshard_decode", bump("kv_seq"))
    wrap(MOE, "_moe_ffn_ep", ep)
    wrap(tdist, "all_reduce", reduce)
    try:
        yield counts
    finally:
        for (o, n), fn in old.items():
            setattr(o, n, fn)


def variant_probe(cfg: LMConfig, shape: Sequence[int], *, device=None,
                  log: Callable[[str], None] = print, **kw):
    """``mesh_probe`` counting on every rank what the variants ran; rank 0
    returns its results with ``counts``, every rank's counts in rank
    order."""
    import torch.distributed as tdist
    with counting() as counts:
        out = mesh_probe(cfg, shape, device=device, log=log, **kw)
    every = [None] * tdist.get_world_size()
    tdist.all_gather_object(every, counts)
    if out is not None:
        out["counts"] = every
    return out


def moe_probe(cases: Sequence[Dict], shape: Sequence[int], *, device=None,
              log: Callable[[str], None] = print):
    """The MoE layer alone on a ``(data, model)`` mesh with ``moe_ep``, for
    each case (``params``: whole numpy leaves ``router`` / ``w_gate`` /
    ``w_up`` / ``w_down``; ``x`` ``[B, S, D]``; ``e``, ``k``, ``cf``):
    each rank keeps its shards of the parameters (the rules of an
    unstacked ``moe/<leaf>``), uses them under the EP branch's plans and
    runs ``moe_ffn`` on its rows of ``x``. Rank 0 returns, per case, the
    output gathered whole, ``lb_loss``, ``dropped``, the gradients of
    ``sum(out ** 2)`` over the whole batch (reduced per plan, summed over
    the batch's axes, gathered whole) and every rank's expert count read
    by the EP call."""
    import torch.distributed as tdist
    from repro_torch import configs as C
    from repro_torch.nn import moe as MOE
    from repro_torch.nn.common import sharding_context
    mesh = make_mesh(shape, ("data", "model"), device)
    results = []
    for case in cases:
        e, k, cf = case["e"], case["k"], case["cf"]
        cfg = dataclasses.replace(C.get_reduced("moonshot-v1-16b-a3b"),
                                  num_experts=e, experts_per_tok=k)
        part = PT.Partitioner(mesh, cfg, moe_ep=True)
        x = torch.as_tensor(case["x"], device=mesh.device)
        b, s, _ = x.shape
        res = part.logical_resolver(b, s)
        assert res.run.ep, (e, shape)
        names = ("router", "w_gate", "w_up", "w_down")
        plans, uses = [], []
        for name in names:
            whole = torch.as_tensor(case["params"][name], device=mesh.device)
            pl = part.plan(f"moe/{name}", whole, res.run)
            stored = PT.owned(PT.local_shard(whole, pl.spec, mesh), whole)
            plans.append(pl)
            uses.append(PT.to_use(stored, pl, mesh).requires_grad_(True))
        axes = tuple(part.batch_dims(b))
        with counting() as counts, sharding_context(res):
            out, aux = MOE.moe_ffn(dict(zip(names, uses)),
                                   mesh.local(x, axes, 0), e, k, cf)
        grads = torch.autograd.grad(torch.sum(out ** 2), uses)
        whole_grads = []
        for g, pl in zip(grads, plans):
            if pl.model == "partial":
                g = mesh.all_reduce(g, ("model",))
            g = mesh.all_reduce(g, axes)
            whole_grads.append(_np(PT.gather_whole(
                PT.from_use(g, pl, mesh).contiguous(), pl.spec, mesh)))
        every = [None] * tdist.get_world_size()
        tdist.all_gather_object(every, counts["ep_experts"])
        # the model ranks' means, averaged over the batch's axes as the
        # step averages its metrics
        aux = {n: float(mesh.all_reduce(v.detach(), axes))
               / mesh.group_size(axes) for n, v in aux.items()}
        results.append(dict(
            out=_np(mesh.all_gather(out.detach(), axes, 0)),
            lb_loss=aux["lb_loss"], dropped=aux["dropped"],
            grads=dict(zip(names, whole_grads)), ep_experts=every,
            models=[pl.model for pl in plans]))
    return results if mesh.rank == 0 else None


def psum_emulate(xs, block=256):
    """The reference's ``compressed_psum`` over members ``xs`` (numpy
    arrays of one shape), in numpy: the per-block MAX of the members'
    scales, each member's int8 payload summed in int32."""
    n = xs[0].size
    pad = (-n) % block
    blocks = [np.pad(x.reshape(-1), (0, pad)).reshape(-1, block)
              for x in xs]
    scale = np.maximum.reduce([np.abs(b).max(1, keepdims=True)
                               / np.float32(127) for b in blocks])
    scale = np.maximum(scale, np.float32(1e-12))
    acc = np.zeros(blocks[0].shape, dtype=np.int32)
    for b in blocks:
        acc += np.clip(np.rint(b / scale), -127, 127).astype(np.int32)
    return (acc.astype(np.float32) * scale).reshape(-1)[:n].reshape(
        xs[0].shape)


def psum_probe(shape: Sequence[int], axes: Sequence[str], xs, *,
               psum_axes: Sequence[str] = ("pod",), device=None,
               log: Callable[[str], None] = print):
    """``compressed_psum`` of ``xs[rank]`` (numpy) over ``psum_axes`` of
    ``make_mesh(shape, axes)``; rank 0 returns every rank's result in rank
    order (numpy)."""
    mesh = make_mesh(shape, axes, device)
    y = compressed_psum(torch.as_tensor(np.asarray(xs[mesh.rank]),
                                        device=mesh.device), mesh,
                        tuple(psum_axes))
    every = mesh.all_gather(y[None].contiguous(), mesh.axis_names, 0)
    return _np(every) if mesh.rank == 0 else None


def tanh_stage(p, h):
    """The reference test's stage: ``tanh(h @ w)``."""
    return torch.tanh(h @ p["w"])


def pipeline_probe(shape: Sequence[int], axes: Sequence[str], w, x, *,
                   axis: str = "pod", device=None,
                   log: Callable[[str], None] = print):
    """``pipeline_forward(tanh_stage, {"w": w}, x, mesh, axis)`` on the
    ranks (``w`` ``[P, d, d]``, ``x`` ``[M, mb, d]``, numpy): rank 0
    returns every rank's outputs, the gradient of ``sum(out ** 2)`` over
    ``w`` (each stage's slice from its own ranks, summed over ``axis``:
    the other slices are zeros there), every rank's gradient of its own
    stage, every rank's gradient of ``x`` and the outputs of a run
    without grad."""
    mesh = make_mesh(shape, axes, device)
    wt = torch.as_tensor(np.asarray(w), device=mesh.device)
    xt = torch.as_tensor(np.asarray(x), device=mesh.device)
    leaf = wt.clone().requires_grad_(True)
    xleaf = xt.clone().requires_grad_(True)
    out = pipeline_forward(tanh_stage, {"w": leaf}, xleaf, mesh, axis)
    g, gx = torch.autograd.grad(torch.sum(out ** 2), [leaf, xleaf])
    with torch.no_grad():
        plain = pipeline_forward(tanh_stage, {"w": wt}, xt, mesh, axis)
    own = g[mesh.coord[axis]]
    outs = mesh.all_gather(out.detach()[None].contiguous(), mesh.axis_names,
                           0)
    owns = mesh.all_gather(own[None].contiguous(), mesh.axis_names, 0)
    gxs = mesh.all_gather(gx[None].contiguous(), mesh.axis_names, 0)
    whole = mesh.all_reduce(g, (axis,))
    if mesh.rank:
        return None
    return dict(out=_np(outs), grad=_np(whole), own=_np(owns),
                grad_x=_np(gxs), plain=_np(plain))


def dryrun_probe(cfg: LMConfig, cell: ShapeCell, shape: Sequence[int],
                 axes: Sequence[str] = ("data", "model"), *,
                 part_kwargs: Optional[Dict] = None, device=None,
                 log: Callable[[str], None] = print):
    """``launch.dryrun.run_rank_step`` of ``cell`` on every rank of
    ``make_mesh(shape, axes)``, its collectives tallied by
    ``CountingMesh.wrap``; rank 0 returns every rank's result and, for a
    train cell, ``launch.steps.resident`` of the state the step ran on."""
    import torch.distributed as tdist
    from repro_torch.launch import dryrun as D
    mesh = make_mesh(shape, axes, device)
    got = D.run_rank_step(cfg, cell, D.CountingMesh.wrap(mesh), part_kwargs)
    resident = None
    if cell.mode == "train":
        bundle = ST.build_step(cfg, cell, mesh=mesh, remat=False,
                               part_kwargs=part_kwargs)
        (state, _), _ = D.rank_args(bundle, cfg, cell, mesh)
        resident = ST.resident(state, bundle.partitioner, bundle.model)
    every = [None] * tdist.get_world_size()
    tdist.all_gather_object(every, got)
    return dict(ranks=every, resident=resident) if mesh.rank == 0 else None
