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
runs a few train steps on a mesh or one device.

A helper of ``tests/test_torch_model_axis.py`` and of ``chip_smoke.py``
phase 21, which import it with ``tests/`` on ``sys.path``.
"""
from __future__ import annotations

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
