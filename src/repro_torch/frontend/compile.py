"""The ``hector_torch.compile()`` front door.

One call takes a model (a DSL ``ModelSpec``, a registry name like
``"rgcn"`` or ``"hgt"``, or any ``prog_fn(in_dim, out_dim, **kw) ->
Program``) plus a ``HeteroGraph`` and builds the stack: per-layer traced
programs -> validated/lowered plans -> ``HectorStack`` -> fanout sampler,
on one device. The returned ``CompiledRGNN`` exposes ``init`` / ``apply`` (full
graph) / ``apply_blocks`` (sampled mini-batch) / ``init_state`` /
``train_step`` (one sampled SGD step) / ``profile`` (the per-op
breakdown of a mini-batch) / ``describe`` and delegates every
other attribute to the underlying ``RGNNEngine``, so it drops into the
trainers unchanged.

``device=None`` means the CUDA card, and raises without one: pass
``device="cpu"`` to run the plain versions on the CPU. ``tune=`` runs the
autotuner on that device exactly as the drivers' ``--tune`` flag does.
``feature_store=`` / ``feature_budget=`` pick the tier of the node-feature
table (``repro_torch.feats``): ``compiled.make_feature_store(feats)``
builds it, and it goes wherever a raw table went (``make_loader``,
``apply_blocks``, ``train_step``, ``profile``). ``dp=`` / ``partitions=``
turn on data-parallel execution (``repro_torch.dist``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["compile", "CompiledRGNN"]


class CompiledRGNN:
    """A compiled multi-layer RGNN bound to one graph and one device."""

    def __init__(self, engine, opt=None):
        self.engine = engine
        self._opt = opt

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def init(self, seed: Union[int, torch.Generator] = 0):
        """Per-layer parameter dicts on the engine's device, drawn from a
        ``torch.Generator`` (an int seeds a fresh one)."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator().manual_seed(int(seed))
        return self.engine.init_params(gen)

    def params_from_reference(self, params_np):
        """The reference package's per-layer params (numpy arrays) as this
        model's, checked against the plans' weight tables."""
        from repro_torch.core.codegen import params_from_reference
        return params_from_reference(
            params_np, self.engine.device, plans=self.engine.plans,
            num_etypes=self.engine.graph.num_etypes,
            num_ntypes=self.engine.graph.num_ntypes)

    def apply(self, params, feats, compiled: bool = True) -> torch.Tensor:
        """Full-graph forward; ``feats`` is the [N, dim] input feature
        table (or a ``{"feature": table}`` dict) on the engine's device."""
        if isinstance(feats, dict):
            feats = feats["feature"]
        return self.engine.forward_full(params, feats, compiled=compiled)

    def apply_blocks(self, params, mb, global_feats,
                     compiled: bool = True) -> torch.Tensor:
        """Sampled mini-batch forward over a ``sampling.MiniBatch``;
        returns one row per requested seed. ``global_feats`` is the device
        table or a feature store (loader-attached ``mb.feats`` win).
        ``compiled=True`` replays the captured CUDA graph of the batch's
        signature on a card; ``compiled=False`` runs op by op."""
        return self.engine.forward_minibatch(params, mb, global_feats,
                                             compiled=compiled)

    def init_state(self, params_or_seed, opt=None):
        """Optimizer state for ``train_step`` from per-layer params (or a
        seed / generator for ``init``). ``opt`` (a
        ``repro_torch.optim.AdamW``, default lr 3e-3) is bound on first
        use."""
        if opt is not None:
            self._opt = opt
        params = params_or_seed
        if isinstance(params_or_seed, (int, torch.Generator)):
            params = self.init(params_or_seed)
        return self._optimizer().init(params)

    def train_step(self, state, mb, labels, global_feats):
        """One neighbor-sampled SGD step (block forward -> per-seed
        cross-entropy -> backward -> optimizer update). ``labels`` align
        with the requested seed order (``mb.seq.slice_labels``); returns
        ``(new_state, {"loss", "accuracy"})``. Captured on a card: the new
        state may live in the step's graph buffers, valid until the next
        step — copy what you keep. ``global_feats`` is the device table or
        a feature store (loader-attached ``mb.feats`` win)."""
        from repro_torch.feats import gather_input
        labels = torch.as_tensor(labels).to(self.engine.device)
        feats = gather_input(global_feats, mb)
        return self.engine.train_executor(self._optimizer()).grad_and_update(
            state, mb, labels, feats)

    def profile(self, params, mb, global_feats, *, warmup: int = 1,
                iters: int = 3):
        """Per-op kernel-time breakdown (the paper's Fig.-9 view) of one
        sampled mini-batch through this model's block path, on the
        engine's device: every op instance (plus one glue row per hop)
        attributed by prefix differencing on the tuner's measurement
        harness, next to the whole-sequence time. ``global_feats`` as in
        ``apply_blocks`` (a store is read without changing its state). Returns an
        ``obs.profile.PlanProfile`` (``.table()`` renders the breakdown,
        ``.to_json()`` exports it)."""
        from repro_torch.obs import profile as _prof
        return _prof.profile_minibatch(self.engine, params, mb,
                                       global_feats, warmup=warmup,
                                       iters=iters)

    def _optimizer(self):
        if self._opt is None:
            from repro_torch.optim import AdamW
            self._opt = AdamW(learning_rate=3e-3)
        return self._opt

    def describe(self) -> str:
        """The generated plans, one per layer."""
        return "\n".join(p.describe() for p in self.engine.plans)

    def __repr__(self) -> str:
        cfg = self.engine.cfg
        return (f"CompiledRGNN<{cfg.model_name}: {cfg.layers} layers, "
                f"dims {cfg.dims}, device {self.engine.device}>")


def compile(  # noqa: A001 - deliberate: the hector_torch.compile() front door
    model,
    graph,
    *,
    layers: int = 2,
    dim: int = 64,
    hidden: int = 64,
    classes: int = 16,
    sample: Optional[Union[int, Sequence[int]]] = None,
    tile: int = 32,
    node_block: int = 32,
    bucket: bool = True,
    activation: str = "relu",
    seed: int = 0,
    device=None,
    sampler: str = "host",
    dp: int = 1,
    partitions: Optional[int] = None,
    feature_store: str = "device",
    feature_budget: Optional[int] = None,
    tune: str = "off",
    tune_cache: Optional[str] = None,
    tune_full_graph: bool = True,
    opt=None,
    config=None,
    model_args: Optional[dict] = None,
    log=None,
    **model_kwargs,
) -> CompiledRGNN:
    """Compile ``model`` for ``graph`` on ``device`` (``None``: the CUDA
    card) and return a ``CompiledRGNN``.

    ``model``: a registry name (``"rgcn" | "rgat" | "hgt" | "rgcn_cat"``),
    a ``@hector_torch.model`` ``ModelSpec`` or any
    ``prog_fn(in_dim, out_dim, **hparams) -> Program``.
    ``sample``: per-hop neighbor fanout of the mini-batch path — an int
    (every hop), a per-layer sequence, or ``-1`` for full neighborhoods.
    ``sampler``: ``"host"`` (NumPy sampling and layouts on a loader
    thread) or ``"device"`` (``DeviceSampler``: selection and layouts on
    the device; the same edges for the same stream position).
    ``bucket=False`` keeps mini-batches at their exact sizes (no
    power-of-two padding: every new size is a new executor key).
    ``feature_store`` / ``feature_budget``: where the node-feature table
    lives (``repro_torch.feats``): ``"device"`` (the whole table on the
    device), ``"host"`` (host tables, only sampled rows shipped) or
    ``"cached"`` (the host tier behind a device hot-row cache of
    ``feature_budget`` rows, default table/4); predictions are the same
    bit for bit across the three. ``dp`` / ``partitions``: data-parallel
    execution (``repro_torch.dist``): the graph is edge-cut into
    ``partitions`` shards (default one per rank) and the multi-shard train
    and serve steps run them on ``dp`` ranks (``dp > 1`` inside the ranks
    ``launch.mesh.launch_ranks`` starts), the halo-feature all-gather and
    the gradient sum included. The engine then exposes ``dist_batcher`` /
    ``dist_train_executor(opt)`` / ``dist_serve_executor()`` /
    ``shard_features(feats)``. ``opt`` (a ``repro_torch.optim.AdamW``)
    is ``train_step``'s optimizer (default lr 3e-3).
    ``tune``: ``"off"`` (the defaults), ``"cached"`` (replay the
    persistent cache at ``tune_cache``, no measurement) or ``"full"``
    (measure what the cache lacks, on ``device``); ``tune_full_graph=False``
    (a caller that only runs sampled batches) skips the full-graph layout
    and op measurements. ``log`` receives the tuner's lines.
    Model hyperparameters ride along as extra keyword arguments, or in
    ``model_args={...}`` where a name collides with a compile keyword
    (e.g. RGCN's ``activation``).
    ``config``: a prebuilt ``train.engine.EngineConfig`` (overrides every
    other compilation keyword; ``model`` still wins if not ``None``).
    """
    import dataclasses

    from repro_torch.train.engine import EngineConfig, RGNNEngine

    if config is not None:
        cfg = config if model is None else \
            dataclasses.replace(config, model=model)
    else:
        if isinstance(sample, (int, np.integer)):
            sample = [int(sample)] * layers
        prog_fn = model
        model_kwargs = {**(model_args or {}), **model_kwargs}
        if model_kwargs:
            import functools

            from repro_torch.train.engine import MODEL_PROGRAMS
            if isinstance(model, str) and model not in MODEL_PROGRAMS:
                raise ValueError(f"unknown model {model!r}; "
                                 f"have {sorted(MODEL_PROGRAMS)}")
            base = MODEL_PROGRAMS[model] if isinstance(model, str) else model
            prog_fn = functools.partial(base, **model_kwargs)
            prog_fn.name = getattr(base, "name",
                                   getattr(base, "__name__", "custom"))
        cfg = EngineConfig(
            model=prog_fn, layers=layers, dim=dim, hidden=hidden,
            classes=classes, fanouts=sample, tile=tile,
            node_block=node_block, bucket=bucket, activation=activation,
            seed=seed, device=device, sampler=sampler, dp=dp,
            partitions=partitions, feature_store=feature_store, feature_budget=feature_budget,
            tune=tune, tune_cache=tune_cache,
            tune_full_graph=tune_full_graph)
    return CompiledRGNN(RGNNEngine(graph, cfg, log=log), opt=opt)
