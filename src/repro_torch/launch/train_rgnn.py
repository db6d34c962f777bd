"""Neighbor-sampled RGNN training driver of the PyTorch/CUDA port.

The training counterpart of ``serve_rgnn``, as ``repro.launch.train_rgnn``:
seed batches stream through the epoch-aware shuffled ``EpochSeedStream``
(without replacement) into the prefetching loader, and every mini-batch
runs one ``BlockTrainExecutor`` step — block forward, per-seed
cross-entropy, backward through the kernels' autograd Functions, AdamW
with a cosine schedule. Periodic full-graph + sampled evaluation,
asynchronous checkpoints with mid-epoch resume, and an optional
full-graph parity run (``--parity``): the full-graph trainer with the same
step budget, whose held-out loss the sampled run must come within
``--parity-tol`` of.

    PYTHONPATH=src python -m repro_torch.launch.train_rgnn --device cuda
    PYTHONPATH=src python -m repro_torch.launch.train_rgnn --device cpu \\
        --reduced

The task is learnable: labels come from a frozen, randomly initialized
teacher of the same architecture run over the full graph. Runs on the
CUDA card unless given ``--device cpu``; ``--sampler device`` samples the
mini-batches and builds their layouts on the device (``DeviceSampler``).
``--tune full|cached`` runs the autotuner (``repro_torch.tune``) on that
device: the full-graph layout tile, materialization and op variants at
engine build, then the block-scale op variants on one warm training batch;
``--tune-cache`` names its persistent cache. ``--skew ALPHA`` draws the
seeds from a Zipf law over the train ids, with replacement (nominal
epochs of ``len(train ids) // batch`` steps). Every step replays the
train executor's captured CUDA graph of its bucketed signature on the
card, captured at the signature's second step (its first runs op by op);
``--eager`` runs every step op by op. ``--feature-store
{device,host,cached}`` / ``--feature-budget`` pick where the node-feature
table lives (``repro_torch.feats``; the cached tier's per-ntype split is
measured on the training stream): the store goes to the trainer, whose
loader attaches each batch's rows. With ``host`` or ``cached`` the
trainer never puts the whole table on the card, so the periodic and final
evaluations are sampled only (rows read through ``host_rows``) and
``--parity`` (a full-graph run) needs ``device``; the task's teacher
labels come from one full-graph forward while the task is made, before
the store exists.

``--dp N`` / ``--partitions P`` train data-parallel (``repro_torch.dist``,
``DistTrainer``): the graph is edge-cut into ``P`` shards (default one per
rank), every step runs each shard's block forward and backward, sums the
per-shard gradients over the gathered shard axis (the same bits at every
``N``) and takes one AdamW step; the final evaluation is full-graph. With
``N > 1`` the driver starts its ``N`` ranks itself
(``launch.mesh.launch_ranks``: ``cuda:r`` where there are ``N`` cards, the
one card otherwise, or the CPU with ``--device cpu``); rank 0 prints and
returns the stats, the final optimizer state among them. ``--max-steps``
stops such a run early. ``--parity``, ``--profile``, ``--ckpt-dir`` and
``--resume`` are refused with them, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.train_rgnn --device cpu \
        --model rgat --reduced --epochs 1 --dp 2 --partitions 4

    PYTHONPATH=src python -m repro_torch.launch.train_rgnn --device cpu \
        --model rgcn --reduced --feature-store cached --feature-budget 64

Telemetry (``repro_torch.obs``) mirrors ``serve_rgnn``: ``--obs on`` (the
default) trains inside a metrics scope (the ``train_step_ms`` histogram,
executor / sampler / tuner counters; ``stats["metrics"]``,
``--metrics-out``), ``--trace-out PATH`` adds the ``sample`` / ``layout``
/ ``train_step`` / ``execute`` phase spans as a Chrome trace, and
``--profile`` attributes one sampled SGD step on a representative batch
into forward / backward / optimizer (``obs.profile.profile_train_step``;
``stats["profile"]`` in ms). ``--obs off`` records nothing; losses are
the same in every mode.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import hector_torch
from repro_torch.core.graph import (CPU_REDUCED_SCALES,
                                    synthetic_heterograph, table3_graph)
from repro_torch.launch import obs_report, obs_scope
from repro_torch.launch.mesh import in_ranks, launch_ranks
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.sampling import EpochSeedStream, SeedStream
from repro_torch.train import (EngineConfig, MODEL_PROGRAMS, SampledTrainer,
                               parse_fanout, resolve_device)

# synthetic default workload (the example trainer's graph); --reduced scale
SYNTHETIC = dict(num_nodes=2000, num_edges=16000, num_ntypes=4,
                 num_etypes=16, target_compaction=0.5)
SYNTHETIC_REDUCED_SCALE = 0.2


def build_task(dataset: str, scale: float, cfg: EngineConfig, seed: int,
               val_frac: float = 0.2, log=None):
    """Graph, compiled engine, features and a learnable node-classification
    task: labels from a frozen teacher forward over the full graph
    (``log`` receives the tuner's lines, when ``cfg.tune`` is on)."""
    if dataset == "synthetic":
        graph = synthetic_heterograph(
            num_nodes=max(64, int(SYNTHETIC["num_nodes"] * scale)),
            num_edges=max(256, int(SYNTHETIC["num_edges"] * scale)),
            num_ntypes=SYNTHETIC["num_ntypes"],
            num_etypes=SYNTHETIC["num_etypes"], seed=seed,
            target_compaction=SYNTHETIC["target_compaction"])
    else:
        graph = table3_graph(dataset, scale=scale, seed=seed)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(graph.num_nodes, cfg.dim)).astype(np.float32)
    engine = hector_torch.compile(None, graph, config=cfg, log=log)
    teacher = engine.init(seed + 1)
    # one forward: nothing to replay, so nothing to capture
    logits = engine.apply(teacher, torch.from_numpy(feats).to(engine.device),
                          compiled=False)
    labels = torch.argmax(logits, dim=-1).cpu().numpy()
    perm = rng.permutation(graph.num_nodes)
    n_val = int(graph.num_nodes * val_frac)
    val_ids = np.sort(perm[:n_val]).astype(np.int32)
    train_ids = np.sort(perm[n_val:]).astype(np.int32)
    return engine, feats, labels, train_ids, val_ids


def train(
    model: str = "rgat",
    dataset: str = "synthetic",
    scale: float = 1.0,
    layers: int = 2,
    dim: int = 64,
    hidden: int = 64,
    classes: int = 8,
    fanouts=None,
    batch_size: int = 64,
    epochs: int = 3,
    lr: float = 1e-2,
    weight_decay: float = 0.0,
    warmup_steps: int = 5,
    tile: int = 32,
    node_block: int = 32,
    bucket: bool = True,
    seed: int = 0,
    val_frac: float = 0.2,
    ckpt_dir=None,
    ckpt_every: int = 0,
    resume: bool = False,
    eval_every_epochs: int = 0,
    parity: bool = False,
    parity_tol: float = 0.05,
    device=None,
    sampler: str = "host",
    feature_store: str = "device",
    feature_budget=None,
    tune: str = "off",
    tune_cache=None,
    skew=None,
    compiled: bool = True,
    obs_mode: str = "on",
    trace_out=None,
    metrics_out=None,
    profile: bool = False,
    dp: int = 1,
    partitions=None,
    max_steps=None,
    log=print,
):
    """Run the sampled training loop on ``device`` (``None``: the CUDA
    card); returns a stats dict (``SampledTrainer.train``'s, plus the
    final evaluation, full-graph with the ``device`` feature store and
    sampled with the others, the tuner's counts as ``tune_*``, the store's
    as ``feature_*`` and, with ``parity``, the comparison). ``skew`` as
    ``--skew``; ``feature_store`` / ``feature_budget`` as
    ``--feature-store`` / ``--feature-budget``; ``compiled=False`` as
    ``--eager``.

    Observability mirrors ``serve_rgnn.serve``: ``obs_mode="on"`` wraps
    the run in an ``obs.scope`` (``stats["metrics"]``, optional
    ``metrics_out`` export); ``trace_out`` adds phase tracing and writes a
    Chrome-trace JSON; ``profile=True`` attributes one sampled SGD step
    into forward / backward / optimizer (``stats["profile"]``, ms).

    ``dp`` / ``partitions`` train data-parallel (``DistTrainer``; with
    ``dp > 1`` on ``dp`` ranks this call starts, returning rank 0's
    stats); ``max_steps`` stops that run early."""
    if dp > 1 and not in_ranks():
        kw = {k: v for k, v in locals().items() if k not in ("device", "log")}
        return launch_ranks(train, dp, device, kw)
    if parity and feature_store != "device":
        raise ValueError("parity runs the full graph, which needs the "
                         "whole table on the device: feature_store='device'")
    with obs_scope(obs_mode, trace_out) as sc:
        dev = resolve_device(device)
        cfg = EngineConfig(model=model, layers=layers, dim=dim, hidden=hidden,
                           classes=classes, fanouts=fanouts, tile=tile,
                           node_block=node_block, bucket=bucket, seed=seed,
                           device=str(dev), sampler=sampler,
                           feature_store=feature_store,
                           feature_budget=feature_budget, tune=tune,
                           tune_cache=tune_cache, dp=dp,
                           partitions=partitions)
        engine, feats, labels, train_ids, val_ids = build_task(
            dataset, scale, cfg, seed, val_frac, log=log)
        log(f"[train_rgnn] {model} on {dataset} (scale {scale}): "
            f"{engine.graph.num_nodes} nodes, {engine.graph.num_edges} edges, "
            f"{engine.graph.num_etypes} etypes; fanouts={cfg.fanouts}, "
            f"device={dev}, sampler={sampler}, "
            f"feature_store={feature_store}"
            + (f", skew={skew}" if skew else "")
            + f", {len(train_ids)} train / {len(val_ids)} val nodes")

        # the schedule's length from the stream the trainer will iterate
        if skew is not None:
            bpe = max(1, len(train_ids) // batch_size)
        else:
            bpe = EpochSeedStream(train_ids, batch_size).batches_per_epoch
        total_steps = epochs * bpe
        opt = AdamW(learning_rate=cosine_schedule(lr, warmup_steps,
                                                  total_steps),
                    weight_decay=weight_decay)
        # the feature store; the cached tier's per-ntype split is measured
        # on the stream the trainer will iterate
        probe = (SeedStream(ids=train_ids, batch_size=batch_size,
                            seed=seed, zipf_alpha=skew) if skew is not None
                 else EpochSeedStream(train_ids, batch_size, seed=seed))
        store = engine.make_feature_store(feats, seed_source=probe)
        if feature_store == "cached":
            log(f"[train_rgnn] feature cache: {store.capacity} device rows "
                f"({store.device_bytes() / 1e6:.2f} MB vs full table "
                f"{store.table_bytes / 1e6:.2f} MB), per-ntype slots "
                f"{store.slot_ptr.tolist()}")
        if cfg.distributed:
            return _train_dist(engine, store, labels, train_ids, val_ids,
                               opt, epochs, batch_size, bpe, seed, parity,
                               profile, ckpt_dir, resume, compiled,
                               max_steps, sc, trace_out, metrics_out, log)
        trainer = SampledTrainer(engine, store, labels, train_ids, val_ids,
                                 opt=opt, ckpt_dir=ckpt_dir,
                                 compiled=compiled, log=log)
        state = trainer.init_state(engine.init(seed))

        if tune != "off":
            # block-scale tuning on one representative training batch (bucketed
            # shapes make the decisions valid for the whole epoch stream)
            warm_seeds = np.sort(np.random.default_rng(seed + 1).choice(
                train_ids, size=min(batch_size, len(train_ids)),
                replace=False)).astype(np.int32)
            tl = engine.make_loader(lambda step: warm_seeds, num_batches=1)
            try:
                # the store is read without changing its state
                engine.tune_minibatch(state.params, next(tl), store)
            finally:
                tl.close()
            ts = engine.tuner_stats
            log(f"[train_rgnn] tune={tune}: {ts['measurements']} "
                f"measurements, {ts['cache_hits']} cache replays, "
                f"{ts['tuned_ops']} tuned (tile {engine.tile}, "
                f"node_block {engine.node_block})")

        start_step = 0
        if resume:
            state, start_step = trainer.resume(state)
            if start_step:
                log(f"[train_rgnn] resumed from step {start_step} "
                    f"(epoch {start_step // bpe}, batch {start_step % bpe})")

        state, stats = trainer.train(
            state, epochs=epochs, batch_size=batch_size, start_step=start_step,
            ckpt_every=ckpt_every, eval_every_epochs=eval_every_epochs,
            log_every=max(1, bpe // 2), skew=skew)

        # full-graph where the table is on the device; a host / cached
        # store is evaluated sampled (rows read through host_rows)
        if trainer.tiered:
            kind = "sampled"
            final_train = trainer.evaluate_sampled(state.params, train_ids)
            final_val = (trainer.evaluate_sampled(state.params, val_ids)
                         if len(val_ids) else None)
        else:
            kind = "full"
            final_train = trainer.full.evaluate(state.params)
            final_val = (trainer.full.evaluate(state.params, val_ids)
                         if len(val_ids) else None)
        stats[f"{kind}_train_loss"] = final_train["loss"]
        stats[f"{kind}_train_acc"] = final_train["accuracy"]
        if final_val is not None:
            stats[f"{kind}_val_loss"] = final_val["loss"]
            stats[f"{kind}_val_acc"] = final_val["accuracy"]
        stats["device"] = str(dev)
        stats["sampler"] = sampler
        for k, v in engine.tuner_stats.items():
            stats[f"tune_{k}"] = v
        if engine.decisions is not None:
            stats["tune_decisions"] = engine.decisions.fingerprint()
        dev_sampler = engine.device_sampler
        if dev_sampler is not None:
            for k, v in dev_sampler.stats().items():
                stats[f"sampler_{k}"] = v
            log(f"[train_rgnn] device sampler: {dev_sampler.trace_count} new "
                f"programs / {dev_sampler.cache_hits} program-cache hits over "
                f"{dev_sampler.batches_sampled} batches; "
                f"{dev_sampler.bucket_shrinks} bucket shrinks, "
                f"{dev_sampler.bucket_overflows} overflows")
        log(f"[train_rgnn] sampled training done: {stats['steps']} steps, "
            f"step p50 {stats['step_ms_p50']:.1f} ms, "
            f"p99 {stats['step_ms_p99']:.1f} ms, "
            f"{stats['seeds_per_s']:.1f} seeds/s, "
            f"{stats['retraces_after_warmup']} new signatures after warmup "
            f"({stats['executor_compiled']} in all)")
        if feature_store != "device":
            log(f"[train_rgnn] feature store ({feature_store}): "
                f"{store.host_gathers} host gathers, "
                f"{store.bytes_moved / 1e6:.2f} MB moved"
                + (f", hit rate {store.hit_rate:.0%} "
                   f"({store.evictions} evictions, {store.overflows} "
                   f"overflows)" if feature_store == "cached" else ""))
        log(f"[train_rgnn] {'sampled' if trainer.tiered else 'full-graph'} "
            f"eval: train loss "
            f"{final_train['loss']:.4f} acc {final_train['accuracy']:.2%}"
            + (f" | val loss {final_val['loss']:.4f} "
               f"acc {final_val['accuracy']:.2%}" if final_val else ""))

        if parity:
            # dense baseline: same init, same optimizer-step budget; judged on
            # held-out loss (train loss, with no val split)
            fg = trainer.full
            fstate = fg.init_state(engine.init(seed))
            fstate, _ = fg.train(fstate, steps=total_steps,
                                 log_every=max(1, total_steps // 4))
            if len(val_ids):
                split, sampled_loss = "val", final_val["loss"]
                fg_loss = fg.evaluate(fstate.params, val_ids)["loss"]
            else:
                split, sampled_loss = "train", final_train["loss"]
                fg_loss = fg.evaluate(fstate.params)["loss"]
            gap = (sampled_loss - fg_loss) / max(fg_loss, 1e-6)
            stats["parity_full_graph_loss"] = fg_loss
            stats["parity_gap"] = gap
            ok = gap <= parity_tol
            log(f"[train_rgnn] parity ({split} loss): sampled "
                f"{sampled_loss:.4f} vs full-graph {fg_loss:.4f} "
                f"(gap {gap:+.1%}, tol {parity_tol:.0%}) -> "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(
                    f"sampled {split} loss {sampled_loss:.4f} not within "
                    f"{parity_tol:.0%} of full-graph {fg_loss:.4f}")

        if profile:
            # forward / backward / optimizer attribution of ONE sampled step,
            # on a representative (bucketed) batch off the epoch stream
            from repro_torch.feats import gather_input
            from repro_torch.obs import profile as prof_mod
            warm_seeds = np.sort(np.random.default_rng(seed + 2).choice(
                train_ids, size=min(batch_size, len(train_ids)),
                replace=False)).astype(np.int32)
            pl = engine.make_loader(lambda step: warm_seeds, num_batches=1)
            try:
                mb = next(pl)
            finally:
                pl.close()
            ph = prof_mod.profile_train_step(
                engine.plans, trainer.opt, state, mb,
                mb.seq.slice_labels(labels),
                gather_input(store, mb, read_only=True),
                activation=engine.cfg.activation, decisions=engine.decisions,
                warmup=1, iters=5)
            log(f"[train_rgnn] step attribution: "
                f"forward {ph['forward']*1e3:.2f} ms, "
                f"backward {ph['backward']*1e3:.2f} ms, "
                f"optimizer {ph['optimizer']*1e3:.2f} ms "
                f"(step {ph['total']*1e3:.2f} ms)")
            stats["profile"] = {k: v * 1e3 for k, v in ph.items()}
        obs_report(sc, stats, trace_out, metrics_out, log, "train_rgnn")
        return stats


def _train_dist(engine, store, labels, train_ids, val_ids, opt, epochs,
                batch_size, bpe, seed, parity, profile, ckpt_dir, resume,
                compiled, max_steps, sc, trace_out, metrics_out, log):
    """The data-parallel training loop (``--dp`` / ``--partitions``):
    sharded sampling and one multi-shard step per batch, metrics read
    once after the loop; the final evaluation runs the full-graph step.
    The stats carry the final optimizer state as ``final_state`` (numpy,
    ``tree_leaves`` order: params, mu, nu, step)."""
    if parity or profile or ckpt_dir or resume:
        raise ValueError("--parity/--profile/--ckpt-dir/--resume are not "
                         "supported together with --dp/--partitions")
    from repro_torch.dist import DistTrainer
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import FullGraphTrainer
    cfg = engine.cfg
    log(f"[train_rgnn] distributed: {cfg.num_partitions} shards over "
        f"{cfg.dp} ranks ({engine.data_mesh.backend or 'one process'})\n"
        + engine.partition.describe())
    trainer = DistTrainer(engine, store, labels, train_ids, val_ids,
                          opt=opt, compiled=compiled, log=log)
    state = trainer.init_state(engine.init(seed))
    state, stats = trainer.train(state, epochs=epochs,
                                 batch_size=batch_size,
                                 log_every=max(1, bpe // 2),
                                 max_steps=max_steps)

    full = FullGraphTrainer(engine, store, labels, train_ids, opt=opt,
                            compiled=compiled, log=log)
    final_train = full.evaluate(state.params)
    final_val = (full.evaluate(state.params, val_ids)
                 if len(val_ids) else None)
    stats["full_train_loss"] = final_train["loss"]
    stats["full_train_acc"] = final_train["accuracy"]
    if final_val is not None:
        stats["full_val_loss"] = final_val["loss"]
        stats["full_val_acc"] = final_val["accuracy"]
    stats["device"] = str(engine.device)
    stats["final_state"] = [t.cpu().numpy() for t in tree_leaves(state)]
    log(f"[train_rgnn] dist training done: {stats['steps']} steps on "
        f"{cfg.num_partitions} shards / {cfg.dp} ranks, "
        f"step p50 {stats['step_ms_p50']:.1f} ms, "
        f"{stats['seeds_per_s']:.1f} seeds/s, "
        f"{stats['retraces_after_warmup']} new keys after warmup "
        f"({stats['executor_compiled']} in all)")
    log(f"[train_rgnn] full-graph eval: train loss {final_train['loss']:.4f} "
        f"acc {final_train['accuracy']:.2%}"
        + (f" | val loss {final_val['loss']:.4f} "
           f"acc {final_val['accuracy']:.2%}" if final_val else ""))
    for k, v in store.stats().items():
        stats[f"feature_{k}"] = v
    obs_report(sc, stats, trace_out, metrics_out, log, "train_rgnn")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="rgat", choices=sorted(MODEL_PROGRAMS))
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic"] + sorted(CPU_REDUCED_SCALES))
    ap.add_argument("--reduced", action="store_true",
                    help="scale the dataset for CPU tractability")
    ap.add_argument("--scale", type=float, default=None,
                    help="explicit dataset scale factor (overrides --reduced)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--fanout", default="5",
                    help="per-hop fanout, e.g. '5' or '5,10'; -1 = full")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--node-block", type=int, default=32)
    ap.add_argument("--no-bucket", action="store_true")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks: shard the graph and run each "
                         "SGD step across all shards; N > 1 starts N ranks "
                         "(rank r on cuda:r with N cards, else on the one "
                         "card or --device cpu)")
    ap.add_argument("--partitions", type=int, default=None,
                    help="graph shard count (default: one per --dp rank; "
                         "a multiple of --dp folds extra shards onto ranks "
                         "with bit-identical results)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop a --dp / --partitions run after this many "
                         "steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-frac", type=float, default=0.2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N steps (0 disables)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--eval-every-epochs", type=int, default=1)
    ap.add_argument("--parity", action="store_true",
                    help="also run the full-graph trainer with the same "
                         "step budget and require the sampled loss within "
                         "--parity-tol of it")
    ap.add_argument("--parity-tol", type=float, default=0.05)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; fails without a card) or "
                         "'cpu'")
    ap.add_argument("--sampler", default="host", choices=["host", "device"],
                    help="'host': NumPy sampling and layouts on a loader "
                         "thread; 'device': the DeviceSampler on --device")
    ap.add_argument("--tune", default="off", choices=["off", "cached", "full"],
                    help="autotune on --device: 'full' measures what the "
                         "cache lacks, 'cached' replays it, 'off' keeps the "
                         "defaults")
    ap.add_argument("--tune-cache", default=None,
                    help="tuning cache path (default "
                         "$REPRO_TORCH_TUNE_CACHE or "
                         "~/.cache/repro_torch-tune.json)")
    ap.add_argument("--feature-store", default="device",
                    choices=["device", "host", "cached"],
                    help="where the node-feature table lives: 'device' = "
                         "the whole table on --device; 'host' = pinned "
                         "per-ntype host tables, only sampled rows copied; "
                         "'cached' = host tier + a fixed-budget hot-row "
                         "cache on --device (host / cached: evaluation is "
                         "sampled, --parity needs 'device')")
    ap.add_argument("--feature-budget", type=int, default=None,
                    help="device hot-row count for --feature-store cached "
                         "(default: num_nodes / 4); the per-ntype split is "
                         "measured on the training stream")
    ap.add_argument("--skew", type=float, default=None, metavar="ALPHA",
                    help="Zipf-skew the seed stream (rank probability "
                         "(r+1)^-ALPHA, with replacement)")
    ap.add_argument("--eager", action="store_true",
                    help="run every step op by op instead of replaying the "
                         "train executor's captured CUDA graphs")
    ap.add_argument("--obs", default="on", choices=["on", "off"],
                    help="observability: 'on' runs inside an obs scope "
                         "(metrics registry + stats['metrics']); 'off' "
                         "records nothing")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable phase tracing and write a Chrome-trace "
                         "JSON (load in chrome://tracing or Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="attribute one sampled SGD step into forward / "
                         "backward / optimizer phases")
    args = ap.parse_args(argv)

    if args.scale is not None:
        scale = args.scale
    elif args.reduced:
        scale = (SYNTHETIC_REDUCED_SCALE if args.dataset == "synthetic"
                 else CPU_REDUCED_SCALES[args.dataset])
    else:
        scale = 1.0
    return train(
        model=args.model, dataset=args.dataset, scale=scale,
        layers=args.layers, dim=args.dim, hidden=args.hidden,
        classes=args.classes,
        fanouts=parse_fanout(args.fanout, args.layers),
        batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        weight_decay=args.weight_decay, tile=args.tile,
        node_block=args.node_block, bucket=not args.no_bucket,
        seed=args.seed, val_frac=args.val_frac, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume,
        eval_every_epochs=args.eval_every_epochs, parity=args.parity,
        parity_tol=args.parity_tol, device=args.device,
        sampler=args.sampler, feature_store=args.feature_store,
        feature_budget=args.feature_budget, tune=args.tune,
        tune_cache=args.tune_cache,
        skew=args.skew, compiled=not args.eager, obs_mode=args.obs, trace_out=args.trace_out,
        metrics_out=args.metrics_out, profile=args.profile, dp=args.dp,
        partitions=args.partitions, max_steps=args.max_steps,
    )


if __name__ == "__main__":
    main()
