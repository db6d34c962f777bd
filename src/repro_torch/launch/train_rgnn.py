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
Feature stores, Zipf-skewed streams, autotuning, telemetry and data
parallelism are later slices.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import hector_torch
from repro_torch.core.graph import (CPU_REDUCED_SCALES,
                                    synthetic_heterograph, table3_graph)
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.sampling import EpochSeedStream
from repro_torch.train import (EngineConfig, MODEL_PROGRAMS, SampledTrainer,
                               parse_fanout, resolve_device)

# synthetic default workload (the example trainer's graph); --reduced scale
SYNTHETIC = dict(num_nodes=2000, num_edges=16000, num_ntypes=4,
                 num_etypes=16, target_compaction=0.5)
SYNTHETIC_REDUCED_SCALE = 0.2


def build_task(dataset: str, scale: float, cfg: EngineConfig, seed: int,
               val_frac: float = 0.2):
    """Graph, compiled engine, features and a learnable node-classification
    task: labels from a frozen teacher forward over the full graph."""
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
    engine = hector_torch.compile(None, graph, config=cfg)
    teacher = engine.init(seed + 1)
    logits = engine.apply(teacher, torch.from_numpy(feats).to(engine.device))
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
    log=print,
):
    """Run the sampled training loop on ``device`` (``None``: the CUDA
    card); returns a stats dict (``SampledTrainer.train``'s, plus the
    final full-graph evaluation and, with ``parity``, the comparison)."""
    dev = resolve_device(device)
    cfg = EngineConfig(model=model, layers=layers, dim=dim, hidden=hidden,
                       classes=classes, fanouts=fanouts, tile=tile,
                       node_block=node_block, bucket=bucket, seed=seed,
                       device=str(dev), sampler=sampler)
    engine, feats, labels, train_ids, val_ids = build_task(
        dataset, scale, cfg, seed, val_frac)
    log(f"[train_rgnn] {model} on {dataset} (scale {scale}): "
        f"{engine.graph.num_nodes} nodes, {engine.graph.num_edges} edges, "
        f"{engine.graph.num_etypes} etypes; fanouts={cfg.fanouts}, "
        f"device={dev}, sampler={sampler}, {len(train_ids)} train / "
        f"{len(val_ids)} val nodes")

    bpe = EpochSeedStream(train_ids, batch_size).batches_per_epoch
    total_steps = epochs * bpe
    opt = AdamW(learning_rate=cosine_schedule(lr, warmup_steps, total_steps),
                weight_decay=weight_decay)
    trainer = SampledTrainer(engine, feats, labels, train_ids, val_ids,
                             opt=opt, ckpt_dir=ckpt_dir, log=log)
    state = trainer.init_state(engine.init(seed))

    start_step = 0
    if resume:
        state, start_step = trainer.resume(state)
        if start_step:
            log(f"[train_rgnn] resumed from step {start_step} "
                f"(epoch {start_step // bpe}, batch {start_step % bpe})")

    state, stats = trainer.train(
        state, epochs=epochs, batch_size=batch_size, start_step=start_step,
        ckpt_every=ckpt_every, eval_every_epochs=eval_every_epochs,
        log_every=max(1, bpe // 2))

    final_train = trainer.full.evaluate(state.params)
    final_val = (trainer.full.evaluate(state.params, val_ids)
                 if len(val_ids) else None)
    stats["full_train_loss"] = final_train["loss"]
    stats["full_train_acc"] = final_train["accuracy"]
    if final_val is not None:
        stats["full_val_loss"] = final_val["loss"]
        stats["full_val_acc"] = final_val["accuracy"]
    stats["device"] = str(dev)
    stats["sampler"] = sampler
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
    log(f"[train_rgnn] full-graph eval: train loss {final_train['loss']:.4f} "
        f"acc {final_train['accuracy']:.2%}"
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
        sampler=args.sampler,
    )


if __name__ == "__main__":
    main()
