"""Data-parallel trainer: sharded sampling + one multi-shard step per batch
(the port's ``repro.dist.trainer``).

The loop mirrors ``train.trainer.SampledTrainer`` — an ``EpochSeedStream``
shuffles the train ids, each batch becomes one ``grad_and_update`` — but
each step is the ``ShardedTrainExecutor``'s: per-shard forwards, the
halo-feature all-gather, backward, the gradient sum over the gathered
shard axis and the optimizer update (captured as one CUDA graph per key at
``dp = 1`` on a card).

Metrics stay device tensors until training finishes: ``float()`` on a
fresh loss would read it back every step, so they are read once, after
the loop. Each step sits in a ``dist_train_step`` span; on a card the
step's time is taken after a device synchronize (no metric is read).
``log_every`` deliberately reads the loss every N steps.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.optim import AdamW, TrainState
from repro_torch.optim.adamw import tree_map
from repro_torch.sampling import EpochSeedStream


def _quiet(*_a, **_k):
    pass


class DistTrainer:
    """Neighbor-sampled data-parallel SGD over a partitioned graph."""

    def __init__(self, engine, feats, labels, train_ids, val_ids=None, *,
                 opt: Optional[AdamW] = None, compiled: bool = True,
                 log=print):
        engine._require_dist()
        self.engine = engine
        self.compiled = compiled
        self.opt = opt or AdamW(learning_rate=3e-3, weight_decay=0.01)
        self.labels = np.asarray(labels)
        self.train_ids = np.asarray(train_ids, dtype=np.int32)
        self.val_ids = (np.asarray(val_ids, dtype=np.int32)
                        if val_ids is not None and len(val_ids) else None)
        self.log = log or _quiet
        self.batcher = engine.dist_batcher
        self.step_exec = engine.dist_train_executor(self.opt)
        self.own_feats = engine.shard_features(feats)

    def init_state(self, params) -> TrainState:
        return self.opt.init(params)

    # ------------------------------------------------------------------
    def train(self, state: TrainState, *, epochs: int = 1,
              batch_size: int = 32, stream_seed: Optional[int] = None,
              warmup_epochs: int = 1, log_every: int = 0,
              max_steps: Optional[int] = None):
        """Run ``epochs`` of data-parallel sampled SGD (at most
        ``max_steps`` steps); returns ``(state, stats)``, the state a copy.
        Metrics are read once, after the loop."""
        stream = EpochSeedStream(
            self.train_ids, batch_size,
            seed=self.engine.cfg.seed if stream_seed is None else stream_seed)
        bpe = stream.batches_per_epoch
        total_steps = epochs * bpe
        if max_steps is not None:
            total_steps = min(total_steps, max_steps)
        warmup_steps = min(warmup_epochs * bpe, total_steps)

        ex = self.step_exec
        dev = self.engine.device
        sync = (lambda: torch.cuda.synchronize(dev)) \
            if dev.type == "cuda" else (lambda: None)
        loss_dev: List[torch.Tensor] = []
        acc_dev: List[torch.Tensor] = []
        step_times: List[float] = []
        traces_at_warmup = None
        t0_all = time.perf_counter()
        for step in range(total_steps):
            if traces_at_warmup is None and step >= warmup_steps:
                traces_at_warmup = ex.trace_count
            seeds = stream.batch(step)
            smb = self.batcher.build(seeds, step=step,
                                     epoch=stream.epoch_of(step))
            t0 = time.perf_counter()
            with obs.span("dist_train_step", step=step):
                state, metrics = ex.grad_and_update(
                    state, smb, self.labels, self.own_feats,
                    compiled=self.compiled)
                sync()
            step_times.append(time.perf_counter() - t0)
            loss_dev.append(metrics["loss"])    # a device tensor: no read
            acc_dev.append(metrics["accuracy"])
            if log_every and (step + 1) % log_every == 0:
                self.log(f"[train_dist] step {step+1:5d} "
                         f"loss {float(metrics['loss']):.4f} "
                         f"acc {float(metrics['accuracy']):.2%}")
        # a replayed step's state lives in its graph's buffers
        state = tree_map(torch.clone, state)
        t_total = time.perf_counter() - t0_all
        if traces_at_warmup is None:
            traces_at_warmup = ex.trace_count

        losses = [float(x) for x in loss_dev]   # one read, at the end
        accs = [float(x) for x in acc_dev]
        stats = {
            "steps": total_steps,
            "batches_per_epoch": bpe,
            "epochs": epochs,
            "batch_size": stream.batch_size,
            "num_partitions": self.engine.cfg.num_partitions,
            "dp": self.engine.cfg.dp,
            "losses": losses,
            "accuracies": accs,
            "final_loss": losses[-1] if losses else float("nan"),
            "step_ms_p50": float(np.percentile(step_times, 50) * 1e3)
            if step_times else float("nan"),
            "seeds_per_s": stream.batch_size * total_steps
            / max(t_total, 1e-9),
            "executor_traces": ex.trace_count,
            "executor_cache_hits": ex.cache_hits,
            "executor_compiled": ex.num_compiled,
            "executor_captures": ex.captures,
            "executor_replays": ex.replays,
            "retraces_after_warmup": ex.trace_count - traces_at_warmup,
            "warmup_steps": warmup_steps,
            **{f"batcher_{k}": v for k, v in self.batcher.stats().items()},
        }
        return state, stats

    # ------------------------------------------------------------------
    def evaluate(self, params, ids=None, *, batch_size: int = 64,
                 epoch: int = 0) -> Dict[str, float]:
        """Sampled loss/accuracy over ``ids`` through the multi-shard serve
        step (fresh neighborhoods, id order)."""
        from repro_torch.core.executor import softmax_xent
        ids = np.asarray(self.val_ids if ids is None else ids, np.int32)
        serve = self.engine.dist_serve_executor()
        tot_loss, tot_acc, n = 0.0, 0.0, 0
        for lo in range(0, len(ids), batch_size):
            chunk = ids[lo:lo + batch_size]
            smb = self.batcher.build(chunk, step=lo, epoch=epoch)
            logits = serve.run_minibatch(params, smb, self.own_feats,
                                         compiled=self.compiled)
            loss, acc = softmax_xent(logits, torch.from_numpy(
                self.labels[chunk].astype(np.int64)).to(logits.device))
            tot_loss += float(loss) * len(chunk)
            tot_acc += float(acc) * len(chunk)
            n += len(chunk)
        return {"loss": tot_loss / max(n, 1), "accuracy": tot_acc / max(n, 1)}
