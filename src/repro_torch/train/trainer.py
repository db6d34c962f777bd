"""RGNN trainers of the port, as in ``repro.train.trainer``.

``SampledTrainer`` is neighbor-sampled SGD: an ``EpochSeedStream`` shuffles
the train ids without replacement every epoch, the prefetching
``MiniBatchLoader`` samples blocks and builds their layouts on a
background thread (epoch-keyed), and every mini-batch runs one
``BlockTrainExecutor.grad_and_update`` — block forward through the
gather-fused kernels, per-seed cross-entropy, backward through the
kernels' autograd Functions (K4, K5 and the traversal VJP), AdamW.
Periodic evaluation runs full-graph and sampled; checkpoints save
``(global step, TrainState)`` and resume mid-epoch bit for bit on the CPU
(the seed stream and the sampler are pure functions of the global step;
on the card the backward's sums run in a fixed order too, K11 and K7, and
two identical runs end bit for bit equal: ``chip_smoke.py`` phase 14 g).

``FullGraphTrainer`` is the dense baseline on ``StackTrainExecutor``: one
full-graph step per call. With full-neighborhood fanout the sampled step
reproduces its loss and gradients.

On a card both steps are captured (``core.executor``, ``compiled=True``,
the default): one CUDA graph per bucketed signature, captured at its
second call and replayed from then on. A replayed step returns the new state in its graph's buffers
(the reference's donated state), valid until the next step; the trainers
copy what they keep — checkpoints snapshot the state to host memory, the
periodic evaluations run before the next step, and ``train`` returns a
copy. ``compiled=False`` runs every step op by op. ``skew`` switches the
sampled trainer's seed stream to Zipf-skewed draws with replacement, as
the reference's.

Telemetry: every sampled step runs inside a ``train_step`` span and lands
in the ``train_step_ms`` histogram (``repro_torch.obs``); the step already
ends in a synchronize on a card, so neither adds one.

Feature stores (``repro_torch.feats``): both trainers take a raw ``[N,
dim]`` table or a store. ``SampledTrainer`` hands a store to its loader,
which attaches each batch's rows (the store's stats come back as
``feature_*``); sampled evaluation reads rows through ``host_rows``
without touching the store's state (the producer owns it).
``FullGraphTrainer`` takes the whole table from ``full_table()``: the
full-graph path needs it on the device, which defeats tiering by design,
so a sampled trainer over a ``host`` or ``cached`` store evaluates sampled
only and never builds it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import executor
from repro_torch.feats import gather_input, is_feature_store
from repro_torch.optim import AdamW, TrainState
from repro_torch.optim.adamw import tree_map
from repro_torch.sampling import EpochSeedStream, SeedStream, build_minibatch
from repro_torch.train.engine import RGNNEngine


# LRU capacity of the sampled trainer's kernel-layout cache (the
# reference trainer's default)
LAYOUT_CACHE = 128


def _quiet(*_a, **_k):
    pass


class FullGraphTrainer:
    """Full-graph SGD over ``StackTrainExecutor`` (captured on a card unless
    ``compiled=False``); ``feats`` is the table or a feature store (its
    ``full_table()``)."""

    def __init__(self, engine: RGNNEngine, feats, labels, train_ids,
                 *, opt: Optional[AdamW] = None, compiled: bool = True,
                 log=print):
        self.engine = engine
        self.compiled = compiled
        self.opt = opt or AdamW(learning_rate=3e-3, weight_decay=0.01)
        self.feats = (feats.full_table() if is_feature_store(feats)
                      else torch.as_tensor(feats).to(engine.device))
        self.labels = np.asarray(labels)
        self.train_ids = np.asarray(train_ids, dtype=np.int32)
        self.log = log or _quiet
        self.step_exec = executor.StackTrainExecutor(
            engine.plans, self.opt, activation=engine.cfg.activation,
            decisions=engine.decisions)
        self._idx = self._device(self.train_ids)
        self._labels_train = self._device(self.labels[self.train_ids])

    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.engine.device)

    def init_state(self, params) -> TrainState:
        return self.opt.init(params)

    def step(self, state: TrainState):
        return self.step_exec.grad_and_update(
            state, self.engine.gt, self.engine.layouts, self._idx,
            self._labels_train, {"feature": self.feats},
            compiled=self.compiled)

    def train(self, state: TrainState, steps: int, log_every: int = 0):
        losses: List[float] = []
        for i in range(steps):
            state, metrics = self.step(state)
            losses.append(float(metrics["loss"]))
            if log_every and (i + 1) % log_every == 0:
                self.log(f"[train_full] step {i+1:4d} loss {losses[-1]:.4f} "
                         f"acc {float(metrics['accuracy']):.2%}")
        # a replayed step's state lives in its graph's buffers
        return tree_map(torch.clone, state), losses

    def evaluate(self, params, ids=None) -> Dict[str, float]:
        ids = self.train_ids if ids is None else np.asarray(ids, np.int32)
        m = self.step_exec.evaluate(
            params, self.engine.gt, self.engine.layouts, self._device(ids),
            self._device(self.labels[ids]), {"feature": self.feats})
        return {k: float(v) for k, v in m.items()}


class SampledTrainer:
    """Neighbor-sampled SGD on the block executor's train step."""

    def __init__(
        self,
        engine: RGNNEngine,
        feats,
        labels,
        train_ids,
        val_ids=None,
        *,
        opt: Optional[AdamW] = None,
        ckpt_dir: Optional[str] = None,
        compiled: bool = True,
        log=print,
    ):
        self.engine = engine
        self.compiled = compiled
        self.opt = opt or AdamW(learning_rate=3e-3, weight_decay=0.01)
        # a store stays a store: the sampled path reads only batch rows
        # through it, so a host / cached store keeps the table off the card
        self.feats = feats if is_feature_store(feats) else \
            torch.as_tensor(feats).to(engine.device)
        self.labels = np.asarray(labels)
        self.train_ids = np.asarray(train_ids, dtype=np.int32)
        # an empty val split means "no validation", not a zero-row eval
        self.val_ids = (np.asarray(val_ids, dtype=np.int32)
                        if val_ids is not None and len(val_ids) else None)
        self.log = log or _quiet
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        # shared with the compile facade: same opt -> same executor
        self.step_exec = engine.train_executor(self.opt)
        self._full = None

    @property
    def tiered(self) -> bool:
        """True for a ``host`` or ``cached`` store: the table is not on the
        device, and the trainer never puts it there."""
        return is_feature_store(self.feats) and self.feats.kind != "device"

    @property
    def full(self) -> FullGraphTrainer:
        """The full-graph evaluator, built on first use."""
        if self._full is None:
            self._full = FullGraphTrainer(
                self.engine, self.feats, self.labels, self.train_ids,
                opt=self.opt, compiled=self.compiled, log=self.log)
        return self._full

    def init_state(self, params) -> TrainState:
        return self.opt.init(params)

    def resume(self, state: TrainState):
        """Restore the latest checkpoint (if any) into ``state``'s
        structure; returns ``(state, start_step)``."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return state, 0
        step = self.ckpt.latest_step()
        return self.ckpt.restore(state), step

    def _labels_of(self, mb) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            mb.seq.slice_labels(self.labels))).to(self.engine.device)

    def train(
        self,
        state: TrainState,
        *,
        epochs: int = 1,
        batch_size: int = 32,
        start_step: int = 0,
        ckpt_every: int = 0,
        eval_every_epochs: int = 0,
        warmup_epochs: int = 1,
        log_every: int = 0,
        skew: Optional[float] = None,
    ):
        """Run ``epochs`` of neighbor-sampled SGD; returns
        ``(state, stats)``, the state a copy. ``start_step`` (a global
        step, e.g. from ``resume``) may land mid-epoch: the stream replays
        the exact remaining batches of that epoch.

        ``skew`` switches the seed stream to Zipf-skewed sampling with
        replacement over the train ids (``SeedStream(zipf_alpha=)``), as
        the reference's: an "epoch" is then nominal (``len(train_ids) //
        batch_size`` steps), and neighborhoods still resample every step
        (the sampler is keyed by the global step)."""
        sseed = self.engine.cfg.seed
        if skew is not None:
            stream = SeedStream(ids=self.train_ids, batch_size=batch_size,
                                seed=sseed, zipf_alpha=skew)
            bpe = max(1, len(self.train_ids) // stream.batch_size)
        else:
            stream = EpochSeedStream(self.train_ids, batch_size, seed=sseed)
            bpe = stream.batches_per_epoch
        total_steps = epochs * bpe
        if start_step >= total_steps:
            raise ValueError(f"start_step {start_step} beyond "
                             f"{epochs} epochs x {bpe} batches")
        warmup_steps = start_step + min(warmup_epochs * bpe,
                                        total_steps - start_step)
        loader = self.engine.make_loader(
            stream, start_step=start_step,
            num_batches=total_steps - start_step,
            cache_layouts=LAYOUT_CACHE,
            feature_store=self.feats if is_feature_store(self.feats)
            else None)

        ex = self.step_exec
        sync = (torch.cuda.synchronize if self.engine.device.type == "cuda"
                else (lambda: None))
        losses: List[float] = []
        accs: List[float] = []
        step_times: List[float] = []
        evals: List[Dict] = []
        traces_at_warmup = None
        t_train0 = time.perf_counter()
        try:
            for mb in loader:
                step = mb.step
                if traces_at_warmup is None and step >= warmup_steps:
                    traces_at_warmup = ex.trace_count
                labels_b = self._labels_of(mb)
                # the loader-attached rows (a store), else the table's
                feats_b = gather_input(self.feats, mb)
                t0 = time.perf_counter()
                # one step (a graph replay once its signature was
                # captured); forward / backward / optimizer attribution is
                # obs.profile.profile_train_step's (and the profiler's
                # record_function ranges, op by op)
                with obs.span("train_step", step=step):
                    state, metrics = ex.grad_and_update(
                        state, mb, labels_b, feats_b,
                        compiled=self.compiled)
                    sync()
                dt = time.perf_counter() - t0
                obs.metrics().histogram("train_step_ms").observe(dt * 1e3)
                loss = float(metrics["loss"])
                step_times.append(dt)
                losses.append(loss)
                accs.append(float(metrics["accuracy"]))
                if log_every and (step + 1) % log_every == 0:
                    self.log(f"[train_rgnn] step {step+1:5d} "
                             f"loss {loss:.4f} acc {accs[-1]:.2%} "
                             f"({step_times[-1]*1e3:.1f} ms)")
                if self.ckpt is not None and ckpt_every \
                        and (step + 1) % ckpt_every == 0:
                    # snapshots the state to host memory before returning
                    self.ckpt.save(step + 1, state)
                if (step + 1) % bpe == 0:
                    epoch = (step + 1) // bpe
                    span = losses[-min(len(losses), bpe):]
                    self.log(f"[train_rgnn] epoch {epoch}/{epochs}: "
                             f"mean loss {np.mean(span):.4f}")
                    if eval_every_epochs and epoch % eval_every_epochs == 0:
                        # runs before the next step changes the state
                        evals.append(self._periodic_eval(state, epoch))
        finally:
            loader.close()
        # a replayed step's state lives in its graph's buffers
        state = tree_map(torch.clone, state)
        t_total = time.perf_counter() - t_train0
        if traces_at_warmup is None:
            traces_at_warmup = ex.trace_count
        if self.ckpt is not None:
            self.ckpt.wait()

        n = len(losses)
        stats = {
            "steps": n,
            "start_step": start_step,
            "batches_per_epoch": bpe,
            "epochs": epochs,
            "batch_size": stream.batch_size,
            "losses": losses,
            "accuracies": accs,
            "final_loss": losses[-1] if losses else float("nan"),
            "step_ms_p50": float(np.percentile(step_times, 50) * 1e3)
            if step_times else float("nan"),
            "step_ms_p99": float(np.percentile(step_times, 99) * 1e3)
            if step_times else float("nan"),
            "seeds_per_s": stream.batch_size * n / max(t_total, 1e-9),
            "executor_traces": ex.trace_count,
            "executor_cache_hits": ex.cache_hits,
            "executor_compiled": ex.num_compiled,
            "executor_captures": ex.captures,
            "executor_replays": ex.replays,
            "retraces_after_warmup": ex.trace_count - traces_at_warmup,
            "warmup_steps": warmup_steps,
            "evals": evals,
        }
        for name, cs in loader.cache_stats().items():
            stats[f"{name}_hits"] = cs["hits"]
            stats[f"{name}_misses"] = cs["misses"]
            stats[f"{name}_hit_rate"] = cs["hit_rate"]
        if is_feature_store(self.feats):
            for k, v in self.feats.stats().items():
                stats[f"feature_{k}"] = v
        return state, stats

    def _periodic_eval(self, state: TrainState, epoch: int) -> Dict:
        out = {"epoch": epoch}
        ids = self.val_ids if self.val_ids is not None else self.train_ids
        split = "val" if self.val_ids is not None else "train"
        line = ""
        if not self.tiered:
            full = self.full.evaluate(state.params, ids)
            out[f"full_{split}"] = full
            line = (f"full-graph {split} loss {full['loss']:.4f} "
                    f"acc {full['accuracy']:.2%} | ")
        sampled = self.evaluate_sampled(state.params, ids, epoch=epoch)
        out[f"sampled_{split}"] = sampled
        self.log(f"[train_rgnn]   eval@{epoch}: {line}sampled {split} "
                 f"loss {sampled['loss']:.4f} "
                 f"acc {sampled['accuracy']:.2%}")
        return out

    def evaluate_sampled(self, params, ids, *, batch_size: int = 64,
                         epoch: int = 0) -> Dict[str, float]:
        """Sampled-forward loss and accuracy over ``ids`` with the engine's
        fanouts (batched, in id order, fresh neighborhoods). A store's
        rows are read through ``host_rows``: periodic evaluation may run
        while the loader's producer owns the store's state."""
        ids = np.asarray(ids, dtype=np.int32)
        cfg = self.engine.cfg
        tot_loss, tot_acc, nb = 0.0, 0.0, 0
        for lo in range(0, len(ids), batch_size):
            chunk = ids[lo:lo + batch_size]
            seq = self.engine.sampler.sample(chunk, batch_index=lo,
                                             epoch=epoch)
            mb = build_minibatch(seq, step=lo, tile=cfg.tile,
                                 node_block=cfg.node_block, bucket=cfg.bucket,
                                 device=self.engine.device)
            mb = dataclasses.replace(mb, feats=gather_input(
                self.feats, mb, read_only=True))
            logits = self.engine.forward_minibatch(params, mb, self.feats,
                                                   compiled=self.compiled)
            loss, acc = executor.softmax_xent(logits, torch.from_numpy(
                self.labels[chunk]).to(self.engine.device))
            tot_loss += float(loss) * len(chunk)
            tot_acc += float(acc) * len(chunk)
            nb += len(chunk)
        return {"loss": tot_loss / max(nb, 1),
                "accuracy": tot_acc / max(nb, 1)}
