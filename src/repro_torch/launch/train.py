"""LM training driver of the PyTorch/CUDA port: the synthetic data
pipeline, the train step, asynchronous checkpoints, heartbeat / straggler
monitoring and the elastic restart drill (the port's counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 20 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 10 --batch 4 --seq 2048          # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch jamba-v0.1-52b --reduced --steps 6 --batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen3-4b --reduced --model-parallel 2 --dp 2 --steps 6

Every config of the registry trains: dense, MoE (the loss carries the
routers' load-balance term), Mamba2, the hybrid, and the cross-attention
configs (whisper-medium, llama-3.2-vision-11b), whose batches carry the
stream's stubbed ``frontend`` embeddings (cast to the model dtype by the
model).

Failure drill (``--simulate-failure N``): at step N the one host,
``"host0"``, stops heartbeating; the controller drains, replans the mesh
from the survivors, rebuilds the step, restores the last checkpoint and
resumes from its step on a fresh prefetch iterator. The data stream is a
pure function of the step, so no batch is skipped and the resumed losses
are the uninterrupted run's, bit for bit. ``--resume`` starts from the
latest checkpoint in ``--ckpt-dir``.

As in the reference, the step applies ``build_step``'s optimizer; the
driver's own ``AdamW(cosine_schedule(3e-4, 10, max(steps, 20)))`` only
initializes the state (the two share every hyperparameter but the
schedule, which ``init`` does not read). The step is built with
``remat=False``, as the reference driver builds it. ``--model-parallel N
--dp M`` trains on the ``plan_elastic_mesh(N * M, model_parallel=N)``
mesh, ``(M, N)`` over ``("data", "model")``, whose ranks the driver
starts itself (``launch.mesh.launch_ranks``): each rank holds its shards
of the state (``launch.steps.init_state``), every rank reads the same
global batch and the step takes its rows; checkpoints are written whole by
rank 0 and restored to each rank's shards, and the drill replans the same
mesh, re-meshes (new process groups) and restores on it. Without them the
plan is the one-device ``(1, 1)``. On a mesh ``--moe-ep``,
``--seq-shard-kv``, ``--bf16-reduce`` and ``--seq-shard`` (the reference's
``launch/dryrun.py`` names) set the perf variants v-B, v-C, v-D and v-E
(``launch/partitioning.py``). ``--device`` (default the card; it
raises without one) and ``--seed`` (weights and stream) are the port's, as
in ``launch/serve.py``; ``--ckpt-every 0`` saves nothing.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch import configs as C
from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import PrefetchIterator, SyntheticLMStream
from repro_torch.launch import partitioning as PT
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (in_ranks, launch_ranks, make_mesh,
                                     plan_elastic_mesh)
from repro_torch.launch.steps import build_step
from repro_torch.lm.config import LMConfig, ShapeCell
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.fault import (
    ElasticController, HeartbeatMonitor, StragglerPolicy,
)

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def train(cfg_or_arch: Union[str, LMConfig] = "qwen3-4b", *,
          reduced: bool = False, steps: int = 20, batch: int = 8,
          seq: int = 64, ckpt_dir: str = DEFAULT_CKPT_DIR,
          ckpt_every: int = 5, simulate_failure: int = -1,
          resume: bool = False, device=None, seed: int = 0,
          model_parallel: int = 1, dp: int = 1, pods: int = 1,
          part_kwargs: Optional[Dict] = None,
          log: Callable[[str], None] = print) -> Dict:
    """Train ``cfg_or_arch`` (a config, or an arch id: its full config, or
    its reduced one with ``reduced``) for ``steps`` steps of ``batch`` x
    ``seq`` tokens on ``device`` (``None``: the CUDA card). Returns the
    losses (the repeated step of a drill included), each step's wall ms
    (the host clock around the step, which ends in reading the loss), the
    final ``TrainState``, the start step, the controller's failure events,
    the plan, the tokens/s of the steps after the first (the warm-up:
    their tokens over the sum of their ms; ``None`` with fewer than two
    steps), the peak device memory (GiB, from the end of
    initialization; ``None`` on the CPU) and each step's ``moe_aux`` (the
    MoE layers' summed load-balance loss; 0 without MoE).

    ``model_parallel`` x ``dp`` above 1 trains on that mesh of ranks
    (started here unless this process is one of them); the result is rank
    0's, with every rank's peak GiB (``rank_peak_gib``), resident state
    bytes against its shards' (``resident``, ``launch.steps.resident``)
    and fp64 sum of each leaf (``state_digest``); its ``state`` is
    ``None`` (the shards stay on the ranks). ``pods`` above 1 (no driver
    flag: the reference's drivers build no pod mesh) trains on ``(pods,
    dp, model_parallel)`` ranks over ``("pod", "data", "model")``, the
    plan's (``plan_elastic_mesh(..., pods=)``). ``part_kwargs``: the
    mesh's ``Partitioner`` flags (the perf variants; ignored on one
    device)."""
    n = model_parallel * dp * pods
    if n > 1 and not in_ranks():
        return launch_ranks(train, n, device, dict(
            cfg_or_arch=cfg_or_arch, reduced=reduced, steps=steps,
            batch=batch, seq=seq, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
            simulate_failure=simulate_failure, resume=resume, seed=seed,
            model_parallel=model_parallel, dp=dp, pods=pods,
            part_kwargs=part_kwargs))
    if isinstance(cfg_or_arch, LMConfig):
        cfg = cfg_or_arch
    else:
        cfg = (C.get_reduced(cfg_or_arch) if reduced
               else C.get_config(cfg_or_arch))
    cell = ShapeCell("custom", seq, batch, "train")
    plan = plan_elastic_mesh(n, model_parallel=model_parallel, pods=pods)

    def build(plan):
        mesh = make_mesh(plan.shape, plan.axes, device) if n > 1 else None
        return mesh, build_step(cfg, cell, None if mesh else device,
                                mesh=mesh, remat=False,
                                part_kwargs=part_kwargs)
    mesh, bundle = build(plan)
    model, part = bundle.model, bundle.partitioner
    specs = ST.state_specs(part, model) if part else None
    dev = model.device
    log(f"[train] {cfg.name}: mesh={plan.shape} devices={plan.used_devices} "
        f"device={dev}")

    opt = AdamW(learning_rate=cosine_schedule(3e-4, 10, max(steps, 20)))
    g = torch.Generator(device=dev).manual_seed(seed)
    if part is not None:
        state = ST.init_state(opt, model, part, g)
    else:
        params = model.init(g)
        state = opt.init(params)
        del params
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    ckpt = Checkpointer(ckpt_dir, mesh=mesh)
    start_step = 0
    if resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state, shardings=specs)
        start_step = ckpt.latest_step()
        log(f"[train] resumed from step {start_step}")

    stream = SyntheticLMStream(cfg, cell, seed=seed)
    it = PrefetchIterator(stream, start_step=start_step)
    hosts = ["host0"]
    monitor = HeartbeatMonitor(hosts, timeout=1e9)
    policy = StragglerPolicy()
    controller = ElasticController(monitor, devices_per_host=n,
                                   model_parallel=plan.shape[-1])

    losses, step_ms, moe_aux = [], [], []
    step = start_step
    try:
        while step < steps:
            got_step, host_batch = next(it)
            if got_step != step:
                raise RuntimeError(f"the stream gave step {got_step} at "
                                   f"step {step}")
            t0 = time.perf_counter()
            data = {k: torch.as_tensor(v, device=dev)
                    for k, v in host_batch.items()}
            state, metrics = bundle.fn(state, data)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            moe_aux.append(float(metrics["moe_aux"]))
            step_ms.append(dt * 1e3)
            for h in hosts:
                monitor.heartbeat(h, step=step, step_time=dt)
            actions = policy.decide(monitor)
            if actions:
                log(f"[train] straggler actions: {actions}")

            if simulate_failure == step:
                log(f"[train] !! simulating host failure at step {step}")
                monitor.hosts["host0"].last_heartbeat = -1e12
                monitor.timeout = 1.0
                ev = controller.check(step)
                if ev is None:
                    raise RuntimeError("the controller saw no failure")
                # drain -> replan -> rebuild -> restore -> resume
                ckpt.wait()
                new_plan = plan_elastic_mesh(n, model_parallel=plan.shape[-1],
                                             pods=pods)
                mesh, bundle = build(new_plan)
                part = bundle.partitioner
                specs = ST.state_specs(part, model) if part else None
                ckpt.mesh = mesh
                restore_step = ckpt.latest_step()
                if restore_step is not None:
                    state = ckpt.restore(state, shardings=specs)
                    it.close()
                    step = restore_step
                    it = PrefetchIterator(stream, start_step=step)
                    log(f"[train] re-meshed to {new_plan.shape}, resumed at "
                        f"step {step}")
                monitor.timeout = 1e9
                monitor.heartbeat("host0")
                simulate_failure = -1
                continue

            step += 1
            if ckpt_every > 0 and step % ckpt_every == 0:
                ckpt.save(step, state, shardings=specs)   # async write
            if step % 5 == 0 or step == steps:
                log(f"[train] step {step:5d} loss {loss:.4f} "
                    + (f"moe_aux {moe_aux[-1]:.4f} " if cfg.num_experts
                       else "") + f"({dt * 1e3:.0f} ms)")
        ckpt.wait()
    finally:
        it.close()
    if losses:
        log(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
    warm = step_ms[1:]
    tok_s = batch * seq * len(warm) / (sum(warm) / 1e3) if warm else None
    out = {"arch": cfg.name, "losses": losses, "step_ms": step_ms,
           "state": state, "start_step": start_step,
           "events": controller.events, "plan": plan,
           "tokens_per_s": tok_s, "peak_mem_gib": peak, "moe_aux": moe_aux}
    if mesh is not None:
        peaks = mesh.all_gather(torch.tensor([peak or 0.0],
                                             dtype=torch.float64),
                                mesh.axis_names, 0)
        out["rank_peak_gib"] = peaks.tolist() if peak is not None else None
        out["resident"] = ST.resident(state, part, model)
        # every rank's fp64 sum of each of its leaves: a fingerprint of
        # the whole state for bitwise comparisons across runs
        out["state_digest"] = mesh.all_gather(torch.tensor(
            [[float(t.double().sum()) for t in tree_leaves(state)]],
            dtype=torch.float64), mesh.axis_names, 0).tolist()
        out["state"] = None
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=C.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=5,
                    help="save every N steps (0: never)")
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the model axis")
    ap.add_argument("--dp", type=int, default=1,
                    help="ranks on the data axis")
    PT.add_variant_flags(ap)
    args = ap.parse_args(argv)
    return train(args.arch, reduced=args.reduced, steps=args.steps,
                 batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every,
                 simulate_failure=args.simulate_failure, resume=args.resume,
                 device=args.device, seed=args.seed,
                 model_parallel=args.model_parallel, dp=args.dp,
                 part_kwargs=PT.variant_kwargs(args))["losses"]


if __name__ == "__main__":
    main()
