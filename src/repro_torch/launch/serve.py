"""Batched LM serving driver of the PyTorch/CUDA port: prefill a prompt
batch into a cache (K/V for attention, the conv window and state for
Mamba), then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --batch 8 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --arch jamba-v0.1-52b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --arch whisper-medium
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --arch qwen3-4b --model-parallel 2 --dp 2

Each of ``--batch`` rows gets a random prompt of ``--prompt-len`` tokens
(numpy, seeded), which is prefilled into a cache of ``prompt_len + gen``
positions; the first generated token comes from the prompt's last
position, and ``gen - 1`` decode steps follow at positions ``prompt_len,
prompt_len + 1, ...``, each feeding back the previous step's greedy token.
(The reference driver, ``repro.launch.serve``, draws and prefills
``prompt_len + gen`` tokens and then decodes from ``prompt_len``; the port
does what both docstrings describe.) Weights are random, from ``--seed``.
A config with cross-attention gets the reference's stubbed frontend: normal
embeddings ``[batch, encoder_seq, d_model]`` (whisper's encoder frames) or
``[batch, frontend_tokens, frontend_dim]`` (llama-vision's image patches),
drawn after the prompts from the same generator, which the prefill takes
(cast to the model dtype) and the decode steps read from the cross cache.
Prints the reference driver's line (prefill ms, decode ms, tok/s, a sample
row) and the peak device memory. ``--model-parallel N --dp M`` serves on a
``(M, N)`` mesh of ``("data", "model")`` ranks, which the driver starts
itself (``launch.mesh.launch_ranks``): each rank draws the weights whole,
one leaf at a time, and keeps its shards, prefills its rows of the batch
through ``launch.steps.build_step``'s prefill step and decodes through its
decode step (the weights resharded where the decode's rules differ); the
logits are replicated, so every rank feeds back the same tokens;
``--moe-ep``, ``--seq-shard-kv``, ``--bf16-reduce`` and ``--seq-shard``
set the perf variants v-B, v-C, v-D and v-E (``launch/partitioning.py``).
Every
config of the
registry serves: dense, MoE, Mamba2, the hybrid, the vision-language and
the encoder-decoder one (``lm/model.py``). A Mamba config's prompt needs
at least ``ssm_conv - 1`` tokens.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.launch import partitioning as PT
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (in_ranks, launch_ranks, make_mesh,
                                     plan_elastic_mesh)
from repro_torch.lm.config import LMConfig, ShapeCell
from repro_torch.lm.model import TransformerLM


def stub_frontend(cfg: LMConfig, batch: int,
                  rng: np.random.Generator) -> Optional[np.ndarray]:
    """``repro.launch.serve``'s stubbed frontend for ``cfg``, float32 normal
    from ``rng``: ``[batch, encoder_seq, d_model]`` with an encoder,
    ``[batch, frontend_tokens, frontend_dim]`` with image patches, else
    ``None``."""
    if cfg.encoder_layers:
        shape = (batch, cfg.encoder_seq, cfg.d_model)
    elif cfg.frontend_tokens:
        shape = (batch, cfg.frontend_tokens, cfg.frontend_dim)
    else:
        return None
    return rng.normal(size=shape).astype(np.float32)


def serve_steps(cfg: LMConfig, batch: int, cache_len: int, *, device=None,
                mesh=None, part_kwargs=None):
    """The prefill and decode ``StepBundle`` of one cache of ``cache_len``
    positions (``launch.steps.build_step``): on ``device``, or with
    ``mesh`` on this rank's shards."""
    return tuple(ST.build_step(cfg, ShapeCell(f"serve_{mode}", cache_len,
                                              batch, mode), device,
                               mesh=mesh, remat=False,
                               part_kwargs=part_kwargs)
                 for mode in ("prefill", "decode"))


def generate(pre, dec, params: Dict, prompts: torch.Tensor, gen: int, *,
             frontend: Optional[torch.Tensor] = None,
             keep_logits: bool = False) -> Dict:
    """Prefill ``prompts [B, P]`` (and the ``frontend`` of a config with
    cross-attention) through ``pre``, then ``gen - 1`` greedy decode steps
    through ``dec``: the ``serve_steps`` of a cache of ``P + gen``
    positions. On a mesh ``params`` are the rank's shards under ``pre``'s
    rules, resharded to ``dec``'s after the prefill where they differ (the
    caches too: v-C's decode splits them on the sequence), and
    ``prompts`` / ``frontend`` the whole batch. Returns the generated
    tokens ``[B, gen]`` (on the host), the prefill and decode wall times
    (each ending in a device synchronize), the caches after the last step
    (the rank's shards on a mesh) and, with ``keep_logits``, each step's
    last-position logits ``[B, V]`` (on the device; every rank's on a
    mesh)."""
    if gen < 1:
        raise ValueError(f"gen={gen} must be >= 1")
    dev = prompts.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    plen = prompts.shape[1]
    sync()
    t0 = time.perf_counter()
    logits, caches = pre.fn(params, prompts, frontend)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    sync()
    t_pre = time.perf_counter() - t0
    part = pre.partitioner
    if part is not None:        # the decode's rules where they differ
        params = ST.reshard(params, ST.param_specs(part, pre.model),
                            ST.param_specs(dec.partitioner, dec.model),
                            part.mesh)
        a_cache = dec.abstract_args[3]
        caches = ST.reshard(caches, ST.cache_specs(part, a_cache),
                            ST.cache_specs(dec.partitioner, a_cache),
                            part.mesh)
    tokens, kept = [tok], [logits[:, -1]] if keep_logits else None
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = dec.fn(params, tok, plen + i, caches)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        tokens.append(tok)
        if keep_logits:
            kept.append(logits[:, -1])
    sync()
    t_dec = time.perf_counter() - t0
    return {"tokens": torch.cat(tokens, dim=1).cpu().numpy(),
            "prefill_s": t_pre, "decode_s": t_dec, "logits": kept,
            "caches": caches}


def serve(arch: Union[str, LMConfig] = "gemma2-2b", *, reduced: bool = False,
          batch: int = 4, prompt_len: int = 32, gen: int = 16, seed: int = 0,
          device=None, keep_logits: bool = False, model_parallel: int = 1,
          dp: int = 1, pods: int = 1, part_kwargs: Optional[Dict] = None,
          log: Callable[[str], None] = print) -> Dict:
    """Serve one prompt batch of ``arch`` (a config, or an arch id: its
    full config, or its reduced one with ``reduced``) on ``device``
    (``None``: the CUDA card), the weights and prompts drawn from
    ``seed`` (the frontend of a config with cross-attention too). Returns
    the prompts, the frontend (numpy, ``None`` without one), the generated
    tokens, the times, tok/s, the peak device memory from the end of
    initialization on (GiB, the weights included; ``None`` on the CPU)
    and, with ``keep_logits``, each step's logits. ``model_parallel`` x
    ``dp`` above 1 serves on that mesh of ranks (started here unless this
    process is one of them): the result is rank 0's, its logits on the
    host, with every rank's peak GiB (``rank_peak_gib``). ``pods`` above 1
    (no driver flag, as in ``launch.train.train``) serves on ``(pods, dp,
    model_parallel)`` ranks over ``("pod", "data", "model")``; the mesh
    is the plan's (``plan_elastic_mesh(..., pods=)``), as training's.
    ``part_kwargs``: the mesh's ``Partitioner`` flags (the perf
    variants)."""
    n = model_parallel * dp * pods
    if n > 1 and not in_ranks():
        return launch_ranks(serve, n, device, dict(
            arch=arch, reduced=reduced, batch=batch, prompt_len=prompt_len,
            gen=gen, seed=seed, keep_logits=keep_logits,
            model_parallel=model_parallel, dp=dp, pods=pods,
            part_kwargs=part_kwargs))
    if isinstance(arch, LMConfig):
        cfg = arch
    else:
        cfg = C.get_reduced(arch) if reduced else C.get_config(arch)
    plan = plan_elastic_mesh(n, model_parallel=model_parallel, pods=pods)
    shape = plan.shape
    mesh = make_mesh(shape, plan.axes, device) if n > 1 else None
    model = TransformerLM(cfg, device=mesh.device if mesh else device)
    dev = model.device
    log(f"[serve] {cfg.name}: device={dev}, {cfg.num_layers} layers, "
        f"batch={batch}, prompt={prompt_len}, gen={gen}"
        + (f", mesh={shape}" if mesh else ""))
    g = torch.Generator(device=dev).manual_seed(seed)
    pre, dec = serve_steps(cfg, batch, prompt_len + gen, device=dev,
                           mesh=mesh, part_kwargs=part_kwargs)
    params = (ST.init_params(model, pre.partitioner, g) if mesh is not None
              else model.init(g))
    if dev.type == "cuda":          # the peak of serving: weights included,
        torch.cuda.reset_peak_memory_stats(dev)     # init's transients not
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    frontend = stub_frontend(cfg, batch, rng)
    fe = None if frontend is None else torch.as_tensor(frontend, device=dev)
    out = generate(pre, dec, params, torch.as_tensor(prompts, device=dev),
                   gen, frontend=fe, keep_logits=keep_logits)
    if mesh is not None and keep_logits:
        out["logits"] = [t.cpu() for t in out["logits"]]
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
    rank_peaks = None
    if mesh is not None and peak is not None:
        rank_peaks = mesh.all_gather(torch.tensor([peak], dtype=torch.float64),
                                     mesh.axis_names, 0).tolist()
    t_pre, t_dec = out["prefill_s"], out["decode_s"]
    tps = batch * (gen - 1) / max(t_dec, 1e-9)
    log(f"[serve] prefill {t_pre * 1e3:.0f} ms, decode {t_dec * 1e3:.0f} ms "
        f"({tps:.1f} tok/s), sample row: {out['tokens'][0][:12]}"
        + (f", peak memory {peak:.2f} GiB" if peak is not None else ""))
    return {"arch": cfg.name, "prompts": prompts, "frontend": frontend,
            "tokens": out["tokens"],
            "prefill_ms": t_pre * 1e3, "decode_ms": t_dec * 1e3,
            "decode_ms_per_token": t_dec * 1e3 / max(1, gen - 1),
            "tok_s": tps, "peak_mem_gib": peak, "logits": out["logits"],
            "num_layers": cfg.num_layers,
            "mesh": shape, "rank_peak_gib": rank_peaks}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2-2b", choices=C.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the model axis")
    ap.add_argument("--dp", type=int, default=1,
                    help="ranks on the data axis")
    PT.add_variant_flags(ap)
    args = ap.parse_args(argv)
    return serve(args.arch, reduced=args.reduced, batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                 device=args.device, model_parallel=args.model_parallel,
                 dp=args.dp, part_kwargs=PT.variant_kwargs(args))["tokens"]


if __name__ == "__main__":
    main()
