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
row) and the peak device memory. One device, no mesh. Every config of the
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
from repro_torch.lm.config import LMConfig
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


def generate(model: TransformerLM, params: Dict, prompts: torch.Tensor,
             gen: int, *, frontend: Optional[torch.Tensor] = None,
             keep_logits: bool = False) -> Dict:
    """Prefill ``prompts [B, P]`` (and the ``frontend`` of a config with
    cross-attention) into a cache of ``P + gen`` positions, then ``gen -
    1`` greedy decode steps. Returns the generated tokens ``[B, gen]`` (on
    the host), the prefill and decode wall times (each ending in a device
    synchronize), the caches after the last step and, with
    ``keep_logits``, each step's last-position logits ``[B, V]`` (on the
    device)."""
    if gen < 1:
        raise ValueError(f"gen={gen} must be >= 1")
    dev = model.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    plen = prompts.shape[1]
    sync()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, prompts, frontend=frontend,
                                   cache_len=plen + gen)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    sync()
    t_pre = time.perf_counter() - t0
    tokens, kept = [tok], [logits[:, -1]] if keep_logits else None
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = model.decode_step(params, tok, plen + i, caches)
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
          device=None, keep_logits: bool = False,
          log: Callable[[str], None] = print) -> Dict:
    """Serve one prompt batch of ``arch`` (a config, or an arch id: its
    full config, or its reduced one with ``reduced``) on ``device``
    (``None``: the CUDA card), the weights and prompts drawn from
    ``seed`` (the frontend of a config with cross-attention too). Returns
    the prompts, the frontend (numpy, ``None`` without one), the generated
    tokens, the times, tok/s, the peak device memory from the end of
    initialization on (GiB, the weights included; ``None`` on the CPU)
    and, with ``keep_logits``, each step's logits."""
    if isinstance(arch, LMConfig):
        cfg = arch
    else:
        cfg = C.get_reduced(arch) if reduced else C.get_config(arch)
    model = TransformerLM(cfg, device=device)
    dev = model.device
    log(f"[serve] {cfg.name}: device={dev}, {cfg.num_layers} layers, "
        f"batch={batch}, prompt={prompt_len}, gen={gen}")
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    if dev.type == "cuda":          # the peak of serving: weights included,
        torch.cuda.reset_peak_memory_stats(dev)     # init's transients not
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    frontend = stub_frontend(cfg, batch, rng)
    out = generate(model, params, torch.as_tensor(prompts, device=dev), gen,
                   frontend=(None if frontend is None
                             else torch.as_tensor(frontend, device=dev)),
                   keep_logits=keep_logits)
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
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
            "num_layers": cfg.num_layers}


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
    args = ap.parse_args(argv)
    return serve(args.arch, reduced=args.reduced, batch=args.batch,
                 prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                 device=args.device)["tokens"]


if __name__ == "__main__":
    main()
