"""TransformerLM for LM serving: the dense family (the port's counterpart of
``repro.lm.model``).

* Parameters keep the reference's layout, stacked over each stage's
  repeats (``params["stages"][i]["l<j>"]...`` with a leading ``[repeats]``
  dimension), so ``params_from_reference`` only converts arrays. Layers run
  as a Python loop over the repeats.
* ``prefill`` / ``decode_step`` serve from a preallocated KV cache (also
  stacked per stage) that attention writes in place. The attention core is
  K10 (``kernels/flash_attention.py``).
* ``backbone(mode="train")`` is the cache-free forward; ``loss`` is the
  reference's sequence-chunked next-token cross-entropy over it. Under
  autograd K10 runs its kernel forward and the plain version's VJP
  (``kernels/flash_attention.FlashAttention``). ``remat=True`` (the
  reference's default) recomputes each repeat of a stage in the backward
  (``torch.utils.checkpoint``, the counterpart of the reference's
  ``jax.checkpoint(nothing_saveable)``), and only while grad is enabled.

Not ported yet (``ROADMAP.md`` §1, the LM substrate): Mamba layers, MoE
MLPs, cross-attention and encoder-decoder layers, encoders and frontends;
a config that needs any of them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.lm.config import LayerSpec, LMConfig, Stage
from repro_torch.nn import attention as A
from repro_torch.nn import mlp as M
from repro_torch.nn.common import dense_init, init_device, rms_norm, softcap
from repro_torch.device import resolve_device

_TODO = "{} is not ported yet (ROADMAP.md §1, LM substrate: {})"


def padded_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def _unsupported(cfg: LMConfig) -> Optional[str]:
    """Why the port cannot run ``cfg`` yet, or ``None`` (a dense model)."""
    for st in cfg.stages:
        for spec in st.pattern:
            if spec.kind == "mamba":
                return _TODO.format("a Mamba layer", "SSM, nn/ssm.py")
            if spec.kind != "self_attn" or spec.dec_cross:
                return _TODO.format("cross-attention",
                                    "cross-attention and encoder/frontend")
            if spec.moe:
                return _TODO.format("an MoE MLP", "MoE, nn/moe.py")
    if cfg.encoder_layers or cfg.frontend_tokens or cfg.frontend_dim:
        return _TODO.format("an encoder or frontend",
                            "cross-attention and encoder/frontend")
    return None


def _take(tree, r: int):
    """Repeat ``r`` of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    return tree[r]


class TransformerLM:
    """The dense LM on one device (``None``: the CUDA card, which must
    exist; ``"cpu"`` runs the plain versions)."""

    def __init__(self, cfg: LMConfig, *, device=None, remat: bool = True,
                 loss_chunk: int = 2048):
        why = _unsupported(cfg)
        if why:
            raise NotImplementedError(f"{cfg.name}: {why}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat = remat
        self.loss_chunk = loss_chunk
        self.vp = padded_vocab(cfg.vocab_size)
        self.dtype = getattr(torch, cfg.dtype)

    # ------------------------------------------------------------ params
    def _init_layer(self, g, spec: LayerSpec, lead: tuple) -> Dict:
        cfg, dt = self.cfg, self.dtype
        dev = init_device(g)
        ones = lambda: torch.ones(lead + (cfg.d_model,), dtype=dt,   # noqa: E731
                                  device=dev)
        p = {"norm": ones(), "attn": A.init_attention(g, cfg, dt, lead)}
        if cfg.d_ff > 0:
            p["mlp_norm"] = ones()
            p["mlp"] = M.init_mlp(g, cfg.d_model, cfg.d_ff, dt, lead)
        return p

    def _build(self, g: Optional[torch.Generator]) -> Dict:
        """Parameters drawn from ``g`` (``None``: shapes only, on the meta
        device)."""
        cfg, dt = self.cfg, self.dtype
        dev = init_device(g)
        params: Dict = {
            "embed": dense_init((self.vp, cfg.d_model), dt, g,
                                fan_in=cfg.d_model),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "stages": [{f"l{i}": self._init_layer(g, spec, (st.repeats,))
                        for i, spec in enumerate(st.pattern)}
                       for st in cfg.stages],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init((cfg.d_model, self.vp), dt, g)
        return params

    def init(self, generator: Optional[torch.Generator] = None) -> Dict:
        """Random parameters on the model's device, drawn from
        ``generator`` (a generator on that device; default: one seeded
        with 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self._build(generator)

    def init_cache(self, batch: int, cache_len: int) -> List[List[Dict]]:
        """Zeroed K/V per stage and pattern layer: ``{"attn": {"k", "v":
        [repeats, batch, cache_len, KV, hd]}}``."""
        cfg = self.cfg
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        zeros = lambda st: torch.zeros((st.repeats,) + shape,   # noqa: E731
                                       dtype=self.dtype, device=self.device)
        return [[{"attn": {"k": zeros(st), "v": zeros(st)}}
                 for _ in st.pattern] for st in cfg.stages]

    # ------------------------------------------------------------ layers
    def _apply_layer(self, spec: LayerSpec, p: Dict, x, positions, *,
                     cache=None, cache_index=None):
        cfg = self.cfg
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        h, _ = A.attention(p["attn"], h, cfg, spec, positions,
                           kv_cache=cache["attn"] if cache else None,
                           cache_index=cache_index)
        x = x + h
        if "mlp_norm" in p:
            h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
            x = x + M.mlp(p["mlp"], h)
        return x

    def _run_stage(self, stage: Stage, sp: Dict, x, positions, *,
                   caches=None, cache_index=None):
        def body(x, lp, cache):
            for i, spec in enumerate(stage.pattern):
                x = self._apply_layer(
                    spec, lp[f"l{i}"], x, positions,
                    cache=cache[i] if cache is not None else None,
                    cache_index=cache_index)
            return x
        remat = self.remat and caches is None and torch.is_grad_enabled()
        for r in range(stage.repeats):
            lp = _take(sp, r)
            cache = (None if caches is None
                     else [_take(c, r) for c in caches])
            # the model draws no random numbers: no RNG state to keep
            x = (checkpoint(body, x, lp, cache, use_reentrant=False,
                            preserve_rng_state=False)
                 if remat else body(x, lp, cache))
        return x

    # ------------------------------------------------------------ forward
    def backbone(self, params: Dict, tokens: torch.Tensor, *,
                 mode: str = "train", caches=None,
                 cache_index: Optional[int] = None) -> torch.Tensor:
        """Final-normed hidden states ``[B, S, D]``. ``train``: the
        cache-free forward at positions ``0..S-1``; ``prefill``: the same,
        writing K/V into ``caches`` at 0; ``decode``: positions
        ``cache_index + 0..S-1``, writing there."""
        cfg = self.cfg
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if (caches is None) != (mode == "train"):
            raise ValueError(f"mode {mode!r} with caches={caches is not None}")
        start = cache_index if mode == "decode" else 0
        positions = torch.arange(start, start + tokens.shape[1],
                                 device=self.device)
        x = params["embed"][tokens].to(self.dtype)
        if cfg.scale_embed:
            x = x * torch.tensor(float(cfg.d_model), dtype=torch.float32
                                 ).sqrt().to(self.dtype)
        for i, stage in enumerate(cfg.stages):
            x = self._run_stage(
                stage, params["stages"][i], x, positions,
                caches=caches[i] if caches is not None else None,
                cache_index=None if caches is None else start)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def logits(self, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return softcap(torch.matmul(hidden, head).float(),
                       self.cfg.logit_softcap)

    def loss(self, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["targets"]`` (both ``[B, S]``), as the reference computes
        it: the head runs over chunks of ``min(loss_chunk, S)`` positions
        (which must divide ``S``), each chunk's logits in fp32 and
        softcapped, ``logsumexp - gold`` summed and divided by ``B * S``.
        Returns ``(loss, {"nll", "moe_aux"})``; the dense family has no
        router, so ``moe_aux`` is 0 and ``loss`` is ``nll`` (the
        reference's ``coef * aux / num_layers`` term comes with MoE)."""
        tokens, targets = batch["tokens"], batch["targets"].long()
        hidden = self.backbone(params, tokens, mode="train")
        b, s, _ = hidden.shape
        chunk = min(self.loss_chunk, s)
        if s % chunk:
            raise ValueError(f"sequence length {s} is not a multiple of the "
                             f"loss chunk {chunk}")
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(0, s, chunk):
            lg = softcap(torch.matmul(hidden[:, c:c + chunk], head).float(),
                         self.cfg.logit_softcap)
            gold = lg.gather(-1, targets[:, c:c + chunk, None])[..., 0]
            total = total + torch.sum(torch.logsumexp(lg, dim=-1) - gold)
        nll = total / (b * s)
        aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        return nll, {"nll": nll, "moe_aux": aux}

    # ------------------------------------------------------------ serving
    def prefill(self, params: Dict, tokens: torch.Tensor, *,
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, list]:
        """Run the prompt into a fresh cache of ``cache_len`` (default: the
        prompt's length); returns ``(logits [B, 1, V] of the last prompt
        token, caches)``."""
        cache_len = cache_len or tokens.shape[1]
        caches = self.init_cache(tokens.shape[0], cache_len)
        hidden = self.backbone(params, tokens, mode="prefill", caches=caches)
        return self.logits(params, hidden[:, -1:]), caches

    def decode_step(self, params: Dict, token: torch.Tensor, index: int,
                    caches: list) -> Tuple[torch.Tensor, list]:
        """One token per row (``token [B, 1]``) at position ``index`` (a
        Python int): ``(logits [B, 1, V], caches)``, the caches updated in
        place."""
        hidden = self.backbone(params, token, mode="decode", caches=caches,
                               cache_index=int(index))
        return self.logits(params, hidden), caches


def _convert(ref, want, path: str, device):
    if isinstance(want, dict):
        if not isinstance(ref, dict) or set(ref) != set(want):
            got = sorted(ref) if isinstance(ref, dict) else type(ref).__name__
            raise ValueError(f"params{path}: {got}, expected {sorted(want)}")
        return {k: _convert(ref[k], want[k], f"{path}[{k!r}]", device)
                for k in want}
    if isinstance(want, list):
        if not isinstance(ref, (list, tuple)) or len(ref) != len(want):
            raise ValueError(f"params{path}: expected {len(want)} stages")
        return [_convert(r, w, f"{path}[{i}]", device)
                for i, (r, w) in enumerate(zip(ref, want))]
    arr = np.array(ref, np.float32)        # a writable copy
    if tuple(arr.shape) != tuple(want.shape):
        raise ValueError(f"params{path}: shape {tuple(arr.shape)}, expected "
                         f"{tuple(want.shape)}")
    return torch.from_numpy(arr).to(device=device, dtype=want.dtype)


def params_from_reference(params_np, cfg: LMConfig, device=None) -> Dict:
    """The reference's ``TransformerLM.init`` pytree (numpy arrays, stacked
    per stage) as the port's parameters on ``device``: the same tree and
    values, in ``cfg.dtype``. Raises ``ValueError`` on a tree or shape that
    does not fit ``cfg``."""
    model = TransformerLM(cfg, device=device)
    return _convert(params_np, model._build(None), "", model.device)
