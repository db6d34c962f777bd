"""TransformerLM for LM serving and training: the dense, MoE, SSM, hybrid,
vision-language and encoder-decoder families (the port's counterpart of
``repro.lm.model``).

* Parameters keep the reference's layout, stacked over each stage's
  repeats (``params["stages"][i]["l<j>"]...`` with a leading ``[repeats]``
  dimension), so ``params_from_reference`` only converts arrays. Layers run
  as a Python loop over the repeats.
* Layer kinds: self-attention (``nn/attention.py``), cross-attention over
  the memory (``cross_attn``, llama-vision's image layers), self- then
  cross-attention (``dec_cross``, whisper's decoder) or a Mamba2 layer
  (``nn/ssm.py``), then a dense MLP (``nn/mlp.py``) or an MoE MLP
  (``nn/moe.py``) per ``LayerSpec.moe``; a Mamba layer of a config without
  ``d_ff`` has no MLP.
* The memory of the cross-attention layers comes from the stubbed
  frontend embeddings (``frontend``): through the encoder
  (``encoder_layers`` non-causal self-attention layers and their MLPs,
  then a final norm; whisper) or through ``frontend_proj``
  (llama-vision). The frontend is cast to the model dtype on entry (the
  reference lets a float32 frontend promote a bf16 model's encoder).
* ``prefill`` / ``decode_step`` serve from a preallocated cache (also
  stacked per stage) that the layers write in place: K/V for attention,
  the memory's K/V for cross-attention (at prefill; decode reads them and
  needs no frontend), the conv window and the recurrent state for Mamba.
  The attention core is K10 (``kernels/flash_attention.py``).
* ``backbone(mode="train")`` is the cache-free forward; ``loss`` is the
  reference's sequence-chunked next-token cross-entropy over it, plus
  ``MOE_AUX_COEF`` times the MoE layers' load-balance loss over the number
  of layers. Under autograd K10 runs its kernel forward and the plain
  version's VJP (``kernels/flash_attention.FlashAttention``). ``remat=True`` (the
  reference's default) recomputes each repeat of a stage in the backward
  (``torch.utils.checkpoint``, the counterpart of the reference's
  ``jax.checkpoint(nothing_saveable)``), and only while grad is enabled.
* On a mesh (a resolver installed by ``launch/steps.py``; see
  ``launch/partitioning.py``) the model sees each rank's shards: a
  vocabulary-split ``embed`` looks up the rows it holds and all-reduces
  (Megatron's masked lookup), attention and the dense MLP split their
  heads and width (``nn/attention.py``, ``nn/mlp.py``), an MoE layer
  gathers the batch's tokens over its axes and runs the whole dispatch
  (or, on v-B's EP branch, keeps its data shard's tokens and runs
  ``nn/moe._moe_ffn_ep``), the logits of a vocabulary-split head are
  all-gathered, and ``loss`` is
  a vocabulary-parallel log-softmax (the max, the sum of exps and the
  target logit each all-reduced over ``model``). Under v-E (the
  resolver's ``run.seq``) the decoder's token stream between blocks is
  the rank's slice of the sequence: the norms run on it, attention, the
  MLPs, Mamba and the head all-gather it first (an MoE layer gathers the
  whole sequence and then takes its token slice, a contiguous run of the
  flattened rows, not the sequence slice) and the blocks' outputs come
  back as the slice. The encoder's stream (whisper) stays whole: the
  split would change its memory only. ``init(keep=)`` draws
  every leaf whole from the generator, one leaf at a time, and keeps the
  rank's slice, so a mesh's parameters are the one device's bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.lm.config import LayerSpec, LMConfig, Stage
from repro_torch.nn import attention as A
from repro_torch.nn import mlp as M
from repro_torch.nn import moe as MOE
from repro_torch.nn import ssm as S
from repro_torch.nn.common import (dense_init, init_device, init_hook,
                                   mesh_ctx, rms_norm, shard, softcap)
from repro_torch.device import resolve_device

# The load-balance loss's weight in ``loss`` (the reference's default).
MOE_AUX_COEF = 0.01


def padded_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


# the encoder's layer (whisper): self-attention, run without causal masking
_ENCODER_LAYER = LayerSpec(kind="self_attn")


def _insertion_paths(tree, prefix=()):
    """``(path, leaf)`` in the order ``_build`` made the leaves (dicts in
    insertion order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _insertion_paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _insertion_paths(v, prefix + (i,))
    else:
        yield "/".join(str(k) for k in prefix), tree


def _take(tree, r: int):
    """Repeat ``r`` of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    return tree[r]


class TransformerLM:
    """The LM on one device (``None``: the CUDA card, which must exist;
    ``"cpu"`` runs the plain versions)."""

    def __init__(self, cfg: LMConfig, *, device=None, remat: bool = True,
                 loss_chunk: int = 2048):
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
        p = {"norm": ones()}
        if spec.kind == "mamba":
            p["mamba"] = S.init_mamba(g, cfg, dt, lead)
        else:
            p["attn"] = A.init_attention(g, cfg, dt, lead,
                                         cross=spec.kind == "cross_attn")
            if spec.dec_cross:
                p["cross_norm"] = ones()
                p["cross"] = A.init_attention(g, cfg, dt, lead, cross=True)
        if spec.moe and (spec.kind != "mamba" or cfg.d_ff > 0):
            p["mlp_norm"] = ones()
            p["moe"] = MOE.init_moe(g, cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                                    cfg.num_experts, dt, lead)
        elif cfg.d_ff > 0:
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
        if cfg.frontend_dim:
            params["frontend_proj"] = dense_init(
                (cfg.frontend_dim, cfg.d_model), dt, g)
        if cfg.encoder_layers:
            params["encoder"] = {
                "stages": [{"l0": self._init_layer(
                    g, _ENCODER_LAYER, (cfg.encoder_layers,))}],
                "final_norm": torch.ones((cfg.d_model,), dtype=dt,
                                         device=dev),
            }
        return params

    def init(self, generator: Optional[torch.Generator] = None, *,
             keep=None) -> Dict:
        """Random parameters on the model's device, drawn from
        ``generator`` (a generator on that device; default: one seeded
        with 0). ``keep(path, leaf)``, where given, returns the part of
        each whole leaf to keep (a rank's shard; ``path`` as
        ``launch/partitioning.py`` spells it): it is applied as each leaf
        is drawn, so no more than one whole leaf exists at a time, and the
        values are those of ``keep=None``'s leaves."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if keep is None:
            return self._build(generator)

        def kept(path, t):
            out = keep(path, t)
            return out if out is t else out.clone()

        drawn = []
        with init_hook(lambda t: drawn.append(t) or t):
            meta = self._build(None)
        order = {id(t): i for i, t in enumerate(drawn)}
        paths = [None] * len(drawn)
        for path, t in _insertion_paths(meta):
            if id(t) in order:
                paths[order[id(t)]] = path
        it = iter(paths)
        with init_hook(lambda t: kept(next(it), t)):
            params = self._build(generator)
        done = set(paths)

        def rest(tree, prefix=()):
            if isinstance(tree, dict):
                return {k: rest(v, prefix + (k,)) for k, v in tree.items()}
            if isinstance(tree, list):
                return [rest(v, prefix + (i,)) for i, v in enumerate(tree)]
            path = "/".join(str(k) for k in prefix)
            return tree if path in done else kept(path, tree)
        return rest(params)

    def init_cache(self, batch: int, cache_len: int) -> List[List[Dict]]:
        """Zeroed caches per stage and pattern layer, stacked over the
        repeats: ``{"attn": {"k", "v": [repeats, batch, cache_len, KV,
        hd]}}`` (model dtype) for self-attention, ``{"cross": {"k", "v":
        [repeats, batch, mem_len, KV, hd]}}`` (model dtype; ``mem_len`` is
        ``encoder_seq or frontend_tokens``) for cross-attention (a
        ``dec_cross`` layer has both), ``{"mamba": {"conv": [repeats,
        batch, ssm_conv - 1, d_inner + 2 g n]`` (model dtype), ``"state":
        [repeats, batch, h, p, n]`` (fp32)``}}`` for Mamba."""
        cfg = self.cfg

        def zeros(st, shape, dtype=self.dtype):
            return torch.zeros((st.repeats, batch) + shape, dtype=dtype,
                               device=self.device)

        heads = (cfg.num_kv_heads, cfg.resolved_head_dim)
        mem_len = cfg.encoder_seq or cfg.frontend_tokens
        conv = (cfg.ssm_conv - 1,
                cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
        state = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)

        def layer(st, spec):
            if spec.kind == "mamba":
                return {"mamba": {"conv": zeros(st, conv),
                                  "state": zeros(st, state, torch.float32)}}
            c = {}
            if spec.kind == "self_attn":
                c["attn"] = {n: zeros(st, (cache_len,) + heads)
                             for n in ("k", "v")}
            if spec.kind == "cross_attn" or spec.dec_cross:
                c["cross"] = {n: zeros(st, (mem_len,) + heads)
                              for n in ("k", "v")}
            return c

        return [[layer(st, spec) for spec in st.pattern]
                for st in cfg.stages]

    # ------------------------------------------------------------ layers
    def _apply_layer(self, spec: LayerSpec, p: Dict, x, positions, *,
                     memory=None, cache=None, cache_index=None,
                     prefill=False, causal=True, seq=False):
        """``(x, lb_loss)``: the layer's output and its MoE load-balance
        loss (``None`` without an MoE MLP). A cross-attention reads
        ``memory`` (training, prefill; a prefill writes its K/V into the
        cache's ``"cross"`` entry) or, at decode, that cache entry.
        ``seq`` (v-E): ``x`` is the rank's slice of the sequence."""
        cfg = self.cfg
        ctx = mesh_ctx()

        def cross(params, h):
            return A.attention(params, h, cfg, spec, positions,
                               memory=memory,
                               cross_kv=cache["cross"] if cache else None,
                               store_cross=prefill, cache_index=cache_index,
                               seq=seq)

        def whole(fn, h):
            """``fn`` on the whole sequence, replicated over ``model``."""
            if not seq:
                return fn(h)
            out, aux = fn(ctx.seq_gather(h, partial=False))
            return ctx.seq_slice(out), aux

        h = rms_norm(x, p["norm"], cfg.norm_eps)
        if spec.kind == "mamba":
            h, _ = whole(lambda h: S.mamba_forward(
                p["mamba"], h, cfg, cache=cache["mamba"] if cache else None,
                prefill=prefill), h)
        elif spec.kind == "cross_attn":
            h, _ = cross(p["attn"], h)
        else:
            h, _ = A.attention(p["attn"], h, cfg, spec, positions,
                               kv_cache=cache["attn"] if cache else None,
                               cache_index=cache_index, causal=causal,
                               seq=seq)
        x = x + h
        if spec.dec_cross:
            h, _ = cross(p["cross"], rms_norm(x, p["cross_norm"],
                                              cfg.norm_eps))
            x = x + h
        aux = None
        if "mlp_norm" in p:
            h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
            if "moe" in p:
                h, aux = whole(lambda h: self._moe(p["moe"], h, ctx), h)
            else:
                h = M.mlp(p["mlp"], h, seq=seq)
            x = x + h
        return shard("activation", x), aux

    def _moe(self, p: Dict, h, ctx):
        """``(out, lb_loss)`` of an MoE MLP: on v-B's EP branch over the
        rank's data shard; otherwise (one device, or a mesh falling back to
        the dense dispatch) over the whole batch's tokens, gathered over the
        batch's axes."""
        cfg = self.cfg
        mine = None
        if ctx is not None and not ctx.run.ep:
            h, mine = ctx.gather_batch(h)
        h, moe_aux = MOE.moe_ffn(p, h, cfg.num_experts, cfg.experts_per_tok,
                                 cfg.capacity_factor)
        return (h if mine is None else mine(h)), moe_aux["lb_loss"]

    def _run_stage(self, stage: Stage, sp: Dict, x, positions, aux, *,
                   memory=None, caches=None, cache_index=None,
                   prefill=False, causal=True, seq=False):
        """The stage's repeats in order; ``aux`` (train mode) sums the MoE
        layers' load-balance losses, layer by layer."""
        def body(x, aux, lp, cache, memory):
            for i, spec in enumerate(stage.pattern):
                x, a = self._apply_layer(
                    spec, lp[f"l{i}"], x, positions, memory=memory,
                    cache=cache[i] if cache is not None else None,
                    cache_index=cache_index, prefill=prefill, causal=causal,
                    seq=seq)
                if a is not None and aux is not None:
                    aux = aux + a
            return x, aux
        remat = self.remat and caches is None and torch.is_grad_enabled()
        for r in range(stage.repeats):
            lp = _take(sp, r)
            cache = (None if caches is None
                     else [_take(c, r) for c in caches])
            # the model draws no random numbers: no RNG state to keep
            x, aux = (checkpoint(body, x, aux, lp, cache, memory,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
                      if remat else body(x, aux, lp, cache, memory))
        return x, aux

    # ------------------------------------------------------------ memory
    @property
    def needs_frontend(self) -> bool:
        """Whether the config has cross-attention layers, whose memory
        comes from the stubbed frontend embeddings."""
        return any(spec.kind == "cross_attn" or spec.dec_cross
                   for st in self.cfg.stages for spec in st.pattern)

    def _encode(self, params: Dict, frames: torch.Tensor) -> torch.Tensor:
        """The whisper-style encoder over frame embeddings ``[B, M, D]``:
        ``encoder_layers`` non-causal self-attention layers (RoPE at
        positions ``0..M-1``) with their MLPs, then the encoder's final
        norm."""
        enc = params["encoder"]
        pos = torch.arange(frames.shape[1], device=frames.device)
        x, _ = self._run_stage(Stage((_ENCODER_LAYER,),
                                     self.cfg.encoder_layers),
                               enc["stages"][0], frames, pos, None,
                               causal=False)
        return rms_norm(x, enc["final_norm"], self.cfg.norm_eps)

    def _memory(self, params: Dict,
                frontend: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The cross-attention memory ``[B, M, D]`` from the stubbed
        frontend embeddings (cast to the model dtype): encoded, projected
        by ``frontend_proj``, or as given. ``None`` for a config without
        cross-attention; such a config given no frontend raises
        ``ValueError`` (the reference would run its cross layers as
        self-attention)."""
        if not self.needs_frontend:
            return None
        if frontend is None:
            raise ValueError(f"{self.cfg.name} has cross-attention layers: "
                             f"pass its frontend embeddings (frontend=)")
        x = frontend.to(device=self.device, dtype=self.dtype)
        if self.cfg.encoder_layers:
            return self._encode(params, x)
        if self.cfg.frontend_dim:
            return torch.matmul(x, params["frontend_proj"])
        return x

    # ------------------------------------------------------------ forward
    def _embed(self, table: torch.Tensor, tokens: torch.Tensor):
        """The embedding rows of ``tokens``; on a vocabulary-split mesh the
        rank looks up the rows it holds (zero elsewhere) and the ranks'
        rows are summed over ``model``."""
        ctx = mesh_ctx()
        if ctx is None or not ctx.splits("embed"):
            return table[tokens].to(self.dtype)
        n = table.shape[0]
        idx = tokens.long() - ctx.model_index() * n
        mine = (idx >= 0) & (idx < n)
        rows = table[idx.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
        return ctx.reduce_model(rows, self.dtype)

    def _head(self, params: Dict) -> torch.Tensor:
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    def _backbone(self, params: Dict, tokens: torch.Tensor, mode: str,
                  caches, cache_index: Optional[int], frontend=None):
        cfg = self.cfg
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if (caches is None) != (mode == "train"):
            raise ValueError(f"mode {mode!r} with caches={caches is not None}")
        start = cache_index if mode == "decode" else 0
        positions = torch.arange(start, start + tokens.shape[1],
                                 device=self.device)
        x = self._embed(params["embed"], tokens)
        if cfg.scale_embed:
            x = x * torch.tensor(float(cfg.d_model), dtype=torch.float32
                                 ).sqrt().to(self.dtype)
        x = shard("activation", x)
        aux = (torch.zeros((), dtype=torch.float32, device=self.device)
               if mode == "train" else None)
        # decode reads the memory's K/V from the cache
        memory = (None if mode == "decode"
                  else self._memory(params, frontend))
        ctx = mesh_ctx()
        seq = ctx is not None and ctx.run.seq
        if seq:
            x = ctx.seq_slice(x)
        for i, stage in enumerate(cfg.stages):
            x, aux = self._run_stage(
                stage, params["stages"][i], x, positions, aux, memory=memory,
                caches=caches[i] if caches is not None else None,
                cache_index=None if caches is None else start,
                prefill=mode == "prefill", seq=seq)
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux

    @staticmethod
    def _whole_stream(hidden, split_head: bool):
        """The final-normed stream for the head: under v-E all-gathered
        over the sequence (the gradient reduce-scattered where the head
        splits the vocabulary, else sliced); otherwise, for a split head,
        ``to_model``."""
        ctx = mesh_ctx()
        if ctx is not None and ctx.run.seq:
            return ctx.seq_gather(hidden, partial=split_head)
        return ctx.to_model(hidden) if split_head else hidden

    def backbone(self, params: Dict, tokens: torch.Tensor, *,
                 frontend: Optional[torch.Tensor] = None, mode: str = "train",
                 caches=None,
                 cache_index: Optional[int] = None) -> torch.Tensor:
        """Final-normed hidden states ``[B, S, D]``. ``train``: the
        cache-free forward at positions ``0..S-1``; ``prefill``: the same,
        writing the caches (K/V at 0, the memory's cross K/V, Mamba's conv
        window and state); ``decode``: positions ``cache_index + 0..S-1``
        (Mamba layers take one token), writing there. ``frontend``: the
        stubbed frontend embeddings of a config with cross-attention
        (``[B, encoder_seq, d_model]`` or ``[B, frontend_tokens,
        frontend_dim]``), which train and prefill need and decode
        ignores."""
        return self._whole_stream(self._backbone(
            params, tokens, mode, caches, cache_index, frontend)[0], False)

    def logits(self, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        """fp32, softcapped logits over the padded vocabulary (on a
        vocabulary-split mesh each rank's part, all-gathered)."""
        ctx = mesh_ctx()
        split = ctx is not None and ctx.splits("lm_head")
        if split:
            hidden = ctx.to_model(hidden)
        lg = softcap(torch.matmul(hidden, self._head(params)).float(),
                     self.cfg.logit_softcap)
        return ctx.gather_model(lg, -1) if split else lg

    def loss(self, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["targets"]`` (both ``[B, S]``), as the reference computes
        it: the head runs over chunks of ``min(loss_chunk, S)`` positions
        (which must divide ``S``), each chunk's logits in fp32 and
        softcapped, ``logsumexp - gold`` summed and divided by ``B * S``.
        ``loss`` adds ``MOE_AUX_COEF * moe_aux / max(1, num_layers)``,
        where ``moe_aux`` sums the MoE layers' load-balance losses (0
        without MoE). A config with cross-attention takes its frontend
        embeddings from ``batch["frontend"]``. Returns ``(loss, {"nll",
        "moe_aux"})``."""
        tokens, targets = batch["tokens"], batch["targets"].long()
        hidden, aux = self._backbone(params, tokens, "train", None, None,
                                     batch.get("frontend"))
        ctx = mesh_ctx()
        split = ctx is not None and ctx.splits("lm_head")
        hidden = self._whole_stream(hidden, split)
        b, s, _ = hidden.shape
        chunk = min(self.loss_chunk, s)
        if s % chunk:
            raise ValueError(f"sequence length {s} is not a multiple of the "
                             f"loss chunk {chunk}")
        head = self._head(params)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(0, s, chunk):
            lg = softcap(torch.matmul(hidden[:, c:c + chunk], head).float(),
                         self.cfg.logit_softcap)
            tgt = targets[:, c:c + chunk]
            if split:
                total = total + torch.sum(_vocab_parallel_nll(ctx, lg, tgt))
                continue
            gold = lg.gather(-1, tgt[..., None])[..., 0]
            total = total + torch.sum(torch.logsumexp(lg, dim=-1) - gold)
        nll = total / (b * s)
        loss = nll + MOE_AUX_COEF * aux / max(1, self.cfg.num_layers)
        return loss, {"nll": nll, "moe_aux": aux}

    # ------------------------------------------------------------ serving
    def prefill(self, params: Dict, tokens: torch.Tensor, *,
                frontend: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, list]:
        """Run the prompt (and, with cross-attention, the ``frontend``) into
        a fresh cache of ``cache_len`` (default: the prompt's length);
        returns ``(logits [B, 1, V] of the last prompt token, caches)``."""
        cache_len = cache_len or tokens.shape[1]
        caches = self.init_cache(tokens.shape[0], cache_len)
        hidden = self.backbone(params, tokens, frontend=frontend,
                               mode="prefill", caches=caches)
        return self.logits(params, hidden[:, -1:]), caches

    def decode_step(self, params: Dict, token: torch.Tensor, index: int,
                    caches: list, *, frontend: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, list]:
        """One token per row (``token [B, 1]``) at position ``index`` (a
        Python int): ``(logits [B, 1, V], caches)``, the caches updated in
        place. ``frontend`` is ignored, as in the reference: the memory's
        K/V are in the cache since the prefill."""
        hidden = self.backbone(params, token, mode="decode", caches=caches,
                               cache_index=int(index))
        return self.logits(params, hidden), caches


def _vocab_parallel_nll(ctx, lg: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """``logsumexp - gold`` per position from each rank's vocabulary part
    ``lg [b, c, V / tp]``: the max, the sum of exps and the target's logit
    each all-reduced over ``model`` (the max carries no gradient; the sums'
    all-reduce is the identity backward, so each rank backpropagates
    through its own part)."""
    n = lg.shape[-1]
    m = ctx.max_model(lg.detach().amax(-1))
    se = ctx.reduce_model(torch.exp(lg - m[..., None]).sum(-1))
    idx = targets - ctx.model_index() * n
    mine = (idx >= 0) & (idx < n)
    gold = lg.gather(-1, idx.clamp(0, n - 1)[..., None])[..., 0]
    gold = ctx.reduce_model(gold * mine.to(gold.dtype))
    return m + torch.log(se) - gold


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
