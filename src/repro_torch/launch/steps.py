"""Step builders of the port: ``train`` / ``prefill`` / ``decode`` for one
(arch x cell) on one device (the port's counterpart of
``repro.launch.steps``).

``input_specs`` gives the data inputs' shapes and dtypes as meta tensors
(the reference's ``ShapeDtypeStruct`` stand-ins); ``build_step`` returns a
``StepBundle`` whose ``fn`` runs the step eagerly and whose
``abstract_args`` are meta tensors matching ``fn``'s signature.

* ``train``: ``fn(state, batch) -> (new_state, {"loss", "nll",
  "moe_aux"})``: ``TransformerLM.loss``, ``torch.autograd.grad`` over the
  parameter leaves, then ``AdamW.update`` with the reference's optimizer,
  ``AdamW(cosine_schedule(3e-4, 200, 20_000))``.
* ``prefill``: ``fn(params, tokens, frontend=None) -> (logits, caches)``
  into a cache of ``seq_len`` positions (``frontend``: the stubbed frontend
  embeddings of a config with cross-attention); ``decode``: ``fn(params,
  token, index, caches, frontend=None)`` (``index`` a Python int) against
  that cache, written in place (the frontend is ignored: the memory's K/V
  are cached). The train step passes ``batch["frontend"]`` to the loss.

Differences by design: one device, so there is no ``Partitioner`` and no
sharding tree (the model axis waits for ``ROADMAP.md`` §1's mesh /
partitioning item). Nothing is donated: ``AdamW.update`` stays functional
(it is shared with the RGNN trainers and their bitwise invariants), so the
old state lives until the caller drops it; an in-place update waits in
``ROADMAP.md`` §2.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.lm.config import LMConfig, ShapeCell
from repro_torch.lm.model import TransformerLM
from repro_torch.optim import AdamW, TrainState, cosine_schedule
from repro_torch.optim.adamw import tree_leaves, tree_like


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: LMConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Abstract data inputs for this (arch, cell), as meta tensors:
    tokens / targets (train), tokens (prefill) or the decode token and
    index; configs with an encoder or a frontend add stubbed frontend
    embeddings, as in the reference."""
    b, s = cell.global_batch, cell.seq_len
    dt = getattr(torch, cfg.dtype)
    specs: Dict[str, torch.Tensor] = {}
    if cell.mode == "train":
        specs["tokens"] = _meta((b, s), torch.int32)
        specs["targets"] = _meta((b, s), torch.int32)
    elif cell.mode == "prefill":
        specs["tokens"] = _meta((b, s), torch.int32)
    else:  # decode: one new token against a seq_len cache
        specs["token"] = _meta((b, 1), torch.int32)
        specs["index"] = _meta((), torch.int32)
    if cfg.encoder_layers:
        specs["frontend"] = _meta((b, cfg.encoder_seq, cfg.d_model), dt)
    elif cfg.frontend_tokens:
        specs["frontend"] = _meta((b, cfg.frontend_tokens, cfg.frontend_dim),
                                  dt)
    return specs


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run one (arch x cell) step."""

    name: str
    fn: Callable
    abstract_args: Tuple         # meta tensors matching fn's signature
    model: TransformerLM
    mode: str


def build_step(cfg: LMConfig, cell: ShapeCell, device=None, *,
               remat: bool = True) -> StepBundle:
    """The step of ``cell.mode`` for ``cfg`` on ``device`` (``None``: the
    CUDA card), for every config of the registry. ``abstract_args`` holds
    the frontend's meta tensor where the prefill takes one."""
    model = TransformerLM(cfg, device=device, remat=remat)
    meta = TransformerLM(cfg, device="meta")
    data = input_specs(cfg, cell)
    b, s = cell.global_batch, cell.seq_len
    a_params = meta._build(None)

    if cell.mode == "train":
        opt = AdamW(learning_rate=cosine_schedule(3e-4, 200, 20_000))

        def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(True)
                          for p in tree_leaves(state.params)]
                loss, metrics = model.loss(tree_like(state.params, leaves),
                                           batch)
                grads = torch.autograd.grad(loss, leaves)
            new_state = opt.update(tree_like(state.params, list(grads)),
                                   state)
            out = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in metrics.items()}}
            return new_state, out

        return StepBundle(f"{cfg.name}:{cell.name}:train", train_step,
                          (opt.init(a_params), data), model, "train")

    if cell.mode == "prefill":
        @torch.no_grad()
        def serve_prefill(params, tokens, frontend=None):
            return model.prefill(params, tokens, frontend=frontend,
                                 cache_len=s)

        args = (a_params, data["tokens"])
        if "frontend" in data:
            args += (data["frontend"],)
        return StepBundle(f"{cfg.name}:{cell.name}:prefill", serve_prefill,
                          args, model, "prefill")

    @torch.no_grad()
    def serve_step(params, token, index: int, caches: Any, frontend=None):
        return model.decode_step(params, token, index, caches)

    return StepBundle(f"{cfg.name}:{cell.name}:decode", serve_step,
                      (a_params, data["token"], data["index"],
                       meta.init_cache(b, s)), model, "decode")
