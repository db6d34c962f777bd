"""Dense gated-SiLU MLP (the port's copy of ``repro.nn.mlp``). The
products stay ``torch.matmul``: the reference computes them outside any
Pallas kernel. Where the resolver splits the width over ``model`` the
input goes through ``to_model`` and ``w_down``'s partial sums are
all-reduced (``rp_einsum``). Under v-E (``seq``) the input is the rank's
slice of the sequence, all-gathered first (its gradient reduce-scattered
where the width splits), and ``w_down``'s sums are reduce-scattered back
to the slice."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.nn.common import dense_init, mesh_ctx, rp_einsum, shard


def init_mlp(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             dtype: torch.dtype, lead: tuple = ()) -> Dict:
    return {
        "w_gate": dense_init((d_model, d_ff), dtype, generator, lead=lead),
        "w_up": dense_init((d_model, d_ff), dtype, generator, lead=lead),
        "w_down": dense_init((d_ff, d_model), dtype, generator, fan_in=d_ff,
                             lead=lead),
    }


def mlp(params: Dict, x: torch.Tensor, seq: bool = False) -> torch.Tensor:
    ctx = mesh_ctx()
    split = ctx is not None and ctx.splits("w_down")
    if seq:
        x = ctx.seq_gather(x, partial=split)
    elif split:
        x = ctx.to_model(x)
    h = torch.nn.functional.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    h = shard("ffn_hidden", h)
    return rp_einsum("bsf,fd->bsd", h, params["w_down"], leaf="w_down",
                     seq=seq)
