"""Block executor of the port: the reference's compiled-executor surface,
run eagerly.

``repro.core.executor.BlockExecutor`` jits the whole block sequence per
argument signature. PyTorch runs eagerly, so here every call executes
``codegen.execute_block_sequence`` op by op (under ``torch.no_grad()``:
this slice serves, it does not train). The signature-keyed counters stay,
so the drivers report the same fields: ``trace_count`` / ``num_compiled``
count signatures seen for the first time, ``cache_hits`` the calls whose
signature was seen before. Capturing one CUDA graph per signature is the
later step that makes those counters mean compiled programs again.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.core import codegen


def signature(args) -> tuple:
    """Hashable key of a call: the structure of the arguments plus every
    tensor's shape and dtype (every static count rides along as itself)."""
    out = []

    def visit(x):
        if isinstance(x, torch.Tensor):
            out.append(("T", tuple(x.shape), str(x.dtype)))
        elif isinstance(x, dict):
            for k in sorted(x):
                out.append(("K", k))
                visit(x[k])
        elif isinstance(x, (list, tuple)):
            out.append(("L", len(x)))
            for v in x:
                visit(v)
        elif hasattr(x, "__dataclass_fields__"):
            out.append(("D", type(x).__name__))
            for f in x.__dataclass_fields__:
                visit(getattr(x, f))
        else:
            out.append(("V", x))

    visit(args)
    return tuple(out)


class BlockExecutor:
    """Sampled-minibatch forward for a stack of per-hop plans."""

    def __init__(self, plans: Sequence, activation: str = "relu"):
        self.plans = list(plans)
        self.activation = activation
        self._static_key = tuple(p.fingerprint() for p in self.plans)
        self._seen: set = set()
        self.cache_hits = 0
        self.trace_count = 0

    @property
    def num_compiled(self) -> int:
        return len(self._seen)

    def __call__(self, params: Sequence[Dict[str, torch.Tensor]],
                 gts: List, kls: List, dst_locals: List,
                 seed_perm, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        key = (self._static_key,
               signature((list(params), list(gts), list(kls),
                          list(dst_locals), seed_perm, feats)))
        if key in self._seen:
            self.cache_hits += 1
        else:
            self._seen.add(key)
            self.trace_count += 1
        with torch.no_grad():
            return codegen.execute_block_sequence(
                self.plans, list(params), list(gts), list(kls),
                list(dst_locals), seed_perm, feats,
                activation=self.activation)

    def run_minibatch(self, params, mb, global_feats) -> torch.Tensor:
        """Forward over a ``sampling.MiniBatch``: the input features are the
        rows of the device table ``global_feats`` at ``mb.input_ids``."""
        feats = {"feature": global_feats[mb.input_ids.long()]}
        return self(params, mb.tensors, mb.layouts, mb.dst_locals,
                    mb.seed_perm, feats)
