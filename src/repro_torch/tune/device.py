"""Device introspection for the autotuner and the codegen fusion gate.

The counterpart of ``repro.tune.device``. There the gather-fused Pallas
kernels keep their whole ungathered source block resident in VMEM, so a
budget derived from the TPU's VMEM gates fusion. The Hopper kernels of the
port (K1, K3, K7) gather each row from global memory by index
(``csrc/segment_mm.cu``, ``csrc/traversal.cu``); nothing has to stay
resident, so on a CUDA card the budget is unbounded and the default
heuristic fuses every fusable op. On the CPU (the plain versions, the
tests' path) the reference's value is kept, 16 MiB x 0.25 with the same
environment overrides, so CPU decisions equal the reference's.

What the card has in place of VMEM (opt-in shared memory per block, the L2
size) is recorded by ``device_limits`` for the cost model's log; no
decision reads it yet.

This module imports nothing of ``repro_torch`` so that ``core/codegen.py``
can use it without an import cycle.
"""
from __future__ import annotations

import functools
import os
import sys
from typing import Dict, Optional

import torch

# the reference's VMEM size of every shipped TPU core, and the fraction the
# fused-gather kernels may claim: the CPU keeps both, so its decisions
# equal the reference's
_CPU_VMEM_BYTES = 16 * 1024 * 1024
_FUSED_GATHER_VMEM_FRACTION = 0.25

# the reference's environment overrides, with the same names
VMEM_ENV = "REPRO_VMEM_BYTES"
BUDGET_ENV = "REPRO_FUSED_GATHER_BUDGET_BYTES"

# "no residency limit": larger than any tensor a card holds
UNBOUNDED = sys.maxsize

# the column slice of a K1 / K4 thread block when ``tile_n`` is unset
# (``kColTile`` in ``csrc/segment_mm.cu``), and the reference's default
# (its Pallas kernels' 128 columns), which the CPU's decisions keep
CARD_TILE_N = 64
_CPU_TILE_N = 128


def _normalize(device) -> torch.device:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _kind(dev: torch.device) -> str:
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev).strip().replace("|", "/")
        return f"cuda:{name}"
    return dev.type


def device_kind(device=None) -> str:
    """Stable, key-safe identifier of ``device`` (``None``: the CPU), e.g.
    ``cpu`` or ``cuda:NVIDIA H100 80GB HBM3``. Part of every tuning-cache
    key, so decisions measured on one part are never replayed on another;
    on the CPU it equals the reference's string."""
    return _kind(_normalize(device))


def vmem_bytes() -> int:
    """The reference's VMEM size for the CPU's decisions
    (``REPRO_VMEM_BYTES`` overrides it)."""
    env = os.environ.get(VMEM_ENV)
    return int(env) if env else _CPU_VMEM_BYTES


def budget_for_kind(kind: str) -> int:
    """Bytes a gather-fused op may keep resident on a device of ``kind``
    (a ``device_kind`` string): unbounded on a CUDA card, the reference's
    VMEM-derived value elsewhere. ``REPRO_FUSED_GATHER_BUDGET_BYTES``
    overrides both."""
    env = os.environ.get(BUDGET_ENV)
    if env:
        return int(env)
    if kind.startswith("cuda"):
        return UNBOUNDED
    return int(vmem_bytes() * _FUSED_GATHER_VMEM_FRACTION)


def default_tile_n(kind: str) -> int:
    """The column tile a GEMM variant without ``tile_n`` runs on a device
    of ``kind``: the port's kernel default on a CUDA card, the reference's
    elsewhere (the plain versions ignore it; the CPU's candidates and
    scores stay the reference's)."""
    return CARD_TILE_N if kind.startswith("cuda") else _CPU_TILE_N


def fused_gather_budget_bytes(device=None) -> int:
    """The fusion budget of ``device`` (``None``: the CPU)."""
    return budget_for_kind(device_kind(device))


def device_limits(device=None) -> Dict[str, Optional[int]]:
    """The card's on-chip sizes that stand where the TPU's VMEM stood: the
    shared memory one block may opt in to, and the L2 cache, in bytes
    (``None`` on the CPU)."""
    dev = _normalize(device)
    if dev.type != "cuda":
        return {"shared_memory_per_block_optin": None, "l2_cache_bytes": None}
    props = torch.cuda.get_device_properties(dev)
    return {
        "shared_memory_per_block_optin": getattr(
            props, "shared_memory_per_block_optin", None),
        "l2_cache_bytes": getattr(props, "L2_cache_size", None),
    }
