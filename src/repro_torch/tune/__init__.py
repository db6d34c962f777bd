"""Measurement-driven per-operator autotuning of the port (``repro.tune``'s
counterpart).

Per lowered op the tuner picks a variant (GEMM row and column tiles,
in-kernel gather on or off), per edge variable COMPACT vs VANILLA
materialization, and per graph the kernel-layout tile, by cost-model
pruning plus timing on the device, with a persistent cache so tuned
decisions replay across processes with zero measurements.

``codegen`` imports the leaf modules here (``device``, ``space``), so this
``__init__`` stays import-light: the ``Tuner`` (which itself imports
codegen) loads lazily.
"""
from repro_torch.tune.cache import TuneCache, default_cache_path  # noqa: F401
from repro_torch.tune.decisions import TuningDecisions            # noqa: F401
from repro_torch.tune.device import (device_kind,                 # noqa: F401
                                     fused_gather_budget_bytes)
from repro_torch.tune.space import (GemmVariant, TravVariant,     # noqa: F401
                                    gemm_key, trav_key)

__all__ = [
    "TuneCache", "default_cache_path", "TuningDecisions", "device_kind",
    "fused_gather_budget_bytes", "GemmVariant", "TravVariant", "gemm_key",
    "trav_key", "Tuner", "TuneReport", "measure", "measure_group",
    "measured_split",
]


def __getattr__(name):
    # lazy: tuner -> codegen -> tune.device would otherwise be a cycle
    if name in ("Tuner", "TuneReport", "measure", "measure_group"):
        from repro_torch.tune import tuner as _tuner
        return getattr(_tuner, name)
    if name == "measured_split":
        # lazy: pulls in repro_torch.feats; keep this __init__ import-light
        from repro_torch.tune.feature_budget import measured_split
        return measured_split
    raise AttributeError(name)
