"""Roofline bounds of LM steps on one H100 (the port's counterpart of
``repro.launch.roofline``).

The analytic half is the reference's, formulas unchanged, with the card's
constants in ``HW_H100``:

  compute    = FLOPs / 989e12 bf16 FLOP/s (dense tensor cores)
  memory     = bytes / 3.35e12 B/s (HBM3)
  collective = wire bytes / 450e9 B/s (NVLink, one way; zero on one card)

``model_flops`` (6 N D train, 2 N D prefill, 2 N_active B decode),
``analytic_memory_bytes`` and ``_cache_bytes`` are the reference's
functions number for number; like the reference's, ``_cache_bytes``
counts no cross-attention K/V (``repro/launch/roofline.py:440-453``),
kept so that the two agree (``ROADMAP.md`` §3, the differences kept from
the reference).

Difference by design: the reference's other half parses XLA's optimized
HLO text (``parse_hlo``, ``analyze_hlo``: trip counts of ``while`` loops,
dot FLOPs, collective bytes), which eager PyTorch does not produce. In its
place ``step_flops`` counts one step's FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` on fake tensors (shapes only,
nothing allocated): matrix products of the forward and the backward,
attention through K10's plain version. A step whose shapes depend on its
data cannot run on fake tensors (the MoE dispatch's ``bincount`` /
``nonzero``): it gives ``None`` and the reason.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch


@dataclasses.dataclass
class HW:
    name: str
    peak_flops: float       # per chip
    hbm_bw: float           # B/s per chip
    link_bw: float          # B/s per link, one way
    hbm_bytes: float        # capacity per chip


# NVIDIA's H100 SXM data sheet (dense, 700 W): bf16 tensor cores, HBM3, the
# NVLink rate to another card one way (900 GB/s both ways), 80 GB
HW_H100 = HW(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12,
             link_bw=450e9, hbm_bytes=80e9)


def summarize_cost(cost) -> Dict[str, float]:
    """The numeric entries of a cost dict (or of the first of a list), as
    floats."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    out = {}
    for k, v in (cost or {}).items():
        if isinstance(v, (int, float)):
            out[str(k)] = float(v)
    return out


def roofline_terms(cost: Dict[str, float], tallies: Dict[str, float],
                   chips: int, hw: HW = HW_H100) -> Dict[str, float]:
    """Three roofline terms in seconds (per step), from per-device tallies
    (``flops``, ``mem_bytes_proxy``, ``collective_bytes``)."""
    flops = tallies.get("flops", 0.0)
    mem = tallies.get("mem_bytes_proxy", 0.0)
    coll = tallies.get("collective_bytes", 0.0)
    t_compute = flops / hw.peak_flops
    t_memory = mem / hw.hbm_bw
    t_collective = coll / hw.link_bw
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "device_flops": flops,
        "device_mem_bytes": mem,
        "device_collective_bytes": coll,
        "total_flops": flops * chips,
    }


def model_flops(cfg, cell) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N·D prefill, 2·N_active·B decode."""
    n_active = cfg.active_param_count()
    if cell.mode == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.mode == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch          # one token per request


def analytic_memory_bytes(cfg, cell, chips: int) -> float:
    """Model-based per-device HBM traffic per step.

    train:   params read twice (fwd + remat-bwd) + grad write + Adam moment
             read/write (f32 m,v) + activation checkpoint IO
    prefill: params read once + activation IO + cache write
    decode:  active params read once + full KV/state cache read + write
    """
    n = cfg.param_count()
    n_act = cfg.active_param_count()
    d, l = cfg.d_model, cfg.num_layers
    b, s = cell.global_batch, cell.seq_len
    tokens = b * s
    if cell.mode == "train":
        weight_io = n * (2 * 2 + 2 + 4 * 4)       # bf16 r(fwd)+r(bwd)+w(grad), f32 m/v r+w
        act_io = tokens * d * 2 * 2 * (l + 4)     # one checkpoint r+w per layer
        return (weight_io + act_io) / chips
    if cell.mode == "prefill":
        weight_io = n_act * 2
        act_io = tokens * d * 2 * 8 * l           # ~8 materialized tensors/layer
        cache_w = _cache_bytes(cfg, cell)
        return (weight_io * max(1, tokens // 8192) + act_io + cache_w) / chips
    # decode: cache read dominates
    weight_io = n_act * 2
    cache_rw = _cache_bytes(cfg, cell) * 1.0
    return (weight_io + cache_rw) / chips


def _cache_bytes(cfg, cell) -> float:
    """The bf16 K/V and Mamba caches of ``cell`` (no cross-attention K/V,
    as in the reference)."""
    b, s = cell.global_batch, cell.seq_len
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    total = 0.0
    for st in cfg.stages:
        for spec in st.pattern:
            if spec.kind == "self_attn":
                total += st.repeats * 2 * b * s * kv * hd * 2
            elif spec.kind == "mamba":
                total += st.repeats * b * (
                    cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
                    + (cfg.ssm_conv - 1)
                    * (cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state) * 2)
    return total


def bound_s(cfg, cell, hw: HW = HW_H100) -> float:
    """The least time one card could take for ``cell``'s step:
    ``max(model_flops / peak, analytic_memory_bytes / hbm_bw)``."""
    return max(model_flops(cfg, cell) / hw.peak_flops,
               analytic_memory_bytes(cfg, cell, 1) / hw.hbm_bw)


class StepFlops(NamedTuple):
    flops: Optional[float]      # None where the step cannot run on shapes
    reason: str                 # why not ("" where it ran)


def step_flops(cfg, cell) -> StepFlops:
    """The FLOPs of one ``launch.steps.build_step`` step of ``cell`` (remat
    off, as the drivers build it; a decode step at the cache's last
    position), counted by ``FlopCounterMode`` while the step runs on fake
    tensors: nothing is allocated, so full-size configs count on any host.
    Attention counts through K10's plain version (every query-key pair,
    masked or not)."""
    from torch._subclasses.fake_tensor import (
        DataDependentOutputException, DynamicOutputShapeException,
        FakeTensorMode)
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.steps import build_step
    from repro_torch.optim.adamw import tree_map

    try:
        with FakeTensorMode():
            bundle = build_step(cfg, cell, "cpu", remat=False)
            args = [tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), a)
                    for a in bundle.abstract_args]
            if cell.mode == "decode":
                args[2] = cell.seq_len - 1
            with FlopCounterMode(display=False) as counter:
                bundle.fn(*args)
    except (DataDependentOutputException, DynamicOutputShapeException) as e:
        return StepFlops(None, f"{type(e).__name__}: {e}"[:300])
    return StepFlops(float(counter.get_total_flops()), "")
