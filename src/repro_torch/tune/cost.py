"""Cheap cost-model prior used to prune variants before measurement (the
port's copy of ``repro.tune.cost``).

The model only needs to *rank* candidates well enough that the top-K always
contains the winner; timing on the device makes the final call. It scores
bytes moved through device memory plus a per-grid-step overhead term, the
two effects the tuning knobs trade against each other:

* gather fusion removes the materialized ``[rows, k]`` copy; where the
  device has a residency budget (the CPU keeps the reference's VMEM one)
  a fused variant past it is infeasible. A CUDA card has none
  (``tune/device.py``), so there no variant is infeasible and ``prune``
  keeps the top ``k`` by predicted bytes;
* smaller row tiles pay more grid-step overhead (but can win on skewed
  type segments where big tiles are mostly padding).

``_GRID_STEP_COST_BYTES`` is a ranking prior, not a measured cost. An
infeasible variant scores infinity: the reference's sentinel of 1e9 bytes
is reached by real scores at full-graph sizes (bgs: about 1.07e9 for an
unfused GEMM over a million padded rows at 8-row tiles), which would prune
feasible variants there.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.tune import device as D
from repro_torch.tune import space as S

_GRID_STEP_COST_BYTES = 2048   # fixed overhead per grid step, in byte units
_INFEASIBLE = float("inf")

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def score(key: str, variant, plan_backend: str) -> float:
    """Predicted relative cost of running the keyed op with ``variant``
    (``plan_backend`` is accepted for the reference's signature; the port
    has one implementation of each op)."""
    info = S.parse_key(key)
    itemsize = _ITEMSIZE.get(info["dtype"], 4)
    budget = D.budget_for_kind(info["device"])

    if info["kind"] == "trav":
        ep, d = info["padded_edges"], info["d"]
        io = ep * d * itemsize                       # message traffic
        msg_rows = ep if not info["compact_msg"] else max(1, ep // 2)
        resident = msg_rows * d * itemsize + ep * 4
        fuse = variant.fuse_gather
        if fuse is None:
            fuse = resident <= budget
        if fuse:
            if resident > budget:
                return _INFEASIBLE
            io = msg_rows * d * itemsize
        else:
            io += ep * d * itemsize                  # dst-sorted copy
        return io

    k, n = info["k"], info["n"]
    rp, x_rows = info["padded_rows"], info["x_rows"]
    tr = variant.tile_rows or info["lay_tile"]
    tn = min(variant.tile_n or D.default_tile_n(info["device"]), n)
    io = rp * (k + n) * itemsize                     # X in + Y out
    if info["fusable"]:
        resident = x_rows * k * itemsize + rp * 4    # source + gather map
        fuse = variant.fuse_gather
        if fuse is None:
            fuse = resident <= budget
        if fuse:
            if resident > budget:
                return _INFEASIBLE
            io = x_rows * k * itemsize + rp * n * itemsize
        else:
            io += rp * k * itemsize                  # materialized copy
    grid_steps = max(1, rp // max(1, tr)) * max(1, n // max(1, tn))
    return io + grid_steps * _GRID_STEP_COST_BYTES


def prune(key: str, candidates: Sequence, plan_backend: str,
          k: int) -> List:
    """Keep the default variant (always, first) plus the cheapest
    alternatives in ascending predicted cost, dropping infeasible ones."""
    default = candidates[0]
    scored = sorted(
        ((score(key, c, plan_backend), i) for i, c in enumerate(candidates)
         if c != default),
        key=lambda t: t[0],
    )
    keep = [candidates[i] for s, i in scored if s < _INFEASIBLE]
    return [default] + keep[: max(0, k - 1)]
