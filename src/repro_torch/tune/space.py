"""The per-operator variant space and the keys decisions are stored under.

The port's copy of ``repro.tune.space``. A *variant* is one point in the
operator-specific optimization space (paper §3.4): GEMM tile shape and
whether the access-scheme gather runs inside the kernel. A *key*
identifies one lowered op instance up to everything that determines which
variant wins: the spec's identity fields, the layout signature (tile
sizes, group counts, power-of-two row buckets), the dtype and the device
kind. Keys are plain strings, equal to the reference's for the same plan
and layouts on the CPU (the dtype is written by its numpy name).

Three departures from the reference:

* the port has one implementation of every op on a device, its own
  kernels (or their plain versions on the CPU), so the only backend a
  variant may name is ``DEFAULT``: the reference's ``xla`` alternative is
  its plain oracle, which the card's path never runs. Codegen raises on a
  decision that names another backend;
* keys take the device of the op's tensors (``gemm_key`` / ``trav_key``'s
  ``device``) where the reference reads JAX's default backend;
* on a CUDA key a GEMM's default column tile is the kernels' own (64
  columns, ``device.default_tile_n``), not the reference's 128, so for
  64 < n <= 128 the candidates there also hold ``tile_n=n``. CPU keys
  keep the reference's default, list and scores.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.kernels.layout import pow2ceil
from repro_torch.kernels.ops import fit_tile_n
from repro_torch.tune import device as D

# sentinel backend meaning "inherit the plan-wide backend": the port's only
DEFAULT = "default"


@dataclasses.dataclass(frozen=True)
class GemmVariant:
    """One point in a GEMM-template instance's variant space.

    ``None`` knobs keep the lowering default (the layout tile's rows, the
    kernel's 64-column slices, the budget fusion heuristic)."""

    backend: str = DEFAULT
    tile_rows: Optional[int] = None
    tile_n: Optional[int] = None
    fuse_gather: Optional[bool] = None

    def to_json(self) -> dict:
        return {"kind": "gemm", "backend": self.backend,
                "tile_rows": self.tile_rows, "tile_n": self.tile_n,
                "fuse_gather": self.fuse_gather}


@dataclasses.dataclass(frozen=True)
class TravVariant:
    """One point in a fused traversal instance's variant space."""

    backend: str = DEFAULT
    fuse_gather: Optional[bool] = None

    def to_json(self) -> dict:
        return {"kind": "trav", "backend": self.backend,
                "fuse_gather": self.fuse_gather}


GEMM_DEFAULT = GemmVariant()
TRAV_DEFAULT = TravVariant()


def variant_from_json(d: dict):
    if d["kind"] == "gemm":
        return GemmVariant(backend=d.get("backend", DEFAULT),
                           tile_rows=d.get("tile_rows"),
                           tile_n=d.get("tile_n"),
                           fuse_gather=d.get("fuse_gather"))
    if d["kind"] == "trav":
        return TravVariant(backend=d.get("backend", DEFAULT),
                           fuse_gather=d.get("fuse_gather"))
    raise ValueError(f"unknown variant kind {d!r}")


# ---------------------------------------------------------------------------
# op-instance keys
# ---------------------------------------------------------------------------
def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype (``torch.float32`` -> ``float32``), as
    the reference's keys write JAX's dtypes."""
    return str(dtype).replace("torch.", "")


def gemm_key(op, lay, x_rows: int, k: int, n: int, has_scale: bool,
             dtype, device) -> str:
    """Key of one lowered GemmSpec instance: spec identity x layout
    signature x dtype x device kind."""
    return "|".join([
        "gemm", op.gather.value, op.type_index.value, op.seg_ptr,
        f"k{k}", f"n{n}", f"s{int(has_scale)}",
        f"t{lay.tile}", f"g{lay.num_groups}",
        f"rp{pow2ceil(int(lay.row_map.shape[0]))}",
        f"x{pow2ceil(int(x_rows))}",
        dtype_name(dtype), D.device_kind(device),
    ])


def trav_key(agg_kind: str, d: int, compact_msg: bool, bc, dtype,
             device) -> str:
    """Key of one fused traversal-aggregation instance (softmax+agg or
    weighted agg) over a blocked-CSR layout."""
    return "|".join([
        "trav", agg_kind, f"d{d}", f"c{int(compact_msg)}",
        f"et{bc.edge_tile}", f"nb{bc.node_block}",
        f"ep{pow2ceil(int(bc.edge_map.shape[0]))}",
        dtype_name(dtype), D.device_kind(device),
    ])


# ---------------------------------------------------------------------------
# key parsing + candidate enumeration
# ---------------------------------------------------------------------------
_MIN_TILE_ROWS = 8  # the reference's smallest row tile (f32 sublanes)

_FUSABLE = ("edge_src", "edge_dst", "unique_src")


def parse_key(key: str) -> dict:
    """Decode a decision key back into the fields that shape its variant
    space. The tuner *records* the exact keys codegen queries (so key
    construction has a single source of truth) and enumerates from them."""
    parts = key.split("|")

    def num(part: str, prefix: str) -> int:
        assert part.startswith(prefix), (key, part, prefix)
        return int(part[len(prefix):])

    if parts[0] == "gemm":
        gather, tindex, seg = parts[1:4]
        return {
            "kind": "gemm", "gather": gather, "tindex": tindex, "seg": seg,
            "k": num(parts[4], "k"), "n": num(parts[5], "n"),
            "has_scale": bool(num(parts[6], "s")),
            "lay_tile": num(parts[7], "t"), "groups": num(parts[8], "g"),
            "padded_rows": num(parts[9], "rp"), "x_rows": num(parts[10], "x"),
            "dtype": parts[11], "device": parts[12],
            "fusable": gather in _FUSABLE and tindex != "none",
        }
    if parts[0] == "trav":
        return {
            "kind": "trav", "agg": parts[1], "d": num(parts[2], "d"),
            "compact_msg": bool(num(parts[3], "c")),
            "edge_tile": num(parts[4], "et"),
            "node_block": num(parts[5], "nb"),
            "padded_edges": num(parts[6], "ep"), "dtype": parts[7],
            "device": parts[8],
        }
    raise ValueError(f"unparseable decision key {key!r}")


def _col_tile_candidates(n: int, default: int) -> List[Optional[int]]:
    """Column-tile candidates with distinct *effective* tiles: the
    alternative is dropped where it clips to the device's ``default`` tile
    (``device.default_tile_n``). On the CPU the default is the reference's
    128, so for n <= 128 only the default survives, as there; on a card it
    is the kernels' 64, so for 64 < n <= 128 the list also holds
    ``tile_n=n``, which the reference's list does not."""
    cands: List[Optional[int]] = [None]          # the default
    alt = min(256, max(_MIN_TILE_ROWS, n))
    if fit_tile_n(n, alt) != fit_tile_n(n, default):
        cands.append(alt)
    return cands


def _row_tile_candidates(lay_tile: int) -> List[Optional[int]]:
    """Sub-tiles of the layout tile: each kernel row tile must stay within
    one type segment, which any divisor of the layout tile guarantees."""
    cands: List[Optional[int]] = [None]  # the layout tile itself
    t = lay_tile // 2
    while t >= _MIN_TILE_ROWS:
        cands.append(t)
        t //= 2
    return cands[:3]


def candidates_for_key(key: str, plan_backend: str) -> List:
    """Enumerate the (unpruned) variant space of one recorded op instance:
    the reference's space on its ``DEFAULT`` backend (the port's own
    kernels on ``plan_backend``, ``cuda`` or ``cpu``). The default variant
    is always first."""
    info = parse_key(key)
    if info["kind"] == "trav":
        # the materialized-gather kernels (K6, K8) are the variant
        return [TravVariant(), TravVariant(fuse_gather=False)]
    out: List = []
    for tr in _row_tile_candidates(info["lay_tile"]):
        for tn in _col_tile_candidates(
                info["n"], D.default_tile_n(info["device"])):
            for fg in ([None, False] if info["fusable"] else [None]):
                out.append(GemmVariant(tile_rows=tr, tile_n=tn,
                                       fuse_gather=fg))
    return _dedup(out)


def _dedup(variants: Sequence) -> List:
    seen, out = set(), []
    for v in variants:
        if v not in seen:
            seen.add(v)
            out.append(v)
    return out
