"""Render the dry run's tables from its records (the port's counterpart of
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report [--tag baseline] \\
        [--dir artifacts/dryrun_torch]

Four sections, as the reference's: the dry-run table of each mesh, the
roofline of the single-pod mesh, the collective breakdown of its top
cells and the hill-climb picks. The roofline fraction is the useful
model FLOPs' time a chip at the H100's 989e12 bf16 FLOP/s over the
dominant bound (the reference divides by the v5e's 197e12). A field the
record holds as ``None`` (the dry run's fields eager PyTorch cannot give,
and every count of a step with data-dependent shapes) prints as ``-``;
``args/dev`` is the rank's own (the port's records are per rank).
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional

from repro_torch.launch.dryrun import ART
from repro_torch.launch.roofline import HW_H100

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MOE_ARCHS = ("moonshot-v1-16b-a3b", "grok-1-314b", "jamba-v0.1-52b")


def load(tag: str = "baseline", directory=None) -> List[Dict]:
    recs = []
    for p in sorted(pathlib.Path(directory or ART).glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("tag", "baseline") == tag:
            recs.append(rec)
    return recs


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.2f}"


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def fmt_e(x):
    return "-" if x is None else f"{x:.2e}"


def _order(r):
    shape = r["shape"]
    return (r["arch"], SHAPE_ORDER.index(shape) if shape in SHAPE_ORDER
            else len(SHAPE_ORDER), shape)


def _flops(r) -> Optional[float]:
    return (r.get("collectives") or {}).get("flops")


def dryrun_table(recs: List[Dict], mesh: str) -> str:
    rows = sorted((r for r in recs if r["mesh"] == mesh), key=_order)
    out = [
        "| arch | shape | mode | lower | compile | args/dev GiB | "
        "temp/dev GiB | HLO flops/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        m = r["memory"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mode']} "
            f"| {fmt_s(r.get('lower_s'))} | {fmt_s(r.get('compile_s'))} "
            f"| {fmt_bytes(m['argument_bytes'])} "
            f"| {fmt_bytes(m['temp_bytes'])} | {fmt_e(_flops(r))} |")
    return "\n".join(out)


def roofline_fraction(r) -> Optional[float]:
    """Useful model FLOPs' time a chip at 989e12 over the dominant bound."""
    t = r.get("roofline_raw")
    if not t:
        return None
    t_model = (r.get("model_flops", 0) / r["chips"]) / HW_H100.peak_flops
    bound = max(t["t_compute_s"], r.get("t_memory_model_s", 0),
                t["t_collective_s"])
    return t_model / bound if bound else 0.0


def roofline_table(recs: List[Dict], mesh: str = "16x16") -> str:
    rows = sorted((r for r in recs if r["mesh"] == mesh), key=_order)
    out = [
        "| arch | shape | t_compute | t_mem(HLO) | t_mem(model) | t_coll | "
        "dominant | MODEL/HLO flops | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        t = r.get("roofline_raw") or {}
        ratio = r.get("model_flops_ratio")
        frac = roofline_fraction(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t.get('t_compute_s'))} "
            f"| {fmt_s(t.get('t_memory_s'))} "
            f"| {fmt_s(r.get('t_memory_model_s'))} "
            f"| {fmt_s(t.get('t_collective_s'))} "
            f"| **{t.get('dominant', '-')}** "
            f"| {'-' if ratio is None else f'{ratio:.2f}'} "
            f"| {'-' if frac is None else f'{frac:.2f}'} |")
    return "\n".join(out)


def collective_breakdown(recs: List[Dict], mesh: str = "16x16") -> str:
    rows = [r for r in recs if r["mesh"] == mesh]
    rows.sort(key=lambda r: -((r.get("collectives") or {})
                              .get("collective_bytes") or 0))
    out = ["| arch | shape | total GB/dev | all-reduce | all-gather | "
           "reduce-scatter | all-to-all | permute |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows[:12]:
        c = r.get("collectives")

        def gb(k):
            return "-" if c is None else f"{c.get(k, 0)/1e9:.1f}"
        out.append(
            f"| {r['arch']} | {r['shape']} | {gb('collective_bytes')} "
            f"| {gb('coll_all-reduce')} | {gb('coll_all-gather')} "
            f"| {gb('coll_reduce-scatter')} | {gb('coll_all-to-all')} "
            f"| {gb('coll_collective-permute')} |")
    return "\n".join(out)


def pick_hillclimb_cells(recs: List[Dict]) -> Dict[str, Optional[Dict]]:
    """worst roofline fraction / most collective-bound / most
    technique-representative (the biggest MoE); among the single-pod
    records with a roofline (``None`` where there is none)."""
    rows = [r for r in recs if r["mesh"] == "16x16" and r.get("roofline_raw")]

    def coll(r):
        t = r["roofline_raw"]
        return t["t_collective_s"] / max(1e-12, t["t_compute_s"])

    moe = [r for r in rows if r["arch"] in MOE_ARCHS]
    return {
        "worst_fraction": min(rows, key=roofline_fraction) if rows else None,
        "most_collective": max(rows, key=coll) if rows else None,
        "technique_rep": max(moe, key=lambda r: r["roofline_raw"][
            "t_collective_s"]) if moe else None,
    }


def render(recs: List[Dict], tag: str = "baseline") -> str:
    lines = [f"## Dry-run ({len(recs)} records, tag={tag})", ""]
    for mesh in ("16x16", "2x16x16"):
        lines += [f"### mesh {mesh}", "", dryrun_table(recs, mesh), ""]
    lines += ["## Roofline (single-pod 16x16)", "", roofline_table(recs), "",
              "### Collective breakdown (top cells)", "",
              collective_breakdown(recs), "", "### Hillclimb picks"]
    for k, r in pick_hillclimb_cells(recs).items():
        lines.append(f"- {k}: " + ("-" if r is None
                                   else f"{r['arch']} x {r['shape']}"))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--dir", default=None,
                    help=f"the records' directory (default {ART})")
    args = ap.parse_args(argv)
    text = render(load(args.tag, args.dir), args.tag)
    print(text)
    return text


if __name__ == "__main__":
    main()
