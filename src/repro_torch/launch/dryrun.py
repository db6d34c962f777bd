"""Multi-pod dry run of the port: one rank of each (arch x shape) cell on
the production meshes, run on fake tensors, its memory, cost and
collectives recorded (the port's counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun          # every cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod

Records land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``--out-dir`` elsewhere); ``launch/report.py`` renders them.

The reference lowers and compiles each cell for 512 fake host devices and
reads XLA's analyses. Eager PyTorch has nothing to compile, so the port
runs the step itself, as rank 0 of ``make_production_mesh`` (``16x16`` or
``2x16x16``) would, under ``FakeTensorMode`` (shapes only, nothing
allocated, as ``roofline.step_flops`` runs), through a ``CountingMesh``: a
``RankMesh`` whose collectives return correctly shaped results and tally
each one's wire bytes a rank by kind, with the reference's ring rules
(``repro/launch/roofline.py:271-288``): an all-reduce moves 2 x its
bytes; an all-gather, an all-to-all, a permute or a broadcast its
result's bytes. The port's reduce-scatter is an all-reduce keeping a
piece, so it is tallied as the all-reduce it runs (``coll_reduce-scatter``
stays 0). ``CountingMesh.wrap(mesh)`` tallies a real ``RankMesh``'s
collectives the same way while they run, so a fake run's tallies can be
held against real ranks'.

A record keeps the reference's fields where they mean something:

* ``memory.argument_bytes``: the rank's parameters, moments, step counter,
  caches and inputs (its rows of the batch), each from the rules'
  ``shard_shape`` (``argument_parts`` splits it); ``output_bytes``: what
  the step returns on the rank;
* ``cost.flops``: the rank's FLOPs by ``FlopCounterMode``;
* ``collectives``: the rank's ``flops``, ``mem_bytes_proxy`` (each op's
  operand and result bytes, summed by a dispatch mode, views and empty
  allocations skipped, as the reference's HLO proxy sums them per op;
  K10's forward, a kernel on the card, as its inputs and output, though
  its plain version runs on the fake tensors and its FLOPs count, every
  query-key pair, as ``step_flops`` counts them),
  ``collective_bytes`` and ``coll_<kind>`` (``calls`` counts them);
* ``roofline_raw`` (``roofline.roofline_terms`` with ``HW_H100``),
  ``model_flops``, ``model_flops_ratio``, ``t_memory_model_s``,
  ``analytic_mem_bytes_per_dev``;
* ``lower_s``: the seconds to build and run the step on fake tensors.

``None`` where eager PyTorch cannot give a field: ``temp_bytes`` and
``peak_bytes`` (no buffer assignment: the allocator's peak exists only on
a real run), ``generated_code_bytes`` and ``compile_s`` (nothing is
compiled). A step whose shapes depend on its data (the MoE dispatch's
``nonzero``) cannot run on fake tensors: its flops, collectives,
``mem_bytes_proxy``, ``output_bytes`` and roofline are ``None`` and
``reason`` says why, as ``step_flops`` does.

Flags are the reference's: ``--arch``, ``--shape``, ``--multi-pod``,
``--both-meshes``, ``--tag``, ``--attn-baseline`` (the rules'
``attn_head_sharding_only=False``: attention sharded on ``head_dim`` where
the heads do not split, which the run time gathers before use) and the
perf variants' (``--seq-shard``, ``--moe-ep``, ``--bf16-reduce``,
``--seq-shard-kv``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import (
    DataDependentOutputException, DynamicOutputShapeException,
    FakeTensorMode)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import configs as C
from repro_torch.launch import partitioning as PT
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import RankMesh, make_production_mesh
from repro_torch.launch.roofline import (
    HW_H100, analytic_memory_bytes, model_flops, roofline_terms)
from repro_torch.lm.config import SHAPES
from repro_torch.lm.model import TransformerLM
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves, tree_like

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True, eq=False)
class CountingMesh(RankMesh):
    """A ``RankMesh`` that tallies every collective's wire bytes a rank, by
    kind (``tallies``: ``coll_<kind>`` and ``calls``). ``fake`` (the
    default): no process group, each collective returns its result's
    shape from the operand alone; ``wrap(mesh)``: the real mesh's groups,
    each collective run as ``RankMesh`` runs it."""

    fake: bool = True
    tallies: Dict = dataclasses.field(default_factory=lambda: {
        "calls": {}, **{f"coll_{k}": 0 for k in KINDS}})

    @classmethod
    def of(cls, shape, rank: int = 0, device="cpu") -> "CountingMesh":
        """Rank ``rank`` of ``shape`` (a ``MeshShape``), fake."""
        return cls(tuple(shape.axis_names), tuple(shape.sizes), rank,
                   torch.device(device))

    @classmethod
    def wrap(cls, mesh: RankMesh) -> "CountingMesh":
        return cls(mesh.axis_names, mesh.sizes, mesh.rank, mesh.device,
                   mesh.backend, mesh.groups, fake=False)

    def _tally(self, kind: str, nbytes: int) -> None:
        self.tallies[f"coll_{kind}"] += nbytes
        self.tallies["calls"][kind] = self.tallies["calls"].get(kind, 0) + 1

    def collective_bytes(self) -> int:
        return sum(self.tallies[f"coll_{k}"] for k in KINDS)

    def all_reduce(self, t, axes, op: str = "sum"):
        if self.group_size(axes) == 1:
            return t
        self._tally("all-reduce", 2 * _nbytes(t))
        return t.detach().clone() if self.fake else \
            super().all_reduce(t, axes, op)

    def all_gather(self, t, axes, dim: int):
        n = self.group_size(axes)
        if n == 1:
            return t
        self._tally("all-gather", n * _nbytes(t))
        return torch.cat([t.detach()] * n, dim=dim) if self.fake else \
            super().all_gather(t, axes, dim)

    def all_to_all(self, t, axes):
        if self.group_size(axes) == 1:
            return t
        self._tally("all-to-all", _nbytes(t))
        return t.detach().clone() if self.fake else \
            super().all_to_all(t, axes)

    def send_recv(self, t, axis: str, shift: int = 1):
        if self.group_size(axis) == 1:
            return t
        self._tally("collective-permute", _nbytes(t))
        return t.detach().clone() if self.fake else \
            super().send_recv(t, axis, shift)

    def broadcast(self, t, axis: str, position: int):
        if self.group_size(axis) == 1:
            return t
        self._tally("broadcast", _nbytes(t))
        return t.detach().clone() if self.fake else \
            super().broadcast(t, axis, position)


class MemProxy(TorchDispatchMode):
    """Sums each op's tensor operand and result bytes (``total``), skipping
    views, empty allocations and queries (no tensor result), which move
    no memory. K10's forward is one kernel on the card: its plain
    version's ops are not summed, its ``q``, ``k``, ``v`` and output are
    (``flash_attention.watch_forward``)."""

    _SKIP = ("empty", "empty_like", "new_empty", "empty_strided",
             "new_empty_strided", "detach", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.total = 0
        self.inside = 0

    def __enter__(self):
        import repro_torch.kernels.flash_attention as F

        def before():
            self.inside += 1

        def after(q, k, v, out):
            self.inside -= 1
            if out is not None:
                self.total += sum(_nbytes(t) for t in (q, k, v, out))
        self._watch = F.watch_forward(before, after)
        self._watch.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._watch.__exit__(None, None, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        results = [t for t in tree_flatten(out)[0]
                   if isinstance(t, torch.Tensor)]
        if results and not (self.inside or getattr(func, "is_view", False)
                            or func.__name__.split(".")[0] in self._SKIP):
            operands = tree_flatten((args, kwargs or {}))[0]
            self.total += sum(_nbytes(t) for t in operands + results
                              if isinstance(t, torch.Tensor))
        return out


# ---------------------------------------------------------------------------
# one rank's step
# ---------------------------------------------------------------------------
def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def rank_args(bundle: ST.StepBundle, cfg, cell, mesh):
    """The step's arguments as this rank holds them (zeros: parameters,
    moments and caches as their shards, the global batch) and the bytes of
    each part a rank stores under the rules' ``shard_shape`` (its rows of
    the batch)."""
    part, dev = bundle.partitioner, mesh.device
    meta = TransformerLM(cfg, device="meta")._build(None)
    specs = ST.param_specs(part, bundle.model)
    params = tree_like(meta, [_zeros(PT.shard_shape(mesh, s, m.shape),
                                     m.dtype, dev)
                              for m, s in zip(tree_leaves(meta), specs)])
    data = {k: v for k, v in ST.input_specs(cfg, cell).items()
            if k != "index"}
    parts = {"params": sum(_nbytes(t) for t in tree_leaves(params)),
             "moments": 0, "step": 0, "caches": 0,
             "inputs": sum(
                 PT._prod(PT.shard_shape(mesh, part.batch_spec(
                     tuple(v.shape)), v.shape)) * v.element_size()
                 for v in data.values())}
    batch = {k: _zeros(v.shape, v.dtype, dev) for k, v in data.items()}
    if cell.mode == "train":
        state = ST.init_state(AdamW(), bundle.model, part, None,
                              params=params)
        parts["moments"] = sum(_nbytes(t) for t in
                               tree_leaves(state.mu) + tree_leaves(state.nu))
        parts["step"] = _nbytes(state.step)
        return (state, batch), parts
    if cell.mode == "prefill":
        args = (params, batch["tokens"])
        if "frontend" in batch:
            args += (batch["frontend"],)
        return args, parts
    a_cache = TransformerLM(cfg, device="meta").init_cache(
        cell.global_batch, cell.seq_len)
    caches = tree_like(a_cache, [
        _zeros(PT.shard_shape(mesh, s, c.shape), c.dtype, dev)
        for c, s in zip(tree_leaves(a_cache), ST.cache_specs(part,
                                                             a_cache))])
    parts["caches"] = sum(_nbytes(t) for t in tree_leaves(caches))
    return (params, batch["token"], cell.seq_len - 1, caches), parts


def run_rank_step(cfg, cell, mesh: CountingMesh, part_kwargs=None) -> Dict:
    """Build ``cell``'s step on ``mesh`` and run it once on its zero
    arguments (fake tensors when entered under ``FakeTensorMode``, real
    ones on a wrapped mesh): the argument parts, the output bytes, the
    FLOPs, the memory proxy and the collective tallies of this rank."""
    from torch.utils.flop_counter import FlopCounterMode

    bundle = ST.build_step(cfg, cell, mesh=mesh, remat=False,
                           part_kwargs=part_kwargs)
    args, parts = rank_args(bundle, cfg, cell, mesh)
    out = {"argument_parts": parts, "output_bytes": None, "flops": None,
           "mem_bytes_proxy": None, "tallies": None, "reason": ""}
    try:
        with FlopCounterMode(display=False) as flops, MemProxy() as mem:
            result = bundle.fn(*args)
    except (DataDependentOutputException, DynamicOutputShapeException) as e:
        out["reason"] = f"{type(e).__name__}: {e}"[:300]
        return out
    leaves, _ = tree_flatten(result)
    out.update(output_bytes=sum(_nbytes(t) for t in leaves
                                if isinstance(t, torch.Tensor)),
               flops=float(flops.get_total_flops()),
               mem_bytes_proxy=float(mem.total),
               tallies=json.loads(json.dumps(mesh.tallies)))
    return out


def run_cell(arch: str, shape: str, multi_pod: bool, *, part_kwargs=None,
             tag: str = "", verbose: bool = True, cfg=None,
             mesh_shape=None) -> dict:
    """The record of rank 0 of ``arch`` x ``shape`` on the production mesh
    (``cfg`` / ``mesh_shape`` replace the registry's config and the
    production shape: the tests' reduced cells)."""
    cfg = cfg or C.get_config(arch)
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    ms = mesh_shape or make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(n) for n in ms.sizes)
    chips = ms.size
    rec = {
        "arch": arch, "shape": cell.name, "mesh": mesh_name, "chips": chips,
        "rank": 0, "mode": cell.mode, "tag": tag or "baseline",
        "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.active_param_count() / 1e9,
        "part_kwargs": part_kwargs or {},
    }
    t0 = time.time()
    with FakeTensorMode():
        got = run_rank_step(cfg, cell, CountingMesh.of(ms), part_kwargs)
    rec["lower_s"] = time.time() - t0
    rec["compile_s"] = None
    parts = got["argument_parts"]
    rec["memory"] = {
        "argument_bytes": sum(parts.values()),
        "argument_parts": parts,
        "output_bytes": got["output_bytes"],
        "temp_bytes": None, "peak_bytes": None,
        "generated_code_bytes": None,
    }
    rec["reason"] = got["reason"]
    flops, mem = got["flops"], got["mem_bytes_proxy"]
    rec["cost"] = {} if flops is None else {"flops": flops}
    rec["mem_bytes_proxy"] = mem
    if got["tallies"] is None:
        rec["collectives"] = rec["roofline_raw"] = None
    else:
        t = got["tallies"]
        rec["collectives"] = {
            "flops": flops, "mem_bytes_proxy": mem,
            "collective_bytes": float(sum(t[f"coll_{k}"] for k in KINDS)),
            **{f"coll_{k}": float(t[f"coll_{k}"]) for k in KINDS},
            "calls": t["calls"]}
        rec["roofline_raw"] = roofline_terms(rec["cost"], rec["collectives"],
                                             chips, HW_H100)
    mf = model_flops(cfg, cell)
    total = rec["roofline_raw"]["total_flops"] if rec["roofline_raw"] \
        else None
    rec["model_flops"] = mf
    rec["model_flops_ratio"] = mf / total if total else None
    amem = analytic_memory_bytes(cfg, cell, chips)
    rec["t_memory_model_s"] = amem / HW_H100.hbm_bw
    rec["analytic_mem_bytes_per_dev"] = amem
    if verbose:
        f = "-" if flops is None else f"{flops:.3e}"
        c = "-" if rec["collectives"] is None else \
            f"{rec['collectives']['collective_bytes']:.3e}"
        print(f"[dryrun] {arch:24s} {cell.name:12s} {mesh_name:8s} "
              f"run={rec['lower_s']:6.1f}s args/rank="
              f"{rec['memory']['argument_bytes'] / 2**30:7.2f}GiB "
              f"flops/rank={f} coll B/rank={c}"
              + (f" ({rec['reason'][:60]})" if rec["reason"] else ""))
    return rec


def save(rec: dict, out_dir: Optional[pathlib.Path] = None) -> pathlib.Path:
    out_dir = pathlib.Path(out_dir or ART)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "" if rec["tag"] == "baseline" else f"__{rec['tag']}"
    path = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    path.write_text(json.dumps(rec, indent=2, default=str))
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="single arch id")
    ap.add_argument("--shape", default=None, help="single shape cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--attn-baseline", action="store_true",
                    help="reproduce pre-v-A attention sharding (hd "
                         "fallback)")
    PT.add_variant_flags(ap)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=None,
                    help=f"where the records go (default {ART})")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else C.ARCHS
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    part_kwargs = dict(PT.variant_kwargs(args) or {})
    if args.attn_baseline:
        part_kwargs["attn_head_sharding_only"] = False
    part_kwargs = part_kwargs or None
    failures, saved = [], []
    t0 = time.time()
    for arch in archs:
        shapes = [args.shape] if args.shape else C.applicable_shapes(arch)
        for shape in shapes:
            if shape not in C.applicable_shapes(arch):
                print(f"[dryrun] SKIP {arch} {shape} (long-context needs "
                      f"sub-quadratic attention)")
                continue
            for mp in meshes:
                try:
                    rec = run_cell(arch, shape, mp, part_kwargs=part_kwargs,
                                   tag=args.tag)
                    saved.append(save(rec, args.out_dir))
                except Exception as e:  # noqa: BLE001 - reported, then raised
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"[dryrun] FAIL {arch} {shape} mp={mp}: {e}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print(f"[dryrun] all requested cells ran on fake tensors "
          f"({len(saved)} records) in {time.time() - t0:.1f} s")
    return saved


if __name__ == "__main__":
    main()
