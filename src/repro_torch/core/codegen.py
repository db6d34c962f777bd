"""Hector code generator (paper §3.6), PyTorch/CUDA port.

The counterpart of ``repro.core.codegen``: each ``GemmSpec`` instantiates
the segment-MM op with its access scheme resolved, each ``TraversalSpec``
executes its fused statement region, pattern-matching the canonical
edge-softmax(+aggregate) region onto the fused traversal kernels, and the
rest runs as plain torch ops. Execution is eager; which kernel runs follows
the device of the tensors (``kernels/ops.py``).

A ``decisions`` table (``tune.TuningDecisions``, from the autotuner; or
``None``) picks each op's variant, as in the reference: the GEMMs'
``tile_rows`` / ``tile_n`` and, for the GEMMs and the fused traversals,
whether the access-scheme gather runs inside the kernel (K1, K3, K7) or
over a materialized copy (K4, K6, K8). Where the table is silent the
default is ``_fits_budget``: the reference's ``_fits_vmem`` with the budget
of the tensors' device (``tune/device.py``), which is unbounded on a CUDA
card, where the Hopper kernels gather rows from global memory and nothing
has to stay resident, so every fusable op fuses there; on the CPU it is the
reference's VMEM-derived value, so CPU runs take the reference's defaults.
A decision naming a backend other than ``default`` raises: the port has
one implementation of each op, its own kernels.

The per-edge attention that the fused softmax + aggregation region also
names is computed only when a plan output or another statement reads it
(with or without autograd): JAX's ``jit`` drops it as dead code, eager
PyTorch would not.

Everything here runs under autograd: the ops are differentiable
(``kernels/ops.py``), so the train executors call ``execute_plan`` and
``execute_block_sequence`` as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.graph import GraphTensors, HeteroGraph, to_device
from repro_torch.core.ir import inter_op as I
from repro_torch.core.ir import intra_op as O
from repro_torch.kernels import layout as L
from repro_torch.kernels import ops as K
from repro_torch.tune import device as tunedev
from repro_torch.tune import space as tspace


@dataclasses.dataclass(frozen=True, eq=False)
class KernelLayouts:
    """Per-graph tile-aligned layouts for the generated kernels.

    Built on the host (NumPy) as CPU tensors; ``to(device)`` moves them.
    Besides the segment/CSR layouts this carries the padded gather-index
    layouts (§3.3 access schemes composed with the tile padding maps) and
    the per-destination in-degree used by mean aggregation.
    """

    edge_seg: K.PaddedSegmentsDev      # etype segments over canonical edges
    unique_seg: K.PaddedSegmentsDev    # etype segments over unique (src,etype)
    node_seg: K.PaddedSegmentsDev      # ntype segments over nodes
    blocked: K.BlockedCSRDev           # dst-sorted blocked CSR
    edge_src_rows: torch.Tensor        # [Rp_e] padded slot -> src node, or -1
    edge_dst_rows: torch.Tensor        # [Rp_e] padded slot -> dst node, or -1
    unique_src_rows: torch.Tensor      # [Rp_u] padded slot -> src node, or -1
    dst_deg: torch.Tensor              # [N] float32 per-destination in-degree

    def to(self, device, non_blocking: bool = False) -> "KernelLayouts":
        """Every tensor on ``device``; host tensors bound for a card are
        pinned first, so ``non_blocking=True`` copies run asynchronously."""
        return KernelLayouts(
            edge_seg=self.edge_seg.to(device, non_blocking),
            unique_seg=self.unique_seg.to(device, non_blocking),
            node_seg=self.node_seg.to(device, non_blocking),
            blocked=self.blocked.to(device, non_blocking),
            **{f: to_device(getattr(self, f), device, non_blocking)
               for f in ("edge_src_rows", "edge_dst_rows",
                         "unique_src_rows", "dst_deg")})


def build_kernel_layouts(
    hg: HeteroGraph, tile: int = 128, node_block: int = 128,
    bucket: bool = False, row_floors=None,
) -> KernelLayouts:
    """Build the per-graph layouts (CPU tensors); with ``bucket=True`` every
    layout is grown to power-of-two row/edge-slot counts (pure padding), so
    the set of kernel shapes stays small across sampled blocks.

    ``row_floors`` (a ``bucketing.LayoutRowFloors``) clamps each field's
    bucket to a grow-only floor shared across blocks."""
    edge_ps = L.pad_segments(hg.etype_ptr, tile)
    unique_ps = L.pad_segments(hg.unique_etype_ptr, tile)
    node_ps = L.pad_segments(hg.ntype_ptr, tile)
    bc = L.block_csr(hg.dst_ptr, edge_tile=tile, node_block=node_block)
    if bucket:
        if tile & (tile - 1):
            raise ValueError("bucketed layouts need a power-of-two tile")

        def bucket_rows(name: str, rows: int) -> int:
            t = max(tile, L.pow2ceil(rows))
            if row_floors is not None:
                t = row_floors.raise_to(name, t)
            return t
        edge_ps = L.pad_segments_rows(
            edge_ps, bucket_rows("edge", edge_ps.padded_rows))
        unique_ps = L.pad_segments_rows(
            unique_ps, bucket_rows("unique", unique_ps.padded_rows))
        node_ps = L.pad_segments_rows(
            node_ps, bucket_rows("node", node_ps.padded_rows))
        bc = L.pad_blocked_csr(bc, bucket_rows("csr", bc.padded_edges))
    return KernelLayouts(
        edge_seg=K.padded_segments_dev(edge_ps),
        unique_seg=K.padded_segments_dev(unique_ps),
        node_seg=K.padded_segments_dev(node_ps),
        blocked=K.blocked_csr_dev(bc, hg.perm_dst, hg.edge_to_unique),
        edge_src_rows=K._tensor(L.compose_gather_rows(edge_ps, hg.src)),
        edge_dst_rows=K._tensor(L.compose_gather_rows(edge_ps, hg.dst)),
        unique_src_rows=K._tensor(
            L.compose_gather_rows(unique_ps, hg.unique_src)),
        dst_deg=torch.from_numpy(np.diff(hg.dst_ptr).astype(np.float32)),
    )


# ---------------------------------------------------------------------------
# parameters: initialization from the plan's weight table, or carried over
# from the reference
# ---------------------------------------------------------------------------
def _param_shape(w: I.Weight, num_etypes: int, num_ntypes: int) -> tuple:
    if w.indexed_by == "etype":
        lead = (num_etypes,)
    elif w.indexed_by in ("ntype", "ntype_src", "ntype_dst"):
        lead = (num_ntypes,)
    else:
        lead = ()
    return lead + tuple(w.shape)


def _param_names(plan: O.Plan) -> List[str]:
    return sorted(n for n in plan.weights if not n.startswith("_wprod"))


def init_params(
    plan: O.Plan, num_etypes: int, num_ntypes: int,
    generator: torch.Generator, dtype=torch.float32, device="cpu",
) -> Dict[str, torch.Tensor]:
    """Normal(0, 1/fan_in) weights for every name in the plan's weight
    table (hoisted weight products excluded), drawn in sorted-name order
    from ``generator`` on the CPU, then moved to ``device``."""
    params: Dict[str, torch.Tensor] = {}
    for name in _param_names(plan):
        w = plan.weights[name]
        shape = _param_shape(w, num_etypes, num_ntypes)
        fan_in = w.shape[0] if len(w.shape) >= 1 else 1
        scale = 1.0 / math.sqrt(max(1, fan_in))
        t = torch.randn(shape, generator=generator, dtype=torch.float32)
        params[name] = (t * scale).to(dtype=dtype, device=device)
    return params


def params_from_reference(
    params_np: Sequence[Dict[str, np.ndarray]], device="cpu", *,
    plans: Optional[Sequence[O.Plan]] = None,
    num_etypes: Optional[int] = None, num_ntypes: Optional[int] = None,
) -> List[Dict[str, torch.Tensor]]:
    """The reference's per-layer params (numpy arrays, e.g.
    ``np.asarray(jax_array)``) as the port's: one dict of float32 tensors
    per layer on ``device``, under the same weight names.

    With ``plans`` the names are checked against each plan's weight table,
    and with ``num_etypes`` / ``num_ntypes`` the shapes too; a mismatch
    raises ``ValueError``."""
    params_np = list(params_np)
    if plans is not None and len(plans) != len(params_np):
        raise ValueError(f"{len(params_np)} parameter dicts for "
                         f"{len(plans)} layers")
    out: List[Dict[str, torch.Tensor]] = []
    for i, p in enumerate(params_np):
        if plans is not None:
            want = set(_param_names(plans[i]))
            if set(p) != want:
                raise ValueError(
                    f"layer {i}: weights {sorted(p)} do not match the "
                    f"plan's weight table {sorted(want)}")
        layer = {}
        for name, arr in p.items():
            arr = np.asarray(arr)
            if plans is not None and num_etypes is not None:
                shape = _param_shape(plans[i].weights[name], num_etypes,
                                     num_ntypes or 1)
                if tuple(arr.shape) != shape:
                    raise ValueError(f"layer {i}: weight {name!r} has shape "
                                     f"{tuple(arr.shape)}, the plan needs "
                                     f"{shape}")
            layer[name] = torch.from_numpy(
                np.array(arr, dtype=np.float32)).to(device)
        out.append(layer)
    return out


# ---------------------------------------------------------------------------
# the generated forward function
# ---------------------------------------------------------------------------
_SOFTMAX_TAIL = ("segment_max", "gather_dst_var", "elementwise", "elementwise",
                 "segment_sum", "gather_dst_var", "elementwise")


class _Env:
    """Execution environment: name -> tensor, with layout-aware edge reads."""

    def __init__(self, plan: O.Plan, gt: GraphTensors, params, feats):
        self.plan = plan
        self.gt = gt
        self.vals: Dict[str, torch.Tensor] = {}
        for name, v in feats.items():
            self.vals["node:" + name] = v
        self.params = dict(params)

    def get(self, name: str) -> torch.Tensor:
        if name.startswith("scalar:"):
            # a fill, not a host-to-device copy: plans may be captured
            return torch.full((), float(name.split(":", 1)[1]),
                              dtype=torch.float32, device=self.gt.device)
        if name in self.vals:
            return self.vals[name]
        if name.startswith("node:") and name[5:] in self.vals:
            return self.vals[name[5:]]
        raise KeyError(f"undefined IR value {name!r}; have {list(self.vals)}")

    def get_edge_vanilla(self, name: str) -> torch.Tensor:
        """Read an edge var in canonical per-edge order, resolving compact
        layout through the edge_to_unique indirection."""
        v = self.get(name)
        if self.plan.layouts.get(name) == I.Layout.COMPACT:
            return v[self.gt.edge_to_unique.long()]
        return v

    def set(self, name: str, v: torch.Tensor):
        self.vals[name] = v


def _elementwise(op: str, args, alpha: float = 0.01):
    a = args[0]
    if len(args) == 1:
        if op == "exp":
            return torch.exp(a)
        if op == "leaky_relu":
            return torch.where(a > 0, a, alpha * a)
        if op == "relu":
            return torch.clamp(a, min=0)
        if op == "sigmoid":
            return torch.sigmoid(a)
        if op == "tanh":
            return torch.tanh(a)
        if op == "neg":
            return -a
        raise ValueError(op)
    b = args[1]
    if a.dim() == 2 and b.dim() == 1:
        b = b[:, None]
    elif a.dim() == 1 and b.dim() == 2:
        a = a[:, None]
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        return a / b
    raise ValueError(op)


def execute_plan(
    plan: O.Plan,
    params: Dict[str, torch.Tensor],
    gt: GraphTensors,
    feats: Dict[str, torch.Tensor],
    kl: KernelLayouts,
    decisions=None,
) -> Dict[str, torch.Tensor]:
    """Run the lowered layer under the per-op ``decisions`` (or the
    defaults). Returns {output name: tensor}."""
    env = _Env(plan, gt, params, feats)
    derived: Dict[str, torch.Tensor] = {}
    for op in plan.ops:
        execute_op(op, env, derived, gt, kl, decisions)
    return {name: env.get(name) for name in plan.outputs}


def execute_op(op, env: _Env, derived: Dict[str, torch.Tensor],
               gt: GraphTensors, kl: KernelLayouts, decisions=None) -> None:
    """Execute ONE lowered op spec against the environment (the loop body
    of ``execute_plan``). ``derived`` carries hoisted weight products
    (``WeightProductSpec`` outputs) that later GEMMs resolve before the
    parameter table."""
    if isinstance(op, O.WeightProductSpec):
        wm, wv = env.params[op.w_matrix], env.params[op.w_vector]
        # (x W_r) · w_r == x (W_r w_r^T): hoisted weight-weight BMM, a
        # plain product the reference also leaves to the framework
        derived[op.out] = torch.einsum("rdf,rf->rd", wm, wv)[..., None]
    elif isinstance(op, O.GemmSpec):
        _exec_gemm(op, env,
                   lambda name: derived.get(name, env.params.get(name)),
                   gt, kl, decisions)
    elif isinstance(op, O.TraversalSpec):
        _exec_traversal(op, env, gt, kl, decisions)
    elif isinstance(op, O.FallbackSpec):
        raise NotImplementedError(
            f"fallback op {op.stmt} reached the executor; add a torch "
            f"lowering for it"
        )


# ---------------------------------------------------------------------------
# block-sequence execution (sampled mini-batch path)
# ---------------------------------------------------------------------------
_ACTIVATIONS = {
    "relu": lambda x: torch.clamp(x, min=0),
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "none": lambda x: x,
    None: lambda x: x,
}


def execute_block_sequence(
    plans,                  # List[O.Plan], one lowered layer per hop
    params,                 # List[Dict[str, Tensor]] per layer
    gts,                    # List[GraphTensors] per block
    kls,                    # List[KernelLayouts] per block
    dst_locals,             # List[Tensor]: out-frontier rows per block
    seed_perm: torch.Tensor,  # final-frontier row of each requested seed
    feats: Dict[str, torch.Tensor],  # features for the first block's nodes
    activation: str = "relu",
    decisions=None,
) -> torch.Tensor:
    """Run one lowered layer per sampled hop, narrowing to each hop's output
    frontier, and gather the requested seed rows from the last hop."""
    if not (len(plans) == len(params) == len(gts) == len(kls)
            == len(dst_locals)):
        raise ValueError("plans/params/blocks length mismatch")
    act = _ACTIVATIONS[activation]
    cur = dict(feats)
    h = None
    last = len(plans) - 1
    for i, (plan, p, gt, kl) in enumerate(zip(plans, params, gts, kls)):
        out = execute_plan(plan, p, gt, cur, kl, decisions)
        h = out[plan.outputs[0]][dst_locals[i].long()]
        if i < last:
            cur = {"feature": act(h)}
    return h[seed_perm.long()]


# gather schemes whose row lists have a precomposed padded gather-index
# layout in KernelLayouts (-> the in-kernel gather of K1)
_FUSABLE_GATHERS = (O.GatherScheme.BY_EDGE_SRC, O.GatherScheme.BY_EDGE_DST,
                    O.GatherScheme.BY_UNIQUE_SRC)


def _fits_budget(arr: torch.Tensor, *index_arrays) -> bool:
    """Default gather-fusion heuristic (the reference's ``_fits_vmem``):
    the ungathered source block plus the gather / slot-map index arrays
    within the fusion budget of the device they lie on
    (``tune/device.py``: unbounded on a CUDA card; overridable by env)."""
    total = arr.numel() * arr.element_size()
    for ix in index_arrays:
        if ix is not None:
            total += ix.numel() * ix.element_size()
    return total <= tunedev.fused_gather_budget_bytes(arr.device)


def _checked(dec, key: str):
    """A decided variant, refused if it names a backend the port lacks."""
    if dec is not None and dec.backend != tspace.DEFAULT:
        raise ValueError(
            f"tuning decision for {key!r} names backend {dec.backend!r}; "
            f"the port runs its own kernels only (backend "
            f"{tspace.DEFAULT!r})")
    return dec


def _gemm_decision(decisions, op, lay, x_src, w, has_scale):
    if decisions is None or lay is None:
        return None
    key = tspace.gemm_key(op, lay, int(x_src.shape[0]), int(w.shape[-2]),
                          int(w.shape[-1]), has_scale, x_src.dtype,
                          x_src.device)
    return _checked(decisions.lookup(key), key)


def _trav_decision(decisions, kind, msg, compact_msg, kl):
    if decisions is None:
        return None
    key = tspace.trav_key(kind, int(msg.shape[-1]), compact_msg, kl.blocked,
                          msg.dtype, msg.device)
    return _checked(decisions.lookup(key), key)


def _fuse(dec, *budget_args) -> bool:
    """The decided ``fuse_gather``, else the budget heuristic."""
    if dec is not None and dec.fuse_gather is not None:
        return dec.fuse_gather
    return _fits_budget(*budget_args)


def _exec_gemm(op: O.GemmSpec, env: _Env, weight, gt: GraphTensors,
               kl: KernelLayouts, decisions=None):
    w = weight(op.weight)

    scale = None
    if op.per_row_scale is not None:
        scale = env.get_edge_vanilla(op.per_row_scale)
        if scale.dim() == 2:
            scale = scale[:, 0]

    # resolve the access scheme: layout, padded gather map, gather list
    if op.gather == O.GatherScheme.BY_EDGE_SRC:
        lay, gmap, gidx = kl.edge_seg, kl.edge_src_rows, gt.src
        x_src = env.get(op.x_source)
    elif op.gather == O.GatherScheme.BY_EDGE_DST:
        lay, gmap, gidx = kl.edge_seg, kl.edge_dst_rows, gt.dst
        x_src = env.get(op.x_source)
    elif op.gather == O.GatherScheme.BY_UNIQUE_SRC:
        lay, gmap, gidx = kl.unique_seg, kl.unique_src_rows, gt.unique_src
        x_src = env.get(op.x_source)
    elif op.gather == O.GatherScheme.BY_NODE:
        lay, gmap, gidx = kl.node_seg, None, None
        x_src = env.get(op.x_source)
    else:  # IDENTITY: var already in segment-sorted order
        x_src = env.get(op.x_source.split(":", 1)[1]
                        if op.x_source.startswith("edge:") else op.x_source)
        lay = {
            "etype_ptr": kl.edge_seg,
            "unique_etype_ptr": kl.unique_seg,
            "ntype_ptr": kl.node_seg,
        }.get(op.seg_ptr)
        gmap = gidx = None

    typed = op.type_index != O.TypeIndex.NONE
    dec = _gemm_decision(decisions, op, lay, x_src, w, scale is not None) \
        if typed else None
    tiles = {} if dec is None else dict(tile_rows=dec.tile_rows,
                                         tile_n=dec.tile_n)
    if (typed and gmap is not None and op.gather in _FUSABLE_GATHERS
            and _fuse(dec, x_src, gmap)):
        # the gather runs inside K1 from the padded gather-index layout
        y = K.segment_mm_gather(x_src, w, lay, gmap, row_scale=scale,
                                **tiles)
    else:
        x = x_src if gidx is None else x_src[gidx.long()]
        if not typed:
            y = x @ w
            if scale is not None:
                y = y * scale[:, None]
        else:
            y = K.segment_mm(x, w, lay, row_scale=scale, **tiles)
    out = y[:, 0] if (op.out_cols == 1 and y.shape[-1] == 1) else y
    env.set(op.out, out)


def _edge_msg(env: _Env, gt: GraphTensors, kl: KernelLayouts, name: str):
    """Resolve a feature-wide edge var in its *storage* order for the
    traversal kernels: COMPACT vars stay in the unique-pair table and carry
    the precomposed slot map, so the per-edge expansion happens in-kernel
    instead of materializing an [E, d] copy here."""
    v = env.get(name)
    if env.plan.layouts.get(name) == I.Layout.COMPACT:
        return v, gt.edge_to_unique, kl.blocked.edge_map_unique
    return v, None, kl.blocked.edge_map


def _read_elsewhere(plan: O.Plan, region: O.TraversalSpec, fused_at: int,
                    name: str) -> bool:
    """Is ``name`` a plan output, or read by any statement or GEMM other
    than the fused aggregation ``region.stmts[fused_at]``?"""
    if name in plan.outputs:
        return True
    for op in plan.ops:
        if isinstance(op, O.TraversalSpec):
            for j, s in enumerate(op.stmts):
                if op is region and j == fused_at:
                    continue
                if name in s.ins or s.scale == name:
                    return True
        elif isinstance(op, O.GemmSpec):
            if name in (op.x_source.split(":", 1)[-1], op.per_row_scale):
                return True
    return False


def _exec_traversal(op: O.TraversalSpec, env: _Env, gt: GraphTensors,
                    kl: KernelLayouts, decisions=None):
    """Execute a fused traversal region, fusing the canonical softmax(+agg)
    pattern onto the traversal kernels when present."""
    stmts = op.stmts
    i = 0
    while i < len(stmts):
        # peephole: expanded softmax (7 stmts) [+ segment_sum scaled by it]
        if (
            i + len(_SOFTMAX_TAIL) <= len(stmts)
            and tuple(s.kind for s in stmts[i : i + 7]) == _SOFTMAX_TAIL
        ):
            score_name = stmts[i].ins[0]
            att_name = stmts[i + 6].out
            scores = env.get_edge_vanilla(score_name)
            if scores.dim() == 2:
                scores = scores[:, 0]
            nxt = stmts[i + 7] if i + 7 < len(stmts) else None
            if (
                nxt is not None
                and nxt.kind == "segment_sum"
                and nxt.scale == att_name
            ):
                msg, msg_rows, slot_map = _edge_msg(env, gt, kl, nxt.ins[0])
                dec = _trav_decision(decisions, "softmax_agg", msg,
                                     msg_rows is not None, kl)
                out = K.edge_softmax_agg(
                    scores, msg, gt.dst, gt.num_nodes, bc=kl.blocked,
                    msg_rows=msg_rows, msg_slot_map=slot_map,
                    fuse_gather=_fuse(dec, msg, slot_map))
                env.set(nxt.out, out)
                if _read_elsewhere(env.plan, op, i + 7, att_name):
                    env.set(att_name, K.edge_softmax(
                        scores, gt.dst, gt.num_nodes, bc=kl.blocked))
                i += 8
                continue
            env.set(att_name, K.edge_softmax(scores, gt.dst, gt.num_nodes,
                                             bc=kl.blocked))
            i += 7
            continue

        s = stmts[i]
        if s.kind == "elementwise":
            args = [env.get_edge_vanilla(a) if not a.startswith(("node:", "scalar:"))
                    else env.get(a) for a in s.ins]
            env.set(s.out, _elementwise(s.op, args, s.alpha))
        elif s.kind == "rowdot":
            a = env.get_edge_vanilla(s.ins[0])
            b = env.get_edge_vanilla(s.ins[1])
            env.set(s.out, torch.sum(a * b, dim=-1))
        elif s.kind == "concat":
            env.set(s.out, torch.cat(
                [env.get_edge_vanilla(a) for a in s.ins], dim=-1))
        elif s.kind == "gather_src":
            env.set(s.out, env.get(s.ins[0])[gt.src.long()])
        elif s.kind in ("gather_dst", "gather_dst_var"):
            env.set(s.out, env.get(s.ins[0])[gt.dst.long()])
        elif s.kind == "gather_unique":
            env.set(s.out, env.get(s.ins[0])[gt.edge_to_unique.long()])
        elif s.kind == "gather_etype_weight":
            env.set(s.out, env.params[s.ins[0]][gt.etype.long()])
        elif s.kind == "segment_max":
            x = env.get_edge_vanilla(s.ins[0])
            mx = compat.segment_max(x, gt.dst, gt.num_nodes)
            env.set(s.out, torch.where(torch.isfinite(mx), mx,
                                       torch.zeros_like(mx)))
        elif s.kind == "segment_sum":
            msg, msg_rows, slot_map = _edge_msg(env, gt, kl, s.ins[0])
            dec = _trav_decision(decisions, "weighted_agg", msg,
                                 msg_rows is not None, kl)
            scale = None
            if s.scale is not None:
                scale = env.get_edge_vanilla(s.scale)
                if scale.dim() == 2:
                    scale = scale[:, 0]
            out = K.weighted_agg(scale, msg, gt.dst, gt.num_nodes,
                                 bc=kl.blocked, msg_rows=msg_rows,
                                 msg_slot_map=slot_map,
                                 fuse_gather=_fuse(dec, msg, slot_map))
            if s.op == "mean":
                deg = kl.dst_deg.to(out.dtype)
                out = out / torch.clamp(deg, min=1.0)[:, None]
            env.set(s.out, out)
        else:
            raise NotImplementedError(f"traversal stmt {s.kind}")
        i += 1
