"""Traversal-template kernels K2, K3, K6, K7 and K8 (Hector Algorithm 2)
and their plain versions, over the blocked destination CSR
(``BlockedCSR``); and K11, the backward's scatter-add over a sorted
target index.

``seg_stats_padded``                per-destination softmax max and Σexp
``seg_softmax_agg_gather_padded``   out[v] = Σ_e softmax(score)_e · msg[mmap[e]]
                                    with the message gather inside the kernel
``seg_weighted_agg_gather_padded``  out[v] = Σ_e scale_e · msg[mmap[e]],
                                    the same walk with a per-slot scale
``seg_softmax_agg_padded``          K3 over messages already padded into the
                                    dst-sorted slots (``msg_p[slot]``)
``seg_weighted_agg_padded``         K7 over padded messages
``seg_sum_sorted``                  out[r] = Σ_{key[j] = r} values[perm[j]],
                                    K11 (no TPU kernel)

The last two are the materialized-gather variants the tuner selects with
``fuse_gather=False`` (``kernels/ops.py``). Each wrapper dispatches on the
tensors' device: CPU runs the plain PyTorch version, CUDA launches the
hand-written kernel in ``csrc/traversal.cu`` (replacing the functions of
the same names in ``repro/kernels/traversal.py``). Nothing falls back;
``.launches`` on each wrapper counts its kernel launches.

The plain versions index nodes through the tile -> block map ``t2b``.
All five kernels split by slots: ``ceil(T / chunk_tiles)`` units of
``chunk_tiles`` consecutive tiles (by default ``K2_CHUNK_TILES``,
``K3_CHUNK_TILES``, ``K6_CHUNK_TILES``, ``K7_CHUNK_TILES``), each reduced
by one thread block into fp64 partials, and a second kernel that reduces,
in unit order, the nodes whose slots cross a unit edge. K3's and K6's
weight is the attention from K2's ``mx`` / ``den``, computed as the slot
is staged (one call, two launches, counted once). K2 makes two such
passes, the max and then the sum of ``exp(s - mx)`` (four launches,
counted once). They rely on the order ``slot_keys`` states, which every
layout builder keeps: real slots sorted by destination, each node block's
pads after its real slots; ``block_tile_ptr`` is read only for the node
blocks that own no tile. Pad slots carry ``local_dst == node_block`` and
contribute nothing (the reference gives them scale 0); a message index of
-1 contributes nothing.
A node without edges, and every node of a block that owns no tile, gets
``mx = -1e30``, ``den = 0`` and a zero output row: the Pallas kernels never
write the blocks without tiles. Inputs and outputs are fp32 (the plain
versions keep their inputs' dtype); kernels and plain versions alike
accumulate ``den`` and the outputs in fp64, so the long sums of the
bucketing pad node stay within fp32 rounding and the two agree at any
length. The padded variants read slot ``i``'s message at row ``i`` of
``msg_p``; a pad slot's row is never added.

K11 (``seg_sum_sorted``, ``csrc/scatter.cu``) is the backward's
scatter-add without float atomics: the dX of a gathered GEMM and the
compact message gradients of the traversal ops sum their rows over a
stable sort of the target index (``sorted_segments``), split by entries
into units (``scatter_plan``, from shapes alone) whose crossing rows are
added in unit order, in one launch. It replaces no TPU kernel (the
reference leaves those sums to XLA); it makes the card's backward bit for
bit repeatable.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "seg_stats_f32": [_P] * 7 + [_I] * 5 + [_P],
    "seg_softmax_agg_gather_f32": [_P] * 10 + [_I] * 7 + [_P],
    "seg_weighted_agg_gather_f32": [_P] * 8 + [_I] * 7 + [_P],
    "seg_softmax_agg_padded_f32": [_P] * 9 + [_I] * 7 + [_P],
    "seg_weighted_agg_padded_f32": [_P] * 7 + [_I] * 7 + [_P],
    "seg_weighted_agg_smem_bytes": [_I] * 4,
}
# K7's and K8's work unit: this many consecutive tiles of the slot array
# (256 slots at tile 32) to a thread block; K3's and K6's, the same walk;
# K2's, the same units (one slot a thread at tile 32)
K7_CHUNK_TILES = 8
K3_CHUNK_TILES = K6_CHUNK_TILES = K2_CHUNK_TILES = K7_CHUNK_TILES


def _library() -> ctypes.CDLL:
    return build.load("traversal", _SIGNATURES,
                      sizes=("seg_weighted_agg_smem_bytes",))


def _slot_nodes(local_dst_p: torch.Tensor, t2b: torch.Tensor,
                node_block: int):
    """Flat padded slots -> (valid mask, global node row) via ``t2b``."""
    num_tiles, tile = local_dst_p.shape
    ld = local_dst_p.reshape(-1).long()
    valid = ld < node_block
    blk = t2b[:num_tiles].long().repeat_interleave(tile)
    return valid, blk * node_block + torch.where(valid, ld, 0)


def slot_keys(local_dst_p: torch.Tensor, t2b: torch.Tensor,
              node_block: int) -> torch.Tensor:
    """The sort key of every flat slot, as K3, K7 and K8 compute it: ``2 *``
    the global destination of a real slot, ``2 *`` the last node of its
    block ``+ 1`` for a pad. The kernels rely on these keys never
    decreasing along the slots: the real slots' destinations are sorted,
    and each node block's pad slots follow its real ones."""
    num_tiles, tile = local_dst_p.shape
    ld = local_dst_p.reshape(-1).long()
    blk = t2b[:num_tiles].long().repeat_interleave(tile)
    return torch.where(ld < node_block, 2 * (blk * node_block + ld),
                       2 * (blk + 1) * node_block - 1)


# ---------------------------------------------------------------------------
# K2: per-destination softmax statistics
# ---------------------------------------------------------------------------
def seg_stats_padded_plain(scores_p, local_dst_p, t2b, block_tile_ptr=None,
                           *, node_block: int, num_node_blocks: int):
    """Plain version of K2 -> (mx, den), each [num_node_blocks, node_block].

    ``block_tile_ptr`` is accepted for a signature equal to the kernel's;
    the plain version reads ``t2b``."""
    valid, node = _slot_nodes(local_dst_p, t2b, node_block)
    s = scores_p.reshape(-1)[valid]
    node = node[valid]
    total = num_node_blocks * node_block
    mx = s.new_full((total,), NEG_INF).scatter_reduce(
        0, node, s, "amax", include_self=True)
    den = torch.zeros(total, dtype=torch.float64, device=s.device)
    den.index_add_(0, node, torch.exp(s - mx[node]).double())
    return (mx.view(num_node_blocks, node_block),
            den.to(s.dtype).view(num_node_blocks, node_block))


def seg_stats_padded(scores_p, local_dst_p, t2b, block_tile_ptr, *,
                     node_block: int, num_node_blocks: int,
                     chunk_tiles: int = K2_CHUNK_TILES):
    """K2: per-destination max and Σexp over dst-sorted edge tiles.

    scores_p, local_dst_p: [T, tile] (pad slots: local_dst == node_block);
    t2b: [>= T] tile -> node block; block_tile_ptr: [num_node_blocks + 1].
    The kernel splits the slots into units of ``chunk_tiles`` tiles (a
    keyword only for sweeping it; the CPU route ignores it) and makes two
    passes, the max and then the sum, each a unit kernel and a combine.
    The workspace holds two fp64 partials a unit (2,806 units at the bgs
    full graph: 45 KB); each pass's combine reads only what its unit kernel
    wrote, so it is not cleared."""
    if scores_p.device.type == "cpu":
        return seg_stats_padded_plain(
            scores_p, local_dst_p, t2b, block_tile_ptr,
            node_block=node_block, num_node_blocks=num_node_blocks)
    if scores_p.device.type != "cuda":
        raise ValueError(f"seg_stats_padded: no kernel for device "
                         f"{scores_p.device}")
    dev = scores_p.device
    kernel = "seg_stats_padded"
    build.check_args(kernel, dev, scores_p=(scores_p, torch.float32),
                     local_dst_p=(local_dst_p, torch.int32),
                     t2b=(t2b, torch.int32),
                     block_tile_ptr=(block_tile_ptr, torch.int32))
    _check_ptr(block_tile_ptr, num_node_blocks, kernel)
    num_tiles, tile = _check_split(kernel, local_dst_p, t2b, chunk_tiles,
                                   num_node_blocks * node_block,
                                   scores_p=scores_p)
    shape = (num_node_blocks, node_block)
    if num_tiles == 0 or num_node_blocks == 0:     # nothing is launched
        return (torch.full(shape, NEG_INF, dtype=torch.float32, device=dev),
                torch.zeros(shape, dtype=torch.float32, device=dev))
    mx = torch.empty(shape, dtype=torch.float32, device=dev)
    den = torch.empty_like(mx)
    ws = torch.empty((2 * -(-num_tiles // chunk_tiles),), dtype=torch.float64,
                     device=dev)
    scores_p, local_dst_p = scores_p.contiguous(), local_dst_p.contiguous()
    t2b, block_tile_ptr = t2b.contiguous(), block_tile_ptr.contiguous()
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.seg_stats_f32(
            scores_p.data_ptr(), local_dst_p.data_ptr(), t2b.data_ptr(),
            block_tile_ptr.data_ptr(), mx.data_ptr(), den.data_ptr(),
            ws.data_ptr(), num_tiles, num_node_blocks, node_block, tile,
            chunk_tiles, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, kernel)
    seg_stats_padded.launches += 1
    return mx, den


seg_stats_padded.launches = 0


# ---------------------------------------------------------------------------
# K3: gather-fused softmax aggregation
# ---------------------------------------------------------------------------
def seg_softmax_agg_gather_padded_plain(scores_p, msg, mmap, local_dst_p,
                                        t2b, block_tile_ptr, mx, den, *,
                                        node_block: int,
                                        num_node_blocks: int):
    """Plain version of K3 -> [num_node_blocks * node_block, d]."""
    valid, node = _slot_nodes(local_dst_p, t2b, node_block)
    rows = mmap.long()
    keep = valid & (rows >= 0)
    node, rows = node[keep], rows[keep]
    s = scores_p.reshape(-1)[keep]
    mxf, denf = mx.reshape(-1), den.reshape(-1)
    att = torch.exp(s - mxf[node]) / torch.clamp(denf[node], min=1e-38)
    out = torch.zeros((num_node_blocks * node_block, msg.shape[-1]),
                      dtype=torch.float64, device=msg.device)
    out.index_add_(0, node, att.double()[:, None] * msg[rows].double())
    return out.to(msg.dtype)


def seg_softmax_agg_gather_padded(scores_p, msg, mmap, local_dst_p, t2b,
                                  block_tile_ptr, mx, den, *,
                                  node_block: int, num_node_blocks: int,
                                  chunk_tiles: int = K3_CHUNK_TILES):
    """K3: softmax-weighted aggregation with the message gather in-kernel.

    msg: [Em, d] in storage order (canonical edges or the compact
    unique-pair table); mmap: [T * tile] slot -> msg row, or -1; mx, den:
    K2's outputs. K7's slot split, in units of ``chunk_tiles`` tiles (a
    keyword only for sweeping it; the CPU route ignores it)."""
    if scores_p.device.type == "cpu":
        return seg_softmax_agg_gather_padded_plain(
            scores_p, msg, mmap, local_dst_p, t2b, block_tile_ptr, mx, den,
            node_block=node_block, num_node_blocks=num_node_blocks)
    out, launched = _launch_weighted(
        "seg_softmax_agg_gather_padded", "seg_softmax_agg_gather_f32", msg,
        dict(scores_p=(scores_p, torch.float32), msg=(msg, torch.float32),
             mmap=(mmap, torch.int32),
             local_dst_p=(local_dst_p, torch.int32),
             t2b=(t2b, torch.int32),
             block_tile_ptr=(block_tile_ptr, torch.int32),
             mx=(mx, torch.float32), den=(den, torch.float32)),
        node_block=node_block, num_node_blocks=num_node_blocks,
        chunk_tiles=chunk_tiles)
    seg_softmax_agg_gather_padded.launches += launched
    return out


seg_softmax_agg_gather_padded.launches = 0


# ---------------------------------------------------------------------------
# K7: gather-fused weighted aggregation
# ---------------------------------------------------------------------------
def seg_weighted_agg_gather_padded_plain(scale_p, msg, mmap, local_dst_p,
                                         t2b, block_tile_ptr=None, *,
                                         node_block: int,
                                         num_node_blocks: int):
    """Plain version of K7 -> [num_node_blocks * node_block, d]: K3's plain
    version with the slot's scale in place of the attention."""
    valid, node = _slot_nodes(local_dst_p, t2b, node_block)
    rows = mmap.long()
    keep = valid & (rows >= 0)
    node, rows = node[keep], rows[keep]
    s = scale_p.reshape(-1)[keep]
    out = torch.zeros((num_node_blocks * node_block, msg.shape[-1]),
                      dtype=torch.float64, device=msg.device)
    out.index_add_(0, node, s.double()[:, None] * msg[rows].double())
    return out.to(msg.dtype)


def seg_weighted_agg_gather_padded(scale_p, msg, mmap, local_dst_p, t2b,
                                   block_tile_ptr, *, node_block: int,
                                   num_node_blocks: int,
                                   chunk_tiles: int = K7_CHUNK_TILES):
    """K7: scale-weighted aggregation with the message gather in-kernel.

    scale_p: [T, tile] per-slot scale (pad slots 0); msg: [Em, d] in
    storage order; mmap: [T * tile] slot -> msg row, or -1. The kernel
    splits the slots into units of ``chunk_tiles`` tiles (a keyword only
    for sweeping it; the CPU route ignores it) and reads
    ``block_tile_ptr`` only for the node blocks that own no tile."""
    if scale_p.device.type == "cpu":
        return seg_weighted_agg_gather_padded_plain(
            scale_p, msg, mmap, local_dst_p, t2b, block_tile_ptr,
            node_block=node_block, num_node_blocks=num_node_blocks)
    out, launched = _launch_weighted(
        "seg_weighted_agg_gather_padded", "seg_weighted_agg_gather_f32", msg,
        dict(scale_p=(scale_p, torch.float32), msg=(msg, torch.float32),
             mmap=(mmap, torch.int32),
             local_dst_p=(local_dst_p, torch.int32),
             t2b=(t2b, torch.int32),
             block_tile_ptr=(block_tile_ptr, torch.int32)),
        node_block=node_block, num_node_blocks=num_node_blocks,
        chunk_tiles=chunk_tiles)
    seg_weighted_agg_gather_padded.launches += launched
    return out


seg_weighted_agg_gather_padded.launches = 0


# ---------------------------------------------------------------------------
# K6 / K8: the same aggregations over messages padded into the slots
# ---------------------------------------------------------------------------
def _slot_rows(local_dst_p: torch.Tensor) -> torch.Tensor:
    """The slot -> message row map of pre-padded messages: the slot."""
    return torch.arange(local_dst_p.numel(), dtype=torch.int32,
                        device=local_dst_p.device)


def _check_padded(msg_p, local_dst_p, kernel: str) -> None:
    if msg_p.shape[0] != local_dst_p.numel():
        raise ValueError(f"{kernel}: msg_p has {msg_p.shape[0]} rows for "
                         f"{local_dst_p.numel()} slots")


def seg_softmax_agg_padded_plain(scores_p, msg_p, local_dst_p, t2b,
                                 block_tile_ptr, mx, den, *,
                                 node_block: int, num_node_blocks: int):
    """Plain version of K6: K3's with slot ``i`` reading ``msg_p[i]``."""
    _check_padded(msg_p, local_dst_p, "seg_softmax_agg_padded")
    return seg_softmax_agg_gather_padded_plain(
        scores_p, msg_p, _slot_rows(local_dst_p), local_dst_p, t2b,
        block_tile_ptr, mx, den, node_block=node_block,
        num_node_blocks=num_node_blocks)


def seg_softmax_agg_padded(scores_p, msg_p, local_dst_p, t2b,
                           block_tile_ptr, mx, den, *, node_block: int,
                           num_node_blocks: int,
                           chunk_tiles: int = K6_CHUNK_TILES):
    """K6: softmax-weighted aggregation over pre-padded messages, K3's
    walk with slot ``i`` reading ``msg_p[i]``.

    msg_p: [T * tile, d], the messages in the dst-sorted slots (pad slots'
    rows are not added); mx, den: K2's outputs."""
    _check_padded(msg_p, local_dst_p, "seg_softmax_agg_padded")
    if scores_p.device.type == "cpu":
        return seg_softmax_agg_padded_plain(
            scores_p, msg_p, local_dst_p, t2b, block_tile_ptr, mx, den,
            node_block=node_block, num_node_blocks=num_node_blocks)
    out, launched = _launch_weighted(
        "seg_softmax_agg_padded", "seg_softmax_agg_padded_f32", msg_p,
        dict(scores_p=(scores_p, torch.float32), msg_p=(msg_p, torch.float32),
             local_dst_p=(local_dst_p, torch.int32),
             t2b=(t2b, torch.int32),
             block_tile_ptr=(block_tile_ptr, torch.int32),
             mx=(mx, torch.float32), den=(den, torch.float32)),
        node_block=node_block, num_node_blocks=num_node_blocks,
        chunk_tiles=chunk_tiles)
    seg_softmax_agg_padded.launches += launched
    return out


seg_softmax_agg_padded.launches = 0


def seg_weighted_agg_padded_plain(scale_p, msg_p, local_dst_p, t2b,
                                  block_tile_ptr=None, *, node_block: int,
                                  num_node_blocks: int):
    """Plain version of K8: K7's with slot ``i`` reading ``msg_p[i]``."""
    _check_padded(msg_p, local_dst_p, "seg_weighted_agg_padded")
    return seg_weighted_agg_gather_padded_plain(
        scale_p, msg_p, _slot_rows(local_dst_p), local_dst_p, t2b,
        block_tile_ptr, node_block=node_block,
        num_node_blocks=num_node_blocks)


def seg_weighted_agg_padded(scale_p, msg_p, local_dst_p, t2b,
                            block_tile_ptr, *, node_block: int,
                            num_node_blocks: int,
                            chunk_tiles: int = K7_CHUNK_TILES):
    """K8: scale-weighted aggregation over pre-padded messages, K7's walk
    with slot ``i`` reading ``msg_p[i]``.

    scale_p: [T, tile] per-slot scale (pad slots 0); msg_p: [T * tile, d]."""
    _check_padded(msg_p, local_dst_p, "seg_weighted_agg_padded")
    if scale_p.device.type == "cpu":
        return seg_weighted_agg_padded_plain(
            scale_p, msg_p, local_dst_p, t2b, block_tile_ptr,
            node_block=node_block, num_node_blocks=num_node_blocks)
    out, launched = _launch_weighted(
        "seg_weighted_agg_padded", "seg_weighted_agg_padded_f32", msg_p,
        dict(scale_p=(scale_p, torch.float32), msg_p=(msg_p, torch.float32),
             local_dst_p=(local_dst_p, torch.int32),
             t2b=(t2b, torch.int32),
             block_tile_ptr=(block_tile_ptr, torch.int32)),
        node_block=node_block, num_node_blocks=num_node_blocks,
        chunk_tiles=chunk_tiles)
    seg_weighted_agg_padded.launches += launched
    return out


seg_weighted_agg_padded.launches = 0


def _launch_weighted(kernel: str, entry: str, msg, named, *,
                     node_block: int, num_node_blocks: int,
                     chunk_tiles: int):
    """Launch K3, K6, K7 or K8 (the C entry point ``entry``: the unit kernel,
    then the combine kernel) on the ``named`` ``(tensor, dtype)`` inputs,
    in the kernel's argument order; returns ``(out, 1)``, or ``(out, 0)``
    where there is nothing to sum (no slot, no node or no column): then
    every row is zero and nothing is launched. A device without a kernel
    raises.

    The workspace holds a head and a tail partial row of fp64 for every
    unit: ``ceil(T / chunk_tiles) * 2 * d * 8`` bytes (2,806 units of
    d = 64 at the bgs full graph, T = 22,447: 2.9 MB); the combine reads
    only the rows the unit kernel wrote, so it is not cleared."""
    first = next(iter(named.values()))[0]
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {dev}")
    build.check_args(kernel, dev, **named)
    _check_ptr(named["block_tile_ptr"][0], num_node_blocks, kernel)
    num_nodes = num_node_blocks * node_block
    num_tiles, tile = _check_split(
        kernel, named["local_dst_p"][0], named["t2b"][0], chunk_tiles,
        num_nodes, **{name: named[name][0] for name in
                      ("scale_p", "scores_p", "mmap") if name in named})
    for name in ("mx", "den"):
        if name in named and named[name][0].numel() != num_nodes:
            raise ValueError(f"{kernel}: {name} has "
                             f"{named[name][0].numel()} entries for "
                             f"{num_nodes} nodes")
    d = int(msg.shape[-1])
    if num_tiles == 0 or num_nodes == 0 or d == 0:
        return torch.zeros((num_nodes, d), dtype=torch.float32,
                           device=dev), 0
    out = torch.empty((num_nodes, d), dtype=torch.float32, device=dev)
    args = [t.contiguous() for t, _ in named.values()]
    # columns a lane loads at once: the widest vector that divides d, fits
    # the messages' alignment and still spreads a row over 8 lanes
    msg_ptr = args[1].data_ptr()
    vec = next(v for v in (4, 2, 1) if v == 1 or (
        d % v == 0 and msg_ptr % (4 * v) == 0 and d // v >= 8))
    lib = _library()
    smem = lib.seg_weighted_agg_smem_bytes(d, tile, chunk_tiles, vec)
    if smem > build.MAX_SMEM_BYTES:
        raise ValueError(f"{kernel}: chunk_tiles={chunk_tiles}, tile={tile} "
                         f"needs {smem} bytes of shared memory per block "
                         f"(limit {build.MAX_SMEM_BYTES})")
    units = -(-num_tiles // chunk_tiles)
    ws = torch.empty((units * 2 * d,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in args), out.data_ptr(), ws.data_ptr(), d,
            num_tiles, num_node_blocks, node_block, tile, chunk_tiles, vec,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, kernel)
    return out, 1


def _check_split(kernel: str, local_dst_p, t2b, chunk_tiles: int,
                 num_nodes: int, **per_slot):
    """The slot split's preconditions; returns ``(num_tiles, tile)``.
    ``per_slot``: inputs of one entry a slot."""
    num_tiles, tile = (int(n) for n in local_dst_p.shape)
    slots = num_tiles * tile
    for name, t in per_slot.items():
        if t.numel() != slots:
            raise ValueError(f"{kernel}: {name} has {t.numel()} entries for "
                             f"{slots} slots")
    if t2b.numel() < num_tiles:
        raise ValueError(f"{kernel}: t2b has {t2b.numel()} entries for "
                         f"{num_tiles} tiles")
    if chunk_tiles < 1:
        raise ValueError(f"{kernel}: chunk_tiles={chunk_tiles} below 1")
    if 2 * num_nodes >= 2**31 or slots + chunk_tiles * tile >= 2**31:
        raise ValueError(f"{kernel}: {num_nodes} nodes or {slots} slots "
                         f"overflow the kernel's int32 keys")
    return num_tiles, tile


def _check_ptr(block_tile_ptr, num_node_blocks: int, kernel: str) -> None:
    if block_tile_ptr.shape[0] != num_node_blocks + 1:
        raise ValueError(f"{kernel}: block_tile_ptr has "
                         f"{block_tile_ptr.shape[0]} entries for "
                         f"{num_node_blocks} node blocks")


# ---------------------------------------------------------------------------
# K11: the backward's scatter-add over a sorted target index
# ---------------------------------------------------------------------------
_SCATTER_SIGNATURES = {
    "seg_sum_sorted_f32": [_P] * 6 + [_I] * 7 + [_P],
}
# one stage of K11's shared-memory ring: this many floats of value rows
# (4 KB; two stages a warp)
SCATTER_STAGE_FLOATS = 1024
# a unit's sorted entries: SCATTER_MAX_UNIT, halved while the call makes
# fewer than SCATTER_TARGET_UNITS units (one warp each: 32 on each of the
# H100's 132 SMs), down to SCATTER_MIN_UNIT (a hub's combine adds one
# partial a unit it spans)
SCATTER_MIN_UNIT, SCATTER_MAX_UNIT = 32, 256
SCATTER_TARGET_UNITS = 132 * 32


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """How one K11 call is cut, from its shapes alone: ``vec`` floats a
    copy (4: 16-byte ``cp.async`` where d % 4 == 0, else 1), ``lanes``
    lanes a group (``32 // lanes`` groups each walk their span of a stage;
    a column pass covers ``lanes * vec`` columns), ``chunk`` entries a
    ring stage, ``unit`` entries a warp, ``units`` warps (one a block) and
    the workspace (``ws_doubles``: a head and a tail partial row a unit;
    ``tickets``: two ints a unit, zeroed)."""

    vec: int
    lanes: int
    chunk: int
    unit: int
    units: int
    ws_doubles: int
    tickets: int


@functools.lru_cache(maxsize=4096)
def scatter_plan(n_entries: int, d: int) -> ScatterPlan:
    """K11's split of ``n_entries`` sorted entries of width ``d``. Raises
    on a shape the kernel cannot take."""
    if n_entries <= 0 or d <= 0:
        raise ValueError(f"seg_sum_sorted: no work to split: "
                         f"n_entries={n_entries}, d={d}")
    vec = 4 if d % 4 == 0 else 1
    lanes = min(32, 1 << (-(-d // vec) - 1).bit_length())
    cols = lanes * vec
    unit = SCATTER_MAX_UNIT
    while (unit > SCATTER_MIN_UNIT
           and -(-n_entries // unit) < SCATTER_TARGET_UNITS):
        unit //= 2
    chunk = min(unit, SCATTER_STAGE_FLOATS // cols)
    units = -(-n_entries // unit)
    if n_entries + unit >= 2**31:
        raise ValueError(f"seg_sum_sorted: {n_entries} entries overflow the "
                         f"kernel's int32 positions")
    return ScatterPlan(vec, lanes, chunk, unit, units, 2 * units * d,
                       2 * units)


def _scatter_library() -> ctypes.CDLL:
    return build.load("scatter", _SCATTER_SIGNATURES)


def sorted_segments(target: torch.Tensor):
    """K11's ``(perm, key)`` for a scatter to ``target`` (one entry a value
    row; -1: none): ``perm`` a stable sort of the targets, ``key`` the
    sorted targets (both int32; the -1s first). Static shapes, no
    synchronize: a captured backward builds them too."""
    key, perm = torch.sort(target, stable=True)
    return perm.to(torch.int32), key.to(torch.int32)


def seg_sum_sorted_plain(values, perm, key, num_rows: int):
    """Plain version of K11 -> [num_rows, d]: ``index_add_`` of the sorted
    entries' value rows into their rows (``key``; -1 adds nothing), in
    fp64, in increasing position (the order K11 sums a run in)."""
    keep = key >= 0
    out = torch.zeros((num_rows, values.shape[1]), dtype=torch.float64,
                      device=values.device)
    out.index_add_(0, key[keep].long(), values[perm[keep].long()].double())
    return out.to(values.dtype)


def seg_sum_sorted(values, perm, key, num_rows: int):
    """K11: ``out[r] = Σ_{key[j] = r} values[perm[j]]``.

    values: [n, d] fp32; perm: [m] int32, indices into ``values`` in the
    stable order of their targets; key: [m] int32, those targets, sorted
    (``sorted_segments``; -1 adds nothing, every other key below
    ``num_rows``). Rows without entries are zero. One launch, cut by
    ``scatter_plan``: a warp a unit of sorted entries, its value rows
    gathered with ``cp.async``, runs summed in fp64, the rows that cross a
    unit edge added in unit order by the last unit to finish: bit for bit
    the same from launch to launch."""
    if values.device.type == "cpu":
        return seg_sum_sorted_plain(values, perm, key, num_rows)
    dev = values.device
    kernel = "seg_sum_sorted"
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {dev}")
    build.check_args(kernel, dev, values=(values, torch.float32),
                     perm=(perm, torch.int32), key=(key, torch.int32))
    if values.dim() != 2 or perm.dim() != 1 or key.shape != perm.shape:
        raise ValueError(f"{kernel}: values must be [n, d], perm and key "
                         f"[m], got {tuple(values.shape)}, "
                         f"{tuple(perm.shape)} and {tuple(key.shape)}")
    n, d = int(perm.numel()), int(values.shape[1])
    if n == 0 or num_rows == 0 or d == 0:         # nothing is launched
        return torch.zeros((num_rows, d), dtype=torch.float32, device=dev)
    plan = scatter_plan(n, d)
    values, perm, key = values.contiguous(), perm.contiguous(), \
        key.contiguous()
    if plan.vec == 4 and values.data_ptr() % 16:
        values = values.clone()                   # 16-byte copies
    out = torch.empty((num_rows, d), dtype=torch.float32, device=dev)
    ws = torch.empty((plan.ws_doubles,), dtype=torch.float64, device=dev)
    tickets = torch.zeros((plan.tickets,), dtype=torch.int32, device=dev)
    lib = _scatter_library()
    with torch.cuda.device(dev):
        rc = lib.seg_sum_sorted_f32(
            values.data_ptr(), perm.data_ptr(), key.data_ptr(),
            out.data_ptr(), ws.data_ptr(), tickets.data_ptr(), d, n,
            num_rows, plan.unit, plan.chunk, plan.lanes, plan.vec,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, kernel)
    seg_sum_sorted.launches += 1
    return out


seg_sum_sorted.launches = 0
