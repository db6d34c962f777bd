"""Device sampling kernels: fanout selection and layout build on the device.

The port's counterpart of ``repro.kernels.sampling_ops``. The host
``FanoutSampler`` ranks every candidate in-edge of the frontier by a
counter-based hash key and keeps the ``fanout[etype]`` smallest per
(destination, etype) bin. This module evaluates the same selection as
fixed-shape torch code over the device CSC (``core.graph.DeviceGraph``):
every shape is static for a bucket tuple, and nothing is read back to the
host, so the steady-state sampling loop never synchronizes.

* **K9** (``candidate_keys``): the masked key of every candidate in the
  CSC window ``[rows, C]`` (C = the graph's largest per-(dst, etype)
  in-degree), a hand-written CUDA kernel (``csrc/sampling.cu``) on a card
  and ``candidate_keys_plain`` on the CPU; it replaces
  ``repro/kernels/sampling_ops.py::_candidate_keys_pallas``.
* **stage A** (``make_sample_hop``): K9 over the frontier's window, the K
  smallest keys per bin, the sorted frontier ∪ sources union and the
  3-vector of (next-frontier, edge, unique-pair) counts, the only values
  the host reads back (asynchronously) to pick later buckets.
* **stage B** (``make_build_block``): compaction of the union into the
  block's sorted-unique node set, canonical etype-sorted edges with every
  ``GraphTensors`` product, and the complete ``KernelLayouts`` through the
  ``device_*`` builders of ``kernels/layout.py`` and ``kernels/ops.py``.
* **seed prep** (``make_prep_seeds``): the sorted unique seed frontier.

Keys are int32 in the kernel's encoding (``csrc/sampling.cu``): the uint32
key ``k`` is stored as ``k ^ 0x80000000`` read as int32, whose signed order
is the unsigned order of ``k``; invalid candidates are ``INT32_MAX``
(0xFFFFFFFF in the reference). ``decode_keys`` gives the uint32 values back
(as int64).

Padding discipline, as the reference's: pad nodes sort after real nodes
(sentinel id = N), pad edges carry etype R-1 and connect the first pad
node to itself, so every type-sorted invariant the kernels rely on
(non-decreasing etype/ntype/dst, tile-to-group maps) holds by construction
and pad rows only ever feed pad rows. The reference's dropped scatters
(``.at[i].set(v, mode="drop")``) write into a trash slot that is sliced
off (``layout.scatter_drop``); its stable argsorts are ``stable=True``
sorts; its cumulative counts of sorted values are binary searches
(``layout.ptr_of_sorted``).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.core.codegen import KernelLayouts
from repro_torch.core.graph import DeviceGraph, GraphTensors, to_device
from repro_torch.kernels import build
from repro_torch.kernels import layout as L
from repro_torch.kernels import ops as K
from repro_torch.sampling.sampler import (FULL_NEIGHBORHOOD,
                                          edge_sample_keys_torch)

I32_MAX = 2**31 - 1
# candidates stage A keys at once (2 GiB of int32 keys): larger frontiers
# are keyed and selected in slices of frontier rows
WINDOW_CANDIDATES = 1 << 29

_P = ctypes.c_void_p
_SIGNATURES = {
    "candidate_keys_i32": [_P, _P, ctypes.c_uint32, _P, ctypes.c_longlong,
                           ctypes.c_int, _P],
}


def _library() -> ctypes.CDLL:
    return build.load("sampling", _SIGNATURES)


def effective_fanouts(fanout, max_bin: int) -> Tuple[int, ...]:
    """Resolve a per-etype fanout vector against the candidate window width:
    ``FULL_NEIGHBORHOOD`` (and any cap beyond the widest bin) becomes C —
    no bin has more than C candidates, so keeping C keys is exact."""
    c = max(1, int(max_bin))
    return tuple(c if int(k) == FULL_NEIGHBORHOOD else min(int(k), c)
                 for k in fanout)


# ---------------------------------------------------------------------------
# K9: candidate keys
# ---------------------------------------------------------------------------
def decode_keys(keys: torch.Tensor) -> torch.Tensor:
    """K9's int32 encoding -> the uint32 keys, as int64 values."""
    return keys.long() + 2**31


def candidate_keys_plain(starts: torch.Tensor, cnts: torch.Tensor,
                         base_key, width: int) -> torch.Tensor:
    """Plain version of K9: ``sampler.edge_sample_keys_torch`` over the
    window in int64, encoded as the kernel encodes its keys."""
    col = torch.arange(width, dtype=torch.int64, device=starts.device)
    keys = edge_sample_keys_torch(base_key, starts.long()[..., None] + col)
    return torch.where(col < cnts.long()[..., None], keys - 2**31,
                       I32_MAX).to(torch.int32)


def candidate_keys(starts: torch.Tensor, cnts: torch.Tensor, base_key,
                   width: int) -> torch.Tensor:
    """K9: the masked per-candidate sort keys over the CSC windows.

    ``starts`` / ``cnts`` are int32 bin starts and sizes of any shape;
    returns ``[*shape, width]`` int32 keys in the kernel's encoding, the
    candidates at or past a bin's count pinned to ``INT32_MAX`` so they
    sort last. ``base_key`` is the hop's uint32 base key. A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel or raises."""
    if width <= 0:
        raise ValueError(f"candidate_keys: width={width} must be positive")
    if starts.shape != cnts.shape:
        raise ValueError(f"candidate_keys: starts {tuple(starts.shape)} "
                         f"and cnts {tuple(cnts.shape)} differ")
    if starts.device.type == "cpu":
        return candidate_keys_plain(starts, cnts, base_key, width)
    if starts.device.type != "cuda":
        raise ValueError(f"candidate_keys: no kernel for device "
                         f"{starts.device}")
    dev = starts.device
    build.check_args("candidate_keys", dev, starts=(starts, torch.int32),
                     cnts=(cnts, torch.int32))
    out = torch.empty((*starts.shape, width), dtype=torch.int32, device=dev)
    rows = starts.numel()
    if rows == 0:
        return out                # an empty grid is never launched
    starts, cnts = starts.contiguous(), cnts.contiguous()
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.candidate_keys_i32(
            starts.data_ptr(), cnts.data_ptr(), int(base_key) & 0xFFFFFFFF,
            out.data_ptr(), rows, width,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "candidate_keys")
    candidate_keys.launches += 1
    return out


candidate_keys.launches = 0


def _first_of_runs(sorted_vals: torch.Tensor) -> torch.Tensor:
    """True at the first element of every run of equal sorted values."""
    return torch.cat([torch.ones(1, dtype=torch.bool,
                                 device=sorted_vals.device),
                      sorted_vals[1:] != sorted_vals[:-1]])


# ---------------------------------------------------------------------------
# stage A: per-hop fanout selection
# ---------------------------------------------------------------------------
def make_sample_hop(dg: DeviceGraph, k_eff: Sequence[int], fp: int):
    """The stage-A function for one (frontier bucket, hop fanout)
    configuration.

    ``fn(csc_indptr, csc_src, frontier [fp], base_key) ->
    (union_sorted, sel_src [fp,R,K], sel_valid [fp,R,K], counts [3])`` where
    ``counts = (next-frontier nodes, sampled edges, unique (src,etype)
    pairs)``.

    Selection is ``torch.topk(K, largest=False, sorted=True)`` over each
    bin's keys: the valid keys of a bin are distinct (``mix32`` is a
    bijection and ``pos ^ base`` injective in ``pos``), so the top K are the
    reference's stable ``argsort(...)[:K]``, in its order, without a full
    sort. Ties are possible only at ``INT32_MAX``, between the invalid
    slots and a valid key of 0xFFFFFFFF; that key is then the bin's largest
    valid one, which the reference ranks at ``cnt - 1`` (positions break
    ties), and its column is the one of ``0..cnt-1`` missing from the ranks
    below, which is put there whatever order topk gave the ties.
    """
    n, r = dg.num_nodes, dg.num_etypes
    e = dg.num_edges
    c = max(1, dg.max_bin)
    kvec = tuple(int(k) for k in k_eff)
    kmax = max(1, max(kvec)) if kvec else 1
    if e == 0:
        raise ValueError("device sampling needs a graph with edges")
    dev = dg.device
    kcap = to_device(torch.tensor(kvec, dtype=torch.int32), dev,
                     non_blocking=True)
    etypes = torch.arange(r, dtype=torch.int32, device=dev)
    ranks = torch.arange(kmax, dtype=torch.int32, device=dev)
    slice_rows = max(1, WINDOW_CANDIDATES // (r * c))

    def fn(csc_indptr, csc_src, frontier, base_key):
        f = frontier.clamp(0, n - 1)
        bins = (f[:, None] * r + etypes[None, :]).long()
        start = csc_indptr[bins]                                # [fp, R]
        cnt = torch.where((frontier < n)[:, None],
                          csc_indptr[bins + 1] - start, 0)
        vals, cols = [], []
        for lo in range(0, fp, slice_rows):
            keys = candidate_keys(start[lo:lo + slice_rows],
                                  cnt[lo:lo + slice_rows], base_key, c)
            v, i = torch.topk(keys, kmax, dim=-1, largest=False,
                              sorted=True)
            vals.append(v)
            cols.append(i)
        vals = torch.cat(vals) if len(vals) > 1 else vals[0]
        col = torch.cat(cols) if len(cols) > 1 else cols[0]   # [fp,R,K]
        cap = torch.minimum(cnt, kcap[None, :])
        sel_valid = ranks < cap[..., None]
        n_c = cnt.long()
        missing = n_c * (n_c - 1) // 2 - torch.where(
            ranks < n_c[..., None] - 1, col, 0).sum(-1)
        col = torch.where(sel_valid & (vals == I32_MAX), missing[..., None],
                          col)
        sel_pos = (start[..., None] + col).clamp(0, e - 1)
        sel_src = torch.where(sel_valid, csc_src[sel_pos], n)
        e_cnt = sel_valid.sum(dtype=torch.int32)

        union = torch.sort(torch.cat([frontier, sel_src.reshape(-1)]))[0]
        n_next = ((union < n) & _first_of_runs(union)).sum(dtype=torch.int32)

        pair = torch.where(sel_valid, sel_src * r + etypes[:, None], I32_MAX)
        sp = torch.sort(pair.reshape(-1))[0]
        u_cnt = ((sp < I32_MAX) & _first_of_runs(sp)).sum(dtype=torch.int32)

        counts = torch.stack([n_next, e_cnt, u_cnt])
        return union, sel_src, sel_valid, counts

    return fn


# ---------------------------------------------------------------------------
# stage B: block compaction + graph products + kernel layouts
# ---------------------------------------------------------------------------
def make_build_block(dg: DeviceGraph, fp: int, kmax: int, n_pad: int,
                     e_pad: int, u_pad: int, tile: int, node_block: int):
    """The stage-B function for one bucket tuple.

    ``fn(union_sorted, sel_src, sel_valid, frontier, node_type) ->
    (GraphTensors, KernelLayouts, node_ids [n_pad], dst_local [fp],
    input_gather [n_pad])``: a complete device-built block, the same
    tensors ``build_minibatch`` builds on the host, with static shapes
    from the bucket (``n_pad``/``e_pad``/``u_pad`` are pow2 buckets of the
    stage-A counts; layout row capacities add one worst-case pad tile per
    group so the device ``pad_segments``/``block_csr`` always fit).
    """
    n, r, t = dg.num_nodes, dg.num_etypes, dg.num_ntypes
    for name, v in (("n_pad", n_pad), ("e_pad", e_pad), ("u_pad", u_pad)):
        if v % tile:
            raise ValueError(f"{name}={v} must be a tile multiple")
    nb = (n_pad + node_block - 1) // node_block
    rp_e, rp_u, rp_n = e_pad + r * tile, u_pad + r * tile, n_pad + t * tile
    ep_csr = e_pad + nb * tile
    lf = fp * r * kmax
    dev = dg.device
    i32 = torch.int32
    et_f = torch.arange(r, dtype=i32, device=dev)[None, :, None].expand(
        fp, r, kmax).reshape(lf)
    posn_e = torch.arange(e_pad, dtype=i32, device=dev)
    take_e = posn_e.clamp(max=lf - 1).long()
    posn_u = torch.arange(u_pad, dtype=i32, device=dev)

    def fn(union, sel_src, sel_valid, frontier, node_type_g):
        # A batch that outgrew a shrunken bucket (counted later by
        # ``DeviceSampler.drain`` as an overflow) is truncated, as in the
        # reference; there the gathers clamp out-of-range indices, here
        # the node indices are clamped to the last slot explicitly (a
        # no-op otherwise), so such a batch stays in bounds.
        # ---- node compaction: sorted unique reals, then sentinel pads ----
        fo = (union < n) & _first_of_runs(union)
        rank = torch.cumsum(fo, 0, dtype=i32) - 1
        n_cnt = fo.sum(dtype=i32).clamp(max=n_pad - 1)
        node_ids = L.scatter_drop(n_pad, n, torch.where(fo, rank, n_pad),
                                  union)
        node_type = torch.where(
            node_ids < n, node_type_g[node_ids.clamp(0, n - 1).long()],
            t - 1)
        ntype_ptr = L.ptr_of_sorted(node_type, t)

        # ---- edges: localize, canonical etype sort, pad tail ----
        flat_valid = sel_valid.reshape(lf)
        src_g = torch.where(flat_valid, sel_src.reshape(lf), n)
        dst_g = torch.where(
            flat_valid, frontier[:, None, None].expand(fp, r, kmax)
            .reshape(lf), n)
        src_l = torch.searchsorted(node_ids, src_g,
                                   out_int32=True).clamp(max=n_pad - 1)
        dst_l = torch.searchsorted(node_ids, dst_g,
                                   out_int32=True).clamp(max=n_pad - 1)
        sortkey = torch.where(flat_valid, et_f, r)
        order = torch.sort(sortkey, stable=True)[1]   # valid first, by et
        e_cnt = flat_valid.sum(dtype=i32)
        in_range = posn_e < e_cnt
        # the first e_cnt sorted edges, then pad edges: first pad node ->
        # itself, etype R-1 (keeps every type-sorted invariant; never read
        # back through the gathers)
        pick = order[take_e]
        src_c = torch.where(in_range, src_l[pick], n_cnt)
        dst_c = torch.where(in_range, dst_l[pick], n_cnt)
        et_c = torch.where(in_range, sortkey[pick], r - 1)
        etype_ptr = L.ptr_of_sorted(et_c, r)

        # ---- destination-sorted view ----
        perm_dst = torch.sort(dst_c, stable=True)[1].to(i32)
        dst_sorted = dst_c[perm_dst.long()]
        dst_ptr = L.ptr_of_sorted(dst_sorted, n_pad)

        # ---- compact materialization map (unique (src, etype) pairs) ----
        ukey = et_c * n_pad + src_c          # etype-major, pad pair largest
        sk = torch.sort(ukey)[0]
        ufresh = _first_of_runs(sk)
        urank = torch.cumsum(ufresh, 0, dtype=i32) - 1
        u_tot = ufresh.sum(dtype=i32)
        padkey = (r - 1) * n_pad + n_cnt
        ukeys = torch.where(
            posn_u < u_tot,
            L.scatter_drop(u_pad, 0, torch.where(ufresh, urank, u_pad), sk),
            padkey)
        unique_etype = ukeys // n_pad
        unique_src = ukeys % n_pad
        unique_etype_ptr = L.ptr_of_sorted(unique_etype, r)
        edge_to_unique = torch.searchsorted(
            ukeys, ukey, out_int32=True).clamp(max=u_pad - 1)

        gt = GraphTensors(
            src=src_c, dst=dst_c, etype=et_c, etype_ptr=etype_ptr,
            node_type=node_type, ntype_ptr=ntype_ptr, perm_dst=perm_dst,
            dst_sorted=dst_sorted, dst_ptr=dst_ptr, unique_src=unique_src,
            unique_etype=unique_etype, unique_etype_ptr=unique_etype_ptr,
            edge_to_unique=edge_to_unique,
            num_nodes=n_pad, num_ntypes=t, num_etypes=r,
        )

        # ---- kernel layouts, entirely on the device ----
        edge_seg = K.device_padded_segments(etype_ptr, et_c, tile, rp_e)
        unique_seg = K.device_padded_segments(unique_etype_ptr,
                                              unique_etype, tile, rp_u)
        kl = KernelLayouts(
            edge_seg=edge_seg,
            unique_seg=unique_seg,
            node_seg=K.device_padded_segments(ntype_ptr, node_type, tile,
                                              rp_n),
            blocked=K.device_blocked_csr(dst_ptr, dst_sorted, perm_dst,
                                         edge_to_unique, tile, node_block,
                                         ep_csr),
            edge_src_rows=L.device_compose_gather_rows(edge_seg.row_map,
                                                       src_c),
            edge_dst_rows=L.device_compose_gather_rows(edge_seg.row_map,
                                                       dst_c),
            unique_src_rows=L.device_compose_gather_rows(unique_seg.row_map,
                                                         unique_src),
            dst_deg=(dst_ptr[1:] - dst_ptr[:-1]).to(torch.float32),
        )

        dst_local = torch.searchsorted(node_ids, frontier,
                                       out_int32=True).clamp(max=n_pad - 1)
        input_gather = torch.where(node_ids < n, node_ids, 0)
        return gt, kl, node_ids, dst_local, input_gather

    return fn


# ---------------------------------------------------------------------------
# seed preparation (sorted-unique frontier, fixed shape, no readback)
# ---------------------------------------------------------------------------
def make_prep_seeds(num_nodes: int, fp: int):
    """``fn(seeds [B]) -> (frontier [fp], seed_perm [B])``: the sorted unique
    seed frontier (sentinel-padded) and each seed's row in it, the device
    mirror of the host's ``np.unique`` + ``searchsorted`` seed prologue."""

    def fn(seeds):
        su = torch.sort(seeds)[0]
        fo = _first_of_runs(su)
        rank = torch.cumsum(fo, 0, dtype=torch.int32) - 1
        frontier = L.scatter_drop(fp, num_nodes,
                                  torch.where(fo, rank, fp), su)
        seed_perm = torch.searchsorted(frontier, seeds, out_int32=True)
        return frontier, seed_perm

    return fn
