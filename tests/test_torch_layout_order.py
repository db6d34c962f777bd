"""The slot order that K2, K3, K6, K7 and K8 (``seg_stats_padded``,
``seg_softmax_agg_gather_padded``, ``seg_softmax_agg_padded``,
``seg_weighted_agg_gather_padded``, ``seg_weighted_agg_padded``) rely on,
pinned for every layout builder of the port.

The kernels cut the slot array into units of consecutive tiles and find
each unit's destinations from the slots alone, so they need the real
slots' global destinations (``t2b * node_block + local_dst``) never to
decrease, and every pad slot of a node block's tile range to follow that
block's real slots: ``traversal.slot_keys`` never decreases. Held here for
the host ``block_csr``, the bucketed layouts of a served mini-batch (the
pad node and the pure-pad tail) and ``ops.device_blocked_csr`` on the CPU,
over sampled aifb / bgs blocks, a hub, nodes without edges and node
blocks without tiles, and for every K2 and K3 call of RGAT's and HGT's
host- and device-sampled batches (their compact message maps included).
The kernels' CPU route, which accepts and ignores ``chunk_tiles``, is held
to the plain versions, and K2's, K3's and K6's to the reference's Pallas
kernels in interpret mode at the layouts the slot split has its edges at:
a hub, a pure-pad tail and node blocks without tiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import traversal as RTK
from repro_torch.core.graph import (HeteroGraph, synthetic_heterograph,
                                    table3_graph)
from repro_torch.core.module import HectorStack
from repro_torch.kernels import layout as L
from repro_torch.kernels import ops
from repro_torch.kernels import traversal as TK
from repro_torch.models import hgt_program, rgat_program
from repro_torch.sampling import DeviceSampler
from repro_torch.sampling.loader import build_minibatch
from repro_torch.sampling.sampler import FanoutSampler

SEEDS = np.array([3, 50, 7, 119, 0, 64, 201, 33], dtype=np.int32)


def _sampled(name, scale):
    graph = table3_graph(name, scale, seed=0)
    return FanoutSampler(graph, [4, 4], seed=1).sample(
        SEEDS % graph.num_nodes, batch_index=0)


def _hub():
    """Node 5 takes 3,000 in-edges, nodes 40-139 none (node blocks without
    tiles at node_block 32 and 8), and a few nodes one edge each."""
    rng = np.random.default_rng(3)
    dst = np.concatenate([np.full(3000, 5), rng.integers(0, 40, 200),
                          rng.integers(140, 160, 50)]).astype(np.int32)
    src = rng.integers(0, 160, dst.shape[0]).astype(np.int32)
    etype = rng.integers(0, 3, dst.shape[0]).astype(np.int32)
    return HeteroGraph.from_edges(src, dst, etype, 170, 3)


def _sparse():
    """Every third node has an edge; the last 100 nodes none."""
    rng = np.random.default_rng(4)
    dst = np.repeat(np.arange(0, 300, 3), rng.integers(1, 4, 100))
    src = rng.integers(0, 400, dst.shape[0])
    etype = np.zeros(dst.shape[0], np.int32)
    return HeteroGraph.from_edges(src, dst, etype, 400, 1)


GRAPHS = {
    "aifb blocks": lambda: [b.graph for b in _sampled("aifb", 0.05).blocks],
    "bgs blocks": lambda: [b.graph for b in _sampled("bgs", 0.02).blocks],
    "hub": lambda: [_hub()],
    "sparse": lambda: [_sparse()],
}


def _host(g, tile, nb):
    return ops.blocked_csr_dev(L.block_csr(g.dst_ptr, tile, nb), g.perm_dst)


def _device(g, tile, nb):
    """The device builder on the CPU, with two pure-pad tiles of room past
    the worst-case per-block padding."""
    num_blocks = -(-g.num_nodes // nb)
    cap = g.num_edges + num_blocks * tile + 2 * tile
    cap += -cap % tile
    return ops.device_blocked_csr(
        torch.from_numpy(g.dst_ptr), torch.from_numpy(g.dst_sorted),
        torch.from_numpy(g.perm_dst), torch.from_numpy(g.edge_to_unique),
        tile, nb, cap)


def _layouts(case, builder, tile, nb):
    if builder == "bucketed":
        if case in ("aifb blocks", "bgs blocks"):
            seq = _sampled(*{"aifb blocks": ("aifb", 0.05),
                             "bgs blocks": ("bgs", 0.02)}[case])
            mb = build_minibatch(seq, tile=tile, node_block=nb, bucket=True)
            return [lay.blocked for lay in mb.layouts]
        from repro_torch.core import codegen
        from repro_torch.sampling.bucketing import pad_block_graph
        return [codegen.build_kernel_layouts(pad_block_graph(g), tile, nb,
                                             bucket=True).blocked
                for g in GRAPHS[case]()]
    build = {"host": _host, "device": _device}[builder]
    return [build(g, tile, nb) for g in GRAPHS[case]()]


def _keys_numpy(bcd):
    ld = bcd.local_dst.numpy().reshape(-1).astype(np.int64)
    nb = bcd.node_block
    blk = np.repeat(bcd.t2b.numpy()[:bcd.local_dst.shape[0]],
                    bcd.local_dst.shape[1]).astype(np.int64)
    return np.where(ld < nb, 2 * (blk * nb + ld), 2 * (blk + 1) * nb - 1)


@pytest.mark.parametrize("tile,nb", [(32, 32), (8, 8)])
@pytest.mark.parametrize("builder", ["host", "bucketed", "device"])
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_slot_order_of_every_builder(case, builder, tile, nb):
    for bcd in _layouts(case, builder, tile, nb):
        ld = bcd.local_dst.reshape(-1).long()
        real = ld < nb
        blk = bcd.t2b[:bcd.local_dst.shape[0]].long().repeat_interleave(tile)
        dst = (blk * nb + ld)[real]
        assert bool((dst[1:] >= dst[:-1]).all()), "real slots out of order"
        keys = TK.slot_keys(bcd.local_dst, bcd.t2b, nb)
        np.testing.assert_array_equal(keys.numpy(), _keys_numpy(bcd))
        assert bool((keys[1:] >= keys[:-1]).all()), "a pad slot precedes " \
            "a real slot of its block"
        assert int(real.sum()) > 0


def test_bucketed_layouts_have_the_pad_node_and_a_pure_pad_tail():
    """The served layouts carry what the slot split must handle: the
    bucketing pad node, the last destination, with more slots than any
    other, a run of tiles without a real slot at the end, and node blocks
    without tiles."""
    seq = _sampled("bgs", 0.02)
    bcd = build_minibatch(seq, tile=8, node_block=8, bucket=True).layouts[
        0].blocked
    ld = bcd.local_dst.reshape(-1)
    _, node = TK._slot_nodes(bcd.local_dst, bcd.t2b, 8)
    real = node[ld < 8]
    counts = torch.bincount(real)
    assert int(counts.argmax()) == int(real[-1])
    assert int(counts.max()) > int(torch.sort(counts).values[-2])
    tiles_real = (bcd.local_dst < 8).any(dim=1)
    assert not bool(tiles_real[-1])
    btp = bcd.block_tile_ptr
    assert bool((btp[1:] == btp[:-1]).any())


def test_slot_keys_see_a_swapped_layout():
    """The check finds a layout whose tiles are out of block order."""
    g = _sparse()
    bcd = _host(g, 8, 8)
    keys = TK.slot_keys(bcd.local_dst, bcd.t2b, 8)
    assert bool((keys[1:] >= keys[:-1]).all())
    ld = bcd.local_dst.clone()
    ld[[0, -1]] = ld[[-1, 0]]
    t2b = bcd.t2b.clone()
    t2b[[0, bcd.local_dst.shape[0] - 1]] = t2b[[bcd.local_dst.shape[0] - 1,
                                                0]]
    keys = TK.slot_keys(ld, t2b, 8)
    assert not bool((keys[1:] >= keys[:-1]).all())


@pytest.mark.parametrize("chunk_tiles", [1, 2, 8, 64])
@pytest.mark.parametrize("kernel", ["K2", "K3", "K6", "K7", "K8"])
def test_cpu_route_ignores_chunk_tiles(kernel, chunk_tiles):
    rng = np.random.default_rng(chunk_tiles)
    g = _hub()
    bcd = _host(g, 8, 8)
    e = g.num_edges
    msg = torch.from_numpy(rng.normal(size=(e, 16)).astype(np.float32))
    scale_p = ops._padded_scale(
        torch.from_numpy(rng.normal(size=e).astype(np.float32)), bcd, msg)
    kw = dict(node_block=8, num_node_blocks=bcd.num_node_blocks)
    scores_p = ops._padded_scores(
        torch.from_numpy(rng.normal(size=e).astype(np.float32)), bcd)
    mx, den = TK.seg_stats_padded(scores_p, bcd.local_dst, bcd.t2b,
                                  bcd.block_tile_ptr, **kw)
    if kernel == "K2":
        args = (scores_p, bcd.local_dst, bcd.t2b, bcd.block_tile_ptr)
        fn, plain = TK.seg_stats_padded, TK.seg_stats_padded_plain
        launches = fn.launches
        got = fn(*args, **kw, chunk_tiles=chunk_tiles)
        for g, w, again in zip(got, plain(*args, **kw), fn(*args, **kw)):
            assert torch.equal(g, w) and torch.equal(g, again)
        assert fn.launches == launches
        return
    if kernel == "K3":
        mmap = ops._msg_slot_map(bcd, None).clone()
        mmap[::5] = -1
        args = (scores_p, msg, mmap, bcd.local_dst, bcd.t2b,
                bcd.block_tile_ptr, mx, den)
        fn, plain = (TK.seg_softmax_agg_gather_padded,
                     TK.seg_softmax_agg_gather_padded_plain)
    elif kernel == "K6":
        args = (scores_p, ops.pad_rows(msg, bcd.edge_map), bcd.local_dst,
                bcd.t2b, bcd.block_tile_ptr, mx, den)
        fn, plain = (TK.seg_softmax_agg_padded,
                     TK.seg_softmax_agg_padded_plain)
    elif kernel == "K7":
        mmap = ops._msg_slot_map(bcd, None).clone()
        mmap[::5] = -1
        args = (scale_p, msg, mmap, bcd.local_dst, bcd.t2b,
                bcd.block_tile_ptr)
        fn, plain = (TK.seg_weighted_agg_gather_padded,
                     TK.seg_weighted_agg_gather_padded_plain)
    else:
        args = (scale_p, ops.pad_rows(msg, bcd.edge_map), bcd.local_dst,
                bcd.t2b, bcd.block_tile_ptr)
        fn, plain = (TK.seg_weighted_agg_padded,
                     TK.seg_weighted_agg_padded_plain)
    launches = fn.launches
    got = fn(*args, **kw, chunk_tiles=chunk_tiles)
    assert torch.equal(got, plain(*args, **kw))
    assert torch.equal(got, fn(*args, **kw))
    assert fn.launches == launches


def _k3_layout(case):
    """The layouts K3's slot split has its edges at (tile 8, node block
    8): a hub whose 700 slots span many units, node blocks without tiles
    (nodes 40-89 have no edge), and a pure-pad tail of 30 tiles."""
    rng = np.random.default_rng(7)
    deg = rng.integers(0, 3, 120)
    deg[40:90] = 0
    grow = 0
    if case == "hub":
        deg[13] = 700
    elif case == "pure-pad tail":
        grow = 30
    ptr = np.zeros(len(deg) + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    bc = L.block_csr(ptr, 8, 8)
    if grow:
        bc = L.pad_blocked_csr(bc, bc.padded_edges + grow * 8)
    e = int(deg.sum())
    return ops.blocked_csr_dev(bc, np.arange(e, dtype=np.int32)), e


@pytest.mark.parametrize("d", [1, 8, 64])
@pytest.mark.parametrize("case", ["hub", "pure-pad tail",
                                  "blocks without tiles"])
def test_k3_matches_pallas_interpret_at_split_edges(case, d):
    """K3's CPU route against the reference's Pallas kernel (interpret
    mode) on K2's statistics, with compact rows and slots without a
    message; every unit size gives the same result, node blocks without
    tiles (which the Pallas kernel never writes) are zero."""
    bcd, e = _k3_layout(case)
    rng = np.random.default_rng(d)
    nb, blocks = 8, bcd.num_node_blocks
    kw = dict(node_block=nb, num_node_blocks=blocks)
    scores_p = ops._padded_scores(
        torch.from_numpy(rng.normal(size=e).astype(np.float32) * 3), bcd)
    msg = torch.from_numpy(rng.normal(size=(97, d)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 97, e).astype(np.int32))
    mmap = ops._msg_slot_map(bcd, rows).clone()
    mmap[::11] = -1
    mx, den = TK.seg_stats_padded(scores_p, bcd.local_dst, bcd.t2b,
                                  bcd.block_tile_ptr, **kw)
    args = (scores_p, msg, mmap, bcd.local_dst, bcd.t2b, bcd.block_tile_ptr,
            mx, den)
    got = TK.seg_softmax_agg_gather_padded(*args, **kw)
    for ct in (1, 2, 8, 64):
        assert torch.equal(got, TK.seg_softmax_agg_gather_padded(
            *args, **kw, chunk_tiles=ct))
    ref = np.asarray(RTK.seg_softmax_agg_gather_padded(
        jnp.asarray(scores_p.numpy()), jnp.asarray(msg.numpy()),
        jnp.asarray(mmap.numpy()), jnp.asarray(bcd.local_dst.numpy()),
        jnp.asarray(bcd.t2b.numpy()), jnp.asarray(mx.numpy()),
        jnp.asarray(den.numpy()), interpret=True, **kw))
    btp = bcd.block_tile_ptr.numpy()
    owned = np.repeat(btp[1:] > btp[:-1], nb)
    assert not owned.all()
    got = got.numpy()
    np.testing.assert_allclose(got[owned], ref[owned], rtol=2e-5, atol=2e-5)
    assert np.all(got[~owned] == 0.0)


def _split_edge_scores(bcd, e, seed):
    """Scores in [-9, 9] for ``_k3_layout``'s edges, those of the
    destination with the most edges spanning [-80, 80] (so that the max
    decides which terms underflow), padded into the slots."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(-9, 9, e).astype(np.float32)
    valid, node = TK._slot_nodes(bcd.local_dst, bcd.t2b, bcd.node_block)
    dst = np.zeros(e, np.int64)
    dst[bcd.edge_map.numpy()[valid.numpy()]] = node[valid].numpy()
    wide = dst == np.bincount(dst).argmax()
    scores[wide] = rng.permutation(np.linspace(-80, 80, int(wide.sum()),
                                               dtype=np.float32))
    return ops._padded_scores(torch.from_numpy(scores), bcd)


@pytest.mark.parametrize("case", ["hub", "pure-pad tail",
                                  "blocks without tiles"])
def test_k2_matches_pallas_interpret_at_split_edges(case):
    """K2's CPU route against the reference's Pallas kernel (interpret
    mode): ``mx`` exact and ``den`` within rtol 1e-5 on the nodes of blocks
    that own tiles (the reference rescales its sums online; the port sums
    each node's fp32 terms in fp64); the nodes of blocks without tiles,
    which the Pallas kernel never writes, are (-1e30, 0); every unit size
    gives the same result."""
    bcd, e = _k3_layout(case)
    nb = 8
    kw = dict(node_block=nb, num_node_blocks=bcd.num_node_blocks)
    scores_p = _split_edge_scores(bcd, e, 20)
    args = (scores_p, bcd.local_dst, bcd.t2b, bcd.block_tile_ptr)
    mx, den = TK.seg_stats_padded(*args, **kw)
    for ct in (1, 2, 8, 64):
        mx_ct, den_ct = TK.seg_stats_padded(*args, **kw, chunk_tiles=ct)
        assert torch.equal(mx, mx_ct) and torch.equal(den, den_ct)
    rmx, rden = (np.asarray(a).reshape(-1) for a in RTK.seg_stats_padded(
        jnp.asarray(scores_p.numpy()), jnp.asarray(bcd.local_dst.numpy()),
        jnp.asarray(bcd.t2b.numpy()), interpret=True, **kw))
    btp = bcd.block_tile_ptr.numpy()
    owned = np.repeat(btp[1:] > btp[:-1], nb)
    assert not owned.all()
    mx, den = mx.numpy().reshape(-1), den.numpy().reshape(-1)
    np.testing.assert_array_equal(mx[owned], rmx[owned])
    np.testing.assert_allclose(den[owned], rden[owned], rtol=1e-5, atol=0)
    assert np.all(mx[~owned] == np.float32(-1e30))
    assert np.all(den[~owned] == 0.0)
    assert mx.max() == np.float32(80.0)


@pytest.mark.parametrize("d", [1, 8, 64])
@pytest.mark.parametrize("case", ["hub", "pure-pad tail",
                                  "blocks without tiles"])
def test_k6_matches_pallas_interpret_at_split_edges(case, d):
    """K6's CPU route against the reference's Pallas kernel (interpret
    mode) on K2's statistics, over messages padded into the slots whose pad
    rows are not zero (they must add nothing): within 2e-5 on the nodes of
    blocks that own tiles, zero rows for the blocks without tiles; every
    unit size gives the same result."""
    bcd, e = _k3_layout(case)
    rng = np.random.default_rng(d)
    nb = 8
    kw = dict(node_block=nb, num_node_blocks=bcd.num_node_blocks)
    scores_p = _split_edge_scores(bcd, e, d)
    msg_p = ops.pad_rows(
        torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)),
        bcd.edge_map)
    msg_p[bcd.local_dst.reshape(-1) >= nb] = 1e3
    mx, den = TK.seg_stats_padded(scores_p, bcd.local_dst, bcd.t2b,
                                  bcd.block_tile_ptr, **kw)
    args = (scores_p, msg_p, bcd.local_dst, bcd.t2b, bcd.block_tile_ptr, mx,
            den)
    got = TK.seg_softmax_agg_padded(*args, **kw)
    for ct in (1, 2, 8, 64):
        assert torch.equal(got, TK.seg_softmax_agg_padded(
            *args, **kw, chunk_tiles=ct))
    ref = np.asarray(RTK.seg_softmax_agg_padded(
        jnp.asarray(scores_p.numpy()), jnp.asarray(msg_p.numpy()),
        jnp.asarray(bcd.local_dst.numpy()), jnp.asarray(bcd.t2b.numpy()),
        jnp.asarray(mx.numpy()), jnp.asarray(den.numpy()), interpret=True,
        **kw))
    btp = bcd.block_tile_ptr.numpy()
    owned = np.repeat(btp[1:] > btp[:-1], nb)
    assert not owned.all()
    got = got.numpy()
    np.testing.assert_allclose(got[owned], ref[owned], rtol=2e-5, atol=2e-5)
    assert np.all(got[~owned] == 0.0)


@pytest.fixture(scope="module")
def small_graph():
    return synthetic_heterograph(num_nodes=150, num_edges=1400, num_ntypes=4,
                                 num_etypes=7, seed=3)


@pytest.mark.parametrize("sampler", ["host", "device"])
@pytest.mark.parametrize("model", ["rgat", "hgt"])
def test_k3_calls_of_served_batches_keep_the_slot_order(small_graph, model,
                                                        sampler,
                                                        monkeypatch):
    """Every K2 and K3 call of an RGAT or HGT forward over a host-sampled
    (bucketed) or device-sampled mini-batch: its slot keys never decrease,
    K3 runs on the layout K2 ran on just before it, every pad slot's
    message index is -1, and a real slot's names a row of its message
    table (the compact unique-pair table where the plan compacts)."""
    calls, stats = [], []

    def recording(fn, into):
        def rec(*args, **kw):
            into.append((args, kw))
            return fn(*args, **kw)
        return rec

    monkeypatch.setattr(ops, "seg_softmax_agg_gather_padded", recording(
        ops.seg_softmax_agg_gather_padded, calls))
    monkeypatch.setattr(ops, "seg_stats_padded", recording(
        ops.seg_stats_padded, stats))
    prog = {"rgat": rgat_program, "hgt": hgt_program}[model]
    stack = HectorStack([prog(16, 12), prog(12, 6)], small_graph, tile=8,
                        node_block=8, device="cpu")
    params = stack.init(torch.Generator().manual_seed(0))
    feats = torch.from_numpy(np.random.default_rng(1).normal(
        size=(small_graph.num_nodes, 16)).astype(np.float32))
    seeds = np.array([3, 50, 7, 119, 0, 64, 140], dtype=np.int32)
    for bi in range(3):
        if sampler == "host":
            mb = build_minibatch(FanoutSampler(small_graph, [4, 4], seed=5)
                                 .sample(seeds, batch_index=bi),
                                 tile=8, node_block=8, bucket=True)
        else:
            mb = DeviceSampler(small_graph, [4, 4], seed=5, tile=8,
                               node_block=8, device="cpu").sample_minibatch(
                seeds, batch_index=bi)
        with torch.no_grad():
            stack.apply_blocks(params, mb, feats)
    assert len(calls) == len(stats) == 3 * 2
    for (args, kw), (sargs, skw) in zip(calls, stats):
        scores_p, msg, mmap, local_dst, t2b = args[:5]
        nb = kw["node_block"]
        assert skw == kw
        assert sargs[0] is scores_p and sargs[1] is local_dst
        assert sargs[2] is t2b and sargs[3] is args[5]
        keys = TK.slot_keys(local_dst, t2b, nb)
        assert bool((keys[1:] >= keys[:-1]).all())
        pad = local_dst.reshape(-1) >= nb
        assert bool((mmap[pad] == -1).all())
        assert bool(((mmap[~pad] >= 0) & (mmap[~pad] < msg.shape[0])).all())
