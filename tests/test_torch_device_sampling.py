"""Device sampling of the port (``DeviceSampler``, K9's plain version, the
``device_*`` layout builders) against the reference's, array for array, and
against the port's host sampler; the drivers' ``--sampler device`` on the
CPU. Inputs come from numpy with a seed and go to both packages."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.graph import synthetic_heterograph as ref_graph
from repro.kernels import layout as RL
from repro.kernels import sampling_ops as RSO
from repro.sampling.device_sampler import DeviceSampler as RefDeviceSampler
from repro.sampling.sampler import edge_sample_keys as ref_edge_sample_keys
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.core.module import HectorStack
from repro_torch.kernels import layout as L
from repro_torch.kernels import ops
from repro_torch.kernels import sampling_ops as SO
from repro_torch.launch import serve_rgnn, train_rgnn
from repro_torch.models import hgt_program, rgat_program, rgcn_program
from repro_torch.sampling import (DeviceSampler, FanoutSampler,
                                  MiniBatchLoader, SeedStream,
                                  build_minibatch)
from repro_torch.sampling.sampler import (edge_sample_keys, hop_base_key,
                                          mix32)
from repro_torch.train import EngineConfig

GRAPH = dict(num_nodes=120, num_edges=900, num_ntypes=4, num_etypes=7,
             seed=0)
SEEDS = np.array([3, 50, 7, 3, 119, 0], dtype=np.int32)  # dupes on purpose
GRAPH_FIELDS = ("src", "dst", "etype", "etype_ptr", "node_type", "ntype_ptr",
                "perm_dst", "dst_sorted", "dst_ptr", "unique_src",
                "unique_etype", "unique_etype_ptr", "edge_to_unique")
TINY = dict(dataset="aifb", scale=0.05, layers=2, dim=16, hidden=16,
            tile=8, node_block=8, seed=0, device="cpu")


@pytest.fixture(scope="module")
def graph():
    return synthetic_heterograph(**GRAPH)


@pytest.fixture(scope="module")
def rgraph():
    return ref_graph(**GRAPH)


@pytest.fixture(scope="module")
def feats(graph):
    return torch.from_numpy(np.random.default_rng(1).normal(
        size=(graph.num_nodes, 16)).astype(np.float32))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=msg)


# ---------------------------------------------------------------------------
# K9's plain version
# ---------------------------------------------------------------------------
def _mix32_inverse(y: int) -> int:
    """The position key ``x`` with ``mix32(x) == y`` (the finalizer's steps
    undone in reverse order)."""
    y ^= y >> 16
    y = (y * pow(0xC2B2AE35, -1, 2**32)) & 0xFFFFFFFF
    y ^= (y >> 13) ^ (y >> 26)
    y = (y * pow(0x85EBCA6B, -1, 2**32)) & 0xFFFFFFFF
    return y ^ (y >> 16)


def test_mix32_inverse_inverts():
    xs = np.random.default_rng(0).integers(0, 2**32, 50, dtype=np.uint64)
    xs = xs.astype(np.uint32)
    for x, y in zip(xs, mix32(xs)):
        assert _mix32_inverse(int(y)) == int(x)


@pytest.mark.parametrize("rows,width,base", [
    (13, 7, 0x1234567),          # rows not a multiple of 8
    (16, 1, 0x9E3779B9),         # C = 1, base with the high bit set
    (5, 31, 0xFFFFFFFF),         # aifb's width, every base bit set
    (8, 222, 0),                 # bgs's width
])
def test_candidate_keys_plain_equals_reference_kernel(rows, width, base):
    """K9's plain version, decoded from the kernel's int32 encoding, equals
    the reference's Pallas kernel (interpret mode) and
    ``edge_sample_keys`` bit for bit, with bins of count 0 and count C."""
    rng = np.random.default_rng(rows * width)
    starts = rng.integers(0, 2**31 - width, size=rows).astype(np.int32)
    cnts = rng.integers(0, width + 1, size=rows).astype(np.int32)
    cnts[0], cnts[-1] = 0, width
    got = SO.decode_keys(SO.candidate_keys(
        torch.from_numpy(starts), torch.from_numpy(cnts), base, width))
    assert got.dtype == torch.int64
    want = RSO.candidate_keys(jnp.asarray(starts), jnp.asarray(cnts),
                              jnp.uint32(base), width,
                              backend="pallas_interpret")
    _eq(got, np.asarray(want).astype(np.int64))
    col = np.arange(width)
    keys = edge_sample_keys(np.uint32(base), starts[:, None] + col)
    _eq(got, np.where(col < cnts[:, None], keys.astype(np.int64),
                      0xFFFFFFFF))
    np.testing.assert_array_equal(
        keys, ref_edge_sample_keys(np.uint32(base), starts[:, None] + col))


def test_candidate_keys_encoding_sorts_as_uint32():
    rng = np.random.default_rng(3)
    starts = torch.from_numpy(rng.integers(0, 10**6, 40).astype(np.int32))
    cnts = torch.from_numpy(rng.integers(0, 9, 40).astype(np.int32))
    enc = SO.candidate_keys(starts, cnts, 0xDEADBEEF, 8)
    assert enc.dtype == torch.int32 and enc.shape == (40, 8)
    order = torch.argsort(enc, dim=-1, stable=True)
    dec = SO.decode_keys(enc)
    assert torch.equal(order, torch.argsort(dec, dim=-1, stable=True))
    assert int(enc[cnts == 0].min()) == SO.I32_MAX


def test_candidate_keys_rejects_other_devices():
    t = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        SO.candidate_keys(t, t, 1, 4)


# ---------------------------------------------------------------------------
# the device_* layout builders
# ---------------------------------------------------------------------------
def _block(graph, fanouts=(3, 3)):
    """A sampled hop-0 block graph (bucketing-free host arrays)."""
    return FanoutSampler(graph, list(fanouts), seed=4).sample(
        SEEDS, batch_index=1).blocks[-1].graph


@pytest.mark.parametrize("seg", ["edge", "unique", "node"])
def test_device_pad_segments_equal_reference_and_host(graph, seg):
    g = _block(graph)
    ptr, rows = {"edge": (g.etype_ptr, g.etype),
                 "unique": (g.unique_etype_ptr, g.unique_etype),
                 "node": (g.ntype_ptr, g.node_type)}[seg]
    tile = 8
    cap = rows.shape[0] + (len(ptr) - 1) * tile
    cap += -cap % tile + 2 * tile
    got = L.device_pad_segments(torch.from_numpy(ptr),
                                torch.from_numpy(rows), tile, cap)
    want = RL.device_pad_segments(jnp.asarray(ptr), jnp.asarray(rows), tile,
                                  cap)
    for a, b, name in zip(got, want, ("row_map", "inv_map", "t2g")):
        _eq(a, b, name)
    # the bundle with K5's work split equals the host bundle at the same
    # capacity; both chunk counts are the static bound
    dev = ops.device_padded_segments(torch.from_numpy(ptr),
                                     torch.from_numpy(rows), tile, cap)
    host = ops.padded_segments_dev(
        L.pad_segments_rows(L.pad_segments(ptr, tile), cap))
    for f in ("row_map", "inv_map", "t2g", "group_tile_ptr",
              "group_chunk_ptr"):
        _eq(getattr(dev, f), getattr(host, f), f)
    assert dev.num_chunks == host.num_chunks
    assert dev.chunk_tiles == host.chunk_tiles
    assert dev.num_chunks == cap // tile // dev.chunk_tiles + len(ptr) - 1
    src = torch.from_numpy(np.arange(rows.shape[0], dtype=np.int32) * 3)
    _eq(L.device_compose_gather_rows(got[0], src),
        RL.device_compose_gather_rows(jnp.asarray(got[0].numpy()),
                                      jnp.asarray(src.numpy())))


def test_device_block_csr_equals_reference_and_host(graph):
    g = _block(graph)
    tile, nb_size = 8, 8
    nb = -(-g.num_nodes // nb_size)
    cap = g.num_edges + nb * tile + 3 * tile
    cap += -cap % tile
    got = L.device_block_csr(torch.from_numpy(g.dst_ptr),
                             torch.from_numpy(g.dst_sorted), tile, nb_size,
                             cap)
    want = RL.device_block_csr(jnp.asarray(g.dst_ptr),
                               jnp.asarray(g.dst_sorted), tile, nb_size, cap)
    for a, b, name in zip(got, want, ("edge_map", "local_dst", "t2b")):
        _eq(a, b, name)
    dev = ops.device_blocked_csr(
        torch.from_numpy(g.dst_ptr), torch.from_numpy(g.dst_sorted),
        torch.from_numpy(g.perm_dst), torch.from_numpy(g.edge_to_unique),
        tile, nb_size, cap)
    host = ops.blocked_csr_dev(
        L.pad_blocked_csr(L.block_csr(g.dst_ptr, tile, nb_size), cap),
        g.perm_dst, g.edge_to_unique)
    for f in ("edge_map", "edge_map_unique", "local_dst", "t2b",
              "block_tile_ptr"):
        _eq(getattr(dev, f), getattr(host, f), f)
    assert (dev.num_node_blocks, dev.num_nodes) == (host.num_node_blocks,
                                                    host.num_nodes)


def test_scatter_drop_routes_out_of_range_writes_to_the_trash():
    out = L.scatter_drop(4, -1, torch.tensor([0, 4, 9, -2, 3]),
                         torch.tensor([10, 11, 12, 13, 14]))
    _eq(out, [10, -1, -1, 14])


# ---------------------------------------------------------------------------
# DeviceSampler against the reference's and the host sampler
# ---------------------------------------------------------------------------
def _assert_minibatch_equal(mb, rmb):
    _eq(mb.input_ids, rmb.input_ids, "input_ids")
    _eq(mb.seed_perm, rmb.seed_perm, "seed_perm")
    assert len(mb.dst_locals) == len(rmb.dst_locals)
    for d, rd in zip(mb.dst_locals, rmb.dst_locals):
        _eq(d, rd, "dst_locals")
    for b, rb in zip(mb.seq.blocks, rmb.seq.blocks):
        _eq(b.node_ids, rb.node_ids, "node_ids")
        assert (b.num_src, b.num_edges, b.num_dst) == (
            rb.num_src, rb.num_edges, rb.num_dst)
    for gt, rgt in zip(mb.tensors, rmb.tensors):
        for f in GRAPH_FIELDS:
            _eq(getattr(gt, f), getattr(rgt, f), f)
        assert (gt.num_nodes, gt.num_ntypes, gt.num_etypes) == (
            rgt.num_nodes, rgt.num_ntypes, rgt.num_etypes)
    for kl, rkl in zip(mb.layouts, rmb.layouts):
        for seg in ("edge_seg", "unique_seg", "node_seg"):
            a, b = getattr(kl, seg), getattr(rkl, seg)
            assert (a.tile, a.num_groups) == (b.tile, b.num_groups)
            for f in ("row_map", "inv_map", "t2g"):
                _eq(getattr(a, f), getattr(b, f), f"{seg}.{f}")
        a, b = kl.blocked, rkl.blocked
        for f in ("edge_tile", "node_block", "num_node_blocks", "num_nodes"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("edge_map", "edge_map_unique", "local_dst", "t2b"):
            _eq(getattr(a, f), getattr(b, f), f"blocked.{f}")
        for f in ("edge_src_rows", "edge_dst_rows", "unique_src_rows",
                  "dst_deg"):
            _eq(getattr(kl, f), getattr(rkl, f), f)


@pytest.mark.parametrize("fanouts", [[3, 3], [2, 4], [-1, -1]])
def test_device_minibatch_equals_reference_device_minibatch(
        graph, rgraph, fanouts):
    """Field for field, for the same stream positions, through the same
    bucket shrink (the drain before the second batch)."""
    dev = DeviceSampler(graph, fanouts, seed=11, tile=8, node_block=8,
                        device="cpu")
    ref = RefDeviceSampler(rgraph, fanouts, seed=11, tile=8, node_block=8)
    for bi, epoch in ((0, None), (1, None), (5, 2)):
        _assert_minibatch_equal(
            dev.sample_minibatch(SEEDS, batch_index=bi, epoch=epoch),
            ref.sample_minibatch(SEEDS, batch_index=bi, epoch=epoch))
    ours, theirs = dev.stats(), ref.stats()
    assert {k: ours[k] for k in theirs} == theirs


def _device_block_edges(mb, hop, num_nodes):
    """Global (src, dst, etype) multiset of one device block's real edges."""
    nid = mb.seq.blocks[hop].node_ids.numpy()
    gt = mb.tensors[hop]
    src_g = nid[gt.src.numpy()]
    dst_g = nid[gt.dst.numpy()]
    et = gt.etype.numpy()
    valid = (src_g < num_nodes) & (dst_g < num_nodes)
    return sorted(zip(src_g[valid].tolist(), dst_g[valid].tolist(),
                      et[valid].tolist()))


def _host_block_edges(hb):
    return sorted(zip(hb.node_ids[hb.graph.src].tolist(),
                      hb.node_ids[hb.graph.dst].tolist(),
                      hb.graph.etype.tolist()))


@pytest.mark.parametrize("fanouts", [[3, 3], [2, 4], [1]])
def test_device_sampler_matches_host_blocks(graph, fanouts):
    """For the same (seed, batch_index, epoch) both pipelines select the
    same edge multisets and produce the same frontier node sets."""
    host = FanoutSampler(graph, fanouts, seed=11)
    dev = DeviceSampler(graph, fanouts, seed=11, tile=8, node_block=8,
                        device="cpu")
    for bi in (0, 1, 5):
        seq = host.sample(SEEDS, batch_index=bi)
        mb = dev.sample_minibatch(SEEDS, batch_index=bi)
        for hop in range(len(fanouts)):
            hb = seq.blocks[hop]
            assert _device_block_edges(mb, hop, graph.num_nodes) == \
                _host_block_edges(hb)
            nid = mb.seq.blocks[hop].node_ids.numpy()
            _eq(nid[nid < graph.num_nodes], hb.node_ids)
        _eq(mb.seed_perm, seq.seed_perm)


def test_device_sampler_epoch_rekeys_stream(graph):
    dev = DeviceSampler(graph, [3, 3], seed=0, tile=8, node_block=8,
                        device="cpu")
    a = _device_block_edges(dev.sample_minibatch(SEEDS, epoch=0), 0,
                            graph.num_nodes)
    b = _device_block_edges(dev.sample_minibatch(SEEDS, epoch=1), 0,
                            graph.num_nodes)
    host = FanoutSampler(graph, [3, 3], seed=0)
    assert a != b
    assert a == _host_block_edges(host.sample(SEEDS, epoch=0).blocks[0])


def test_selection_keeps_a_valid_key_of_all_ones(graph, rgraph):
    """A valid candidate whose key is 0xFFFFFFFF ties with the invalid
    slots (INT32_MAX in the encoding); stage A must still select it at the
    rank the reference's stable argsort gives it, whatever order topk gives
    the ties."""
    dg = graph.to_device_graph("cpu")
    rdg = rgraph.to_device_graph()
    indptr = dg.csc_indptr.numpy()
    counts = np.diff(indptr)
    # bins with 2..3 candidates: all of them are kept at fanout 3
    bins = np.flatnonzero((counts >= 2) & (counts <= 3))
    frontier = np.unique(bins // graph.num_etypes).astype(np.int32)[:8]
    fp = 8
    frontier = np.concatenate([frontier, np.full(fp - len(frontier),
                                                 graph.num_nodes, np.int32)])
    k_eff = SO.effective_fanouts([3] * graph.num_etypes, dg.max_bin)
    fn = SO.make_sample_hop(dg, k_eff, fp)
    rfn = RSO.make_sample_hop(rdg, k_eff, fp)
    hits = 0
    for b in bins[:12]:
        if b // graph.num_etypes not in frontier:
            continue
        for c in range(counts[b]):       # that candidate's key is all ones
            base = _mix32_inverse(0xFFFFFFFF) ^ int(indptr[b] + c)
            got = fn(dg.csc_indptr, dg.csc_src, torch.from_numpy(frontier),
                     base)
            want = rfn(rdg.csc_indptr, rdg.csc_src, jnp.asarray(frontier),
                       jnp.uint32(base))
            for a, w in zip(got, want):
                _eq(a, w)
            hits += 1
    assert hits >= 4


@pytest.mark.parametrize("prog_fn", [rgcn_program, rgat_program,
                                     hgt_program])
def test_device_minibatch_forward_matches_host(graph, feats, prog_fn):
    """A device-built MiniBatch is a drop-in: the same per-seed outputs as
    the host-built one for the same stream position (the reference's
    bound)."""
    stack = HectorStack([prog_fn(16, 12), prog_fn(12, 6)], graph, tile=8,
                        node_block=8, device="cpu")
    params = stack.init(torch.Generator().manual_seed(0))
    mb_h = build_minibatch(
        FanoutSampler(graph, [3, 3], seed=11).sample(SEEDS, batch_index=2),
        tile=8, node_block=8, bucket=True)
    mb_d = DeviceSampler(graph, [3, 3], seed=11, tile=8, node_block=8,
                         device="cpu").sample_minibatch(SEEDS, batch_index=2)
    with torch.no_grad():
        out_h = stack.apply_blocks(params, mb_h, feats)
        out_d = stack.apply_blocks(params, mb_d, feats)
    np.testing.assert_allclose(out_d.numpy(), out_h.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_device_full_fanout_matches_full_graph(graph, feats):
    stack = HectorStack([rgat_program(16, 12), rgat_program(12, 6)], graph,
                        tile=8, node_block=8, device="cpu")
    params = stack.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        full = stack.apply(params, {"feature": feats})
        mb = DeviceSampler(graph, [-1, -1], seed=0, tile=8, node_block=8,
                           device="cpu").sample_minibatch(SEEDS)
        out = stack.apply_blocks(params, mb, feats)
    assert out.shape == (len(SEEDS), 6)
    np.testing.assert_allclose(out.numpy(), full[SEEDS].numpy(), rtol=2e-4,
                               atol=2e-4)


def test_device_sampler_builds_no_program_in_steady_state(graph):
    """Recurring stream positions (the same seeds at the same batch index)
    reuse the programs already built, and the loop never waits on a count
    readback."""
    dev = DeviceSampler(graph, [3, 3], seed=2, tile=8, node_block=8,
                        device="cpu")
    stream = SeedStream(graph.num_nodes, 6, seed=5)
    positions = [(stream.batch(i), i) for i in range(3)]
    # pass 1 builds the worst-case buckets; the drain barrier lands every
    # count inspection; pass 2 builds the shrunken buckets
    for seeds, bi in positions:
        dev.sample_minibatch(seeds, batch_index=bi)
    dev.drain(block=True)
    assert dev.bucket_shrinks > 0
    for seeds, bi in positions:
        dev.sample_minibatch(seeds, batch_index=bi)
    dev.drain(block=True)
    warm, syncs = dev.trace_count, dev.count_syncs
    assert warm == dev.cache_misses
    for _ in range(2):
        for seeds, bi in positions:
            dev.sample_minibatch(seeds, batch_index=bi)
    assert dev.trace_count == warm
    assert dev.cache_hits > 0
    assert dev.count_syncs == syncs   # steady state issued no readback
    dev.drain(block=True)
    assert dev.bucket_overflows == 0


def test_settle_rebuilds_a_batch_that_outgrew_its_buckets(graph):
    """A batch built at buckets its counts do not fit (a shrunken guess
    that a later batch outgrows) is sampled again at the worst-case
    buckets before use; a batch that fits is handed out as it is."""
    dev = DeviceSampler(graph, [3, 3], seed=11, tile=8, node_block=8,
                        device="cpu")
    want = dev.sample_minibatch(SEEDS, batch_index=2)
    assert dev.settle(want) is want
    for sig in list(dev._guess):              # guesses far too small
        dev._guess[sig] = (8, 8, 8)
        dev._shrunk.add(sig)
    small = dev.sample_minibatch(SEEDS, batch_index=2)
    assert small.seq.blocks[-1].num_src == 8
    got = dev.settle(small)
    assert got is not small and dev.overflow_rebuilds == 1
    _assert_minibatch_equal(got, want)
    dev.drain(block=True)
    assert dev.bucket_overflows == 2          # both hops outgrew (8, 8, 8)
    assert dev.stats()["overflow_rebuilds"] == 1


def test_device_loader_threadless_prefetch(graph):
    """MiniBatchLoader in device mode: the iteration / StopIteration
    contract, zero host builds, no thread, batches equal to direct
    sampling."""
    dev = DeviceSampler(graph, [3, 3], seed=2, tile=8, node_block=8,
                        device="cpu")
    stream = SeedStream(graph.num_nodes, 6, seed=5)
    loader = MiniBatchLoader(dev, stream, num_batches=5, start_step=2)
    try:
        batches = list(loader)
    finally:
        loader.close()
    assert loader.mode == "device" and loader._thread is None
    assert [mb.step for mb in batches] == [2, 3, 4, 5, 6]
    assert loader.host_builds == 0 and loader.device_builds == 5
    with pytest.raises(StopIteration):
        next(loader)
    again = DeviceSampler(graph, [3, 3], seed=2, tile=8, node_block=8,
                          device="cpu")
    for mb in batches:
        want = again.sample_minibatch(stream.batch(mb.step),
                                      batch_index=mb.step)
        _eq(_device_block_edges(mb, 0, graph.num_nodes),
            _device_block_edges(want, 0, graph.num_nodes))


def test_device_graph_csc_consistent(graph):
    """The CSC is exactly the (dst-major, etype-minor) view of the host
    graph's dst-sorted edges, and equals the reference's."""
    dg = graph.to_device_graph("cpu")
    indptr, csc_src = dg.csc_indptr.numpy(), dg.csc_src.numpy()
    assert indptr[-1] == graph.num_edges == dg.num_edges
    r = graph.num_etypes
    et_dst_sorted = graph.etype[graph.perm_dst]
    for v, t in [(3, 0), (50, 2), (119, r - 1)]:
        lo, hi = indptr[v * r + t], indptr[v * r + t + 1]
        mask = (graph.dst_sorted == v) & (et_dst_sorted == t)
        _eq(csc_src[lo:hi], graph.src[graph.perm_dst][mask])
    rdg = ref_graph(**GRAPH).to_device_graph()
    for f in ("csc_indptr", "csc_src", "node_type", "ntype_ptr"):
        _eq(getattr(dg, f), getattr(rdg, f), f)
    assert (dg.num_nodes, dg.num_ntypes, dg.num_etypes, dg.max_bin) == (
        rdg.num_nodes, rdg.num_ntypes, rdg.num_etypes, rdg.max_bin)


# ---------------------------------------------------------------------------
# the drivers and the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["rgat", "rgcn"])
def test_serve_driver_device_sampler_matches_host_sampler(model):
    runs = {}
    for sampler in ("host", "device"):
        logits = []
        stats = serve_rgnn.serve(
            model=model, fanouts=[3, 3], batch_size=8, num_batches=4,
            classes=4, sampler=sampler, log=lambda *a: None,
            on_batch=lambda mb, y: logits.append(y), **TINY)
        runs[sampler] = (stats, logits)
    (hs, hl), (ds, dl) = runs["host"], runs["device"]
    assert len(dl) == len(hl) == 4
    for a, b in zip(dl, hl):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_array_equal(ds["last_preds"], hs["last_preds"])
    assert (ds["sampler"], ds["host_builds"], ds["device_builds"]) == (
        "device", 0, 4)
    assert hs["sampler"] == "host" and hs["device_builds"] == 0
    assert ds["sampler_count_syncs_after_warmup"] == 0
    assert ds["sampler_bucket_overflows"] == 0
    assert ds["sampler_retraces_after_warmup"] == 0
    assert serve_rgnn.main(["--sampler", "device", "--device", "cpu",
                            "--scale", "0.05", "--num-batches", "2",
                            "--dim", "8", "--hidden", "8", "--classes", "3",
                            "--batch-size", "4", "--tile", "8",
                            "--node-block", "8"])["device_builds"] == 2


def test_train_driver_device_sampler_losses_match_host():
    """The first loss (the same batch and initial weights) within rtol
    1e-4; every later one too, since each step's batch holds the same
    edges (a batch that outgrew a shrunken bucket is rebuilt)."""
    kw = dict(model="rgat", dataset="aifb", scale=0.05, dim=8, hidden=8,
              classes=3, fanouts=[3, 3], batch_size=16, epochs=1, tile=8,
              node_block=8, device="cpu", eval_every_epochs=0,
              log=lambda *a: None)
    host = train_rgnn.train(**kw)
    dev = train_rgnn.train(**kw, sampler="device")
    np.testing.assert_allclose(dev["losses"][0], host["losses"][0],
                               rtol=1e-4)
    np.testing.assert_allclose(dev["losses"], host["losses"], rtol=1e-4)
    assert dev["sampler"] == "device" and dev["steps"] == host["steps"]
    assert dev["sampler_batches_sampled"] == (
        dev["steps"] + dev["sampler_overflow_rebuilds"])


def test_engine_config_rejects_unknown_sampler():
    with pytest.raises(ValueError, match="pick host/device"):
        EngineConfig(sampler="bogus")


def test_device_sampler_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_rgnn.serve(scale=0.01, sampler="device", log=lambda *a: None)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_rgnn.main(["--sampler", "device", "--scale", "0.01"])


def test_hop_base_keys_shared_with_reference():
    from repro.sampling.sampler import hop_base_key as ref_key
    for args in ((0, 0, 0, None), (11, 5, 1, 2), (3, 2**20, 2, 0)):
        assert int(hop_base_key(*args)) == int(ref_key(*args))
