"""The port's graph, sampler, bucketing and ``build_minibatch`` give
array-identical graphs, blocks and layouts to the reference's."""
import numpy as np
import pytest

from repro.core.graph import table3_graph as ref_table3
from repro.sampling import FanoutSampler as RefSampler
from repro.sampling import SeedStream as RefStream
from repro.sampling import build_minibatch as ref_build
from repro_torch.core.graph import table3_graph
from repro_torch.sampling import FanoutSampler, SeedStream, build_minibatch
from repro_torch.sampling.bucketing import ShapeFloors
from repro.sampling.bucketing import ShapeFloors as RefShapeFloors

GRAPH_FIELDS = ("src", "dst", "etype", "etype_ptr", "node_type", "ntype_ptr",
                "perm_dst", "dst_sorted", "dst_ptr", "unique_src",
                "unique_etype", "unique_etype_ptr", "edge_to_unique")


def _graphs(name="aifb", scale=0.05, seed=0):
    return table3_graph(name, scale, seed), ref_table3(name, scale, seed)


def _assert_graph_equal(a, b):
    assert (a.num_nodes, a.num_ntypes, a.num_etypes) == \
        (b.num_nodes, b.num_ntypes, b.num_etypes)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("name,scale", [("aifb", 0.05), ("mutag", 0.02)])
def test_table3_graph_identical(name, scale):
    _assert_graph_equal(*_graphs(name, scale))


@pytest.mark.parametrize("seed", [0, 3])
def test_seed_stream_identical(seed):
    ours = SeedStream(500, 16, seed=seed)
    ref = RefStream(500, 16, seed=seed)
    for step in range(7):
        np.testing.assert_array_equal(ours.batch(step), ref.batch(step))


@pytest.mark.parametrize("fanouts", [[5, 5], [2, -1], [3, 1, 4]])
def test_sampled_blocks_identical(fanouts):
    g, rg = _graphs()
    seeds = SeedStream(g.num_nodes, 32, seed=0).batch(1)
    seq = FanoutSampler(g, fanouts, seed=7).sample(seeds, batch_index=3)
    rseq = RefSampler(rg, fanouts, seed=7).sample(seeds, batch_index=3)
    np.testing.assert_array_equal(seq.seed_perm, rseq.seed_perm)
    assert seq.num_hops == rseq.num_hops
    for b, rb in zip(seq.blocks, rseq.blocks):
        np.testing.assert_array_equal(b.node_ids, rb.node_ids)
        np.testing.assert_array_equal(b.dst_local, rb.dst_local)
        _assert_graph_equal(b.graph, rb.graph)


def _assert_layouts_equal(kl, rkl):
    for seg in ("edge_seg", "unique_seg", "node_seg"):
        a, b = getattr(kl, seg), getattr(rkl, seg)
        assert (a.tile, a.num_groups) == (b.tile, b.num_groups)
        for f in ("row_map", "inv_map", "t2g"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))
    a, b = kl.blocked, rkl.blocked
    for f in ("edge_tile", "node_block", "num_node_blocks", "num_nodes"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("edge_map", "edge_map_unique", "local_dst", "t2b"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(b, f)), err_msg=f)
    # the port's extra tile-range table is the run-length form of t2b
    t2b = np.asarray(b.t2b)[: a.local_dst.shape[0]]
    ptr = a.block_tile_ptr.numpy()
    assert ptr.shape == (a.num_node_blocks + 1,) and ptr[-1] == len(t2b)
    for blk in range(a.num_node_blocks):
        assert np.all(t2b[ptr[blk]:ptr[blk + 1]] == blk)
    for f in ("edge_src_rows", "edge_dst_rows", "unique_src_rows",
              "dst_deg"):
        np.testing.assert_array_equal(getattr(kl, f).numpy(),
                                      np.asarray(getattr(rkl, f)), err_msg=f)


@pytest.mark.parametrize("bucket,floors", [(False, False), (True, False),
                                           (True, True)])
def test_build_minibatch_identical(bucket, floors):
    g, rg = _graphs()
    seeds = SeedStream(g.num_nodes, 32, seed=0).batch(0)
    seq = FanoutSampler(g, [5, 5], seed=0).sample(seeds, batch_index=0)
    rseq = RefSampler(rg, [5, 5], seed=0).sample(seeds, batch_index=0)
    kw = dict(tile=8, node_block=8, bucket=bucket)
    mb = build_minibatch(seq, **kw,
                         shape_floors=ShapeFloors() if floors else None)
    rmb = ref_build(rseq, **kw,
                    shape_floors=RefShapeFloors() if floors else None)
    np.testing.assert_array_equal(mb.input_ids.numpy(),
                                  np.asarray(rmb.input_ids))
    np.testing.assert_array_equal(mb.seed_perm.numpy(),
                                  np.asarray(rmb.seed_perm))
    for d, rd in zip(mb.dst_locals, rmb.dst_locals):
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    for gt, rgt in zip(mb.tensors, rmb.tensors):
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                          np.asarray(getattr(rgt, f)))
        assert (gt.num_nodes, gt.num_ntypes, gt.num_etypes) == (
            rgt.num_nodes, rgt.num_ntypes, rgt.num_etypes)
    for kl, rkl in zip(mb.layouts, rmb.layouts):
        _assert_layouts_equal(kl, rkl)


def test_loader_reraises_producer_failure():
    g, _ = _graphs()
    from repro_torch.sampling import MiniBatchLoader

    def seeds(step):
        if step == 2:
            raise ValueError("boom at step 2")
        return np.arange(4, dtype=np.int32) + step

    loader = MiniBatchLoader(FanoutSampler(g, [2, 2]), seeds, tile=8,
                             node_block=8, bucket=True, num_batches=5)
    try:
        assert [next(loader).step for _ in range(2)] == [0, 1]
        with pytest.raises(ValueError, match="boom at step 2"):
            next(loader)
        assert not loader._thread.is_alive()
    finally:
        loader.close()
