"""The port's loader caches and seed streams against the reference's, on the
CPU: ``LRUCache``, ``block_signature``, the KernelLayouts and sampled-block
caches of ``build_minibatch`` / ``MiniBatchLoader`` (counters, hit rates,
the obs mirror, the epoch key of training streams) and the repeating,
Zipf-skewed and id-restricted ``SeedStream`` (the same seeds as the
reference's for the same arguments). Mirrors the cache and skew tests of
``tests/test_sampling.py``; where a mirrored test compares executor
counters, the port's counters are held to the reference's keys on the
same batches."""
import numpy as np
import pytest
import torch

from repro.core import executor as rexecutor
from repro.core.graph import synthetic_heterograph as ref_graph
from repro.sampling import FanoutSampler as RefSampler
from repro.sampling import LRUCache as RefLRUCache
from repro.sampling import MiniBatchLoader as RefLoader
from repro.sampling import SeedStream as RefStream
from repro.sampling import block_signature as ref_block_signature
from repro_torch import obs
from repro_torch.core import executor
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.core.module import HectorStack
from repro_torch.models import rgat_program
from repro_torch.sampling import (FanoutSampler, LRUCache, MiniBatchLoader,
                                  SeedStream, block_signature,
                                  build_minibatch)

GRAPH = dict(num_nodes=120, num_edges=900, num_ntypes=4, num_etypes=7,
             seed=0)
SEEDS = np.array([3, 50, 7, 3, 119, 0], dtype=np.int32)  # dupes on purpose


@pytest.fixture(scope="module")
def graph():
    return synthetic_heterograph(**GRAPH)


@pytest.fixture(scope="module")
def feats(graph):
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.normal(size=(graph.num_nodes, 16))
                            .astype(np.float32))


def _stack(graph):
    stack = HectorStack([rgat_program(16, 12), rgat_program(12, 6)], graph,
                        tile=8, node_block=8, device="cpu")
    return stack, stack.init(torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# executor keys over bucketed batches
# ---------------------------------------------------------------------------
def test_block_executor_compile_cache_hits_same_bucket(graph, feats):
    """Same-bucket blocks -> one key and a hit; a new bucket -> a miss; the
    port's keys split exactly where the reference's signatures do."""
    stack, params = _stack(graph)
    ex = stack.block_executor
    sampler = FanoutSampler(graph, [2, 2], seed=0)
    rsampler = RefSampler(ref_graph(**GRAPH), [2, 2], seed=0)
    from repro.sampling import build_minibatch as ref_build

    def both(seeds, batch_index):
        kw = dict(tile=8, node_block=8, bucket=True)
        return (build_minibatch(sampler.sample(seeds, batch_index), **kw),
                ref_build(rsampler.sample(seeds, batch_index), **kw))

    (mb0, r0), (mb1, r1) = both(SEEDS, 0), both(SEEDS, 1)
    out0 = stack.apply_blocks(params, mb0, feats, compiled=True)
    assert (ex.trace_count, ex.cache_misses, ex.cache_hits) == (1, 1, 0)
    stack.apply_blocks(params, mb0, feats, compiled=True)
    assert (ex.trace_count, ex.cache_hits) == (1, 1)
    # the op-by-op path gives the same logits (on the CPU both run op by
    # op) and counts its key as well
    np.testing.assert_array_equal(
        out0.numpy(),
        stack.apply_blocks(params, mb0, feats, compiled=False).numpy())
    assert (ex.trace_count, ex.cache_hits) == (1, 2)
    same = executor.signature((mb1.tensors, mb1.layouts)) == \
        executor.signature((mb0.tensors, mb0.layouts))
    assert same == (rexecutor.signature((r1.tensors, r1.layouts))
                    == rexecutor.signature((r0.tensors, r0.layouts)))
    stack.apply_blocks(params, mb1, feats, compiled=True)
    assert ex.trace_count == (1 if same else 2)
    # a structurally different batch (more seeds -> larger buckets): miss
    big, _ = both(np.arange(60, dtype=np.int32), 2)
    before = ex.cache_misses
    stack.apply_blocks(params, big, feats, compiled=True)
    assert ex.cache_misses == before + 1 == ex.trace_count


# ---------------------------------------------------------------------------
# LRU cache and the layout cache
# ---------------------------------------------------------------------------
def test_lru_cache_eviction_and_counters():
    for cls in (LRUCache, RefLRUCache):
        c = cls(maxsize=2)
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1          # refresh 'a': now 'b' is LRU
        c.put("c", 3)                   # evicts 'b'
        assert c.evictions == 1
        assert c.get("b") is None
        assert c.get("a") == 1 and c.get("c") == 3
        assert c.hits == 3 and c.misses == 1
        assert 0 < c.hit_rate < 1
        assert c.stats() == {"hits": 3, "misses": 1, "evictions": 1,
                             "size": 2, "hit_rate": 0.75}
    with pytest.raises(ValueError):
        LRUCache(maxsize=0)


def test_kernel_layouts_cache_by_block_signature(graph):
    sampler = FanoutSampler(graph, [3, 3], seed=7)
    seq = sampler.sample(SEEDS, batch_index=0)
    cache = LRUCache(maxsize=16)
    mb_a = build_minibatch(seq, tile=8, node_block=8, bucket=True,
                           layout_cache=cache)
    assert cache.misses == mb_a.num_hops and cache.hits == 0
    # identical sample again: all hops hit, layouts are the same objects
    mb_b = build_minibatch(seq, tile=8, node_block=8, bucket=True,
                           layout_cache=cache)
    assert cache.hits == mb_a.num_hops
    for la, lb in zip(mb_a.layouts, mb_b.layouts):
        assert la is lb
    # a scope keeps entries apart
    build_minibatch(seq, tile=8, node_block=8, bucket=True,
                    layout_cache=cache, layout_scope="shard 1")
    assert cache.misses == 2 * mb_a.num_hops
    # content-based, and the same key as the reference's for the same block
    other = sampler.sample(SEEDS, batch_index=1)
    keys = {block_signature(b.graph, 8, 8, True) for b in seq.blocks}
    keys_other = {block_signature(b.graph, 8, 8, True)
                  for b in other.blocks}
    assert keys != keys_other
    rseq = RefSampler(ref_graph(**GRAPH), [3, 3], seed=7).sample(
        SEEDS, batch_index=0)
    assert keys == {ref_block_signature(b.graph, 8, 8, True)
                    for b in rseq.blocks}


# ---------------------------------------------------------------------------
# the sampled-block cache in the loader
# ---------------------------------------------------------------------------
def _repeat_loader(loader_cls, sampler, num_nodes, distinct, total):
    return loader_cls(
        sampler, (SeedStream if loader_cls is MiniBatchLoader
                  else RefStream)(num_nodes, 6, seed=5,
                                  num_distinct=distinct),
        tile=8, node_block=8, bucket=True, num_batches=total,
        cache_blocks=8, cache_layouts=32)


def test_loader_block_cache_zero_rebuilds_on_repeats(graph, feats):
    """Repeated seed batches come from the block cache (no sampling, no
    layout build) with zero new executor keys after the first round, the
    repeats reproduce their first occurrence bit for bit, and the cache
    counters equal the reference loader's on the same stream."""
    distinct, total = 2, 8
    stack, params = _stack(graph)
    ex = stack.block_executor
    loader = _repeat_loader(MiniBatchLoader,
                            FanoutSampler(graph, [3, 3], seed=2),
                            graph.num_nodes, distinct, total)
    outs = []
    try:
        for mb in loader:
            outs.append(stack.apply_blocks(params, mb, feats).numpy())
    finally:
        loader.close()
    assert len(outs) == total
    stats = loader.cache_stats()
    assert stats["block_cache"]["misses"] == distinct
    assert stats["block_cache"]["hits"] == total - distinct
    assert stats["layout_cache"]["misses"] <= distinct * 2
    assert loader.host_builds == distinct
    assert ex.trace_count <= distinct
    assert ex.cache_hits >= total - distinct
    for i in range(distinct, total):
        np.testing.assert_array_equal(outs[i], outs[i % distinct])
    ref = _repeat_loader(RefLoader, RefSampler(ref_graph(**GRAPH), [3, 3],
                                               seed=2),
                         GRAPH["num_nodes"], distinct, total)
    try:
        for _ in ref:
            pass
    finally:
        ref.close()
    assert ref.cache_stats() == stats


def test_loader_block_cache_epoch_keyed_for_training_streams(graph):
    """A training stream (``epoch_of``) keys the block cache and the
    sampler by the epoch: the same seeds in a later epoch draw a fresh
    neighborhood and never hit; a serving stream replays the cached
    block."""
    seeds = np.arange(32, dtype=np.int32)

    def edge_key(mb):
        b = mb.seq.blocks[0]
        return (b.node_ids[b.graph.src].tobytes(),
                b.node_ids[b.graph.dst].tobytes())

    class ConstantEpochStream:
        """Same seed batch every step; one step per 'epoch'."""
        def batch(self, step):
            return seeds

        def epoch_of(self, step):
            return step

    loader = MiniBatchLoader(FanoutSampler(graph, [3, 3], seed=0),
                             ConstantEpochStream(), tile=8, node_block=8,
                             bucket=True, num_batches=3, cache_blocks=8)
    try:
        keys = [edge_key(mb) for mb in loader]
        cache = loader.block_cache.stats()
    finally:
        loader.close()
    assert len(set(keys)) == len(keys)
    assert cache["hits"] == 0

    loader = MiniBatchLoader(FanoutSampler(graph, [3, 3], seed=2),
                             lambda step: seeds[:24], tile=8, node_block=8,
                             bucket=True, num_batches=3, cache_blocks=8)
    try:
        batches = list(loader)
        stats = loader.cache_stats()["block_cache"]
    finally:
        loader.close()
    assert stats["hits"] == 2 and stats["misses"] == 1
    assert [mb.step for mb in batches] == [0, 1, 2]
    assert edge_key(batches[0]) == edge_key(batches[1]) == \
        edge_key(batches[2])


def test_loader_stats_report_cache_hit_rates(graph):
    """``build_stats`` / ``cache_stats`` carry each cache's hit rate, and
    the LRU mirrors counters and rate into the obs registry."""
    distinct, total = 2, 8
    with obs.scope(metrics=True) as sc:
        loader = _repeat_loader(MiniBatchLoader,
                                FanoutSampler(graph, [3, 3], seed=2),
                                graph.num_nodes, distinct, total)
        try:
            for _ in loader:
                pass
        finally:
            loader.close()
        bs = loader.build_stats()
        want = (total - distinct) / total
        assert bs["block_cache_hit_rate"] == pytest.approx(want)
        assert 0.0 <= bs["layout_cache_hit_rate"] <= 1.0
        assert bs["host_builds"] == distinct
        cs = loader.cache_stats()
        assert cs["block_cache"]["hit_rate"] == pytest.approx(want)
        snap = sc.registry.snapshot()
    rates = [m for m in snap["gauges"]
             if m["name"] == "loader_cache_hit_rate"
             and m["labels"].get("cache") == "block_cache"]
    assert rates and rates[0]["value"] == pytest.approx(want)
    for name in ("block_cache", "layout_cache"):
        got = {c["name"]: c["value"] for c in snap["counters"]
               if c["labels"].get("cache") == name}
        assert got.get("loader_cache_hits", 0) == cs[name]["hits"]
        assert got.get("loader_cache_misses", 0) == cs[name]["misses"]


# ---------------------------------------------------------------------------
# repeating, skewed and id-restricted seed streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(num_nodes=500), dict(num_nodes=500, num_distinct=3),
    dict(num_nodes=500, zipf_alpha=1.2),
    dict(num_nodes=500, zipf_alpha=0.7, num_distinct=4),
    dict(ids=np.array([5, 17, 40, 99, 230], dtype=np.int32)),
    dict(ids=np.arange(100, 300, 3, dtype=np.int32), zipf_alpha=1.5)])
@pytest.mark.parametrize("seed", [0, 9])
def test_seed_stream_matches_reference(kw, seed):
    ours = SeedStream(batch_size=16, seed=seed, **kw)
    ref = RefStream(batch_size=16, seed=seed, **kw)
    for step in range(9):
        got = ours.batch(step)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref.batch(step))


def test_seed_stream_zipf_deterministic_and_pinned():
    a = SeedStream(200, 64, seed=9, zipf_alpha=1.2)
    b = SeedStream(200, 64, seed=9, zipf_alpha=1.2)
    np.testing.assert_array_equal(a.batch(3), b.batch(3))
    np.testing.assert_array_equal(a.batch(3), a.batch(3))
    assert a.batch(0).dtype == np.int32
    # inverse-CDF draws over rank probabilities (r+1)^-alpha mapped through
    # the seed-keyed rank permutation, reproduced from the documented spec
    rng = np.random.default_rng((9, 3))
    p = np.arange(1, 201, dtype=np.float64) ** -1.2
    cdf = np.cumsum(p / p.sum())
    ranks = np.searchsorted(cdf, rng.random(64), side="right")
    r2i = np.random.default_rng((9, 0x5eed)).permutation(200).astype(np.int64)
    np.testing.assert_array_equal(
        a.batch(3), r2i[np.minimum(ranks, 199)].astype(np.int32))


def test_seed_stream_zipf_skews_traffic():
    n = 500
    s = SeedStream(n, 256, seed=1, zipf_alpha=1.2)
    draws = np.concatenate([s.batch(t) for t in range(40)])
    counts = np.bincount(draws, minlength=n)
    top = np.sort(counts)[::-1]
    assert top[: n // 10].sum() / counts.sum() > 0.5
    assert np.argmax(counts) == s._rank2idx[0]


def test_seed_stream_uniform_path_bitwise_unchanged():
    s = SeedStream(120, 16, seed=4)
    expected = np.random.default_rng((4, 7)).integers(
        0, 120, size=16, dtype=np.int32)
    np.testing.assert_array_equal(s.batch(7), expected)


def test_seed_stream_repeats_and_ids_population():
    s = SeedStream(300, 8, seed=2, num_distinct=3)
    for step in range(3, 9):
        np.testing.assert_array_equal(s.batch(step), s.batch(step % 3))
    ids = np.array([5, 17, 40, 99], dtype=np.int32)
    z = SeedStream(ids=ids, batch_size=32, seed=0, zipf_alpha=1.5)
    assert z.num_nodes == 4
    assert set(z.batch(0).tolist()) <= set(ids.tolist())
    u = SeedStream(ids=ids, batch_size=32, seed=0)
    assert set(u.batch(0).tolist()) <= set(ids.tolist())
    with pytest.raises(ValueError):
        SeedStream(ids=np.empty(0, np.int32))
    with pytest.raises(ValueError):
        SeedStream(100, zipf_alpha=0.0)
    with pytest.raises(ValueError):
        SeedStream()
