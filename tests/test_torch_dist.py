"""The port's data-parallel slice (``repro_torch.dist``, the data group of
``repro_torch.launch.mesh``, the loader's ``partition=``, the engine's and
``compile``'s ``dp`` / ``partitions``) against the reference's
``repro.dist`` on the CPU, case for case with ``tests/test_dist.py``.

The host side is held array for array: the partition's tables, the
sharded sampler's blocks (against the reference's and the port's own
``FanoutSampler``), seed routing, and every shard's padded blocks, fixed
layouts and hop gathers against the reference's stacked ``[P, ...]``
arrays. The executors are held as the reference holds its own: serve
logits equal to the port's plain ``BlockExecutor`` bit for bit, a train
step's loss and accuracy equal to the plain step's and its params within
rtol 2e-5 / atol 2e-6; and against the reference's ``shard_map``
executors with the reference's weights (``params_from_reference``):
logits within 1e-5, params / mu / nu within rtol 2e-5 / atol 2e-6.
Multi-rank runs are in ``tests/test_torch_dist_ranks.py``."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hector_torch
from repro.core import executor as rexecutor
from repro.core.graph import synthetic_heterograph as ref_graph
from repro.dist import ShardedBatcher as RShardedBatcher
from repro.dist import ShardedSampler as RShardedSampler
from repro.dist import partition_graph as ref_partition
from repro.dist.data import route_seeds as ref_route_seeds
from repro.launch import mesh as rmesh
from repro.optim import AdamW as RAdamW
from repro.sampling import build_minibatch as ref_build
from repro.sampling.loader import _partition_token as ref_token
from repro.train import EngineConfig as REngineConfig
from repro.train import RGNNEngine as RRGNNEngine
from repro_torch.core import executor
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.dist import (DistTrainer, ShardedBatcher, ShardedSampler,
                              check_partition, partition_graph)
from repro_torch.dist.data import route_seeds
from repro_torch.feats import make_feature_store
from repro_torch.launch import mesh
from repro_torch.launch import train_rgnn
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sampling import (FanoutSampler, MiniBatchLoader, SeedStream,
                                  build_minibatch)
from repro_torch.sampling.loader import LRUCache, _partition_token
from repro_torch.train.engine import EngineConfig, RGNNEngine

SEEDS = np.array([3, 50, 7, 3, 119, 0, 88, 12], dtype=np.int32)
GRAPH = (120, 900, 4, 7)
DIMS = dict(layers=2, dim=16, hidden=12, classes=6, fanouts=[3, 3], tile=8,
            node_block=8, seed=0)


@pytest.fixture(scope="module")
def graph():
    return synthetic_heterograph(*GRAPH, seed=0)


@pytest.fixture(scope="module")
def rgraph():
    return ref_graph(*GRAPH, seed=0)


@pytest.fixture(scope="module")
def part(graph):
    return partition_graph(graph, 4)


@pytest.fixture(scope="module")
def feats(graph):
    rng = np.random.default_rng(1)
    return rng.normal(size=(graph.num_nodes, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def labels(graph):
    return np.asarray(np.random.default_rng(2).integers(
        0, 6, graph.num_nodes))


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _np_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


_engines = {}


def _engines_for(model, graph, rgraph):
    """The port's and the reference's engines at 4 shards on one device,
    with the reference's weights carried to the port."""
    if model not in _engines:
        eng = RGNNEngine(graph, EngineConfig(model=model, partitions=4,
                                             device="cpu", **DIMS))
        reng = RRGNNEngine(rgraph, REngineConfig(model=model, partitions=4,
                                                 **DIMS))
        rparams = reng.init_params(jax.random.key(0))
        params = hector_torch.CompiledRGNN(eng).params_from_reference(
            _np_params(rparams))
        _engines[model] = (eng, reng, params, rparams)
    return _engines[model]


# ---------------------------------------------------------------------------
# partitioner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_parts", [1, 3, 4])
def test_partition_arrays_equal_reference(graph, rgraph, num_parts):
    """Edge-cut-by-dst covering invariants, and every table equal to the
    reference's: bounds, each shard's dst-CSR slice, edge slice, halo
    table and standalone subgraph."""
    ours, ref = partition_graph(graph, num_parts), ref_partition(rgraph,
                                                                 num_parts)
    assert check_partition(ours)
    np.testing.assert_array_equal(ours.bounds, ref.bounds)
    assert ours.describe() == ref.describe()
    for a, b in zip(ours.shards, ref.shards):
        assert (a.part, a.lo, a.hi) == (b.part, b.lo, b.hi)
        for f in ("dst_ptr", "src_d", "etype_d", "halo_nodes",
                  "halo_owner"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        (ga, ia), (gb, ib) = ours.shard_subgraph(a.part), \
            ref.shard_subgraph(b.part)
        np.testing.assert_array_equal(ia, ib)
        for f in ("src", "dst", "etype", "dst_ptr", "unique_src"):
            np.testing.assert_array_equal(getattr(ga, f), getattr(gb, f))
    nodes = np.arange(graph.num_nodes)
    np.testing.assert_array_equal(ours.owner_of(nodes), ref.owner_of(nodes))
    np.testing.assert_array_equal(ours.local_row(nodes),
                                  ref.local_row(nodes))


def test_partition_explicit_bounds(graph, rgraph):
    part = partition_graph(graph, 2, bounds=np.array([0, 30, 120]))
    assert check_partition(part)
    assert part.shards[0].num_owned == 30
    np.testing.assert_array_equal(part.owner_of(np.array([0, 29, 30, 119])),
                                  [0, 0, 1, 1])
    ref = ref_partition(rgraph, 2, bounds=np.array([0, 30, 120]))
    for a, b in zip(part.shards, ref.shards):
        np.testing.assert_array_equal(a.halo_nodes, b.halo_nodes)


def test_partition_errors(graph):
    with pytest.raises(ValueError):
        partition_graph(graph, 0)
    with pytest.raises(ValueError):
        partition_graph(graph, graph.num_nodes + 1)
    with pytest.raises(ValueError):
        partition_graph(graph, 2, bounds=np.array([0, 60, 60, 120]))


def test_shard_features_zero_padded(graph, part, feats):
    sf = part.shard_features(feats)
    np.testing.assert_array_equal(
        sf, ref_partition(ref_graph(*GRAPH, seed=0), 4).shard_features(feats))
    for p in range(part.num_parts):
        lo, hi = int(part.bounds[p]), int(part.bounds[p + 1])
        np.testing.assert_array_equal(sf[p, :hi - lo], feats[lo:hi])
        assert not sf[p, hi - lo:].any()
    # the engine's slabs: from the table, and through a host store's
    # host_rows (the whole table never on the device)
    eng = RGNNEngine(graph, EngineConfig(model="rgcn", partitions=4,
                                         device="cpu", **DIMS))
    np.testing.assert_array_equal(_np(eng.shard_features(feats)), sf)
    store = make_feature_store(feats, graph, kind="host", device="cpu")
    np.testing.assert_array_equal(_np(eng.shard_features(store)), sf)


# ---------------------------------------------------------------------------
# sharded sampler: same key stream as the single-box sampler
# ---------------------------------------------------------------------------
def test_sharded_sampler_matches_reference_and_fanout_sampler(
        graph, rgraph, part):
    """Selection is keyed by full-graph dst-sorted edge positions, so a
    shard sampling its owned seeds draws exactly the blocks the single-box
    sampler draws for the same seeds — and the reference's shard draws."""
    ss = ShardedSampler(part, [3, 3], seed=0)
    rss = RShardedSampler(ref_partition(rgraph, 4), [3, 3], seed=0)
    host = FanoutSampler(graph, [3, 3], seed=0)
    for p in range(part.num_parts):
        lo, hi = int(part.bounds[p]), int(part.bounds[p + 1])
        mine = SEEDS[(SEEDS >= lo) & (SEEDS < hi)]
        if mine.size == 0:
            mine = np.array([lo], dtype=np.int32)
        a = ss.sample_for_shard(p, mine, batch_index=5, epoch=2)
        r = rss.sample_for_shard(p, mine, batch_index=5, epoch=2)
        b = host.sample(mine, batch_index=5, epoch=2)
        assert len(a.blocks) == len(b.blocks) == len(r.blocks)
        for ba, bb, br in zip(a.blocks, b.blocks, r.blocks):
            for x, y in ((ba, bb), (ba, br)):
                np.testing.assert_array_equal(x.node_ids, y.node_ids)
                np.testing.assert_array_equal(x.dst_local, y.dst_local)
                for f in ("src", "dst", "etype"):
                    np.testing.assert_array_equal(getattr(x.graph, f),
                                                  getattr(y.graph, f))
        np.testing.assert_array_equal(a.seed_perm, b.seed_perm)
        np.testing.assert_array_equal(a.seed_perm, r.seed_perm)
    assert ss.stats() == rss.stats()
    assert ss.stats()["local_lookups"] + ss.stats()["halo_lookups"] > 0
    with pytest.raises(ValueError):
        ss.sample_for_shard(0, np.array([119], np.int32))


# ---------------------------------------------------------------------------
# seed routing + batcher
# ---------------------------------------------------------------------------
def test_route_seeds_reconstructs_request_order(part, rgraph):
    shard_seeds, mask, route = route_seeds(part, SEEDS)
    for a, b in zip((shard_seeds, mask, route),
                    ref_route_seeds(ref_partition(rgraph, 4), SEEDS)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(shard_seeds.reshape(-1)[route], SEEDS)
    assert mask.sum() == len(SEEDS)
    owners = part.owner_of(SEEDS)
    for p in range(part.num_parts):
        n_owned_here = int((owners == p).sum())
        np.testing.assert_array_equal(
            shard_seeds[p, n_owned_here:], part.bounds[p])
        np.testing.assert_array_equal(mask[p], np.arange(
            shard_seeds.shape[1]) < n_owned_here)
    with pytest.raises(ValueError):
        route_seeds(part, np.zeros(0, np.int32))


def test_sharded_batcher_caches_recurring_batches(part):
    bat = ShardedBatcher(part, [3, 3], seed=0, tile=8, node_block=8)
    a = bat.build(SEEDS, step=0, epoch=0)
    b = bat.build(SEEDS, step=7, epoch=0)
    assert bat.host_builds == 1 and b.step == 7
    for ga, gb in zip(a.blocks[0].tensors, b.blocks[0].tensors):
        assert ga.src.shape == gb.src.shape
    # a new epoch re-keys the sampler stream: fresh neighborhoods
    bat.build(SEEDS, step=8, epoch=1)
    assert bat.host_builds == 2
    # one ShardBlocks a shard, equal buckets across shards
    assert len(a.blocks) == part.num_parts == a.num_shards
    for h in range(a.num_hops):
        assert len({sh.tensors[h].src.shape for sh in a.blocks}) == 1
        assert len({sh.layouts[h].edge_seg.row_map.shape
                    for sh in a.blocks}) == 1
    # a batcher of some shards lays out only those
    sub = ShardedBatcher(part, [3, 3], seed=0, tile=8, node_block=8,
                         shards=(2, 3)).build(SEEDS, step=0, epoch=0)
    assert sub.shards == (2, 3) and len(sub.blocks) == 2
    np.testing.assert_array_equal(_np(sub.blocks[0].owner_rows),
                                  _np(a.blocks[2].owner_rows))


def _pad_seg_equal(a, b):
    for f in ("row_map", "inv_map", "t2g"):
        np.testing.assert_array_equal(_np(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
    assert (a.tile, a.num_groups) == (b.tile, b.num_groups)


def test_sharded_batches_equal_reference(part, rgraph):
    """Every shard's padded block graph, fixed-capacity layouts and hop
    gathers equal the reference's stacked arrays at that shard."""
    smb = ShardedBatcher(part, [3, 3], seed=0, tile=8, node_block=8).build(
        SEEDS, step=3, epoch=1)
    rmb = RShardedBatcher(ref_partition(rgraph, 4), [3, 3], seed=0, tile=8,
                          node_block=8).build(SEEDS, step=3, epoch=1)
    np.testing.assert_array_equal(smb.shard_seeds, rmb.shard_seeds)
    np.testing.assert_array_equal(_np(smb.mask), np.asarray(rmb.mask))
    np.testing.assert_array_equal(_np(smb.route), np.asarray(rmb.route))
    for p, sh in enumerate(smb.blocks):
        np.testing.assert_array_equal(_np(sh.seed_perm),
                                      np.asarray(rmb.seed_perm[p]))
        np.testing.assert_array_equal(_np(sh.owner_rows),
                                      np.asarray(rmb.owner_rows[p]))
        np.testing.assert_array_equal(_np(sh.local_rows),
                                      np.asarray(rmb.local_rows[p]))
        for h in range(smb.num_hops):
            gt, rgt = sh.tensors[h], rmb.tensors[h]
            assert gt.num_nodes == rgt.num_nodes
            for f in ("src", "dst", "etype", "etype_ptr", "node_type",
                      "perm_dst", "dst_ptr", "unique_src", "edge_to_unique"):
                np.testing.assert_array_equal(
                    _np(getattr(gt, f)), np.asarray(getattr(rgt, f)[p]))
            np.testing.assert_array_equal(_np(sh.dst_locals[h]),
                                          np.asarray(rmb.dst_locals[h][p]))
            kl, rkl = sh.layouts[h], rmb.layouts[h]
            for f in ("edge_seg", "unique_seg", "node_seg"):
                ra = getattr(rkl, f)
                _pad_seg_equal(getattr(kl, f), dataclasses.replace(
                    ra, row_map=ra.row_map[p], inv_map=ra.inv_map[p],
                    t2g=ra.t2g[p]))
            for f in ("edge_map", "edge_map_unique", "local_dst", "t2b"):
                np.testing.assert_array_equal(
                    _np(getattr(kl.blocked, f)),
                    np.asarray(getattr(rkl.blocked, f)[p]))
            for f in ("edge_src_rows", "edge_dst_rows", "unique_src_rows",
                      "dst_deg"):
                np.testing.assert_array_equal(
                    _np(getattr(kl, f)), np.asarray(getattr(rkl, f)[p]))


# ---------------------------------------------------------------------------
# loader cache partitioning (shards sharing a process)
# ---------------------------------------------------------------------------
def test_loader_cache_keys_include_partition(graph, part):
    stream = SeedStream(graph.num_nodes, 8, seed=5, num_distinct=2)
    mk = lambda partition: MiniBatchLoader(  # noqa: E731
        FanoutSampler(graph, [3, 3], seed=0), stream, tile=8, node_block=8,
        bucket=True, num_batches=1, cache_blocks=4, partition=partition)
    l0, l1, l0b, ln = mk((part, 0)), mk((part, 1)), mk((part, 0)), mk(None)
    try:
        k0, k1 = l0._cache_key(SEEDS, None), l1._cache_key(SEEDS, None)
        assert k0 != k1, "two shards would replay each other's blocks"
        assert k0 == l0b._cache_key(SEEDS, None)
        assert ln._cache_key(SEEDS, None) != k0
    finally:
        for ld in (l0, l1, l0b, ln):
            ld.close()
    # the tokens are the reference's
    rpart = ref_partition(ref_graph(*GRAPH, seed=0), 4)
    assert _partition_token((part, 1)) == ref_token((rpart, 1))
    assert _partition_token(part) == ref_token(rpart)
    assert _partition_token(None) is None and _partition_token("s0") == "s0"


def test_layout_cache_scoped_by_partition(graph):
    """A layout cache shared across shards namespaces its entries: the
    same block signature under two scopes is two entries, not a replay."""
    seq = FanoutSampler(graph, [3, 3], seed=0).sample(SEEDS, batch_index=0)
    cache = LRUCache(16, name="shared")
    build_minibatch(seq, tile=8, node_block=8, bucket=True,
                    layout_cache=cache, layout_scope="shard0")
    misses_one_scope = cache.misses
    build_minibatch(seq, tile=8, node_block=8, bucket=True,
                    layout_cache=cache, layout_scope="shard0")
    assert cache.misses == misses_one_scope
    build_minibatch(seq, tile=8, node_block=8, bucket=True,
                    layout_cache=cache, layout_scope="shard1")
    assert cache.misses == 2 * misses_one_scope


def test_partitioned_loader_serves_the_plain_batches(graph, part):
    """A loader's ``partition`` only scopes its caches: the batches it
    hands out are the unpartitioned loader's."""
    stream = SeedStream(graph.num_nodes, 8, seed=5, num_distinct=2)
    out = []
    for partition in (None, (part, 2)):
        ld = MiniBatchLoader(FanoutSampler(graph, [3, 3], seed=0), stream,
                             tile=8, node_block=8, bucket=True,
                             num_batches=3, cache_blocks=4, cache_layouts=8,
                             partition=partition)
        try:
            out.append([(_np(mb.input_ids), _np(mb.seed_perm)) for mb in ld])
        finally:
            ld.close()
    for (a, b), (c, d) in zip(*out):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


# ---------------------------------------------------------------------------
# engine config, compile and data-group surface
# ---------------------------------------------------------------------------
def test_engine_config_dist_validation():
    with pytest.raises(ValueError):
        EngineConfig(model="rgat", dp=0)
    with pytest.raises(ValueError):
        EngineConfig(model="rgat", dp=2, partitions=3)
    cfg = EngineConfig(model="rgat", dp=2)
    assert cfg.num_partitions == 2 and cfg.distributed
    cfg = EngineConfig(model="rgat", dp=2, partitions=6)
    assert cfg.num_partitions == 6
    assert not EngineConfig(model="rgat").distributed
    for dp, parts in ((1, None), (2, None), (2, 6), (1, 4)):
        a, b = EngineConfig(dp=dp, partitions=parts), \
            REngineConfig(dp=dp, partitions=parts)
        assert (a.num_partitions, a.distributed) == \
            (b.num_partitions, b.distributed)


def test_compile_takes_dp_and_partitions(graph):
    c = hector_torch.compile("rgcn", graph, device="cpu", partitions=4,
                             **{k: v for k, v in DIMS.items()
                                if k != "fanouts"}, sample=[3, 3])
    assert c.cfg.num_partitions == 4 and c.cfg.dp == 1
    assert c.partition.num_parts == 4 and c.data_mesh.dp == 1
    assert c.dist_batcher.shards == (0, 1, 2, 3)
    assert c.dist_serve_executor() is c.dist_serve_executor()
    plain = hector_torch.compile("rgcn", graph, device="cpu")
    assert plain.partition is None
    with pytest.raises(ValueError, match="partitions"):
        plain.dist_serve_executor()
    # dp > 1 needs the ranks the drivers start
    with pytest.raises(ValueError, match="launch_ranks"):
        hector_torch.compile("rgcn", graph, device="cpu", dp=2)


def test_data_group_and_elastic_plan():
    g = mesh.make_data_mesh(1, device="cpu")
    assert (g.dp, g.rank, g.backend, g.pg) == (1, 0, None, None)
    assert g.shards(4) == (0, 1, 2, 3) and g.num_local(4) == 4
    t = torch.arange(6.0).reshape(3, 2)
    assert g.all_gather(t) is t
    for dp, rank, want in ((2, 1, (2, 3)), (4, 3, (3,)), (4, 0, (0,))):
        assert mesh.DataGroup(dp=dp, rank=rank,
                              device=torch.device("cpu")).shards(4) == want
    with pytest.raises(ValueError):
        mesh.DataGroup(dp=3, rank=0, device=torch.device("cpu")).shards(4)
    with pytest.raises(ValueError):
        mesh.make_data_mesh(0)
    assert mesh.rank_device(1, 2, "cpu") == torch.device("cpu")
    assert mesh.choose_backend(2, "cpu") == "gloo"
    for n in (1, 3, 4):
        a = mesh.plan_elastic_mesh(n, model_parallel=1, data_only=True)
        b = rmesh.plan_elastic_mesh(n, model_parallel=1, data_only=True)
        assert (a.shape, a.axes, a.used_devices, a.dropped_devices,
                a.dp_degree) == (b.shape, b.axes, b.used_devices,
                                 b.dropped_devices, b.dp_degree)
    a = mesh.plan_elastic_mesh(32, model_parallel=16)   # an LM plan
    b = rmesh.plan_elastic_mesh(32, model_parallel=16)
    assert (a.shape, a.axes, a.used_devices, a.dropped_devices,
            a.dp_degree) == (b.shape, b.axes, b.used_devices,
                             b.dropped_devices, b.dp_degree)
    with pytest.raises(ValueError):
        mesh.plan_elastic_mesh(3, model_parallel=2, data_only=True)


# ---------------------------------------------------------------------------
# dist executors vs the plain executors and the reference (1 rank, P=4)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["rgat", "rgcn", "hgt"])
def test_dist_serve_matches_plain_executor_bitwise(model, graph, rgraph,
                                                   feats):
    eng, reng, params, rparams = _engines_for(model, graph, rgraph)
    seq = FanoutSampler(graph, [3, 3], seed=0).sample(SEEDS, batch_index=0,
                                                      epoch=0)
    mb = build_minibatch(seq, tile=8, node_block=8, bucket=True)
    ref = executor.BlockExecutor(eng.plans).run_minibatch(
        params, mb, torch.from_numpy(feats))

    smb = eng.dist_batcher.build(SEEDS, step=0, epoch=0)
    ex = eng.dist_serve_executor()
    got = ex.run_minibatch(params, smb, eng.shard_features(feats))
    assert torch.equal(got, ref)   # bitwise, not approx
    # and the reference's shard_map serve step, on the same weights
    rsmb = reng.dist_batcher.build(SEEDS, step=0, epoch=0)
    rgot = reng.dist_serve_executor().run_minibatch(
        rparams, rsmb, reng.shard_features(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(rgot), rtol=1e-5,
                               atol=1e-5)
    # a repeat is a cache hit, not a new key
    keys = ex.trace_count
    ex.run_minibatch(params, smb, eng.shard_features(feats))
    assert ex.trace_count == keys and ex.cache_hits >= 1


def _assert_states_close(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("model", ["rgat", "rgcn", "hgt"])
def test_dist_train_step_matches_plain_and_reference(model, graph, rgraph,
                                                     feats, labels):
    """Loss and accuracy equal to the plain step's, and the state within
    the reference's bounds of the plain step's and of the reference's
    ``shard_map`` step's. For HGT the moments (the gradients: mu = 0.1 g,
    nu = 0.05 g^2 after one step) are held, not the params: some of its
    W_K / W_Q entries get gradients of ~4e-8, near AdamW's eps = 1e-8, so
    the first step moves them by lr * g / (|g| + eps) and a summation-order
    difference of 0.7 % in such a g shows as 1e-3 relative in the
    param."""
    eng, reng, params, rparams = _engines_for(model, graph, rgraph)
    held = ("mu", "nu") if model == "hgt" else ("params", "mu", "nu")
    opt = AdamW(learning_rate=1e-2, weight_decay=0.01)
    seq = FanoutSampler(graph, [3, 3], seed=0).sample(SEEDS, batch_index=0,
                                                      epoch=0)
    mb = build_minibatch(seq, tile=8, node_block=8, bucket=True)
    s_ref, m_ref = executor.BlockTrainExecutor(eng.plans, opt) \
        .grad_and_update(opt.init(params), mb,
                         torch.from_numpy(seq.slice_labels(labels)),
                         {"feature": torch.from_numpy(feats)[
                             mb.input_ids.long()]})

    smb = eng.dist_batcher.build(SEEDS, step=0, epoch=0)
    s_got, m_got = eng.dist_train_executor(opt).grad_and_update(
        opt.init(params), smb, labels, eng.shard_features(feats))
    # the per-shard partial losses sum to the global mean exactly
    assert float(m_ref["loss"]) == float(m_got["loss"])
    assert float(m_ref["accuracy"]) == float(m_got["accuracy"])
    # gradients agree up to summation association
    for f in held:
        _assert_states_close(tree_leaves(getattr(s_got, f)),
                             [_np(t) for t in tree_leaves(getattr(s_ref, f))])

    # against the reference's shard_map step: params, mu and nu
    ropt = RAdamW(learning_rate=1e-2, weight_decay=0.01)
    rsmb = reng.dist_batcher.build(SEEDS, step=0, epoch=0)
    rstate, rm = reng.dist_train_executor(ropt).grad_and_update(
        ropt.init(rparams), rsmb, labels, reng.shard_features(feats))
    np.testing.assert_allclose(float(m_got["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    for f in held:
        _assert_states_close(tree_leaves(getattr(s_got, f)),
                             jax.tree.leaves(getattr(rstate, f)))
    assert int(s_got.step) == int(rstate.step) == 1


def test_dist_train_step_plain_reference_step_agrees(graph, rgraph, feats,
                                                     labels):
    """The reference's own plain step and the port's dist step, on the
    reference's weights: the loss within 1e-5 (the chain the two tests
    above close from both sides)."""
    eng, reng, params, rparams = _engines_for("rgat", graph, rgraph)
    ropt = RAdamW(learning_rate=1e-2, weight_decay=0.01)
    rseq = reng.sampler.sample(SEEDS, batch_index=0, epoch=0)
    rmb = ref_build(rseq, tile=8, node_block=8, bucket=True)
    _, rm = rexecutor.BlockTrainExecutor(reng.plans, ropt).grad_and_update(
        ropt.init(rparams), rmb, jnp.asarray(rseq.slice_labels(labels)),
        {"feature": jnp.asarray(feats)[rmb.input_ids]})
    opt = AdamW(learning_rate=1e-2, weight_decay=0.01)
    _, m = eng.dist_train_executor(opt).grad_and_update(
        opt.init(params), eng.dist_batcher.build(SEEDS, step=0, epoch=0),
        labels, eng.shard_features(feats))
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)


def test_dist_trainer_loop_and_eval(graph, feats, labels):
    eng = RGNNEngine(graph, EngineConfig(model="rgat", partitions=4,
                                         device="cpu", **DIMS))
    ids = np.arange(0, 64, dtype=np.int32)
    tr = DistTrainer(eng, feats, labels, ids, val_ids=ids[:16], opt=None,
                     log=None)
    state = tr.init_state(eng.init_params(torch.Generator().manual_seed(0)))
    state, stats = tr.train(state, epochs=2, batch_size=16,
                            warmup_epochs=1)
    assert stats["steps"] == 8 and len(stats["losses"]) == 8
    assert np.isfinite(stats["final_loss"])
    assert stats["retraces_after_warmup"] == 0
    assert stats["num_partitions"] == 4 and stats["dp"] == 1
    assert stats["batcher_host_builds"] == 8
    ev = tr.evaluate(state.params, ids[:16], batch_size=16)
    assert np.isfinite(ev["loss"]) and 0.0 <= ev["accuracy"] <= 1.0


def test_train_driver_refuses_what_the_reference_refuses():
    kw = dict(dataset="aifb", scale=0.05, dim=8, hidden=8, classes=4,
              fanouts=[3, 3], tile=8, node_block=8, device="cpu",
              partitions=2, obs_mode="off", log=lambda *a: None)
    for bad in (dict(parity=True), dict(profile=True),
                dict(ckpt_dir="unused"), dict(resume=True)):
        with pytest.raises(ValueError, match="--dp/--partitions"):
            train_rgnn.train(**kw, **bad)
