"""The port's tiered feature storage (``repro_torch.feats``) against the
reference's (``repro.feats``), on the CPU: the budget split and the
measured split array for array, the three tiers' gathers bit for bit (to
each other, to the table and to the reference's stores), the cached
tier's CLOCK trajectory state for state after every batch, overflow under
tiny and zero budgets, the shape counter flat after warm-up, a fully hot
batch without host work, the ``gather_input`` precedence, the factory's
validation, the loader's attach rule on block-cache hits, engine serving
and training across tiers against the reference engine (logits rtol =
atol = 1e-4; training at ``tests/test_torch_train.py``'s bounds: loss
rtol 1e-5, params rtol 1e-4 / atol 1e-6), ``hector_torch.compile``'s
``bucket=`` / ``opt=`` and both drivers' ``feature_store=``.

The graph is the reference's ``tests/test_feats.py`` graph
(``synthetic_heterograph(120, 900, 4 ntypes, 7 etypes)``), dim 16, with
Zipf id batches; every input is made with numpy from a seed and goes to
both packages."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import hector
import hector_torch
from repro.core.graph import synthetic_heterograph as ref_graph
from repro.feats import gather_input as ref_gather_input
from repro.feats import make_feature_store as ref_make
from repro.feats import split_budget as ref_split_budget
from repro.optim import AdamW as RAdamW
from repro.sampling import FanoutSampler as RFanoutSampler
from repro.sampling import SeedStream as RSeedStream
from repro.train import EngineConfig as REngineConfig
from repro.tune.feature_budget import measured_split as ref_measured_split
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.feats import (CachedFeatureStore, DeviceFeatureStore,
                               HostFeatureStore, gather_input,
                               is_feature_store, make_feature_store,
                               split_budget)
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sampling import FanoutSampler, SeedStream
from repro_torch.train import EngineConfig
from repro_torch.tune.feature_budget import measured_split

GRAPH = dict(num_nodes=120, num_edges=900, num_ntypes=4, num_etypes=7,
             seed=0)
KINDS = ("device", "host", "cached")


@pytest.fixture(scope="module")
def graph():
    return synthetic_heterograph(**GRAPH)


@pytest.fixture(scope="module")
def rgraph():
    return ref_graph(**GRAPH)


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(1)
    return rng.normal(size=(GRAPH["num_nodes"], 16)).astype(np.float32)


def id_batches(n_batches=10, batch=24, seed=3, alpha=1.2):
    s = SeedStream(GRAPH["num_nodes"], batch, seed=seed, zipf_alpha=alpha)
    return [s.batch(t) for t in range(n_batches)]


def store(feats, graph, kind, **kw):
    return make_feature_store(feats, graph, kind=kind, device="cpu", **kw)


def rows(out):
    return out["feature"].numpy()


# ---------------------------------------------------------------------------
# budget splitting
# ---------------------------------------------------------------------------
WEIGHTS = {"populations": None, "one_type": [0.0, 1.0, 0.0, 0.0],
           "skewed": [5.0, 0.5, 3.0, 1.0]}


@pytest.mark.parametrize("budget", [0, 1, 7, 40, 170])
@pytest.mark.parametrize("weights", sorted(WEIGHTS))
def test_split_budget_matches_reference(graph, rgraph, budget, weights):
    w = WEIGHTS[weights]
    got = split_budget(graph, budget, weights=w)
    want = ref_split_budget(rgraph, budget, weights=w)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    sizes = np.diff(graph.ntype_ptr)
    assert (got <= sizes).all()
    if w is None:
        assert got.sum() == min(budget, GRAPH["num_nodes"])
    with pytest.raises(ValueError):
        split_budget(graph, budget, weights=[1.0])


@pytest.mark.parametrize("fanouts", [[0], [3, 3]])
@pytest.mark.parametrize("traffic", ["one_type", "zipf"])
def test_measured_split_matches_reference(graph, rgraph, fanouts, traffic):
    """The reference's probes of one ntype's ids (fanout 0: the input rows
    are the seeds, so that type gets the whole capped budget) and of a
    Zipf stream over the graph (two hops: the split follows the measured
    counts), array for array."""
    if traffic == "one_type":
        lo, hi = int(graph.ntype_ptr[2]), int(graph.ntype_ptr[3])
        kw = dict(ids=np.arange(lo, hi, dtype=np.int32), batch_size=8,
                  seed=1)
    else:
        kw = dict(num_nodes=GRAPH["num_nodes"], batch_size=12, seed=2,
                  zipf_alpha=1.1)
    slots, report = measured_split(
        graph, FanoutSampler(graph, fanouts, seed=0), SeedStream(**kw),
        budget=30, probe_batches=3)
    rslots, rreport = ref_measured_split(
        rgraph, RFanoutSampler(rgraph, fanouts, seed=0), RSeedStream(**kw),
        budget=30, probe_batches=3)
    np.testing.assert_array_equal(slots, rslots)
    assert report == rreport
    w = np.asarray(report["row_counts"], np.float64)
    np.testing.assert_array_equal(slots, split_budget(graph, 30, weights=w))
    if traffic == "one_type" and fanouts == [0]:
        assert slots.sum() == slots[2] == min(30, np.diff(graph.ntype_ptr)[2])


# ---------------------------------------------------------------------------
# bitwise tier parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_tier_gathers_bitwise_equal_reference(graph, rgraph, feats, kind):
    """Each tier's rows equal the table's and the reference store's, batch
    by batch, whether the ids come as numpy or as a tensor; the host
    tables give the table back, and so does ``full_table``."""
    ours = store(feats, graph, kind, budget=30)
    ref = ref_make(feats, rgraph, kind=kind, budget=30)
    for step, ids in enumerate(id_batches()):
        arg = torch.from_numpy(ids) if step % 2 else ids
        got = rows(ours.gather(arg, step=step))
        np.testing.assert_array_equal(got, feats[ids])
        np.testing.assert_array_equal(
            got, np.asarray(ref.gather(ids, step=step)["feature"]))
    all_ids = np.arange(GRAPH["num_nodes"])
    np.testing.assert_array_equal(ours.host_rows(all_ids), feats)
    np.testing.assert_array_equal(ours.full_table().numpy(), feats)
    st, rst = ours.stats(), ref.stats()
    assert st == rst
    if kind == "cached":
        assert ours.hits > 0 and ours.misses > 0


@pytest.mark.parametrize("budget", [4, 24, 40, 120])
@pytest.mark.parametrize("alpha", [1.2, 1.6])
def test_cached_clock_trajectory_matches_reference(graph, rgraph, feats,
                                                   budget, alpha):
    """After every batch of a stream, the cached store's CLOCK state (slot
    owners, the id -> slot map, reference bits, hands), its counters and
    its slab equal the reference ``CachedFeatureStore``'s exactly."""
    ours = CachedFeatureStore(feats, graph, budget=budget, device="cpu")
    ref = ref_make(feats, rgraph, kind="cached", budget=budget)
    for step, ids in enumerate(id_batches(n_batches=12, alpha=alpha)):
        np.testing.assert_array_equal(
            rows(ours.gather(ids, step=step)),
            np.asarray(ref.gather(ids, step=step)["feature"]))
        np.testing.assert_array_equal(ours._slot_gid, ref._slot_gid)
        np.testing.assert_array_equal(ours._gid2slot, ref._gid2slot)
        np.testing.assert_array_equal(ours._ref, ref._ref)
        np.testing.assert_array_equal(ours._hand, ref._hand)
        assert (ours.hits, ours.misses, ours.evictions, ours.overflows) \
            == (ref.hits, ref.misses, ref.evictions, ref.overflows)
        np.testing.assert_array_equal(ours.slots.numpy(),
                                      np.asarray(ref.slots))
    if budget < 120:
        assert ours.evictions > 0


@pytest.mark.parametrize("budget", [0, 1, 4])
def test_cached_tiny_budget_overflow_and_bounded_memory(graph, rgraph, feats,
                                                        budget):
    """Batches larger than the cache overflow (ship uninserted) and stay
    bit for bit right; the device footprint is the slab's, far below the
    table's; the counters equal the reference's."""
    st = CachedFeatureStore(feats, graph, budget=budget, device="cpu")
    ref = ref_make(feats, rgraph, kind="cached", budget=budget)
    for step, ids in enumerate(id_batches(n_batches=6, batch=32)):
        np.testing.assert_array_equal(rows(st.gather(ids, step=step)),
                                      feats[ids])
        ref.gather(ids, step=step)
    assert st.overflows > 0 and st.overflows == ref.overflows
    assert st.device_bytes() < st.table_bytes
    assert st.device_bytes() == st.slots.shape[0] * st.dim * st.itemsize \
        == ref.device_bytes()


def test_cached_zero_budget_type_still_correct(graph, feats):
    # a type with zero slots ships every row uncached, still bitwise-exact
    split = np.zeros(graph.num_ntypes, dtype=np.int64)
    split[0] = 8
    st = CachedFeatureStore(feats, graph, budget=8, split=split,
                            device="cpu")
    ids = np.arange(graph.num_nodes, dtype=np.int32)
    np.testing.assert_array_equal(rows(st.gather(ids)), feats)
    assert st.overflows > 0


# ---------------------------------------------------------------------------
# shape stability, hot batches
# ---------------------------------------------------------------------------
def test_cached_zero_new_shapes_after_warmup(graph, rgraph, feats):
    """``trace_count`` counts the (miss bucket, n_idx) shapes and the hot
    read's as the reference's jit traces its two programs: equal to the
    reference's after every batch, flat after warm-up."""
    st = CachedFeatureStore(feats, graph, budget=40, device="cpu")
    ref = ref_make(feats, rgraph, kind="cached", budget=40)
    batches = id_batches(n_batches=16, batch=16, alpha=1.4)
    for step, ids in enumerate(batches[:6]):
        st.gather(ids, step=step)
        ref.gather(ids, step=step)
        assert st.trace_count == ref.trace_count
    st.gather(batches[5], step=6)        # fully hot
    ref.gather(batches[5], step=6)
    warm = st.trace_count
    for step, ids in enumerate(batches[6:], start=7):
        st.gather(ids, step=step)
        ref.gather(ids, step=step)
    assert st.trace_count == warm == ref.trace_count
    assert st.stats()["trace_count"] == st.trace_count


def test_cached_hot_batch_does_no_host_work(graph, feats):
    st = CachedFeatureStore(feats, graph, budget=graph.num_nodes,
                            device="cpu")
    ids = np.array([3, 50, 7, 3, 99, 0], dtype=np.int32)
    st.gather(ids, step=0)
    gathers, moved = st.host_gathers, st.bytes_moved
    out = st.gather(ids, step=1)          # fully hot: zero host gathers
    np.testing.assert_array_equal(rows(out), feats[ids])
    assert st.host_gathers == gathers
    assert st.bytes_moved == moved
    assert st.hit_rate > 0.0


# ---------------------------------------------------------------------------
# the consumption rule, store construction
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MB:   # minimal MiniBatch stand-in
    input_ids: object
    feats: object = None
    step: int = 0


def test_gather_input_precedence(graph, rgraph, feats):
    ids = np.array([5, 1, 5, 80], dtype=np.int32)
    tids = torch.from_numpy(ids)
    st = store(feats, graph, "cached", budget=20)
    ref = ref_make(feats, rgraph, kind="host")
    # 1) loader-attached feats win unconditionally
    pre = {"feature": torch.zeros((4, 16))}
    assert gather_input(st, MB(tids, pre)) is pre
    rpre = {"feature": jnp.zeros((4, 16))}
    assert ref_gather_input(ref, MB(jnp.asarray(ids), rpre)) is rpre
    # 2) a store gathers through its tier (state moves), or is read on the
    # host (read_only: state and counters untouched)
    out = gather_input(st, MB(tids, step=3))
    np.testing.assert_array_equal(rows(out), feats[ids])
    np.testing.assert_array_equal(rows(out), np.asarray(
        ref_gather_input(ref, MB(jnp.asarray(ids)))["feature"]))
    before = st.stats()
    out = gather_input(st, MB(torch.tensor([7, 9]), step=4), read_only=True)
    np.testing.assert_array_equal(rows(out), feats[[7, 9]])
    assert st.stats() == before
    # 3) a raw table is indexed on its device
    for table in (feats, torch.from_numpy(feats)):
        np.testing.assert_array_equal(rows(gather_input(table, MB(tids))),
                                      feats[ids])
    assert is_feature_store(st) and not is_feature_store(feats)


def test_make_feature_store_kinds_and_validation(graph, feats):
    assert isinstance(store(feats, graph, "device"), DeviceFeatureStore)
    assert isinstance(store(feats, graph, "host"), HostFeatureStore)
    cached = store(feats, graph, "cached")
    assert isinstance(cached, CachedFeatureStore)
    assert cached.capacity == graph.num_nodes // 4   # default budget
    assert store(feats, graph, "host").device_bytes() == 0
    assert store(feats, graph, "device").device_bytes() == \
        graph.num_nodes * 16 * 4
    with pytest.raises(ValueError):
        store(feats, graph, "nvme")
    with pytest.raises(ValueError):
        store(feats[:10], graph, "device")           # wrong row count
    with pytest.raises(ValueError):
        CachedFeatureStore(feats, graph, budget=8, split=[1, 2],
                           device="cpu")
    with pytest.raises(ValueError):                  # slots > table size
        split = np.diff(graph.ntype_ptr).astype(np.int64)
        split[0] += 1
        CachedFeatureStore(feats, graph, budget=8, split=split,
                           device="cpu")
    with pytest.raises(ValueError):
        EngineConfig(model="rgcn", feature_store="nvme", device="cpu")


# ---------------------------------------------------------------------------
# the loader's attach rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sampler", ["host", "device"])
@pytest.mark.parametrize("kind", KINDS)
def test_loader_attaches_feats_and_caches_none(graph, feats, sampler, kind):
    """Every batch comes with its rows, block-cache hits included, and the
    cached batches hold none (each occurrence gathers again)."""
    compiled = hector_torch.compile(
        "rgcn", graph, layers=2, dim=16, hidden=16, classes=4, sample=3,
        tile=8, node_block=8, device="cpu", sampler=sampler,
        feature_store=kind, feature_budget=30)
    st = compiled.make_feature_store(feats)
    stream = SeedStream(graph.num_nodes, 12, seed=3, num_distinct=3)
    loader = compiled.make_loader(stream, num_batches=7, cache_blocks=8,
                                  feature_store=st)
    try:
        batches = list(loader)
    finally:
        loader.close()
    assert len(batches) == 7
    assert loader.block_cache.hits == 4
    for mb in batches:
        ids = mb.input_ids.numpy()
        np.testing.assert_array_equal(rows(mb.feats), feats[ids])
    assert all(v.feats is None for v in loader.block_cache._d.values())
    if kind == "host":
        assert st.host_gathers == 7     # one gather a batch, hits too


# ---------------------------------------------------------------------------
# end to end through the engine, against the reference engine
# ---------------------------------------------------------------------------
DIMS = dict(model="rgcn", layers=2, dim=16, hidden=16, classes=4,
            fanouts=[3, 3], tile=8, node_block=8, seed=0)


def _engines(kind, budget=40):
    ref = hector.compile(None, ref_graph(**GRAPH), config=REngineConfig(
        **DIMS, feature_store=kind, feature_budget=budget))
    ours = hector_torch.compile(None, synthetic_heterograph(**GRAPH),
                                config=EngineConfig(
                                    **DIMS, feature_store=kind,
                                    feature_budget=budget, device="cpu"))
    rparams = ref.init(jax.random.key(0))
    params = ours.params_from_reference(
        [{k: np.asarray(v) for k, v in p.items()} for p in rparams])
    return ref, ours, rparams, params


def _serve(engine, store, params, fwd, stream):
    loader = engine.make_loader(stream, num_batches=5, feature_store=store)
    outs = []
    try:
        for mb in loader:
            assert mb.feats is not None
            outs.append(np.asarray(fwd(params, mb, store)))
    finally:
        loader.close()
    return np.concatenate(outs)


def test_engine_serve_and_train_parity_across_tiers(feats):
    """Served logits through the loader-attached rows: bit for bit across
    the port's tiers, within 1e-4 of the reference engine's. Training:
    four sampled steps through the same store, the losses bit for bit
    across the tiers (on the CPU the backward has no atomics), each step
    within the reference's loss bound, the final params within its
    one-step bounds of the reference's."""
    labels = np.arange(GRAPH["num_nodes"]) % 4
    logits, losses, finals = {}, {}, {}
    for kind in KINDS:
        ref, ours, rparams, params = _engines(kind)
        stream = SeedStream(GRAPH["num_nodes"], 12, seed=3, zipf_alpha=1.2)
        rstream = RSeedStream(GRAPH["num_nodes"], 12, seed=3,
                              zipf_alpha=1.2)
        st = ours.make_feature_store(feats, seed_source=stream)
        rst = ref.make_feature_store(feats, seed_source=rstream)
        assert st.kind == kind
        if kind == "cached":
            np.testing.assert_array_equal(st.slot_ptr, rst.slot_ptr)
        logits[kind] = _serve(ours, st, params, ours.forward_minibatch,
                              stream)
        want = _serve(ref, rst, rparams, ref.forward_minibatch, rstream)
        np.testing.assert_allclose(logits[kind], want, rtol=1e-4, atol=1e-4)

        ex = ours.train_executor(AdamW(learning_rate=1e-2))
        rex = ref.train_executor(RAdamW(learning_rate=1e-2))
        state = ex.opt.init(params)
        rstate = rex.opt.init(rparams)
        loader = ours.make_loader(stream, num_batches=4, feature_store=st)
        rloader = ref.make_loader(rstream, num_batches=4, feature_store=rst)
        ls = []
        try:
            for mb, rmb in zip(loader, rloader):
                state, m = ex.grad_and_update(
                    state, mb, torch.from_numpy(mb.seq.slice_labels(labels)),
                    gather_input(st, mb))
                rstate, rm = rex.grad_and_update(
                    rstate, rmb, jnp.asarray(rmb.seq.slice_labels(labels)),
                    ref_gather_input(rst, rmb))
                ls.append(float(m["loss"]))
                np.testing.assert_allclose(ls[-1], float(rm["loss"]),
                                           rtol=1e-5)
        finally:
            loader.close()
            rloader.close()
        losses[kind] = ls
        finals[kind] = tree_leaves(state.params)
        for a, b in zip(finals[kind], jax.tree.leaves(rstate.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-6)
    for kind in ("host", "cached"):
        np.testing.assert_array_equal(logits[kind], logits["device"])
        assert losses[kind] == losses["device"]
        for a, b in zip(finals[kind], finals["device"]):
            assert torch.equal(a, b)


def test_engine_make_feature_store_measured_split(feats):
    ref, ours, _, _ = _engines("cached", budget=20)
    stream = SeedStream(GRAPH["num_nodes"], 8, seed=2, zipf_alpha=1.0)
    rstream = RSeedStream(GRAPH["num_nodes"], 8, seed=2, zipf_alpha=1.0)
    st = ours.make_feature_store(feats, seed_source=stream)
    assert isinstance(st, CachedFeatureStore) and st.capacity == 20
    np.testing.assert_array_equal(
        st.slot_ptr, ref.make_feature_store(feats,
                                            seed_source=rstream).slot_ptr)
    # no seed source: the population split, the same capacity
    fallback = ours.make_feature_store(feats)
    assert fallback.capacity == 20
    np.testing.assert_array_equal(fallback.slot_ptr,
                                  ref.make_feature_store(feats).slot_ptr)


# ---------------------------------------------------------------------------
# hector_torch.compile(bucket=, opt=)
# ---------------------------------------------------------------------------
def test_compile_bucket_and_opt_match_reference(feats):
    """``bucket=False`` reaches the engine (batches at their exact sizes,
    the reference's unbucketed logits within 1e-4); ``opt=`` is
    ``train_step``'s optimizer (one step against the reference's with the
    same optimizer: loss rtol 1e-5, params rtol 1e-4 / atol 1e-6)."""
    kw = dict(layers=2, dim=16, hidden=16, classes=4, sample=3, tile=8,
              node_block=8, bucket=False)
    ref = hector.compile("rgat", ref_graph(**GRAPH), **kw,
                         opt=RAdamW(learning_rate=5e-2))
    ours = hector_torch.compile("rgat", synthetic_heterograph(**GRAPH),
                                **kw, device="cpu",
                                opt=AdamW(learning_rate=5e-2))
    assert ours.cfg.bucket is False and ours._opt.learning_rate == 5e-2
    rparams = ref.init(jax.random.key(0))
    params = ours.params_from_reference(
        [{k: np.asarray(v) for k, v in p.items()} for p in rparams])
    seeds = np.array([3, 50, 7, 3, 119, 0, 88], dtype=np.int32)
    mb = next(iter(ours.make_loader(lambda s: seeds, num_batches=1)))
    rmb = next(iter(ref.make_loader(lambda s: seeds, num_batches=1)))
    assert mb.input_ids.shape[0] == len(mb.seq.input_node_ids)   # unpadded
    np.testing.assert_allclose(ours.apply_blocks(params, mb, feats).numpy(),
                               np.asarray(ref.apply_blocks(
                                   rparams, rmb, jnp.asarray(feats))),
                               rtol=1e-4, atol=1e-4)
    labels = np.arange(GRAPH["num_nodes"]) % 4
    state, m = ours.train_step(ours.init_state(params), mb,
                               mb.seq.slice_labels(labels),
                               torch.from_numpy(feats))
    rstate, rm = ref.train_step(ref.init_state(rparams), rmb,
                                rmb.seq.slice_labels(labels),
                                jnp.asarray(feats))
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(state.params),
                    jax.tree.leaves(rstate.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------
def test_serve_driver_feature_stores_bitwise():
    """``serve(feature_store=)`` on the CPU: every batch's logits equal bit
    for bit across the tiers, under a budget that overflows too, and the
    store's stats come back as ``feature_*``."""
    from repro_torch.launch import serve_rgnn

    runs = {}
    for kind, budget in [("device", None), ("host", None),
                         ("cached", None), ("cached", 16)]:
        out = []
        stats = serve_rgnn.serve(
            model="rgat", dataset="aifb", scale=0.05, dim=16, hidden=16,
            classes=4, num_batches=4, skew=1.2, device="cpu",
            feature_store=kind, feature_budget=budget,
            on_batch=lambda mb, y: out.append(y.numpy().copy()),
            log=lambda *a: None)
        assert stats["feature_kind"] == kind
        runs[(kind, budget)] = (out, stats)
    want = runs[("device", None)][0]
    for key, (out, stats) in runs.items():
        for a, b in zip(out, want):
            np.testing.assert_array_equal(a, b)
    assert runs[("host", None)][1]["feature_device_bytes"] == 0
    assert runs[("cached", 16)][1]["feature_overflows"] > 0
    assert runs[("cached", None)][1]["feature_hits"] > 0


def test_train_driver_feature_stores():
    """``train(feature_store=)`` on the CPU: the losses equal bit for bit
    across the tiers; a host / cached run evaluates sampled and refuses
    ``parity``."""
    from repro_torch.launch import train_rgnn

    kw = dict(model="rgcn", dataset="synthetic", scale=0.05, dim=16,
              hidden=16, classes=4, fanouts=[3, 3], batch_size=32,
              epochs=1, device="cpu", log=lambda *a: None)
    runs = {kind: train_rgnn.train(**kw, feature_store=kind,
                                   feature_budget=24) for kind in KINDS}
    assert runs["host"]["losses"] == runs["device"]["losses"] \
        == runs["cached"]["losses"]
    assert "full_train_loss" in runs["device"]
    assert "sampled_train_loss" in runs["cached"]
    assert runs["cached"]["feature_hits"] + runs["cached"][
        "feature_misses"] > 0
    with pytest.raises(ValueError, match="parity"):
        train_rgnn.train(**kw, feature_store="host", parity=True)
