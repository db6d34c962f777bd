"""The port's executor keys (one CUDA graph per key on a card) against the
reference's jit cache, on the CPU, where every call runs op by op and the
same keys are counted: the key machinery itself (``_flatten`` /
``_rebuild``, the decisions fingerprint), the mirrors of
``tests/test_train.py``'s compile-cache and zero-retrace tests, the
regression that the port's ``executor_compiled`` equals the reference's
number of compiled programs on the same fresh RGAT aifb-b32 stream (a
batch's group sizes once split the keys), the host and device layout
builders' equal static fields (hypothesis), the skewed trainer stream,
``--eager`` against the default, and the capture dispatch (a key's second
call captures, owned tensors stay in place) through a stand-in graph."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import hector_torch
from repro.core import executor as rexecutor
from repro.core.graph import table3_graph as ref_table3
from repro.sampling import FanoutSampler as RefSampler
from repro.sampling import SeedStream as RefStream
from repro.sampling import build_minibatch as ref_build
from repro_torch.core import executor
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.kernels import layout as L
from repro_torch.kernels import ops
from repro_torch.launch import serve_rgnn, train_rgnn
from repro_torch.optim import AdamW
from repro_torch.sampling import build_minibatch
from repro_torch.train import SampledTrainer
from repro_torch.tune import GemmVariant, TuningDecisions

GRAPH = dict(num_nodes=120, num_edges=900, num_ntypes=4, num_etypes=7,
             seed=0)
DIMS = dict(layers=2, dim=16, hidden=12, classes=6, tile=8, node_block=8)
SEEDS = np.array([3, 50, 7, 3, 119, 0, 88, 12], dtype=np.int32)  # dupes


@pytest.fixture(scope="module")
def graph():
    return synthetic_heterograph(**GRAPH)


@pytest.fixture(scope="module")
def task(graph):
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(graph.num_nodes, 16)).astype(np.float32)
    labels = rng.integers(0, 6, graph.num_nodes)
    return feats, labels


def _engine(graph):
    return hector_torch.compile("rgat", graph, sample=[3, 3], device="cpu",
                                **DIMS)


# ---------------------------------------------------------------------------
# the key machinery
# ---------------------------------------------------------------------------
def test_flatten_rebuild_round_trip(graph, task):
    """``_rebuild`` puts new tensors into the exact structure
    ``_flatten`` visited (lists, dicts in their own key order, frozen
    layout dataclasses, the train state), static fields untouched."""
    feats, labels = task
    eng = _engine(graph)
    opt = AdamW(learning_rate=1e-2)
    state = opt.init(eng.init(0))
    seq = eng.sampler.sample(SEEDS, batch_index=0)
    mb = build_minibatch(seq, tile=8, node_block=8, bucket=True)
    args = (state, list(mb.tensors), list(mb.layouts), list(mb.dst_locals),
            mb.seed_perm, torch.zeros(len(SEEDS)),
            {"z": torch.ones(2), "feature": torch.ones(3)})
    sig, tensors = executor._flatten(args)
    assert sig == executor.signature(args)
    clones = [t.clone() for t in tensors]
    rebuilt = executor._rebuild(args, iter(clones))
    sig2, tensors2 = executor._flatten(rebuilt)
    assert sig2 == sig
    assert all(a is b for a, b in zip(tensors2, clones))
    assert list(rebuilt[6]) == ["z", "feature"]
    kl, kl2 = mb.layouts[0], rebuilt[2][0]
    assert type(kl2) is type(kl)
    assert kl2.edge_seg.num_chunks == kl.edge_seg.num_chunks
    assert kl2.edge_seg.row_map is not kl.edge_seg.row_map
    assert torch.equal(kl2.edge_seg.row_map, kl.edge_seg.row_map)


def test_key_takes_the_decisions_fingerprint_and_cpu_never_captures(
        graph, task):
    """A new decision table makes new keys (the reference's
    ``set_decisions``); going back to the old table hits again; on the CPU
    nothing is captured, whatever ``compiled`` says."""
    feats, _ = task
    eng = _engine(graph)
    params = eng.init(0)
    x = torch.from_numpy(feats)
    seq = eng.sampler.sample(SEEDS, batch_index=0)
    mb = build_minibatch(seq, tile=8, node_block=8, bucket=True)
    ex = executor.BlockExecutor(eng.plans)
    y0 = ex.run_minibatch(params, mb, x)
    assert (ex.cache_misses, ex.cache_hits) == (1, 0)
    d = TuningDecisions()
    d.set_op("gemm:dummy", GemmVariant(tile_rows=8))
    ex.set_decisions(d)
    ex.run_minibatch(params, mb, x)
    assert (ex.cache_misses, ex.cache_hits) == (2, 0)
    ex.set_decisions(None)
    y1 = ex.run_minibatch(params, mb, x, compiled=False)
    assert (ex.cache_misses, ex.cache_hits, ex.num_compiled) == (2, 1, 2)
    assert ex.captures == ex.replays == 0
    np.testing.assert_array_equal(y0.numpy(), y1.numpy())
    assert ex.cache_stats()["captures"] == 0


def test_capturing_flag_off_outside_captures():
    assert executor.capturing() is False


# ---------------------------------------------------------------------------
# mirrors of tests/test_train.py
# ---------------------------------------------------------------------------
def test_train_step_compile_cache(graph, task):
    """Same-bucket batches reuse one key (one graph on a card)."""
    feats, labels = task
    eng = _engine(graph)
    opt = AdamW(learning_rate=1e-2)
    ex = executor.BlockTrainExecutor(eng.plans, opt)
    state = opt.init(eng.init(0))
    x = torch.from_numpy(feats)

    def batch(batch_index):
        seq = eng.sampler.sample(SEEDS, batch_index=batch_index, epoch=0)
        return seq, build_minibatch(seq, tile=8, node_block=8, bucket=True)

    def step(state, seq, mb):
        return ex.grad_and_update(
            state, mb, torch.from_numpy(seq.slice_labels(labels)),
            {"feature": x[mb.input_ids.long()]})

    seq0, mb0 = batch(0)
    sig0 = executor.signature((mb0.tensors, mb0.layouts))
    state, m0 = step(state, seq0, mb0)
    assert (ex.trace_count, ex.cache_misses, ex.cache_hits) == (1, 1, 0)
    seq1, mb1 = next(
        (s, m) for s, m in map(batch, range(1, 40))
        if executor.signature((m.tensors, m.layouts)) == sig0)
    state, m1 = step(state, seq1, mb1)
    assert ex.trace_count == 1 and ex.cache_hits == 1
    assert int(state.step) == 2
    assert np.isfinite(float(m0["loss"])) and np.isfinite(float(m1["loss"]))


def test_sampled_trainer_zero_retraces_after_warmup(graph, task):
    feats, labels = task
    eng = _engine(graph)
    ids = np.arange(graph.num_nodes, dtype=np.int32)
    tr = SampledTrainer(eng, feats, labels, ids[:96], ids[96:],
                        opt=AdamW(learning_rate=1e-2), log=None)
    state = tr.init_state(eng.init(0))
    state, stats = tr.train(state, epochs=3, batch_size=32,
                            warmup_epochs=2, eval_every_epochs=3)
    assert stats["steps"] == 9 and stats["batches_per_epoch"] == 3
    assert stats["retraces_after_warmup"] == 0
    assert stats["executor_traces"] == stats["executor_compiled"]
    assert stats["losses"][-1] != stats["losses"][0]
    assert len(stats["evals"]) == 1
    ev = stats["evals"][0]
    assert {"full_val", "sampled_val"} <= set(ev)
    assert abs(ev["full_val"]["loss"] - ev["sampled_val"]["loss"]) < 1.0
    # the layout cache served the blocks it had seen
    assert stats["layout_cache_misses"] > 0
    assert int(state.step) == 9


def test_skewed_trainer_stream(graph, task):
    """``skew``: Zipf draws with replacement over the train ids, the
    reference's stream seed for seed; nominal epochs of ids // batch."""
    feats, labels = task
    eng = _engine(graph)
    ids = np.arange(10, 110, dtype=np.int32)
    tr = SampledTrainer(eng, feats, labels, ids,
                        opt=AdamW(learning_rate=1e-2), log=None)
    seen = []
    make_loader = eng.make_loader

    def spy(stream, **kw):
        seen.append(stream)
        return make_loader(stream, **kw)

    eng.engine.make_loader = spy
    state, stats = tr.train(tr.init_state(eng.init(0)), epochs=2,
                            batch_size=16, skew=1.1)
    assert stats["batches_per_epoch"] == 100 // 16
    assert stats["steps"] == 2 * (100 // 16)
    ref = RefStream(ids=ids, batch_size=16, seed=0, zipf_alpha=1.1)
    for step in range(stats["steps"]):
        np.testing.assert_array_equal(seen[0].batch(step), ref.batch(step))
    assert all(np.isfinite(stats["losses"]))


# ---------------------------------------------------------------------------
# the regression: keys from shapes alone
# ---------------------------------------------------------------------------
def test_executor_compiled_equals_reference_on_fresh_stream():
    """RGAT aifb-b32 at scale 1.0, tile 32, 16 fresh batches: the port's
    ``executor_compiled`` equals the number of programs the reference
    compiles for the same batches (its distinct jit keys), and the number
    of distinct shape signatures among the port's own batches. A static
    field read off a batch's group sizes (K5's chunk count, once) made
    more keys than shapes."""
    nb, bs = 16, 32
    sigs = []
    stats = serve_rgnn.serve(
        model="rgat", dataset="aifb", scale=1.0, dim=16, hidden=16,
        classes=4, batch_size=bs, num_batches=nb, tile=32, node_block=32,
        device="cpu", log=lambda *a: None,
        on_batch=lambda mb, y: sigs.append(executor.signature(
            (mb.tensors, mb.layouts, mb.dst_locals, mb.seed_perm,
             mb.input_ids))))
    rg = ref_table3("aifb", 1.0, 0)
    sampler = RefSampler(rg, [5, 5], seed=0)
    stream = RefStream(rg.num_nodes, bs, seed=0)
    ref_keys = set()
    for step in range(nb):
        seq = sampler.sample(stream.batch(step), batch_index=step)
        mb = ref_build(seq, step=step, tile=32, node_block=32, bucket=True)
        ref_keys.add(rexecutor.signature(
            (list(mb.tensors), list(mb.layouts), list(mb.dst_locals),
             mb.seed_perm, mb.input_ids)))
    assert stats["executor_compiled"] == len(ref_keys) == len(set(sigs))
    assert stats["executor_compiled"] < nb
    assert stats["retraces_after_warmup"] == \
        stats["executor_compiled"] - len(set(sigs[:2]))


@settings(max_examples=60, deadline=None)
@given(sizes=st.lists(st.integers(0, 300), min_size=1, max_size=24),
       tile=st.sampled_from([8, 16, 32]), grow=st.integers(1, 5))
def test_host_and_device_padded_segments_agree(sizes, tile, grow):
    """On any segment sizes and capacity the host builder
    (``padded_segments_dev``) and the device one
    (``device_padded_segments``) give equal fields, the static ones
    included; the chunk count covers ``group_chunk_ptr[-1]`` and depends
    on the capacity and group count alone."""
    sizes = np.asarray(sizes, dtype=np.int64)
    r = len(sizes)
    ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    cap = (int(sizes.sum()) + r * tile) * grow    # the device's capacity
    cap += -cap % tile
    host = ops.padded_segments_dev(
        L.pad_segments_rows(L.pad_segments(ptr, tile), cap))
    dev = ops.device_padded_segments(
        torch.from_numpy(ptr),
        torch.from_numpy(np.repeat(np.arange(r, dtype=np.int32), sizes)),
        tile, cap)
    for f in dataclasses.fields(ops.PaddedSegmentsDev):
        a, b = getattr(host, f.name), getattr(dev, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f.name)
        else:
            assert a == b, f.name
    assert host.num_chunks >= int(host.group_chunk_ptr[-1])
    assert host.num_chunks == ops.static_chunk_count(
        cap, tile, host.chunk_tiles, r)


# ---------------------------------------------------------------------------
# the drivers' --eager against the default
# ---------------------------------------------------------------------------
SERVE = dict(model="hgt", dataset="aifb", scale=0.05, dim=8, hidden=8,
             classes=4, fanouts=[3, 3], batch_size=8, num_batches=6, tile=8,
             node_block=8, repeat_after=2, cache_blocks=4, cache_layouts=16,
             device="cpu", log=lambda *a: None)


def test_serve_eager_equals_default():
    runs = {}
    for compiled in (True, False):
        logits = []
        stats = serve_rgnn.serve(
            **SERVE, compiled=compiled,
            on_batch=lambda mb, y: logits.append(y.clone()))
        runs[compiled] = (stats, logits)
    (a, la), (b, lb) = runs[True], runs[False]
    assert len(la) == len(lb) == SERVE["num_batches"]
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    for k in ("executor_traces", "executor_compiled",
              "retraces_after_warmup", "block_cache_hits",
              "layout_cache_misses"):
        assert a[k] == b[k], k
    assert a["retraces_after_warmup"] == 0 and a["warmup_batches"] == 2
    assert a["block_cache_hits"] == SERVE["num_batches"] - 2
    assert a["executor_captures"] == b["executor_captures"] == 0


def test_driver_flags():
    """``--eager``, ``--skew``, ``--repeat-after`` and the cache sizes
    reach both drivers."""
    kw = ["--device", "cpu", "--scale", "0.05", "--dim", "8", "--hidden",
          "8", "--classes", "4", "--tile", "8", "--node-block", "8",
          "--obs", "off"]
    s = serve_rgnn.main(kw + ["--num-batches", "4", "--batch-size", "8",
                              "--repeat-after", "2", "--cache-blocks", "4",
                              "--cache-layouts", "8", "--skew", "1.1",
                              "--eager"])
    assert s["block_cache_hits"] == 2 and s["retraces_after_warmup"] == 0
    t = train_rgnn.main(["--device", "cpu", "--model", "rgcn", "--reduced",
                         "--epochs", "1", "--skew", "1.1", "--eager",
                         "--eval-every-epochs", "0", "--obs", "off"])
    assert t["steps"] > 0 and np.isfinite(t["final_loss"])


class _Probe(executor._Executor):
    """An executor whose "graph" reruns the captured function over its
    static inputs: the dispatch of ``_run`` and ``_replay`` on the CPU."""

    def __init__(self):
        super().__init__([])

    @staticmethod
    def _capturable(tensors):
        return True

    def _capture(self, fn, args, tensors, own):
        inputs = [t if j in own else torch.empty_like(t)
                  for j, t in enumerate(tensors)]
        static = executor._rebuild(args, iter(inputs))
        outputs = fn(*static)
        self.captures += 1
        return executor._Graph(_Rerun(fn, static), inputs, outputs)


class _Rerun:
    def __init__(self, fn, static):
        self.fn, self.static = fn, static

    def replay(self):
        self.fn(*self.static)


def test_second_call_captures_owned_tensors_in_place():
    """A key's first call runs op by op, its second captures and replays,
    every later one replays (a replay per repeated key); the owned
    tensor is captured in place and never copied into, and another owned
    tensor of the same shape gets its own graph under the same key."""
    out = torch.zeros(4)

    def eager(x, table):
        return x * 2 + table

    def captured(x, table):
        out.copy_(x * 2 + table)
        return out

    ex = _Probe()
    table, other = torch.arange(4.0), torch.full((4,), 10.0)
    for i in range(4):
        x = torch.full((4,), float(i))
        y = ex._run(eager, captured, (x, table), True, torch.clone,
                    owned=(1,))
        torch.testing.assert_close(y, x * 2 + table, rtol=0, atol=0)
        assert y is not out
    assert (ex.num_compiled, ex.cache_hits) == (1, 3)
    assert (ex.captures, ex.replays) == (1, 3)
    (entry,) = ex._graphs.values()
    assert entry.inputs[1] is table and entry.inputs[0] is not x
    assert torch.equal(table, torch.arange(4.0))
    for i in range(2):
        y = ex._run(eager, captured, (x, other), True, torch.clone,
                    owned=(1,))
        torch.testing.assert_close(y, x * 2 + other, rtol=0, atol=0)
    assert (ex.num_compiled, ex.captures, ex.replays) == (1, 2, 4)
    ex._run(eager, captured, (x, table), False, torch.clone, owned=(1,))
    assert (ex.captures, ex.replays, ex.cache_hits) == (2, 4, 6)


def test_flatten_ends_mark_each_argument():
    args = (torch.ones(2), {"a": torch.ones(1), "b": 3},
            [torch.ones(3), torch.ones(4)], 7)
    ends = []
    sig, tensors = executor._flatten(args, ends)
    assert (sig, len(tensors)) == (executor.signature(args), 4)
    assert ends == [1, 2, 4, 4]
