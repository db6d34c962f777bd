"""The work split of K1 and K4 (``segment_mm_gather_padded``,
``segment_mm_padded``) and what the kernels rely on, pinned on the CPU.

The Hopper kernels cut a call by ``segment_mm.gemm_plan`` (from the shapes
alone): a narrow route for n <= 16 (a row a thread) and a wide route (a
register tile a thread), persistent blocks each walking a span of rows.
Inside a span the kernels find runs of consecutive tiles of one group and
stage each group's W once a run, and K1 skips the tiles whose gather
indices are all -1. So they rely on:

* ``t2g`` never decreasing (a run is then one group's whole stretch of the
  span), held for every layout builder: host ``pad_segments`` and its
  bucketed growth, ``ops.device_padded_segments``, the layouts of a served
  host- or device-sampled mini-batch with their pure-pad tail, and
  ``ops.gemm_tiles``' sub-tiles at ``tile_rows`` 8 / 16;
* the pure-pad tiles of K1's gather layouts holding only -1;
* the plan covering every row (so every tile) and column exactly once,
  at every (k, n) the model zoo produces, with the narrow route exactly
  for n <= 16.

The CPU route, which ignores the split and ``tile_n``, is held to the
reference's Pallas kernels in interpret mode where the split has its
edges: a group change inside a block, the pure-pad tail, n = 1, k = 300,
a transposed W, the scale. Tolerance 1e-5, the reference's own
kernel-vs-oracle bound (``tests/test_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segment_mm as RSK
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.core.module import HectorStack
from repro_torch.kernels import layout as L
from repro_torch.kernels import ops
from repro_torch.kernels import segment_mm as SK
from repro_torch.sampling import DeviceSampler
from repro_torch.sampling.loader import build_minibatch
from repro_torch.sampling.sampler import FanoutSampler
from repro_torch.train.engine import MODEL_PROGRAMS

TOL = dict(rtol=1e-5, atol=1e-5)
SEEDS = np.array([3, 50, 7, 119, 0, 64, 140], dtype=np.int32)


@pytest.fixture(scope="module")
def graph():
    return synthetic_heterograph(num_nodes=150, num_edges=1400, num_ntypes=4,
                                 num_etypes=7, seed=3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sizes(seed, groups=12, top=90):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, top, groups)
    sizes[[1, 4, groups - 2]] = 0               # groups that own no tile
    return sizes


def _ptr(sizes):
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def _minibatch(graph, sampler, bi):
    if sampler == "host":
        return build_minibatch(FanoutSampler(graph, [4, 4], seed=5).sample(
            SEEDS, batch_index=bi), tile=8, node_block=8, bucket=True)
    return DeviceSampler(graph, [4, 4], seed=5, tile=8, node_block=8,
                         device="cpu").sample_minibatch(SEEDS, batch_index=bi)


def _t2g_maps(builder, graph):
    """(t2g, number of tiles) of every layout ``builder`` makes."""
    out = []
    if builder in ("host", "host bucketed"):
        for seed in range(4):
            for tile in (8, 32):
                ps = L.pad_segments(_ptr(_sizes(seed)), tile)
                if builder == "host bucketed":
                    ps = L.pad_segments_rows(
                        ps, L.pow2ceil(ps.padded_rows) * 2)
                out.append((ps.tile_to_group, ps.padded_rows // tile))
    elif builder == "device":
        for seed in range(4):
            sizes = _sizes(seed)
            group = np.repeat(np.arange(len(sizes)), sizes)
            for tile in (8, 32):
                rows = int(sizes.sum()) + len(sizes) * tile + 3 * tile
                rows += -rows % tile
                lay = ops.device_padded_segments(
                    _t(_ptr(sizes).astype(np.int32)),
                    _t(group.astype(np.int32)), tile, rows)
                out.append((lay.t2g.numpy(), rows // tile))
    elif builder.startswith("served"):
        for bi in range(3):
            mb = _minibatch(graph, builder.split()[1], bi)
            for lay in mb.layouts:
                for seg in (lay.edge_seg, lay.unique_seg, lay.node_seg):
                    out.append((seg.t2g.numpy(),
                                seg.row_map.shape[0] // seg.tile))
    else:                                       # gemm_tiles' sub-tiles
        tile_rows = int(builder.split()[1])
        for seed in range(4):
            lay = ops.padded_segments_dev(L.pad_segments(
                _ptr(_sizes(seed)), 32))
            tiles = ops.gemm_tiles(lay, tile_rows=tile_rows)
            assert tiles.tile == tile_rows
            out.append((tiles.t2g.numpy(),
                        lay.row_map.shape[0] // tile_rows))
    return out


@pytest.mark.parametrize("builder", [
    "host", "host bucketed", "device", "served host", "served device",
    "gemm_tiles 8", "gemm_tiles 16"])
def test_t2g_never_decreases(builder, graph):
    maps = _t2g_maps(builder, graph)
    assert maps
    for t2g, num_tiles in maps:
        t = np.asarray(t2g)[:num_tiles]
        assert t.shape[0] == num_tiles
        assert np.all(np.diff(t.astype(np.int64)) >= 0), t


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_pure_pad_tiles_gather_only_minus_one(graph, sampler):
    """Every pad slot of a served mini-batch's K1 gather layouts is -1, so
    a tile of pad slots (the bucketed pure-pad tail among them) is all -1;
    real slots gather a real row."""
    tails = 0
    for bi in range(3):
        mb = _minibatch(graph, sampler, bi)
        for lay in mb.layouts:
            for seg, rows in ((lay.edge_seg, lay.edge_src_rows),
                              (lay.edge_seg, lay.edge_dst_rows),
                              (lay.unique_seg, lay.unique_src_rows)):
                pad = seg.row_map < 0
                assert rows.shape == seg.row_map.shape
                assert bool((rows[pad] == -1).all())
                assert bool((rows[~pad] >= 0).all())
                per_tile = rows.reshape(-1, seg.tile)
                pure = (seg.row_map.reshape(-1, seg.tile) < 0).all(dim=1)
                assert bool((per_tile[pure] == -1).all())
                tails += int(pure[-1])
    assert tails > 0                            # bucketing left a pad tail


def _zoo_calls(graph):
    """(rows, k, n) of every K1 / K4 call of a served forward and of a
    full-graph forward and backward of each registry model at the zoo's
    widths (64 wide; 16 and 8 classes)."""
    shapes = set()

    def recording(fn, kind):
        def rec(*args, **kw):
            if kind == "k1":
                rows, k, n = args[2].shape[0], args[1].shape[1], \
                    args[1].shape[2]
            else:
                w = args[1]
                rows, k = args[0].shape
                n = w.shape[1] if kw.get("transpose_w") else w.shape[2]
            shapes.add((int(rows), int(k), int(n)))
            return fn(*args, **kw)
        return rec

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "segment_mm_gather_padded",
               recording(ops.segment_mm_gather_padded, "k1"))
    mp.setattr(SK, "segment_mm_padded",
               recording(SK.segment_mm_padded, "k4"))
    try:
        feats = torch.from_numpy(np.random.default_rng(1).normal(
            size=(graph.num_nodes, 64)).astype(np.float32))
        mb = _minibatch(graph, "host", 0)
        for name, prog in sorted(MODEL_PROGRAMS.items()):
            for classes in (16, 8):
                stack = HectorStack([prog(64, 64), prog(64, classes)], graph,
                                    tile=8, node_block=8, device="cpu")
                params = stack.init(torch.Generator().manual_seed(0))
                with torch.no_grad():            # the served forward
                    stack.apply_blocks(params, mb, feats)
                for layer in params:             # a full-graph step
                    for p in layer.values():
                        p.requires_grad_(True)
                out = stack.apply(params, {"feature": feats})
                out.square().sum().backward()
    finally:
        mp.undo()
    return sorted(shapes)


def _blocks(plan, rows, n):
    """The (rows, columns) each thread block of a plan covers: the
    kernels' grid, ceil(rows / block_rows) spans by col_blocks slices."""
    for by in range(plan.col_blocks):
        cols = range(by * plan.block_cols,
                     min(n, (by + 1) * plan.block_cols))
        for bx in range(-(-rows // plan.block_rows)):
            yield (range(bx * plan.block_rows,
                         min(rows, (bx + 1) * plan.block_rows)), cols)


# padded row counts of the phases the card runs: served aifb / bgs
# batches, an aifb training step, the bgs full-graph steps' calls
CARD_ROWS = (512, 4096, 16384, 95488, 131072, 495904, 674784)


def test_zoo_calls_cover_both_routes(graph):
    calls = _zoo_calls(graph)
    ns = {n for _, _, n in calls}
    assert {1, 8, 16, 64} <= ns                 # attention, classes, hidden
    assert any(k == 1 for _, k, _ in calls)     # the n = 1 products' dX


def test_gemm_plan_covers_every_row_and_column_once(graph):
    """At every (k, n) the zoo produces, at its own row counts and the
    card's: each row (so each tile, at any tile) and each column lies in
    exactly one block; the narrow route exactly for n <= 16."""
    calls = _zoo_calls(graph)
    checked = 0
    for rows0, k, n in calls:
        for rows in sorted({rows0, *CARD_ROWS}):
            plan = SK.gemm_plan(rows, n)
            assert plan.route == ("narrow" if n <= 16 else "wide")
            if plan.route == "narrow":
                assert plan.per_thread in SK.GEMM_NARROW_WIDTHS
                assert plan.per_thread >= n and plan.col_blocks == 1
                assert plan.piece_rows == SK.GEMM_NARROW_ROWS
            else:
                assert plan.per_thread in (2, 8)
                assert plan.piece_rows == 16 * plan.per_thread
            assert plan.block_rows % plan.piece_rows == 0
            assert plan.block_rows <= SK.GEMM_SPAN_MAX
            # the blocks are row spans x column slices: each (span, slice)
            # once, the spans tiling the rows, the slices the columns
            blocks = list(_blocks(plan, rows, n))
            assert len(blocks) == plan.row_blocks * plan.col_blocks
            assert len(set((rr.start, cc.start) for rr, cc in blocks)) == \
                len(blocks)
            row_hits = np.zeros(rows, np.int32)
            col_hits = np.zeros(n, np.int32)
            for rr, cc in blocks:
                assert len(rr) > 0 and len(cc) > 0
                if cc.start == 0:
                    row_hits[rr.start:rr.stop] += 1
                if rr.start == 0:
                    col_hits[cc.start:cc.stop] += 1
            assert np.all(row_hits == 1) and np.all(col_hits == 1), \
                (rows, k, n, plan)
            checked += 1
    assert checked >= len(calls) * len(CARD_ROWS)


@pytest.mark.parametrize("n", [1, 4, 5, 8, 12, 16, 17, 64, 96, 300])
@pytest.mark.parametrize("rows", [1, 31, 4096, 70000, 674784, 3_000_000])
def test_gemm_plan_routes_and_spans(rows, n):
    plan = SK.gemm_plan(rows, n)
    if n <= SK.GEMM_NARROW_MAX_N:
        assert plan.route == "narrow"
        assert plan.per_thread == min(c for c in SK.GEMM_NARROW_WIDTHS
                                      if c >= n)
    else:
        assert plan.route == "wide"
        assert plan.col_blocks == -(-n // SK.GEMM_WIDE_COLS)
        big = -(-rows // 128) * plan.col_blocks >= SK.GEMM_WIDE_MIN_PIECES
        assert plan.per_thread == (8 if big else 2)
    assert plan.row_blocks == -(-rows // plan.block_rows)
    assert plan.block_rows <= SK.GEMM_SPAN_MAX
    assert SK.gemm_plan(rows, n) is plan        # cached: no per-call cost
    with pytest.raises(ValueError):
        SK.gemm_plan(0, n)


# ---------------------------------------------------------------------------
# the CPU route against the Pallas kernels at the split's edges
# ---------------------------------------------------------------------------
K1_CASES = {
    # group changes inside 32- and 128-row pieces at tile 8 and 16
    "group change tile 8": dict(tile=8, k=64, n=64, sizes=[5, 0, 19, 3, 26,
                                                           1, 9]),
    "group change tile 16": dict(tile=16, k=64, n=17, sizes=[5, 0, 19, 3,
                                                             26, 1, 9]),
    # a tile of -1 next to a real one, and a pure-pad tail of 6 tiles
    "pure-pad tail": dict(tile=8, k=64, n=64, sizes=[9, 30, 4], grow=6,
                          kill_tile=1),
    "n = 1": dict(tile=32, k=64, n=1, sizes=[40, 0, 70], grow=2),
    "n = 8, k = 7": dict(tile=8, k=7, n=8, sizes=[12, 3, 20]),
    "k = 300": dict(tile=8, k=300, n=96, sizes=[6, 17, 2]),
    "k = 300, n = 16": dict(tile=16, k=300, n=16, sizes=[6, 17, 2]),
}


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_cpu_route_matches_pallas_at_split_edges(case, with_scale):
    c = K1_CASES[case]
    rng = np.random.default_rng(len(case) + 7 * with_scale)
    tile, k, n, sizes = c["tile"], c["k"], c["n"], np.array(c["sizes"])
    ps = L.pad_segments(_ptr(sizes), tile)
    if c.get("grow"):
        ps = L.pad_segments_rows(ps, ps.padded_rows + c["grow"] * tile)
    nx = 60
    gidx = L.compose_gather_rows(ps, rng.integers(0, nx, int(sizes.sum())))
    if "kill_tile" in c:
        t = c["kill_tile"]
        gidx[t * tile:(t + 1) * tile] = -1
    gidx[np.flatnonzero(gidx >= 0)[::5]] = -1
    x = rng.normal(size=(nx, k)).astype(np.float32)
    w = rng.normal(size=(len(sizes), k, n)).astype(np.float32)
    scale = (rng.normal(size=(ps.padded_rows, 1)).astype(np.float32)
             if with_scale else None)
    ref = RSK.segment_mm_gather_padded(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gidx),
        jnp.asarray(ps.tile_to_group),
        None if scale is None else jnp.asarray(scale), tile_rows=tile,
        tile_n=n, interpret=True)
    ours = SK.segment_mm_gather_padded(
        _t(x), _t(w), _t(gidx), _t(ps.tile_to_group),
        None if scale is None else _t(scale), tile=tile)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    assert np.all(ours.numpy()[gidx < 0] == 0.0)


K4_CASES = {
    "group change tile 8": dict(tile=8, kd=64, n=64, sizes=[5, 0, 19, 3,
                                                            26, 1, 9]),
    "pure-pad tail": dict(tile=8, kd=64, n=17, sizes=[9, 30, 4], grow=6),
    "n = 1": dict(tile=16, kd=64, n=1, sizes=[40, 0, 70]),
    "k = 300": dict(tile=8, kd=300, n=16, sizes=[6, 17, 2]),
    "transposed k = 1": dict(tile=8, kd=1, n=64, sizes=[12, 0, 30],
                             transpose=True),
    "transposed k = 8": dict(tile=8, kd=8, n=64, sizes=[12, 0, 30],
                             transpose=True),
    "transposed k = 64": dict(tile=16, kd=64, n=64, sizes=[12, 0, 30],
                              transpose=True),
    "transposed k = 64, n = 8": dict(tile=8, kd=64, n=8, sizes=[12, 30],
                                     transpose=True),
}


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_cpu_route_matches_pallas_at_split_edges(case, with_scale):
    c = K4_CASES[case]
    rng = np.random.default_rng(len(case) + 5 * with_scale)
    tile, kd, n, sizes = c["tile"], c["kd"], c["n"], np.array(c["sizes"])
    transpose = c.get("transpose", False)
    ps = L.pad_segments(_ptr(sizes), tile)
    if c.get("grow"):
        ps = L.pad_segments_rows(ps, ps.padded_rows + c["grow"] * tile)
    x_p = rng.normal(size=(ps.padded_rows, kd)).astype(np.float32)
    x_p[ps.row_map < 0] = 0.0
    w = rng.normal(size=(len(sizes), n, kd) if transpose
                   else (len(sizes), kd, n)).astype(np.float32)
    scale = (rng.normal(size=(ps.padded_rows, 1)).astype(np.float32)
             if with_scale else None)
    w_ref = np.swapaxes(w, 1, 2) if transpose else w
    ref = RSK.segment_mm_padded(
        jnp.asarray(x_p), jnp.asarray(w_ref), jnp.asarray(ps.tile_to_group),
        None if scale is None else jnp.asarray(scale), tile_rows=tile,
        tile_n=n, interpret=True)
    ours = SK.segment_mm_padded(
        _t(x_p), _t(w), _t(ps.tile_to_group),
        None if scale is None else _t(scale), tile=tile,
        transpose_w=transpose)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("tile_n", [8, 64, 96])
def test_cpu_route_ignores_tile_n(tile_n):
    """``tile_n`` (the tuner's column tile) is accepted and changes no
    output; a non-positive one is refused."""
    rng = np.random.default_rng(tile_n)
    ps = L.pad_segments(_ptr(np.array([7, 0, 20])), 8)
    gidx = _t(L.compose_gather_rows(ps, rng.integers(0, 9, 27)))
    t2g = _t(ps.tile_to_group)
    x = _t(rng.normal(size=(9, 64)).astype(np.float32))
    w = _t(rng.normal(size=(3, 64, 96)).astype(np.float32))
    x_p = _t(rng.normal(size=(ps.padded_rows, 64)).astype(np.float32))
    assert torch.equal(
        SK.segment_mm_gather_padded(x, w, gidx, t2g, tile=8, tile_n=tile_n),
        SK.segment_mm_gather_padded(x, w, gidx, t2g, tile=8))
    assert torch.equal(
        SK.segment_mm_padded(x_p, w, t2g, tile=8, tile_n=tile_n),
        SK.segment_mm_padded(x_p, w, t2g, tile=8))
    for fn, args in ((SK.segment_mm_gather_padded, (x, w, gidx, t2g)),
                     (SK.segment_mm_padded, (x_p, w, t2g))):
        with pytest.raises(ValueError, match="tile_n=0 must be positive"):
            fn(*args, tile=8, tile_n=0)
