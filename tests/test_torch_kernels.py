"""Kernels K1-K8 of the port (their plain versions, the CPU path) against
the reference's Pallas kernels run in interpret mode, on the same seeded
numpy inputs, with the edge cases the card check also drives: gather
index -1, groups and node blocks that own no tile, pow2 pad tiles, the
scale epilogue on and off (K7, K8: ``scale=None``), k = 1 and n = 1, d = 1,
a transposed W, and empty layouts. K6 and K8 (the materialized-gather
variants, ``fuse_gather=False``) also through the ops, against the
reference's ops with ``fuse_gather=False``.
The autograd Functions of the ops against ``jax.grad`` of the reference's
``custom_vjp`` ops (Pallas interpret), and ``gradcheck`` in fp64.

Tolerances: 1e-5 for kernels (the reference's own kernel-vs-oracle bound
for fp32, ``tests/test_kernels.py``), 1e-4 for gradients (its gradient
bound)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.kernels import layout as RL
from repro.kernels import ops as rops
from repro.kernels import ref as RR
from repro.kernels import segment_mm as RSK
from repro.kernels import traversal as RTK
from repro_torch.kernels import layout as L
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels import segment_mm as SK
from repro_torch.kernels import traversal as TK

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _segments(rng, n_groups, max_size, empty=(1, 3)):
    sizes = rng.integers(1, max_size, n_groups)
    sizes[list(empty)] = 0                      # groups that own no tile
    ptr = np.zeros(n_groups + 1, np.int64)
    np.cumsum(sizes, out=ptr[1:])
    return ptr, int(sizes.sum())


# ---------------------------------------------------------------------------
# K1: gather-fused segment GEMM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [64, 16, 1])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("grow", [False, True])
def test_k1_matches_pallas_interpret(n, with_scale, grow):
    rng = np.random.default_rng(n * 7 + with_scale * 3 + grow)
    k, tile, r, nx = 64, 8, 6, 40
    ptr, m = _segments(rng, r, 19)
    ps = L.pad_segments(ptr, tile)
    if grow:                                   # pow2 bucket pad tiles
        ps = L.pad_segments_rows(ps, L.pow2ceil(ps.padded_rows) * 2)
    gidx = L.compose_gather_rows(ps, rng.integers(0, nx, m))
    gidx[np.flatnonzero(gidx >= 0)[::5]] = -1  # real slots gathering -1
    x = rng.normal(size=(nx, k)).astype(np.float32)
    w = rng.normal(size=(r, k, n)).astype(np.float32)
    scale = (rng.normal(size=(ps.padded_rows, 1)).astype(np.float32)
             if with_scale else None)
    t2g = ps.tile_to_group
    ref = RSK.segment_mm_gather_padded(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gidx), jnp.asarray(t2g),
        None if scale is None else jnp.asarray(scale), tile_rows=tile,
        tile_n=min(n, 128), interpret=True)
    ours = SK.segment_mm_gather_padded(
        _t(x), _t(w), _t(gidx), _t(t2g),
        None if scale is None else _t(scale), tile=tile)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    assert np.all(ours.numpy()[gidx < 0] == 0.0)


def test_k1_cpu_path_never_counts_a_launch():
    before = ops.launch_counts()
    ps = L.pad_segments(np.array([0, 3, 8]), 4)
    lay = ops.padded_segments_dev(ps)
    x = torch.ones(5, 4, requires_grad=True)
    w = torch.ones(2, 4, 2, requires_grad=True)
    y = ops.segment_mm_gather(x, w, lay,
                              _t(L.compose_gather_rows(ps, np.arange(8) % 5)))
    y.sum().backward()                           # K4 and K5's plain versions
    assert x.grad is not None and w.grad is not None
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# K2 / K3: softmax stats and gather-fused softmax aggregation
# ---------------------------------------------------------------------------
def _blocked(rng, n_nodes=70, n_edges=260, tile=8, nb=8, grow=False):
    """Blocked CSR over random destinations; nodes 16..39 get no edge, so
    node blocks 2-4 own no tile."""
    pool = np.concatenate([np.arange(16), np.arange(40, n_nodes)])
    dst = rng.choice(pool, n_edges).astype(np.int32)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_nodes), out=ptr[1:])
    bc = L.block_csr(ptr, tile, nb)
    if grow:
        bc = L.pad_blocked_csr(bc, L.pow2ceil(bc.padded_edges) * 2)
    return dst, perm, bc


def _owned(bc):
    """Per node row: does its node block own at least one tile?"""
    t2b = bc.tile_to_block[: bc.num_tiles]
    owns = np.bincount(t2b, minlength=bc.num_node_blocks) > 0
    return np.repeat(owns, bc.node_block)


@pytest.mark.parametrize("grow", [False, True])
@pytest.mark.parametrize("d,compact", [(64, True), (16, False)])
def test_k2_k3_match_pallas_interpret(grow, d, compact):
    rng = np.random.default_rng(d + grow)
    n_nodes, nb = 70, 8
    dst, perm, bc = _blocked(rng, n_nodes=n_nodes, nb=nb, grow=grow)
    e = dst.shape[0]
    scores = rng.normal(size=e).astype(np.float32) * 3
    em = e // 3 if compact else e
    msg = rng.normal(size=(em, d)).astype(np.float32)
    rows = rng.integers(0, em, e).astype(np.int32) if compact else None
    bcd = ops.blocked_csr_dev(bc, perm)
    mmap = ops._msg_slot_map(bcd, None if rows is None else _t(rows))
    scores_p = ops._padded_scores(_t(scores), bcd)
    kw = dict(node_block=nb, num_node_blocks=bc.num_node_blocks)

    rmx, rden = RTK.seg_stats_padded(
        jnp.asarray(scores_p.numpy()), jnp.asarray(bcd.local_dst.numpy()),
        jnp.asarray(bcd.t2b.numpy()), interpret=True, **kw)
    mx, den = TK.seg_stats_padded(scores_p, bcd.local_dst, bcd.t2b,
                                  bcd.block_tile_ptr, **kw)
    owned = _owned(bc)
    mx, den = mx.numpy().reshape(-1), den.numpy().reshape(-1)
    np.testing.assert_array_equal(mx[owned], np.asarray(rmx).reshape(-1)[owned])
    np.testing.assert_allclose(den[owned], np.asarray(rden).reshape(-1)[owned],
                               rtol=1e-5)
    # blocks without a tile: the oracle's empty sum, and the -1e30 max the
    # TPU kernel gives every edgeless node of the blocks it visits
    _, ref_den = R.segment_softmax_stats_ref(_t(scores), _t(dst),
                                             bc.num_node_blocks * nb)
    assert np.all(den[~owned] == ref_den.numpy()[~owned])
    assert np.all(mx[~owned] == np.float32(TK.NEG_INF))

    rout = RTK.seg_softmax_agg_gather_padded(
        jnp.asarray(scores_p.numpy()), jnp.asarray(msg),
        jnp.asarray(mmap.numpy()), jnp.asarray(bcd.local_dst.numpy()),
        jnp.asarray(bcd.t2b.numpy()), rmx, rden, interpret=True, **kw)
    out = TK.seg_softmax_agg_gather_padded(
        scores_p, _t(msg), mmap, bcd.local_dst, bcd.t2b, bcd.block_tile_ptr,
        _t(mx.reshape(-1, nb)), _t(den.reshape(-1, nb)), **kw).numpy()
    np.testing.assert_allclose(out[owned], np.asarray(rout)[owned], **TOL)
    msg_e = msg if rows is None else msg[rows]
    ref_out = R.softmax_agg_ref(_t(scores), _t(msg_e), _t(dst),
                                bc.num_node_blocks * nb).numpy()
    np.testing.assert_array_equal(out[~owned], ref_out[~owned])
    np.testing.assert_allclose(out, ref_out, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# K7: gather-fused weighted aggregation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grow", [False, True])
@pytest.mark.parametrize("d,compact", [(64, True), (16, False), (1, True)])
@pytest.mark.parametrize("with_scale", [False, True])
def test_k7_matches_pallas_interpret(grow, d, compact, with_scale):
    rng = np.random.default_rng(100 + d + 2 * grow + with_scale)
    nb = 8
    dst, perm, bc = _blocked(rng, nb=nb, grow=grow)
    e = dst.shape[0]
    em = e // 3 if compact else e
    msg = rng.normal(size=(em, d)).astype(np.float32)
    rows = rng.integers(0, em, e).astype(np.int32) if compact else None
    bcd = ops.blocked_csr_dev(bc, perm)
    mmap = ops._msg_slot_map(bcd, None if rows is None
                             else _t(rows)).clone()
    mmap[torch.nonzero(mmap >= 0)[::7, 0]] = -1      # real slots with no row
    scale = rng.normal(size=e).astype(np.float32) if with_scale else None
    scale_p = ops._padded_scale(None if scale is None else _t(scale), bcd,
                                _t(msg))
    assert np.all(scale_p.numpy().reshape(-1)[bcd.edge_map.numpy() < 0] == 0)
    kw = dict(node_block=nb, num_node_blocks=bc.num_node_blocks)

    rout = RTK.seg_weighted_agg_gather_padded(
        jnp.asarray(scale_p.numpy()), jnp.asarray(msg),
        jnp.asarray(mmap.numpy()), jnp.asarray(bcd.local_dst.numpy()),
        jnp.asarray(bcd.t2b.numpy()), interpret=True, **kw)
    out = TK.seg_weighted_agg_gather_padded(
        scale_p, _t(msg), mmap, bcd.local_dst, bcd.t2b, bcd.block_tile_ptr,
        **kw).numpy()
    assert out.shape == (bc.num_node_blocks * nb, d)
    owned = _owned(bc)
    assert not owned.all()
    np.testing.assert_allclose(out[owned], np.asarray(rout)[owned], **TOL)
    assert np.all(out[~owned] == 0.0)          # blocks without a tile
    # the oracle over the slots that carry a message row
    ld = bcd.local_dst.numpy().reshape(-1)
    slot_node = np.repeat(bc.tile_to_block[:bc.num_tiles], bc.edge_tile) * nb
    keep = (ld < nb) & (mmap.numpy() >= 0)
    want = np.zeros_like(out, dtype=np.float64)
    np.add.at(want, (slot_node + ld)[keep],
              scale_p.numpy().reshape(-1)[keep, None].astype(np.float64)
              * msg[mmap.numpy()[keep]])
    np.testing.assert_allclose(out, want, **TOL)


# ---------------------------------------------------------------------------
# K6 / K8: the aggregations over messages padded into the slots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grow", [False, True])
@pytest.mark.parametrize("d", [64, 16, 1])
def test_k6_matches_pallas_interpret(grow, d):
    """K6 against the reference's ``seg_softmax_agg_padded`` (interpret),
    and equal to K3 reading the same rows through a slot map."""
    rng = np.random.default_rng(200 + d + grow)
    nb = 8
    dst, perm, bc = _blocked(rng, nb=nb, grow=grow)
    e = dst.shape[0]
    scores = rng.normal(size=e).astype(np.float32) * 3
    msg = rng.normal(size=(e, d)).astype(np.float32)
    bcd = ops.blocked_csr_dev(bc, perm)
    scores_p = ops._padded_scores(_t(scores), bcd)
    msg_p = ops.pad_rows(_t(msg), bcd.edge_map)
    assert msg_p.shape == (bcd.local_dst.numel(), d)
    kw = dict(node_block=nb, num_node_blocks=bc.num_node_blocks)
    mx, den = TK.seg_stats_padded(scores_p, bcd.local_dst, bcd.t2b,
                                  bcd.block_tile_ptr, **kw)
    rout = RTK.seg_softmax_agg_padded(
        jnp.asarray(scores_p.numpy()), jnp.asarray(msg_p.numpy()),
        jnp.asarray(bcd.local_dst.numpy()), jnp.asarray(bcd.t2b.numpy()),
        jnp.asarray(mx.numpy()), jnp.asarray(den.numpy()), interpret=True,
        **kw)
    out = TK.seg_softmax_agg_padded(scores_p, msg_p, bcd.local_dst, bcd.t2b,
                                    bcd.block_tile_ptr, mx, den, **kw)
    owned = _owned(bc)
    assert out.shape == (bc.num_node_blocks * nb, d) and not owned.all()
    np.testing.assert_allclose(out.numpy()[owned], np.asarray(rout)[owned],
                               **TOL)
    assert np.all(out.numpy()[~owned] == 0.0)  # blocks without a tile
    k3 = TK.seg_softmax_agg_gather_padded(
        scores_p, _t(msg), bcd.edge_map, bcd.local_dst, bcd.t2b,
        bcd.block_tile_ptr, mx, den, **kw)
    np.testing.assert_array_equal(out.numpy(), k3.numpy())


@pytest.mark.parametrize("grow", [False, True])
@pytest.mark.parametrize("d", [64, 16, 1])
@pytest.mark.parametrize("with_scale", [False, True])
def test_k8_matches_pallas_interpret(grow, d, with_scale):
    """K8 against the reference's ``seg_weighted_agg_padded`` (interpret),
    and equal to K7 reading the same rows through a slot map."""
    rng = np.random.default_rng(300 + d + 2 * grow + with_scale)
    nb = 8
    dst, perm, bc = _blocked(rng, nb=nb, grow=grow)
    e = dst.shape[0]
    msg = rng.normal(size=(e, d)).astype(np.float32)
    bcd = ops.blocked_csr_dev(bc, perm)
    scale = rng.normal(size=e).astype(np.float32) if with_scale else None
    scale_p = ops._padded_scale(None if scale is None else _t(scale), bcd,
                                _t(msg))
    msg_p = ops.pad_rows(_t(msg), bcd.edge_map)
    kw = dict(node_block=nb, num_node_blocks=bc.num_node_blocks)
    rout = RTK.seg_weighted_agg_padded(
        jnp.asarray(scale_p.numpy()), jnp.asarray(msg_p.numpy()),
        jnp.asarray(bcd.local_dst.numpy()), jnp.asarray(bcd.t2b.numpy()),
        interpret=True, **kw)
    out = TK.seg_weighted_agg_padded(scale_p, msg_p, bcd.local_dst, bcd.t2b,
                                     bcd.block_tile_ptr, **kw)
    owned = _owned(bc)
    np.testing.assert_allclose(out.numpy()[owned], np.asarray(rout)[owned],
                               **TOL)
    assert np.all(out.numpy()[~owned] == 0.0)
    k7 = TK.seg_weighted_agg_gather_padded(
        scale_p, _t(msg), bcd.edge_map, bcd.local_dst, bcd.t2b,
        bcd.block_tile_ptr, **kw)
    np.testing.assert_array_equal(out.numpy(), k7.numpy())


def test_k6_k8_pad_slots_add_nothing():
    """A pad slot (``local_dst == node_block``) adds nothing even where its
    padded message row is not zero, and a row count that is not the slot
    count is refused."""
    rng = np.random.default_rng(9)
    nb = 8
    dst, perm, bc = _blocked(rng, nb=nb, grow=True)
    bcd = ops.blocked_csr_dev(bc, perm)
    e, slots = dst.shape[0], bcd.local_dst.numel()
    msg_p = ops.pad_rows(_t(rng.normal(size=(e, 4)).astype(np.float32)),
                         bcd.edge_map)
    pad = (bcd.local_dst.reshape(-1) >= nb)
    assert pad.any()
    noisy = msg_p.clone()
    noisy[pad] = 1e6
    kw = dict(node_block=nb, num_node_blocks=bc.num_node_blocks)
    scale_p = ops._padded_scale(None, bcd, msg_p) + 1.0   # pads too
    args = (bcd.local_dst, bcd.t2b, bcd.block_tile_ptr)
    torch.testing.assert_close(
        TK.seg_weighted_agg_padded(scale_p, noisy, *args, **kw),
        TK.seg_weighted_agg_padded(scale_p, msg_p, *args, **kw))
    with pytest.raises(ValueError, match=f"rows for {slots} slots"):
        TK.seg_weighted_agg_padded(scale_p, msg_p[:-1], *args, **kw)
    with pytest.raises(ValueError, match=f"rows for {slots} slots"):
        TK.seg_softmax_agg_padded(scale_p, msg_p[:-1], *args, None, None,
                                  **kw)


@pytest.mark.parametrize("compact", [False, True])
def test_op_softmax_agg_unfused_matches_reference(compact):
    """``edge_softmax_agg(fuse_gather=False)`` (K2 + K6) equals the fused op
    and the reference op with ``fuse_gather=False`` (interpret), forward
    and gradients (the reference's ``test_kernels.py`` fused-vs-
    materialized cases)."""
    rng = np.random.default_rng(81 + compact)
    n_nodes, d = 13, 4
    dst, perm, ptr = _all_nodes_dst(rng, n_nodes, 47)
    e = dst.shape[0]
    e2u = rng.integers(0, 20, e).astype(np.int32) if compact else None
    scores = rng.normal(size=e).astype(np.float32)
    msg = rng.normal(size=(20 if compact else e, d)).astype(np.float32)
    cot = rng.normal(size=(n_nodes, d)).astype(np.float32)
    bc = ops.blocked_csr_dev(L.block_csr(ptr, 8, 8), perm, e2u)
    rbc = rops.blocked_csr_dev(RL.block_csr(ptr, 8, 8), perm, e2u)
    rows = None if e2u is None else _t(e2u)

    def ours(s, m, fuse=False):
        out = ops.edge_softmax_agg(s, m, _t(dst), n_nodes, bc=bc,
                                   msg_rows=rows, fuse_gather=fuse)
        return torch.sum(out * _t(cot))

    def ref(s, m):
        out = rops.edge_softmax_agg(
            s, m, jnp.asarray(dst), n_nodes, bc=rbc,
            backend="pallas_interpret", fuse_gather=False,
            msg_rows=None if e2u is None else jnp.asarray(e2u))
        return jnp.sum(out * cot)

    fwd = ops.edge_softmax_agg(_t(scores), _t(msg), _t(dst), n_nodes, bc=bc,
                               msg_rows=rows, fuse_gather=False)
    fused = ops.edge_softmax_agg(_t(scores), _t(msg), _t(dst), n_nodes,
                                 bc=bc, msg_rows=rows)
    rfwd = rops.edge_softmax_agg(
        jnp.asarray(scores), jnp.asarray(msg), jnp.asarray(dst), n_nodes,
        bc=rbc, backend="pallas_interpret", fuse_gather=False,
        msg_rows=None if e2u is None else jnp.asarray(e2u))
    np.testing.assert_allclose(fwd.numpy(), fused.numpy(), **TOL)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(rfwd), **TOL)
    got = _torch_grads(ours, scores, msg)
    want = jax.grad(ref, argnums=(0, 1))(jnp.asarray(scores),
                                         jnp.asarray(msg))
    fused_g = _torch_grads(lambda s, m: ours(s, m, True), scores, msg)
    for a, b, c in zip(got, want, fused_g):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL)
        np.testing.assert_allclose(a, c, **GRAD_TOL)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("with_scale", [False, True])
def test_op_weighted_agg_unfused_matches_reference(compact, with_scale):
    """``weighted_agg(fuse_gather=False)`` (K8) against the reference op
    with ``fuse_gather=False`` (interpret), forward and gradients."""
    rng = np.random.default_rng(91 + 2 * compact + with_scale)
    n_nodes, d = 9, 5
    dst, perm, ptr = _all_nodes_dst(rng, n_nodes, 41)
    e = dst.shape[0]
    e2u = rng.integers(0, 17, e).astype(np.int32) if compact else None
    scale = rng.normal(size=e).astype(np.float32)
    msg = rng.normal(size=(17 if compact else e, d)).astype(np.float32)
    bc = ops.blocked_csr_dev(L.block_csr(ptr, 8, 8), perm, e2u)
    rbc = rops.blocked_csr_dev(RL.block_csr(ptr, 8, 8), perm, e2u)
    rows = None if e2u is None else _t(e2u)
    rrows = None if e2u is None else jnp.asarray(e2u)

    def ours(*a):
        s, m = a if with_scale else (None, a[0])
        return torch.sum(torch.cos(ops.weighted_agg(
            s, m, _t(dst), n_nodes, bc=bc, msg_rows=rows,
            fuse_gather=False)))

    def ref(*a):
        s, m = a if with_scale else (None, a[0])
        return jnp.sum(jnp.cos(rops.weighted_agg(
            s, m, jnp.asarray(dst), n_nodes, bc=rbc,
            backend="pallas_interpret", msg_rows=rrows, fuse_gather=False)))

    inputs = (scale, msg) if with_scale else (msg,)
    np.testing.assert_allclose(
        ops.weighted_agg(_t(scale) if with_scale else None, _t(msg), _t(dst),
                         n_nodes, bc=bc, msg_rows=rows,
                         fuse_gather=False).numpy(),
        np.asarray(rops.weighted_agg(
            jnp.asarray(scale) if with_scale else None, jnp.asarray(msg),
            jnp.asarray(dst), n_nodes, bc=rbc, backend="pallas_interpret",
            msg_rows=rrows, fuse_gather=False)), **TOL)
    got = _torch_grads(ours, *inputs)
    want = jax.grad(ref, argnums=tuple(range(len(inputs))))(
        *(jnp.asarray(a) for a in inputs))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL)


def test_unfused_ops_gradcheck_fp64():
    rng = np.random.default_rng(52)
    n_nodes = 20
    dst = np.concatenate([np.arange(n_nodes - 4),
                          rng.integers(0, n_nodes, 30)]).astype(np.int32)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    dptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_nodes), out=dptr[1:])
    e2u = rng.integers(0, 11, dst.shape[0]).astype(np.int32)
    bc = ops.blocked_csr_dev(L.block_csr(dptr, 4, 4), perm, e2u)
    scores = torch.from_numpy(rng.normal(size=dst.shape[0])).requires_grad_()
    msg = torch.from_numpy(rng.normal(size=(11, 3))).requires_grad_()
    for fn in (ops.edge_softmax_agg, ops.weighted_agg):
        assert torch.autograd.gradcheck(
            lambda sc, mg: fn(sc, mg, _t(dst), n_nodes, bc=bc,
                              msg_rows=_t(e2u), fuse_gather=False),
            (scores, msg))


def _all_nodes_dst(rng, n_nodes, n_extra):
    """Destinations where every node receives an edge, so every node block
    owns a tile (the Pallas kernels leave blocks without one unwritten)."""
    dst = np.concatenate([np.arange(n_nodes),
                          rng.integers(0, n_nodes, n_extra)]).astype(np.int32)
    dst = rng.permutation(dst)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_nodes), out=ptr[1:])
    return dst, perm, ptr


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("with_scale", [False, True])
def test_op_weighted_agg_matches_reference(compact, with_scale):
    rng = np.random.default_rng(51 + 2 * compact + with_scale)
    n_nodes, d = 40, 5
    dst, perm, ptr = _all_nodes_dst(rng, n_nodes, 160)
    e = dst.shape[0]
    e2u = rng.integers(0, 17, e).astype(np.int32) if compact else None
    msg = rng.normal(size=(17 if compact else e, d)).astype(np.float32)
    scale = rng.normal(size=e).astype(np.float32) if with_scale else None
    bc = ops.blocked_csr_dev(L.block_csr(ptr, 8, 8), perm, e2u)
    rbc = rops.blocked_csr_dev(RL.block_csr(ptr, 8, 8), perm, e2u)
    ours = ops.weighted_agg(
        None if scale is None else _t(scale), _t(msg), _t(dst), n_nodes,
        bc=bc, msg_rows=None if e2u is None else _t(e2u))
    ref = rops.weighted_agg(
        None if scale is None else jnp.asarray(scale), jnp.asarray(msg),
        jnp.asarray(dst), n_nodes, bc=rbc, backend="pallas_interpret",
        msg_rows=None if e2u is None else jnp.asarray(e2u))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    msg_e = msg if e2u is None else msg[e2u]
    oracle = RR.weighted_agg_ref(
        None if scale is None else jnp.asarray(scale), jnp.asarray(msg_e),
        jnp.asarray(dst), n_nodes)
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle), **TOL)
    # without the layout: the CPU oracle itself
    plain = ops.weighted_agg(None if scale is None else _t(scale), _t(msg),
                             _t(dst), n_nodes,
                             msg_rows=None if e2u is None else _t(e2u))
    np.testing.assert_allclose(plain.numpy(), np.asarray(oracle), **TOL)


# ---------------------------------------------------------------------------
# the ops over the kernels, against the reference's ops (Pallas interpret)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_scale", [False, True])
def test_op_segment_mm_gather_matches_reference(with_scale):
    rng = np.random.default_rng(11 + with_scale)
    ptr, m = _segments(rng, 5, 17)
    nx, k, n = 30, 16, 24
    src = rng.integers(0, nx, m).astype(np.int32)
    x = rng.normal(size=(nx, k)).astype(np.float32)
    w = rng.normal(size=(5, k, n)).astype(np.float32)
    scale = rng.normal(size=m).astype(np.float32) if with_scale else None
    ps = L.pad_segments(ptr, 8)
    gmap = L.compose_gather_rows(ps, src)
    ours = ops.segment_mm_gather(
        _t(x), _t(w), ops.padded_segments_dev(ps), _t(gmap),
        row_scale=None if scale is None else _t(scale))
    ref = rops.segment_mm_gather(
        jnp.asarray(x), jnp.asarray(w),
        rops.padded_segments_dev(RL.pad_segments(ptr, 8)), jnp.asarray(gmap),
        row_scale=None if scale is None else jnp.asarray(scale),
        backend="pallas_interpret")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    seg_ids = np.repeat(np.arange(5), np.diff(ptr))
    oracle = R.gather_mm_ref(_t(x), _t(w), _t(src), _t(seg_ids),
                             None if scale is None else _t(scale))
    np.testing.assert_allclose(ours.numpy(), oracle.numpy(), **TOL)


def test_op_edge_softmax_agg_compact_matches_reference():
    rng = np.random.default_rng(5)
    n_nodes, e, u, d = 50, 200, 60, 16
    dst = rng.integers(0, n_nodes - 10, e).astype(np.int32)
    e2u = rng.integers(0, u, e).astype(np.int32)
    scores = rng.normal(size=e).astype(np.float32)
    msg = rng.normal(size=(u, d)).astype(np.float32)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_nodes), out=ptr[1:])
    bc = L.block_csr(ptr, 8, 8)
    ours = ops.edge_softmax_agg(
        _t(scores), _t(msg), _t(dst), n_nodes,
        bc=ops.blocked_csr_dev(bc, perm, e2u), msg_rows=_t(e2u))
    ref = rops.edge_softmax_agg(
        jnp.asarray(scores), jnp.asarray(msg), jnp.asarray(dst), n_nodes,
        bc=rops.blocked_csr_dev(RL.block_csr(ptr, 8, 8), perm, e2u),
        backend="pallas_interpret", msg_rows=jnp.asarray(e2u))
    # the Pallas kernel never writes node blocks that own no tile (nodes
    # 40-49 here), so only the others are compared with it
    owned = _owned(bc)[:n_nodes]
    assert not owned.all()
    np.testing.assert_allclose(ours.numpy()[owned], np.asarray(ref)[owned],
                               **TOL)
    oracle = RR.softmax_agg_ref(jnp.asarray(scores), jnp.asarray(msg[e2u]),
                                jnp.asarray(dst), n_nodes)
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle), **TOL)
    att = ops.edge_softmax(_t(scores), _t(dst), n_nodes)
    np.testing.assert_allclose(
        att.numpy(), np.asarray(RR.edge_softmax_ref(
            jnp.asarray(scores), jnp.asarray(dst), n_nodes)), **TOL)


def test_ops_empty_layouts_return_without_a_kernel():
    ps = L.pad_segments(np.zeros(4, np.int64), 8)       # no rows at all
    y = ops.segment_mm_gather(torch.ones(3, 4), torch.ones(3, 4, 5),
                              ops.padded_segments_dev(ps),
                              _t(L.compose_gather_rows(ps, np.zeros(0))))
    assert y.shape == (0, 5)
    bc = ops.blocked_csr_dev(L.block_csr(np.zeros(5, np.int64), 8, 8),
                             np.zeros(0, np.int32))
    out = ops.edge_softmax_agg(torch.zeros(0), torch.ones(0, 3),
                               torch.zeros(0, dtype=torch.int32), 4, bc=bc)
    assert out.shape == (4, 3) and not out.any()
    out = ops.weighted_agg(None, torch.ones(0, 3),
                           torch.zeros(0, dtype=torch.int32), 4, bc=bc)
    assert out.shape == (4, 3) and not out.any()
    for fn in (ops.edge_softmax_agg, ops.weighted_agg):
        out = fn(torch.zeros(0), torch.ones(0, 3),
                 torch.zeros(0, dtype=torch.int32), 4, bc=bc,
                 fuse_gather=False)
        assert out.shape == (4, 3) and not out.any()
    assert bc.local_dst.shape == (0, 8)
    assert bc.block_tile_ptr.tolist() == [0, 0]


def test_block_tile_ptr_of_bucketed_csr():
    bc = L.pad_blocked_csr(
        L.block_csr(np.array([0, 3, 3, 3, 20]), 4, 2), 32)
    ptr = ops.block_tile_ptr(bc.tile_to_block, bc.num_tiles,
                             bc.num_node_blocks)
    # block 0: one tile; block 1: its 5 tiles plus the 2 bucket pad tiles
    assert ptr.tolist() == [0, 1, 8]


# ---------------------------------------------------------------------------
# K4: segment GEMM over pre-padded rows; K5: per-group outer products (dW)
# ---------------------------------------------------------------------------
def _padded_rows(rng, ps, k):
    """Rows in the padded layout: pad slots (row_map -1) hold zeros, as
    ``ops.pad_rows`` gives them."""
    x = rng.normal(size=(ps.padded_rows, k)).astype(np.float32)
    x[ps.row_map < 0] = 0.0
    return x


@pytest.mark.parametrize("kd,n,transpose", [(64, 64, False), (64, 1, False),
                                            (1, 64, True), (16, 24, True)])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("grow", [False, True])
def test_k4_matches_pallas_interpret(kd, n, transpose, with_scale, grow):
    """k = 1 with W transposed is the dX of the n = 1 attention GEMMs."""
    rng = np.random.default_rng(kd + n + 2 * with_scale + grow)
    tile, r = 8, 6
    ptr, _ = _segments(rng, r, 19)
    ps = L.pad_segments(ptr, tile)
    if grow:
        ps = L.pad_segments_rows(ps, L.pow2ceil(ps.padded_rows) * 2)
    x_p = _padded_rows(rng, ps, kd)
    w = rng.normal(size=(r, n, kd) if transpose else (r, kd, n)
                   ).astype(np.float32)
    scale = (rng.normal(size=(ps.padded_rows, 1)).astype(np.float32)
             if with_scale else None)
    w_ref = np.swapaxes(w, 1, 2) if transpose else w
    ref = RSK.segment_mm_padded(
        jnp.asarray(x_p), jnp.asarray(w_ref), jnp.asarray(ps.tile_to_group),
        None if scale is None else jnp.asarray(scale), tile_rows=tile,
        tile_n=min(n, 128), interpret=True)
    ours = SK.segment_mm_padded(
        _t(x_p), _t(w), _t(ps.tile_to_group),
        None if scale is None else _t(scale), tile=tile,
        transpose_w=transpose)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("k,n", [(64, 64), (64, 1), (1, 64), (16, 24)])
@pytest.mark.parametrize("grow", [False, True])
def test_k5_matches_pallas_interpret(k, n, grow):
    rng = np.random.default_rng(3 * k + n + grow)
    tile, r = 8, 6
    ptr, _ = _segments(rng, r, 40)
    ps = L.pad_segments(ptr, tile)
    if grow:                                   # pure-pad tiles, last group
        ps = L.pad_segments_rows(ps, L.pow2ceil(ps.padded_rows) * 2)
    x_p = _padded_rows(rng, ps, k)
    dy_p = rng.normal(size=(ps.padded_rows, n)).astype(np.float32)
    lay = ops.padded_segments_dev(ps)
    ref = np.asarray(RSK.segment_outer_padded(
        jnp.asarray(x_p), jnp.asarray(dy_p), jnp.asarray(ps.tile_to_group),
        num_groups=r, tile_rows=tile, interpret=True))
    ours = SK.segment_outer_padded(
        _t(x_p), _t(dy_p), lay.group_tile_ptr, lay.group_chunk_ptr,
        num_groups=r, num_chunks=lay.num_chunks, tile=tile,
        chunk_tiles=lay.chunk_tiles).numpy()
    owns = np.diff(lay.group_tile_ptr.numpy()) > 0
    assert not owns.all()                      # groups 1 and 3 are empty
    # the Pallas kernel never visits a group without tiles; K5 zeroes it
    np.testing.assert_allclose(ours[owns], ref[owns], **TOL)
    assert np.all(ours[~owns] == 0.0)


def test_k5_chunks_cover_only_real_tiles():
    """Each group's run of real tiles, cut into chunks of at most the
    layout's ``chunk_tiles``; bucketing's pure-pad tiles are in no run."""
    padded_tiles = 4 * SK.K5_TARGET_CHUNKS             # tile 8
    c = SK.outer_chunk_tiles(padded_tiles)
    sizes = np.array([0, 3, c * 8 * 2 + 1, 0, 8 * c])
    ps = L.pad_segments(np.concatenate([[0], np.cumsum(sizes)]), 8)
    ps = L.pad_segments_rows(ps, padded_tiles * 8)
    lay = ops.padded_segments_dev(ps)
    assert lay.chunk_tiles == c > 1
    assert lay.group_tile_ptr.tolist() == [0, 0, 1, 2 * c + 2, 2 * c + 2,
                                           3 * c + 2]
    assert lay.group_chunk_ptr.tolist() == [0, 0, 1, 4, 4, 5]
    # the launch width is the static bound, past the 5 chunks with work
    assert lay.num_chunks == padded_tiles // c + 5 > 5
    assert ps.padded_rows // 8 > 3 * c + 2     # pad tiles outside the runs


@pytest.mark.parametrize("num_tiles", [0, 1, 7, 1000, 2560, 2561, 4096,
                                       15497, 22447, 10**6])
def test_k5_chunk_tiles_fit_the_padded_tile_count(num_tiles):
    """K5's chunk size depends on the layout's padded tile count alone (a
    static shape): between its floor and its cap (1 <= floor), never
    decreasing with the count, about K5_TARGET_CHUNKS chunks between them,
    and the host and device builders agree at the same capacity whatever
    the real rows."""
    ct = SK.outer_chunk_tiles(num_tiles)
    assert 1 <= SK.K5_MIN_CHUNK_TILES <= ct <= SK.K5_MAX_CHUNK_TILES
    assert ct >= SK.outer_chunk_tiles(max(0, num_tiles - 1))
    if ct < SK.K5_MAX_CHUNK_TILES:
        assert -(-num_tiles // ct) <= SK.K5_TARGET_CHUNKS
    if ct > SK.K5_MIN_CHUNK_TILES:
        assert -(-num_tiles // (ct - 1)) > SK.K5_TARGET_CHUNKS
    if 0 < num_tiles <= 4096:
        rng = np.random.default_rng(num_tiles)
        tile = 8
        for real in (0, num_tiles * tile // 3):
            cuts = np.sort(rng.integers(0, real + 1, 5))
            ptr = np.concatenate([[0], cuts, [real]]).astype(np.int32)
            cap = max(num_tiles * tile, real + 6 * tile)
            cap += -cap % tile
            host = ops.padded_segments_dev(
                L.pad_segments_rows(L.pad_segments(ptr, tile), cap))
            dev = ops.device_padded_segments(
                _t(ptr), _t(np.repeat(np.arange(6, dtype=np.int32),
                                      np.diff(ptr))), tile, cap)
            assert host.chunk_tiles == dev.chunk_tiles == \
                SK.outer_chunk_tiles(cap // tile)
            assert dev.group_chunk_ptr.tolist() == \
                host.group_chunk_ptr.tolist()


@pytest.mark.parametrize("seed", range(6))
def test_k5_static_chunk_count_covers_the_exact_count(seed):
    """The device builder's static chunk count is at least the exact count
    ``group_chunk_ptr[R]`` at every size: sparse and dense groups, empty
    groups, capacities from tight to 64x."""
    rng = np.random.default_rng(100 + seed)
    tile = [8, 32][seed % 2]
    r = int(rng.integers(1, 130))
    for _ in range(20):
        sizes = rng.integers(0, int(rng.choice([2, 40, 3000])), r)
        sizes[rng.random(r) < 0.3] = 0
        ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
        need = int(sizes.sum()) + r * tile
        cap = need * int(rng.choice([1, 2, 64]))
        cap += -cap % tile
        dev = ops.device_padded_segments(
            _t(ptr), _t(np.repeat(np.arange(r, dtype=np.int32), sizes)),
            tile, cap)
        exact = int(dev.group_chunk_ptr[-1])
        assert dev.num_chunks >= exact
        ct = dev.chunk_tiles
        assert exact == int(np.sum(-(-(-(-sizes // tile)) // ct)))


def _chunked_outer(x_p, dy_p, gtp, gcp, ct, tile, r):
    """The kernel's arithmetic in numpy: each chunk's X_t^T dY_t summed in
    fp64 over its rows, a group's chunk partials added in chunk order."""
    k, n = x_p.shape[1], dy_p.shape[1]
    dw = np.zeros((r, k, n), np.float64)
    for g in range(r):
        parts = []
        for c in range(gcp[g], gcp[g + 1]):
            t0 = gtp[g] + (c - gcp[g]) * ct
            t1 = min(t0 + ct, gtp[g + 1])
            rows = slice(t0 * tile, t1 * tile)
            parts.append(x_p[rows].astype(np.float64).T
                         @ dy_p[rows].astype(np.float64))
        for p in parts:
            dw[g] += p
    return dw.astype(np.float32)


@pytest.mark.parametrize("ct", [1, 2, 3, 16, 64])
def test_k5_chunked_sum_matches_plain_and_pallas(ct):
    """K5's split (chunks of ``ct`` tiles, fp64 partials added in chunk
    order) changes only the fp64 summation order: the plain version, which
    ignores the split, agrees bit for bit at every ``ct``, and both agree
    with the chunked sum at K5's bound (1e-6) and with the Pallas kernel
    (fp32 sums) at the kernels' bound (1e-5)."""
    rng = np.random.default_rng(ct)
    tile, r = 8, 6
    ptr, _ = _segments(rng, r, 90)
    ps = L.pad_segments_rows(L.pad_segments(ptr, tile),
                             L.pow2ceil(L.pad_segments(ptr, tile)
                                        .padded_rows) * 2)
    x_p = _padded_rows(rng, ps, 24)
    dy_p = rng.normal(size=(ps.padded_rows, 40)).astype(np.float32)
    gtp = SK.outer_tile_ptr(ps.seg_sizes, tile)
    gcp = SK.outer_chunk_ptr(gtp, ct)
    kw = dict(num_groups=r, num_chunks=int(gcp[-1]), tile=tile,
              chunk_tiles=ct)
    ours = SK.segment_outer_padded(_t(x_p), _t(dy_p), _t(gtp), _t(gcp),
                                   **kw).numpy()
    base = SK.segment_outer_padded_plain(_t(x_p), _t(dy_p), _t(gtp),
                                         num_groups=r, tile=tile).numpy()
    np.testing.assert_array_equal(ours, base)
    np.testing.assert_allclose(
        ours, _chunked_outer(x_p, dy_p, gtp, gcp, ct, tile, r),
        rtol=1e-6, atol=1e-6)
    ref = np.asarray(RSK.segment_outer_padded(
        jnp.asarray(x_p), jnp.asarray(dy_p), jnp.asarray(ps.tile_to_group),
        num_groups=r, tile_rows=tile, interpret=True))
    owns = np.diff(gtp) > 0
    np.testing.assert_allclose(ours[owns], ref[owns], **TOL)
    assert np.all(ours[~owns] == 0.0)


@pytest.mark.parametrize("gather", [False, True])
def test_gemm_backward_dw_on_device_layouts(gather):
    """dW through the ops on a layout built as device sampling builds it
    (static chunk bound, pure-pad tiles, groups without rows): K5's zeros
    for the empty groups stand without a mask, and the gradient equals the
    masked one of the host layout and the reference's ``jax.grad``."""
    rng = np.random.default_rng(51 + gather)
    r, tile, k, n = 6, 8, 16, 12
    ptr, m = _segments(rng, r, 30)
    cap = L.pow2ceil(L.pad_segments(ptr, tile).padded_rows) * 2
    group = np.repeat(np.arange(r, dtype=np.int32), np.diff(ptr))
    dev = ops.device_padded_segments(_t(ptr.astype(np.int32)), _t(group),
                                     tile, cap)
    ps = L.pad_segments_rows(L.pad_segments(ptr, tile), cap)
    host = ops.padded_segments_dev(ps)
    assert dev.num_chunks > int(dev.group_chunk_ptr[-1])
    nx = 20
    x = rng.normal(size=(nx if gather else m, k)).astype(np.float32)
    w = rng.normal(size=(r, k, n)).astype(np.float32)
    src = rng.integers(0, nx, m)

    def ours(lay):
        def f(x, w):
            if gather:
                gidx = _t(L.compose_gather_rows(ps, src))
                y = ops.segment_mm_gather(x, w, lay, gidx)
            else:
                y = ops.segment_mm(x, w, lay)
            return torch.sum(torch.sin(y))
        return _torch_grads(f, x, w)

    dx, dw = ours(dev)
    dx_h, dw_h = ours(host)
    np.testing.assert_array_equal(dw, dw_h)
    np.testing.assert_array_equal(dx, dx_h)
    empty = np.diff(ptr) == 0
    assert empty.any() and np.all(dw[empty] == 0.0)
    rlay = rops.padded_segments_dev(ps)

    def ref(x, w):
        if gather:
            y = rops.segment_mm_gather(
                x, w, rlay, jnp.asarray(L.compose_gather_rows(ps, src)),
                backend="pallas_interpret")
        else:
            y = rops.segment_mm(x, w, rlay, backend="pallas_interpret")
        return jnp.sum(jnp.sin(y))

    want = jax.grad(ref, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(dx, np.asarray(want[0]), **GRAD_TOL)
    np.testing.assert_allclose(dw, np.asarray(want[1]), **GRAD_TOL)


# the numbers K5's design rests on: an fp32 x fp32 product is exact in fp64
# (24 + 24 significant bits <= 53, exponents within fp64's range), so the
# fp64 tensor cores' products equal the plain version's, and only the fp64
# summation order differs
FP32_RANGES = {
    "normal": (1e-3, 1e3),
    "large": (1e30, np.finfo(np.float32).max),
    "tiny normal": (np.finfo(np.float32).tiny, 1e-30),
    "subnormal": (np.float32(1.4e-45), np.finfo(np.float32).tiny),
}


@pytest.mark.parametrize("a_range,b_range", [
    ("normal", "normal"), ("large", "large"), ("large", "subnormal"),
    ("subnormal", "subnormal"), ("tiny normal", "subnormal"),
    ("normal", "large")])
def test_fp32_products_are_exact_in_fp64(a_range, b_range):
    from fractions import Fraction

    rng = np.random.default_rng(len(a_range) * 7 + len(b_range))

    def draw(name, size):
        lo, hi = (np.log2(float(v)) for v in FP32_RANGES[name])
        mag = np.exp2(rng.uniform(lo, hi, size)).astype(np.float32)
        sign = rng.choice(np.array([-1, 1], np.float32), size)
        return (mag * sign).astype(np.float32)

    a, b = draw(a_range, 400), draw(b_range, 400)
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    prod = a.astype(np.float64) * b.astype(np.float64)
    for x, y, p in zip(a.tolist(), b.tolist(), prod.tolist()):
        assert Fraction(p) == Fraction(x) * Fraction(y)


@pytest.mark.parametrize("n", [32, 4096, 40000])
def test_fp64_sums_of_fp32_products_round_within_one_ulp(n):
    """The same fp32 x fp32 products summed in fp64 in different orders
    (sequential, chunked, reversed, shuffled: the kernel's split against the
    plain version's) round to fp32 values at most one fp32 ulp apart."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.normal(size=(n, 8)).astype(np.float32)
    terms = x.astype(np.float64) * y.astype(np.float64)
    sums = [terms.sum(axis=0)]
    acc = np.zeros(8)
    for t in terms:
        acc = acc + t
    sums.append(acc)
    sums.append(sum(c.sum(axis=0) for c in np.array_split(terms, 7)))
    sums.append(terms[::-1].cumsum(axis=0)[-1])
    sums.append(terms[rng.permutation(n)].cumsum(axis=0)[-1])
    f32 = np.stack([s.astype(np.float32) for s in sums])
    ulp = np.spacing(np.abs(f32).max(axis=0))
    assert np.all(f32.max(axis=0) - f32.min(axis=0) <= ulp)


@pytest.mark.parametrize("grow", [1, 4])
def test_k5_static_chunk_bound_of_the_device_layout(grow):
    """Both builders give K5's layout a static chunk count above
    ``group_chunk_ptr[R]`` (``ops.static_chunk_count``): K5 on it equals
    K5 launched at the exact count, and the reference kernel on every
    group that owns tiles."""
    rng = np.random.default_rng(11 + grow)
    tile, r = 8, 6
    ptr, m = _segments(rng, r, 40)
    cap = (m + r * tile) * grow
    cap += -cap % tile
    dev = ops.device_padded_segments(
        _t(ptr.astype(np.int32)),
        _t(np.repeat(np.arange(r, dtype=np.int32), np.diff(ptr))), tile, cap)
    ps = L.pad_segments_rows(L.pad_segments(ptr, tile), cap)
    host = ops.padded_segments_dev(ps)
    exact_chunks = int(host.group_chunk_ptr[-1])
    assert dev.num_chunks == host.num_chunks > exact_chunks
    x_p = _padded_rows(rng, ps, 16)
    dy_p = rng.normal(size=(cap, 24)).astype(np.float32)
    ours = SK.segment_outer_padded(
        _t(x_p), _t(dy_p), dev.group_tile_ptr, dev.group_chunk_ptr,
        num_groups=r, num_chunks=dev.num_chunks, tile=tile,
        chunk_tiles=dev.chunk_tiles).numpy()
    exact = SK.segment_outer_padded(
        _t(x_p), _t(dy_p), host.group_tile_ptr, host.group_chunk_ptr,
        num_groups=r, num_chunks=exact_chunks, tile=tile,
        chunk_tiles=host.chunk_tiles).numpy()
    np.testing.assert_array_equal(ours, exact)
    ref = np.asarray(RSK.segment_outer_padded(
        jnp.asarray(x_p), jnp.asarray(dy_p), jnp.asarray(ps.tile_to_group),
        num_groups=r, tile_rows=tile, interpret=True))
    owns = np.diff(host.group_tile_ptr.numpy()) > 0
    np.testing.assert_allclose(ours[owns], ref[owns], **TOL)


# ---------------------------------------------------------------------------
# gradients of the ops' autograd Functions against jax.grad of the
# reference's custom_vjp ops (Pallas interpret)
# ---------------------------------------------------------------------------
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _torch_grads(fn, *arrays):
    ts = [_t(a).requires_grad_(True) for a in arrays]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("n", [24, 1])
def test_segment_mm_gather_grads_match_reference(n):
    rng = np.random.default_rng(21 + n)
    ptr, m = _segments(rng, 5, 17)
    nx, k = 30, 16
    src = rng.integers(0, nx, m).astype(np.int32)
    x = rng.normal(size=(nx, k)).astype(np.float32)
    w = rng.normal(size=(5, k, n)).astype(np.float32)
    scale = rng.normal(size=m).astype(np.float32)
    ps = L.pad_segments(ptr, 8)
    gmap = L.compose_gather_rows(ps, src)
    lay, rlay = ops.padded_segments_dev(ps), rops.padded_segments_dev(
        RL.pad_segments(ptr, 8))

    def ours(x, w, s):
        return torch.sum(torch.sin(ops.segment_mm_gather(
            x, w, lay, _t(gmap), row_scale=s)))

    def ref(x, w, s):
        return jnp.sum(jnp.sin(rops.segment_mm_gather(
            x, w, rlay, jnp.asarray(gmap), row_scale=s,
            backend="pallas_interpret")))

    got = _torch_grads(ours, x, w, scale)
    want = jax.grad(ref, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(scale))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL)


def test_segment_mm_grads_match_reference():
    rng = np.random.default_rng(31)
    ptr, m = _segments(rng, 5, 13)
    x = rng.normal(size=(m, 16)).astype(np.float32)
    w = rng.normal(size=(5, 16, 24)).astype(np.float32)
    scale = rng.normal(size=m).astype(np.float32)
    ps = L.pad_segments(ptr, 8)
    ps = L.pad_segments_rows(ps, L.pow2ceil(ps.padded_rows) * 2)
    lay = ops.padded_segments_dev(ps)
    rlay = rops.padded_segments_dev(ps)

    def ours(x, w, s):
        return torch.sum(torch.sin(ops.segment_mm(x, w, lay, row_scale=s)))

    def ref(x, w, s):
        return jnp.sum(jnp.sin(rops.segment_mm(
            x, w, rlay, row_scale=s, backend="pallas_interpret")))

    got = _torch_grads(ours, x, w, scale)
    want = jax.grad(ref, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(scale))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("compact", [False, True])
def test_edge_softmax_agg_grads_match_reference(compact):
    rng = np.random.default_rng(41 + compact)
    n_nodes, d = 48, 16
    # every node receives an edge, so every node block owns a tile (the
    # Pallas kernel leaves blocks without one unwritten)
    dst = np.concatenate([np.arange(n_nodes),
                          rng.integers(0, n_nodes, 150)]).astype(np.int32)
    e = dst.shape[0]
    scores = (rng.normal(size=e) * 2).astype(np.float32)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_nodes), out=ptr[1:])
    e2u = rng.integers(0, 60, e).astype(np.int32) if compact else None
    msg = rng.normal(size=(60 if compact else e, d)).astype(np.float32)
    cot = rng.normal(size=(n_nodes, d)).astype(np.float32)
    bc = ops.blocked_csr_dev(L.block_csr(ptr, 8, 8), perm, e2u)
    rbc = rops.blocked_csr_dev(RL.block_csr(ptr, 8, 8), perm, e2u)

    def ours(s, m):
        out = ops.edge_softmax_agg(
            s, m, _t(dst), n_nodes, bc=bc,
            msg_rows=None if e2u is None else _t(e2u))
        return torch.sum(out * _t(cot))

    def ref(s, m):
        out = rops.edge_softmax_agg(
            s, m, jnp.asarray(dst), n_nodes, bc=rbc,
            backend="pallas_interpret",
            msg_rows=None if e2u is None else jnp.asarray(e2u))
        return jnp.sum(out * cot)

    got = _torch_grads(ours, scores, msg)
    want = jax.grad(ref, argnums=(0, 1))(jnp.asarray(scores),
                                         jnp.asarray(msg))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("compact", [False, True])
def test_weighted_agg_grads_match_reference(compact):
    """The gradients of ``ops.weighted_agg`` (K7 forward, the plain VJP)
    against ``jax.grad`` of the reference op (Pallas interpret), as the
    reference's own ``test_weighted_agg_gather_fused_compact_and_grads``."""
    rng = np.random.default_rng(61 + compact)
    n_nodes, d = 9, 5
    dst, perm, ptr = _all_nodes_dst(rng, n_nodes, 41)
    e = dst.shape[0]
    e2u = rng.integers(0, 17, e).astype(np.int32) if compact else None
    scale = rng.normal(size=e).astype(np.float32)
    msg = rng.normal(size=(17 if compact else e, d)).astype(np.float32)
    bc = ops.blocked_csr_dev(L.block_csr(ptr, 8, 8), perm, e2u)
    rbc = rops.blocked_csr_dev(RL.block_csr(ptr, 8, 8), perm, e2u)

    def ours(s, m):
        return torch.sum(torch.cos(ops.weighted_agg(
            s, m, _t(dst), n_nodes, bc=bc,
            msg_rows=None if e2u is None else _t(e2u))))

    def ref(s, m):
        return jnp.sum(jnp.cos(rops.weighted_agg(
            s, m, jnp.asarray(dst), n_nodes, bc=rbc,
            backend="pallas_interpret",
            msg_rows=None if e2u is None else jnp.asarray(e2u))))

    got = _torch_grads(ours, scale, msg)
    want = jax.grad(ref, argnums=(0, 1))(jnp.asarray(scale),
                                         jnp.asarray(msg))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL)
    # scale=None: ones, and the message gradient alone
    m = _t(msg).requires_grad_(True)
    torch.sum(torch.cos(ops.weighted_agg(
        None, m, _t(dst), n_nodes, bc=bc,
        msg_rows=None if e2u is None else _t(e2u)))).backward()
    want = jax.grad(lambda m: jnp.sum(jnp.cos(rops.weighted_agg(
        None, m, jnp.asarray(dst), n_nodes, bc=rbc,
        backend="pallas_interpret",
        msg_rows=None if e2u is None else jnp.asarray(e2u)))))(
        jnp.asarray(msg))
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("compact", [False, True])
def test_weighted_agg_gradcheck_fp64(compact):
    rng = np.random.default_rng(71 + compact)
    n_nodes = 20
    dst = np.concatenate([np.arange(n_nodes - 4),
                          rng.integers(0, n_nodes, 30)]).astype(np.int32)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    dptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_nodes), out=dptr[1:])
    e2u = rng.integers(0, 11, dst.shape[0]).astype(np.int32) \
        if compact else None
    bc = ops.blocked_csr_dev(L.block_csr(dptr, 4, 4), perm, e2u)
    scale = torch.from_numpy(rng.normal(size=dst.shape[0])).requires_grad_()
    msg = torch.from_numpy(rng.normal(
        size=(11 if compact else dst.shape[0], 3))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda sc, mg: ops.weighted_agg(
            sc, mg, _t(dst), n_nodes, bc=bc,
            msg_rows=None if e2u is None else _t(e2u)), (scale, msg))


def test_gradcheck_fp64_plain_paths():
    """``torch.autograd.gradcheck`` of every autograd Function on the CPU
    (the plain versions keep fp64)."""
    rng = np.random.default_rng(51)

    def t64(a):
        return torch.from_numpy(np.asarray(a, np.float64)).requires_grad_()

    ptr, m = _segments(rng, 4, 9, empty=(1,))
    ps = L.pad_segments(ptr, 4)
    ps = L.pad_segments_rows(ps, L.pow2ceil(ps.padded_rows) * 2)
    lay = ops.padded_segments_dev(ps)
    gmap = _t(L.compose_gather_rows(ps, rng.integers(0, 7, m)))
    x_src, x = t64(rng.normal(size=(7, 3))), t64(rng.normal(size=(m, 3)))
    w, s = t64(rng.normal(size=(4, 3, 2))), t64(rng.normal(size=m))
    assert torch.autograd.gradcheck(
        lambda x, w, s: ops.segment_mm_gather(x, w, lay, gmap, row_scale=s),
        (x_src, w, s))
    assert torch.autograd.gradcheck(
        lambda x, w, s: ops.segment_mm(x, w, lay, row_scale=s), (x, w, s))

    n_nodes = 20
    dst = np.concatenate([np.arange(n_nodes - 4),
                          rng.integers(0, n_nodes, 30)]).astype(np.int32)
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    dptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_nodes), out=dptr[1:])
    e2u = rng.integers(0, 11, dst.shape[0]).astype(np.int32)
    bc = ops.blocked_csr_dev(L.block_csr(dptr, 4, 4), perm, e2u)
    scores, msg = t64(rng.normal(size=dst.shape[0])), t64(
        rng.normal(size=(11, 3)))
    assert torch.autograd.gradcheck(
        lambda sc, mg: ops.edge_softmax_agg(sc, mg, _t(dst), n_nodes, bc=bc,
                                            msg_rows=_t(e2u)),
        (scores, msg))
    assert torch.autograd.gradcheck(
        lambda sc: ops.edge_softmax(sc, _t(dst), n_nodes, bc=bc), (scores,))


# ---------------------------------------------------------------------------
# segment reductions and device dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(40,), (40, 3)])
def test_compat_segment_reductions_match_reference(shape):
    from repro import compat as rcompat
    from repro_torch import compat

    rng = np.random.default_rng(3)
    data = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(0, 9, shape[0]).astype(np.int32)
    ids[ids == 4] = 5                           # segment 4 stays empty
    for ours_fn, ref_fn in ((compat.segment_sum, rcompat.segment_sum),
                            (compat.segment_max, rcompat.segment_max)):
        ours = ours_fn(_t(data), _t(ids), 10).numpy()
        ref = np.asarray(ref_fn(jnp.asarray(data), jnp.asarray(ids), 10))
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    assert np.all(compat.segment_max(_t(data), _t(ids), 10).numpy()[4]
                  == -np.inf)


def test_off_cpu_tensors_never_take_the_plain_path():
    """Tensors that are not on the CPU get the kernel or an error: the
    kernel wrappers (K1-K5 and K7, through ``ops.weighted_agg``, and the
    GEMM backward that runs K4 and K5) refuse a device they have no kernel
    for (here ``meta``, which needs no card), and an op without its layout
    refuses to run its oracle there."""
    meta = torch.device("meta")
    ps = L.pad_segments(np.array([0, 5, 9]), 4)
    lay = ops.padded_segments_dev(ps).to(meta)
    with pytest.raises(ValueError, match="segment_mm_padded: no kernel for "
                                         "device meta"):
        ops.segment_mm(torch.ones(9, 4, device=meta),
                       torch.ones(2, 4, 3, device=meta), lay)
    bc = ops.blocked_csr_dev(L.block_csr(np.array([0, 2, 6, 6, 6]), 4, 4),
                             np.arange(6, dtype=np.int32)).to(meta)
    with pytest.raises(ValueError, match="seg_weighted_agg_gather_padded: "
                                         "no kernel for device meta"):
        ops.weighted_agg(None, torch.ones(6, 3, device=meta),
                         torch.zeros(6, dtype=torch.int32, device=meta), 4,
                         bc=bc)
    with pytest.raises(ValueError, match="needs the blocked CSR layout"):
        ops.weighted_agg(None, torch.ones(6, 3, device=meta),
                         torch.zeros(6, dtype=torch.int32, device=meta), 4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        SK.segment_mm_gather_padded(
            torch.ones(5, 4, device=meta), torch.ones(2, 4, 3, device=meta),
            torch.zeros(12, dtype=torch.int32, device=meta),
            torch.zeros(3, dtype=torch.int32, device=meta), tile=4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        SK.segment_mm_padded(
            torch.ones(12, 4, device=meta), torch.ones(2, 3, 4, device=meta),
            torch.zeros(3, dtype=torch.int32, device=meta), tile=4,
            transpose_w=True)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        SK.segment_outer_padded(
            torch.ones(12, 4, device=meta), torch.ones(12, 3, device=meta),
            lay.group_tile_ptr, lay.group_chunk_ptr, num_groups=2,
            num_chunks=lay.num_chunks, tile=4, chunk_tiles=lay.chunk_tiles)
    for fn in (ops.weighted_agg, ops.edge_softmax_agg):
        name = ("seg_weighted_agg_padded" if fn is ops.weighted_agg
                else "seg_stats_padded")
        with pytest.raises(ValueError, match=f"{name}: no kernel for "
                                             f"device meta"):
            fn(torch.ones(6, device=meta), torch.ones(6, 3, device=meta),
               torch.zeros(6, dtype=torch.int32, device=meta), 4, bc=bc,
               fuse_gather=False)
    i32 = dict(dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="seg_softmax_agg_padded: no kernel "
                                         "for device meta"):
        TK.seg_softmax_agg_padded(
            torch.ones(2, 4, device=meta), torch.ones(8, 3, device=meta),
            torch.zeros(2, 4, **i32), torch.zeros(2, **i32),
            torch.zeros(2, **i32), torch.ones(1, 4, device=meta),
            torch.ones(1, 4, device=meta), node_block=4, num_node_blocks=1)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        TK.seg_stats_padded(
            torch.ones(2, 4, device=meta),
            torch.zeros(2, 4, dtype=torch.int32, device=meta),
            torch.zeros(2, dtype=torch.int32, device=meta),
            torch.zeros(2, dtype=torch.int32, device=meta),
            node_block=4, num_node_blocks=1)
    # the GEMM backward: dX through K4, dW through K5, never a plain path
    gidx = torch.zeros(12, dtype=torch.int32, device=meta)
    args = (torch.ones(12, 3, device=meta), torch.ones(5, 4, device=meta),
            torch.ones(2, 4, 3, device=meta), None, None, lay, gidx)
    with pytest.raises(ValueError, match="segment_mm_padded: no kernel"):
        ops._gemm_backward((True, False, False), *args)
    with pytest.raises(ValueError, match="segment_outer_padded: no kernel"):
        ops._gemm_backward((False, True, False), *args)


# ---------------------------------------------------------------------------
# the kernel build (no nvcc here: what can be checked without one)
# ---------------------------------------------------------------------------
def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


def test_library_name_follows_the_source_hash(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert build.sources() == ["k"]
    first = build._library_path("k")
    assert first.parent == tmp_path / "b"
    assert build._library_path("k") == first
    (src / "k.cu").write_text("// v2\n")
    second = build._library_path("k")
    assert second != first
    (src / "common.cuh").write_text("// header\n")      # headers count too
    assert build._library_path("k") not in (first, second)
    assert build.sources() == ["k"]
