"""The port's deterministic backward on the CPU: K11
(``traversal.seg_sum_sorted``, the backward's scatter-add over a stable
sort of its target index) and the routes that use it.

* K11's plain version against an fp64 ``index_add_`` over random targets
  with -1s, rows without entries and one hub row; ``sorted_segments``'
  index arrays (static shapes, stable, the -1s first).
* Each of the four backward sites calls its new route: the dX of a
  gathered GEMM and the compact ``dmsg`` of both traversal ops go through
  K11, the softmax VJP's per-destination sum through K7 at width 1 over the
  forward's blocked CSR (counted by wrapping the ops' names).
* Gradients of RGAT, RGCN, HGT and rgcn_cat through the port against the
  reference's ``HectorModule`` (Pallas interpret) on the same NumPy
  weights and features, with respect to the weights and the input
  features (so every site is reached): 1e-4 of each gradient's largest
  entry, the bound of ``tests/test_torch_models.py``.
* Two identical backward passes give bit-equal gradients.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core.graph import synthetic_heterograph as ref_graph
from repro.core.module import HectorModule as RefModule
from repro.train.engine import MODEL_PROGRAMS as REF_PROGRAMS
from repro_torch.core.codegen import params_from_reference
from repro_torch.core.graph import synthetic_heterograph
from repro_torch.core.module import HectorModule
from repro_torch.kernels import ops
from repro_torch.kernels import traversal as TK
from repro_torch.train.engine import MODEL_PROGRAMS

NAMES = ["rgcn", "rgat", "hgt", "rgcn_cat"]
GRAPH = dict(num_nodes=120, num_edges=900, num_ntypes=4, num_etypes=7,
             seed=0)


def _index_add(values, target, num_rows):
    """The oracle: fp64 ``index_add_`` of the rows whose target is not -1."""
    keep = target >= 0
    out = torch.zeros((num_rows, values.shape[1]), dtype=torch.float64)
    out.index_add_(0, target[keep].long(), values[keep].double())
    return out.float()


@pytest.mark.parametrize("case", ["random", "hub", "all_pad", "one_row",
                                  "empty_rows"])
def test_seg_sum_sorted_plain_equals_index_add(case):
    rng = np.random.default_rng({"random": 0, "hub": 1, "all_pad": 2,
                                 "one_row": 3, "empty_rows": 4}[case])
    n, num_rows, d = 3000, 200, 7
    target = rng.integers(-1, num_rows, n)
    if case == "hub":
        target[rng.random(n) < 0.6] = 17          # one row takes most
    elif case == "all_pad":
        target[:] = -1
    elif case == "one_row":
        target[:] = num_rows - 1
    elif case == "empty_rows":
        target = np.where(target % 3 == 0, -1, target)   # a third empty
    values = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    target_t = torch.from_numpy(target.astype(np.int32))
    perm, ptr = TK.sorted_segments(target_t, num_rows)
    assert perm.dtype == ptr.dtype == torch.int32
    assert perm.shape == (n,) and ptr.shape == (num_rows + 1,)
    assert int(ptr[0]) == int((target < 0).sum())
    assert int(ptr[-1]) == n
    # stable: within a row, the original order
    st = target[perm.numpy()]
    assert np.all(np.diff(st) >= 0)
    for r in (0, 17, num_rows - 1):
        run = perm.numpy()[int(ptr[r]):int(ptr[r + 1])]
        assert np.all(np.diff(run) > 0)
    got = TK.seg_sum_sorted(values, perm, ptr, num_rows)
    want = _index_add(values, target_t, num_rows)
    assert got.dtype == torch.float32 and got.shape == (num_rows, d)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ops.scatter_rows(values, target_t, num_rows),
                               got, rtol=0, atol=0)
    if case in ("all_pad", "empty_rows"):
        empty = np.setdiff1d(np.arange(num_rows), target[target >= 0])
        assert torch.equal(got[empty], torch.zeros(len(empty), d))


def test_seg_sum_sorted_checks_its_inputs():
    v = torch.zeros(4, 3)
    perm, ptr = TK.sorted_segments(torch.tensor([0, 1, -1, 1]), 2)
    with pytest.raises(ValueError, match="no kernel"):
        TK.seg_sum_sorted(v.to("meta"), perm.to("meta"), ptr.to("meta"), 2)
    assert TK.seg_sum_sorted(v, perm, ptr, 2).shape == (2, 3)


class _Counting:
    """Wraps an ops-level kernel name and counts its calls (width of the
    values / messages each)."""

    def __init__(self, fn, width_arg):
        self.fn, self.width_arg, self.widths = fn, width_arg, []

    def __call__(self, *args, **kw):
        self.widths.append(int(args[self.width_arg].shape[-1]))
        return self.fn(*args, **kw)


@pytest.fixture
def routes(monkeypatch):
    k11 = _Counting(ops.seg_sum_sorted, 0)
    k7 = _Counting(ops.seg_weighted_agg_gather_padded, 1)
    monkeypatch.setattr(ops, "seg_sum_sorted", k11)
    monkeypatch.setattr(ops, "seg_weighted_agg_gather_padded", k7)
    return k11, k7


def _layout(num_nodes=40, num_edges=300, seed=0):
    from repro_torch.core.codegen import build_kernel_layouts
    g = synthetic_heterograph(num_nodes, num_edges, 2, 3, seed=seed)
    kl = build_kernel_layouts(g, tile=8, node_block=8)
    return g, g.to_tensors(), kl


def test_gathered_gemm_dx_sums_through_k11(routes):
    k11, _ = routes
    g, gt, kl = _layout()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(g.num_nodes, 6)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=(g.num_etypes, 6, 5)).astype(
        np.float32)).requires_grad_(True)
    gmap = kl.edge_src_rows
    y = ops.segment_mm_gather(x, w, kl.edge_seg, gmap)
    torch.sum(y * y).backward()
    assert k11.widths == [6]
    # the same product with the rows gathered beforehand
    x2 = x.detach().clone().requires_grad_(True)
    y2 = ops.segment_mm(x2[gt.src.long()], w.detach(), kl.edge_seg)
    torch.sum(y2 * y2).backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-5)


def test_traversal_backward_routes(routes):
    """edge_softmax_agg over compact messages: dmsg by K11, the softmax VJP
    by K7 at width 1; weighted_agg over compact messages: dmsg by K11;
    edge_softmax: the VJP by K7 at width 1."""
    k11, k7 = routes
    g, gt, kl = _layout()
    rng = np.random.default_rng(1)
    e2u = gt.edge_to_unique
    m = int(e2u.max()) + 1
    scores = torch.from_numpy(rng.normal(size=g.num_edges).astype(
        np.float32)).requires_grad_(True)
    msg = torch.from_numpy(rng.normal(size=(m, 4)).astype(
        np.float32)).requires_grad_(True)
    out = ops.edge_softmax_agg(scores, msg, gt.dst, g.num_nodes,
                               bc=kl.blocked, msg_rows=e2u)
    torch.sum(out ** 2).backward()
    assert k11.widths == [4] and k7.widths == [1]
    k11.widths.clear()
    k7.widths.clear()
    scale = scores.detach().clone().requires_grad_(True)
    out = ops.weighted_agg(scale, msg, gt.dst, g.num_nodes, bc=kl.blocked,
                           msg_rows=e2u)
    torch.sum(out ** 2).backward()
    assert k11.widths == [4] and k7.widths == [4]     # K7's forward only
    k11.widths.clear()
    k7.widths.clear()
    att = ops.edge_softmax(scores, gt.dst, g.num_nodes, bc=kl.blocked)
    torch.sum(att * torch.arange(g.num_edges)).backward()
    assert k11.widths == [] and k7.widths == [1]


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_reference(name):
    """Weights' and input features' gradients of a loss over one layer
    (reordered, compact) against the reference's, and bit for bit the
    same on a second backward."""
    g, rg = synthetic_heterograph(**GRAPH), ref_graph(**GRAPH)
    rmod = RefModule(REF_PROGRAMS[name](16, 24), rg, reorder=True,
                     compact=True, backend="pallas_interpret", tile=8,
                     node_block=8)
    mod = HectorModule(MODEL_PROGRAMS[name](16, 24), g, tile=8,
                       node_block=8, reorder=True, compact=True)
    rparams = rmod.init(jax.random.key(0))
    (params,) = params_from_reference(
        [{k: np.asarray(v) for k, v in rparams.items()}], plans=[mod.plan],
        num_etypes=g.num_etypes, num_ntypes=g.num_ntypes)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(g.num_nodes, 16)).astype(np.float32)
    cot = rng.normal(size=(g.num_nodes, 24)).astype(np.float32)

    def backward():
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        out = mod.apply(leaves, {"feature": xt})["h_out"]
        torch.sum(out * torch.from_numpy(cot)).backward()
        return dict({k: v.grad for k, v in leaves.items()}, x=xt.grad)

    def rloss(p, xx):
        return jnp.sum(rmod.apply(p, {"feature": xx})["h_out"] * cot)

    got = backward()
    rgrads, rgx = jax.grad(rloss, argnums=(0, 1))(rparams, jnp.asarray(x))
    want = dict({k: np.asarray(v) for k, v in rgrads.items()},
                x=np.asarray(rgx))
    assert set(got) == set(want)
    for k, t in got.items():
        denom = float(np.abs(want[k]).max()) + 1e-9
        np.testing.assert_allclose(t.numpy() / denom, want[k] / denom,
                                   rtol=0, atol=1e-4, err_msg=k)
    again = backward()
    for k, t in got.items():
        assert torch.equal(t, again[k]), k


def test_launch_counts_list_k11():
    """``ops.launch_counts()`` (the ``kernels`` line's source) names all
    eleven kernels, K11 among them; the CPU route launches nothing."""
    counts = ops.launch_counts()
    assert len(counts) == 11 and "seg_sum_sorted" in counts
    before = counts["seg_sum_sorted"]
    perm, ptr = TK.sorted_segments(torch.tensor([1, 0, 1, -1]), 3)
    TK.seg_sum_sorted(torch.ones(4, 2), perm, ptr, 3)
    assert ops.launch_counts()["seg_sum_sorted"] == before
