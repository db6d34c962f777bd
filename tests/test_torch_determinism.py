"""The port's deterministic backward on the CPU: K11
(``traversal.seg_sum_sorted``, the backward's scatter-add over a stable
sort of its target index) and the routes that use it.

* K11's plain version against an fp64 ``index_add_`` over random targets
  with -1s, rows without entries and one hub row, and at the edge cases
  ``chip_smoke.py`` runs the kernel at; ``sorted_segments``' index arrays
  (static shapes, stable, the -1s first, ``key`` the sorted targets).
* ``scatter_plan``, K11's split from shapes alone: a unit size, lane split
  and workspace for every width and call size, and a raise on what the
  kernel cannot take.
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
    perm, key = TK.sorted_segments(target_t)
    assert perm.dtype == key.dtype == torch.int32
    assert perm.shape == key.shape == (n,)
    assert int((key < 0).sum()) == int((target < 0).sum())
    # the sorted targets; stable: within a row, the original order
    st = target[perm.numpy()]
    assert np.array_equal(key.numpy(), st)
    assert np.all(np.diff(st) >= 0)
    for r in (0, 17, num_rows - 1):
        run = perm.numpy()[st == r]
        assert np.all(np.diff(run) > 0)
    got = TK.seg_sum_sorted(values, perm, key, num_rows)
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
    perm, key = TK.sorted_segments(torch.tensor([0, 1, -1, 1]))
    with pytest.raises(ValueError, match="no kernel"):
        TK.seg_sum_sorted(v.to("meta"), perm.to("meta"), key.to("meta"), 2)
    assert TK.seg_sum_sorted(v, perm, key, 2).shape == (2, 3)


# the widths ``chip_smoke.py`` runs K11's edge cases at, and call sizes
# from one entry to 10**6 (each side of the plan's unit halvings)
PLAN_D = (1, 4, 7, 16, 64, 96, 300)
PLAN_N = (1, 2, 31, 64, 65, 2000, 16384, 32 * 4224, 32 * 4224 + 1,
          64 * 4224 + 1, 128 * 4224, 128 * 4224 + 1, 673000, 10**6)


@pytest.mark.parametrize("d", PLAN_D)
def test_scatter_plan_covers_every_call(d):
    """A unit size, a lane split and a workspace for every call: 16-byte
    copies exactly where d % 4 == 0, ``32 // lanes`` lane groups whose
    column pass covers d columns (or 32 lanes' worth), a stage split
    evenly among the groups and whole stages in a unit, a two-stage ring
    of at most 4 KB a stage, units of
    32-256 entries, smaller for small calls (2,000 entries fill more than
    8 SMs), and the workspace sized by the unit count."""
    for n in PLAN_N:
        p = TK.scatter_plan(n, d)
        assert p.vec == (4 if d % 4 == 0 else 1)
        assert p.lanes in (1, 2, 4, 8, 16, 32)
        cols = p.lanes * p.vec
        assert cols >= d or p.lanes == 32
        assert p.lanes == 1 or (p.lanes // 2) * p.vec < d
        assert p.chunk % (32 // p.lanes) == 0 and p.unit % p.chunk == 0
        assert p.chunk * cols <= TK.SCATTER_STAGE_FLOATS
        assert p.unit in (32, 64, 128, 256)
        assert p.units == -(-n // p.unit)
        assert (p.units >= TK.SCATTER_TARGET_UNITS
                or p.unit == TK.SCATTER_MIN_UNIT)
        assert p.ws_doubles == 2 * p.units * d and p.tickets == 2 * p.units
        # the kernel's shared memory: the ring and the unit's indices
        assert (2 * p.chunk * cols + 2 * p.unit) * 4 <= 48 * 1024
    assert TK.scatter_plan(2000, d).units > 8


def test_scatter_plan_shapes_only_and_raises():
    """The plan is a function of (entries, width) alone, the same object
    on every call at a shape (so a captured key never splits on values);
    it raises where the kernel cannot go, and never picks the plain
    version."""
    import inspect

    assert list(inspect.signature(TK.scatter_plan).parameters) == [
        "n_entries", "d"]
    assert TK.scatter_plan(5000, 64) is TK.scatter_plan(5000, 64)
    for n, d in ((0, 64), (-1, 8), (100, 0), (100, -3), (2**31 - 64, 1)):
        with pytest.raises(ValueError):
            TK.scatter_plan(n, d)
    # the splits the kernel is instantiated for: 6 lane counts x 2 widths
    splits = {(TK.scatter_plan(1, d).vec, TK.scatter_plan(1, d).lanes)
              for d in (1, 2, 3, 7, 15, 33, 4, 8, 16, 32, 64, 96, 300)}
    assert len(splits) == 12


def _edge_cases(u):
    """The K11 edge cases of ``chip_smoke.py`` (``k11_edge_cases``) at
    unit ``u``: (targets, rows) by name."""
    rng = np.random.default_rng(11)
    runs = np.array([u - 1, 1, u, u + 1, 2 * u - 1, 0, 1, 1, 3 * u + 1, 0,
                     0, 17, u])
    laid = np.repeat(np.arange(runs.size), runs)
    hub = np.concatenate([rng.integers(0, 5000, 20000),
                          np.full(30000, 2500)])
    cases = {
        "all -1": (np.full(4 * u + 37, -1), 50),
        "one row": (np.full(40000, 3), 8),
        "runs across unit edges": (laid, runs.size),
        "runs after 300 -1s": (np.concatenate([laid, np.full(300, -1)]),
                               runs.size),
        "hub": (hub, 5000),
        "sparse rows": (rng.integers(0, 200000, 5000), 200000),
    }
    return {k: (rng.permutation(t).astype(np.int32), r)
            for k, (t, r) in cases.items()}


@pytest.mark.parametrize("d", [1, 7, 64])
@pytest.mark.parametrize("case", ["all -1", "one row",
                                  "runs across unit edges",
                                  "runs after 300 -1s", "hub",
                                  "sparse rows"])
def test_seg_sum_sorted_plain_at_edge_cases(case, d):
    """The plain version and ``sorted_segments``' outputs at the shapes
    the card's edge cases use: within rtol = atol = 1e-6 of an fp64
    ``index_add_``; the sort's key and perm rebuild the targets."""
    u = TK.scatter_plan(1, 1).unit
    target, num_rows = _edge_cases(u)[case]
    assert TK.scatter_plan(target.size, d).unit == u
    rng = np.random.default_rng(d)
    values = torch.from_numpy(rng.normal(size=(target.size, d)).astype(
        np.float32))
    target_t = torch.from_numpy(target)
    perm, key = TK.sorted_segments(target_t)
    rebuilt = torch.full_like(target_t, -1)
    rebuilt[perm.long()] = key
    assert torch.equal(rebuilt, target_t)
    got = TK.seg_sum_sorted(values, perm, key, num_rows)
    want = _index_add(values, target_t, num_rows)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _k11_walk(values, perm, key, num_rows, arrival_rng):
    """A NumPy model of K11's algorithm (``csrc/scatter.cu``) at the cut
    ``scatter_plan`` gives: per unit the zeros of its gaps, each chunk's
    group walks joined by a segmented scan across the groups with a
    carry, partials of the runs that cross a unit edge, then the tickets
    taken in a random arrival order (the telescoping terms -(a + 1), -1,
    b + 2) and each crossing run added by the unit that completes it.
    Every row is written exactly once and every ticket ends at zero."""
    int_min = -2**31
    n, d = len(perm), values.shape[1]
    p = TK.scatter_plan(n, d)
    unit, chunk, groups = p.unit, p.chunk, 32 // p.lanes
    units = p.units
    out = np.full((num_rows, d), np.nan)
    ws = np.full((2 * units, d), np.nan)
    count, first = np.zeros(units, np.int64), np.zeros(units, np.int64)
    written = np.zeros(num_rows, int)
    open_units = []
    for u in range(units):
        us, cnt = u * unit, min(unit, n - u * unit)
        ks, ps = key[us:us + cnt], perm[us:us + cnt]
        before = key[us - 1] if us > 0 else -1
        last_unit = us + cnt == n
        after = int_min if last_unit else key[us + cnt]
        fr, lr = ks[0], ks[-1]
        for t in range(cnt + (1 if last_unit else 0)):
            prev = (ks[t - 1] if t else before) if t < cnt else lr
            cur = ks[t] if t < cnt else num_rows
            out[prev + 1:cur] = 0
            written[prev + 1:max(cur, prev + 1)] += 1
        if lr < 0:
            continue
        ho, to = fr >= 0 and before == fr, after == lr

        def put(row, v, u=u, fr=fr, lr=lr, ho=ho, to=to):
            if row < 0:
                return
            if row == fr and ho:
                ws[2 * u] = v
            elif row == lr and to:
                ws[2 * u + 1] = v
            else:
                out[row] = v
                written[row] += 1

        carry_row, carry = int_min, None
        for t0 in range(0, cnt, chunk):
            rows = min(chunk, cnt - t0)
            key_at = (lambda e: ks[t0 + e] if e < rows else lr)
            span = chunk // groups
            hks, tks, hvs, accs = [], [], [], []
            for g in range(groups):
                hk = tk = int_min
                hv = acc = np.zeros(d)
                for e in range(g * span, (g + 1) * span):
                    k = key_at(e)
                    if k != tk:
                        if tk != int_min:
                            if hk == int_min:
                                hk, hv = tk, acc
                            else:
                                put(tk, acc)
                        tk, acc = k, np.zeros(d)
                    if e < rows and k >= 0:
                        acc = acc + values[ps[t0 + e]].astype(np.float64)
                hks.append(hk)
                tks.append(tk)
                hvs.append(hv)
                accs.append(acc)
            multi = [h != int_min for h in hks]
            in_keys = [h if m else t for h, m, t in zip(hks, multi, tks)]
            if carry_row not in (int_min, in_keys[0]):
                put(carry_row, carry)
                carry_row = int_min
            o = list(accs)
            if not multi[0] and carry_row == tks[0]:
                o[0] = carry + accs[0]
            head = [g == 0 or multi[g] or tks[g - 1] != tks[g]
                    for g in range(groups)]
            off = 1
            while off < groups:
                o2, h2 = list(o), list(head)
                for g in range(off, groups):
                    if not head[g]:
                        o2[g], h2[g] = o[g - off] + o[g], head[g - off]
                o, head, off = o2, h2, 2 * off
            for g in range(groups - 1):
                if in_keys[g + 1] != tks[g]:
                    put(tks[g], o[g])
            for g in range(groups):
                if multi[g]:
                    left = (o[g - 1] if g and tks[g - 1] == hks[g] else
                            carry if not g and carry_row == hks[g] else 0)
                    put(hks[g], left + hvs[g])
            carry, carry_row = o[-1], tks[-1]
        put(carry_row, carry)
        if ho or to:
            b = u
            while to and b + 1 < units and key[(b + 1) * unit] == lr:
                b += 1
            open_units.append((u, ho, to, ho and to and fr == lr, fr, lr, b))
    order = arrival_rng.permutation(len(open_units))
    for u, ho, to, inside, fr, lr, b in (open_units[i] for i in order):
        if to and not inside:
            first[b] = u
    for u, ho, to, inside, fr, lr, b in (open_units[i] for i in order):
        terms = ([(fr, b, -1)] if inside else
                 [(fr, u, u + 2)] * int(ho) + [(lr, b, -(u + 1))] * int(to))
        for row, last, term in terms:
            count[last] += term
            if count[last] == 2:
                a = first[last]
                out[row] = ws[2 * a + 1] + sum(ws[2 * w]
                                               for w in range(a + 1, last + 1))
                written[row] += 1
                count[last] = 0
    assert (written == 1).all() and (count == 0).all()
    return out.astype(np.float32)


@pytest.mark.parametrize("seed", range(8))
def test_k11_algorithm_model(seed):
    """K11's algorithm, modelled in NumPy at the plan's cut, against an
    fp64 ``index_add_`` (rtol = atol = 1e-6): random targets, a hub, runs
    across unit edges, mostly -1, at widths that take G = 32 / 16 / 8 / 4
    / 2 / 1 groups and several chunks a unit."""
    rng = np.random.default_rng(seed)
    d = (1, 8, 7, 16, 64, 96, 3, 33)[seed]
    u = TK.scatter_plan(1, d).unit
    n, num_rows = 1500, 300
    target = rng.integers(-1, num_rows, n)
    if seed % 4 == 1:
        target[rng.random(n) < 0.5] = num_rows // 2
    elif seed % 4 == 2:
        runs = rng.integers(0, 3 * u, 40)
        target, num_rows = np.repeat(np.arange(40), runs), 40
    elif seed % 4 == 3:
        target[rng.random(n) < 0.7] = -1
    values = rng.normal(size=(target.size, d)).astype(np.float32)
    perm = np.argsort(target, kind="stable")
    got = _k11_walk(values, perm, target[perm], num_rows, rng)
    want = _index_add(torch.from_numpy(values), torch.from_numpy(target),
                      num_rows)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)


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
    perm, key = TK.sorted_segments(torch.tensor([1, 0, 1, -1]))
    TK.seg_sum_sorted(torch.ones(4, 2), perm, key, 3)
    assert ops.launch_counts()["seg_sum_sorted"] == before
