"""``repro_torch.launch.partitioning`` against ``repro.launch.partitioning``,
on the CPU: the rules leaf for leaf.

The reference's ``Partitioner`` runs on ``jax.sharding.AbstractMesh``
(no devices) over ``jax.eval_shape`` trees; the port's on a ``MeshShape``
over its meta trees. For every config of the registry, every mode and the
meshes ``(16, 16)``, ``(2, 16, 16)``, ``(2, 4)``, ``(4, 2)`` and ``(1, 1)``:
the parameters' specs, the ZeRO-1 moments' (``state_shardings``), the
caches' over ``init_cache``'s tree at three batch sizes, ``batch_spec`` and
the resolver's spec for every logical name (the reference's captured by
monkeypatching ``jax.lax.with_sharding_constraint`` inside the test), each
equal, and each leaf's local shape equal to
``NamedSharding(abstract_mesh, spec).shard_shape``. The two variant flags
``attn_head_sharding_only=False`` and ``seq_shard_kv_decode=True`` are
held the same way. Then the port's run-time decision (split, gather,
partial or whole over ``model``) is pinned for every leaf of every config
at ``tp`` = 2 and 16.
"""
import functools
import types

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as RC
from repro.launch import partitioning as RP
from repro.lm.model import TransformerLM as RefLM
from repro.optim import AdamW as RefAdamW
from repro_torch import configs as C
from repro_torch.launch import mesh as M
from repro_torch.launch import partitioning as PT
from repro_torch.lm.model import TransformerLM
from repro_torch.optim import AdamW

MESHES = [(16, 16), (2, 16, 16), (2, 4), (4, 2), (1, 1)]
MODES = ["train", "prefill", "decode"]
CACHE_BATCHES = (1, 16, 32)
CACHE_LEN = 64


def axes_of(sizes):
    return ("pod", "data", "model")[-len(sizes):] if len(sizes) == 3 \
        else ("data", "model")


def meshes(sizes):
    names = axes_of(sizes)
    return AbstractMesh(tuple(sizes), names), PT.MeshShape(names, tuple(sizes))


def path_str(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in kp)


@functools.lru_cache(maxsize=None)
def ref_trees(arch):
    rm = RefLM(RC.get_config(arch))
    params = jax.eval_shape(rm.init, jax.random.key(0))
    state = jax.eval_shape(RefAdamW().init, params)
    caches = {b: jax.eval_shape(lambda b=b: rm.init_cache(b, CACHE_LEN))
              for b in CACHE_BATCHES}
    return params, state, caches


@functools.lru_cache(maxsize=None)
def port_trees(arch):
    model = TransformerLM(C.get_config(arch), device="meta")
    params = model._build(None)
    return params, AdamW().init(params), {
        b: model.init_cache(b, CACHE_LEN) for b in CACHE_BATCHES}


def ref_specs(shardings):
    return {path_str(kp): (tuple(s.spec), s)
            for kp, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}


def port_specs(shardings):
    return {PT._path_str(kp): s for kp, s in PT.tree_paths(shardings)}


def assert_same_specs(ref_tree, ref_sh, port_sh, abstract, what):
    want = ref_specs(ref_sh)
    got = port_specs(port_sh)
    assert set(got) == set(want), what
    shapes = {path_str(kp): tuple(x.shape) for kp, x in
              jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    for path, (spec, _) in want.items():
        assert tuple(got[path].spec) == spec, (what, path, got[path].spec,
                                               spec)
        assert got[path].shard_shape(shapes[path]) == NamedSharding(
            abstract, jax.sharding.PartitionSpec(*spec)).shard_shape(
                shapes[path]), (what, path)


def pair(arch, sizes, mode, **flags):
    abstract, shape = meshes(sizes)
    return (RP.Partitioner(abstract, RC.get_config(arch), mode=mode, **flags),
            PT.Partitioner(shape, C.get_config(arch), mode=mode, **flags),
            abstract)


def check_rules(arch, sizes, mode, **flags):
    ref, port, abstract = pair(arch, sizes, mode, **flags)
    rparams, rstate, rcaches = ref_trees(arch)
    params, state, caches = port_trees(arch)
    tag = (arch, sizes, mode, flags)
    assert_same_specs(rparams, ref.param_shardings(rparams),
                      port.param_shardings(params), abstract, tag + ("param",))
    assert_same_specs(rstate, ref.state_shardings(rstate),
                      port.state_shardings(state), abstract, tag + ("state",))
    for b in CACHE_BATCHES:
        assert_same_specs(rcaches[b], ref.cache_shardings(rcaches[b]),
                          port.cache_shardings(caches[b]), abstract,
                          tag + ("cache", b))
    for b in (1, 2, 4, 16, 32, 64):
        assert port.batch_dims(b) == ref.batch_dims(b), (tag, b)
        for shape in ((b, 1), (b, 64), (b, 100), (b, 64, 8)):
            assert tuple(port.batch_spec(shape)) == \
                tuple(ref.batch_spec(shape)), (tag, shape)


@pytest.mark.parametrize("sizes", MESHES, ids=str)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", C.ARCHS)
def test_rules_equal_the_reference(arch, mode, sizes):
    check_rules(arch, sizes, mode)


@pytest.mark.parametrize("flags", [dict(attn_head_sharding_only=False),
                                   dict(seq_shard_kv_decode=True)], ids=str)
@pytest.mark.parametrize("arch", C.ARCHS)
def test_variant_flags_rules_equal_the_reference(arch, flags):
    for sizes in MESHES:
        for mode in MODES:
            check_rules(arch, sizes, mode, **flags)


def logical_shapes(cfg, b):
    hd = cfg.resolved_head_dim
    return {
        "activation": [(b, 64, cfg.d_model), (b, 1, cfg.d_model),
                       (b, 48, cfg.d_model)],
        "kv": [(b, 64, cfg.num_kv_heads, hd), (b, 1, cfg.num_kv_heads, hd)],
        "ffn_hidden": [(b, 64, max(cfg.d_ff, 1)), (b, 64, 40)],
        "attn_out_heads": [(b, 64, cfg.num_heads, hd),
                           (b, 1, cfg.num_heads, hd)],
        "ssm_heads": [(b, 64, max(cfg.ssm_heads, 1), cfg.ssm_head_dim),
                      (b, 64, 24, 64)],
        "moe_dispatch": [(max(cfg.num_experts, 1), 64, cfg.d_model),
                         (8, 40, cfg.d_model), (6, 64, 32)],
        "moe_hidden": [(max(cfg.num_experts, 1), 64, 128), (6, 64, 32),
                       (6, 40, 30)],
    }


@pytest.mark.parametrize("flags", [{}, dict(seq_shard_activations=True)],
                         ids=str)
@pytest.mark.parametrize("arch", C.ARCHS)
def test_logical_names_resolve_as_the_reference(arch, flags, monkeypatch):
    captured = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: captured.append(s.spec) or x)
    cfg = C.get_config(arch)
    for sizes in MESHES:
        for mode in MODES:
            ref, port, _ = pair(arch, sizes, mode, **flags)
            resolve = ref.logical_resolver()
            mine = port.logical_resolver()
            for b in (1, 16, 32):
                for name, shapes in logical_shapes(cfg, b).items():
                    for shape in shapes:
                        captured.clear()
                        resolve(name, types.SimpleNamespace(shape=shape))
                        assert len(captured) == 1
                        assert tuple(mine.spec(name, shape)) == \
                            tuple(captured[0]), (sizes, mode, name, shape)
            captured.clear()
            resolve("other", types.SimpleNamespace(shape=(2, 3)))
            assert captured == [] and mine.spec("other", (2, 3)) is None


def test_production_meshes_and_the_resolvers_metadata():
    assert M.make_production_mesh().shape == {"data": 16, "model": 16}
    pm = M.make_production_mesh(multi_pod=True)
    assert pm.axis_names == ("pod", "data", "model") and pm.size == 512
    for sizes in MESHES:
        ref, port, _ = pair("grok-1-314b", sizes, "train")
        r, p = ref.logical_resolver(), port.logical_resolver()
        assert (p.tp, p.dp, p.dp_axes, p.tp_axis) == \
            (r.tp, r.dp, r.dp_axes, r.tp_axis)
        assert (p.seq_shard_kv_decode, p.moe_ep, p.bf16_reduce) == \
            (r.seq_shard_kv_decode, r.moe_ep, r.bf16_reduce)
        assert (port.tp, port.dp, port.data_size) == \
            (ref.tp, ref.dp, ref.data_size)


def test_partition_spec_normalizes_as_jax():
    from jax.sharding import PartitionSpec as JP
    for entries in ((("data",), None, "model"), (("pod", "data"),),
                    (None, None), ()):
        assert tuple(PT.P(*entries)) == tuple(JP(*entries))
    assert PT.P(("pod", "data"), None).axes(0) == ("pod", "data")
    assert PT.P("model").all_axes() == ("model",)


def test_variants_have_rules_but_no_run_time():
    """Every variant flag has its run time now (``tests/
    test_torch_perf_variants.py``): nothing refuses one, and each reaches
    the resolver."""
    assert not hasattr(PT.Partitioner, "runtime_check")
    for flag in ("seq_shard_kv_decode", "moe_ep", "bf16_reduce",
                 "seq_shard_activations"):
        part = PT.Partitioner(PT.MeshShape(("data", "model"), (1, 2)),
                              C.get_reduced("qwen3-4b"), **{flag: True})
        res = part.logical_resolver(4, 16)
        assert getattr(res, flag, True) and getattr(part, flag)


# ---------------------------------------------------------------------------
# the run time's decision, leaf by leaf
# ---------------------------------------------------------------------------
def decisions(arch, tp, mode):
    """``{block/leaf: decision}`` over every parameter leaf (each the same
    in every layer, the encoder's included), on a ``(1, tp)`` mesh."""
    part = PT.Partitioner(PT.MeshShape(("data", "model"), (1, tp)),
                          C.get_config(arch), mode=mode)
    out = {}
    for kp, leaf in PT.tree_paths(port_trees(arch)[0]):
        parts = [str(k) for k in kp]
        key = "/".join(parts[-2:]) if len(parts) > 1 else parts[0]
        d = part.plan("/".join(parts), leaf).model
        assert out.setdefault(key, d) == d, (arch, tp, mode, key)
    return out


ATTN = ("wq", "wk", "wv", "wo")
MLP = ("w_gate", "w_up", "w_down")
SSM = ("wi_z", "wi_x", "wi_bc", "wi_dt", "conv_w_x", "conv_w_bc",
       "conv_b_x", "conv_b_bc", "gate_norm", "wo")


def _attn(block, h, kv, n):
    return {f"{block}/{k}": v for k, v in zip(
        ATTN + ("q_norm", "k_norm")[:n], (h, kv, kv, h, "partial",
                                           "partial")[:4 + n])}


# decision of the attention leaves at tp (train, prefill, decode):
# split heads, KV heads split or used whole by every rank ("partial"),
# or the whole block gathered (replicated attention)
SPLIT_KV = ("split", "split")
DUP_KV = ("split", "partial")
PINNED = {
    # arch: {tp: (attention per mode, (qk-norm leaves), mlp, others)}
    "qwen3-4b": {2: ("split", "split", "split"), 16: ("dup", "dup", "dup")},
    "gemma2-2b": {2: ("split",) * 3, 16: ("gather", "gather", "gather")},
    "qwen3-14b": {2: ("split",) * 3, 16: ("gather", "gather", "gather")},
    "gemma3-4b": {2: ("split",) * 3, 16: ("gather", "gather", "gather")},
    "mamba2-780m": {2: (), 16: ()},
    "grok-1-314b": {2: ("split",) * 3, 16: ("dup", "dup", "dup")},
    "moonshot-v1-16b-a3b": {2: ("split",) * 3, 16: ("split",) * 3},
    "llama-3.2-vision-11b": {2: ("split",) * 3, 16: ("dup", "dup", "dup")},
    "whisper-medium": {2: ("split",) * 3, 16: ("split",) * 3},
    "jamba-v0.1-52b": {2: ("split",) * 3, 16: ("dup", "dup", "dup")},
}


def expected(arch, tp, mode):
    cfg = C.get_config(arch)
    kind = dict(zip(MODES, PINNED[arch][tp])).get(mode)
    gather_or_whole = {True: "gather", False: "whole"}
    want = {"embed": "split", "final_norm": "whole"}
    if not cfg.tie_embeddings:
        want["lm_head"] = "split"
    if cfg.frontend_dim:
        want["frontend_proj"] = "gather"
    qk = 2 if cfg.qk_norm else 0
    for block in ("attn", "cross"):
        h, kvd = {"split": SPLIT_KV, "dup": DUP_KV}.get(kind, (None, None))
        if kind == "gather":
            hd_tp = cfg.resolved_head_dim % tp == 0
            kv_tp = cfg.num_kv_heads % tp == 0
            att = {f"{block}/wq": gather_or_whole[mode == "decode" and hd_tp],
                   f"{block}/wk": gather_or_whole[kv_tp or (
                       mode == "decode" and hd_tp)],
                   f"{block}/wo": gather_or_whole[mode == "decode" and hd_tp]}
            att[f"{block}/wv"] = att[f"{block}/wk"]
            att.update({f"{block}/{n}": "whole"
                        for n in ("q_norm", "k_norm")[:qk]})
        else:
            att = _attn(block, h, kvd, qk)
        want.update(att)
    if cfg.d_ff and cfg.d_ff % tp == 0:
        want.update({f"mlp/{k}": "split" for k in MLP})
    return want, kind


@pytest.mark.parametrize("tp", [2, 16])
@pytest.mark.parametrize("arch", C.ARCHS)
def test_split_or_gather_is_pinned_for_every_leaf(arch, tp):
    cfg = C.get_config(arch)
    for mode in MODES:
        got = decisions(arch, tp, mode)
        want, kind = expected(arch, tp, mode)
        for key, d in got.items():
            leaf = key.split("/")[-1]
            block = key.split("/")[-2] if "/" in key else ""
            if key in want:
                assert d == want[key], (arch, tp, mode, key, d)
            elif block in ("attn", "cross") and leaf in ("q_norm", "k_norm"):
                # a cross layer has no qk-norm; a self one the config's
                assert d == ("partial" if kind in ("split", "dup")
                             else "whole"), (arch, tp, mode, key)
            elif block == "mamba":
                # the SSM's channels: gathered where the rules shard them
                assert d in ("gather", "whole"), (arch, tp, mode, key)
                assert (d == "gather") == (leaf in SSM and leaf not in (
                    "wi_dt",) or (leaf == "wi_dt" and cfg.ssm_heads % tp
                                  == 0)), (arch, tp, mode, key, d)
            elif block == "moe":
                # expert stacks gathered, the router whole
                assert d == ("whole" if leaf == "router" else "gather"), \
                    (arch, tp, mode, key, d)
            elif block == "mlp":
                assert d == ("gather" if cfg.d_ff % tp == 0 else "whole")
            else:
                # norms and the encoder's final norm
                assert d == "whole", (arch, tp, mode, key, d)


def test_decisions_follow_the_specs():
    """Every leaf of every config at tp 2 / 16 in every mode: a split leaf
    is stored sharded on ``model`` exactly on the dimension its math splits,
    a gathered one sharded on ``model`` somewhere, a partial or whole one
    not on ``model``; what the math sees is the stored shard with every
    other sharded dimension gathered."""
    for arch in C.ARCHS:
        params = port_trees(arch)[0]
        for tp in (2, 16):
            for sizes in ((1, tp), (2, tp)):
                for mode in MODES:
                    part = PT.Partitioner(PT.MeshShape(("data", "model"),
                                                       sizes),
                                          C.get_config(arch), mode=mode)
                    for kp, leaf in PT.tree_paths(params):
                        pl = part.plan(PT._path_str(kp), leaf)
                        on = "model" in pl.spec.all_axes()
                        assert on == (pl.model in ("split", "gather")) or (
                            pl.model == "partial" and on
                            and mode == "decode"), (arch, kp, pl)
                        if pl.model == "split":
                            assert pl.use.all_axes() == ("model",)
                            d = list(pl.use).index("model")
                            assert pl.spec[d] == "model"
                        else:
                            assert pl.use.all_axes() == ()
                        assert set(pl.gathered) == {
                            d for d in range(len(pl.spec))
                            if pl.spec.axes(d) and pl.use.axes(d) == ()}
