"""The perf variants' run time on CPU gloo ranks: v-B's expert-parallel
MoE (an all-to-all over ``model``), v-C's sequence-sharded decode, v-D's
bf16 wire and v-E's sequence-parallel activations, each set through
``build_step`` / ``serve_steps``'s ``part_kwargs`` and held to the
reference or to the one-device math.

* **v-B.** The MoE layer alone on a ``(2, 4)`` mesh of ranks
  (``torch_mesh_probe.moe_probe``) against the reference's ``_moe_ffn_ep``
  on a ``(2, 4)`` mesh of host devices (one JAX subprocess,
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
  ``tests/test_perf_variants.py`` runs it), on the same numpy parameters
  and inputs: E = 8 (two experts a rank) and E = 2 (each expert's
  capacity split over two ranks, ``dup`` = 2). At capacity factor 1.25
  something is dropped and the output, ``lb_loss`` and ``dropped`` agree
  within 1e-5; at 8.0 the dense dispatch agrees too (1e-4). Gradients of
  ``sum(out ** 2)`` within rtol 1e-4 / atol 1e-6 (the reference's test
  allows 1e-3). ``moe_ffn_ep_plain`` (one device) against the same
  reference outputs. No rank reads another rank's experts.
* **Whole steps** (``torch_mesh_probe.variant_probe``: one train step,
  prefill + 3 decodes, every rank counting what the variants ran):
  reduced moonshot with ``moe_ep`` on ``(1, 2)`` and ``(2, 2)``, and with
  v-E too, against one device whose MoE layers are the yardstick
  (``moe_ffn_ep_plain`` at the mesh's shape); reduced qwen3-4b (2 KV
  heads) and gemma2-2b decoded with v-C on ``(1, 2)`` and ``(2, 4)``
  against one device (the reference's own mirror,
  ``test_seqshard_decode_equals_baseline``, fails in the reference); a
  bf16 reduced qwen3-4b with v-D on ``(1, 2)`` against one device within
  ``BF16_BUDGET``, its row-parallel sums on a bf16 wire, and fp32 configs
  unchanged by the flag bit for bit; reduced qwen3-4b with v-E on ``(1,
  2)`` and ``(2, 2)``. Tolerances: 1e-4 (loss, state, logits, caches),
  gradients 1e-4 / 1e-6; every rank's resident bytes its shard shapes'
  sum.
* Both drivers take the reference's ``launch/dryrun.py`` flag names.

Every run of ranks is a subprocess with its own timeout (one intra-op
thread a rank); the groups start together and each test waits for its
own.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.launch import partitioning as PT
from repro_torch.nn import moe as MOE
import torch_mesh_probe as probe
from test_torch_model_axis import Group, close

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
EP_TOL = dict(rtol=1e-5, atol=1e-5)
B, S, PROMPT, GEN = 4, 16, 8, 4
# v-D against one device, bf16 reduced qwen3-4b on (1, 2): each row-parallel
# sum rounds its two partials to bf16 before summing them in bf16 (one
# device rounds the whole sum once): up to about one bf16 ulp (2^-8
# relative) more a contraction, two a layer. Logits of size ~3 then move by
# a few hundredths; the loss (a mean) by less
BF16_BUDGET = dict(logits=0.1, loss=2e-2)

# (arch, mesh, flags, dtype)
VARIANTS = {
    "ep-12": ("moonshot-v1-16b-a3b", (1, 2), ("moe_ep",), None),
    "ep-22": ("moonshot-v1-16b-a3b", (2, 2), ("moe_ep",), None),
    "ep-seq-22": ("moonshot-v1-16b-a3b", (2, 2),
                  ("moe_ep", "seq_shard_activations"), None),
    "kv-qwen-12": ("qwen3-4b", (1, 2), ("seq_shard_kv_decode",), None),
    "kv-qwen-24": ("qwen3-4b", (2, 4), ("seq_shard_kv_decode",), None),
    "kv-gemma-12": ("gemma2-2b", (1, 2), ("seq_shard_kv_decode",), None),
    "kv-gemma-24": ("gemma2-2b", (2, 4), ("seq_shard_kv_decode",), None),
    "bf16-qwen-12": ("qwen3-4b", (1, 2), ("bf16_reduce",), "bfloat16"),
    "plain-bf16-qwen-12": ("qwen3-4b", (1, 2), (), "bfloat16"),
    "bf16-fp32-qwen-12": ("qwen3-4b", (1, 2), ("bf16_reduce",), None),
    "plain-qwen-12": ("qwen3-4b", (1, 2), (), None),
    "seq-qwen-12": ("qwen3-4b", (1, 2), ("seq_shard_activations",), None),
    "seq-qwen-22": ("qwen3-4b", (2, 2), ("seq_shard_activations",), None),
}
# what each flag's run leaves in the rank's counts
RAN = {"moe_ep": "exchange", "seq_shard_kv_decode": "kv_seq",
       "seq_shard_activations": "seq_slice"}


def config(arch, dtype):
    cfg = C.get_reduced(arch)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def inputs(arch, dtype=None):
    cfg = config(arch, dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return (cfg, {"tokens": toks[:, :-1], "targets": toks[:, 1:]},
            rng.integers(0, cfg.vocab_size, (B, PROMPT)))


# ---------------------------------------------------------------------------
# v-B, the layer alone: the same numpy parameters and inputs on both sides
# ---------------------------------------------------------------------------
EP_D, EP_F = 16, 32
# (E, k): plain EP, and each expert's capacity split over dup = 2 ranks. With
# E = 2 and k = 2 every token takes both experts, so no capacity drops: the
# dropping dup case is k = 1, whose gate is 1 whatever the router (its
# router gradient is 0 but for rounding, and is not compared)
EP_EXPERTS = ((8, 2), (2, 1), (2, 2))
EP_FACTORS = (1.25, 8.0)


def ep_cases():
    """Every (E, k, capacity factor) case: numpy parameters (normal,
    scaled by the fan-in as ``init_moe`` scales them) and ``x [4, 128,
    D]`` (normal, 0.2 around 0.1: the router leans to some experts, so
    that 1.25 drops, and the gradients of ``sum(out ** 2)`` over 512
    tokens stay of order 1, where fp32's rounding is below the 1e-6
    bound), from seeds."""
    out = []
    for e, k in EP_EXPERTS:
        rng = np.random.default_rng(e)
        d, f = EP_D, EP_F
        params = {
            "router": rng.normal(size=(d, e)) / np.sqrt(d),
            "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(e),
            "w_up": rng.normal(size=(e, d, f)) / np.sqrt(e),
            "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f),
        }
        params = {n: v.astype(np.float32) for n, v in params.items()}
        x = (0.2 * rng.normal(size=(4, 128, d)) + 0.1).astype(np.float32)
        for cf in EP_FACTORS:
            out.append(dict(e=e, k=k, cf=cf, params=params, x=x))
    return out


EP_REF = """
    import pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro import configs as RC
    from repro.launch.mesh import make_mesh
    from repro.launch.partitioning import Partitioner
    from repro.nn.common import sharding_context
    from repro.nn import moe as RMOE
    from test_torch_perf_variants import ep_cases
    mesh = make_mesh((2, 4), ('data', 'model'))
    part = Partitioner(mesh, RC.get_reduced('moonshot-v1-16b-a3b'),
                       moe_ep=True)
    out = []
    for case in ep_cases():
        e, k, cf = case['e'], case['k'], case['cf']
        p = {n: jnp.asarray(v) for n, v in case['params'].items()}
        x = jnp.asarray(case['x'])

        def ep(p):
            with sharding_context(part.logical_resolver()):
                return RMOE.moe_ffn(p, x, e, k, capacity_factor=cf)
        o, aux = jax.jit(ep)(p)
        g = jax.jit(jax.grad(lambda p: jnp.sum(ep(p)[0] ** 2)))(p)
        dense, _ = RMOE._moe_ffn_dense(p, x, e, k, cf)
        out.append(dict(out=np.asarray(o), lb_loss=float(aux['lb_loss']),
                        dropped=float(aux['dropped']), dense=np.asarray(dense),
                        grads={n: np.asarray(v) for n, v in g.items()}))
    with open(OUT, 'wb') as f:
        pickle.dump(out, f)
    """

EP_RANKS = """
    import pickle
    from repro_torch.launch.mesh import launch_ranks
    import torch_mesh_probe as probe
    from test_torch_perf_variants import ep_cases
    if __name__ == "__main__":
        out = launch_ranks(probe.moe_probe, 8, "cpu", dict(
            cases=ep_cases(), shape=(2, 4)), timeout_s=240)
        with open(OUT, "wb") as f:
            pickle.dump(out, f)
    """


def _variant_code(keys):
    return f"""
        import pickle
        from repro_torch.launch.mesh import launch_ranks
        import torch_mesh_probe as probe
        from test_torch_perf_variants import VARIANTS, inputs, GEN
        if __name__ == "__main__":
            out = {{}}
            for key in {sorted(keys)!r}:
                arch, shape, flags, dtype = VARIANTS[key]
                cfg, batch, prompts = inputs(arch, dtype)
                out[key] = launch_ranks(probe.variant_probe,
                                        shape[0] * shape[1], "cpu", dict(
                    cfg=cfg, shape=shape, batch=batch, prompts=prompts,
                    gen=GEN, part_kwargs={{f: True for f in flags}}),
                    timeout_s=240)
            with open(OUT, "wb") as f:
                pickle.dump(out, f)
        """


DRIVERS = """
    import pickle, shutil, tempfile
    from repro_torch.launch import serve as SV, train as TR
    if __name__ == "__main__":
        d = tempfile.mkdtemp()
        out = {"serve_ep": SV.main(["--device", "cpu", "--reduced", "--arch",
                                    "moonshot-v1-16b-a3b", "--model-parallel",
                                    "2", "--gen", "4", "--moe-ep"]),
               "train_seq": TR.main(["--device", "cpu", "--arch", "qwen3-4b",
                                     "--reduced", "--steps", "3", "--batch",
                                     "4", "--seq", "16", "--ckpt-every", "0",
                                     "--model-parallel", "2", "--seq-shard",
                                     "--bf16-reduce", "--ckpt-dir", d])}
        shutil.rmtree(d)
        with open(OUT, "wb") as f:
            pickle.dump(out, f)
    """


def _groups():
    keys = sorted(VARIANTS)
    return {
        "ep_ref": (EP_REF, {"XLA_FLAGS":
                            "--xla_force_host_platform_device_count=8",
                            "JAX_PLATFORMS": "cpu"}),
        "ep_ranks": (EP_RANKS, None),
        "variants_ep": (_variant_code([k for k in keys
                                       if k.startswith("ep")]), None),
        "variants_kv": (_variant_code([k for k in keys
                                       if k.startswith("kv")]), None),
        "variants_rest": (_variant_code([
            k for k in keys if not k.startswith(("ep", "kv"))]), None),
        "drivers": (DRIVERS, None),
    }


@pytest.fixture(scope="module")
def runs():
    groups = {name: Group(name, code, 420, env)
              for name, (code, env) in _groups().items()}
    yield groups
    for g in groups.values():
        g.stop()


def variant_result(runs, key):
    group = ("variants_ep" if key.startswith("ep") else "variants_kv"
             if key.startswith("kv") else "variants_rest")
    return runs[group].result()[key]


# ---------------------------------------------------------------------------
# v-B: the layer alone against the reference
# ---------------------------------------------------------------------------
EP_IDS = [f"E{e}-k{k}-cf{cf}" for e, k in EP_EXPERTS for cf in EP_FACTORS]


@pytest.mark.parametrize("i", range(len(EP_IDS)), ids=EP_IDS)
def test_ep_equals_the_reference(runs, i):
    case = ep_cases()[i]
    want = runs["ep_ref"].result()[i]
    got = runs["ep_ranks"].result()[i]
    if case["cf"] == 1.25 and case["k"] < case["e"]:
        assert want["dropped"] > 0 and got["dropped"] > 0, "nothing dropped"
    elif case["cf"] == 8.0:
        assert want["dropped"] == got["dropped"] == 0
        np.testing.assert_allclose(got["out"], want["dense"], **TOL)
    np.testing.assert_allclose(got["out"], want["out"], **EP_TOL)
    np.testing.assert_allclose(got["lb_loss"], want["lb_loss"], **EP_TOL)
    np.testing.assert_allclose(got["dropped"], want["dropped"], **EP_TOL)


@pytest.mark.parametrize("i", range(len(EP_IDS)), ids=EP_IDS)
def test_ep_gradients_equal_the_reference(runs, i):
    want = runs["ep_ref"].result()[i]["grads"]
    got = runs["ep_ranks"].result()[i]["grads"]
    names = ("router", "w_gate", "w_up", "w_down")
    for name in names[ep_cases()[i]["k"] == 1:]:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("i", range(len(EP_IDS)), ids=EP_IDS)
def test_ep_plain_equals_the_reference(runs, i):
    """``moe_ffn_ep_plain`` on one device at the ``(2, 4)`` mesh's shape:
    the reference's EP outputs; at the dropping capacity not the dense
    dispatch's."""
    case = ep_cases()[i]
    want = runs["ep_ref"].result()[i]
    torch.set_num_threads(1)
    p = {n: torch.as_tensor(v) for n, v in case["params"].items()}
    out, aux = MOE.moe_ffn_ep_plain(p, torch.as_tensor(case["x"]),
                                    case["e"], case["k"], case["cf"],
                                    tp=4, dp=2)
    np.testing.assert_allclose(out.numpy(), want["out"], **EP_TOL)
    np.testing.assert_allclose(float(aux["lb_loss"]), want["lb_loss"],
                               **EP_TOL)
    np.testing.assert_allclose(float(aux["dropped"]), want["dropped"],
                               **EP_TOL)
    if want["dropped"] > 0:
        assert not np.allclose(out.numpy(), want["dense"], **TOL)


def test_ep_ranks_hold_only_their_experts(runs):
    """The EP call on each rank reads ``E / tp`` experts (E = 8: two of
    the eight) as stored (``"ep"``); with fewer experts than ranks it
    gathers them whole (their gradients summed over the copies) and runs
    its copy's one."""
    for case, got in zip(ep_cases(), runs["ep_ranks"].result()):
        e = case["e"]
        assert got["ep_experts"] == [e // 4 if e % 4 == 0 else e] * 8, e
        want = ["partial"] + (["ep"] * 3 if e % 4 == 0 else ["partial"] * 3)
        assert got["models"] == want


# ---------------------------------------------------------------------------
# whole steps on the ranks
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def one_device(arch, dtype, ep_shape=None):
    """The one-device port's results on ``inputs(arch, dtype)``; with
    ``ep_shape`` its MoE layers are ``moe_ffn_ep_plain`` at that mesh's
    shape (the yardstick)."""
    cfg, batch, prompts = inputs(arch, dtype)
    torch.set_num_threads(1)
    dense = MOE.moe_ffn
    if ep_shape is not None:
        MOE.moe_ffn = functools.partial(MOE.moe_ffn_ep_plain,
                                        tp=ep_shape[1], dp=ep_shape[0])
    try:
        return probe.one_device(cfg, batch=batch, prompts=prompts, gen=GEN)
    finally:
        MOE.moe_ffn = dense


def want_for(key):
    arch, shape, flags, dtype = VARIANTS[key]
    return one_device(arch, dtype, shape if "moe_ep" in flags else None)


FP32_KEYS = sorted(k for k, v in VARIANTS.items() if v[3] is None)


@pytest.mark.parametrize("key", FP32_KEYS)
def test_variant_equals_one_device(runs, key):
    """Loss, every gradient leaf, the new state, the logits and caches of
    prefill + 3 decodes, and the greedy tokens: one device's (v-B's
    yardstick's under ``moe_ep``); the parameters drawn on the ranks,
    gathered back, one device's bit for bit."""
    want, got = want_for(key), variant_result(runs, key)
    assert all(np.array_equal(a, b) for a, b in
               zip(got["params"], want["params"])), "params not bit for bit"
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], **TOL)
    close(got["grads"], want["grads"], GRAD_TOL, "grads")
    close(got["state"], want["state"], TOL, "state")
    close(got["logits"], want["logits"], TOL, "logits")
    close(got["caches"], want["caches"], TOL, "caches")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("key", sorted(VARIANTS))
def test_variant_ran_on_every_rank(runs, key):
    """Each flag's path ran on every rank (v-B's all-to-alls, v-C's
    decodes, v-E's sequence slices), and no rank ran a path whose flag is
    off."""
    arch, shape, flags, _ = VARIANTS[key]
    counts = variant_result(runs, key)["counts"]
    assert len(counts) == shape[0] * shape[1]
    layers = C.get_reduced(arch).num_layers
    for c in counts:
        for flag, name in RAN.items():
            assert (c[name] > 0) == (flag in flags), (key, name, c)
        if "seq_shard_kv_decode" in flags:
            assert c["kv_seq"] == layers * (GEN - 1), c
        if "moe_ep" in flags:
            # every MoE call of the step (2 forwards), prefill and decodes
            assert c["ep_calls"] == layers * (2 + 1 + GEN - 1), c
            assert c["exchange"] == 2 * c["ep_calls"], c


@pytest.mark.parametrize("key", sorted(VARIANTS))
def test_variant_ranks_hold_exactly_their_shards(runs, key):
    """Before and after the step, on every rank: the resident parameter
    and moment bytes are the sum of the rules' shard shapes, each leaf
    exactly its shard; under ``moe_ep`` the EP calls read the rank's
    ``E / tp`` experts only."""
    arch, shape, flags, _ = VARIANTS[key]
    got = variant_result(runs, key)
    for res in (got["resident"], got["resident_after"]):
        assert len(res) == shape[0] * shape[1]
        for r in res:
            for part in ("params", "moments"):
                assert r[part]["bytes"] == r[part]["expected"], (r, part)
                assert r[part]["exact"] == 1, (r, part)
    if "moe_ep" in flags:
        e = C.get_reduced(arch).num_experts
        assert all(c["ep_experts"] == e // shape[1] for c in got["counts"])


def test_bf16_wire_within_its_budget(runs):
    """v-D on a bf16 reduced qwen3-4b, (1, 2): loss and logits within
    ``BF16_BUDGET`` of one device's, no further than the plain bf16 mesh
    plus the budget, and the same greedy tokens."""
    want = one_device("qwen3-4b", "bfloat16")
    got = variant_result(runs, "bf16-qwen-12")
    plain = variant_result(runs, "plain-bf16-qwen-12")
    assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) \
        <= BF16_BUDGET["loss"]
    for g, p, w in zip(got["logits"], plain["logits"], want["logits"]):
        assert np.all(np.isfinite(g))
        assert float(np.abs(g - w).max()) <= BF16_BUDGET["logits"]
        assert float(np.abs(p - w).max()) <= BF16_BUDGET["logits"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_bf16_wire_carries_bf16(runs):
    """With ``bf16_reduce`` every ``wo`` / ``w_down`` sum of the bf16
    config is a bf16 all-reduce (2 a layer in each forward: the step's
    two, the prefill, the decodes); without it there is none, and the
    same sums go in fp32."""
    layers = C.get_reduced("qwen3-4b").num_layers
    n = 2 * layers * (2 + 1 + GEN - 1)
    on = variant_result(runs, "bf16-qwen-12")["counts"]
    off = variant_result(runs, "plain-bf16-qwen-12")["counts"]
    for a, b in zip(on, off):
        assert a["all_reduce"].get("bfloat16", 0) == n, a
        assert b["all_reduce"].get("bfloat16", 0) == 0, b
        assert b["all_reduce"]["float32"] == a["all_reduce"]["float32"] + n


def test_bf16_reduce_leaves_fp32_bit_for_bit(runs):
    """On an fp32 config ``bf16_reduce`` changes nothing: every result of
    the (1, 2) probe bit for bit the flagless one's."""
    a = variant_result(runs, "bf16-fp32-qwen-12")
    b = variant_result(runs, "plain-qwen-12")
    assert a["metrics"] == b["metrics"]
    for key in ("grads", "state", "logits", "caches"):
        assert all(np.array_equal(x, y) for x, y in zip(a[key], b[key])), key
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_drivers_take_the_variant_flags(runs):
    """``serve.main`` with ``--moe-ep`` and ``train.main`` with
    ``--seq-shard --bf16-reduce``, both ``--model-parallel 2 --device
    cpu``."""
    out = runs["drivers"].result()
    assert out["serve_ep"].shape == (4, 4)
    assert len(out["train_seq"]) == 3 and all(np.isfinite(out["train_seq"]))


# ---------------------------------------------------------------------------
# the decisions, without ranks
# ---------------------------------------------------------------------------
def part_on(arch, sizes, mode="train", **flags):
    return PT.Partitioner(PT.MeshShape(("data", "model"), sizes),
                          C.get_config(arch), mode=mode, **flags)


@pytest.mark.parametrize("sizes,batch,seq,want", [
    ((1, 16), 4, 2048, 1),      # 64 experts: 4 a rank
    ((16, 16), 16, 1, 0),       # one token a rank: 1 % 16 != 0, dense
    ((1, 16), 4, 1, 0),         # 4 tokens over 16 ranks: dense
    ((2, 16), 3, 2048, 0),      # the batch shards over nothing: dense
    ((1, 128), 4, 2048, 2),     # 64 experts over 128 ranks: 2 copies
    ((1, 48), 4, 2048, 0),      # neither divides the other: dense
])
def test_ep_branch_as_the_reference_takes_it(sizes, batch, seq, want):
    """``ep_dup``: the reference's conditions (``repro/nn/moe.py:57-62``,
    ``:163-164``) on moonshot's 64 experts."""
    part = part_on("moonshot-v1-16b-a3b", sizes, moe_ep=True)
    assert part.ep_dup(batch, seq) == want
    assert part_on("moonshot-v1-16b-a3b", sizes).ep_dup(batch, seq) == 0


def test_seq_and_kv_decisions():
    """v-E where the reference's activation spec puts ``model`` on the
    sequence (not at one token, not where the batch does not shard); v-C
    only in a decode over a cache length ``tp`` divides."""
    on = part_on("qwen3-4b", (2, 2), seq_shard_activations=True)
    assert on.seq_split(4, 16) and not on.seq_split(4, 1)
    assert not on.seq_split(3, 16)      # the sequence shards over data
    assert not on.seq_split(4, 15)
    assert not part_on("qwen3-4b", (2, 2)).seq_split(4, 16)
    dec = part_on("qwen3-4b", (1, 2), "decode", seq_shard_kv_decode=True)
    assert dec.run_for(4, 1, 12).kv_seq and not dec.run_for(4, 1, 13).kv_seq
    pre = part_on("qwen3-4b", (1, 2), "prefill", seq_shard_kv_decode=True)
    assert not pre.run_for(4, 1, 12).kv_seq
    assert not part_on("qwen3-4b", (1, 1), "decode",
                       seq_shard_kv_decode=True).run_for(4, 1, 12).kv_seq


def test_variant_plans():
    """The plans a run gives: v-B's router partial and experts used as
    stored (or gathered and summed with copies), v-E's stream norms
    partial (the encoder's whole), v-C's projections and ``wo`` split on
    heads as stored (q, k and v gathered over heads instead), and the
    self-attention cache used split on the sequence."""
    import repro_torch.lm.model as LM
    part = part_on("moonshot-v1-16b-a3b", (1, 16), moe_ep=True)
    run = part.run_for(4, 2048)
    leaf = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    e, d, f = 64, 2048, 1408
    assert part.plan("stages/0/l0/moe/router", leaf(1, d, e),
                     run).model == "partial"
    pl = part.plan("stages/0/l0/moe/w_gate", leaf(1, e, d, f), run)
    assert pl.model == "ep" and pl.use.axes(1) == ("model",)
    assert part.plan("stages/0/l0/moe/w_gate", leaf(1, e, d, f)).model \
        == "gather"
    dup = part_on("moonshot-v1-16b-a3b", (1, 128), moe_ep=True)
    assert dup.plan("stages/0/l0/moe/w_down", leaf(1, e, f, d),
                    dup.run_for(4, 2048)).model == "partial"
    seq = PT.Run(seq=True)
    wp = part_on("whisper-medium", (1, 4), seq_shard_activations=True)
    assert wp.plan("stages/0/l0/norm", leaf(1, 1024), seq).model == "partial"
    assert wp.plan("final_norm", leaf(1024), seq).model == "partial"
    assert wp.plan("encoder/stages/0/l0/norm", leaf(1, 1024),
                   seq).model == "whole"
    kv = part_on("qwen3-4b", (1, 2), "decode", seq_shard_kv_decode=True)
    r = kv.run_for(4, 1, 2080)
    cfg = C.get_config("qwen3-4b")
    h, k, hd, d = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                   cfg.d_model)
    assert kv.plan("stages/0/l0/attn/wq", leaf(1, d, h, hd), r).model \
        == "split"
    assert kv.plan("stages/0/l0/attn/wk", leaf(1, d, k, hd), r).model \
        == "split"
    assert kv.plan("stages/0/l0/attn/wo", leaf(1, h, hd, d), r).model \
        == "split"
    cache = LM.TransformerLM(cfg, device="meta").init_cache(4, 2080)
    cp = kv.cache_plan("0/0/attn/k", cache[0][0]["attn"]["k"], r)
    assert cp.model == "split" and cp.use.axes(2) == ("model",)
    assert kv.cache_plan("0/0/attn/k", cache[0][0]["attn"]["k"]).model \
        == "gather"
    res = kv.logical_resolver(4, 1, 2080)
    assert res.run == r and not res.attn_split and res.splits("wo")
    assert res.q_split and res.kv_heads_split


def test_every_flag_is_the_identity_on_one_rank():
    """On a ``(1, 1)`` mesh the four flags give the flagless step's state
    bit for bit (moonshot, its MoE on the EP branch of one rank)."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.lm.config import ShapeCell
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves
    torch.set_num_threads(1)
    cfg, batch, _ = inputs("moonshot-v1-16b-a3b")
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    flags = dict(moe_ep=True, seq_shard_kv_decode=True, bf16_reduce=True,
                 seq_shard_activations=True)
    states = []
    for kw in ({}, flags):
        bundle = ST.build_step(cfg, ShapeCell("t", S, B, "train"), mesh=mesh,
                               part_kwargs=kw)
        assert bundle.partitioner.run_for(B, S).ep == (1 if kw else 0)
        state = ST.init_state(AdamW(), bundle.model, bundle.partitioner,
                              torch.Generator().manual_seed(0))
        state, _ = bundle.fn(state, {k: torch.as_tensor(v)
                                     for k, v in batch.items()})
        states.append(tree_leaves(state))
    assert all(torch.equal(a, b) for a, b in zip(*states))


def test_variant_flags_parse_as_the_reference_names_them():
    import argparse
    ap = argparse.ArgumentParser()
    PT.add_variant_flags(ap)
    assert PT.variant_kwargs(ap.parse_args([])) is None
    assert PT.variant_kwargs(ap.parse_args(
        ["--moe-ep", "--seq-shard-kv", "--bf16-reduce", "--seq-shard"])) == \
        dict(moe_ep=True, seq_shard_kv_decode=True, bf16_reduce=True,
             seq_shard_activations=True)
