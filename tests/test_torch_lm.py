"""The LM serving slice of the PyTorch port against the JAX reference, on
the CPU: the config registry, the ``nn`` primitives, self-attention with
and without a KV cache, cross-attention with and without its cache, the
encoder, ``TransformerLM`` prefill / decode of the dense, MoE, SSM,
hybrid, vision-language and encoder-decoder configs (parameters carried
over by ``params_from_reference``, the stubbed frontends drawn with
numpy), the arch smoke of ``tests/test_lm_archs.py``, the cross K/V cache
of ``tests/test_perf_variants.py``, and the serving driver. Tolerances: rtol = atol = 1e-4 in fp32 (the port's
card-vs-CPU bound), the reference's own 2e-2 / 5e-2 where its decode check
compares two paths of one model.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.lm.config import SHAPES as REF_SHAPES
from repro.lm.model import TransformerLM as RefLM
from repro.nn import attention as RA
from repro.nn import common as RN
from repro.nn import mlp as RM
from repro_torch import configs as C
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.lm.config import SHAPES, LayerSpec, Stage
from repro_torch.lm.model import TransformerLM, params_from_reference
from repro_torch.nn import attention as A
from repro_torch.nn import common as N
from repro_torch.nn import mlp as M

RNG = np.random.default_rng(0)
DENSE = ["qwen3-4b", "gemma2-2b", "gemma3-4b", "qwen3-14b"]
MOE_SSM = ["moonshot-v1-16b-a3b", "grok-1-314b", "mamba2-780m",
           "jamba-v0.1-52b"]
CROSS = ["whisper-medium", "llama-3.2-vision-11b"]
PORTED = DENSE + MOE_SSM + CROSS
TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def frontend_np(cfg, b, rng=RNG):
    """The reference drivers' stubbed frontend of ``cfg`` (float32 normal),
    or ``None`` for a config without cross-attention."""
    if cfg.encoder_layers:
        return rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend_tokens:
        return rng.normal(size=(b, cfg.frontend_tokens,
                                cfg.frontend_dim)).astype(np.float32)
    return None


def as_jax(x):
    return None if x is None else jnp.asarray(x)


def as_torch(x):
    return None if x is None else torch.from_numpy(x)


@pytest.fixture(scope="module")
def models():
    """Reference and port models of each ported reduced config, on the same
    parameters (the reference's init carried over)."""
    out = {}
    for arch in PORTED:
        rcfg = RC.get_reduced(arch)
        rm = RefLM(rcfg, remat=False)
        rp = rm.init(jax.random.key(0))
        pnp = jax.tree_util.tree_map(np.asarray, rp)
        cfg = C.get_reduced(arch)
        out[arch] = (rm, rp, TransformerLM(cfg, device="cpu"),
                     params_from_reference(pnp, cfg, "cpu"))
    return out


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_registry_lists_the_reference_archs():
    assert C.ARCHS == RC.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    cfg, rcfg = C.get_config(arch), RC.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(C.get_reduced(arch)) == \
        dataclasses.asdict(RC.get_reduced(arch))
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert C.applicable_shapes(arch) == RC.applicable_shapes(arch)
    assert dataclasses.asdict(C.shrink(cfg, d_model=32)) == \
        dataclasses.asdict(RC.shrink(rcfg, d_model=32))


# ---------------------------------------------------------------------------
# nn primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm_equals_the_reference(plus_one):
    x = RNG.normal(size=(2, 5, 16)).astype(np.float32)
    w = RNG.normal(size=(16,)).astype(np.float32)
    want = RN.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, plus_one)
    close(N.rms_norm(t(x), t(w), 1e-6, plus_one), want)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_equals_the_reference(theta):
    x = RNG.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(40, 47, dtype=np.int32)
    want = RN.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(N.rope(t(x), torch.from_numpy(pos), theta), want)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap_equals_the_reference(cap):
    x = (RNG.normal(size=(4, 9)) * 50).astype(np.float32)
    close(N.softcap(t(x), cap), RN.softcap(jnp.asarray(x), cap))


def test_mlp_equals_the_reference():
    rp = RM.init_mlp(jax.random.key(1), 16, 32, jnp.float32)
    x = RNG.normal(size=(2, 5, 16)).astype(np.float32)
    want = RM.mlp(rp, jnp.asarray(x))
    close(M.mlp({k: t(v) for k, v in rp.items()}, t(x)), want)


def test_init_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    cfg = C.get_reduced("qwen3-4b")
    p = A.init_attention(g, cfg, torch.float32, lead=(3,))
    rp = RA.init_attention(jax.random.key(0), RC.get_reduced("qwen3-4b"),
                           jnp.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: (3,) + tuple(v.shape) for k, v in rp.items()}
    w = N.dense_init((4096, 64), torch.float32, g)
    assert abs(float(w.std()) - 4096 ** -0.5) < 1e-3
    assert N.dense_init((8, 4), torch.float32, None).device.type == "meta"


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _attn_case(arch):
    rcfg, cfg = RC.get_reduced(arch), C.get_reduced(arch)
    spec = cfg.stages[0].pattern[0]
    rspec = rcfg.stages[0].pattern[0]
    rp = RA.init_attention(jax.random.key(3), rcfg, jnp.float32)
    return rcfg, cfg, rspec, spec, rp, {k: t(v) for k, v in rp.items()}


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-4b"])
def test_attention_without_cache_equals_the_reference(arch):
    rcfg, cfg, rspec, spec, rp, p = _attn_case(arch)
    x = RNG.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    pos = np.arange(11, dtype=np.int32)
    want, _ = RA.attention(rp, jnp.asarray(x), rcfg, rspec, jnp.asarray(pos))
    got, cache = A.attention(p, t(x), cfg, spec, torch.from_numpy(pos))
    assert cache is None
    close(got, want)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-4b"])
@pytest.mark.parametrize("start,q_len", [(0, 9), (9, 1), (13, 1)])
def test_attention_with_cache_equals_the_reference(arch, start, q_len):
    """A prefill (at 0) or a decode step into a cache of 16 slots whose
    earlier slots hold other keys: the write lands at ``cache_index`` in
    place and the queries attend over the whole cache."""
    rcfg, cfg, rspec, spec, rp, p = _attn_case(arch)
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    kc = RNG.normal(size=(2, 16, kv, hd)).astype(np.float32)
    vc = RNG.normal(size=(2, 16, kv, hd)).astype(np.float32)
    x = RNG.normal(size=(2, q_len, cfg.d_model)).astype(np.float32)
    pos = np.arange(start, start + q_len, dtype=np.int32)
    want, wcache = RA.attention(
        rp, jnp.asarray(x), rcfg, rspec, jnp.asarray(pos),
        kv_cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        cache_index=jnp.int32(start))
    cache = {"k": t(kc), "v": t(vc)}
    kbuf = cache["k"]
    got, gcache = A.attention(p, t(x), cfg, spec, torch.from_numpy(pos),
                              kv_cache=cache, cache_index=start)
    close(got, want)
    assert gcache["k"] is kbuf                       # written in place
    close(gcache["k"], wcache["k"])
    close(gcache["v"], wcache["v"])


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-11b",
                                  "qwen3-4b"])
def test_cross_attention_equals_the_reference(arch):
    """A cross-attention layer (no qk-norm, even in qwen3's config; no
    RoPE; every query sees every memory position) over a memory of 16:
    ``memory=`` with ``store_cross=True`` for 9 queries, then one query at
    position 9 from ``cross_kv=`` alone, each within 1e-4 of the
    reference's, the cross K/V the reference's. The port's prefill form
    writes them in place into a preallocated cache."""
    rcfg, cfg = RC.get_reduced(arch), C.get_reduced(arch)
    rspec, spec = LayerSpec(kind="cross_attn"), LayerSpec(kind="cross_attn")
    rp = RA.init_attention(jax.random.key(5), rcfg, jnp.float32, cross=True)
    p = {k: t(v) for k, v in rp.items()}
    assert sorted(p) == sorted(A.init_attention(
        None, cfg, torch.float32, cross=True)) == ["wk", "wo", "wq", "wv"]
    mem = RNG.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    x = RNG.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    x1 = RNG.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    want, wkv = RA.attention(rp, jnp.asarray(x), rcfg, rspec,
                             jnp.arange(9, dtype=jnp.int32),
                             memory=jnp.asarray(mem), store_cross=True)
    got, kv = A.attention(p, t(x), cfg, spec, torch.arange(9),
                          memory=t(mem), store_cross=True)
    close(got, want)
    for name in ("k", "v"):
        close(kv[name], wkv[name])
    heads = (cfg.num_kv_heads, cfg.resolved_head_dim)
    cache = {n: torch.zeros((2, 16) + heads) for n in ("k", "v")}
    kbuf = cache["k"]
    got, kv = A.attention(p, t(x), cfg, spec, torch.arange(9),
                          memory=t(mem), cross_kv=cache, store_cross=True,
                          cache_index=0)
    assert kv["k"] is kbuf                           # written in place
    close(got, want)
    close(kbuf, wkv["k"])
    want, none = RA.attention(rp, jnp.asarray(x1), rcfg, rspec,
                              jnp.asarray([9], jnp.int32), cross_kv=wkv)
    got, ret = A.attention(p, t(x1), cfg, spec, torch.tensor([9]),
                           cross_kv=cache, cache_index=9)
    assert none is None and ret is None
    close(got, want)


def test_encoder_equals_the_reference():
    """whisper's encoder (non-causal self-attention layers with RoPE at
    ``0..M-1``, their MLPs, the final norm) against the reference's
    ``_encode`` on the same frames, 1e-4; a causal encoder would not be."""
    rcfg, cfg = RC.get_reduced("whisper-medium"), C.get_reduced(
        "whisper-medium")
    rm = RefLM(rcfg, remat=False)
    rp = rm.init(jax.random.key(2))
    m = TransformerLM(cfg, device="cpu")
    p = params_from_reference(jax.tree_util.tree_map(np.asarray, rp), cfg,
                              "cpu")
    frames = frontend_np(cfg, 2)
    want = rm._encode(rp, jnp.asarray(frames))
    got = m._encode(p, t(frames))
    close(got, want)
    assert cfg.encoder_layers == 2
    causal, _ = m._run_stage(Stage((LayerSpec(),), cfg.encoder_layers),
                             p["encoder"]["stages"][0], t(frames),
                             torch.arange(frames.shape[1]), None)
    causal = N.rms_norm(causal, p["encoder"]["final_norm"], cfg.norm_eps)
    assert float((causal - got).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_equal_the_reference(models, arch):
    """prefill of 12 tokens into a cache of 16, then three decode steps:
    logits within 1e-4 of the reference's at every step, and the caches
    (K/V, the cross K/V, Mamba's conv window and state) the reference's,
    entry for entry."""
    rm, rp, m, p = models[arch]
    b, s = 2, 12
    toks = RNG.integers(0, m.cfg.vocab_size, (b, s + 3))
    fe = frontend_np(m.cfg, b)
    rl, rc = rm.prefill(rp, jnp.asarray(toks[:, :s], jnp.int32),
                        frontend=as_jax(fe), cache_len=s + 4)
    lg, caches = m.prefill(p, torch.from_numpy(toks[:, :s]),
                           frontend=as_torch(fe), cache_len=s + 4)
    assert lg.shape == (b, 1, m.vp) and lg.dtype == torch.float32
    close(lg, rl)
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        rl, rc = rm.decode_step(rp, jnp.asarray(tok, jnp.int32), s + i, rc)
        lg, caches = m.decode_step(p, torch.from_numpy(tok), s + i, caches)
        close(lg, rl)
    for stage, rstage in zip(caches, rc):
        for layer, rlayer in zip(stage, rstage):
            assert sorted(layer) == sorted(rlayer)
            for kind, entry in layer.items():
                for name, buf in entry.items():
                    close(buf, rlayer[kind][name])


@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_full_forward(models, arch):
    """The reference's ``test_decode_matches_full_forward`` on the port:
    prefill(S) + decode(S) logits == forward(S+1) last logits (capacity
    factor 8, as there: no MoE drops in either path)."""
    _, _, model, params = models[arch]
    model = TransformerLM(dataclasses.replace(model.cfg, capacity_factor=8.0),
                          device="cpu")
    b, s = 2, 12
    toks = torch.from_numpy(RNG.integers(0, model.cfg.vocab_size,
                                         (b, s + 1)))
    fe = as_torch(frontend_np(model.cfg, b))
    hidden = model.backbone(params, toks, frontend=fe)
    lg_pre, caches = model.prefill(params, toks[:, :s], frontend=fe,
                                   cache_len=s + 4)
    close(lg_pre, model.logits(params, hidden[:, s - 1:s]).numpy(),
          rtol=2e-2, atol=2e-2)
    lg_dec, _ = model.decode_step(params, toks[:, s:s + 1], s, caches,
                                  frontend=fe)
    close(lg_dec, model.logits(params, hidden[:, -1:]).numpy(),
          rtol=5e-2, atol=5e-2)


def test_cross_kv_cache_consistency(models):
    """``tests/test_perf_variants.py::test_cross_kv_cache_consistency`` on
    the port: after a prefill with the frontend, a decode step given no
    frontend reads the cross K/V from the cache and continues the full
    forward (within the reference's 5e-2)."""
    for arch in CROSS:
        _, _, model, params = models[arch]
        b, s = 2, 12
        toks = torch.from_numpy(RNG.integers(0, model.cfg.vocab_size,
                                             (b, s + 1)))
        fe = as_torch(frontend_np(model.cfg, b))
        want = model.logits(params, model.backbone(params, toks,
                                                   frontend=fe)[:, -1:])
        _, caches = model.prefill(params, toks[:, :s], frontend=fe,
                                  cache_len=s + 4)
        got, _ = model.decode_step(params, toks[:, s:], s, caches)
        assert float((got - want).abs().max()) < 5e-2, arch


@pytest.mark.parametrize("arch", CROSS)
def test_cross_configs_need_a_frontend(models, arch):
    """A config with cross-attention raises ``ValueError`` in ``prefill``,
    ``backbone`` and ``loss`` without its frontend (the reference would run
    its cross layers as self-attention); a config without cross-attention
    needs none."""
    _, _, m, p = models[arch]
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="frontend"):
        m.prefill(p, toks)
    with pytest.raises(ValueError, match="frontend"):
        m.backbone(p, toks)
    with pytest.raises(ValueError, match="frontend"):
        m.loss(p, {"tokens": toks, "targets": toks})
    assert m.needs_frontend
    assert not models["jamba-v0.1-52b"][2].needs_frontend


def test_loss_runs_and_reports_its_metrics(models):
    """The loss of a ported config runs (``tests/test_torch_lm_train.py``
    holds every config's to the reference) and reports ``nll`` and
    ``moe_aux``."""
    _, _, m, p = models["qwen3-4b"]
    loss, metrics = m.loss(p, {"tokens": torch.zeros(1, 4, dtype=torch.long),
                               "targets": torch.ones(1, 4, dtype=torch.long)})
    assert bool(torch.isfinite(loss)) and set(metrics) == {"nll", "moe_aux"}


@pytest.mark.parametrize("arch", CROSS)
def test_frontend_is_cast_to_the_model_dtype(arch):
    """A float32 frontend given to a bf16 model is cast on entry: the
    memory, and so the cross cache, stays bf16 (the reference would promote
    the encoder to float32); the logits match the same model fed the
    frontend already cast."""
    cfg = dataclasses.replace(C.get_reduced(arch), dtype="bfloat16")
    m = TransformerLM(cfg, device="cpu")
    p = m.init()
    fe = torch.from_numpy(frontend_np(cfg, 2))
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 6)))
    lg, caches = m.prefill(p, toks, frontend=fe, cache_len=8)
    cross = [layer["cross"] for st in caches for layer in st
             if "cross" in layer]
    assert cross and all(e[n].dtype == torch.bfloat16 for e in cross
                         for n in ("k", "v"))
    assert bool(torch.isfinite(lg).all())
    lg2, _ = m.prefill(p, toks, frontend=fe.to(torch.bfloat16), cache_len=8)
    assert torch.equal(lg, lg2)


def test_port_init_has_the_reference_tree(models):
    for arch in PORTED:
        _, rp, m, _ = models[arch]
        got = m.init(torch.Generator().manual_seed(1))
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
        assert jax.tree_util.tree_map(lambda a: tuple(a.shape), got) == want
        assert all(x.dtype == torch.float32
                   for x in jax.tree_util.tree_leaves(got))


FP32_LEAVES = {"router", "A_log", "dt_bias", "D_skip"}


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "grok-1-314b"])
def test_params_from_reference_keeps_fp32_leaves_in_bf16(arch):
    """In a bf16 config the router and Mamba's ``A_log``, ``dt_bias`` and
    ``D_skip`` stay fp32 (the reference's values exactly), as the port's
    own init makes them; every other leaf is bf16."""
    rcfg = dataclasses.replace(RC.get_reduced(arch), dtype="bfloat16")
    cfg = dataclasses.replace(C.get_reduced(arch), dtype="bfloat16")
    rp = RefLM(rcfg).init(jax.random.key(0))
    got = params_from_reference(jax.tree_util.tree_map(np.asarray, rp), cfg,
                                "cpu")
    own = TransformerLM(cfg, device="cpu").init()
    paths = jax.tree_util.tree_leaves_with_path(rp)
    leaves = jax.tree_util.tree_leaves(got)
    assert len(paths) == len(leaves) == len(jax.tree_util.tree_leaves(own))
    seen = set()
    for (path, want), g, o in zip(paths, leaves,
                                  jax.tree_util.tree_leaves(own)):
        name = getattr(path[-1], "key", None)
        fp32 = name in FP32_LEAVES
        seen |= {name} & FP32_LEAVES
        assert g.dtype == o.dtype == (torch.float32 if fp32
                                      else torch.bfloat16), path
        assert str(want.dtype) == ("float32" if fp32 else "bfloat16"), path
        if fp32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert seen == (FP32_LEAVES if arch.startswith("jamba") else {"router"})


@pytest.mark.parametrize("arch", MOE_SSM + CROSS)
def test_arch_smoke_forward_and_train_step(arch):
    """``tests/test_lm_archs.py::test_arch_smoke_forward_and_train_step`` on
    the port: the port's own init, forward shapes, finite hidden states and
    loss, and one SGD step that keeps the loss finite."""
    cfg = C.get_reduced(arch)
    model = TransformerLM(cfg, device="cpu", remat=False)
    params = model.init(torch.Generator().manual_seed(0))
    b, s = 2, 16
    batch = {"tokens": torch.from_numpy(RNG.integers(0, cfg.vocab_size,
                                                     (b, s))),
             "targets": torch.from_numpy(RNG.integers(0, cfg.vocab_size,
                                                      (b, s)))}
    if arch in CROSS:
        batch["frontend"] = as_torch(frontend_np(cfg, b))
    hidden = model.backbone(params, batch["tokens"],
                            frontend=batch.get("frontend"))
    assert hidden.shape == (b, s, cfg.d_model)
    assert bool(torch.isfinite(hidden).all())
    loss, metrics = model.loss(params, batch)
    assert bool(torch.isfinite(loss))
    assert (float(metrics["moe_aux"]) > 0) == (cfg.num_experts > 0)
    from repro_torch.optim.adamw import tree_leaves, tree_like
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    grads = torch.autograd.grad(model.loss(tree_like(params, leaves),
                                           batch)[0], leaves)
    params2 = tree_like(params, [p - 1e-2 * g for p, g in zip(leaves,
                                                              grads)])
    with torch.no_grad():
        loss2, _ = model.loss(params2, batch)
    assert bool(torch.isfinite(loss2))


def test_params_from_reference_checks_the_tree(models):
    _, rp, m, _ = models["gemma2-2b"]
    pnp = jax.tree_util.tree_map(np.asarray, rp)
    bad = dict(pnp, embed=pnp["embed"][:, :3])
    with pytest.raises(ValueError, match="embed"):
        params_from_reference(bad, m.cfg, "cpu")
    with pytest.raises(ValueError, match="lm_head"):
        params_from_reference(dict(pnp, lm_head=pnp["embed"]), m.cfg, "cpu")


def test_the_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(C.get_reduced("gemma2-2b"))


# ---------------------------------------------------------------------------
# the serving driver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-4b", "mamba2-780m",
                                  "jamba-v0.1-52b", "whisper-medium",
                                  "llama-3.2-vision-11b"])
def test_driver_matches_the_reference_model(arch):
    """``--device cpu --reduced``: the port prefills ``prompt_len`` tokens
    into a cache of ``prompt_len + gen`` and decodes from ``prompt_len``;
    the reference model called that way, on the port's parameters, prompts
    and stubbed frontend, gives the same greedy tokens."""
    b, plen, gen = 3, 10, 6
    lines = []
    out = serve.serve(arch, reduced=True, batch=b, prompt_len=plen, gen=gen,
                      device="cpu", seed=5, log=lines.append)
    assert out["tokens"].shape == (b, gen) and len(lines) == 2
    assert "tok/s" in lines[1] and "sample row" in lines[1]
    cfg = RC.get_reduced(arch)
    m = TransformerLM(C.get_reduced(arch), device="cpu")
    rp = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()),
                                m.init(torch.Generator().manual_seed(5)))
    rm = RefLM(cfg, remat=False)
    assert (out["frontend"] is None) == (arch not in CROSS)
    lg, caches = rm.prefill(rp, jnp.asarray(out["prompts"], jnp.int32),
                            frontend=as_jax(out["frontend"]),
                            cache_len=plen + gen)
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    want = [np.asarray(tok)]
    for i in range(gen - 1):
        lg, caches = rm.decode_step(rp, tok, plen + i, caches)
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(out["tokens"], np.concatenate(want, 1))


def test_driver_main_runs_on_the_cpu_and_counts_no_launch():
    ops.reset_launch_counts()
    toks = serve.main(["--device", "cpu", "--reduced", "--arch", "gemma3-4b",
                       "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    assert toks.shape == (2, 3)
    assert not any(ops.launch_counts().values())


def test_driver_keeps_each_steps_logits():
    out = serve.serve("qwen3-14b", reduced=True, batch=2, prompt_len=4,
                      gen=4, device="cpu", keep_logits=True,
                      log=lambda m: None)
    assert len(out["logits"]) == 4
    got = np.stack([lg.argmax(-1).numpy() for lg in out["logits"]], 1)
    np.testing.assert_array_equal(got, out["tokens"])


def test_driver_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced"])


def test_layer_spec_is_the_reference_dataclass_copy():
    assert dataclasses.asdict(LayerSpec(window=8)) == \
        dataclasses.asdict(RC.get_reduced("gemma2-2b").stages[0].pattern[0])
