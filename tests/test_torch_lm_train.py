"""The LM training slice of the PyTorch port against the JAX reference.

``TransformerLM.loss`` and the gradient of every parameter leaf are held
to ``jax.value_and_grad`` of the reference's ``TransformerLM.loss`` for
the four dense, the four MoE / SSM / hybrid and the two cross-attention
reduced configs (fp32, B 2, S 32, four loss chunks; the MoE configs' loss
with its ``MOE_AUX_COEF * aux / num_layers`` term; the cross-attention
configs' batch with a stubbed frontend, whose gradient reaches the encoder
and ``frontend_proj``), on the reference's parameters carried across by
``params_from_reference``. K10
under autograd (``flash_attention.FlashAttention``: its forward, and the
plain version's VJP recomputed from ``q, k, v``) is held to ``jax.vjp`` of
the reference's attention core. ``remat=True`` equals ``remat=False`` bit
for bit, and one ``launch.steps.build_step`` train step equals the
reference's step math without a mesh (``value_and_grad`` of the loss,
then ``repro.optim.AdamW.update``).

Bitwise checks run with one intra-op thread: the embedding gather's
backward (``index_put_`` with ``accumulate=True``) is not repeatable on
the CPU with several. The card's side (K10's kernel forward inside
autograd) is checked by ``chip_smoke.py`` phase 18.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import configs as RC
from repro.launch.steps import input_specs as ref_input_specs
from repro.lm.config import ShapeCell as RefShapeCell
from repro.lm.model import TransformerLM as RefLM
from repro.optim import AdamW as RefAdamW
from repro.optim import cosine_schedule as ref_cosine
from repro_torch import configs as C
from repro_torch.kernels import flash_attention as F
from repro_torch.launch import steps
from repro_torch.lm.config import SHAPES, ShapeCell
from repro_torch.lm.model import (MOE_AUX_COEF, TransformerLM,
                                  params_from_reference)
from repro_torch.optim.adamw import tree_leaves, tree_like
from test_flash import ref_attention

DENSE = ["qwen3-4b", "gemma2-2b", "gemma3-4b", "qwen3-14b"]
MOE_SSM = ["moonshot-v1-16b-a3b", "grok-1-314b", "mamba2-780m",
           "jamba-v0.1-52b"]
CROSS = ["whisper-medium", "llama-3.2-vision-11b"]
PORTED = DENSE + MOE_SSM + CROSS
B, S, CHUNK = 2, 32, 8
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# The configs whose gradients were read past GRAD_TOL, each with its own
# bound. jamba's reduced config is 8 layers deep (7 Mamba, 4 MoE): there the
# fp32 rounding of two correct implementations reaches 4.0e-6 on leaves
# whose largest entry is ~1 (14 of ~1e5 entries past 1e-6), as it does for
# mamba2 or moonshot cut to 8 layers (1.4e-5 / 7.4e-6 of the largest
# entry); one Mamba or MoE layer stays within 1e-6 of its largest entry
DEEP_GRAD_TOL = {"jamba-v0.1-52b": dict(rtol=1e-4, atol=1e-5)}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def batch_np(cfg, seed=1, b=B, s=S):
    """Tokens and targets, and the stubbed frontend (float32 normal) of a
    config with an encoder or image patches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.encoder_layers:
        out["frontend"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    elif cfg.frontend_tokens:
        out["frontend"] = rng.normal(
            size=(b, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def ref_setup(arch, **kw):
    """The reference model and its params, and the port's model on the same
    params (CPU)."""
    rm = RefLM(RC.get_reduced(arch), remat=False, **kw)
    rp = rm.init(jax.random.key(0))
    cfg = C.get_reduced(arch)
    p = params_from_reference(jax.tree_util.tree_map(np.asarray, rp), cfg,
                              "cpu")
    return rm, rp, cfg, p


def loss_and_grads(model, params, batch):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = model.loss(tree_like(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def assert_grads_close(got, want, tol=GRAD_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert bool((g != 0).any()), "a gradient leaf is identically zero"
        np.testing.assert_allclose(g.numpy(), w, **tol)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", PORTED)
def test_loss_and_grads_equal_the_reference(arch):
    rm, rp, cfg, p = ref_setup(arch, loss_chunk=CHUNK)
    batch = batch_np(cfg)
    (rl, rmet), rg = jax.value_and_grad(rm.loss, has_aux=True)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = TransformerLM(cfg, device="cpu", loss_chunk=CHUNK)
    assert S // model.loss_chunk == 4 and model.remat
    loss, metrics, grads = loss_and_grads(model, p, to_torch(batch))
    np.testing.assert_allclose(float(loss), float(rl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["nll"]), float(rmet["nll"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["moe_aux"]),
                               float(rmet["moe_aux"]), rtol=LOSS_RTOL)
    assert (float(metrics["moe_aux"]) > 0) == (cfg.num_experts > 0)
    if cfg.num_experts:
        assert MOE_AUX_COEF == rm.moe_aux_coef == 0.01
        assert float(loss) != float(metrics["nll"])
    else:
        assert float(metrics["moe_aux"]) == 0.0
        assert float(loss) == float(metrics["nll"])
    assert_grads_close(grads, jax.tree_util.tree_leaves(rg),
                       DEEP_GRAD_TOL.get(arch, GRAD_TOL))


def test_loss_chunk_must_divide_the_sequence():
    _, _, cfg, p = ref_setup("qwen3-4b")
    model = TransformerLM(cfg, device="cpu", loss_chunk=12)
    with pytest.raises(ValueError, match="loss chunk"):
        model.loss(p, to_torch(batch_np(cfg)))


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma2-2b",
                                  "moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_remat_equals_no_remat_bitwise(arch, one_thread):
    _, _, cfg, p = ref_setup(arch)
    batch = to_torch(batch_np(cfg))
    got = {}
    for remat in (True, False):
        model = TransformerLM(cfg, device="cpu", remat=remat, loss_chunk=CHUNK)
        loss, _, grads = loss_and_grads(model, p, batch)
        got[remat] = (loss, grads)
    assert torch.equal(got[True][0], got[False][0])
    assert all(torch.equal(a, b) for a, b in zip(got[True][1],
                                                  got[False][1]))


def test_remat_recomputes_the_forward_only_under_grad():
    """With remat each repeat's forward runs again in the backward (K10's
    forward twice a layer); under ``no_grad`` the stage runs once and
    plainly, so serving and the decode check are untouched."""
    _, _, cfg, p = ref_setup("gemma2-2b")
    calls = []
    orig = F._forward

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    batch = to_torch(batch_np(cfg))
    F._forward = counted
    try:
        for remat, want in ((True, 2), (False, 1)):
            calls.clear()
            loss_and_grads(TransformerLM(cfg, device="cpu", remat=remat), p,
                           batch)
            assert len(calls) == want * cfg.num_layers
        calls.clear()
        with torch.no_grad():
            TransformerLM(cfg, device="cpu").loss(p, batch)
        assert len(calls) == cfg.num_layers
    finally:
        F._forward = orig


# ---------------------------------------------------------------------------
# K10 under autograd
# ---------------------------------------------------------------------------
ATTN_CASES = [
    # b, sq, sk, h, kv, hd, options
    (2, 16, 16, 4, 2, 8, dict()),                          # GQA g = 2
    (1, 12, 20, 8, 2, 16, dict()),                         # g = 4, sq < sk
    (2, 24, 24, 4, 2, 8, dict(window=5)),                  # sliding window
    (1, 16, 16, 4, 1, 8, dict(softcap=3.0)),               # MQA, softcap
    (2, 37, 45, 6, 3, 16, dict(window=9, softcap=50.0)),   # ragged lengths
    (1, 33, 33, 4, 2, 8, dict(causal=False)),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,kw", ATTN_CASES)
def test_attention_grads_equal_the_reference(b, sq, sk, h, kv, hd, kw):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, kv, hd)).astype(np.float32)
    dout = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    kw = dict(kw, q_offset=sk - sq)
    want_out, vjp = jax.vjp(lambda *a: ref_attention(*a, **kw),
                            *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = F.flash_attention(*t, **kw)
    assert isinstance(out.grad_fn, F.FlashAttention._backward_cls)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(out, t, torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_attention_backward_is_the_plain_vjp():
    """The Function's gradients are autograd's through the plain version,
    bit for bit, and stay so when the recompute takes the batch a row at
    a time; only the inputs that want a gradient get one."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((3, 10, 4, 8), (3, 12, 2, 8), (3, 12, 2, 8)))
    dout = torch.from_numpy(rng.normal(size=(3, 10, 4, 8)).astype(np.float32))
    kw = dict(window=4, softcap=3.0, q_offset=2)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(F.flash_attention_plain(*leaves, **kw),
                               leaves, dout)
    got = torch.autograd.grad(F.flash_attention(*leaves, **kw), leaves, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    old = F._BACKWARD_SCORE_BYTES
    F._BACKWARD_SCORE_BYTES = 1          # one batch row at a time
    try:
        rows = torch.autograd.grad(F.flash_attention(*leaves, **kw), leaves,
                                   dout)
        for a, b in zip(rows, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)
        only_k = [q, k.clone().requires_grad_(True), v]
        (dk,) = torch.autograd.grad(F.flash_attention(*only_k, **kw),
                                    [only_k[1]], dout)
        np.testing.assert_allclose(dk.numpy(), want[1].numpy(), rtol=1e-6,
                                   atol=1e-7)
    finally:
        F._BACKWARD_SCORE_BYTES = old


def test_serving_calls_stay_outside_autograd():
    """No input requires grad, or grad is off: the forward runs as before
    (no ``FlashAttention`` node), as phase 12's serving calls do."""
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    k = torch.randn(1, 4, 2, 8)
    assert F.flash_attention(q.detach(), k, k).grad_fn is None
    with torch.no_grad():
        assert F.flash_attention(q, k, k).grad_fn is None
    with torch.inference_mode():
        assert F.flash_attention(q.detach(), k, k).grad_fn is None
    assert F.flash_attention(q, k, k).grad_fn is not None


# ---------------------------------------------------------------------------
# launch/steps.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", RC.ARCHS)
def test_input_specs_equal_the_reference(arch):
    cells = dict(SHAPES, tiny=ShapeCell("tiny", 16, 2, "train"))
    for name, cell in cells.items():
        rcell = RefShapeCell(cell.name, cell.seq_len, cell.global_batch,
                             cell.mode)
        want = ref_input_specs(RC.get_config(arch), rcell)
        got = steps.input_specs(C.get_config(arch), cell)
        assert sorted(got) == sorted(want), name
        for key, spec in got.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[key].shape), (name, key)
            assert str(spec.dtype).replace("torch.", "") == \
                str(want[key].dtype), (name, key)


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma2-2b",
                                  "moonshot-v1-16b-a3b", "mamba2-780m"]
                         + CROSS)
def test_train_step_equals_the_reference_step(arch, one_thread):
    rm, rp, cfg, p = ref_setup(arch)
    batch = batch_np(cfg, seed=2)
    ropt = RefAdamW(learning_rate=ref_cosine(3e-4, 200, 20_000))
    rstate = ropt.init(rp)
    (rl, rmet), rg = jax.value_and_grad(rm.loss, has_aux=True)(
        rstate.params, {k: jnp.asarray(v) for k, v in batch.items()})
    rnew = ropt.update(rg, rstate)

    bundle = steps.build_step(cfg, ShapeCell("t", S, B, "train"), "cpu")
    assert (bundle.mode, bundle.model.remat) == ("train", True)
    state, data = bundle.abstract_args
    assert data["tokens"].device.type == "meta"
    assert [tuple(t.shape) for t in tree_leaves(state.params)] == \
        [tuple(t.shape) for t in tree_leaves(p)]
    from repro_torch.optim import AdamW
    state = AdamW().init(p)
    new, out = bundle.fn(state, to_torch(batch))
    np.testing.assert_allclose(float(out["loss"]), float(rl), rtol=LOSS_RTOL)
    assert set(out) == {"loss", "nll", "moe_aux"}
    assert int(new.step) == int(rnew.step) == 1
    for part in ("params", "mu", "nu"):
        for g, w in zip(tree_leaves(getattr(new, part)),
                        jax.tree_util.tree_leaves(getattr(rnew, part))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    # functional: the old state is as it was
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params),
                                                  tree_leaves(p)))


def test_serve_steps_equal_the_model():
    _, _, cfg, p = ref_setup("gemma2-2b")
    model = TransformerLM(cfg, device="cpu")
    toks = torch.from_numpy(batch_np(cfg)["tokens"][:, :12])
    pre = steps.build_step(cfg, ShapeCell("p", 16, B, "prefill"), "cpu")
    assert pre.abstract_args[1].shape == (B, 16)
    lg, caches = pre.fn(p, toks)
    want, wcaches = model.prefill(p, toks, cache_len=16)
    assert torch.equal(lg, want) and lg.grad_fn is None
    dec = steps.build_step(cfg, ShapeCell("d", 16, B, "decode"), "cpu")
    a_params, a_tok, a_idx, a_cache = dec.abstract_args
    assert a_tok.shape == (B, 1) and a_idx.shape == ()
    assert a_cache[0][0]["attn"]["k"].device.type == "meta"
    assert a_cache[0][0]["attn"]["k"].shape == caches[0][0]["attn"]["k"].shape
    tok = toks[:, -1:]
    got, _ = dec.fn(p, tok, 12, caches)
    want, _ = model.decode_step(p, tok, 12, wcaches)
    assert torch.equal(got, want)


def test_serve_steps_carry_the_mamba_cache():
    """A hybrid config's decode step takes the Mamba entries of
    ``init_cache`` (conv window in the model dtype, state in fp32) beside
    the K/V, and equals the model's prefill / decode."""
    _, _, cfg, p = ref_setup("jamba-v0.1-52b")
    model = TransformerLM(cfg, device="cpu")
    toks = torch.from_numpy(batch_np(cfg)["tokens"][:, :12])
    dec = steps.build_step(cfg, ShapeCell("d", 16, B, "decode"), "cpu")
    a_cache = dec.abstract_args[3]
    kinds = [sorted(layer) for layer in a_cache[0]]
    assert kinds == [["attn"] if spec.kind == "self_attn" else ["mamba"]
                     for spec in cfg.stages[0].pattern]
    want = model.init_cache(B, 16)
    for layer, w in zip(a_cache[0], want[0]):
        for kind in layer:
            for name, t in layer[kind].items():
                assert t.device.type == "meta"
                assert (t.shape, t.dtype) == (w[kind][name].shape,
                                              w[kind][name].dtype)
    assert want[0][0]["mamba"]["state"].dtype == torch.float32
    pre = steps.build_step(cfg, ShapeCell("p", 16, B, "prefill"), "cpu")
    lg, caches = pre.fn(p, toks)
    want_lg, wcaches = model.prefill(p, toks, cache_len=16)
    assert torch.equal(lg, want_lg)
    got, _ = dec.fn(p, toks[:, -1:], 12, caches)
    want_lg, _ = model.decode_step(p, toks[:, -1:], 12, wcaches)
    assert torch.equal(got, want_lg)


@pytest.mark.parametrize("arch", CROSS)
def test_serve_steps_take_the_frontend(arch):
    """A cross-attention config's prefill step takes the frontend (its meta
    tensor in ``abstract_args``, shaped as ``input_specs`` says) and equals
    the model's prefill; the decode step ignores a frontend (the memory's
    K/V are cached) and equals the model's decode."""
    _, _, cfg, p = ref_setup(arch)
    model = TransformerLM(cfg, device="cpu")
    data = batch_np(cfg)
    toks = torch.from_numpy(data["tokens"][:, :12])
    fe = torch.from_numpy(data["frontend"])
    pre = steps.build_step(cfg, ShapeCell("p", 16, B, "prefill"), "cpu")
    assert len(pre.abstract_args) == 3
    a_fe = pre.abstract_args[2]
    assert a_fe.device.type == "meta" and a_fe.shape == fe.shape
    lg, caches = pre.fn(p, toks, fe)
    want, wcaches = model.prefill(p, toks, frontend=fe, cache_len=16)
    assert torch.equal(lg, want)
    dec = steps.build_step(cfg, ShapeCell("d", 16, B, "decode"), "cpu")
    kinds = [sorted(layer) for layer in dec.abstract_args[3][0]]
    assert kinds == [sorted(layer) for layer in caches[0]]
    assert any("cross" in k for k in kinds)
    got, _ = dec.fn(p, toks[:, -1:], 12, caches, fe)
    want, _ = model.decode_step(p, toks[:, -1:], 12, wcaches)
    assert torch.equal(got, want)
