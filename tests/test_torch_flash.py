"""K10 (flash attention) of the PyTorch port against the JAX reference.

The plain version (``flash_attention_plain``, what the wrapper runs on a
CPU tensor) is held to the reference's Pallas kernel in interpret mode at
every case of ``tests/test_flash.py``, at that file's tolerances, and to
its ``ref_attention`` oracle at lengths the Pallas kernel cannot take
(ragged ``Sq`` / ``Sk``, rows whose leading keys are all outside the
window), and on rows that see no key. The wrapper's choice of kernel
(``route`` / ``plan``), its key splits against the kernels' walk, and the
precision argument of the tensor-core kernel's split P @ V are pinned here
too. The CUDA kernels themselves are checked against the plain version on
the card by ``chip_smoke.py`` (phase 12).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.nn.attention import _mask as ref_mask
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as F
from test_flash import ref_attention

RNG = np.random.default_rng(0)


def make(b, sq, sk, h, kv, hd):
    return (RNG.normal(size=(b, sq, h, hd)).astype(np.float32),
            RNG.normal(size=(b, sk, kv, hd)).astype(np.float32),
            RNG.normal(size=(b, sk, kv, hd)).astype(np.float32))


def port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return F.flash_attention_plain(*t, **kw).float().numpy()


# ---------------------------------------------------------------------------
# every case of tests/test_flash.py, against the interpret-mode kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,qt,kt", [
    (1, 32, 32, 2, 2, 8, 8, 8),
    (2, 64, 64, 4, 2, 16, 16, 16),     # GQA g=2
    (1, 16, 64, 8, 2, 8, 16, 32),      # g=4, long K
    (2, 128, 128, 2, 1, 32, 128, 64),  # MQA
])
def test_plain_matches_pallas_sweep(b, sq, sk, h, kv, hd, qt, kt):
    q, k, v = make(b, sq, sk, h, kv, hd)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     q_tile=qt, k_tile=kt, interpret=True, q_offset=sk - sq)
    np.testing.assert_allclose(port(q, k, v, q_offset=sk - sq),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [8, 16])
def test_plain_matches_pallas_sliding_window(window):
    q, k, v = make(1, 64, 64, 2, 2, 8)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     window=window, q_tile=16, k_tile=16, interpret=True)
    np.testing.assert_allclose(port(q, k, v, window=window),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


def test_plain_matches_pallas_softcap():
    q, k, v = make(1, 32, 32, 2, 2, 8)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     softcap=5.0, q_tile=8, k_tile=8, interpret=True)
    np.testing.assert_allclose(port(q, k, v, softcap=5.0), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_plain_matches_pallas_bf16():
    q, k, v = make(1, 32, 32, 4, 4, 16)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = ref_flash(qj, kj, vj, q_tile=16, k_tile=16, interpret=True)
    # the same bf16 inputs on both sides
    q, k, v = (np.asarray(x, np.float32) for x in (qj, kj, vj))
    got = port(q, k, v, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_plain_matches_pallas_decode_single_query():
    q, k, v = make(2, 1, 64, 4, 2, 8)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     q_offset=40, q_tile=1, k_tile=16, interpret=True)
    np.testing.assert_allclose(port(q, k, v, q_offset=40), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,window", [(False, 8), (True, 4)])
def test_plain_matches_pallas_on_rows_that_see_no_key(causal, window):
    """Queries past the cache whose window starts past the last key: the
    Pallas kernel averages every value there, and so does K10."""
    q, k, v = make(1, 16, 32, 2, 1, 8)
    kw = dict(causal=causal, window=window, q_offset=30)
    blind = ~F.attention_mask(30 + torch.arange(16), torch.arange(32),
                              window, causal).any(1)
    assert 0 < int(blind.sum()) < 16
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_tile=8, k_tile=8,
                                interpret=True, **kw))
    np.testing.assert_allclose(want[0, blind.numpy()],
                               np.broadcast_to(v.mean(1), (int(blind.sum()),
                                                           2, 8)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port(q, k, v, **kw), want, rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# lengths and masks the Pallas kernel cannot take, against ref_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,kw", [
    (2, 37, 101, 10, 2, 16, dict(q_offset=20)),            # ragged, g = 5
    (1, 1, 333, 8, 1, 8, dict(q_offset=0)),                # decode, MQA
    (1, 1, 333, 8, 1, 8, dict(q_offset=170)),              # mid-cache
    (1, 1, 333, 8, 1, 8, dict(q_offset=332)),              # the last slot
    (1, 70, 90, 4, 4, 12, dict(window=1, q_offset=20)),    # window 1
    (1, 70, 90, 4, 4, 12, dict(window=500, q_offset=20)),  # window > Sk
    (2, 45, 77, 6, 3, 8, dict(causal=False, softcap=3.0)),
    # every row's first 64+ keys lie before its window
    (1, 30, 200, 4, 2, 8, dict(window=40, q_offset=150)),
])
def test_plain_ragged_lengths_match_ref_attention(b, sq, sk, h, kv, hd, kw):
    q, k, v = make(b, sq, sk, h, kv, hd)
    want = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         **kw)
    np.testing.assert_allclose(port(q, k, v, **kw), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window,causal", [(None, True), (4, True),
                                           (4, False), (None, False)])
def test_attention_mask_equals_the_reference(window, causal):
    qp, kp = np.arange(5, 12), np.arange(16)
    want = ref_mask(jnp.asarray(qp), jnp.asarray(kp), window, causal)
    got = F.attention_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                           window, causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the wrapper's dispatch
# ---------------------------------------------------------------------------
def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(x) for x in make(2, 5, 19, 4, 2, 8))
    before = ops.launch_counts()["flash_attention"]
    kw = dict(window=7, softcap=20.0, q_offset=14)
    torch.testing.assert_close(F.flash_attention(q, k, v, **kw),
                               F.flash_attention_plain(q, k, v, **kw),
                               rtol=0, atol=0)
    assert ops.launch_counts()["flash_attention"] == before


def test_non_cpu_tensors_take_the_kernel_or_raise(monkeypatch, tmp_path):
    q = torch.empty((1, 4, 2, 8), device="meta")
    k = torch.empty((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        F.flash_attention(q, k, k)
    # the CUDA route builds its kernel or raises: nothing falls back
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        F._library()


@pytest.mark.parametrize("kw,match", [
    (dict(window=0), "window=0"), (dict(softcap=0.0), "softcap=0.0"),
])
def test_wrapper_rejects_bad_options(kw, match):
    q, k, v = (torch.from_numpy(x) for x in make(1, 4, 4, 2, 1, 8))
    with pytest.raises(ValueError, match=match):
        F.flash_attention(q, k, v, **kw)


def test_wrapper_rejects_heads_that_do_not_group():
    q = torch.zeros((1, 4, 3, 8))
    k = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="not a multiple"):
        F.flash_attention(q, k, k)


def test_key_splits_fill_the_card_at_decode_only():
    sms = 132
    # gemma2-2b prefill at 4096 tokens, batch 4: enough blocks, one split
    assert F.key_splits(4, 4, 4096 * 2, 4096, sms, "mma") == (1, 4096)
    # its decode over a 4128-slot cache: one decode block per (batch, KV
    # head), 16 blocks, split towards at most 2 x 132
    splits, chunk = F.key_splits(4, 4, 2, 4128, sms, "decode")
    assert splits > 1 and chunk % F.KEY_TILE["decode"] == 0
    assert (splits - 1) * chunk < 4128 <= splits * chunk
    assert 16 * splits <= 2 * sms and chunk >= 128
    # a short cache keeps at least 128 keys a split: one split
    splits, chunk = F.key_splits(1, 1, 1, 100, sms, "decode")
    assert splits == 1 and chunk >= 100
    # qwen3-4b decode, batch 8, 2080 slots
    splits, chunk = F.key_splits(8, 8, 4, 2080, sms, "decode")
    assert splits > 1 and splits * chunk >= 2080 and 64 * splits <= 2 * sms
    # the CUDA-core kernel's 64-row blocks: fp32 decode splits alike
    splits, chunk = F.key_splits(4, 4, 2, 4128, sms, "fma")
    assert splits > 1 and chunk % F.KEY_TILE["fma"] == 0


@pytest.mark.parametrize("dtype,hd,rows,want", [
    (torch.bfloat16, 256, 4096 * 2, "mma"),    # gemma2-2b prefill
    (torch.bfloat16, 128, 2048 * 4, "mma"),    # qwen3-4b prefill
    (torch.bfloat16, 256, 2, "decode"),        # gemma2-2b decode
    (torch.bfloat16, 128, 4, "decode"),        # qwen3-4b decode
    (torch.bfloat16, 64, 64, "mma"),           # the row threshold
    (torch.bfloat16, 64, 63, "decode"),
    (torch.bfloat16, 16, 185, "mma"),          # hd 16, Sq 37 x g 5
    (torch.bfloat16, 8, 8192, "fma"),          # hd not a multiple of 16
    (torch.bfloat16, 12, 2, "fma"),
    (torch.float32, 256, 8192, "fma"),         # fp32 stays on FMAs
    (torch.float32, 128, 4, "fma"),
])
def test_route_by_dtype_head_dim_and_rows(dtype, hd, rows, want):
    assert F.route(dtype, hd, rows) == want
    assert want in F.ROUTES


def test_plan_names_the_route_splits_and_kernels():
    bf = torch.bfloat16
    prefill = F.plan(torch.empty(4, 4096, 8, 256, dtype=bf),
                     torch.empty(4, 4128, 4, 256, dtype=bf), sms=132)
    assert prefill == F.Plan("mma", 1, 4128) and prefill.kernels == 1
    decode = F.plan(torch.empty(4, 1, 8, 256, dtype=bf),
                    torch.empty(4, 4128, 4, 256, dtype=bf), sms=132)
    assert decode.route == "decode" and decode.splits > 1
    assert decode.kernels == 2                   # the kernel and the combine
    fp32 = F.plan(torch.empty(4, 1, 8, 256), torch.empty(4, 4128, 4, 256),
                  sms=132)
    assert fp32.route == "fma" and fp32.kernels == 2


def _walked_keys(row0, last_row, split, g, sk, chunk, causal, window,
                 q_offset):
    """csrc/flash_attention.cu's visible_keys: the keys one block walks."""
    qpos_lo, qpos_hi = q_offset + row0 // g, q_offset + last_row // g
    lo, hi = split * chunk, min(sk, split * chunk + chunk)
    blind_row = window is not None and qpos_hi - window + 1 >= sk
    if causal:
        hi = min(hi, qpos_hi + 1)
    if window is not None and not blind_row:
        lo = max(lo, qpos_lo - window + 1)
    return set(range(lo, hi))


@pytest.mark.parametrize("b,sq,sk,h,kv,kw", [
    (1, 1, 4128, 8, 4, dict(q_offset=4127)),               # decode
    (1, 1, 4128, 8, 4, dict(window=4096, q_offset=4126)),  # window
    (1, 1, 4128, 8, 4, dict(window=8, q_offset=4200)),     # blind row
    (2, 3, 1000, 10, 2, dict(q_offset=997)),               # g = 5, chunk
    (1, 64, 2000, 2, 2, dict(causal=False)),               # split prefill
    (1, 200, 300, 10, 2, dict(window=40, q_offset=100)),   # g = 5, window
    (2, 70, 90, 4, 2, dict(causal=False, window=16, q_offset=60)),
])
def test_key_splits_cover_exactly_the_keys_each_row_sees(b, sq, sk, h, kv,
                                                          kw):
    """Each route's splits partition the keys, and the blocks' walks cover
    every key a row sees (every key where it sees none) in exactly one
    split; keys past a walk weigh 0."""
    g, causal = h // kv, kw.get("causal", True)
    window, off = kw.get("window"), kw.get("q_offset", 0)
    sees = F.attention_mask(off + torch.arange(sq), torch.arange(sk),
                            window, causal)
    for dtype in (torch.bfloat16, torch.float32):
        pl = F.plan(torch.empty(b, sq, h, 64, dtype=dtype),
                    torch.empty(b, sk, kv, 64, dtype=dtype), sms=132)
        starts = [s * pl.chunk for s in range(pl.splits)]
        assert starts[-1] < sk <= starts[-1] + pl.chunk
        rows = sq * g
        block = rows if pl.route == "decode" else F.ROWS_PER_BLOCK
        for size in {block, 2 * block if pl.route == "mma" else block}:
            for row0 in range(0, rows, size):
                last = min(row0 + size, rows) - 1
                walks = [_walked_keys(row0, last, s, g, sk, pl.chunk, causal,
                                      window, off)
                         for s in range(pl.splits)]
                walked = set().union(*walks)
                assert sum(len(w) for w in walks) == len(walked)
                for row in range(row0, last + 1):
                    want = sees[row // g].nonzero().flatten().tolist()
                    assert set(want or range(sk)) <= walked, (row, pl)


@pytest.mark.parametrize("hd", [64, 256])
def test_split_bf16_probabilities_hold_one_ulp(hd):
    """The tensor-core kernel's P @ V as P_hi @ V + P_lo @ V (P_hi =
    bf16(p), P_lo = bf16(p - P_hi)), emulated in fp32 on the same bf16
    inputs, stays within chip_smoke's bf16 bound of K10 (rtol 2^-7, atol
    2e-5) of the plain version at long rows; P rounded to bf16 alone does
    not."""
    rng = np.random.default_rng(hd)
    sq, sk = 8, 2048
    q = torch.from_numpy(3 * rng.normal(size=(1, sq, 1, hd))).bfloat16()
    k = torch.from_numpy(rng.normal(size=(1, sk, 1, hd))).bfloat16()
    v = torch.from_numpy(rng.normal(size=(1, sk, 1, hd))).bfloat16()
    want = F.flash_attention_plain(q, k, v, causal=False).float()
    s = (q[0, :, 0].float() @ k[0, :, 0].float().T) / np.sqrt(hd)
    p = torch.exp(s - s.max(-1, keepdim=True).values)
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    vf, den = v[0, :, 0].float(), p.sum(-1, keepdim=True)

    def out(weights):
        return sum(w @ vf for w in weights) / den

    rtol, atol = 2 ** -7, 2e-5
    torch.testing.assert_close(out([hi, lo]).bfloat16().float(),
                               want[0, :, 0], rtol=rtol, atol=atol)
    assert not torch.allclose(out([hi]).bfloat16().float(), want[0, :, 0],
                              rtol=rtol, atol=atol)
