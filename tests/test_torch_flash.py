"""K10 (flash attention) of the PyTorch port against the JAX reference.

The plain version (``flash_attention_plain``, what the wrapper runs on a
CPU tensor) is held to the reference's Pallas kernel in interpret mode at
every case of ``tests/test_flash.py``, at that file's tolerances, and to
its ``ref_attention`` oracle at lengths the Pallas kernel cannot take
(ragged ``Sq`` / ``Sk``, rows whose leading keys are all outside the
window), and on rows that see no key. The CUDA kernel itself is checked against the plain version on
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
    assert F.key_splits(4, 4, 4096 * 2, 4096, sms) == (1, 4096)
    # its decode over a 4128-slot cache: B * KV = 16 blocks are split
    splits, chunk = F.key_splits(4, 4, 2, 4128, sms)
    assert splits > 1 and chunk % F.KEYS_PER_TILE == 0
    assert (splits - 1) * chunk < 4128 <= splits * chunk
    assert 16 * splits >= sms and chunk >= 128
    # a short cache keeps at least 128 keys a split
    assert F.key_splits(1, 1, 1, 100, sms) == (1, 128)
    # qwen3-4b decode, batch 8, 2080 slots
    splits, chunk = F.key_splits(8, 8, 4, 2080, sms)
    assert splits * chunk >= 2080 and 64 * splits >= sms
