"""``repro_torch.launch.roofline`` against ``repro.launch.roofline``, on the
CPU: the analytic half (``model_flops``, ``analytic_memory_bytes``,
``_cache_bytes``) number for number for every config of the registry at
every ``SHAPES`` cell, and ``roofline_terms``' choice of the dominant term
(``tests/test_roofline.py::test_dominant_term_selection``) with the H100's
constants. The reference's four HLO-parsing tests (``test_shape_bytes``,
``test_scan_trip_count_multiplier``, ``test_nested_scan_multipliers``,
``test_parse_synthetic_hlo_with_tuple_types``) have no counterpart: eager
PyTorch produces no HLO text, and the port counts a step's FLOPs with
``step_flops`` (``FlopCounterMode`` on fake tensors) instead.
"""
import pytest

from repro import configs as RC
from repro.launch import roofline as RR
from repro.lm.config import SHAPES as REF_SHAPES
from repro_torch import configs as C
from repro_torch.launch import roofline as R
from repro_torch.lm.config import SHAPES, ShapeCell


@pytest.mark.parametrize("cell", list(SHAPES))
@pytest.mark.parametrize("arch", C.ARCHS)
def test_analytic_terms_equal_the_reference(arch, cell):
    cfg, rcfg = C.get_config(arch), RC.get_config(arch)
    got, want = SHAPES[cell], REF_SHAPES[cell]
    assert R.model_flops(cfg, got) == RR.model_flops(rcfg, want)
    for chips in (1, 256):
        assert R.analytic_memory_bytes(cfg, got, chips) == \
            RR.analytic_memory_bytes(rcfg, want, chips)
    assert R._cache_bytes(cfg, got) == RR._cache_bytes(rcfg, want)
    assert R.bound_s(cfg, got) == max(
        R.model_flops(cfg, got) / 989e12,
        R.analytic_memory_bytes(cfg, got, 1) / 3.35e12)


def test_cache_bytes_leave_out_the_cross_kv_as_the_reference_does():
    """whisper's cache counts its 24 decoder layers' self-attention K/V and
    nothing of the 1500-frame cross K/V (a known omission of the
    reference's formula, kept so that the two agree)."""
    cfg, cell = C.get_config("whisper-medium"), SHAPES["decode_32k"]
    self_kv = 24 * 2 * cell.global_batch * cell.seq_len * 16 * 64 * 2
    assert R._cache_bytes(cfg, cell) == self_kv


def test_h100_constants():
    hw = R.HW_H100
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == \
        (989e12, 3.35e12, 450e9, 80e9)


def test_dominant_term_selection():
    terms = R.roofline_terms(
        {}, {"flops": 1e12, "mem_bytes_proxy": 1e9,
             "collective_bytes": 1e12}, 256, R.HW_H100)
    assert terms["dominant"] == "collective"
    assert terms["t_collective_s"] == pytest.approx(1e12 / 450e9)
    terms2 = R.roofline_terms(
        {}, {"flops": 1e15, "mem_bytes_proxy": 1e9, "collective_bytes": 0},
        256, R.HW_H100)
    assert terms2["dominant"] == "compute"
    assert terms2["total_flops"] == 1e15 * 256
    terms3 = R.roofline_terms({}, {"flops": 1e9, "mem_bytes_proxy": 1e12},
                              1)
    assert terms3["dominant"] == "memory"
    assert terms3["t_memory_s"] == pytest.approx(1e12 / 3.35e12)


def test_summarize_cost_keeps_the_numbers():
    assert R.summarize_cost([{"flops": 3, "name": "x", "bytes": 2.5}]) == \
        RR.summarize_cost([{"flops": 3, "name": "x", "bytes": 2.5}]) == \
        {"flops": 3.0, "bytes": 2.5}
    assert R.summarize_cost(None) == {}


def test_step_flops_of_a_dense_train_step_near_model_flops():
    """A reduced qwen3-4b train step (B 2, S 16) counted op by op is within
    10 % of ``6 N D``: its matrix products are the parameters' (the tied
    embedding as the head), attention's 16-key products add ~4 %."""
    cfg, cell = C.get_reduced("qwen3-4b"), ShapeCell("t", 16, 2, "train")
    got = R.step_flops(cfg, cell)
    assert got.reason == ""
    assert abs(got.flops / R.model_flops(cfg, cell) - 1) < 0.1


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_step_flops_of_serve_steps(mode):
    """Prefill and decode steps count too, for an encoder-decoder config
    (the encoder's products run in the prefill, not in a decode step)."""
    cfg = C.get_reduced("whisper-medium")
    got = R.step_flops(cfg, ShapeCell("s", 16, 2, mode))
    assert got.reason == "" and got.flops > 0
    if mode == "decode":
        pre = R.step_flops(cfg, ShapeCell("s", 16, 2, "prefill"))
        assert got.flops < pre.flops / 8


def test_step_flops_of_a_data_dependent_step_is_none():
    """The MoE dispatch sizes its slots from the routing
    (``nn/moe.py``): on fake tensors that shape is unknown, so the step
    gives no count and says why."""
    got = R.step_flops(C.get_reduced("grok-1-314b"),
                       ShapeCell("t", 16, 2, "train"))
    assert got.flops is None and "DynamicOutputShape" in got.reason
