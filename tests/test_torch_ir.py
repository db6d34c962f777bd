"""The port's own IR, DSL and models (RGCN, RGAT, HGT, rgcn_cat) against
the reference's: equal program renderings and plan fingerprints, and DSL
diagnostics that name the offending model line."""
import pytest

import hector_torch
from repro.core.ir.passes import lower_program as ref_lower
from repro.models import rgat_program as ref_rgat
from repro_torch.core.ir.passes import lower_program
from repro_torch.models import rgat_program


@pytest.mark.parametrize("dims", [(64, 64), (64, 16), (8, 4)])
def test_rgat_program_describe_and_fingerprint_equal(dims):
    ours, ref = rgat_program(*dims), ref_rgat(*dims)
    assert ours.describe() == ref.describe()
    assert ours.fingerprint() == ref.fingerprint()


@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("compact", [True, False])
def test_rgat_plan_fingerprint_equal(reorder, compact):
    ours = lower_program(rgat_program(64, 16), reorder=reorder,
                         compact=compact)
    ref = ref_lower(ref_rgat(64, 16), reorder=reorder, compact=compact)
    assert ours.describe() == ref.describe()
    assert ours.fingerprint() == ref.fingerprint()


@pytest.mark.parametrize("name", ["rgcn", "hgt", "rgcn_cat"])
@pytest.mark.parametrize("dims", [(64, 64), (8, 4)])
def test_new_model_programs_describe_and_fingerprint_equal(name, dims):
    from repro.train.engine import MODEL_PROGRAMS as REF
    from repro_torch.train.engine import MODEL_PROGRAMS

    ours, ref = MODEL_PROGRAMS[name](*dims), REF[name](*dims)
    assert ours.describe() == ref.describe()
    assert ours.fingerprint() == ref.fingerprint()


@pytest.mark.parametrize("name", ["rgcn", "hgt", "rgcn_cat"])
@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("compact", [True, False])
def test_new_model_plan_fingerprints_equal(name, reorder, compact):
    from repro.train.engine import MODEL_PROGRAMS as REF
    from repro_torch.train.engine import MODEL_PROGRAMS

    ours = lower_program(MODEL_PROGRAMS[name](64, 16), reorder=reorder,
                         compact=compact)
    ref = ref_lower(REF[name](64, 16), reorder=reorder, compact=compact)
    assert ours.describe() == ref.describe()
    assert ours.fingerprint() == ref.fingerprint()


def test_rgcn_activation_binds_as_the_reference():
    from repro.models import rgcn_program as ref_rgcn
    from repro_torch.models import rgcn_program

    ours, ref = rgcn_program(8, 4, "tanh"), ref_rgcn(8, 4, "tanh")
    assert ours.fingerprint() == ref.fingerprint()
    assert ours.fingerprint() != rgcn_program(8, 4).fingerprint()


def test_model_registries_agree():
    from repro.models import DSL_MODELS as REF_DSL
    from repro.train.engine import MODEL_PROGRAMS as REF
    from repro_torch.models import DSL_MODELS
    from repro_torch.train.engine import MODEL_PROGRAMS

    assert sorted(MODEL_PROGRAMS) == sorted(REF) == sorted(DSL_MODELS) \
        == sorted(REF_DSL) == ["hgt", "rgat", "rgcn", "rgcn_cat"]


def test_rgat_plan_reaches_the_three_kernels():
    """Per layer: two weight products, three typed GEMMs (hs and atts by
    unique source, attt by edge destination), one fused traversal."""
    text = lower_program(rgat_program(64, 64)).describe()
    assert text.count("WPROD<") == 2
    assert text.count("GEMM<") == 3
    assert text.count("[unique_src]") == 2 and text.count("[edge_dst]") == 1
    assert text.count("TRAV<") == 1


def test_dsl_error_names_offending_line():
    @hector_torch.model
    def m(g, e, n, i, o):
        W = g.weight("W", (i, o), indexed_by="etype")
        e["hs"] = e.src["feature"] @ W
        e["att"] = hector_torch.edge_softmax(e["scores"])
        n["h"] = hector_torch.aggregate(e["hs"], scale=e["att"])
        return n["h"]

    with pytest.raises(hector_torch.ProgramValidationError) as ei:
        m(8, 8)
    msg = str(ei.value)
    assert "undefined edge var 'scores'" in msg
    assert "test_torch_ir.py" in msg
    assert 'hector_torch.edge_softmax(e["scores"])' in msg
