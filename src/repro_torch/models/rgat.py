"""Single-headed RGAT layer in the Hector authoring DSL (paper Listing 1).

    hs    = h_src W_r                    (edgewise typed linear -> compactable)
    atts  = hs · w_s[r]                  (reordering -> h_src (W_r w_s^T))
    attt  = (h_dst W_r) · w_t[r]         (reordering, dst side)
    att   = edge_softmax(leaky_relu(atts + attt))
    h_v'  = Σ_e att_e · hs_e             (fused traversal aggregation)

The port's own copy of ``repro.models.rgat``: it traces to a program whose
``describe()`` and plan fingerprints equal the reference's
(``tests/test_torch_ir.py``).
"""
from repro_torch import frontend as hector
from repro_torch.core.ir import inter_op as I


@hector.model
def rgat(g, e, n, in_dim, out_dim, slope=0.01):
    W = g.weight("W_rel", (in_dim, out_dim), indexed_by="etype")
    w_s = g.weight("w_att_src", (out_dim,), indexed_by="etype")
    w_t = g.weight("w_att_dst", (out_dim,), indexed_by="etype")
    e["hs"] = e.src["feature"] @ W
    e["atts"] = hector.dot(e["hs"], w_s)
    e["attt"] = hector.dot(e.dst["feature"] @ W, w_t)
    e["att_raw"] = hector.leaky_relu(e["atts"] + e["attt"], slope)
    e["att"] = hector.edge_softmax(e["att_raw"])
    n["h_out"] = hector.aggregate(e["hs"], scale=e["att"])
    return n["h_out"]


def rgat_program(in_dim: int, out_dim: int, slope: float = 0.01) -> I.Program:
    """Thin wrapper: trace the DSL model into inter-operator IR."""
    return rgat(in_dim, out_dim, slope=slope)
