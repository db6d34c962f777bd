"""RGCN layer (Schlichtkrull et al.) in the Hector authoring DSL.

Formula (paper Eq. 1):
    h_v' = σ( h_v W_0 + Σ_r Σ_{u∈N_v^r} (1/c_{v,r}) h_u W_r )

The in-degree normalizer (DGL's default 'right' norm) is folded into the
mean-reduce of the aggregation. The port's own copy of
``repro.models.rgcn``: it traces to a program whose ``describe()`` and plan
fingerprints equal the reference's (``tests/test_torch_ir.py``).
"""
from repro_torch import frontend as hector
from repro_torch.core.ir import inter_op as I


@hector.model
def rgcn(g, e, n, in_dim, out_dim, activation="relu"):
    W_r = g.weight("W_rel", (in_dim, out_dim), indexed_by="etype")
    W_0 = g.weight("W_self", (in_dim, out_dim))
    e["msg"] = e.src["feature"] @ W_r
    n["h_agg"] = hector.aggregate(e["msg"], reduce="mean")
    n["h_self"] = n["feature"] @ W_0
    n["h_out"] = hector.unary(activation, n["h_agg"] + n["h_self"])
    return n["h_out"]


def rgcn_program(in_dim: int, out_dim: int,
                 activation: str = "relu") -> I.Program:
    """Thin wrapper: trace the DSL model into inter-operator IR."""
    return rgcn(in_dim, out_dim, activation=activation)
