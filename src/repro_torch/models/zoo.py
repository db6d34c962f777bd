"""DSL-authored model variants beyond the paper's three.

``rgcn_cat`` — a concat-style RGCN: instead of *summing* the relational
aggregate and the self representation, it concatenates them and mixes with
a learned output projection (the GraphSAGE-style combine). It lowers
entirely onto the GEMM and traversal templates. The port's own copy of
``repro.models.zoo`` (fingerprints held equal by ``tests/test_torch_ir.py``).
"""
from repro_torch import frontend as hector
from repro_torch.core.ir import inter_op as I


@hector.model
def rgcn_cat(g, e, n, in_dim, out_dim, activation="relu"):
    W_r = g.weight("W_rel", (in_dim, out_dim), indexed_by="etype")
    W_0 = g.weight("W_self", (in_dim, out_dim))
    W_o = g.weight("W_out", (2 * out_dim, out_dim))
    e["msg"] = e.src["feature"] @ W_r
    n["h_agg"] = hector.aggregate(e["msg"], reduce="mean")
    n["h_self"] = n["feature"] @ W_0
    n["h_cat"] = hector.concat(n["h_agg"], n["h_self"])
    n["h_mix"] = n["h_cat"] @ W_o
    n["h_out"] = hector.unary(activation, n["h_mix"])
    return n["h_out"]


def rgcn_cat_program(in_dim: int, out_dim: int,
                     activation: str = "relu") -> I.Program:
    """Thin wrapper: trace the DSL model into inter-operator IR."""
    return rgcn_cat(in_dim, out_dim, activation=activation)
