"""Single-headed HGT layer in the Hector authoring DSL (paper Fig. 2).

    k_n  = h_n W_K[τ(n)]          (nodewise typed linear, ntype segments)
    q_n  = h_n W_Q[τ(n)]
    v_n  = h_n W_V[τ(n)]
    katt = k_src W_A[τ(e)]        (edgewise typed linear -> COMPACT)
    msg  = v_src W_M[τ(e)]        (COMPACT)
    att  = softmax_dst( (katt · q_dst) / sqrt(d) )
    h_v' = Σ_e att_e · msg_e

The port's own copy of ``repro.models.hgt`` (fingerprints held equal by
``tests/test_torch_ir.py``).
"""
import math

from repro_torch import frontend as hector
from repro_torch.core.ir import inter_op as I


@hector.model
def hgt(g, e, n, in_dim, out_dim):
    W_K = g.weight("W_K", (in_dim, out_dim), indexed_by="ntype")
    W_Q = g.weight("W_Q", (in_dim, out_dim), indexed_by="ntype")
    W_V = g.weight("W_V", (in_dim, out_dim), indexed_by="ntype")
    W_A = g.weight("W_att", (out_dim, out_dim), indexed_by="etype")
    W_M = g.weight("W_msg", (out_dim, out_dim), indexed_by="etype")
    n["kk"] = n["feature"] @ W_K
    n["qq"] = n["feature"] @ W_Q
    n["vv"] = n["feature"] @ W_V
    e["katt"] = e.src["kk"] @ W_A
    e["msg"] = e.src["vv"] @ W_M
    e["att_raw"] = hector.dot(e["katt"], e.dst["qq"]) * (1.0 / math.sqrt(out_dim))
    e["att"] = hector.edge_softmax(e["att_raw"])
    n["h_out"] = hector.aggregate(e["msg"], scale=e["att"])
    return n["h_out"]


def hgt_program(in_dim: int, out_dim: int) -> I.Program:
    """Thin wrapper: trace the DSL model into inter-operator IR."""
    return hgt(in_dim, out_dim)
