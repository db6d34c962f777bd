"""Hector authoring frontend of the PyTorch port: the Python-embedded DSL
and the ``compile()`` entry point (``hector_torch`` re-exports both).

    @hector_torch.model
    def rgat(g, e, n, in_dim, out_dim, slope=0.01):
        ...

    compiled = hector_torch.compile(rgat, graph, layers=2, sample=5)
    params = compiled.init(0)
    logits = compiled.apply_blocks(params, mb, feats)  # sampled mini-batch

Models trace to ``core.ir.inter_op.Program`` and are validated at trace
time with source-located diagnostics (``ProgramValidationError``).
"""
from repro_torch.core.ir.validate import (  # noqa: F401
    ProgramValidationError,
    check_var_refs,
    validate_program,
)
from repro_torch.frontend.compile import CompiledRGNN, compile  # noqa: F401,A004
from repro_torch.frontend.trace import (  # noqa: F401
    ModelSpec,
    aggregate,
    concat,
    dot,
    edge_softmax,
    exp,
    leaky_relu,
    model,
    neg,
    relu,
    sigmoid,
    tanh,
    unary,
)

__all__ = [
    "model", "compile", "CompiledRGNN", "ModelSpec",
    "ProgramValidationError", "validate_program", "check_var_refs",
    "aggregate", "concat", "dot", "edge_softmax", "unary",
    "relu", "leaky_relu", "sigmoid", "tanh", "exp", "neg",
]
