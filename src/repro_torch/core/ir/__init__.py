from repro_torch.core.ir import inter_op, intra_op, passes  # noqa: F401
