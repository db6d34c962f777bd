"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The entry points' device: ``None`` means the CUDA card. Without one
    this raises instead of running on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev
