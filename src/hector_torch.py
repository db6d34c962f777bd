"""``import hector_torch`` — the front door to the PyTorch/CUDA port.

Re-exports the authoring DSL (``@hector_torch.model`` + the edge/node
operations) and ``hector_torch.compile()`` from ``repro_torch.frontend``::

    import hector_torch

    compiled = hector_torch.compile("rgat", graph, layers=2, sample=5)
    params = compiled.init(0)
    logits = compiled.apply_blocks(params, mb, feats)    # sampled batch
    logits = compiled.apply(params, feats)                # full graph
    state = compiled.init_state(params)
    state, metrics = compiled.train_step(state, mb, labels, feats)

``sampler="device"`` samples mini-batches and builds their layouts on the
device (``repro_torch.sampling.DeviceSampler``) in place of the host
loader thread. Entry points run on the CUDA card unless given
``device="cpu"``.
"""
from repro_torch.frontend import *  # noqa: F401,F403
from repro_torch.frontend import __all__  # noqa: F401
