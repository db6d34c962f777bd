"""Hetero mini-batch sampling of the port: host fanout sampling producing
message-flow-graph blocks, and a prefetching loader that builds each
block's layouts on the host and copies them to the device.

Device-native sampling (``repro.sampling.device_sampler``) is not ported
yet.
"""
from repro_torch.sampling.loader import (  # noqa: F401
    EpochSeedStream,
    MiniBatch,
    MiniBatchLoader,
    SeedStream,
    build_minibatch,
)
from repro_torch.sampling.sampler import (  # noqa: F401
    Block,
    BlockSequence,
    FanoutSampler,
)
