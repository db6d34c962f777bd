"""Hetero mini-batch sampling of the port: host fanout sampling producing
message-flow-graph blocks, device sampling (``DeviceSampler``: selection
and layout build on the device, the same edges as the host sampler), and
a prefetching loader that takes either.
"""
from repro_torch.sampling.loader import (  # noqa: F401
    EpochSeedStream,
    MiniBatch,
    MiniBatchLoader,
    SeedStream,
    build_minibatch,
)
from repro_torch.sampling.device_sampler import (  # noqa: F401
    DeviceBlock,
    DeviceBlockSequence,
    DeviceSampler,
)
from repro_torch.sampling.sampler import (  # noqa: F401
    Block,
    BlockSequence,
    FanoutSampler,
)
