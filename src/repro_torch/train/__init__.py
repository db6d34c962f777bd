"""RGNN execution engine and trainers of the port."""
from repro_torch.train.engine import (EngineConfig, MODEL_PROGRAMS,  # noqa: F401
                                      RGNNEngine, parse_fanout,
                                      resolve_device)
from repro_torch.train.trainer import (FullGraphTrainer,  # noqa: F401
                                       SampledTrainer)
