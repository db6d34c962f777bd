"""RGNN execution engine of the port (serving subset; training is a later
slice)."""
from repro_torch.train.engine import EngineConfig, RGNNEngine  # noqa: F401
