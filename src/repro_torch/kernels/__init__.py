"""Kernels of the port: host layouts, oracles, the hand-written CUDA kernels
(K1-K10, sources in ``repro_torch/csrc``) with their plain versions, and the
ops the code generator calls."""
