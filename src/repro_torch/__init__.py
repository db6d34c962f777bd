"""PyTorch/CUDA port of the Hector reproduction (``repro``).

Mirrors ``repro``'s module paths. It imports torch and numpy, never JAX nor
the reference package: what it needs of the reference it keeps as its own
copies, held to the reference by the ``tests/test_torch_*.py`` parity tests.
Plain torch code runs on the CPU; every ported Pallas kernel is a
hand-written CUDA kernel (``csrc/``) launched for CUDA tensors.
"""
