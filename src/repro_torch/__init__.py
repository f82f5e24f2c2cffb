"""PyTorch/CUDA port of the matrix computations and optimization suite.

A second package beside `repro` (the JAX reference): same module layout,
hand-written Hopper kernels on the card, plain torch on the CPU.
"""
