"""NeuLite in PyTorch for NVIDIA Hopper: a port of the JAX package
``repro``, which stays the reference it is tested against.

Layout follows the reference module for module (``core``, ``models``,
``federated``, ``data``, ``optim``, ``kernels``), with ``bridge`` converting
params between the two.  Kernels are hand-written CUDA for ``sm_90a``, built
with ``nvcc`` at first use.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; on CPU tensors each kernel wrapper takes its
plain PyTorch version.
"""
