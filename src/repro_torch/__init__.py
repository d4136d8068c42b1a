"""PyTorch/CUDA port of the JAX package ``repro``, for one NVIDIA H100.

Modules mirror ``repro``'s names. The port imports torch, numpy and the
standard library, never jax and nothing of ``repro``: what it needs of a
jax-free module there (configs, the page ledger) it keeps as its own copy.
Attention runs through hand-written CUDA kernels (``kernels/csrc``) on the
card, and through their plain PyTorch versions on the CPU.
"""
