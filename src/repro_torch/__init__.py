"""PyTorch/CUDA port of the decentralized-compression runtime.

A second package beside the JAX reference ``repro``: the same module names,
written in PyTorch, with every Pallas kernel on the ported path replaced by a
hand-written CUDA kernel for Hopper (``kernels/csrc``).  The package imports
``torch`` and never ``jax``, and nothing of ``repro``: what it needs of the
JAX package it keeps as its own copy.

Entry points run on the GPU unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper runs its plain PyTorch version, on CUDA tensors
it launches the kernel or raises.
"""
