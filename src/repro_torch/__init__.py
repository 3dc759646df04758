"""CB-SpMV on PyTorch and CUDA: the port of the JAX package ``repro``.

Same layout and public names as ``repro``; this package imports torch and
numpy only. What is ported so far is listed in the README's "PyTorch/CUDA
port" section.
"""
