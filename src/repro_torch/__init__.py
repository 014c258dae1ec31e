"""PyTorch/CUDA port of the ``repro`` package (the JAX reference).

The port mirrors the JAX package's module names so each counterpart is
easy to find, imports ``torch`` and never ``jax`` or ``repro``, and runs
every entry point on the card unless the caller passes ``device="cpu"``.
Slice 1 covers paged serving of the dense LM: the flash-prefill and
paged-decode attention kernels are CUDA C++ under ``csrc/``.
"""
