"""corrifnet_tpu_torch — the PyTorch/CUDA port of corrifnet_tpu for NVIDIA Hopper.

The JAX package ``corrifnet_tpu`` stays the reference; this package runs
the same models with PyTorch, and the JAX package's Pallas kernels become
kernels written for the H100 (CUDA C++ under ``csrc/``, or Triton). Ported
so far: MMVit4 (CorrIFNet) inference through ``run.evaluate``. The package
never imports jax or flax; of the JAX package it imports only the modules
that load no jax: ``corrifnet_tpu.config`` and ``corrifnet_tpu.data``.

Layout mirrors ``corrifnet_tpu``: ``ops/`` (kernels beside their plain
versions), ``nn/``, ``models/``, ``metrics/``, ``run/``.
"""

__version__ = "0.1.0"
