"""corrifnet_tpu_torch — the PyTorch/CUDA port of corrifnet_tpu for NVIDIA Hopper.

The JAX package ``corrifnet_tpu`` stays the reference; this package runs
the same models with PyTorch, and the JAX package's Pallas kernels become
kernels written for the H100 (CUDA C++ under ``csrc/``, or Triton). Ported
so far: MMVit4 (CorrIFNet) evaluation through ``run.evaluate`` and training
through ``run.main``. The package never imports jax, flax or optax, and
nothing of the JAX package: it keeps its own copies of the numpy-only
config and data modules.

Layout mirrors ``corrifnet_tpu``: ``config.py``, ``data/``, ``ops/`` (kernels
beside their plain versions), ``nn/``, ``models/``, ``metrics/``, ``train/``,
``utils/``, ``run/``.
"""

__version__ = "0.1.0"
