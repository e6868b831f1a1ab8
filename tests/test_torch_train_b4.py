"""The whole MMVit4 train step of the port against the JAX package at B=4
with a padded sample, in f32 on the CPU. A file of its own, apart from
``test_torch_train.py`` (which runs the B=1 case), so that a test run that
gives each file to one worker runs the two cases side by side.
"""

from __future__ import annotations

import pytest

from torch_train_step import check_train_step, jax_step  # noqa: F401 (fixture)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

# the depth-fused standard chain on both sides (the lean one runs at B=1)
DECODER_LEAN = False


@pytest.mark.parametrize("batch,padded", [(4, True)])
def test_train_step_matches_jax(jax_step, batch, padded):
    """One whole MMVit4 train step and a second after Adam against JAX
    (bounds and their reasons: ``torch_train_step.check_train_step``)."""
    check_train_step(jax_step, batch, padded, DECODER_LEAN)
