"""Models of the port (counterpart of ``corrifnet_tpu.models``)."""

from corrifnet_tpu_torch.models.jax_import import (
    mmvit4_named_gradients,
    mmvit4_state_dict_from_variables,
)
from corrifnet_tpu_torch.models.mmvit4 import MMVit4
from corrifnet_tpu_torch.models.registry import create_model

__all__ = ["MMVit4", "create_model", "mmvit4_named_gradients",
           "mmvit4_state_dict_from_variables"]
