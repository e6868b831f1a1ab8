"""Models of the port (counterpart of ``corrifnet_tpu.models``)."""

from corrifnet_tpu_torch.models.jax_import import (
    mmvit2_named_gradients,
    mmvit2_state_dict_from_variables,
    mmvit4_named_gradients,
    mmvit4_state_dict_from_variables,
    rfnet_named_gradients,
    rfnet_state_dict_from_variables,
    robustseg_named_gradients,
    robustseg_state_dict_from_variables,
)
from corrifnet_tpu_torch.models.mmvit2 import MMFormer, MMVit2
from corrifnet_tpu_torch.models.mmvit4 import MMVit4
from corrifnet_tpu_torch.models.registry import create_model
from corrifnet_tpu_torch.models.rfnet import RFNet
from corrifnet_tpu_torch.models.robustseg import RobustMseg

__all__ = ["MMFormer", "MMVit2", "MMVit4", "RFNet", "RobustMseg", "create_model",
           "mmvit2_named_gradients", "mmvit2_state_dict_from_variables",
           "mmvit4_named_gradients", "mmvit4_state_dict_from_variables",
           "rfnet_named_gradients", "rfnet_state_dict_from_variables",
           "robustseg_named_gradients", "robustseg_state_dict_from_variables"]
