"""Models of the port (counterpart of ``corrifnet_tpu.models``)."""

from corrifnet_tpu_torch.models.deeplabv3p import DeepLabV3Plus
from corrifnet_tpu_torch.models.elanet import ELANet
from corrifnet_tpu_torch.models.enet import ENet
from corrifnet_tpu_torch.models.fassdnet import FASSDNet
from corrifnet_tpu_torch.models.jax_import import (
    deeplab_named_gradients,
    deeplab_state_dict_from_variables,
    elanet_named_gradients,
    elanet_state_dict_from_variables,
    enet_named_gradients,
    enet_state_dict_from_variables,
    fassdnet_named_gradients,
    fassdnet_state_dict_from_variables,
    mmvit2_named_gradients,
    mmvit2_state_dict_from_variables,
    mmvit4_named_gradients,
    mmvit4_state_dict_from_variables,
    multisenseseg_named_gradients,
    multisenseseg_state_dict_from_variables,
    rfnet_named_gradients,
    rfnet_state_dict_from_variables,
    robustseg_named_gradients,
    robustseg_state_dict_from_variables,
    segformer_named_gradients,
    segformer_state_dict_from_variables,
    unetv2_named_gradients,
    unetv2_state_dict_from_variables,
)
from corrifnet_tpu_torch.models.mmvit2 import MMFormer, MMVit2
from corrifnet_tpu_torch.models.mmvit4 import MMVit4
from corrifnet_tpu_torch.models.multisenseseg import MultiSenseSeg
from corrifnet_tpu_torch.models.registry import create_model
from corrifnet_tpu_torch.models.rfnet import RFNet
from corrifnet_tpu_torch.models.robustseg import RobustMseg
from corrifnet_tpu_torch.models.segformer import Segformer
from corrifnet_tpu_torch.models.unet import UNetV2

__all__ = ["DeepLabV3Plus", "ELANet", "ENet", "FASSDNet", "MMFormer", "MMVit2", "MMVit4",
           "MultiSenseSeg", "RFNet", "RobustMseg", "Segformer", "UNetV2", "create_model",
           "deeplab_named_gradients", "deeplab_state_dict_from_variables",
           "elanet_named_gradients", "elanet_state_dict_from_variables",
           "enet_named_gradients", "enet_state_dict_from_variables",
           "fassdnet_named_gradients", "fassdnet_state_dict_from_variables",
           "mmvit2_named_gradients", "mmvit2_state_dict_from_variables",
           "mmvit4_named_gradients", "mmvit4_state_dict_from_variables",
           "multisenseseg_named_gradients", "multisenseseg_state_dict_from_variables",
           "rfnet_named_gradients", "rfnet_state_dict_from_variables",
           "robustseg_named_gradients", "robustseg_state_dict_from_variables",
           "segformer_named_gradients", "segformer_state_dict_from_variables",
           "unetv2_named_gradients", "unetv2_state_dict_from_variables"]
