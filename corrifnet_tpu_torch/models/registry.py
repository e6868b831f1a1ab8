"""Model registry of the port, keyed by the reference's ``modeltype`` strings.

Counterpart of ``corrifnet_tpu/models/registry.py``: a table of specs (name,
factory, input kind, the model options it takes). MMVit4 (CorrIFNet), MMVit2,
mmformer, RFNet, RobustMseg and MultiSenseSeg (5-D input) and UNetV2,
Segformer, DeepLabv3_plus, ELANet, FASSDNet and ENet (4-D input: one
modality, chosen by the config's ``chindex``) are ported: every model the
JAX package's zoo can build. The names it lists as unavailable (their
modules are absent from the reference's snapshot) have no port either.
A factory takes the compute ``dtype``, ``transformer_dropout`` and the
options its spec names as keywords and returns a module with
``compute_dtype``, ``reset_parameters(generator)`` and
``set_dropout_rng(rng)``, as ``MMVit4`` has. An option set for a model that
does not take it has no effect, as in the JAX package's ``_build_model``
(``corrifnet_tpu/run/main.py:48-67``), and ``create_model`` prints one line
naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from corrifnet_tpu_torch.models.deeplabv3p import DeepLabV3Plus
from corrifnet_tpu_torch.models.elanet import ELANet
from corrifnet_tpu_torch.models.enet import ENet
from corrifnet_tpu_torch.models.fassdnet import FASSDNet
from corrifnet_tpu_torch.models.mmvit2 import MMFormer, MMVit2
from corrifnet_tpu_torch.models.mmvit4 import MMVit4
from corrifnet_tpu_torch.models.multisenseseg import MultiSenseSeg
from corrifnet_tpu_torch.models.rfnet import RFNet
from corrifnet_tpu_torch.models.robustseg import RobustMseg
from corrifnet_tpu_torch.models.segformer import Segformer
from corrifnet_tpu_torch.models.unet import UNetV2

__all__ = ["ModelSpec", "available_models", "create_model", "get_spec"]


# the model options of create_model and their defaults (no effect when unset)
_OPTION_DEFAULTS = {"pallas_fused_blocks": False, "decoder_lean": None,
                    "depth_mode": "full", "fuse_expand_bn": False,
                    "decoder_remat": False, "decoder_chunk": 0, "remat_mode": "all"}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    factory: Callable[..., nn.Module]
    input_kind: str  # '5d': (B, 3 modalities, 3 bands, H, W); '4d': (B, 3 bands, H, W)
    options: Tuple[str, ...] = tuple(_OPTION_DEFAULTS)  # the ones the factory takes


_REGISTRY: Dict[str, ModelSpec] = {
    "MMVit4": ModelSpec("MMVit4", MMVit4, "5d"),
    "MMVit2": ModelSpec("MMVit2", MMVit2, "5d", options=("depth_mode",)),
    "mmformer": ModelSpec("mmformer", MMFormer, "5d", options=("depth_mode",)),
    "RFNet": ModelSpec("RFNet", RFNet, "5d", options=()),
    "RobustMseg": ModelSpec("RobustMseg", RobustMseg, "5d", options=()),
    "MultiSenseSeg": ModelSpec("MultiSenseSeg", MultiSenseSeg, "5d", options=()),
    "UNetV2": ModelSpec("UNetV2", UNetV2, "4d", options=()),
    "Segformer": ModelSpec("Segformer", Segformer, "4d", options=()),
    "DeepLabv3_plus": ModelSpec("DeepLabv3_plus", DeepLabV3Plus, "4d", options=()),
    "ELANet": ModelSpec("ELANet", ELANet, "4d", options=()),
    "FASSDNet": ModelSpec("FASSDNet", FASSDNet, "4d", options=()),
    "ENet": ModelSpec("ENet", ENet, "4d", options=()),
}


def get_spec(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"modeltype {name!r} has no PyTorch port; see ROADMAP.md"
        )
    return _REGISTRY[name]


def available_models():
    """The model ids of the registry, sorted."""
    return sorted(_REGISTRY)


def create_model(name: str, dtype=torch.float32, device="cpu", seed: int = 0,
                 transformer_dropout: float = 0.1,
                 pallas_fused_blocks: bool = False,
                 decoder_lean: "bool | None" = None,
                 depth_mode: str = "full", fuse_expand_bn: bool = False,
                 decoder_remat: bool = False, decoder_chunk: int = 0,
                 remat_mode: str = "all"):
    """Build ``name`` in eval mode with f32 parameters drawn from ``seed``
    (on the CPU, so weights do not depend on the device), compute dtype
    ``dtype``, on ``device``. ``transformer_dropout`` acts in training mode;
    ``pallas_fused_blocks`` runs the encoder bottlenecks through the fused
    convolution kernels (same parameters, same ``state_dict``);
    ``decoder_lean`` chooses the decoder's lean backward (None: at batch <=
    4, the JAX package's rule); ``depth_mode``, ``fuse_expand_bn``,
    ``decoder_remat``, ``decoder_chunk`` and ``remat_mode`` (the encoders'
    tail blocks rematerialized in training, JAX's default ``"all"``) as the
    JAX model's (``models/mmvit4.py``, ``models/decoder.py``,
    ``models/resnet3d.py``). All are MMVit4's
    options; MMVit2 and mmformer take ``depth_mode`` alone and run their
    decoder by the batch rule, and no other model takes any."""
    spec = get_spec(name)
    given = {"pallas_fused_blocks": pallas_fused_blocks, "decoder_lean": decoder_lean,
             "depth_mode": depth_mode, "fuse_expand_bn": fuse_expand_bn,
             "decoder_remat": decoder_remat, "decoder_chunk": decoder_chunk,
             "remat_mode": remat_mode}
    inert = [f"{k}={v!r}" for k, v in given.items()
             if k not in spec.options and v != _OPTION_DEFAULTS[k]]
    if inert:
        print(f"config: {', '.join(inert)} have no effect on {name} (as in the JAX "
              "package)")
    model = spec.factory(dtype=dtype, transformer_dropout=transformer_dropout,
                         **{k: v for k, v in given.items() if k in spec.options})
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
