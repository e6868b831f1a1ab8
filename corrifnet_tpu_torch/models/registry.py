"""Model registry of the port, keyed by the reference's ``modeltype`` strings.

Counterpart of ``corrifnet_tpu/models/registry.py``: a table of specs (name,
factory, input kind, the model options it takes). MMVit4 (CorrIFNet), MMVit2,
mmformer, RFNet and RobustMseg are ported; every other model of the JAX
package's zoo is still to be ported (see ROADMAP.md). A factory takes the
compute ``dtype``, ``transformer_dropout`` and the options its spec names as
keywords and returns a module with ``compute_dtype``,
``reset_parameters(generator)`` and ``set_dropout_rng(rng)``, as ``MMVit4``
has. An option set for a model that
does not take it has no effect, as in the JAX package's ``_build_model``
(``corrifnet_tpu/run/main.py:48-67``), and ``create_model`` prints one line
naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from corrifnet_tpu_torch.models.mmvit2 import MMFormer, MMVit2
from corrifnet_tpu_torch.models.mmvit4 import MMVit4
from corrifnet_tpu_torch.models.rfnet import RFNet
from corrifnet_tpu_torch.models.robustseg import RobustMseg

__all__ = ["ModelSpec", "create_model", "get_spec"]


# the model options of create_model and their defaults (no effect when unset)
_OPTION_DEFAULTS = {"pallas_fused_blocks": False, "decoder_lean": None}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    factory: Callable[..., nn.Module]
    input_kind: str  # '5d': (B, 3 modalities, 3 bands, H, W)
    options: Tuple[str, ...] = tuple(_OPTION_DEFAULTS)  # the ones the factory takes


_REGISTRY: Dict[str, ModelSpec] = {
    "MMVit4": ModelSpec("MMVit4", MMVit4, "5d"),
    "MMVit2": ModelSpec("MMVit2", MMVit2, "5d", options=()),
    "mmformer": ModelSpec("mmformer", MMFormer, "5d", options=()),
    "RFNet": ModelSpec("RFNet", RFNet, "5d", options=()),
    "RobustMseg": ModelSpec("RobustMseg", RobustMseg, "5d", options=()),
}


def get_spec(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"modeltype {name!r} is not ported to PyTorch yet; see ROADMAP.md"
        )
    return _REGISTRY[name]


def create_model(name: str, dtype=torch.float32, device="cpu", seed: int = 0,
                 transformer_dropout: float = 0.1,
                 pallas_fused_blocks: bool = False,
                 decoder_lean: "bool | None" = None):
    """Build ``name`` in eval mode with f32 parameters drawn from ``seed``
    (on the CPU, so weights do not depend on the device), compute dtype
    ``dtype``, on ``device``. ``transformer_dropout`` acts in training mode;
    ``pallas_fused_blocks`` runs the encoder bottlenecks through the fused
    convolution kernels (same parameters, same ``state_dict``);
    ``decoder_lean`` chooses the decoder's lean backward (None: at batch <=
    4, the JAX package's rule). The two options are MMVit4's: MMVit2 and
    mmformer run their decoder by the batch rule, and no other model takes
    either."""
    spec = get_spec(name)
    given = {"pallas_fused_blocks": pallas_fused_blocks, "decoder_lean": decoder_lean}
    inert = [f"{k}={v!r}" for k, v in given.items()
             if k not in spec.options and v != _OPTION_DEFAULTS[k]]
    if inert:
        print(f"config: {', '.join(inert)} have no effect on {name} (as in the JAX "
              "package)")
    model = spec.factory(dtype=dtype, transformer_dropout=transformer_dropout,
                         **{k: v for k, v in given.items() if k in spec.options})
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
