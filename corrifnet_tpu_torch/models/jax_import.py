"""JAX MMVit4, MMVit2 and mmformer variables and gradients -> the port's names.

``mmvit4_state_dict_from_variables`` is the inverse of
``corrifnet_tpu.models.torch_import.mmvit4_variables_from_state_dict``. It
takes the JAX package's MMVit4 variables -- a nested dict of numpy arrays
with ``params`` and ``batch_stats`` -- in either tree layout
(``pack_stage1=True``, the default, or the unpacked one) and returns a
``state_dict`` that ``MMVit4.load_state_dict(..., strict=True)`` accepts.
Every step is a transpose, a reshape or an index: no value changes. It
imports no jax. ``batch_stats`` become the BatchNorm buffers, so the state
after a training step (parameters and running statistics) converts like
the initial one. ``mmvit4_named_gradients`` maps a JAX gradient tree (the
``params`` structure) onto the port's parameter names the same way, so
gradients compare tensor by tensor under ``named_parameters()``.
``mmvit2_state_dict_from_variables`` and ``mmvit2_named_gradients`` do the
same for MMVit2 and mmformer, inverting
``corrifnet_tpu.models.torch_import.mmvit2_variables_from_state_dict``.

Layouts (JAX -> PyTorch):
  * conv kernels (KD, KH, KW, I, O) -> (O, I, KD, KH, KW);
  * 1x1x1 convs the JAX package runs as Dense layers, (I, O) -> (O, I, 1, 1, 1);
  * Linear kernels (I, O) -> (O, I);
  * BatchNorm {scale, bias} + {mean, var} -> weight, bias, running_mean,
    running_var;
  * the three modality encoders and token streams are stacked on a leading
    modality axis (RGB, NIR, SWIR); tail bottlenecks on a scan axis after it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = [
    "flatten_variables",
    "mmvit2_named_gradients",
    "mmvit2_state_dict_from_variables",
    "mmvit4_named_gradients",
    "mmvit4_state_dict_from_variables",
    "unflatten_variables",
    "unpack_stage1_variables",
]

_MODALITIES = ("RGB", "NIR", "SWIR")
_LAYER_BLOCKS = {1: 3, 2: 4, 3: 6, 4: 3}  # resnet50 layer -> blocks
_CHAIN = ("d4_c1", "d4_c2", "d4_out", "d3_c1", "d3_c2", "d3_out",
          "d2_c1", "d2_c2", "d2_out", "d1_c1", "d1_c2", "d1_out")


def _t(a) -> torch.Tensor:
    """A contiguous copy as float32; a float64 array stays float64."""
    a = np.asarray(a)
    dtype = np.float64 if a.dtype == np.float64 else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype, order="C"))


def _conv_weight(kernel):
    return _t(np.transpose(np.asarray(kernel), (4, 3, 0, 1, 2)))


def _dense_as_conv(kernel):
    k = np.asarray(kernel)
    return _t(k.T.reshape(k.shape[1], k.shape[0], 1, 1, 1))


def _put(sd, key, tree, weight_fn):
    sd[f"{key}.weight"] = weight_fn(tree["kernel"])
    if "bias" in tree:
        sd[f"{key}.bias"] = _t(tree["bias"])


def _bn(sd, key, params, stats):
    sd[f"{key}.weight"] = _t(params["scale"])
    sd[f"{key}.bias"] = _t(params["bias"])
    if stats is not None:
        sd[f"{key}.running_mean"] = _t(stats["mean"])
        sd[f"{key}.running_var"] = _t(stats["var"])


def _child(tree, key):
    """``tree[key]``, or None for a missing tree (gradients have no stats)."""
    return None if tree is None else tree[key]


def _select(tree, *index):
    """Index every leaf of a nested dict."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _select(v, *index) for k, v in tree.items()}
    return np.asarray(tree)[index]


def _stack(trees, axis):
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees], axis) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees], axis=axis)


def unpack_stage1_variables(variables, modalities: int = 3) -> Dict:
    """Inverse of ``corrifnet_tpu.models.resnet3d.pack_stage1_variables``:
    the ``packed_stage1`` subtree moves back under ``encoders`` with its
    BatchNorm vectors (M*C,) -> (M, C) and the layer-1 tail blocks stacked
    on the scan axis. Trees without ``packed_stage1`` pass through."""
    if "packed_stage1" not in variables["params"]:
        return variables

    def unpack_module(name, tree):
        if "bn" in name:
            return {k: np.asarray(v).reshape(modalities, -1) for k, v in tree.items()}
        return tree

    def unpack_collection(col):
        col = dict(col)
        ps1 = col.pop("packed_stage1")
        enc = dict(col["encoders"])
        for name in ("stem_conv", "stem_bn"):
            if name in ps1:
                enc[name] = unpack_module(name, ps1[name])
        enc["layer1_block0"] = {
            k: unpack_module(k, v) for k, v in ps1["layer1_block0"].items()
        }
        tails = [ps1[f"layer1_b{bi}"]["block"] for bi in range(1, _LAYER_BLOCKS[1])]
        tails = [{k: unpack_module(k, v) for k, v in t.items()} for t in tails]
        enc["layer1_tail"] = {"blocks": {"block": _stack(tails, axis=1)}}
        col["encoders"] = enc
        return col

    return {
        name: unpack_collection(col) if name in ("params", "batch_stats") else col
        for name, col in variables.items()
    }


def _bottleneck(sd, key, params, stats):
    for ci in (1, 2, 3):
        sd[f"{key}.conv{ci}.weight"] = _conv_weight(params[f"conv{ci}"]["kernel"])
        _bn(sd, f"{key}.bn{ci}", params[f"bn{ci}"], _child(stats, f"bn{ci}"))
    if "down_conv" in params:
        sd[f"{key}.downsample.0.weight"] = _conv_weight(params["down_conv"]["kernel"])
        _bn(sd, f"{key}.downsample.1", params["down_bn"], _child(stats, "down_bn"))


def _encoder(sd, prefix, params, stats):
    sd[f"{prefix}.e1_c1.weight"] = _conv_weight(params["stem_conv"]["kernel"])
    _bn(sd, f"{prefix}.e1_bn", params["stem_bn"], _child(stats, "stem_bn"))
    for li, blocks in _LAYER_BLOCKS.items():
        layer = f"{prefix}.e{li + 1}"
        _bottleneck(sd, f"{layer}.0", params[f"layer{li}_block0"],
                    _child(stats, f"layer{li}_block0"))
        tail_p = params[f"layer{li}_tail"]["blocks"]["block"]
        tail_s = None
        if stats is not None:
            tail_s = stats[f"layer{li}_tail"]["blocks"]["block"]
        for bi in range(1, blocks):
            _bottleneck(sd, f"{layer}.{bi}", _select(tail_p, bi - 1),
                        _select(tail_s, bi - 1))
    for i in range(1, 6):
        _put(sd, f"{prefix}.adapt{i}", params[f"adapt{i}"], _conv_weight)
    _put(sd, f"{prefix}.conv6", params["conv6"], _conv_weight)


def _transformer(sd, prefix, params):
    j = 0
    attn = f"{prefix}.cross_attention_list.{j}.fn"
    sd[f"{attn}.norm.weight"] = _t(params[f"attn_norm_{j}"]["scale"])
    sd[f"{attn}.norm.bias"] = _t(params[f"attn_norm_{j}"]["bias"])
    a = params[f"attn_{j}"]
    sd[f"{attn}.fn.qkv.weight"] = _t(np.asarray(a["qkv"]["kernel"]).T)
    sd[f"{attn}.fn.proj.weight"] = _t(np.asarray(a["proj"]["kernel"]).T)
    sd[f"{attn}.fn.proj.bias"] = _t(a["proj"]["bias"])
    ffn = f"{prefix}.cross_ffn_list.{j}.fn"
    sd[f"{ffn}.norm.weight"] = _t(params[f"ffn_norm_{j}"]["scale"])
    sd[f"{ffn}.norm.bias"] = _t(params[f"ffn_norm_{j}"]["bias"])
    f = params[f"ffn_{j}"]
    for idx, name in ((0, "fc1"), (3, "fc2")):
        sd[f"{ffn}.fn.net.{idx}.weight"] = _t(np.asarray(f[name]["kernel"]).T)
        sd[f"{ffn}.fn.net.{idx}.bias"] = _t(f[name]["bias"])


def _decoder(sd, params):
    d = "decoder_fuse"
    _put(sd, f"{d}.final_conv", params["final_conv"], _conv_weight)
    if "RFM5_reduce" in params:  # MMVit4's; MMVit2 and mmformer have none
        _put(sd, f"{d}.RFM5_reduce", params["RFM5_reduce"], _conv_weight)
    for i in range(1, 6):
        for j in range(3):
            _put(sd, f"{d}.RFM{i}.fusion_layer.{j}.conv",
                 params[f"RFM{i}"][f"l{j}"]["conv"], _conv_weight)
    for name in _CHAIN:
        _put(sd, f"{d}.{name}.conv", params[name]["conv"], _conv_weight)


def mmvit4_state_dict_from_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX MMVit4 ``variables`` (packed or unpacked tree) -> port state_dict."""
    variables = unpack_stage1_variables(variables)
    params, stats = variables["params"], variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {}
    for mi, m in enumerate(_MODALITIES):
        _encoder(sd, f"{m}_encoder", _select(params["encoders"], mi),
                 _select(_child(stats, "encoders"), mi))
        stream = _select(params["modality_stream"], mi)
        _put(sd, f"{m}_encode_conv", stream["encode_conv"], _dense_as_conv)
        _transformer(sd, f"{m}_transformer", stream["transformer"])
        _put(sd, f"qkv_{m}", stream["qkv"], _dense_as_conv)
        sd[f"{m}_pos"] = _t(np.asarray(params["modality_pos"])[mi])
    sd["fused6_pos"] = _t(params["fused6_pos"])
    _put(sd, "fused6_encode_conv", params["fused6_encode_conv"], _dense_as_conv)
    _transformer(sd, "multimodal_transformer", params["multimodal_transformer"])
    _put(sd, "multimodal_decode_conv", params["multimodal_decode_conv"],
         _dense_as_conv)
    for i in range(1, 7):
        _put(sd, f"fusion{i}.conv", params[f"fusion{i}"]["conv"], _conv_weight)
    _decoder(sd, params["decoder"])
    return sd


def mmvit4_named_gradients(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of MMVit4's ``params`` (numpy arrays, packed or
    unpacked layout) -> {port parameter name: gradient}. A gradient moves
    with its parameter: the same transposes and indices, no value changes."""
    return mmvit4_state_dict_from_variables({"params": grads})


def _conv_encoder(sd, prefix, params):
    """One JAX ``ConvEncoder`` -> the reference's conv Encoder names: the
    bare ``e1_c1``, ``e{s}_c{c}.conv`` and ``conv6`` as ``conv``."""
    _put(sd, f"{prefix}.e1_c1", params["e1_c1"], _conv_weight)
    for si in range(1, 6):
        for ci in (1, 2, 3):
            if (si, ci) != (1, 1):
                name = f"e{si}_c{ci}"
                _put(sd, f"{prefix}.{name}.conv", params[name]["conv"], _conv_weight)
    _put(sd, f"{prefix}.conv", params["conv6"], _conv_weight)


def mmvit2_state_dict_from_variables(variables, mmformer: bool = False
                                     ) -> Dict[str, torch.Tensor]:
    """JAX MMVit2 (or, ``mmformer``, MMFormer) ``variables`` -> port
    state_dict. The modality axis 0 of ``encoders`` and ``modality_stream``
    is unstacked and ``modality_pos`` split into ``{m}_pos``. mmformer has no
    ``qkv_{m}``: the JAX tree's ``qkv`` leaves, which its forward never
    reads, must be zero (as ``mmvit2_variables_from_state_dict`` fills them)
    and are dropped; a non-zero one raises, since the tree is then MMVit2's
    (or holds weights that a conversion would lose)."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for mi, m in enumerate(_MODALITIES):
        _conv_encoder(sd, f"{m}_encoder", _select(params["encoders"], mi))
        stream = _select(params["modality_stream"], mi)
        _put(sd, f"{m}_encode_conv", stream["encode_conv"], _dense_as_conv)
        _transformer(sd, f"{m}_transformer", stream["transformer"])
        if not mmformer:
            _put(sd, f"qkv_{m}", stream["qkv"], _dense_as_conv)
        elif any(np.any(np.asarray(a) != 0) for a in stream["qkv"].values()):
            raise ValueError(
                f"mmformer variables with non-zero qkv leaves (modality {m}): an "
                "MMVit2 tree, or mmformer weights whose unused qkv was not zeroed")
        sd[f"{m}_pos"] = _t(np.asarray(params["modality_pos"])[mi])
    _transformer(sd, "multimodal_transformer", params["multimodal_transformer"])
    _put(sd, "multimodal_decode_conv", params["multimodal_decode_conv"], _dense_as_conv)
    _decoder(sd, params["decoder"])
    return sd


def mmvit2_named_gradients(grads, mmformer: bool = False) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of MMVit2's (or MMFormer's) ``params`` -> {port
    parameter name: gradient}, as ``mmvit4_named_gradients``; mmformer's
    ``qkv`` gradients are zero in JAX and have no parameter in the port."""
    return mmvit2_state_dict_from_variables({"params": grads}, mmformer)


def flatten_variables(tree, prefix="") -> Dict[str, np.ndarray]:
    """Nested dict -> {'params/encoders/.../kernel': array} (the ``.npz``
    layout ``run.evaluate --weights`` reads)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_variables(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_variables(flat: Mapping[str, np.ndarray]) -> Dict:
    """Inverse of :func:`flatten_variables`."""
    tree: Dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value)
    return tree
