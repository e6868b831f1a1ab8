"""JAX variables and gradients of the ported models -> the port's names.

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
``corrifnet_tpu.models.torch_import.mmvit2_variables_from_state_dict``;
``rfnet_*``, ``robustseg_*``, ``multisenseseg_*``, ``unetv2_*``,
``segformer_*``, ``deeplab_*``, ``elanet_*``, ``fassdnet_*`` and ``enet_*``
invert ``rfnet_variables_from_state_dict``,
``robustseg_variables_from_state_dict``,
``multisenseseg_variables_from_state_dict``,
``unetv2_variables_from_state_dict``,
``segformer_variables_from_state_dict``,
``deeplab_variables_from_state_dict``,
``elanet_variables_from_state_dict``,
``fassdnet_variables_from_state_dict`` and
``enet_variables_from_state_dict``. ``multisenseseg_*`` also reads the
trees of MultiSenseSeg's ``use_faster`` and ``aux`` options, which the
reference converter does not; ``extras_state_dict_from_variables`` converts
any block of ``corrifnet_tpu.models.extras`` to its port
(``models/extras.py``), one way only.

Layouts (JAX -> PyTorch):
  * conv kernels (KD, KH, KW, I, O) -> (O, I, KD, KH, KW), and 2-D ones
    (KH, KW, I, O) -> (O, I, KH, KW);
  * 1x1x1 convs the JAX package runs as Dense layers, (I, O) -> (O, I, 1, 1, 1);
  * Linear kernels (I, O) -> (O, I);
  * BatchNorm {scale, bias} + {mean, var} -> weight, bias, running_mean,
    running_var;
  * transposed-conv kernels (KH, KW, O, I) -> (I, O, KH, KW), the same
    transpose as a 2-D conv's; PReLU {alpha} -> weight; ELANet's CCA
    Conv1d taps (k, 1, 1) -> (1, 1, k);
  * the three modality encoders and token streams are stacked on a leading
    modality axis (RGB, NIR, SWIR); tail bottlenecks on a scan axis after it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from corrifnet_tpu_torch.models.deeplabv3p import XCEPTION_BLOCKS, rep_layout
from corrifnet_tpu_torch.models.enet import STAGE23 as ENET_STAGE23
from corrifnet_tpu_torch.models.fassdnet import N_LAYERS as FASSD_LAYERS
from corrifnet_tpu_torch.models.segformer import STAGE_KSP

__all__ = [
    "deeplab_named_gradients",
    "deeplab_state_dict_from_variables",
    "elanet_named_gradients",
    "elanet_state_dict_from_variables",
    "enet_named_gradients",
    "enet_state_dict_from_variables",
    "extras_state_dict_from_variables",
    "fassdnet_named_gradients",
    "fassdnet_state_dict_from_variables",
    "flatten_variables",
    "mmvit2_named_gradients",
    "mmvit2_state_dict_from_variables",
    "mmvit4_named_gradients",
    "mmvit4_state_dict_from_variables",
    "multisenseseg_named_gradients",
    "multisenseseg_state_dict_from_variables",
    "rfnet_named_gradients",
    "rfnet_state_dict_from_variables",
    "robustseg_named_gradients",
    "robustseg_state_dict_from_variables",
    "segformer_named_gradients",
    "segformer_state_dict_from_variables",
    "unetv2_named_gradients",
    "unetv2_state_dict_from_variables",
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
    k = np.asarray(kernel)
    return _t(np.transpose(k, (4, 3, 0, 1, 2) if k.ndim == 5 else (3, 2, 0, 1)))


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


def _rf_encoder(sd, prefix, params):
    for s in range(1, 5):
        for c in range(1, 4):
            _put(sd, f"{prefix}.e{s}_c{c}.conv", params[f"e{s}_c{c}"]["conv"], _conv_weight)


def rfnet_state_dict_from_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX RFNet ``variables`` -> port state_dict: the ``encoders`` modality
    axis unstacked into ``{m}_encoder``, the generators' and fusions' convs
    under the reference's Sequential indices."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for mi, m in enumerate(_MODALITIES):
        _rf_encoder(sd, f"{m}_encoder", _select(params["encoders"], mi))
    d = "decoder_fuse"
    for i in range(1, 5):
        prm, key = params[f"prm_generator{i}"], f"{d}.prm_generator{i}"
        for j in range(3):
            _put(sd, f"{key}.embedding_layer.{j}.conv", prm[f"emb{j}"]["conv"], _conv_weight)
        _put(sd, f"{key}.prm_layer.0.conv", prm["prm0"]["conv"], _conv_weight)
        _put(sd, f"{key}.prm_layer.1", prm["prm1"], _conv_weight)
    for i in range(1, 5):
        rfm, key = params[f"RFM{i}"], f"{d}.RFM{i}"
        _put(sd, f"{key}.modal_fusion.weight_layer.0", rfm["mf_w0"], _conv_weight)
        _put(sd, f"{key}.modal_fusion.weight_layer.2", rfm["mf_w1"], _conv_weight)
        for j in range(3):
            _put(sd, f"{key}.region_fusion.fusion_layer.{j}.conv", rfm[f"rf{j}"]["conv"],
                 _conv_weight)
            _put(sd, f"{key}.short_cut.{j}.conv", rfm[f"sc{j}"]["conv"], _conv_weight)
    for lvl in (3, 2, 1):
        for name in (f"d{lvl}_c1", f"d{lvl}_c2", f"d{lvl}_out"):
            _put(sd, f"{d}.{name}.conv", params[name]["conv"], _conv_weight)
    _put(sd, f"{d}.seg_layer", params["seg_layer"], _conv_weight)
    return sd


def rfnet_named_gradients(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of RFNet's ``params`` -> {port parameter name:
    gradient}, as ``mmvit4_named_gradients``."""
    return rfnet_state_dict_from_variables({"params": grads})


def _basic(sd, key, tree):
    """A BasicConv2d's bias-free kernel."""
    _put(sd, f"{key}.conv", tree["conv"], _conv_weight)


def robustseg_state_dict_from_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX RobustMseg ``variables`` -> port state_dict: the ``style_enc``
    and ``content_enc`` modality axes unstacked into the reference's
    ``style_enc_list.{m}`` and ``content_enc_list.{m}``, the reconstruction
    decoders (whose output nothing reads) kept."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for m in range(3):
        style, key = _select(params["style_enc"], m), f"style_enc_list.{m}"
        for i in range(5):
            _basic(sd, f"{key}.encoder.{i}", style[f"enc{i}"])
        _basic(sd, f"{key}.final", style["final"])
        content = _select(params["content_enc"], m)
        for lvl in range(1, 5):
            for c in range(1, 4):
                _basic(sd, f"content_enc_list.{m}.e{lvl}c{c}", content[f"e{lvl}c{c}"])
    for lvl in range(4):
        _basic(sd, f"content_attn.{lvl}", params[f"content_attn{lvl}"])
        _basic(sd, f"content_share.{lvl}", params[f"content_share{lvl}"])
    for i in range(3):
        rec, key = params[f"recon{i}"], f"recon_decoders.{i}"
        for name in ("l1", "l2", "l_mu", "l_sigma"):
            sd[f"{key}.mlp.{name}.weight"] = _t(np.asarray(rec["mlp"][name]["kernel"]).T)
            sd[f"{key}.mlp.{name}.bias"] = _t(rec["mlp"][name]["bias"])
        for j in range(4):
            for c in (1, 2):
                _basic(sd, f"{key}.res_blocks.{j}.conv{c}", rec[f"res{j}_conv{c}"])
        for j in range(3):
            _basic(sd, f"{key}.up_blocks.{j}.1", rec[f"up{j}"])
        _basic(sd, f"{key}.final", rec["final"])
    seg = params["seg_decoder"]
    for g in ("c3", "c2", "c1"):
        for i in (1, 2, 3):
            _basic(sd, f"seg_decoder.{g}_{i}", seg[f"{g}_{i}"])
    _basic(sd, "seg_decoder.final", seg["final"])
    return sd


def robustseg_named_gradients(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of RobustMseg's ``params`` -> {port parameter
    name: gradient}, as ``mmvit4_named_gradients``."""
    return robustseg_state_dict_from_variables({"params": grads})


def _linear_weight(kernel):
    return _t(np.asarray(kernel).T)


def _ln(sd, key, params):
    sd[f"{key}.weight"] = _t(params["scale"])
    sd[f"{key}.bias"] = _t(params["bias"])


def _cba(sd, key, params, stats, conv=0):
    """A ``_ConvBNAct``: its conv at index ``conv`` of the Sequential
    ``key``, its BatchNorm (if any) at the next index."""
    _put(sd, f"{key}.{conv}", params["conv"], _conv_weight)
    if "bn" in params:
        _bn(sd, f"{key}.{conv + 1}", params["bn"], _child(stats, "bn"))


def _se(sd, key, params):
    """SEAttention: the reference Sequential's convs at 1 and 3."""
    _put(sd, f"{key}.attn.1", params["fc1"]["conv"], _conv_weight)
    _put(sd, f"{key}.attn.3", params["fc2"]["conv"], _conv_weight)


def _mss_block(sd, key, params, stats):
    _ln(sd, f"{key}.norm1", params["norm1"])
    attn = params["attn"]
    _put(sd, f"{key}.attn.qkv", attn["qkv"], _linear_weight)
    _put(sd, f"{key}.attn.proj", attn["proj"], _linear_weight)
    sd[f"{key}.attn.relative_position_bias_table"] = _t(
        attn["relative_position_bias_table"])
    _bn(sd, f"{key}.norm2.1", params["norm2"], _child(stats, "norm2"))
    mlp, mlp_stats = params["mlp"], _child(stats, "mlp")
    _put(sd, f"{key}.mlp.convup.0", mlp["convup"]["conv"], _conv_weight)
    _cba(sd, f"{key}.mlp.dw_conv", mlp["dw"], _child(mlp_stats, "dw"))
    _put(sd, f"{key}.mlp.convdown", mlp["convdown"]["conv"], _conv_weight)


def multisenseseg_state_dict_from_variables(variables, depths=(2, 2, 8, 2)
                                            ) -> Dict[str, torch.Tensor]:
    """JAX MultiSenseSeg ``variables`` -> port state_dict under the
    reference's names (``build_MSEs_AMM``, ``build_pipeline``,
    ``build_neck``, ``build_decode_head``). ``depths``: the Swin stages'
    block counts the tree was built with. The AMM offset table and the
    window attention's relative position index are static in both packages
    and in neither tree. A tree of the ``use_faster`` model (the CNN
    backbone: ``backbone/layer{i}_block{j}/{c1,c2,short}``) and of ``aux``
    (``aux_conv``, ``aux_head``) converts under the JAX names, which the
    port's modules keep (the reference converter reads neither option);
    ``depths`` is then not read for the backbone."""
    params, stats = variables["params"], variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {}
    head = "build_MSEs_AMM"
    for i in range(3):
        p, s, key = params[f"MSE{i}"], _child(stats, f"MSE{i}"), f"{head}.MSEs.{i}"
        _cba(sd, f"{key}.conv1", p["conv1"], _child(s, "conv1"))
        _put(sd, f"{key}.conv2", p["conv2"]["conv"], _conv_weight)
        _cba(sd, f"{key}.conv3", p["conv3_dw"], _child(s, "conv3_dw"))
        _put(sd, f"{key}.conv3.2", p["conv3_pw"]["conv"], _conv_weight)
        _se(sd, f"{key}.attn", p["attn"])
    _cba(sd, f"{head}.smooth", params["smooth"], _child(stats, "smooth"))
    amm, key = params["AMM"], f"{head}.fuse_proj"
    _put(sd, f"{key}.short_cut_conv.0", amm["short_cut_conv"], _conv_weight)
    _ln(sd, f"{key}.short_cut_conv.1.1", amm["short_cut_ln"])
    for name, target in (("q", "q"), ("k", "k"), ("v", "v"), ("q_proj", "q_proj.1"),
                         ("k_proj", "k_proj.1"), ("v_proj", "v_proj")):
        _put(sd, f"{key}.{target}", amm[name], _conv_weight)
    sd[f"{key}.logit_scale"] = _t(amm["logit_scale"])
    _put(sd, f"{key}.cpb_mlp.0", amm["cpb_fc1"], _linear_weight)
    _put(sd, f"{key}.cpb_mlp.2", amm["cpb_fc2"], _linear_weight)
    _put(sd, f"{key}.proj.0", amm["proj1"]["conv"], _conv_weight)
    _put(sd, f"{key}.proj.2", amm["proj2"]["conv"], _conv_weight)
    _ln(sd, f"{key}.norm.1", amm["norm"])

    bb, bb_stats = params["backbone"], _child(stats, "backbone")
    if "layer1_block0" in bb:  # use_faster: the CNN backbone, JAX's names
        for name, block in bb.items():
            for part in ("c1", "c2", "short"):
                if part in block:
                    _cba(sd, f"build_pipeline.{name}.{part}", block[part],
                         _child(_child(bb_stats, name), part))
        depths = ()
    for li, depth in enumerate(depths):
        for i in range(depth):
            name = f"stage{li}_block{i}"
            _mss_block(sd, f"build_pipeline.layers.{li}.long_blocks.{i}", bb[name],
                       _child(bb_stats, name))
        _ln(sd, f"build_pipeline.norm{li}", bb[f"out_norm{li}"])
        if li < len(depths) - 1:
            merge = bb[f"merge{li}"]
            _ln(sd, f"build_pipeline.layers.{li}.downsample.ln", merge["ln"])
            _put(sd, f"build_pipeline.layers.{li}.downsample.reduction", merge["reduction"],
                 _linear_weight)

    if "aux_conv" in params:  # aux: JAX's names
        _cba(sd, "aux_conv", params["aux_conv"], _child(stats, "aux_conv"))
        _put(sd, "aux_head", params["aux_head"], _conv_weight)

    ppm, ppm_stats = params["ppm"], _child(stats, "ppm")
    for i in range(4):
        _put(sd, f"build_neck.ppm_head.pool_projs.{i}.1", ppm[f"pool_proj{i}"], _conv_weight)
    _cba(sd, "build_neck.ppm_head.bottom", ppm["bottom"], _child(ppm_stats, "bottom"))
    fpn, fpn_stats = params["fpn"], _child(stats, "fpn")
    for i in range(sum(k.startswith("conv_") for k in fpn)):
        _cba(sd, f"build_neck.fpn_neck.conv_.{i}", fpn[f"conv_{i}"],
             _child(fpn_stats, f"conv_{i}"))
        _cba(sd, f"build_neck.fpn_neck.fpn_conv.{i}", fpn[f"fpn_conv{i}"],
             _child(fpn_stats, f"fpn_conv{i}"))
    _cba(sd, "build_neck.fpn_neck.out", fpn["out"], _child(fpn_stats, "out"))

    dg, dg_stats, d = params["decode_gate"], _child(stats, "decode_gate"), "build_decode_head"
    _cba(sd, f"{d}.conv", dg["conv"], _child(dg_stats, "conv"))
    _put(sd, f"{d}.spat_attn.conv1.1", dg["sa_conv1"], _conv_weight)
    _bn(sd, f"{d}.spat_attn.conv1.2", dg["sa_bn1"], _child(dg_stats, "sa_bn1"))
    _cba(sd, f"{d}.spat_attn.conv2", dg["sa_conv2"], _child(dg_stats, "sa_conv2"))
    _cba(sd, f"{d}.spat_attn.attn", dg["sa_attn"], _child(dg_stats, "sa_attn"), conv=1)
    _se(sd, f"{d}.chan_attn", dg["chan_attn"])
    _cba(sd, f"{d}.dwconv", dg["dw1"], _child(dg_stats, "dw1"))
    _put(sd, f"{d}.dwconv.2", dg["dw2"]["conv"], _conv_weight)
    _put(sd, f"{d}.out.1", dg["out_conv"]["conv"], _conv_weight)
    return sd


def multisenseseg_named_gradients(grads, depths=(2, 2, 8, 2)) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of MultiSenseSeg's ``params`` -> {port parameter
    name: gradient}, as ``mmvit4_named_gradients``."""
    return multisenseseg_state_dict_from_variables({"params": grads}, depths)


def unetv2_state_dict_from_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX UNetV2 ``variables`` -> port state_dict: each DoubleConv's convs
    at indices 0 and 3 of the reference's ``conv`` Sequential, its
    BatchNorms at 1 and 4."""
    params, stats = variables["params"], variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {}
    keys = {"inc": "inc.conv.conv", **{f"down{i}": f"down{i}.mpconv.2.conv" for i in range(1, 5)},
            **{f"up{i}": f"up{i}.conv.conv" for i in range(1, 5)}}
    for name, key in keys.items():
        p, s = params[name], _child(stats, name)
        for i, idx in enumerate((0, 3)):
            _put(sd, f"{key}.{idx}", p[f"conv{i}"], _conv_weight)
            _bn(sd, f"{key}.{idx + 1}", p[f"bn{i}"], _child(s, f"bn{i}"))
    _put(sd, "outc.conv", params["outc"], _conv_weight)
    return sd


def unetv2_named_gradients(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of UNetV2's ``params`` -> {port parameter name:
    gradient}, as ``mmvit4_named_gradients``."""
    return unetv2_state_dict_from_variables({"params": grads})


def segformer_state_dict_from_variables(variables, debug_variant: bool = False
                                        ) -> Dict[str, torch.Tensor]:
    """JAX Segformer ``variables`` -> port state_dict under the reference's
    names: each patch embed's (k, k, I, O) kernel as the reference's
    ``(O, I*k*k, 1, 1)`` 1x1 weight, the ChannelNorms' ``g``/``b`` as
    ``(1, C, 1, 1)``; the head as ``to_segmentation.{0,1}``, or with
    ``debug_variant`` the orphan F32 model's ``to_segmentation1/2``."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for si, (k, _, _) in enumerate(STAGE_KSP):
        embed = np.asarray(params[f"s{si}_embed"]["kernel"])
        sd[f"mit.stages.{si}.1.weight"] = _t(
            np.transpose(embed, (3, 2, 0, 1)).reshape(embed.shape[3], -1, 1, 1))
        sd[f"mit.stages.{si}.1.bias"] = _t(params[f"s{si}_embed"]["bias"])
        li = 0
        while f"s{si}_l{li}_attn" in params:
            base, name = f"mit.stages.{si}.2.{li}", f"s{si}_l{li}"
            for j, norm in ((0, "norm1"), (1, "norm2")):
                for leaf in ("g", "b"):
                    sd[f"{base}.{j}.norm.{leaf}"] = _t(
                        np.asarray(params[f"{name}_{norm}"][leaf]).reshape(1, -1, 1, 1))
            for conv in ("to_q", "to_kv", "to_out"):
                _put(sd, f"{base}.0.fn.{conv}", params[f"{name}_attn"][conv], _conv_weight)
            ff = params[f"{name}_ff"]
            for conv, key in (("fc1", "0"), ("dw", "1.net.0"), ("pw", "1.net.1"), ("fc2", "3")):
                _put(sd, f"{base}.1.fn.net.{key}", ff[conv], _conv_weight)
            li += 1
        _put(sd, f"to_fused.{si}.0", params[f"fuse{si}"], _conv_weight)
    head = ("to_segmentation1", "to_segmentation2") if debug_variant else (
        "to_segmentation.0", "to_segmentation.1")
    _put(sd, head[0], params["seg1"], _conv_weight)
    _put(sd, head[1], params["seg2"], _conv_weight)
    return sd


def segformer_named_gradients(grads, debug_variant: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of Segformer's ``params`` -> {port parameter
    name: gradient}, as ``mmvit4_named_gradients``."""
    return segformer_state_dict_from_variables({"params": grads}, debug_variant)


def _sepconv(sd, key, params):
    """SeparableConvSame {dw, pw} -> ``{key}.conv1`` and ``{key}.pointwise``."""
    _put(sd, f"{key}.conv1", params["dw"], _conv_weight)
    _put(sd, f"{key}.pointwise", params["pw"], _conv_weight)


def deeplab_state_dict_from_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX DeepLabV3Plus ``variables`` -> port state_dict under the
    reference's names: each Xception block's ``sep{j}``/``bn{j}`` at its
    place in the ``rep`` Sequential, ReLUs counted (``rep_layout``);
    ``aspp{i}``/``aspp{i}_bn`` as ``aspp{i}.atrous_convolution`` and
    ``.batch_norm``; ``image_pool.1``, ``fc1.{0,1}``, ``reduce_conv2.{0,1}``
    and ``last_conv.{0,1,4,5,8}``."""
    params, stats = variables["params"], variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {}
    xp, xs, x = params["xception"], _child(stats, "xception"), "xception_features"
    for name in ("conv1", "conv2"):
        _put(sd, f"{x}.{name}", xp[name], _conv_weight)
    for name in ("bn1", "bn2"):
        _bn(sd, f"{x}.{name}", xp[name], _child(xs, name))
    for name, (_, reps, stride, swr, grow, last) in XCEPTION_BLOCKS.items():
        bp, bs, key = xp[name], _child(xs, name), f"{x}.{name}"
        seq = rep_layout(reps, stride, swr, grow, last)
        j = 0
        for pos, kind in enumerate(seq):
            if kind != "sep":
                continue
            _sepconv(sd, f"{key}.rep.{pos}", bp[f"sep{j}"])
            if pos + 1 < len(seq) and seq[pos + 1] == "bn":
                _bn(sd, f"{key}.rep.{pos + 1}", bp[f"bn{j}"], _child(bs, f"bn{j}"))
            j += 1
        if "skip" in bp:
            _put(sd, f"{key}.skip", bp["skip"], _conv_weight)
            _bn(sd, f"{key}.skipbn", bp["skipbn"], _child(bs, "skipbn"))
    for i in (3, 4, 5):
        _sepconv(sd, f"{x}.conv{i}", xp[f"conv{i}"])
        _bn(sd, f"{x}.bn{i}", xp[f"bn{i}"], _child(xs, f"bn{i}"))
    for i in range(1, 5):
        _put(sd, f"aspp{i}.atrous_convolution", params[f"aspp{i}"], _conv_weight)
        _bn(sd, f"aspp{i}.batch_norm", params[f"aspp{i}_bn"], _child(stats, f"aspp{i}_bn"))
    _put(sd, "image_pool.1", params["image_pool"], _conv_weight)
    for conv, norm in (("fc1", "fc1_bn"), ("reduce_conv2", "reduce_bn")):
        _put(sd, f"{conv}.0", params[conv], _conv_weight)
        _bn(sd, f"{conv}.1", params[norm], _child(stats, norm))
    for j, (ci, bi) in enumerate(((0, 1), (4, 5))):
        _put(sd, f"last_conv.{ci}", params[f"last_conv{j}"], _conv_weight)
        _bn(sd, f"last_conv.{bi}", params[f"last_bn{j}"], _child(stats, f"last_bn{j}"))
    _put(sd, "last_conv.8", params["classifier"], _conv_weight)
    return sd


def deeplab_named_gradients(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of DeepLabV3Plus's ``params`` -> {port parameter
    name: gradient}, as ``mmvit4_named_gradients``."""
    return deeplab_state_dict_from_variables({"params": grads})


def _prelu(sd, key, params):
    sd[f"{key}.weight"] = _t(params["alpha"])


def _ela_bnp(sd, key, params, stats):
    """ELANet's BNPReLU {bn, act}."""
    _bn(sd, f"{key}.bn", params["bn"], _child(stats, "bn"))
    _prelu(sd, f"{key}.act", params["act"])


def _ela_cbp(sd, key, params, stats):
    """ELANet's ConvBNPReLU {conv, bn, act}."""
    _put(sd, f"{key}.conv", params["conv"], _conv_weight)
    _ela_bnp(sd, key, params, stats)


def _ela_cca(sd, key, params):
    for leaf, idx in (("w1", 0), ("w2", 2)):
        sd[f"{key}.conv.{idx}.weight"] = _t(np.transpose(np.asarray(params[leaf]), (2, 1, 0)))


def _ela_ecg(sd, key, params, stats):
    """ECG_D or ECG_R: its ConvBNPReLUs, channelwise convs, BNPReLUs (ECG_D's
    own bn and act), ``reduce`` and CCA, each under its own name."""
    for name, p in params.items():
        s = None if stats is None else stats.get(name)
        if name == "CA":
            _ela_cca(sd, f"{key}.CA", p)
        elif name == "act":
            _prelu(sd, f"{key}.act", p)
        elif name == "bn":
            _bn(sd, f"{key}.bn", p, s)
        elif "conv" in p and "bn" in p:
            _ela_cbp(sd, f"{key}.{name}", p, s)
        elif "bn" in p:
            _ela_bnp(sd, f"{key}.{name}", p, s)
        else:  # F_loc/F_sur, reduce: the wrapped conv
            _put(sd, f"{key}.{name}.conv", p, _conv_weight)


def _ela_wdconv(sd, key, params, stats):
    _put(sd, f"{key}.conv", params["conv"], _conv_weight)
    _ela_bnp(sd, f"{key}.bnpre", params["bnpre"], _child(stats, "bnpre"))


def elanet_state_dict_from_variables(variables, M: int = 2, N: int = 5
                                     ) -> Dict[str, torch.Tensor]:
    """JAX ELANet ``variables`` -> port state_dict under the reference's
    names: ``level2_r{i}``/``level3_r{i}`` as ``level2.{i}``/``level3.{i}``,
    the decoder's ``Xd1_wd``/``_pw``/``_bnp`` as ``Xd1.{0,1,2}`` (and so
    ``Xd2_1``), ``Xb_1`` as ``Xb_1.0``, SCA's ``c1``/``dw``/``bnp``/``out``
    as ``SA.conv.{0,1,2,3}``, the classifier as ``classifier.0.conv``."""
    params, stats = variables["params"], variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {}
    for i in range(3):
        _ela_cbp(sd, f"level1_{i}", params[f"level1_{i}"], _child(stats, f"level1_{i}"))
    blocks = {"level2_0": "level2_0", **{f"level2_r{i}": f"level2.{i}" for i in range(M)},
              "level3_0": "level3_0",
              **{f"level3_r{i}": f"level3.{i}" for i in range(2 * N - 1)}}
    for name, key in blocks.items():
        _ela_ecg(sd, key, params[name], _child(stats, name))
    for name in ("b1", "bn_prelu_2", "bn_prelu_3"):
        _ela_bnp(sd, name, params[name], _child(stats, name))
    dp, ds = params["decode"], _child(stats, "decode")
    for name, key in (("Xd1", "decode.Xd1.0"), ("Xd2", "decode.Xd2"),
                      ("Xd2_1", "decode.Xd2_1.0")):
        _ela_wdconv(sd, key, dp[f"{name}_wd"], _child(ds, f"{name}_wd"))
    for name in ("Xd1", "Xd2_1"):
        _put(sd, f"decode.{name}.1", dp[f"{name}_pw"], _conv_weight)
        _ela_bnp(sd, f"decode.{name}.2", dp[f"{name}_bnp"], _child(ds, f"{name}_bnp"))
    _put(sd, "decode.Xb_1.0", dp["Xb_1"], _conv_weight)
    _ela_cca(sd, "decode.CA", dp["CA"])
    sap, sas = dp["SA"], _child(ds, "SA")
    _ela_cbp(sd, "decode.SA.conv.0", sap["c1"], _child(sas, "c1"))
    _put(sd, "decode.SA.conv.1.conv", sap["dw"], _conv_weight)
    _ela_bnp(sd, "decode.SA.conv.2", sap["bnp"], _child(sas, "bnp"))
    _put(sd, "decode.SA.conv.3", sap["out"], _conv_weight)
    _ela_bnp(sd, "decode.bnpre", dp["bnpre"], _child(ds, "bnpre"))
    _put(sd, "classifier.0.conv", params["classifier"], _conv_weight)
    return sd


def elanet_named_gradients(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of ELANet's ``params`` -> {port parameter name:
    gradient}, as ``mmvit4_named_gradients``."""
    return elanet_state_dict_from_variables({"params": grads})


def _fassd_convlayer(sd, key, params, stats):
    _put(sd, f"{key}.conv", params["conv"], _conv_weight)
    _bn(sd, f"{key}.norm", params["norm"], _child(stats, "norm"))


def _fassd_hardblock(sd, key, params, stats, n_layers):
    for i in range(n_layers):
        _fassd_convlayer(sd, f"{key}.layers.{i}", params[f"layer{i}"],
                         _child(stats, f"layer{i}"))


def _fassd_bnprelu(sd, key, params, stats):
    """FASSDNet's BNPReLU {bn, act}, its PReLU named ``acti``."""
    _bn(sd, f"{key}.bn", params["bn"], _child(stats, "bn"))
    _prelu(sd, f"{key}.acti", params["act"])


_MDA_CONVS = (("conv3x3", "conv3x3"), ("par_conv3x3", "parallel_conv3x3"),
              ("par_ddconv3x1", "parallel_ddconv3x1"), ("par_ddconv1x3", "parallel_ddconv1x3"))


def fassdnet_state_dict_from_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX FASSDNet ``variables`` -> port state_dict under the reference's
    names: ``stem{i}`` as ``base.{i}``, ``hard{i}``/``trans{i}`` as
    ``base.{4 + 3i}``/``base.{5 + 3i}``, the decoder's ``up_conv{i}``,
    ``mda{i}`` and ``hard_up{i}`` as ``conv1x1_up.{i}``, ``mda.{i}`` and
    ``denseBlocksUp.{i}``, MDA's ``par_*`` convs as ``parallel_*``."""
    params, stats = variables["params"], variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {}

    def sub(name):
        return params[name], _child(stats, name)

    for i in range(4):
        _fassd_convlayer(sd, f"base.{i}", *sub(f"stem{i}"))
    for i, n in enumerate(FASSD_LAYERS):
        _fassd_hardblock(sd, f"base.{4 + 3 * i}", *sub(f"hard{i}"), n)
        _fassd_convlayer(sd, f"base.{5 + 3 * i}", *sub(f"trans{i}"))
    p, s = sub("DAPF")
    _put(sd, "DAPF.conv1x1", p["conv1x1"], _conv_weight)
    _bn(sd, "DAPF.bn1x1", p["bn1x1"], _child(s, "bn1x1"))
    for i in (2, 3, 4):
        bp, bs, key = p[f"pyBranch{i}"], _child(s, f"pyBranch{i}"), f"DAPF.pyBranch{i}"
        for conv, norm in (("conv3x1", "bn3x1"), ("conv1x3", "bn1x3")):
            _put(sd, f"{key}.atrous_{conv}", bp[conv], _conv_weight)
            _bn(sd, f"{key}.{norm}", bp[norm], _child(bs, norm))
    _put(sd, "DAPF.conv1", p["conv1"], _conv_weight)
    _bn(sd, "DAPF.bn1", p["bn1"], _child(s, "bn1"))
    for di in range(len(FASSD_LAYERS) - 1):
        _fassd_convlayer(sd, f"conv1x1_up.{di}", *sub(f"up_conv{di}"))
        mp, ms, key = *sub(f"mda{di}"), f"mda.{di}"
        for name in ("bn_relu_1", "bn_relu_2"):
            _fassd_bnprelu(sd, f"{key}.{name}", mp[name], _child(ms, name))
        for mine, ref in _MDA_CONVS:
            _put(sd, f"{key}.{ref}.conv", mp[f"{mine}_conv"], _conv_weight)
            _fassd_bnprelu(sd, f"{key}.{ref}.bn_prelu", mp[f"{mine}_bnp"],
                           _child(ms, f"{mine}_bnp"))
        _put(sd, f"{key}.conv1x1.conv", mp["conv1x1"], _conv_weight)
        _fassd_hardblock(sd, f"denseBlocksUp.{di}", *sub(f"hard_up{di}"),
                         FASSD_LAYERS[len(FASSD_LAYERS) - 2 - di])
    _put(sd, "finalConv", params["finalConv"], _conv_weight)
    return sd


def fassdnet_named_gradients(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of FASSDNet's ``params`` -> {port parameter name:
    gradient}, as ``mmvit4_named_gradients``."""
    return fassdnet_state_dict_from_variables({"params": grads})


# the JAX module's names of the stage-2/3 bottlenecks, in ENET_STAGE23's order
_ENET_JAX_STAGE23 = ("regular{s}_a", "dilated{s}_b", "asym{s}_c", "dilated{s}_d",
                     "regular{s}_e", "dilated{s}_f", "asym{s}_g", "dilated{s}_h")


def _enet_regulars():
    """[(JAX name, reference name)] of ENet's regular bottlenecks."""
    pairs = [(f"regular1_{i}", f"regular1_{i}") for i in range(1, 5)]
    for stage, first in ((2, 1), (3, 0)):
        pairs += [(mine.format(s=stage), ref.format(s=stage, i=first + j))
                  for j, (mine, (ref, _)) in enumerate(zip(_ENET_JAX_STAGE23, ENET_STAGE23))]
    return pairs + [(n, n) for n in ("regular4_1", "regular4_2", "regular5_1")]


def _enet_seq(sd, key, params, stats, convs):
    """Conv/BatchNorm pairs of a Sequential: [(conv, norm, conv's index)]."""
    for conv, norm, idx in convs:
        _put(sd, f"{key}.{idx}", params[conv], _conv_weight)
        _bn(sd, f"{key}.{idx + 1}", params[norm], _child(stats, norm))


def _enet_act(sd, key, params, places):
    """The bottleneck's one PReLU slope (none for ReLU) under every key that
    the reference's ``state_dict`` holds it."""
    if "act" in params:
        for place in places:
            _prelu(sd, f"{key}.{place}", params["act"]["prelu"])


def enet_state_dict_from_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX ENet ``variables`` -> port state_dict under the reference's
    names: ``init_*`` as ``initial_block``'s, ``down{s}_0``/``up{s}_0`` as
    ``downsample{s}_0``/``upsample{s}_0``, the stage-2/3 bottlenecks ``a``
    to ``h`` by the reference's numbering, each bottleneck's ``c{i}``/
    ``bn{i}`` as ``ext_conv{i}.{0,1}`` (an asymmetric one's ``c2a``/``c2b``
    at ``ext_conv2.0`` and ``.3``), ``main_c1``/``main_bn`` as
    ``main_conv1.{0,1}``; an encoder bottleneck's PReLU slope under each of
    its keys (``ext_conv{i}.2``, ``ext_conv2.5``, ``out_prelu``)."""
    params, stats = variables["params"], variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {}

    def sub(name):
        return params[name], _child(stats, name)

    _put(sd, "initial_block.main_branch", params["init_conv"], _conv_weight)
    _bn(sd, "initial_block.batch_norm", params["init_bn"], _child(stats, "init_bn"))
    _enet_act(sd, "initial_block", {"act": params["init_act"]}, ("out_prelu",))
    acts = ("ext_conv1.2", "ext_conv2.2", "ext_conv3.2", "out_prelu")
    for stage in (1, 2):
        (p, s), key = sub(f"down{stage}_0"), f"downsample{stage}_0"
        for i in (1, 2, 3):
            _enet_seq(sd, f"{key}.ext_conv{i}", p, s, [(f"c{i}", f"bn{i}", 0)])
        _enet_act(sd, key, p, acts)
    for mine, key in _enet_regulars():
        p, s = sub(mine)
        _enet_seq(sd, f"{key}.ext_conv1", p, s, [("c1", "bn1", 0)])
        asym = mine.startswith("asym")
        _enet_seq(sd, f"{key}.ext_conv2", p, s,
                  [("c2a", "bn2a", 0), ("c2b", "bn2b", 3)] if asym else [("c2", "bn2", 0)])
        _enet_seq(sd, f"{key}.ext_conv3", p, s, [("c3", "bn3", 0)])
        _enet_act(sd, key, p, acts + (("ext_conv2.5",) if asym else ()))
    for stage in (4, 5):
        (p, s), key = sub(f"up{stage}_0"), f"upsample{stage}_0"
        _enet_seq(sd, f"{key}.main_conv1", p, s, [("main_c1", "main_bn", 0)])
        for i in (1, 2, 3):
            _enet_seq(sd, f"{key}.ext_conv{i}", p, s, [(f"c{i}", f"bn{i}", 0)])
        _enet_act(sd, key, p, acts)
    _put(sd, "transposed_conv", params["transposed_conv"], _conv_weight)
    return sd


def enet_named_gradients(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of ENet's ``params`` -> {port parameter name:
    gradient}, as ``mmvit4_named_gradients``; a bottleneck's one PReLU
    gradient under each of its names."""
    return enet_state_dict_from_variables({"params": grads})


def extras_state_dict_from_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX variables of any block of ``corrifnet_tpu.models.extras`` -> the
    state_dict of its port in ``corrifnet_tpu_torch.models.extras``, whose
    submodules carry the JAX names: a module with a ``kernel`` is a conv
    (4 axes) or a Linear layer (2 axes), with its ``bias`` if any; one with
    a ``scale`` is a BatchNorm where ``batch_stats`` has it, else a
    LayerNorm. Nested modules (a block's ``attn``, MultiScaleBlock's fusion
    blocks) nest the same way under ``.``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(params, stats, key):
        if "kernel" in params:
            k = np.asarray(params["kernel"])
            _put(sd, key, params, _conv_weight if k.ndim == 4 else _linear_weight)
        elif "scale" in params:
            if stats is not None and "mean" in stats:
                _bn(sd, key, params, stats)
            else:
                _ln(sd, key, params)
        else:
            for name, sub in params.items():
                walk(sub, _child(stats, name) if stats and name in stats else None,
                     f"{key}.{name}" if key else name)

    walk(variables["params"], variables.get("batch_stats"), "")
    return sd


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
