"""Re-evaluate a model over the test fold (allJaccardResults_irem_f1_jcrd.py).

Counterpart of ``corrifnet_tpu/run/evaluate.py:33-177``, on the port's own
config and data modules: config -> ``cross_val`` -> ``load_dstl`` (pack,
``.mat`` directories or synthetic) -> batches of
``max(mini_batch_size, 8)`` -> forward -> per-image (jaccard2, f1) on
modality channel 0 -> mean and std. A 4-D model (UNetV2, Segformer,
DeepLabv3_plus, ELANet, FASSDNet, ENet) is given modality 0 and channel 0 of the masks *whatever the
config's* ``chindex`` (the JAX package's ``evaluate_run`` does so,
``corrifnet_tpu/run/evaluate.py:99-100``): a 4-D model trained on NIR is
evaluated on RGB (ROADMAP.md, "Not faults").

Weights: ``--weights`` takes a ``.npz`` of the flattened JAX variable tree
(``/``-joined keys, e.g. ``params/encoders/conv6/kernel``) of the config's
``modeltype`` (MMVit4, MMVit2, mmformer, RFNet, RobustMseg, MultiSenseSeg,
UNetV2, Segformer, DeepLabv3_plus, ELANet, FASSDNet or ENet), converted by
``models.jax_import``, or a ``.pt`` ``state_dict``: the port's, or the
reference's (its BatchNorm step counters, UNetV2's dead up-sampling weights
and ENet's dead ``project_layer`` dropped, its static tables checked against
the port's).
Without it the model is initialized from ``cfg.seed``, and one JSON line
gives the result.

``--run-dir`` (or ``--manifest``: alternating run-name / run-directory
lines, allJaccardResults:45-52) evaluates each run's ``Finaliremmodel{index}``
(a port checkpoint: written by ``run.main`` or ``run.import_checkpoint``),
restored strictly, and prints one line per run,
``name: jaccard m±s f1 m±s (n=…)``; ``--segplot-dir`` writes the
``segplot_indexed`` PNGs of each test image of a 5-D model from a B=1
forward. A JAX run's orbax checkpoint is refused, naming
``scripts/export_jax_checkpoint.py``. Unlike the JAX package's
``evaluate_run``, which never reads ``data_dirs``, the data come from the
config as in a training run. The model is built with the compute dtype,
``pallas_fused_blocks`` and ``decoder_lean``; the training levers
``depth_mode``, ``fuse_expand_bn``, ``decoder_remat``, ``decoder_chunk``
and ``remat_mode`` (which acts in training alone) are not passed, as the JAX package's ``evaluate_run`` builds with
``create_model(modeltype, dtype)`` alone (``corrifnet_tpu/run/evaluate.py:
98``): a config with ``depth_mode: pruned`` is evaluated at full depth, and
one printed line says so.

    python -m corrifnet_tpu_torch.run.evaluate --config model0.txt \
        [--weights weights.npz | --run-dir RUN | --manifest runs.txt]
        [--index 0] [--segplot-dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import re
import time
from pathlib import Path

import numpy as np
import torch

from corrifnet_tpu_torch.config import check_supported, load_config
from corrifnet_tpu_torch.data import cross_val, load_dstl, make_batches
from corrifnet_tpu_torch.metrics import jaccard_f1_pair
from corrifnet_tpu_torch.models import (
    create_model,
    deeplab_state_dict_from_variables,
    elanet_state_dict_from_variables,
    enet_state_dict_from_variables,
    fassdnet_state_dict_from_variables,
    mmvit2_state_dict_from_variables,
    mmvit4_state_dict_from_variables,
    multisenseseg_state_dict_from_variables,
    rfnet_state_dict_from_variables,
    robustseg_state_dict_from_variables,
    segformer_state_dict_from_variables,
    unetv2_state_dict_from_variables,
)
from corrifnet_tpu_torch.models.jax_import import unflatten_variables
from corrifnet_tpu_torch.models.multisenseseg import _amm_relative_bias, _relative_position_index
from corrifnet_tpu_torch.models.registry import get_spec
from corrifnet_tpu_torch.run.segplot import segplot_indexed
from corrifnet_tpu_torch.train.checkpoint import Checkpointer, final_ckpt_name
from corrifnet_tpu_torch.utils.determinism import deterministic

__all__ = ["compute_dtype", "evaluate_run", "evaluation_arrays", "load_weights", "main",
           "per_image_metrics", "read_manifest", "restore_run", "write_segplots"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    """The torch compute dtype named by ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


# modeltype: the JAX tree -> port state_dict converter of its .npz
_CONVERTERS = {
    "MMVit4": mmvit4_state_dict_from_variables,
    "MMVit2": lambda v: mmvit2_state_dict_from_variables(v, mmformer=False),
    "mmformer": lambda v: mmvit2_state_dict_from_variables(v, mmformer=True),
    "RFNet": rfnet_state_dict_from_variables,
    "RobustMseg": robustseg_state_dict_from_variables,
    "MultiSenseSeg": multisenseseg_state_dict_from_variables,
    "UNetV2": unetv2_state_dict_from_variables,
    "Segformer": segformer_state_dict_from_variables,
    "DeepLabv3_plus": deeplab_state_dict_from_variables,
    "ELANet": elanet_state_dict_from_variables,
    "FASSDNet": fassdnet_state_dict_from_variables,
    "ENet": enet_state_dict_from_variables,
}


def _npz_model(params):
    """Which of the ported models a JAX ``params`` tree is (None: none of
    them): MMVit4 has the fused6 group, RFNet the region map generators,
    RobustMseg the content encoders, MultiSenseSeg AMM, UNetV2 ``outc``,
    Segformer its first patch embed, DeepLabv3_plus its Xception, ELANet
    ``level1_0``, FASSDNet ``DAPF``, ENet ``init_conv``; of the conv-encoder
    family, mmformer's unused qkv leaves are zero."""
    if "fused6_pos" in params:
        return "MMVit4"
    if "prm_generator4" in params:
        return "RFNet"
    if "content_enc" in params:
        return "RobustMseg"
    if "AMM" in params:
        return "MultiSenseSeg"
    if "outc" in params:
        return "UNetV2"
    if "s0_embed" in params:
        return "Segformer"
    if "xception" in params:
        return "DeepLabv3_plus"
    for key, name in (("level1_0", "ELANet"), ("DAPF", "FASSDNet"), ("init_conv", "ENet")):
        if key in params:
            return name
    qkv = params.get("modality_stream", {}).get("qkv")
    if "multimodal_decode_conv" not in params or qkv is None:
        return None
    return "MMVit2" if any(np.any(a != 0) for a in qkv.values()) else "mmformer"


def _state_dict_model(keys):
    """Which of the ported models a port ``state_dict`` is (None: another)."""
    if "fused6_pos" in keys:
        return "MMVit4"
    if "decoder_fuse.prm_generator4.prm_layer.1.weight" in keys:
        return "RFNet"
    if "content_enc_list.0.e1c1.conv.weight" in keys:
        return "RobustMseg"
    if "build_MSEs_AMM.fuse_proj.logit_scale" in keys:
        return "MultiSenseSeg"
    if "outc.conv.weight" in keys:
        return "UNetV2"
    if "mit.stages.0.1.weight" in keys:
        return "Segformer"
    if "xception_features.conv1.weight" in keys:
        return "DeepLabv3_plus"
    for key, name in (("level1_0.conv.weight", "ELANet"), ("DAPF.conv1x1.weight", "FASSDNet"),
                      ("initial_block.main_branch.weight", "ENet")):
        if key in keys:
            return name
    if "RGB_encoder.e1_c1.weight" not in keys:
        return None
    return "MMVit2" if "qkv_RGB.weight" in keys else "mmformer"


def _check_model(path, found, modeltype):
    if modeltype in _CONVERTERS and found is not None and found != modeltype:
        raise ValueError(f"{path} holds {found} weights, not {modeltype}")


def _static_tables(keys):
    """{key: the port's value} of the reference's static buffers among
    ``keys``: AMM's channel-offset table and the window attentions' relative
    position indices, which the port builds and keeps out of its
    ``state_dict``, as the JAX package does."""
    tables = {}
    for key in keys:
        if key.endswith("fuse_proj.relative_position_bias"):
            tables[key] = _amm_relative_bias(int(round(keys[key].numel() ** 0.5)))
        elif key.endswith("attn.relative_position_index"):
            side = int(round((keys[key].numel() ** 0.25)))
            tables[key] = _relative_position_index(side, side)
    return tables


def _from_reference(sd, path):
    """A reference ``state_dict`` as the port's: BatchNorm's
    ``num_batches_tracked``, UNetV2's dead ConvTranspose2d weights
    (``up{i}.up.*``, unused with ``bilinear=True``) and ENet's dead
    ``project_layer.*`` (F29:414-415) dropped, and the static tables dropped
    once they equal the port's (``ValueError`` otherwise)."""
    out = {}
    tables = _static_tables(sd)
    for key, value in sd.items():
        if key in tables:
            want = tables[key]
            got = value.detach().cpu().numpy()
            if got.size != want.size or not np.allclose(got.reshape(want.shape), want,
                                                        rtol=1e-6, atol=1e-6):
                raise ValueError(f"{path}: {key} differs from the table the model builds")
            continue
        if (key.endswith("num_batches_tracked") or re.match(r"up\d\.up\.", key)
                or key.startswith("project_layer.")):
            continue
        out[key] = value
    return out


def load_weights(path, modeltype="MMVit4"):
    """A port state_dict for ``modeltype`` from a ``.pt`` file (the port's
    or the reference's) or a flattened JAX ``.npz``, converted by that
    model's converter. Weights of another of the ported models raise
    ``ValueError`` naming both."""
    path = Path(path)
    if path.suffix != ".npz":
        sd = _from_reference(torch.load(path, map_location="cpu", weights_only=True), path)
        _check_model(path, _state_dict_model(sd), modeltype)
        return sd
    with np.load(path, allow_pickle=False) as z:
        variables = unflatten_variables({k: z[k] for k in z.files})
    _check_model(path, _npz_model(variables["params"]), modeltype)
    if modeltype not in _CONVERTERS:
        raise NotImplementedError(
            f"no converter of JAX {modeltype} variables to the port; see ROADMAP.md")
    return _CONVERTERS[modeltype](variables)


def evaluation_arrays(data, spec):
    """(images, masks) that ``evaluate_run`` gives a model of ``spec``: all
    of them for a 5-D model; modality 0 and mask channel 0 for a 4-D one,
    whatever ``chindex`` says (``corrifnet_tpu/run/evaluate.py:99-100``)."""
    if spec.input_kind == "5d":
        return data.images, data.masks
    return np.ascontiguousarray(data.images[:, 0]), data.masks[:, 0]


@torch.no_grad()
def per_image_metrics(model, images, masks, indices, batch_size, device):
    """Per-image (jaccard2, f1) over ``images[indices]``, on modality
    channel 0 (allJaccardResults:208-240). Also returns each batch's wall
    seconds, ending with the metrics on the host."""
    jacks, f1s, seconds = [], [], []
    for batch in make_batches(images, masks, indices, batch_size):
        t0 = time.perf_counter()
        out = model(torch.from_numpy(batch.images).to(device)).float()
        ma = torch.from_numpy(batch.masks).to(device)
        pairs = [
            jaccard_f1_pair(ma[i, 0].reshape(-1, 1), out[i, 0].reshape(-1, 1))
            for i in range(out.shape[0])
        ]
        j = torch.cat([p[0] for p in pairs]).cpu().numpy()
        f = torch.cat([p[1] for p in pairs]).cpu().numpy()
        seconds.append(time.perf_counter() - t0)
        keep = batch.valid.astype(bool)
        jacks.append(j[keep])
        f1s.append(f[keep])
    return np.concatenate(jacks), np.concatenate(f1s), seconds


def read_manifest(path):
    """[(run name, run directory)] of a manifest's alternating lines
    (allJaccardResults:45-52)."""
    lines = [ln.strip() for ln in Path(path).read_text().splitlines() if ln.strip()]
    return list(zip(lines[0::2], lines[1::2]))


def restore_run(run_dir, index=0):
    """The port ``state_dict`` ``Finaliremmodel{index}`` of ``run_dir``, on
    the CPU. A JAX run's orbax directory raises ``ValueError`` naming the
    export script."""
    name = final_ckpt_name(index)
    path = Path(run_dir) / name
    if path.is_dir():
        raise ValueError(
            f"{path} is an orbax checkpoint, a JAX run's: export it where jax and orbax "
            f"are installed with `python scripts/export_jax_checkpoint.py --config CONFIG --run-dir "
            f"{run_dir} --index {index} --out w.npz`, then `python -m "
            f"corrifnet_tpu_torch.run.import_checkpoint MODEL w.npz RUN_DIR`")
    if not path.is_file():
        raise FileNotFoundError(f"no checkpoint {name} in {run_dir}")
    return Checkpointer(run_dir).restore(name)


@torch.no_grad()
def write_segplots(model, data, indices, out_dir, device):
    """``segplot_indexed`` PNGs of each image of ``indices`` from a B=1
    forward, with the training means (``corrifnet_tpu/run/evaluate.py:123-140``)."""
    for idx in indices:
        out = model(torch.from_numpy(data.images[idx:idx + 1]).to(device)).float().cpu().numpy()
        image = np.moveaxis(data.images[idx, 0], 0, -1)
        segplot_indexed(out_dir, image.shape[0], image, out[0, 0, 0], data.masks[idx, 0, 0],
                        data.tr_mean_r, data.tr_mean_g, data.tr_mean_b, indx=int(idx))


# the model levers the JAX package's evaluation does not pass, at their defaults
_TRAINING_LEVERS = {"depth_mode": "full", "fuse_expand_bn": False, "decoder_remat": False,
                    "decoder_chunk": 0, "remat_mode": "all"}


@deterministic()
def evaluate_run(cfg, state_dict=None, device="cuda", segplot_dir=None):
    """Evaluate ``cfg.modeltype`` over ``cfg``'s test fold on ``device``,
    under ``utils.determinism.deterministic()``, as a training run, with the
    weights of ``state_dict`` (a port ``state_dict``, loaded strictly), else
    the seed's; with ``segplot_dir``, a 5-D model also writes each test
    image's overlay.

    ``device="cuda"`` runs the kernels; with no GPU that raises, it never
    falls back to the CPU. Returns the metric means and stds, the image
    count, the batch size and each batch's seconds."""
    check_supported(cfg, device)
    tsind, trind, _ = cross_val(cfg.train_set_size, cfg.fno, cfg.fsiz)
    data = load_dstl(cfg.train_set_size, trind, pack_path=cfg.data_pack,
                     synthetic_seed=cfg.synthetic_seed,
                     data_dirs=cfg.data_dirs)
    unused = [f"{k}={getattr(cfg, k)!r}" for k, v in _TRAINING_LEVERS.items()
              if getattr(cfg, k) != v]
    if unused:
        print(f"config: {', '.join(unused)} not used by run.evaluate: the model is "
              "evaluated as built by default (full depth), as the JAX package's "
              "evaluate_run builds it")
    model = create_model(cfg.modeltype, dtype=compute_dtype(cfg), device=device,
                         seed=cfg.seed,
                         pallas_fused_blocks=cfg.pallas_fused_blocks,
                         decoder_lean=cfg.decoder_lean)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    spec = get_spec(cfg.modeltype)
    images, masks = evaluation_arrays(data, spec)
    bs = max(cfg.mini_batch_size, 8)
    jacks, f1s, seconds = per_image_metrics(model, images, masks, tsind, bs, device)
    if segplot_dir is not None and spec.input_kind == "5d":
        write_segplots(model, data, tsind, segplot_dir, device)
    return {
        "jaccard_mean": float(jacks.mean()),
        "jaccard_std": float(jacks.std()),
        "f1_mean": float(f1s.mean()),
        "f1_std": float(f1s.std()),
        "n_images": int(len(jacks)),
        "batch_size": bs,
        "batch_seconds": seconds,
    }


def main(argv=None):
    """Without ``--run-dir`` or ``--manifest``: one evaluation, printed as a
    JSON line and returned. With either: ``{run name: result}``, one printed
    line per run."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="18-line .txt or .json config")
    ap.add_argument("--weights", default=None, help=".npz (JAX tree) or .pt")
    ap.add_argument("--run-dir", default=None, help="a run directory of the port")
    ap.add_argument("--manifest", default=None,
                    help="alternating run-name / run-directory lines")
    ap.add_argument("--index", type=int, default=None,
                    help="evaluate Finaliremmodel{index} of each run (default 0)")
    ap.add_argument("--segplot-dir", default=None,
                    help="write each test image's overlay PNGs here (5-D models)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not (args.run_dir or args.manifest):
        if args.index is not None or args.segplot_dir is not None:
            ap.error("--index and --segplot-dir need --run-dir or --manifest")
        cfg = load_config(args.config)
        weights = None if args.weights is None else load_weights(args.weights, cfg.modeltype)
        r = evaluate_run(cfg, weights, args.device)
        print(json.dumps(r))
        return r
    if args.weights is not None:
        ap.error("--weights cannot be given with --run-dir or --manifest")
    if args.run_dir and args.manifest:
        ap.error("give --run-dir or --manifest, not both")
    cfg = load_config(args.config)
    runs = read_manifest(args.manifest) if args.manifest else [("run", args.run_dir)]
    results = {}
    for name, run_dir in runs:
        r = evaluate_run(cfg, restore_run(run_dir, args.index or 0), args.device,
                         args.segplot_dir)
        results[name] = r
        print(f"{name}: jaccard {r['jaccard_mean']:.5f}±{r['jaccard_std']:.5f} "
              f"f1 {r['f1_mean']:.5f}±{r['f1_std']:.5f} (n={r['n_images']})")
    return results


if __name__ == "__main__":
    main()
