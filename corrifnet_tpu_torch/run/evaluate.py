"""Re-evaluate a model over the test fold (allJaccardResults_irem_f1_jcrd.py).

Counterpart of ``corrifnet_tpu/run/evaluate.py:39-177``, on the port's own
config and data modules: config -> ``cross_val`` -> ``load_dstl`` (pack or
synthetic) -> batches of
``max(mini_batch_size, 8)`` -> forward -> per-image (jaccard2, f1) on
modality channel 0 -> mean and std.

Weights: ``--weights`` takes a ``.npz`` of the flattened JAX variable tree
(``/``-joined keys, e.g. ``params/encoders/conv6/kernel``) of the config's
``modeltype`` (MMVit4, MMVit2 or mmformer), converted by
``models.jax_import``, or a ``.pt`` port ``state_dict``. Without it the
model is initialized from ``cfg.seed``.

    python -m corrifnet_tpu_torch.run.evaluate --config model0.txt \
        [--weights weights.npz] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from corrifnet_tpu_torch.config import check_supported, load_config
from corrifnet_tpu_torch.data import cross_val, load_dstl, make_batches
from corrifnet_tpu_torch.metrics import jaccard_f1_pair
from corrifnet_tpu_torch.models import (
    create_model,
    mmvit2_state_dict_from_variables,
    mmvit4_state_dict_from_variables,
)
from corrifnet_tpu_torch.models.jax_import import unflatten_variables

__all__ = ["compute_dtype", "evaluate_run", "load_weights", "main",
           "per_image_metrics"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    """The torch compute dtype named by ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


# modeltype: the JAX tree -> port state_dict converter of its .npz
_CONVERTERS = {
    "MMVit4": mmvit4_state_dict_from_variables,
    "MMVit2": lambda v: mmvit2_state_dict_from_variables(v, mmformer=False),
    "mmformer": lambda v: mmvit2_state_dict_from_variables(v, mmformer=True),
}


def _npz_model(params):
    """Which of MMVit4, MMVit2 and mmformer a JAX ``params`` tree is (None:
    none of them): MMVit4 has the fused6 group; of the conv-encoder family,
    mmformer's unused qkv leaves are zero."""
    if "fused6_pos" in params:
        return "MMVit4"
    qkv = params.get("modality_stream", {}).get("qkv")
    if "multimodal_decode_conv" not in params or qkv is None:
        return None
    return "MMVit2" if any(np.any(a != 0) for a in qkv.values()) else "mmformer"


def _state_dict_model(keys):
    """Which of the three models a port ``state_dict`` is (None: another)."""
    if "fused6_pos" in keys:
        return "MMVit4"
    if "RGB_encoder.e1_c1.weight" not in keys:
        return None
    return "MMVit2" if "qkv_RGB.weight" in keys else "mmformer"


def _check_model(path, found, modeltype):
    if modeltype in _CONVERTERS and found is not None and found != modeltype:
        raise ValueError(f"{path} holds {found} weights, not {modeltype}")


def load_weights(path, modeltype="MMVit4"):
    """A port state_dict for ``modeltype`` from a ``.pt`` file or a flattened
    JAX ``.npz``, converted by that model's converter. Weights of another of
    the ported models raise ``ValueError`` naming both."""
    path = Path(path)
    if path.suffix != ".npz":
        sd = torch.load(path, map_location="cpu", weights_only=True)
        _check_model(path, _state_dict_model(sd), modeltype)
        return sd
    with np.load(path, allow_pickle=False) as z:
        variables = unflatten_variables({k: z[k] for k in z.files})
    _check_model(path, _npz_model(variables["params"]), modeltype)
    if modeltype not in _CONVERTERS:
        raise NotImplementedError(
            f"no converter of JAX {modeltype} variables to the port; see ROADMAP.md")
    return _CONVERTERS[modeltype](variables)


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


def evaluate_run(cfg, weights=None, device="cuda"):
    """Evaluate ``cfg.modeltype`` over ``cfg``'s test fold on ``device``.

    ``device="cuda"`` runs the kernels; with no GPU that raises, it never
    falls back to the CPU. Returns the metric means and stds, the image
    count, the batch size and each batch's seconds."""
    check_supported(cfg, device)
    tsind, trind, _ = cross_val(cfg.train_set_size, cfg.fno, cfg.fsiz)
    data = load_dstl(cfg.train_set_size, trind, pack_path=cfg.data_pack,
                     synthetic_seed=cfg.synthetic_seed,
                     data_dirs=cfg.data_dirs)
    model = create_model(cfg.modeltype, dtype=compute_dtype(cfg), device=device,
                         seed=cfg.seed,
                         pallas_fused_blocks=cfg.pallas_fused_blocks,
                         decoder_lean=cfg.decoder_lean)
    if weights is not None:
        model.load_state_dict(load_weights(weights, cfg.modeltype), strict=True)
    bs = max(cfg.mini_batch_size, 8)
    jacks, f1s, seconds = per_image_metrics(
        model, data.images, data.masks, tsind, bs, device
    )
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
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="18-line .txt or .json config")
    ap.add_argument("--weights", default=None, help=".npz (JAX tree) or .pt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = evaluate_run(load_config(args.config), args.weights, args.device)
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()
