"""Segmentation overlay rendering (reference: F11_SEGPLOT.py,
F11_SEGPLOT2.py, F11_SEGPLOT2_BLACKWHITE.py).

The port's own copy of ``corrifnet_tpu/run/segplot.py`` (numpy, struct and
zlib; it imports nothing of the JAX package): the same functions, the same
files, the same bytes.

HSV composite math (F11_SEGPLOT.py:40-54):
    value      = image_R/4 + pred/2 + gt/4
    saturation = min(gt + pred, 1)
    hue        = 0.75 - gt/2
after re-adding the training-fold RGB means (:11-13) and min-max
normalizing the image (:14).

Implemented in pure NumPy (HSV->RGB conversion included) so it has no
cv2/matplotlib dependency; PNG writing uses matplotlib when importable and
falls back to a minimal PNG writer (zlib-compressed) otherwise.

Variants:
  * ``segplot``            — F11_SEGPLOT.py:8-81 (fixed filenames)
  * ``segplot_indexed``    — F11_SEGPLOT2.py (per-index filenames)
  * ``segplot_blackwhite`` — F11_SEGPLOT2_BLACKWHITE.py:15-19 (gray base +
    striped overlay)
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["segplot", "segplot_indexed", "segplot_blackwhite", "hsv_to_rgb"]


def hsv_to_rgb(h, s, v):
    """Vectorized HSV->RGB, h/s/v in [0, 1]."""
    h = (h % 1.0) * 6.0
    i = np.floor(h).astype(np.int32) % 6
    f = h - np.floor(h)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def _write_png(path, rgb_u8):
    """Write an RGB uint8 (H, W, 3) array as PNG (matplotlib if available)."""
    try:
        import matplotlib.pyplot as plt  # noqa

        plt.imsave(path, rgb_u8)
        return
    except Exception:
        pass
    h, w, _ = rgb_u8.shape
    raw = b"".join(b"\x00" + rgb_u8[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF
        )

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def _to_u8(img01):
    return np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)


def _normalize_image(image, tr_mean_r, tr_mean_g, tr_mean_b):
    image = np.array(image, dtype=np.float32, copy=True)
    image[:, :, 0] += tr_mean_r
    image[:, :, 1] += tr_mean_g
    image[:, :, 2] += tr_mean_b
    rng = image.max() - image.min()
    return (image - image.min()) / (rng if rng else 1.0)


def _composite(image_r, predmask, grmask):
    pred = np.squeeze(predmask)
    gt = np.squeeze(grmask)
    v = image_r / 4 + pred / 2 + gt / 4
    s = np.minimum(gt + pred, 1.0)
    h = 0.75 - gt / 2
    # the reference scales h*179 into cv2's uint8 hue (179 == full circle);
    # h in [0,1] on a [0,1) hue circle is the same mapping
    return hsv_to_rgb(np.clip(h, 0, 1), np.clip(s, 0, 1), np.clip(v, 0, 1))


def segplot(pathm, lim, image, predmask, grmask, tr_mean_r, tr_mean_g, tr_mean_b):
    """F11_SEGPLOT.py:8-81: overlay + image/channel/mask PNGs."""
    del lim
    image = _normalize_image(image, tr_mean_r, tr_mean_g, tr_mean_b)
    rgb = _composite(image[:, :, 0], predmask, grmask)
    pathm = Path(pathm)
    pathm.mkdir(parents=True, exist_ok=True)
    _write_png(pathm / "segmentation_image.png", _to_u8(rgb))
    _write_png(pathm / "test_image.png", _to_u8(image))
    for ci, name in enumerate(["R", "G", "B"]):
        chan = np.repeat(image[:, :, ci : ci + 1], 3, axis=-1)
        _write_png(pathm / f"test_image_{name}.png", _to_u8(chan))
    pm = np.squeeze(np.asarray(predmask))
    gm = np.squeeze(np.asarray(grmask))
    _write_png(pathm / "test_pred_mask.png", _to_u8(np.repeat(pm[..., None], 3, -1)))
    _write_png(pathm / "ground_truth_mask.png", _to_u8(np.repeat(gm[..., None], 3, -1)))


def segplot_indexed(pathm, lim, image, predmask, grmask,
                    tr_mean_r, tr_mean_g, tr_mean_b, indx):
    """F11_SEGPLOT2.py: same composite, per-index filenames."""
    image = _normalize_image(image, tr_mean_r, tr_mean_g, tr_mean_b)
    rgb = _composite(image[:, :, 0], predmask, grmask)
    pathm = Path(pathm)
    pathm.mkdir(parents=True, exist_ok=True)
    _write_png(pathm / f"segmentation_image_{indx}.png", _to_u8(rgb))
    _write_png(pathm / f"test_image_{indx}.png", _to_u8(image))


def segplot_blackwhite(pathm, lim, image, predmask, grmask,
                       tr_mean_r, tr_mean_g, tr_mean_b, indx=0):
    """F11_SEGPLOT2_BLACKWHITE.py:15-19: gray base, striped pred overlay."""
    image = _normalize_image(image, tr_mean_r, tr_mean_g, tr_mean_b)
    pred = np.squeeze(np.asarray(predmask))
    gt = np.squeeze(np.asarray(grmask))
    gray = image[:, :, 0]
    out = np.repeat(gray[..., None], 3, axis=-1)
    stripes = (np.add.outer(np.arange(gray.shape[0]),
                            np.arange(gray.shape[1])) // 4) % 2 == 0
    out[(pred > 0.5) & stripes] = [1.0, 1.0, 1.0]
    out[(gt > 0.5) & ~stripes] = [0.0, 0.0, 0.0]
    pathm = Path(pathm)
    pathm.mkdir(parents=True, exist_ok=True)
    _write_png(pathm / f"segmentation_bw_{indx}.png", _to_u8(out))
