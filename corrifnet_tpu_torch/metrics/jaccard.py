"""Soft-Jaccard metrics on un-thresholded probabilities (F5_JACCARD2.py).

Counterpart of ``jaccard2``, ``jaccard2_masked`` and ``jaccard_f1_pair`` in
``corrifnet_tpu/metrics/jaccard.py``. Inputs are ``(N, 1)`` columns; sums
run over dim 0. When the ground truth is all background, both masks are
inverted so an empty patch is scored on the background class
(F5_JACCARD2.py:12-14).
"""

from __future__ import annotations

import torch

__all__ = ["jaccard2", "jaccard2_masked", "jaccard_f1_pair"]


def _maybe_invert(y, y_pred):
    empty = y.sum(0) == 0
    return torch.where(empty, 1.0 - y, y), torch.where(empty, 1.0 - y_pred, y_pred)


def _counts(y, y_pred):
    tp = (y_pred * y).sum(0)
    fp = ((1 - y_pred) * y).sum(0)
    fn = ((1 - y) * y_pred).sum(0)
    return tp, fp, fn


def jaccard2(y, y_pred, epsilon: float = 1e-8):
    """Soft Jaccard with the all-background inversion (F5_JACCARD2.py:11-20)."""
    tp, fp, fn = _counts(*_maybe_invert(y, y_pred))
    return (tp + epsilon) / (tp + fp + fn + epsilon)


def jaccard2_masked(y, y_pred, valid, epsilon: float = 1e-8):
    """``jaccard2`` over the rows where ``valid`` (same shape as y) is 1: the
    padded samples of a ragged final batch are masked out of every sum,
    including the all-background check
    (``corrifnet_tpu/metrics/jaccard.py:55-76``)."""
    empty = (y * valid).sum(0) == 0
    y_eff = torch.where(empty, 1.0 - y, y) * valid
    y_pred_eff = torch.where(empty, 1.0 - y_pred, y_pred) * valid
    tp = (y_pred_eff * y_eff).sum(0)
    fp = ((valid - y_pred_eff) * y_eff).sum(0)
    fn = ((valid - y_eff) * y_pred_eff).sum(0)
    return (tp + epsilon) / (tp + fp + fn + epsilon)


def jaccard_f1_pair(y, y_pred, epsilon: float = 1e-8):
    """(jaccard2, f1) in one pass, with the same inversion."""
    tp, fp, fn = _counts(*_maybe_invert(y, y_pred))
    jack = (tp + epsilon) / (tp + fp + fn + epsilon)
    recall = tp / (tp + fn + epsilon)
    prec = tp / (tp + fp + epsilon)
    return jack, 2 * (recall * prec) / (recall + prec + epsilon)
