"""Data path of the port (counterpart of ``corrifnet_tpu.data``), numpy only."""

from corrifnet_tpu_torch.data.crossval import (
    cross_val,
    load_permutation,
    write_permutation,
)
from corrifnet_tpu_torch.data.dataset import (
    Batch,
    batch_iterator,
    make_batches,
    num_batches,
)
from corrifnet_tpu_torch.data.dstl import (
    DstlArrays,
    load_dstl,
    load_pack,
    normalize_per_fold,
    synthetic_dstl,
)

__all__ = [
    "Batch",
    "DstlArrays",
    "batch_iterator",
    "cross_val",
    "load_dstl",
    "load_pack",
    "load_permutation",
    "make_batches",
    "normalize_per_fold",
    "num_batches",
    "synthetic_dstl",
    "write_permutation",
]
