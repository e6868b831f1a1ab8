"""Utilities of the port (counterpart of ``corrifnet_tpu.utils``)."""

from corrifnet_tpu_torch.utils.logfiles import RunLogs

__all__ = ["RunLogs"]
