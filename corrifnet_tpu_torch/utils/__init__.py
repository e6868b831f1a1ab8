"""Utilities of the port (counterpart of ``corrifnet_tpu.utils``)."""

from corrifnet_tpu_torch.utils.logfiles import RunLogs
from corrifnet_tpu_torch.utils.profiling import device_memory_stats, live_tensor_bytes, trace

__all__ = ["RunLogs", "device_memory_stats", "live_tensor_bytes", "trace"]
