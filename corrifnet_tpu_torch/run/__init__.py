"""Entry points of the port (counterpart of ``corrifnet_tpu.run``)."""
