"""Visualization tools of the port (counterpart of slowfast_tpu/visualization/)."""
