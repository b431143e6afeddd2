"""Measurement tools of the port (run on the GPU)."""
