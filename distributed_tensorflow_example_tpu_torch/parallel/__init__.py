"""Data-parallel training step of the port (one replica so far)."""
