"""Tensor ops of the port: nn primitives, attention, and the CUDA
kernels under :mod:`.cuda`."""
