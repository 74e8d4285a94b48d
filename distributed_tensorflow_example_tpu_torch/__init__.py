"""PyTorch/CUDA port of ``distributed_tensorflow_example_tpu`` for the
NVIDIA H100.

The JAX package beside it is the reference each part of the port is held
against; the port imports neither JAX nor that package. Module names
mirror the reference's so each counterpart is easy to find. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; the
hand-written Hopper kernels live in ``csrc/`` and are built on first use
by :mod:`.ops.cuda._build`.
"""
