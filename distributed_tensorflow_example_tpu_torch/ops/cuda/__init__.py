"""Hand-written Hopper kernels (``csrc/*.cu``), each beside its plain
PyTorch version. A wrapper takes the plain version only for CPU tensors;
on CUDA tensors it launches its kernel (and counts the launch in its
``launches`` attribute) or raises."""
