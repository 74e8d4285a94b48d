"""Runnable examples of the port (``python -m
distributed_tensorflow_example_tpu_torch.examples.<name>``)."""
