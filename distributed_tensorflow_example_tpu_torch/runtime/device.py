"""Device choice for the port's entry points.

``cuda`` by default; the CPU only when the caller asks for it (the tests
do). Without CUDA and without an explicit ``"cpu"`` an entry point
raises: it never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU unless "
                "the caller passes device='cpu'")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index} "
                               f"({torch.cuda.device_count()} present)")
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    return dev
