"""PyTorch/CUDA port of the MaxEVA serving and training stack for NVIDIA
Hopper.

Plain tensor code is PyTorch; every TPU kernel on the serving path is a
hand-written CUDA C++ kernel under ``csrc/``, built with ``nvcc`` for
``sm_90a`` at first CUDA use, and so is the training path's backward of
the attention (``csrc/flash_backward.cu``).  Entry points run on the
card unless the caller passes ``device="cpu"``; each kernel wrapper picks
its kernel or its plain PyTorch version by the device of the tensor it is
given.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else.  Raises when no card is present and the caller did
    not ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
