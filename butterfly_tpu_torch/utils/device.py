"""Device choice for the port's entry points.

Entry points run on the card unless the caller names another device. Where
there is no card and the caller named none, they raise: they never fall back
to the CPU on their own.
"""

from __future__ import annotations

import torch

from butterfly_tpu_torch.utils.errors import RuntimeButterflyError

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device. A
    CUDA device without an index gets the current one, so that it compares
    equal to the device of the tensors made on it."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeButterflyError(
            "CUDA is not available: pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
