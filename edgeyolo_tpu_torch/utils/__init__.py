"""Small helpers the model graph and the entry points share."""

from __future__ import annotations

import logging
import math

import torch


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round up to a multiple of `divisor` (the width-scaling rule)."""
    return int(math.ceil(x / divisor) * divisor)


def select_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    With no device given, a machine without a CUDA card is an error, not a
    silent fall-back to the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    """t filled in place with U(-bound, bound) drawn from `generator` (in f32,
    on the CPU, then copied: the same weights on every device)."""
    w = torch.rand(t.shape, generator=generator, dtype=torch.float32)
    t.copy_(w * (2 * bound) - bound)


LOGGER = logging.getLogger("edgeyolo_tpu_torch")
