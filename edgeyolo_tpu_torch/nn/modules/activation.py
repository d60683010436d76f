"""Activations, NCHW (edgeyolo_tpu/nn/modules/activation.py): TeLU and AGLU.

- `telu(x)` = x * tanh(exp(x)), and x itself above the cutoff (20), where
  exp would overflow; `TeLU` is its module. A conv takes it by name
  (`act="telu"`, a Conv line's 7th argument).
- `AGLU`: exp(softplus_{beta=-1}(kappa x - log lambda) / lambda) with learned
  scalars `lambd` (clamped at 1e-4) and `kappa`, both drawn from U(0, 1) by
  the model's seeded init (`seeded_init`), as flax initialises them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def telu(x: torch.Tensor, cutoff: float = 20.0) -> torch.Tensor:
    """x * tanh(exp(x)); x above `cutoff`."""
    return torch.where(x > cutoff, x, x * torch.tanh(torch.exp(x.clamp(max=cutoff))))


class TeLU(nn.Module):
    def __init__(self, cutoff: float = 20.0):
        super().__init__()
        self.cutoff = cutoff

    def forward(self, x):
        return telu(x, self.cutoff)


class AGLU(nn.Module):
    """Unified activation with learned lambda and kappa."""

    def __init__(self):
        super().__init__()
        self.lambd = nn.Parameter(torch.rand(1))
        self.kappa = nn.Parameter(torch.rand(1))

    def seeded_init(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.lambd, self.kappa):
                p.copy_(torch.rand(p.shape, generator=generator))  # U(0, 1)

    def forward(self, x):
        lam = self.lambd.clamp(min=1e-4).to(x.dtype)
        z = self.kappa.to(x.dtype) * x - torch.log(lam)
        return torch.exp(-F.softplus(-z) / lam)  # softplus with beta -1 is -softplus(-z)
