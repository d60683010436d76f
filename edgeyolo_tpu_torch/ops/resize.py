"""jax.image.resize's bilinear, cubic and nearest rules in PyTorch: test-time
augmentation's down-scaled inputs (engine/predictor.py), the segment masks
taken back out of the letterbox (ops/segments.py), CBFuse's resize
(nn/modules/gelan.py), copy-paste's mask upsample (data/augment_device.py)
and SAM2's Hiera background position (nn/sam2.py, cubic)."""

from __future__ import annotations

from typing import Sequence

import torch


def nearest_resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *size) by jax.image.resize's "nearest": source
    index floor((i + 0.5) * in / out), computed in f32 as JAX computes it."""
    for dim, n in zip((2, 3), size):
        m = x.shape[dim]
        if m != n:
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).long()
            x = x.index_select(dim, idx.clamp_(max=m - 1).to(x.device))
    return x


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 (jax.image's "cubic";
    F.interpolate's bicubic takes a = -0.75 and clamps its edge taps)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def resize_weights(n_in: int, n_out: int, kernel: str = "triangle") -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize` along one axis
    (jax.image.compute_weight_mat, antialias on): the triangle ("bilinear")
    or Keys cubic ("cubic") filter, widened by the downscale, each output's
    weights renormalised to sum to 1 (so the cubic's taps past the border
    fall away)."""
    scale = n_out / n_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x) if kernel == "cubic" else (1.0 - x).clamp_min(0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(x, ..., "bilinear") of an NCHW batch to (h, w): the
    two axes' weights in x's dtype, contracted one axis after the other."""
    wh = resize_weights(x.shape[2], size[0]).to(x.device, x.dtype)
    ww = resize_weights(x.shape[3], size[1]).to(x.device, x.dtype)
    return torch.matmul(wh.t(), torch.matmul(x, ww))


def resize_cubic(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(x, ..., "cubic") of an NCHW batch to (h, w): each
    axis whose size changes contracted with its cubic weights in x's dtype
    (an axis that keeps its size is left as it is, as JAX leaves it)."""
    if x.shape[2] != size[0]:
        x = torch.matmul(resize_weights(x.shape[2], size[0], "cubic").to(x.device, x.dtype).t(), x)
    if x.shape[3] != size[1]:
        x = torch.matmul(x, resize_weights(x.shape[3], size[1], "cubic").to(x.device, x.dtype))
    return x
