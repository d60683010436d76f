"""Letterbox preprocessing for val and predict (edgeyolo_tpu/data/letterbox.py).

The same ratio, rounding and gray-114 pads as the JAX letterbox, always to
the static (imgsz, imgsz) canvas. The resize is torch's antialiased bilinear
(`F.interpolate(mode="bilinear", antialias=True, align_corners=False)`,
rounded to uint8) in place of PIL's BILINEAR: the two differ by at most one
grey level, on about a sixth of the pixels of a random image.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(img: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """HWC uint8 -> (h, w, C) uint8 by antialiased bilinear resampling."""
    w, h = size_wh
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(h, w), mode="bilinear", antialias=True, align_corners=False)
    return y[0].round_().clamp_(0, 255).to(torch.uint8).permute(1, 2, 0).contiguous().numpy()


def letterbox(img: np.ndarray, new_shape: int | tuple[int, int] = 640, scaleup: bool = True):
    """Resize and pad (gray 114, split evenly) an HWC uint8 image.

    Returns (padded image (nh, nw, C), ratio, (pad_w, pad_h)).
    """
    if img.ndim == 2:
        img = img[..., None]
    shape = img.shape[:2]  # h, w
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (round(shape[1] * r), round(shape[0] * r))  # (w, h)
    dw, dh = (new_shape[1] - new_unpad[0]) / 2, (new_shape[0] - new_unpad[1]) / 2
    if shape[::-1] != new_unpad:
        img = resize_bilinear(img, new_unpad)
    top = int(round(dh - 0.1))
    left = int(round(dw - 0.1))
    out = np.full((new_shape[0], new_shape[1], img.shape[2]), 114, dtype=img.dtype)
    out[top:top + img.shape[0], left:left + img.shape[1]] = img
    return out, r, (left, top)
