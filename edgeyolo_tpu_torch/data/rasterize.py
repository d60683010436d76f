"""Instance polygons -> the segment task's training masks (edgeyolo_tpu/data/
dataset.py `_rasterize_masks`, its cv2 path), without cv2.

Each polygon (normalised, original image) is mapped into letterbox pixels in
f32, truncated to integer vertices, filled at the full canvas resolution by
`fill_poly` (csrc/rasterize.cpp: cv2.fillPoly's outline and scan rules), and
reduced to the mask grid (canvas / mask_ratio) by cv2.resize's INTER_LINEAR
taps on a 0/1 image: at an odd ratio the one source pixel (r - 1) / 2 into
the cell, at an even one the 2 x 2 around the cell's centre, set where two
or more of the four are set (the fixed-point rounding of their 0.25 weights).
With two or more instances the masks are then made exclusive as the
reference's overlap merge draws them: by area, largest first (ties in list
order), each pixel to the last (smallest) instance drawn over it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from edgeyolo_tpu_torch.ops import _build

_lib = None


def _fill_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("rasterize")
        lib.eyr_fill_poly.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.eyr_fill_poly.restype = None
        _lib = lib
    return _lib


def fill_poly(img: np.ndarray, pts: np.ndarray, color: int = 1) -> np.ndarray:
    """Fill one polygon of integer (x, y) vertices into a (H, W) uint8 image,
    in place (cv2.fillPoly(img, [pts], color))."""
    if img.dtype != np.uint8 or img.ndim != 2 or not img.flags.c_contiguous:
        raise ValueError("fill_poly needs a C-contiguous (H, W) uint8 image")
    xy = np.ascontiguousarray(pts, np.int32).reshape(-1, 2)
    _fill_lib().eyr_fill_poly(img.ctypes.data, img.shape[0], img.shape[1], xy.ctypes.data,
                              len(xy), int(color))
    return img


def downsample(full: np.ndarray, ratio: int) -> np.ndarray:
    """A 0/1 (H, W) image -> (H / ratio, W / ratio) float32 by cv2.resize's
    INTER_LINEAR taps (both sides divisible by ratio)."""
    h, w = full.shape
    if h % ratio or w % ratio:
        raise ValueError(f"mask canvas {h}x{w} is not divisible by mask_ratio {ratio}")
    sh, sw = h // ratio, w // ratio
    if ratio == 1:
        return full.astype(np.float32)
    lo = (ratio - 1) // 2
    if ratio % 2:  # the one tap at offset (ratio - 1) / 2
        return full[lo::ratio, lo::ratio][:sh, :sw].astype(np.float32)
    s = (full[lo::ratio, lo::ratio][:sh, :sw].astype(np.int32)
         + full[lo + 1::ratio, lo::ratio][:sh, :sw] + full[lo::ratio, lo + 1::ratio][:sh, :sw]
         + full[lo + 1::ratio, lo + 1::ratio][:sh, :sw])
    return (s >= 2).astype(np.float32)


def polygon_masks(segments, n: int, w0: int, h0: int, r: float, pw, ph, H: int, W: int,
                  ratio: int, max_gt: int) -> np.ndarray:
    """The first n polygons of one sample -> (max_gt, H / ratio, W / ratio)
    float32 0/1 masks, exclusive where they overlap."""
    sh, sw = H // ratio, W // ratio
    out = np.zeros((max_gt, sh, sw), np.float32)
    for j, poly in enumerate(segments[:n]):
        pts = poly.copy()
        pts[:, 0] = pts[:, 0] * w0 * r + pw
        pts[:, 1] = pts[:, 1] * h0 * r + ph
        full = np.zeros((H, W), np.uint8)
        out[j] = downsample(fill_poly(full, pts.astype(np.int32)), ratio)
    if n > 1:
        areas = out[:n].reshape(n, -1).sum(1)
        order = np.argsort(-areas, kind="stable")
        merged = np.zeros((sh, sw), np.int32)
        for rank, j in enumerate(order):
            merged = np.clip(merged + out[j].astype(np.int32) * (rank + 1), 0, rank + 1)
        for rank, j in enumerate(order):
            out[j] = (merged == rank + 1).astype(np.float32)
    return out
