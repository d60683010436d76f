"""Letterbox preprocessing for train, val and predict (edgeyolo_tpu/data/letterbox.py).

The same ratio, rounding and gray-114 pads as the JAX letterbox, to a square
(imgsz, imgsz) or a rect (H, W) canvas. Decoding and resizing run in the
codec library (csrc/imageio.cpp), over worker threads for a batch: JPEG
sources are decoded there, other images arrive as pixels. The resize is
edgeyolo_tpu/native/io.cpp's triangle filter with PIL BILINEAR's support
(antialiased on downscale), which is within one grey level of PIL's. Onto a
square canvas a JPEG whose long side is at least 4x the canvas decodes at
1/2, 1/4 or 1/8 scale in the DCT domain first, as native/io.cpp's does
(`decode_letterbox` is its single-image call).
"""

from __future__ import annotations

import ctypes

import numpy as np

from edgeyolo_tpu_torch.data.imageio import EyioMeta, EyioSource, codec

THREADS = 4  # decode threads of a batch, as edgeyolo_tpu/native's default


class LetterboxError(ValueError):
    """A source of a batch failed; `index` is its place in the batch."""

    def __init__(self, index: int, message: str):
        super().__init__(f"decode and letterbox failed at image {index}: {message}")
        self.index = index


def letterbox_batch(sources: list, new_shape: int | tuple[int, int] = 640, scaleup: bool = True,
                    threads: int = THREADS):
    """Decode and letterbox a batch onto one canvas shape.

    sources: JPEG file bytes, or HWC uint8 RGB (or HW gray) arrays. Returns
    (images (n, H, W, 3) uint8, [(ratio, (pad_w, pad_h), (h0, w0)), ...]).
    A source that fails raises LetterboxError (a ValueError) naming its index.
    """
    H, W = (new_shape, new_shape) if isinstance(new_shape, int) else new_shape
    n = len(sources)
    keep, src = [], (EyioSource * max(n, 1))()
    for i, s in enumerate(sources):
        if isinstance(s, (bytes, bytearray, memoryview)):
            a = np.frombuffer(s, np.uint8)
            src[i] = EyioSource(a.ctypes.data, a.size, 0, 0, 0)
        else:
            a = np.asarray(s)
            if a.ndim == 3 and a.shape[2] == 1:
                a = a[..., 0]
            if a.ndim == 2:
                a = np.repeat(a[..., None], 3, axis=2)
            if a.ndim != 3 or a.shape[2] != 3:
                raise ValueError(f"image {i}: expected (H, W, 3) uint8 pixels, got {a.shape}")
            a = np.ascontiguousarray(a, np.uint8)
            src[i] = EyioSource(a.ctypes.data, a.size, 1, a.shape[0], a.shape[1])
        keep.append(a)  # alive until the call returns
    out = np.empty((n, H, W, 3), np.uint8)
    meta = (EyioMeta * max(n, 1))()
    err = ctypes.create_string_buffer(512)
    rc = codec().eyio_letterbox_batch(n, src, H, W, int(bool(scaleup)), int(threads),
                                      out.ctypes.data, meta, err, len(err))
    if rc < 0:
        raise RuntimeError(f"decode and letterbox failed: {err.value.decode()}")
    if rc:
        raise LetterboxError(rc - 1, err.value.decode())
    return out, [(m.r, (m.pw, m.ph), (m.h0, m.w0)) for m in meta[:n]]


def letterbox(img: np.ndarray, new_shape: int | tuple[int, int] = 640, scaleup: bool = True):
    """Resize and pad (gray 114, split evenly) an HWC uint8 image.

    Returns (padded image (nh, nw, 3), ratio, (pad_w, pad_h)).
    """
    out, [(r, pads, _)] = letterbox_batch([img], new_shape, scaleup, threads=1)
    return out[0], r, pads


def decode_letterbox(data: bytes, imgsz: int, scaleup: bool = True):
    """One JPEG's bytes onto an (imgsz, imgsz) canvas (edgeyolo_tpu.native.decode_letterbox).

    Returns (image (imgsz, imgsz, 3) uint8, ratio, (pad_w, pad_h), (h0, w0)).
    """
    out, [(r, pads, hw)] = letterbox_batch([data], imgsz, scaleup, threads=1)
    return out[0], r, pads, hw
