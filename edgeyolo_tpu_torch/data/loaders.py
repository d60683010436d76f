"""Still-image inference sources (edgeyolo_tpu/data/loaders.py, the image part).

`load_inference_source` turns a file, a directory, a glob, a list of paths
or arrays, one HWC uint8 array, or a (B, H, W, 3) array or tensor (frames
named tensor0, tensor1, ...) into an iterator of (name, HWC RGB uint8
frame). Video files, streams, HTTP and screen capture are not ported yet
(ROADMAP A.9).
"""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np
import torch

from edgeyolo_tpu_torch.data.imageio import load_image_rgb

IMG_EXTS = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp"}


class LoadImages:
    """Image files from a file, a directory (recursively), a glob or a list of paths."""

    def __init__(self, source):
        paths = source if isinstance(source, (list, tuple)) else [source]
        files: list[Path] = []
        for s in map(str, paths):
            p = Path(s)
            if p.is_dir():
                files += sorted(x for x in p.rglob("*.*") if x.suffix.lower() in IMG_EXTS)
            elif "*" in s:
                files += [Path(f) for f in sorted(glob.glob(s)) if Path(f).suffix.lower() in IMG_EXTS]
            elif p.is_file():
                files.append(p)
            else:
                raise FileNotFoundError(f"source not found: {s}")
        self.files = files

    def __iter__(self):
        for f in self.files:
            yield str(f), load_image_rgb(f)


class LoadArrays:
    """In-memory HWC uint8 frames."""

    def __init__(self, imgs, prefix: str = "image"):
        self.items, self.prefix = list(imgs), prefix

    def __iter__(self):
        for i, im in enumerate(self.items):
            yield f"{self.prefix}{i}", np.asarray(im)


def load_inference_source(source):
    """Dispatch a still-image source to a (name, frame) iterator."""
    if isinstance(source, torch.Tensor):
        source = source.detach().cpu().numpy()
    if isinstance(source, np.ndarray):
        return LoadArrays(source, "tensor") if source.ndim == 4 else LoadArrays([source])
    if isinstance(source, (list, tuple)) and source and isinstance(source[0], np.ndarray):
        return LoadArrays(source)
    if isinstance(source, (str, Path, list, tuple)):
        s = str(source)
        if s.startswith(("http://", "https://", "rtsp://", "rtmp://")) or s.isnumeric():
            raise NotImplementedError(f"stream sources are not ported yet (ROADMAP A.9): {s}")
        if Path(s).suffix.lower() in {".mp4", ".avi", ".mov", ".mkv", ".m4v", ".webm", ".gif"}:
            raise NotImplementedError(f"video sources are not ported yet (ROADMAP A.9): {s}")
        return LoadImages(source)
    raise TypeError(f"unsupported source type {type(source).__name__}")
