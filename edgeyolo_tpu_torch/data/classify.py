"""Folder-per-class classification data (edgeyolo_tpu/data/classify.py).

`check_cls_dataset` resolves a root to its train and val (or validation,
else test, else train) splits, each `<split>/<class>/*.<ext>`, or a flat
`root/<class>/*` used for both; the names are the sorted class folders.
`ClassificationDataset` lists a split's images per sorted class (all
depths below the class folder, sorted), keeps the first `fraction` of them,
and yields each (kept in RAM after its first read with `cache`) decoded by
the port's codec (greyscale and RGBA become RGB
as PIL's convert("RGB") makes them; TIFF and WebP raise, as the port's
other loaders do) and put through `resize_center_crop`. `ClassifyLoader`
batches them in one prefetch thread: shuffled by `random.Random(seed +
epoch)`, the short tail dropped with `drop_last`, else padded from the
start of the epoch's order, with `n_real` the count of real images.

`resize_center_crop` is the eval transform at crop_fraction 1.0: the short
side to `size` (the long side truncated with int(), as torchvision does),
PIL's Image.resize with BILINEAR (`resize_bilinear`: its two-pass
fixed-point resample, antialiased when it shrinks), then the centre crop.
It equals JAX's PIL path byte for byte. The stochastic train transforms
run on the device (augment_device.py::classify_augment_batch).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.data.dataset import DataLoader
from edgeyolo_tpu_torch.data.imageio import load_image_rgb
from edgeyolo_tpu_torch.utils import LOGGER

IMG_EXTS = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp"}
PRECISION_BITS = 22  # Pillow's Resample.c: 32 - 8 (uint8) - 2


def check_cls_dataset(data: str | Path) -> dict:
    """A classification root -> {train, val, test, nc, names}."""
    root = Path(data)
    if not root.is_dir():
        raise FileNotFoundError(f"classification dataset root not found: {root}")
    train = root / "train"
    val = next((root / s for s in ("val", "validation") if (root / s).is_dir()), None)
    test = (root / "test") if (root / "test").is_dir() else None
    if not train.is_dir():  # flat layout: root/<class>/*, for train and val
        train = root
    if val is None:
        val = test or train
        LOGGER.warning(f"no val split under {root}; using {val.name or root} for val")
    classes = sorted(d.name for d in train.iterdir() if d.is_dir())
    return {"train": str(train), "val": str(val), "test": str(test) if test else None,
            "nc": len(classes), "names": dict(enumerate(classes))}


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs for the bilinear filter (support 1) over the
    whole axis, normalised and turned to PRECISION_BITS fixed point: per
    output position the first source index (xmin) and the (out, ksize)
    int32 weights (0 past its taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    w = np.maximum(1.0 - np.abs((x[None] + xmin[:, None] - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    w = np.where(x[None] < xmax[:, None], w, 0.0)
    ww = np.zeros((out_size, 1))
    for j in range(ksize):  # summed in tap order, as Pillow's loop sums them
        ww[:, 0] += w[:, j]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = np.trunc(0.5 + w * (1 << PRECISION_BITS)).astype(np.int32)  # sums stay under 2 ** 31
    return xmin, k


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One Pillow pass along `axis` (1: horizontal, 0: vertical) of HWC uint8:
    sum of taps times fixed-point weights plus half, shifted and clipped."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full([out_size if d == axis else n for d, n in enumerate(img.shape)],
                  1 << (PRECISION_BITS - 1), np.int32)
    for j in range(k.shape[1]):  # one tap at a time over the whole image
        src = np.take(img, np.minimum(xmin + j, in_size - 1), axis=axis)
        acc += src * k[:, j].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """HWC uint8 -> (h, w): PIL's Image.resize((w, h), BILINEAR), horizontal
    pass first, each pass rounded and clipped to uint8; a side that keeps
    its size takes no pass."""
    if w != img.shape[1]:
        img = _resample_axis(img, w, 1)
    if h != img.shape[0]:
        img = _resample_axis(img, h, 0)
    return np.ascontiguousarray(img)


def resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Short side to `size` (the long side int(size * long / short), at least
    size), PIL's bilinear resize, then the centre (size, size) crop."""
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = size, max(int(size * w / h), size)
    else:
        nw, nh = size, max(int(size * h / w), size)
    if (nw, nh) != (w, h):
        img = resize_bilinear(img, nw, nh)
    top, left = (nh - size) // 2, (nw - size) // 2
    return np.ascontiguousarray(img[top:top + size, left:left + size])


class ClassificationDataset:
    """A split's images per class folder, as fixed (S, S, 3) uint8 items."""

    def __init__(self, root: str | Path, imgsz: int = 224, augment: bool = False,
                 fraction: float = 1.0, names: dict | None = None, cache: bool | str = False):
        self.root = Path(root)
        self.imgsz = int(imgsz)
        self.augment = augment
        self.cache_ram = str(cache).lower() in ("true", "ram", "1")
        self._cache: dict[int, np.ndarray] = {}
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.names = names or dict(enumerate(classes))
        name_to_ix = {v: k for k, v in self.names.items()}
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            ci = name_to_ix.get(c)
            if ci is None:
                continue
            files = sorted(p for p in (self.root / c).rglob("*") if p.suffix.lower() in IMG_EXTS)
            self.samples += [(str(p), ci) for p in files]
        if fraction < 1.0:
            self.samples = self.samples[:max(1, round(len(self.samples) * fraction))]
        if not self.samples:
            raise FileNotFoundError(f"no images under {self.root}")

    def __len__(self):
        return len(self.samples)

    def get_item(self, i: int) -> dict:
        path, ci = self.samples[i]
        img = self._cache.get(i)
        if img is None:
            img = resize_center_crop(load_image_rgb(path), self.imgsz)
            if self.cache_ram:
                self._cache[i] = img
        return {"img": img, "cls": np.int64(ci), "im_file": path}

    def get_items(self, idx: list[int]) -> list[dict]:
        return [self.get_item(i) for i in idx]


class ClassifyLoader(DataLoader):
    """Fixed-shape batches {"img" (B, S, S, 3) uint8, "cls" (B,) int64,
    "n_real", "meta"}, made one epoch ahead by one thread."""

    def __init__(self, dataset: ClassificationDataset, batch_size: int = 16,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False):
        super().__init__(dataset, batch_size, shuffle=shuffle, seed=seed)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def _chunks(self, idx: list[int]):
        """Full batches, then the tail: dropped with drop_last, else padded
        with the epoch's first indices (JAX's wrap-around)."""
        for start in range(0, len(idx), self.bs):
            chunk = idx[start:start + self.bs]
            if len(chunk) < self.bs:
                if self.drop_last:
                    return
                chunk = chunk + [idx[(start + j) % len(idx)]
                                 for j in range(len(chunk), self.bs)]
                yield chunk, len(idx) - start
                return
            yield chunk, self.bs

    def _collate(self, chunk_n_real: tuple[list[int], int]) -> dict:
        chunk, n_real = chunk_n_real
        items = self.dataset.get_items(chunk)
        return {"img": np.stack([it["img"] for it in items]),
                "cls": np.stack([it["cls"] for it in items]), "n_real": n_real, "meta": items}

    def first_batch(self) -> dict:
        return self._collate(next(iter(self._chunks(self._indices()))))
