"""Synthetic detection dataset generator (edgeyolo_tpu/data/synthetic.py), detect task.

Coloured shapes on noise backgrounds with exact YOLO-format labels, so the
train, val and predict paths run with no download. Class mapping:
0 = rectangle, 1 = ellipse, 2 = cross (classes past 3 cycle through the
shapes and the palette).

For a seed the draws are the JAX generator's: the same
`np.random.RandomState(seed)` calls in the same order, so the label files
and `dataset.yaml` are byte-identical to what the JAX package writes. The
shapes are rasterised here in numpy (PIL's ImageDraw is not on the card's
machine) and the images are written as PNG, where JAX writes JPEG.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.data.imageio import save_png

PALETTE = [(220, 40, 40), (40, 180, 60), (50, 80, 220), (230, 200, 40), (160, 60, 200)]
_SHAPES = ("rectangle", "ellipse", "cross")
WHITE = (255, 255, 255)


def class_names(nc: int) -> list[str]:
    """A distinct name per class: (shape, colour) pairs are unique for nc <= 15."""
    if nc <= 3:
        return list(_SHAPES[:nc])
    return [f"{_SHAPES[c % 3]}_{c % len(PALETTE)}" for c in range(nc)]


def _span(lo: float, hi: float, n: int) -> slice:
    """Pixels whose centres (integer coordinates) lie in [lo, hi]."""
    return slice(max(int(np.ceil(lo)), 0), min(int(np.floor(hi)), n - 1) + 1)


def draw_rectangle(img, x1, y1, x2, y2, fill, outline=WHITE):
    n = img.shape[0]
    ys, xs = _span(y1, y2, n), _span(x1, x2, n)
    img[ys, xs] = outline
    img[_span(y1 + 1, y2 - 1, n), _span(x1 + 1, x2 - 1, n)] = fill


def draw_ellipse(img, x1, y1, x2, y2, fill, outline=WHITE):
    n = img.shape[0]
    ys, xs = _span(y1, y2, n), _span(x1, x2, n)
    yy, xx = np.mgrid[ys, xs]
    cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
    d = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
    inner = ((xx - cx) / max(rx - 1, 1e-6)) ** 2 + ((yy - cy) / max(ry - 1, 1e-6)) ** 2
    region = img[ys, xs]
    region[d <= 1] = outline
    region[inner <= 1] = fill


def draw_cross(img, x1, y1, x2, y2, fill, w_h: int, w_v: int):
    """A horizontal bar of thickness w_h through the centre and a vertical one
    of thickness w_v, each clipped to the box."""
    n = img.shape[0]
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    img[_span(max(cy - w_h / 2, y1), min(cy + w_h / 2, y2), n), _span(x1, x2, n)] = fill
    img[_span(y1, y2, n), _span(max(cx - w_v / 2, x1), min(cx + w_v / 2, x2), n)] = fill


def generate_dataset(root: str | Path, n_train: int = 16, n_val: int = 8, imgsz: int = 320,
                     nc: int = 3, max_objs: int = 4, min_objs: int = 1, min_size: float = 0.15,
                     max_size: float = 0.4, seed: int = 0, task: str = "detect") -> Path:
    """Create {root}/{images,labels}/{train,val} and dataset.yaml; returns the yaml path."""
    if task != "detect":
        raise NotImplementedError(f"synthetic task '{task}' is not ported yet (ROADMAP A.10)")
    root = Path(root)
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            img = (rng.rand(imgsz, imgsz, 3) * 60 + 90).astype(np.uint8)
            lines = []
            for _ in range(rng.randint(min_objs, max_objs + 1)):
                c = int(rng.randint(0, nc))
                w = rng.uniform(min_size, max_size) * imgsz
                h = rng.uniform(min_size, max_size) * imgsz
                color = PALETTE[c % len(PALETTE)]
                cx = rng.uniform(w / 2 + 2, imgsz - w / 2 - 2)
                cy = rng.uniform(h / 2 + 2, imgsz - h / 2 - 2)
                x1, y1, x2, y2 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
                if c % 3 == 0:
                    draw_rectangle(img, x1, y1, x2, y2, color)
                elif c % 3 == 1:
                    draw_ellipse(img, x1, y1, x2, y2, color)
                else:
                    draw_cross(img, x1, y1, x2, y2, color, max(3, int(h / 5)), max(3, int(w / 5)))
                S = imgsz
                lines.append(f"{c} {cx/S:.6f} {cy/S:.6f} {w/S:.6f} {h/S:.6f}")
            save_png(root / "images" / split / f"{split}_{i:04d}.png", img)
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text("\n".join(lines) + "\n")
    yaml_path = root / "dataset.yaml"
    names = "\n".join(f"  {i}: {n}" for i, n in enumerate(class_names(nc)))
    yaml_path.write_text(
        f"path: {root.resolve()}\ntrain: images/train\nval: images/val\nnc: {nc}\nnames:\n{names}\n")
    return yaml_path
