"""Synthetic dataset generator (edgeyolo_tpu/data/synthetic.py): the detect,
segment, pose, obb and classify tasks.

Coloured shapes on noise backgrounds with exact YOLO-format labels, so the
train, val and predict paths run with no download. Class mapping:
0 = rectangle, 1 = ellipse, 2 = cross (classes past 3 cycle through the
shapes and the palette).

For a seed the draws are the JAX generator's: the same
`np.random.RandomState(seed)` calls in the same order, so the label files
and `dataset.yaml` are byte-identical to what the JAX package writes. The
shapes are rasterised here in numpy (PIL's ImageDraw is not on the card's
machine; the obb task's rotated shapes through `fill_poly`) and the images
are written as PNG, where JAX writes JPEG.

`generate_classify_dataset` writes JAX's folder-per-class set of oriented
gratings under noise, from the same draws, as JPEG q92 on the port's
encoder (PIL's file for the same pixels).

`moving_shapes` draws the same shapes moving across a video's frames, and
`write_mjpeg_avi` writes frames as an MJPEG AVI on the port's JPEG encoder:
the video and tracking inputs of the tests and of chip_smoke.py.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.data.imageio import encode_jpeg, save_jpeg, save_png
from edgeyolo_tpu_torch.data.rasterize import fill_poly

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
    h, w = img.shape[:2]
    ys, xs = _span(y1, y2, h), _span(x1, x2, w)
    img[ys, xs] = outline
    img[_span(y1 + 1, y2 - 1, h), _span(x1 + 1, x2 - 1, w)] = fill


def draw_ellipse(img, x1, y1, x2, y2, fill, outline=WHITE):
    h, w = img.shape[:2]
    ys, xs = _span(y1, y2, h), _span(x1, x2, w)
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
    h, w = img.shape[:2]
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    img[_span(max(cy - w_h / 2, y1), min(cy + w_h / 2, y2), h), _span(x1, x2, w)] = fill
    img[_span(y1, y2, h), _span(max(cx - w_v / 2, x1), min(cx + w_v / 2, x2), w)] = fill


def draw_shape(img, c: int, x1, y1, x2, y2):
    """Class c's shape in its palette colour (the dataset's drawing)."""
    color = PALETTE[c % len(PALETTE)]
    if c % 3 == 0:
        draw_rectangle(img, x1, y1, x2, y2, color)
    elif c % 3 == 1:
        draw_ellipse(img, x1, y1, x2, y2, color)
    else:
        draw_cross(img, x1, y1, x2, y2, color, max(3, int((y2 - y1) / 5)),
                   max(3, int((x2 - x1) / 5)))


def polygon_mask(shape, pts) -> np.ndarray:
    """(H, W) bool: the polygon of (x, y) vertices pts, rounded to pixels, filled."""
    pts = np.round(np.asarray(pts)).astype(np.int32)
    return fill_poly(np.zeros(shape[:2], np.uint8), pts) > 0


def draw_rotated(img, c: int, cx, cy, w, h, theta):
    """Class c's shape rotated by theta about (cx, cy): a filled rectangle with
    a white rim, a diamond in a white frame, or a cross of two bars. Returns
    its four corners (going along the width first)."""
    ct, st = np.cos(theta), np.sin(theta)

    def rot(pts):
        return [(cx + dx * ct - dy * st, cy + dx * st + dy * ct) for dx, dy in pts]

    def rect(hw, hh):
        return rot([(-hw, -hh), (hw, -hh), (hw, hh), (-hw, hh)])

    color = PALETTE[c % len(PALETTE)]
    if c % 3 < 2:
        outer = polygon_mask(img.shape, rect(w / 2, h / 2))
        inner = polygon_mask(img.shape, rect(w / 2 - 1, h / 2 - 1))
        img[outer & ~inner] = WHITE
        if c % 3 == 0:
            img[inner] = color
        else:
            img[polygon_mask(img.shape, rot([(0, -h / 2), (w / 2, 0), (0, h / 2),
                                              (-w / 2, 0)]))] = color
    else:
        t_h, t_v = max(3, int(h / 5)), max(3, int(w / 5))
        img[polygon_mask(img.shape, rect(w / 2, t_h / 2))
            | polygon_mask(img.shape, rect(t_v / 2, h / 2))] = color
    return rect(w / 2, h / 2)


def moving_shapes(n_frames: int, height: int, width: int, n_objs: int = 3, nc: int = 3,
                  size: tuple[float, float] = (0.2, 0.3), speed: float = 2.0, seed: int = 0):
    """Frames of shapes over one noise background, each moving `speed` px a
    frame up and down its own column of the frame (width / n_objs wide, its
    width capped to fit) and bouncing off the borders, so no two overlap.

    Returns (frames (n_frames, H, W, 3) uint8, boxes (n_frames, n_objs, 5)
    [cls, x1, y1, x2, y2] in pixels). `size` is the range of a side as a
    fraction of the short side.
    """
    rng = np.random.RandomState(seed)
    bg = (rng.rand(height, width, 3) * 60 + 90).astype(np.uint8)
    short, lane = min(height, width), width / n_objs
    objs = []
    for k in range(n_objs):
        w, h = (rng.uniform(*size) * short for _ in range(2))
        w = min(w, lane - 6)
        x = lane * k + 3 + rng.uniform(0, lane - 6 - w)
        y = rng.uniform(2, height - h - 2)
        objs.append([k % nc, x, y, w, h, speed * rng.choice([-1.0, 1.0])])
    frames = np.empty((n_frames, height, width, 3), np.uint8)
    boxes = np.zeros((n_frames, n_objs, 5), np.float32)
    for t in range(n_frames):
        img = bg.copy()
        for k, o in enumerate(objs):
            c, x, y, w, h, v = o
            draw_shape(img, c, x, y, x + w, y + h)
            boxes[t, k] = (c, x, y, x + w, y + h)
            if not 1 <= y + v <= height - 1 - h:
                o[5] = v = -v
            o[2] = y + v
        frames[t] = img
    return frames, boxes


def write_mjpeg_avi(path: str | Path, frames, fps: int = 30, quality: int = 90) -> Path:
    """Write frames (each (H, W, 3) uint8, one size) as an MJPEG AVI: RIFF
    'AVI ' with one 'MJPG' video stream, each frame a '00dc' chunk holding a
    baseline 4:2:0 JPEG of the port's encoder, and an idx1 index."""
    frames = list(frames)
    if not frames:
        raise ValueError("write_mjpeg_avi needs at least one frame")
    h, w = frames[0].shape[:2]
    jpegs = [encode_jpeg(np.ascontiguousarray(f, np.uint8), quality=quality) for f in frames]

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) % 2)

    def lst(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    n, big = len(jpegs), max(len(j) for j in jpegs)
    avih = struct.pack("<14I", 1_000_000 // fps, big * fps, 0, 0x10, n, 0, 1, big, w, h, 0, 0, 0, 0)
    strh = b"vidsMJPG" + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, n, big,
                                     0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh)
                                                  + chunk(b"strf", strf)))
    movi, index, off = b"", b"", 4
    for j in jpegs:
        c = chunk(b"00dc", j)
        index += b"00dc" + struct.pack("<III", 0x10, off, len(j))
        movi += c
        off += len(c)
    body = b"AVI " + hdrl + lst(b"movi", movi) + chunk(b"idx1", index)
    path = Path(path)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def generate_dataset(root: str | Path, n_train: int = 16, n_val: int = 8, imgsz: int = 320,
                     nc: int = 3, max_objs: int = 4, min_objs: int = 1, min_size: float = 0.15,
                     max_size: float = 0.4, seed: int = 0, task: str = "detect") -> Path:
    """Create {root}/{images,labels}/{train,val} and dataset.yaml; returns the yaml path.

    task "detect" writes xywh labels, "segment" each shape's box-corner
    polygon, "pose" xywh and 5 keypoints (the corners, then the centre; the
    yaml names kpt_shape [5, 3] and flip_idx), "obb" the 4 corners of a
    shape rotated by up to pi/3 either way: JAX's labels, draw for draw."""
    if task not in ("detect", "segment", "pose", "obb"):
        raise ValueError(f"unknown synthetic task '{task}' (classify: "
                         "generate_classify_dataset)")
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
                S = imgsz
                if task == "obb":
                    theta = rng.uniform(-np.pi / 3, np.pi / 3)
                    r = float(np.hypot(w, h)) / 2
                    cx = rng.uniform(r + 2, imgsz - r - 2)
                    cy = rng.uniform(r + 2, imgsz - r - 2)
                    corners = draw_rotated(img, c, cx, cy, w, h, theta)
                    lines.append(f"{c} " + " ".join(f"{v/S:.6f}" for xy in corners for v in xy))
                    continue
                cx = rng.uniform(w / 2 + 2, imgsz - w / 2 - 2)
                cy = rng.uniform(h / 2 + 2, imgsz - h / 2 - 2)
                x1, y1, x2, y2 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
                if c % 3 == 0:
                    draw_rectangle(img, x1, y1, x2, y2, color)
                elif c % 3 == 1:
                    draw_ellipse(img, x1, y1, x2, y2, color)
                else:
                    draw_cross(img, x1, y1, x2, y2, color, max(3, int(h / 5)), max(3, int(w / 5)))
                if task == "segment":
                    pts = " ".join(f"{v/S:.6f}" for v in (x1, y1, x2, y1, x2, y2, x1, y2))
                    lines.append(f"{c} {pts}")
                elif task == "pose":
                    kpts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2), (cx, cy)]
                    ks = " ".join(f"{px/S:.6f} {py/S:.6f} 2" for px, py in kpts)
                    lines.append(f"{c} {cx/S:.6f} {cy/S:.6f} {w/S:.6f} {h/S:.6f} {ks}")
                else:
                    lines.append(f"{c} {cx/S:.6f} {cy/S:.6f} {w/S:.6f} {h/S:.6f}")
            save_png(root / "images" / split / f"{split}_{i:04d}.png", img)
            (root / "labels" / split / f"{split}_{i:04d}.txt").write_text("\n".join(lines) + "\n")
    yaml_path = root / "dataset.yaml"
    names = "\n".join(f"  {i}: {n}" for i, n in enumerate(class_names(nc)))
    # the corners (TL, TR, BR, BL) and the centre; a left-right flip swaps TL-TR and BL-BR
    extra = "kpt_shape: [5, 3]\nflip_idx: [1, 0, 3, 2, 4]\n" if task == "pose" else ""
    yaml_path.write_text(f"path: {root.resolve()}\ntrain: images/train\nval: images/val\n"
                         f"nc: {nc}\nnames:\n{names}\n{extra}")
    return yaml_path


def generate_classify_dataset(root: str | Path, nc: int = 4, n_train_per_class: int = 8,
                              n_val_per_class: int = 4, size_range: tuple[int, int] = (60, 140),
                              noise: float = 60.0, seed: int = 0) -> Path:
    """{root}/{train,val}/grating_{c}/*.jpg: class c is a grating at angle
    c * pi / nc under Gaussian pixel noise, each image non-square with sides
    in size_range (so the resize and centre crop of the eval transform do
    work). Returns the root."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train_per_class), ("val", n_val_per_class)):
        for c in range(nc):
            d = root / split / f"grating_{c}"
            d.mkdir(parents=True, exist_ok=True)
            theta = c * np.pi / nc
            for i in range(n):
                h = int(rng.randint(size_range[0], size_range[1] + 1))
                w = int(rng.randint(size_range[0], size_range[1] + 1))
                if h == w:
                    w += 3
                yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
                period = rng.uniform(8, 16)
                phase = rng.uniform(0, 2 * np.pi)
                g = np.sin((xx * np.cos(theta) + yy * np.sin(theta)) * (2 * np.pi / period)
                           + phase)
                im = (127 + 70 * g)[..., None] + rng.normal(0, noise, (h, w, 3))
                save_jpeg(d / f"{split}_{c}_{i:04d}.jpg", np.clip(im, 0, 255).astype(np.uint8),
                          quality=92)
    return root
