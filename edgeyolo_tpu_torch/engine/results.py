"""Prediction containers (edgeyolo_tpu/engine/results.py), detection and
segment parts.

`Boxes` holds (N, 6) [x1, y1, x2, y2, conf, cls] rows in pixels of the
original image, or (N, 7) with a track id after the box, with the xywh and
normalised views; `Masks` holds (N, h0, w0) instance masks over the
original image, with their outlines as polygons (`xy`, `xyn`: the numpy
trace of ops/segments.py); `Results` holds one image's boxes (and masks)
with `plot` (each mask blended 0.6 image + 0.4 its colour, by instance
index, under the boxes), `save`,
`show`, `save_txt` (a segment model's polygons), `save_crop`, `to_json`
(with segments) and `verbose_str`. `plot` draws
as JAX's does with PIL (utils/plotting.py: the same rectangles pixel for
pixel, the label text in the port's bitmap font). Host numpy: the device
work ends at the NMS output.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.data.imageio import save_jpeg, save_png
from edgeyolo_tpu_torch.ops.segments import masks2segments
from edgeyolo_tpu_torch.utils import LOGGER
from edgeyolo_tpu_torch.utils.plotting import BitmapFont, rectangle, text

PALETTE = [
    (255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29), (207, 210, 49),
    (72, 249, 10), (146, 204, 23), (61, 219, 134), (26, 147, 52), (0, 212, 187),
    (44, 153, 168), (0, 194, 255), (52, 69, 147), (100, 115, 255), (0, 24, 236),
    (132, 56, 255), (82, 0, 133), (203, 56, 255), (255, 149, 200), (255, 55, 199),
]


def _colors(i) -> tuple[int, int, int]:
    return PALETTE[int(i) % len(PALETTE)]


class Boxes:
    """Detection boxes: data (N, 6) = [x1, y1, x2, y2, conf, cls], or (N, 7)
    = [x1, y1, x2, y2, id, conf, cls] for tracks; orig_shape = (h, w)."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        data = np.asarray(data, dtype=np.float32)
        ncol = data.shape[-1] if data.ndim > 1 and data.size else 6
        self.data = data.reshape(-1, ncol)
        self.is_track = ncol == 7
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return Boxes(self.data[i], self.orig_shape)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def id(self):
        return self.data[:, 4] if self.is_track else None

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def xywh(self):
        b = self.data[:, :4]
        return np.concatenate([(b[:, :2] + b[:, 2:4]) / 2, b[:, 2:4] - b[:, :2]], axis=1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.xyxy / np.asarray([w, h, w, h], np.float32)

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.asarray([w, h, w, h], np.float32)


class Masks:
    """Instance masks (N, h0, w0), bool or 0/1, over the original image;
    `xy` and `xyn` their outlines as (K, 2) polygons in pixels and normalised."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        self.data = np.asarray(data)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return Masks(self.data[i].reshape((-1, *self.data.shape[1:])), self.orig_shape)

    @property
    def xy(self) -> list[np.ndarray]:
        return masks2segments(self.data)

    @property
    def xyn(self) -> list[np.ndarray]:
        h, w = self.orig_shape
        return [sg / np.asarray([w, h], np.float32) for sg in self.xy]


class Results:
    """One image's detections (and instance masks)."""

    def __init__(self, orig_img: np.ndarray, path: str, names: dict,
                 boxes: np.ndarray | None = None, speed: dict | None = None,
                 masks: np.ndarray | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes) if self.boxes is not None else 0

    def __getitem__(self, i):
        r = Results(self.orig_img, self.path, self.names, speed=self.speed)
        if self.boxes is not None:
            r.boxes = self.boxes[i]
        if self.masks is not None:
            r.masks = self.masks[i]
        return r

    def update(self, boxes: np.ndarray | None = None, masks: np.ndarray | None = None):
        if boxes is not None:
            self.boxes = Boxes(boxes, self.orig_shape)
        if masks is not None:
            self.masks = Masks(masks, self.orig_shape)
        return self

    def plot(self, line_width: int | None = None, font_size: int | None = None,
             labels: bool = True, conf: bool = True) -> np.ndarray:
        """The original image with each box, its class name (and track id)
        and confidence drawn on a copy: HWC RGB uint8. Line width
        max(round((w + h) / 2 * 0.003), 2), font size max(12, 4 x line width),
        a filled band in the box's colour behind white text at its top left."""
        im = np.array(self.orig_img, dtype=np.uint8, copy=True)
        if im.ndim == 2:
            im = np.repeat(im[..., None], 3, axis=2)
        if self.masks is not None:
            for i, m in enumerate(self.masks.data):
                c = np.asarray(_colors(i), np.float32)
                sel = np.asarray(m) > 0.5
                im[sel] = (0.6 * im[sel] + 0.4 * c).astype(np.uint8)
        h, w = im.shape[:2]
        lw = line_width or max(round((w + h) / 2 * 0.003), 2)
        font = BitmapFont(font_size or max(12, lw * 4))
        if self.boxes is not None:
            ids = self.boxes.id
            for k, b in enumerate(self.boxes.data):
                x1, y1, x2, y2 = b[:4].tolist()
                cf, c = float(b[-2]), float(b[-1])
                color = _colors(c)
                rectangle(im, [x1, y1, x2, y2], color, lw)
                if labels:
                    name = self.names.get(int(c), str(int(c)))
                    if ids is not None:
                        name = f"id:{int(ids[k])} {name}"
                    label = f"{name} {cf:.2f}" if conf else name
                    bx0, by0, bx1, by1 = font.getbbox(label)
                    rectangle(im, [x1 + bx0, y1 + by0 - 2, x1 + bx1 + 2, y1 + by1], color,
                              fill=True)
                    text(im, (x1 + 1, y1 - 1), label, (255, 255, 255), font)
        return im

    def save(self, filename: str | Path, **plot_kwargs) -> str:
        """`plot` written to `filename`: PNG for a .png name, else a JPEG at
        PIL's default quality, 75."""
        img = self.plot(**plot_kwargs)
        if str(filename).lower().endswith(".png"):
            save_png(filename, img)
        else:
            save_jpeg(filename, img, quality=75)
        return str(filename)

    def show(self, *a, **kw):
        """Display `plot`: the port has no image viewer, so, as PIL does on a
        machine with none, nothing is shown."""
        self.plot(*a, **kw)
        LOGGER.info(f"{self.path}: no image viewer; use save() to write the annotated image")

    def save_txt(self, txt_file: str | Path, save_conf: bool = False):
        """Append one line per detection (6 significant digits): `cls xywhn
        [conf]`, or with masks `cls x1 y1 ... xn yn [conf]` of its normalised
        outline (none for a mask of fewer than 3 outline points)."""
        lines = []
        if self.masks is not None and self.boxes is not None:
            for b, seg in zip(self.boxes.data, self.masks.xyn):
                if len(seg) < 3:
                    continue
                vals = [int(b[-1]), *seg.reshape(-1).tolist()] + ([float(b[-2])] if save_conf
                                                                  else [])
                lines.append(" ".join(f"{v:.6g}" if j else str(v) for j, v in enumerate(vals)))
        elif self.boxes is not None:
            for b, xywhn in zip(self.boxes.data, self.boxes.xywhn):
                vals = [int(b[-1]), *xywhn.tolist()] + ([float(b[-2])] if save_conf else [])
                lines.append(" ".join(f"{v:.6g}" if j else str(v) for j, v in enumerate(vals)))
        if lines:
            Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
            with open(txt_file, "a") as f:
                f.write("\n".join(lines) + "\n")

    def save_crop(self, save_dir: str | Path, file_name: str | Path = "im.jpg"):
        """One crop per detection under save_dir/<class name>/, the box grown by
        gain 1.02 and 10 px (reference save_one_box), named stem, stem1, stem2, ...
        A .png name writes PNG; any other a JPEG at PIL's default quality, 75."""
        if self.boxes is None:
            return
        h, w = self.orig_shape
        stem, suffix = Path(file_name).stem, Path(file_name).suffix or ".jpg"
        for k, b in enumerate(self.boxes.data):
            x1, y1, x2, y2 = b[:4]
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            bw, bh = (x2 - x1) * 1.02 + 10, (y2 - y1) * 1.02 + 10
            xa, xb = int(np.clip(cx - bw / 2, 0, w)), int(np.clip(cx + bw / 2, 0, w))
            ya, yb = int(np.clip(cy - bh / 2, 0, h)), int(np.clip(cy + bh / 2, 0, h))
            if xb <= xa or yb <= ya:
                continue
            d = Path(save_dir) / self.names.get(int(b[-1]), str(int(b[-1])))
            d.mkdir(parents=True, exist_ok=True)
            crop = np.ascontiguousarray(self.orig_img[ya:yb, xa:xb], np.uint8)
            path = d / f"{stem}{'' if k == 0 else k}{suffix}"
            if suffix.lower() == ".png":
                save_png(path, crop)
            else:
                save_jpeg(path, crop, quality=75)

    def to_json(self, normalize: bool = False) -> str:
        out = []
        h, w = self.orig_shape
        if self.boxes is not None:
            segs = None if self.masks is None else (self.masks.xyn if normalize
                                                    else self.masks.xy)
            for i, b in enumerate(self.boxes.data):
                x1, y1, x2, y2 = b[:4]
                if normalize:
                    x1, y1, x2, y2 = x1 / w, y1 / h, x2 / w, y2 / h
                row = {
                    "name": self.names.get(int(b[-1]), str(int(b[-1]))),
                    "class": int(b[-1]), "confidence": round(float(b[-2]), 5),
                    "box": {"x1": round(float(x1), 5), "y1": round(float(y1), 5),
                            "x2": round(float(x2), 5), "y2": round(float(y2), 5)},
                }
                if segs is not None:
                    row["segments"] = {"x": np.round(segs[i][:, 0], 5).tolist(),
                                       "y": np.round(segs[i][:, 1], 5).tolist()}
                out.append(row)
        return json.dumps(out, indent=2)

    @property
    def verbose_str(self) -> str:
        if self.boxes is None or len(self.boxes) == 0:
            return "(no detections)"
        counts: dict[int, int] = {}
        for c in self.boxes.cls:
            counts[int(c)] = counts.get(int(c), 0) + 1
        return ", ".join(f"{n} {self.names.get(c, c)}{'s' if n > 1 else ''}"
                         for c, n in sorted(counts.items()))
