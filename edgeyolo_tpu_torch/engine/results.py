"""Prediction containers (edgeyolo_tpu/engine/results.py): detection,
segment, pose, obb and classify parts.

`Boxes` holds (N, 6) [x1, y1, x2, y2, conf, cls] rows in pixels of the
original image, or (N, 7) with a track id after the box, with the xywh and
normalised views; `Masks` holds (N, h0, w0) instance masks over the
original image, with their outlines as polygons (`xy`, `xyn`: the numpy
trace of ops/segments.py); `Results` holds one image's boxes (and masks)
with `plot` (each mask blended 0.6 image + 0.4 its colour, by instance
index, under the boxes), `save`,
`show`, `save_txt` (a segment model's polygons, a pose model's
keypoints, an obb model's corners), `save_crop` (which warns and writes
nothing for obb results, as JAX's), `to_json` (with segments, keypoints or
corner points) and `verbose_str`. `Keypoints` holds (N, K, 2 | 3) pixel
keypoints (and their visibility) and `OBB` (N, 7) [cx, cy, w, h, angle,
conf, cls] rotated boxes with their corner views. `Probs` holds a classify
result's (nc,) probabilities with `top1`, `top5` (the five largest, largest
first), `top1conf` and `top5conf`; as in JAX, a probs result plots as the
image itself, writes no text lines, has no crops (a warning) and an empty
JSON list. `plot` draws as JAX's
does with PIL (utils/plotting.py: the same rectangles, keypoint discs and
wide-line OBB rings pixel for pixel, the label text in the port's bitmap
font). Host numpy: the device work ends at the NMS output.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.data.imageio import save_jpeg, save_png
from edgeyolo_tpu_torch.ops.segments import masks2segments
from edgeyolo_tpu_torch.utils import LOGGER
from edgeyolo_tpu_torch.ops.boxes import xywhr2xyxyxyxy
from edgeyolo_tpu_torch.utils.plotting import BitmapFont, ellipse, line, rectangle, text

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


class Keypoints:
    """Pose keypoints (N, K, 2 | 3): pixel xy and, with 3, the visibility."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        self.data = np.asarray(data)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return Keypoints(self.data[i].reshape((-1, *self.data.shape[1:])), self.orig_shape)

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        h, w = self.orig_shape
        return self.data[..., :2] / np.asarray([w, h], np.float32)

    @property
    def conf(self):
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


class OBB:
    """Rotated boxes (N, 7) = [cx, cy, w, h, angle (rad), conf, cls] in pixels."""

    def __init__(self, data: np.ndarray, orig_shape: tuple[int, int]):
        self.data = np.asarray(data).reshape(-1, 7)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return OBB(self.data[i], self.orig_shape)

    @property
    def xywhr(self):
        return self.data[:, :5]

    @property
    def conf(self):
        return self.data[:, 5]

    @property
    def cls(self):
        return self.data[:, 6]

    @property
    def xyxyxyxy(self) -> np.ndarray:
        """(N, 4, 2) corners, along the width first."""
        return xywhr2xyxyxyxy(self.data[:, :5])

    @property
    def xyxyxyxyn(self) -> np.ndarray:
        h, w = self.orig_shape
        return self.xyxyxyxy / np.asarray([w, h], np.float32)

    @property
    def xyxy(self) -> np.ndarray:
        """(N, 4): the corners' axis-aligned envelope."""
        pts = self.xyxyxyxy
        return np.concatenate([pts.min(1), pts.max(1)], -1)


class Probs:
    """A classify result's class probabilities (nc,)."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.float32)

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self) -> list[int]:
        return self.data.argsort()[-5:][::-1].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data.max())

    @property
    def top5conf(self) -> np.ndarray:
        return self.data[self.top5]


class Results:
    """One image's detections (and instance masks, keypoints or rotated boxes),
    or its class probabilities."""

    def __init__(self, orig_img: np.ndarray, path: str, names: dict,
                 boxes: np.ndarray | None = None, speed: dict | None = None,
                 masks: np.ndarray | None = None, keypoints: np.ndarray | None = None,
                 obb: np.ndarray | None = None, probs: np.ndarray | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.obb = OBB(obb, self.orig_shape) if obb is not None else None
        self.probs = Probs(probs) if probs is not None else None
        self.speed = speed or {}

    def __len__(self):
        if self.obb is not None:
            return len(self.obb)
        return len(self.boxes) if self.boxes is not None else 0

    def __getitem__(self, i):
        r = Results(self.orig_img, self.path, self.names, speed=self.speed)
        for attr in ("boxes", "masks", "keypoints", "obb"):
            v = getattr(self, attr)
            if v is not None:
                setattr(r, attr, v[i])
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
        a filled band in the box's colour behind white text at its top left.
        Keypoints (visibility over 0.25, or all of them without one) are
        green discs of the line width's radius; a rotated box is the ring of
        its corners, its label in its colour at its first corner, with no band."""
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
        if self.keypoints is not None:
            for kp in self.keypoints.data:
                for k in kp:
                    if kp.shape[-1] < 3 or k[2] > 0.25:
                        ellipse(im, [k[0] - lw, k[1] - lw, k[0] + lw, k[1] + lw], (0, 255, 0))
        if self.obb is not None:
            for pts, cf, c in zip(self.obb.xyxyxyxy, self.obb.conf, self.obb.cls):
                color = _colors(c)
                line(im, [tuple(p) for p in pts] + [tuple(pts[0])], color, lw)
                if labels:
                    name = self.names.get(int(c), str(int(c)))
                    text(im, (float(pts[0][0]), float(pts[0][1])),
                         f"{name} {cf:.2f}" if conf else name, color, font)
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
        [conf]`, with keypoints `cls xywhn` and each keypoint's normalised xy
        (and visibility) `[conf]`, with masks `cls x1 y1 ... xn yn [conf]`
        of its normalised outline (none for a mask of fewer than 3 outline
        points), and for rotated boxes `cls` and the 4 normalised corners `[conf]`."""
        lines = []
        if self.obb is not None:
            for pts, cf, c in zip(self.obb.xyxyxyxyn, self.obb.conf, self.obb.cls):
                vals = [int(c), *pts.reshape(-1).tolist()] + ([float(cf)] if save_conf else [])
                lines.append(" ".join(f"{v:.6g}" if i else str(v) for i, v in enumerate(vals)))
        elif self.masks is not None and self.boxes is not None:
            for b, seg in zip(self.boxes.data, self.masks.xyn):
                if len(seg) < 3:
                    continue
                vals = [int(b[-1]), *seg.reshape(-1).tolist()] + ([float(b[-2])] if save_conf
                                                                  else [])
                lines.append(" ".join(f"{v:.6g}" if j else str(v) for j, v in enumerate(vals)))
        elif self.boxes is not None:
            kpn = self.keypoints.data if self.keypoints is not None else None
            h, w = self.orig_shape
            for i, (b, xywhn) in enumerate(zip(self.boxes.data, self.boxes.xywhn)):
                vals = [int(b[-1]), *xywhn.tolist()]
                if kpn is not None:
                    k = kpn[i].astype(np.float64)
                    k[..., 0] /= w
                    k[..., 1] /= h
                    vals += k.reshape(-1).tolist()
                vals += [float(b[-2])] if save_conf else []
                lines.append(" ".join(f"{v:.6g}" if j else str(v) for j, v in enumerate(vals)))
        if lines:
            Path(txt_file).parent.mkdir(parents=True, exist_ok=True)
            with open(txt_file, "a") as f:
                f.write("\n".join(lines) + "\n")

    def save_crop(self, save_dir: str | Path, file_name: str | Path = "im.jpg"):
        """One crop per detection under save_dir/<class name>/, the box grown by
        gain 1.02 and 10 px (reference save_one_box), named stem, stem1, stem2, ...
        A .png name writes PNG; any other a JPEG at PIL's default quality, 75.
        Rotated boxes and class probabilities have no crop: a warning, and
        nothing is written."""
        if self.obb is not None or self.probs is not None:
            LOGGER.warning("save_crop is not supported for "
                           f"{'obb' if self.obb is not None else 'classify'} results")
            return
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
                if self.keypoints is not None:
                    k = self.keypoints.data[i]
                    kx, ky = (k[:, 0] / w, k[:, 1] / h) if normalize else (k[:, 0], k[:, 1])
                    row["keypoints"] = {"x": np.round(kx, 5).tolist(),
                                        "y": np.round(ky, 5).tolist()}
                    if k.shape[-1] == 3:
                        row["keypoints"]["visible"] = np.round(k[:, 2], 5).tolist()
                out.append(row)
        if self.obb is not None:
            pts_all = self.obb.xyxyxyxyn if normalize else self.obb.xyxyxyxy
            for pts, cf, c in zip(pts_all, self.obb.conf, self.obb.cls):
                out.append({"name": self.names.get(int(c), str(int(c))), "class": int(c),
                            "confidence": round(float(cf), 5),
                            "points": [{"x": round(float(p[0]), 5), "y": round(float(p[1]), 5)}
                                       for p in pts]})
        return json.dumps(out, indent=2)

    @property
    def verbose_str(self) -> str:
        src = self.obb if self.obb is not None else self.boxes
        if src is None or len(src) == 0:
            return "(no detections)"
        counts: dict[int, int] = {}
        for c in src.cls:
            counts[int(c)] = counts.get(int(c), 0) + 1
        return ", ".join(f"{n} {self.names.get(c, c)}{'s' if n > 1 else ''}"
                         for c, n in sorted(counts.items()))
