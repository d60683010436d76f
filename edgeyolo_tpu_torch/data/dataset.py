"""YOLO-format dataset and loader (edgeyolo_tpu/data/dataset.py): the detect,
segment, pose and obb tasks.

File scanning with `fraction`, a header check of every image, label parsing
with the JSON label cache (the JAX package's file name, format and `sig`, so
either package reads the other's cache), class filtering, `single_cls`, the
rect-val canvas shapes, letterboxed samples with labels mapped into
letterbox space, and an optional RAM cache of decoded images.

With task="segment" each label line may be a polygon (x1 y1 ... xn yn,
normalised), whose box is its extent; a box-only line becomes its
box-corner polygon, so segments stay index-aligned with the classes (the
class filter keeps them aligned), and the cache records the task. Each
sample then carries `masks` (max_gt, H / mask_ratio, W / mask_ratio), the
polygons rasterised as JAX's cv2 path does (data/rasterize.py) and made
exclusive where they overlap.

With task="pose" a line `cls x y w h` + K x D keypoint values (kpt_shape
(K, D), D = 2 lines getting visibility 2) carries each instance's
keypoints (zeros for a box-only line, so they stay aligned with the
classes); a sample's `keypoints` (max_gt, K, 3) are in letterbox pixels.
With task="obb" each line is a polygon (a box-only line its corners), and
a sample carries `rboxes` (max_gt, 5): the minimum-area rectangle of the
polygon fitted in the original image's pixels (`poly2rbox`, rotating
calipers over the convex hull, angle in [-pi/4, 3pi/4) with w >= h), then
mapped through the letterbox and normalised by the canvas, and
`rboxes_ori` (max_gt, 5), the same rectangles in original pixels.

Batches have fixed shapes: images (B, imgsz, imgsz, 3) uint8 (or one rect
canvas per batch), and labels padded to the dataset's `max_gt` with a
validity mask. The last batch of an epoch is padded by repeating its last
item, and `n_real` says how many are real. The trainer augments on the
device (data/augment_device.py); the host only decodes and letterboxes, in
one prefetch thread that hands each batch to the codec library: JPEG files
are decoded there, and the batch is letterboxed there over its threads
(data/letterbox.py).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import queue as queue_mod
import random
import threading
from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.data.imageio import decode_image, image_size, is_jpeg
from edgeyolo_tpu_torch.data.letterbox import LetterboxError, letterbox_batch
from edgeyolo_tpu_torch.data.rasterize import polygon_masks
from edgeyolo_tpu_torch.utils import LOGGER
from edgeyolo_tpu_torch.utils.yamlfile import yaml_load

IMG_FORMATS = {"bmp", "jpeg", "jpg", "png", "tif", "tiff", "webp"}


def img2label_path(img_path: str) -> str:
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return sb.join(img_path.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt"


def check_det_dataset(data: str | Path | dict) -> dict:
    """Parse a dataset YAML (or dict) into {path, train, val, test, names, nc, ...}."""
    if isinstance(data, (str, Path)):
        data = yaml_load(data, append_filename=True)
    data = dict(data)
    root = Path(data.get("path") or Path(data.get("yaml_file", ".")).parent)
    if not root.is_absolute():
        root = (Path(data.get("yaml_file", ".")).parent / root).resolve()
    for split in ("train", "val", "test"):
        if data.get(split):
            p = Path(data[split])
            data[split] = str(p if p.is_absolute() else root / p)
    names = data.get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    data["names"] = {int(k): str(v) for k, v in (names or {}).items()}
    data["nc"] = data.get("nc") or len(data["names"])
    if not data["names"]:
        data["names"] = {i: f"class{i}" for i in range(data["nc"])}
    data["path"] = str(root)
    return data


class YOLODataset:
    """Detection or segment dataset over YOLO-format .txt labels."""

    def __init__(self, img_path: str, imgsz: int = 640, augment: bool = False, rect: bool = False,
                 single_cls: bool = False, classes=None, fraction: float = 1.0,
                 names: dict | None = None, cache: bool | str = False, task: str = "detect",
                 mask_ratio: int = 4, kpt_shape=(17, 3)):
        if task not in ("detect", "segment", "pose", "obb"):
            raise ValueError(f"unknown dataset task '{task}' (classify: "
                             "data/classify.py::ClassificationDataset)")
        self.task, self.mask_ratio = task, int(mask_ratio)
        self.kpt_shape = tuple(int(k) for k in kpt_shape)
        self.img_path = img_path
        self.imgsz = imgsz
        self.augment = augment
        self.cache_ram = str(cache).lower() in ("true", "ram", "1")
        self._im_cache: dict = {}
        self.rect = bool(rect) and not augment
        self._rect_shape = None
        self.single_cls = single_cls
        self.names = names or {}
        self.im_files = self._scan_images(img_path, fraction)
        if not self.im_files:
            raise FileNotFoundError(f"no images found in {img_path}")
        self.labels = self._load_labels()
        if classes is not None:
            self._filter_classes(classes)
        counts = [len(lab["cls"]) for lab in self.labels]
        observed = max(counts) if counts else 1  # labels padded to a multiple of 8, at least 8
        self.max_gt = max(8, int(np.ceil(max(observed, 1) / 8) * 8))

    def __len__(self):
        return len(self.im_files)

    @staticmethod
    def _scan_images(img_path: str, fraction: float) -> list[str]:
        p = Path(img_path)
        files: list[str] = []
        if p.is_dir():
            files = sorted(x for x in glob.glob(str(p / "**" / "*.*"), recursive=True)
                           if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS)
        elif p.is_file() and p.suffix == ".txt":  # a file list
            base = p.parent
            for line in p.read_text().splitlines():
                line = line.strip()
                if line:
                    q = Path(line)
                    files.append(str(q if q.is_absolute() else base / q))
            files.sort()
        elif p.is_file():
            files = [str(p)]
        if fraction < 1.0:
            files = files[:max(1, round(len(files) * fraction))]
        return files

    def _cache_path(self) -> Path:
        h = hashlib.sha1("".join(self.im_files).encode()).hexdigest()[:16]
        return Path(self.im_files[0]).parent.parent / f".edgeyolo_labels_{h}.json"

    def _verify_images(self):
        """Drop images whose header does not read or that are under 10 px, before
        the cache check, so cached labels align with the kept files."""
        good = []
        for f in self.im_files:
            try:
                w0, h0 = image_size(f)
                if w0 < 10 or h0 < 10:
                    raise ValueError(f"image too small {w0}x{h0}")
                good.append(f)
            except (OSError, ValueError) as e:
                LOGGER.warning(f"dropping corrupt image {f}: {e}")
        self.im_files = good
        if not self.im_files:
            raise FileNotFoundError(f"all images under {self.img_path} failed verification")

    def _load_labels(self):
        self._verify_images()
        cache = self._cache_path()
        sig = ["v2"] + [os.path.getmtime(f) if os.path.exists(f) else 0
                        for f in map(img2label_path, self.im_files)]
        if cache.exists():
            try:
                d = json.loads(cache.read_text())
                if d.get("sig") == sig and d.get("task") == self.task:
                    k = self.kpt_shape[0]
                    return [{"cls": np.asarray(lab["cls"], np.float32),
                             "bboxes": np.asarray(lab["bboxes"], np.float32).reshape(-1, 4),
                             "segments": [np.asarray(sg, np.float32).reshape(-1, 2)
                                          for sg in lab.get("segments", [])],
                             "keypoints": np.asarray(lab.get("keypoints") or [],
                                                     np.float32).reshape(-1, k, 3)}
                            for lab in d["labels"]]
            except (ValueError, KeyError, TypeError) as e:
                LOGGER.warning(f"ignoring unreadable label cache {cache}: {e}")
        labels = []
        nm = nf = ne = nch = 0
        poly_task = self.task in ("segment", "obb")
        k, dims = self.kpt_shape
        for f in self.im_files:
            lp = img2label_path(f)
            cls, boxes, segments, kpts = [], [], [], []
            if os.path.exists(lp):
                for line in Path(lp).read_text().splitlines():
                    parts = line.split()
                    if len(parts) < 5:
                        continue
                    c = float(parts[0])
                    vals = [float(x) for x in parts[1:]]
                    seg = kp = None
                    if self.task == "pose" and len(vals) == 4 + k * dims:
                        b = vals[:4]
                        kp = np.asarray(vals[4:], np.float32).reshape(k, dims)
                        if dims == 2:
                            kp = np.concatenate([kp, np.full((k, 1), 2, np.float32)], 1)
                    elif len(vals) > 5 and len(vals) % 2 == 0:  # a polygon: its box
                        seg = np.asarray(vals, np.float32).reshape(-1, 2)
                        x1, y1 = seg[:, 0].min(), seg[:, 1].min()
                        x2, y2 = seg[:, 0].max(), seg[:, 1].max()
                        b = [(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1]
                    else:
                        b = vals[:4]
                    if all(0 <= v <= 1.001 for v in b) and b[2] > 0 and b[3] > 0:
                        cls.append(c)
                        boxes.append(b)
                        if self.task == "pose":  # zeros for a box-only line, so they align
                            kpts.append(kp if kp is not None else np.zeros((k, 3), np.float32))
                        if poly_task:  # a box-only line: its corners, so segments align
                            segments.append(seg if seg is not None else np.asarray(
                                [[b[0] - b[2] / 2, b[1] - b[3] / 2],
                                 [b[0] + b[2] / 2, b[1] - b[3] / 2],
                                 [b[0] + b[2] / 2, b[1] + b[3] / 2],
                                 [b[0] - b[2] / 2, b[1] + b[3] / 2]], np.float32))
                        elif seg is not None:
                            segments.append(seg)
                    else:
                        nch += 1
                nf += 1 if cls else 0
                ne += 0 if cls else 1
            else:
                nm += 1
            labels.append({"cls": np.asarray(cls, np.float32),
                           "bboxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                           "segments": segments,
                           "keypoints": np.asarray(kpts, np.float32).reshape(-1, k, 3)})
        LOGGER.info(f"dataset {self.img_path}: {len(self.im_files)} images, {nf} labelled, "
                    f"{ne} empty, {nm} missing labels, {nch} corrupt boxes dropped")
        try:
            cache.write_text(json.dumps({
                "sig": sig, "task": self.task,
                "labels": [{"cls": lab["cls"].tolist(), "bboxes": lab["bboxes"].tolist(),
                            "segments": [sg.tolist() for sg in lab["segments"]],
                            "keypoints": lab["keypoints"].tolist()} for lab in labels]}))
        except OSError as e:
            LOGGER.warning(f"label cache not written ({e})")
        return labels

    def _filter_classes(self, classes):
        keep = list(set(classes))
        for lab in self.labels:
            m = np.isin(lab["cls"], keep)
            if len(lab["segments"]) == len(lab["cls"]):  # keep them aligned with cls
                lab["segments"] = [sg for sg, k in zip(lab["segments"], m) if k]
            if len(lab["keypoints"]) == len(lab["cls"]):
                lab["keypoints"] = lab["keypoints"][m]
            lab["cls"], lab["bboxes"] = lab["cls"][m], lab["bboxes"][m]

    def set_rectangle(self, batch_size: int):
        """Rect val batching: sort by aspect ratio and give each batch one canvas,
        quantised up to a multiple of 64."""
        shapes = []
        for f in self.im_files:
            w, h = image_size(f)
            shapes.append((h, w))
        ar = np.asarray([h / w for h, w in shapes], np.float64)
        order = np.argsort(ar).tolist()
        self.im_files = [self.im_files[i] for i in order]
        self.labels = [self.labels[i] for i in order]
        ar = ar[order]
        n = len(ar)
        self._rect_shape = [None] * n
        for b in range(0, n, batch_size):
            sl = ar[b:b + batch_size]
            shape = [1.0, 1.0]
            if sl.max() < 1:
                shape = [float(sl.max()), 1.0]
            elif sl.min() > 1:
                shape = [1.0, float(1 / sl.min())]
            H = int(np.ceil(shape[0] * self.imgsz / 64) * 64)
            W = int(np.ceil(shape[1] * self.imgsz / 64) * 64)
            for i in range(b, min(b + batch_size, n)):
                self._rect_shape[i] = (H, W)
        self.rect = True

    def _target(self, i: int):
        return self._rect_shape[i] if (self.rect and self._rect_shape) else self.imgsz

    def _letterboxed(self, idx: list[int]) -> dict:
        """{i: (img, r, (pw, ph), (h0, w0))} for distinct indices, each canvas
        shape's images decoded and letterboxed in one threaded library call."""
        out, todo = {}, {}
        for i in idx:
            ck = (i, self._target(i))
            if self.cache_ram and ck in self._im_cache:
                out[i] = self._im_cache[ck]
            else:
                todo.setdefault(ck[1], []).append(i)
        for target, group in todo.items():
            sources = []
            for i in group:
                data = Path(self.im_files[i]).read_bytes()
                sources.append(data if is_jpeg(data) else decode_image(data, self.im_files[i]))
            try:
                imgs, metas = letterbox_batch(sources, target, scaleup=self.augment)
            except LetterboxError as e:  # name the file, not only its place in the batch
                raise ValueError(f"{self.im_files[group[e.index]]}: {e}") from None
            for i, img, (r, pads, hw) in zip(group, imgs, metas):
                out[i] = (img, r, pads, hw)
                if self.cache_ram:
                    self._im_cache[(i, target)] = out[i]
        return out

    def get_items(self, idx: list[int]) -> list[dict]:
        """Samples for `idx` (repeats allowed), decoded and letterboxed together."""
        decoded = self._letterboxed(list(dict.fromkeys(idx)))
        return [self._sample(i, *decoded[i]) for i in idx]

    def get_item(self, i: int) -> dict:
        """One sample: letterboxed uint8 image and padded normalised-xywh labels."""
        return self.get_items([i])[0]

    def _sample(self, i: int, img, r, pads, hw) -> dict:
        (pw, ph), (h0, w0) = pads, hw
        H, W = img.shape[:2]
        lab = self.labels[i]
        cls = lab["cls"].copy()
        boxes = lab["bboxes"].copy()  # normalised xywh in the original image
        if self.single_cls:
            cls[:] = 0
        if len(boxes):  # into normalised letterbox coordinates
            boxes = boxes * np.array([w0 * r / W, h0 * r / H, w0 * r / W, h0 * r / H])
            boxes[:, 0] += pw / W
            boxes[:, 1] += ph / H
        n = min(len(cls), self.max_gt)
        pc = np.zeros(self.max_gt, np.float32)
        pb = np.zeros((self.max_gt, 4), np.float32)
        pm = np.zeros(self.max_gt, np.float32)
        pc[:n], pm[:n] = cls[:n], 1.0
        if n:
            pb[:n] = boxes[:n]
        item = {"img": img, "cls": pc, "bboxes": pb, "mask_gt": pm, "ori_shape": (h0, w0),
                "ratio_pad": (r, (pw, ph)), "im_file": self.im_files[i],
                "ori_cls": cls, "ori_bboxes": lab["bboxes"]}
        if self.task == "segment":
            item["masks"] = polygon_masks(lab["segments"], n, w0, h0, r, pw, ph, H, W,
                                          self.mask_ratio, self.max_gt)
        elif self.task == "pose":
            pk = np.zeros((self.max_gt, self.kpt_shape[0], 3), np.float32)
            kp = lab["keypoints"][:n].copy()
            kp[..., 0] = kp[..., 0] * w0 * r + pw  # into letterbox pixels
            kp[..., 1] = kp[..., 1] * h0 * r + ph
            pk[:len(kp)] = kp
            item["keypoints"] = pk
        elif self.task == "obb":
            pr = np.zeros((self.max_gt, 5), np.float32)  # letterbox, normalised by the canvas
            pr_ori = np.zeros((self.max_gt, 5), np.float32)  # original pixels
            for j, poly in enumerate(lab["segments"][:n]):
                rb = poly2rbox(poly * np.asarray([w0, h0], np.float32))
                pr_ori[j] = rb
                pr[j] = [(rb[0] * r + pw) / W, (rb[1] * r + ph) / H, rb[2] * r / W, rb[3] * r / H,
                         rb[4]]
            item["rboxes"], item["rboxes_ori"] = pr, pr_ori
        return item


class DataLoader:
    """Fixed-shape numpy batches, decoded one epoch ahead by one thread.

    `shuffle` orders each epoch by `random.Random(seed + epoch)`; the epoch
    advances with each `iter`. A decode error in the thread is raised in the
    consumer."""

    PREFETCH = 2  # batches decoded ahead

    def __init__(self, dataset: YOLODataset, batch_size: int = 16, shuffle: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return (len(self.dataset) + self.bs - 1) // self.bs

    def _indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        return idx

    def _chunks(self, idx: list[int]):
        """The epoch's batches of dataset indices, the last one short."""
        return (idx[start:start + self.bs] for start in range(0, len(idx), self.bs))

    def _collate(self, chunk: list[int]) -> dict:
        """Stack one batch; a short final batch repeats its last item (n_real says)."""
        n_real = len(chunk)
        chunk = chunk + [chunk[-1]] * (self.bs - len(chunk))
        items = self.dataset.get_items(chunk)
        batch = {"img": np.stack([it["img"] for it in items]),
                 "cls": np.stack([it["cls"] for it in items]),
                 "bboxes": np.stack([it["bboxes"] for it in items]),
                 "mask_gt": np.stack([it["mask_gt"] for it in items]),
                 "n_real": n_real, "meta": items}
        for extra in ("masks", "keypoints", "rboxes"):
            if extra in items[0]:
                batch[extra] = np.stack([it[extra] for it in items])
        return batch

    def first_batch(self) -> dict:
        """Batch 0, made in the caller's thread, without advancing the epoch."""
        return self._collate(self._indices()[:self.bs])

    def __iter__(self):
        idx = self._indices()
        self.epoch += 1
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def produce():
            try:
                for chunk in self._chunks(idx):
                    if not put(self._collate(chunk)):
                        return
                put(None)
            except Exception as e:  # noqa: BLE001 - handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    return
                if isinstance(b, Exception):
                    raise b
                yield b
        finally:  # a consumer that stops early releases the thread
            stop.set()
            t.join(timeout=5)


def build_dataloader(dataset, batch_size, shuffle=True, seed=0):
    return DataLoader(dataset, batch_size, shuffle=shuffle, seed=seed)


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain: points (N, 2) -> hull (M, 2), counter-clockwise."""
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(a, b):
        return a[0] * b[1] - a[1] * b[0]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and cross(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    return np.asarray(half(pts)[:-1] + half(pts[::-1])[:-1])


def poly2rbox(poly: np.ndarray) -> np.ndarray:
    """A polygon in pixels -> its minimum-area rectangle (cx, cy, w, h, r),
    by rotating calipers over the convex hull (JAX's `_poly2rbox`, the numpy
    form of cv2.minAreaRect); w >= h and r in [-pi/4, 3pi/4)."""
    p = poly.reshape(-1, 2).astype(np.float64)
    hull = convex_hull(p)
    if len(hull) < 3:  # a line or a point
        c, d = p.mean(0), p.max(0) - p.min(0)
        return np.asarray([c[0], c[1], max(d[0], 1e-6), max(d[1], 1e-6), 0.0], np.float32)
    best = None
    n = len(hull)
    for i in range(n):
        e = hull[(i + 1) % n] - hull[i]
        norm = np.hypot(e[0], e[1])
        if norm < 1e-12:
            continue
        ux, uy = e / norm  # the edge's direction
        rot = np.asarray([[ux, uy], [-uy, ux]])  # turns the edge onto +x
        q = hull @ rot.T
        mn, mx = q.min(0), q.max(0)
        w, h = mx - mn
        if best is None or w * h < best[0]:
            cx, cy = (mn + mx) / 2 @ rot
            best = (w * h, cx, cy, w, h, np.arctan2(uy, ux))
    _, cx, cy, w, h, r = best
    if w < h:
        w, h, r = h, w, r + np.pi / 2
    while r >= 3 * np.pi / 4:
        r -= np.pi
    while r < -np.pi / 4:
        r += np.pi
    return np.asarray([cx, cy, w, h, r], np.float32)
