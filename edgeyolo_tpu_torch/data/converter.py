"""Dataset converters (edgeyolo_tpu/data/converter.py): COCO JSON -> YOLO txt,
VOC XML -> YOLO txt, the COCO 80 <-> 91 class maps, and train/val splitting.
Host tooling, no device; and the DOTA sliding-window tiler of the obb task.
"""

from __future__ import annotations

import json
import random
import shutil
from collections import defaultdict
from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.utils import LOGGER


def coco91_to_coco80_class() -> list:
    """Map COCO 91-index category ids to the contiguous 80-class space."""
    x = [None] * 91
    idx80 = 0
    missing = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91}
    for i in range(1, 92):
        if i in missing:
            continue
        x[i - 1] = idx80
        idx80 += 1
    return x


def coco80_to_coco91_class() -> list:
    """Map contiguous 80-class indices back to COCO 91-id category ids
    (reference utils/ops.py coco80_to_coco91_class) — the ids COCO GT
    annotation jsons use."""
    missing = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91}
    return [i for i in range(1, 92) if i not in missing]


def convert_coco(labels_json: str | Path, save_dir: str | Path, use_segments: bool = False,
                 cls91to80: bool = True) -> Path:
    """COCO instances JSON -> YOLO-format labels (one txt per image)."""
    save_dir = Path(save_dir)
    (save_dir / "labels").mkdir(parents=True, exist_ok=True)
    data = json.loads(Path(labels_json).read_text())
    images = {im["id"]: im for im in data["images"]}
    cmap = coco91_to_coco80_class() if cls91to80 else None
    per_image = defaultdict(list)
    for ann in data["annotations"]:
        if ann.get("iscrowd"):
            continue
        per_image[ann["image_id"]].append(ann)
    n = 0
    for img_id, anns in per_image.items():
        im = images[img_id]
        w, h = im["width"], im["height"]
        lines = []
        for ann in anns:
            cid = ann["category_id"] - 1
            c = cmap[cid] if cmap else cid
            if c is None:
                continue
            if use_segments and ann.get("segmentation"):
                seg = ann["segmentation"][0]
                pts = np.asarray(seg, dtype=np.float64).reshape(-1, 2) / [w, h]
                lines.append(f"{c} " + " ".join(f"{v:.6f}" for v in pts.reshape(-1)))
            else:
                x, y, bw, bh = ann["bbox"]
                cx, cy = (x + bw / 2) / w, (y + bh / 2) / h
                lines.append(f"{c} {cx:.6f} {cy:.6f} {bw / w:.6f} {bh / h:.6f}")
        stem = Path(im["file_name"]).stem
        (save_dir / "labels" / f"{stem}.txt").write_text("\n".join(lines) + "\n")
        n += 1
    LOGGER.info(f"convert_coco: wrote {n} label files to {save_dir / 'labels'}")
    return save_dir


def convert_voc(xml_dir: str | Path, save_dir: str | Path, names: list[str]) -> Path:
    """Pascal-VOC XML annotations -> YOLO labels."""
    import xml.etree.ElementTree as ET

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    name_to_id = {n: i for i, n in enumerate(names)}
    n_files = 0
    for xml_file in sorted(Path(xml_dir).glob("*.xml")):
        root = ET.parse(xml_file).getroot()
        size = root.find("size")
        w = float(size.find("width").text)
        h = float(size.find("height").text)
        lines = []
        for obj in root.iter("object"):
            cls_name = obj.find("name").text
            if cls_name not in name_to_id:
                continue
            bb = obj.find("bndbox")
            x1, y1 = float(bb.find("xmin").text), float(bb.find("ymin").text)
            x2, y2 = float(bb.find("xmax").text), float(bb.find("ymax").text)
            cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
            lines.append(f"{name_to_id[cls_name]} {cx:.6f} {cy:.6f} {(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}")
        (save_dir / f"{xml_file.stem}.txt").write_text("\n".join(lines) + "\n")
        n_files += 1
    LOGGER.info(f"convert_voc: wrote {n_files} label files to {save_dir}")
    return save_dir


def split_train_val(dataset_root: str | Path, val_fraction: float = 0.2, seed: int = 0) -> None:
    """Split images/ + labels/ flat folders into train/ and val/ subfolders."""
    root = Path(dataset_root)
    imgs = sorted((root / "images").glob("*.*"))
    imgs = [p for p in imgs if p.is_file() and p.parent.name == "images"]
    rng = random.Random(seed)
    rng.shuffle(imgs)
    n_val = max(1, round(len(imgs) * val_fraction))
    for split, subset in (("val", imgs[:n_val]), ("train", imgs[n_val:])):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for img in subset:
            shutil.move(str(img), root / "images" / split / img.name)
            lbl = root / "labels" / f"{img.stem}.txt"
            if lbl.exists():
                shutil.move(str(lbl), root / "labels" / split / lbl.name)
    LOGGER.info(f"split_train_val: {len(imgs) - n_val} train / {n_val} val")


def _poly_area(p: np.ndarray) -> float:
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def split_dota_image(img: np.ndarray, labels: np.ndarray, crop: int = 1024, gap: int = 200,
                     area_thr: float = 0.7):
    """DOTA's sliding-window tiling of one large image and its 8-coordinate
    obb labels (N, 9) [cls, x1, y1, ..., x4, y4] in pixels: windows of
    `crop` px every crop - gap px, the last flush with the far border. A
    label is kept in a window when its corners clipped to the window keep
    area_thr of its area. Yields (window image, its labels (n, 9) normalised
    to the window, (x0, y0)); the validator's merged DOTA pass moves tile
    predictions back by that origin."""
    h, w = img.shape[:2]
    step = crop - gap
    xs = list(range(0, max(w - crop, 0) + 1, step)) or [0]
    ys = list(range(0, max(h - crop, 0) + 1, step)) or [0]
    if xs[-1] + crop < w:
        xs.append(w - crop)
    if ys[-1] + crop < h:
        ys.append(h - crop)
    for y0 in ys:
        for x0 in xs:
            x1, y1 = min(x0 + crop, w), min(y0 + crop, h)
            keep = []
            for lab in labels:
                pts = lab[1:9].reshape(4, 2)
                clipped = np.clip(pts, [x0, y0], [x1 - 1, y1 - 1])
                a0 = _poly_area(pts)
                if a0 > 0 and _poly_area(clipped) / a0 >= area_thr:
                    loc = (clipped - [x0, y0]) / np.array([x1 - x0, y1 - y0], np.float64)
                    keep.append(np.concatenate([[lab[0]], loc.reshape(-1)]))
            yield img[y0:y1, x0:x1], np.asarray(keep, np.float32).reshape(-1, 9), (x0, y0)
