"""COCO outputs of the port against the JAX package, on the CPU.

- Evaluator: metrics/coco_eval.py's `evaluate_coco` against JAX's on seeded
  GT and prediction jsons with crowd boxes, every area range and more than
  100 detections per image: within 1e-12.
- `save_json`: the port validator's predictions.json against the JAX
  validator's, on one JPEG dataset (numeric file stems, 80 class names under a
  "coco" path, so both map categories 80 -> 91) and one EdgeLine-YOLO-n whose
  state_dict is converted into the JAX flagship by convert_state_dict: the
  same rows (image id, category), boxes within 1e-2 px, scores within 1e-4;
  the COCO metrics each validator computes from its own file within 1e-6.
- Converters: `convert_coco` (boxes and segments) and `convert_voc` write
  byte-identical label files; `split_train_val` moves the same files for a
  seed; the 80 <-> 91 class maps are equal.
- `save_crop`: the same file names, and the port's JPEG crops decode to the
  pixels PIL reads from JAX's crops.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from edgeyolo_tpu.cfg import get_cfg as jget_cfg
from edgeyolo_tpu.data import converter as jconverter
from edgeyolo_tpu.engine.results import Results as JResults
from edgeyolo_tpu.engine.validator import DetectionValidator as JValidator
from edgeyolo_tpu.metrics.coco_eval import evaluate_coco as jevaluate_coco
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.utils.torch_convert import convert_state_dict
from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.data import converter
from edgeyolo_tpu_torch.data.imageio import load_image_rgb, save_jpeg
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine.results import Results
from edgeyolo_tpu_torch.engine.validator import DetectionValidator
from edgeyolo_tpu_torch.metrics.coco_eval import evaluate_coco
from edgeyolo_tpu_torch.nn.modules.edgeline import WaveletEnhancer
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

S = 64


# -- evaluator ----------------------------------------------------------------------
def _coco_jsons(tmp_path, seed):
    rs = np.random.RandomState(seed)
    images, anns, preds = [], [], []
    for img_id in range(1, 7):
        images.append({"id": img_id, "width": 640, "height": 480, "file_name": f"{img_id}.jpg"})
        for _ in range(rs.randint(3, 15)):
            w, h = rs.uniform(4, 300, 2)  # small, medium and large
            x, y = rs.uniform(0, 640 - w), rs.uniform(0, 480 - h)
            anns.append({"id": len(anns) + 1, "image_id": img_id, "category_id": int(rs.randint(1, 5)),
                         "bbox": [x, y, w, h], "area": w * h, "iscrowd": int(rs.rand() < 0.1)})
        for _ in range(130):  # more than maxDets
            a = anns[rs.randint(len(anns))]
            jit = rs.normal(0, 0.15, 4) * np.array([*a["bbox"][2:], *a["bbox"][2:]])
            box = np.array(a["bbox"]) + jit if rs.rand() < 0.6 else rs.uniform(1, 200, 4)
            preds.append({"image_id": img_id, "category_id": int(rs.randint(1, 5))
                          if rs.rand() < 0.3 else a["category_id"],
                          "bbox": [float(v) for v in np.abs(box)], "score": float(rs.rand())})
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": i, "name": str(i)} for i in range(1, 5)]}
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "pred.json").write_text(json.dumps(preds))
    return tmp_path / "gt.json", tmp_path / "pred.json"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_coco_equals_jax(tmp_path, seed):
    gt, pred = _coco_jsons(tmp_path, seed)
    got, want = evaluate_coco(gt, pred), jevaluate_coco(gt, pred)
    assert set(got) == set(want) == {"AP", "AP50", "AP75", "APs", "APm", "APl"}
    assert 0 < want["AP"] < 1 and 0 < want["AP50"] < 1, want
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


# -- save_json ----------------------------------------------------------------------
def _jpeg_coco_dataset(root: Path) -> Path:
    """The port's synthetic dataset with its val images as JPEG q92 under numeric
    stems, 80 class names, and a COCO GT json of the labels (category ids 80 -> 91)."""
    yaml_path = generate_dataset(root / "coco_jpeg", n_train=0, n_val=4, imgsz=S, nc=3,
                                 min_objs=1, max_objs=3, seed=0)
    ds = yaml_path.parent
    cmap = converter.coco80_to_coco91_class()
    images, anns = [], []
    for k, png in enumerate(sorted((ds / "images" / "val").glob("*.png")), start=1):
        img = load_image_rgb(png)
        save_jpeg(ds / "images" / "val" / f"{k}.jpg", img, quality=92)
        png.unlink()
        lab = ds / "labels" / "val" / f"{png.stem}.txt"
        lines = lab.read_text().split()
        lab.rename(lab.with_name(f"{k}.txt"))
        images.append({"id": k, "width": S, "height": S, "file_name": f"{k}.jpg"})
        for c, cx, cy, w, h in np.asarray(lines, np.float64).reshape(-1, 5):
            anns.append({"id": len(anns) + 1, "image_id": k, "category_id": cmap[int(c)],
                         "bbox": [(cx - w / 2) * S, (cy - h / 2) * S, w * S, h * S],
                         "area": w * h * S * S, "iscrowd": 0})
    (ds / "gt.json").write_text(json.dumps({"images": images, "annotations": anns}))
    names = "\n".join(f"  {i}: c{i}" for i in range(80))
    yaml_path.write_text(f"path: {ds}\ntrain: images/val\nval: images/val\n"
                         f"annotations: {ds / 'gt.json'}\nnames:\n{names}\n")
    return yaml_path


def _model(nc: int, seed: int = 0, live: int = 3) -> DetectionModel:
    """Gates open, BatchNorm moved off identity; the first `live` classes' logits
    near 0 (scores pass the gate), the rest at -10 (under conf 0.001), so that no
    image reaches max_det and no cut falls among near-equal scores."""
    m = DetectionModel("edgeline-yolo.yaml", device="cpu", seed=seed, nc=nc)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, WaveletEnhancer):
                mod.gamma.fill_(0.5)
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.add_(torch.randn(mod.weight.shape, generator=g) * 0.1)
                mod.bias.add_(torch.randn(mod.bias.shape, generator=g) * 0.1)
        for seq in m.model[-1].cv3:
            seq[-1].bias.fill_(-10.0)
            seq[-1].bias[:live] = 0.0
    return m.eval()


def _jax_model(model: DetectionModel, nc: int):
    d = dict(jtasks.yaml_model_load("edgeline-yolo.yaml"))
    d["nc"] = nc
    jm = jtasks.DetectionModel(d)
    shapes = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables, _ = convert_state_dict(sd, template, strict=True)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    return jm


def test_save_json_predictions_equal_jax(tmp_path):
    data = _jpeg_coco_dataset(tmp_path)
    model = _model(nc=80)
    kw = {"mode": "val", "data": str(data), "imgsz": S, "batch": 4, "conf": 0.001, "iou": 0.7,
          "max_det": 300, "plots": False, "save_json": True}
    jv = JValidator(jget_cfg(overrides=kw), save_dir=tmp_path / "jax")
    jv(_jax_model(model, 80))
    pv = DetectionValidator(get_cfg(overrides={**kw, "device": "cpu"}), save_dir=tmp_path / "port")
    pv(model)
    want = json.loads((tmp_path / "jax" / "predictions.json").read_text())
    got = json.loads((tmp_path / "port" / "predictions.json").read_text())
    print(f"{len(got)} rows; COCO port {pv.metrics.speed}")
    assert len(got) == len(want) > 100
    assert max(sum(r["image_id"] == i for r in got) for i in (1, 2, 3, 4)) < 300
    assert {r["image_id"] for r in got} == {1, 2, 3, 4}
    assert {r["category_id"] for r in got} <= set(converter.coco80_to_coco91_class())
    # the same multiset of rows: each port row matched once to a JAX row of the same
    # image and category, box within 1e-2 px and score within 1e-4
    free = {}
    for j, r in enumerate(want):
        free.setdefault((r["image_id"], r["category_id"]), []).append(j)
    for r in got:
        cands = free.get((r["image_id"], r["category_id"]), [])
        hit = next((j for j in cands if abs(want[j]["score"] - r["score"]) <= 1e-4
                    and np.abs(np.subtract(want[j]["bbox"], r["bbox"])).max() <= 1e-2), None)
        assert hit is not None, r
        cands.remove(hit)
    for k in ("AP", "AP50", "AP75", "APs", "APm", "APl"):
        assert abs(pv.metrics.speed[f"coco/{k}"] - jv.metrics.speed[f"coco/{k}"]) <= 1e-6, k


def test_coco_class_maps_equal_jax():
    assert converter.coco80_to_coco91_class() == jconverter.coco80_to_coco91_class()
    assert converter.coco91_to_coco80_class() == jconverter.coco91_to_coco80_class()


# -- converters ---------------------------------------------------------------------
def _instances_json(path: Path) -> Path:
    rs = np.random.RandomState(3)
    images = [{"id": i, "width": 320 + 16 * i, "height": 240, "file_name": f"img{i}.jpg"}
              for i in range(5)]
    anns = []
    for k in range(40):
        im = images[rs.randint(5)]
        x, y = rs.uniform(0, 100, 2)
        w, h = rs.uniform(5, 150, 2)
        poly = [float(v) for p in zip(rs.uniform(x, x + w, 6), rs.uniform(y, y + h, 6)) for v in p]
        anns.append({"id": k, "image_id": im["id"], "category_id": int(rs.choice([1, 12, 13, 45, 90, 91])),
                     "bbox": [x, y, w, h], "segmentation": [poly] if k % 3 else [],
                     "iscrowd": int(k % 11 == 0)})
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    return path


def _same_tree(a: Path, b: Path):
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa
    for f in fa:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("use_segments", [False, True])
def test_convert_coco_writes_jax_bytes(tmp_path, use_segments):
    src = _instances_json(tmp_path / "instances.json")
    converter.convert_coco(src, tmp_path / "port", use_segments=use_segments)
    jconverter.convert_coco(src, tmp_path / "jax", use_segments=use_segments)
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_convert_voc_writes_jax_bytes(tmp_path):
    names = ["cat", "dog", "person"]
    (tmp_path / "xml").mkdir()
    rs = np.random.RandomState(4)
    for i in range(4):
        objs = "".join(
            f"<object><name>{rs.choice(names + ['car'])}</name><bndbox><xmin>{rs.randint(0, 100)}"
            f"</xmin><ymin>{rs.randint(0, 80)}</ymin><xmax>{rs.randint(120, 300)}</xmax>"
            f"<ymax>{rs.randint(90, 200)}</ymax></bndbox></object>" for _ in range(3))
        (tmp_path / "xml" / f"{i:06d}.xml").write_text(
            f"<annotation><size><width>{300 + i}</width><height>200</height></size>{objs}"
            "</annotation>")
    converter.convert_voc(tmp_path / "xml", tmp_path / "port", names)
    jconverter.convert_voc(tmp_path / "xml", tmp_path / "jax", names)
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_split_train_val_moves_the_jax_files(tmp_path):
    for side in ("port", "jax"):
        (tmp_path / side / "images").mkdir(parents=True)
        (tmp_path / side / "labels").mkdir()
        for i in range(11):
            (tmp_path / side / "images" / f"{i}.jpg").write_bytes(b"x")
            if i % 4:
                (tmp_path / side / "labels" / f"{i}.txt").write_text(f"{i}\n")
    converter.split_train_val(tmp_path / "port", val_fraction=0.3, seed=5)
    jconverter.split_train_val(tmp_path / "jax", val_fraction=0.3, seed=5)
    _same_tree(tmp_path / "port", tmp_path / "jax")


# -- save_crop ----------------------------------------------------------------------
def test_save_crop_names_and_pixels_equal_jax(tmp_path):
    rs = np.random.RandomState(6)
    img = rs.randint(0, 256, (120, 170, 3)).astype(np.uint8)
    boxes = np.array([[10, 20, 60, 90, 0.9, 0], [100.4, 5.6, 169, 119, 0.8, 1],
                      [0, 0, 3, 3, 0.5, 0], [50, 50, 50.5, 80, 0.4, 2]], np.float32)
    names = {0: "a", 1: "b", 2: "c"}
    Results(img, "x.jpg", names, boxes=boxes).save_crop(tmp_path / "port", "shot.jpg")
    JResults(img, "x.jpg", names, boxes=boxes).save_crop(tmp_path / "jax", "shot.jpg")
    port = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.jpg"))
    jax_ = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.jpg"))
    assert port == jax_ and len(port) == 4
    for f in port:
        np.testing.assert_array_equal(load_image_rgb(tmp_path / "port" / f),
                                      np.asarray(Image.open(tmp_path / "jax" / f).convert("RGB")))
