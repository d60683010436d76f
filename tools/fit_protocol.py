#!/usr/bin/env python
"""The JAX package's trainer on chip_smoke.py's `fit` protocol, for the mAP
the PyTorch port's `fit` phase is held against.

    JAX_PLATFORMS=cpu python tools/fit_protocol.py [--coco] OUT_DIR [JSON_OVERRIDES]

Writes the port's synthetic dataset (16 train / 8 val PNG images, 160 px,
3 classes, seed 0: edgeyolo_tpu_torch/data/synthetic.py, which the JAX
dataset reads through PIL), trains EdgeLine-YOLO-n with the JAX facade for
150 epochs at batch 16, imgsz 160, SGD lr0 0.01, validating every epoch,
with the overrides given as JSON (e.g. '{"nbs": 16, "warmup_epochs": 0}';
"model" names another model YAML, e.g. '{"model": "yolov13-test.yaml",
"imgsz": 192}'), and prints the best mAP50-95 and every 15th row of
results.csv. About 7 minutes on a CPU for EdgeLine-YOLO-n; '{"model":
"yolov8-rtdetr.yaml", "nbs": 16, "warmup_epochs": 0.0, "seed": 0}' about 20
(RT-DETR's rows log its L1, class and GIoU losses as box, cls and dfl).

'{"task": "segment"}' writes the segment form of the same dataset (each
shape's box-corner polygon) and trains yolo11n-seg unless "model" names
another segment YAML; it then also prints the box and mask mAP50-95 of the
best epoch (the row of highest fitness), the figures chip_smoke.py's segment
`fit` is held against (less 0.1).

'{"task": "pose"}' and '{"task": "obb"}' do the same for the pose form
(5 keypoints per shape, kpt_shape [5, 3] in the dataset YAML) with
yolo11n-pose, printing the best epoch's box and pose mAP50-95, and for the
obb form (rotated shapes) with yolo11n-obb, printing its probiou mAP50-95:
the figures of chip_smoke.py's pose and obb fits (less 0.1), e.g.

    JAX_PLATFORMS=cpu python tools/fit_protocol.py OUT '{"task": "pose", "epochs": 100,
        "nbs": 16, "warmup_epochs": 0.0, "seed": 0}'

'{"task": "classify"}' writes the folder-per-class grating set of
chip_smoke.py's CLS_FIT_DATA (8 classes, 16 train and 8 val images each,
sides 60-140 px, JPEG q92, seed 0: generate_classify_dataset) and trains yolo11n-cls at 128 px, printing the
best epoch's top-1 and top-5: the figures chip_smoke.py's classify fit is
held against (top-1 less 0.1), e.g.

    JAX_PLATFORMS=cpu python tools/fit_protocol.py OUT '{"task": "classify", "epochs": 60,
        "nbs": 16, "warmup_epochs": 0.0, "seed": 0}'

With --coco, the trained model is then validated by the JAX validator with
save_json on the val images re-encoded as JPEG q92 (chip_smoke.py's
`jpeg_coco_copy`, which writes a COCO GT json of the labels): it prints the
validator's mAP50-95 beside COCO AP50-95 of the same call and their gap, the
gap chip_smoke.py's `jpeg` phase allows the port (plus 0.02).
"""

import csv
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main():
    argv = sys.argv[1:]
    coco = argv[:1] == ["--coco"]
    argv = argv[1:] if coco else argv
    out = Path(argv[0]).resolve()
    overrides = json.loads(argv[1]) if len(argv) > 1 else {}
    from edgeyolo_tpu import YOLO
    from edgeyolo_tpu_torch.data.synthetic import generate_classify_dataset, generate_dataset

    task = overrides.pop("task", "detect")
    if task == "classify":
        from chip_smoke import CLS_FIT_DATA

        data = generate_classify_dataset(out / "data", **CLS_FIT_DATA)
    else:
        data = generate_dataset(out / "data", n_train=16, n_val=8, imgsz=160, nc=3, seed=0,
                                task=task)
    args = {"epochs": 150, "batch": 16, "imgsz": 128 if task == "classify" else 160,
            "optimizer": "SGD", "lr0": 0.01, "val": True, "plots": False, **overrides}
    model = args.pop("model", {"segment": "yolo11n-seg.yaml", "pose": "yolo11n-pose.yaml",
                               "obb": "yolo11n-obb.yaml", "classify": "yolo11n-cls.yaml"}.get(
                                   task, "edgeline-yolo.yaml"))
    t0 = time.time()
    yolo = YOLO(model)
    best = yolo.train(data=str(data), project=str(out), name="train", exist_ok=True, **args)
    with open(out / "train" / "results.csv") as f:
        rows = list(csv.DictReader(f))
    if task == "classify":
        top = max(rows, key=lambda r: float(r["fitness"]))
        for r in rows[9::10]:
            print(" ".join(f"{k} {r[k]}" for k in ("epoch", "train/loss", "metrics/accuracy_top1",
                                                  "metrics/accuracy_top5", "lr/pg0")))
        print(json.dumps({"task": task, "model": model, "overrides": overrides,
                          "best_epoch": int(top["epoch"]),
                          "top1": float(top["metrics/accuracy_top1"]),
                          "top5": float(top["metrics/accuracy_top5"]),
                          "seconds": round(time.time() - t0, 1)}))
        return
    for r in rows[14::15]:
        print(" ".join(f"{k} {r[k]}" for k in ("epoch", "train/box_loss", "train/cls_loss",
                                              "metrics/mAP50(B)", "metrics/mAP50-95(B)", "lr/pg0")))
    print(json.dumps({"overrides": overrides, "best_mAP50-95": best,
                      "seconds": round(time.time() - t0, 1)}))
    if task != "detect":
        top = max(rows, key=lambda r: float(r.get("fitness") or r["metrics/mAP50-95(B)"]))
        extra = {"segment": ("mask_mAP50-95", "metrics/mAP50-95(M)"),
                 "pose": ("pose_mAP50-95", "metrics/mAP50-95(P)")}.get(task)
        line = {"task": task, "model": model, "best_epoch": int(top["epoch"]),
                ("probiou_mAP50-95" if task == "obb" else "box_mAP50-95"):
                    float(top["metrics/mAP50-95(B)"])}
        if extra:
            line[extra[0]] = float(top[extra[1]])
        print(json.dumps(line))
    if coco:
        import chip_smoke
        from edgeyolo_tpu.cfg import get_cfg
        from edgeyolo_tpu.engine.validator import DetectionValidator

        jpeg = chip_smoke.jpeg_coco_copy(data, out / "jpeg")
        v = DetectionValidator(get_cfg(overrides={
            "mode": "val", "data": str(jpeg), "imgsz": args["imgsz"], "batch": args["batch"],
            "save_json": True, "plots": False}), save_dir=out / "val_jpeg")
        m = v(yolo.model)
        ap = v.metrics.speed["coco/AP"]
        print(json.dumps({"jpeg_val_mAP50-95": m["metrics/mAP50-95(B)"], "coco_AP50-95": ap,
                          "gap": abs(ap - m["metrics/mAP50-95(B)"]),
                          "coco": {k: v for k, v in v.metrics.speed.items() if "coco" in k}}))


if __name__ == "__main__":
    main()
