#!/usr/bin/env python
"""The JAX package's trainer on chip_smoke.py's `fit` protocol, for the mAP
the PyTorch port's `fit` phase is held against.

    JAX_PLATFORMS=cpu python tools/fit_protocol.py OUT_DIR [JSON_OVERRIDES]

Writes the port's synthetic dataset (16 train / 8 val PNG images, 160 px,
3 classes, seed 0: edgeyolo_tpu_torch/data/synthetic.py, which the JAX
dataset reads through PIL), trains EdgeLine-YOLO-n with the JAX facade for
150 epochs at batch 16, imgsz 160, SGD lr0 0.01, validating every epoch,
with the overrides given as JSON (e.g. '{"nbs": 16, "warmup_epochs": 0}';
"model" names another model YAML, e.g. '{"model": "yolov13-test.yaml",
"imgsz": 192}'), and prints the best mAP50-95 and every 15th row of
results.csv. About 7 minutes on a CPU for EdgeLine-YOLO-n.
"""

import csv
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main():
    out = Path(sys.argv[1]).resolve()
    overrides = json.loads(sys.argv[2]) if len(sys.argv) > 2 else {}
    from edgeyolo_tpu import YOLO
    from edgeyolo_tpu_torch.data.synthetic import generate_dataset

    data = generate_dataset(out / "data", n_train=16, n_val=8, imgsz=160, nc=3, seed=0)
    args = {"epochs": 150, "batch": 16, "imgsz": 160, "optimizer": "SGD", "lr0": 0.01,
            "val": True, "plots": False, **overrides}
    model = args.pop("model", "edgeline-yolo.yaml")
    t0 = time.time()
    best = YOLO(model).train(data=str(data), project=str(out), name="train", exist_ok=True,
                             **args)
    with open(out / "train" / "results.csv") as f:
        rows = list(csv.DictReader(f))
    for r in rows[14::15]:
        print(" ".join(f"{k} {r[k]}" for k in ("epoch", "train/box_loss", "train/cls_loss",
                                              "metrics/mAP50(B)", "metrics/mAP50-95(B)", "lr/pg0")))
    print(json.dumps({"overrides": overrides, "best_mAP50-95": best,
                      "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
