#!/usr/bin/env python3
"""Where an epoch of chip_smoke.py's classify fit spends its time, on one card.

    python3 tools/profile_classify.py

On the fit protocol's data (chip_smoke.CLS_FIT_DATA) and model (yolo11n-cls,
batch 16 x 128 px, bf16): the train loader's epoch with and without the RAM
cache, `classify_augment_batch`, `train_step` and forward with backward
(median, min and max ms of 20, deterministic algorithms off and on), the
validation of the 64 val images with and without the cache, then
chip_smoke.py's classify fit with and without the cache (the same fit:
deterministic, the same bytes).
"""
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch
import chip_smoke as cs
from edgeyolo_tpu_torch.ops import _build, linear_attention as la
from edgeyolo_tpu_torch.data.synthetic import generate_classify_dataset
from edgeyolo_tpu_torch.data.classify import ClassificationDataset, ClassifyLoader, check_cls_dataset
from edgeyolo_tpu_torch.data.augment_device import classify_augment_batch
from edgeyolo_tpu_torch.nn.tasks import ClassificationModel
from edgeyolo_tpu_torch.train.classify import ClassificationTrainer, classify_forward
from edgeyolo_tpu_torch.train.trainer import batch_to_device, deterministic_algorithms
from edgeyolo_tpu_torch.engine.classify import ClassificationValidator
from edgeyolo_tpu_torch.cfg import get_cfg
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
print(card, flush=True)
_build.build()
def med(fn, n=20):
    ts = []
    for _ in range(n):
        torch.cuda.synchronize(); t0 = time.perf_counter(); fn(); torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts), max(ts)
with tempfile.TemporaryDirectory() as w:
    root = generate_classify_dataset(Path(w) / "d", **cs.CLS_FIT_DATA)
    cfg = check_cls_dataset(root)
    for cache in (False, True):
        ds = ClassificationDataset(cfg["train"], 128, names=cfg["names"], cache=cache)
        ld = ClassifyLoader(ds, 16, shuffle=True, seed=0, drop_last=True)
        ts = []
        for ep in range(3):
            t0 = time.perf_counter(); n = sum(1 for _ in ld); ts.append((time.perf_counter() - t0) * 1e3)
        print(f"loader epoch (8 batches of 16 x 128 px), cache {cache}: {[round(t, 1) for t in ts]} ms", flush=True)
    model = ClassificationModel(cs.CLS, nc=8, device="cuda")
    tr = ClassificationTrainer(model, {**cs.CLS_FIT_TRAIN, "amp": True}, device="cuda")
    tr.setup(nb=8)
    batch = batch_to_device(ld.first_batch(), torch.device("cuda"))
    a = tr.args
    for det in (False, True):
        with deterministic_algorithms(det):
            print(f"deterministic {det}: augment {med(lambda: classify_augment_batch(batch['img'], tr.gen, a))} ms; "
                  f"train_step {med(lambda: tr.train_step(batch))} ms", flush=True)
            x = classify_augment_batch(batch['img'], tr.gen, a).permute(0, 3, 1, 2).contiguous()
            def fb():
                loss = torch.nn.functional.cross_entropy(classify_forward(model, x, True), batch["cls"].long())
                loss.backward()
            print(f"deterministic {det}: forward+backward {med(fb)} ms", flush=True)
    for cache in (False, True):
        v = ClassificationValidator(get_cfg(overrides={"mode": "val", "imgsz": 128, "task": "classify", "cache": cache}), device="cuda")
        ts = []
        for _ in range(3):
            t0 = time.perf_counter(); v(model, data=cfg, batch_size=16); ts.append((time.perf_counter() - t0) * 1e3)
        print(f"validation (64 images), cache {cache}: {[round(t, 1) for t in ts]} ms", flush=True)
    for cache in (False, True):
        cs.CLS_FIT_TRAIN = {**cs.CLS_FIT_TRAIN, "cache": cache}
        t0 = time.perf_counter()
        cs.fit_classify(la, card, Path(w) / f"fit_{cache}")
        print(f"fit_classify cache {cache}: {time.perf_counter() - t0:.1f} s", flush=True)
