"""Classification training (edgeyolo_tpu/train/classify.py): softmax
cross-entropy over a folder-per-class dataset, on one device.

ClassificationTrainer is the DetectionTrainer with the classify pieces: the
dataset (data/classify.py; the dataset's class count must be the model's;
the short tail batch is dropped when the split holds at least one batch),
the step (uint8 batch -> `classify_augment_batch` -> forward in train mode,
with `amp` on the parameters rounded to bf16 under bf16 autocast ->
`ClassificationLoss` in f32 -> backward -> accumulate -> update -> EMA),
and the validation (the EMA weights and the current BatchNorm statistics
through ClassificationValidator: top-1, top-5 and their mean as fitness).
The rest is the detection trainer's, as JAX shares it: auto_optimizer,
accumulate = max(round(nbs / batch), 1), decay scaled by batch x
accumulate / nbs, the linear or cosine schedule with its warmup and the
warmup momentum, the EMA on update steps only (BatchNorm statistics are not
averaged), results.csv (`train/loss`), best and last checkpoints with their
JSON metadata, resume, early stopping and the callback events.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

import torch
from torch import nn

from edgeyolo_tpu_torch.data.augment_device import classify_augment_batch
from edgeyolo_tpu_torch.data.classify import (ClassificationDataset, ClassifyLoader,
                                              check_cls_dataset)
from edgeyolo_tpu_torch.nn.tasks import amp_params
from edgeyolo_tpu_torch.train.loss import ClassificationLoss
from edgeyolo_tpu_torch.train.trainer import DetectionTrainer, batch_to_device


def classify_forward(model: nn.Module, x: torch.Tensor, amp: bool) -> torch.Tensor:
    """Train-mode logits (B, nc) in f32; with `amp` the forward sees the
    parameters rounded to bf16 (gradients flow to the f32 masters) under
    bf16 autocast."""
    if not amp:
        return model(x).float()
    with torch.autocast(x.device.type, dtype=torch.bfloat16):
        return torch.func.functional_call(model, amp_params(model),
                                          (x.to(torch.bfloat16),)).float()


class ClassificationTrainer(DetectionTrainer):
    """Trains a classify model (a Classify head) on one device."""

    LOSS_ITEMS = ("cls",)

    def build_criterion(self, loss_cls):
        return ClassificationLoss()

    def freeze_mask(self):
        return None  # JAX's classify trainer takes no `freeze`

    def train_step(self, batch: dict, mosaic: bool = True):
        """One micro-step on a device batch {"img" uint8 (B, S, S, 3), "cls"
        (B,), "img_weight" (B,)}. Returns (loss, {"cls"}, whether the
        parameters were updated)."""
        img01 = classify_augment_batch(batch["img"], self.gen, self.args)
        logits = classify_forward(self.model, img01.permute(0, 3, 1, 2).contiguous(),
                                  bool(self.args["amp"]))
        loss, items = self.criterion(logits, batch)
        self.flat.grad.zero_()
        loss.backward()
        updated = self.optimizer.step(self.flat.data, self.flat.grad)
        if updated:
            self.ema.update(self.flat.data)
        return loss.detach(), items, updated

    def _epoch(self, batches: Iterable[dict], epoch: int) -> list[float]:
        self.epoch = epoch
        items = [self.train_step(batch_to_device(b, self.device))[1] for b in batches]
        self.epoch_losses.append([torch.stack([it["cls"] for it in items]).mean().item()])
        return self.epoch_losses[-1]

    def _train_data(self):
        a = self.args
        data_cfg = check_cls_dataset(a["data"])
        if data_cfg["nc"] != self.model.nc:
            raise ValueError(f"dataset nc={data_cfg['nc']} != model nc={self.model.nc}")
        bs = int(a["batch"])
        train_set = ClassificationDataset(data_cfg["train"], imgsz=int(a["imgsz"]), augment=True,
                                          fraction=float(a.get("fraction", 1.0)),
                                          names=data_cfg["names"], cache=a.get("cache", False))
        # the tail batch is dropped (torch's drop_last) for a split of at least one batch:
        # padded, its fillers would train at full weight
        return data_cfg, ClassifyLoader(train_set, bs, shuffle=True, seed=int(a["seed"]),
                                        drop_last=len(train_set) >= bs)

    def _loss_row(self, mloss: list[float]) -> dict:
        return {"train/loss": round(float(mloss[0]), 5)}

    def _validate(self, data_cfg: dict) -> dict:
        """The val split through the EMA weights and the current BatchNorm
        statistics; the trained weights are put back after."""
        from edgeyolo_tpu_torch.cfg import get_cfg
        from edgeyolo_tpu_torch.engine.classify import ClassificationValidator

        if self.validator is None:
            a = self.args
            vargs = get_cfg(overrides={"mode": "val", "data": a["data"], "imgsz": int(a["imgsz"]),
                                       "batch": int(a["batch"]), "task": "classify",
                                       "cache": a.get("cache", False)})
            self.validator = ClassificationValidator(vargs, save_dir=Path(self.save_dir) / "val",
                                                     device=self.device)
        raw = self.flat.data.clone()
        try:
            with torch.no_grad():
                self.flat.data.copy_(self.ema.ema)
            return self.validator(self.model, data=data_cfg, batch_size=int(self.args["batch"]))
        finally:
            with torch.no_grad():
                self.flat.data.copy_(raw)
