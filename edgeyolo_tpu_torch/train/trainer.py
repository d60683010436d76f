"""Detection, segment, pose and obb training (edgeyolo_tpu/train/trainer.py): the optimizer chain,
gradient accumulation, the warmup and LR schedule, EMA, early stopping and
the step and epoch loop, on one device.

As in the JAX trainer, the trainable parameters live in one flat f32 vector:
each parameter of the model is a view of it, and so is each `.grad`, so
autograd accumulates straight into one flat gradient and the optimizer and
EMA are a few whole-vector ops per update. The chain is optax's:

    clip_by_global_norm(10) -> weight decay on conv kernels only (`_decay_mask`)
    -> nesterov SGD | Adam (coupled decay) | AdamW (decoupled) | RMSProp

with the momentum warmup on SGD and RMSProp only. `MultiSteps` averages the
k = round(nbs / batch) micro-step gradients before the clip, as
optax.MultiSteps does (the reference sums them), and the schedule counts
real updates. The EMA, decay 0.9999 (1 - exp(-t / 2000)), advances on
completed updates only.

The step: uint8 batch -> `augment_batch` -> forward in train mode (with
`amp`, on the parameters rounded to bf16 under bf16 autocast, as JAX's
`amp_cast`) -> `DetectionLoss` in f32 (`E2EDetectLoss` on the whole output
dict when the model's head is end to end, `SegmentationLoss` for a segment
model, whose instance masks ride `augment_batch` with the images,
`PoseLoss` for a pose model, with its keypoints, and `OBBLoss` for an obb
model, whose rotated boxes, warped, are the criterion's boxes; for an RT-DETR
model the contrastive-denoising queries are built from the augmented targets
(`make_cdn_group`, drawn from the trainer's generator), handed to the head,
and `RTDETRDetectionLoss` takes the whole output dict; its L1, class and
GIoU items are the epoch's box, cls and dfl columns, as in JAX's log) ->
backward -> accumulate ->
update -> EMA. `DetectionTrainer.train(batches)` runs epochs over a re-iterable of
batches in the loader's collate format. `DetectionTrainer.fit()` is JAX's
dataset-driven `DetectionTrainer.train`: the dataset YAML, a shuffled
augmenting loader, `close_mosaic`, validation each epoch with the EMA
weights and the current BatchNorm statistics, results.csv, the `best`,
`last` and `epoch{n}` checkpoints, early stopping on fitness, the `time`
budget and `resume`; it fires the callback events (utils/callbacks.py) where
JAX's trainer does. An epoch that improves the fitness builds its checkpoint
once and writes the same bytes to `best.pt` and `last.pt`. Checkpoints are
`torch.save` files that load with
`weights_only=True`: the state_dicts (reference keys, so
edgeyolo_tpu/utils/torch_convert.py::convert_state_dict maps them onto the
flax tree) of the trained and the EMA weights, the optimizer's flat
buffers, the MultiSteps state (its accumulator only between updates: it is
zero at mini-step 0), the augmentation generator, the update
count, the epoch and the best fitness, with a JSON sidecar of metadata.

`batch` <= 0 sizes the batch by AutoBatch at 60% of the card's memory, and
0 < `batch` < 1 at that fraction (utils/profiling.py::autobatch, the train
probe), as JAX's trainer does. `freeze` (an int N: layers 0 to N-1; a list:
those layer indices) holds the parameters of `model.{i}.*`: their gradient
and their update are multiplied by 0 in the flat vectors, so neither the
clip, the momentum step nor the weight decay moves them, and their EMA stays
equal to them; their BatchNorm statistics still update in train mode, as
JAX's `mutable=["batch_stats"]` does. Multi-host training is not ported yet.
"""

from __future__ import annotations

import contextlib
import csv
import json
import math
import os
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Iterable

import torch
from torch import nn

from edgeyolo_tpu_torch.data.augment_device import augment_batch
from edgeyolo_tpu_torch.data.dataset import (DataLoader, YOLODataset, build_dataloader,
                                             check_det_dataset)
from edgeyolo_tpu_torch.nn.modules.transformer import MultiheadAttention
from edgeyolo_tpu_torch.nn.tasks import is_rtdetr, train_forward
from edgeyolo_tpu_torch.train.detr_loss import RTDETRDetectionLoss, make_cdn_group
from edgeyolo_tpu_torch.train.loss import (DetectionLoss, E2EDetectLoss, OBBLoss, PoseLoss,
                                           SegmentationLoss)
from edgeyolo_tpu_torch.utils import LOGGER, select_device
from edgeyolo_tpu_torch.utils.callbacks import CallbackMixin
from edgeyolo_tpu_torch.utils.yamlfile import yaml_save

# the training keys of the JAX package's cfg/default.yaml
TRAIN_DEFAULTS = {
    "epochs": 100, "batch": 16, "optimizer": "auto", "seed": 0,
    "cos_lr": False, "close_mosaic": 10, "amp": True, "patience": 100, "nbs": 64,
    "lr0": 0.01, "lrf": 0.01, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "box": 7.5, "cls": 0.5, "dfl": 1.5,
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0, "translate": 0.1,
    "scale": 0.5, "shear": 0.0, "perspective": 0.0, "flipud": 0.0, "fliplr": 0.5,
    "bgr": 0.0, "photometric": 1.0, "mosaic": 1.0, "mixup": 0.0, "copy_paste": 0.0,
    "copy_paste_mode": "flip", "mask_ratio": 4, "overlap_mask": True, "deterministic": True,
    "auto_augment": "randaugment", "erasing": 0.4,
}
CLIP_NORM = 10.0


@contextlib.contextmanager
def deterministic_algorithms(on: bool):
    """While on, PyTorch's and cuDNN's deterministic algorithms only, so that a
    fit on the card repeats to the bit from its seed, as JAX's does on the
    TPU (the default atomics and cuDNN's fastest kernels make two fits differ
    in mAP50-95 by a few hundredths); the process's settings come back on
    exit. An op with no deterministic form warns and runs."""
    if not on:
        yield
        return
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(), torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.deterministic = was[2]


def _decay_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name -> whether it takes weight decay: conv (transposed too)
    and linear kernels only, an attention's packed q, k, v kernel among them
    (BatchNorm and LayerNorm scales and shifts, biases, gates, the wavelet
    and MSLA weights, the hyperedge prototypes and RT-DETR's denoising
    embedding take none)."""
    kernels = {name for name, m in model.named_modules()
               if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear))}
    packed = {f"{name}.in_proj_weight" for name, m in model.named_modules()
              if isinstance(m, MultiheadAttention)}
    return {name: (name.rpartition(".")[0] in kernels and name.endswith(".weight"))
            or name in packed for name, p in model.named_parameters() if p.requires_grad}


class FlatParams:
    """The model's trainable parameters as views of one flat f32 vector, and
    their gradients as views of a second one (f64 vectors for an f64 model,
    a reference step)."""

    def __init__(self, model: nn.Module):
        self.named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        total = sum(p.numel() for _, p in self.named)
        device, dtype = self.named[0][1].device, self.named[0][1].dtype
        self.data = torch.empty(total, dtype=dtype, device=device)
        self.grad = torch.zeros(total, dtype=dtype, device=device)
        self.slices: dict[str, slice] = {}
        off = 0
        for name, p in self.named:
            if p.dtype != dtype or dtype not in (torch.float32, torch.float64):
                raise TypeError(f"{name} is {p.dtype}; training keeps f32 parameters")
            n = p.numel()
            self.data[off:off + n].copy_(p.detach().flatten())
            p.data = self.data[off:off + n].view_as(p)
            p.grad = self.grad[off:off + n].view_as(p)
            self.slices[name] = slice(off, off + n)
            off += n

    def vector(self, mask: dict[str, bool]) -> torch.Tensor:
        """A 0/1 flat vector from a name -> bool map."""
        out = torch.zeros_like(self.data)
        for name, sl in self.slices.items():
            if mask[name]:
                out[sl] = 1.0
        return out

    def unflatten(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        return {name: flat[sl].view_as(p) for (name, p), sl in
                zip(self.named, self.slices.values())}


class FlatOptimizer:
    """JAX's build_optimizer chain on flat vectors; `update` moves p in place.

    lr_at(count) and momentum_at(count) give the hyperparameters of the
    count-th update (count from 0); momentum_at only for SGD and RMSProp.
    """

    def __init__(self, name: str, lr_at: Callable[[int], float], momentum: float,
                 decay: float, mask: torch.Tensor,
                 momentum_at: Callable[[int], float] | None = None,
                 keep: torch.Tensor | None = None):
        self.keep = keep  # 0 where `freeze` holds a parameter: its update is zeroed
        self.name = name.lower()
        if self.name not in ("sgd", "adam", "adamw", "rmsprop"):
            raise ValueError(f"unknown optimizer {name}")
        self.lr_at, self.momentum, self.decay, self.mask = lr_at, momentum, decay, mask
        self.momentum_at = momentum_at if self.name in ("sgd", "rmsprop") else None
        self.count = 0
        self.trace = torch.zeros_like(mask)  # SGD and RMSProp momentum
        self.mu = torch.zeros_like(mask) if self.name.startswith("adam") else None
        self.nu = torch.zeros_like(mask) if self.name != "sgd" else None

    def update(self, p: torch.Tensor, g: torch.Tensor) -> None:
        lr = self.lr_at(self.count)
        m = self.momentum_at(self.count) if self.momentum_at else self.momentum
        self.count += 1
        # accumulated in f64: an f32 sum of millions of squares on the CPU
        # drifts by 4e-4 relative at the flagship's 2.68M parameters
        norm = torch.linalg.vector_norm(g, dtype=torch.float64).to(g.dtype)
        g = torch.where(norm < CLIP_NORM, g, g / norm * CLIP_NORM)
        wd = self.decay * self.mask
        if self.name == "sgd":
            g = g + wd * p
            self.trace = g + m * self.trace
            u = g + m * self.trace  # nesterov
            p.add_(self._held(u * -lr))
        elif self.name in ("adam", "adamw"):
            if self.name == "adam":
                g = g + wd * p
            b1, b2 = self.momentum, 0.999
            self.mu = (1 - b1) * g + b1 * self.mu
            self.nu = (1 - b2) * g ** 2 + b2 * self.nu
            u = (self.mu / (1 - b1 ** self.count)) / (
                torch.sqrt(self.nu / (1 - b2 ** self.count)) + 1e-8)
            if self.name == "adamw":
                u = u + wd * p
            p.add_(self._held(u * -lr))
        else:  # rmsprop: scale by rms, then the learning rate, then momentum
            g = g + wd * p
            self.nu = (1 - 0.9) * g ** 2 + 0.9 * self.nu
            u = g * torch.rsqrt(self.nu + 1e-8) * -lr
            self.trace = u + m * self.trace
            p.add_(self._held(self.trace))

    def _held(self, update: torch.Tensor) -> torch.Tensor:
        return update if self.keep is None else update * self.keep


class MultiSteps:
    """optax.MultiSteps: average k micro-step gradients, update on the k-th."""

    def __init__(self, opt: FlatOptimizer, k: int):
        self.opt, self.k = opt, k
        self.acc = torch.zeros_like(opt.mask)
        self.mini_step = 0

    def step(self, p: torch.Tensor, g: torch.Tensor) -> bool:
        """Take one micro-step; True when it was a real update."""
        self.acc = self.acc + (g - self.acc) / (self.mini_step + 1)
        if self.mini_step < self.k - 1:
            self.mini_step += 1
            return False
        self.opt.update(p, self.acc)
        self.acc.zero_()
        self.mini_step = 0
        return True


class ModelEMA:
    """EMA of the flat parameters, decay 0.9999 (1 - exp(-updates / 2000))."""

    def __init__(self, p: torch.Tensor, keep: torch.Tensor | None = None):
        self.ema = p.clone()
        self.updates = 0
        self.held = None if keep is None else keep == 0  # frozen entries keep their value

    @staticmethod
    def decay(updates: int) -> float:
        return 0.9999 * (1 - math.exp(-updates / 2000.0))

    def update(self, p: torch.Tensor) -> None:
        self.updates += 1
        d = self.decay(self.updates)
        ema = self.ema * d + (1 - d) * p
        self.ema = ema if self.held is None else torch.where(self.held, self.ema, ema)


@dataclass(frozen=True)
class Schedule:
    """Per-update LR and momentum: linear (or cosine) decay over the epochs,
    with a warmup of max(round(warmup_epochs * nb), 100) micro-steps."""

    lr0: float
    lrf: float
    epochs: int
    nb: int
    accumulate: int
    warmup_steps: int
    cos_lr: bool = False
    momentum: float = 0.937
    warmup_momentum: float = 0.8

    def lr_at(self, step: int) -> float:
        e = step * self.accumulate / max(self.nb, 1)
        if self.cos_lr:
            lf = ((1 - math.cos(e / self.epochs * math.pi)) / 2) * (self.lrf - 1) + 1
        else:
            lf = max(1 - e / self.epochs, 0.0) * (1.0 - self.lrf) + self.lrf
        warm = (min(max((step * self.accumulate + 1) / max(self.warmup_steps, 1), 0.0), 1.0)
                if self.warmup_steps else 1.0)
        return self.lr0 * lf * warm

    def momentum_at(self, step: int) -> float:
        if not self.warmup_steps:
            return self.momentum
        t = min(max((step * self.accumulate + 1) / max(self.warmup_steps, 1), 0.0), 1.0)
        return self.warmup_momentum + (self.momentum - self.warmup_momentum) * t


def warmup_steps_for(warmup_epochs: float, epochs: int, nb: int) -> int:
    """The reference floors the warmup at 100 micro-steps; 0 disables it."""
    return 0 if (warmup_epochs <= 0 or epochs <= 1) else max(round(warmup_epochs * nb), 100)


def auto_optimizer(nc: int, lr0: float, momentum: float, iterations: float):
    """AdamW(lr = 0.002 * 5 / (4 + nc), 0.9) for short runs, else SGD(lr0, momentum)."""
    if iterations > 10000:
        return "SGD", lr0, momentum
    return "AdamW", round(0.002 * 5 / (4 + nc), 6), 0.9


class EarlyStopping:
    """Stop when fitness has not improved for `patience` epochs (ties count as improvement)."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float | None) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_epoch, self.best_fitness = epoch, fitness
        return (epoch - self.best_epoch) >= self.patience


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A collated batch (numpy or torch) on `device`, with its per-image
    weight: 1 for the n_real real images, 0 for the padded repeats."""
    out = {}
    for k in ("img", "cls", "bboxes", "mask_gt", "masks", "keypoints", "rboxes"):
        if k not in batch:
            continue
        v = torch.as_tensor(batch[k])
        out[k] = v.to(device, non_blocking=True) if k == "img" else v.float().to(device)
    b = out["img"].shape[0]
    n_real = int(batch.get("n_real", b))
    out["img_weight"] = (torch.arange(b, device=device) < n_real).float()
    return out


class DetectionTrainer(CallbackMixin):
    """Trains a DetectionModel on one device; `hyp` (a dict or a get_cfg
    namespace) overrides TRAIN_DEFAULTS; `callbacks` is an event -> hooks
    table (the facade's), else an empty one.

    `setup(nb)` builds the optimizer for nb batches per epoch; `train_step`
    takes one micro-step; `train(batches)` runs the epochs over given batches
    and `fit()` over hyp["data"]. The model must hold f32 parameters; with
    hyp["amp"] its forward sees them rounded to bf16 (`train_forward`).
    """

    LOSS_ITEMS = ("box", "cls", "dfl")  # the loss items an epoch averages, results.csv's

    def __init__(self, model: nn.Module, hyp: dict | SimpleNamespace | None = None,
                 device: str | torch.device | None = None, save_dir: str | Path = "runs/train",
                 callbacks: dict | None = None):
        hyp = vars(hyp) if isinstance(hyp, SimpleNamespace) else (hyp or {})
        self.init_callbacks(callbacks)
        self.args = {**TRAIN_DEFAULTS, **hyp}
        self.device = select_device(device)
        self.save_dir = Path(save_dir)
        self.best_fitness = 0.0
        self.best_metrics: dict = {}
        self.last_metrics: dict = {}
        self.validator = None
        self.model = model.to(self.device).train()
        self.end2end = bool(getattr(model, "end2end", False))
        self.task = getattr(model, "task", "detect")
        self.rtdetr = is_rtdetr(model)
        # criteria called with the whole output dict
        self.dict_loss = self.end2end or self.rtdetr or self.task in ("segment", "pose", "obb")
        loss_cls = {"segment": SegmentationLoss, "pose": PoseLoss, "obb": OBBLoss}.get(
            self.task, RTDETRDetectionLoss if self.rtdetr else
            E2EDetectLoss if self.end2end else DetectionLoss)

        self.criterion = self.build_criterion(loss_cls)
        self.gen = torch.Generator().manual_seed(int(self.args["seed"]))
        self.epoch_losses: list[list[float]] = []
        self.epoch = 0

    def build_criterion(self, loss_cls):
        return loss_cls.for_model(self.model, self.args)

    def resolve_batch(self) -> int:
        """args["batch"] as a batch size: AutoBatch for batch <= 0 (at 60% of
        the card's memory) or 0 < batch < 1 (at that fraction); its measured
        peak bytes by candidate go to `autobatch_peaks`."""
        a = self.args
        bs = float(a["batch"])
        if bs < 1:
            from edgeyolo_tpu_torch.utils import profiling

            self.autobatch_peaks: dict[int, int] = {}
            a["batch"] = profiling.autobatch(self.model, imgsz=int(a.get("imgsz", 640)),
                                             fraction=bs if bs > 0 else 0.60, train=True,
                                             peaks=self.autobatch_peaks)
        return int(a["batch"])

    def freeze_mask(self) -> torch.Tensor | None:
        """The flat 0/1 vector that `freeze` holds at 0 (None: nothing frozen)."""
        freeze = self.args.get("freeze")
        if freeze in (None, 0, False):
            return None
        idxs = ({int(i) for i in freeze} if isinstance(freeze, (list, tuple))
                else set(range(int(freeze))))
        keep = self.flat.vector({name: not any(name.startswith(f"model.{i}.") for i in idxs)
                                 for name in self.flat.slices})
        LOGGER.info(f"freeze: layers {sorted(idxs)} -> {int((keep == 0).sum())} params held")
        return keep

    def setup(self, nb: int) -> None:
        a = self.args
        bs, epochs = self.resolve_batch(), int(a["epochs"])
        self.accumulate = max(round(int(a["nbs"]) / bs), 1)
        name, lr0, momentum = (
            (a["optimizer"], float(a["lr0"]), float(a["momentum"])) if a["optimizer"] != "auto"
            else auto_optimizer(self.model.nc, float(a["lr0"]), float(a["momentum"]), epochs * nb))
        self.schedule = Schedule(lr0, float(a["lrf"]), epochs, nb, self.accumulate,
                                 warmup_steps_for(float(a["warmup_epochs"]), epochs, nb),
                                 bool(a["cos_lr"]), momentum, float(a["warmup_momentum"]))
        # weight decay scaled as the reference: decay * batch * accumulate / nbs
        self.decay = float(a["weight_decay"]) * bs * self.accumulate / int(a["nbs"])
        self.flat = FlatParams(self.model)
        self.keep = self.freeze_mask()
        opt = FlatOptimizer(name, self.schedule.lr_at, momentum, self.decay,
                            self.flat.vector(_decay_mask(self.model)),
                            self.schedule.momentum_at if self.schedule.warmup_steps else None,
                            keep=self.keep)
        self.optimizer = MultiSteps(opt, self.accumulate)
        self.ema = ModelEMA(self.flat.data, keep=self.keep)

    def train_step(self, batch: dict, mosaic: bool = True):
        """One micro-step on a device batch (see `batch_to_device`). Returns
        (loss, {"box", "cls", "dfl"[, "seg" | "kpt"]}, whether the parameters were updated)."""
        a = self.args
        imgsz = batch["img"].shape[1]
        extra = {"segment": "masks", "pose": "keypoints", "obb": "rboxes"}.get(self.task)
        aug = augment_batch(batch["img"], batch["cls"], batch["bboxes"], batch["mask_gt"],
                            self.gen, imgsz, a, mosaic,
                            **({extra: batch.get(extra)} if extra else {}))
        img01, cls, bboxes, mask = aug[:4]
        tgt = {"cls": cls, "bboxes": bboxes, "mask_gt": mask, "img_weight": batch["img_weight"]}
        if self.rtdetr:
            tgt["dn"] = make_cdn_group(cls, bboxes, mask, self.model.nc, self.gen)
        out = train_forward(self.model, img01.permute(0, 3, 1, 2).contiguous(),
                            amp=bool(a["amp"]), dn=tgt.get("dn"))
        if len(aug) == 5:  # the obb criterion's boxes are the rotated ones
            tgt["bboxes" if extra == "rboxes" else extra] = aug[4]
        loss, items = (self.criterion(out, tgt) if self.dict_loss
                       else self.criterion(out["feats"], tgt, out.get("quality")))
        if self.rtdetr:  # JAX logs L1, cls and GIoU in the box, cls and dfl columns
            items = {**items, "box": items["l1"], "dfl": items["giou"]}
        self.flat.grad.zero_()
        loss.backward()
        if self.keep is not None:
            self.flat.grad.mul_(self.keep)
        updated = self.optimizer.step(self.flat.data, self.flat.grad)
        if updated:
            self.ema.update(self.flat.data)
        return loss.detach(), items, updated

    def _epoch(self, batches: Iterable[dict], epoch: int) -> list[float]:
        """One epoch of micro-steps; the mean of each of LOSS_ITEMS."""
        a = self.args
        self.epoch = epoch
        mosaic = float(a["mosaic"]) > 0 and epoch < int(a["epochs"]) - int(a["close_mosaic"])
        items = [self.train_step(batch_to_device(b, self.device), mosaic)[1] for b in batches]
        means = torch.stack([torch.stack([it[k] for k in self.LOSS_ITEMS]) for it in items])
        self.epoch_losses.append(means.mean(0).tolist())
        return self.epoch_losses[-1]

    def train(self, batches: Iterable[dict],
              fitness: Callable[["DetectionTrainer"], float | None] | None = None
              ) -> list[list[float]]:
        """Run the epochs over `batches` (re-iterable, with a len); returns the
        mean (box, cls, dfl) loss items of each epoch. `fitness`, when given,
        scores each epoch for early stopping."""
        self.setup(len(batches))
        stopper = EarlyStopping(int(self.args["patience"]))
        for epoch in range(int(self.args["epochs"])):
            self._epoch(batches, epoch)
            if stopper(epoch, fitness(self) if fitness else None):
                break
        return self.epoch_losses

    # -- the dataset-driven loop ------------------------------------------------
    def fit(self) -> float:
        """JAX's DetectionTrainer.train: epochs over args["data"]'s train split,
        validation with the EMA, results.csv and checkpoints under `save_dir`.
        Returns the best fitness; the model ends holding the EMA weights.
        With args["deterministic"] (the default) the run uses deterministic
        algorithms only (`deterministic_algorithms`)."""
        with deterministic_algorithms(bool(self.args["deterministic"])):
            return self._fit()

    def _train_data(self) -> tuple[dict, DataLoader]:
        """The dataset config and the shuffled, augmenting train loader."""
        a = self.args
        self.resolve_batch()
        data_cfg = check_det_dataset(a["data"])
        if data_cfg["nc"] != self.model.nc:
            raise ValueError(f"dataset nc={data_cfg['nc']} != model nc={self.model.nc}")
        train_set = YOLODataset(data_cfg["train"], imgsz=int(a["imgsz"]), augment=True,
                                single_cls=bool(a.get("single_cls", False)),
                                fraction=float(a.get("fraction", 1.0)), names=data_cfg["names"],
                                cache=a.get("cache", False), task=self.task,
                                mask_ratio=int(a["mask_ratio"]),
                                kpt_shape=getattr(self.model, "kpt_shape", None) or (17, 3))
        return data_cfg, build_dataloader(train_set, int(a["batch"]), shuffle=True,
                                          seed=int(a["seed"]))

    def _loss_row(self, mloss: list[float]) -> dict:
        return {f"train/{k}_loss": round(float(v), 5) for k, v in zip(self.LOSS_ITEMS, mloss)}

    def _fit(self) -> float:
        a = self.args
        data_cfg, loader = self._train_data()
        self.model.names = data_cfg["names"]
        epochs = int(a["epochs"])
        self.save_dir.mkdir(parents=True, exist_ok=True)
        yaml_save(self.save_dir / "args.yaml", {k: v for k, v in a.items()
                                                 if isinstance(v, (int, float, str, bool, type(None), list))})
        self.setup(len(loader))
        start_epoch = 0
        if a.get("resume"):
            ck = Path(a["resume"]) if isinstance(a["resume"], (str, Path)) else self.save_dir / "last.pt"
            if not ck.exists():
                raise FileNotFoundError(f"resume checkpoint {ck} not found")
            start_epoch = self.load_state(ck) + 1
            LOGGER.info(f"resumed from {ck} at epoch {start_epoch} "
                        f"(best fitness {self.best_fitness:.4f})")
        loader.epoch = start_epoch  # the shuffle of epoch e is Random(seed + e) on resume too
        stopper = EarlyStopping(int(a["patience"]))
        csv_path = self.save_dir / "results.csv"
        t_start = time.time()
        self.epoch_times: list[float] = []
        self.val_times: list[float] = []
        self.save_times: list[float] = []  # results.csv, checkpoints and the epoch's callbacks
        self.run_callbacks("on_train_start")
        for epoch in range(start_epoch, epochs):
            self.epoch = epoch
            self.run_callbacks("on_train_epoch_start")
            t0 = time.perf_counter()
            mloss = self._epoch(loader, epoch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            self.run_callbacks("on_train_epoch_end")
            metrics_row = self._validate(data_cfg) if a.get("val", True) else {}
            t2 = time.perf_counter()
            self.epoch_times.append(t1 - t0)
            self.val_times.append(t2 - t1)
            fitness_val = metrics_row.get("fitness")
            self.last_metrics = dict(metrics_row)
            self.run_callbacks("on_fit_epoch_end")
            row = {"epoch": epoch, "time": round(time.time() - t_start, 2), **self._loss_row(mloss),
                   **{k: round(float(v), 5) for k, v in metrics_row.items()},
                   "lr/pg0": round(self.schedule.lr_at(self.optimizer.opt.count), 6)}
            write_header = not csv_path.exists()
            with open(csv_path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(row))
                if write_header:
                    w.writeheader()
                w.writerow(row)
            LOGGER.info(f"epoch {epoch + 1}/{epochs} "
                        + " ".join(f"{k} {v:.4f}" for k, v in zip(self.LOSS_ITEMS, mloss))
                        + (f" fitness {fitness_val:.4f}" if fitness_val is not None else ""))
            names = ("last",)
            if fitness_val is not None and fitness_val >= self.best_fitness:
                self.best_fitness = fitness_val
                self.best_metrics = dict(metrics_row)
                names = ("best", "last")
            self.save_checkpoint(names, epoch)
            self.run_callbacks("on_model_save")
            sp = int(a.get("save_period", -1))
            if sp > 0 and (epoch + 1) % sp == 0:
                self.save_checkpoint(f"epoch{epoch}", epoch)
            self.save_times.append(time.perf_counter() - t2)
            stop = stopper(epoch, fitness_val)
            if a.get("time") and (time.time() - t_start) > float(a["time"]) * 3600:
                LOGGER.info("time budget reached, stopping")
                stop = True
            if stop:
                break
        with torch.no_grad():
            self.flat.data.copy_(self.ema.ema)  # the model handle keeps the EMA weights
        self.run_callbacks("on_train_end")
        self.run_callbacks("teardown")
        LOGGER.info(f"training done in {(time.time() - t_start) / 3600:.3f}h, best fitness "
                    f"{self.best_fitness:.4f}, results in {self.save_dir}")
        return self.best_fitness

    def _validate(self, data_cfg: dict) -> dict:
        """The val split through the EMA weights and the current BatchNorm
        statistics, at max_nms 4096; the trained weights are put back after."""
        from edgeyolo_tpu_torch.cfg import get_cfg
        from edgeyolo_tpu_torch.engine.model import task_class

        if self.validator is None:
            a = self.args
            vargs = get_cfg(overrides={
                "mode": "val", "data": a["data"], "imgsz": int(a["imgsz"]),
                "batch": int(a["batch"]), "conf": 0.001, "iou": 0.7, "max_det": 300,
                "plots": False, "single_cls": bool(a.get("single_cls", False)),
                "task": self.task, "overlap_mask": bool(a["overlap_mask"])})
            self.validator = task_class(self.task, 0)(vargs, save_dir=self.save_dir / "val",
                                                      device=self.device)
        raw = self.flat.data.clone()
        try:
            with torch.no_grad():
                self.flat.data.copy_(self.ema.ema)
            return self.validator(self.model, data=data_cfg, batch_size=int(self.args["batch"]),
                                  max_nms=4096)
        finally:
            with torch.no_grad():
                self.flat.data.copy_(raw)

    # -- checkpoints --------------------------------------------------------------
    def checkpoint(self, epoch: int) -> dict:
        """The training state as tensors and plain values (weights_only-loadable)."""
        def cpu(sd):
            return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}

        opt = self.optimizer.opt
        return {
            "model": cpu(self.model.state_dict()),
            "ema": cpu(self.ema_state_dict()),
            "optimizer": {"name": opt.name, "count": opt.count,
                          **{k: getattr(opt, k).detach().to("cpu", copy=True)
                             for k in ("trace", "mu", "nu") if getattr(opt, k) is not None},
                          # zero at mini-step 0 (after an update): not stored then
                          "acc": (self.optimizer.acc.detach().to("cpu", copy=True)
                                  if self.optimizer.mini_step else None),
                          "mini_step": self.optimizer.mini_step},
            "generator": self.gen.get_state(),
            "updates": self.ema.updates, "epoch": epoch, "best_fitness": float(self.best_fitness),
            "meta": self.meta(epoch),
        }

    def meta(self, epoch: int) -> dict:
        m = self.model
        return {"epoch": epoch, "best_fitness": float(self.best_fitness),
                "model_yaml": getattr(m, "cfg", ""), "task": getattr(m, "task", "detect"),
                "scale": getattr(m, "scale", ""), "nc": m.nc, "names": dict(m.names),
                "kpt_shape": list(m.kpt_shape) if getattr(m, "kpt_shape", None) else None,
                "train_args": {k: v for k, v in self.args.items()
                               if isinstance(v, (int, float, str, bool, type(None)))}}

    def save_checkpoint(self, names: str | tuple[str, ...], epoch: int) -> Path:
        """{save_dir}/{name}.pt and its {name}.json metadata for each of
        `names`: the checkpoint built and serialised once, into one file that
        every name links to. Each name is replaced, never written in place, so a
        later checkpoint leaves the files of an earlier one as they were.
        Returns the last path."""
        self.save_dir.mkdir(parents=True, exist_ok=True)
        meta = json.dumps(self.meta(epoch), default=str)
        first = None
        for name in (names,) if isinstance(names, str) else names:
            path = self.save_dir / f"{name}.pt"
            tmp = path.with_suffix(".pt.tmp")
            tmp.unlink(missing_ok=True)
            if first is None:
                torch.save(self.checkpoint(epoch), tmp)
                first = path
            else:
                os.link(first, tmp)
            os.replace(tmp, path)
            path.with_suffix(".json").write_text(meta)
        return path

    def load_state(self, path: str | Path) -> int:
        """Restore a checkpoint's training state (after `setup`); returns its epoch."""
        ck = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(ck["model"])
        with torch.no_grad():
            self.ema.ema.copy_(torch.cat([ck["ema"][n].reshape(-1) for n, _ in self.flat.named]))
        self.ema.updates = int(ck["updates"])
        opt, st = self.optimizer.opt, ck["optimizer"]
        if st["name"] != opt.name:
            raise ValueError(f"checkpoint optimizer {st['name']} != {opt.name}")
        opt.count = int(st["count"])
        for k in ("trace", "mu", "nu"):
            if k in st:
                setattr(opt, k, st[k].to(self.device))
        self.optimizer.acc = (torch.zeros_like(self.optimizer.acc) if st["acc"] is None
                              else st["acc"].to(self.device))
        self.optimizer.mini_step = int(st["mini_step"])
        self.gen.set_state(ck["generator"])
        self.best_fitness = float(ck["best_fitness"])
        return int(ck["epoch"])

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state_dict with the EMA in place of the trained parameters."""
        sd = dict(self.model.state_dict())
        sd.update(self.flat.unflatten(self.ema.ema))
        return sd


def load_checkpoint(model: nn.Module, path: str | Path, use_ema: bool = True) -> dict:
    """Load a trainer checkpoint's weights (the EMA by default) and class names
    into `model`; returns the checkpoint."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ck["ema"] if use_ema else ck["model"])
    names = (ck.get("meta") or {}).get("names")
    if names:
        model.names = {int(k): v for k, v in names.items()}
    return ck
