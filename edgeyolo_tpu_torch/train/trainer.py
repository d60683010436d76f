"""Detection training (edgeyolo_tpu/train/trainer.py): the optimizer chain,
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

The step: uint8 batch -> `augment_batch` -> bf16 autocast forward in train
mode -> `DetectionLoss` in f32 -> backward -> accumulate -> update -> EMA.
`DetectionTrainer.train` runs epochs over a re-iterable of batches in the
JAX loader's collate format; that iterable is where the dataset and loader
plug in. Validation, checkpoints, resume, results.csv, freeze and
multi-host training are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable

import torch
from torch import nn

from edgeyolo_tpu_torch.data.augment_device import augment_batch
from edgeyolo_tpu_torch.nn.tasks import train_forward
from edgeyolo_tpu_torch.train.loss import DetectionLoss
from edgeyolo_tpu_torch.utils import select_device

# the training keys of the JAX package's cfg/default.yaml
TRAIN_DEFAULTS = {
    "epochs": 100, "batch": 16, "optimizer": "auto", "seed": 0,
    "cos_lr": False, "close_mosaic": 10, "amp": True, "patience": 100, "nbs": 64,
    "lr0": 0.01, "lrf": 0.01, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "box": 7.5, "cls": 0.5, "dfl": 1.5,
    "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 0.0, "translate": 0.1,
    "scale": 0.5, "shear": 0.0, "perspective": 0.0, "flipud": 0.0, "fliplr": 0.5,
    "bgr": 0.0, "photometric": 1.0, "mosaic": 1.0, "mixup": 0.0,
}
CLIP_NORM = 10.0


def _decay_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name -> whether it takes weight decay: conv kernels only
    (BatchNorm scales and shifts, biases and the wavelet weights take none)."""
    convs = {name for name, m in model.named_modules() if isinstance(m, nn.Conv2d)}
    return {name: name.rpartition(".")[0] in convs and name.endswith(".weight")
            for name, p in model.named_parameters() if p.requires_grad}


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
                 momentum_at: Callable[[int], float] | None = None):
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
            p.add_(u * -lr)
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
            p.add_(u * -lr)
        else:  # rmsprop: scale by rms, then the learning rate, then momentum
            g = g + wd * p
            self.nu = (1 - 0.9) * g ** 2 + 0.9 * self.nu
            u = g * torch.rsqrt(self.nu + 1e-8) * -lr
            self.trace = u + m * self.trace
            p.add_(self.trace)


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

    def __init__(self, p: torch.Tensor):
        self.ema = p.clone()
        self.updates = 0

    @staticmethod
    def decay(updates: int) -> float:
        return 0.9999 * (1 - math.exp(-updates / 2000.0))

    def update(self, p: torch.Tensor) -> None:
        self.updates += 1
        d = self.decay(self.updates)
        self.ema = self.ema * d + (1 - d) * p


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
    for k in ("img", "cls", "bboxes", "mask_gt"):
        v = torch.as_tensor(batch[k])
        out[k] = v.to(device, non_blocking=True) if k == "img" else v.float().to(device)
    b = out["img"].shape[0]
    n_real = int(batch.get("n_real", b))
    out["img_weight"] = (torch.arange(b, device=device) < n_real).float()
    return out


class DetectionTrainer:
    """Trains a DetectionModel on one device; `hyp` overrides TRAIN_DEFAULTS.

    `setup(nb)` builds the optimizer for nb batches per epoch; `train_step`
    takes one micro-step; `train(batches)` runs the epochs. The model must
    hold f32 parameters; with hyp["amp"] its forward runs in bf16 autocast.
    """

    def __init__(self, model: nn.Module, hyp: dict | None = None,
                 device: str | torch.device | None = None):
        self.args = {**TRAIN_DEFAULTS, **(hyp or {})}
        self.device = select_device(device)
        self.model = model.to(self.device).train()
        self.criterion = DetectionLoss.for_model(model, self.args)
        self.gen = torch.Generator().manual_seed(int(self.args["seed"]))
        self.epoch_losses: list[list[float]] = []
        self.epoch = 0

    def setup(self, nb: int) -> None:
        a = self.args
        bs, epochs = int(a["batch"]), int(a["epochs"])
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
        opt = FlatOptimizer(name, self.schedule.lr_at, momentum, self.decay,
                            self.flat.vector(_decay_mask(self.model)),
                            self.schedule.momentum_at if self.schedule.warmup_steps else None)
        self.optimizer = MultiSteps(opt, self.accumulate)
        self.ema = ModelEMA(self.flat.data)

    def train_step(self, batch: dict, mosaic: bool = True):
        """One micro-step on a device batch (see `batch_to_device`). Returns
        (loss, {"box", "cls", "dfl"}, whether the parameters were updated)."""
        a = self.args
        imgsz = batch["img"].shape[1]
        img01, cls, bboxes, mask = augment_batch(batch["img"], batch["cls"], batch["bboxes"],
                                                 batch["mask_gt"], self.gen, imgsz, a, mosaic)
        out = train_forward(self.model, img01.permute(0, 3, 1, 2).contiguous(),
                            amp=bool(a["amp"]))
        tgt = {"cls": cls, "bboxes": bboxes, "mask_gt": mask, "img_weight": batch["img_weight"]}
        loss, items = self.criterion(out["feats"], tgt, out["quality"])
        self.flat.grad.zero_()
        loss.backward()
        updated = self.optimizer.step(self.flat.data, self.flat.grad)
        if updated:
            self.ema.update(self.flat.data)
        return loss.detach(), items, updated

    def train(self, batches: Iterable[dict],
              fitness: Callable[["DetectionTrainer"], float | None] | None = None
              ) -> list[list[float]]:
        """Run the epochs over `batches` (re-iterable, with a len); returns the
        mean (box, cls, dfl) loss items of each epoch. `fitness`, when given,
        scores each epoch for early stopping."""
        a = self.args
        epochs = int(a["epochs"])
        self.setup(len(batches))
        stopper = EarlyStopping(int(a["patience"]))
        for epoch in range(epochs):
            self.epoch = epoch
            mosaic = float(a["mosaic"]) > 0 and epoch < epochs - int(a["close_mosaic"])
            items = [self.train_step(batch_to_device(b, self.device), mosaic)[1] for b in batches]
            means = torch.stack([torch.stack([it["box"], it["cls"], it["dfl"]]) for it in items])
            self.epoch_losses.append(means.mean(0).tolist())
            if stopper(epoch, fitness(self) if fitness else None):
                break
        return self.epoch_losses

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state_dict with the EMA in place of the trained parameters."""
        sd = dict(self.model.state_dict())
        sd.update(self.flat.unflatten(self.ema.ema))
        return sd
