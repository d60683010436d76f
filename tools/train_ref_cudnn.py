#!/usr/bin/env python3
"""How far the card's f32 train step is from an exact (f64) one, by cuDNN mode.

    python3 tools/train_ref_cudnn.py [--batch B] [--imgsz S] [MODEL ...]
                                     (default: batch 2, 64 px, edgeline-yolo-n yolov10n)

For each model, chip_smoke.py's reference step (default augmentation,
accumulate 1) from class logits at 0 (the flagship; `exercise_branches`)
or spread around 0 (others; `spread_logits`): on the CPU in f32, on the CPU in f64
on the CPU's augmented batch, and on the card in f32 with cuDNN as served, with
`cudnn.deterministic`, and with cuDNN off (native CUDA convolutions); TF32 off
throughout. For a model with a wavelet enhancer (the flagship's model.22.wave),
two more card steps, cuDNN as served, each moving one suspect of ROADMAP §C.9
to f64 alone: the train-mode BatchNorm of the bands (f_ll's and f_h's:
statistics, normalisation and affine), and the 2x bilinear upsample of the
bands. Prints each f32 step's whole-gradient and worst per-tensor gaps from
the f64 step, the card's against the CPU's, and the wave.alpha gradient's gap
from the f64 step for every step. Needs one CUDA card.
"""

import contextlib
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def band_norms_f64():
    """The wavelet enhancers' band BatchNorms (marked by `mark_bands`) in f64."""
    import torch
    import torch.nn.functional as F

    from edgeyolo_tpu_torch.nn.modules import conv

    forward = conv.BatchNorm2d.forward

    def f64(self, x):
        if not (self.training and getattr(self, "band", False)):
            return forward(self, x)
        n = x.numel() // x.shape[1]
        rv = self.running_var.double()
        rm = self.running_mean.double()
        y = F.batch_norm(x.double(), rm, rv, self.weight.double(), self.bias.double(), True,
                         self.momentum, self.eps)
        with torch.no_grad():  # flax's running update, as BatchNorm2d.forward
            self.running_mean.copy_(rm)
            kept = self.running_var.mul_(1.0 - self.momentum)
            kept.add_((rv.float() - kept) * ((n - 1) / n))
        return y.to(x.dtype)

    return mock.patch.object(conv.BatchNorm2d, "forward", f64)


def upsample_f64():
    """The wavelet enhancers' 2x bilinear upsample of the bands in f64."""
    from edgeyolo_tpu_torch.nn.modules import edgeline

    resize = edgeline._bilinear_resize
    return mock.patch.object(edgeline, "_bilinear_resize",
                             lambda x, size: resize(x.double(), size).to(x.dtype))


def mark_bands(model):
    from edgeyolo_tpu_torch.nn.modules.edgeline import WaveletEnhancer

    for m in model.modules():
        if isinstance(m, WaveletEnhancer):
            m.f_ll.bn.band = True
            if hasattr(m.f_h, "bn"):
                m.f_h.bn.band = True
    return model


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_ref_cudnn: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from edgeyolo_tpu_torch.ops import _build
    from edgeyolo_tpu_torch.ops import linear_attention as la

    args = sys.argv[1:]
    size = {"--batch": cs.TRAIN_REF_BATCH, "--imgsz": cs.TRAIN_REF_IMGSZ}
    while args and args[0] in size:
        size[args[0]] = int(args[1])
        args = args[2:]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    batch = cs.train_batch(size["--batch"], size["--imgsz"], cs.TRAIN_REF_M, 4, seed=3)
    print(f"batch {size['--batch']} x {size['--imgsz']} px", flush=True)

    def cudnn(**kw):
        return lambda: torch.backends.cudnn.flags(allow_tf32=False, **kw)

    def both(*contexts):
        def enter():
            stack = contextlib.ExitStack()
            for c in contexts:
                stack.enter_context(c())
            return stack
        return enter

    for name in args or ["edgeline-yolo-n", "yolov10n"]:
        start = cs.exercise_branches if name == "edgeline-yolo-n" else cs.spread_logits
        cpu = cs.ref_step(la, "cpu", start, batch, name=name)
        exact = cs.ref_step(la, "cpu", start, batch, replay=cpu["augmented"], name=name)
        steps = {"CPU f32": cpu}
        runs = [("card cuDNN", cudnn(enabled=True)),
                ("card cudnn.deterministic", cudnn(enabled=True, deterministic=True)),
                ("card cuDNN off", cudnn(enabled=False))]
        if "model.22.wave.alpha" in exact["grads"]:
            runs += [("card cuDNN, band BatchNorm f64", both(cudnn(enabled=True), band_norms_f64)),
                     ("card cuDNN, band upsample f64", both(cudnn(enabled=True), upsample_f64))]
        for label, within in runs:
            begin = (lambda m: mark_bands(start(m))) if "band" in label else start
            steps[label] = cs.ref_step(la, "cuda", begin, batch, name=name, within=within)
        for label, step in steps.items():
            gap = cs.step_gap(exact, step)
            print(f"{name} {label} against the f64 step: whole gradient {gap['grad_all']:.3e} of "
                  f"its norm; worst tensors "
                  + ", ".join(f"{n} {e:.3e}" for e, n in gap["grad"][:4]), flush=True)
            if label != "CPU f32":
                vs = cs.step_gap(cpu, step)
                print(f"{name} {label} against the CPU f32 step: whole gradient "
                      f"{vs['grad_all']:.3e}; worst tensors "
                      + ", ".join(f"{n} {e:.3e}" for e, n in vs["grad"][:4]), flush=True)
        alpha = "model.22.wave.alpha"
        if alpha in exact["grads"]:
            ref = exact["grads"][alpha]
            scale = ref.abs().max().item()
            print(f"{name} {alpha}, of its max |grad| from the f64 step: " + "; ".join(
                f"{label} {(s['grads'][alpha] - ref).abs().max().item() / scale:.3e}"
                for label, s in steps.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
