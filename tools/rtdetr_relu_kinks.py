#!/usr/bin/env python
"""How well f32 resolves one RT-DETR train step, on the CPU: the step of
chip_smoke.py's rtdetr train reference (rtdetr-l, f32, 64 px, 4 images with
its denoising group, `rt_perturbed` weights) taken twice on the CPU, with 8
torch threads and with 1, which changes only the order of f32 sums; each
row prints the two steps' gap (chip_smoke.py's `gap_text`: the loss
relative, each gradient of its own max |grad|, the whole gradient of its
norm, the params after the update) and whether the matched encoder tokens
are equal.

    python tools/rtdetr_relu_kinks.py [MODEL ...]

Two rows per model: as built, and with every ReLU built and called as SiLU
(chip_smoke.py's `smooth_relus`). A ReLU's gradient jumps at 0, and
HGNet's convs and the decoder's FFN put pre-activations within f32 rounding
of it, so the step as built differs between thread counts by a tenth or
more of some tensors' max |grad|; smoothed, by about 1e-4. About 1 minute a
model on 8 cores.
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main():
    import torch

    import chip_smoke as cs
    from edgeyolo_tpu_torch.ops import linear_attention as la

    batch = cs.train_batch(4, cs.TRAIN_REF_IMGSZ, cs.TRAIN_REF_M, 4, seed=3)
    for name in sys.argv[1:] or ["rtdetr-l"]:
        for label, ctx in (("as built", cs.contextlib.nullcontext), ("ReLU as SiLU",
                                                                     cs.smooth_relus)):
            steps = []
            for threads in (8, 1):
                torch.set_num_threads(threads)
                with ctx():
                    steps.append(cs.ref_step(la, "cpu", cs.rt_perturbed, batch, name=name))
            same = bool((cs.matched_queries(steps[0]) == cs.matched_queries(steps[1])).all())
            print(f"{name}, {label}: 8 vs 1 threads: {cs.gap_text(cs.step_gap(*steps))}; "
                  f"matched tokens equal: {same}", flush=True)


if __name__ == "__main__":
    main()
