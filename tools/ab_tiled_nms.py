"""The validator's tiled NMS from two copies of the port, on one card in one
run, alternating which side runs first:

    mkdir -p tree_check/parent tree_check/change
    git archive <parent-commit> edgeyolo_tpu_torch | tar -x -C tree_check/parent
    git archive $(git write-tree) edgeyolo_tpu_torch | tar -x -C tree_check/change
    python3 tools/ab_tiled_nms.py tree_check/parent tree_check/change

(tree_check/ is git-ignored.) The load is val640's shape: batch 32, 8,400
anchors of 640 px boxes, 3 classes, multi-label at conf 0.001, iou 0.7,
max_det 300, max_nms 30000, with about 1,500 candidates per image past the
gate. Prints each side's batch times (host clock around a synchronised call),
their median and quartiles, and whether the two sides' detections are equal.
"""

import importlib.util
import statistics
import sys
import time
from pathlib import Path

import torch

KW = dict(conf_thres=0.001, iou_thres=0.7, max_det=300, max_nms=30000, multi_label=True,
          method="tiled")
PAIRS, WARMUP = 10, 2
B, A, NC, PASS = 32, 8400, 3, 0.06  # PASS: share of (anchor, class) scores past the gate


def load(root: str):
    """non_max_suppression of `root`'s ops/nms.py, as a module of its own (its
    imports resolve to the first copy on sys.path; ops/boxes.py must agree)."""
    spec = importlib.util.spec_from_file_location(
        f"nms_{abs(hash(root))}", Path(root) / "edgeyolo_tpu_torch" / "ops" / "nms.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.non_max_suppression


def make_pred(device: str) -> torch.Tensor:
    g = torch.Generator().manual_seed(0)
    xy = torch.rand(B, A, 2, generator=g) * 640
    wh = 8 + torch.rand(B, A, 2, generator=g) * 120
    live = torch.rand(B, A, NC, generator=g) < PASS
    sc = torch.where(live, 0.001 + torch.rand(B, A, NC, generator=g) * 0.2, 0.0005)
    return torch.cat([xy, wh, sc], -1).to(device)


def timed(nms, pred) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nms(pred, **KW)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_tiled_nms: needs a CUDA card", file=sys.stderr)
        return 1
    a_root, b_root = sys.argv[1:3]
    sys.path.insert(0, str(Path(a_root).resolve()))
    sides = {"a": load(a_root), "b": load(b_root)}
    pred = make_pred("cuda")
    n_cand = (pred[..., 4:] > KW["conf_thres"]).sum((1, 2))
    print(f"candidates past conf per image: min {int(n_cand.min())}, median "
          f"{int(n_cand.median())}, max {int(n_cand.max())}")
    da, na = sides["a"](pred, **KW)
    db, nb = sides["b"](pred, **KW)
    print(f"detections equal: {torch.equal(da, db) and torch.equal(na, nb)}; kept per image "
          f"min {int(na.min())} max {int(na.max())}")
    for _ in range(WARMUP):
        for nms in sides.values():
            timed(nms, pred)
    times = {"a": [], "b": []}
    for i in range(PAIRS):
        for side in ("a", "b") if i % 2 == 0 else ("b", "a"):
            times[side].append(timed(sides[side], pred))
    for side, root in (("a", a_root), ("b", b_root)):
        t = times[side]
        q = statistics.quantiles(t, n=4)
        print(f"{side} ({root}): median {statistics.median(t):.3f} ms per batch, quartiles "
              f"{q[0]:.3f}-{q[2]:.3f}; runs " + " ".join(f"{x:.3f}" for x in t))
    wins = sum(tb < ta for ta, tb in zip(times["a"], times["b"]))
    print(f"b faster in {wins} of {PAIRS} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
