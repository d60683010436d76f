#!/usr/bin/env python
"""Is the port's fit on the card repeatable? Fits EdgeLine-YOLO-n four times
on chip_smoke.py's `fit` protocol (its FIT dataset and FIT_TRAIN settings),
alternately with and without PyTorch's and cuDNN's deterministic algorithms,
and runs chip_smoke.py's ByteTrack and BoT-SORT check (video phase, part c)
on each fit's best.pt.

    python3 tools/fit_repeat.py        # on a machine with a CUDA card, about 8 minutes

Prints one JSON line per fit: its wall time, best fitness and metrics, a
hash of best.pt's EMA weights, each tracker's (share of frames under the
shape's most frequent id, frames found) per shape, and any warning of an op
that has no deterministic form.
"""
import hashlib
import json
import shutil
import sys
import tempfile
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch

import chip_smoke as cs
from edgeyolo_tpu_torch.ops import _build

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.build()
from edgeyolo_tpu_torch.data.synthetic import generate_dataset, moving_shapes, write_mjpeg_avi
from edgeyolo_tpu_torch.engine.model import YOLO

work = Path(tempfile.mkdtemp())
data = generate_dataset(work / "fit", **cs.FIT, task="detect")
truth_frames, truth = moving_shapes(cs.TRACK["frames"], cs.TRACK["imgsz"], cs.TRACK["imgsz"],
                                    n_objs=3, size=(0.2, 0.28), speed=cs.TRACK["speed"], seed=5)
clip = write_mjpeg_avi(work / "track.avi", truth_frames, quality=95)


def run(tag, det):
    torch.use_deterministic_algorithms(det, warn_only=True)
    torch.backends.cudnn.deterministic = det
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = YOLO("edgeline-yolo.yaml", device="cuda")
        t0 = time.perf_counter()
        m.train(data=str(data), project=str(work / "runs"), name=tag, deterministic=det,
                **cs.FIT_TRAIN)
        wall = time.perf_counter() - t0
    msgs = sorted({str(x.message)[:300] for x in w if "determinis" in str(x.message)})
    best = m.trainer.save_dir / "best.pt"
    ema = torch.load(best, map_location="cpu", weights_only=True)["ema"]
    h = hashlib.sha256(b"".join(t.numpy().tobytes() for t in ema.values())).hexdigest()[:16]
    shares = {}
    fitted = YOLO(best, device="cuda")
    for tracker in ("bytetrack", "botsort"):
        res = list(fitted.track(str(clip), tracker=tracker, imgsz=cs.TRACK["imgsz"], batch=1,
                                save=False, project=str(work / "runs")))
        shares[tracker] = cs.track_ids_kept(res, truth)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    print(json.dumps({"tag": tag, "det": det, "wall": round(wall, 3),
                      "best_fitness": m.trainer.best_fitness, "best": m.trainer.best_metrics,
                      "sha": h, "shares": shares, "warnings": msgs}), flush=True)


for tag, det in (("det1", True), ("nondet1", False), ("det2", True), ("nondet2", False)):
    run(tag, det)
shutil.rmtree(work)
