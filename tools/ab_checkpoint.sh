#!/bin/bash
# yolov8-rtdetr's `fit` (chip_smoke.py's protocol cut to 20 epochs) in two copies of the port,
# in the order parent, change, change, parent, twice, on one card in one run:
#
#   mkdir -p tree_check/parent tree_check/change
#   git archive <parent-commit> edgeyolo_tpu_torch chip_smoke.py | tar -x -C tree_check/parent
#   git archive $(git write-tree) edgeyolo_tpu_torch chip_smoke.py | tar -x -C tree_check/change
#   bash tools/ab_checkpoint.sh
#
# (tree_check/ is git-ignored.) Prints per run the wall time of the training call, and the mean
# time an epoch spends outside its train steps and its validation (results.csv and the
# checkpoint write above all) with the median of the trainer's own checkpoint-and-csv timer.
# yolov8-rtdetr's checkpoint (model, EMA and momentum, 116 MB) is the largest of the fits'.
set -e
for r in 1 2; do
  for side in parent change change parent; do
    (cd tree_check/$side && python3 -c "
import statistics, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, '.')
import chip_smoke as cs
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.ops import _build, linear_attention as la
_build.build()
runs, train = [], YOLO.train
def timed(self, **kw):
    t0 = time.perf_counter()
    out = train(self, **kw)
    runs.append((time.perf_counter() - t0, self.trainer))
    return out
YOLO.train = timed
with tempfile.TemporaryDirectory() as work:
    cs.fit(la, '$side', Path(work), 'yolov8-rtdetr.yaml', 0.0, epochs=20)
wall, t = runs[0]
n = len(t.epoch_times)
rest = (wall - sum(t.epoch_times) - sum(t.val_times)) / n
print(f'ab_checkpoint round $r $side: {n} epochs, train call {wall:.3f} s, train steps '
      f'{sum(t.epoch_times):.3f} s, validation {sum(t.val_times):.3f} s, outside both '
      f'{rest * 1e3:.3f} ms an epoch, checkpoint and csv median '
      f'{statistics.median(t.save_times) * 1e3:.3f} ms', flush=True)
" 2>&1 | grep -E '^ab_checkpoint|Error')
  done
done
