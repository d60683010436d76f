#!/bin/bash
# chip_smoke.py's yolo11n `fit` (150 epochs, 16 PNG images at 160 px) in two copies of the
# port, in the order parent, change, repeated ROUNDS times (default 3), on one card in one run:
#
#   mkdir -p tree_check/parent tree_check/change
#   git archive <parent-commit> edgeyolo_tpu_torch chip_smoke.py | tar -x -C tree_check/parent
#   git archive $(git write-tree) edgeyolo_tpu_torch chip_smoke.py | tar -x -C tree_check/change
#   bash tools/ab_fit.sh [ROUNDS]
#
# (tree_check/ is git-ignored.) Prints per run the wall time of the training call and the mean
# time an epoch spends outside its train steps and its validation (results.csv, the
# checkpoints, and the trainer's set-up spread over the epochs), from the trainer's own timers.
set -e
rounds=${1:-3}
for r in $(seq "$rounds"); do
  for side in parent change; do
    (cd tree_check/$side && python3 -c "
import sys, tempfile, time
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
    cs.fit(la, '$side', Path(work), 'yolo11n.yaml', cs.YOLO11N_FIT_MAP_MIN)
wall, t = runs[0]
n = len(t.epoch_times)
rest = (wall - sum(t.epoch_times) - sum(t.val_times)) / n
print(f'ab_fit round $r $side: {n} epochs, train call {wall:.3f} s, train steps '
      f'{sum(t.epoch_times):.3f} s, validation {sum(t.val_times):.3f} s, outside both '
      f'{rest * 1e3:.3f} ms an epoch', flush=True)
" 2>&1 | grep -E '^ab_fit|^fit yolo11n.yaml: [0-9]+ epochs|Error')
  done
done
