#!/bin/bash
# chip_smoke.py's train phase (EdgeLine-YOLO-n, batch 32 x 640 px, bf16 AMP, 12 steps) in two
# copies of the port, in the order parent, change, change, parent, on one card in one run:
#
#   mkdir -p tree_check/parent tree_check/change
#   git archive <parent-commit> edgeyolo_tpu_torch chip_smoke.py | tar -x -C tree_check/parent
#   git archive $(git write-tree) edgeyolo_tpu_torch chip_smoke.py | tar -x -C tree_check/change
#   bash tools/ab_train.sh
#
# (tree_check/ is git-ignored.) Prints each run's step times, stage spans and device busy time.
set -e
for side in parent change change parent; do
  echo "=== $side"
  (cd tree_check/$side && python3 -c "
import sys; sys.path.insert(0, '.')
import chip_smoke as cs
from edgeyolo_tpu_torch.ops import _build, linear_attention as la
_build.build()
cs.TRAIN_STEPS = 12
cs.train(la, '$side')
" 2>&1 | grep -E '^train: batch|^train profile|^train stages')
done
