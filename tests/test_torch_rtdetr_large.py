"""rtdetr-x and rtdetr-resnet101 in the PyTorch port against the JAX
package, on the CPU in f32 at 64 px: tests/test_torch_rtdetr.py's model
check (perturbed weights carried through convert_rtdetr_state_dict; boxes
5e-3 px, scores 1e-4, rows in order but within selection near-ties; the
state_dict back from JAX's tree), in a file of its own so that the tier-1
run's `--dist loadfile` gives these two large models a worker.
"""

import pytest
from test_torch_rtdetr import check_model_pair, model_pair
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

LARGE = {"rtdetr-x": ("rtdetr-x.yaml", 1.0), "rtdetr-resnet101": ("rtdetr-resnet101.yaml", 1.0)}


@pytest.mark.parametrize("name", list(LARGE))
def test_large_model_pred_matches_jax_at_64px(name):
    check_model_pair(model_pair(name, *LARGE[name]))
