"""YOLOv3, YOLOv5 and YOLOv8 in the PyTorch port against the JAX package, on
the CPU in f32 (tests/torch_family_checks.py): yolov3 (repeated plain
Bottlenecks, no scales), yolov5 and yolov5x (the 6 x 6 stem `[64, 6, 2, 2]`
with C3 repeats), yolov5-p6 (a 4-level head at strides 8 to 64), yolov8 and
yolov8x, and yolov8-p2 (a 4-level head at strides 4 to 32).

Each YAML: the byte-identical copy; every scale parsed as JAX parses it and
built, counting the reference's parameters where tests/test_parse_and_parity.py
lists them; at scale n or its own size JAX's parameter count, the strict
bridge both ways and the 64 px pred against JAX's.
"""

import pytest
import torch
from torch_family_checks import (build_family, check_bridge, check_copy, check_pred,  # noqa: F401
                                 check_scale, one_torch_thread, scales_of)

from edgeyolo_tpu_torch.cfg.models import model_cfg
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.ops.boxes import make_anchors

# YAML: weight SCALE
CONFIGS = {"yolov3.yaml": 2.1, "yolov5.yaml": 2.5, "yolov5x.yaml": 2.25, "yolov5-p6.yaml": 2.5,
           "yolov8.yaml": 2.5, "yolov8x.yaml": 2.4, "yolov8-p2.yaml": 2.5}


@pytest.mark.parametrize("yaml", list(CONFIGS))
def test_yaml_copy_is_byte_identical_to_jax(yaml):
    check_copy(yaml)


@pytest.mark.parametrize("yaml,scale", [(y, s) for y in CONFIGS for s in scales_of(y)],
                         ids=lambda v: v.replace(".yaml", ""))
def test_every_scale_parses_as_jax_and_builds(yaml, scale):
    check_scale(yaml, scale)


@pytest.mark.parametrize("name,strides", [("yolov8-p2-n", (4, 8, 16, 32)),
                                          ("yolov5-p6-n", (8, 16, 32, 64)),
                                          ("yolov3", (8, 16, 32))])
def test_head_strides_and_anchors(name, strides):
    """Four-level heads: the strides derived from the graph, and make_anchors
    over 64 px (a 1 x 1 grid at stride 64)."""
    layers = tasks.parse_spec(model_cfg(name))[0]
    derived = tasks.derive_strides(layers)
    assert tuple(int(derived[j]) for j in layers[-1].f) == strides
    m = DetectionModel(name, device="cpu")
    assert m.model[-1].stride == strides
    anchors, st = make_anchors([(64 // s, 64 // s) for s in strides], strides)
    assert anchors.shape == (sum((64 // s) ** 2 for s in strides), 2)
    assert torch.equal(st[-1], torch.tensor([float(strides[-1])]))


def test_yolov5_stem_is_a_6x6_stride_2_conv():
    conv = DetectionModel("yolov5n", device="cpu").model[0].conv
    assert (conv.kernel_size, conv.stride, conv.padding) == ((6, 6), (2, 2), (2, 2))


@pytest.fixture(scope="module", params=[(y, scales_of(y)[:1]) for y in CONFIGS],
                ids=lambda v: f"{v[0].removesuffix('.yaml')}@{v[1]}")
def family(request):
    yaml, scale = request.param
    return build_family(yaml, scale, CONFIGS[yaml])


def test_state_dict_bridges_both_ways(family):
    check_bridge(family)


def test_pred_matches_jax(family):
    check_pred(family)
