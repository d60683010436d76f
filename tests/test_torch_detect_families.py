"""The detect families that need no new module in the PyTorch port, against
the JAX package on the CPU in f32 (tests/torch_family_checks.py): the YOLO11
variants yolo11-t (stock C2PSA), yolo11-test and yolo11-tune
(C2PSA_LinearAttention, so the attention kernel's plain version); yolov12
(A2C2f with `a2` False: C3k stages) and yolov12x; yolov13x; and yolov8-test
(E2EDetect on a C2f backbone, where only the head leaves the legacy cls
tower).

Each YAML: the byte-identical copy; every scale parsed as JAX parses it and
built, counting the reference's parameters where tests/test_parse_and_parity.py
lists them; at scale n or its own size JAX's parameter count, the strict
bridge both ways and the 64 px pred against JAX's. YOLOv12's area attention is chaotic above about 1.76x
its init kernels (f32 rounding then grows past the box tolerance), so its
weight SCALE is lower, as YOLOv13's is in tests/test_torch_families.py. At
scale x (yolov12x, yolov13x) no scale both moves a box by 1 px between the
two images and stays within the box tolerance on one thread and on eight
(at 1.56 and 1.57 the boxes move 2-3 px, and the port on one thread is
6.6e-3 and 5.1e-2 px off JAX): they run at 1.55 and 1.53, where the boxes
move 0.086 and 0.113 px, held to move by more than 10 times the 5e-3 px box
tolerance (MIN_SPREAD).
"""

import pytest
from torch_family_checks import (build_family, check_bridge, check_copy, check_pred,  # noqa: F401
                                 check_scale, one_torch_thread, scales_of)

from edgeyolo_tpu_torch.cfg.models import model_cfg
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.modules.edgeline import LinearAttention
from edgeyolo_tpu_torch.nn.modules.head import E2EDetect
from edgeyolo_tpu_torch.nn.tasks import DetectionModel

# YAML: weight SCALE
CONFIGS = {"yolo11-t.yaml": 2.4, "yolo11-test.yaml": 2.4, "yolo11-tune.yaml": 2.4,
           "yolov12.yaml": 1.74, "yolov12x.yaml": 1.55, "yolov13x.yaml": 1.53,
           "yolov8-test.yaml": 2.5}
MIN_SPREAD = {"yolov12x.yaml": 0.05, "yolov13x.yaml": 0.05}  # px; 1 px for the others


@pytest.mark.parametrize("yaml", list(CONFIGS))
def test_yaml_copy_is_byte_identical_to_jax(yaml):
    check_copy(yaml)


@pytest.mark.parametrize("yaml,scale", [(y, s) for y in CONFIGS for s in scales_of(y)],
                         ids=lambda v: v.replace(".yaml", ""))
def test_every_scale_parses_as_jax_and_builds(yaml, scale):
    check_scale(yaml, scale)


def test_parse_paths_no_ported_model_ran_before():
    """yolov12's head A2C2f rows with a2 False (C3k stages); yolov8-test's
    E2EDetect after C2f stages: the DWConv cls tower on the head alone."""
    layers = tasks.parse_spec(model_cfg("yolov12n"))[0]
    assert [s.args[2] for s in layers if s.name == "A2C2f"] == [True, True, False, False, False]
    m = DetectionModel("yolov8-test-n", device="cpu")
    assert isinstance(m.model[-1], E2EDetect) and m.end2end
    assert dict(tasks.parse_spec(model_cfg("yolov8-test-n"))[0][-1].kwargs)["legacy"] is False
    assert dict(tasks.parse_spec(model_cfg("yolov8n"))[0][-1].kwargs)["legacy"] is True


def test_attention_kernel_on_the_edgeline_variants():
    """yolo11-test and yolo11-tune run the attention kernel once per forward
    (their C2PSA_LinearAttention, head dim 64 at scale n); yolo11-t not."""
    for name, n in (("yolo11-test-n", 1), ("yolo11-tune-n", 1), ("yolo11-t-n", 0)):
        m = DetectionModel(name, device="cpu")
        attn = [(mod.num_heads, mod.qkv.in_channels // mod.num_heads) for mod in m.modules()
                if isinstance(mod, LinearAttention)]
        assert len(attn) == n and all(d == 64 for _, d in attn)


@pytest.fixture(scope="module", params=[(y, scales_of(y)[:1]) for y in CONFIGS],
                ids=lambda v: f"{v[0].removesuffix('.yaml')}@{v[1]}")
def family(request):
    yaml, scale = request.param
    return build_family(yaml, scale, CONFIGS[yaml])


def test_state_dict_bridges_both_ways(family):
    check_bridge(family)


def test_pred_matches_jax(family):
    check_pred(family, MIN_SPREAD.get(family["yaml"], 1.0))
