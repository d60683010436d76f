"""The pose and obb tasks' heads and models in the PyTorch port against the
JAX package, on the CPU.

- The Pose head (COCO's 17 x 3 and a 5 x 2 keypoint shape) and the OBB head,
  in both cls towers: feats and the raw keypoints 1e-4, the decoded boxes and
  keypoints 1e-3 px, scores and visibilities 1e-4, angles 1e-5; their cv4
  towers carried from the JAX variables by `from_jax_variables`.
- The five pose and obb YAMLs (tests/torch_family_checks.py): the
  byte-identical copy, the parse (layer specs, strides, the kpt_shape
  argument, a data-level kpt_shape replacing the literal), the build, JAX's
  parameter count, the strict state_dict bridge both ways (the cv4 towers
  among its keys), and at 64 px in f32 the pred: boxes 5e-3 px and scores
  1e-4 (that file's tolerances), keypoint xy 5e-3 px and visibilities 1e-4,
  angles 1e-5; the output depends on the image.
- guess_model_task, PoseModel and OBBModel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_families import _imgs, _jax_template
from test_torch_v13_e2e_families import _perturbed
from test_torch_v13_modules import _from_port, _to_port, _variables, _x
from torch_family_checks import (check_bridge, check_copy, check_scale, jax_spec,  # noqa: F401
                                 one_torch_thread, to_jax)

from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import head as jhead
from edgeyolo_tpu_torch.cfg.models import model_cfg
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.modules import head
from edgeyolo_tpu_torch.nn.tasks import (DetectionModel, OBBModel, PoseModel, guess_model_task,
                                         num_params)
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

ATOL = 1e-4
CH = (16, 32, 64)


def _head_io(jm, tm):
    xs = [_x((2, s, s, c), seed=i) for i, (s, c) in enumerate(zip((8, 4, 2), CH))]
    xj = [jnp.asarray(x) for x in xs]
    flat = _variables(jm, xj)
    assert any(k[1].startswith("cv4_") for k in flat)
    with jconv.bn_config():
        oj = jax.jit(jm.apply)(traverse_util.unflatten_dict(flat), xj)
    sd = from_jax_variables(flat)
    assert {k for k in sd if k.startswith("cv4.")} == {
        k for k in tm.state_dict() if k.startswith("cv4.") and "num_batches" not in k}
    missing, unexpected = tm.load_state_dict(sd, strict=False)
    assert missing == ["dfl.conv.weight"] and not unexpected
    with torch.no_grad():
        ot = tm.eval()([_to_port(x, "nhwc") for x in xs])
        train_keys = set(tm.train()([_to_port(x, "nhwc") for x in xs]))
    for fj, ft in zip(oj["feats"], ot["feats"]):
        np.testing.assert_allclose(_from_port(ft, "nhwc"), np.asarray(fj), atol=ATOL)
    return oj, ot, train_keys


@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)], ids=["coco17x3", "5x2"])
@pytest.mark.parametrize("legacy", [False, True], ids=["dw_cls_tower", "legacy_cls_tower"])
def test_pose_head_matches_jax(legacy, kpt_shape):
    nc = 3
    jm = jhead.Pose(nc=nc, kpt_shape=kpt_shape, ch=CH, legacy=legacy)
    tm = head.Pose(nc=nc, kpt_shape=kpt_shape, ch=CH, legacy=legacy)
    oj, ot, train_keys = _head_io(jm, tm)
    assert train_keys == {"feats", "kpts_raw"}
    nk = kpt_shape[0] * kpt_shape[1]
    assert ot["kpts_raw"].shape == (2, 84, nk)
    np.testing.assert_allclose(ot["kpts_raw"].numpy(), np.asarray(oj["kpts_raw"]), atol=ATOL)
    pj, pt = np.asarray(oj["pred"]), ot["pred"].numpy()
    assert pt.shape == pj.shape == (2, 84, 4 + nc + nk)
    np.testing.assert_allclose(pt[..., :4], pj[..., :4], atol=1e-3)
    np.testing.assert_allclose(pt[..., 4:4 + nc], pj[..., 4:4 + nc], atol=ATOL)
    kt = pt[..., 4 + nc:].reshape(2, 84, *kpt_shape)
    kj = pj[..., 4 + nc:].reshape(2, 84, *kpt_shape)
    np.testing.assert_allclose(kt[..., :2], kj[..., :2], atol=1e-3)  # pixels
    if kpt_shape[1] == 3:
        np.testing.assert_allclose(kt[..., 2], kj[..., 2], atol=ATOL)
        assert 0 < kt[..., 2].min() and kt[..., 2].max() < 1
    assert [m[0].conv.out_channels for m in tm.cv4] == [max(CH[0] // 4, nk)] * 3


@pytest.mark.parametrize("legacy", [False, True], ids=["dw_cls_tower", "legacy_cls_tower"])
def test_obb_head_matches_jax(legacy):
    nc = 4
    jm = jhead.OBB(nc=nc, ne=1, ch=CH, legacy=legacy)
    tm = head.OBB(nc=nc, ne=1, ch=CH, legacy=legacy)
    oj, ot, train_keys = _head_io(jm, tm)
    assert train_keys == {"feats", "angle"}
    assert ot["angle"].shape == (2, 84, 1) and ot["angle"].dtype == torch.float32
    np.testing.assert_allclose(ot["angle"].numpy(), np.asarray(oj["angle"]), atol=1e-5)
    a = ot["angle"].numpy()
    assert -np.pi / 4 <= a.min() and a.max() < 3 * np.pi / 4 and a.std() > 0.01
    pj, pt = np.asarray(oj["pred"]), ot["pred"].numpy()
    assert pt.shape == pj.shape == (2, 84, 4 + nc + 1)
    np.testing.assert_allclose(pt[..., :4], pj[..., :4], atol=1e-3)
    np.testing.assert_allclose(pt[..., 4:4 + nc], pj[..., 4:4 + nc], atol=ATOL)
    np.testing.assert_allclose(pt[..., -1], pj[..., -1], atol=1e-5)


def test_task_guess_and_the_task_models():
    assert guess_model_task(model_cfg("yolo11n-pose")) == "pose"
    assert guess_model_task(model_cfg("yolov8n-obb")) == "obb"
    assert PoseModel("yolo11n-pose", device="cpu").kpt_shape == (17, 3)
    assert OBBModel("yolo11n-obb", device="cpu").task == "obb"
    with pytest.raises(ValueError):
        PoseModel("yolo11n-obb", device="cpu")
    with pytest.raises(ValueError):
        OBBModel("yolo11n", device="cpu")


@pytest.mark.parametrize("yaml", ["yolo11-pose.yaml", "yolov8-pose-p6.yaml"])
def test_data_level_kpt_shape_replaces_the_literal(yaml):
    """A dataset's kpt_shape replaces the YAML's [17, 3] (a literal in
    yolo11-pose, the name kpt_shape in yolov8-pose-p6), as in JAX."""
    d = model_cfg(yaml)
    d["kpt_shape"] = [5, 3]
    jd = jax_spec(yaml, d["scale"])
    jd["kpt_shape"] = [5, 3]
    layers, _, _ = tasks.parse_spec(d)
    jlayers, _, _ = jtasks.parse_spec(jd)
    assert layers[-1].args == jlayers[-1].args and layers[-1].args[1] == (5, 3)
    pm = DetectionModel(yaml, device="cpu", nc=3, kpt_shape=(5, 3))
    assert pm.kpt_shape == (5, 3) and pm.model[-1].nk == 15 and pm.nc == 3


# -- the five pose and obb YAMLs --------------------------------------------------------------
# YAML: weight SCALE, scanned as tests/test_torch_families.py scans it (boxes of the two images
# apart by 0.07-0.25 px at 2.0; at 2.2 every one of them overflows)
POSE_OBB = {"yolo11-pose.yaml": 2.0, "yolov8-pose.yaml": 2.0, "yolov8-pose-p6.yaml": 2.0,
            "yolo11-obb.yaml": 2.0, "yolov8-obb.yaml": 2.0}
MIN_SPREAD = 0.015


@pytest.mark.parametrize("yaml", list(POSE_OBB))
def test_pose_obb_yaml_copy_is_byte_identical_to_jax(yaml):
    check_copy(yaml)


@pytest.mark.parametrize("yaml", list(POSE_OBB))
def test_pose_obb_yaml_parses_as_jax_and_builds(yaml):
    pm = check_scale(yaml, model_cfg(yaml)["scale"])
    assert pm.task == ("pose" if "pose" in yaml else "obb")
    assert pm.kpt_shape == ((17, 3) if pm.task == "pose" else None)


def _family(yaml: str, weight_scale: float) -> dict:
    scale = model_cfg(yaml)["scale"]
    pm = DetectionModel(yaml, scale=scale, device="cpu")
    sd = _perturbed(pm.state_dict(), weight_scale)
    pm.load_state_dict(sd)
    jm = jtasks.DetectionModel(jax_spec(yaml, scale))
    template = _jax_template(jm)
    variables, rep = to_jax(pm, sd, template)
    imgs = _imgs()
    apply = jax.jit(lambda v, x: jm.net.apply(v, x, train=False)["pred"])
    jpred = np.asarray(apply(jax.tree.map(jnp.asarray, variables),
                             jnp.asarray(imgs, jnp.float32) / 255.0))
    with torch.no_grad():
        pred = pm(torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255)["pred"].numpy()
    return {"yaml": yaml, "scale": scale, "pm": pm, "sd": sd, "template": template,
            "variables": variables, "report": rep, "pred": pred, "jpred": jpred}


@pytest.fixture(scope="module", params=list(POSE_OBB), ids=lambda y: y.removesuffix(".yaml"))
def family(request):
    return _family(request.param, POSE_OBB[request.param])


def test_pose_obb_state_dict_bridges_both_ways(family):
    check_bridge(family)
    head_i = len(family["pm"].model) - 1
    assert any(k.startswith(f"model.{head_i}.cv4.2.2.") for k in family["sd"])
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(family["template"]["params"]))
    assert num_params(family["pm"]) == n_jax + 16


def test_pose_obb_pred_matches_jax(family):
    pm, pred, jpred = family["pm"], family["pred"], family["jpred"]
    nc = pm.nc
    anchors = sum((64 // s) ** 2 for s in pm.model[-1].stride)
    extra = pm.model[-1].nk if pm.task == "pose" else 1
    assert pred.shape == jpred.shape == (2, anchors, 4 + nc + extra)
    d = np.abs(pred - jpred)
    assert d[..., :4].max() < 5e-3, d[..., :4].max()
    assert d[..., 4:4 + nc].max() < 1e-4, d[..., 4:4 + nc].max()
    if pm.task == "pose":
        k = d[..., 4 + nc:].reshape(2, anchors, 17, 3)
        assert k[..., :2].max() < 5e-3, k[..., :2].max()
        assert k[..., 2].max() < 1e-4, k[..., 2].max()
    else:
        assert d[..., -1].max() < 1e-5, d[..., -1].max()
    sc = pred[..., 4:4 + nc]
    assert 0.01 < sc.min() and sc.max() < 0.99  # not saturated
    assert np.abs(pred[0, :, :4] - pred[1, :, :4]).max() > MIN_SPREAD
