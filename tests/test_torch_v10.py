"""YOLOv10 in the PyTorch port against the JAX package, on the CPU in f32.

- Its modules one by one at narrow widths, as tests/test_torch_v13_modules.py
  runs them (variables from `jax.eval_shape` filled from a seeded generator,
  carried across with `from_jax_variables`, tolerance 1e-4): SCDown, PSA,
  C2fPSA, RepVGGDW, CIB with and without `lk` and `shortcut` (and at
  c1 != c2, where it takes no residual), C2fCIB, and the v10Detect head, an
  NMS-free Detect without quality (its one2one decode and top-k selection).
- The seven v10 YAMLs (tests/torch_family_checks.py): byte-identical copies;
  every scale parses as JAX parses it and builds, counting the reference's
  parameters where tests/test_parse_and_parity.py lists them (yolov10n
  2,775,520 ... yolov10x 31,808,960); the per-size files resolve by their
  own name; at scale n, or the file's own size, JAX's parameter count, the
  strict bridge both ways and the 64 px E2E pred against JAX's row by row. Their weight SCALE is 2.0: at 2.5
  every top-k score saturates at 1.0.
- The end-to-end path without quality: both branches' bias init, the
  predictor's and validator's passthrough of the head's top-k, the
  trainer's E2EDetectLoss. Three train steps against JAX are in
  tests/test_torch_v10_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_e2e import assert_e2e_close
from test_torch_v13_modules import ATOL, _from_port, _run_pair, _to_port, _variables, _x
from torch_family_checks import (build_family, check_bridge, check_copy, check_pred,  # noqa: F401
                                 check_scale, one_torch_thread, scales_of)

from edgeyolo_tpu.nn.modules import block as jblock
from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import extra as jextra
from edgeyolo_tpu.nn.modules import head as jhead
from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.cfg.models import model_cfg
from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
from edgeyolo_tpu_torch.engine.validator import DetectionValidator
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.modules import block, extra, head
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.train import trainer
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

YAMLS = ["yolov10.yaml", "yolov10n.yaml", "yolov10s.yaml", "yolov10m.yaml", "yolov10b.yaml",
         "yolov10l.yaml", "yolov10x.yaml"]
WEIGHT_SCALE = 2.0

CASES = [
    ("SCDown", jblock.SCDown(32, 3, 2), block.SCDown(16, 32, 3, 2), (2, 8, 8, 16)),
    ("SCDown_odd", jblock.SCDown(16, 3, 2), block.SCDown(16, 16, 3, 2), (2, 7, 7, 16)),
    ("PSA", jblock.PSA(128), block.PSA(128, 128), (2, 5, 5, 128)),
    ("PSA_two_heads", jblock.PSA(256), block.PSA(256, 256), (2, 4, 4, 256)),
    ("C2fPSA", jblock.C2fPSA(128, 2), block.C2fPSA(96, 128, 2), (2, 4, 4, 96)),
    ("RepVGGDW", jextra.RepVGGDW(16), extra.RepVGGDW(16), (2, 9, 9, 16)),
    ("CIB", jextra.CIB(32), extra.CIB(32, 32), (2, 6, 6, 32)),
    ("CIB_lk", jextra.CIB(32, True, 0.5, True), extra.CIB(32, 32, True, 0.5, True),
     (2, 9, 9, 32)),
    ("CIB_no_shortcut", jextra.CIB(32, False, 1.0, True), extra.CIB(32, 32, False, 1.0, True),
     (2, 6, 6, 32)),
    ("CIB_c1_ne_c2", jextra.CIB(32, True, 0.5), extra.CIB(16, 32, True, 0.5), (2, 6, 6, 16)),
    ("C2fCIB", jextra.C2fCIB(64, 2, True, False), extra.C2fCIB(32, 64, 2, True, False),
     (2, 6, 6, 32)),
    ("C2fCIB_lk", jextra.C2fCIB(64, 1, True, True), extra.C2fCIB(64, 64, 1, True, True),
     (2, 8, 8, 64)),
]


@pytest.mark.parametrize("jmod,tmod,shape", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_module_matches_jax(jmod, tmod, shape):
    flat, yj, yt = _run_pair(jmod, tmod, _x(shape), "nhwc")
    np.testing.assert_allclose(_from_port(yt, "nhwc"), np.asarray(yj), atol=ATOL)
    assert {k for k in tmod.state_dict() if not k.endswith("num_batches_tracked")} == set(
        from_jax_variables(flat))


def test_cib_residual_only_at_equal_widths():
    assert extra.CIB(32, 32, True).add and not extra.CIB(32, 32, False).add
    assert not extra.CIB(16, 32, True).add
    assert isinstance(extra.CIB(32, 32, lk=True).cv1[2], extra.RepVGGDW)
    assert not isinstance(extra.CIB(32, 32, lk=False).cv1[2], extra.RepVGGDW)


def test_psa_heads_at_the_yolov10n_shape():
    """yolov10n layer 10: PSA over c = 128 channels, 2 heads of head dim 64
    and key dim 32 (400 tokens at 640 px)."""
    spec = tasks.parse_spec(model_cfg("yolov10n"))[0][10]
    assert spec.name == "PSA" and spec.c1 == spec.c2 == 256
    m = DetectionModel("yolov10n", device="cpu").model[10]
    assert (m.attn.num_heads, m.attn.head_dim, m.attn.key_dim) == (2, 64, 32)


def test_v10detect_matches_jax():
    ch, nc = (16, 32, 64), 5
    xs = [_x((2, s, s, c), seed=i) for i, (s, c) in enumerate(zip((8, 4, 2), ch))]
    jm = jhead.v10Detect(nc=nc, ch=ch, legacy=False)
    tm = head.v10Detect(nc=nc, ch=ch, legacy=False)
    xj = [jnp.asarray(x) for x in xs]
    flat = _variables(jm, xj)
    with jconv.bn_config():
        oj = jax.jit(jm.apply)(traverse_util.unflatten_dict(flat), xj)
    missing, unexpected = tm.load_state_dict(from_jax_variables(flat), strict=False)
    assert missing == ["dfl.conv.weight"] and not unexpected
    with torch.no_grad():
        ot = tm.eval()([_to_port(x, "nhwc") for x in xs])
    assert set(ot) == {"one2one_feats", "pred"}  # eval runs the one2one branch only
    for fj, ft in zip(oj["one2one_feats"], ot["one2one_feats"]):
        np.testing.assert_allclose(_from_port(ft, "nhwc"), np.asarray(fj), atol=ATOL)
    pj, pt = np.asarray(oj["pred"]), ot["pred"].numpy()
    assert pt.shape == pj.shape == (2, 8 * 8 + 4 * 4 + 2 * 2, 6)
    assert_e2e_close(pt, pj, box_atol=1e-3, score_atol=ATOL)
    out = tm.train()([_to_port(x, "nhwc") for x in xs])
    assert set(out) == {"feats", "one2one_feats"}


@pytest.mark.parametrize("yaml", YAMLS)
def test_yaml_copy_is_byte_identical_to_jax(yaml):
    check_copy(yaml)


@pytest.mark.parametrize("yaml,scale", [(y, s) for y in YAMLS for s in scales_of(y)],
                         ids=lambda v: v.replace(".yaml", ""))
def test_every_scale_parses_as_jax_and_builds(yaml, scale):
    pm = check_scale(yaml, scale)
    assert pm.end2end and isinstance(pm.model[-1], head.v10Detect)


def test_per_size_files_resolve_by_their_own_name():
    """yolov10s is its own file (a C2fCIB backbone), not yolov10.yaml at s."""
    for s in "nsmblx":
        d = model_cfg(f"yolov10{s}")
        assert d["scale"] == s and list(d["scales"]) == [s]
        assert d == model_cfg(f"yolov10{s}.yaml")
    assert model_cfg("yolov10s")["backbone"] != model_cfg("yolov10.yaml", scale="s")["backbone"]
    assert model_cfg("yolov10.yaml")["scale"] == "n"


@pytest.fixture(scope="module", params=[(y, s) for y in YAMLS for s in scales_of(y)[:1]],
                ids=lambda v: f"{v[0].removesuffix('.yaml')}@{v[1]}")
def family(request):
    return build_family(*request.param, WEIGHT_SCALE)


def test_state_dict_bridges_both_ways(family):
    check_bridge(family)


def test_pred_matches_jax(family):
    check_pred(family)


def test_bias_init_sets_both_branches():
    h = DetectionModel("yolov10n", device="cpu").model[-1]
    prior = np.log(5 / 80 / (640 / np.array(h.stride)) ** 2)
    for cv2, cv3 in ((h.cv2, h.cv3), (h.one2one_cv2, h.one2one_cv3)):
        assert all(torch.all(s[-1].bias == 1.0) for s in cv2)
        for s, p in zip(cv3, prior):
            torch.testing.assert_close(s[-1].bias, torch.full_like(s[-1].bias, float(p)))


def test_predictor_and_validator_pass_the_top_k_through():
    """No NMS for a head without quality: the predictor's detections and the
    validator's are the head's top-k rows past conf, in order."""
    m = DetectionModel("yolov10n", device="cpu")
    with torch.no_grad():
        for s in m.model[-1].one2one_cv3:
            s[-1].bias.zero_()  # scores near 0.5, past conf 0.25
    imgs = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3))
                            .astype(np.uint8))
    with torch.no_grad():
        top = m(imgs.permute(0, 3, 1, 2).float() / 255)["pred"]
    assert top.shape == (2, 84, 6)
    det, n = DetectionPredictor(m, conf=0.25, device="cpu")(imgs)
    v = DetectionValidator(get_cfg(overrides={"mode": "val", "max_det": 300}), device="cpu")
    v.conf = 0.25
    gt = (torch.zeros(2, 1, 4), -torch.ones(2, 1), torch.zeros(2, 1),
          torch.tensor([[1.0, 0, 0, 64, 64]] * 2))
    vdet, vn, _ = v.infer(m, imgs, gt, max_nms=30000)
    for b in range(2):
        keep = top[b][top[b, :, 4] > 0.25]
        assert int(n[b]) == int(vn[b]) == len(keep) > 0
        torch.testing.assert_close(vdet[b, :len(keep)], keep)  # letterbox space
        keep[:, :4] = keep[:, :4].clamp(0, 64)  # the predictor clips to the image
        torch.testing.assert_close(det[b, :len(keep)], keep)


def test_trainer_takes_the_e2e_loss():
    t = trainer.DetectionTrainer(DetectionModel("yolov10n", device="cpu"),
                                 {"batch": 2, "nbs": 2, "amp": False}, device="cpu")
    assert t.end2end and type(t.criterion).__name__ == "E2EDetectLoss"
    out = tasks.train_forward(t.model.train(), torch.zeros(1, 3, 64, 64), amp=False)
    assert out["quality"] is None and out["one2one_quality"] is None
    assert len(out["feats"]) == len(out["one2one_feats"]) == 3
