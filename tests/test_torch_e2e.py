"""The NMS-free (end-to-end) path of the PyTorch port against the JAX package,
on the CPU in f32: `e2e_postprocess` (JAX head.py), the E2E quality head's
pred (E2EDetect / GFLHeadv2_E2E), `E2EDetectLoss` and its gradients (JAX
loss.py), and the predictor's and validator's passthrough of the head's
top-k (JAX predictor.py infer_e2e, validator.py is_e2e).

Tolerances: the selection on exact ties is compared exactly (the lower index
first, jax.lax.top_k's order); scores 1e-4 and boxes 1e-3 px, those of
tests/test_torch_v13_modules.py's Detect; where two scores lie within the
score tolerance the two frameworks may order them either way, so such rows
are matched within their group. The loss at rel 1e-4 and its gradients at
1e-4 of their max |grad|, tests/test_torch_v13_train.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_v13_modules import _to_port, _variables, _x

from edgeyolo_tpu.cfg import get_cfg as jget_cfg
from edgeyolo_tpu.engine.predictor import DetectionPredictor as JPredictor
from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import head as jhead
from edgeyolo_tpu.train.loss import E2EDetectLoss as JE2EDetectLoss
from edgeyolo_tpu_torch.cfg import get_cfg
from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor, e2e_detections
from edgeyolo_tpu_torch.engine.validator import DetectionValidator
from edgeyolo_tpu_torch.nn.modules import head
from edgeyolo_tpu_torch.train.loss import E2EDetectLoss
from edgeyolo_tpu_torch.utils.convert import from_jax_variables
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

NC, CH = 5, (16, 32, 64)
SIDES = (8, 4, 2)  # a 64 px image at strides 8, 16, 32


def assert_e2e_close(pt, pj, box_atol=1e-3, score_atol=1e-4):
    """(B, K, 6) selections: sorted scores within score_atol; each row's box
    and class those of the JAX row at its place or, among rows whose scores
    lie within 2 score_atol of its own, of one of them."""
    assert pt.shape == pj.shape
    np.testing.assert_allclose(pt[..., 4], pj[..., 4], atol=score_atol)
    for b in range(pt.shape[0]):
        for i in range(pt.shape[1]):
            near = np.nonzero(np.abs(pj[b, :, 4] - pt[b, i, 4]) <= 2 * score_atol)[0]
            ok = [j for j in [i, *near] if pt[b, i, 5] == pj[b, j, 5]
                  and np.abs(pt[b, i, :4] - pj[b, j, :4]).max() <= box_atol]
            assert ok, (b, i, pt[b, i], pj[b, i])


def _preds(seed, b=2, a=40, nc=NC):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 50, (b, a, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(1, 14, (b, a, 2))], -1)
    return np.concatenate([boxes, rs.uniform(0, 1, (b, a, nc))], -1).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "all_equal", "equal_rows", "few_anchors"])
def test_e2e_postprocess_selects_as_jax(case):
    """Random scores; every score equal (the first k anchors, then the flat
    (anchor, class) pairs in index order); half the anchors sharing one score
    row; fewer anchors than max_det (k = A)."""
    p = _preds(0, a=12 if case == "few_anchors" else 40)
    if case == "all_equal":
        p[..., 4:] = 0.5
    elif case == "equal_rows":
        p[:, ::2, 4:] = p[:, :1, 4:]
    max_det = 30
    want = np.asarray(jhead.e2e_postprocess(jnp.asarray(p), max_det, NC))
    got = head.e2e_postprocess(torch.from_numpy(p), max_det, NC).numpy()
    assert got.shape == want.shape == (2, min(max_det, p.shape[1]), 6)
    np.testing.assert_array_equal(got, want)


def test_topk_stable_breaks_ties_by_the_lower_index():
    x = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]])
    vals, idx = head.topk_stable(x, 5)
    assert idx.tolist() == [[1, 3, 0, 2, 5]] and torch.equal(vals, x[:, [1, 3, 0, 2, 5]])
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert np.asarray(ji).tolist() == idx.tolist()


@pytest.fixture(scope="module")
def e2e_head():
    """JAX's GFLHeadv2_E2E and the port's on the same filled variables, with
    the outputs of JAX's eval apply."""
    xs = [_x((2, s, s, c), seed=i) for i, (s, c) in enumerate(zip(SIDES, CH))]
    jm = jhead.GFLHeadv2_E2E(nc=NC, ch=CH)
    xj = [jnp.asarray(x) for x in xs]
    flat = _variables(jm, xj)
    with jconv.bn_config():
        oj = jax.jit(jm.apply)(traverse_util.unflatten_dict(flat), xj)
        oj_train = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])[0])(
            traverse_util.unflatten_dict(flat), xj)
    oj = {**oj, "train": oj_train}
    tm = head.GFLHeadv2_E2E(nc=NC, ch=CH)
    missing, unexpected = tm.load_state_dict(from_jax_variables(flat), strict=False)
    assert missing == ["dfl.conv.weight"] and not unexpected
    return xs, flat, oj, tm


def test_e2e_head_pred_matches_jax(e2e_head):
    xs, _, oj, tm = e2e_head
    with torch.no_grad():
        ot = tm.eval()([_to_port(x, "nhwc") for x in xs])
    assert set(ot) == {"one2one_feats", "one2one_quality", "pred"}  # no one2many in eval
    for fj, ft in zip(oj["one2one_feats"] + oj["one2one_quality"],
                      ot["one2one_feats"] + ot["one2one_quality"]):
        np.testing.assert_allclose(ft.numpy().transpose(0, 2, 3, 1), np.asarray(fj), atol=1e-4)
    pj, pt = np.asarray(oj["pred"]), ot["pred"].numpy()
    assert pt.shape == (2, sum(s * s for s in SIDES), 6)  # k = min(300, 84 anchors)
    assert (pt[..., 2:4] >= pt[..., 0:2]).all()  # xyxy
    assert_e2e_close(pt, pj)
    # in training both branches run (BatchNorm on the batch statistics), as in JAX
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        tr = tm.train()([_to_port(x, "nhwc") for x in xs])
    tm.eval().load_state_dict(state)
    jt = oj["train"]
    assert set(tr) == {"feats", "quality", "one2one_feats", "one2one_quality"} == set(jt)
    for k in tr:
        for fj, ft in zip(jt[k], tr[k]):
            np.testing.assert_allclose(ft.numpy().transpose(0, 2, 3, 1), np.asarray(fj),
                                       atol=1e-4, err_msg=k)


def test_one2one_towers_see_detached_inputs(e2e_head):
    """JAX stop_gradient: a loss on the one2one feats reaches the one2one
    weights but not the head's input."""
    xs, _, _, tm = e2e_head
    inp = [_to_port(x, "nhwc").requires_grad_() for x in xs]
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    out = tm.train()(inp)
    sum(f.sum() for f in out["one2one_feats"]).backward()
    assert all(x.grad is None for x in inp)
    assert tm.one2one_cv2[0][0].conv.weight.grad.abs().sum() > 0
    assert tm.cv2[0][0].conv.weight.grad is None
    tm.zero_grad(set_to_none=True)
    tm.eval().load_state_dict(state)
    assert isinstance(tm, head.E2EDetect) and tm.end2end and not head.GFLHeadv2_uniH.end2end


def _targets(seed=3, b=2, m=6):
    rs = np.random.RandomState(seed)
    xy, wh = rs.uniform(0.3, 0.7, (b, m, 2)), rs.uniform(0.2, 0.5, (b, m, 2))
    mask = (np.arange(m)[None] < np.array([[3], [5]])).astype(np.float32)
    return {"cls": rs.randint(0, NC, (b, m)).astype(np.float32), "mask_gt": mask,
            "bboxes": (np.concatenate([xy, wh], -1) * mask[..., None]).astype(np.float32)}


def test_e2e_loss_and_gradients_match_jax():
    """The sum of the one2many (top-10) and one2one (top-1) criteria, each on
    its own feats and quality: the loss, its items, and its gradients with
    respect to both branches' feats and qualities."""
    rs = np.random.RandomState(4)
    no = NC + 64
    out = {}
    for key in ("", "one2one_"):
        out[key + "feats"] = [rs.randn(2, no, s, s).astype(np.float32) for s in SIDES]
        out[key + "quality"] = [rs.uniform(0.05, 0.95, (2, 1, s, s)).astype(np.float32)
                                for s in SIDES]
    tgt = _targets()
    pt = {k: [torch.from_numpy(a).requires_grad_() for a in v] for k, v in out.items()}
    crit = E2EDetectLoss(nc=NC, stride=(8, 16, 32))
    assert (crit.one2many.tal_topk, crit.one2one.tal_topk) == (10, 1)
    total, items = crit(pt, {k: torch.from_numpy(v) for k, v in tgt.items()})
    total.backward()

    jcrit = JE2EDetectLoss(nc=NC, reg_max=16, stride=(8, 16, 32))

    def f(o):
        return jcrit({k: [a.transpose(0, 2, 3, 1) for a in v] for k, v in o.items()},
                     {k: jnp.asarray(v) for k, v in tgt.items()})

    (jt, jitems), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: [jnp.asarray(a) for a in v] for k, v in out.items()})
    assert float(jt) > 0 and float(jitems["box"]) > 0
    np.testing.assert_allclose(total.item(), float(jt), rtol=1e-4)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(items[k]), float(jitems[k]), rtol=1e-4, atol=1e-7)
    for k in out:
        for p, j in zip(pt[k], jg[k]):
            j = np.asarray(j)
            assert np.abs(j).max() > 0, k
            np.testing.assert_allclose(p.grad.numpy(), j, atol=1e-4 * np.abs(j).max(), rtol=0,
                                       err_msg=k)


class _Fixed(torch.nn.Module):
    """A model stub whose pred is a fixed (B, K, 6) end-to-end selection."""

    end2end, nc, dtype = True, NC, torch.float32

    def __init__(self, pred):
        super().__init__()
        self.pred = pred

    def forward(self, x):
        return {"pred": self.pred}


class _JFixed:
    end2end, nc = True, NC

    def __init__(self, pred):
        self.pred = pred

    def apply(self, v, img, train=False):
        return {"pred": self.pred}


def _selection(seed=5, k=30, b=3):
    """Score-sorted (B, K, 6) rows as the head emits them, boxes inside 64 px."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 40, (b, k, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(1, 20, (b, k, 2))], -1)
    scores = -np.sort(-rs.uniform(0, 1, (b, k)), axis=1)
    cls = rs.randint(0, NC, (b, k))
    return np.concatenate([boxes, scores[..., None], cls[..., None]], -1).astype(np.float32)


@pytest.mark.parametrize("classes,max_det", [(None, 300), ((1, 3), 300), ((0, 2, 4), 12),
                                             (None, 7)], ids=str)
def test_predictor_passthrough_matches_jax(classes, max_det):
    """The conf gate, a class filter that punches holes in the score-sorted
    prefix (kept rows compacted to the front, in order), the max_det slice."""
    pred = _selection()
    conf = 0.3
    overrides = {"mode": "predict", "max_det": max_det, "classes": list(classes) if classes
                 else None}
    infer = JPredictor(jget_cfg(overrides=overrides))._build_infer(_JFixed(jnp.asarray(pred)),
                                                                   conf)
    jdet, jn = (np.asarray(a) for a in infer({}, jnp.zeros((1,))))
    det, n = e2e_detections(torch.from_numpy(pred), conf, max_det, classes)
    np.testing.assert_array_equal(det.numpy(), jdet)
    np.testing.assert_array_equal(n.numpy(), jn)
    if classes:  # the filter did punch holes: a dropped row ahead of a kept one
        keep = (pred[..., 4] > conf) & np.isin(pred[..., 5], classes)
        assert any((~keep[b, :i]).any() for b in range(3) for i in np.nonzero(keep[b])[0])
    # through the serving entry point: uint8 in, the same rows (boxes lie inside the image)
    predictor = DetectionPredictor(_Fixed(torch.from_numpy(pred)), conf=conf, max_det=max_det,
                                   classes=classes, device="cpu")
    pdet, pn = predictor(np.zeros((3, 64, 64, 3), np.uint8))
    np.testing.assert_array_equal(pdet.numpy(), jdet)
    np.testing.assert_array_equal(pn.numpy(), jn)


def test_validator_passthrough_takes_the_rows_past_conf():
    """JAX validator.py is_e2e: no NMS; the rows past conf of the score-sorted
    prefix, up to max_det, then the native-space matching as after NMS."""
    pred = _selection(k=40)
    v = DetectionValidator(get_cfg(overrides={"mode": "val", "max_det": 25}), device="cpu")
    v.conf = 0.2
    rs = np.random.RandomState(6)
    gtb = np.concatenate([pred[:, :4, :2], pred[:, :4, 2:4]], -1)[:, :, :4].copy()
    gtb[:, :, :2] -= rs.uniform(0, 1, gtb[:, :, :2].shape)
    gt = (torch.from_numpy(np.pad(gtb, ((0, 0), (0, 28), (0, 0)))),
          torch.from_numpy(np.pad(pred[:, :4, 5], ((0, 0), (0, 28)), constant_values=-1)),
          torch.from_numpy(np.pad(np.ones((3, 4), np.float32), ((0, 0), (0, 28)))),
          torch.tensor([[1.0, 0, 0, 64, 64]] * 3))
    det, n, tp = v.infer(_Fixed(torch.from_numpy(pred)),
                         torch.zeros(3, 64, 64, 3, dtype=torch.uint8), gt, max_nms=30000)
    jp = jnp.asarray(pred)
    keep = jp[..., 4] > 0.2
    want = np.asarray(jnp.where(keep[..., None], jp, 0.0)[:, :25])
    np.testing.assert_array_equal(det.numpy(), want)
    np.testing.assert_array_equal(n.numpy(), np.asarray(keep[:, :25].sum(1)))
    assert tp.shape == (3, 25, 10) and bool(tp[:, 0].any())  # the gt boxes are matched
