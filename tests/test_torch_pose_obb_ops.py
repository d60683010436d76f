"""The rotated and keypoint box ops of the pose and obb tasks in the PyTorch
port against the JAX package, on the CPU.

- probiou (with and without CIoU, and its gradient where a box is
  degenerate), kpt_iou and dist2rbox: f32, 1e-6. xywhr2xyxyxyxy: the numpy
  branch exact, the torch branch within two f32 ulps of the largest corner
  (3.1e-5 px at 230 px; its cos and sin round apart by one).
- nms_rotated: the blocked suppression (forced into many small blocks)
  against the dense plain version, and both against JAX's nms_rotated, for
  the argmax and the multi-label candidates and a `classes` filter: the
  same kept rows (classes and scores exact), boxes 1e-5, counts exact.
- poly2rbox (rotating calipers) against JAX's `_poly2rbox`: corners 1e-5 for
  rectangles, skewed quads and random polygons, compared by corners so that
  a box on the angle seam (theta or theta - pi/2 with w and h swapped) is
  the same box.
- split_dota_image: the same windows, origins and labels as JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from edgeyolo_tpu.data import converter as jconverter
from edgeyolo_tpu.data.dataset import _poly2rbox as jax_poly2rbox
from edgeyolo_tpu.ops import boxes as jboxes
from edgeyolo_tpu.ops.nms import nms_rotated as jax_nms_rotated
from edgeyolo_tpu_torch.data.converter import split_dota_image
from edgeyolo_tpu_torch.data.dataset import poly2rbox
from edgeyolo_tpu_torch.ops import boxes, nms


def _rboxes(rs, n, lo=4.0, hi=60.0):
    xy = rs.uniform(0, 200, (n, 2))
    wh = rs.uniform(lo, hi, (n, 2))
    r = rs.uniform(-np.pi / 4, 3 * np.pi / 4, (n, 1))
    return np.concatenate([xy, wh, r], -1).astype(np.float32)


@pytest.mark.parametrize("ciou", [False, True], ids=["iou", "ciou"])
def test_probiou_matches_jax(ciou):
    rs = np.random.RandomState(0)
    a, b = _rboxes(rs, 64), _rboxes(rs, 64)
    b[:16] = a[:16] + rs.randn(16, 5).astype(np.float32) * 2  # overlapping pairs
    b[16:20, 2:4] = 0.0  # degenerate boxes: det = 0 under the clip
    pt = boxes.probiou(torch.from_numpy(a)[:, None], torch.from_numpy(b)[None], CIoU=ciou)
    pj = jboxes.probiou(jnp.asarray(a)[:, None], jnp.asarray(b)[None], CIoU=ciou)
    assert pt.shape == (64, 64, 1)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    if not ciou:  # probiou itself lies in [0, 1], high for the overlapping pairs
        overlapping = pt.numpy()[np.arange(16), np.arange(16), 0]
        assert (overlapping > 0.2).mean() > 0.5 and 0 <= pt.min() and pt.max() <= 1.0


def test_probiou_gradient_is_finite_at_a_unit_dummy_box():
    a = torch.tensor([[5.0, 6.0, 3.0, 2.0, 0.3]], requires_grad=True)
    dummy = torch.tensor([[0.0, 0.0, 1.0, 1.0, 0.0]])
    boxes.probiou(a, dummy).sum().backward()
    assert torch.isfinite(a.grad).all()


def test_kpt_iou_matches_jax():
    rs = np.random.RandomState(1)
    k1 = np.concatenate([rs.uniform(0, 100, (5, 17, 2)), rs.randint(0, 3, (5, 17, 1))], -1)
    k2 = k1[rs.randint(0, 5, 7)] + rs.randn(7, 17, 3) * 3
    area = rs.uniform(100, 3000, 5)
    sig = np.linspace(0.02, 0.1, 17)
    k1, k2, area = (x.astype(np.float32) for x in (k1, k2, area))
    pt = boxes.kpt_iou(torch.from_numpy(k1), torch.from_numpy(k2), torch.from_numpy(area), sig)
    pj = jboxes.kpt_iou(jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(area), sig)
    assert pt.shape == (5, 7)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)


def test_dist2rbox_and_corners_match_jax():
    rs = np.random.RandomState(2)
    dist = rs.uniform(0, 8, (2, 30, 4)).astype(np.float32)
    ang = rs.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 30, 1)).astype(np.float32)
    anc = rs.uniform(0, 20, (30, 2)).astype(np.float32)
    pt = boxes.dist2rbox(torch.from_numpy(dist), torch.from_numpy(ang), torch.from_numpy(anc))
    pj = jboxes.dist2rbox(jnp.asarray(dist), jnp.asarray(ang), jnp.asarray(anc))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    rb = _rboxes(rs, 40)
    want = jboxes.xywhr2xyxyxyxy(rb)
    ulp = np.spacing(np.abs(want).max())  # f32 spacing at the largest corner (1.5e-5 px)
    np.testing.assert_allclose(boxes.xywhr2xyxyxyxy(torch.from_numpy(rb)).numpy(), want,
                               atol=2 * ulp, rtol=0)
    got_np = boxes.xywhr2xyxyxyxy(rb)
    assert got_np.dtype == np.float32 and got_np.shape == (40, 4, 2)
    np.testing.assert_array_equal(got_np, want)


# -- nms_rotated ------------------------------------------------------------------------------
def _obb_pred(seed=0, b=3, a=400, nc=4):
    """Crowded rotated candidates: boxes around a few centres, so suppression
    runs deep; scores spread over classes."""
    rs = np.random.RandomState(seed)
    centres = rs.uniform(40, 300, (b, 10, 2))
    pick = rs.randint(0, 10, (b, a))
    xy = np.take_along_axis(centres, pick[..., None].repeat(2, -1), axis=1) + rs.randn(b, a, 2) * 6
    wh = rs.uniform(20, 60, (b, a, 2))
    ang = rs.uniform(-np.pi / 4, 3 * np.pi / 4, (b, a, 1))
    sc = rs.rand(b, a, nc) ** 3
    return np.concatenate([xy, wh, sc, ang], -1).astype(np.float32)


CASES = [dict(multi_label=False), dict(multi_label=True),
         dict(multi_label=True, classes=(1, 3)), dict(multi_label=False, classes=(2,))]


@pytest.mark.parametrize("kw", CASES, ids=["argmax", "multi_label", "multi_label_classes",
                                           "argmax_classes"])
def test_nms_rotated_blocked_dense_and_jax_agree(kw, monkeypatch):
    pred = _obb_pred()
    args = dict(conf_thres=0.05, iou_thres=0.5, max_det=100, max_nms=1024, **kw)
    with monkeypatch.context() as m:  # the suppression by the dense plain version
        m.setattr(nms, "rotated_suppressed_blocked",
                  lambda cand, cls_ix, iou_thres, n_live: nms.rotated_suppressed_dense(
                      cand, cls_ix, iou_thres))
        dense, nd = nms.nms_rotated(torch.from_numpy(pred), **args)
    monkeypatch.setattr(nms, "ROT_NMS_ELEMS", 3 * 1024 * 7)  # 7 rows per block
    blocked, nb = nms.nms_rotated(torch.from_numpy(pred), **args)
    jd, jn = jax_nms_rotated(jnp.asarray(pred), **args)
    jd, jn = np.asarray(jd), np.asarray(jn)
    assert blocked.shape == dense.shape == jd.shape == (3, 100, 7)
    np.testing.assert_array_equal(nb.numpy(), jn)
    np.testing.assert_array_equal(nd.numpy(), jn)
    assert 10 < jn.min() and jn.max() < 100  # suppression ran, max_det did not cut
    for got in (blocked.numpy(), dense.numpy()):
        np.testing.assert_array_equal(got[..., 5:], jd[..., 5:])  # conf and cls exact
        np.testing.assert_allclose(got[..., :5], jd[..., :5], atol=1e-5, rtol=0)
    if "classes" in kw:
        for b in range(3):
            assert set(np.unique(jd[b, :jn[b], 6]).astype(int)) <= set(kw["classes"])


def test_nms_rotated_blocked_matches_dense_suppression():
    rs = np.random.RandomState(3)
    cand = torch.from_numpy(_rboxes(rs, 300).reshape(2, 150, 5))
    cls = torch.from_numpy(rs.randint(0, 2, (2, 150)).astype(np.float32))
    want = nms.rotated_suppressed_dense(cand, cls, 0.3)
    for rows in (1, 5, 64, 1000):
        nms.ROT_NMS_ELEMS, old = 2 * 150 * rows, nms.ROT_NMS_ELEMS
        try:
            got = nms.rotated_suppressed_blocked(cand, cls, 0.3)
        finally:
            nms.ROT_NMS_ELEMS = old
        assert torch.equal(got, want)
    assert want.any() and not want.all()


# -- poly2rbox and the DOTA tiler ----------------------------------------------------------------
def _polys(rs):
    out = []
    for _ in range(20):  # rectangles at any angle
        c, (w, h), t = rs.uniform(50, 150, 2), rs.uniform(5, 60, 2), rs.uniform(-np.pi, np.pi)
        ct, st = np.cos(t), np.sin(t)
        out.append(np.array([[c[0] + dx * ct - dy * st, c[1] + dx * st + dy * ct]
                             for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2),
                                            (-w / 2, h / 2))]))
    for _ in range(20):  # skewed quads
        out.append(rs.uniform(0, 200, (4, 2)))
    for n in (5, 7, 12):  # random polygons
        out.append(rs.uniform(0, 200, (n, 2)))
    for t in (0.0, np.pi / 2, np.pi / 4, -np.pi / 4):  # on and around the seams
        ct, st = np.cos(t), np.sin(t)
        out.append(np.array([[100 + dx * ct - dy * st, 80 + dx * st + dy * ct]
                             for dx, dy in ((-20, -10), (20, -10), (20, 10), (-20, 10))]))
    return [p.astype(np.float32) for p in out]


def test_poly2rbox_matches_jax_by_corners():
    rs = np.random.RandomState(4)
    n_raw = 0
    for p in _polys(rs):
        got, want = poly2rbox(p), jax_poly2rbox(p)
        assert got.dtype == np.float32 and got.shape == (5,)
        gc, wc = jboxes.xywhr2xyxyxyxy(got), jboxes.xywhr2xyxyxyxy(want)
        # the same rectangle: each corner of one within 1e-5 of a corner of the other
        d = np.abs(gc[:, None] - wc[None]).max(-1).min(1)
        assert d.max() < 1e-5 * max(1.0, np.abs(wc).max()), (p, got, want)
        n_raw += bool(np.allclose(got, want, atol=1e-5))
        assert got[2] >= got[3] and -np.pi / 4 <= got[4] < 3 * np.pi / 4
    assert n_raw >= 40  # away from the seam the parameters themselves agree


def test_split_dota_image_matches_jax():
    rs = np.random.RandomState(5)
    img = rs.randint(0, 255, (700, 1000, 3)).astype(np.uint8)
    labels = []
    for _ in range(30):
        c = rs.randint(0, 5)
        pts = (rs.uniform(0, 1000, 2) + rs.uniform(-40, 40, (4, 2))).reshape(-1)
        pts[1::2] = np.clip(pts[1::2] * 0.7, 0, 699)
        labels.append(np.concatenate([[c], pts]))
    labels = np.asarray(labels, np.float32)
    got = list(split_dota_image(img, labels, crop=400, gap=100))
    want = list(jconverter.split_dota_image(img, labels, crop=400, gap=100))
    assert len(got) == len(want) == 6  # 3 columns x 2 rows
    for (gw, gl, go), (ww, wl, wo) in zip(got, want):
        assert go == wo and np.array_equal(gw, ww)
        assert gl.dtype == wl.dtype and np.array_equal(gl, wl)
    assert sum(len(g[1]) for g in got) > 10
