"""The training criterion of the PyTorch port against the JAX package, on the CPU in f32.

Inputs come from a numpy seed: head maps at 64 px (8x8, 4x4 and 2x2 anchors
per level, nc = 80, reg_max = 16), batch 2-3, M = 8 padded targets.

Tolerances: bbox_iou CIoU and bbox2dist 1e-6; TAL fg_mask and
target_gt_idx equal, target_scores 1e-5; the loss and its items rel 1e-5,
the gradients with respect to feats and quality 1e-4 of their max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgeyolo_tpu.nn.modules.block import dfl_decode as jdfl_decode
from edgeyolo_tpu.ops import boxes as jboxes
from edgeyolo_tpu.train import loss as jloss
from edgeyolo_tpu.train.tal import task_aligned_assign as jtal
from edgeyolo_tpu_torch.nn.modules.block import dfl_decode
from edgeyolo_tpu_torch.ops import boxes
from edgeyolo_tpu_torch.train import loss
from edgeyolo_tpu_torch.train.tal import task_aligned_assign
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

NC, REG_MAX, STRIDES, SHAPES = 80, 16, (8, 16, 32), ((8, 8), (4, 4), (2, 2))
HYP = {"box": 7.5, "cls": 0.5, "dfl": 1.5}


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes_xyxy(rs, shape, lo=0.0, hi=64.0):
    xy = rs.uniform(lo, hi * 0.7, shape + (2,))
    wh = rs.uniform(2.0, hi * 0.5, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_ciou_and_bbox2dist_match_jax():
    rs = np.random.RandomState(0)
    b1, b2 = _boxes_xyxy(rs, (5, 7)), _boxes_xyxy(rs, (5, 7))
    b2[0, 0] = b1[0, 0]  # identical boxes
    b2[0, 1] = [0.0, 0.0, 0.0, 0.0]  # degenerate
    for xywh in (False, True):
        j = np.asarray(jboxes.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh, CIoU=True))
        p = boxes.bbox_iou(_t(b1), _t(b2), xywh=xywh, CIoU=True).numpy()
        np.testing.assert_allclose(p, j, atol=1e-6, rtol=0)
        j = np.asarray(jboxes.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=xywh))
        np.testing.assert_allclose(boxes.bbox_iou(_t(b1), _t(b2), xywh=xywh).numpy(), j,
                                   atol=1e-6, rtol=0)
    anchors = rs.uniform(0, 64, (7, 2)).astype(np.float32)
    j = np.asarray(jboxes.bbox2dist(jnp.asarray(anchors), jnp.asarray(b1), REG_MAX - 1))
    np.testing.assert_allclose(boxes.bbox2dist(_t(anchors), _t(b1), REG_MAX - 1).numpy(), j,
                               atol=1e-6, rtol=0)


def test_ciou_alpha_carries_no_gradient():
    """JAX stops the gradient at CIoU's alpha; the port detaches it."""
    rs = np.random.RandomState(1)
    b1, b2 = _boxes_xyxy(rs, (6,)), _boxes_xyxy(rs, (6,))
    jg = np.asarray(jax.grad(lambda a: jboxes.bbox_iou(a, jnp.asarray(b2), xywh=False,
                                                       CIoU=True).sum())(jnp.asarray(b1)))
    x = _t(b1).requires_grad_()
    boxes.bbox_iou(x, _t(b2), xywh=False, CIoU=True).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), jg, atol=1e-6, rtol=1e-5)


def test_dfl_decode_matches_jax():
    logits = np.random.RandomState(2).randn(3, 5, 4 * REG_MAX).astype(np.float32)
    j = np.asarray(jdfl_decode(jnp.asarray(logits), REG_MAX))
    np.testing.assert_allclose(dfl_decode(_t(logits), REG_MAX).numpy(), j, atol=1e-5, rtol=0)


def _tal_inputs(seed=0, b=3, m=8, a=84):
    rs = np.random.RandomState(seed)
    scores = rs.uniform(0.01, 0.99, (b, a, NC)).astype(np.float32)
    pd = _boxes_xyxy(rs, (b, a))
    anc = rs.uniform(0, 64, (a, 2)).astype(np.float32)
    labels = rs.randint(0, NC, (b, m)).astype(np.float32)
    gt = _boxes_xyxy(rs, (b, m), hi=64.0)
    gt[..., 2:] = np.maximum(gt[..., 2:], gt[..., :2] + 20)
    n_real = np.array([[5], [8], [0]])[:b]  # image 2: all padding
    mask = (np.arange(m)[None] < n_real).astype(np.float32)
    return scores, pd, anc, labels, gt * mask[..., None], mask


def _check_tal(inputs, topk=10):
    j = [np.asarray(x) for x in jtal(*(jnp.asarray(x) for x in inputs), topk=topk, num_classes=NC)]
    p = [x.numpy() for x in task_aligned_assign(*(_t(x) for x in inputs), topk=topk,
                                                 num_classes=NC)]
    np.testing.assert_array_equal(p[3], j[3])  # fg_mask
    np.testing.assert_array_equal(p[4], j[4])  # target_gt_idx
    np.testing.assert_array_equal(p[0], j[0])  # target_labels
    np.testing.assert_allclose(p[1], j[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(p[2], j[2], atol=1e-5, rtol=0)
    return p


def test_tal_matches_jax():
    p = _check_tal(_tal_inputs())
    fg = p[3]
    assert fg[:2].any() and not fg[2].any()  # the all-padding image has no positives
    assert (p[4][2] == 0).all()  # argmax of an all-zero column is index 0 in both


def test_tal_ties_go_to_the_lowest_index():
    """Every anchor predicts the same box and score: the top-k picks ties by
    index, and two identical gts claim the same anchors, which the overlap
    argmax gives to the lower gt."""
    scores, pd, anc, labels, gt, mask = _tal_inputs(seed=1)
    scores[:] = 0.5
    pd[:] = [10.0, 10.0, 50.0, 50.0]
    gt[0, 1] = gt[0, 0] = [4.0, 4.0, 60.0, 60.0]
    labels[0, 1] = labels[0, 0]
    anc = np.stack(np.meshgrid(np.arange(8) * 8 + 4.0, np.arange(8) * 8 + 4.0), -1).reshape(-1, 2)
    anc = np.concatenate([anc, anc[:20]]).astype(np.float32)  # duplicate centres tie exactly
    p = _check_tal((scores, pd[:, :84], anc, labels, gt, mask), topk=10)
    assert p[3][0].sum() >= 10 and (p[4][0][p[3][0]] != 1).all()


def _loss_inputs(seed=0, b=3, zero_gt=False):
    rs = np.random.RandomState(seed)
    feats = [rs.randn(b, 4 * REG_MAX + NC, h, w).astype(np.float32) for h, w in SHAPES]
    for f in feats:
        f[:, 4 * REG_MAX:] -= 2.0  # class logits around the prior
    quality = [rs.uniform(0.05, 0.95, (b, 1, h, w)).astype(np.float32) for h, w in SHAPES]
    m = 8
    cls = rs.randint(0, NC, (b, m)).astype(np.float32)
    xy = rs.uniform(0.25, 0.75, (b, m, 2))
    wh = rs.uniform(0.15, 0.5, (b, m, 2))
    bboxes = np.concatenate([xy, wh], -1).astype(np.float32)
    n_real = rs.randint(1, m, b)
    if zero_gt:
        n_real[-1] = 0
    mask = (np.arange(m)[None] < n_real[:, None]).astype(np.float32)
    batch = {"cls": cls, "bboxes": bboxes * mask[..., None], "mask_gt": mask}
    return feats, quality, batch


def _jax_loss(feats, quality, batch):
    crit = jloss.DetectionLoss(nc=NC, reg_max=REG_MAX, stride=STRIDES, hyp=HYP)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(fs, qs):  # NCHW in, NHWC to JAX
        total, items = crit([x.transpose(0, 2, 3, 1) for x in fs], jb,
                            [q.transpose(0, 2, 3, 1) for q in qs])
        return total, items

    (total, items), (gf, gq) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(x) for x in feats], [jnp.asarray(q) for q in quality])
    return float(total), {k: float(v) for k, v in items.items()}, gf, gq


@pytest.mark.parametrize("case", ["plain", "img_weight", "zero_gt"])
def test_detection_loss_and_grads_match_jax(case):
    feats, quality, batch = _loss_inputs(seed={"plain": 0, "img_weight": 1, "zero_gt": 2}[case],
                                         zero_gt=case == "zero_gt")
    if case == "img_weight":
        batch["img_weight"] = np.float32([1.0, 1.0, 0.0])  # the last image is a padded duplicate
    jt, jitems, jgf, jgq = _jax_loss(feats, quality, batch)
    pf = [_t(x).requires_grad_() for x in feats]
    pq = [_t(q).requires_grad_() for q in quality]
    crit = loss.DetectionLoss(nc=NC, reg_max=REG_MAX, stride=STRIDES, hyp=HYP)
    total, items = crit(pf, {k: _t(v) for k, v in batch.items()}, pq)
    total.backward()
    assert np.isfinite(jt) and jt > 0
    np.testing.assert_allclose(float(total), jt, rtol=1e-5)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(items[k]), jitems[k], rtol=1e-5, atol=1e-7)
    for p, j in list(zip(pf, jgf)) + list(zip(pq, jgq)):
        j = np.asarray(j)
        assert np.isfinite(p.grad.numpy()).all()
        np.testing.assert_allclose(p.grad.numpy(), j, atol=1e-4 * np.abs(j).max(), rtol=0)
    if case == "img_weight":  # the weighted-out image takes no gradient
        assert all(float(p.grad[2].abs().max()) == 0.0 for p in pf + pq)


def test_detection_loss_without_quality_matches_jax():
    feats, _, batch = _loss_inputs(seed=3)
    crit = jloss.DetectionLoss(nc=NC, reg_max=REG_MAX, stride=STRIDES, hyp=HYP)
    jt, _ = crit([jnp.asarray(x.transpose(0, 2, 3, 1)) for x in feats],
                 {k: jnp.asarray(v) for k, v in batch.items()})
    pt, _ = loss.DetectionLoss(nc=NC, stride=STRIDES, hyp=HYP)(
        [_t(x) for x in feats], {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(pt), float(jt), rtol=1e-5)


def test_df_loss_and_bce_match_jax():
    rs = np.random.RandomState(4)
    pd = rs.randn(2, 9, 4, REG_MAX).astype(np.float32)
    tgt = rs.uniform(-1, REG_MAX + 1, (2, 9, 4)).astype(np.float32)
    j = np.asarray(jloss.df_loss(jnp.asarray(pd), jnp.asarray(tgt), REG_MAX))
    np.testing.assert_allclose(loss.df_loss(_t(pd), _t(tgt), REG_MAX).numpy(), j, atol=1e-5, rtol=0)
    lg, t = rs.randn(50).astype(np.float32) * 20, rs.rand(50).astype(np.float32)
    np.testing.assert_allclose(loss.bce_logits(_t(lg), _t(t)).numpy(),
                               np.asarray(jloss.bce_logits(jnp.asarray(lg), jnp.asarray(t))),
                               atol=1e-6, rtol=1e-6)
