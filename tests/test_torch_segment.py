"""The segment task's model, ops, data and augmentation in the PyTorch port
against the JAX package, on the CPU.

- Proto (its square 16 -> 16 transposed conv with a kernel that the spatial
  flip changes, so a converter that keyed on the shape would fail) and the
  Segment head: f32, 1e-4 (tests/test_torch_v13_modules.py's module
  tolerance); the decoded boxes 1e-3 px.
- NMS with `return_idx` in the single- and multi-label paths (and the tiled
  path, which equals the matrix one): the same rows and anchor indices,
  padding rows 0, as JAX's.
- crop_mask (exact), unletterbox_masks (1e-6 against jax.image.resize),
  masks2segments against JAX's no-cv2 outline `_numpy_outline` (exact).
- The rasteriser: the masks of the port's YOLODataset(task="segment")
  against JAX's (its cv2 path) at tolerance 0 for convex, concave, thin,
  sub-pixel and border-touching polygons (box-corner polygons on every
  border, general polygons on the left and top), box-only lines, overlapping
  instances of equal area, and letterboxed square and non-square (rect)
  canvases. General polygons with a vertex on the right or bottom border,
  and self-intersecting ones, are held against cv2.fillPoly itself, also at
  tolerance 0 (ROADMAP C.14).
- Mask augmentation: the warp (separable and gather image samplers, mosaic
  and single-source), flips, and copy-paste in "flip" and "mixup" mode,
  against JAX's augment_batch with JAX's draws: images 1e-4, labels 1e-5,
  masks exact.
- The six seg YAMLs (tests/torch_family_checks.py): the byte-identical copy,
  the parse, the reference's parameter count where listed, JAX's count, the
  strict bridge both ways, and at 64 px the pred (boxes 5e-3 px, scores
  1e-4), the mask coefficients and the prototypes (1e-4 of their largest
  magnitude) and the cropped sigmoid masks of the 20 best anchors per image
  (probabilities 1e-4; thresholded at 0.5 equal except within 1e-4 of 0.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_augment import S as AUG_S
from test_torch_augment import _batch as aug_batch
from test_torch_augment import jax_drawn_params
from test_torch_families import _imgs, _jax_template
from test_torch_v13_modules import _from_port, _to_port, _variables, _x
from test_torch_v13_e2e_families import _perturbed
from torch_family_checks import (check_bridge, check_copy, check_scale, jax_spec,  # noqa: F401
                                 one_torch_thread, to_jax)

from edgeyolo_tpu.data import augment_device as jaug
from edgeyolo_tpu.data.dataset import YOLODataset as JYOLODataset
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.nn.modules import block as jblock
from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import head as jhead
from edgeyolo_tpu.ops import boxes as jboxes
from edgeyolo_tpu.ops import segments as jsegments
from edgeyolo_tpu.ops.nms import non_max_suppression as jax_nms
from edgeyolo_tpu_torch.cfg.models import model_cfg
from edgeyolo_tpu_torch.data import augment_device as aug
from edgeyolo_tpu_torch.data.dataset import YOLODataset, build_dataloader
from edgeyolo_tpu_torch.data.imageio import save_png
from edgeyolo_tpu_torch.data.rasterize import downsample, fill_poly
from edgeyolo_tpu_torch.nn.modules import block, head
from edgeyolo_tpu_torch.nn.tasks import DetectionModel, SegmentationModel, guess_model_task
from edgeyolo_tpu_torch.ops.nms import non_max_suppression
from edgeyolo_tpu_torch.ops.segments import crop_mask, masks2segments, unletterbox_masks
from edgeyolo_tpu_torch.utils import make_divisible
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

ATOL = 1e-4


# -- Proto and the Segment head -------------------------------------------------------------
def test_proto_square_deconv_is_carried_by_its_scope():
    jm, tm = jblock.Proto(16, 8), block.Proto(16, 16, 8)
    x = _x((2, 5, 5, 16))
    flat = _variables(jm, jnp.asarray(x))
    k = flat[("params", "upsample", "conv_transpose", "kernel")]
    assert k.shape == (2, 2, 16, 16)  # a conv's shape too: only the scope says transposed
    assert np.abs(k - k[::-1, ::-1]).max() > 0.1  # the spatial flip changes it
    with jconv.bn_config():
        yj = jax.jit(jm.apply)(traverse_util.unflatten_dict(flat), jnp.asarray(x))
    sd = from_jax_variables(flat)
    assert "upsample.weight" in sd and "upsample.bias" in sd
    tm.load_state_dict(sd)
    with torch.no_grad():
        yt = tm.eval()(_to_port(x, "nhwc"))
    assert yt.shape == (2, 8, 10, 10)
    np.testing.assert_allclose(_from_port(yt, "nhwc"), np.asarray(yj), atol=ATOL)
    # a shape-probed converter (the plain conv rule) scrambles the deconvolution
    wrong = dict(sd, **{"upsample.weight": torch.from_numpy(
        np.ascontiguousarray(k.transpose(3, 2, 0, 1)))})
    tm.load_state_dict(wrong)
    with torch.no_grad():
        assert np.abs(_from_port(tm(_to_port(x, "nhwc")), "nhwc") - np.asarray(yj)).max() > 1e-2


@pytest.mark.parametrize("legacy", [False, True], ids=["dw_cls_tower", "legacy_cls_tower"])
def test_segment_head_matches_jax(legacy):
    ch, nc, nm, npr = (16, 32, 64), 5, 8, 24
    xs = [_x((2, s, s, c), seed=i) for i, (s, c) in enumerate(zip((8, 4, 2), ch))]
    jm = jhead.Segment(nc=nc, nm=nm, npr=npr, ch=ch, legacy=legacy)
    tm = head.Segment(nc=nc, nm=nm, npr=npr, ch=ch, legacy=legacy)
    xj = [jnp.asarray(x) for x in xs]
    flat = _variables(jm, xj)
    with jconv.bn_config():
        oj = jax.jit(jm.apply)(traverse_util.unflatten_dict(flat), xj)
    missing, unexpected = tm.load_state_dict(from_jax_variables(flat), strict=False)
    assert missing == ["dfl.conv.weight"] and not unexpected
    with torch.no_grad():
        ot = tm.eval()([_to_port(x, "nhwc") for x in xs])
    assert set(ot) == {"feats", "mask_coefs", "proto", "pred"}
    for fj, ft in zip(oj["feats"], ot["feats"]):
        np.testing.assert_allclose(_from_port(ft, "nhwc"), np.asarray(fj), atol=ATOL)
    assert ot["mask_coefs"].shape == (2, 84, nm) and ot["proto"].shape == (2, nm, 16, 16)
    np.testing.assert_allclose(ot["mask_coefs"].numpy(), np.asarray(oj["mask_coefs"]), atol=ATOL)
    np.testing.assert_allclose(_from_port(ot["proto"], "nhwc"), np.asarray(oj["proto"]),
                               atol=ATOL)
    pj, pt = np.asarray(oj["pred"]), ot["pred"].numpy()
    assert pt.shape == pj.shape == (2, 84, 4 + nc + nm)
    np.testing.assert_allclose(pt[..., :4], pj[..., :4], atol=1e-3)
    np.testing.assert_allclose(pt[..., 4:], pj[..., 4:], atol=ATOL)
    assert set(tm.train()([_to_port(x, "nhwc") for x in xs])) == {"feats", "mask_coefs", "proto"}
    c4 = max(ch[0] // 4, nm)
    assert [m[0].conv.out_channels for m in tm.cv4] == [c4] * 3


def test_task_guess_and_segmentation_model():
    assert guess_model_task(model_cfg("yolo11n-seg")) == "segment"
    assert guess_model_task(model_cfg("yolo11n")) == "detect"
    assert SegmentationModel("yolo11n-seg", device="cpu").task == "segment"
    with pytest.raises(ValueError):
        SegmentationModel("yolo11n", device="cpu")


# -- NMS return_idx ---------------------------------------------------------------------------
def _seg_pred(seed=0, b=2, a=64, nc=3, nm=4):
    rs = np.random.RandomState(seed)
    centres = rs.uniform(20, 100, (b, 6, 2))
    pick = rs.randint(0, 6, (b, a))
    xy = np.take_along_axis(centres, pick[..., None].repeat(2, -1), axis=1) + rs.randn(b, a, 2) * 4
    wh = rs.uniform(15, 30, (b, a, 2))
    scores = rs.uniform(0, 1, (b, a, nc)) ** 2
    coefs = rs.randn(b, a, nm)
    return np.concatenate([xy, wh, scores, coefs], -1).astype(np.float32), nc


@pytest.mark.parametrize("multi_label", [False, True], ids=["best_class", "multi_label"])
def test_nms_return_idx_matches_jax(multi_label):
    pred, nc = _seg_pred()
    kw = dict(conf_thres=0.25, iou_thres=0.5, max_det=40, max_nms=64, multi_label=multi_label)
    dj, nj, ij = jax_nms(jnp.asarray(pred), nc=nc, return_idx=True, **kw)
    dt, nt, it = non_max_suppression(torch.from_numpy(pred), nc=nc, return_idx=True, **kw)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert int(nt.min()) > 1 and (it.numpy()[0, int(nt[0]):] == 0).all()  # padding rows: 0
    # the kept rows' boxes are their anchors' boxes
    box = pred[..., :4]
    xyxy = np.concatenate([box[..., :2] - box[..., 2:] / 2, box[..., :2] + box[..., 2:] / 2], -1)
    for i in range(2):
        k = int(nt[i])
        np.testing.assert_allclose(dt.numpy()[i, :k, :4], xyxy[i, it.numpy()[i, :k]], atol=1e-5)
    ti = non_max_suppression(torch.from_numpy(pred), nc=nc, return_idx=True, method="tiled",
                             **kw)
    for a, b in zip(ti, (dt, nt, it)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- mask ops -------------------------------------------------------------------------------
def test_crop_mask_is_half_open_as_jax():
    rs = np.random.RandomState(0)
    masks = rs.rand(5, 12, 16).astype(np.float32)
    boxes = np.array([[0, 0, 16, 12], [2.0, 3.0, 7.0, 9.0], [2.5, 3.5, 7.5, 9.5],
                      [-3, -2, 4, 5], [10, 8, 30, 40]], np.float32)
    want = np.asarray(jboxes.crop_mask(jnp.asarray(masks), jnp.asarray(boxes)))
    got = crop_mask(torch.from_numpy(masks), torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1, 3, 2] != 0 and got[1, 3, 7] == 0  # [x1, x2): 7 is out


@pytest.mark.parametrize("pad,orig", [((0.0, 4.0), (40, 64)), ((3.5, 0.0), (50, 39)),
                                      ((0.0, 0.0), (100, 100))])
def test_unletterbox_masks_matches_jax(pad, orig):
    rs = np.random.RandomState(1)
    masks = rs.rand(3, 16, 16).astype(np.float32)
    want = jsegments.unletterbox_masks(masks, pad, orig)
    got = unletterbox_masks(torch.from_numpy(masks), pad, orig).numpy()
    assert got.shape == want.shape == (3, *orig)
    np.testing.assert_allclose(got, want, atol=1e-6)
    wb = jsegments.unletterbox_masks(masks > 0.5, pad, orig)
    gb = unletterbox_masks(torch.from_numpy(masks > 0.5), pad, orig).numpy()
    assert gb.dtype == bool and np.mean(gb != wb) < 1e-3  # bool -> bilinear -> 0.5 cut


def test_masks2segments_is_jaxs_numpy_outline():
    rs = np.random.RandomState(2)
    masks = np.zeros((5, 20, 24), bool)
    masks[0, 3:9, 4:15] = True  # a rectangle
    yy, xx = np.mgrid[:20, :24]
    masks[1] = (yy - 10) ** 2 + (xx - 12) ** 2 < 40  # a disc
    masks[2, 5:15, 5:8] = True
    masks[2, 12:15, 5:20] = True  # an L
    masks[3] = rs.rand(20, 24) > 0.6  # scattered components
    segs = masks2segments(masks)  # masks[4]: empty
    assert len(segs) == 5 and segs[4].shape == (0, 2)
    for m, sg in zip(masks, segs):
        np.testing.assert_array_equal(sg, jsegments._numpy_outline(m.astype(np.uint8)))
        assert sg.dtype == np.float32
    assert len(masks2segments(torch.from_numpy(masks.astype(np.float32)))[0]) == len(segs[0])


# -- the rasteriser -------------------------------------------------------------------------
LABELS = {
    # image (w, h): label lines
    (80, 48): ["0 0.1 0.1 0.5 0.15 0.45 0.7 0.2 0.6",  # convex
               "1 0.55 0.2 0.95 0.2 0.95 0.9 0.75 0.9 0.75 0.45 0.55 0.45",  # concave (an L)
               "2 0.3 0.8 0.31 0.2 0.32 0.8"],  # thin
    (50, 90): ["0 0.0 0.0 0.4 0.0 0.2 0.3",  # on the left and top borders
               "1 0.6 0.5 0.8 0.6",  # box-only line: its corners
               "2 0.5 0.5 0.505 0.5 0.5 0.503",  # sub-pixel
               "0 0.7 0.7 1.0 0.7 1.0 1.0 0.7 1.0"],  # a box on the right and bottom borders
    (64, 64): ["0 0.1 0.1 0.5 0.1 0.5 0.5 0.1 0.5",  # equal areas, overlapping: tie order
               "1 0.3 0.3 0.7 0.3 0.7 0.7 0.3 0.7",
               "2 0.25 0.25 0.75 0.25 0.75 0.75 0.25 0.75",
               "0 0.5 0.5 0.2 0.2",  # box-only, overlapping the three
               "1 0.0 0.6 0.3 0.6 0.3 1.0 0.0 1.0"],
    (96, 40): ["0 0.05 0.1 0.95 0.1 0.5 0.9",
               "2 0.2 0.3 0.6 0.35 0.25 0.8 0.1 0.5 0.4 0.5",  # self-intersecting
               "1 0.62 0.12 0.9 0.15 0.88 0.85 0.7 0.6 0.63 0.88"],
}


@pytest.fixture(scope="module")
def seg_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("segds")
    rs = np.random.RandomState(0)
    for i, ((w, h), lines) in enumerate(LABELS.items()):
        for split in ("images", "labels"):
            (root / split / "val").mkdir(parents=True, exist_ok=True)
        save_png(root / "images" / "val" / f"im{i}.png", rs.randint(0, 255, (h, w, 3), np.uint8))
        (root / "labels" / "val" / f"im{i}.txt").write_text("\n".join(lines) + "\n")
    return root / "images" / "val"


@pytest.mark.parametrize("imgsz,rect", [(64, False), (96, False), (256, True)],
                         ids=["square64", "square96", "rect256"])
def test_rasterised_masks_equal_jax(seg_dir, imgsz, rect):
    jds = JYOLODataset(str(seg_dir), imgsz=imgsz, task="segment", rect=rect)
    pds = YOLODataset(str(seg_dir), imgsz=imgsz, task="segment", rect=rect)
    if rect:
        jds.set_rectangle(2)
        pds.set_rectangle(2)
    assert pds.max_gt == jds.max_gt and pds.im_files == jds.im_files
    shapes = set()
    for i in range(len(pds)):
        pj, pt = jds.get_item(i), pds.get_item(i)
        assert pt["masks"].shape == pj["masks"].shape and pt["masks"].dtype == np.float32
        shapes.add(pt["img"].shape[:2])
        np.testing.assert_array_equal(pt["masks"], pj["masks"], err_msg=pds.im_files[i])
        np.testing.assert_array_equal(pt["bboxes"], pj["bboxes"])
        n = int(pt["mask_gt"].sum())
        assert pt["masks"][:n].sum() > 0
        if n > 1:  # exclusive
            assert pt["masks"][:n].sum(0).max() == 1
    if rect:
        assert any(h != w for h, w in shapes)  # non-square canvases


def test_segment_labels_and_cache(seg_dir):
    pds = YOLODataset(str(seg_dir), task="segment")
    again = YOLODataset(str(seg_dir), task="segment")  # from the cache
    jds = JYOLODataset(str(seg_dir), task="segment")
    for a, b, c in zip(pds.labels, again.labels, jds.labels):
        assert len(a["segments"]) == len(a["cls"])  # box-only lines too
        for s1, s2, s3 in zip(a["segments"], b["segments"], c["segments"]):
            np.testing.assert_array_equal(s1, s3)
            np.testing.assert_array_equal(s2, s3)
    kept = YOLODataset(str(seg_dir), task="segment", classes=[1])
    for lab in kept.labels:
        assert len(lab["segments"]) == len(lab["cls"]) and (lab["cls"] == 1).all()
    batch = next(iter(build_dataloader(pds, 2, shuffle=False)))
    assert batch["masks"].shape == (2, pds.max_gt, 160, 160)


def test_border_polygons_against_cv2_fill():
    """General polygons with a vertex on the right or bottom border (x = W or
    y = H, one past the last pixel), at the mask grid (ratio 4) and at full
    resolution: the port's fill against cv2.fillPoly, pixel for pixel (an
    edge that leaves the canvas is scanned along its clipped segment's slope,
    ROADMAP C.14). Box-corner polygons there: exact too."""
    cv2 = pytest.importorskip("cv2")
    rs = np.random.RandomState(0)
    differ, worst = 0, 0
    for t in range(600):
        h, w = 4 * rs.randint(4, 20, 2)
        n = rs.randint(3, 9)
        ang = np.sort(rs.rand(n)) * 2 * np.pi
        rad = rs.rand(n) * max(h, w)
        pts = np.clip(np.stack([w / 2 + rad * np.cos(ang), h / 2 + rad * np.sin(ang)], 1), 0,
                      [w, h]).astype(np.int32)
        a = np.zeros((h, w), np.uint8)
        cv2.fillPoly(a, [pts], color=1)
        b = fill_poly(np.zeros((h, w), np.uint8), pts)
        d = int((cv2.resize(a, (w // 4, h // 4)) != downsample(b, 4)).sum())
        differ += d > 0 or not np.array_equal(a, b)
        worst = max(worst, d, int((a != b).sum()))
    for t in range(200):  # box corners on the borders: exact
        h, w = 4 * rs.randint(4, 20, 2)
        x1, y1 = rs.randint(0, w), rs.randint(0, h)
        pts = np.array([[x1, y1], [w, y1], [w, h], [x1, h]], np.int32)
        a = np.zeros((h, w), np.uint8)
        cv2.fillPoly(a, [pts], color=1)
        np.testing.assert_array_equal(fill_poly(np.zeros((h, w), np.uint8), pts), a)
    print(f"general border polygons: {differ} of 600 differ, worst {worst} px")
    assert differ == 0 and worst == 0


def test_fill_matches_cv2_inside_the_canvas():
    """Simple (star-shaped) and self-intersecting polygons inside the canvas:
    pixel for pixel (the active edge list re-sorted fully after each row, as
    cv2's bubble pass does, ROADMAP C.14)."""
    cv2 = pytest.importorskip("cv2")
    rs = np.random.RandomState(1)
    for t in range(500):
        h, w = rs.randint(4, 60, 2)
        n = rs.randint(3, 12)
        ang = np.sort(rs.rand(n)) * 2 * np.pi
        rad = rs.rand(n) * min(h, w) / 2
        pts = np.clip(np.stack([w / 2 + rad * np.cos(ang), h / 2 + rad * np.sin(ang)], 1), 0,
                      [w - 1, h - 1]).astype(np.int32)
        a = np.zeros((h, w), np.uint8)
        cv2.fillPoly(a, [pts], color=1)
        np.testing.assert_array_equal(fill_poly(np.zeros((h, w), np.uint8), pts), a)
    differ, worst = 0, 0
    for t in range(1000):
        h, w = rs.randint(4, 60, 2)
        n = rs.randint(3, 12)
        pts = np.stack([rs.randint(0, w, n), rs.randint(0, h, n)], 1).astype(np.int32)
        a = np.zeros((h, w), np.uint8)
        cv2.fillPoly(a, [pts], color=1)
        d = int((fill_poly(np.zeros((h, w), np.uint8), pts) != a).sum())
        differ += d > 0
        worst = max(worst, d)
    print(f"self-intersecting polygons: {differ} of 1000 differ, worst {worst} px")
    assert differ == 0 and worst == 0


# -- mask augmentation -----------------------------------------------------------------------
def _masks(boxes, mask, sm=AUG_S // 4):
    """Box-shaped instance masks at the grid, with a notch so flips show."""
    b, m = mask.shape
    out = np.zeros((b, m, sm, sm), np.float32)
    for i in range(b):
        for j in range(m):
            if mask[i, j]:
                cx, cy, w, h = boxes[i, j] * sm
                x1, y1 = int(cx - w / 2), int(cy - h / 2)
                x2, y2 = int(np.ceil(cx + w / 2)), int(np.ceil(cy + h / 2))
                out[i, j, y1:y2, x1:x2] = 1.0
                out[i, j, y1:y1 + 2, x1:x1 + 1] = 0.0
    return out


AUG_CASES = {
    "mosaic_separable": ({"hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "photometric": 0.0,
                          "fliplr": 0.5, "flipud": 0.5}, True),
    "mosaic_gather": ({"degrees": 10.0, "shear": 3.0, "perspective": 0.0005,
                       "photometric": 0.0, "fliplr": 0.5, "hsv_h": 0.0, "hsv_s": 0.0,
                       "hsv_v": 0.0}, True),
    "single_source": ({"photometric": 0.0, "mixup": 0.5, "fliplr": 0.0}, False),
    "copy_paste_flip": ({"photometric": 0.0, "copy_paste": 1.0, "fliplr": 0.5}, True),
    "copy_paste_mixup": ({"photometric": 0.0, "copy_paste": 0.7, "copy_paste_mode": "mixup"},
                         False),
}


@pytest.mark.parametrize("case", list(AUG_CASES))
def test_mask_augmentation_matches_jax(case):
    hyp, mosaic = AUG_CASES[case]
    b = 4
    imgs, cls, boxes, mask = aug_batch(b=b, seed=5)
    masks = _masks(boxes, mask)
    key = jax.random.PRNGKey(11)
    j_img, j_cls, j_box, j_val, j_ex = (jaug.augment_batch(
        jnp.asarray(imgs), jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask), key, AUG_S,
        hyp, mosaic=mosaic, masks=jnp.asarray(masks)))
    prm = jax_drawn_params(key, b, AUG_S, hyp, mosaic)
    pcp = float(hyp.get("copy_paste", 0.0))
    if pcp:
        m4 = (4 if mosaic else 1) * mask.shape[1]
        u = jax.random.uniform(jax.random.fold_in(key, 23), (b, m4))
        prm.copy_paste = torch.from_numpy(np.array(u < pcp))
        prm.copy_paste_mode = str(hyp.get("copy_paste_mode", "flip"))
    out = aug.augment_apply(torch.from_numpy(imgs), torch.from_numpy(cls),
                            torch.from_numpy(boxes), torch.from_numpy(mask), prm, AUG_S,
                            masks=torch.from_numpy(masks))
    p_img, p_cls, p_box, p_val, p_masks = (t.numpy() for t in out)
    jm = np.asarray(j_ex["masks"])
    assert p_masks.shape == jm.shape and p_cls.shape == np.asarray(j_cls).shape
    np.testing.assert_array_equal(p_val, np.asarray(j_val))
    np.testing.assert_array_equal(p_cls, np.asarray(j_cls))
    np.testing.assert_allclose(p_box, np.asarray(j_box), atol=1e-5, rtol=0)
    np.testing.assert_allclose(p_img, np.asarray(j_img), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(p_masks, jm)
    assert p_masks.sum() > 0 and (p_masks[p_val == 0] == 0).all()
    if pcp:  # instances were pasted, and their slots appended: M doubled
        assert p_val.shape[1] == 2 * (4 if mosaic else 1) * mask.shape[1]
        assert p_val[:, p_val.shape[1] // 2:].sum() > 0


def test_mixup_is_off_when_masks_ride_along():
    imgs, cls, boxes, mask = aug_batch(b=4, seed=6)
    hyp = {"photometric": 0.0, "mixup": 1.0}
    prm = aug.sample_params(4, AUG_S, hyp, False, torch.Generator().manual_seed(0), m=6)
    out = aug.augment_apply(torch.from_numpy(imgs), torch.from_numpy(cls),
                            torch.from_numpy(boxes), torch.from_numpy(mask), prm, AUG_S,
                            masks=torch.from_numpy(_masks(boxes, mask)))
    assert out[1].shape[1] == 6 and out[4].shape[1] == 6
    assert aug.augment_apply(torch.from_numpy(imgs), torch.from_numpy(cls),
                             torch.from_numpy(boxes), torch.from_numpy(mask), prm,
                             AUG_S)[1].shape[1] == 12


# -- the six seg YAMLs ----------------------------------------------------------------------
# YAML: weight SCALE, scanned as tests/test_torch_families.py scans it (the two images' boxes
# apart by 0.02-0.13 px at these; 0.1 more overflows or saturates the deeper graphs)
SEG = {"yolo11-seg.yaml": 2.0, "yolov8-seg.yaml": 2.0, "yolov8-seg-p6.yaml": 2.0,
       "fastsam.yaml": 2.0, "yolov9c-seg.yaml": 2.1, "yolov9e-seg.yaml": 2.1}
MIN_SPREAD = 0.015


@pytest.mark.parametrize("yaml", list(SEG))
def test_seg_yaml_copy_is_byte_identical_to_jax(yaml):
    check_copy(yaml)


@pytest.mark.parametrize("yaml", list(SEG))
def test_seg_yaml_parses_as_jax_and_builds(yaml):
    d = model_cfg(yaml)
    pm = check_scale(yaml, d["scale"] if d.get("scales") else "")
    assert pm.task == "segment"
    _, width, max_ch = d["scales"][d["scale"]] if d.get("scales") else (1, 1.0, float("inf"))
    assert pm.model[-1].npr == make_divisible(min(256, max_ch) * width, 8)  # npr scaled
    assert pm.model[-1].proto.cv1.conv.out_channels == pm.model[-1].npr


def seg_family(yaml: str, weight_scale: float) -> dict:
    d = model_cfg(yaml)
    scale = d["scale"] if d.get("scales") else ""
    pm = DetectionModel(yaml, scale=scale or None, device="cpu")
    sd = _perturbed(pm.state_dict(), weight_scale)
    pm.load_state_dict(sd)
    jm = jtasks.DetectionModel(jax_spec(yaml, scale))
    template = _jax_template(jm)
    variables, rep = to_jax(pm, sd, template)
    imgs = _imgs()
    apply = jax.jit(lambda v, x: jm.net.apply(v, x, train=False))
    oj = apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(imgs, jnp.float32) / 255.0)
    with torch.no_grad():
        ot = pm(torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255)
    return {"yaml": yaml, "scale": scale, "pm": pm, "sd": sd, "template": template,
            "variables": variables, "report": rep, "ot": ot,
            "oj": {k: np.asarray(oj[k]) for k in ("pred", "proto", "mask_coefs")}}


@pytest.fixture(scope="module", params=list(SEG), ids=lambda y: y.removesuffix(".yaml"))
def family(request):
    return seg_family(request.param, SEG[request.param])


def test_seg_state_dict_bridges_both_ways(family):
    check_bridge(family)


def test_seg_pred_coefs_proto_and_masks_match_jax(family):
    pm, ot, oj = family["pm"], family["ot"], family["oj"]
    nc, nm = pm.nc, pm.model[-1].nm
    pred, jpred = ot["pred"].numpy(), oj["pred"]
    anchors = sum((64 // s) ** 2 for s in pm.model[-1].stride)
    assert pred.shape == jpred.shape == (2, anchors, 4 + nc + nm)
    d = np.abs(pred - jpred)
    assert d[..., :4].max() < 5e-3, d[..., :4].max()
    assert d[..., 4:4 + nc].max() < 1e-4, d[..., 4:4 + nc].max()
    coef_scale = np.abs(jpred[..., 4 + nc:]).max()
    assert d[..., 4 + nc:].max() < 1e-4 * coef_scale, (d[..., 4 + nc:].max(), coef_scale)
    np.testing.assert_allclose(ot["mask_coefs"].numpy(), oj["mask_coefs"],
                               atol=1e-4 * coef_scale)
    proto, jproto = _from_port(ot["proto"], "nhwc"), oj["proto"]
    assert proto.shape == jproto.shape == (2, 16, 16, nm)
    np.testing.assert_allclose(proto, jproto, atol=1e-4 * np.abs(jproto).max())
    sc = pred[..., 4:4 + nc]
    assert 0.01 < sc.min() and sc.max() < 0.99  # not saturated
    assert np.abs(pred[0, :, :4] - pred[1, :, :4]).max() > MIN_SPREAD
    # the cropped sigmoid masks of the 20 best anchors, both cropped to JAX's boxes
    top = np.argsort(-jpred[..., 4:4 + nc].max(-1), axis=1, kind="stable")[:, :20]
    box = np.take_along_axis(jpred[..., :4], top[..., None], 1)
    xyxy = np.concatenate([box[..., :2] - box[..., 2:] / 2, box[..., :2] + box[..., 2:] / 2], -1)

    def masks(p, pr):
        c = np.take_along_axis(p[..., 4 + nc:], top[..., None], 1)
        m = 1 / (1 + np.exp(-np.einsum("bhwn,bdn->bdhw", pr.astype(np.float64), c)))
        return np.stack([np.asarray(jboxes.crop_mask(jnp.asarray(mi, jnp.float32),
                                                     jnp.asarray(bi * 16 / 64)))
                         for mi, bi in zip(m, xyxy)])

    mt, mj = masks(pred, proto), masks(jpred, jproto)
    assert np.abs(mt - mj).max() < 1e-4
    off = (mt > 0.5) != (mj > 0.5)
    assert not off.any() or np.abs(mj[off] - 0.5).max() < 1e-4
