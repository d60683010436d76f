"""The predictor's test-time augmentation, feature maps and annotated saves,
and `Results.plot`, of the port held against the JAX package on the CPU (f32,
the flagship at full width with test_torch_families.py's perturbation at
weight scale 2.0: its output depends on the image and its activations stay
under 3, where 2.5 sends the C2PSA stage past 4,000 at 160 px and f32
rounding past the tolerances).

- `capture` (GraphNet.forward): every layer's raw output within 1e-4 of
  JAX's `capture` at 64 px.
- The TTA resize against `jax.image.resize(..., "bilinear")`: f32 within
  2e-6 on the down-scales TTA runs and 1e-5 on up-scales, where JAX's own
  result is up to 7.6e-6 from an f64 evaluation of the same weights (the
  port's within 1e-6 of it); bf16 (weights and image in bf16, as the bf16
  serve runs it) within one bf16 step of the values (2^-8 absolute for
  values in [0, 1]).
- TTA detections at 160 px (canvases 160, 160 and 128: the last pass differs
  in shape) against JAX's `_build_infer_tta` with the same weights, clipped
  to the canvas as the port serves them: `assert_e2e_close`, boxes 1e-3 px,
  scores 1e-4. An NMS-free head: JAX's TTA reads its class ids as scores
  (ROADMAP C.13); the port warns and serves single-scale.
- `visualize`: one PNG per layer but the head whose output JAX's
  `feature_visualization` would draw (4-D, no side of 1), named as JAX's.
- `plot`: equal to JAX's PIL drawing outside both packages' label bands,
  band heights within 2 px, at three image sizes, with and without track
  ids; `save` and `save_txt` per frame.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw, ImageFont
from test_torch_e2e import assert_e2e_close
from test_torch_families import _jax_template, _perturb
from torch_family_checks import to_jax
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.cfg import get_cfg as jget_cfg
from edgeyolo_tpu.engine.predictor import DetectionPredictor as JPredictor
from edgeyolo_tpu.engine.results import Results as JResults
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu_torch.data.imageio import decode_jpeg, encode_jpeg, save_png
from edgeyolo_tpu_torch.data.synthetic import moving_shapes, write_mjpeg_avi
from edgeyolo_tpu_torch.engine import predictor as pred_mod
from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
from edgeyolo_tpu_torch.engine.results import Results
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.utils.plotting import BitmapFont

TTA_SZ = 160


@pytest.fixture(scope="module")
def flag():
    pm = DetectionModel("edgeline-yolo.yaml", device="cpu")
    sd = _perturb(pm.state_dict(), 2.0)
    pm.load_state_dict(sd)
    jm = jtasks.DetectionModel("edgeline-yolo.yaml")
    variables, _ = to_jax(pm, sd, _jax_template(jm))
    return pm, jm, jax.tree.map(jnp.asarray, variables)


def _imgs(n, s, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (n, s, s, 3)).astype(np.uint8)


def test_capture_equals_jax(flag):
    pm, jm, v = flag
    imgs = _imgs(2, 64)
    idx = [sp.i for sp in pm.layers[:-1]]
    jout, jcap = jax.jit(lambda v, x: jm.apply(v, x, train=False, capture=idx))(
        v, jnp.asarray(imgs, jnp.float32) / 255)
    with torch.no_grad():
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255
        out, cap = pm(x, capture=idx)
        plain = pm(x)
    assert sorted(cap) == sorted(jcap) == idx
    for i in idx:
        np.testing.assert_allclose(cap[i].numpy(), np.asarray(jcap[i]).transpose(0, 3, 1, 2),
                                   atol=1e-4, rtol=0, err_msg=f"layer {i}")
    torch.testing.assert_close(out["pred"], plain["pred"], rtol=0, atol=0)  # the same forward
    np.testing.assert_allclose(out["pred"].numpy(), np.asarray(jout["pred"]), atol=5e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_equals_jax_image_resize(dtype):
    x = np.random.RandomState(0).rand(2, 3, TTA_SZ, TTA_SZ).astype(np.float32)
    for size in ((132, 132), (107, 107), (101, 77), (200, 90)):
        want = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1), dtype),
                                           (2, *size, 3), method="bilinear"), np.float32)
        got = pred_mod.resize_bilinear(torch.from_numpy(x).to(getattr(torch, dtype)), size)
        assert got.dtype == getattr(torch, dtype)
        got = got.float().numpy().transpose(0, 2, 3, 1)
        d = np.abs(got - want).max()
        if dtype == "bfloat16":
            assert d <= 2 ** -8, (size, d)
            continue
        assert d <= (1e-5 if max(size) > TTA_SZ else 2e-6), (size, d)
        exact = np.einsum("bchw,hH,wW->bHWc", x.astype(np.float64),
                          *(pred_mod.resize_weights(TTA_SZ, n).double().numpy() for n in size))
        assert np.abs(got - exact).max() <= 1e-6


def test_tta_detections_equal_jax(flag):
    pm, jm, v = flag
    imgs = _imgs(2, TTA_SZ, seed=4)
    conf = 0.25
    jargs = jget_cfg(overrides={"mode": "predict", "augment": True, "conf": conf, "save": False})
    jdet, jn = JPredictor(jargs)._build_infer_tta(jm, conf)(v, jnp.asarray(imgs, jnp.float32) / 255)
    jdet = np.array(jdet)
    jdet[..., 0:4:2] = jdet[..., 0:4:2].clip(0, TTA_SZ)
    jdet[..., 1:4:2] = jdet[..., 1:4:2].clip(0, TTA_SZ)
    predictor = DetectionPredictor(pm, conf=conf, device="cpu", imgsz=TTA_SZ, augment=True)
    det, n = predictor(imgs)
    assert n.tolist() == np.asarray(jn).tolist() and min(n.tolist()) > 5
    assert_e2e_close(det.numpy(), jdet)
    plain, _ = DetectionPredictor(pm, conf=conf, device="cpu", imgsz=TTA_SZ)(imgs)
    assert not torch.equal(det, plain)  # the augmented passes changed the detections


def test_tta_canvases_and_tails(flag, monkeypatch):
    """Three passes at 160, 160 and 128 px (the second flipped), the full
    scale's P5 and the smallest scale's P3 anchors dropped."""
    pm = flag[0]
    seen = []
    fwd = pm.forward

    def spy(x, capture=None):
        seen.append(tuple(x.shape[2:]))
        return fwd(x, capture)

    monkeypatch.setattr(pm, "forward", spy)
    predictor = DetectionPredictor(pm, conf=0.25, device="cpu", imgsz=TTA_SZ, augment=True)
    x = predictor._input(_imgs(1, TTA_SZ))
    with torch.no_grad():
        pred = predictor._tta_pred(x)
    assert seen == [(160, 160), (160, 160), (128, 128)]
    assert pred.shape[1] == (525 - 25) + 525 + (336 - 256)


def test_e2e_head_serves_single_scale_where_jax_reads_ids_as_scores():
    from torch_family_checks import build_family

    fam = build_family("yolov10n.yaml", "", 1.0)
    jm = jtasks.DetectionModel("yolov10n.yaml")
    imgs = _imgs(2, 64)
    jargs = jget_cfg(overrides={"mode": "predict", "augment": True, "conf": 0.25, "save": False})
    jdet, jn = JPredictor(jargs)._build_infer(jm, 0.25)(
        jax.tree.map(jnp.asarray, fam["variables"]), jnp.asarray(imgs, jnp.float32) / 255)
    jdet = np.asarray(jdet)
    assert (jdet[..., 4][np.arange(jdet.shape[1])[None] < np.asarray(jn)[:, None]] > 1).any()
    tta = DetectionPredictor(fam["pm"], conf=0.25, device="cpu", imgsz=64, augment=True)
    assert not tta.augment
    single = DetectionPredictor(fam["pm"], conf=0.25, device="cpu", imgsz=64)
    for a, b in zip(tta(imgs), single(imgs)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_visualize_writes_jax_named_feature_maps(flag, tmp_path):
    pm, jm, v = flag
    frame = _imgs(1, 64)[0]
    p = DetectionPredictor(pm, conf=0.25, device="cpu", imgsz=64, visualize=True, save=False,
                           save_dir=tmp_path)
    (res,) = p.predict([frame])
    assert res.path == "image0"
    idx = tuple(sp.i for sp in jm.spec[:-1])
    _, feats = jax.eval_shape(lambda x: jm.apply(v, x, train=False, capture=idx),
                              jnp.asarray(frame[None], jnp.float32))
    want = {f"stage{sp.i}_{sp.name}_features.png" for sp in jm.spec[:-1]
            if hasattr(feats[sp.i], "ndim") and len(feats[sp.i].shape) == 4
            and 1 not in feats[sp.i].shape[1:3]}
    got = {f.name for f in (tmp_path / "image0").iterdir()}
    assert got == want and len(got) > 15
    grid = decode_png_file(tmp_path / "image0" / "stage0_Conv_features.png")
    assert grid.ndim == 3 and grid.shape[2] == 3 and (grid[..., 0] == grid[..., 1]).all()


def decode_png_file(path):
    from edgeyolo_tpu_torch.data.imageio import load_image_rgb

    return load_image_rgb(path)


# -- plot and save ---------------------------------------------------------------------
def _boxes(rs, n, h, w, nc=25):
    x1, y1 = rs.uniform(-5, w * 0.8, n), rs.uniform(-5, h * 0.8, n)
    return np.stack([x1, y1, x1 + rs.uniform(5, w / 2, n), y1 + rs.uniform(5, h / 2, n),
                     rs.uniform(0, 1, n), rs.randint(0, nc, n)], 1).astype(np.float32)


def _bands(rows, names, h, w, track):
    """Both packages' label bands, as a mask of the pixels they may cover,
    and their heights (JAX's PIL font, the port's bitmap font)."""
    lw = max(round((w + h) / 2 * 0.003), 2)
    size = max(12, lw * 4)
    pil_font, font = ImageFont.load_default(size=size), BitmapFont(size)
    draw = ImageDraw.Draw(Image.new("RGB", (w, h)))
    mask, heights = np.zeros((h, w), bool), []
    for r in rows:
        name = names[int(r[-1])]
        if track:
            name = f"id:{int(r[4])} {name}"
        label = f"{name} {r[-2]:.2f}"
        jb = draw.textbbox((float(r[0]), float(r[1])), label, font=pil_font)
        pb = [v + o for v, o in zip(font.getbbox(label), (r[0], r[1], r[0], r[1]))]
        heights.append((int(jb[3]) - int(jb[1] - 2), int(pb[3]) - int(pb[1] - 2)))
        for tb in (jb, pb):
            x0, y0, x1, y1 = int(tb[0]), int(tb[1] - 2), int(tb[2] + 2), int(tb[3])
            mask[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = True
    return mask, heights


@pytest.mark.parametrize("hw", [(120, 200), (720, 1280), (64, 64)], ids=str)
@pytest.mark.parametrize("track", [False, True], ids=["boxes", "tracks"])
def test_plot_equals_jax_outside_the_label_bands(hw, track):
    h, w = hw
    rs = np.random.RandomState(h)
    img = rs.randint(0, 255, (h, w, 3)).astype(np.uint8)
    rows = _boxes(rs, 6, h, w)
    if track:
        rows = np.insert(rows, 4, np.arange(1, 7), axis=1)
    names = {i: f"cls{i}" for i in range(25)}
    got, want = Results(img, "x", names, boxes=rows).plot(), JResults(img, "x", names, boxes=rows).plot()
    mask, heights = _bands(rows, names, h, w, track)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got[~mask], want[~mask])
    assert all(abs(a - b) <= 2 for a, b in heights), heights
    assert (got[mask] != img[mask]).any()  # labels were drawn
    for kw in ({"labels": False}, {"line_width": 5, "conf": False}):
        g, j = Results(img, "x", names, boxes=rows).plot(**kw), \
            JResults(img, "x", names, boxes=rows).plot(**kw)
        if kw.get("labels") is False:
            np.testing.assert_array_equal(g, j)
        else:
            assert (g != j).any(-1).sum() <= mask.sum() * 2


def test_save_writes_one_image_per_frame(flag, tmp_path):
    pm = flag[0]
    frames = list(moving_shapes(3, 48, 64, seed=1)[0])
    src = tmp_path / "src"
    src.mkdir()
    save_png(src / "still.png", frames[0])
    write_mjpeg_avi(src / "line.avi", frames)
    out = tmp_path / "out"
    p = DetectionPredictor(pm, conf=0.25, device="cpu", imgsz=64, batch=2, save=True,
                           save_txt=True, save_dir=out, line_width=3, show_conf=False)
    res = p.predict(str(src))
    names = sorted(f.name for f in out.glob("*.jpg"))
    assert [r.path.rsplit("/", 1)[-1] for r in res] == ["still.png"] + [f"line.avi:{i}"
                                                                       for i in range(3)]
    assert names == ["line_0.jpg", "line_1.jpg", "line_2.jpg", "still.jpg"]
    for r in res:
        stem = pred_mod.frame_name(r.path)
        saved = (out / f"{stem}.jpg").read_bytes()
        assert saved == encode_jpeg(r.plot(line_width=3, conf=False), quality=75)
        assert decode_jpeg(saved).shape == r.orig_img.shape
        if len(r):
            assert (out / "labels" / f"{stem}.txt").read_text().count("\n") == len(r)
    assert all(len(r) for r in res)
    assert re.fullmatch(r"line_\d+", pred_mod.frame_name(f"{src}/line.avi:12")[:-1] + "2")
