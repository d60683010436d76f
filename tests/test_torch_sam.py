"""SAM, MobileSAM's TinyViT and the SAM facade in the PyTorch port against
the JAX package (edgeyolo_tpu/nn/sam.py, nn/tinyvit.py, engine/sam.py), on
the CPU in f32.

- A ViT encoder small enough for the CPU (dim 64, depth 4, 4 heads, global
  blocks 1 and 3, 128 px: an 8 x 8 grid in 14 x 14 windows, so the padding
  runs), with JAX's variables (shapes from `jax.eval_shape`) filled from a
  seeded generator, every one away from its init (the positions and
  relative tables included), carried in by
  `from_jax_variables` (every JAX variable mapped; the port has the mask stem
  besides, which JAX creates only when a mask is given): the encoding, the
  prompt encoder (points with labels -1 to 3, and a mask prompt), the mask
  decoder and SAMModel's masks and IoU predictions, each within 1e-5 of
  its largest magnitude.
- At full width (the port on the meta device, JAX's shapes from
  `jax.eval_shape`) ViT-B maps every JAX variable onto the port's names and
  exact shapes, ViT-L and ViT-H by name and size; `sam2*` raises as JAX's.
- TinyViT: the reference's own state_dict (`tests/.cache/ref_mobile_sam.npz`)
  loads strictly and gives the reference's embedding at JAX's tolerance
  (atol 2e-4, rtol 1e-3); JAX's variables carried in give JAX's embedding
  within 1e-5 of its scale; 5,743,892 parameters.
- The facade, on the small model in both packages: `set_image` (a 200 x 300
  image shrunk to 128 px by jax.image.resize's antialiased rule), point, box
  and multimask prompts: IoU predictions within 1e-4, masks equal except
  where JAX's logit, resized to the image, lies within 1e-4 of 0;
  `grid_generate` on the same prompt outputs (synthetic discs; a random
  model's masks all span the grid) keeps the same masks, boxes, IoUs and
  stability scores, with and without the small-region repair, and on the
  small model through both facades the same survivor (boxes 1e-4, masks
  within 0.1% of pixels); `remove_small_regions` equals JAX's exactly.
"""

import math
from pathlib import Path

import jax
import jax.image as jimg
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

import edgeyolo_tpu_torch
from edgeyolo_tpu.engine import sam as jsam
from edgeyolo_tpu.nn import sam as jnsam
from edgeyolo_tpu.nn import tinyvit as jtinyvit
from edgeyolo_tpu_torch.engine import sam
from edgeyolo_tpu_torch.nn import sam as nsam
from edgeyolo_tpu_torch.nn.tinyvit import TinyViT
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

IMG = 128
SMALL = {"img_size": IMG, "encoder_dim": 64, "encoder_depth": 4, "encoder_heads": 4,
         "global_idx": (1, 3)}
REF = Path(__file__).parent / ".cache" / "ref_mobile_sam.npz"


_UNIT = {"pe_gaussian", "point_embeddings", "not_a_point_embed", "no_mask_embed", "iou_token",
         "mask_tokens"}


def _filled(shapes, seed=0):
    """JAX variable shapes (flattened) filled from a seeded generator: kernels
    U(+-1/sqrt(fan_in)) x 1.5, LayerNorm and BatchNorm scales 1 + N(0, 0.1),
    running variances U(0.5, 1.5), the embeddings and the Fourier matrix
    N(0, 1), the rest (biases, running means, positions, relative and
    attention-bias tables) N(0, 0.1): every variable away from its init."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, sh in shapes.items():
        shape, leaf = tuple(sh.shape), k[-1]
        if leaf == "kernel":
            b = float(np.prod(shape[:-1])) ** -0.5
            a = rs.uniform(-b, b, shape) * 1.5
        elif leaf == "var":
            a = rs.uniform(0.5, 1.5, shape)
        elif leaf == "scale":
            a = 1.0 + rs.randn(*shape) * 0.1
        elif leaf in _UNIT:
            a = rs.randn(*shape)
        else:
            a = rs.randn(*shape) * 0.1
        out[k] = np.asarray(a, np.float32)
    return out


def _shapes(init, *args):
    return traverse_util.flatten_dict(jax.eval_shape(lambda: init(jax.random.PRNGKey(0), *args)))


def assert_close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, (err, scale)


def _inputs():
    rs = np.random.RandomState(1)
    x = rs.randn(2, IMG, IMG, 3).astype(np.float32)
    pts = rs.rand(2, 5, 2).astype(np.float32)
    labels = np.array([[1, 0, 2, 3, -1], [3, 2, 1, 1, 0]], np.int32)
    return x, pts, labels


@pytest.fixture(scope="module")
def small():
    """JAX's small SAMModel and its moved variables, the port's with them."""
    jm = jnsam.SAMModel(**SMALL)
    x, pts, labels = _inputs()
    flat = _filled(_shapes(jm.init, jnp.asarray(x[:1]), jnp.asarray(pts[:1]),
                           jnp.asarray(labels[:1])))
    pm = nsam.SAMModel(**SMALL).eval()
    missing, unexpected = pm.load_state_dict(from_jax_variables(flat), strict=False)
    assert not unexpected
    assert missing and all(k.startswith("prompt_encoder.mask_downscaling.") for k in missing)
    return jm, traverse_util.unflatten_dict(flat), pm


def test_encoder_matches_jax(small):
    jm, v, pm = small
    x, _, _ = _inputs()
    want = jax.jit(lambda v, a: jm.apply(v, a, method="encode"))(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm.encode(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 256, IMG // 16, IMG // 16)
    assert_close(got.transpose(0, 2, 3, 1), want)


def test_prompt_and_mask_decoder_match_jax(small):
    jm, v, pm = small
    x, pts, labels = _inputs()
    emb = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, method="encode"))(v, jnp.asarray(x)))
    wm, wi = jax.jit(lambda v, e, p, lab: jm.apply(v, e, p, lab, method="prompt"))(
        v, jnp.asarray(emb), jnp.asarray(pts), jnp.asarray(labels))
    with torch.no_grad():
        gm, gi = pm.prompt(torch.from_numpy(emb).permute(0, 3, 1, 2), torch.from_numpy(pts),
                           torch.from_numpy(labels))
    assert gm.shape == (2, 4, IMG // 4, IMG // 4) and gi.shape == (2, 4)
    assert_close(gm.numpy(), wm)
    assert_close(gi.numpy(), wi)


def test_prompt_encoder_with_a_mask_matches_jax():
    g = IMG // 16
    _, pts, labels = _inputs()
    masks = np.random.RandomState(2).randn(2, 4 * g, 4 * g, 1).astype(np.float32)
    je = jnsam.PromptEncoder(grid=g)
    flat = _filled({("params", "prompt_encoder", *k[1:]): a for k, a in _shapes(
        je.init, jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(masks)).items()})
    want = jax.jit(je.apply)(traverse_util.unflatten_dict(
        {("params", *k[2:]): a for k, a in flat.items()}), jnp.asarray(pts),
        jnp.asarray(labels), jnp.asarray(masks))
    pe = nsam.PromptEncoder(grid=g).eval()
    missing, unexpected = pe.load_state_dict(
        {k.removeprefix("prompt_encoder."): t for k, t in from_jax_variables(flat).items()},
        strict=False)
    assert missing == ["no_mask_embed.weight"] and not unexpected
    with torch.no_grad():
        sparse, dense, dense_pe = pe(torch.from_numpy(pts), torch.from_numpy(labels),
                                     torch.from_numpy(masks).permute(0, 3, 1, 2))
    assert_close(sparse.numpy(), want[0])
    assert_close(dense.numpy().transpose(0, 2, 3, 1), want[1])
    assert_close(dense_pe.numpy().transpose(1, 2, 0), want[2])


def test_vit_b_maps_every_jax_variable_and_variants_by_name_and_size():
    """At full width, the port built on the meta device and JAX's shapes from
    `jax.eval_shape`: ViT-B's variables carried over land on the port's
    names with the port's exact shapes; ViT-L's and ViT-H's by name and
    size (their values would take gigabytes)."""
    for variant in ("vit_b", "vit_l", "vit_h"):
        jm = jnsam.build_sam(variant)
        shapes = jax.eval_shape(lambda m=jm: m.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1024, 3)), jnp.zeros((1, 1, 2)),
            jnp.zeros((1, 1), jnp.int32)))
        flat = traverse_util.flatten_dict(shapes)
        with torch.device("meta"):
            pm = nsam.SAMModel(*((1024,) + nsam._VARIANTS[variant]))
        own = dict(pm.state_dict())
        if variant == "vit_b":  # true shapes: every layout transform lands
            keys = from_jax_variables({k: np.zeros(s.shape, np.float32) for k, s in flat.items()})
            assert all(keys[k].shape == own[k].shape for k in keys if k in own)
        else:  # one to four entries an axis: names and sizes
            keys = from_jax_variables({k: np.zeros(tuple(min(d, 4) for d in s.shape), np.float32)
                                       for k, s in flat.items()})
        missing = sorted(set(own) - set(keys))
        unexpected = sorted(set(keys) - set(own))
        assert sum(own[k].numel() for k in keys if k in own) == sum(
            math.prod(s.shape) for s in flat.values())
        assert not unexpected, unexpected[:5]
        assert missing and all(k.startswith("prompt_encoder.mask_downscaling.") for k in missing)
        assert len(pm.image_encoder.blocks) == nsam._VARIANTS[variant][1]
    for mod in (jnsam, nsam):
        with pytest.raises(ValueError, match="SAM2"):
            mod.build_sam("sam2_t")
    assert nsam.build_sam("mobile_sam", img_size=IMG).mobile


def test_tinyvit_loads_the_reference_state_dict_and_matches_it():
    z = np.load(REF)
    m = TinyViT().eval()
    assert sum(p.numel() for p in m.parameters()) == 5_743_892
    m.load_state_dict({k.removeprefix("image_encoder."): torch.from_numpy(z[k])
                       for k in z.files if not k.startswith("__")}, strict=True)
    with torch.no_grad():
        emb = m(torch.from_numpy(z["__input__"])).numpy()
    np.testing.assert_allclose(emb, z["__emb__"], atol=2e-4, rtol=1e-3)


def test_tinyvit_matches_jax():
    x = np.random.RandomState(3).rand(1, IMG, IMG, 3).astype(np.float32)
    jmod = jtinyvit.TinyViT()
    flat = _filled({(k[0], "image_encoder", *k[1:]): a
                    for k, a in _shapes(jmod.init, jnp.asarray(x)).items()})
    want = jax.jit(jmod.apply)(traverse_util.unflatten_dict(
        {(k[0], *k[2:]): a for k, a in flat.items()}), jnp.asarray(x))
    m = TinyViT().eval()
    m.load_state_dict({k.removeprefix("image_encoder."): t
                       for k, t in from_jax_variables(flat).items()}, strict=False)
    missing = [k for k in m.state_dict() if not k.endswith("num_batches_tracked")]
    assert len(missing) == len(flat)  # every JAX variable lands, nothing else is missing
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert_close(got.transpose(0, 2, 3, 1), want)


@pytest.fixture(scope="module")
def facades(small):
    """JAX's and the port's SAM facades over the small model's weights."""
    jm, v, pm = small
    jf = jsam.SAM.__new__(jsam.SAM)
    jf.img_size, jf.net, jf.variables, jf._embed, jf._hw = IMG, jm, v, None, None
    jf._encode = jax.jit(lambda v, x: jm.apply(v, x, method="encode"))
    jf._prompt = jax.jit(lambda v, e, p, lab: jm.apply(v, e, p, lab, method="prompt"))
    pf = sam.SAM.__new__(sam.SAM)
    pf.device, pf.img_size, pf.net, pf._embed, pf._hw = torch.device("cpu"), IMG, pm, None, None
    img = (np.random.RandomState(0).rand(200, 300, 3) * 255).astype(np.uint8)
    jf.set_image(img)
    pf.set_image(img)
    return jf, pf, img


def _jax_logit(jf, pts01, labels, multimask):
    """JAX's prompt logit resized to the image (the value its mask cuts at 0)."""
    h, w = jf._hw
    masks, iou = jf._prompt(jf.variables, jf._embed, jnp.asarray(pts01)[None],
                            jnp.asarray(labels)[None])
    best = int(jnp.argmax(iou[0, 1:])) + 1 if multimask else 0
    return np.asarray(jimg.resize(masks[0, best], (h, w), method="bilinear"))


@pytest.mark.parametrize("prompt", ["point", "box", "multimask"])
def test_facade_prompts_match_jax(facades, prompt):
    jf, pf, img = facades
    assert_close(pf._embed.numpy().transpose(0, 2, 3, 1), jf._embed)
    h, w = img.shape[:2]
    kw = {"point": {"points": [[150, 100], [40, 170]], "labels": [1, 0]},
          "box": {"bboxes": [50, 40, 250, 160]},
          "multimask": {"points": [[150, 100]], "labels": [1], "multimask_output": True}}[prompt]
    gm, gi = pf(**kw)
    wm, wi = jf(**kw)
    assert gm.shape == (1, h, w) and gm.dtype == bool and gi.shape == (1,)
    np.testing.assert_allclose(gi, wi, atol=1e-4, rtol=0)
    if prompt == "box":
        pts01, labels = np.array([[50 / w, 40 / h], [250 / w, 160 / h]]), np.array([2, 3])
    else:
        pts01 = np.asarray(kw["points"], np.float32) / [w, h]
        labels = np.asarray(kw["labels"])
    logit = _jax_logit(jf, pts01.astype(np.float32), labels.astype(np.int32),
                       prompt == "multimask")
    differ = gm[0] != np.asarray(wm)[0]
    assert not differ[np.abs(logit) > 1e-4].any()
    assert 0 < gm.sum() < gm.size or differ.sum() == 0


def _blobs(pts01):
    """Synthetic multimask logits (B, 3, 32, 32) and IoUs (B, 3) of point
    prompts: three discs about each point (radii 0.12, 0.22, 0.32 of the
    side) with a seeded ripple, and IoUs from the point's position."""
    pts01 = np.asarray(pts01, np.float32)
    ys, xs = np.meshgrid((np.arange(32) + 0.5) / 32, (np.arange(32) + 0.5) / 32, indexing="ij")
    d2 = (xs[None] - pts01[:, :1, None]) ** 2 + (ys[None] - pts01[:, 1:, None]) ** 2
    ripple = np.sin(xs * 13.0 + ys * 7.0)[None] * 0.3
    logits = np.stack([(r * r - d2) * 60 + ripple for r in (0.12, 0.22, 0.32)], 1)
    ious = 0.7 + 0.25 * np.sin(pts01[:, :1] * 9 + pts01[:, 1:] * 5 + np.arange(3))
    return logits.astype(np.float32), ious.astype(np.float32)


class _JaxBlobs:
    def set_image(self, img):
        return self

    def _prompt_batch(self, pts01):
        logits, ious = _blobs(pts01)
        return jnp.asarray(logits), jnp.asarray(ious)


class _PortBlobs(_JaxBlobs):
    device = torch.device("cpu")

    def _prompt_batch(self, pts01):
        logits, ious = _blobs(pts01)
        return torch.from_numpy(logits), torch.from_numpy(ious)


@pytest.mark.parametrize("min_area", [0, 40])
def test_grid_generate_keeps_the_same_masks_and_boxes(facades, min_area):
    """The sweep's filters, boxes, NMS, small-region repair and resize on
    the same prompt outputs (synthetic discs: a random model's masks cover
    the whole grid), then on the small model through both facades."""
    jf, pf, img = facades
    kw = {"points_per_side": 6, "points_per_batch": 16, "pred_iou_thresh": 0.6,
          "stability_thresh": 0.5, "nms_iou": 0.5, "min_area": min_area}
    got = sam.grid_generate(_PortBlobs(), img, **kw)
    want = jsam.grid_generate(_JaxBlobs(), img, **kw)
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert g["bbox"] == w["bbox"] and g["predicted_iou"] == w["predicted_iou"]
        assert g["stability_score"] == w["stability_score"]
        assert np.array_equal(g["segmentation"], w["segmentation"])
    # the small random model through the facades, every candidate through
    # the filters: its masks span the grid, so few survive the NMS
    kw = {"points_per_side": 8, "points_per_batch": 24, "pred_iou_thresh": -1e9,
          "stability_thresh": -1.0, "stability_offset": 0.05, "nms_iou": 0.5}
    got, want = pf.generate(img, **kw), jsam.grid_generate(jf, img, **kw)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-4)
        assert abs(g["predicted_iou"] - w["predicted_iou"]) < 1e-4
        assert abs(g["stability_score"] - w["stability_score"]) < 1e-2
        assert (g["segmentation"] != w["segmentation"]).mean() < 1e-3


def test_remove_small_regions_equals_jax():
    rs = np.random.RandomState(4)
    m = np.zeros((4, 32, 32), bool)
    m[0, 4:28, 4:28] = True
    m[0, 10:12, 10:12] = False  # a 4 px hole
    m[0, 0, 0] = True  # a 1 px island
    m[1, 4:28, 4:28] = True  # mask 0's body, untouched
    m[2, 2:6, 20:30] = True
    m[3] = rs.rand(32, 32) > 0.6  # many small parts
    for min_area in (0, 5, 16):
        got, gk = sam.remove_small_regions(m.copy(), min_area=min_area, nms_thresh=0.7)
        want, wk = jsam.remove_small_regions(m.copy(), min_area=min_area, nms_thresh=0.7)
        assert gk == wk and np.array_equal(got, want)
    assert sam.remove_small_regions(np.zeros((0, 8, 8), bool))[1] == []


def test_facade_names_and_pt_refusal():
    assert edgeyolo_tpu_torch.SAM is sam.SAM
    with pytest.raises(NotImplementedError):
        sam.SAM("sam_b.pt", device="cpu")
    if not torch.cuda.is_available():  # an entry point needs a card unless told the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            sam.SAM("vit_b", img_size=IMG)
