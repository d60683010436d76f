"""The SAM2 facades of the PyTorch port (edgeyolo_tpu_torch/engine/sam2.py)
against JAX's (edgeyolo_tpu/engine/sam2.py) on the small model of
tests/torch_sam2_common.py, the same weights in both, on the CPU in f32.

- SAM2: `set_image` of a 150 x 100 image (resized to 128 px by
  jax.image.resize's bilinear rule) gives JAX's features within 1e-5 of
  their scale; point (labels 1 and 0, the +0.5 pixel-centre shift), box
  (corners unshifted) and multimask prompts give JAX's IoUs within 1e-4 and
  its masks except where JAX's logit, resized to the image, lies within
  1e-4 of 0; `grid_generate` with every candidate let through keeps JAX's
  masks (boxes 1e-4, IoUs 1e-4, masks within 0.1% of pixels).
- SAM2VideoPredictor with num_maskmem 3 and max_obj_ptrs 4, so the bank
  ramps and then holds within the 6 frames of a moving disc: frame by frame
  the memory and positions each frame attends to within 1e-5 of their scale
  and the same number of pointer tokens, scores within 1e-4, low-resolution
  logits within 1e-4 of their scale, masks as above, and the same
  conditioning and non-conditioning frames; the bank stays on the model's
  device as tensors. The encoded-frame cache evicts as JAX's does (8 frames).
- The facades' names, the `.pt` refusal, and no CPU fallback without a card.
"""

import jax
import jax.image as jimg
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_sam2_common import IMG, assert_close, nhwc, small_pair
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.engine import sam as jsam
from edgeyolo_tpu.engine import sam2 as jsam2
from edgeyolo_tpu_torch.engine import sam2

MASKMEM, PTRS = 3, 4


def _jax_facades(jm, v):
    jf = jsam2.SAM2.__new__(jsam2.SAM2)
    jf.img_size, jf.net, jf.variables, jf._enc_out, jf._hw = IMG, jm, v, None, None
    jf._encode = jax.jit(lambda v, x: jm.apply(v, x, method="encode_image"))
    jf._heads = jax.jit(lambda v, *a: jm.apply(v, *a, multimask_output=True, method="sam_heads"))
    jv = jsam2.SAM2VideoPredictor.__new__(jsam2.SAM2VideoPredictor)
    jv.sam, jv.net, jv.variables = jf, jm, v
    jv.num_maskmem, jv.max_obj_ptrs = MASKMEM, PTRS
    jv._heads_single = jax.jit(
        lambda v, *a: jm.apply(v, *a, multimask_output=False, method="sam_heads"))
    jv._heads_multi = jf._heads
    jv._condition = jax.jit(lambda v, f, pos, mem, mpos, nptr: jm.apply(
        v, f, pos, mem, mpos, nptr, method="condition_features"), static_argnums=(5,))
    jv._encode_mem = jax.jit(lambda v, f, hi, ol: jm.apply(v, f, hi, ol, method="encode_memory"))
    jv._tpos = jax.jit(lambda v, p: jm.apply(v, p, method="tpos_ptr"))
    jv.reset()
    return jf, jv


def _port_facades(pm):
    pf = sam2.SAM2.__new__(sam2.SAM2)
    pf.device, pf.img_size, pf.net, pf._enc, pf._hw = torch.device("cpu"), IMG, pm, None, None
    pv = sam2.SAM2VideoPredictor.__new__(sam2.SAM2VideoPredictor)
    pv.sam, pv.net, pv.device = pf, pm, pf.device
    pv.num_maskmem, pv.max_obj_ptrs = MASKMEM, PTRS
    pv.reset()
    return pf, pv


@pytest.fixture(scope="module")
def facades():
    jm, v, pm = small_pair()
    jf, jv = _jax_facades(jm, v)
    pf, pv = _port_facades(pm)
    img = (np.random.RandomState(0).rand(100, 150, 3) * 255).astype(np.uint8)
    jf.set_image(img)
    pf.set_image(img)
    return jf, jv, pf, pv, img


def _assert_masks(got, logit):
    """Masks equal but where JAX's logit is within 1e-4 of the cut."""
    differ = got != (logit > 0.0)
    assert not differ[np.abs(logit) > 1e-4].any()


def test_set_image_matches_jax(facades):
    jf, _, pf, _, _ = facades
    for k in ("feat_s0", "feat_s1", "feat", "pos"):
        assert_close(nhwc(pf._enc[k]), jf._enc_out[k])


@pytest.mark.parametrize("prompt", ["point", "box", "multimask"])
def test_prompts_match_jax(facades, prompt):
    jf, _, pf, _, img = facades
    h, w = img.shape[:2]
    kw = {"point": {"points": [[90, 40], [30, 70]], "labels": [1, 0]},
          "box": {"bboxes": [20, 15, 120, 80]},
          "multimask": {"points": [[90, 40]], "labels": [1], "multimask_output": True}}[prompt]
    gm, gi = pf(**kw)
    wm, wi = jf(**kw)
    assert gm.shape == (1, h, w) and gm.dtype == bool and gi.shape == (1,)
    np.testing.assert_allclose(gi, wi, atol=1e-4, rtol=0)
    if prompt == "box":
        pts, labels = np.array([[20 / w, 15 / h], [120 / w, 80 / h]], np.float32), [2, 3]
    else:
        pts = (np.asarray(kw["points"], np.float32) * [IMG / w, IMG / h] + 0.5) / IMG
        labels = kw["labels"]
    enc = jf._enc_out
    feat = enc["feat"] + jf.variables["params"]["no_mem_embed"][0, 0]
    low_multi, ious, low_res, *_ = jf._heads(
        jf.variables, feat, jnp.asarray(pts, jnp.float32)[None],
        jnp.asarray(labels, jnp.int32)[None], enc["feat_s0"], enc["feat_s1"])
    m = low_multi[0, int(jnp.argmax(ious[0]))] if prompt == "multimask" else low_res[0, 0]
    _assert_masks(gm[0], np.asarray(jimg.resize(m, (h, w), method="bilinear")))
    assert 0 < gm.sum() < gm.size


def test_prompt_batch_stays_on_the_device(facades):
    _, _, pf, _, _ = facades
    logits, ious = pf._prompt_batch(np.array([[0.2, 0.3], [0.7, 0.6]], np.float32))
    assert torch.is_tensor(logits) and logits.shape == (2, 3, IMG // 4, IMG // 4)
    assert ious.shape == (2, 3) and logits.device == pf.device


def test_grid_generate_keeps_the_same_masks(facades):
    """Every candidate through the filters (a random model's predicted IoUs
    sit near 0.5): the sweep, its boxes, NMS and resize through both facades."""
    jf, _, pf, _, img = facades
    kw = {"points_per_side": 6, "points_per_batch": 16, "pred_iou_thresh": -1e9,
          "stability_thresh": -1.0, "stability_offset": 0.05, "nms_iou": 0.5}
    got, want = pf.generate(img, **kw), jsam.grid_generate(jf, img, **kw)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-4)
        assert abs(g["predicted_iou"] - w["predicted_iou"]) < 1e-4
        assert abs(g["stability_score"] - w["stability_score"]) < 1e-2
        assert (g["segmentation"] != w["segmentation"]).mean() < 1e-3


def _frames(n=6, h=96, w=144):
    """A bright disc moving 8 px a frame over a fixed noise background."""
    rs = np.random.RandomState(3)
    bg = rs.randint(0, 60, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    out = []
    for i in range(n):
        img = bg.copy()
        img[(yy - 48) ** 2 + (xx - 40 - 8 * i) ** 2 < 18 ** 2] = (230, 60, 60)
        out.append(img)
    return out


def test_video_predictor_matches_jax_frame_by_frame(facades):
    _, jv, _, pv, _ = facades
    frames = _frames()
    h, w = frames[0].shape[:2]
    jv.init_state(frames)
    pv.init_state(frames)
    gm0, gs0 = pv.add_points(0, points=[[40, 48]], labels=[1])
    wm0, ws0 = jv.add_points(0, points=[[40, 48]], labels=[1])
    assert abs(gs0 - ws0) < 1e-4
    n_ptr_tokens = []
    gen_p, gen_j = pv.propagate(), jv.propagate()
    for fidx in range(len(frames)):
        if fidx:  # the bank frame fidx attends to, before its step
            with torch.no_grad():
                gmem, gpos, gn = pv._assemble_memory(fidx)
            wmem, wpos, wn = jv._assemble_memory(fidx)
            assert gn == wn
            n_ptr_tokens.append(gn)
            assert_close(gmem.numpy(), wmem)
            assert_close(gpos.numpy(), wpos)
        gi, gmask, gscore = next(gen_p)
        wi, wmask, wscore = next(gen_j)
        assert gi == wi == fidx and gmask.shape == (h, w) and gmask.dtype == bool
        assert abs(gscore - wscore) < 1e-4
        grec = (pv.cond if fidx in pv.cond else pv.non_cond)[fidx]
        wrec = (jv.cond if fidx in jv.cond else jv.non_cond)[fidx]
        assert grec["low_res"].device == pv.device and torch.is_tensor(grec["maskmem"])
        assert_close(grec["low_res"].numpy(), wrec["low_res"], 1e-4)
        logit = np.asarray(jimg.resize(jnp.asarray(wrec["low_res"][0, 0]), (h, w), "bilinear"))
        _assert_masks(gmask, logit)
    assert sorted(pv.cond) == sorted(jv.cond) == [0]
    assert sorted(pv.non_cond) == sorted(jv.non_cond) == [1, 2, 3, 4, 5]
    # pointers: frame 0's, then up to PTRS - 1 previous frames, four tokens each
    assert n_ptr_tokens == [4, 8, 12, 16, 16]


def test_encoded_frame_cache_evicts_as_jax(facades):
    """Twelve frames stepped out of order through a counting encoder: the
    same frames cached at every step, never more than eight."""
    jf, jv, pf, pv, _ = facades
    order = [0, 1, 2, 3, 4, 5, 6, 7, 8, 2, 9, 11, 10, 0]
    got, want = [], []
    jv.reset()
    pv.reset()
    jv.frames = pv.frames = list(range(12))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf, "_encode", lambda v, x: x)
        mp.setattr(jf, "_preprocess", lambda frame: frame)
        mp.setattr(pf, "encode", lambda frame: frame)
        for fidx in order:
            assert pv._enc(fidx) == jv._enc(fidx) == fidx
            got.append(sorted(pv._enc_cache))
            want.append(sorted(jv._enc_cache))
    assert got == want and max(map(len, got)) == sam2.ENC_CACHE == 8


def test_facade_refusals():
    with pytest.raises(NotImplementedError):
        sam2.SAM2("sam2_t.pt", device="cpu")
    if not torch.cuda.is_available():  # an entry point needs a card unless told the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            sam2.SAM2("sam2_t", img_size=IMG)
        with pytest.raises(RuntimeError, match="CUDA"):
            sam2.SAM2VideoPredictor("sam2_t", img_size=IMG)
