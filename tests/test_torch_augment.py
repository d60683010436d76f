"""Training augmentation of the PyTorch port against the JAX package, on the CPU.

The two frameworks draw different random numbers, so the port splits
sampling from application: `jax_drawn_params` replays the JAX draw
structure of `_augment_impl` (its keys, folds and splits) and hands the
values to the port's `augment_apply`, whose output is then held against
JAX's `augment_batch` on the same key. Inputs come from a numpy seed at
64 px, batch 2 (the photometric subset formulation at batch 16).

Tolerances: img01 atol 1e-4 (bilinear taps of 0..255 pixels at inverse-map
coordinates that differ by f32 rounding, then /255), labels 1e-5; single
photometric ops on fixed images: median and gray 1e-6, CLAHE and JPEG
2/255 (max difference printed), box blur 5e-6 (ROADMAP §C: JAX's
cumulative-sum blur is itself 2.0e-6 off the exact value at 64 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgeyolo_tpu.data import augment_device as jaug
from edgeyolo_tpu.data import photometric as jphoto
from edgeyolo_tpu_torch.data import augment_device as aug
from edgeyolo_tpu_torch.data import photometric as photo
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

S, B, M = 64, 2, 6
IMG_ATOL, LABEL_ATOL = 1e-4, 1e-5
QUIET = {"hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "fliplr": 0.0, "photometric": 0.0,
         "mosaic": 1.0, "mixup": 0.0, "translate": 0.1, "scale": 0.5}
GATHER = {"degrees": 10.0, "shear": 3.0, "perspective": 0.0005}


def _batch(b=B, m=M, seed=0):
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 256, (b, S, S, 3)).astype(np.uint8)
    cls = rs.randint(0, 80, (b, m)).astype(np.float32)
    xy = rs.uniform(0.2, 0.8, (b, m, 2))
    wh = rs.uniform(0.1, 0.4, (b, m, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = (np.arange(m)[None] < rs.randint(1, m, (b, 1))).astype(np.float32)
    boxes *= mask[..., None]
    return imgs, cls, boxes, mask


def _photometric_draws(key, b, s):
    """JAX's photometric_batch / _rare_one / photometric_one draws as PhotometricParams."""
    prm = photo.PhotometricParams.empty(b)

    def rare(i, k, pscale):
        kp, kb, kc = jax.random.split(k, 3)
        p = np.asarray(jax.random.uniform(kp, (4,)))
        prm.blur_k[i] = 3 + 2 * int(jax.random.randint(kb, (), 0, 3))
        prm.clahe_clip[i] = float(jax.random.uniform(kc, (), minval=1.0, maxval=4.0))
        gates = p < np.float32([photo.P_BLUR, photo.P_MEDIAN, photo.P_GRAY, photo.P_CLAHE]) * pscale
        prm.blur[i], prm.median[i], prm.gray[i], prm.clahe[i] = (bool(g) for g in gates)

    if b <= 8:
        for i, ki in enumerate(jax.random.split(key, b)):
            kr, kp, kq = jax.random.split(ki, 3)
            rare(i, kr, 1.0)
            if s % 8 == 0:
                prm.jpeg_quality[i] = float(jax.random.uniform(kq, (), minval=75.0, maxval=100.0))
                prm.jpeg[i] = bool(jax.random.uniform(kp) < photo.P_JPEG)
        return prm
    k2, k4 = jax.random.split(key)
    stride = b // 8
    for j, kj in enumerate(jax.random.split(k2, 8)):
        rare(j * stride, kj, b / 8)
    nj = b // 2
    prm.jpeg[0:2 * nj:2] = True
    prm.jpeg_quality[0:2 * nj:2] = torch.from_numpy(np.array(
        jax.random.uniform(k4, (nj,), minval=75.0, maxval=100.0)))
    return prm


def jax_drawn_params(key, b, s, hyp, mosaic):
    """The values JAX's _augment_impl draws from `key`, as the port's AugParams."""
    n_src = 4 if mosaic else 1
    keys = jax.random.split(key, b * 4).reshape(b, 4, 2)
    part = np.asarray(jax.random.randint(jax.random.fold_in(key, 17), (b, n_src - 1), 1, b))
    sel = np.concatenate([np.arange(b)[:, None], (np.arange(b)[:, None] + part) % b], 1)
    center, affine = [], []
    for i in range(b):
        kc, ka = jax.random.split(keys[i, 0])
        center.append(np.asarray(jax.random.uniform(kc, (2,), minval=0.5 * s, maxval=1.5 * s)))
        affine.append(np.asarray(jaug._affine_params(ka, s, hyp)))
    gains = np.asarray([hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4)],
                       np.float32)
    hsv = None
    if gains.any():
        hsv = np.stack([np.asarray(jax.random.uniform(keys[i, 1], (3,), minval=-1.0, maxval=1.0))
                        for i in range(b)]) * gains + 1.0

    def gate(salt, p):
        u = jax.random.uniform(jax.random.fold_in(key, salt), (b,))
        return torch.from_numpy(np.array(u < p))

    pud, pmix, pbgr = hyp.get("flipud", 0.0), hyp.get("mixup", 0.0), hyp.get("bgr", 0.0)
    lam = None
    if pmix > 0:
        lam = torch.from_numpy(np.array(jax.random.beta(jax.random.fold_in(key, 41), 32.0, 32.0,
                                                        (b,))))
    return aug.AugParams(
        sel=torch.from_numpy(sel).long(), center=torch.from_numpy(np.stack(center)),
        affine=torch.from_numpy(np.stack(affine)),
        photometric=(_photometric_draws(jax.random.fold_in(key, 43), b, s)
                     if hyp.get("photometric", 1.0) else None),
        hsv_gain=None if hsv is None else torch.from_numpy(hsv.astype(np.float32)),
        fliplr=gate(29, hyp.get("fliplr", 0.5)),
        flipud=gate(31, pud) if pud > 0 else None,
        mixup=gate(37, pmix) if pmix > 0 else None, mixup_lam=lam,
        bgr=gate(47, pbgr) if pbgr > 0 else None)


NO_HSV = {"hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0}


def assert_hsv_image_as_jax(p_img, j_img, j_pre, key, hyp, atol=IMG_ATOL) -> int:
    """The port's augmented images `p_img` with HSV on, held by ROADMAP
    §C.16's rule: at `atol` everywhere against JAX's `_hsv_aug`, run op by op,
    of JAX's own warped images `j_pre` (its augment_batch on the same key with
    HSV off; the flips after HSV commute with it); and at `atol` against JAX's
    fused augment_batch `j_img` outside the values where that fused program
    differs from the same composition (XLA's CPU fusion of the gather warp
    into HSV recomputes a channel with another rounding, so `max == g` can
    fail for the max channel and pick another sextant). Those values must
    stay under 0.1%; returns their count."""
    b = j_img.shape[0]
    keys = jax.random.split(key, b * 4).reshape(b, 4, 2)
    comp = np.stack([np.asarray(jaug._hsv_aug(jnp.asarray(j_pre[i]), keys[i, 1], hyp))
                     for i in range(b)])
    np.testing.assert_allclose(p_img, comp, atol=atol, rtol=0)
    fused_fault = np.abs(j_img - comp) > atol
    print(f"HSV: port vs JAX's composition {np.abs(p_img - comp).max():.3e}; fused-program "
          f"values off that composition {int(fused_fault.sum())} of {fused_fault.size}")
    assert fused_fault.mean() <= 1e-3, int(fused_fault.sum())
    np.testing.assert_allclose(np.where(fused_fault, j_img, p_img), j_img, atol=atol, rtol=0)
    return int(fused_fault.sum())


def _run_both(hyp, mosaic, b=B, seed=0):
    imgs, cls, boxes, mask = _batch(b, seed=seed)
    key = jax.random.PRNGKey(seed + 7)
    j_img, j_cls, j_box, j_mask = (np.asarray(a) for a in jaug.augment_batch(
        jnp.asarray(imgs), jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask), key, S, hyp,
        mosaic=mosaic))
    prm = jax_drawn_params(key, b, S, hyp, mosaic)
    p_img, p_cls, p_box, p_mask = (t.numpy() for t in aug.augment_apply(
        torch.from_numpy(imgs), torch.from_numpy(cls), torch.from_numpy(boxes),
        torch.from_numpy(mask), prm, S))
    return (j_img, j_cls, j_box, j_mask), (p_img, p_cls, p_box, p_mask), prm


def _assert_same(j, p, img_atol=IMG_ATOL):
    j_img, j_cls, j_box, j_mask = j
    p_img, p_cls, p_box, p_mask = p
    assert p_img.shape == j_img.shape and p_img.dtype == np.float32
    np.testing.assert_allclose(p_img, j_img, atol=img_atol, rtol=0)
    np.testing.assert_array_equal(p_mask, j_mask)
    np.testing.assert_array_equal(p_cls, j_cls)
    np.testing.assert_allclose(p_box, j_box, atol=LABEL_ATOL, rtol=0)


@pytest.mark.parametrize("path", ["separable", "gather"])
@pytest.mark.parametrize("mosaic", [True, False], ids=["mosaic4", "single"])
def test_warp_matches_jax(path, mosaic):
    hyp = {**QUIET, **(GATHER if path == "gather" else {})}
    j, p, _ = _run_both(hyp, mosaic)
    _assert_same(j, p)
    assert p[3].sum() > 0  # some boxes survive the candidate filter


@pytest.mark.parametrize("mosaic", [True, False], ids=["mosaic4", "single"])
def test_separable_and_gather_paths_agree(mosaic):
    """The same axis-aligned draw through both samplers of the port."""
    imgs = torch.from_numpy(_batch()[0])
    prm = jax_drawn_params(jax.random.PRNGKey(3), B, S, QUIET, mosaic)
    assert aug.axis_aligned(prm.affine)
    a_inv = torch.linalg.inv(prm.affine.float())
    sep = aug._sample_separable(imgs, prm.sel, prm.center, a_inv, S)
    gat = aug._sample_gather(imgs, prm.sel, prm.center, a_inv, S)
    np.testing.assert_allclose(sep.numpy() / 255, gat.numpy() / 255, atol=IMG_ATOL, rtol=0)


def test_sampler_follows_the_drawn_homography():
    """warp takes the separable sampler exactly when every drawn homography
    is axis-aligned; a rotation, shear or perspective term anywhere in the
    batch sends the batch through the gather."""
    gen = torch.Generator().manual_seed(0)
    assert aug.axis_aligned(aug.sample_params(B, S, QUIET, True, gen).affine)
    for term in ({"degrees": 1.0}, {"shear": 1.0}, {"perspective": 1e-4}):
        assert not aug.axis_aligned(aug.sample_params(B, S, {**QUIET, **term}, True, gen).affine)
    a = torch.eye(3).repeat(B, 1, 1)
    a[1, 2, 1] = 1e-4
    assert not aug.axis_aligned(a)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("photometric", [0.0, 1.0], ids=["hsv-flips-mixup-bgr", "all"])
def test_detect_augmentation_matches_jax(photometric, seed):
    """HSV, both flips, mixup with Beta(32, 32) and the BGR swap on top of
    mosaic4, with the values JAX drew; then with the photometric stage too,
    where the image is held at the JPEG tolerance: a DCT coefficient within
    f32 noise of a rounding edge quantises to the next step in one framework."""
    hyp = {**QUIET, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "fliplr": 0.5, "flipud": 0.5,
           "photometric": photometric, "mixup": 0.5, "bgr": 0.5}
    j, p, prm = _run_both(hyp, True, b=4, seed=seed)
    print(f"img01 max abs diff {np.abs(p[0] - j[0]).max() * 255:.3e} / 255")
    _assert_same(j, p, IMG_ATOL if not photometric else 2 / 255)
    assert p[1].shape == (4, 2 * 4 * M)  # mixup doubles the label slots
    assert bool(prm.mixup.any()) and bool(prm.fliplr.any()) and bool(prm.bgr.any())


@pytest.mark.parametrize("seed", [1, 6])
def test_hsv_after_the_gather_warp_matches_jax(seed):
    """HSV on the gather path (rotation, shear, perspective) at seeds where
    JAX's fused augment_batch meets §C.16 (its HSV picks another sextant at
    some values): the image held by `assert_hsv_image_as_jax`, the labels as
    everywhere."""
    hyp = {**QUIET, **GATHER, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "fliplr": 0.5}
    j, p, _ = _run_both(hyp, True, b=4, seed=seed)
    j_pre, _, _ = _run_both({**hyp, **NO_HSV}, True, b=4, seed=seed)
    _assert_same(j, p, img_atol=1.0)  # the labels; the image below
    assert_hsv_image_as_jax(p[0], j[0], j_pre[0], jax.random.PRNGKey(seed + 7), hyp)


def test_hsv_matches_jax():
    rs = np.random.RandomState(2)
    ims = rs.rand(3, S, S, 3).astype(np.float32)
    hyp = {"hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4}
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    j = np.stack([np.asarray(jaug._hsv_aug(jnp.asarray(im), k, hyp)) for im, k in zip(ims, keys)])
    gains = np.stack([np.asarray(jax.random.uniform(k, (3,), minval=-1.0, maxval=1.0))
                      for k in keys]) * np.float32([0.015, 0.7, 0.4]) + 1
    p = aug.hsv_aug(torch.from_numpy(ims), torch.from_numpy(gains.astype(np.float32))).numpy()
    np.testing.assert_allclose(p, j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("op", ["blur3", "blur5", "blur7", "median", "gray"])
def test_photometric_op_matches_jax(op):
    ims = np.random.RandomState(4).rand(3, S, S, 3).astype(np.float32)
    jfn, pfn, tol = {
        "blur3": (lambda x: jphoto.box_blur(x, 3), lambda x: photo.box_blur(x, 3), 5e-6),
        "blur5": (lambda x: jphoto.box_blur(x, 5), lambda x: photo.box_blur(x, 5), 5e-6),
        "blur7": (lambda x: jphoto.box_blur(x, 7), lambda x: photo.box_blur(x, 7), 5e-6),
        "median": (jphoto.median3, photo.median3, 1e-6),
        "gray": (jphoto.to_gray, photo.to_gray, 1e-6),
    }[op]
    j = np.stack([np.asarray(jfn(jnp.asarray(im))) for im in ims])
    p = pfn(torch.from_numpy(ims)).numpy()
    print(f"{op}: max abs diff {np.abs(p - j).max():.3e}")
    np.testing.assert_allclose(p, j, atol=tol, rtol=0)


@pytest.mark.parametrize("op", ["clahe", "jpeg"])
def test_clahe_and_jpeg_match_jax(op):
    ims = np.random.RandomState(6).rand(3, S, S, 3).astype(np.float32)
    args = (np.float32([1.0, 2.5, 3.9]) if op == "clahe" else np.float32([75.0, 86.3, 99.9]))
    jfn, pfn = (jphoto.clahe, photo.clahe) if op == "clahe" else (jphoto.jpeg_compress,
                                                                   photo.jpeg_compress)
    j = np.stack([np.asarray(jfn(jnp.asarray(im), a)) for im, a in zip(ims, args)])
    p = pfn(torch.from_numpy(ims), torch.from_numpy(args)).numpy()
    print(f"{op}: max abs diff {np.abs(p - j).max() * 255:.3e} / 255")
    np.testing.assert_allclose(p, j, atol=2 / 255, rtol=0)


@pytest.mark.parametrize("b", [4, 16], ids=["per-image", "subset"])
def test_photometric_batch_matches_jax(b):
    """Both formulations, fed JAX's draws; the subset draw at batch 16 fires
    rare ops at 2x their marginal probability on 8 strided images."""
    ims = np.random.RandomState(8).rand(b, S, S, 3).astype(np.float32)
    key = jax.random.PRNGKey(11 + b)
    j = np.asarray(jphoto.photometric_batch(jnp.asarray(ims), key, {"photometric": 1.0}))
    prm = _photometric_draws(key, b, S)
    p = photo.photometric_apply(torch.from_numpy(ims), prm).numpy()
    np.testing.assert_allclose(p, j, atol=2 / 255, rtol=0)
    assert bool(prm.jpeg.any())


def test_bgr_swap_matches_jax():
    ims = np.random.RandomState(9).rand(4, S, S, 3).astype(np.float32)
    key = jax.random.PRNGKey(2)
    j = np.asarray(jphoto.bgr_swap_batch(jnp.asarray(ims), key, {"bgr": 0.5}))
    swap = torch.from_numpy(np.array(jax.random.uniform(key, (4,)) < 0.5))
    np.testing.assert_array_equal(photo.bgr_swap_batch(torch.from_numpy(ims), swap).numpy(), j)


def test_sampling_is_seeded_and_on_the_host():
    hyp = {**QUIET, "photometric": 1.0, "fliplr": 0.5, "mixup": 0.5, "hsv_h": 0.015}
    a = aug.sample_params(16, S, hyp, True, torch.Generator().manual_seed(0))
    b = aug.sample_params(16, S, hyp, True, torch.Generator().manual_seed(0))
    for name in ("sel", "center", "affine", "hsv_gain", "fliplr", "mixup", "mixup_lam"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert getattr(a, name).device.type == "cpu"
    assert a.sel.shape == (16, 4) and bool((a.sel[:, 1:] != a.sel[:, :1]).all())
    assert bool(((a.center >= 0.5 * S) & (a.center <= 1.5 * S)).all())
    lam = aug.sample_beta(32.0, 32.0, 4000, torch.Generator().manual_seed(1))
    assert abs(float(lam.mean()) - 0.5) < 0.01 and abs(float(lam.std()) - 0.0619) < 0.004
