"""RandAugment of the classify train pipeline (edgeyolo_tpu/data/randaugment.py),
on a batch on the device.

torchvision's tensor-path formulas as the JAX package writes them: 14 ops
(identity, shear x/y, translate x/y, rotate, brightness, colour, contrast,
sharpness, posterize, solarize, autocontrast, equalize), num_ops = 2 applied
in turn, magnitude 9 of 31 bins, signed where the op has a direction; the
geometric ops sample nearest with zero fill about the image centre, and
posterize, solarize and equalize work on the 0..255 grid. Images are
(B, S, S, 3) float in [0, 1].

The draws are apart from the application: `sample_rand_augment` draws each
image's op indices and signs from a torch.Generator on the host;
`rand_augment_apply` applies them, each op to the images that drew it at
once. The tests feed it the draws JAX's `rand_augment` makes from its keys.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NUM_BINS = 31
OPS = ("identity", "shear_x", "shear_y", "translate_x", "translate_y", "rotate", "brightness",
       "color", "contrast", "sharpness", "posterize", "solarize", "autocontrast", "equalize")
DEG2RAD = np.float32(np.pi / 180)  # as jnp.deg2rad's f32 constant


def magnitudes(size: int) -> dict[str, np.ndarray]:
    """torchvision RandAugment's bins (num_bins 31) for an image side of `size`."""
    bins = NUM_BINS
    return {
        "shear": np.linspace(0.0, 0.3, bins),
        "translate": np.linspace(0.0, 150.0 / 331.0 * size, bins),
        "rotate": np.linspace(0.0, 30.0, bins),
        "color": np.linspace(0.0, 0.9, bins),
        "posterize": 8 - np.round(np.arange(bins) / (bins - 1) * 4),
        "solarize": np.linspace(255.0, 0.0, bins),
    }


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """torchvision's grayscale weights: (N, S, S, 3) -> (N, S, S)."""
    r, g, b = img.unbind(-1)
    return 0.2989 * r + 0.587 * g + 0.114 * b


def _blend(img1: torch.Tensor, img2: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """ratio * img1 + (1 - ratio) * img2, clipped to [0, 1]; ratio (N,)."""
    r = _per_image(ratio)
    return (r * img1 + (1.0 - r) * img2).clamp(0.0, 1.0)


def adjust_brightness(img, factor):
    return _blend(img, torch.zeros_like(img), factor)


def adjust_saturation(img, factor):
    return _blend(img, rgb_to_gray(img)[..., None], factor)


def adjust_contrast(img, factor):
    mean = rgb_to_gray(img).mean((1, 2))
    return _blend(img, _per_image(mean).expand_as(img), factor)


def adjust_sharpness(img, factor):
    """The 3 x 3 kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 (zero padded),
    clipped, blended on the interior only: border rows and columns keep
    their pixels."""
    k = torch.ones(3, 3, device=img.device)
    k[1, 1] = 5.0
    k = k / 13.0
    x = img.permute(0, 3, 1, 2)
    blur = F.conv2d(x, k.expand(3, 1, 3, 3), padding=1, groups=3).clamp(0.0, 1.0)
    blur = blur.permute(0, 2, 3, 1)
    out = img.clone()
    out[:, 1:-1, 1:-1] = blur[:, 1:-1, 1:-1]
    return _blend(img, out, factor)


def posterize(img, bits: int):
    """The top `bits` bits of each value's 0..255 quantisation."""
    q = torch.floor(img * 255.0 + 0.5).to(torch.int32)
    return torch.bitwise_and(q, -(1 << (8 - int(bits)))).float() / 255.0


def solarize(img, threshold01: float):
    return torch.where(img >= threshold01, 1.0 - img, img)


def autocontrast(img):
    """Each channel stretched from its own min and max to [0, 1]."""
    lo = img.amin((1, 2), keepdim=True)
    hi = img.amax((1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.ones_like(hi))
    return torch.where(hi > lo, (img - lo) * scale, img).clamp(0.0, 1.0)


def equalize(img):
    """Per-channel histogram equalisation on the 0..255 grid (torchvision's
    _scale_channel): step = (pixels - count of the last non-zero bin) // 255,
    lut = (cumsum + step // 2) // step shifted by one and clipped; a channel
    with step 0 stays as it is."""
    n, h, w, c = img.shape
    q = torch.clamp(torch.floor(img * 255.0 + 0.5), 0, 255).long()
    qc = q.permute(0, 3, 1, 2).reshape(n * c, h * w)
    hist = torch.zeros(n * c, 256, dtype=torch.long, device=img.device)
    hist.scatter_add_(1, qc, torch.ones_like(qc))
    bins = torch.arange(256, device=img.device)
    last = torch.where(hist > 0, bins, -1).amax(1, keepdim=True)
    step = (hist.sum(1, keepdim=True) - hist.gather(1, last)) // 255
    lut = (hist.cumsum(1) + step // 2) // step.clamp(min=1)
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], 1).clamp(0, 255)
    out = torch.where(step == 0, qc, lut.gather(1, qc))
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1).float() / 255.0


def affine_nearest(img: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Sample each image at inv (N, 2, 3) applied to its centre-origin output
    coordinates, nearest (half to even), zero outside."""
    n, h, w, _ = img.shape
    cy, cx = (h - 1) * 0.5, (w - 1) * 0.5
    ys = torch.arange(h, dtype=torch.float32, device=img.device) - cy
    xs = torch.arange(w, dtype=torch.float32, device=img.device) - cx
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    a = inv[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    sx = a[:, 0, 0] * gx + a[:, 0, 1] * gy + a[:, 0, 2] + cx
    sy = a[:, 1, 0] * gx + a[:, 1, 1] * gy + a[:, 1, 2] + cy
    xi, yi = torch.round(sx).long(), torch.round(sy).long()
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    bi = torch.arange(n, device=img.device)[:, None, None]
    val = img[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
    return torch.where(ok[..., None], val, 0.0)


def _inv(img: torch.Tensor, entries: dict) -> torch.Tensor:
    """Per-image (N, 2, 3) identities with `entries` {(i, j): (N,)} set."""
    inv = torch.eye(2, 3, device=img.device).repeat(len(img), 1, 1)
    for (i, j), v in entries.items():
        inv[:, i, j] = v
    return inv


def shear_x(img, deg):
    return affine_nearest(img, _inv(img, {(0, 1): torch.tan(deg * DEG2RAD)}))


def shear_y(img, deg):
    return affine_nearest(img, _inv(img, {(1, 0): torch.tan(deg * DEG2RAD)}))


def translate_x(img, px):
    return affine_nearest(img, _inv(img, {(0, 2): -px}))


def translate_y(img, px):
    return affine_nearest(img, _inv(img, {(1, 2): -px}))


def rotate(img, deg):
    """Counter-clockwise by `deg` about the centre (the inverse map's matrix)."""
    a = deg * DEG2RAD
    cos, sin = torch.cos(a), torch.sin(a)
    return affine_nearest(img, _inv(img, {(0, 0): cos, (0, 1): sin, (1, 0): -sin, (1, 1): cos}))


def _op(img: torch.Tensor, k: int, sign: torch.Tensor, m: dict) -> torch.Tensor:
    """Op k of OPS on images (N, S, S, 3) with per-image signs (N,) of +-1."""
    name = OPS[k]
    if name == "identity":
        return img
    if name in ("shear_x", "shear_y"):
        return (shear_x if name == "shear_x" else shear_y)(img, sign * m["shear_deg"])
    if name in ("translate_x", "translate_y"):
        return (translate_x if name == "translate_x" else translate_y)(img, sign * m["translate"])
    if name == "rotate":
        return rotate(img, sign * m["rotate"])
    if name in ("brightness", "color", "contrast", "sharpness"):
        fn = {"brightness": adjust_brightness, "color": adjust_saturation,
              "contrast": adjust_contrast, "sharpness": adjust_sharpness}[name]
        return fn(img, 1.0 + sign * m["color"])
    if name == "posterize":
        return posterize(img, m["posterize"])
    if name == "solarize":
        return solarize(img, m["solarize"])
    return autocontrast(img) if name == "autocontrast" else equalize(img)


def _op_magnitudes(size: int, magnitude: int) -> dict:
    mags = magnitudes(size)
    return {"shear_deg": float(np.degrees(np.arctan(float(mags["shear"][magnitude])))),
            "translate": float(mags["translate"][magnitude]),
            "rotate": float(mags["rotate"][magnitude]),
            "color": float(mags["color"][magnitude]),
            "posterize": int(mags["posterize"][magnitude]),
            "solarize": float(mags["solarize"][magnitude]) / 255.0}


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device` without a wait: pinned, then copied
    asynchronously (a pageable copy would wait for the device's queue)."""
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def rand_augment_apply(img01: torch.Tensor, ops: torch.Tensor, signs: torch.Tensor,
                       magnitude: int = 9) -> torch.Tensor:
    """Apply each image's drawn ops (B, num_ops) with their signs (B, num_ops)
    in turn; at each turn every op runs once, on the images that drew it.
    The groups are formed on the host from the host draws and their indices
    and signs reach the device in one copy."""
    m = _op_magnitudes(img01.shape[1], magnitude)
    ops_host, signs_host = ops.cpu(), signs.cpu().float()
    groups = [(i, k, (ops_host[:, i] == k).nonzero()[:, 0]) for i in range(ops.shape[1])
              for k in torch.unique(ops_host[:, i]).tolist()]
    packed = to_device(torch.cat([torch.stack([sel.float(), signs_host[sel, i]])
                                  for i, _, sel in groups], 1), img01.device)
    off = 0
    for i in range(ops.shape[1]):
        out = img01.clone()
        for j, k, sel in groups:
            if j != i:
                continue
            idx = packed[0, off:off + len(sel)].long()
            out[idx] = _op(img01[idx], k, packed[1, off:off + len(sel)], m)
            off += len(sel)
        img01 = out
    return img01


def sample_rand_augment(b: int, gen: torch.Generator, num_ops: int = 2):
    """Each image's op indices (b, num_ops) and signs (+-1, b, num_ops)."""
    ops = torch.randint(0, len(OPS), (b, num_ops), generator=gen)
    signs = torch.where(torch.rand(b, num_ops, generator=gen) < 0.5, -1.0, 1.0)
    return ops, signs
