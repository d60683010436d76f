"""The photometric stage of training augmentation and the BGR swap
(edgeyolo_tpu/data/photometric.py), on (N, S, S, 3) float images in [0, 1].

The reference's Albumentations list: Blur, MedianBlur, ToGray and CLAHE at
p = 0.01 each, ImageCompression (quality 75-100) at p = 0.5, between MixUp and
RandomHSV. The ops are the JAX package's analogs: replicate-edge blur and
3x3 median, luma gray, CLAHE on luma with the RGB rescaled by the luma ratio,
and a JPEG round trip through the 8x8 DCT with the T.81 tables and no chroma
subsampling.

Sampling is apart from application. `sample_photometric` draws every gate,
blur size, CLIP limit and JPEG quality from a torch.Generator, following the
JAX draw structure (per image when B <= k_rare; otherwise the rare ops on
k_rare images at strided positions with their probabilities scaled by
B / k_rare, and JPEG on every even position). `photometric_apply` runs each
op only on the images whose gate fired: the gates are host tensors, so no
op is computed to be thrown away and no device value is read back.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

P_BLUR = 0.01
P_MEDIAN = 0.01
P_GRAY = 0.01
P_CLAHE = 0.01
P_JPEG = 0.5

_LUMA = (0.299, 0.587, 0.114)

# standard JPEG quantization tables (Annex K of ITU-T T.81)
_QY = (
    (16, 11, 10, 16, 24, 40, 51, 61),
    (12, 12, 14, 19, 26, 58, 60, 55),
    (14, 13, 16, 24, 40, 57, 69, 56),
    (14, 17, 22, 29, 51, 87, 80, 62),
    (18, 22, 37, 56, 68, 109, 103, 77),
    (24, 35, 55, 64, 81, 104, 113, 92),
    (49, 64, 78, 87, 103, 121, 120, 101),
    (72, 92, 95, 98, 112, 100, 103, 99),
)
_QC = (
    (17, 18, 24, 47, 99, 99, 99, 99),
    (18, 21, 26, 66, 99, 99, 99, 99),
    (24, 26, 56, 99, 99, 99, 99, 99),
    (47, 66, 99, 99, 99, 99, 99, 99),
) + ((99,) * 8,) * 4


def box_blur(im: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box blur of (N, S, S, C) with replicate edges (cv2.blur analog).

    A direct window sum: JAX's cumulative-sum form carries the rounding of
    sums up to S, about 2e-6 at S = 64 in f32."""
    p = k // 2
    x = F.pad(im.permute(0, 3, 1, 2), (p, p, p, p), mode="replicate")
    return F.avg_pool2d(x, k, stride=1).permute(0, 2, 3, 1)


def median3(im: torch.Tensor) -> torch.Tensor:
    """3x3 median of (N, S, S, C) with replicate edges, by J. L. Smith's
    19-exchange median-of-9 network (min/max only, no sort)."""
    s = im.shape[1]
    p = F.pad(im.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
    t = [p[:, dy:dy + s, dx:dx + s] for dy in range(3) for dx in range(3)]
    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                 (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                 (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)):
        t[i], t[j] = torch.minimum(t[i], t[j]), torch.maximum(t[i], t[j])
    return t[4]


def _luma(im: torch.Tensor) -> torch.Tensor:
    return im @ torch.tensor(_LUMA, dtype=im.dtype, device=im.device)


def to_gray(im: torch.Tensor) -> torch.Tensor:
    """Replicated-luma grayscale (cv2 BGR2GRAY weights)."""
    return _luma(im)[..., None].expand(im.shape).contiguous()


def clahe(im: torch.Tensor, clip_limit: torch.Tensor, grid: int = 8,
          bins: int = 256) -> torch.Tensor:
    """Clip-limited adaptive histogram equalisation of (N, S, S, 3) in [0, 1],
    with one clip limit per image (N,); S % grid == 0.

    Per tile of the luma: a clipped histogram, its excess spread over the
    bins, the CDF as a lookup table; each pixel interpolates bilinearly
    between the tables of its 4 neighbouring tiles, with edge tiles
    replicated (the half-tile padding of JAX's block formulation). The
    tables are rounded to bf16 before the lookup, as JAX's one-hot matmul
    rounds them. RGB is rescaled by the luma ratio.
    """
    n, s = im.shape[:2]
    ts = s // grid
    luma = _luma(im)
    q = (luma * (bins - 1)).round().clamp(0, bins - 1).long()  # (N, S, S)

    qt = q.reshape(n, grid, ts, grid, ts).permute(0, 1, 3, 2, 4).reshape(n, grid * grid, ts * ts)
    hist = torch.zeros(n, grid * grid, bins, dtype=torch.float32, device=im.device)
    hist.scatter_add_(2, qt, torch.ones_like(qt, dtype=torch.float32))
    limit = (clip_limit.float() * ts * ts / bins).clamp(min=1.0)[:, None, None]
    excess = (hist - limit).clamp(min=0.0).sum(dim=-1, keepdim=True)
    hist = torch.minimum(hist, limit) + excess / bins
    lut = (hist.cumsum(dim=-1) / (ts * ts)).to(torch.bfloat16).float()
    lut = lut.reshape(n, grid, grid, bins)

    # blocks of the half-tile-padded luma: each sees 4 constant neighbour tiles
    h2, g = ts // 2, grid + 1
    qp = F.pad(q[:, None].float(), (h2, h2, h2, h2), mode="replicate")[:, 0].long()
    qb = qp.reshape(n, g, ts, g, ts).permute(0, 1, 3, 2, 4).reshape(n, g * g, ts * ts)
    c0 = (torch.arange(g, device=im.device) - 1).clamp(0, grid - 1)
    c1 = torch.arange(g, device=im.device).clamp(0, grid - 1)
    l4 = torch.stack([lut[:, c0[:, None], c0[None, :]], lut[:, c0[:, None], c1[None, :]],
                      lut[:, c1[:, None], c0[None, :]], lut[:, c1[:, None], c1[None, :]]],
                     dim=-1).reshape(n, g * g, bins, 4)
    vb = l4.gather(2, qb[..., None].expand(n, g * g, ts * ts, 4))  # (N, G^2, ts^2, 4)
    fy = (torch.arange(ts, dtype=torch.float32, device=im.device) + 0.5) / ts
    vb = vb.reshape(n, g, g, ts, ts, 2, 2)
    v = (vb[..., 0, 0] * (1 - fy)[:, None] * (1 - fy)[None, :]
         + vb[..., 0, 1] * (1 - fy)[:, None] * fy[None, :]
         + vb[..., 1, 0] * fy[:, None] * (1 - fy)[None, :]
         + vb[..., 1, 1] * fy[:, None] * fy[None, :])
    v = v.permute(0, 1, 3, 2, 4).reshape(n, s + ts, s + ts)[:, h2:-h2, h2:-h2]
    ratio = (v + 1e-6) / (luma + 1e-6)
    return (im * ratio[..., None]).clamp(0.0, 1.0)


def _dct_matrix(n: int = 8, device=None) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float32, device=device)
    d = torch.cos((2 * k[None, :] + 1) * k[:, None] * math.pi / (2 * n))
    return d * torch.where(k[:, None] == 0, 1.0 / math.sqrt(n), math.sqrt(2.0 / n))


def jpeg_compress(im: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """JPEG round trip of (N, S, S, 3) in [0, 1] at one quality per image (N,);
    S % 8 == 0. RGB -> full-range YCbCr, 8x8 block DCT, quantise and
    dequantise with the T.81 tables scaled by quality, inverse DCT, RGB."""
    n, s = im.shape[:2]
    nb = s // 8
    r, g, b = im[..., 0] * 255, im[..., 1] * 255, im[..., 2] * 255
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b
    ycc = torch.stack([y, cb, cr], dim=1)  # (N, 3, S, S), centred

    quality = quality.float().reshape(n, 1, 1)
    scale = torch.where(quality < 50, 5000.0 / quality.clamp(min=1), 200.0 - 2.0 * quality)
    qy = torch.tensor(_QY, dtype=torch.float32, device=im.device)
    qc = torch.tensor(_QC, dtype=torch.float32, device=im.device)
    qy = ((qy * scale + 50) / 100).floor().clamp(1, 255)
    qc = ((qc * scale + 50) / 100).floor().clamp(1, 255)
    tbl = torch.stack([qy, qc, qc], dim=1)  # (N, 3, 8, 8)

    d = _dct_matrix(device=im.device)
    blocks = ycc.reshape(n, 3, nb, 8, nb, 8)
    coef = torch.einsum("ij,ncajbk,lk->ncaibl", d, blocks, d)
    tq = tbl[:, :, None, :, None, :]
    deq = torch.round(coef / tq) * tq
    ycc2 = torch.einsum("ji,ncajbk,kl->ncaibl", d, deq, d).reshape(n, 3, s, s)
    y2, cb2, cr2 = ycc2[:, 0] + 128.0, ycc2[:, 1], ycc2[:, 2]
    r2 = y2 + 1.402 * cr2
    g2 = y2 - 0.344136 * cb2 - 0.714136 * cr2
    b2 = y2 + 1.772 * cb2
    return (torch.stack([r2, g2, b2], dim=-1) / 255.0).clamp(0.0, 1.0)


@dataclass
class PhotometricParams:
    """Per image (B,) host tensors: which op fires, and its draw."""

    blur: torch.Tensor  # bool
    blur_k: torch.Tensor  # int, 3, 5 or 7
    median: torch.Tensor  # bool
    gray: torch.Tensor  # bool
    clahe: torch.Tensor  # bool
    clahe_clip: torch.Tensor  # float in [1, 4)
    jpeg: torch.Tensor  # bool
    jpeg_quality: torch.Tensor  # float in [75, 100)

    @classmethod
    def empty(cls, b: int) -> "PhotometricParams":
        def no():
            return torch.zeros(b, dtype=torch.bool)

        return cls(no(), torch.full((b,), 3), no(), no(), no(), torch.zeros(b), no(),
                   torch.zeros(b))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _rare_draw(prm: PhotometricParams, i: int, gen: torch.Generator, pscale: float) -> None:
    """The p = 0.01 gates of image i (JAX's _rare_one), probabilities x pscale."""
    p = torch.rand(4, generator=gen)
    prm.blur_k[i] = 3 + 2 * int(torch.randint(0, 3, (), generator=gen))
    prm.clahe_clip[i] = _uniform(gen, (), 1.0, 4.0)
    prm.blur[i] = p[0] < P_BLUR * pscale
    prm.median[i] = p[1] < P_MEDIAN * pscale
    prm.gray[i] = p[2] < P_GRAY * pscale
    prm.clahe[i] = p[3] < P_CLAHE * pscale


def sample_photometric(b: int, s: int, gen: torch.Generator,
                       k_rare: int = 8) -> PhotometricParams:
    """Draw the stage's parameters for a batch of b images of s x s pixels."""
    prm = PhotometricParams.empty(b)
    jpeg_ok = s % 8 == 0
    if b <= k_rare:  # JAX: vmap(photometric_one), every image on its own
        for i in range(b):
            _rare_draw(prm, i, gen, 1.0)
            if jpeg_ok:
                prm.jpeg_quality[i] = _uniform(gen, (), 75.0, 100.0)
                prm.jpeg[i] = bool(torch.rand((), generator=gen) < P_JPEG)
        return prm
    stride = b // k_rare  # the rare ops: k_rare images at strided positions
    for j in range(k_rare):
        _rare_draw(prm, j * stride, gen, b / k_rare)
    if jpeg_ok:  # JPEG at p = 0.5: every even position
        nj = b // 2
        prm.jpeg[0:2 * nj:2] = True
        prm.jpeg_quality[0:2 * nj:2] = _uniform(gen, (nj,), 75.0, 100.0)
    return prm


def apply_where(img: torch.Tensor, gate: torch.Tensor, fn) -> torch.Tensor:
    """img with fn applied to the images whose host gate is set."""
    idx = gate.nonzero().flatten()
    if idx.numel() == 0:
        return img
    idx = idx.to(img.device)
    img = img.clone()
    img[idx] = fn(img[idx], idx)
    return img


def photometric_apply(img01: torch.Tensor, prm: PhotometricParams) -> torch.Tensor:
    """Blur, median, gray and CLAHE in that order, then JPEG, each on the
    images whose gate fired; img01 is (B, S, S, 3) in [0, 1]."""
    for k in (3, 5, 7):
        img01 = apply_where(img01, prm.blur & (prm.blur_k == k), lambda x, _i: box_blur(x, k))
    img01 = apply_where(img01, prm.median, lambda x, _i: median3(x))
    img01 = apply_where(img01, prm.gray, lambda x, _i: to_gray(x))
    clip = prm.clahe_clip.to(img01.device)
    img01 = apply_where(img01, prm.clahe, lambda x, i: clahe(x, clip[i]))
    quality = prm.jpeg_quality.to(img01.device)
    return apply_where(img01, prm.jpeg, lambda x, i: jpeg_compress(x, quality[i]))


def bgr_swap_batch(img01: torch.Tensor, swap: torch.Tensor) -> torch.Tensor:
    """RGB <-> BGR on the images whose host flag is set (the reference's Format
    stage, probability hyp["bgr"])."""
    return apply_where(img01, swap, lambda x, _i: x.flip(-1))
