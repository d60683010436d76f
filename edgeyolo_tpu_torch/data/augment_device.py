"""Training augmentation on the device (edgeyolo_tpu/data/augment_device.py),
detect, segment, pose and obb labels: mosaic4 or single-source placement with a random
affine as one inverse-map bilinear sample per output pixel, the photometric
stage, HSV, copy-paste, flips, mixup and the BGR swap, over a uint8 NHWC
batch.

Sampling is apart from application. `sample_params` draws every random
number of a step (partners, mosaic centre, homography, photometric picks
and JPEG qualities, HSV gains, flips, mixup and its lambda, BGR swaps) from
a torch.Generator on the CPU, a few numbers per image, so a step on the card
and one on the CPU draw the same values. `augment_apply` takes them as
tensors; the tests feed it the parameters the JAX code draws from its keys.

The warp is separable when every drawn homography is axis-aligned (so when
degrees, shear and perspective are all 0, the default detect hyps): each
output row and column samples two source rows and columns, and the gray
border comes from the missing weight. Otherwise each pixel gathers its four
taps.
Boxes ride the forward transform (4 corners, min/max, candidate filter),
fixed-shape: each image carries n_src * M padded slots.

Instance masks (B, M, Sm, Sm) at S / Sm of the image ride the same inverse
map, whichever image sampler ran: the map at every (S / Sm)-th pixel, its
source position divided by S / Sm and rounded, read nearest, zero out of
the tile (JAX's _warp_masks). Copy-paste (masks only) takes each image's
instances mirrored left-right ("flip") or the previous image's ("mixup"),
keeps those whose box covers no existing box by ioa 0.30 or more (the
intersection over the existing box's area) and that the draw selects,
pastes their pixels through their masks nearest-upsampled to S, and appends
their labels and masks (M doubles); mixup is off when masks ride along.

Keypoints (B, M, K, 3) in letterbox pixels ride the forward transform;
one that lands off the canvas, or whose box the candidate filter drops,
becomes invisible. With keypoints both flips and mixup are off, as in JAX
(which has no flip_idx remap). Rotated boxes (B, M, 5), normalised cx, cy,
w, h and the angle, ride it as their four corners, refitted from the
transformed edges (exact under translate, scale and rotation) with the
angle brought into [0, pi/2) by swapping w and h; their own filter (sides
over 2 px, centre on the canvas) replaces the box filter, and a flip
mirrors the angle, swapping w and h when it crosses the pi/2 seam
(`flip_rbox_angle`). Mixup is off with rotated boxes too.

Classification (`classify_apply`, JAX's classify_augment_batch): per image
a random-resized crop through the bilinear gather (area in (max(1 - scale,
0.05), 1), log aspect in (log 3/4, log 4/3), the sample grid at pixel
centres; a tap before the first or past the last row or column reads
GRAY, 114, on the [0, 1] image, as JAX's does), the flips, HSV,
RandAugment (data/randaugment.py) when `auto_augment` is "randaugment", and
random erasing at `erasing` (area 0.02-0.33 of the image, log aspect
log 0.3-log 3.3, clamped to fit, filled with 0). `sample_classify_params`
draws them on the host, as `sample_params` does for detection.

Not ported yet: mosaic3/9.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from edgeyolo_tpu_torch.data.randaugment import rand_augment_apply, sample_rand_augment, to_device
from edgeyolo_tpu_torch.data.photometric import (
    PhotometricParams,
    apply_where,
    bgr_swap_batch,
    photometric_apply,
    sample_photometric,
)
from edgeyolo_tpu_torch.ops.boxes import xywh2xyxy
from edgeyolo_tpu_torch.ops.resize import nearest_resize

GRAY = 114.0


@dataclass
class AugParams:
    """One step's random draws; every tensor has the batch as its first dim."""

    sel: torch.Tensor  # (B, n_src) long: source images, column 0 the image itself
    center: torch.Tensor  # (B, 2) mosaic centre (yc, xc) on the 2S canvas
    affine: torch.Tensor  # (B, 3, 3) canvas-centred -> output homography
    photometric: PhotometricParams | None
    hsv_gain: torch.Tensor | None  # (B, 3) h, s, v gains
    fliplr: torch.Tensor  # (B,) bool
    flipud: torch.Tensor | None  # (B,) bool
    mixup: torch.Tensor | None  # (B,) bool
    mixup_lam: torch.Tensor | None  # (B,)
    bgr: torch.Tensor | None  # (B,) bool
    copy_paste: torch.Tensor | None = None  # (B, n_src * M) bool: instances drawn to paste
    copy_paste_mode: str = "flip"  # "flip": this image's, mirrored; "mixup": the previous image's

    def to(self, device) -> "AugParams":
        """The tensors the application indexes or multiplies with, on `device`;
        the gates it branches on, and the homography, which it inverts, stay
        on the host."""
        def move(t):
            return None if t is None else t.to(device)

        return replace(self, sel=move(self.sel), center=move(self.center),
                       hsv_gain=move(self.hsv_gain), mixup=move(self.mixup),
                       mixup_lam=move(self.mixup_lam), copy_paste=move(self.copy_paste))


def _hyp(hyp: dict, key: str, default: float) -> float:
    return float(hyp.get(key, default))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def affine_matrix(angle_deg: torch.Tensor, scale: torch.Tensor, shear_deg: torch.Tensor,
                  translate: torch.Tensor, persp: torch.Tensor) -> torch.Tensor:
    """M = T @ Sh @ R @ P (JAX's _affine_params), batched: angle, scale (B,),
    shear (B, 2) degrees (x, y), translate (B, 2) pixels, persp (B, 2)."""
    b = angle_deg.shape[0]
    a = angle_deg * math.pi / 180.0
    cos, sin = torch.cos(a) * scale, torch.sin(a) * scale
    eye = torch.eye(3).expand(b, 3, 3)
    r, sh, t, p = eye.clone(), eye.clone(), eye.clone(), eye.clone()
    r[:, 0, 0], r[:, 0, 1], r[:, 1, 0], r[:, 1, 1] = cos, -sin, sin, cos
    sh[:, 0, 1] = torch.tan(shear_deg[:, 0] * math.pi / 180.0)
    sh[:, 1, 0] = torch.tan(shear_deg[:, 1] * math.pi / 180.0)
    t[:, 0, 2], t[:, 1, 2] = translate[:, 0], translate[:, 1]
    p[:, 2, 0], p[:, 2, 1] = persp[:, 0], persp[:, 1]
    return t @ sh @ r @ p


def sample_params(b: int, s: int, hyp: dict, mosaic: bool, gen: torch.Generator,
                  m: int = 0, keypoints: bool = False) -> AugParams:
    """Draw one step's augmentation parameters for b images of s x s pixels.

    With m (the label slots of an image whose instance masks ride along) and
    `copy_paste`, each of the n_src * m warped instances is drawn for pasting
    last, after every other draw. With `keypoints` no flip is drawn (JAX
    draws the left-right flip at probability 0, and no up-down flip).

    `multi_scale` draws one more content scale per image in [0.5, 1.5], after
    the affine's own draws, and folds it into the homography's scale (JAX's
    static-canvas form of the reference's random image size per batch);
    without it the draws are those of a run that never had the option."""
    n_src = 4 if mosaic else 1
    # partners: n_src - 1 other images, by random offsets in [1, b)
    part = (torch.randint(1, b, (b, n_src - 1), generator=gen) if b > 1
            else torch.ones(b, n_src - 1, dtype=torch.long))
    base = torch.arange(b)[:, None]
    sel = torch.cat([base, (base + part) % b], dim=1)
    center = _uniform(gen, (b, 2), 0.5 * s, 1.5 * s)

    deg, tra, scl = _hyp(hyp, "degrees", 0.0), _hyp(hyp, "translate", 0.1), _hyp(hyp, "scale", 0.5)
    shr, per = _hyp(hyp, "shear", 0.0), _hyp(hyp, "perspective", 0.0)
    angle, scale = _uniform(gen, (b,), -deg, deg), _uniform(gen, (b,), 1 - scl, 1 + scl)
    shear = _uniform(gen, (b, 2), -shr, shr)
    translate = _uniform(gen, (b, 2), 0.5 - tra, 0.5 + tra) * s
    persp = _uniform(gen, (b, 2), -per, per) if per > 0 else torch.zeros(b, 2)
    if _hyp(hyp, "multi_scale", 0.0):
        scale = scale * _uniform(gen, (b,), 0.5, 1.5)
    affine = affine_matrix(angle, scale, shear, translate, persp)

    photometric = (sample_photometric(b, s, gen) if _hyp(hyp, "photometric", 1.0) else None)
    gains = torch.tensor([_hyp(hyp, "hsv_h", 0.015), _hyp(hyp, "hsv_s", 0.7),
                          _hyp(hyp, "hsv_v", 0.4)])
    hsv_gain = _uniform(gen, (b, 3), -1.0, 1.0) * gains + 1.0 if bool(gains.any()) else None
    fliplr = torch.rand(b, generator=gen) < (0.0 if keypoints else _hyp(hyp, "fliplr", 0.5))
    pud = 0.0 if keypoints else _hyp(hyp, "flipud", 0.0)
    flipud = torch.rand(b, generator=gen) < pud if pud > 0 else None
    pmix = _hyp(hyp, "mixup", 0.0)
    mixup = torch.rand(b, generator=gen) < pmix if pmix > 0 else None
    lam = sample_beta(32.0, 32.0, b, gen) if pmix > 0 else None
    pbgr = _hyp(hyp, "bgr", 0.0)
    bgr = torch.rand(b, generator=gen) < pbgr if pbgr > 0 else None
    pcp = _hyp(hyp, "copy_paste", 0.0)
    copy_paste = torch.rand(b, n_src * m, generator=gen) < pcp if pcp > 0 and m else None
    return AugParams(sel, center, affine, photometric, hsv_gain, fliplr, flipud, mixup, lam, bgr,
                     copy_paste, str(hyp.get("copy_paste_mode", "flip")))


def _sample_gamma(alpha: float, gen: torch.Generator) -> float:
    """One Gamma(alpha, 1) draw, alpha >= 1, by Marsaglia and Tsang's method."""
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=gen))
        v = (1.0 + c * x) ** 3
        if v <= 0:
            continue
        u = 1.0 - float(torch.rand((), generator=gen))  # in (0, 1]
        if math.log(u) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v


def sample_beta(a: float, b: float, n: int, gen: torch.Generator) -> torch.Tensor:
    """n Beta(a, b) draws as X / (X + Y) of two gamma draws."""
    out = []
    for _ in range(n):
        x, y = _sample_gamma(a, gen), _sample_gamma(b, gen)
        out.append(x / (x + y))
    return torch.tensor(out, dtype=torch.float32)


def _axis_taps(loc: torch.Tensor, s: int):
    """The two bilinear taps of each source coordinate along one axis: clipped
    indices and weights, a tap outside [0, s) weighing 0 (JAX's _axis_weights,
    stored sparse: two non-zeros per output position)."""
    i0 = loc.floor()
    f = loc - i0
    i0 = i0.long()
    ok0 = ((i0 >= 0) & (i0 < s)).to(loc.dtype)
    ok1 = ((i0 + 1 >= 0) & (i0 + 1 < s)).to(loc.dtype)
    return i0.clamp(0, s - 1), (i0 + 1).clamp(0, s - 1), (1 - f) * ok0, f * ok1


def _separable_sample(images: torch.Tensor, src_img: torch.Tensor, y_loc: torch.Tensor,
                      x_loc: torch.Tensor, col_group: torch.Tensor) -> torch.Tensor:
    """Axis-aligned bilinear sampling (JAX's _separable_accumulate).

    images (N, S, S, 3) uint8; y_loc (B, S) tile-local source row of each
    output row; x_loc (B, S) source column of each output column; col_group
    (B, S) the column group of each output column; src_img (B, G, S): the
    source image of output row i in column group g. Rows are interpolated
    first, per column group, then columns, and the gray border fills the
    weight the out-of-tile taps miss: out = sum w_y w_x px + GRAY (1 - W_y W_x).
    """
    b, s = y_loc.shape
    g = src_img.shape[1]
    y0, y1, wy0, wy1 = _axis_taps(y_loc, s)  # (B, S)
    x0, x1, wx0, wx1 = _axis_taps(x_loc, s)
    yi = lambda t: t[:, None, :].expand(b, g, s)  # noqa: E731
    rows = (wy0[:, None, :, None, None] * images[src_img, yi(y0)].float()
            + wy1[:, None, :, None, None] * images[src_img, yi(y1)].float())  # (B, G, S, S, 3)
    bi = torch.arange(b, device=images.device)[:, None]
    c0 = rows[bi, col_group, :, x0]  # (B, S_j, S_i, 3)
    c1 = rows[bi, col_group, :, x1]
    out = (wx0[:, :, None, None] * c0 + wx1[:, :, None, None] * c1).transpose(1, 2)
    wy, wx = wy0 + wy1, wx0 + wx1
    return out + GRAY * (1.0 - wy[:, :, None] * wx[:, None, :])[..., None]


def _bilinear_gather(images: torch.Tensor, img_idx: torch.Tensor, yy: torch.Tensor,
                     xx: torch.Tensor) -> torch.Tensor:
    """Sample images (N, S, S, 3) uint8 at per-pixel (img_idx, yy, xx); taps out
    of the image read gray (JAX's _bilinear_gather)."""
    s = images.shape[1]
    y0, x0 = yy.floor(), xx.floor()
    fy, fx = (yy - y0)[..., None], (xx - x0)[..., None]
    y0, x0 = y0.long(), x0.long()

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < s) & (xi >= 0) & (xi < s)
        v = images[img_idx, yi.clamp(0, s - 1), xi.clamp(0, s - 1)].float()
        return torch.where(valid[..., None], v, GRAY)

    return (tap(y0, x0) * (1 - fy) * (1 - fx) + tap(y0, x0 + 1) * (1 - fy) * fx
            + tap(y0 + 1, x0) * fy * (1 - fx) + tap(y0 + 1, x0 + 1) * fy * fx)


def axis_aligned(affine: torch.Tensor) -> bool:
    """Whether every homography of the batch maps rows to rows and columns to
    columns: no rotation, shear or perspective term."""
    return not bool(affine[:, 0, 1].any() or affine[:, 1, 0].any() or affine[:, 2, :2].any())


def _canvas_offset(s: int, mosaic: bool) -> float:
    return float(s) if mosaic else 0.5 * s  # half the canvas: 2S for mosaic4, else S


def _sample_separable(images: torch.Tensor, sel: torch.Tensor, center: torch.Tensor,
                      a_inv: torch.Tensor, s: int) -> torch.Tensor:
    """The warped images of axis-aligned inverse maps a_inv (B, 3, 3): output
    row i reads canvas row u(i), output column j canvas column v(j)."""
    b, mosaic = sel.shape[0], sel.shape[1] == 4
    offs = _canvas_offset(s, mosaic)
    ar = torch.arange(s, dtype=torch.float32, device=images.device)
    zero, one = torch.zeros_like(ar), torch.ones_like(ar)
    src_r = torch.stack([zero, ar, one], dim=-1) @ a_inv.transpose(1, 2)  # (B, S, 3)
    src_c = torch.stack([ar, zero, one], dim=-1) @ a_inv.transpose(1, 2)
    u = src_r[..., 1] / src_r[..., 2] + offs  # canvas row of output row i
    v = src_c[..., 0] / src_c[..., 2] + offs  # canvas column of output column j
    if not mosaic:
        src = sel[:, :1, None].expand(b, 1, s)
        return _separable_sample(images, src, u, v, torch.zeros_like(v, dtype=torch.long))
    yc, xc = center[:, 0, None], center[:, 1, None]  # (B, 1)
    bot, rgt = (u >= yc).long(), (v >= xc).long()
    y_loc = u - torch.where(bot == 1, yc, yc - s)
    x_loc = v - torch.where(rgt == 1, xc, xc - s)
    tile = 2 * bot[:, None, :] + torch.arange(2, device=images.device)[None, :, None]  # (B, 2, S)
    src = sel.gather(1, tile.flatten(1)).view(b, 2, s)
    return _separable_sample(images, src, y_loc, x_loc, rgt)


def _inverse_map(sel: torch.Tensor, center: torch.Tensor, a_inv: torch.Tensor, s: int,
                 step: int = 1):
    """The inverse map at every step-th output row and column: each pixel's
    mosaic tile (B, S/step, S/step) and its tile-local source row and column."""
    b, mosaic = sel.shape[0], sel.shape[1] == 4
    offs = _canvas_offset(s, mosaic)
    ar = torch.arange(0, s, step, dtype=torch.float32, device=a_inv.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (S', S', 3)
    src = pts[None] @ a_inv.transpose(1, 2)[:, None]  # (B, S', S', 3)
    u = src[..., 1] / src[..., 2] + offs
    v = src[..., 0] / src[..., 2] + offs
    if not mosaic:
        return torch.zeros_like(u, dtype=torch.long), u, v
    yc4, xc4 = center[:, 0, None, None], center[:, 1, None, None]
    right, bottom = (v >= xc4).long(), (u >= yc4).long()
    y_loc = u - torch.where(bottom == 1, yc4, yc4 - s)
    x_loc = v - torch.where(right == 1, xc4, xc4 - s)
    return right + 2 * bottom, y_loc, x_loc


def _sample_gather(images: torch.Tensor, sel: torch.Tensor, center: torch.Tensor,
                   a_inv: torch.Tensor, s: int) -> torch.Tensor:
    """The warped images of any inverse maps a_inv (B, 3, 3), four taps per pixel."""
    b = sel.shape[0]
    tile, y_loc, x_loc = _inverse_map(sel, center, a_inv, s)
    img_idx = sel.gather(1, tile.flatten(1)).view(b, s, s)
    return _bilinear_gather(images, img_idx, y_loc, x_loc)


def warp_masks(masks4: torch.Tensor, sel: torch.Tensor, center: torch.Tensor,
               a_inv: torch.Tensor, s: int) -> torch.Tensor:
    """Instance masks (B, n_src, M, Sm, Sm) of the selected sources through
    the image's inverse map, nearest -> (B, n_src * M, Sm, Sm): a pixel of
    slot q * M + m reads instance m of source q where the map lands in tile q."""
    b, n_src, m, sm = masks4.shape[:4]
    r = s // sm
    tile, y_loc, x_loc = _inverse_map(sel, center, a_inv, s, step=r)
    ys, xs = torch.round(y_loc / r).long(), torch.round(x_loc / r).long()
    inb = (ys >= 0) & (ys < sm) & (xs >= 0) & (xs < sm)
    bi = torch.arange(b, device=masks4.device)[:, None, None]
    sampled = masks4.permute(0, 1, 3, 4, 2)[bi, tile, ys.clamp(0, sm - 1), xs.clamp(0, sm - 1)]
    sampled = sampled * inb[..., None]  # (B, Sm, Sm, M)
    quad = torch.nn.functional.one_hot(tile, n_src).to(sampled.dtype)  # (B, Sm, Sm, n_src)
    out = quad[..., :, None] * sampled[..., None, :]  # (B, Sm, Sm, n_src, M)
    return out.permute(0, 3, 4, 1, 2).reshape(b, n_src * m, sm, sm)


def copy_paste(img01: torch.Tensor, cls: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
               masks: torch.Tensor, drawn: torch.Tensor, mode: str):
    """Paste the drawn instances that cover no existing box by ioa 0.30 or
    more: this image's mirrored ("flip") or the previous image's ("mixup").
    Returns img01, cls, boxes, valid and masks with the candidates appended."""
    b, s = img01.shape[:2]
    if mode == "mixup" and b > 1:
        fboxes, fmasks, fcls, fvalid, src = (t.roll(1, 0) for t in (boxes, masks, cls, valid,
                                                                    img01))
    else:
        fboxes = boxes.clone()
        fboxes[..., 0] = 1.0 - boxes[..., 0]
        fmasks, fcls, fvalid, src = masks.flip(-1), cls, valid, img01.flip(2)
    a, e = xywh2xyxy(fboxes)[:, :, None], xywh2xyxy(boxes)[:, None]
    iw = (torch.minimum(a[..., 2], e[..., 2]) - torch.maximum(a[..., 0], e[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], e[..., 3]) - torch.maximum(a[..., 1], e[..., 1])).clamp(min=0)
    ioa = iw * ih / (boxes[..., 2] * boxes[..., 3]).clamp(min=1e-9)[:, None, :]  # [cand, existing]
    ioa = torch.where(valid[:, None, :], ioa, 0.0)
    sel = fvalid & (ioa.amax(-1) < 0.30) & drawn
    paste = (fmasks * sel[..., None, None]).amax(1)  # (B, Sm, Sm)
    paste = nearest_resize(paste[:, None], (s, s))[:, 0]
    img01 = torch.where((paste > 0.5)[..., None], src, img01)
    return (img01, torch.cat([cls, fcls], 1), torch.cat([boxes, fboxes], 1),
            torch.cat([valid, sel], 1), torch.cat([masks, fmasks], 1))


def warp_kpts(kpts4: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, a: torch.Tensor,
              offs: float, s: int, valid: torch.Tensor) -> torch.Tensor:
    """Keypoints (B, n_src, M, K, 3) in their sources' letterbox pixels through
    the forward map -> (B, n_src * M, K, 3); off the canvas, or of a box the
    filter dropped (valid (B, n_src, M) False), a keypoint turns invisible."""
    b, n_src, m, k, _ = kpts4.shape
    px = kpts4[..., 0] + ox[..., None, None] - offs
    py = kpts4[..., 1] + oy[..., None, None] - offs
    out = torch.stack([px, py, torch.ones_like(px)], dim=-1) @ a.transpose(1, 2)[:, None, None]
    x, y = out[..., 0] / out[..., 2], out[..., 1] / out[..., 2]
    inb = (x >= 0) & (x < s) & (y >= 0) & (y < s)
    vis = kpts4[..., 2] * inb.to(kpts4.dtype) * valid[..., None].to(kpts4.dtype)
    return torch.stack([x, y, vis], dim=-1).reshape(b, n_src * m, k, 3)


def warp_rboxes(rboxes4: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, a: torch.Tensor,
                offs: float, s: int):
    """Rotated boxes (B, n_src, M, 5) (normalised cx, cy, w, h, angle) through
    the forward map as corners, refitted: the first edge's length and angle
    are w and the angle, the second's h; an angle past pi/2 (mod pi) swaps w
    and h and drops by pi/2. Returns ((B, n_src * M, 5), keep (B, n_src, M):
    both sides over 2 px and the centre inside the canvas)."""
    b, n_src, m, _ = rboxes4.shape
    cx = rboxes4[..., 0] * s + ox[..., None]
    cy = rboxes4[..., 1] * s + oy[..., None]
    w, h, ang = rboxes4[..., 2] * s, rboxes4[..., 3] * s, rboxes4[..., 4]
    ca, sa = torch.cos(ang), torch.sin(ang)
    ex = torch.stack([ca, sa], dim=-1) * w[..., None] * 0.5
    ey = torch.stack([-sa, ca], dim=-1) * h[..., None] * 0.5
    ctr = torch.stack([cx, cy], dim=-1)
    corners = torch.stack([ctr - ex - ey, ctr + ex - ey, ctr + ex + ey, ctr - ex + ey], dim=-2)
    ph = torch.cat([corners - offs, torch.ones_like(corners[..., :1])], dim=-1)
    out = ph @ a.transpose(1, 2)[:, None, None]
    p = out[..., :2] / out[..., 2:3]  # (B, n, M, 4, 2)
    e1, e2 = p[..., 1, :] - p[..., 0, :], p[..., 3, :] - p[..., 0, :]
    w_new, h_new = torch.linalg.vector_norm(e1, dim=-1), torch.linalg.vector_norm(e2, dim=-1)
    ang_mod = torch.remainder(torch.atan2(e1[..., 1], e1[..., 0]), math.pi)
    swap = ang_mod >= math.pi / 2
    w_c, h_c = torch.where(swap, h_new, w_new), torch.where(swap, w_new, h_new)
    ang_c = torch.where(swap, ang_mod - math.pi / 2, ang_mod)
    ctr_new = p.mean(dim=-2)
    keep = ((w_new > 2) & (h_new > 2) & (ctr_new[..., 0] > 0) & (ctr_new[..., 0] < s)
            & (ctr_new[..., 1] > 0) & (ctr_new[..., 1] < s))
    rb = torch.stack([ctr_new[..., 0] / s, ctr_new[..., 1] / s, w_c / s, h_c / s, ang_c], dim=-1)
    return rb.reshape(b, n_src * m, 5), keep


def flip_rbox_angle(rboxes: torch.Tensor, do_flip: torch.Tensor) -> torch.Tensor:
    """Mirror rotated boxes (B, M, 5) with angles in [0, pi/2) where do_flip
    (B,): the angle a becomes (-a) mod pi/2, and for a > 0, which crosses the
    seam, w and h swap (the mirrored width axis is the old height axis)."""
    a = rboxes[..., 4]
    f = do_flip[:, None]
    recanon = f & (a > 1e-7)
    out = rboxes.clone()
    out[..., 2] = torch.where(recanon, rboxes[..., 3], rboxes[..., 2])
    out[..., 3] = torch.where(recanon, rboxes[..., 2], rboxes[..., 3])
    out[..., 4] = torch.where(f, torch.remainder(-a, math.pi / 2), a)
    return out


def warp(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor, prm: AugParams,
         s: int, keypoints: torch.Tensor | None = None, rboxes: torch.Tensor | None = None):
    """Place and warp each output image from its n_src sources (JAX's _warp_one,
    batched): mosaic4 when prm.sel holds four sources, else single-source.
    images (N, S, S, 3) uint8; boxes (B, n_src, M, 4) normalised xywh and
    valid (B, n_src, M) of the selected sources, and their keypoints
    (B, n_src, M, K, 3) or rotated boxes (B, n_src, M, 5) when given. The
    separable sampler runs when every drawn homography is axis-aligned, the
    gather otherwise. Returns (img (B, S, S, 3) in 0..255, boxes (B, n_src*M,
    4), valid (B, n_src*M), the warped keypoints or rotated boxes or None);
    with rotated boxes, valid is theirs."""
    b, n_src, m = valid.shape
    dev = images.device
    mosaic = n_src == 4
    a, a_inv = prm.affine.float(), torch.linalg.inv(prm.affine.float())
    sample = _sample_separable if axis_aligned(a) else _sample_gather
    a, a_inv = a.to(dev), a_inv.to(dev)
    img = sample(images, prm.sel, prm.center, a_inv, s)
    offs = _canvas_offset(s, mosaic)

    # labels: the forward transform
    if mosaic:
        yc, xc = prm.center[:, 0, None], prm.center[:, 1, None]  # (B, 1)
        oy = torch.cat([yc - s, yc - s, yc, yc], dim=1)  # (B, 4) per-quadrant origin
        ox = torch.cat([xc - s, xc, xc - s, xc], dim=1)
    else:
        oy = ox = torch.zeros(b, n_src, device=dev)
    bx = boxes * s
    x1 = bx[..., 0] - bx[..., 2] / 2 + ox[..., None]
    y1 = bx[..., 1] - bx[..., 3] / 2 + oy[..., None]
    x2 = bx[..., 0] + bx[..., 2] / 2 + ox[..., None]
    y2 = bx[..., 1] + bx[..., 3] / 2 + oy[..., None]
    cx = torch.stack([x1, x2, x1, x2], dim=-1) - offs  # (B, n, M, 4 corners)
    cy = torch.stack([y1, y1, y2, y2], dim=-1) - offs
    ph = torch.stack([cx, cy, torch.ones_like(cx)], dim=-1)
    out = ph @ a.transpose(1, 2)[:, None, None]
    px, py = out[..., 0] / out[..., 2], out[..., 1] / out[..., 2]
    nx1, ny1 = px.amin(-1).clamp(0, s), py.amin(-1).clamp(0, s)
    nx2, ny2 = px.amax(-1).clamp(0, s), py.amax(-1).clamp(0, s)
    w_new, h_new = nx2 - nx1, ny2 - ny1
    # candidates (the reference's box_candidates): > 2 px, area ratio > 0.1, aspect < 100
    area_ratio = (w_new * h_new) / ((x2 - x1) * (y2 - y1) + 1e-16)
    aspect = torch.maximum(w_new / (h_new + 1e-16), h_new / (w_new + 1e-16))
    keep = (w_new > 2) & (h_new > 2) & (area_ratio > 0.10) & (aspect < 100)
    boxes_out = torch.stack([(nx1 + nx2) / 2 / s, (ny1 + ny2) / 2 / s, w_new / s, h_new / s],
                            dim=-1).reshape(b, n_src * m, 4)
    valid_out, extra = valid & keep, None
    if keypoints is not None:
        extra = warp_kpts(keypoints, oy, ox, a, offs, s, valid_out)
    if rboxes is not None:
        extra, rkeep = warp_rboxes(rboxes, oy, ox, a, offs, s)
        valid_out = valid & rkeep
    return img, boxes_out, valid_out.reshape(b, n_src * m), extra


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> HSV on [0, 1] floats, channels last."""
    r, g, b = rgb.unbind(-1)
    mx, mn = rgb.amax(-1), rgb.amin(-1)
    d = mx - mn + 1e-12
    h = torch.where(mx == r, torch.remainder((g - b) / d, 6.0),
                    torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0)) / 6.0
    return torch.stack([torch.remainder(h, 1.0), d / (mx + 1e-12), mx], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = h.floor()
    f = h - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = torch.remainder(i.long(), 6)

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def hsv_aug(img01: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """HSV jitter of (B, S, S, 3) in [0, 1] by per-image gains (B, 3)."""
    hsv = rgb_to_hsv(img01)
    g = gains[:, None, None, :]
    h = torch.remainder(hsv[..., 0] * g[..., 0], 1.0)
    s = (hsv[..., 1] * g[..., 1]).clamp(0, 1)
    v = (hsv[..., 2] * g[..., 2]).clamp(0, 1)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1)).clamp(0, 1)


def augment_apply(images: torch.Tensor, cls: torch.Tensor, bboxes: torch.Tensor,
                  mask: torch.Tensor, prm: AugParams, imgsz: int,
                  masks: torch.Tensor | None = None, keypoints: torch.Tensor | None = None,
                  rboxes: torch.Tensor | None = None):
    """Apply drawn parameters (JAX's _augment_impl); what runs follows from
    them alone: mosaic4 for four sources per image, each stage whose
    parameters were drawn.

    images (B, S, S, 3) uint8; cls (B, M); bboxes (B, M, 4) normalised xywh;
    mask (B, M); at most one of masks (B, M, Sm, Sm) 0/1 instance masks,
    keypoints (B, M, K, 3) in letterbox pixels and rboxes (B, M, 5). Returns
    (img01 (B, S, S, 3) f32 in [0, 1], cls (B, M'), bboxes (B, M', 4), mask
    (B, M') f32), M' = n_src * M, twice that with mixup or copy-paste, and
    the warped masks (B, M', Sm, Sm), keypoints (B, M', K, 3) or rotated
    boxes (B, M', 5) last when given.
    """
    b, m = cls.shape
    sel = prm.sel
    n_src = sel.shape[1]
    boxes4, valid4 = bboxes[sel], mask[sel] > 0  # (B, n, M, 4), (B, n, M)
    cls4 = cls[sel].reshape(b, n_src * m)
    img, boxes_out, valid, extra = warp(
        images, boxes4, valid4, prm, imgsz, None if keypoints is None else keypoints[sel].float(),
        None if rboxes is None else rboxes[sel].float())
    kpts_out = extra if keypoints is not None else None
    rboxes_out = extra if rboxes is not None else None
    masks_out = None
    if masks is not None:
        a_inv = torch.linalg.inv(prm.affine.float()).to(images.device)
        masks_out = warp_masks(masks[sel].float(), sel, prm.center, a_inv, imgsz)
    img01 = img / 255.0
    if prm.photometric is not None:
        img01 = photometric_apply(img01, prm.photometric)
    if prm.hsv_gain is not None:  # all-zero gains are the identity, and skipped
        img01 = hsv_aug(img01, prm.hsv_gain)
    if prm.copy_paste is not None and masks_out is not None:
        img01, cls4, boxes_out, valid, masks_out = copy_paste(
            img01, cls4, boxes_out, valid, masks_out, prm.copy_paste, prm.copy_paste_mode)

    for gate, dim, coord in ((prm.fliplr, 2, 0), (prm.flipud, 1, 1)):  # x on fliplr, y on flipud
        if gate is not None and bool(gate.any()):
            img01 = apply_where(img01, gate, lambda x, _i, d=dim: x.flip(d))
            g = gate.to(boxes_out.device)[:, None]
            boxes_out = boxes_out.clone()
            boxes_out[..., coord] = torch.where(g, 1.0 - boxes_out[..., coord],
                                                boxes_out[..., coord])
            if masks_out is not None:
                masks_out = torch.where(g[..., None, None], masks_out.flip(dim + 1), masks_out)
            if rboxes_out is not None:
                rboxes_out = rboxes_out.clone()
                rboxes_out[..., coord] = torch.where(g, 1.0 - rboxes_out[..., coord],
                                                     rboxes_out[..., coord])
                rboxes_out = flip_rbox_angle(rboxes_out, gate.to(rboxes_out.device))

    if prm.mixup is not None and extra is None and masks_out is None:  # each with the next
        other = torch.roll(torch.arange(b, device=img01.device), -1)
        lam = prm.mixup_lam.to(img01.dtype)[:, None, None, None]
        mixed = lam * img01 + (1 - lam) * img01[other]
        img01 = torch.where(prm.mixup[:, None, None, None], mixed, img01)
        boxes_out = torch.cat([boxes_out, boxes_out[other]], dim=1)
        cls4 = torch.cat([cls4, cls4[other]], dim=1)
        valid = torch.cat([valid, valid[other] & prm.mixup[:, None]], dim=1)

    if prm.bgr is not None:
        img01 = bgr_swap_batch(img01, prm.bgr)
    boxes_out = boxes_out * valid[..., None]
    if masks_out is not None:
        return img01, cls4, boxes_out, valid.float(), masks_out * valid[:, :, None, None]
    if kpts_out is not None:
        return img01, cls4, boxes_out, valid.float(), kpts_out
    if rboxes_out is not None:
        return img01, cls4, boxes_out, valid.float(), rboxes_out * valid[..., None]
    return img01, cls4, boxes_out, valid.float()


def augment_batch(images: torch.Tensor, cls: torch.Tensor, bboxes: torch.Tensor,
                  mask: torch.Tensor, gen: torch.Generator, imgsz: int, hyp: dict,
                  mosaic: bool = True, masks: torch.Tensor | None = None,
                  keypoints: torch.Tensor | None = None, rboxes: torch.Tensor | None = None):
    """Draw one step's parameters from `gen` and apply them on images' device."""
    prm = sample_params(images.shape[0], imgsz, hyp, mosaic, gen,
                        m=cls.shape[1] if masks is not None else 0,
                        keypoints=keypoints is not None)
    return augment_apply(images, cls, bboxes, mask, prm.to(images.device), imgsz, masks,
                         keypoints, rboxes)


@dataclass
class ClassifyParams:
    """One classify step's random draws; the batch is the first dim."""

    crop: torch.Tensor  # (B, 4) oy, ox, ch, cw of the random-resized crop, in pixels
    fliplr: torch.Tensor | None  # (B,) bool
    flipud: torch.Tensor | None  # (B,) bool
    hsv_gain: torch.Tensor | None  # (B, 3)
    ra_ops: torch.Tensor | None  # (B, num_ops) long: RandAugment op indices
    ra_signs: torch.Tensor | None  # (B, num_ops) +-1
    erase: torch.Tensor | None  # (B,) bool
    erase_box: torch.Tensor | None  # (B, 4) oy, ox, eh, ew


def place(off: torch.Tensor, h: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    """(oy, ox, h, w): an h x w box at `off` (B, 2) of the free space of s x s."""
    return torch.stack([off[:, 0] * (s - h), off[:, 1] * (s - w), h, w], dim=1)


def sample_classify_params(b: int, s: int, hyp: dict, gen: torch.Generator) -> ClassifyParams:
    """Draw one classify step's parameters for b images of s x s pixels."""
    smin = max(1.0 - _hyp(hyp, "scale", 0.5), 0.05)
    area = _uniform(gen, (b,), smin, 1.0)
    ratio = torch.exp(_uniform(gen, (b,), math.log(3 / 4), math.log(4 / 3)))
    cw = torch.clamp(s * torch.sqrt(area * ratio), max=float(s))
    ch = torch.clamp(s * torch.sqrt(area / ratio), max=float(s))
    crop = place(torch.rand(b, 2, generator=gen), ch, cw, s)
    plr, pud = _hyp(hyp, "fliplr", 0.5), _hyp(hyp, "flipud", 0.0)
    fliplr = torch.rand(b, generator=gen) < plr if plr > 0 else None
    flipud = torch.rand(b, generator=gen) < pud if pud > 0 else None
    gains = torch.tensor([_hyp(hyp, "hsv_h", 0.015), _hyp(hyp, "hsv_s", 0.7),
                          _hyp(hyp, "hsv_v", 0.4)])
    hsv_gain = _uniform(gen, (b, 3), -1.0, 1.0) * gains + 1.0 if bool(gains.any()) else None
    ra_ops = ra_signs = None
    if str(hyp.get("auto_augment", "") or "") == "randaugment":
        ra_ops, ra_signs = sample_rand_augment(b, gen)
    per = _hyp(hyp, "erasing", 0.0)
    erase = erase_box = None
    if per > 0:
        erase = torch.rand(b, generator=gen) < per
        area = _uniform(gen, (b,), 0.02, 0.33) * s * s
        r = torch.exp(_uniform(gen, (b,), math.log(0.3), math.log(3.3)))
        eh = torch.clamp(torch.sqrt(area * r), max=float(s))
        ew = torch.clamp(torch.sqrt(area / r), max=float(s))
        erase_box = place(torch.rand(b, 2, generator=gen), eh, ew, s)
    return ClassifyParams(crop, fliplr, flipud, hsv_gain, ra_ops, ra_signs, erase, erase_box)


def classify_apply(images: torch.Tensor, prm: ClassifyParams) -> torch.Tensor:
    """Apply drawn parameters to uint8 (B, S, S, 3) images: float (B, S, S, 3)
    in [0, 1] (JAX's classify_augment_batch). The draws reach the device in
    one copy; the stages drawn as off are skipped on the host."""
    b, s = images.shape[:2]
    dev = images.device
    zeros = torch.zeros(b)
    host = torch.cat([prm.crop.float(), torch.stack([
        zeros if g is None else g.float() for g in (prm.fliplr, prm.flipud, prm.erase)], 1),
        zeros[:, None].expand(b, 3) if prm.hsv_gain is None else prm.hsv_gain.float(),
        zeros[:, None].expand(b, 4) if prm.erase_box is None else prm.erase_box.float()], 1)
    d = to_device(host, dev)  # (B, 14): crop 4, fliplr, flipud, erase, hsv 3, erase box 4
    img01 = images.float() / 255.0
    oy, ox, ch, cw = (d[:, i, None] for i in range(4))
    t = (torch.arange(s, device=dev) + 0.5) / s
    ys, xs = oy + t * ch - 0.5, ox + t * cw - 0.5  # (B, S) source rows and columns
    img01 = _bilinear_gather(img01, torch.arange(b, device=dev)[:, None, None].expand(b, s, s),
                             ys[:, :, None].expand(b, s, s), xs[:, None, :].expand(b, s, s))
    for gate, col, dim in ((prm.fliplr, 4, 2), (prm.flipud, 5, 1)):
        if gate is not None and bool(gate.any()):
            img01 = torch.where(d[:, col, None, None, None] > 0, img01.flip(dim), img01)
    if prm.hsv_gain is not None:
        img01 = hsv_aug(img01, d[:, 7:10])
    if prm.ra_ops is not None:
        img01 = rand_augment_apply(img01, prm.ra_ops, prm.ra_signs)
    if prm.erase is not None:
        eoy, eox, eh, ew = (d[:, i, None, None] for i in range(10, 14))
        yy = torch.arange(s, dtype=torch.float32, device=dev)[None, :, None]
        xx = torch.arange(s, dtype=torch.float32, device=dev)[None, None, :]
        inside = (yy >= eoy) & (yy < eoy + eh) & (xx >= eox) & (xx < eox + ew)
        img01 = torch.where((inside & (d[:, 6, None, None] > 0))[..., None], 0.0, img01)
    return img01


def classify_augment_batch(images: torch.Tensor, gen: torch.Generator, hyp: dict) -> torch.Tensor:
    """Draw one classify step's parameters from `gen` and apply them on images' device."""
    return classify_apply(images, sample_classify_params(images.shape[0], images.shape[1], hyp,
                                                         gen))
