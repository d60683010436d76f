"""Instance-mask ops (edgeyolo_tpu/ops/boxes.py crop_mask and
edgeyolo_tpu/ops/segments.py).

- `crop_mask`: zero each mask outside its box, half-open: a pixel (c, r)
  stays where x1 <= c < x2 and y1 <= r < y2.
- `proto_masks`: the kept rows' coefficients against the prototypes,
  sigmoid, cropped to the box scaled onto the prototype grid: the segment
  predictor's masks at prototype resolution.
- `unletterbox_masks`: crop the letterbox pad (rounded to whole pixels) and
  resize to the original frame by jax.image.resize's bilinear rule
  (ops/resize.py).
- `masks2segments`: masks -> polygons by JAX's no-cv2 path, a Moore trace of
  the outline starting at the topmost-leftmost pixel (`_numpy_outline`),
  not cv2.findContours: the port imports no cv2 (ROADMAP C.14).
"""

from __future__ import annotations

import numpy as np
import torch

from edgeyolo_tpu_torch.ops.resize import resize_bilinear


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """masks (..., N, H, W) times the inside of the xyxy boxes (..., N, 4)."""
    h, w = masks.shape[-2:]
    x1, y1, x2, y2 = boxes[..., None, None].unbind(-3)
    c = torch.arange(w, dtype=boxes.dtype, device=boxes.device)
    r = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[:, None]
    return masks * ((c >= x1) & (c < x2) & (r >= y1) & (r < y2))


def proto_masks(proto: torch.Tensor, coefs: torch.Tensor, boxes: torch.Tensor,
                imgsz: int) -> torch.Tensor:
    """proto (B, nm, h, w), the kept rows' coefficients (B, D, nm) and xyxy
    input-pixel boxes (B, D, 4) -> cropped sigmoid masks (B, D, h, w) in f32."""
    masks = torch.sigmoid(torch.einsum("bnhw,bdn->bdhw", proto.float(), coefs.float()))
    return crop_mask(masks, boxes.float() * (masks.shape[2] / imgsz))


def unletterbox_masks(masks: torch.Tensor, pad: tuple[float, float],
                      orig_shape: tuple[int, int]) -> torch.Tensor:
    """(N, H, W) masks of the letterboxed input (or its prototype grid, with
    the pad scaled to it) -> (N, h0, w0) over the original frame: the pad
    crop, then bilinear as jax.image.resize. A bool input comes back
    thresholded at 0.5, any other in its dtype."""
    if masks.numel() == 0:
        return masks.new_zeros((masks.shape[0], *orig_shape))
    h, w = masks.shape[1:]
    x0, y0 = int(round(pad[0])), int(round(pad[1]))
    cropped = masks[:, y0:h - y0, x0:w - x0].float()
    out = resize_bilinear(cropped[None], tuple(orig_shape))[0]
    return out > 0.5 if masks.dtype == torch.bool else out.to(masks.dtype)


_NBRS = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]  # N, clockwise


def _numpy_outline(mask: np.ndarray) -> np.ndarray:
    """The ordered outline (K, 2) float32 xy of a binary mask: Moore
    boundary tracing, 8-neighbours clockwise, from the topmost-leftmost
    foreground pixel until it comes back to it."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return np.zeros((0, 2), np.float32)
    pad = np.zeros((mask.shape[0] + 2, mask.shape[1] + 2), bool)
    pad[1:-1, 1:-1] = mask.astype(bool)
    sy, sx = int(ys.min() + 1), int(xs[ys == ys.min()].min() + 1)
    contour = [(sy, sx)]
    y, x = sy, sx
    py, px = sy, sx - 1  # the background pixel looked at before entering (y, x)
    for _ in range(4 * mask.size):
        pi = _NBRS.index((py - y, px - x))
        for k in range(1, 9):
            dy, dx = _NBRS[(pi + k) % 8]
            if pad[y + dy, x + dx]:
                by, bx = _NBRS[(pi + k - 1) % 8]
                py, px = y + by, x + bx
                y, x = y + dy, x + dx
                break
        else:  # an isolated pixel
            break
        if (y, x) == (sy, sx):
            break
        contour.append((y, x))
    return np.asarray(contour, np.float32)[:, ::-1] - 1.0


def masks2segments(masks) -> list[np.ndarray]:
    """(N, H, W) masks (bool, or probabilities cut at 0.5) -> one (K, 2)
    float32 xy polygon per mask."""
    arr = masks.detach().cpu().numpy() if isinstance(masks, torch.Tensor) else np.asarray(masks)
    return [_numpy_outline(np.asarray(m) > 0.5) for m in arr]
