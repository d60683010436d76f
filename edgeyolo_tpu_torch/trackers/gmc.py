"""Global motion compensation for BoT-SORT in numpy (edgeyolo_tpu/trackers/gmc.py).

Method "sparseOptFlow": Shi-Tomasi corner response with one corner per grid
cell, two-level iterative Lucas-Kanade flow, and a RANSAC similarity
(partial-affine) fit whose samples come from `np.random.RandomState(seed)`,
the JAX package's draws. Returns a 2x3 warp from the previous frame's
coordinates to this frame's; the identity on the first frame or when
tracking fails.
"""

from __future__ import annotations

import numpy as np

_EYE23 = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)


def _gray(img: np.ndarray) -> np.ndarray:
    g = img.mean(axis=2) if img.ndim == 3 else img.astype(np.float32)
    return g.astype(np.float32)


def _downscale(g: np.ndarray, k: int = 2) -> np.ndarray:
    h, w = g.shape
    h2, w2 = h // k * k, w // k * k
    return g[:h2, :w2].reshape(h2 // k, k, w2 // k, k).mean(axis=(1, 3))


def _sobel(g: np.ndarray):
    gp = np.pad(g, 1, mode="edge")
    ix = (gp[1:-1, 2:] - gp[1:-1, :-2]) * 0.5
    iy = (gp[2:, 1:-1] - gp[:-2, 1:-1]) * 0.5
    return ix, iy


def _box_filter(a: np.ndarray, r: int) -> np.ndarray:
    """Separable box sum over a (2r+1) window via cumulative sums."""
    ap = np.pad(a, r + 1, mode="edge")
    c = ap.cumsum(0)
    a1 = c[2 * r + 1 :, :] - c[: -(2 * r + 1), :]
    c = a1.cumsum(1)
    return c[:, 2 * r + 1 :] - c[:, : -(2 * r + 1)]


def _shi_tomasi(g: np.ndarray, max_corners: int = 300, quality: float = 0.01,
                cell: int = 16) -> np.ndarray:
    """Corner points (N, 2) as (x, y): min-eigenvalue response, one best
    corner per cell (grid NMS doubles as minDistance)."""
    ix, iy = _sobel(g)
    a = _box_filter(ix * ix, 2)
    b = _box_filter(ix * iy, 2)
    c = _box_filter(iy * iy, 2)
    lam = (a + c) / 2 - np.sqrt(((a - c) / 2) ** 2 + b * b)
    thr = quality * lam.max() if lam.size else 0.0
    h, w = g.shape
    pts = []
    for y0 in range(0, h - cell, cell):
        for x0 in range(0, w - cell, cell):
            blk = lam[y0 : y0 + cell, x0 : x0 + cell]
            j = int(blk.argmax())
            by, bx = divmod(j, blk.shape[1])
            if blk[by, bx] > thr:
                pts.append((x0 + bx, y0 + by))
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    if len(pts) > max_corners:
        # keep strongest responses
        resp = lam[pts[:, 1].astype(int), pts[:, 0].astype(int)]
        pts = pts[np.argsort(-resp)[:max_corners]]
    return pts


def _bilinear(g: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h, w = g.shape
    x = np.clip(x, 0, w - 1.001)
    y = np.clip(y, 0, h - 1.001)
    x0 = x.astype(int)
    y0 = y.astype(int)
    fx = x - x0
    fy = y - y0
    return (g[y0, x0] * (1 - fx) * (1 - fy) + g[y0, x0 + 1] * fx * (1 - fy)
            + g[y0 + 1, x0] * (1 - fx) * fy + g[y0 + 1, x0 + 1] * fx * fy)


def _lk_level(prev: np.ndarray, cur: np.ndarray, pts: np.ndarray,
              guess: np.ndarray, win: int = 10, iters: int = 8):
    """Iterative LK at one level. pts (N,2) in prev; guess (N,2) displacement.
    Returns (flow (N,2), ok (N,) bool)."""
    n = len(pts)
    if n == 0:
        return guess, np.zeros(0, bool)
    ys, xs = np.mgrid[-win : win + 1, -win : win + 1]
    gx = pts[:, 0, None, None] + xs[None]
    gy = pts[:, 1, None, None] + ys[None]
    tpl = _bilinear(prev, gx, gy)  # (N, W, W)
    ixp, iyp = _sobel(prev)
    jx = _bilinear(ixp, gx, gy)
    jy = _bilinear(iyp, gx, gy)
    a11 = (jx * jx).sum((1, 2))
    a12 = (jx * jy).sum((1, 2))
    a22 = (jy * jy).sum((1, 2))
    det = a11 * a22 - a12 * a12
    ok = det > 1e-4
    det = np.where(ok, det, 1.0)
    d = guess.copy()
    for _ in range(iters):
        cx = gx + d[:, 0, None, None]
        cy = gy + d[:, 1, None, None]
        err = _bilinear(cur, cx, cy) - tpl
        b1 = (err * jx).sum((1, 2))
        b2 = (err * jy).sum((1, 2))
        du = -(a22 * b1 - a12 * b2) / det
        dv = -(-a12 * b1 + a11 * b2) / det
        d[:, 0] += np.where(ok, du, 0.0)
        d[:, 1] += np.where(ok, dv, 0.0)
    # validity: converged flow keeps the residual small
    cx = gx + d[:, 0, None, None]
    cy = gy + d[:, 1, None, None]
    res = np.abs(_bilinear(cur, cx, cy) - tpl).mean((1, 2))
    ok = ok & (res < 12.0) & np.isfinite(d).all(1)
    return d, ok


def _lk_pyramidal(prev: np.ndarray, cur: np.ndarray, pts: np.ndarray):
    """Two-level pyramid LK."""
    p2, c2 = _downscale(prev), _downscale(cur)
    d2, _ = _lk_level(p2, c2, pts / 2.0, np.zeros_like(pts))
    d, ok = _lk_level(prev, cur, pts, d2 * 2.0)
    return d, ok


def _fit_similarity(src: np.ndarray, dst: np.ndarray):
    """Least-squares similarity (scale, rotation, translation): dst ~ sR src + t.
    Returns 2x3 matrix."""
    ms, md = src.mean(0), dst.mean(0)
    s_, d_ = src - ms, dst - md
    a = (s_ * d_).sum()
    b = (s_[:, 0] * d_[:, 1] - s_[:, 1] * d_[:, 0]).sum()
    denom = (s_ * s_).sum()
    if denom < 1e-9:
        return _EYE23.copy()
    ca, sa = a / denom, b / denom
    t = md - np.array([ca * ms[0] - sa * ms[1], sa * ms[0] + ca * ms[1]])
    return np.array([[ca, -sa, t[0]], [sa, ca, t[1]]], np.float32)


def _ransac_similarity(src: np.ndarray, dst: np.ndarray, thresh: float = 3.0,
                       iters: int = 60, seed: int = 0):
    n = len(src)
    if n < 2:
        return _EYE23.copy()
    rng = np.random.RandomState(seed)
    best_inl = None
    best_cnt = 1
    for _ in range(iters):
        i, j = rng.randint(0, n, 2)
        if i == j:
            continue
        H = _fit_similarity(src[[i, j]], dst[[i, j]])
        pred = src @ H[:, :2].T + H[:, 2]
        inl = np.linalg.norm(pred - dst, axis=1) < thresh
        c = int(inl.sum())
        if c > best_cnt:
            best_cnt, best_inl = c, inl
    if best_inl is None or best_cnt < max(4, n // 10):
        return _EYE23.copy()
    return _fit_similarity(src[best_inl], dst[best_inl])


class GMC:
    """Sparse-optical-flow global motion estimator (reference gmc.py:11)."""

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        if method in ("none", "None", None):
            method = "none"
        elif method != "sparseOptFlow":
            # orb/sift/ecc need feature descriptors; sparseOptFlow is the
            # reference default and the one implemented natively here
            method = "sparseOptFlow"
        self.method = method
        self.downscale = max(1, int(downscale))
        self.prev = None

    def reset(self):
        self.prev = None

    def apply(self, img: np.ndarray, dets=None) -> np.ndarray:
        """Estimate the 2x3 warp from the previous frame to this frame."""
        if self.method == "none":
            return _EYE23.copy()
        g = _gray(np.asarray(img))
        if self.downscale > 1:
            g = _downscale(g, self.downscale)
        if self.prev is None or self.prev.shape != g.shape:
            self.prev = g
            return _EYE23.copy()
        pts = _shi_tomasi(self.prev)
        if len(pts) < 8:
            self.prev = g
            return _EYE23.copy()
        flow, ok = _lk_pyramidal(self.prev, g, pts)
        src = pts[ok]
        dst = (pts + flow)[ok]
        self.prev = g
        if len(src) < 4:
            return _EYE23.copy()
        H = _ransac_similarity(src, dst)
        H = H.copy()
        H[:, 2] *= self.downscale  # translation back to full-res pixels
        return H
