"""Drawing for Results.plot and feature maps (edgeyolo_tpu/utils/plotting.py,
and the PIL ImageDraw calls of edgeyolo_tpu/engine/results.py).

`rectangle` follows PIL's ImageDraw.rectangle pixel for pixel (coordinates
truncated to int, both corners inclusive, an outline of `width` drawn
inward; Pillow's draw.c ImagingDrawRectangle); `ellipse` follows PIL's
filled ImageDraw.ellipse (Pillow's integer quarter-ellipse scan) and
`line` PIL's ImageDraw.line with a width over 1 (each segment's integer
end points widened into a quadrilateral, filled by Pillow's polygon scan
with its corner rules). Text is a 5 x 9 bitmap font
drawn by hand for this module (no third-party font data), scaled by
nearest neighbour so that at a font size S
its capitals stand 0.75 S above the baseline and its descenders 2/7 of that
below it, which is where PIL's default FreeType font puts its ink; the
glyph shapes differ from that font's. `feature_visualization` writes the
first channels of a feature map as one greyscale grid PNG, named as JAX
names it; the grid's layout is this module's own (matplotlib is not a
dependency of the port).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.data.imageio import save_png

# rows 0-6 stand on the baseline (capitals and digits rows 0-6, lower case
# rows 2-6); rows 7-8 are descenders. Missing rows are blank.
_GLYPHS = {
    " ": "", "!": "..#../..#../..#../..#../..#../...../..#..",
    '"': ".#.#./.#.#./.#.#.", "#": ".#.#./.#.#./#####/.#.#./#####/.#.#./.#.#.",
    "$": "..#../.####/#.#../.###./..#.#/####./..#..", "%": "##.../##..#/...#./..#../.#.../#..##/...##",
    "&": ".##../#..#./#.#../.#.../#.#.#/#..#./.##.#", "'": "..#../..#../..#..",
    "(": "...#./..#../.#.../.#.../.#.../..#../...#.", ")": ".#.../..#../...#./...#./...#./..#../.#...",
    "*": "...../..#../#.#.#/.###./#.#.#/..#../.....", "+": "...../..#../..#../#####/..#../..#../.....",
    ",": "...../...../...../...../...../..##./..##./..#../.#...", "-": "...../...../...../#####",
    ".": "...../...../...../...../...../.##../.##..", "/": "...../....#/...#./..#../.#.../#..../.....",
    "0": ".###./#...#/#..##/#.#.#/##..#/#...#/.###.", "1": "..#../.##../..#../..#../..#../..#../.###.",
    "2": ".###./#...#/....#/...#./..#../.#.../#####", "3": "#####/...#./..#../...#./....#/#...#/.###.",
    "4": "...#./..##./.#.#./#..#./#####/...#./...#.", "5": "#####/#..../####./....#/....#/#...#/.###.",
    "6": "..##./.#.../#..../####./#...#/#...#/.###.", "7": "#####/....#/...#./..#../.#.../.#.../.#...",
    "8": ".###./#...#/#...#/.###./#...#/#...#/.###.", "9": ".###./#...#/#...#/.####/....#/...#./.##..",
    ":": "...../.##../.##../...../.##../.##../.....", ";": "...../.##../.##../...../.##../.##../.#...",
    "<": "...#./..#../.#.../#..../.#.../..#../...#.", "=": "...../...../#####/...../#####",
    ">": ".#.../..#../...#./....#/...#./..#../.#...", "?": ".###./#...#/....#/...#./..#../...../..#..",
    "@": ".###./#...#/....#/.##.#/#.#.#/#.#.#/.###.", "A": ".###./#...#/#...#/#####/#...#/#...#/#...#",
    "B": "####./#...#/#...#/####./#...#/#...#/####.", "C": ".###./#...#/#..../#..../#..../#...#/.###.",
    "D": "###../#..#./#...#/#...#/#...#/#..#./###..", "E": "#####/#..../#..../####./#..../#..../#####",
    "F": "#####/#..../#..../####./#..../#..../#....", "G": ".###./#...#/#..../#.###/#...#/#...#/.####",
    "H": "#...#/#...#/#...#/#####/#...#/#...#/#...#", "I": ".###./..#../..#../..#../..#../..#../.###.",
    "J": "..###/...#./...#./...#./...#./#..#./.##..", "K": "#...#/#..#./#.#../##.../#.#../#..#./#...#",
    "L": "#..../#..../#..../#..../#..../#..../#####", "M": "#...#/##.##/#.#.#/#.#.#/#...#/#...#/#...#",
    "N": "#...#/#...#/##..#/#.#.#/#..##/#...#/#...#", "O": ".###./#...#/#...#/#...#/#...#/#...#/.###.",
    "P": "####./#...#/#...#/####./#..../#..../#....", "Q": ".###./#...#/#...#/#...#/#.#.#/#..#./.##.#",
    "R": "####./#...#/#...#/####./#.#../#..#./#...#", "S": ".####/#..../#..../.###./....#/....#/####.",
    "T": "#####/..#../..#../..#../..#../..#../..#..", "U": "#...#/#...#/#...#/#...#/#...#/#...#/.###.",
    "V": "#...#/#...#/#...#/#...#/#...#/.#.#./..#..", "W": "#...#/#...#/#...#/#.#.#/#.#.#/#.#.#/.#.#.",
    "X": "#...#/#...#/.#.#./..#../.#.#./#...#/#...#", "Y": "#...#/#...#/#...#/.#.#./..#../..#../..#..",
    "Z": "#####/....#/...#./..#../.#.../#..../#####", "[": ".###./.#.../.#.../.#.../.#.../.#.../.###.",
    "\\": "...../#..../.#.../..#../...#./....#/.....", "]": ".###./...#./...#./...#./...#./...#./.###.",
    "^": "..#../.#.#./#...#", "_": "...../...../...../...../...../...../.....//#####",
    "`": ".#.../..#../...#.", "a": "...../...../.###./....#/.####/#...#/.####",
    "b": "#..../#..../#.##./##..#/#...#/#...#/####.", "c": "...../...../.###./#..../#..../#...#/.###.",
    "d": "....#/....#/.##.#/#..##/#...#/#...#/.####", "e": "...../...../.###./#...#/#####/#..../.###.",
    "f": "..##./.#..#/.#.../###../.#.../.#.../.#...",
    "g": "...../...../.####/#...#/#...#/.####/....#/#...#/.###.",
    "h": "#..../#..../#.##./##..#/#...#/#...#/#...#", "i": "..#../...../.##../..#../..#../..#../.###.",
    "j": "...#./...../..##./...#./...#./...#./...#./#..#./.##..",
    "k": "#..../#..../#..#./#.#../##.../#.#../#..#.", "l": ".##../..#../..#../..#../..#../..#../.###.",
    "m": "...../...../##.#./#.#.#/#.#.#/#...#/#...#", "n": "...../...../#.##./##..#/#...#/#...#/#...#",
    "o": "...../...../.###./#...#/#...#/#...#/.###.",
    "p": "...../...../####./#...#/#...#/####./#..../#..../#....",
    "q": "...../...../.####/#...#/#...#/.####/....#/....#/....#",
    "r": "...../...../#.##./##..#/#..../#..../#....", "s": "...../...../.####/#..../.###./....#/####.",
    "t": ".#.../.#.../###../.#.../.#.../.#..#/..##.", "u": "...../...../#...#/#...#/#...#/#..##/.##.#",
    "v": "...../...../#...#/#...#/#...#/.#.#./..#..", "w": "...../...../#...#/#...#/#.#.#/#.#.#/.#.#.",
    "x": "...../...../#...#/.#.#./..#../.#.#./#...#",
    "y": "...../...../#...#/#...#/#...#/.####/....#/#...#/.###.",
    "z": "...../...../#####/...#./..#../.#.../#####", "{": "...#./..#../..#../.#.../..#../..#../...#.",
    "|": "..#../..#../..#../..#../..#../..#../..#..", "}": ".#.../..#../..#../...#./..#../..#../.#...",
    "~": "...../...../.#.../#.#.#/...#.",
}
_BOX = "#####/#...#/#...#/#...#/#...#/#...#/#####"  # a character with no glyph


def _bitmap(ch: str) -> np.ndarray:
    rows = _GLYPHS.get(ch, _BOX).split("/") if _GLYPHS.get(ch, _BOX) else []
    g = np.zeros((9, 5), bool)
    for r, row in enumerate(rows):
        g[r] = [c == "#" for c in row] if row else False
    return g


_BITMAPS = {ch: _bitmap(ch) for ch in _GLYPHS}


class BitmapFont:
    """The 5 x 9 font at size S: a pixel of the glyph is s = 0.75 S / 7 high
    and 0.8 s wide (so a line of text is about as long as PIL's default
    font's), and a character advances 6 glyph pixels."""

    def __init__(self, size: int):
        self.size = int(size)
        s = 0.75 * self.size / 7
        sx = 0.8 * s
        self.cell_w, self.cap, self.desc = round(5 * sx), round(7 * s), round(2 * s)
        self.advance = max(round(6 * sx), self.cell_w + 1)
        rows = np.minimum((np.arange(self.cap + self.desc) / s).astype(int), 8)
        cols = np.minimum((np.arange(self.cell_w) / sx).astype(int), 4)
        self._cells = {ch: b[rows][:, cols] for ch, b in _BITMAPS.items()}
        self._box = _bitmap("\0")[rows][:, cols]

    def _glyph(self, ch: str) -> np.ndarray:
        return self._cells.get(ch, self._box)

    def mask(self, text: str) -> tuple[np.ndarray, int]:
        """(ink (H, W) bool, top): the text's ink from the top of its cap
        height, and that top's offset below the drawing origin (S - cap)."""
        w = max(self.advance * len(text), 1)
        m = np.zeros((self.cap + self.desc, w), bool)
        for k, ch in enumerate(text):
            m[:, k * self.advance:k * self.advance + self.cell_w] = self._glyph(ch)
        return m, self.size - self.cap

    def getbbox(self, text: str) -> tuple[int, int, int, int]:
        """The ink's box from the origin, as PIL's `font.getbbox`."""
        m, top = self.mask(text)
        ys, xs = np.nonzero(m)
        if not len(ys):
            return 0, top, 0, top
        return int(xs.min()), top + int(ys.min()), int(xs.max()) + 1, top + int(ys.max()) + 1


def _hline(img: np.ndarray, x0: int, y: int, x1: int, color) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h:
        x0, x1 = max(x0, 0), min(x1, w - 1)
        if x0 <= x1:
            img[y, x0:x1 + 1] = color


def _vline(img: np.ndarray, x: int, y0: int, y1: int, color) -> None:
    """PIL's line8/line32 for dx = 0: |y1 - y0| pixels from y0 toward y1 (y1 excluded)."""
    h, w = img.shape[:2]
    if not 0 <= x < w:
        return
    step = 1 if y1 >= y0 else -1
    for y in range(y0, y1, step):
        if 0 <= y < h:
            img[y, x] = color


def rectangle(img: np.ndarray, xy, color, width: int = 1, fill: bool = False) -> None:
    """PIL's ImageDraw.rectangle(xy, outline=color, width=width), or with
    `fill` its rectangle(xy, fill=color), on an HWC uint8 image in place."""
    x0, y0, x1, y1 = (int(v) for v in xy)  # truncation toward zero, as Pillow's C call
    if y0 > y1:
        y0, y1 = y1, y0
    if fill:
        h = img.shape[0]
        if y0 >= h or y1 < 0:
            return
        for y in range(max(y0, 0), min(y1, h) + 1):
            _hline(img, x0, y, x1, color)
        return
    width = width or 1
    for i in range(width):
        _hline(img, x0, y0 + i, x1, color)
        _hline(img, x0, y1 - i, x1, color)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, color)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, color)


def _round_up(f: float) -> int:
    """Pillow's ROUND_UP: half away from zero."""
    return int(math.floor(f + 0.5)) if f >= 0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    """Pillow's ROUND_DOWN: half toward zero."""
    return int(math.ceil(f - 0.5)) if f >= 0 else -int(math.ceil(abs(f) - 0.5))


class _Quarter:
    """Pillow's quarter_state: one quarter of an ellipse on a grid of step 2."""

    def __init__(self, a: int, b: int):
        self.finished = a < 0 or b < 0
        if not self.finished:
            self.cx, self.cy, self.ex, self.ey = a, b % 2, a % 2, b
            self.a2, self.b2 = a * a, b * b
            self.a2b2 = self.a2 * self.b2

    def _delta(self, x: int, y: int) -> int:
        return abs(self.a2 * y * y + self.b2 * x * x - self.a2b2)

    def next(self):
        if self.finished:
            return None
        ret = (self.cx, self.cy)
        if self.cx == self.ex and self.cy == self.ey:
            self.finished = True
        else:
            nx, ny = self.cx, self.cy + 2
            nd = self._delta(nx, ny)
            if nx > 1:
                d = self._delta(self.cx - 2, self.cy + 2)
                if nd > d:
                    nx, ny, nd = self.cx - 2, self.cy + 2, d
                d = self._delta(self.cx - 2, self.cy)
                if nd > d:
                    nx, ny = self.cx - 2, self.cy
            self.cx, self.cy = nx, ny
        return ret


def _ellipse_spans(a: int, b: int, w: int):
    """Pillow's ellipse_state: the (x0, y, x1) spans, on the step-2 grid, of
    an a x b ellipse ring of width w."""
    leftmost = a % 2
    outer = _Quarter(a, b)
    first = outer.next()
    if w < 1 or first is None:
        return
    pr, py = first
    inner, pl, finished = _Quarter(a - 2 * (w - 1), b - 2 * (w - 1)), leftmost, False
    while not finished:
        y, l, r = py, pl, pr
        nxt = outer.next()
        while nxt is not None and nxt[1] <= y:
            nxt = outer.next()
        if nxt is None:
            finished = True
        else:
            pr, py = nxt
        nxt = inner.next()
        while nxt is not None and nxt[1] <= y:
            l = nxt[0]
            nxt = inner.next()
        pl = leftmost if nxt is None else nxt[0]
        if (l > 0 or l < r) and y > 0:
            yield (2 if l == 0 else l), y, r
        if y > 0:
            yield -r, y, -l
        if l > 0 or l < r:
            yield (2 if l == 0 else l), -y, r
        yield -r, -y, -l


def ellipse(img: np.ndarray, xy, color) -> None:
    """PIL's ImageDraw.ellipse(xy, fill=color) on an HWC uint8 image in place."""
    x0, y0, x1, y1 = (int(v) for v in xy)
    a, b = x1 - x0, y1 - y0
    if a < 0 or b < 0:
        return
    for sx0, sy, sx1 in _ellipse_spans(a, b, a + b):
        _hline(img, x0 + int((sx0 + a) / 2), y0 + int((sy + b) / 2), x0 + int((sx1 + a) / 2),
               color)


def _polygon(img: np.ndarray, verts, color) -> None:
    """Pillow's polygon_generic over the closed polygon of integer vertices:
    per scan line, the f32 crossings of its edges (an edge's lower end
    counted twice, joined corners nudged as Pillow does), sorted, filled
    pairwise from ROUND_UP of the left to ROUND_DOWN of the right."""
    f32 = np.float32
    edges, ymin, ymax = [], img.shape[0] - 1, 0
    for (xa, ya), (xb, yb) in zip(verts, verts[1:] + verts[:1]):
        e = {"x0": xa, "y0": ya, "xmin": min(xa, xb), "xmax": max(xa, xb),
             "ymin": min(ya, yb), "ymax": max(ya, yb),
             "dx": f32(0.0) if ya == yb else f32(xb - xa) / f32(yb - ya)}
        ymin, ymax = min(ymin, e["ymin"]), max(ymax, e["ymax"])
        if e["ymin"] == e["ymax"]:
            _hline(img, e["xmin"], e["ymin"], e["xmax"], color)
            continue
        edges.append(e)

    def at(e, y):
        return f32(f32(y - e["y0"]) * e["dx"] + f32(e["x0"]))

    ymin, ymax = max(ymin, 0), min(ymax, img.shape[0])
    for y in range(ymin, ymax + 1):
        xx = []
        for i, cur in enumerate(edges):
            if not cur["ymin"] <= y <= cur["ymax"]:
                continue
            xx.append(at(cur, y))
            if y == cur["ymax"] and y < ymax:
                xx.append(xx[-1])
            elif cur["dx"] != 0 and len(xx) % 2 == 1 and np.round(xx[-1]) == xx[-1]:
                for other in edges[:i]:  # connect discontiguous corners
                    if (cur["dx"] > 0 and other["dx"] <= 0) or (cur["dx"] < 0
                                                                and other["dx"] >= 0):
                        continue
                    if np.round(xx[-1]) == np.round(at(other, y)):
                        off = -1 if y == cur["ymax"] else 1
                        adj = at(cur, y + off)
                        if other["ymin"] <= y + off <= other["ymax"]:
                            adj_o = at(other, y + off)
                            if xx[-1] > adj + 1 and xx[-1] > adj_o + 1:
                                xx[-1] = f32(np.round(max(adj, adj_o)) + 0.5)
                            elif xx[-1] < adj - 1 and xx[-1] < adj_o - 1:
                                xx[-1] = f32(np.round(min(adj, adj_o)) - 0.5)
                            break
        xx.sort()
        for i in range(1, len(xx), 2):
            x_end = _round_down(float(xx[i]))
            if x_end < xx[i - 1]:
                continue
            _hline(img, _round_up(float(xx[i - 1])), y, x_end, color)


def line(img: np.ndarray, xy, color, width: int = 1) -> None:
    """PIL's ImageDraw.line(xy, fill=color, width=width), width > 1, on an HWC
    uint8 image in place: xy a sequence of (x, y) points."""
    pts = [(int(x), int(y)) for x, y in xy]
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        dx, dy = x1 - x0, y1 - y0
        if dx == 0 and dy == 0:
            _hline(img, x0, y0, x0, color)
            continue
        big, small = math.hypot(dx, dy), (width - 1) / 2.0
        r_max, r_min = _round_up(small) / big, _round_down(small) / big
        dxmin, dxmax = _round_down(r_min * dy), _round_down(r_max * dy)
        dymin, dymax = _round_down(r_min * dx), _round_down(r_max * dx)
        _polygon(img, [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
                       (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)], color)


def text(img: np.ndarray, xy, s: str, color, font: BitmapFont) -> None:
    """Draw `s` with its origin at xy (the top of the line, as PIL's anchor 'la')."""
    m, top = font.mask(s)
    x, y = int(math.floor(xy[0])), int(math.floor(xy[1])) + top
    h, w = img.shape[:2]
    ya, yb, xa, xb = max(y, 0), min(y + m.shape[0], h), max(x, 0), min(x + m.shape[1], w)
    if ya < yb and xa < xb:
        region = img[ya:yb, xa:xb]
        region[m[ya - y:yb - y, xa - x:xb - x]] = color


def feature_visualization(x, module_type: str, stage: int, save_dir, n: int = 32):
    """The first n channels of one layer's feature map (1, C, H, W) as a
    greyscale grid PNG, stage{stage}_{module_type}_features.png under
    save_dir; each channel is min-max scaled and enlarged by nearest
    neighbour to at least 64 px a side, 8 to a row, 2 px white between.
    Maps with a side of 1 are skipped (returns None)."""
    x = np.asarray(x.detach().float().cpu() if hasattr(x, "detach") else x, np.float32)
    if x.ndim != 4 or 1 in x.shape[2:4]:
        return None
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    _, c, h, w = x.shape
    n = min(n, c)
    k = max(1, math.ceil(64 / max(h, w)))
    th, tw, cols = h * k, w * k, 8
    rows = math.ceil(n / cols)
    grid = np.full((rows * (th + 2) + 2, cols * (tw + 2) + 2), 255, np.uint8)
    for i in range(n):
        f = x[0, i]
        lo, hi = float(f.min()), float(f.max())
        g = np.zeros_like(f) if hi <= lo else (f - lo) / (hi - lo)
        tile = np.repeat(np.repeat((g * 255 + 0.5).astype(np.uint8), k, 0), k, 1)
        r, q = divmod(i, cols)
        grid[2 + r * (th + 2):2 + r * (th + 2) + th, 2 + q * (tw + 2):2 + q * (tw + 2) + tw] = tile
    f = save_dir / f"stage{stage}_{module_type}_features.png"
    save_png(f, np.repeat(grid[..., None], 3, axis=2))
    return f
