"""Drawing for Results.plot and feature maps (edgeyolo_tpu/utils/plotting.py,
and the PIL ImageDraw calls of edgeyolo_tpu/engine/results.py).

`rectangle` follows PIL's ImageDraw.rectangle pixel for pixel (coordinates
truncated to int, both corners inclusive, an outline of `width` drawn
inward; Pillow's draw.c ImagingDrawRectangle). Text is a 5 x 9 bitmap font
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
