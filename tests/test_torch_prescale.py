"""The codec's DCT-domain prescale (csrc/imageio.cpp), held against JAX's
native decode + letterbox (`edgeyolo_tpu.native.decode_letterbox`, libjpeg
with scale_denom) and against PIL's reduced-size decode (`Image.draft`),
byte for byte (tolerance 0).

Cases: baseline and progressive JPEGs (PIL-written) with 4:4:4, 4:2:2 and
4:2:0 sampling, and grey, at long sides that give denominators 2, 4 and 8,
one that just misses 2, and one with no prescale; square letterbox targets
of 64 and 32 px, scaleup on and off. A rect canvas takes the full-size
decode (JAX's PIL path there), which the batch call is checked for too.
"""

import io

import numpy as np
import pytest
from PIL import Image, ImageFile
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu import native
from edgeyolo_tpu_torch.data import imageio
from edgeyolo_tpu_torch.data.letterbox import decode_letterbox, letterbox, letterbox_batch

if not native.available():
    pytest.skip("edgeyolo_tpu.native does not build here (no g++ or libjpeg)",
                allow_module_level=True)

# (h, w, target): long side // (denom * 2) >= 2 * target picks the denominator
SIZES = {
    "denom1": (254, 180, 64),       # 254 // 2 = 127 < 128: just misses 1/2
    "denom2": (256, 181, 64),       # exactly 1/2
    "denom4": (515, 260, 64),
    "denom8": (1031, 517, 64),
    "denom8_wide": (390, 777, 32),
    "small": (90, 60, 64),          # smaller than the canvas: upscaled (or not)
}
KINDS = {"444": 0, "422": 1, "420": 2}


def _image(h, w, seed=0):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([x * 255 // w, y * 255 // h, (x + y) % 256], -1).astype(np.float32)
    a += rs.normal(0, 25, a.shape)
    for _ in range(8):
        cy, cx, r = rs.randint(0, h), rs.randint(0, w), rs.randint(5, max(6, h // 4))
        a[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rs.randint(0, 256, 3)
    return np.clip(a, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pil_buffer():
    old = ImageFile.MAXBLOCK
    ImageFile.MAXBLOCK = 1 << 24  # PIL writes small progressive files only with a larger buffer
    yield
    ImageFile.MAXBLOCK = old


def _jpeg(a, kind, progressive):
    b = io.BytesIO()
    if kind == "gray":
        Image.fromarray(a[..., 0]).save(b, "JPEG", quality=90, progressive=progressive)
    else:
        Image.fromarray(a).save(b, "JPEG", quality=90, subsampling=KINDS[kind],
                                progressive=progressive)
    return b.getvalue()


def _denom(h, w, target):
    d = 1
    while d < 8 and max(h, w) // (d * 2) >= 2 * target:
        d *= 2
    return d


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("kind", [*KINDS, "gray"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_decode_letterbox_equals_native(pil_buffer, size, kind, progressive):
    h, w, target = SIZES[size]
    data = _jpeg(_image(h, w), kind, progressive)
    for scaleup in (True, False):
        want, wr, wpads, whw = native.decode_letterbox(data, target, scaleup=scaleup)
        got, r, pads, hw = decode_letterbox(data, target, scaleup=scaleup)
        assert (r, pads, hw) == (wr, wpads, whw)
        np.testing.assert_array_equal(got, want)
    # the batch call over threads gives the same canvases
    imgs, metas = letterbox_batch([data, data], target, threads=2)
    np.testing.assert_array_equal(imgs[1], native.decode_letterbox(data, target)[0])


@pytest.mark.parametrize("denom", [2, 4, 8])
@pytest.mark.parametrize("kind", [*KINDS, "gray"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_reduced_decode_equals_pil_draft(pil_buffer, denom, kind, progressive):
    """libjpeg's 4x4, 2x2 and 1x1 IDCTs, chroma upsampled at the reduced
    scale (triangle filters while the luma blocks are wider than 1 pixel)."""
    for h, w in ((203, 301), (64, 48), (17, 9)):
        data = _jpeg(_image(h, w, seed=h), kind, progressive)
        im = Image.open(io.BytesIO(data))
        im.draft("RGB", (w // denom, h // denom))
        want = np.asarray(im.convert("RGB"))
        got = imageio.decode_jpeg(data, denom)
        assert got.shape == want.shape == (-(-h // denom), -(-w // denom), 3)
        np.testing.assert_array_equal(got, want)


def test_rect_canvas_and_pixels_take_no_prescale(pil_buffer):
    """Onto a rect canvas a large JPEG decodes at full size, and pixel sources
    never prescale: both equal the full decode followed by the resize."""
    data = _jpeg(_image(1031, 517), "420", False)
    full = imageio.decode_jpeg(data)
    (got,), _ = letterbox_batch([data], (64, 128))
    want, _, _ = letterbox(full, (64, 128))
    np.testing.assert_array_equal(got, want)
    (sq,), _ = letterbox_batch([full], 64)
    assert not np.array_equal(sq, native.decode_letterbox(data, 64)[0])


def test_bad_denominator_raises():
    data = _jpeg(_image(32, 32), "420", False)
    with pytest.raises(ValueError, match="1/3"):
        imageio.decode_jpeg(data, 3)
