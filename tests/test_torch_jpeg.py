"""The port's image codec (csrc/imageio.cpp) against the JAX package and PIL, on the CPU.

- JPEG decode: files written by PIL from seeded images, at 1x1, 7x5, 37x23,
  64x48 and 321x241, sampled 4:4:4, 4:2:2, 4:2:0 and gray, plain,
  progressive, with restart intervals (both modes) and with optimised
  Huffman tables, at qualities 10, 50, 92 and 100: equal byte for byte to
  JAX's `load_image_rgb` (PIL with libjpeg-turbo). Tolerance 0.
- Decode and letterbox: equal to `edgeyolo_tpu.native.decode_letterbox`
  (libjpeg and the same resize) wherever its DCT prescale is off (the long
  side under 4x the target), pixels, ratio, pads and size; within one grey
  level of JAX's `letterbox(load_image_rgb(...))`, ratio and pads equal.
- Batch: the threaded call equals one-by-one calls; a bad file raises naming
  its index.
- Refusals: truncated and corrupt streams, CMYK, arithmetic coding, 12-bit,
  lossless and progressive files left unrefined raise ValueError.
- Encode: PIL reads the port's file; its RMSE to the source is at most 1.05x
  that of PIL's own file at the same quality and subsampling (4:2:0, 4:2:2,
  4:4:4); the file is PIL's byte for byte (libjpeg's padding and dummy
  blocks); the port's decode of it equals PIL's; gray likewise. 4:4:0, which
  PIL reads but does not write, decodes equal to PIL on the port's files.
- PNG: the library's row un-filtering equals the numpy plain version and
  JAX's `load_image_rgb`, on files of each filter and on PIL-written files.
- chip_smoke.py's JPEG_Q92 bound equals PIL's q92 error on the val640 images.
- Build: the codec compiles with g++ into `_build/<name>-<hash of source and
  flags>.so`; a source that does not compile raises, with nothing loaded.
"""

import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from edgeyolo_tpu import native
from edgeyolo_tpu.data.letterbox import letterbox as jletterbox
from edgeyolo_tpu.data.letterbox import load_image_rgb as jload
from edgeyolo_tpu_torch.data import imageio
from edgeyolo_tpu_torch.data.letterbox import LetterboxError, letterbox_batch
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (no torch or JAX at import)

SIZES = [(1, 1), (5, 7), (23, 37), (48, 64), (241, 321)]  # (h, w): 1x1, 7x5, 37x23, 64x48, 321x241
QUALITIES = [10, 50, 92, 100]
SAMPLING = {"444": 0, "422": 1, "420": 2, "gray": None}
OPTIONS = {"baseline": {}, "progressive": {"progressive": True},
           "restart": {"restart_marker_blocks": 3}, "optimize": {"optimize": True},
           "progressive-restart": {"progressive": True, "restart_marker_rows": 1}}


def picture(h, w, seed=0):
    """Gradients with noise: smooth areas and edges, so every coefficient band is used."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 7 % 256], -1)
    return np.clip(base + rs.randint(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(autouse=True)
def pil_buffer(monkeypatch):
    """PIL writes a progressive or optimised file through one buffer of at least
    MAXBLOCK bytes, which a noisy 4:4:4 picture at quality 92 outgrows."""
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 22)


def pil_jpeg(path, img, sampling="420", **kw):
    if SAMPLING[sampling] is None:
        Image.fromarray(img).convert("L").save(path, "JPEG", **kw)
    else:
        Image.fromarray(img).save(path, "JPEG", subsampling=SAMPLING[sampling], **kw)
    return path


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("sampling", SAMPLING)
def test_decode_equals_jax_load_image_rgb(tmp_path, sampling, option):
    n = 0
    for h, w in SIZES:
        for q in QUALITIES:
            p = pil_jpeg(tmp_path / f"{h}x{w}q{q}.jpg", picture(h, w, h * w + q), sampling,
                         quality=q, **OPTIONS[option])
            got, want = imageio.load_image_rgb(p), jload(str(p))
            assert got.shape == want.shape == (h, w, 3)
            assert (got == want).all(), (h, w, q, np.abs(got.astype(int) - want).max())
            n += 1
    assert n == len(SIZES) * len(QUALITIES)


@pytest.mark.parametrize("h,w,size,scaleup", [
    (100, 80, 64, True), (241, 321, 160, True), (50, 70, 160, False), (33, 97, 128, True),
    (160, 160, 160, False), (480, 640, 640, False), (480, 640, 320, True),
    (720, 1280, 640, False),
])
def test_decode_letterbox_equals_jax(tmp_path, h, w, size, scaleup):
    data = pil_jpeg(tmp_path / "a.jpg", picture(h, w, h + w), quality=92).read_bytes()
    assert max(h, w) < 4 * size  # JAX's native decodes at denom 1 here
    nimg, nr, npad, nhw = native.decode_letterbox(data, size, scaleup=scaleup)
    out, [(r, pad, hw)] = letterbox_batch([data], size, scaleup=scaleup)
    assert (r, pad, hw) == (nr, tuple(npad), tuple(nhw))
    np.testing.assert_array_equal(out[0], nimg)
    ref, jr, jpad = jletterbox(jload(str(tmp_path / "a.jpg")), size, scaleup=scaleup)
    assert (r, pad) == (jr, jpad)
    assert np.abs(out[0].astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("shape", [96, (64, 128), (128, 64)])
def test_batch_equals_one_by_one_and_names_a_bad_file(tmp_path, shape):
    sources = [pil_jpeg(tmp_path / f"{i}.jpg", picture(40 + 9 * i, 70 - 5 * i, i),
                        quality=92).read_bytes() for i in range(5)]
    sources += [picture(50, 30, 7), picture(20, 90, 8)[..., 0]]  # pixels, RGB and gray
    batch, metas = letterbox_batch(sources, shape, threads=4)
    for i, s in enumerate(sources):
        one, [meta] = letterbox_batch([s], shape, threads=1)
        np.testing.assert_array_equal(batch[i], one[0])
        assert metas[i] == meta
    broken = sources[:3] + [sources[3][:len(sources[3]) // 2]] + sources[4:]
    with pytest.raises(LetterboxError, match="image 3") as e:
        letterbox_batch(broken, shape, threads=4)
    assert e.value.index == 3


def _corrupt(data: bytes) -> bytes:
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    b = bytearray(data)
    for i in range(start + 10, len(b) - 2, 7):  # scramble the entropy-coded data
        if b[i] != 0xFF and b[i - 1] != 0xFF:
            b[i] = 0xFF if i % 2 else b[i] ^ 0x5A
    return bytes(b)


def _marker_swapped(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + 2:]


def test_refused_streams_raise_value_error(tmp_path):
    base = pil_jpeg(tmp_path / "a.jpg", picture(48, 64), quality=92).read_bytes()
    prog = pil_jpeg(tmp_path / "p.jpg", picture(48, 64), quality=92,
                    progressive=True).read_bytes()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(tmp_path / "c.jpg", "JPEG")
    sof = base.index(b"\xff\xc0")
    twelve = base[:sof + 4] + bytes([12]) + base[sof + 5:]
    first_scans = prog[:prog.index(b"\xff\xda", prog.index(b"\xff\xda") + 2)]  # DC scan only
    cases = {
        "truncated": (base[:len(base) // 2], "truncated|premature"),
        "no EOI": (base[:-2], "truncated"),
        "corrupt": (_corrupt(base), "corrupt|truncated|premature"),
        "CMYK": ((tmp_path / "c.jpg").read_bytes(), "CMYK"),
        "arithmetic": (_marker_swapped(base, b"\xff\xc0", b"\xff\xc9"), "arithmetic"),
        "lossless": (_marker_swapped(base, b"\xff\xc0", b"\xff\xc3"), "lossless"),
        "12-bit": (twelve, "12-bit"),
        "unrefined progressive": (first_scans + b"\xff\xd9", "block smoothing"),
        "not a JPEG": (b"\xff\xd8" + b"\x00" * 20, "JPEG"),
    }
    for name, (data, match) in cases.items():
        with pytest.raises(ValueError, match=match):
            imageio.decode_jpeg(data)
        with pytest.raises(LetterboxError):
            letterbox_batch([data], 64)


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:2:2", "4:4:4"])
@pytest.mark.parametrize("quality", [50, 75, 92])
@pytest.mark.parametrize("h,w", [(48, 64), (37, 23), (241, 321)])
def test_encoder_is_read_by_pil_at_pil_error(tmp_path, h, w, quality, subsampling):
    img = picture(h, w, quality)
    imageio.save_jpeg(tmp_path / "port.jpg", img, quality=quality, subsampling=subsampling)
    Image.fromarray(img).save(tmp_path / "pil.jpg", "JPEG", quality=quality,
                              subsampling=subsampling)
    by_pil = np.asarray(Image.open(tmp_path / "port.jpg").convert("RGB"))
    ref = np.asarray(Image.open(tmp_path / "pil.jpg").convert("RGB"))

    def rmse(a):
        return float(np.sqrt(((a.astype(np.float64) - img) ** 2).mean()))
    assert rmse(by_pil) <= 1.05 * rmse(ref), (rmse(by_pil), rmse(ref))
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "pil.jpg").read_bytes()
    np.testing.assert_array_equal(imageio.load_image_rgb(tmp_path / "port.jpg"), by_pil)
    gray = img[..., 0]
    imageio.save_jpeg(tmp_path / "gray.jpg", gray, quality=quality)
    np.testing.assert_array_equal(imageio.load_image_rgb(tmp_path / "gray.jpg"),
                                  np.asarray(Image.open(tmp_path / "gray.jpg").convert("RGB")))


def test_decode_of_4_4_0_equals_pil(tmp_path):
    """4:4:0 (luma 1 x 2: libjpeg's vertical-only fancy upsampling), which PIL
    reads but does not write: the port's own files, decoded by both."""
    for h, w in SIZES:
        for q in QUALITIES:
            imageio.save_jpeg(tmp_path / "a.jpg", picture(h, w, q), quality=q,
                              subsampling="4:4:0")
            assert (imageio.load_image_rgb(tmp_path / "a.jpg") == jload(str(tmp_path / "a.jpg"))).all()


def _one_filter_png(a: np.ndarray, ftype: int) -> bytes:
    """Every row filtered with `ftype`, from the PNG specification's definitions."""
    h, w, _ = a.shape
    rows = a.reshape(h, w * 3).astype(np.int64)
    out = []
    for y in range(h):
        x, up = rows[y], rows[y - 1] if y else np.zeros(w * 3, np.int64)
        left = np.concatenate([np.zeros(3, np.int64), x[:-3]])
        ul = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        p = left + up - ul
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
        pred = [0, left, up, (left + up) // 2,
                np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))][ftype]
        out.append(bytes([ftype]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    png = imageio.encode_png(a, "none")
    ihdr = dict(imageio._chunks(png))[b"IHDR"]

    def chunk(kind, payload):
        return (len(payload).to_bytes(4, "big") + kind + payload
                + zlib.crc32(kind + payload).to_bytes(4, "big"))
    return (imageio.PNG_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("source", ["filter0", "filter1", "filter2", "filter3", "filter4",
                                    "pil-RGB", "pil-RGBA", "pil-L", "pil-P"])
def test_png_library_equals_plain_and_jax(tmp_path, source):
    img = picture(61, 83, 5)
    p = tmp_path / "a.png"
    if source.startswith("filter"):
        p.write_bytes(_one_filter_png(img, int(source[-1])))
    else:
        im = Image.fromarray(img)
        mode = source[4:]
        if mode == "RGBA":
            im = Image.fromarray(np.concatenate([img, img[..., :1]], -1), "RGBA")
        elif mode == "P":
            im = im.quantize(64)
        elif mode != "RGB":
            im = im.convert(mode)
        im.save(p, "PNG")
    data = p.read_bytes()
    got = imageio.decode_png(data)
    np.testing.assert_array_equal(got, imageio.decode_png_plain(data))
    np.testing.assert_array_equal(got, jload(str(p)))


def test_chip_smoke_jpeg_bounds_are_pils(tmp_path):
    """chip_smoke.py's `jpeg` phase holds the port's q92 round trip of the val640
    images to JPEG_Q92: the worst RMSE and max |diff| of PIL's own q92 files of the
    same images (PIL decoding them), which the port's files and decode equal."""
    v = chip_smoke.VAL640
    yaml_path = generate_dataset(tmp_path / "val640", n_train=0, n_val=v["n_val"],
                                 imgsz=v["imgsz"], nc=chip_smoke.FIT["nc"], seed=1)
    worst = {"rmse": 0.0, "max_abs": 0}
    for f in sorted((yaml_path.parent / "images" / "val").glob("*.png")):
        a = imageio.load_image_rgb(f)
        Image.fromarray(a).save(tmp_path / "a.jpg", quality=92)
        d = np.asarray(Image.open(tmp_path / "a.jpg").convert("RGB")).astype(np.int32) - a
        worst["rmse"] = max(worst["rmse"], float(np.sqrt((d.astype(np.float64) ** 2).mean())))
        worst["max_abs"] = max(worst["max_abs"], int(np.abs(d).max()))
    print(worst)
    assert worst["max_abs"] == chip_smoke.JPEG_Q92["max_abs"]
    assert worst["rmse"] <= chip_smoke.JPEG_Q92["rmse"] < worst["rmse"] + 1e-4


def test_codec_builds_by_hash_and_a_failed_build_raises(tmp_path, monkeypatch):
    path = _build.library_path("imageio")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("imageio-")
    assert _build.build(("imageio",))["imageio"] == path and path.is_file()
    (tmp_path / "imageio.cpp").write_text("int broken(;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="native build failed"):
        _build.build(("imageio",))
    assert not list((tmp_path / "_build").iterdir())  # no library, no leftover temporary
