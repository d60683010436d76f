"""Image files without PIL: JPEG and PNG decode and encode, 24-bit BMP decode,
and header-only size reads (the part of PIL that edgeyolo_tpu/data/letterbox.py's
`load_image_rgb`, dataset.py's verify and `set_rectangle`, and results.py's
`save_crop` use).

- JPEG decode and encode: the port's own codec, csrc/imageio.cpp, built by the
  host C++ compiler on first use (ops/_build.py). Decoding gives PIL's pixels
  byte for byte (libjpeg's accurate integer IDCT, fancy upsampling and
  YCbCr -> RGB) for baseline and progressive Huffman files, 8-bit, gray or
  three components, sampling factors 1 or 2, with restart intervals; other
  modes, and truncated or corrupt streams, raise ValueError. Encoding is
  baseline, 4:2:0, 4:2:2, 4:4:0 or 4:4:4 (gray: one component), the Annex K
  tables scaled by `quality` as libjpeg scales them: PIL's file byte for byte.
- PNG decode: bit depths 1, 2, 4 and 8 for gray and palette, 8 for gray+alpha,
  RGB and RGBA; non-interlaced; zlib from the standard library, the five row
  filters undone in the codec library. The result is HWC RGB uint8 as PIL's
  `convert("RGB")` gives it: alpha is dropped, gray is repeated, a palette is
  looked up. `decode_png_plain` undoes the filters in numpy and Python instead
  (the plain version the tests hold the library against).
- PNG encode: RGB, filter None or Up, zlib level 1.
- BMP decode: uncompressed 24-bit, bottom-up or top-down.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from edgeyolo_tpu_torch.ops import _build

PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _chunks(data: bytes, check_crc: bool = True):
    """(type, payload) of each chunk of a PNG file."""
    if data[:8] != PNG_SIG:
        raise ValueError("not a PNG file")
    i = 8
    while i + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[i:i + 8])
        payload = data[i + 8:i + 8 + n]
        if len(payload) != n or i + 12 + n > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if check_crc:
            crc = struct.unpack(">I", data[i + 8 + n:i + 12 + n])[0]
            if zlib.crc32(kind + payload) != crc:
                raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        i += 12 + n
    raise ValueError("PNG file has no IEND chunk")


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        cur[i] = (cur[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


class EyioSource(ctypes.Structure):
    """csrc/imageio.cpp's EyioSource: JPEG bytes (kind 0) or (h, w, 3) pixels (kind 1)."""
    _fields_ = [("data", ctypes.c_void_p), ("len", ctypes.c_uint64), ("kind", ctypes.c_int32),
                ("h", ctypes.c_int32), ("w", ctypes.c_int32)]


class EyioMeta(ctypes.Structure):
    _fields_ = [("h0", ctypes.c_int32), ("w0", ctypes.c_int32), ("r", ctypes.c_double),
                ("pw", ctypes.c_int32), ("ph", ctypes.c_int32)]


_P = ctypes.c_void_p
_I = ctypes.c_int32
_ERR = (ctypes.c_char_p, ctypes.c_int)
_SIGNATURES = {
    "eyio_jpeg_decode": (_P, ctypes.c_uint64, _I, _P, _I, _I, *_ERR),
    "eyio_jpeg_encode": (_P, _I, _I, _I, _I, _I, _I,
                         ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                         ctypes.POINTER(ctypes.c_uint64), *_ERR),
    "eyio_free": (_P,),
    "eyio_png_unfilter": (_P, ctypes.c_uint64, _I, _I, _I, _P, *_ERR),
    "eyio_letterbox_batch": (_I, ctypes.POINTER(EyioSource), _I, _I, _I, _I, _P,
                             ctypes.POINTER(EyioMeta), *_ERR),
}


def codec() -> ctypes.CDLL:
    """The codec library (csrc/imageio.cpp), built on first use, its functions typed."""
    lib = _build.load("imageio")
    if not getattr(lib, "_typed", False):
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = None if name == "eyio_free" else ctypes.c_int
        lib._typed = True
    return lib


def _err_buf():
    return ctypes.create_string_buffer(512)


def _ptr(a) -> int:
    """Address of a bytes object or contiguous numpy array (the caller keeps it alive)."""
    return (a if isinstance(a, np.ndarray) else np.frombuffer(a, np.uint8)).ctypes.data


def decode_jpeg(data: bytes, denom: int = 1) -> np.ndarray:
    """JPEG bytes -> HWC RGB uint8, equal to PIL's decode followed by convert("RGB").
    `denom` 2, 4 or 8 decodes at that fraction of the size in the DCT domain
    (libjpeg's scale_denom, PIL's `draft`): ceil(w / denom) x ceil(h / denom)."""
    if denom not in (1, 2, 4, 8):
        raise ValueError(f"JPEG scale must be 1/1, 1/2, 1/4 or 1/8, got 1/{denom}")
    w, h = _jpeg_size(data)
    w, h = -(-w // denom), -(-h // denom)
    out = np.empty((h, w, 3), np.uint8)
    err = _err_buf()
    if codec().eyio_jpeg_decode(_ptr(data), len(data), denom, out.ctypes.data, w, h, err,
                                len(err)):
        raise ValueError(err.value.decode())
    return out


SUBSAMPLING = {"4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:0": (1, 2), "4:4:4": (1, 1)}


def encode_jpeg(img: np.ndarray, quality: int = 92, subsampling: str = "4:2:0") -> bytes:
    """HWC RGB (or HW gray) uint8 -> baseline JPEG bytes, libjpeg's (PIL's) file at
    the same quality and subsampling."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected an (H, W, 3) or (H, W) uint8 image, got {img.shape}")
    lib, err = codec(), _err_buf()
    out, n = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_uint64()
    ch = 1 if img.ndim == 2 else 3
    sh, sv = SUBSAMPLING[subsampling]
    if lib.eyio_jpeg_encode(img.ctypes.data, img.shape[1], img.shape[0], ch, int(quality), sh, sv,
                            ctypes.byref(out), ctypes.byref(n), err, len(err)):
        raise ValueError(err.value.decode())
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.eyio_free(out)


def save_jpeg(path: str | Path, img: np.ndarray, quality: int = 92,
              subsampling: str = "4:2:0") -> None:
    Path(path).write_bytes(encode_jpeg(img, quality, subsampling))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters in the codec library: (h, stride) uint8."""
    out = np.empty((h, stride), np.uint8)
    err = _err_buf()
    if codec().eyio_png_unfilter(_ptr(raw), len(raw), h, stride, bpp, out.ctypes.data, err,
                                 len(err)):
        raise ValueError(err.value.decode())
    return out


def _unfilter_plain(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters in numpy and Python: (h, stride) uint8."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            out[y] = cur
        elif ftype == 1:  # Sub: a running sum per byte of the pixel, mod 256
            out[y] = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            out[y] = cur + prev
        elif ftype in (3, 4):
            row = bytearray(cur.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(row, prev.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> HWC RGB uint8."""
    return _decode_png(data, _unfilter)


def decode_png_plain(data: bytes) -> np.ndarray:
    """decode_png with the row filters undone in numpy and Python (the plain version)."""
    return _decode_png(data, _unfilter_plain)


def _decode_png(data: bytes, unfilter) -> np.ndarray:
    header, idat, palette = None, [], None
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"bad PNG colour type {ctype}")
    if interlace:
        raise NotImplementedError("interlaced PNG is not supported")
    if depth != 8 and not (depth in (1, 2, 4) and ctype in (0, 3)):
        raise NotImplementedError(f"PNG bit depth {depth} with colour type {ctype}")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    px = unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, ch * depth // 8))
    if depth < 8:  # packed samples, most significant bits first
        bits = np.unpackbits(px, axis=1).reshape(h, -1, depth)[:, :w]
        px = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        if ctype == 0:
            px = (px.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
    px = px.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette
        return full[px[..., 0]]
    if ch in (1, 2):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def encode_png(img: np.ndarray, filter: str = "up") -> bytes:
    """HWC RGB uint8 -> PNG bytes; every row filtered None or Up, zlib level 1."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {img.shape}")
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3)
    if filter == "up":
        body = rows.copy()
        body[1:] -= rows[:-1]  # uint8 wraps mod 256
        ftype = 2
    elif filter == "none":
        body, ftype = rows, 0
    else:
        raise ValueError(f"unknown PNG filter '{filter}'")
    raw = np.concatenate([np.full((h, 1), ftype, np.uint8), body], axis=1).tobytes()
    if filter == "up" and h:
        raw = bytes([0]) + raw[1:]  # the first row has no row above: filter None
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    return (PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def decode_bmp(data: bytes) -> np.ndarray:
    """Uncompressed 24-bit BMP bytes -> HWC RGB uint8."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    if hsize < 40:
        raise NotImplementedError("BMP with an OS/2 header")
    w, h, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    if bpp != 24 or comp != 0:
        raise NotImplementedError(f"BMP with {bpp} bits per pixel, compression {comp}")
    stride = (w * 3 + 3) & ~3
    rows = np.frombuffer(data, np.uint8, abs(h) * stride, offset).reshape(abs(h), stride)
    img = rows[:, :w * 3].reshape(abs(h), w, 3)[..., ::-1]
    return np.ascontiguousarray(img[::-1] if h > 0 else img)


def _jpeg_size(data: bytes) -> tuple[int, int]:
    i = 2
    while i + 9 < len(data):
        if data[i] != 0xFF:
            raise ValueError("corrupt JPEG marker stream")
        marker = data[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">HH", data[i + 5:i + 9])
            return w, h
        i += 2 + n
    raise ValueError("JPEG has no frame header")


def image_size(path: str | Path) -> tuple[int, int]:
    """(width, height) from the file's header, as PIL's `Image.open(f).size`.
    PNG files are walked chunk by chunk with their CRCs checked, which is what
    PIL's `verify` checks; a corrupt file raises ValueError."""
    data = Path(path).read_bytes()
    if data[:8] == PNG_SIG:
        for kind, payload in _chunks(data):
            if kind == b"IHDR":
                w, h = struct.unpack(">II", payload[:8])
        return w, h
    if data[:2] == b"BM":
        w, h = struct.unpack("<ii", data[18:26])
        return w, abs(h)
    if data[:2] == b"\xff\xd8":
        return _jpeg_size(data)
    raise ValueError(f"unknown image format: {path}")


def is_jpeg(data: bytes) -> bool:
    return data[:2] == b"\xff\xd8"


def decode_image(data: bytes, name: str | Path = "image") -> np.ndarray:
    """Image file bytes -> HWC RGB uint8 (JPEG, PNG or 24-bit BMP)."""
    if is_jpeg(data):
        try:
            return decode_jpeg(data)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    if data[:8] == PNG_SIG:
        return decode_png(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    raise ValueError(f"unknown image format: {name}")


def load_image_rgb(path: str | Path) -> np.ndarray:
    """An image file -> HWC RGB uint8 (JPEG, PNG or 24-bit BMP)."""
    return decode_image(Path(path).read_bytes(), path)


def save_png(path: str | Path, img: np.ndarray, filter: str = "up") -> None:
    Path(path).write_bytes(encode_png(img, filter))
