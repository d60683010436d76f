"""The port's host data path against the JAX package, on the CPU.

- YAML: the keys check_det_dataset reads (path, train, val, test, nc, names,
  kpt_shape, flip_idx) equal to yaml.safe_load on every file in
  edgeyolo_tpu/cfg/datasets/ and on the generator's dataset.yaml; scalars
  resolve as YAML 1.1 does.
- Images: PNG decode bit-equal to PIL on PIL-written files (gray, gray+alpha,
  RGB, RGBA, palette at 8, 4 and 1 bits), 24-bit BMP decode bit-equal, the
  port's PNG encoder read back by PIL bit-equal, header sizes equal to PIL's,
  a PIL-written JPEG decoded bit-equal (tests/test_torch_jpeg.py has the rest).
- Letterbox: ratio and pads equal to JAX's, pixels within 1 grey level (the
  antialiased bilinear resize against PIL's BILINEAR).
- Synthetic data: label files and dataset.yaml byte-identical to JAX's for
  the same seed; each shape's pixels inside its labelled box (+-1 px).
- Loader: over two shuffled epochs, every batch (img bytes, cls, bboxes,
  mask_gt, n_real and each item's ratio_pad, ori_shape, ori_cls,
  ori_bboxes) equal to JAX's on a PNG dataset whose images are at imgsz;
  exact apart from the image of a resized case, held to 1 grey level. The
  same on a JPEG dataset of ten aspects against JAX's PIL path, square
  (val and train scaling) and rect batches.
- Inference sources: file, directory, glob, list, HWC array and (B, H, W, 3)
  array or tensor.
"""

import io
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from edgeyolo_tpu.data import dataset as jdataset
from edgeyolo_tpu.data.letterbox import letterbox as jletterbox
from edgeyolo_tpu.data.synthetic import generate_dataset as jgenerate
from edgeyolo_tpu_torch.data import dataset, imageio
from edgeyolo_tpu_torch.data.letterbox import letterbox
from edgeyolo_tpu_torch.data.loaders import load_inference_source
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.utils.yamlfile import yaml_load, yaml_loads, yaml_save

REPO = Path(__file__).resolve().parents[1]
DATASET_YAMLS = sorted((REPO / "edgeyolo_tpu" / "cfg" / "datasets").glob("*.yaml"))
DATA_KEYS = ("path", "train", "val", "test", "nc", "names", "kpt_shape", "flip_idx")


# -- YAML ---------------------------------------------------------------------------
def test_there_are_thirty_dataset_files():
    assert len(DATASET_YAMLS) == 30


@pytest.mark.parametrize("path", DATASET_YAMLS, ids=lambda p: p.stem)
def test_dataset_yaml_keys_match_pyyaml(path):
    ref = yaml.safe_load(path.read_text()) or {}
    got = yaml_load(path)
    for k in DATA_KEYS:
        assert got.get(k) == ref.get(k), k
    assert got == ref  # and the whole file


@pytest.mark.parametrize("text", [
    "a: yes", "a: Off", "a: n", "a: 1e3", "a: 1.0e+3", "a: .5", "a: -.inf", "a: 0x1F",
    "a: 017", "a: 1_000", "a: ~", "a:", "a: 'it''s'", 'a: "q\\n"', "a: x # c",
    "a: [1, [2, 'b c'], {d: e}]", "a: [1,\n  2]", "a: |\n  x\n  y\nb: 2",
    "a: >\n  x\n  y\n", "a:\n- 1\n- b: 2\n  c: 3\n- [4]", "a:\n  b:\n    c: 1\n  d: 2",
    "0: person\n1: bicycle",
])
def test_yaml_scalars_and_structures_match_pyyaml(text):
    assert yaml_loads(text) == yaml.safe_load(text)


def test_yaml_save_round_trips(tmp_path):
    d = {"a": 1, "b": 0.5, "c": None, "d": "x: y", "e": [1, 2], "f": True, "g": "runs/x",
         "h": "yes", "i": "1e3"}
    yaml_save(tmp_path / "args.yaml", d)
    assert yaml_load(tmp_path / "args.yaml") == d == yaml.safe_load((tmp_path / "args.yaml").read_text())


# -- image files --------------------------------------------------------------------
def _picture(h=37, w=53, seed=0):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([x * 3 % 256, y * 5 % 256, (x + y) % 256], -1).astype(np.uint8)
    a[rs.rand(h, w) < 0.3] = rs.randint(0, 256, 3)
    return a


def _pil_png(mode: str) -> Image.Image:
    a = _picture()
    im = Image.fromarray(a)
    if mode == "RGBA":
        return Image.fromarray(np.concatenate([a, a[..., :1]], -1), "RGBA")
    if mode.startswith("P"):
        return im.quantize({"P": 200, "P16": 16, "P3": 3}[mode])
    return im.convert(mode)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "P16", "P3", "1"])
def test_png_decode_is_bit_equal_to_pil(mode):
    im = _pil_png(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG")
    got = imageio.decode_png(buf.getvalue())
    np.testing.assert_array_equal(got, np.asarray(im.convert("RGB")))


def _filtered_png(a: np.ndarray, ftype: int) -> bytes:
    """An RGB PNG whose rows all use filter `ftype` (0-4), encoded here from
    the PNG specification's definitions."""
    h, w, _ = a.shape
    rows = a.reshape(h, w * 3).astype(np.int64)
    out = []
    for y in range(h):
        x, up = rows[y], rows[y - 1] if y else np.zeros(w * 3, np.int64)
        left = np.concatenate([np.zeros(3, np.int64), x[:-3]])
        ul = np.concatenate([np.zeros(3, np.int64), up[:-3]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - up
        elif ftype == 3:
            f = x - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            f = x - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
    png = imageio.encode_png(a, "none")
    chunks = {k: p for k, p in imageio._chunks(png)}
    zdata = zlib.compress(b"".join(out))

    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
            ">I", zlib.crc32(kind + payload))
    return (imageio.PNG_SIG + chunk(b"IHDR", chunks[b"IHDR"]) + chunk(b"IDAT", zdata)
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decode_of_each_row_filter(ftype):
    """Each of the five row filters, on every row; PIL reads the same file."""
    a = _picture(640, 640) if ftype == 4 else _picture(64, 80)
    data = _filtered_png(a, ftype)
    t0 = time.perf_counter()
    got = imageio.decode_png(data)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"{a.shape[0]} px RGB PNG, every row filter {ftype}: decode {ms:.1f} ms (CPU)")
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), a)
    np.testing.assert_array_equal(got, a)


def test_png_decode_of_a_pil_written_picture():
    """PIL's encoder picks a filter per row (Sub, Up and Paeth here)."""
    a = _picture(640, 640)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "PNG")
    data = buf.getvalue()
    raw = zlib.decompress(b"".join(p for k, p in imageio._chunks(data) if k == b"IDAT"))
    filters = {raw[y * (640 * 3 + 1)] for y in range(640)}
    t0 = time.perf_counter()
    got = imageio.decode_png(data)
    ms = (time.perf_counter() - t0) * 1e3
    print(f"PIL-written 640 px RGB PNG, row filters {sorted(filters)}: decode {ms:.1f} ms (CPU)")
    assert len(filters) > 1
    np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("filt", ["none", "up"])
def test_png_encode_reads_back_in_pil(tmp_path, filt):
    a = _picture(29, 31)
    imageio.save_png(tmp_path / "a.png", a, filter=filt)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), a)
    np.testing.assert_array_equal(imageio.load_image_rgb(tmp_path / "a.png"), a)


@pytest.mark.parametrize("w", [31, 32])  # row padding and none
def test_bmp_decode_is_bit_equal_to_pil(tmp_path, w):
    a = _picture(23, w)
    Image.fromarray(a).save(tmp_path / "a.bmp")
    np.testing.assert_array_equal(imageio.load_image_rgb(tmp_path / "a.bmp"), a)


@pytest.mark.parametrize("fmt", ["png", "bmp", "jpg"])
def test_header_size_matches_pil(tmp_path, fmt):
    p = tmp_path / f"a.{fmt}"
    Image.fromarray(_picture(41, 67)).save(p)
    assert imageio.image_size(p) == Image.open(p).size == (67, 41)


def test_jpeg_decode_matches_pil(tmp_path):
    Image.fromarray(_picture()).save(tmp_path / "a.jpg")
    np.testing.assert_array_equal(imageio.load_image_rgb(tmp_path / "a.jpg"),
                                  np.asarray(Image.open(tmp_path / "a.jpg").convert("RGB")))


def test_corrupt_png_is_refused(tmp_path):
    imageio.save_png(tmp_path / "a.png", _picture())
    data = bytearray((tmp_path / "a.png").read_bytes())
    data[40] ^= 0xFF
    (tmp_path / "b.png").write_bytes(bytes(data))
    with pytest.raises(ValueError):
        imageio.image_size(tmp_path / "b.png")


# -- letterbox ----------------------------------------------------------------------
@pytest.mark.parametrize("h,w,size,scaleup", [
    (100, 80, 64, True), (50, 70, 160, True), (50, 70, 160, False), (300, 200, 64, False),
    (33, 97, 128, True), (160, 160, 160, False),
])
def test_letterbox_matches_jax(h, w, size, scaleup):
    img = np.random.RandomState(h + w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    ref, r_ref, pad_ref = jletterbox(img, size, scaleup=scaleup)
    out, r, pad = letterbox(img, size, scaleup=scaleup)
    assert (r, pad, out.shape) == (r_ref, pad_ref, ref.shape)
    d = np.abs(out.astype(int) - ref.astype(int))
    print(f"{h}x{w} -> {size} scaleup={scaleup}: max {d.max()}, {100 * (d > 0).mean():.1f}% differ")
    assert d.max() <= 1


# -- synthetic data -----------------------------------------------------------------
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    kw = dict(n_train=6, n_val=3, imgsz=64, nc=3, seed=3)
    return jgenerate(root / "jax", **kw), generate_dataset(root / "port", **kw)


def test_synthetic_labels_and_yaml_are_jax_bytes(synth):
    jy, py = synth
    jroot, proot = jy.parent, py.parent
    assert jy.read_text().replace(str(jroot.resolve()), "R") == \
        py.read_text().replace(str(proot.resolve()), "R")
    files = sorted((jroot / "labels").rglob("*.txt"))
    assert len(files) == 9
    for f in files:
        assert (proot / f.relative_to(jroot)).read_bytes() == f.read_bytes()
    assert len(list((proot / "images").rglob("*.png"))) == 9


def test_synthetic_shapes_lie_in_their_boxes(synth):
    _, py = synth
    for lp in sorted((py.parent / "labels").rglob("*.txt")):
        ip = Path(str(lp).replace("/labels/", "/images/")).with_suffix(".png")
        img = imageio.load_image_rgb(ip).astype(int)
        drawn = np.zeros(img.shape[:2], bool)
        inside = np.zeros(img.shape[:2], bool)
        for line in lp.read_text().split("\n"):
            if not line:
                continue
            _c, cx, cy, w, h = (float(v) for v in line.split())
            x1, y1, x2, y2 = ((cx - w / 2) * 64 - 1, (cy - h / 2) * 64 - 1,
                              (cx + w / 2) * 64 + 1, (cy + h / 2) * 64 + 1)
            yy, xx = np.mgrid[0:64, 0:64]
            inside |= (xx >= x1) & (xx <= x2) & (yy >= y1) & (yy <= y2)
        # background noise is 90..149 in every channel; shapes are palette or white
        drawn = ((img < 90) | (img > 149)).any(-1)
        assert drawn.any() and not (drawn & ~inside).any(), lp.name


# -- dataset and loader -------------------------------------------------------------
def _check_batches(jb, pb, img_tol=0):
    assert set(pb) == set(jb)
    d = np.abs(pb["img"].astype(int) - jb["img"].astype(int)).max()
    assert d <= img_tol
    for k in ("cls", "bboxes", "mask_gt"):
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    assert pb["n_real"] == jb["n_real"]
    for jm, pm in zip(jb["meta"], pb["meta"]):
        assert pm["ratio_pad"] == jm["ratio_pad"] and pm["ori_shape"] == jm["ori_shape"]
        assert pm["im_file"] == jm["im_file"]
        np.testing.assert_array_equal(pm["ori_cls"], jm["ori_cls"])
        np.testing.assert_array_equal(pm["ori_bboxes"], jm["ori_bboxes"])
    return d


@pytest.mark.parametrize("imgsz,augment", [(64, True), (64, False), (96, True), (48, False)])
def test_loader_batches_match_jax_over_two_shuffled_epochs(synth, imgsz, augment):
    """imgsz 64 is the images' own size (exact); 96 and 48 resize (1 level)."""
    _, py = synth
    cfg = dataset.check_det_dataset(py)
    assert cfg == jdataset.check_det_dataset(py)
    pset = dataset.YOLODataset(cfg["train"], imgsz=imgsz, augment=augment, names=cfg["names"])
    jset = jdataset.YOLODataset(cfg["train"], imgsz=imgsz, augment=augment, names=cfg["names"])
    assert pset.im_files == jset.im_files and pset.max_gt == jset.max_gt
    ploader = dataset.build_dataloader(pset, 4, shuffle=True, seed=1)
    jloader = jdataset.build_dataloader(jset, 4, shuffle=True, seed=1)
    assert len(ploader) == len(jloader) == 2
    worst, orders = 0, []
    for _ in range(2):
        pbs, jbs = list(ploader), list(jloader)
        assert len(pbs) == len(jbs) == 2 and pbs[-1]["n_real"] == 2
        for jb, pb in zip(jbs, pbs):
            worst = max(worst, _check_batches(jb, pb, img_tol=0 if imgsz == 64 else 1))
        orders.append([m["im_file"] for b in pbs for m in b["meta"]])
    assert orders[0] != orders[1]  # the epochs shuffle differently
    _check_batches(jloader.first_batch(), ploader.first_batch(), 0 if imgsz == 64 else 1)
    print(f"imgsz {imgsz} augment {augment}: max image difference {worst} level(s)")


def test_label_cache_is_shared_with_jax(synth):
    _, py = synth
    cfg = dataset.check_det_dataset(py)
    a = dataset.YOLODataset(cfg["val"], imgsz=64)
    cache = a._cache_path()
    assert cache.exists()
    j = jdataset.YOLODataset(cfg["val"], imgsz=64)  # reads the port's cache
    for la, lj in zip(a.labels, j.labels):
        np.testing.assert_array_equal(la["cls"], lj["cls"])
        np.testing.assert_array_equal(la["bboxes"], lj["bboxes"])
    b = dataset.YOLODataset(cfg["val"], imgsz=64)  # from the cache
    for la, lb in zip(a.labels, b.labels):
        np.testing.assert_array_equal(la["bboxes"], lb["bboxes"])


def test_dataset_options_match_jax(synth):
    _, py = synth
    cfg = dataset.check_det_dataset(py)
    for kw in ({"fraction": 0.5}, {"classes": [1]}, {"single_cls": True}, {"cache": "ram"}):
        p = dataset.YOLODataset(cfg["train"], imgsz=64, **kw)
        j = jdataset.YOLODataset(cfg["train"], imgsz=64, **kw)
        assert p.im_files == j.im_files and p.max_gt == j.max_gt
        for i in range(len(p)):
            pi, ji = p.get_item(i), j.get_item(i)
            for k in ("img", "cls", "bboxes", "mask_gt", "ori_cls"):
                np.testing.assert_array_equal(pi[k], ji[k], err_msg=f"{kw} {k}")
    p = dataset.YOLODataset(cfg["train"], imgsz=64)
    j = jdataset.YOLODataset(cfg["train"], imgsz=64)
    p.set_rectangle(4)
    j.set_rectangle(4)
    assert p._rect_shape == j._rect_shape and p.im_files == j.im_files
    assert dataset.img2label_path("/d/images/a/x.png") == jdataset.img2label_path("/d/images/a/x.png")


JPEG_SIZES = [(48, 64), (64, 48), (40, 80), (80, 40), (60, 60), (30, 90), (90, 30), (50, 70),
              (70, 50), (45, 64)]


@pytest.fixture(scope="module")
def jpeg_set(tmp_path_factory):
    """PIL-written JPEGs (q92, 4:2:0) of ten aspects with one to three boxes each."""
    root = tmp_path_factory.mktemp("jpeg")
    rs = np.random.RandomState(11)
    for split in ("images", "labels"):
        (root / split / "val").mkdir(parents=True)
    for i, (h, w) in enumerate(JPEG_SIZES):
        Image.fromarray(_picture(h, w, i)).save(root / "images" / "val" / f"{i}.jpg", quality=92)
        boxes = [f"{rs.randint(3)} {rs.uniform(0.3, 0.7):.6f} {rs.uniform(0.3, 0.7):.6f} "
                 f"{rs.uniform(0.1, 0.5):.6f} {rs.uniform(0.1, 0.5):.6f}"
                 for _ in range(rs.randint(1, 4))]
        (root / "labels" / "val" / f"{i}.txt").write_text("\n".join(boxes) + "\n")
    return str(root / "images" / "val")


@pytest.mark.parametrize("rect,augment", [(False, False), (False, True), (True, False)])
def test_jpeg_loader_matches_jax_pil_path(jpeg_set, monkeypatch, rect, augment):
    """JPEG files decoded by the port's codec and letterboxed over threads against
    JAX's PIL decode and letterbox (EDGEYOLO_NATIVE_IO=0): labels, ratio and pads
    exact, pixels within 1 grey level; rect batches keep JAX's canvas shapes."""
    monkeypatch.setenv("EDGEYOLO_NATIVE_IO", "0")
    monkeypatch.setattr(jdataset, "_NATIVE_IO", False)
    imgsz, bs = (128, 2) if rect else (64, 4)  # rect: canvases of 64 x 128, 128 x 128, 128 x 64
    names = {0: "a", 1: "b", 2: "c"}
    pset = dataset.YOLODataset(jpeg_set, imgsz=imgsz, augment=augment, names=names)
    jset = jdataset.YOLODataset(jpeg_set, imgsz=imgsz, augment=augment, names=names)
    if rect:
        pset.set_rectangle(bs)
        jset.set_rectangle(bs)
        assert pset._rect_shape == jset._rect_shape and len(set(pset._rect_shape)) == 3
    assert pset.im_files == jset.im_files and pset.max_gt == jset.max_gt
    pbs = list(dataset.build_dataloader(pset, bs, shuffle=False))
    jbs = list(jdataset.build_dataloader(jset, bs, shuffle=False))
    assert len(pbs) == len(jbs) == (len(JPEG_SIZES) + bs - 1) // bs
    worst = max(_check_batches(jb, pb, img_tol=1) for jb, pb in zip(jbs, pbs))
    print(f"rect {rect} augment {augment}: batch shapes {[b['img'].shape for b in pbs]}, "
          f"max image difference {worst} level(s)")


def test_loader_raises_a_decode_error_in_the_consumer(tmp_path, synth):
    _, py = synth
    cfg = dataset.check_det_dataset(py)
    ds = dataset.YOLODataset(cfg["train"], imgsz=64)
    ds.im_files = list(ds.im_files)
    ds.im_files[5] = str(tmp_path / "missing.png")
    with pytest.raises(FileNotFoundError):
        list(dataset.build_dataloader(ds, 2, shuffle=False))


# -- inference sources --------------------------------------------------------------
def test_inference_sources(synth):
    _, py = synth
    vdir = py.parent / "images" / "val"
    files = sorted(vdir.glob("*.png"))
    for src, n in ((vdir, 3), (str(files[0]), 1), (str(vdir / "*.png"), 3),
                   ([str(f) for f in files[:2]], 2)):
        got = list(load_inference_source(src)[0])
        assert len(got) == n
        assert all(im.shape == (64, 64, 3) and im.dtype == np.uint8 for _, im in got)
    arr = np.zeros((5, 7, 3), np.uint8)
    assert [(n, im.shape) for n, im in load_inference_source(arr)[0]] == [("image0", (5, 7, 3))]
    assert [n for n, _ in load_inference_source([arr, arr])[0]] == ["image0", "image1"]
    for batch in (np.zeros((2, 5, 7, 3), np.uint8), torch.zeros(2, 5, 7, 3, dtype=torch.uint8)):
        loader, kinds = load_inference_source(batch)
        assert [n for n, _ in loader] == ["tensor0", "tensor1"] and kinds.tensor
    mp4 = py.parent / "clip.mp4"  # a video file no built-in decoder reads
    mp4.write_bytes(b"\0" * 64)
    with pytest.raises(NotImplementedError, match="register_video_decoder"):
        list(load_inference_source(str(mp4))[0])
