"""FastSAM's prompts and auto-annotation in the PyTorch port against the JAX
package (edgeyolo_tpu/engine/fastsam.py, data/annotator.py), on the CPU.

- `bbox_prompt` and `point_prompt` select JAX's indices: both packages'
  functions get the same Results (seeded proposal boxes; prompt boxes and
  points, negative labels, an IoU gate, an image with no proposal).
- The facade: the port's FastSAM (fastsam.yaml, scale n, the segment
  family's perturbation with its class logits spread so proposals pass the
  gate) in everything mode over synthetic 64 px images gives masked
  proposals, and its prompted Results are the proposals the prompt
  functions select.
- `auto_annotate` writes JAX's label files: both packages' detectors are
  stubs that yield the same boxes on the same images (a class filter drops
  one class), both SAM facades hold the same small model (tests/
  test_torch_sam.py's), and JAX's outlines are its numpy path, the port's
  `masks2segments` (ROADMAP section C.14): the same files, lines and
  classes, coordinates within 1e-4.
"""

import numpy as np
import pytest
import torch
from test_torch_sam import IMG, SMALL, _filled, _shapes
from test_torch_v13_e2e_families import _perturbed
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

import edgeyolo_tpu_torch
from edgeyolo_tpu.data import annotator as jannotator
from edgeyolo_tpu.engine import fastsam as jfastsam
from edgeyolo_tpu.engine import results as jresults
from edgeyolo_tpu.engine import sam as jsam
from edgeyolo_tpu.nn import sam as jnsam
from edgeyolo_tpu.ops import segments as jsegments
from edgeyolo_tpu_torch.data.annotator import auto_annotate
from edgeyolo_tpu_torch.data.imageio import load_image_rgb
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine import fastsam, results, sam
from edgeyolo_tpu_torch.nn import sam as nsam
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

S = 64


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("fastsam")
    y = generate_dataset(root / "ds", n_train=1, n_val=4, imgsz=S, nc=3)
    return y.parent / "images" / "val"


@pytest.fixture(scope="module")
def everything(data):
    fs = edgeyolo_tpu_torch.FastSAM("fastsam.yaml", device="cpu")
    m = fs.yolo.model
    m.load_state_dict(_perturbed(m.state_dict(), 1.5))
    res = fs(str(data), imgsz=S, conf=0.3, save=False)
    return fs, res


def test_everything_mode_gives_masked_proposals(everything):
    fs, res = everything
    assert fs.yolo.task == "segment" and fs.yolo.model.nc == 1
    assert len(res) == 4 and all(r.masks is not None for r in res if len(r))
    assert sum(len(r) for r in res) > 8


PROMPTS = [
    ("bbox", {"bboxes": [[5, 5, 40, 40], [30, 20, 60, 63]]}),
    ("bbox_gate", {"bboxes": [[0, 0, 30, 30]], "iou_thres": 0.2}),
    ("point", {"points": [[32, 32], [10, 50]]}),
    ("point_negative", {"points": [[32, 32], [10, 10], [40, 12]], "labels": [1, 1, 0]}),
]


def _proposals():
    """Four images' Results of 25 seeded proposal boxes each, and one with none."""
    rs = np.random.RandomState(6)
    res = []
    for i in range(4):
        xy = rs.uniform(0, 48, (25, 2))
        wh = rs.uniform(4, 40, (25, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, S), rs.uniform(0.3, 1, (25, 1)),
                                np.zeros((25, 1))], 1)
        res.append(results.Results(np.zeros((S, S, 3), np.uint8), f"{i}.png", {0: "object"},
                                   boxes=boxes))
    return res + [results.Results(np.zeros((S, S, 3), np.uint8), "empty.png", {0: "object"},
                                  boxes=np.zeros((0, 6)))]


@pytest.mark.parametrize("kind,kw", PROMPTS, ids=[p[0] for p in PROMPTS])
def test_prompt_selections_equal_jax(kind, kw):
    res = _proposals()
    if kind.startswith("bbox"):
        got = fastsam.bbox_prompt(res, kw["bboxes"], kw.get("iou_thres", 0.0))
        want = jfastsam.bbox_prompt(res, kw["bboxes"], kw.get("iou_thres", 0.0))
    else:
        got = fastsam.point_prompt(res, kw["points"], kw.get("labels"))
        want = jfastsam.point_prompt(res, kw["points"], kw.get("labels"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert sum(len(g) for g in got) > 0 and len(got[-1]) == 0


def test_facade_prompts_return_the_selected_proposals(everything, data):
    fs, res = everything
    boxes = [[5, 5, 40, 40]]
    sel = fastsam.bbox_prompt(res, boxes)
    got = fs(str(data), bboxes=boxes, imgsz=S, conf=0.3, save=False)
    for r, g, idx in zip(res, got, sel):
        assert len(g) == len(idx)
        np.testing.assert_array_equal(g.boxes.data, r.boxes.data[idx])
        if len(idx):
            np.testing.assert_array_equal(g.masks.data, r.masks.data[idx])
    pts = fs(str(data), points=[[32, 32]], labels=[1], imgsz=S, conf=0.3, save=False)
    assert [len(p) for p in pts] == [len(i) for i in fastsam.point_prompt(res, [[32, 32]])]


class _Detector:
    """A detector that yields fixed boxes on each image of a folder, as the
    given package's Results."""

    def __init__(self, folder, make):
        self.files = sorted(folder.iterdir())
        self.make = make

    def predict(self, source, stream=False, **kw):
        for i, f in enumerate(self.files):
            img = load_image_rgb(f)
            h, w = img.shape[:2]
            boxes = np.array([[4 + i, 6, w / 2 + i, h - 8, 0.9, i % 3],
                              [w / 3, h / 4, w - 5, h / 2 + 3, 0.8, (i + 1) % 3]], np.float32)
            yield self.make(img, str(f), {0: "a", 1: "b", 2: "c"}, boxes=boxes)


def test_auto_annotate_writes_jax_label_files(data, tmp_path, monkeypatch):
    jm = jnsam.SAMModel(**SMALL)
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    flat = _filled(_shapes(jm.init, jnp.asarray(x), jnp.zeros((1, 1, 2)),
                           jnp.zeros((1, 1), jnp.int32)), seed=5)
    jf = jsam.SAM.__new__(jsam.SAM)
    jf.img_size, jf.net, jf._embed, jf._hw = IMG, jm, None, None
    jf.variables = traverse_util.unflatten_dict(flat)
    jf._encode = jax.jit(lambda v, a: jm.apply(v, a, method="encode"))
    jf._prompt = jax.jit(lambda v, e, p, lab: jm.apply(v, e, p, lab, method="prompt"))
    pm = nsam.SAMModel(**SMALL).eval()
    pm.load_state_dict(from_jax_variables(flat), strict=False)
    pf = sam.SAM.__new__(sam.SAM)
    pf.device, pf.img_size, pf.net, pf._embed, pf._hw = torch.device("cpu"), IMG, pm, None, None

    monkeypatch.setattr(jsegments, "_HAS_CV2", False)  # JAX's numpy outline: the port's
    out_p = auto_annotate(data, _Detector(data, results.Results), pf, classes=[0, 1],
                          output_dir=tmp_path / "p")
    out_j = jannotator.auto_annotate(data, _Detector(data, jresults.Results), jf,
                                     classes=[0, 1], output_dir=tmp_path / "j")
    files = sorted(p.name for p in out_p.iterdir())
    assert files == sorted(p.name for p in out_j.iterdir()) and len(files) >= 3
    n_lines = 0
    for name in files:
        got = (out_p / name).read_text().splitlines()
        want = (out_j / name).read_text().splitlines()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g, w = g.split(), w.split()
            assert g[0] == w[0] and g[0] in ("0", "1") and len(g) == len(w) > 6
            np.testing.assert_allclose(np.float64(g[1:]), np.float64(w[1:]), atol=1e-4)
        n_lines += len(got)
    assert n_lines >= 3
    default = auto_annotate(data, _Detector(data, results.Results), pf)
    assert default == data.parent / f"{data.name}_auto_annotate_labels" and any(default.iterdir())
