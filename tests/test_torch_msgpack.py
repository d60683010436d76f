"""The JAX package's `.msgpack` checkpoints in the port: the decoder
(utils/msgpack.py) against flax's own, and the facade's `.msgpack` loading,
`load`, `save_pretrained` and `from_pretrained` against JAX's.

Tolerances: the decoder and the transferred tensors exact; preds of the
same weights 5e-3 px on boxes and 1e-4 on scores (the family tests'
tolerances: f32 on both sides, convolutions summed in different orders).
"""

import os
import subprocess
import sys
from pathlib import Path

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from edgeyolo_tpu import YOLO as JaxYOLO
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.utils import msgpack as mp
from edgeyolo_tpu_torch.utils.convert import from_jax_variables
from test_torch_families import _jax_template
from test_torch_v13_e2e_families import _perturbed
from torch_family_checks import to_jax
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

REPO = Path(__file__).resolve().parents[1]
S = 64


def _same(a, b) -> bool:
    """Equal trees, arrays by dtype, shape and bytes (bf16 as its bits)."""
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(b, np.ndarray) and b.dtype == jnp.bfloat16:
        return (isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
                and tuple(a.shape) == b.shape
                and np.array_equal(a.view(torch.int16).numpy(), b.view(np.int16)))
    if isinstance(b, (np.ndarray, np.generic)):
        return (type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == np.shape(b)
                and np.array_equal(a, b, equal_nan=True))
    return type(a) is type(b) and (a == b or (a != a and b != b))


def _tree():
    rs = np.random.RandomState(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, 2 ** 64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    return {
        "params": {"l0_Conv": {"conv": {"kernel": rs.randn(3, 3, 3, 16).astype(np.float32)},
                               "bn": {"scale": rs.randn(16).astype(np.float16),
                                      "bias": jnp.asarray(rs.randn(16), jnp.bfloat16)}},
                   "wide": {f"k{i}": np.float32(i) for i in range(20)}},  # map16
        "ints": {f"i{j}": v for j, v in enumerate(ints)},
        "arrays": {"i8": rs.randint(-128, 128, (5, 7)).astype(np.int8),
                   "u8": rs.randint(0, 256, (70000,)).astype(np.uint8),  # bin32
                   "i32": rs.randint(-2 ** 31, 2 ** 31, (4,)).astype(np.int32),
                   "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
                   "f64": rs.randn(3).astype(np.float64), "bool": np.array([True, False]),
                   "empty": np.zeros((0, 3), np.float32), "scalar0d": np.array(2.5, np.float32)},
        "scalars": {"f32": np.float32(1.5), "i64": np.int64(-7), "u8": np.uint8(200),
                    "bf16": jnp.bfloat16(3.25)},
        "py": {"float": 0.1, "neg": -2.5e300, "none": None, "t": True, "f": False,
               "s": "x" * 31, "s8": "y" * 40, "s16": "z" * 300, "uni": "äö€", "bytes": b"\x00\x01",
               "complex": 1.5 - 2j, "list": [1, "a", [2.0, None]] + list(range(20))},
    }


def test_decoder_matches_flax_on_what_flax_writes():
    blob = fser.msgpack_serialize(_tree())
    assert _same(mp.restore(blob), fser.msgpack_restore(blob))


def test_decoder_joins_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)  # bytes: every array here is chunked
    rs = np.random.RandomState(1)
    tree = {"a": {"w": rs.randn(7, 9).astype(np.float32), "b": np.arange(40, dtype=np.int16)},
            "c": jnp.asarray(rs.randn(50), jnp.bfloat16)}
    blob = fser.msgpack_serialize(tree)
    raw = mp.unpackb(blob)
    assert raw["a"]["w"]["__msgpack_chunked_array__"] and len(raw["a"]["w"]["chunks"]) > 1
    assert _same(mp.restore(blob), fser.msgpack_restore(blob))


def test_decoder_refuses_broken_documents():
    blob = fser.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        mp.unpackb(blob[:-1])
    with pytest.raises(ValueError, match="after"):
        mp.unpackb(blob + b"\x00")
    with pytest.raises(ValueError, match="type byte"):
        mp.unpackb(b"\xc1")


@pytest.fixture(scope="module")
def flagship_ckpt(tmp_path_factory):
    """JAX's YOLO.save of the flagship (perturbed weights) and JAX's pred."""
    root = tmp_path_factory.mktemp("ck")
    pm = DetectionModel("edgeline-yolo.yaml", device="cpu")
    sd = _perturbed(pm.state_dict(), 2.2)  # image-dependent, below f32's chaotic edge (~2.5)
    jy = JaxYOLO("edgeline-yolo.yaml")
    jy.model.variables = jax.tree.map(jnp.asarray, to_jax(pm, sd, _jax_template(jy.model))[0])
    path = jy.save(root / "flag.msgpack")
    imgs = np.random.RandomState(1).randint(0, 256, (2, S, S, 3)).astype(np.uint8)
    jpred = np.asarray(jax.jit(lambda v, x: jy.model.apply(v, x)["pred"])(
        jy.model.variables, jnp.asarray(imgs, jnp.float32) / 255))
    return {"root": root, "path": path, "jy": jy, "imgs": imgs, "jpred": jpred}


def _pred(y: YOLO, imgs: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return y.model(torch.from_numpy(imgs).permute(0, 3, 1, 2).float() / 255)["pred"].numpy()


def _assert_pred_close(pred, jpred):
    assert pred.shape == jpred.shape
    d = np.abs(pred - jpred)
    assert d[..., :4].max() < 5e-3, d[..., :4].max()
    assert d[..., 4:].max() < 1e-4, d[..., 4:].max()


def test_yolo_reads_jaxs_saved_checkpoint(flagship_ckpt):
    y = YOLO(flagship_ckpt["path"], device="cpu")
    assert y.trained and y.model_name == "edgeline-yolo.yaml" and y.task == "detect"
    assert y.model.names == flagship_ckpt["jy"].model.names
    _assert_pred_close(_pred(y, flagship_ckpt["imgs"]), flagship_ckpt["jpred"])


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """yolo11n trained by JAX's DetectionTrainer: one epoch of two 64 px images."""
    root = tmp_path_factory.mktemp("jt")
    data = generate_dataset(root / "ds", n_train=2, n_val=2, imgsz=S, nc=3, seed=0)
    jy = JaxYOLO("yolo11n.yaml")
    jy.train(data=str(data), epochs=1, imgsz=S, batch=2, nbs=2, val=False, plots=False,
             workers=0, mosaic=0.0, warmup_epochs=0, amp=False, project=str(root / "runs"),
             name="t")
    last = root / "runs" / "t" / "last.msgpack"
    assert last.exists()
    return {"root": root, "data": data, "last": last}


def test_yolo_reads_jaxs_trainer_checkpoint(jax_trained):
    imgs = np.random.RandomState(2).randint(0, 256, (2, S, S, 3)).astype(np.uint8)
    jy = JaxYOLO(str(jax_trained["last"]))
    jpred = np.asarray(jax.jit(lambda v, x: jy.model.apply(v, x)["pred"])(
        jy.model.variables, jnp.asarray(imgs, jnp.float32) / 255))
    y = YOLO(jax_trained["last"], device="cpu")
    assert y.model.nc == 3 and y.overrides["imgsz"] == S
    assert y.model.names == {int(k): v for k, v in jy.model.names.items()}
    _assert_pred_close(_pred(y, imgs), jpred)
    # the EMA weights and the BatchNorm statistics, tensor for tensor
    flat = traverse_util.flatten_dict(jax.device_get(jy.model.variables))
    ref = from_jax_variables({k: np.asarray(v) for k, v in flat.items()})
    sd = y.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in ref.items())


def test_load_of_a_msgpack_donor_transfers_what_jax_transfers(flagship_ckpt):
    """A flagship with a 3-class head takes every tensor of the 80-class donor
    but the class convs' last layers, as JAX's load does."""
    jy = JaxYOLO("edgeline-yolo.yaml")
    jy.model = jtasks.DetectionModel(dict(jy.model.yaml, nc=3))
    rs = np.random.RandomState(3)
    start = {k: rs.uniform(0.5, 1.5, a.shape).astype(a.dtype) for k, a in
             traverse_util.flatten_dict(_jax_template(jy.model)).items()}
    jy.model.variables = traverse_util.unflatten_dict(
        {k: jnp.asarray(a) for k, a in start.items()})
    y = YOLO("edgeline-yolo.yaml", device="cpu")
    y.model = DetectionModel("edgeline-yolo.yaml", nc=3, device="cpu")
    y.model.load_state_dict(from_jax_variables({k: np.asarray(v) for k, v in start.items()}),
                            strict=False)
    jy.load(flagship_ckpt["path"])
    y.load(flagship_ckpt["path"])
    after = traverse_util.flatten_dict(jax.device_get(jy.model.variables))
    moved = {k for k in after if not np.array_equal(np.asarray(after[k]), np.asarray(start[k]))}
    assert 0 < len(moved) < len(after)
    ref = from_jax_variables({k: np.asarray(v) for k, v in after.items()})
    sd = y.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in ref.items())


def test_save_pretrained_round_trips(tmp_path):
    y = YOLO("yolo11n.yaml", device="cpu")
    y.model.names = {i: f"c{i}" for i in range(80)}
    d = y.save_pretrained(tmp_path / "snap")
    assert {p.name for p in d.iterdir()} == {"model.pt", "model.json", "config.json",
                                             "README.md"}
    back = YOLO.from_pretrained(d, device="cpu")
    assert back.model.names == y.model.names and back.task == "detect"
    sd = y.model.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in back.model.state_dict().items())


def test_from_pretrained_reads_a_jax_snapshot(flagship_ckpt, tmp_path):
    d = flagship_ckpt["jy"].save_pretrained(tmp_path / "jsnap")
    y = YOLO.from_pretrained(d, device="cpu")
    _assert_pred_close(_pred(y, flagship_ckpt["imgs"]), flagship_ckpt["jpred"])
    if importlib_missing("huggingface_hub"):
        with pytest.raises(ImportError, match="huggingface_hub"):
            YOLO.from_pretrained("someone/some-model", device="cpu")


def importlib_missing(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is None


def test_port_reads_a_checkpoint_with_flax_and_msgpack_blocked(flagship_ckpt):
    code = ("import sys\n"
            "sys.modules['flax'] = None\nsys.modules['msgpack'] = None\n"
            "from edgeyolo_tpu_torch.engine.model import YOLO\n"
            f"y = YOLO({str(flagship_ckpt['path'])!r}, device='cpu')\n"
            "print(y.model.nc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "80", r.stderr[-2000:]
