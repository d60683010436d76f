"""The port's benchmark table (utils/benchmarks.py), the facade's `export` and
`benchmark`, and the CLI's `export` and `benchmark` modes, on the CPU.

- The table over native, native-int8, torch_export, npz and onnx, validated
  on the port's synthetic set (64 px, one large box an image, so an untrained
  3-class yolo11n with its class logits at 0 scores above 0): every artifact
  row ok, native / torch_export / npz mAP50-95 equal within 1e-6 (one forward
  function, reloaded three ways), onnx within 1e-3 (the numpy executor sums
  in another order: NMS may keep another near-duplicate), native-int8 gated
  until nn/quant.py is ported.
- The native row within 1e-3 of JAX's `benchmark` native row on the same
  weights (the validators' mAP, f32 forward on both sides).
- The CLI's export and benchmark modes end to end on device=cpu; tune refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import _jax_template
from torch_threads import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

from edgeyolo_tpu import YOLO as JaxYOLO
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.utils.benchmarks import benchmark as jax_benchmark
from edgeyolo_tpu.utils.torch_convert import convert_state_dict
from edgeyolo_tpu_torch.cfg.cli import entrypoint
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.export import exporter
from edgeyolo_tpu_torch.utils.benchmarks import INT8_GATED, profile_layers

S = 64
FORMATS = ["native", "native-int8", "torch_export", "npz", "onnx"]


def _scoring_model(seed=0):
    """yolo11n with 3 classes, its class logits at 0 (scores 0.5, past the val gate)."""
    y = YOLO("yolo11n.yaml", device="cpu")
    from edgeyolo_tpu_torch.nn.tasks import DetectionModel

    y.model = DetectionModel("yolo11n.yaml", nc=3, device="cpu", seed=seed)
    with torch.no_grad():
        for seq in y.model.model[-1].cv3:
            seq[-1].bias.zero_()
    return y


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    data = generate_dataset(root / "ds", n_train=2, n_val=8, imgsz=S, nc=3, min_objs=1,
                            max_objs=1, min_size=0.7, max_size=0.9, seed=0)
    y = _scoring_model()
    rows = y.benchmark(imgsz=S, batch=2, iters=2, data=str(data), formats=FORMATS,
                       out_dir=str(root / "exp"), verbose=False)
    return {"root": root, "data": data, "model": y, "rows": {r["format"]: r for r in rows}}


def test_table_rows_and_their_maps(table):
    rows = table["rows"]
    assert list(rows) == FORMATS
    assert rows["native-int8"]["status"] == INT8_GATED
    for f in ("native", "torch_export", "npz", "onnx"):
        r = rows[f]
        assert r["status"] == "ok", r
        assert r["imgs/s"] > 0 and r["ms/img"] > 0 and isinstance(r["mAP50-95"], float)
    maps = {f: rows[f]["mAP50-95"] for f in ("native", "torch_export", "npz", "onnx")}
    print(f"mAP50-95 by format: {maps}")
    assert maps["native"] > 0
    assert abs(maps["torch_export"] - maps["native"]) <= 1e-6
    assert abs(maps["npz"] - maps["native"]) <= 1e-6
    assert abs(maps["onnx"] - maps["native"]) <= 1e-3
    assert not table["model"].model.fused  # the table exports copies


def test_native_row_matches_jaxs(table):
    y = table["model"]
    jy = JaxYOLO("yolo11n.yaml")
    jy.model = jtasks.DetectionModel("yolo11n.yaml", nc=3)
    variables, _ = convert_state_dict({k: v.numpy() for k, v in y.model.state_dict().items()},
                                      _jax_template(jy.model), strict=True)
    jy.model.variables = jax.tree.map(jnp.asarray, variables)
    (row,) = jax_benchmark(jy, imgsz=S, batch=2, iters=1, data=str(table["data"]),
                           formats=["native"], out_dir=str(table["root"] / "jax"), verbose=False)
    ours = table["rows"]["native"]["mAP50-95"]
    print(f"native mAP50-95: port {ours}, JAX {row['mAP50-95']}")
    assert row["status"] == "ok" and abs(row["mAP50-95"] - ours) <= 1e-3


def test_cli_export_and_benchmark_modes(table, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the table's default out_dir is relative
    assert entrypoint(["detect", "export", "model=yolo11n.yaml", "format=onnx", f"imgsz={S}",
                       "device=cpu", f"project={tmp_path / 'p'}", "name=e"]) == 0
    out = capsys.readouterr().out
    path = out.split("exported -> ")[1].strip()
    assert path == str(tmp_path / "p" / "e" / "yolo11n.onnx") and json.loads(
        open(path.replace(".onnx", ".json")).read())["imgsz"] == S
    monkeypatch.setattr(exporter, "EXPORT_FORMATS", {"npz": (".npz", True)})
    assert entrypoint(["detect", "benchmark", "model=yolo11n.yaml", f"imgsz={S}", "device=cpu",
                       f"data={table['data']}"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["format"] for r in rows] == ["native", "native-int8", "npz"]
    assert rows[0]["status"] == rows[2]["status"] == "ok" and rows[1]["status"] == INT8_GATED
    with pytest.raises(NotImplementedError, match="tune"):
        entrypoint(["detect", "tune", "model=yolo11n.yaml"])


def test_profile_layers_covers_every_layer():
    y = YOLO("yolo11n.yaml", device="cpu")
    rows = profile_layers(y, imgsz=S, iters=1)
    assert [r["i"] for r in rows] == list(range(len(y.model.layers)))
    cum = np.array([r["cum_ms"] for r in rows])
    assert (np.diff(cum) >= 0).all() and cum[-1] > 0
