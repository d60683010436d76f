"""int8 PTQ of the port (nn/quant.py) against the JAX package's nn/quant.py.

Models at 64 px, f32 on the CPU, calibrated on the same two images on both
sides: the flagship (edgeline-yolo-n), yolo11n and yolov13-test-n, with
weights perturbed as in the family tests so activations stay O(1) through
the depth. JAX's convs map to the port's module names by
`jax_path_to_torch_key`.

Tolerances:
- the quantized set equal; int8 weights and weight scales equal to the bit
  (the same f32 numpy arithmetic on the same f32 weights);
- activation scales 1e-5 relative: each side's own f32 forward up to the
  conv, up to 30 layers deep, sums in another order (measured at most
  4.5e-6 on these three models);
- per conv of the flagship, at JAX's own input: the int8 codes equal JAX's
  (a code may differ only where x / sx lies within one f32 ulp of a .5 edge,
  in under 1e-4 of the elements) and the output within 1e-6 of its scale
  (XLA may contract the epilogue's product and sum into one FMA);
- the flagship's int8 pred within 1e-3 of its scale (boxes and scores each):
  24 layers of requantized activations, where an f32 rounding difference
  upstream can move a code by one step. Measured with JAX's calibration on
  both sides: 1.3e-7 and 1.5e-7 of the scale at weight scale 2.0, 3.0e-7 and
  1.8e-7 at 2.5 (the one tested), but 2.7e-4 and 4.4e-3 at 2.2, where one
  such step early in the net cascades to the scores;
- a half int8 predict (bf16 copy, calibrated on the bf16 request as JAX's
  predictor): int8 weights, weight scales and f32 biases equal to JAX's
  to the bit; per conv the tolerances of `test_half_int8_each_conv_matches_jax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from edgeyolo_tpu.nn import quant as Q
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu_torch.data.synthetic import generate_dataset
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.engine.predictor import DetectionPredictor
from edgeyolo_tpu_torch.nn import quant as PQ
from edgeyolo_tpu_torch.nn.tasks import DetectionModel, for_precision
from edgeyolo_tpu_torch.ops import int8_conv as ic
from edgeyolo_tpu_torch.utils.convert import jax_path_to_torch_key
from test_torch_families import _jax_template
from test_torch_v13_e2e_families import _perturbed
from torch_family_checks import jax_spec, to_jax
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

S = 64
MODELS = {"edgeline-yolo-n": ("edgeline-yolo.yaml", "", 2.5, 138),
          "yolo11n": ("yolo11.yaml", "n", 2.5, 87),
          "yolov13-test-n": ("yolov13-test.yaml", "n", 1.8, 225)}


def _imgs():
    return np.random.RandomState(1).randint(0, 256, (2, S, S, 3)).astype(np.uint8)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2).contiguous()


def _torch_name(path: str) -> str:
    return jax_path_to_torch_key(tuple(path.split("/")) + ("kernel",)).rsplit(".", 1)[0]


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """Both packages' models with the same weights, each calibrated and
    quantized on the same batch."""
    yaml, scale, weight_scale, n_convs = MODELS[request.param]
    pm = DetectionModel(yaml, scale=scale or None, device="cpu")
    sd = _perturbed(pm.state_dict(), weight_scale)
    pm.load_state_dict(sd)
    jm = jtasks.DetectionModel(jax_spec(yaml, scale))
    variables, _ = to_jax(pm, sd, _jax_template(jm))
    variables = jax.tree.map(jnp.asarray, variables)
    x = _imgs().astype(np.float32) / 255.0
    jqs = Q.quantize(variables, Q.calibrate(jm.net, variables, [jnp.asarray(x)]))
    qs = pm.quantize(_nchw(x))
    return {"name": request.param, "n": n_convs, "pm": pm, "jm": jm, "variables": variables,
            "jqs": jqs, "qs": qs, "x": x}


def test_quantized_set_scales_and_weights_are_jax_s(pair):
    jqs, qs = pair["jqs"], pair["qs"]
    jnames = {_torch_name(p): p for p in jqs.wq}
    assert len(jnames) == len(jqs.wq) == pair["n"]
    assert set(qs.wq) == set(jnames)
    for name, p in jnames.items():
        a, b = qs.act_scales[name], jqs.act_scales[p]
        assert abs(a - b) <= 1e-5 * b, (name, a, b)
        assert np.array_equal(qs.wq[name].numpy(),
                              np.asarray(jqs.wq[p]).transpose(3, 2, 0, 1)), name
        assert np.array_equal(qs.ws[name].numpy().view(np.int32),
                              np.asarray(jqs.ws[p]).view(np.int32)), name
    assert sum(isinstance(m, PQ.QConv2d) for m in pair["pm"].modules()) == pair["n"]


def _capture(dtype):
    """JAX's jitted int8 flagship forward on the images in `dtype` (its
    interceptor, as served), calibrated on the same input in that dtype (as
    JAX's predictor calibrates its first chunk), with each conv's input, int8
    codes and output captured; and the port's f32 model of the same weights."""
    yaml, scale, weight_scale, _ = MODELS["edgeline-yolo-n"]
    pm = DetectionModel(yaml, device="cpu")
    sd = _perturbed(pm.state_dict(), weight_scale)
    pm.load_state_dict(sd)
    jm = jtasks.DetectionModel(jax_spec(yaml, scale))
    variables = jax.tree.map(jnp.asarray, to_jax(pm, sd, _jax_template(jm))[0])
    x = jnp.asarray(_imgs(), dtype) / 255.0
    jqs = Q.quantize(variables, Q.calibrate(jm.net, variables, [x]))
    rec, cur = {}, []
    conv = jax.lax.conv_general_dilated

    def conv_spy(lhs, *a, **k):
        if lhs.dtype == jnp.int8:
            rec.setdefault(cur[-1], {})["xq"] = lhs
        return conv(lhs, *a, **k)

    def recorder(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Conv) and context.method_name == "__call__":
            path = "/".join(str(p) for p in context.module.path)
            cur.append(path)
            y = next_fun(*args, **kwargs)
            cur.pop()
            rec.setdefault(path, {}).update(x=args[0], y=y)
            return y
        return next_fun(*args, **kwargs)

    def forward(v, xx):
        rec.clear()
        with fnn.intercept_methods(recorder), Q.quant_ctx(jqs):
            pred = jm.net.apply(v, xx, train=False)["pred"]
        return pred, dict(rec)

    jax.lax.conv_general_dilated = conv_spy
    try:
        jpred, captured = jax.jit(forward)(variables, x)
    finally:
        jax.lax.conv_general_dilated = conv
    return pm, jqs, np.asarray(x, np.float32), np.asarray(jpred, np.float32), {
        _torch_name(p): {k: np.asarray(v) for k, v in d.items()} for p, d in captured.items()}


def _port_state(jqs, act_scales=None, bias=None) -> PQ.QuantState:
    """JAX's QuantState under the port's names and layout; `act_scales` and
    `bias` replace its scales and give the convs' f32 biases."""
    return PQ.QuantState(act_scales or {_torch_name(p): v for p, v in jqs.act_scales.items()},
                         *({_torch_name(p): torch.from_numpy(
                             np.array(a).transpose(3, 2, 0, 1) if a.ndim == 4 else np.array(a))
                            for p, a in tree.items()} for tree in (jqs.wq, jqs.ws)),
                         bias=bias)


def _biases(model) -> dict:
    return {n: m.bias.detach().float() for n, m in PQ.int8_convs(model).items()
            if m.bias is not None}


@pytest.fixture(scope="module")
def flagship_capture():
    """The f32 capture, the port's model quantized with JAX's own calibration."""
    pm, jqs, x, jpred, captured = _capture(jnp.float32)
    pm.quant = _port_state(jqs, bias=_biases(pm))
    return pm, x, jpred, captured


@pytest.fixture(scope="module")
def flagship_half():
    """The bf16 capture, and the port's half int8 predict on the same images
    as the facade serves it: a bf16 copy of the f32 model (`for_precision`)
    through the predictor's int8 flag, which calibrates on the request."""
    pm, jqs, _, _, captured = _capture(jnp.bfloat16)
    net = for_precision(pm, True)
    DetectionPredictor(net, conf=0.0, device="cpu", int8=True)(_imgs())
    return pm, net, jqs, captured


def test_each_conv_codes_and_output_match_jax(flagship_capture):
    pm, _, _, captured = flagship_capture
    convs = {n: m for n, m in pm.named_modules() if isinstance(m, PQ.QConv2d)}
    assert set(convs) == {n for n, d in captured.items() if "xq" in d} and len(convs) == 138
    differ = total = 0
    for name, m in convs.items():
        d = captured[name]
        x = _nchw(d["x"])
        codes = ic.quantize_codes(x, m.rcp).numpy()
        jcodes = d["xq"].transpose(0, 3, 1, 2).astype(np.float32)
        bad = codes != jcodes
        if bad.any():
            t = x.numpy().astype(np.float64)[bad] / np.float64(m.sx)
            edge = np.abs(np.abs(t - np.trunc(t)) - 0.5)
            assert (edge <= np.spacing(np.abs(t).astype(np.float32))).all(), name
        differ += int(bad.sum())
        total += bad.size
        if not bad.any():  # with equal codes the outputs agree to f32 rounding
            with torch.no_grad():
                y = m(x).numpy()
            jy = d["y"].transpose(0, 3, 1, 2)
            assert np.abs(y - jy).max() <= 1e-6 * np.abs(jy).max(), name
    assert differ <= 1e-4 * total, (differ, total)


def test_int8_pred_matches_jax(flagship_capture):
    pm, x, jpred, _ = flagship_capture
    with torch.no_grad():
        pred = pm(_nchw(x))["pred"].numpy()
    assert pred.shape == jpred.shape == (2, 84, 84)
    for part in (slice(0, 4), slice(4, None)):
        d = np.abs(pred[..., part] - jpred[..., part]).max()
        assert d <= 1e-3 * np.abs(jpred[..., part]).max(), d


def test_half_int8_quantizes_the_f32_weights_as_jax(flagship_half):
    """predict(int8=True, half=True): the int8 weights, their scales and the
    biases come from the f32 model, as JAX quantizes its f32 params whatever
    the request's dtype, and the state lives on the f32 model (JAX's handle).
    Quantizing the bf16 copy's rounded weights flips codes near a .5 edge."""
    pm, net, jqs, _ = flagship_half
    qs = net.quant
    assert qs is pm.quant and net.master is pm
    jnames = {_torch_name(p): p for p in jqs.wq}
    assert set(qs.wq) == set(jnames) and len(jnames) == 138
    for name, p in jnames.items():
        assert np.array_equal(qs.wq[name].numpy(),
                              np.asarray(jqs.wq[p]).transpose(3, 2, 0, 1)), name
        assert np.array_equal(qs.ws[name].numpy().view(np.int32),
                              np.asarray(jqs.ws[p]).view(np.int32)), name
    f32 = _biases(pm)
    assert set(qs.bias) == set(f32) and all(torch.equal(qs.bias[n], b) for n, b in f32.items())
    qconvs = {n: m for n, m in net.named_modules() if isinstance(m, PQ.QConv2d)}
    assert len(qconvs) == 138
    for n, m in qconvs.items():
        assert m.scale.dtype == torch.float32
        assert (m.qbias is None) == (n not in f32)
        assert m.qbias is None or torch.equal(m.qbias, f32[n])


def test_half_int8_each_conv_matches_jax(flagship_half):
    """Per conv of the bf16 copy under JAX's half calibration, at JAX's own
    input. JAX's half forward promotes to f32 from the wavelet block on (the
    port stays bf16: ROADMAP §C, "Parity as measured"), so 5 of the
    138 convs take bf16 there, and XLA quantizes their activation before the
    bf16 rounding it keeps in the captured input (excess precision). So:
    - the codes of the captured input equal JAX's but by one step, where
      x / sx lies within one bf16 step (2^-8 relative) of a .5 edge, in
      under 5e-3 of the elements (measured 2.1e-3);
    - JAX's own codes in (as x = codes * sx, which requantizes to them), the
      output within one bf16 step of its scale where JAX's is bf16 (measured
      2.6e-3 of 3.9e-3), within 1e-6 where it is f32.
    The whole pred is not compared: the two bf16 forwards differ by the bf16
    forward's own gap (and so do their calibrations, by up to 4%)."""
    pm, net, jqs, captured = flagship_half
    half = for_precision(pm, True)
    half.quant = _port_state(jqs, bias=net.quant.bias)
    convs = {n: m for n, m in half.named_modules() if isinstance(m, PQ.QConv2d)}
    assert set(convs) == {n for n, d in captured.items() if "xq" in d} and len(convs) == 138
    differ = total = n_bf16 = 0
    for name, m in convs.items():
        d = captured[name]
        bf16 = d["x"].dtype != np.float32
        n_bf16 += bf16
        x = torch.from_numpy(d["x"].astype(np.float32)).permute(0, 3, 1, 2).contiguous()
        codes = ic.quantize_codes(x.to(torch.bfloat16 if bf16 else torch.float32), m.rcp)
        jcodes = torch.from_numpy(d["xq"].transpose(0, 3, 1, 2).astype(np.float32))
        bad = (codes != jcodes).numpy()
        if bad.any():
            assert (codes - jcodes).abs().max() == 1, name
            t = x.numpy().astype(np.float64)[bad] / np.float64(m.sx)
            edge = np.abs(np.abs(t - np.trunc(t)) - 0.5)
            assert (edge <= 2.0 ** -8 * np.abs(t)).all(), name
        differ += int(bad.sum())
        total += bad.size
        with torch.no_grad():
            y = m(jcodes * m.sx).numpy()
        jy = d["y"].transpose(0, 3, 1, 2).astype(np.float32)
        tol = (2.0 ** -8 if d["y"].dtype != np.float32 else 1e-6) * np.abs(jy).max()
        assert np.abs(y - jy).max() <= tol, name
    assert n_bf16 == 5 and differ <= 5e-3 * total, (n_bf16, differ, total)


def test_quantized_model_keeps_its_state_dict_and_casts():
    m = DetectionModel("yolo11n", device="cpu")
    keys = list(m.state_dict())
    x = torch.rand(1, 3, S, S)
    m.quantize(x)
    assert list(m.state_dict()) == keys
    q = m.get_submodule("model.0.conv")
    assert isinstance(q, PQ.QConv2d) and q.weight is m.state_dict(keep_vars=True)[
        "model.0.conv.weight"]
    m.set_dtype(torch.bfloat16)
    assert q.weight.dtype == torch.bfloat16 and q.scale.dtype == torch.float32
    assert q.wq.dtype == torch.int8
    qs, m.quant = m.quant, None
    assert not any(isinstance(mod, PQ.QConv2d) for mod in m.modules())
    assert list(m.state_dict()) == keys
    assert type(m.get_submodule("model.0.conv")) is torch.nn.Conv2d
    with PQ.quant_ctx(m, qs):  # JAX's name: the int8 forward for a block
        assert isinstance(m.get_submodule("model.0.conv"), PQ.QConv2d)
    assert type(m.get_submodule("model.0.conv")) is torch.nn.Conv2d


def test_training_mode_runs_full_precision():
    m = DetectionModel("yolo11n", device="cpu")
    x = torch.rand(1, 3, S, S)
    with torch.no_grad():
        m.train()
        fp = m(x)["feats"][0]
        m.eval()
        m.quantize(x)
        m.train()
        assert torch.equal(m(x)["feats"][0], fp)


def test_quantization_engages_and_is_bounded():
    """As JAX's tests/test_quant.py: every BatchNorm shift at 0.5 so random
    init does not attenuate the activations to ~0."""
    m = DetectionModel("yolo11n", nc=3, device="cpu")
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.bias.fill_(0.5)
        x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, S, S).astype(np.float32))
        fp = m(x)["feats"]
        m.quantize(x)
        assert len(m.quant.wq) > 50
        q = m(x)["feats"]
    rels = [float((a - b).abs().max() / (a.abs().max() + 1e-9)) for a, b in zip(fp, q)]
    assert max(rels) > 1e-5, "quantized path identical to fp"
    assert max(rels) < 0.25, rels


def test_skip_list_respected():
    m = DetectionModel("yolo11n", nc=3, device="cpu")
    m.quantize(torch.zeros(1, 3, S, S), skip=("model.0.",))
    assert m.quant.wq and not any(n.startswith("model.0.") for n in m.quant.wq)
    assert type(m.get_submodule("model.0.conv")) is torch.nn.Conv2d
    assert isinstance(m.get_submodule("model.1.conv"), PQ.QConv2d)


def test_the_per_call_flag_stashes_and_reuses():
    m = DetectionModel("yolo11n", nc=3, device="cpu")
    x = torch.rand(1, 3, S, S)
    PQ.set_int8(m, True, lambda: x)
    qs = m.quant
    assert qs is not None
    PQ.set_int8(m, False, None)
    assert m.quant is None and m._quant_stash is qs
    assert not any(isinstance(mod, PQ.QConv2d) for mod in m.modules())

    def no_calibration():
        raise AssertionError("the stashed state should be reused")

    PQ.set_int8(m, True, no_calibration)
    assert m.quant is qs


def test_predictor_int8_flag_serves_int8():
    """int8=True was ignored before: the predictor took no such flag."""
    m = DetectionModel("yolo11n", nc=3, device="cpu")
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.bias.fill_(0.5)
    imgs = _imgs()
    fp = DetectionPredictor(m, conf=0.0, device="cpu")
    det_fp, _ = fp(imgs)
    det_q, _ = DetectionPredictor(m, conf=0.0, device="cpu", int8=True)(imgs)
    assert m.quant is not None and len(m.quant.wq) == 87
    assert not torch.equal(det_q, det_fp)
    det_fp2, _ = fp(imgs)
    assert m.quant is None and torch.equal(det_fp2, det_fp)


def test_validator_int8_flag_calibrates_on_the_first_batch(tmp_path):
    data = generate_dataset(tmp_path / "ds", n_train=2, n_val=4, imgsz=S)
    y = YOLO("yolo11n.yaml", device="cpu")
    y.model = DetectionModel("yolo11n.yaml", nc=3, device="cpu")  # the dataset's classes
    r_fp = y.val(data=str(data), batch=4, imgsz=S, project=str(tmp_path / "v"))
    assert y.model.quant is None
    y.val(data=str(data), batch=4, imgsz=S, project=str(tmp_path / "v"), int8=True)
    assert y.model.quant is not None and len(y.model.quant.wq) == 87
    r_fp2 = y.val(data=str(data), batch=4, imgsz=S, project=str(tmp_path / "v"))
    assert y.model.quant is None and y.model._quant_stash is not None
    assert r_fp2 == r_fp


def test_validator_half_int8_calibrates_the_f32_model(tmp_path):
    """val(int8=True, half=True) calibrates the f32 model in f32 on the first
    val batch, as JAX's validator, and keeps the state there for the next
    call; the bf16 copy it validates inherits it."""
    data = generate_dataset(tmp_path / "ds", n_train=2, n_val=4, imgsz=S)
    y = YOLO("yolo11n.yaml", device="cpu")
    y.model = DetectionModel("yolo11n.yaml", nc=3, device="cpu")
    kw = dict(data=str(data), batch=4, imgsz=S, project=str(tmp_path / "v"), int8=True,
              half=True)
    y.val(**kw)
    qs = y.model.quant
    assert qs is not None and len(qs.wq) == 87
    ref = DetectionModel("yolo11n.yaml", nc=3, device="cpu")
    ref.load_state_dict(y.model.state_dict())
    img = torch.from_numpy(y.validator._loader.first_batch()["img"])
    assert PQ.calibrate(ref, [img.permute(0, 3, 1, 2).float().div(255)]) == qs.act_scales
    y.val(**kw)
    assert y.model.quant is qs


def test_frozen_weights_still_quantize_and_an_empty_state_raises():
    """The int8 convs are chosen by module, not by requires_grad: a model
    frozen for inference quantizes JAX's 87 convs of yolo11n. A state that
    quantizes no conv raises rather than serving full precision."""
    m = DetectionModel("yolo11n", nc=3, device="cpu").requires_grad_(False)
    x = torch.rand(1, 3, S, S)
    PQ.set_int8(m, True, lambda: x)
    assert len(m.quant.wq) == 87
    m.quantize(x, skip=("model.",))
    assert not m.quant.wq
    with pytest.raises(ValueError, match="no conv"):
        PQ.set_int8(m, True, None)

