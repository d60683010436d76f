"""The RT-DETR family in the PyTorch port against the JAX package, on the CPU
in f32.

- The five YAMLs are byte-identical copies of JAX's, parse as JAX's (specs,
  save list, strides) and build with JAX's parameter counts (rtdetr-l's is
  the reference's 32,970,476).
- Each module alone (JAX's under `bn_config()`, the detection models'
  BatchNorm eps), its weights carried onto JAX's tree through JAX's
  `convert_rtdetr_state_dict` (the port names its parameters with the
  reference's torch keys), at 1e-5: LightConv, HGStem, HGBlock with and
  without `lightconv` and `shortcut`, RepC3, AIFI, TransformerEncoderLayer
  with and without positions, the attention with and without a mask,
  `ms_deform_sample` with taps outside the map, MSDeformAttn with 2-D points
  and 4-D boxes, the decoder layer, and RTDETRDecoder in eval and in
  training with a denoising group (its CDN mask, dn outputs apart).
- rtdetr-l, rtdetr-resnet50 and yolov8-rtdetr-n at 64 px from perturbed
  weights (`rt_perturbed`: BatchNorm statistics and norms moved, weights
  scaled, offsets and attention weights off zero, score biases spread
  around 0): boxes 5e-3 px, scores 1e-4, rows equal in order but where two
  queries' selection scores lie within 1e-5 (f32 rounding orders such
  near-ties either way: `assert_queries_close`, the rule of
  tests/test_torch_e2e.py's `assert_e2e_close`); the state_dict back from
  JAX's tree with `from_jax_variables` equal tensor for tensor.
- `topk_stable` on tied scores: jax.lax.top_k's order.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util
from test_parse_and_parity import PARITY
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import extra as jextra
from edgeyolo_tpu.nn.modules import head as jhead
from edgeyolo_tpu.nn.modules import transformer as jtr
from edgeyolo_tpu.train.detr_loss import make_cdn_group as jmake_cdn_group
from edgeyolo_tpu.utils.torch_convert import convert_rtdetr_state_dict
from edgeyolo_tpu_torch.cfg.models import MODELS_DIR, model_cfg
from edgeyolo_tpu_torch.engine.model import RTDETR
from edgeyolo_tpu_torch.nn import tasks
from edgeyolo_tpu_torch.nn.modules import conv, extra, head, transformer
from edgeyolo_tpu_torch.nn.tasks import DetectionModel, num_params
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

REPO = Path(__file__).resolve().parents[1]
S = 64
YAMLS = ("rtdetr-l.yaml", "rtdetr-x.yaml", "rtdetr-resnet50.yaml", "rtdetr-resnet101.yaml",
         "yolov8-rtdetr.yaml")
TOL = 1e-5


def rt_perturbed(sd: dict, scale: float = 1.0, seed: int = 0) -> dict:
    """Seeded weights moved so the output depends on the image: BatchNorm
    statistics, norm scales and shifts and biases moved, conv, linear and
    packed attention kernels times `scale`, the sampling-offset and
    attention-weight kernels (0 at init) drawn at 0.02, and every score
    head's bias spread around 0, so scores straddle 0.25."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in sd.items():
        a, leaf = v.numpy().copy(), k.rsplit(".", 1)[-1]
        if k.endswith("num_batches_tracked") or "denoising_class_embed" in k:
            pass
        elif re.search(r"(sampling_offsets|attention_weights)\.weight$", k):
            a = rs.randn(*a.shape) * 0.02
        elif re.search(r"score_head(\.\d+)?\.bias$", k):
            a = rs.randn(*a.shape) * 0.5
        elif leaf == "running_mean":
            a = rs.randn(*a.shape) * 0.1
        elif leaf == "running_var":
            a = rs.uniform(0.5, 1.5, a.shape)
        elif leaf in ("bias", "in_proj_bias") or (leaf == "weight" and a.ndim == 1):
            a = a + rs.randn(*a.shape) * 0.1
        elif leaf in ("weight", "in_proj_weight"):
            a = a * scale
        out[k] = torch.from_numpy(np.asarray(a, v.numpy().dtype))
    return out


def jax_template(init):
    shapes = jax.eval_shape(init)
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def to_jax(sd: dict, template: dict, prefix: str = "m") -> dict:
    """The port's state_dict onto a JAX tree through convert_rtdetr_state_dict
    (strict), under a `prefix` scope on both sides (the rewrite rules expect
    a parent key, as `model.{i}` is in a model)."""
    nested = {c: {prefix: t} for c, t in template.items()}
    arrays = {f"{prefix}.{k}": v.numpy() for k, v in sd.items()}
    variables, rep = convert_rtdetr_state_dict(arrays, nested, strict=True)
    assert not rep["missing"] and not rep["unused"], rep
    return jax.tree.map(jnp.asarray, {c: t[prefix] for c, t in variables.items()})


def _japply(jmod, variables, *args, **kwargs):
    """A JAX module applied under the detection models' BatchNorm convention,
    compiled (one XLA program, not one per eager op): the variables traced,
    the inputs, shapes and flags closed over."""
    with jconv.bn_config():
        return jax.jit(lambda v: jmod.apply(v, *args, **kwargs))(variables)


def _moved(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """A module's seeded weights (the models' `init_weights`), perturbed."""
    tasks.init_weights(module, torch.Generator().manual_seed(seed))
    module.load_state_dict(rt_perturbed(module.state_dict(), seed=seed))
    return module.eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _conv_case(pmod, jmod, c1: int, hw: int = 12, seed: int = 0):
    x = np.random.RandomState(seed).randn(2, hw, hw, c1).astype(np.float32)
    pmod = _moved(pmod, seed)
    v = to_jax(pmod.state_dict(), jax_template(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, c1)))))
    want = _japply(jmod, v, jnp.asarray(x))
    with torch.no_grad():
        got = pmod(_nchw(x))
    _close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("yaml", YAMLS)
def test_yaml_copy_is_byte_identical_to_jax(yaml):
    assert (MODELS_DIR / yaml).read_bytes() == (
        REPO / "edgeyolo_tpu" / "cfg" / "models" / yaml).read_bytes()


@pytest.mark.parametrize("yaml", YAMLS)
def test_yaml_parses_builds_and_counts_as_jax(yaml):
    d = model_cfg(yaml)
    jd = jtasks.yaml_model_load(yaml)
    jd["scale"] = d["scale"]
    jlayers, jsave, jinfo = jtasks.parse_spec(jd)
    layers, save, info = tasks.parse_spec(d)
    assert info["scale"] == jinfo["scale"] and save == jsave
    assert [(s.i, s.f, s.n, s.name, s.args, s.kwargs, s.c2) for s in layers] == \
        [(s.i, s.f, s.n, s.name, s.args, s.kwargs, s.c2) for s in jlayers]
    assert tasks.derive_strides(layers) == jtasks.derive_strides(jlayers)
    jm = jtasks.DetectionModel(jd)
    params = jax.eval_shape(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))["params"]
    pm = DetectionModel(yaml, device="cpu")
    assert tasks.is_rtdetr(pm) and not pm.end2end and pm.task == "detect"
    assert num_params(pm) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    listed = PARITY.get((yaml.removesuffix(".yaml"), d["scale"]))
    assert listed is None or num_params(pm) == listed
    if yaml == "rtdetr-l.yaml":
        assert num_params(pm) == 32_970_476


def test_model_names_resolve_and_the_facade_name():
    assert model_cfg("rtdetr-l")["scale"] == "l" and model_cfg("rtdetr-x")["scale"] == "x"
    assert model_cfg("yolov8-rtdetr-s")["scale"] == "s"
    m = RTDETR("yolov8-rtdetr-n", device="cpu")
    assert m.task == "detect" and m.model.scale == "n" and tasks.is_rtdetr(m.model)
    with pytest.raises(ValueError):
        tasks.RTDETRDetectionModel("yolov8n.yaml", device="cpu")


def test_light_conv_matches_jax():
    _conv_case(conv.LightConv(8, 16, 5), jconv.LightConv(16, 5), 8)


def test_hgstem_matches_jax():
    _conv_case(extra.HGStem(3, 16, 24), jextra.HGStem(16, 24), 3, hw=16)


@pytest.mark.parametrize("lightconv,shortcut,c1", [(False, False, 8), (True, False, 8),
                                                   (True, True, 32), (False, True, 32)])
def test_hgblock_matches_jax(lightconv, shortcut, c1):
    _conv_case(extra.HGBlock(c1, 8, 32, 3, 3, lightconv, shortcut),
               jextra.HGBlock(8, 32, 3, 3, lightconv, shortcut), c1)


def test_repc3_matches_jax():
    _conv_case(transformer.RepC3(16, 24, 2), jtr.RepC3(24, 2), 16)


def test_aifi_matches_jax_with_its_transposed_positions():
    # 3 x 5: the w-major grid against H-major tokens differs from the square case
    x = np.random.RandomState(0).randn(2, 3, 5, 32).astype(np.float32)
    pmod = _moved(transformer.AIFI(32, 64, 4))
    jmod = jtr.AIFI(32, 64, 4)
    v = to_jax(pmod.state_dict(), jax_template(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 5, 32)))))
    with torch.no_grad():
        got = pmod(_nchw(x))
    _close(got.permute(0, 2, 3, 1), _japply(jmod, v, jnp.asarray(x)))


@pytest.mark.parametrize("with_pos", [False, True])
def test_encoder_layer_matches_jax(with_pos):
    rs = np.random.RandomState(1)
    src = rs.randn(2, 10, 32).astype(np.float32)
    pos = rs.randn(1, 10, 32).astype(np.float32) if with_pos else None
    pmod = _moved(transformer.TransformerEncoderLayer(32, 64, 4))
    jmod = jtr.TransformerEncoderLayer(32, 64, 4)
    v = to_jax(pmod.state_dict(), jax_template(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 32)))))
    want = _japply(jmod, v, jnp.asarray(src), None if pos is None else jnp.asarray(pos))
    with torch.no_grad():
        got = pmod(torch.from_numpy(src), None if pos is None else torch.from_numpy(pos))
    _close(got, want)


class _JaxAttention(fnn.Module):
    """JAX's `_mha` under a scope named `attn`, as its layers call it."""

    @fnn.compact
    def __call__(self, q, k, v, mask=None):
        dense = lambda f, nm: fnn.Dense(f, name=nm)  # noqa: E731
        return jtr._mha(q, k, v, 4, dense, "attn", mask=mask)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_with_and_without_a_mask_matches_jax(masked):
    rs = np.random.RandomState(2)
    q, k = rs.randn(2, 9, 32).astype(np.float32), rs.randn(2, 9, 32).astype(np.float32)
    mask = head.cdn_attention_mask(4, 5, 2) if masked else None
    pmod = torch.nn.Module()
    pmod.attn = _moved(transformer.MultiheadAttention(32, 4))
    jmod = _JaxAttention()
    v = to_jax(pmod.state_dict(), jax_template(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 9, 32)), jnp.zeros((1, 9, 32)),
                          jnp.zeros((1, 9, 32)))))
    want = _japply(jmod, v, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                      None if mask is None else jnp.asarray(mask.numpy()))
    with torch.no_grad():
        got = pmod.attn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k), mask)
    _close(got, want)


SHAPES = ((6, 7), (3, 4), (2, 2))


def _sample_inputs(seed: int = 3, lq: int = 11, nh: int = 2, d: int = 4, npts: int = 3):
    rs = np.random.RandomState(seed)
    lv = sum(h * w for h, w in SHAPES)
    value = rs.randn(2, lv, nh, d).astype(np.float32)
    # locations from -0.2 to 1.2: taps outside the map on every side, and at its border
    loc = rs.uniform(-0.2, 1.2, (2, lq, nh, len(SHAPES), npts, 2)).astype(np.float32)
    loc[0, 0, 0, :, 0] = 0.0
    loc[0, 0, 0, :, 1] = 1.0
    aw = rs.uniform(0, 1, (2, lq, nh, len(SHAPES), npts)).astype(np.float32)
    return value, loc, aw


def test_ms_deform_sample_matches_jax_with_taps_outside_the_map():
    value, loc, aw = _sample_inputs()
    want = jtr.ms_deform_sample(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(aw))
    got = transformer.ms_deform_sample(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                                       torch.from_numpy(aw))
    _close(got, want)
    outside = (loc < -0.5 / 7) | (loc > 1 + 0.5 / 7)
    assert outside.any()


def test_ms_deform_sample_gradients_match_jax():
    value, loc, aw = _sample_inputs(seed=4)
    g = jax.grad(lambda v, lc, a: jnp.sum(jtr.ms_deform_sample(v, SHAPES, lc, a) ** 2),
                 argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(loc), jnp.asarray(aw))
    t = [torch.tensor(a, requires_grad=True) for a in (value, loc, aw)]
    (transformer.ms_deform_sample(t[0], SHAPES, t[1], t[2]) ** 2).sum().backward()
    for gj, tt in zip(g, t):
        _close(tt.grad, gj, 1e-5)


@pytest.mark.parametrize("points", [2, 4])
def test_msdeformattn_matches_jax(points):
    rs = np.random.RandomState(5)
    lv = sum(h * w for h, w in SHAPES)
    query = rs.randn(2, 7, 32).astype(np.float32)
    value = rs.randn(2, lv, 32).astype(np.float32)
    if points == 2:
        refer = rs.uniform(0.05, 0.95, (2, 7, len(SHAPES), 2)).astype(np.float32)
    else:
        refer = np.concatenate([rs.uniform(0.2, 0.8, (2, 7, 2)), rs.uniform(0.1, 0.6, (2, 7, 2))],
                               -1).astype(np.float32)
    pmod = _moved(transformer.MSDeformAttn(32, len(SHAPES), 4, 3))
    jmod = jtr.MSDeformAttn(32, len(SHAPES), 4, 3)
    v = to_jax(pmod.state_dict(), jax_template(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 7, 32)), jnp.zeros((1, 7) + refer.shape[2:]),
        jnp.zeros((1, lv, 32)), SHAPES)))
    want = _japply(jmod, v, jnp.asarray(query), jnp.asarray(refer), jnp.asarray(value), SHAPES)
    with torch.no_grad():
        got = pmod(torch.from_numpy(query), torch.from_numpy(refer), torch.from_numpy(value),
                   SHAPES)
    _close(got, want)


def test_msdeformattn_seeded_init_is_jax_init():
    """The offsets' bias rays and the zero kernels, as JAX initialises them."""
    pmod = transformer.MSDeformAttn(32, 3, 4, 3)
    pmod.seeded_init(torch.Generator().manual_seed(0))
    jmod = jtr.MSDeformAttn(32, 3, 4, 3)
    v = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 32)), jnp.zeros((1, 2, 4)),
                  jnp.zeros((1, 58, 32)), SHAPES)["params"]
    _close(pmod.sampling_offsets.bias, v["sampling_offsets"]["bias"], 1e-6)
    assert not pmod.sampling_offsets.weight.any() and not pmod.attention_weights.weight.any()
    bound = (6.0 / 64) ** 0.5
    assert 0.9 * bound < pmod.value_proj.weight.abs().max() <= bound


def test_decoder_layer_matches_jax_with_a_mask():
    rs = np.random.RandomState(6)
    lv = sum(h * w for h, w in SHAPES)
    embed = rs.randn(2, 9, 32).astype(np.float32)
    pos = rs.randn(2, 9, 32).astype(np.float32)
    refer = np.concatenate([rs.uniform(0.2, 0.8, (2, 9, 2)), rs.uniform(0.1, 0.6, (2, 9, 2))],
                           -1).astype(np.float32)
    feats = rs.randn(2, lv, 32).astype(np.float32)
    mask = head.cdn_attention_mask(4, 5, 2)
    pmod = _moved(transformer.DeformableTransformerDecoderLayer(32, 4, 64, len(SHAPES), 3))
    jmod = jtr.DeformableTransformerDecoderLayer(32, 4, 64, len(SHAPES), 3)
    v = to_jax(pmod.state_dict(), jax_template(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 9, 32)), jnp.zeros((1, 9, 4)),
        jnp.zeros((1, lv, 32)), SHAPES, jnp.zeros((1, 9, 32)))))
    want = _japply(jmod, v, *(jnp.asarray(a) for a in (embed, refer, feats)), SHAPES,
                      jnp.asarray(pos), jnp.asarray(mask.numpy()))
    with torch.no_grad():
        got = pmod(*(torch.from_numpy(a) for a in (embed, refer, feats)), SHAPES,
                   torch.from_numpy(pos), mask)
    _close(got, want)


HEAD = {"nc": 5, "ch": (16, 24, 32), "hd": 32, "nq": 60, "ndp": 3, "nh": 4, "ndl": 3,
        "d_ffn": 64}
HEAD_HW = (8, 4, 2)


@pytest.fixture(scope="module")
def rt_head():
    rs = np.random.RandomState(7)
    xs = [rs.randn(2, hw, hw, c).astype(np.float32) for hw, c in zip(HEAD_HW, HEAD["ch"])]
    pmod = _moved(head.RTDETRDecoder(**HEAD))
    jmod = jhead.RTDETRDecoder(**HEAD)
    zeros = [jnp.zeros((1, hw, hw, c)) for hw, c in zip(HEAD_HW, HEAD["ch"])]
    v = to_jax(pmod.state_dict(), jax_template(lambda: jmod.init(jax.random.PRNGKey(0), zeros)))
    return pmod, jmod, v, xs


def test_rtdetr_decoder_eval_matches_jax(rt_head):
    pmod, jmod, v, xs = rt_head
    want = _japply(jmod, v, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = pmod.eval()([_nchw(x) for x in xs])
    assert got["pred"].shape == (2, 60, 4 + HEAD["nc"])
    _close(got["pred"], want["pred"])
    _close(got["enc_bboxes"], want["enc_bboxes"])
    _close(got["enc_scores"], want["enc_scores"])
    for a, b in zip(got["aux"][1], want["aux"][1]):
        _close(a, b)


def test_rtdetr_decoder_trains_with_a_denoising_group_as_jax(rt_head):
    pmod, jmod, v, xs = rt_head
    rs = np.random.RandomState(8)
    m = 3
    mask = (np.arange(m)[None] < np.array([[2], [3]])).astype(np.float32)
    boxes = np.concatenate([rs.uniform(0.3, 0.7, (2, m, 2)), rs.uniform(0.1, 0.4, (2, m, 2))],
                           -1).astype(np.float32)
    cls = rs.randint(0, HEAD["nc"], (2, m)).astype(np.float32)
    jdn = jmake_cdn_group(jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask), HEAD["nc"],
                          jax.random.PRNGKey(0))
    want, _ = _japply(jmod, v, [jnp.asarray(x) for x in xs], train=True, dn=jdn,
                         mutable=["batch_stats"])
    dn = {"cls": torch.from_numpy(np.asarray(jdn["cls"])).long(),
          "bbox": torch.from_numpy(np.asarray(jdn["bbox"])),
          "group_size": jdn["group_size"], "num_groups": jdn["num_groups"]}
    got = pmod.train()([_nchw(x) for x in xs], dn=dn)
    pmod.eval()
    d = jdn["cls"].shape[1]
    assert got["dn_feats"][0].shape == (2, d, 4) and "pred" not in got
    for key in ("feats", "dn_feats"):
        for a, b in zip(got[key], want[key]):
            _close(a, b)
    for key in ("aux", "dn_aux"):
        for la, lb in zip(got[key], want[key]):
            for a, b in zip(la, lb):
                _close(a, b)
    _close(got["enc_scores"], want["enc_scores"])


def test_cdn_attention_mask_isolates_the_groups():
    m = head.cdn_attention_mask(6, 4, 2).numpy()
    assert m[6:, :6].all() and not m[6:, 6:].any() and not m[:6, 6:].any()
    for g in range(3):
        blk = m[2 * g:2 * g + 2, :6]
        assert not blk[:, 2 * g:2 * g + 2].any() and blk.sum() == 2 * 4


def test_topk_stable_keeps_jax_order_on_ties():
    rs = np.random.RandomState(9)
    x = np.round(rs.rand(3, 400) * 8) / 8  # 9 values: ties everywhere
    jv, ji = jax.lax.top_k(jnp.asarray(x, jnp.float32), 300)
    v, i = head.topk_stable(torch.from_numpy(x).float(), 300)
    assert (i.numpy() == np.asarray(ji)).all() and (v.numpy() == np.asarray(jv)).all()


MODELS = {"rtdetr-l": ("rtdetr-l.yaml", 1.0), "rtdetr-resnet50": ("rtdetr-resnet50.yaml", 1.0),
          "yolov8-rtdetr-n": ("yolov8-rtdetr.yaml", 1.0)}


def model_pair(name: str, yaml: str, scale: float) -> dict:
    """The port model at perturbed weights, the JAX model on the same weights,
    both models' 64 px preds of two images."""
    pm = DetectionModel(name, device="cpu")
    sd = rt_perturbed(pm.state_dict(), scale)
    pm.load_state_dict(sd)
    jd = jtasks.yaml_model_load(yaml)
    jd["scale"] = pm.scale
    jm = jtasks.DetectionModel(jd)
    template = jax_template(lambda: jm.net.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                                train=False))
    variables, rep = convert_rtdetr_state_dict({k: v.numpy() for k, v in sd.items()}, template,
                                               strict=True)
    assert not rep["unused"] and not rep["missing"]
    imgs = np.random.RandomState(1).randint(0, 256, (2, S, S, 3)).astype(np.uint8)
    jpred = np.asarray(jax.jit(lambda v, x: jm.net.apply(v, x, train=False)["pred"])(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(imgs, jnp.float32) / 255.0))
    with torch.no_grad():
        out = pm(_nchw(imgs).float() / 255)
    return {"pm": pm, "sd": sd, "variables": variables, "pred": out["pred"].numpy(),
            "jpred": jpred, "selection": out["enc_scores"].amax(-1).numpy()}


def assert_queries_close(pred, jpred, selection, box_px: float = 5e-3, score: float = 1e-4,
                         tie: float = 1e-5) -> None:
    """(B, nq, 4 + nc) preds of two frameworks row by row, boxes within
    box_px pixels at S and scores within `score`; a row may instead match a
    row of JAX's whose query's selection score (the encoder's best class
    logit, `selection`, in selection order) lies within `tie` of its own: f32
    rounding orders such near-ties either way in jax.lax.top_k and its
    stable counterpart. Returns nothing; at least 90% of the rows must match
    in place."""
    assert pred.shape == jpred.shape
    in_place = 0
    for b in range(pred.shape[0]):
        for i in range(pred.shape[1]):
            group = np.nonzero(np.abs(selection[b] - selection[b, i]) <= tie)[0]
            ok = [j for j in sorted(group, key=lambda j: j != i)
                  if np.abs(pred[b, i, :4] - jpred[b, j, :4]).max() * S < box_px
                  and np.abs(pred[b, i, 4:] - jpred[b, j, 4:]).max() < score]
            assert ok, (b, i, np.abs(pred[b, i] - jpred[b, i]).max())
            in_place += ok[0] == i
    assert in_place >= 0.9 * pred.shape[0] * pred.shape[1], in_place


def check_model_pair(p: dict) -> None:
    pred, jpred = p["pred"], p["jpred"]
    assert pred.shape == jpred.shape == (2, 84, 4 + 80)  # min(300, 64 + 16 + 4) queries
    assert_queries_close(pred, jpred, p["selection"])
    assert (pred[..., 4:] > 0.25).any() and (pred[..., 4:] < 0.25).any()
    assert np.abs(pred[0, :, :4] - pred[1, :, :4]).max() * S > 1.0  # depends on the image
    back = from_jax_variables(traverse_util.flatten_dict(p["variables"]))
    assert set(back) == {k for k in p["sd"] if not k.endswith("num_batches_tracked")}
    assert all(torch.equal(back[k], p["sd"][k]) for k in back)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_pred_matches_jax_at_64px(name):
    check_model_pair(model_pair(name, *MODELS[name]))
