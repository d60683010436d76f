"""SAM2's model graph in the PyTorch port (edgeyolo_tpu_torch/nn/sam2.py)
against the JAX package (edgeyolo_tpu/nn/sam2.py) and the reference's own
dump, on the CPU in f32.

- Positions: the 2-D sine table equal to JAX's, the 1-D sine and the RoPE
  rotation within 1e-6, jax.image.resize's cubic rule (up and down, one
  axis kept) within 1e-6 of its scale.
- Modules on the small model of tests/torch_sam2_common.py (q-pooling, a
  global block, padded windows; every variable away from its init): the
  Hiera stages, the neck, encode_image, sam_heads (multimask and the
  dynamic choice, stable and not; the object gate open and shut; a mask
  prompt), encode_memory, condition_features over two memory
  frames and three object pointers (the RoPE table tiled, the pointer tokens
  unrotated), tpos_ptr, downsample_mask and the forward, each within 1e-5
  of its output's largest magnitude.
- The full sam2_t at 128 px on the reference's random-init state_dict
  (tests/.cache/ref_sam2.npz, tools/dump_reference_sam2.py): it loads
  strictly and meets each staged output at tests/test_sam2.py's tolerances;
  the same weights through JAX's `convert_sam2_state_dict` give JAX's
  outputs within 1e-5 of their scale.
- At full width, the port on the meta device: sam2_t, _s, _b and _l map
  every JAX variable onto the port's names and exact shapes, nothing left
  over on either side.
"""

import copy
import functools
import math
from pathlib import Path

import jax
import jax.image as jimg
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_sam2_common import IMG, assert_close, jax_template, nhwc, small_pair
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.nn import sam2 as jsam2
from edgeyolo_tpu.utils.torch_convert import convert_sam2_state_dict
from edgeyolo_tpu_torch.nn import sam2 as nsam2
from edgeyolo_tpu_torch.ops.resize import resize_bilinear, resize_cubic
from edgeyolo_tpu_torch.utils import convert

REF = Path(__file__).parent / ".cache" / "ref_sam2.npz"
G = IMG // 16


def _apply(jm, method):
    return jax.jit(lambda v, *a: jm.apply(v, *a, method=method))


@functools.cache
def _jax_heads(jm, multimask: bool):
    """JAX's sam_heads, compiled once per model and output mode."""
    return jax.jit(lambda v, *a: jm.apply(v, *a, multimask_output=multimask, method="sam_heads"))


@pytest.fixture(scope="module")
def small():
    return small_pair()


def _image(seed=1, b=2):
    return np.random.RandomState(seed).randn(b, IMG, IMG, 3).astype(np.float32)


@pytest.fixture(scope="module")
def encoded(small):
    """encode_image of two images on both sides: (JAX's dict, the port's)."""
    jm, v, pm = small
    x = _image()
    want = _apply(jm, "encode_image")(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm.encode_image(torch.from_numpy(x).permute(0, 3, 1, 2))
    return {k: np.asarray(a) for k, a in want.items()}, got


def test_positions_match_jax():
    assert np.array_equal(nsam2.sine_pos_embed_2d(5, 7, 32), jsam2.sine_pos_embed_2d(5, 7, 32))
    pos = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    assert_close(nsam2.get_1d_sine_pe(torch.from_numpy(pos), 64).numpy(),
                 jsam2.get_1d_sine_pe(jnp.asarray(pos), 64), 1e-6)
    cos, sin = nsam2.axial_rope_table(32, 6, 6, torch.device("cpu"))
    jcos, jsin = jsam2._axial_rope_table(32, 6, 6)
    assert np.array_equal(cos.numpy(), jcos) and np.array_equal(sin.numpy(), jsin)
    x = np.random.RandomState(2).randn(2, 3, 36, 32).astype(np.float32)
    assert_close(nsam2.apply_rope(torch.from_numpy(x), cos, sin).numpy(),
                 jsam2._apply_rope(jnp.asarray(x), jnp.asarray(jcos), jnp.asarray(jsin)), 1e-6)
    for hw_in, hw_out in (((7, 7), (32, 32)), ((14, 14), (8, 8)), ((7, 7), (7, 16))):
        a = np.random.RandomState(3).randn(1, 4, *hw_in).astype(np.float32)
        want = jimg.resize(jnp.asarray(a), (1, 4, *hw_out), method="cubic")
        assert_close(resize_cubic(torch.from_numpy(a), hw_out).numpy(), want, 1e-6)


def test_hiera_and_neck_match_jax(small):
    jm, v, pm = small
    x = _image()
    trunk = _apply(jm, lambda m, a: m.image_encoder.trunk(a))(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm.image_encoder.trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(t.shape[2:]) for t in got] == [(32, 32), (16, 16), (8, 8), (4, 4)]
    for g, w in zip(got, trunk):
        assert_close(nhwc(g), w)
    feats, pos = _apply(jm, lambda m, xs: m.image_encoder.neck(xs))(v, trunk)
    with torch.no_grad():
        gf, gp = pm.image_encoder.neck(got)
    for g, w in zip(gf + gp, list(feats) + list(pos)):
        assert_close(nhwc(g), w)


def test_encode_image_matches_jax(encoded):
    want, got = encoded
    for k in ("feat_s0", "feat_s1", "feat", "pos"):
        assert_close(nhwc(got[k]), want[k])
    assert got["feat"].shape == (2, 256, G, G) and got["feat_s0"].shape == (2, 32, 4 * G, 4 * G)


def _prompts():
    rs = np.random.RandomState(4)
    pts = rs.rand(2, 4, 2).astype(np.float32)
    labels = np.array([[1, 0, 2, 3], [1, 1, 0, -1]], np.int32)
    return pts, labels


def _tuned(small, hyper0: float, obj_shift: float):
    """The small pair with mask 0's hypernetwork output scaled by `hyper0`
    (drawn, its stability is 0.96-0.97: x 30 makes it stable, x 1e-3
    unstable) and `obj_shift` added to the object head's bias (drawn, both
    prompts' object logits are about 0.38: -1 shuts the gate), in both
    packages."""
    jm, v, pm = small
    v = jax.tree.map(np.array, v)
    pm = copy.deepcopy(pm)
    dec, jdec = pm.sam_mask_decoder, v["params"]["mask_decoder"]
    with torch.no_grad():
        last = dec.output_hypernetworks_mlps[0].layers[2]
        last.weight.mul_(hyper0)
        last.bias.mul_(hyper0)
        dec.pred_obj_score_head.layers[2].bias.add_(obj_shift)
    jdec["hyper_0"]["l2"]["kernel"] *= hyper0
    jdec["hyper_0"]["l2"]["bias"] *= hyper0
    jdec["obj_score_head"]["l2"]["bias"] += obj_shift
    return jm, jax.tree.map(jnp.asarray, v), pm


CASES = {"stable mask 0": (30.0, 0.0), "unstable mask 0": (1e-3, 0.0),
         "gate shut": (1.0, -1.0)}


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_sam_heads_match_jax(small, encoded, multimask, case):
    """Each branch: multimask by IoU, the dynamic choice keeping a stable
    mask 0 or taking the best other mask, and the object gate shut (every
    mask at -1024, the no-object pointer)."""
    want_enc, got_enc = encoded
    feat = {k: got_enc[k] for k in ("feat", "feat_s0", "feat_s1")}
    jm, v, pm = _tuned(small, *CASES[case])
    pts, labels = _prompts()
    with torch.no_grad():
        feat["feat"] = pm.no_memory_features(feat["feat"])
        got = pm.sam_heads(feat["feat"], torch.from_numpy(pts), torch.from_numpy(labels),
                           feat["feat_s0"], feat["feat_s1"], multimask_output=multimask)
        s0 = pm.sam_mask_decoder(feat["feat"], *_dec_inputs(pm, pts, labels, feat))[0][:, 0]
    jfeat = np.asarray(want_enc["feat"]) + np.asarray(v["params"]["no_mem_embed"][0, 0])
    want = _jax_heads(jm, multimask)(
        v, jnp.asarray(jfeat), jnp.asarray(pts), jnp.asarray(labels),
        want_enc["feat_s0"], want_enc["feat_s1"])
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)
    obj = got[5].numpy()
    shut = case == "gate shut"
    assert ((obj < -0.1) if shut else (obj > 0.1)).all()
    assert (got[2].numpy() == -1024.0).all() == shut
    stab = ((s0 > 0.05).sum((1, 2)) / (s0 > -0.05).sum((1, 2)).clamp_min(1)).numpy()
    assert (stab >= 0.99).all() if case == "stable mask 0" else (stab < 0.98).all()


def test_sam_heads_with_a_mask_prompt_match_jax(small, encoded):
    """A low-resolution mask logit map as a prompt (the prompt encoder's mask
    stem in place of the no-mask embedding)."""
    jm, v, pm = small
    want_enc, got_enc = encoded
    pts, labels = _prompts()
    masks = np.random.RandomState(11).randn(2, 1, 4 * G, 4 * G).astype(np.float32) * 3
    with torch.no_grad():
        got = pm.sam_heads(pm.no_memory_features(got_enc["feat"]), torch.from_numpy(pts),
                           torch.from_numpy(labels), got_enc["feat_s0"], got_enc["feat_s1"],
                           mask_inputs=torch.from_numpy(masks), multimask_output=True)
    jfeat = want_enc["feat"] + np.asarray(v["params"]["no_mem_embed"][0, 0])
    want = _apply(jm, lambda m, *a: m.sam_heads(*a, multimask_output=True))(
        v, jnp.asarray(jfeat), jnp.asarray(pts), jnp.asarray(labels), want_enc["feat_s0"],
        want_enc["feat_s1"], jnp.asarray(masks.transpose(0, 2, 3, 1)))
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)


def _dec_inputs(pm, pts, labels, feat):
    sparse, dense, dense_pe = pm.sam_prompt_encoder(torch.from_numpy(pts),
                                                    torch.from_numpy(labels))
    return dense_pe, sparse, dense, feat["feat_s0"], feat["feat_s1"]


def test_mask_decoder_matches_jax(small, encoded):
    jm, v, pm = small
    want_enc, got_enc = encoded
    pts, labels = _prompts()
    feat = {k: got_enc[k] for k in ("feat", "feat_s0", "feat_s1")}
    with torch.no_grad():
        got = pm.sam_mask_decoder(feat["feat"], *_dec_inputs(pm, pts, labels, feat))

    def dec(m, f, p, lab, s0, s1):
        sparse, dense, dense_pe = m.prompt_encoder(p, lab)
        return m.mask_decoder(f, dense_pe, sparse, dense, s0, s1)

    want = _apply(jm, dec)(v, want_enc["feat"], jnp.asarray(pts), jnp.asarray(labels),
                           want_enc["feat_s0"], want_enc["feat_s1"])
    assert got[0].shape == (2, 4, 4 * G, 4 * G) and got[2].shape == (2, 4, 256)
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)


def _hires(seed=5):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:IMG, :IMG] / IMG
    disc = 8.0 * (0.08 - (yy - 0.4) ** 2 - (xx - 0.6) ** 2)
    return (disc[None, None] + rs.randn(2, 1, IMG, IMG)).astype(np.float32)


def test_encode_memory_matches_jax(small, encoded):
    jm, v, pm = small
    want_enc, got_enc = encoded
    hi = _hires()
    obj = np.array([0.3, -0.2], np.float32)
    want = _apply(jm, "encode_memory")(v, want_enc["feat"], jnp.asarray(hi.transpose(0, 2, 3, 1)),
                                       jnp.asarray(obj))
    with torch.no_grad():
        mem, pos = pm.encode_memory(got_enc["feat"], torch.from_numpy(hi), torch.from_numpy(obj))
    assert mem.shape == (2, 64, G, G) and pos.shape == (1, 64, G, G)
    assert_close(nhwc(mem), want[0])
    assert_close(nhwc(pos)[0], want[1])


def test_condition_features_match_jax(small, encoded):
    """Two memory frames (their temporal encodings on the positions) and
    three object pointers as twelve 64-channel tokens: the RoPE table tiled
    over the 2 x 64 spatial keys, the last 12 keys not rotated."""
    jm, v, pm = small
    want_enc, got_enc = encoded
    rs = np.random.RandomState(6)
    n_mem = 2 * G * G
    tpos = np.asarray(v["params"]["maskmem_tpos_enc"])
    memory = rs.randn(2, n_mem + 12, 64).astype(np.float32)
    mpos = rs.randn(2, n_mem + 12, 64).astype(np.float32)
    mpos[:, :G * G] += tpos[0, 0]
    mpos[:, G * G:n_mem] += tpos[5, 0]
    want = _apply(jm, lambda m, *a: m.condition_features(*a, num_obj_ptr_tokens=12))(
        v, want_enc["feat"], want_enc["pos"], jnp.asarray(memory), jnp.asarray(mpos))
    with torch.no_grad():
        got = pm.condition_features(got_enc["feat"], got_enc["pos"], torch.from_numpy(memory),
                                    torch.from_numpy(mpos), 12)
    assert_close(nhwc(got), want)


def test_small_methods_and_forward_match_jax(small):
    jm, v, pm = small
    pos = np.array([0.0, 3 / 15, 1.0], np.float32)
    with torch.no_grad():
        assert_close(pm.tpos_ptr(torch.from_numpy(pos)).numpy(),
                     _apply(jm, "tpos_ptr")(v, jnp.asarray(pos)), 1e-6)
        hi = _hires(7)
        assert_close(nhwc(pm.downsample_mask(torch.from_numpy(hi))),
                     _apply(jm, "downsample_mask")(v, jnp.asarray(hi.transpose(0, 2, 3, 1))))
        feat = np.random.RandomState(8).randn(2, G, G, 256).astype(np.float32)
        assert_close(nhwc(pm.no_memory_features(torch.from_numpy(feat).permute(0, 3, 1, 2))),
                     _apply(jm, "no_memory_features")(v, jnp.asarray(feat)))
        x = _image(9, 1)
        pts, labels = np.array([[[0.3, 0.6]]], np.float32), np.array([[1]], np.int32)
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(pts),
                 torch.from_numpy(labels))
    want = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(pts), jnp.asarray(labels))
    assert_close(got[0].numpy(), want[0])
    assert_close(got[1].numpy(), want[1])
    assert_close(nhwc(got[2]), want[2])


# -- the full sam2_t on the reference's own state_dict -----------------------------------
@pytest.fixture(scope="module")
def reference():
    z = np.load(REF)
    pm = nsam2.build_sam2("sam2_t", img_size=128)
    pm.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files if not k.startswith("__")},
                       strict=True)
    x = torch.from_numpy(z["__input__"])
    with torch.no_grad():
        enc = pm.encode_image(x)
    return z, pm, enc


def _ref_prompt(z):
    """tests/test_sam2.py's tokens: +0.5 pixel centre, / 128, one pad slot."""
    pts = np.concatenate([z["__pts__"] + 0.5, np.zeros((1, 1, 2), np.float32)], 1) / 128.0
    labs = np.concatenate([z["__labs__"], -np.ones((1, 1), np.int32)], 1).astype(np.int32)
    return pts.astype(np.float32), labs


def _ref_memory(z, pm):
    """The next frame's memory: the reference's memory slot with its
    temporal encoding and its object pointer as four tokens (test_sam2.py's)."""
    memory = torch.from_numpy(z["__maskmem__"]).flatten(2).transpose(1, 2)
    mpos = torch.from_numpy(z["__maskmem_pos__"]).flatten(2).transpose(1, 2)
    mpos = mpos + pm.maskmem_tpos_enc[6, 0].detach()
    tpos = pm.tpos_ptr(torch.tensor([0.0]) / 15.0)
    memory = torch.cat([memory, torch.from_numpy(z["__obj_ptr__"]).reshape(1, 4, 64)], 1)
    return memory, torch.cat([mpos, tpos[None].expand(1, 4, 64)], 1)


def test_reference_state_dict_meets_staged_outputs(reference):
    z, pm, enc = reference
    assert sum(p.numel() for p in pm.parameters()) == sum(
        z[k].size for k in z.files if not k.startswith("__")) - 2 * 128
    np.testing.assert_allclose(enc["feat"].numpy(), z["__fpn2__"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(enc["pos"].numpy(), z["__pos2__"], atol=2e-4, rtol=1e-3)
    pts, labs = _ref_prompt(z)
    with torch.no_grad():
        out = pm.sam_heads(pm.no_memory_features(enc["feat"]), torch.from_numpy(pts),
                           torch.from_numpy(labs), enc["feat_s0"], enc["feat_s1"],
                           multimask_output=True)
        low_multi, ious, low_res, _, obj_ptr, obj_logits = (t.numpy() for t in out)
        np.testing.assert_allclose(low_multi, z["__low_multi__"], atol=5e-3, rtol=1e-3)
        np.testing.assert_allclose(ious, z["__ious__"], atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(low_res, z["__low_res__"], atol=5e-3, rtol=1e-3)
        np.testing.assert_allclose(obj_ptr, z["__obj_ptr__"], atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(obj_logits[:, None], z["__obj_logits__"], atol=1e-4, rtol=1e-3)
        hi = resize_bilinear(torch.from_numpy(z["__low_res__"]), (128, 128))
        mem, mem_pos = pm.encode_memory(enc["feat"], hi, torch.from_numpy(z["__obj_logits__"]))
        np.testing.assert_allclose(mem.numpy(), z["__maskmem__"], atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(mem_pos.numpy(), z["__maskmem_pos__"], atol=1e-5, rtol=1e-5)
        cond = pm.condition_features(enc["feat"], enc["pos"], *_ref_memory(z, pm), 4)
    want = z["__cond__"].transpose(1, 2, 0).reshape(1, 256, G, G)
    np.testing.assert_allclose(cond.numpy(), want, atol=2e-3, rtol=1e-3)


def test_reference_weights_give_jax_outputs(reference):
    """The port's state_dict through JAX's own converter (strict): every
    SAM2 method of the two packages within 1e-5 of its output's scale."""
    z, pm, enc = reference
    jm = jsam2.build_sam2("sam2_t", img_size=128)
    shapes = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 1, 2)),
                        jnp.zeros((1, 1), jnp.int32))))
    v, rep = convert_sam2_state_dict({k: t.numpy() for k, t in pm.state_dict().items()}, shapes)
    assert rep["matched"] == 465 and not rep["unused"]
    pts, labs = _ref_prompt(z)
    memory, mpos = _ref_memory(z, pm)
    hi = _hires(10)[:1]

    def run(m, x, p, lab, hi_nhwc, mem, mp):
        e = m.encode_image(x)
        heads = [m.sam_heads(e["feat"] + m.no_mem_embed[0, 0], p, lab, e["feat_s0"],
                             e["feat_s1"], multimask_output=mm) for mm in (True, False)]
        return (e, heads, m.encode_memory(e["feat"], hi_nhwc, heads[0][5]),
                m.condition_features(e["feat"], e["pos"], mem, mp, num_obj_ptr_tokens=4))

    je, jheads, jmem, jcond = _apply(jm, run)(
        v, jnp.asarray(z["__input__"].transpose(0, 2, 3, 1)), jnp.asarray(pts), jnp.asarray(labs),
        jnp.asarray(hi.transpose(0, 2, 3, 1)), jnp.asarray(memory.numpy()),
        jnp.asarray(mpos.numpy()))
    for k in ("feat_s0", "feat_s1", "feat", "pos"):
        assert_close(nhwc(enc[k]), je[k])
    with torch.no_grad():
        feat = pm.no_memory_features(enc["feat"])
        for mm, want in zip((True, False), jheads):
            got = pm.sam_heads(feat, torch.from_numpy(pts), torch.from_numpy(labs),
                               enc["feat_s0"], enc["feat_s1"], multimask_output=mm)
            for g, w in zip(got, want):
                assert_close(g.numpy(), w)
        mem, mem_pos = pm.encode_memory(enc["feat"], torch.from_numpy(hi), None)
        cond = pm.condition_features(enc["feat"], enc["pos"], memory, mpos, 4)
    assert_close(nhwc(mem), jmem[0])
    assert_close(nhwc(mem_pos)[0], jmem[1])
    assert_close(nhwc(cond), jcond)


# -- full width --------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["sam2_t", "sam2_s", "sam2_b", "sam2_l"])
def test_variant_maps_every_jax_variable(variant):
    """JAX's variables at full width (shapes from jax.eval_shape) land on
    the port's names with the port's exact shapes, one variable at a time
    (sam2_l's values would take gigabytes): nothing missing, nothing left over."""
    flat = jax_template(jsam2.build_sam2(variant, img_size=64), 64)
    with torch.device("meta"):
        pm = nsam2.SAM2Model(image_size=1024, **nsam2.sam2_config(variant))
    own = {k: tuple(t.shape) for k, t in pm.state_dict().items()}
    seen = {}
    for k, s in flat.items():
        one = {k: np.zeros(s.shape, np.float32)}
        for key, t in convert._sam_from_jax(one, convert.SAM2_REWRITE_RULES).items():
            seen[key] = tuple(t.shape)
    assert seen == own
    assert sum(math.prod(s) for s in own.values()) == sum(
        math.prod(s.shape) for s in flat.values())
    assert len(pm.image_encoder.trunk.blocks) == sum(nsam2.SAM2_CONFIGS[variant][1])
    with pytest.raises(ValueError, match="unknown SAM2 variant"):
        nsam2.sam2_config("sam2_x")
