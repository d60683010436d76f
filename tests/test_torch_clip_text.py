"""CLIP's text tower and BPE tokenizer in the PyTorch port against the JAX
package (edgeyolo_tpu/nn/clip_text.py), on the CPU in f32.

No CLIP weights or BPE vocabulary ship with either package, so the tower is
held at full width (512, 12 blocks, 8 heads, 77 tokens, 49,408 ids) on token
ids with seeded weights, and the tokenizer on a synthetic merges file:

- JAX's variables (shapes from `jax.eval_shape`, filled from a seeded
  generator as flax initialises them, biases and LayerNorms moved) carried
  in by `from_jax_variables` (strict),
  and the port's seeded state_dict carried out by JAX's own
  `convert_clip_text_state_dict`: the unit embeddings of token sequences of
  different lengths within 1e-5 of JAX's;
- the causal mask (tokens after the EOT change nothing) and the EOT pooling
  (the first of a row's largest ids);
- tokenizer ids equal to JAX's (which splits with the `regex` module) on
  text with letters, digits, punctuation, contractions, accents and other
  scripts, over merges learned from a small corpus;
- `convert_clip_text_state_dict` of a synthetic dump (a whole CLIP model's
  keys, image tower included, and a text-only dump without `.weight` on the
  embedding) equals JAX's conversion of it;
- `WorldModel.set_classes(strings, clip_npz=, bpe_path=)` gives the bank
  JAX's set_classes computes from the same files (its tokenizer, converter
  and tower; 1e-5) and the strings as names; without the files it raises
  JAX's ValueError; FastSAM's `text_prompt` raises as JAX's does.
"""

import gzip
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.engine import fastsam as jfastsam
from edgeyolo_tpu.nn import clip_text as J
from edgeyolo_tpu.nn import tasks as jtasks
from edgeyolo_tpu_torch.engine import fastsam
from edgeyolo_tpu_torch.nn import clip_text as C
from edgeyolo_tpu_torch.nn.tasks import WorldModel
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

TOL = 1e-5


def _tokens():
    """Four rows: SOT, 1-40 ids, EOT, zeros (one row with junk after its EOT)."""
    rs = np.random.RandomState(0)
    toks = np.zeros((4, C.CONTEXT), np.int32)
    for i, n in enumerate((1, 5, 17, 40)):
        toks[i, 0] = C.VOCAB - 2
        toks[i, 1:1 + n] = rs.randint(1, C.VOCAB - 2, n)
        toks[i, 1 + n] = C.VOCAB - 1
    return toks


def _filled(shapes, seed=0):
    """JAX's variable shapes filled from a seeded generator as flax
    initialises them (embeddings N(0, 0.02) and N(0, 0.01), the projection
    N(0, 512^-0.5), kernels N(0, 1/fan_in)), with the biases N(0, 0.1) and
    the LayerNorm scales 1 + N(0, 0.1) off their init."""
    rs = np.random.RandomState(seed)
    std = {"token_embedding": 0.02, "positional_embedding": 0.01,
           "text_projection": C.WIDTH ** -0.5}
    out = {}
    for k, sh in traverse_util.flatten_dict(shapes).items():
        shape, leaf = tuple(sh.shape), k[-1]
        if leaf in std:
            a = rs.randn(*shape) * std[leaf]
        elif leaf == "kernel":  # fan_in: WIDTH, or 4 x WIDTH for the MLP's projection
            fan_in = 4 * C.WIDTH if shape == (4 * C.WIDTH, C.WIDTH) else C.WIDTH
            a = rs.randn(*shape) * fan_in ** -0.5
        elif leaf == "scale":
            a = 1 + rs.randn(*shape) * 0.1
        else:
            a = rs.randn(*shape) * 0.1
        out[k] = np.asarray(a, np.float32)
    return traverse_util.unflatten_dict(out)


@pytest.fixture(scope="module")
def jax_tower():
    m = J.ClipTextModel()
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.zeros((1, C.CONTEXT), jnp.int32))
    return m, _filled(shapes), jax.jit(m.apply)


@pytest.fixture(scope="module")
def port_tower():
    """One port tower for the tests that load every weight into it."""
    return C.ClipTextModel().eval()


def test_tower_from_jax_variables_matches_jax(jax_tower, port_tower):
    m, variables, apply = jax_tower
    port = port_tower
    port.load_state_dict(from_jax_variables(traverse_util.flatten_dict(variables)), strict=True)
    toks = _tokens()
    want = np.asarray(apply(variables, jnp.asarray(toks)))
    with torch.no_grad():
        got = port(torch.from_numpy(toks)).numpy()
    assert got.shape == (4, C.WIDTH)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    assert np.abs(got - want).max() < TOL
    assert np.abs(got[0] - got[1]).max() > 1e-2  # the embedding depends on the tokens


def test_port_weights_through_jax_converter_match_jax(jax_tower):
    m, variables, apply = jax_tower
    port = C.ClipTextModel(seed=3).eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    jv = J.convert_clip_text_state_dict(sd, variables)
    toks = _tokens()
    with torch.no_grad():
        got = port(torch.from_numpy(toks)).numpy()
    assert np.abs(got - np.asarray(apply(jv, jnp.asarray(toks)))).max() < TOL


def test_causal_mask_and_eot_pooling():
    port = C.ClipTextModel(seed=1).eval()
    toks = _tokens()[:2]
    junk = toks.copy()
    junk[:, 30:40] = 123  # after each row's EOT (positions 2 and 6)
    with torch.no_grad():
        a = port(torch.from_numpy(toks))
        b = port(torch.from_numpy(junk))
        # EOT pooling reads the first of the row's largest ids: a second EOT later is ignored
        twice = toks.copy()
        twice[:, 50] = C.VOCAB - 1
        c = port(torch.from_numpy(twice))
    assert torch.equal(a, b) and torch.equal(a, c)


CORPUS = ("a photo of a person riding a bus, the dog's ball; traffic-light 12 stop "
          "sign & fire hydrant. don't they'll we've café naïve 東京 ½ 3.5 x2 "
          "hot dog hotdog teddy bear toothbrush").split()


def _merges(path):
    """Merges learned greedily on CORPUS (byte-level, </w>-terminated words)."""
    enc = C._bytes_to_unicode()
    words = Counter()
    for w in CORPUS:
        for piece in C.split_words(w.lower()):
            chars = "".join(enc[b] for b in piece.encode("utf-8"))
            words[tuple(chars[:-1]) + (chars[-1] + "</w>",)] += 1
    merges = []
    for _ in range(120):
        pairs = Counter()
        for w, n in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += n
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        new = Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] += n
        words = new
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: synthetic\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return path


TEXTS = ["a photo of a person", "Traffic-Light!! 12", "the dog's ball; they'll go", "café naïve",
         "東京 ½ x2 3.5", "hot   dog\thotdog", "&amp;quot;stop&quot; sign",
         "'S 'LL <|endoftext|>", "", "teddy bear" * 12]


def test_tokenizer_ids_equal_jax(tmp_path):
    path = _merges(tmp_path / "bpe.txt.gz")
    ours, theirs = C.ClipBPETokenizer(path), J.ClipBPETokenizer(path)
    for t in TEXTS:
        assert ours.encode(t) == theirs.encode(t), t
    got, want = ours.tokenize(TEXTS), theirs.tokenize(TEXTS)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got[:, 0] == ours.encoder["<|startoftext|>"]).all()
    assert len(set(ours.encode("a photo of a person"))) > 1


def _dump(rs, text_only=False):
    """A synthetic CLIP state_dict (the whole model's keys unless text_only)."""
    w = C.WIDTH
    sd = {("token_embedding" if text_only else "token_embedding.weight"):
          rs.randn(C.VOCAB, w).astype(np.float32) * 0.02,
          "positional_embedding": rs.randn(C.CONTEXT, w).astype(np.float32) * 0.01,
          "text_projection": rs.randn(w, w).astype(np.float32) * 0.05,
          "ln_final.weight": 1 + rs.randn(w).astype(np.float32) * 0.1,
          "ln_final.bias": rs.randn(w).astype(np.float32) * 0.1}
    for i in range(C.LAYERS):
        p = f"transformer.resblocks.{i}."
        for name, shape in (("ln_1.weight", (w,)), ("ln_1.bias", (w,)), ("ln_2.weight", (w,)),
                            ("ln_2.bias", (w,)), ("attn.in_proj_weight", (3 * w, w)),
                            ("attn.in_proj_bias", (3 * w,)), ("attn.out_proj.weight", (w, w)),
                            ("attn.out_proj.bias", (w,)), ("mlp.c_fc.weight", (4 * w, w)),
                            ("mlp.c_fc.bias", (4 * w,)), ("mlp.c_proj.weight", (w, 4 * w)),
                            ("mlp.c_proj.bias", (w,))):
            a = rs.randn(*shape).astype(np.float32) * (0.04 if len(shape) == 2 else 0.1)
            sd[p + name] = a + (1.0 if name.startswith("ln") and name.endswith("weight") else 0)
    if not text_only:
        sd["visual.proj"] = rs.randn(768, w).astype(np.float32)
        sd["logit_scale"] = np.float32(4.6)
    return sd


@pytest.mark.parametrize("text_only", [False, True], ids=["whole_model", "text_only"])
def test_converter_of_a_synthetic_dump_matches_jax(jax_tower, port_tower, text_only):
    m, variables, apply = jax_tower
    sd = _dump(np.random.RandomState(1), text_only)
    port = port_tower
    port.load_state_dict(C.convert_clip_text_state_dict(sd), strict=True)
    toks = _tokens()
    with torch.no_grad():
        got = port(torch.from_numpy(toks)).numpy()
    want = np.asarray(apply(J.convert_clip_text_state_dict(sd, variables), jnp.asarray(toks)))
    assert np.abs(got - want).max() < TOL


def test_set_classes_from_strings_matches_jax(jax_tower, tmp_path):
    """The port's bank against what JAX's set_classes computes from the same
    files: its tokenizer, `convert_clip_text_state_dict` of the npz and the
    tower's apply (JAX's `load_clip_text` and `model.apply`, the apply
    compiled here)."""
    m, variables, apply = jax_tower
    bpe = _merges(tmp_path / "bpe.txt.gz")
    npz = tmp_path / "clip_text.npz"
    sd = _dump(np.random.RandomState(2))
    np.savez(npz, **sd)
    names = ["person", "bus", "traffic light", "dog's ball"]
    pm = WorldModel("yolov8-worldv2.yaml", device="cpu")
    pm.set_classes(names, clip_npz=str(npz), bpe_path=str(bpe))
    tokens = J.ClipBPETokenizer(bpe).tokenize(names)
    want = np.asarray(apply(J.convert_clip_text_state_dict(dict(np.load(npz)), variables),
                            jnp.asarray(tokens)))
    assert pm.nc == 4 and pm.names == dict(enumerate(names)) and pm.model[-1].nc == 4
    assert np.abs(pm.text[0].numpy() - want).max() < TOL
    jm = jtasks.WorldModel("yolov8-worldv2.yaml")
    for mod in (pm, jm):
        with pytest.raises(ValueError, match="clip_npz"):
            mod.set_classes(names)


def test_text_prompt_raises_as_jax():
    for mod in (fastsam, jfastsam):
        with pytest.raises(NotImplementedError, match="CLIP"):
            mod.text_prompt([], "a dog")
