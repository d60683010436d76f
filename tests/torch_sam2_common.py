"""What the port's SAM2 test files share: a small SAM2 in both packages with
the same weights, every variable away from its init.

The small model keeps every path of the full one at a CPU's size: a Hiera of
width 16 (stages 1, 2, 2, 1, so 16 -> 128 channels, heads 1 -> 8), at
128 px: stage 1 in 8 x 8 windows of its 32 x 32 map, q-pooling at the first
block of stages 2-4, block 4 global, stages 3 and 4 (8 x 8 and 4 x 4) in
windows of 14 and 7 padded with zeros, a 7 x 7 background position resized
to 32 x 32 by the cubic rule; the decoder, memory encoder and memory
attention at full width (256, 64 memory channels). JAX's variables come
from `jax.eval_shape` of its init, are filled from a seeded generator by
tests/test_torch_sam.py's `_filled` (kernels U(+-1.5/sqrt(fan_in)), norm
scales 1 + N(0, 0.1), tokens and the Fourier matrix N(0, 1), the rest, the
positions, ConvNeXt gammas and memory embeddings included, N(0, 0.1)), and
are carried into the port by `from_jax_variables`, strictly."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util
from test_torch_sam import _filled, assert_close  # noqa: F401  (re-exported)

from edgeyolo_tpu.nn import sam2 as jsam2
from edgeyolo_tpu_torch.nn import sam2 as nsam2
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

IMG = 128
SMALL = {"embed_dim": 16, "stages": (1, 2, 2, 1), "global_att_blocks": (4,),
         "backbone_channel_list": (128, 64, 32, 16)}


def jax_template(jm, img: int) -> dict:
    """JAX's variables as shapes (jax.eval_shape of its init), flattened."""
    return traverse_util.flatten_dict(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), jnp.zeros((1, 1, 2)),
        jnp.zeros((1, 1), jnp.int32))))


def small_pair(seed: int = 0, **overrides):
    """(JAX's SAM2Model, its variables, the port's SAM2Model) with the same
    filled weights."""
    jm = jsam2.SAM2Model(image_size=IMG, **SMALL, **overrides)
    flat = _filled(jax_template(jm, IMG), seed)
    pm = nsam2.SAM2Model(image_size=IMG, **SMALL, **overrides).eval()
    pm.load_state_dict(from_jax_variables(flat), strict=True)
    return jm, traverse_util.unflatten_dict(flat), pm


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)
