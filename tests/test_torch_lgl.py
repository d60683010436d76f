"""The LGL blocks of yolov13-dsc3k2-lgl in the PyTorch port against the JAX
package, on the CPU in f32 at narrow widths: LocalAgg, GlobalSparseAttn (sr 2,
and the sr 1 fallback when a side is odd), LGLBlock and DSC3K2_LGL (JAX
edgeyolo_tpu/nn/modules/msla_lgl.py).

Variables come from `jax.eval_shape` of the JAX module's init, filled from a
seeded numpy generator (tests/test_torch_v13_modules.py's `_variables`:
LayerNorm scales 1 + N(0, 0.1), shifts N(0, 0.1)), and are carried into the
port with `from_jax_variables`.

Tolerance: 1e-4, tests/test_torch_v13_modules.py's for learned conv stacks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_v13_modules import ATOL, _from_port, _to_port, _variables, _x

from edgeyolo_tpu.nn.modules import conv as jconv
from edgeyolo_tpu.nn.modules import msla_lgl as jmsla
from edgeyolo_tpu_torch.nn.modules import msla_lgl
from edgeyolo_tpu_torch.utils.convert import from_jax_variables

# (id, JAX module, port module, NHWC input shape, port keys JAX does not create)
CASES = [
    ("LocalAgg", jmsla.LocalAgg(16), msla_lgl.LocalAgg(16), (2, 10, 10, 16), ()),
    ("LocalAgg_ratio2", jmsla.LocalAgg(8, 2.0), msla_lgl.LocalAgg(8, 2.0), (2, 5, 7, 8), ()),
    ("GlobalSparseAttn_sr2", jmsla.GlobalSparseAttn(32, 2, 2), msla_lgl.GlobalSparseAttn(32, 2, 2),
     (2, 8, 6, 32), ()),
    ("GlobalSparseAttn_1head", jmsla.GlobalSparseAttn(16, 1, 2),
     msla_lgl.GlobalSparseAttn(16, 1, 2), (2, 12, 12, 16), ()),
    # a side of 5 does not divide by 2: full attention at full resolution, no
    # upsample and no norm (JAX creates neither)
    ("GlobalSparseAttn_sr1_fallback", jmsla.GlobalSparseAttn(32, 2, 2),
     msla_lgl.GlobalSparseAttn(32, 2, 2), (2, 5, 6, 32), ("local_prop.", "norm.")),
    ("LGLBlock", jmsla.LGLBlock(32), msla_lgl.LGLBlock(32), (2, 8, 8, 32), ()),
    ("LGLBlock_16", jmsla.LGLBlock(16), msla_lgl.LGLBlock(16), (2, 6, 4, 16), ()),
    ("DSC3K2_LGL", jmsla.DSC3K2_LGL(c2=32, n=1, e=0.5), msla_lgl.DSC3K2_LGL(16, 32, 1, e=0.5),
     (2, 8, 8, 16), ()),
    ("DSC3K2_LGL_n2_e025", jmsla.DSC3K2_LGL(c2=64, n=2, e=0.25),
     msla_lgl.DSC3K2_LGL(32, 64, 2, e=0.25), (2, 4, 4, 32), ()),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_module_matches_jax(case):
    _, jmod, tmod, shape, absent = case
    x = _x(shape)
    flat = _variables(jmod, jnp.asarray(x))
    with jconv.bn_config():
        yj = jax.jit(jmod.apply)(traverse_util.unflatten_dict(flat), jnp.asarray(x))
    missing, unexpected = tmod.load_state_dict(from_jax_variables(flat), strict=False)
    assert not unexpected and all(k.startswith(absent) for k in missing), missing
    assert bool(missing) == bool(absent)
    with torch.no_grad():
        yt = tmod.eval()(_to_port(x, "nhwc"))
    np.testing.assert_allclose(_from_port(yt, "nhwc"), np.asarray(yj), atol=ATOL)


def test_layer_norm_is_flax_s():
    """eps 1e-6 (torch's default is 1e-5), statistics and affine in f32 for a
    bf16 input, the output back in bf16."""
    m = msla_lgl.GlobalSparseAttn(16, 1, 2)
    assert m.norm.eps == 1e-6
    x = torch.from_numpy(_x((2, 16, 4, 4))).to(torch.bfloat16)
    y = msla_lgl.layer_norm_f32(m.norm, x)
    ref = torch.nn.functional.layer_norm(x.float().permute(0, 2, 3, 1), (16,), eps=1e-6)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, ref.permute(0, 3, 1, 2).to(torch.bfloat16), rtol=0, atol=0)


def test_heads_follow_the_width():
    """max(1, min(4, dim // 16)) heads in LGLBlock's global attention."""
    heads = {d: getattr(msla_lgl.LGLBlock(d), "global").num_heads for d in (8, 16, 32, 64, 128)}
    assert heads == {8: 1, 16: 1, 32: 2, 64: 4, 128: 4}
