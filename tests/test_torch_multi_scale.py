"""`multi_scale` training augmentation of the port against the JAX package.

JAX folds a content scale drawn in [0.5, 1.5] into each image's homography
(edgeyolo_tpu/data/augment_device.py `_affine_params`). The port draws it
after the affine's own draws, so a run without the option draws as before.
- the homography from JAX's draws (its key's k1..k7) through the port's
  `affine_matrix`, equal to JAX's `_affine_params` to 1e-5 relative;
- the warped batch with JAX's draws replayed into the port's `augment_apply`
  against JAX's `augment_batch`, at tests/test_torch_augment.py's
  tolerances (img01 1e-4, labels 1e-5);
- the port's own draws: with the option, the affine is the one without it
  times the extra draw; the train step of the flagship runs with it.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_augment import GATHER, QUIET, S, _assert_same, _run_both
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.data import augment_device as jaug
from edgeyolo_tpu_torch.data import augment_device as aug
from edgeyolo_tpu_torch.nn.tasks import DetectionModel
from edgeyolo_tpu_torch.train import trainer

HYP = {"degrees": 10.0, "shear": 3.0, "perspective": 0.0005, "translate": 0.1, "scale": 0.5,
       "multi_scale": True}


@pytest.mark.parametrize("seed", range(4))
def test_homography_equals_jax(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug._affine_params(key, S, HYP))
    k1, k2, k3, k4, k5, k6, k7 = jax.random.split(key, 7)

    def u(k, shape, lo, hi):
        return torch.from_numpy(np.array(jax.random.uniform(k, shape, minval=lo, maxval=hi)))

    angle, scale = u(k1, (1,), -10.0, 10.0), u(k2, (1,), 0.5, 1.5)
    extra = u(k6, (1,), 0.5, 1.5)
    shear = torch.stack([u(k3, (), -3.0, 3.0), u(k4, (), -3.0, 3.0)])[None]
    translate = u(k5, (1, 2), 0.4, 0.6) * S
    persp = u(k7, (1, 2), -0.0005, 0.0005)
    got = aug.affine_matrix(angle, scale * extra, shear, translate, persp)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(aug.affine_matrix(angle, scale, shear, translate, persp)[0].numpy(),
                           want, rtol=1e-3)  # the extra scale matters


@pytest.mark.parametrize("path", ["separable", "gather"])
@pytest.mark.parametrize("mosaic", [True, False], ids=["mosaic4", "single"])
def test_warp_matches_jax(path, mosaic):
    hyp = {**QUIET, **(GATHER if path == "gather" else {}), "multi_scale": True}
    j, p, _ = _run_both(hyp, mosaic)
    _assert_same(j, p)
    assert p[3].sum() > 0


def test_port_draws_the_scale_after_the_affine():
    b = 4
    on = aug.sample_params(b, S, {**HYP, "photometric": 0.0}, True, torch.Generator().manual_seed(5))
    off = aug.sample_params(b, S, {**HYP, "multi_scale": False, "photometric": 0.0}, True,
                            torch.Generator().manual_seed(5))
    torch.testing.assert_close(on.sel, off.sel, rtol=0, atol=0)
    torch.testing.assert_close(on.center, off.center, rtol=0, atol=0)
    g = torch.Generator().manual_seed(5)  # replay: partners, centres, the affine's draws, the scale
    torch.randint(1, b, (b, 3), generator=g)
    torch.rand((b, 2), generator=g)
    angle, scale = aug._uniform(g, (b,), -10, 10), aug._uniform(g, (b,), 0.5, 1.5)
    shear, translate = aug._uniform(g, (b, 2), -3, 3), aug._uniform(g, (b, 2), 0.4, 0.6) * S
    persp = aug._uniform(g, (b, 2), -0.0005, 0.0005)
    extra = aug._uniform(g, (b,), 0.5, 1.5)
    torch.testing.assert_close(off.affine, aug.affine_matrix(angle, scale, shear, translate, persp),
                               rtol=0, atol=0)
    torch.testing.assert_close(on.affine, aug.affine_matrix(angle, scale * extra, shear, translate,
                                                            persp), rtol=0, atol=0)


def test_train_step_with_multi_scale():
    rs = np.random.RandomState(0)
    b, m = 2, 4
    batch = {"img": torch.from_numpy(rs.randint(0, 256, (b, S, S, 3)).astype(np.uint8)),
             "cls": torch.zeros(b, m), "mask_gt": torch.ones(b, m),
             "bboxes": torch.from_numpy(np.concatenate([rs.uniform(0.3, 0.7, (b, m, 2)),
                                                        rs.uniform(0.2, 0.4, (b, m, 2))], -1)
                                        .astype(np.float32)),
             "img_weight": torch.ones(b)}
    t = trainer.DetectionTrainer(DetectionModel("edgeline-yolo.yaml", device="cpu"),
                                 {"batch": b, "nbs": 2, "amp": False, "optimizer": "SGD",
                                  "multi_scale": True, "photometric": 0.0}, device="cpu")
    t.setup(nb=1)
    loss, items, updated = t.train_step(batch)
    assert np.isfinite(float(loss)) and updated
