"""The YOLO-NAS facade of the PyTorch port (edgeyolo_tpu_torch/engine/nas.py)
against JAX's (edgeyolo_tpu/engine/nas.py), on the CPU.

- JAX's own two cases (tests/test_nas.py) on the port: the YAML assertion
  and the super_gradients gate; one planted detection out of 50 anchors.
- The postprocess on the same NAS-layout output in both packages, at
  A = 50 and A = 8,400 (YOLO-NAS-S at 640 px), 80 classes, two images with
  planted detections among seeded noise: the same count per image, classes
  and kept anchors exactly, boxes within 1e-4 px, scores within 1e-6.
- `edgeyolo_tpu_torch.NAS` is the facade; no CPU fallback without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

import edgeyolo_tpu_torch
from edgeyolo_tpu.engine.nas import NAS as JaxNAS
from edgeyolo_tpu.ops.boxes import xyxy2xywh as jax_xyxy2xywh
from edgeyolo_tpu.ops.nms import non_max_suppression as jax_nms
from edgeyolo_tpu_torch.engine.nas import NAS
from edgeyolo_tpu_torch.ops.boxes import xyxy2xywh
from edgeyolo_tpu_torch.ops.nms import non_max_suppression


def test_nas_rejects_yaml_and_gates_load():
    with pytest.raises(AssertionError):
        NAS("yolo_nas_s.yaml", device="cpu")
    with pytest.raises(ImportError, match="super_gradients"):
        NAS("yolo_nas_s.pt", device="cpu")


def test_nas_postprocess_with_backend():
    rng = np.random.RandomState(0)

    def fake_backend(imgs):
        b = imgs.shape[0]
        a, nc = 50, 80
        boxes = np.zeros((b, a, 4), np.float32)
        boxes[..., :2] = rng.rand(b, a, 2) * 300
        boxes[..., 2:] = boxes[..., :2] + 20 + rng.rand(b, a, 2) * 60
        scores = rng.rand(b, a, nc).astype(np.float32) * 0.2
        scores[:, 7, 3] = 0.95  # one strong detection
        return boxes, scores

    nas = NAS("yolo_nas_s.pt", backend=fake_backend, device="cpu")
    det, n = nas.predict(np.zeros((2, 320, 320, 3), np.uint8), conf=0.5)
    det, n = det.numpy(), n.numpy()
    assert det.shape[0] == 2 and det.shape[2] == 6
    assert (n == 1).all()  # exactly the planted detection survives
    assert int(det[0, 0, 5]) == 3 and det[0, 0, 4] > 0.9


def nas_output(b: int, a: int, nc: int = 80, objects: int = 10, size: float = 640.0,
               seed: int = 0):
    """Seeded NAS-layout output: xyxy boxes over the image and scores under
    0.2 (below the gate), with per image `objects` clusters of 8 overlapping
    boxes of one class at 0.3-0.95 (NMS keeps some of each, suppresses the
    rest) and 4 strong lone boxes."""
    rs = np.random.RandomState(seed)
    xy = rs.rand(b, a, 2) * (size - 120)
    boxes = np.concatenate([xy, xy + 16 + rs.rand(b, a, 2) * 100], -1).astype(np.float32)
    scores = (rs.rand(b, a, nc) * 0.2).astype(np.float32)
    for i in range(b):
        idx = rs.choice(a, 8 * objects + 4, replace=False)
        for j in range(objects):  # 8 overlapping boxes of one class about each object
            c = idx[8 * j:8 * j + 8]
            base = rs.rand(2) * (size - 200)
            boxes[i, c] = np.concatenate([base, base + 60 + rs.rand(2) * 100]) + rs.randn(8, 4) * 8
            scores[i, c, rs.randint(nc)] = 0.3 + rs.rand(8) * 0.65
        scores[i, idx[-4:], rs.randint(0, nc, 4)] = 0.6 + rs.rand(4) * 0.3  # lone ones
    return boxes, scores


@pytest.mark.parametrize("anchors", [50, 8400])
def test_postprocess_equals_jax(anchors):
    boxes, scores = nas_output(2, anchors, objects=10 if anchors > 100 else 4)
    got_det, got_n = NAS("yolo_nas_s.pt", backend=lambda x: x, device="cpu").postprocess(
        boxes, scores, conf=0.25, iou=0.45)
    want_det, want_n = JaxNAS("yolo_nas_s.pt", backend=lambda x: x).postprocess(
        boxes, scores, conf=0.25, iou=0.45)
    got_det, want_det, want_n = got_det.numpy(), np.asarray(want_det), np.asarray(want_n)
    assert np.array_equal(got_n.numpy(), want_n) and (want_n > 1).all()
    for i, k in enumerate(want_n):
        assert np.array_equal(got_det[i, :k, 5], want_det[i, :k, 5])
        np.testing.assert_allclose(got_det[i, :k, :4], want_det[i, :k, :4], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got_det[i, :k, 4], want_det[i, :k, 4], atol=1e-6, rtol=0)
    # the kept anchors: the same NMS of the same concatenation, with its indices
    pred = np.concatenate([np.asarray(jax_xyxy2xywh(jnp.asarray(boxes))), scores], -1)
    _, _, want_idx = jax_nms(jnp.asarray(pred), conf_thres=0.25, iou_thres=0.45, return_idx=True)
    tpred = torch.cat([xyxy2xywh(torch.from_numpy(boxes)), torch.from_numpy(scores)], -1)
    _, _, got_idx = non_max_suppression(tpred, conf_thres=0.25, iou_thres=0.45, return_idx=True)
    for i, k in enumerate(want_n):
        assert np.array_equal(got_idx[i, :k].numpy(), np.asarray(want_idx)[i, :k])


def test_facade_name_and_no_cpu_fallback():
    assert edgeyolo_tpu_torch.NAS is NAS
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            NAS("yolo_nas_s.pt", backend=lambda x: x)
