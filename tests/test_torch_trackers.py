"""The port's trackers (edgeyolo_tpu_torch/trackers) held against the JAX
package's (edgeyolo_tpu/trackers) on the CPU.

- Kalman XYAH and XYWH: the same measurements through initiate, predict,
  multi_predict, update and gating; means and covariances equal to 1e-9
  (both float64).
- ByteTrack and BoT-SORT on tests/test_trackers.py's two moving objects and
  on seeded sequences with jitter, low-confidence frames, dropouts and new
  objects: equal ids, classes and detection indices on every frame, boxes
  and scores within 1e-6.
- GMC (sparseOptFlow) on tests/test_trackers.py's panned noise and on
  moving-shape frames: warps within 1e-4.
- `make_tracker` from the byte-identical tracker YAMLs; `track_stream` over a
  video's Results equal to JAX's `track_stream` over the same Results; the
  facade's `track(persist=True)` keeping one id across calls (as
  tests/test_facade_surface.py:201), and the CLI's `track` mode.
`STrack`'s class-level id counter is reset before each test in both packages.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.engine.results import Results as JResults
from edgeyolo_tpu.trackers import byte_tracker as jbt
from edgeyolo_tpu.trackers import gmc as jgmc
from edgeyolo_tpu.trackers import kalman as jkalman
from edgeyolo_tpu.trackers import track as jtrack
from edgeyolo_tpu_torch.cfg import cli
from edgeyolo_tpu_torch.data.synthetic import moving_shapes, write_mjpeg_avi
from edgeyolo_tpu_torch.engine.model import YOLO
from edgeyolo_tpu_torch.trackers import byte_tracker as bt
from edgeyolo_tpu_torch.trackers import gmc
from edgeyolo_tpu_torch.trackers import kalman
from edgeyolo_tpu_torch.trackers import track

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_ids():
    bt.STrack.reset_id()
    jbt.STrack.reset_id()
    yield


@pytest.mark.parametrize("kind", ["KalmanFilterXYAH", "KalmanFilterXYWH"])
def test_kalman_equals_jax(kind):
    kf, jkf = getattr(kalman, kind)(), getattr(jkalman, kind)()
    rs = np.random.RandomState(0)
    z = np.array([50.0, 40.0, 0.8 if kind.endswith("AH") else 16.0, 20.0])
    m, c = kf.initiate(z)
    jm, jc = jkf.initiate(z)
    for t in range(12):
        m, c = kf.predict(m, c)
        jm, jc = jkf.predict(jm, jc)
        z = z + np.array([2.0, -1.0, 0.0, 0.3]) + rs.randn(4) * 0.2
        m, c = kf.update(m, c, z)
        jm, jc = jkf.update(jm, jc, z)
        np.testing.assert_allclose(m, jm, atol=1e-9, rtol=0)
        np.testing.assert_allclose(c, jc, atol=1e-9, rtol=0)
    means, covs = np.stack([m, m + 1]), np.stack([c, c * 1.1])
    for a, b in zip(kf.multi_predict(means, covs), jkf.multi_predict(means, covs)):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
    meas = z[None] + rs.randn(5, 4)
    for only in (False, True):
        np.testing.assert_allclose(kf.gating_distance(m, c, meas, only),
                                   jkf.gating_distance(m, c, meas, only), atol=1e-9, rtol=1e-12)


def _moving_dets(t):
    """tests/test_trackers.py's two objects moving right and down."""
    return (np.array([[10 + 3 * t, 10, 30 + 3 * t, 30], [100, 50 + 2 * t, 130, 90 + 2 * t]],
                     np.float32),
            np.array([0.9, 0.85], np.float32), np.array([0.0, 1.0], np.float32))


def _sequence(seed, n=30):
    """Seeded frames: 4 objects with jittered boxes and scores, some frames
    missing an object, some scores under the high threshold, an object
    appearing halfway."""
    rs = np.random.RandomState(seed)
    starts = rs.uniform(20, 200, (4, 2))
    vel = rs.uniform(-3, 3, (4, 2))
    size = rs.uniform(15, 40, (4, 2))
    frames = []
    for t in range(n):
        boxes, scores, cls = [], [], []
        for k in range(4):
            if (k == 3 and t < n // 2) or rs.rand() < 0.1:
                continue
            xy = starts[k] + vel[k] * t + rs.randn(2)
            boxes.append([*xy, *(xy + size[k] + rs.randn(2) * 0.5)])
            scores.append(rs.uniform(0.12, 0.95))
            cls.append(float(k % 2))
        frames.append((np.asarray(boxes, np.float32).reshape(-1, 4),
                       np.asarray(scores, np.float32), np.asarray(cls, np.float32)))
    return frames


def _panned(n, seed=1):
    rs = np.random.RandomState(seed)
    base = rs.randint(0, 255, (160, 240, 3)).astype(np.float32)
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, -1, 0) + np.roll(base, -1, 1)) / 5
    return [np.roll(base, 4 * f, axis=1).astype(np.uint8) for f in range(n)]


def _assert_same_tracks(out, jout):
    assert out.shape == jout.shape
    np.testing.assert_array_equal(out[:, [4, 6, 7]], jout[:, [4, 6, 7]])  # id, cls, det index
    np.testing.assert_allclose(out[:, :4], jout[:, :4], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[:, 5], jout[:, 5], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["bytetrack", "botsort"])
@pytest.mark.parametrize("seq", ["two_moving", "seed0", "seed1", "seed2"])
def test_tracker_equals_jax(kind, seq):
    tr, jtr = track.make_tracker(kind), jtrack.make_tracker(kind)
    if seq == "two_moving":
        frames = [_moving_dets(t) for t in range(10)]
    else:
        frames = _sequence(int(seq[-1]))
    imgs = _panned(len(frames)) if kind == "botsort" else [None] * len(frames)
    ids = set()
    for (boxes, scores, cls), img in zip(frames, imgs):
        out = tr.update(boxes, scores, cls, img=img)
        jout = jtr.update(boxes, scores, cls, img=img)
        _assert_same_tracks(out, jout)
        ids |= set(out[:, 4].astype(int))
    assert ids  # tracks were made
    if seq == "two_moving":
        assert ids == {1, 2}


def test_bytetrack_keeps_ids_through_a_dropout():
    tr = bt.BYTETracker(track_buffer=30)
    for t in range(5):
        out = tr.update(*_moving_dets(t))
    before = set(out[:, 4].astype(int))
    for t in range(5, 7):
        boxes, scores, cls = _moving_dets(t)
        tr.update(boxes[1:], scores[1:], cls[1:])
    assert set(tr.update(*_moving_dets(7))[:, 4].astype(int)) == before


@pytest.mark.parametrize("frames", ["panned", "shapes"])
def test_gmc_equals_jax(frames):
    if frames == "panned":
        seq = _panned(4)
    else:
        seq = list(moving_shapes(4, 120, 200, speed=3.0, seed=4)[0])
    g, jg = gmc.GMC("sparseOptFlow", downscale=2), jgmc.GMC("sparseOptFlow", downscale=2)
    for img in seq:
        np.testing.assert_allclose(g.apply(img), jg.apply(img), atol=1e-4, rtol=0)
    if frames == "panned":  # the pan is found: 4 px a frame to the right
        assert abs(g.apply(np.roll(seq[-1], 4, axis=1))[0, 2] - 4) < 1.5


def test_gmc_ransac_draws_equal_jax():
    rs = np.random.RandomState(3)
    src = rs.uniform(0, 100, (40, 2))
    dst = src * 1.02 + [3.0, -2.0] + rs.randn(40, 2) * 0.3
    dst[:6] += 40  # outliers
    for seed in (0, 1):
        np.testing.assert_allclose(gmc._ransac_similarity(src, dst, seed=seed),
                                   jgmc._ransac_similarity(src, dst, seed=seed), atol=1e-6)


@pytest.mark.parametrize("name", ["bytetrack", "botsort"])
def test_make_tracker_from_the_yaml_copies(name):
    port = REPO / "edgeyolo_tpu_torch" / "cfg" / "trackers" / f"{name}.yaml"
    assert port.read_bytes() == (REPO / "edgeyolo_tpu" / "cfg" / "trackers" / f"{name}.yaml").read_bytes()
    for cfg in (f"{name}.yaml", str(port), name):
        t, jt = track.make_tracker(cfg), jtrack.make_tracker(cfg)
        assert type(t).__name__ == type(jt).__name__
        keys = ("track_high_thresh", "track_low_thresh", "new_track_thresh", "match_thresh",
                "fuse_score", "max_time_lost", "proximity_thresh", "appearance_thresh",
                "with_reid")
        assert {k: getattr(t, k, None) for k in keys} == {k: getattr(jt, k, None) for k in keys}
    with pytest.raises(ValueError, match="unknown tracker"):
        track.make_tracker("sort")


# -- the facade ------------------------------------------------------------------------
class _SquareFinder(torch.nn.Module):
    """A stand-in detector: one box around the bright pixels of each image
    (xywh in canvas pixels), class 0 at 0.9; the rest of the anchors empty."""

    def __init__(self):
        super().__init__()
        self.nc, self.dtype, self.names, self.end2end = 2, torch.float32, {0: "a", 1: "b"}, False

    def forward(self, x):
        b, _, h, w = x.shape
        pred = torch.zeros(b, 8, 6)
        for i in range(b):
            ys, xs = torch.nonzero(x[i].mean(0) > 0.8, as_tuple=True)
            if len(ys):
                x1, y1, x2, y2 = xs.min(), ys.min(), xs.max() + 1, ys.max() + 1
                pred[i, 0, :4] = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
                pred[i, 0, 4] = 0.9
        return {"pred": pred}


def _square_frames(n=8, s=64):
    out = []
    for t in range(n):
        f = np.full((s, s, 3), 40, np.uint8)
        f[20:36, 4 + 3 * t:20 + 3 * t] = 255
        out.append(f)
    return out


def _yolo():
    m = YOLO("edgeline-yolo.yaml", device="cpu")
    m.model = _SquareFinder()
    return m


def test_track_persist_keeps_ids_across_calls(tmp_path):
    m = _yolo()
    ids = []
    for f in _square_frames(5):  # one call per frame, the tracker kept
        (r,) = list(m.track(f, persist=True, imgsz=64, project=str(tmp_path), save=False))
        ids += r.track_ids.tolist()
    assert ids == [1] * 5 and m._tracker.frame_id == 5
    (r,) = list(m.track(_square_frames(1)[0], imgsz=64, project=str(tmp_path), save=False))
    assert m._tracker.frame_id == 1  # persist=False starts a new tracker


@pytest.mark.parametrize("kind", ["bytetrack", "botsort"])
def test_track_stream_over_a_video_equals_jax(kind, tmp_path):
    frames = _square_frames(8)
    avi = write_mjpeg_avi(tmp_path / "line.avi", frames, quality=95)
    m = _yolo()
    results = list(m.predict(str(avi), imgsz=64, conf=0.1, project=str(tmp_path), save=False))
    got = list(track.track_stream(iter(results), tracker_cfg=kind))
    want = list(jtrack.track_stream(
        iter([JResults(r.orig_img, r.path, r.names, boxes=r.boxes.data) for r in results]),
        tracker_cfg=kind))
    assert [r.path for r in got] == [f"{avi}:{i}" for i in range(8)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.track_ids, w.track_ids)
        np.testing.assert_allclose(g.boxes.data, w.boxes.data, atol=ATOL, rtol=0)
        assert g.boxes.is_track == w.boxes.is_track
    assert {i for r in got for i in r.track_ids.tolist()} == {1}
    tracked = list(m.track(str(avi), imgsz=64, project=str(tmp_path), tracker=f"{kind}.yaml",
                           save=True))
    assert len(tracked) == 8 and len(list((tmp_path / "predict").glob("line_*.jpg"))) == 8


def test_cli_track_mode(tmp_path, capsys):
    avi = write_mjpeg_avi(tmp_path / "line.avi", moving_shapes(3, 48, 64, seed=6)[0])
    rc = cli.entrypoint(["detect", "track", "model=edgeline-yolo.yaml", f"source={avi}",
                         "device=cpu", "imgsz=64", f"project={tmp_path}", "tracker=botsort.yaml"])
    out = capsys.readouterr().out
    assert rc == 0 and "3 frames tracked" in out and f"{avi}:2: ids" in out
    assert len(list((tmp_path / "predict").glob("line_*.jpg"))) == 3
