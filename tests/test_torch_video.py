"""Video and stream sources of the port (edgeyolo_tpu_torch/data/loaders.py)
held against the JAX package's (edgeyolo_tpu/data/loaders.py).

- MJPEG AVI (written by the port's `write_mjpeg_avi`): every frame equal
  byte for byte (tolerance 0) to JAX's `_mjpeg_avi_decoder` (PIL), and the
  `path:i` names and `vid_stride` selection of tests/test_loaders_video.py
  (frames 0, 3, 6 of 7 at stride 3), through `LoadVideo` and `LoadImages`
  over a directory of images and a video;
- the MJPEG-over-HTTP reader on a loopback server in a thread: frames equal
  to JAX's `open_mjpeg_http` byte for byte, a non-MJPEG response refused with
  NotImplementedError, a truncated frame raised;
- `FrameStream` and `LoadStreams` with `stream_buffer` (buffer=True) delivering
  every frame, in order, to a consumer slower than the reader;
- the dispatcher's `SourceTypes` as JAX's, and `NotImplementedError` naming
  `register_video_decoder` where no decoder reads the file (mp4, RTSP).
Every socket and thread test has its own timeout (`_within`).
"""

import http.server
import io
import threading
import time

import numpy as np
import pytest
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401  (the port on one thread)

from edgeyolo_tpu.data import loaders as jloaders
from edgeyolo_tpu_torch.data import loaders
from edgeyolo_tpu_torch.data.imageio import decode_jpeg, encode_jpeg, save_png
from edgeyolo_tpu_torch.data.synthetic import moving_shapes, write_mjpeg_avi

TIMEOUT = 30.0


def _within(fn, timeout=TIMEOUT):
    """fn() on a thread; fails the test if it does not return in `timeout` s."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"timed out after {timeout} s"
    if err:
        raise err[0]
    return out[0]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("video")
    frames, boxes = moving_shapes(7, 48, 80, speed=3.0, seed=2)
    return write_mjpeg_avi(d / "clip.avi", frames, quality=85), frames


def test_avi_frames_equal_jax(clip):
    path, frames = clip
    want = list(jloaders._mjpeg_avi_decoder(str(path)))
    got = list(loaders.open_video(str(path)))
    assert len(got) == len(want) == 7
    for g, w, f in zip(got, want, frames):
        assert g.dtype == np.uint8 and g.shape == (48, 80, 3)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, decode_jpeg(encode_jpeg(f, quality=85)))


def test_vid_stride_and_names_equal_jax(clip):
    path, _ = clip
    for stride in (1, 3):
        got = [n for n, _ in loaders.LoadVideo(str(path), vid_stride=stride)]
        want = [n for n, _ in jloaders.LoadVideo(str(path), vid_stride=stride)]
        assert got == want
    assert [n.rsplit(":", 1)[1] for n, _ in loaders.LoadVideo(str(path), 3)] == ["0", "3", "6"]


def test_directory_of_images_and_a_video(clip, tmp_path):
    path, frames = clip
    d = tmp_path / "mixed"
    d.mkdir()
    (d / "clip.avi").write_bytes(path.read_bytes())
    save_png(d / "a.png", frames[0])
    loader, kinds = loaders.load_inference_source(str(d), vid_stride=2)
    jloader, jkinds = jloaders.load_inference_source(str(d), vid_stride=2)
    got, want = list(loader), list(jloader)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == 1 + 4 and vars(kinds) == vars(jkinds)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_truncated_avi_raises(clip, tmp_path):
    path, _ = clip
    data = path.read_bytes()
    cut = tmp_path / "cut.avi"
    cut.write_bytes(data[:data.rfind(b"\xff\xd9") - 10])
    with pytest.raises(ValueError, match="truncated"):
        list(loaders.open_video(str(cut)))
    bad = tmp_path / "bad.avi"  # a frame whose entropy-coded data is damaged
    blob = bytearray(data)
    s = data.find(b"\xff\xda")  # the first frame's scan header
    blob[s + 20:s + 60] = b"\xff\x00" * 20
    bad.write_bytes(bytes(blob))
    with pytest.raises(ValueError):
        list(loaders.open_video(str(bad)))


def test_unreadable_sources_name_the_way_in(tmp_path):
    mp4 = tmp_path / "clip.mp4"
    mp4.write_bytes(b"\0" * 64)
    with pytest.raises(NotImplementedError, match="register_video_decoder"):
        list(loaders.open_video(str(mp4)))
    with pytest.raises(NotImplementedError, match="register_video_decoder"):
        loaders.load_inference_source("rtsp://127.0.0.1:1/cam")
    with pytest.raises(NotImplementedError, match="register_video_decoder"):
        loaders.load_inference_source("0")


def test_registered_decoder_is_used(tmp_path):
    fake = tmp_path / "video.xyz"
    fake.write_bytes(b"fake")

    def xyz(path):
        return iter([np.zeros((8, 8, 3), np.uint8)] * 3) if str(path).endswith(".xyz") else None

    loaders.register_video_decoder(xyz, prepend=True)
    try:
        assert len(list(loaders.open_video(fake))) == 3
    finally:
        loaders.VIDEO_DECODERS.remove(xyz)


# -- MJPEG over HTTP -------------------------------------------------------------------
def _server(handler_get):
    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            handler_get(self)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/stream"


def _mjpeg(blobs, boundary=b"frame"):
    def get(h):
        h.send_response(200)
        h.send_header("Content-Type", f"multipart/x-mixed-replace; boundary={boundary.decode()}")
        h.end_headers()
        for blob in blobs:
            h.wfile.write(b"--" + boundary + b"\r\nContent-Type: image/jpeg\r\n")
            h.wfile.write(f"Content-Length: {len(blob)}\r\n\r\n".encode() + blob + b"\r\n")
    return _server(get)


def _blobs(n=5):
    frames, _ = moving_shapes(n, 40, 56, seed=3)
    return [encode_jpeg(f, quality=80) for f in frames]


def test_mjpeg_http_frames_equal_jax():
    blobs = _blobs()
    srv, url = _mjpeg(blobs)
    try:
        got = _within(lambda: list(loaders.open_mjpeg_http(url)))
        want = _within(lambda: list(jloaders.open_mjpeg_http(url)))
    finally:
        srv.shutdown()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mjpeg_http_through_the_dispatcher():
    srv, url = _mjpeg(_blobs(4))
    try:
        loader, kinds = loaders.load_inference_source(url)
        got = _within(lambda: list(loader))
    finally:
        srv.shutdown()
    assert kinds.stream and [n for n, _ in got] == [f"{url}:{i}" for i in range(4)]


def test_mjpeg_http_refuses_other_content():
    def page(h):
        h.send_response(200)
        h.send_header("Content-Type", "text/html")
        h.end_headers()
        h.wfile.write(b"<html></html>")

    srv, url = _server(page)
    try:
        with pytest.raises(NotImplementedError, match="MJPEG"):
            _within(lambda: loaders.open_mjpeg_http(url))
    finally:
        srv.shutdown()


def test_mjpeg_http_truncated_frame_raises():
    blobs = _blobs(2)
    blobs[-1] = blobs[-1][:len(blobs[-1]) // 2]  # the stream ends inside the last frame
    srv, url = _mjpeg(blobs)
    try:
        with pytest.raises(ValueError):
            _within(lambda: list(loaders.open_mjpeg_http(url)))
    finally:
        srv.shutdown()


# -- buffered streams ------------------------------------------------------------------
def test_framestream_delivers_every_frame_in_order():
    frames = [np.full((16, 16, 3), i, np.uint8) for i in range(12)]

    def consume():
        out = []
        for _, f in loaders.FrameStream(iter(frames), buffer=2):
            out.append(int(f[0, 0, 0]))
            time.sleep(0.02)  # slower than the reader, within its one-second wait
        return out

    assert _within(consume) == list(range(12))


def test_framestream_raises_the_sources_error():
    def gen():
        yield np.zeros((4, 4, 3), np.uint8)
        raise ValueError("camera lost")

    with pytest.raises(ValueError, match="camera lost"):
        _within(lambda: list(loaders.FrameStream(gen())))


@pytest.mark.parametrize("kind", ["file", "http"])
def test_load_streams_buffered_delivers_every_frame(kind, tmp_path):
    """stream_buffer=True: the reader waits for the consumer instead of
    dropping the oldest frame (tests/test_loaders_video.py's check, on an
    MJPEG AVI and an MJPEG camera instead of cv2's mp4)."""
    plates = [np.full((32, 32, 3), i * 15, np.uint8) for i in range(12)]
    srv = None
    if kind == "file":
        src = str(write_mjpeg_avi(tmp_path / "cam.avi", plates))
    else:
        srv, src = _mjpeg([encode_jpeg(p) for p in plates])

    def consume():
        ls = loaders.LoadStreams(src, buffer_size=2, buffer=True)
        got = []
        for name, frame in ls:
            assert name == src
            got.append(int(frame.mean()))
            time.sleep(0.03)
        ls.close()
        return got

    try:
        got = _within(consume)
    finally:
        if srv:
            srv.shutdown()
    assert len(got) == 12 and got == sorted(got)


def test_load_streams_unbuffered_keeps_the_latest(tmp_path):
    plates = [np.full((32, 32, 3), i * 15, np.uint8) for i in range(12)]
    src = str(write_mjpeg_avi(tmp_path / "cam.avi", plates))

    def consume():
        ls = loaders.LoadStreams([src], buffer_size=2, buffer=False)
        time.sleep(0.5)  # the reader runs ahead and drops the oldest frames
        return [int(f.mean()) for _, f in ls]

    got = _within(consume)
    assert 1 <= len(got) < 12 and got == sorted(got) and got[-1] == 165


def test_source_types_equal_jax(clip):
    path, frames = clip
    arr = frames[0]
    for src in (arr, [arr, arr], np.stack([arr, arr]), str(path)):
        assert vars(loaders.load_inference_source(src)[1]) == \
            vars(jloaders.load_inference_source(src)[1])
    it = loaders.load_inference_source(iter([arr]))
    assert it[1].stream and len(list(it[0])) == 1


def test_pil_written_avi_frames(tmp_path):
    """An AVI whose frames PIL wrote (not the port's encoder) decodes equal to JAX's."""
    frames, _ = moving_shapes(3, 30, 44, seed=5)
    blobs = []
    for f in frames:
        b = io.BytesIO()
        Image.fromarray(f).save(b, "JPEG", quality=70, progressive=True)
        blobs.append(b.getvalue())
    movi = b"".join(b"00dc" + len(j).to_bytes(4, "little") + j + b"\0" * (len(j) % 2)
                    for j in blobs)
    path = tmp_path / "pil.avi"
    path.write_bytes(b"RIFF\0\0\0\0AVI LIST\0\0\0\0hdrlstrhvidsMJPG" + movi)
    got, want = list(loaders.open_video(str(path))), list(jloaders._mjpeg_avi_decoder(str(path)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
